#!/usr/bin/env python3
"""How far fp32 rounding alone moves the gradients of chip_smoke's
card-vs-CPU ResNet step, the basis of its VIS_GRAD_RTOL.

    python3 tools/resnet_rounding.py [--seed N] [--top K]

Builds the BottleneckBlock ResNet-50 with 10 classes of
`chip_smoke.vision_card_vs_cpu` from the same seed and takes its 2 x 3 x
64 x 64 step three times from the same weights, ReLU masks shared: in
float64 on the CPU, in fp32 on the CPU and in fp32 on the card (cuDNN's
TF32 off). For each parameter it prints, as a share of that gradient's
own largest value, the card against the CPU's fp32 step (what chip_smoke
checks), the CPU's fp32 step against float64 and the card's against
float64, worst first; then the same for the running statistics, and, after
one Momentum step, for the eval forward's logits on the running
statistics. Without a card it compares the CPU with itself. The last
line is one JSON object of the worst readings.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs                                     # noqa: E402
import paddle_tpu_torch as paddle                           # noqa: E402


def _rel(a, b):
    """max |a - b| over max |b|, in float64."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    card_dev = "cuda" if torch.cuda.is_available() else "cpu"
    if card_dev == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    M = paddle.vision.models

    def build(place, weights=None):
        paddle.set_device(place)
        net = M.ResNet(M.resnet.BottleneckBlock, 50, num_classes=10)
        if weights is not None:
            net.set_state_dict({k: v.cpu().clone()
                                for k, v in weights.items()})
        return net

    paddle.seed(args.seed)
    card = build(card_dev)
    weights = {k: v._t for k, v in card.state_dict().items()}
    nets = {"f64": build("cpu", weights), "cpu": build("cpu", weights),
            "card": card}
    torch.nn.Module.to(nets["f64"], torch.float64)
    paddle.set_device(card_dev)
    g = np.random.RandomState(args.seed + 80)
    x = g.randn(2, 3, 64, 64)
    y = g.randint(0, 10, (2, 1))

    def run(name, train):
        place = card_dev if name == "card" else "cpu"
        xx = x if name == "f64" else x.astype(np.float32)
        net = nets[name]
        net.train() if train else net.eval()
        out = net(paddle.to_tensor(xx, dtype=str(xx.dtype), place=place))
        if not train:
            return out._t
        loss = paddle.nn.CrossEntropyLoss()(out, paddle.to_tensor(
            y, place=place))
        loss.backward()
        return float(loss)

    order = ("f64", "cpu", "card")
    with cs.shared_relu_masks() as masks:
        losses = {}
        for name in order:
            masks.record() if name == "f64" else masks.replay()
            losses[name] = run(name, True)
        params = {n: dict(m.named_parameters()) for n, m in nets.items()}
        rows = sorted(((_rel(p._t.grad, params["cpu"][n]._t.grad),
                        _rel(params["cpu"][n]._t.grad,
                             params["f64"][n]._t.grad),
                        _rel(p._t.grad, params["f64"][n]._t.grad), n)
                       for n, p in params["card"].items()), reverse=True)
        bufs = {n: dict(m.named_buffers()) for n, m in nets.items()}
        buf_rows = sorted(((_rel(b._t, bufs["cpu"][n]._t),
                            _rel(bufs["cpu"][n]._t, bufs["f64"][n]._t), n)
                           for n, b in bufs["card"].items()), reverse=True)
        for net in nets.values():
            paddle.optimizer.Momentum(
                cs.VIS_LR, 0.9, parameters=net.parameters(),
                weight_decay=paddle.optimizer.L2Decay(cs.VIS_DECAY)).step()
        logits = {}
        for name in order:
            masks.record() if name == "f64" else masks.replay()
            with paddle.no_grad():
                logits[name] = run(name, False)
    print(f"losses {losses}")
    print("gradient, share of its own largest: card vs CPU fp32 | CPU fp32 "
          "vs float64 | card vs float64")
    for r in rows[:args.top]:
        print("  %.3g | %.3g | %.3g  %s" % r)
    print("running statistics: card vs CPU fp32 | CPU fp32 vs float64")
    for r in buf_rows[:min(args.top, 5)]:
        print("  %.3g | %.3g  %s" % r)
    ev = {"card_vs_cpu": _rel(logits["card"], logits["cpu"]),
          "cpu_vs_f64": _rel(logits["cpu"], logits["f64"]),
          "card_vs_f64": _rel(logits["card"], logits["f64"]),
          "largest_logit": float(logits["f64"].abs().max())}
    print(f"eval logits after one Momentum step: {ev}")
    worst = [max(rows, key=lambda r: r[i]) for i in range(3)]
    print(json.dumps({
        "device": card_dev, "losses": losses,
        "grad_card_vs_cpu": [worst[0][0], worst[0][3]],
        "grad_cpu_vs_f64": [worst[1][1], worst[1][3]],
        "grad_card_vs_f64": [worst[2][2], worst[2][3]],
        "stats_card_vs_cpu": [buf_rows[0][0], buf_rows[0][2]],
        "stats_cpu_vs_f64": max(r[1] for r in buf_rows), "eval": ev}))


if __name__ == "__main__":
    main()
