#!/usr/bin/env python3
"""Is one ERNIE-1.0 base train step run-to-run deterministic on the card?

Runs one O1 forward / backward of `ErnieForPretraining` at the Train ERNIE
cell's shape (32 x 512, dropout 0.1, the fused MLM loss) twice from the
same weights and generator, under PyTorch's default algorithms and then
under `torch.use_deterministic_algorithms(True, warn_only=True)`, and
prints the parameters whose gradients differ between the two runs with
their largest difference. Then times the embedding backward of each of
ERNIE's three lookups (word ids, positions, the all-zero token types) by
CUDA events under both settings.

Run from the repository root on a card:  python3 tools/train_determinism.py
"""
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def grads_twice(model, ids, labels, dev):
    runs = [cs.recompute_grads(model, ids, labels, dev, 0) for _ in range(2)]
    (l0, g0), (l1, g1) = runs
    diff = {k: float((g0[k] - g1[k]).abs().max()) for k in g0
            if not torch.equal(g0[k], g1[k])}
    return bool(torch.equal(l0, l1)), diff


def embedding_ms(ids, rows, dev, iters=20):
    w = torch.randn(rows, 768, device=dev, requires_grad=True)
    dy = torch.randn(*ids.shape, 768, device=dev)

    def backward():
        torch.autograd.grad(torch.nn.functional.embedding(ids, w), w, dy)

    return cs.time_ms(backward, iters)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining

    cs.phase_device()
    dev = torch.device("cuda", 0)
    cfg = ErnieConfig.ernie_base()
    cfg.fused_mlm_loss = True
    model = ErnieForPretraining(cfg, device=dev, seed=0)
    model.train()
    rng = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                                (32, 512))).to(dev)
                   for _ in range(2))
    lookups = {"word ids": (ids, cfg.vocab_size),
               "positions": (torch.arange(512, device=dev)[None].expand(
                   32, 512), 512),
               "token types (all 0)": (torch.zeros_like(ids), 2)}
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        same_loss, diff = grads_twice(model, ids, labels, dev)
        cs.log(f"[determinism] deterministic algorithms {det}: two steps' "
               f"losses equal {same_loss}; gradients that differ: "
               f"{diff or 'none'}")
        cs.log(f"[determinism] embedding backward ms (CUDA events), "
               f"deterministic algorithms {det}: " + ", ".join(
                   f"{name} {embedding_ms(i, n, dev):.4f}"
                   for name, (i, n) in lookups.items()))
    torch.use_deterministic_algorithms(False)


if __name__ == "__main__":
    main()
