#!/usr/bin/env python3
"""Time the port's flash dQ kernel (K2, `flash_attention._launch_dq`) of two
checkouts in turns on one card, so that two versions compare within one
run.

    python3 tools/flash_dq_ab.py DIR_A DIR_B [--order ABBA]

Each DIR is a directory holding `chip_smoke.py` and `paddle_tpu_torch/`
(a `git archive` unpacked under a gitignored directory, or `.`). Both
directories' flash libraries are built first, in parallel; then each
letter of --order runs one fresh process in its directory that times K2
(CUDA events over 30 calls queued behind a spin, `chip_smoke.time_ms`) at
ERNIE's shape with dropout 0.1, T5-base's encoder with its (1, h, q, k)
bias without and with d(mask) (8 batch groups), its decoder with d(mask),
and the ring's past and diagonal steps at (1, 4096, 32, 128), and prints
one line `AB <letter> {case: [ms, max error / max|plain|]}`. Inputs come
from a fixed seed, so both versions see the same values and their errors
against the plain version must agree where they compute the same bits.
"""
import argparse
import subprocess
import sys

CASES = r'''
import json, sys, torch
import chip_smoke as cs
from paddle_tpu_torch.ops import flash_attention as fa

dev, bf = torch.device("cuda", 0), torch.bfloat16
g = torch.Generator(device=dev).manual_seed(5)
seed = torch.tensor([777], dtype=torch.int32, device=dev)
out = {}
for name, (b, sq, sk, h, d, bias, causal, p), groups, offs in (
        ("ernie", (32, 512, 512, 12, 64, False, False, 0.1), 0, None),
        ("t5enc", (32, 512, 512, 12, 64, True, False, 0.1), 0, None),
        ("t5enc_dmask", (32, 512, 512, 12, 64, True, False, 0.1), 8, None),
        ("t5dec_dmask", (32, 114, 114, 12, 64, True, True, 0.1), 8, None),
        ("ring_past", (1, 4096, 4096, 32, 128, False, True, 0.0), 0,
         (8192, 4096)),
        ("ring_diag", (1, 4096, 4096, 32, 128, False, True, 0.0), 0,
         (4096, 4096))):
    mask = (0.5 * torch.randn(1, h, sq, sk, generator=g, device=dev)
            if bias else None)
    q, dout = (torch.randn(b, sq, h, d, generator=g, device=dev).to(bf)
               for _ in range(2))
    k, v = (torch.randn(b, sk, h, d, generator=g, device=dev).to(bf)
            for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, mask, causal, True, p, seed,
                                offsets=offs,
                                keep_neg_inf_lse=offs is not None)
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    delta = fa.attention_delta(o, dout)
    prep = fa._bwd_prepare(q, k, v, dout, lse, delta, mask, p, seed, "ab")
    ref = fa.flash_attention_backward_reference(
        q, k, v, dout, lse, delta, mask, causal, p, seed, need_dkv=False,
        offsets=offs)[0]
    dq = fa._launch_dq(prep, causal, groups, offsets=offs)[0]
    torch.cuda.synchronize()
    err = cs.max_err(dq, ref) / float(ref.float().abs().max())
    ms = cs.time_ms(lambda: fa._launch_dq(prep, causal, groups,
                                          offsets=offs), 30, 3)
    out[name] = [round(ms, 5), round(err, 6)]
print("AB", sys.argv[1], json.dumps(out), flush=True)
'''

BUILD = ("from paddle_tpu_torch import _build; "
         "_build.load('flash_fwd'); _build.load('flash_bwd')")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args(argv)
    trees = {"A": args.dir_a, "B": args.dir_b}
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=t)
              for t in trees.values()]
    if any(b.wait() for b in builds):
        raise SystemExit("a build failed")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for tag in args.order:
        subprocess.run([sys.executable, "-c", CASES, tag], cwd=trees[tag],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
