#!/usr/bin/env python3
"""Time the port's paged attention kernels (K6, K6q, K7, K7q) of two or more
checkouts in turns on one card, so that versions compare within one run.

    python3 tools/paged_ab.py DIR_A DIR_B [DIR_C ...] [--order ABBA]

Each DIR is a directory holding `chip_smoke.py` and `paddle_tpu_torch/`
(a `git archive` unpacked under a gitignored directory such as
`build/trees/`, or `.`); the directories take the letters A, B, C, ... in
order. Every directory's `paged_decode` and `ragged_paged` libraries are
built first, all in parallel (each prints `BUILD <letter>` with the most
registers and spill bytes ptxas reports for its Hopper paged kernels);
then each letter of --order (default: A B B
A for two directories, A B C .. C B A for more) runs one fresh process in
its directory that times, through the public wrappers and the seeded cases
of tools/paged_cases.py (LLaMA-7B widths, page 16, capacity 1024): K6 bf16
and K6q int8 / fp8 at b = 8 with positions spread over 0..1023, and K7 bf16
and K7q int8 / fp8 on the flat step (8 decode tokens, a 256-token chunk at
512, T = 328; its halves, with the chunk parked and with the decode
tokens parked; and only the chunk's last 17 tokens at 1007..1023, beside
the decode tokens and alone, and its last 64 alone at rep 1 and 4), each
by CUDA events over 50 calls queued behind a spin (`chip_smoke.time_ms`),
and prints one line `AB <letter> {case: [ms, max abs error against the
plain version]}`. Every tree sees the same inputs.
"""
import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

CASES = r'''
import json, sys, torch
sys.path.insert(0, sys.argv[2])
import chip_smoke as cs
import paged_cases as pc
from paddle_tpu_torch.serving import attention as att

dev = torch.device("cuda", 0)
out = {}
for name, (call, plain, _) in (
        ("K6 bf16", pc.decode_case(dev, "bf16")),
        ("K6q int8", pc.decode_case(dev, "int8")),
        ("K6q fp8", pc.decode_case(dev, "fp8")),
        ("K7 bf16", pc.flat_case(dev, "bf16")),
        ("K7q int8", pc.flat_case(dev, "int8")),
        ("K7q fp8", pc.flat_case(dev, "fp8")),
        ("K7 bf16 chunk parked", pc.flat_case(dev, "bf16", park="chunk")),
        ("K7 bf16 decode parked", pc.flat_case(dev, "bf16",
                                               park="decode")),
        ("K7 bf16 17-token run", pc.flat_case(dev, "bf16", run=17)),
        ("K7 bf16 17-token run alone", pc.flat_case(
            dev, "bf16", park="decode", run=17)),
        ("K7 bf16 64-token run alone", pc.flat_case(
            dev, "bf16", park="decode", run=64)),
        ("K7 bf16 64-token run alone, rep 4", pc.flat_case(
            dev, "bf16", rep=4, park="decode", run=64))):
    got, ref = call(), plain()
    torch.cuda.synchronize()
    err = cs.max_err(got, ref)
    ms = cs.time_ms(call, 50, 5)
    out[name] = [round(ms, 5), err]
print("AB", sys.argv[1], json.dumps(out), flush=True)
'''

# build a tree's two paged libraries and print the registers and spill
# bytes ptxas reports for the Hopper paged kernels
BUILD = r'''
import re, sys
from paddle_tpu_torch import _build
_build._compile(["paged_decode", "ragged_paged"])
worst = {}
for text in _build.BUILD_LOGS.values():
    cur = None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = next((k for k in ("paged_decode_walk_kernel",
                                    "ragged_paged_kernel") if k in m.group(1)),
                       None)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if cur and m:
            w = worst.setdefault(cur, [0, 0])
            w[1] = max(w[1], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", ln)
        if cur and m:
            w = worst.setdefault(cur, [0, 0])
            w[0] = max(w[0], int(m.group(1)))
print("BUILD", sys.argv[1], {k: {"max registers": r, "max spill bytes": b}
                             for k, (r, b) in worst.items()}, flush=True)
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--order", default=None)
    args = ap.parse_args(argv)
    if len(args.dirs) < 2:
        ap.error("give two or more directories")
    letters = "ABCDEFGH"[:len(args.dirs)]
    trees = dict(zip(letters, args.dirs))
    order = args.order or (letters + letters[::-1])
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, tag], cwd=t)
              for tag, t in trees.items()]
    if any(b.wait() for b in builds):
        raise SystemExit("a build failed")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for tag in order:
        subprocess.run([sys.executable, "-c", CASES, tag, HERE],
                       cwd=trees[tag], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
