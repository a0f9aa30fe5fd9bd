#!/usr/bin/env python3
"""Where the paged attention kernels' time goes: clock64() phase stamps of
every block, read on one card.

    python3 tools/paged_stamps.py [--out DIR]

Builds `csrc/paged_decode.cu` and `csrc/ragged_paged.cu` with
`-DPTT_STAMPS` (see `csrc/paged_common.cuh`) into a directory of their own,
`build/paddle_tpu_torch/stamps/`, so the libraries the port loads stay
unstamped; then for each case of
tools/paged_cases.py (K6 bf16 and K6q int8 at the decode shape; K7 bf16 on
the flat step, with its chunk parked and with its decode tokens parked):
one stamped call after a warm-up, read back through `ptt_stamps_read`;
the call's time by CUDA events (50 calls queued behind a spin); and each
kernel's device time under torch.profiler. Prints, per case: the blocks
that did work, the span of the launch on the global timer, the mean block
life, and the mean clocks of each phase the kernel stamps (converted to
microseconds at the clock rate the stamps themselves show): the decode
walk's phases (K6, and K7's one-token tiles) and the tensor-core tile's
(K7's longer tiles). Stamping adds a few instructions a phase; the timings
printed beside come from the same stamped build, so compare them only with
each other.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

BLOCKS, SLOTS = 8192, 16
# per library, groups of stamp slots (first slot, labels): clocks at slots
# first .. first + n - 1, each phase measured from the previous mark (slot
# 3, the block's start, first)
WALK = ["table + q", "first K chunk", "scores", "softmax", "P V",
        "fold + write", "merge"]
GROUPS = {
    "paged_decode": [(4, WALK)],
    "ragged_paged": [(4, WALK),
                     (11, ["tensor-core tile: q + positions", "key tiles",
                           "epilogue"])],
}


def read_stamps(lib):
    buf = np.zeros((BLOCKS, SLOTS), np.int64)
    fn = lib.ptt_stamps_read
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    err = fn(buf.ctypes.data)
    if err:
        raise RuntimeError(f"ptt_stamps_read failed: {err}")
    return buf


def device_ms(call, n=20):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = 0.0
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                us = float(getattr(e, attr))
                break
        if us > 0 and e.device_type != torch.autograd.DeviceType.CPU:
            out[e.key[:80]] = us / 1e3 / n
    return out


def analyse(st, groups):
    live = st[:, 3] != 0
    res = {"blocks": int(live.sum())}
    if not live.any():
        return res
    res["span_us"] = float((st[live, 1].max() - st[live, 0].min()) / 1e3)
    res["sms"] = int(len(np.unique(st[live, 2])))
    for first, labels in groups:
        n = len(labels)
        key = labels[0].split(":")[0] if ":" in labels[0] else "walk"
        w = st[live & (st[:, first + n - 1] != 0)]
        if not len(w):
            continue
        marks = np.concatenate([w[:, 3:4], w[:, first:first + n]],
                               axis=1).astype(np.float64)
        d = np.diff(marks, axis=1)
        clocks = marks[:, -1] - marks[:, 0]
        ns = (w[:, 1] - w[:, 0]).astype(np.float64)
        ghz = float(np.median(clocks / np.maximum(ns, 1)))
        res[key] = {
            "blocks_with_work": int(len(w)),
            "mean_life_us": float(ns.mean() / 1e3),
            "max_life_us": float(ns.max() / 1e3),
            "clock_ghz": ghz,
            "phases_us": {lab: float(d[:, i].mean() / ghz / 1e3)
                          for i, lab in enumerate(labels)}}
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import chip_smoke as cs
    import paged_cases as pc
    from paddle_tpu_torch import _build

    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    _build.NVCC_FLAGS += ("-DPTT_STAMPS",)
    _build.BUILD_DIR = _build.BUILD_DIR / "stamps"
    _build._compile(["paged_decode", "ragged_paged"])
    libs = {n: _build.load(n) for n in ("paged_decode", "ragged_paged")}
    cases = [("paged_decode", pc.decode_case(dev, "bf16")),
             ("paged_decode", pc.decode_case(dev, "int8")),
             ("ragged_paged", pc.flat_case(dev, "bf16")),
             ("ragged_paged", pc.flat_case(dev, "bf16", park="chunk")),
             ("ragged_paged", pc.flat_case(dev, "bf16", park="decode"))]
    results = {"nvidia_smi": smi}
    for lib_name, (call, _, label) in cases:
        call()
        torch.cuda.synchronize()
        read_stamps(libs[lib_name])
        call()
        torch.cuda.synchronize()
        st = read_stamps(libs[lib_name])
        res = analyse(st, GROUPS[lib_name])
        res["call_ms"] = cs.time_ms(call, 50, 5)
        res["kernels_ms"] = device_ms(call)
        results[label] = res
        print(f"[stamps] {label}: {json.dumps(res)}", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "paged_stamps.json"), "w") as f:
            json.dump(results, f, indent=1)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
