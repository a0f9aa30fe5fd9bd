#!/usr/bin/env python3
"""Run some phases of `chip_smoke.py` on one card, in the order given, and
print each one's seconds: the way to read a phase under `--profile`
without the whole script, and to compare a phase of two checkouts within
one call.

    python3 tools/chip_phases.py [DIR] --phases train,dygraph [--profile]
                                 [--seed N] [--out OUT]

DIR (default: this checkout) is a directory holding `chip_smoke.py` and
`paddle_tpu_torch/` (a `git archive` unpacked under a gitignored
directory, or `.`); its own package is imported and its kernels built
first (`phase_device`, `phase_build`). A phase name is a `phase_<name>`
function of that chip_smoke.py; it is called with (seed, dev) and, where
its signature takes them, `profile`, `out_dir` and (the dygraph phase)
`native`, the result of a `train` phase run before it (`--phases
vision_dp` trains ResNet-50 data-parallel through `paddle.Model.fit` on
4 ranks; `--phases vision` includes the zoo and vision.ops). Each phase
prints its own lines, then `[phase] <name>: <seconds> s`; the last line is one
JSON object {"nvidia_smi": "<name, power limit>", "<name>": seconds,
...}.
"""
import argparse
import gc
import importlib
import inspect
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--phases", required=True)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.dir)
    sys.path.insert(0, root)
    os.chdir(root)
    cs = importlib.import_module("chip_smoke")
    import torch

    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    cs.phase_build(args.out)
    results, seconds = {}, {}
    for name in args.phases.split(","):
        fn = getattr(cs, f"phase_{name}")
        params = inspect.signature(fn).parameters
        kw = {k: v for k, v in (("profile", args.profile),
                                ("out_dir", args.out),
                                ("native", results.get("train")))
              if k in params}
        t0 = time.perf_counter()
        results[name] = fn(args.seed, dev, **kw)
        seconds[name] = time.perf_counter() - t0
        cs.log(f"[phase] {name}: {seconds[name]:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        with open(os.path.join(args.out, "chip_phases.json"), "w") as f:
            json.dump(dict(nvidia_smi=smi, seconds=seconds,
                           results=results), f, indent=1, default=str)
    print(json.dumps(dict(nvidia_smi=smi, **seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
