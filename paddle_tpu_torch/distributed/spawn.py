"""Start a world of ranks (counterpart of paddle_tpu/distributed/spawn.py).

`spawn(fn, args, nprocs)` runs `fn(*args)` in `nprocs` new processes, each
of which has joined the world through `init_parallel_env` first, and
returns their results in rank order. The processes start with the `spawn`
method, never `fork` (the caller may hold threads, a CUDA context or JAX),
so `fn` must be importable by name and its module must import cleanly.
The ranks meet through a `file://` store in a temporary directory, so no
TCP port is chosen and two worlds on one machine cannot collide. On the
CPU each rank runs PyTorch with one thread.

A rank that raises makes `spawn` raise with that rank's traceback and
stops the other ranks; ranks that have not finished when `timeout` seconds
have passed are stopped, and `spawn` raises naming them.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

__all__ = ["spawn"]


def _worker(fn, rank, nprocs, args, init_method, device, timeout, results):
    import torch

    from .group import destroy_process_group, init_parallel_env

    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    # one host: gloo's connections and NCCL's bootstrap go over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        group = init_parallel_env(rank, nprocs, init_method, device, timeout)
        if group.device.type == "cpu":
            torch.set_num_threads(1)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)


def spawn(fn: Callable[..., Any], args: Sequence = (), nprocs: int = 1,
          timeout: float = 300.0, device=None) -> List[Any]:
    """Run `fn(*args)` on `nprocs` ranks of a new world (on `device`: the
    card by default, 'cpu' for the CPU; the backend as `init_parallel_env`
    picks it) and return the ranks' results in rank order."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    done = {}
    with tempfile.TemporaryDirectory(prefix="ptt_world_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker,
                             args=(fn, r, nprocs, tuple(args), init_method,
                                   device, timeout, results))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < nprocs:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = [r for r in range(nprocs) if r not in done]
                    raise TimeoutError(
                        f"spawn: rank(s) {missing} of {nprocs} did not "
                        f"finish within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if r not in done
                            and p.exitcode not in (None, 0)]
                    if dead:
                        # its traceback may still be on its way
                        try:
                            rank, ok, payload = results.get(timeout=5.0)
                        except queue_mod.Empty:
                            raise RuntimeError(
                                f"spawn: rank(s) {dead} exited with code(s) "
                                f"{[procs[r].exitcode for r in dead]} "
                                "without a result") from None
                    else:
                        continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} of {nprocs} "
                                       f"failed:\n{payload}")
                done[rank] = payload
        except BaseException:
            _stop(procs)
            raise
        for p in procs:
            p.join(30)
        _stop(procs)
    return [done[r] for r in range(nprocs)]
