"""The launcher, fleetrun (counterpart of
paddle_tpu/distributed/launch/main.py:1-159).

One process a rank: `--nproc_per_node` ranks on this node, node
`--node_rank` of `--nnodes`. Each rank runs `python script args` with
Paddle's environment (reference :52-72): PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS (host:port + i for rank
i), PADDLE_CURRENT_ENDPOINT, PADDLE_MASTER, PADDLE_LOCAL_RANK,
PADDLE_NNODES, and for torch's `env://` rendezvous MASTER_ADDR /
MASTER_PORT from `--master`, so `distributed.init_parallel_env()` with no
arguments joins the world. `--devices` / `--gpus` (comma-separated card
ids) set FLAGS_selected_gpus to the rank's own card (local rank i takes
the i-th id, modulo their count). On one node the ranks' gloo and NCCL
sockets use loopback, and without `--master` a free port is taken.

The watch loop (reference :75-155): a rank that exits non-zero is
restarted up to `--elastic_retries` times, after which the job is
aborted (the other ranks terminated) with that rank's exit code;
`--elastic_dir` runs the `elastic.ElasticManager` over the ranks'
heartbeats and logs its membership events to stderr; `--log_dir` gets
each rank's output as `worker.<rank>.log`.

Usage:
  python -m paddle_tpu_torch.distributed.launch [--nnodes N]
      [--node_rank R] [--master IP:PORT] [--nproc_per_node M]
      [--elastic_retries K] [--log_dir DIR] [--elastic_dir DIR]
      [--devices 0,1,...] training_script [script args...]
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["main"]


def _parse(argv=None):
    p = argparse.ArgumentParser(prog="fleetrun", add_help=True)
    p.add_argument("--nnodes", type=int,
                   default=int(os.environ.get("PADDLE_NNODES", 1)))
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", 0)))
    p.add_argument("--master", default=os.environ.get("PADDLE_MASTER"),
                   help="host:port of the rendezvous (default on one node: "
                        "127.0.0.1 and a free port)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="ranks on this node")
    p.add_argument("--elastic_retries", type=int,
                   default=int(os.environ.get("PADDLE_ELASTIC_RETRIES", 0)),
                   help="restarts of a rank before the job is aborted")
    p.add_argument("--log_dir", default=os.environ.get("PADDLE_LOG_DIR"))
    p.add_argument("--elastic_dir",
                   default=os.environ.get("PADDLE_ELASTIC_DIR"),
                   help="heartbeat directory enabling membership events")
    p.add_argument("--devices", "--gpus", dest="devices", default=None,
                   help="card ids, comma separated")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.master is None:
        if args.nnodes > 1:
            p.error("--master is needed with more than one node")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            args.master = f"127.0.0.1:{s.getsockname()[1]}"
    return args


def _rank_env(args, local_rank: int) -> dict:
    world = args.nnodes * args.nproc_per_node
    rank = args.node_rank * args.nproc_per_node + local_rank
    host, port = args.master.rsplit(":", 1)
    endpoints = ",".join(f"{host}:{int(port) + i}" for i in range(world))
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_TRAINER_ENDPOINTS": endpoints,
        "PADDLE_CURRENT_ENDPOINT": f"{host}:{int(port) + rank}",
        "PADDLE_MASTER": args.master,
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_NNODES": str(args.nnodes),
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
    })
    if args.nnodes == 1:
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if args.elastic_dir:
        env["PADDLE_ELASTIC_DIR"] = args.elastic_dir
    if args.devices:
        ids = args.devices.split(",")
        env["FLAGS_selected_gpus"] = ids[local_rank % len(ids)]
    return env


def main(argv=None) -> int:
    args = _parse(argv)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    procs = {}
    retries = {}
    logs = []

    def launch(local_rank: int):
        env = _rank_env(args, local_rank)
        cmd = [sys.executable, args.script] + args.script_args
        stdout = None
        if args.log_dir:
            stdout = open(os.path.join(
                args.log_dir, f"worker.{env['PADDLE_TRAINER_ID']}.log"),
                "ab")
            logs.append(stdout)
        procs[local_rank] = subprocess.Popen(
            cmd, env=env, stdout=stdout,
            stderr=subprocess.STDOUT if stdout else None)

    def shutdown(signum=None, frame=None):
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10
        for p in procs.values():
            try:
                p.wait(max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if signum is not None:
            raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)

    manager = None
    if args.elastic_dir:
        from ..elastic import ElasticManager

        # heartbeats carry global ranks; health is about the world size
        manager = ElasticManager(
            args.elastic_dir, np_expected=args.nnodes * args.nproc_per_node)
        for kind in ("join", "dead", "leave", "scale_up", "scale_down"):
            manager.on(kind, lambda ev: print(f"[fleetrun][elastic] {ev}",
                                              file=sys.stderr, flush=True))

    exit_code = 0
    try:
        for lr in range(args.nproc_per_node):
            launch(lr)
        while procs:
            time.sleep(0.2)
            if manager is not None:
                manager.scan()
            for lr, p in list(procs.items()):
                code = p.poll()
                if code is None:
                    continue
                if code == 0:
                    del procs[lr]
                    continue
                retries[lr] = retries.get(lr, 0) + 1
                if retries[lr] <= args.elastic_retries:
                    print(f"[fleetrun] rank {lr} exited {code}; restart "
                          f"{retries[lr]}/{args.elastic_retries}",
                          file=sys.stderr, flush=True)
                    launch(lr)
                else:
                    print(f"[fleetrun] rank {lr} failed (exit {code}); "
                          "aborting job", file=sys.stderr, flush=True)
                    exit_code = code
                    return exit_code
    finally:
        shutdown()
        for f in logs:
            f.close()
    return exit_code
