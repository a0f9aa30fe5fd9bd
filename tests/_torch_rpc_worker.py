"""Worker for the port's two-process rpc test (tests/test_torch_launch.py):
rank 0 calls into rank 1's server over real sockets; functions pickle by
reference to this __main__ module. Started by the port's fleetrun."""
import os
import sys
import time

from paddle_tpu_torch.distributed import rpc

_DONE = {"flag": False}


def add_one(x):
    return x + 1


def raise_boom():
    raise ValueError("boom from remote")


def mark_done():
    _DONE["flag"] = True
    return "ok"


def main():
    master = sys.argv[1]
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    rpc.init_rpc(f"worker{rank}", rank=rank, world_size=2,
                 master_endpoint=master)
    infos = rpc.get_all_worker_infos()
    assert [w.name for w in infos] == ["worker0", "worker1"], infos

    if rank == 0:
        assert rpc.rpc_sync("worker1", add_one, args=(41,)) == 42
        fut = rpc.rpc_async("worker1", add_one, args=(1,))
        assert fut.wait() == 2
        try:
            rpc.rpc_sync("worker1", raise_boom)
            raise AssertionError("remote exception did not propagate")
        except ValueError as e:
            assert "boom from remote" in str(e)
        print("rank0 rpc_ok", flush=True)
        rpc.rpc_sync("worker1", mark_done)
    else:
        deadline = time.monotonic() + 60
        while not _DONE["flag"]:
            if time.monotonic() > deadline:
                raise TimeoutError("rank1 never served mark_done")
            time.sleep(0.05)
        print("rank1 served_ok", flush=True)
    rpc.shutdown()


if __name__ == "__main__":
    main()
