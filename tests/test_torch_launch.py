"""The port's host-side services of distributed: fleetrun
(paddle_tpu_torch.distributed.launch), elastic membership, the native
TCPStore and rpc, mirroring tests/test_distributed.py:452-491,
tests/test_elastic.py, tests/test_tcp_store.py:16-118 and
tests/test_rpc.py. Every process here is a real one: the launcher, its
ranks, a TCPStore client, rpc workers."""
import operator
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from paddle_tpu_torch.distributed import TCPStore, rpc
from paddle_tpu_torch.distributed.elastic import (ElasticManager, Event,
                                                  start_heartbeat)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
              "MASTER_ADDR", "MASTER_PORT", "FLAGS_selected_gpus"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _fleetrun(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         *map(str, args)], capture_output=True, text=True, env=_env(),
        timeout=timeout, cwd=REPO)


# ---------------------------------------------------------------- fleetrun
def test_fleetrun_sets_the_rank_environment(tmp_path):
    script = tmp_path / "env_stub.py"
    script.write_text(textwrap.dedent("""
        import os
        e = os.environ
        print("rank={} world={} local={} neps={} master={} addr={}:{} "
              "gpu={} cur={}".format(
                  e["PADDLE_TRAINER_ID"], e["PADDLE_TRAINERS_NUM"],
                  e["PADDLE_LOCAL_RANK"],
                  len(e["PADDLE_TRAINER_ENDPOINTS"].split(",")),
                  e["PADDLE_MASTER"], e["MASTER_ADDR"], e["MASTER_PORT"],
                  e["FLAGS_selected_gpus"], e["PADDLE_CURRENT_ENDPOINT"]),
              flush=True)
    """))
    out = _fleetrun("--nproc_per_node", 2, "--master", "127.0.0.1:6170",
                    "--devices", "3,5", "--log_dir", tmp_path / "logs",
                    script)
    assert out.returncode == 0, out.stderr
    logs = {r: (tmp_path / "logs" / f"worker.{r}.log").read_text()
            for r in (0, 1)}
    for r, gpu in ((0, 3), (1, 5)):
        assert (f"rank={r} world=2 local={r} neps=2 master=127.0.0.1:6170 "
                f"addr=127.0.0.1:6170 gpu={gpu} cur=127.0.0.1:{6170 + r}"
                in logs[r]), logs[r]


def test_fleetrun_aborts_the_job_when_a_rank_fails(tmp_path):
    script = tmp_path / "bad_stub.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["PADDLE_TRAINER_ID"] == "1":
            sys.exit(3)
        time.sleep(60)      # the launcher must stop this rank
    """))
    t0 = time.monotonic()
    out = _fleetrun("--nproc_per_node", 2, script)
    assert out.returncode == 3
    assert "aborting job" in out.stderr
    assert time.monotonic() - t0 < 40


def test_fleetrun_restarts_a_failed_rank(tmp_path):
    script = tmp_path / "flaky_stub.py"
    marker = tmp_path / "failed_once"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        if not os.path.exists({str(marker)!r}):
            open({str(marker)!r}, "w").close()
            sys.exit(5)
        print("second run ok", flush=True)
    """))
    out = _fleetrun("--nproc_per_node", 1, "--elastic_retries", 1, script)
    assert out.returncode == 0, out.stderr
    assert "restart 1/1" in out.stderr
    assert "second run ok" in out.stdout


def test_launcher_main_module_does_not_run_on_import():
    import importlib

    mod = importlib.import_module(
        "paddle_tpu_torch.distributed.launch.__main__")
    assert callable(mod.main)


# ----------------------------------------------------------------- elastic
class TestMembership:
    def test_join_and_clean_leave(self, tmp_path):
        d = str(tmp_path)
        mgr = ElasticManager(d, np_expected=2, dead_timeout=2.0)
        stop0 = start_heartbeat(d, rank=0, interval=0.1)
        stop1 = start_heartbeat(d, rank=1, interval=0.1)
        time.sleep(0.3)
        kinds = sorted(e.kind for e in mgr.scan())
        assert kinds == ["join", "join", "scale_up"]
        assert mgr.membership() == [0, 1] and mgr.is_healthy()
        stop1()   # removes the heartbeat file: a clean LEAVE
        kinds = [e.kind for e in mgr.scan()]
        assert "leave" in kinds and "scale_down" in kinds
        assert mgr.membership() == [0] and not mgr.is_healthy()
        stop0()

    def test_dead_worker_detected_by_timeout(self, tmp_path):
        d = str(tmp_path)
        mgr = ElasticManager(d, dead_timeout=0.4)
        stop = start_heartbeat(d, rank=3, interval=0.1)
        time.sleep(0.3)
        assert [e.kind for e in mgr.scan()] == ["join"]
        stop()
        with open(os.path.join(d, "worker_3.hb"), "w") as f:
            f.write(str(time.time() - 100))  # a stale stamp: a crash
        events = mgr.scan()
        assert [e.kind for e in events] == ["dead"] and events[0].rank == 3
        assert mgr.membership() == []

    def test_callbacks_and_endpoints(self, tmp_path):
        d = str(tmp_path)
        mgr = ElasticManager(d, dead_timeout=5.0,
                             base_endpoint="10.0.0.1:6000")
        seen = []
        mgr.on(Event.JOIN, lambda ev: seen.append(("join", ev.rank)))
        s0 = start_heartbeat(d, rank=0, interval=0.1)
        s2 = start_heartbeat(d, rank=2, interval=0.1)
        time.sleep(0.3)
        mgr.scan()
        assert sorted(seen) == [("join", 0), ("join", 2)]
        # densely re-ranked endpoints for the surviving membership
        assert mgr.endpoints() == "10.0.0.1:6000,10.0.0.1:6001"
        s0()
        s2()


def test_launcher_emits_membership_events(tmp_path):
    script = tmp_path / "hb_stub.py"
    script.write_text(textwrap.dedent("""
        import time
        from paddle_tpu_torch.distributed.elastic import start_heartbeat
        stop = start_heartbeat(interval=0.1)   # from the launcher's env
        time.sleep(1.5)
        stop()
    """))
    out = _fleetrun("--nproc_per_node", 2, "--elastic_dir", tmp_path / "hb",
                    script)
    assert out.returncode == 0, out.stderr
    assert "Event(join, rank=0" in out.stderr
    assert "Event(join, rank=1" in out.stderr
    assert "Event(scale_up" in out.stderr


# ---------------------------------------------------------------- TCPStore
class TestTCPStore:
    def test_set_get_add(self):
        m = TCPStore(is_master=True, world_size=1)
        w = TCPStore(port=m.port)
        try:
            m.set("k", b"v1")
            assert w.get("k") == b"v1"
            assert w.add("c", 3) == 3
            assert m.add("c", 2) == 5
            # counters read back as keys: 8 little-endian bytes
            assert int.from_bytes(m.get("c"), "little") == 5
        finally:
            w.close()
            m.close()

    def test_get_blocks_until_set_and_times_out(self):
        m = TCPStore(is_master=True)
        w = TCPStore(port=m.port)
        try:
            got = {}
            t = threading.Thread(
                target=lambda: got.update(v=w.get("late", timeout=5.0)))
            t.start()
            time.sleep(0.2)
            m.set("late", b"now")
            t.join(timeout=5)
            assert not t.is_alive() and got["v"] == b"now"
            with pytest.raises(TimeoutError):
                m.get("never", timeout=0.2)
        finally:
            w.close()
            m.close()

    def test_barrier_two_clients(self):
        m = TCPStore(is_master=True, world_size=2)
        w = TCPStore(port=m.port, world_size=2)
        try:
            done = []
            t = threading.Thread(
                target=lambda: (w.barrier("b0", timeout=5.0),
                                done.append("w")))
            t.start()
            m.barrier("b0", timeout=5.0)
            t.join(timeout=5)
            assert done == ["w"]
        finally:
            w.close()
            m.close()

    def test_cross_process_rendezvous(self, tmp_path):
        master = TCPStore(is_master=True, world_size=2, timeout=15.0)
        script = tmp_path / "worker.py"
        script.write_text(textwrap.dedent("""
            import sys
            from paddle_tpu_torch.distributed import TCPStore
            store = TCPStore(port=int(sys.argv[1]), world_size=2,
                             timeout=15.0)
            store.set("worker/ready", b"1")
            val = store.get("master/payload", timeout=10.0)
            store.set("worker/echo", val + b"-seen")
            store.barrier("fin", timeout=10.0)
            store.close()
            print("WORKER_OK")
        """))
        proc = subprocess.Popen([sys.executable, str(script),
                                 str(master.port)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, env=_env(),
                                text=True)
        try:
            assert master.get("worker/ready", timeout=30.0) == b"1"
            master.set("master/payload", b"token42")
            assert master.get("worker/echo", timeout=10.0) == \
                b"token42-seen"
            master.barrier("fin", timeout=10.0)
            out, _ = proc.communicate(timeout=30)
            assert proc.returncode == 0 and "WORKER_OK" in out, out
        finally:
            if proc.poll() is None:
                proc.kill()
            master.close()


# --------------------------------------------------------------------- rpc
@pytest.fixture
def single_world():
    rpc.init_rpc("solo", rank=0, world_size=1)
    yield
    rpc.shutdown()


class TestRpcSingleWorld:
    def test_self_calls(self, single_world):
        assert rpc.rpc_sync("solo", operator.add, args=(2, 3)) == 5
        fut = rpc.rpc_async("solo", operator.mul, args=(6, 7))
        assert fut.wait() == 42 and fut.result() == 42

    def test_remote_exception_propagates(self, single_world):
        with pytest.raises(ZeroDivisionError):
            rpc.rpc_sync("solo", operator.truediv, args=(1, 0))

    def test_worker_info_and_double_init(self, single_world):
        info = rpc.get_current_worker_info()
        assert info.name == "solo" and info.rank == 0
        assert rpc.get_worker_info("solo").endpoint == info.endpoint
        with pytest.raises(RuntimeError, match="already"):
            rpc.init_rpc("again", rank=0, world_size=1)

    def test_reinit_after_shutdown(self):
        rpc.init_rpc("a", rank=0, world_size=1)
        rpc.shutdown()
        rpc.init_rpc("b", rank=0, world_size=1)
        assert rpc.rpc_sync("b", operator.neg, args=(4,)) == -4
        rpc.shutdown()


def test_two_real_processes_rpc():
    """Rank 0 runs functions on rank 1 through real sockets; the master
    endpoint's rendezvous assembles the worker table. Both ranks start
    through fleetrun."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        master = f"127.0.0.1:{s.getsockname()[1]}"
    out = _fleetrun("--nproc_per_node", 2,
                    os.path.join(REPO, "tests", "_torch_rpc_worker.py"),
                    master, timeout=180)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "rank0 rpc_ok" in out.stdout
    assert "rank1 served_ok" in out.stdout
