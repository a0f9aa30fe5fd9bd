"""paddle.distributed.rpc: worker-to-worker RPC (counterpart of
paddle_tpu/distributed/rpc.py:1-284, copied: it is host-only).

The contract of Paddle's TensorPipe RPC (init_rpc / rpc_sync / rpc_async
/ get_worker_info / shutdown) on plain TCP sockets with length-prefixed
pickle frames:

- every worker serves on a free port;
- the master endpoint (rank 0) runs the rendezvous: each rank registers
  (rank, name, serve endpoint) and blocks until the worker table is
  whole, then every rank receives it;
- rpc_sync / rpc_async connect to the callee's endpoint, send (fn, args,
  kwargs) by pickle and return the result (or raise the remote
  exception). Functions must be importable on the callee.

A host-side control channel; tensors travel by the collectives. Nothing
starts at import: the serving thread and the sockets belong to
`init_rpc`.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "get_worker_info",
           "get_all_worker_infos", "get_current_worker_info", "shutdown",
           "WorkerInfo"]


class WorkerInfo:
    def __init__(self, name: str, rank: int, endpoint: str):
        self.name = name
        self.rank = rank
        self.endpoint = endpoint

    def __repr__(self):
        return (f"WorkerInfo(name={self.name!r}, rank={self.rank}, "
                f"endpoint={self.endpoint!r})")


_STATE: Dict[str, Any] = {
    "initialized": False, "name": None, "rank": None, "workers": {},
    "server": None, "pool": None,
}


# ------------------------------------------------------------ wire format
def _send_msg(sock: socket.socket, obj) -> None:
    blob = pickle.dumps(obj, protocol=4)
    sock.sendall(struct.pack("!Q", len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("rpc peer closed the connection")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket):
    (n,) = struct.unpack("!Q", _recv_exact(sock, 8))
    return pickle.loads(_recv_exact(sock, n))


# ---------------------------------------------------------------- serving
def _advertised_host() -> str:
    """Host other workers can dial: this rank's PADDLE endpoint host when
    the launcher provided one (multi-node), else loopback."""
    ep = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
    if ":" in ep:
        return ep.rsplit(":", 1)[0]
    return "127.0.0.1"


class _Server:
    def __init__(self):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # bind all interfaces; advertise a host remote workers can reach —
        # a loopback advertisement would make cross-host RPC dial itself
        self.sock.bind(("0.0.0.0", 0))
        self.sock.listen(64)
        self.endpoint = "%s:%d" % (_advertised_host(),
                                   self.sock.getsockname()[1])
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.sock.settimeout(0.2)
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn):
        with conn:
            try:
                req = _recv_msg(conn)
            except (ConnectionError, EOFError):
                return
            if req.get("kind") == "call":
                try:
                    fn = req["fn"]
                    result = fn(*req.get("args", ()),
                                **(req.get("kwargs") or {}))
                    _send_msg(conn, {"ok": True, "result": result})
                except Exception as e:  # ship the remote error back
                    _send_msg(conn, {"ok": False, "error": e})
            elif req.get("kind") == "ping":
                _send_msg(conn, {"ok": True})

    def close(self):
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass


# ------------------------------------------------------------- rendezvous
def _master_rendezvous(master: str, rank: int, world: int,
                       name: str, serve_ep: str,
                       timeout: float) -> Dict[str, WorkerInfo]:
    host, port = master.rsplit(":", 1)
    port = int(port)
    deadline = time.monotonic() + timeout
    if rank == 0:
        reg = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        reg.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        reg.bind((host, port))
        reg.listen(world)
        entries = {name: (0, serve_ep)}
        conns = []
        try:
            while len(entries) < world:
                reg.settimeout(max(0.1, deadline - time.monotonic()))
                conn, _ = reg.accept()
                # accepted sockets do NOT inherit the listener timeout — an
                # unbounded recv here would hang init_rpc past its deadline
                conn.settimeout(max(0.1, deadline - time.monotonic()))
                msg = _recv_msg(conn)
                if msg["name"] in entries:
                    err = ValueError(
                        f"duplicate rpc worker name {msg['name']!r} — "
                        "parameterize names by rank")
                    _send_msg(conn, {"error": err})
                    conn.close()
                    raise err
                entries[msg["name"]] = (msg["rank"], msg["endpoint"])
                conns.append(conn)
            table = {n: WorkerInfo(n, r, ep)
                     for n, (r, ep) in entries.items()}
            payload = {n: (w.rank, w.endpoint) for n, w in table.items()}
            for conn in conns:
                _send_msg(conn, payload)
        finally:
            for conn in conns:
                conn.close()
            reg.close()
        return table
    # non-master: register, then wait for the table
    last_err = None
    while time.monotonic() < deadline:
        try:
            sock = socket.create_connection((host, port), timeout=2.0)
            break
        except OSError as e:
            last_err = e
            time.sleep(0.1)
    else:
        raise TimeoutError(f"rpc rendezvous: master {master} unreachable "
                           f"({last_err})")
    with sock:
        sock.settimeout(max(0.1, deadline - time.monotonic()))
        _send_msg(sock, {"rank": rank, "name": name, "endpoint": serve_ep})
        payload = _recv_msg(sock)
    if isinstance(payload, dict) and isinstance(payload.get("error"),
                                                BaseException):
        raise payload["error"]
    return {n: WorkerInfo(n, r, ep) for n, (r, ep) in payload.items()}


# ------------------------------------------------------------- public API
def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None,
             timeout: float = 120.0) -> None:
    if _STATE["initialized"]:
        raise RuntimeError("rpc is already initialized")
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None \
        else rank
    world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", 1)) \
        if world_size is None else world_size
    master_endpoint = master_endpoint or os.environ.get(
        "PADDLE_MASTER_ENDPOINT", "127.0.0.1:29431")

    server = _Server()
    try:
        if world_size <= 1:
            workers = {name: WorkerInfo(name, rank, server.endpoint)}
        else:
            workers = _master_rendezvous(master_endpoint, rank, world_size,
                                         name, server.endpoint, timeout)
    except BaseException:
        server.close()  # no leaked listener thread/port on failed bootstrap
        raise
    _STATE.update(initialized=True, name=name, rank=rank, workers=workers,
                  server=server, pool=ThreadPoolExecutor(max_workers=8))


def _require_init():
    if not _STATE["initialized"]:
        raise RuntimeError("call paddle.distributed.rpc.init_rpc first")


def get_worker_info(name: str) -> WorkerInfo:
    _require_init()
    return _STATE["workers"][name]


def get_all_worker_infos():
    _require_init()
    return sorted(_STATE["workers"].values(), key=lambda w: w.rank)


def get_current_worker_info() -> WorkerInfo:
    _require_init()
    return _STATE["workers"][_STATE["name"]]


def rpc_sync(to: str, fn, args=(), kwargs=None, timeout: float = 120.0):
    """Run `fn(*args, **kwargs)` on worker `to`; blocks for the result."""
    _require_init()
    info = get_worker_info(to)
    host, port = info.endpoint.rsplit(":", 1)
    with socket.create_connection((host, int(port)),
                                  timeout=timeout) as sock:
        _send_msg(sock, {"kind": "call", "fn": fn, "args": tuple(args),
                         "kwargs": dict(kwargs or {})})
        sock.settimeout(timeout)
        reply = _recv_msg(sock)
    if reply["ok"]:
        return reply["result"]
    raise reply["error"]


def rpc_async(to: str, fn, args=(), kwargs=None,
              timeout: float = 120.0) -> Future:
    """Like rpc_sync but returns a Future (``.wait()`` paddle-style or
    ``.result()``)."""
    _require_init()
    fut = _STATE["pool"].submit(rpc_sync, to, fn, args, kwargs, timeout)
    if not hasattr(fut, "wait"):
        fut.wait = fut.result  # paddle's Future exposes wait()
    return fut


def shutdown():
    """Tear down the local server (no global barrier — callers coordinate
    job teardown through the launcher, as the fleetrun contract does)."""
    if not _STATE["initialized"]:
        return
    _STATE["server"].close()
    _STATE["pool"].shutdown(wait=False)
    _STATE.update(initialized=False, name=None, rank=None, workers={},
                  server=None, pool=None)
