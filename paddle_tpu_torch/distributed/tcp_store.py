"""paddle.distributed.TCPStore (counterpart of
paddle_tpu/distributed/tcp_store.py:25-140): a ctypes binding over the
port's copy of the native store, `csrc/tcp_store.cc`, which
`_build.load_host` compiles with `g++` at first use (nothing is built at
import).

The master (`is_master=True`) starts the in-process server and a client
of it; workers connect as clients. `set` / `get` (which waits for the
key) / `wait` / `add` (an atomic counter, read back as 8 little-endian
bytes by `get`) and a reusable counter barrier over `world_size`
participants. torch's own TCPStore is not used: it keeps `add` counters
as decimal text.
"""
from __future__ import annotations

import ctypes
from typing import Optional

__all__ = ["TCPStore"]


def _lib():
    from .._build import load_host

    lib = load_host("tcp_store")
    if not getattr(lib, "_ptt_bound", False):
        lib.ts_server_start.restype = ctypes.c_void_p
        lib.ts_server_start.argtypes = [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.ts_server_stop.restype = None
        lib.ts_server_stop.argtypes = [ctypes.c_void_p]
        lib.ts_client_connect.restype = ctypes.c_void_p
        lib.ts_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                          ctypes.c_int]
        lib.ts_client_close.restype = None
        lib.ts_client_close.argtypes = [ctypes.c_void_p]
        lib.ts_set.restype = ctypes.c_int
        lib.ts_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.ts_get.restype = ctypes.c_int
        lib.ts_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
                               ctypes.c_int]
        lib.ts_add.restype = ctypes.c_int
        lib.ts_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int, ctypes.c_longlong,
                               ctypes.POINTER(ctypes.c_longlong)]
        lib._ptt_bound = True
    return lib


class TCPStore:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 30.0):
        lib = _lib()
        self._lib = lib
        self._server = None
        self._client = None
        self.host = host
        self.timeout_ms = int(timeout * 1000)
        self.world_size = world_size
        if is_master:
            out_port = ctypes.c_int(0)
            self._server = lib.ts_server_start(port, ctypes.byref(out_port))
            if not self._server:
                raise RuntimeError(f"TCPStore master failed to bind port "
                                   f"{port}")
            port = out_port.value
        self.port = port
        self._client = lib.ts_client_connect(host.encode(), port,
                                             self.timeout_ms)
        if not self._client:
            if self._server:
                lib.ts_server_stop(self._server)
                self._server = None
            raise RuntimeError(f"TCPStore could not connect to {host}:{port}")

    def set(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()
        k = key.encode()
        if self._lib.ts_set(self._client, k, len(k), data, len(data)) != 0:
            raise RuntimeError("TCPStore set failed (connection lost)")

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        """The key's value; blocks until the key exists (TimeoutError past
        `timeout` seconds, the store's timeout by default)."""
        k = key.encode()
        tmo = self.timeout_ms if timeout is None else int(timeout * 1000)
        buf = ctypes.create_string_buffer(1 << 20)
        n = self._lib.ts_get(self._client, k, len(k), buf, len(buf), tmo)
        if n == -1:
            raise TimeoutError(f"TCPStore get({key!r}) timed out")
        if n < 0:
            raise RuntimeError(f"TCPStore get({key!r}) failed (code {n})")
        return buf.raw[:n]

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        for k in ([keys] if isinstance(keys, str) else keys):
            self.get(k, timeout)

    def add(self, key: str, amount: int = 1) -> int:
        k = key.encode()
        out = ctypes.c_longlong(0)
        if self._lib.ts_add(self._client, k, len(k), amount,
                            ctypes.byref(out)) != 0:
            raise RuntimeError("TCPStore add failed (connection lost)")
        return int(out.value)

    def barrier(self, name: str = "barrier",
                timeout: Optional[float] = None) -> None:
        """A reusable barrier over `world_size` participants: each pass
        is an epoch of the counter, so a barrier in a loop synchronizes
        every time."""
        arrived = self.add(f"__barrier/{name}", 1)
        epoch = (arrived - 1) // self.world_size
        if arrived % self.world_size == 0:
            self.set(f"__barrier/{name}/release/{epoch}", b"1")
        self.get(f"__barrier/{name}/release/{epoch}", timeout)

    def close(self) -> None:
        if self._client:
            self._lib.ts_client_close(self._client)
            self._client = None
        if self._server:
            self._lib.ts_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.close()
        except (AttributeError, OSError):
            # interpreter teardown: the library may already be gone
            pass
