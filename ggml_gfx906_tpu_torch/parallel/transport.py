"""Python binding of the native tensor transport (cpp/tensor_transport.cc),
the port of ggml_gfx906_tpu/parallel/transport.py.

The weight-distribution fabric across hosts: content-addressed PUT/GET over
TCP with FNV-1a dedup — the replacement for the reference RPC backend's
SET_TENSOR_HASH weight upload path (src/ggml-rpc/ggml-rpc.cpp:569-592).
Execution is not offloaded over this channel: collectives are
torch.distributed's (parallel/launch.py::initialize). Typical use: the
coordinator serves the GGUF tensor blobs; each worker fetches by hash with
a local disk cache, then memmaps.

The C++ source is the reference's, unchanged; it is built at first use by
ops/cuda/build.py::host_library into build/torch_kernels/ (never into
cpp/, which holds the reference's own committed library). The wire protocol
is the same, so a client of either package talks to a server of either.
"""
from __future__ import annotations

import ctypes

import numpy as np

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from ..ops.cuda import build

    lib = ctypes.CDLL(str(build.host_library("tensor_transport")))
    lib.tt_fnv1a.restype = ctypes.c_uint64
    lib.tt_fnv1a.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tt_server_start.restype = ctypes.c_void_p
    lib.tt_server_start.argtypes = [ctypes.c_uint16, ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_uint16)]
    lib.tt_server_stop.argtypes = [ctypes.c_void_p]
    lib.tt_connect.restype = ctypes.c_void_p
    lib.tt_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
    lib.tt_close.argtypes = [ctypes.c_void_p]
    lib.tt_check.restype = ctypes.c_int
    lib.tt_check.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.tt_put.restype = ctypes.c_int
    lib.tt_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
    lib.tt_get.restype = ctypes.c_int64
    lib.tt_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                           ctypes.c_uint64]
    lib.tt_stat.restype = ctypes.c_int
    lib.tt_stat.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                            ctypes.POINTER(ctypes.c_uint64)]
    lib.tt_shutdown.restype = ctypes.c_int
    lib.tt_shutdown.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _bytes(data: bytes | np.ndarray) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8) if isinstance(data, bytes) \
        else np.ascontiguousarray(data).view(np.uint8).reshape(-1)


def fnv1a(data: bytes | np.ndarray) -> int:
    """FNV-1a 64 — the reference's constants (ggml-rpc.cpp:223)."""
    buf = _bytes(data)
    return int(_load().tt_fnv1a(buf.ctypes.data, buf.size))


class TransportServer:
    """In-process native server (the accept loop runs on a C++ thread)."""

    def __init__(self, port: int = 0, cache_dir: str | None = None):
        lib = _load()
        actual = ctypes.c_uint16(0)
        self._h = lib.tt_server_start(
            port, str(cache_dir).encode() if cache_dir else None, ctypes.byref(actual))
        if not self._h:
            raise OSError("failed to start transport server")
        self.port = actual.value

    def stop(self):
        if self._h:
            _load().tt_server_stop(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class TransportClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._c = _load().tt_connect(host.encode(), port)
        if not self._c:
            raise ConnectionError(f"cannot connect to {host}:{port}")

    def check(self, hash_: int) -> bool:
        r = _load().tt_check(self._c, hash_)
        if r < 0:
            raise ConnectionError("check failed")
        return bool(r)

    def put(self, data: bytes | np.ndarray) -> tuple[int, bool]:
        """Upload (deduped). Returns (hash, was_deduped)."""
        buf = _bytes(data)
        h = fnv1a(buf)
        r = _load().tt_put(self._c, buf.ctypes.data, buf.size)
        if r < 0:
            raise ConnectionError("put failed")
        return h, r == 2

    def get(self, hash_: int, size: int | None = None) -> bytes | None:
        """The blob of `hash_`, or None if the server has none. The native
        GET into a buffer too small for the blob drains it and reports its
        size, so an unknown size costs two transfers (as the reference's
        binding always does); a caller that knows the size (`size`, e.g. a
        tensor's n_bytes) gets it in one."""
        lib = _load()
        n = size if size is not None else lib.tt_get(self._c, hash_, None, 0)
        if n < 0:
            return None
        out = np.empty(n, np.uint8)
        n2 = lib.tt_get(self._c, hash_, out.ctypes.data, out.size)
        if n2 != n:
            return None if n2 < 0 else self.get(hash_, n2)
        return out.tobytes()

    def stat(self) -> tuple[int, int]:
        """(blobs held, their bytes) on the server."""
        a, b = ctypes.c_uint64(), ctypes.c_uint64()
        if _load().tt_stat(self._c, ctypes.byref(a), ctypes.byref(b)) != 0:
            raise ConnectionError("stat failed")
        return a.value, b.value

    def shutdown_server(self):
        _load().tt_shutdown(self._c)

    def close(self):
        if self._c:
            _load().tt_close(self._c)
            self._c = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def distribute_gguf(path, client: TransportClient) -> dict[str, int]:
    """Push every tensor blob of a GGUF to the store (content-deduped);
    returns the name → hash manifest — the coordinator half of model
    distribution."""
    from ..gguf import GGUFReader

    r = GGUFReader(path)
    return {name: client.put(np.ascontiguousarray(r.tensor_bytes(name)))[0]
            for name in r.tensors}


def fetch_manifest(manifest: dict[str, int], client: TransportClient) -> dict[str, bytes]:
    """The worker half: fetch tensor blobs by hash."""
    return {name: client.get(h) for name, h in manifest.items()}
