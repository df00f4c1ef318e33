"""Port parity: the native tensor transport (parallel/transport.py) and the
model sync of parallel/launch.py against the JAX package's.

Both packages bind the same C++ source (the port builds it into
build/torch_kernels/, the reference uses cpp/'s library), so hashes, the
wire protocol and the disk cache are shared: a port client talks to a
reference server and back. The model sync rebuilds a byte-identical GGUF,
and a torn cached file is rejected by both packages' validation."""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from ggml_gfx906_tpu.parallel import launch as jlaunch
from ggml_gfx906_tpu.parallel import transport as jtransport
from ggml_gfx906_tpu_torch.gguf import GGUFWriter
from ggml_gfx906_tpu_torch.parallel import launch, transport
from ggml_gfx906_tpu_torch.quant.types import GGMLType


def _sha(p) -> str:
    return hashlib.sha256(Path(p).read_bytes()).hexdigest()


def _make_gguf(path, seed=0, n=6):
    w = GGUFWriter()
    w.set("general.architecture", "test")
    w.set("test.block_count", 2)
    rng = np.random.default_rng(seed)
    for i in range(n):
        w.add_array_tensor(f"t{i}", rng.standard_normal((8, 64 * (1 + i % 3))).astype(np.float32))
    # a quantized tensor last, so the torn byte below lands in packed blocks
    w.add_array_tensor("q", rng.standard_normal((16, 256)).astype(np.float32), GGMLType.Q4_K)
    w.write(path)
    return path


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1001])
def test_fnv1a_equals_the_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert transport.fnv1a(data) == jtransport.fnv1a(data)
    assert transport.fnv1a(data.tobytes()) == jtransport.fnv1a(data.tobytes())
    assert transport.fnv1a(b"") == 0xcbf29ce484222325
    assert transport.fnv1a(b"foobar") == 0x85944171f73967e8


@pytest.mark.parametrize("server_mod, client_mod", [(transport, jtransport),
                                                    (jtransport, transport),
                                                    (transport, transport)],
                         ids=["port-server", "ref-server", "port-both"])
def test_round_trips_across_packages(server_mod, client_mod):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    other = rng.standard_normal((16, 33)).astype(np.float32)
    with server_mod.TransportServer() as srv, client_mod.TransportClient(port=srv.port) as c:
        h, deduped = c.put(data)
        assert h == transport.fnv1a(data) and not deduped
        assert c.check(h) and c.get(h) == data
        h2, deduped2 = c.put(data)            # the SET_TENSOR_HASH dedup
        assert h2 == h and deduped2
        h3, _ = c.put(other)
        assert c.get(h3) == other.tobytes()
        assert c.stat() == (2, len(data) + other.nbytes)
        assert c.get(0xdeadbeef) is None and not c.check(0xdeadbeef)
        if client_mod is transport:     # a known size: one transfer; a wrong one still works
            assert c.get(h, len(data)) == c.get(h, 10) == c.get(h, 10 * len(data)) == data
            assert c.get(0xdeadbeef, 64) is None


def test_disk_cache_survives_a_restart_across_packages(tmp_path):
    data = b"persistent tensor bytes" * 1000
    with transport.TransportServer(cache_dir=str(tmp_path)) as srv, \
            transport.TransportClient(port=srv.port) as c:
        h, _ = c.put(data)
    for mod in (jtransport, transport):
        with mod.TransportServer(cache_dir=str(tmp_path)) as srv, \
                mod.TransportClient(port=srv.port) as c:
            assert c.check(h) and c.get(h) == data


def test_distribute_gguf_manifest_equals_the_reference(tmp_path):
    path = _make_gguf(tmp_path / "m.gguf")
    with transport.TransportServer() as srv, transport.TransportClient(port=srv.port) as c:
        manifest = transport.distribute_gguf(path, c)
        fetched = transport.fetch_manifest(manifest, c)
    with jtransport.TransportServer() as srv, jtransport.TransportClient(port=srv.port) as c:
        assert jtransport.distribute_gguf(path, c) == manifest
    raw = path.read_bytes()
    assert all(blob in raw for blob in fetched.values())
    assert sorted(manifest) == sorted(fetched) == sorted([f"t{i}" for i in range(6)] + ["q"])


def test_sync_model_rebuilds_the_file_and_matches_the_reference(tmp_path):
    src = _make_gguf(tmp_path / "m.gguf")
    jsrv, jmanifest = jlaunch.serve_model(src, port=0)
    jsrv.stop()
    ref_json = json.loads(Path(str(src) + ".manifest.json").read_text())
    srv, manifest = launch.serve_model(src, port=0)
    try:
        assert manifest == jmanifest
        assert json.loads(Path(str(src) + ".manifest.json").read_text()) == ref_json
        cache = tmp_path / "worker_cache"
        local = launch.sync_model(src, "127.0.0.1", srv.port, cache, manifest)
        assert Path(local) != src and _sha(local) == _sha(src)
        stamp = local.stat().st_mtime_ns
        # the cache hit: the validated copy is returned without a fetch
        assert launch.sync_model(src, "127.0.0.1", srv.port, cache, manifest) == local
        assert local.stat().st_mtime_ns == stamp
        # the reference's worker rebuilds from the port's server too
        jlocal = jlaunch.sync_model(src, "127.0.0.1", srv.port, tmp_path / "ref_cache", manifest)
        assert _sha(jlocal) == _sha(src)
    finally:
        srv.stop()


def test_torn_last_tensor_is_rejected_by_both(tmp_path):
    src = _make_gguf(tmp_path / "m.gguf")
    srv, manifest = launch.serve_model(src, port=0)
    try:
        cache = tmp_path / "worker_cache"
        cache.mkdir()
        torn = bytearray(src.read_bytes())
        torn[-7] ^= 0xFF     # inside the last tensor's data
        (cache / "m.gguf").write_bytes(bytes(torn))
        assert not launch._validate_local(cache / "m.gguf", manifest)
        assert not jlaunch._validate_local(cache / "m.gguf", manifest)
        assert launch._validate_local(src, manifest) and jlaunch._validate_local(src, manifest)
        local = launch.sync_model(src, "127.0.0.1", srv.port, cache, manifest)
        assert _sha(local) == _sha(src)
    finally:
        srv.stop()


def test_the_library_is_built_from_the_unchanged_source():
    """The port builds cpp/tensor_transport.cc into build/torch_kernels/
    under a name keyed by its digest, and writes nothing into cpp/."""
    from ggml_gfx906_tpu_torch.ops.cuda import build

    cpp = sorted(p.name for p in build.CPP.iterdir())
    path = build.host_library("tensor_transport")
    assert path.parent == build.BUILD_DIR and path.name.startswith("libtensor_transport-")
    assert sorted(p.name for p in build.CPP.iterdir()) == cpp
    assert build.host_library("tensor_transport") == path
