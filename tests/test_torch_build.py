"""The port's kernel build (ops/cuda/build.py) on the CPU: the hash that
names a library in build/torch_kernels/ changes with its source, with any
header in csrc/ (K1, K4, K6, K7, K8 and K9 share qmm_f32_tiled.cuh) and with
the flags, so an edit never reuses a stale library. nvcc itself runs only on the card's
machine (chip_smoke.py)."""
import shutil

import pytest

from ggml_gfx906_tpu_torch.ops.cuda import build


@pytest.fixture
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    return copy


def _digests(csrc):
    return {name: build.digest(name, csrc) for name in build.sources()}


def test_digest_of_a_copy_equals_the_checkout(csrc):
    assert _digests(csrc) == {name: build.digest(name) for name in build.sources()}


# the sources on the shared f32 body: K1, K4, K7, K8 and K6 (qmm_legacy), K9
@pytest.mark.parametrize("name", ["qmm_q4k", "qmm_q6k", "qmm_q5k", "qmm_legacy", "qmm_q23k"])
def test_sources_are_the_cu_files_and_headers_are_hashed(csrc, name):
    assert name in build.sources()
    assert not any(source.endswith(".cuh") for source in build.sources())
    assert '#include "qmm_f32_tiled.cuh"' in (csrc / f"{name}.cu").read_text()


# every f32 entry point on the body: K1, K4, K6, K7, K8 (3), K9 (2)
@pytest.mark.parametrize("fn", ["qmm_q4k_f32", "qmm_q6k_f32", "qmm_q4_0_f32", "qmm_q5k_f32",
                                "qmm_q4_1_f32", "qmm_q5_0_f32", "qmm_q5_1_f32", "qmm_q2k_f32",
                                "qmm_q3k_f32"])
def test_f32_entry_points_launch_the_body(csrc, fn):
    text = (csrc / f"{build.SIGNATURES[fn][0]}.cu").read_text()
    assert '#include "qmm_f32_tiled.cuh"' in text
    body = text[text.index(f'extern "C" int {fn}('):]
    body = body[:body.index("\n}\n")]
    assert "qmm_tiled::launch<" in body


@pytest.mark.parametrize("edit", [b"\n// a comment\n", b" "])
@pytest.mark.parametrize("name", ["qmm_f32_tiled.cuh", "qmm_i8_tiled.cuh"])
def test_a_header_edit_changes_every_digest(csrc, edit, name):
    before = _digests(csrc)
    header = csrc / name
    header.write_bytes(header.read_bytes() + edit)
    after = _digests(csrc)
    assert all(after[name] != before[name] for name in before)


# the int8 kernels' entry points, two each (K3, K5-i8, K6-i8): the x
# quantization (qmm_i8::quant_x) and the product on the int8 body
# csrc/qmm_i8_tiled.cuh (qmm_i8::launch); (entry point, C arguments)
I8_ENTRY_POINTS = [("qmm_q4k_i8_quant_x", 9), ("qmm_q4k_i8", 12),
                   ("qmm_q8_0_i8_quant_x", 7), ("qmm_q8_0_i8", 9),
                   ("qmm_q4_0_i8_quant_x", 9), ("qmm_q4_0_i8", 11)]


@pytest.mark.parametrize("fn,nargs", I8_ENTRY_POINTS)
def test_k3_entry_points_are_bound_and_the_product_launches_the_int8_body(csrc, fn, nargs):
    src = fn.removesuffix("_quant_x").removesuffix("_i8")      # qmm_q4k, qmm_q8_0, qmm_q4_0
    source, argtypes = build.SIGNATURES[fn]
    assert source == src and len(argtypes) == nargs
    text = (csrc / f"{src}.cu").read_text()
    assert '#include "qmm_i8_tiled.cuh"' in text
    body = text[text.index(f'extern "C" int {fn}('):]
    body = body[:body.index("\n}\n")]
    quant = fn.endswith("_quant_x")
    assert ("qmm_i8::launch<" in body) != quant
    assert ("qmm_i8::quant_x<" in body) == quant


def test_the_int8_kernels_keep_no_dp4a_kernel(csrc):
    """K5-i8 and K6-i8 left their dp4a kernels for the int8 body."""
    for src in ("qmm_q8_0", "qmm_q4_0"):
        assert "__dp4a" not in (csrc / f"{src}.cu").read_text()


def test_k2_entry_point_takes_the_partials_and_the_split(csrc):
    """flash_attn_fwd: q, k, v, kd, vd, pos, out, the partials; six ints;
    the two slab strides; scale, softcap, 1/softcap; the K/V type, the
    split and the stream."""
    source, argtypes = build.SIGNATURES["flash_attn_fwd"]
    assert source == "flash_attn" and len(argtypes) == 22
    text = (csrc / "flash_attn.cu").read_text()
    assert "float* out, float* part," in text and "int kv_type, int split, void* stream" in text


def test_a_new_header_changes_every_digest(csrc):
    before = _digests(csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(d != before[name] for name, d in _digests(csrc).items())


def test_a_source_edit_changes_only_its_digest(csrc):
    before = _digests(csrc)
    src = csrc / "qmm_q6k.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    after = _digests(csrc)
    assert {name for name in before if after[name] != before[name]} == {"qmm_q6k"}


def test_the_flags_change_every_digest(csrc, monkeypatch):
    before = _digests(csrc)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert all(d != before[name] for name, d in _digests(csrc).items())


def _digest_with(name, csrc, flags):
    """The digest as build.digest computes it, with the given flags."""
    import hashlib

    h = hashlib.sha256()
    h.update((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def test_per_source_flags_leave_the_other_sources_alone(csrc):
    """Only the IQ searches take flags of their own: every other source
    builds with NVCC_FLAGS and keeps the digest those flags give."""
    assert set(build.SOURCE_FLAGS) == {"iq_search"}
    for name in build.sources():
        if name == "iq_search":
            continue
        assert build.flags(name) == build.NVCC_FLAGS
        assert build.digest(name, csrc) == _digest_with(name, csrc, build.NVCC_FLAGS)


def test_the_searches_build_without_fma_contraction(csrc, monkeypatch):
    """csrc/iq_search.cu: --fmad=false after NVCC_FLAGS (its products and
    sums round as numpy's), never fast math; the flags are in its digest
    and on nvcc's command line."""
    fl = build.flags("iq_search")
    assert fl == build.NVCC_FLAGS + ["--fmad=false"]
    assert not any("fast_math" in f or "fast-math" in f for f in fl)
    assert build.digest("iq_search", csrc) == _digest_with("iq_search", csrc, fl)
    assert build.digest("iq_search", csrc) != _digest_with("iq_search", csrc, build.NVCC_FLAGS)
    cmds = []

    class Proc:
        returncode = 1

        def __init__(self, cmd, **kw):
            cmds.append(cmd)

        def communicate(self):
            return "", None

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    monkeypatch.setattr(build, "BUILD_DIR", csrc.parent / "out")
    with pytest.raises(RuntimeError):
        build.build_all(["iq_search", "qmm_q6k"])
    by_src = {cmd[-1].rsplit("/", 1)[-1]: cmd[1:-3] for cmd in cmds}
    assert by_src == {"iq_search.cu": fl, "qmm_q6k.cu": build.NVCC_FLAGS}


def test_search_entry_points_are_bound(csrc):
    """iq3_search (S1), iq2_search (S2), iq1_search (S3): a type code, x,
    the importance row, its super-blocks, the super-block count, out, the
    three tables, the kmap size and the stream."""
    text = (csrc / "iq_search.cu").read_text()
    for fn in ("iq3_search", "iq2_search", "iq1_search"):
        source, argtypes = build.SIGNATURES[fn]
        assert source == "iq_search" and len(argtypes) == 11
        assert f'extern "C" int {fn}(int type,' in text
