"""The port's autotuner (utils/autotune.py), its probe kernel K11 and the
knobs it sets, on the CPU: off the card `choose` / `choose_attn` answer
"kernel" / "pallas" without probing, as the reference's do off the TPU; the
decisions are pure functions of the measured rates, held here at the
reference's own pathological case (tests/test_autotune_int4.py:22-37); K11's
plain version is `copy_`. K11 itself and the timings run on the card
(chip_smoke.py)."""
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.utils import autotune as jautotune
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch import ops as tops
from ggml_gfx906_tpu_torch.ops import cuda as kernels
from ggml_gfx906_tpu_torch.ops.attention import _causal_ref
from ggml_gfx906_tpu_torch.ops.cuda import dma_copy
from ggml_gfx906_tpu_torch.ops.cuda import flash_attn as tfa
from ggml_gfx906_tpu_torch.utils import autotune, config as tconfig


def _no_probe(*a, **k):
    raise AssertionError("probed off the card")


def test_cpu_answers_without_probing(monkeypatch):
    monkeypatch.setattr(autotune, "dma_gbs", _no_probe)
    monkeypatch.setattr(autotune, "_measure_dma", _no_probe)
    assert autotune.choose("cpu") == "kernel"
    assert autotune.choose_attn("cpu") == "pallas"


def test_decisions():
    """K11 at 19 GB/s against 747 GB/s of HBM (the reference's tunnel
    runtime): int8 layout and plain attention; a healthy stream picks the
    faster layout and K2."""
    assert autotune.decide_layout(19.0, 747.0) == "int8"
    assert autotune.decide_attn(19.0, 747.0) == "xla"
    assert autotune.decide_attn(2900.0, 3000.0) == "pallas"
    assert autotune.decide_layout(2900.0, 3000.0, t_kernel_s=1e-5, t_int8_s=3e-5) == "kernel"
    assert autotune.decide_layout(dma_gbs=2900.0, hbm_gbs=3000.0, t_kernel_s=3e-5,
                                  t_int8_s=1e-5) == "int8"
    assert autotune.PATHOLOGICAL == 0.25


def test_dma_gbs_cache_round_trip(monkeypatch, tmp_path):
    """Measured once per key, then read from $GGML_TORCH_CACHE."""
    calls = []
    monkeypatch.setenv("GGML_TORCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(autotune, "_card", lambda device: torch.device("cuda"))
    monkeypatch.setattr(autotune, "_cache_key", lambda device: "H100|torch|cuda|v1")
    monkeypatch.setattr(autotune, "_measure_dma", lambda device: calls.append(1) or 2750.5)
    assert autotune.dma_gbs() == 2750.5
    assert autotune.dma_gbs() == 2750.5
    assert len(calls) == 1
    assert (tmp_path / "cache" / "autotune.json").exists()
    assert autotune._read_cache() == {"H100|torch|cuda|v1": {"dma_gbs": 2750.5}}


def test_dma_gbs_wants_the_card():
    with pytest.raises(RuntimeError):
        autotune.dma_gbs("cpu")
    with pytest.raises(RuntimeError):
        autotune.dma_gbs()                   # no CUDA device here: no fallback


def test_k11_plain_on_the_cpu():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 96)).astype(np.float32))
    before = kernels.K11.launches
    out = dma_copy.dma_copy(x)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    buf = torch.zeros_like(x)
    assert dma_copy.dma_copy(x, buf) is buf and torch.equal(buf, x)
    assert kernels.K11.launches == before
    assert kernels.K11 in kernels.KERNELS and kernels.K11.replaces.endswith("autotune.py:142")
    with pytest.raises(ValueError):
        dma_copy.dma_copy(x.double())
    with pytest.raises(ValueError):
        dma_copy.dma_copy(x, torch.zeros((64, 95)))


def test_cache_key_names_the_k11_build(monkeypatch):
    """A rewritten dma_copy.cu is measured again: the key holds its build's
    hash beside the card, torch and CUDA."""
    from ggml_gfx906_tpu_torch.ops.cuda import build

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "H100")
    key = autotune._cache_key(torch.device("cuda"))
    assert key.startswith("H100|") and key.endswith("|" + build.digest("dma_copy"))
    monkeypatch.setattr(build, "digest", lambda name: "rewritten")
    assert autotune._cache_key(torch.device("cuda")) != key


def test_measure_wants_the_card():
    with pytest.raises(RuntimeError):
        autotune.measure("cpu")


def test_knobs_have_the_reference_defaults():
    for name in ("int8_tile", "weights_layout", "attn_impl"):
        assert tconfig.get(name) == jconfig.get(name), name
    for name, bad in (("weights_layout", "int4"), ("attn_impl", "triton")):
        with pytest.raises(ValueError):
            tconfig.set(name, bad)


def test_auto_layout_on_the_cpu(tmp_path):
    """weights_layout="auto" asks choose, which keeps the kernel layout off
    the card."""
    from ggml_gfx906_tpu_torch.models import llama as tllama

    from _torch_port import recipe_cfg, recipe_weights, write_recipe_gguf
    from ggml_gfx906_tpu.quant.types import GGMLType

    cfg = recipe_cfg(n_ff=256, n_layer=1, n_ctx=32)
    path = tmp_path / "q4k.gguf"
    write_recipe_gguf(path, cfg, recipe_weights(lambda *_: GGMLType.Q4_K, cfg))
    tconfig.set("weights_layout", "auto")
    try:
        _, p = tllama.load(path, device="cpu")
    finally:
        tconfig.unset("weights_layout")
    assert p["wte"].layout == p["blocks"][0]["w_down"].layout == "kernel"
    assert jautotune.choose.__wrapped__(verbose=False) == "kernel"   # the reference off the TPU


def test_attn_impl_xla_takes_the_plain_attention(monkeypatch):
    """attn_impl="xla" sends causal_flash_attn to _causal_ref on every
    device; the default takes K2 (its plain version on the CPU)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 3, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 16, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, 16, 32)).astype(np.float32))
    pos = torch.tensor([5, 12], dtype=torch.int32)
    k2 = tops.causal_flash_attn(q, k, v, pos)
    monkeypatch.setattr(tfa, "causal_flash_attention", _no_probe)
    tconfig.set("attn_impl", "xla")
    try:
        ref = tops.causal_flash_attn(q, k, v, pos)
    finally:
        tconfig.unset("attn_impl")
    assert torch.equal(ref, _causal_ref(q, k, v, pos, 1 / 32 ** 0.5, 0.0))
    assert float(((ref - k2) ** 2).mean() / (k2 ** 2).mean()) < 1e-12
