"""scripts/torch_attn_emu.py on the CPU: K2's order of arithmetic (fixed
128-position chunks, the 16-lane dot and its butterfly, the left fold of
chunk partials) against the JAX package's Pallas kernel in interpret mode,
the row invariance that order gives by construction, and K3's scale fold
and int8 expansion as the kernel forms them against prepare_i8 /
expand_w8, bit for bit. The CUDA kernels themselves run on the card
(chip_smoke.py)."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_gfx906_tpu.ops.pallas import flash_attn as jfa
from ggml_gfx906_tpu_torch.ops.cuda import qmm as tqmm

from _torch_port import nmse

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("torch_attn_emu",
                                               ROOT / "scripts" / "torch_attn_emu.py")
emu = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(emu)
C = emu.CHUNK


def _kv(rng, b, kvh, m, d, dt):
    k = rng.standard_normal((b, kvh, m, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, m, d)).astype(np.float32)
    if dt == "int8":
        kd = (np.abs(k).max(-1) / 127.0).astype(np.float32)
        vd = (np.abs(v).max(-1) / 127.0).astype(np.float32)
        return (np.round(k / kd[..., None]).astype(np.int8),
                np.round(v / vd[..., None]).astype(np.int8), kd, vd)
    return k, v, None, None


# (B, H, KVH, N, M, pos, softcap, K/V type): MHA decode past a chunk edge,
# GQA chunked prefill over two chunks, batched ragged positions with
# softcap, int8 K/V (tests/test_torch_flash_attn.py's kinds of case)
CASES = [(1, 4, 4, 1, 256, 200, 0.0, "f32"),
         (1, 8, 2, 16, 256, 120, 0.0, "f32"),
         (2, 4, 2, 3, 384, [3, 250], 30.0, "f32"),
         (1, 8, 4, 3, 256, 253, 0.0, "int8")]


@pytest.mark.parametrize("b,h,kvh,n,m,pos,softcap,dt", CASES)
def test_k2_order_matches_the_reference_kernel(b, h, kvh, n, m, pos, softcap, dt):
    """nmse < 1e-10 against the interpret-mode Pallas kernel, as K2's plain
    version is held (tests/test_torch_flash_attn.py)."""
    rng = np.random.default_rng(b * 1000 + h * 100 + n + m)
    d = 64
    q = rng.standard_normal((b, h, n, d)).astype(np.float32)
    k, v, kd, vd = _kv(rng, b, kvh, m, d, dt)
    extra = {} if kd is None else dict(k_scale=jnp.asarray(kd), v_scale=jnp.asarray(vd))
    ref = np.asarray(jfa.causal_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos, jnp.int32),
        None, softcap, **extra))
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = emu.k2(t(q), t(k), t(v), torch.tensor(pos), 1.0 / d ** 0.5, softcap, t(kd), t(vd))
    assert nmse(got.numpy(), ref) < 1e-10


@pytest.mark.parametrize("p", [C - 1, C, C + 1, 2 * C + 5])
def test_k2_rows_do_not_depend_on_window_rows_batch_or_split(p):
    """The row at position p has the same bits with the window cut at p + 1
    and at 400, as row 3 of a 7-row prefill, as slot 1 of 3, and with the
    chunk partials folded as they come or kept and folded after (split)."""
    gen = torch.Generator().manual_seed(p)
    d, h, kvh, m = 64, 4, 2, 400
    k = torch.randn((3, kvh, m, d), generator=gen).bfloat16()
    v = torch.randn((3, kvh, m, d), generator=gen).bfloat16()
    q = torch.randn((1, h, 1, d), generator=gen)
    one = emu.k2(q, k[1:2, :, :p + 1], v[1:2, :, :p + 1], [p], 0.125)
    q7 = torch.randn((1, h, 7, d), generator=gen)
    q7[:, :, 3] = q[:, :, 0]
    q3 = torch.randn((3, h, 1, d), generator=gen)
    q3[1] = q[0]
    assert torch.equal(emu.k2(q, k[1:2], v[1:2], [p], 0.125), one)
    assert torch.equal(emu.k2(q7, k[1:2], v[1:2], [p - 3], 0.125)[:, :, 3:4], one)
    assert torch.equal(emu.k2(q3, k, v, [40, p, 390], 0.125)[1:2], one)
    assert torch.equal(emu.k2(q, k[1:2], v[1:2], [p], 0.125, split=3), one)


def _q4k_scales(n, nb, gen):
    scm = torch.randint(0, 64, (n, nb * 16), dtype=torch.uint8, generator=gen)
    dd = torch.rand((n, nb * 2), generator=gen) * 0.003
    scm[0, :16] = 0                 # a superblock whose bound is 0: dw = 0, inv = 0
    scm[1, 8:16] = 0                # mins of 0: dm = 0 throughout a superblock
    scm[2, 16:24:2] = 0             # a lo half with scales 0 but mins not
    dd[3, 1] = 0.0                  # dmin = 0
    return scm, dd


@pytest.mark.parametrize("n,k", [(6, 512), (5, 2816)])
def test_k3_fold_and_expansion_as_the_kernel_forms_them(n, k):
    """K3's fold from scm / dd, step by step in f32, equals prepare_i8's
    dsc', dm' and dw bit for bit (random and edge scales), and the
    expansion's rounding by the 1.5·2^23 sum equals expand_w8's."""
    gen = torch.Generator().manual_seed(n)
    scm, dd = _q4k_scales(n, k // 256, gen)
    qs = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, generator=gen)
    fold = emu.q4k_fold(scm, dd)
    want = tqmm.prepare_i8(torch.randn((2, k), generator=gen), scm, dd)[4:]
    for got, ref in zip(fold, want):
        assert torch.equal(got, ref)
    assert float(fold[4][0, 0]) == 0.0
    for half in (0, 1):
        assert torch.equal(emu.expand_w8(qs, fold[half], fold[2 + half], bool(half)),
                           tqmm.expand_w8(qs, want[half], want[2 + half], bool(half)))


def test_k3_x_quantization_on_the_cpu_is_split_and_quantize():
    """quantize_x, which launches K3's x-quantization kernel on the card,
    gives split_x + quantize_x_tiles' operands on the CPU."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((5, 512), generator=gen)
    x[1, :256] = 0
    xlo, xhi = tqmm.split_x(x)
    want = (*tqmm.quantize_x_tiles(xlo), *tqmm.quantize_x_tiles(xhi))
    got = tqmm.quantize_x(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert float(got[1][1, 0]) == 0.0 and not bool(got[0][1, :128].any())
