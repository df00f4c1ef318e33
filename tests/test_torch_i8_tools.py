"""scripts/torch_i8_emu.py on the CPU: K5-i8's and K6-i8's scale fold and
int8 expansion as the int8 body's formats (Q80I8, Q40I8) form them, and the
x quantization as the shared kernel places it (maps XQ4K, XQ40, XQ80),
against the plain operands of ops/cuda (prepare_i8, expand_w8, quantize_x)
bit for bit; and each module's quantize_x, which launches the
x-quantization kernel on the card, against the plain x operands on the CPU.
The CUDA kernels themselves run on the card (chip_smoke.py)."""
import importlib.util
from pathlib import Path

import pytest
import torch

from ggml_gfx906_tpu_torch.ops.cuda import qmm, qmm_q4_0, qmm_q8_0

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("torch_i8_emu", ROOT / "scripts" / "torch_i8_emu.py")
emu = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(emu)


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def _scales(n, k, gen, scale):
    """Random block scales with edge rows: a row of all-zero scales (dw =
    0, inv = 0), negative scales, and a span with one large block."""
    d = torch.rand((n, k // 32), generator=gen) * scale
    d[0] = 0.0
    d[1] = -d[1]
    d[2, 3] = 300.0 * scale
    d[3, 8:16] = 0.0                 # one zero span inside a row
    return d


# (module, fold, K5-i8 or K6-i8's prepare_i8 fold slice)
FOLDS = [(qmm_q8_0, emu.q80_fold, slice(2, 4)), (qmm_q4_0, emu.q40_fold, slice(4, 6))]


@pytest.mark.parametrize("n,k", [(6, 512), (5, 2816)])
@pytest.mark.parametrize("mod,fold,part", FOLDS)
def test_fold_as_the_kernel_forms_it(mod, fold, part, n, k):
    """The fold from d alone, step by step in f32, equals prepare_i8's d'
    and dw bit for bit, random and edge scales alike."""
    gen = torch.Generator().manual_seed(n + k)
    d = _scales(n, k, gen, 1e-3)
    got = fold(d)
    assert _equal(got, mod.prepare_i8(torch.randn((2, k), generator=gen), d)[part])
    assert not bool(got[1][0].any()) and not bool(got[0][0].any())
    assert bool((got[0][1] <= 0).all())


def test_q8_0_expansion_rounds_as_expand_w8():
    """Every quant -128 .. 127 against d' from the fold, and q = -128 in the
    block that sets the bound, whose -128·d' clips at -127."""
    gen = torch.Generator().manual_seed(8)
    n, k = 4, 512
    d = _scales(n, k, gen, 1e-3)
    qs = torch.arange(-128, 128, dtype=torch.int16).repeat(n, 2).to(torch.int8)
    qs[2, 96:128] = -128             # row 2's block 3 holds the large scale
    dsc_f, _ = emu.q80_fold(d)
    got = emu.q80_expand(qs, dsc_f)
    assert torch.equal(got, qmm_q8_0.expand_w8(qs, dsc_f))
    assert int(got[2, 96]) == -127 and int(got.min()) >= -127


@pytest.mark.parametrize("high", [False, True])
def test_q4_0_expansion_rounds_as_expand_w8(high):
    """Every nibble of every byte value, lo and hi, against d' from the fold."""
    gen = torch.Generator().manual_seed(4)
    n, k = 4, 1024
    d = _scales(n, k, gen, 1e-2)
    qs = torch.arange(256, dtype=torch.int32).repeat(n, 2).to(torch.uint8)
    dsc_f, _ = emu.q40_fold(d)
    assert torch.equal(emu.q40_expand(qs, dsc_f, high), qmm_q4_0.expand_w8(qs, dsc_f, high))


# (format, its module, K): Q8_0 also at K % 256 == 128 (its last span's
# second tile is absent)
XQ = [("q4_K", qmm, 768), ("q4_0", qmm_q4_0, 768), ("q8_0", qmm_q8_0, 768),
      ("q8_0", qmm_q8_0, 640)]


@pytest.mark.parametrize("fmt,mod,k", XQ)
def test_x_quantization_as_the_kernel_places_it(fmt, mod, k):
    """Lane l's 8 elements placed by the format's map, each tile's amax met
    over its lane masks: the operands of quantize_x (split_x +
    quantize_x_tiles, or quantize_x_tiles alone) bit for bit, an all-zero
    tile included."""
    gen = torch.Generator().manual_seed(k)
    x = torch.randn((5, k), generator=gen) * 3.0
    x[1, :256] = 0.0
    assert _equal(emu.quant_x(x, fmt), mod.quantize_x(x))


@pytest.mark.parametrize("mod,nx", [(qmm_q8_0, 2), (qmm_q4_0, 4)])
def test_quantize_x_on_the_cpu_is_the_plain_x_operands(mod, nx):
    """quantize_x, which launches the x-quantization kernel on the card,
    gives prepare_i8's x operands on the CPU, for f32 and bf16 x."""
    gen = torch.Generator().manual_seed(nx)
    x = torch.randn((5, 512), generator=gen)
    x[1, :256] = 0.0
    d = torch.rand((3, 16), generator=gen)
    for xx in (x, x.bfloat16()):
        got = mod.quantize_x(xx)
        assert _equal(got, mod.prepare_i8(xx.float(), d)[:nx])
    assert float(got[1][1, 0]) == 0.0 and not bool(got[0][1, :128].any())
