"""The f32 body's tools on the CPU: scripts/torch_body_emu.py (the body's
kernels emulated with g++) and scripts/torch_tiled_pick.py (tiled against
tree on the card) take every format on the body, K1's Q4_K and K6's Q4_0
included, with the C entry points, fields and plain versions the wrappers
use (K5's Q8_0 too). Neither script's kernels run here: the emulation takes minutes and
the timing needs a card."""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from ggml_gfx906_tpu_torch.ops.cuda import build

ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


emu = _script("torch_body_emu")
pick = _script("torch_tiled_pick")
BODY_FORMATS = ["q4_K", "q6_K", "q8_0", "q4_0", "q5_K", "q4_1", "q5_0", "q5_1", "q2_K", "q3_K"]


def test_both_tools_take_every_format_on_the_body():
    assert set(emu.FORMATS) == set(BODY_FORMATS)
    assert set(pick.FORMATS) == set(BODY_FORMATS)


@pytest.mark.parametrize("fmt", BODY_FORMATS)
def test_emulated_format_matches_its_entry_point_and_plain_version(fmt):
    fn, mod, plain_name, spec = emu.FORMATS[fmt]
    source, argtypes = build.SIGNATURES[fn]
    assert source in emu.SOURCES
    assert len(argtypes) == len(spec) + 6          # x, fields, y, M, N, K, stream
    gen = torch.Generator().manual_seed(0)
    n, k = 8, 512
    fields = emu.weights(spec, n, k, gen)
    y = getattr(mod, plain_name)(torch.randn((3, k), generator=gen), *fields)
    assert y.shape == (3, n) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("fmt", BODY_FORMATS)
def test_tiled_pick_format_is_a_case_of_its_switch(fmt):
    index, spec = pick.FORMATS[fmt]
    assert len(spec) == 4                           # four pointer slots, None where unused
    cases = dict(re.findall(r"case (\d+): return pick<(\w+)>", pick.SOURCE))
    default = re.search(r"default: return pick<(\w+)>", pick.SOURCE).group(1)
    struct = cases.get(str(index), default)
    assert struct == {"q4_K": "Q4K", "q6_K": "Q6K", "q8_0": "Q80", "q4_0": "Q40", "q5_K": "Q5K",
                      "q4_1": "Q41", "q5_0": "Q50", "q5_1": "Q51", "q2_K": "Q2K",
                      "q3_K": "Q3K"}[fmt]
    assert sorted(i for i, _ in pick.FORMATS.values()) == list(range(len(BODY_FORMATS)))


def test_emulated_k10_matches_its_plain_version(tmp_path):
    """K10 (csrc/qmm_q4k_pipe.cu) built by the emulator with g++, its
    mbarriers and bulk copies emulated, at shapes that take each of its
    three tile shapes and wrap its ring of stages: check_pipe holds it
    against qmm_q4_K_pipelined_plain (nmse < 1e-10) and raises otherwise."""
    dll = emu.load(emu.emulated(build.CSRC, tmp_path, sources=("qmm_q4k_pipe",)))
    emu.check_pipe(dll, None, torch.Generator().manual_seed(0))
