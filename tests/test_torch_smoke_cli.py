"""chip_smoke.py's command line on the CPU: --checks names only known
kernel checks, and without a CUDA device the script exits non-zero before
it prints a result line, whatever it was asked to run."""
import pytest

import chip_smoke


def test_unknown_check_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--checks", "q6k,bogus"])
    assert e.value.code != 0
    assert "bogus" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--checks", "q6k,q5k", "--paths", "q4_k_m,q5_k_m"]])
def test_no_card_no_result(argv, capsys):
    assert chip_smoke.main(argv) != 0
    assert '"ok"' not in capsys.readouterr().out


# the checks of the kernels on the shared f32 body: K1, K4, K6, K7, K8, K9
@pytest.mark.parametrize("check", ["qmm", "q6k", "q4_0", "q5k", "legacy", "q23k"])
def test_checks_cover_k4_and_k7_row_invariance(check):
    assert check in chip_smoke.CHECKS
    names = chip_smoke.CHECKS[check].__code__.co_names
    assert "TILED_MS" in names and "check_rows" in names
    assert chip_smoke.TILED_MS[-1] == 128 and 100 in chip_smoke.TILED_MS
    assert set(chip_smoke.ROW_MS) == {1, 8, 16, 63, 100}


def test_attention_check_holds_k2_rows_at_the_chunk_edges():
    """K2's check ends with its rows bit for bit across the window, N, B and
    the split, at positions C - 1, C, C + 1 and 2C + 5 of its chunk C."""
    from ggml_gfx906_tpu_torch.ops.cuda import flash_attn
    c = flash_attn.CHUNK
    assert chip_smoke.EDGE_POS == (c - 1, c, c + 1, 2 * c + 5)
    assert "check_attention_rows" in chip_smoke.CHECKS["attention"].__code__.co_names
    assert "_split" in str(chip_smoke.check_attention_rows.__code__.co_consts)


def _names(code) -> set:
    """The global and attribute names a function uses, its lambdas' too."""
    out = set(code.co_names)
    for c in code.co_consts:
        if hasattr(c, "co_names"):
            out |= _names(c)
    return out


def test_qmm_check_takes_k3_in_its_two_launches_with_digests_and_rows():
    """K3: the x quantization bit for bit at K3_MS, the product against its
    plain version and by sha256, and its rows across M (check_rows)."""
    names = chip_smoke.CHECKS["qmm"].__code__.co_names
    assert {"check_i8", "k3_launches", "K3_MS", "check_rows"} <= set(names)
    assert chip_smoke.K3_MS == (100, 128, 512)
    k3 = _names(chip_smoke.k3_launches.__code__)
    assert {"prepare_i8", "qmm_q4_K_i8_plain", "qmm_q4_K_i8"} <= k3
    assert {"sha256", "equal", "bfloat16"} <= set(chip_smoke.check_i8.__code__.co_names)


# the int8 kernels: (check, its launches, the plain version)
I8 = [("qmm", "k3_launches", "qmm_q4_K_i8_plain"),
      ("q8_0", "k5_i8_launches", "qmm_q8_0_i8_plain"),
      ("q4_0", "k6_i8_launches", "qmm_q4_0_i8_plain")]


@pytest.mark.parametrize("check,launches,plain", I8)
def test_int8_kernels_are_held_in_their_two_launches(check, launches, plain):
    """K3, K5-i8 and K6-i8 go through check_i8 (x quantization against the
    plain x operands, product against the plain version on prepare_i8's,
    sha256) and check_rows; the launches take quantize_x + launch_i8."""
    assert {"check_i8", launches, "check_rows"} <= set(chip_smoke.CHECKS[check].__code__.co_names)
    assert {"prepare_i8", plain} <= _names(getattr(chip_smoke, launches).__code__)
    assert {"quantize_x", "launch_i8"} <= _names(chip_smoke.i8_launches.__code__)
    assert chip_smoke.I8_MS == (64, 100, 128, 512)


# (file recipe, its int8 format struct, its x-quantization map)
I8_TRACES = [("q4_k_m", "Q4KI8", "XQ4K"), ("q3_k_m", "Q4KI8", "XQ4K"),
             ("q8_0", "Q80I8", "XQ80"), ("q4_0", "Q40I8", "XQ40")]


@pytest.mark.parametrize("recipe,fmt,xmap", I8_TRACES)
def test_int8_prefills_are_traced_with_their_kernels_device_time(recipe, fmt, xmap):
    """The prefills that take an int8 kernel are traced, summing the device
    time of the kernel names that csrc/ defines for it."""
    from ggml_gfx906_tpu_torch.ops.cuda import build
    src = "".join(f.read_text() for f in sorted(build.CSRC.iterdir()))
    assert recipe in chip_smoke.RECIPES
    assert {fmt, xmap} <= set(chip_smoke.TRACE_PREFILL[recipe])
    assert f"struct {fmt} {{" in src and f"struct {xmap} {{" in src


def test_q4_k_path_traces_the_long_window_engine_step():
    assert "long_window_step" in chip_smoke.main_path.__code__.co_names
    assert {"BatchedKVCache", "trace_device"} <= set(chip_smoke.long_window_step.__code__.co_names)


def test_q4_k_path_runs_the_graphs_phase_and_the_depth_checks():
    """The 32-layer Q4_K path holds replayed decode against eager decode
    (graphs_phase), its engine at depth 1 against depth 8 (depth_checks),
    and every path traces a depth-8 scan window (scan_window)."""
    names = set(chip_smoke.main_path.__code__.co_names)
    assert {"graphs_phase", "depth_checks", "scan_window", "HAS_GRAPHS"} <= names
    g = _names(chip_smoke.graphs_phase.__code__)
    assert {"decode_chunk", "decode_scan", "decode_step", "step_graph", "equal",
            "expected_launches", "trace_device"} <= g
    assert {"engine_harvest_depth", "SAMPLED"} <= _names(chip_smoke.depth_checks.__code__) \
        | set(chip_smoke.depth_checks.__code__.co_consts)
