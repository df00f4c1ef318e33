"""chip_smoke.py's command line on the CPU: --checks names only known
kernel checks, and without a CUDA device the script exits non-zero before
it prints a result line, whatever it was asked to run."""
import pytest

import chip_smoke
from _torch_port import one_torch_thread  # noqa: F401


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


def test_serving_runtime_phases_are_on_the_paths():
    """Every path holds engine == generate where both take one route
    (engine_vs_generate); the Q4_0 path holds its flooded streams against
    generate at int8_min_m = 0 (f32_route_check); the 32-layer Q4_K path
    runs the admission and kv_variants phases, each skipped on a tree
    without the flood or the int8 cache."""
    names = set(chip_smoke.main_path.__code__.co_names)
    assert {"engine_vs_generate", "f32_route_check", "admission_phase", "kv_variants_phase",
            "HAS_FLOOD", "HAS_KV_VARIANTS", "I8_KERNELS"} <= names
    import inspect

    assert {"record_function", "trace_device", "K3_TRACE_NAMES"} \
        <= _names(inspect.unwrap(chip_smoke.admission_phase).__code__)
    assert {"delta_window_check", "_timed_serve", "first_divergence"} \
        <= _names(inspect.unwrap(chip_smoke.kv_variants_phase).__code__)
    assert {"scan_window", "forward_batch", "WindowDelta"} \
        <= _names(chip_smoke.delta_window_check.__code__)


def test_serving_runtime_phases_run_on_the_cpu(monkeypatch):
    """The smoke's new phases run end to end on a tiny model on the CPU
    (the card's synchronisation, memory statistics and traces stubbed, K2's
    launches counted around its wrapper): the streams checks hold, a flood
    fills the 8 slots, the int8 engine's steps launch K2 on int8 K/V, the
    paged engines give the dense streams, the delta window stays within its
    bound."""
    import dataclasses

    import numpy as np
    import torch

    from _torch_port import tiny_models
    from ggml_gfx906_tpu.quant.types import GGMLType
    from ggml_gfx906_tpu_torch.ops import cuda as kernels
    from ggml_gfx906_tpu_torch.ops.cuda import flash_attn

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "trace_device", lambda fn, match=(): (fn(), {
        "busy_ms": 1.0, "device_activities": 0, "profiled_wall_ms": 1.0, "matched_ms": 0.0,
        "top_ms": []})[1])
    monkeypatch.setattr(chip_smoke, "N_NEW", 6)
    k2 = flash_attn.causal_flash_attention

    def counted(*a, **k):
        kernels.K2.launches += 1
        return k2(*a, **k)

    monkeypatch.setattr(flash_attn, "causal_flash_attention", counted)
    _, _, tcfg, tp = tiny_models(GGMLType.Q4_K, seed=2, n_ctx=1024)
    cfg = dataclasses.replace(tcfg, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in (3, 5, 8, 12, 16, 20, 24, 30)]
    long_prompt = [int(t) for t in rng.integers(1, 256, 150)]
    dev = torch.device("cpu")
    eng = chip_smoke.Engine(chip_smoke.llama, cfg, tp, max_batch=8, max_seq=1024, device=dev)
    done = chip_smoke.serve(eng, prompts + [long_prompt], 6)
    ev = chip_smoke.engine_vs_generate("q4_k", cfg, tp, dev, prompts, done, int8_route=True)
    assert ev["asserted"] == [] and set(ev["recorded"]) == {len(p) for p in prompts}
    assert chip_smoke.f32_route_check(dev, cfg, tp, prompts, long_prompt)["floods"] == [8]
    ad = chip_smoke.admission_phase(dev, cfg, tp, prompts, long_prompt, done)
    assert ad["floods"] == [8] * 4 and ad["calls"]["engine.chunk"] == 2
    kv = chip_smoke.kv_variants_phase(dev, cfg, tp, prompts, long_prompt, done)
    assert kv["kv_quant"]["k2_kv_dtypes"] == ["torch.int8"]
    assert kv["kv_quant"]["launches_per_replayed_step"] == {"causal_flash_attention": 2}
    assert kv["paged"]["kv_bytes"] < 0.6 * kv["dense"]["kv_bytes"]
    assert max(kv["delta"]["logits_nmse_per_step"]) <= kv["delta"]["bound"]


def test_tools_phase_is_on_the_q4_k_path():
    """The 32-layer Q4_K path runs the tools phase on its file before the
    file goes (keep_file), and its launches join the kernels line."""
    import inspect

    src = inspect.getsource(chip_smoke.main_path)
    assert "tools_phase" in src and "keep_file" in src
    assert '"tools"' in inspect.getsource(chip_smoke.main)
    assert {"spec_generate", "model_spec_generate", "perplexity_llama", "verify_step",
            "cli_phase", "ppl_reference_nll", "ppl_window_count"} \
        <= _names(inspect.unwrap(chip_smoke.tools_phase).__code__)
    assert chip_smoke.SPEC_KS == (8, 7)
    assert chip_smoke.ppl_window_count(2048, 512, 128) == 512 + 3 * 384 - 1
    assert chip_smoke.ppl_window_count(70, 32, 8) == 32 + 24


def test_tools_phase_runs_on_the_cpu(monkeypatch, tmp_path):
    """The tools phase end to end on a tiny Q4_K GGUF with the synthetic
    vocabulary on the CPU (the card's synchronisation and traces stubbed,
    K1's and K2's launches counted around their wrappers): speculative ==
    generate at k = 8 and 7 and with the layer-skip draft, the verify step's
    launches as its tensor types predict, perplexity's bookkeeping against
    llama.forward's logits, and the CLI against generate and the Engine."""
    import dataclasses

    import torch

    from ggml_gfx906_tpu_torch.ops import cuda as kernels
    from ggml_gfx906_tpu_torch.ops.cuda import dispatch, flash_attn
    from ggml_gfx906_tpu_torch.quant.types import GGMLType

    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "trace_device", lambda fn, match=(): (fn(), {
        "busy_ms": 1.0, "device_activities": 0, "profiled_wall_ms": 1.0, "matched_ms": 0.0,
        "top_ms": []})[1])
    for name, val in (("N_NEW", 5), ("SPEC_NEW", 10), ("SPEC_SEQ", 256), ("PPL_TOKENS", 96),
                      ("PPL_CTX", 32), ("SERVE_WORDS", (3, 6, 9, 40))):
        monkeypatch.setattr(chip_smoke, name, val)

    def counted(kern, fn):
        def run(*a, **k):
            kern.launches += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(flash_attn, "causal_flash_attention",
                        counted(kernels.K2, flash_attn.causal_flash_attention))
    monkeypatch.setitem(dispatch._KERNELS, (GGMLType.Q4_K, "f32"),
                        counted(kernels.K1, dispatch._KERNELS[(GGMLType.Q4_K, "f32")]))
    path = tmp_path / "tiny_q4_k.gguf"
    small = dict(n_vocab=512, n_ctx=512, n_embd=256, n_head=4, n_kv_head=2, n_ff=512)
    chip_smoke.write_gguf(path, small, 2, "q4_k", random_scales=True)
    cfg, params = chip_smoke.llama.load(path, device="cpu")
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    out = chip_smoke.tools_phase(torch.device("cpu"), cfg, params, 2, path)
    assert set(out["spec"]) == {"repetitive", "plain"}
    for row in out["spec"].values():
        assert {"k8", "k7", "draft4_k4"} <= set(row)
    assert out["verify_step"]["k8"]["launches"] == {"qmm_q4_K": 15, "causal_flash_attention": 2}
    assert out["self_draft_k4"]["accepted_per_step"][0] == 4
    pp = out["perplexity"]
    assert pp["n_tokens"] == chip_smoke.ppl_window_count(96, 32, 8) and pp["windows"] == 3
    assert out["cli"]["serve_requests"] == 4 and "tok/s" in out["cli"]["spec_rate"]
    assert not (tmp_path / "smoke_prompts.txt").exists()


def test_quantize_phase_runs_on_the_cpu(monkeypatch):
    """The quantize phase end to end on a tiny 2-layer model on the CPU
    (the card's synchronisation and memory statistics stubbed; K1, K3, K5,
    K5-i8 and K2 counted around their wrappers): convert to F16, the
    imatrix, the four files quantized (S1-S3 counted around their wrapper),
    their sampled rows against the CPU
    codec, each loaded and generating with the launches its types predict,
    the Q4_K file's fields against QuantTensor.quantize, every codec's
    checks, and no file left behind."""
    import torch

    from ggml_gfx906_tpu_torch.ops import cuda as kernels
    from ggml_gfx906_tpu_torch.ops.cuda import dispatch, flash_attn, iq_search
    from ggml_gfx906_tpu_torch.quant.types import GGMLType

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    for name, val in (("N_NEW", 4), ("QUANT_CHUNK", 48), ("QUANT_ROWS", 16),
                      ("QUANT_TYPE_ROWS", 16), ("QUANT_RATE_ROWS", 8)):
        monkeypatch.setattr(chip_smoke, name, val)

    def counted(kern, fn):
        def run(*a, **k):
            kern.launches += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(flash_attn, "causal_flash_attention",
                        counted(kernels.K2, flash_attn.causal_flash_attention))
    for key, kern in (((GGMLType.Q4_K, "f32"), kernels.K1), ((GGMLType.Q4_K, "i8"), kernels.K3),
                      ((GGMLType.Q8_0, "f32"), kernels.K5), ((GGMLType.Q8_0, "i8"), kernels.K5_I8)):
        monkeypatch.setitem(dispatch._KERNELS, key, counted(kern, dispatch._KERNELS[key]))
    search = iq_search.quantize

    def counted_search(t, x, qw=None):
        iq_search.ROUTES[t][0].launches += 1
        return search(t, x, qw)

    monkeypatch.setattr(iq_search, "quantize", counted_search)
    small = dict(n_vocab=512, n_ctx=512, n_embd=256, n_head=4, n_kv_head=2, n_ff=512)
    out = chip_smoke.quantize_phase(torch.device("cpu"), small, 2)
    assert out["imatrix_launches"] == {"causal_flash_attention": 4}
    files = out["files"]
    assert set(files) == {"q4_k", "q8_0", "iq4_xs", "iq2_xxs"}
    assert files["q4_k"]["launches"] == {"qmm_q4_K": 3 * 15, "qmm_q4_K_i8": 15,
                                         "causal_flash_attention": 4 * 2}
    assert files["q8_0"]["launches"] == {"qmm_q8_0": 3 * 15, "qmm_q8_0_i8": 15,
                                         "causal_flash_attention": 4 * 2}
    for name in ("iq4_xs", "iq2_xxs"):
        assert files[name]["launches"] == {"causal_flash_attention": 4 * 2}
        assert files[name]["layouts"] == ["int8"]
    # S2 once per matrix (each one chunk of rows): the head, token_embd, 7 a layer
    assert files["iq2_xxs"]["quantize_launches"] == {"iq2_search": 2 + 7 * 2}
    assert files["q4_k"]["quantize_launches"] == {}
    assert files["q4_k"]["fields_equal_quantize"] == "blk.0.attn_q.weight"
    for name, row in files.items():
        assert set(row["rows_equal_cpu"].values()) == {16 if name != "iq2_xxs" else 4}
    # every type without an importance row where it takes none (21), and
    # with one where it takes (18) or ignores (5) one
    assert len(out["codecs"]) == 21 + 18 + 5
    assert not list((chip_smoke.ROOT / "build").glob("smoke_llama7b_*_L2.gguf"))


def test_family_recipes_follow_llama_cpp_q4_k_m():
    """The families' files in llama.cpp's Q4_K_M: Mixtral's attn_k / attn_v
    Q8_0 and attn_output Q5_K (8 experts), GPT-2's attn_qkv Q5_K and tied
    head Q6_K, attn_v / ffn_down Q6_K in the use_more_bits layers (0, 3, 6
    and 7 of 8); the launches of a decode step and a 128-token chunk per
    kernel; the Mixtral decode step's weight stream."""
    from ggml_gfx906_tpu_torch.quant.types import GGMLType

    mix, gpt2_l, gptj = (chip_smoke.FAMILIES[n][0] for n in ("mixtral", "gpt2_large", "gptj"))
    t = chip_smoke.family_type
    assert [t(mix, n, 1, 8) for n in ("attn_q", "attn_k", "attn_v", "attn_output")] == \
        [GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q8_0, GGMLType.Q5_K]
    assert [t(mix, "ffn_down_exps", i, 8) for i in range(8)].count(GGMLType.Q6_K) == 4
    assert t(mix, "ffn_down_exps", 3, 8) == GGMLType.Q6_K == t(mix, "output", None, 8)
    assert t(gpt2_l, "attn_qkv", 5, 36) == GGMLType.Q5_K == t(gptj, "attn_qkv", 0, 8)
    assert t(gpt2_l, "token_embd", None, 36) == GGMLType.Q6_K
    assert t(gptj, "token_embd", None, 8) == GGMLType.Q4_K
    assert t(gptj, "attn_v", 7, 8) == GGMLType.Q6_K and t(gptj, "attn_v", 1, 8) == GGMLType.Q4_K
    step = chip_smoke.family_launches(mix, 8, 1)
    assert step == {"causal_flash_attention": 8, "qmm_q4_K": 8 + 2 * 8 * 8 + 4 * 8,
                    "qmm_q8_0": 16, "qmm_q5_K": 8, "qmm_q6_K": 1 + 4 * 8}
    chunk = chip_smoke.family_launches(mix, 8, 128)
    assert chunk["qmm_q4_K_i8"] == 8 + 2 * 8 * 8 + 4 * 8 and chunk["qmm_q8_0_i8"] == 16
    assert chip_smoke.family_launches(gpt2_l, 36, 1)["qmm_q5_K"] == 36
    assert 7.1e9 < chip_smoke.family_bytes(mix, 8) < 7.2e9


def test_families_phase_runs_on_the_cpu(monkeypatch):
    """The families phase end to end on tiny models of the three families on
    the CPU (the card's synchronisation, memory statistics and traces
    stubbed; every kernel on their paths counted around its wrapper): the
    tiny card-vs-CPU check, each file's launches as its types predict,
    decode_step == eager, engine == generate (MoE, GPT-2; for GPT-2 also a
    request to n_ctx), the offload split and the CLI, and no family file
    left behind."""
    import torch

    from ggml_gfx906_tpu_torch.ops import cuda as kernels
    from ggml_gfx906_tpu_torch.ops.cuda import dispatch, flash_attn, iq_search
    from ggml_gfx906_tpu_torch.quant.types import GGMLType

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "trace_device", lambda fn, match=(): (fn(), {
        "busy_ms": 1.0, "device_activities": 0, "profiled_wall_ms": 1.0, "matched_ms": 0.0,
        "top_ms": []})[1])
    for name, val in (("N_NEW", 4), ("SERVE_WORDS", (3, 6, 9, 40)),
                      ("PARITY_LENS", (5, 9, 70))):
        monkeypatch.setattr(chip_smoke, name, val)

    def counted(kern, fn):
        def run(*a, **k):
            kern.launches += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(flash_attn, "causal_flash_attention",
                        counted(kernels.K2, flash_attn.causal_flash_attention))
    for key, kern in (((GGMLType.Q4_K, "f32"), kernels.K1), ((GGMLType.Q4_K, "i8"), kernels.K3),
                      ((GGMLType.Q6_K, "f32"), kernels.K4), ((GGMLType.Q8_0, "f32"), kernels.K5),
                      ((GGMLType.Q8_0, "i8"), kernels.K5_I8), ((GGMLType.Q5_K, "f32"), kernels.K7)):
        monkeypatch.setitem(dispatch._KERNELS, key, counted(kern, dispatch._KERNELS[key]))
    tiny = {name: (chip_smoke.TINY_FAMILIES[arch], 2)
            for name, arch in (("mixtral", "moe"), ("gpt2_large", "gpt2"), ("gptj", "gptj"))}
    monkeypatch.setattr(chip_smoke, "FAMILIES", tiny)
    out = chip_smoke.families_phase(torch.device("cpu"), list(tiny))
    assert set(out["small"]) == {f"{a}_nmse_{n}_tokens" for a in ("moe", "gpt2", "gptj")
                                 for n in (7, 70)}
    mix = out["mixtral"]
    assert mix["launches_per_decode_step"] == chip_smoke.family_launches(tiny["mixtral"][0], 2, 1)
    # attn_q 2, gate and up 2 x 2 x 8 experts, layer 0's ffn_down 8 (layer 1's is Q6_K)
    assert mix["launches_per_prefill_chunk_128"]["qmm_q4_K_i8"] == 2 + 2 * 2 * 8 + 8
    assert mix["replayed_logits_equal_eager"] and mix["offload"]["logits_nmse"] < 1e-9
    assert mix["engine_vs_generate"]["asserted"] == [70]
    assert out["gpt2_large"]["cli"]["serve_requests"] == 4
    assert out["gpt2_large"]["to_n_ctx"]["equal_generate"]
    assert out["gpt2_large"]["to_n_ctx"]["prompt_tokens"] == 1024 - 4
    assert "engine_tok_s" not in out["gptj"] and out["gptj"]["launches"]["qmm_q6_K"] > 0
    assert not list((chip_smoke.ROOT / "build").glob("smoke_*_L2.gguf"))


def test_vision_paths_are_accepted(capsys):
    """--paths vision names phase 9; without a card the run still stops
    before any phase and prints no result line."""
    assert chip_smoke.main(["--checks", "none", "--paths", "vision"]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_vision_phase_runs_on_the_cpu(monkeypatch):
    """The vision phase end to end on the CPU at tiny sizes (the card's
    synchronisation, memory statistics, the event timer and traces stubbed):
    YOLOv3-tiny at 128 on a 96x150 photo, a 96-wide 4-layer SAM at image
    256 cut to 3 layers for the card-vs-CPU check, Magika on 10 files; its
    outputs checked, no counted kernel launched, no file left behind."""
    import time

    import torch

    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "trace_device", lambda fn, match=(): (fn(), {
        "busy_ms": 1.0, "device_activities": 0, "profiled_wall_ms": 1.0, "matched_ms": 0.0,
        "top_ms": []})[1])

    class HostTimer:
        def __init__(self, device):
            pass

        def __call__(self, fn, iters=20, warmup=3):
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(chip_smoke, "Timer", HostTimer)
    for name, val in (("YOLO_NET", 128), ("YOLO_IMAGE", (3, 96, 150)),
                      ("SAM_VIT_B", dict(n_enc_state=96, n_enc_layer=4, n_enc_head=12,
                                         n_img_size=256)),
                      ("MAGIKA_FILES", 10), ("MAGIKA_MAX_BYTES", 5000)):
        monkeypatch.setattr(chip_smoke, name, val)
    out = chip_smoke.vision_phase(torch.device("cpu"))
    yo, sa, mg = out["yolo"], out["sam"], out["magika"]
    assert yo["layer_15_shape"] == [1, 255, 4, 4] and yo["layer_22_shape"] == [1, 255, 8, 8]
    assert yo["layer_15_nmse"] == 0.0 and yo["tf32_conv_nmse"] == 0.0
    assert sa["shapes"] == [[1, 256, 16, 16], [1, 4, 64, 64], [1, 4]]
    assert sa["check_masks_nmse"] == 0.0 and sa["encode_flops"] > 0
    assert mg["files"] == 10 and mg["max_abs_err"] < 1e-6 and mg["labels_equal"]
    assert not any(out["launches"].values())
    assert not [m for m in ("yolo", "sam", "magika")
                if (chip_smoke.ROOT / "build" / f"smoke_{m}.gguf").exists()]


def test_training_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The training phase end to end on the CPU at tiny sizes (the card's
    synchronisation, memory statistics, the event timer and the trace
    stubbed): K2's gradient at N = 16, MNIST fc and cnn on 2,000 images at
    batch 100, a 2-layer 64-wide GPT-2 of vocab 96 on 32 sequences; its
    outputs checked, no counted kernel launched, no file left behind; and
    `--paths training` is taken (here it stops at the missing card)."""
    import time

    import torch

    assert chip_smoke.main(["--paths", "training", "--checks", "none"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "trace_device", lambda fn, match=(): (fn(), {
        "busy_ms": 1.0, "device_activities": 0, "profiled_wall_ms": 1.0, "matched_ms": 0.0,
        "top_ms": []})[1])

    class HostTimer:
        def __init__(self, device):
            pass

        def __call__(self, fn, iters=20, warmup=3):
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(chip_smoke, "Timer", HostTimer)
    for name, val in (("K2_GRAD_N", 16), ("MNIST_IMAGES", 2000), ("MNIST_TEST", 300),
                      ("MNIST_BATCH", 100), ("GPT2_IDS", 16),
                      ("GPT2_CHECK", (1, 16)),
                      ("GPT2_124M", dict(n_vocab=96, n_ctx=32, n_embd=64, n_head=4,
                                         n_layer=2))):
        monkeypatch.setattr(chip_smoke, name, val)
    out = chip_smoke.training_phase(torch.device("cpu"))
    for row in out["k2_grad"].values():
        assert row["bit_equal_to_plain"] and row["nmse_vs_cpu"] == 0.0 and row["flops"] > 0
        assert row["fwd_nmse_vs_plain"] == 0.0 and row["bound_ms"] > 0
    for arch in ("fc", "cnn"):
        r = out["mnist"][arch]
        assert r["steps_nmse_vs_cpu"] == 0.0 and r["resume_bit_equal"]
        assert r["grads_nmse_vs_cpu"] == [0.0] * 3 and r["worst_leaf"]["differ"] == 0
        assert r["accuracy"] > chip_smoke.MNIST_ACC[arch] and len(r["train_loss"]) == 2
    assert out["mnist"]["cnn"]["tf32_steps_nmse_vs_cpu"] == 0.0
    g2 = out["gpt2"]
    assert g2["micro_batches"] == 8 and g2["adamw_steps"] == 4 and g2["deterministic"]
    assert g2["losses"][-1] < g2["losses"][0] and max(g2["check_nmse"]) == 0.0
    assert g2["flops_per_micro_batch"] > 0 and g2["cross_entropy_fwd_bwd_ms"] > 0
    assert not any(out["launches"].values())
    assert not [p for p in (chip_smoke.ROOT / "build").glob("smoke_*mnist*")]
    assert not [p for p in (chip_smoke.ROOT / "build").glob("smoke_ckpt_*")]


def test_parallel_phase_runs_on_the_cpu(monkeypatch, capsys):
    """The parallel phase end to end on the CPU at tiny sizes (the card's
    synchronisation and traces stubbed in this process): the world-size-1
    mesh (gloo here, NCCL on the card) bit-equal to the mesh-free forward,
    generate and Engine; then two spawned gloo ranks: tp = 2 logits within
    their bounds on the f32 and the int8 route and engine == tp_decode_step
    streams, dp = 2 engine == the mesh-free engine, ep = 2 == mul_mat_id
    bit for bit, both ring schedules and pp = 2 within their bounds; no
    file left behind;
    and `--paths parallel` is taken (here it stops at the missing card)."""
    import torch

    assert chip_smoke.main(["--paths", "parallel", "--checks", "none"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "trace_device", lambda fn, match=(): (fn(), {
        "busy_ms": 1.0, "device_activities": 0, "profiled_wall_ms": 1.0, "matched_ms": 0.0,
        "top_ms": []})[1])
    monkeypatch.setattr(chip_smoke, "N_NEW", 4)
    monkeypatch.setattr(chip_smoke, "PARITY_LENS", (3, 5, 8, 12, 16, 20, 24, 30))
    sizes = {"cfg": dict(n_vocab=512, n_ctx=1024, n_embd=512, n_head=4, n_kv_head=2,
                         n_ff=1024, rope_base=500000.0),
             "layers": 2, "ep": (4, 256, 256), "ep_tokens": 40, "sp": (1, 4, 2, 64, 16),
             "pp": (2, 2, 8)}
    out = chip_smoke.parallel_phase(torch.device("cpu"), sizes)
    nc = out["nccl"]
    assert nc["backend"] == "gloo" and not nc["captured"]
    assert nc["nccl_window"]["tokens"] == nc["mesh_free_window"]["tokens"] > 0
    t2 = out["tp2"]
    assert t2["logits_f32_nmse"] < 1e-9 and t2["logits_nmse"] < t2["logits_bound"]
    assert t2["logits_int8_route_nmse"] < t2["logits_int8_route_bound"] == chip_smoke.TP_INT8_BOUND
    assert t2["engine_asserted"] == [
        3, 5, 8, 12, 16, 20, 24, 30, 300]
    assert not t2["engine_captured"] and t2["all_reduces_per_step"] == 4
    assert out["dp2"]["slots_per_rank"] == 4
    assert out["ep2"]["equal"] and out["ep2"]["local"] == 2
    for sched in ("contiguous", "zigzag"):
        assert out["sp2"][sched]["nmse"] < chip_smoke.SP_BOUND
    assert out["pp2"]["nmse"] < chip_smoke.PP_BOUND
    assert out["tp2_rank1"]["logits_nmse"] == t2["logits_nmse"]
    assert not list((chip_smoke.ROOT / "build").glob("smoke_llama3_*"))


def test_tp_check_holds_the_shard_shapes():
    """Phase 3's `tp` check takes K1, K3 and K4 at the Llama-3-8B-width
    file's tp = 2 shard shapes beside the whole shapes they are cut from;
    n_ff 14336 splits by column at tp = 2 on superblocks, 11008 does not."""
    cfg = chip_smoke.LLAMA3_8B
    D, FF = cfg["n_embd"], cfg["n_ff"]
    KVD = cfg["n_kv_head"] * D // cfg["n_head"]
    want = {((D // 2, D), (D, D)), ((KVD // 2, D), (KVD, D)), ((FF // 2, D), (FF, D)),
            ((D, D // 2), (D, D)), ((D, FF // 2), (D, FF))}
    assert {pair for pair, _, _ in chip_smoke.TP_SHAPES} == want
    assert {pair[0] for pair, _, q6 in chip_smoke.TP_SHAPES if q6} == {(KVD // 2, D), (D, FF // 2)}
    assert (FF // 2) % 256 == 0 and (11008 // 2) % 256 != 0
    names = _names(chip_smoke.CHECKS["tp"].__code__)
    assert {"check_f32", "check_i8", "k3_launches", "qmm_q6_K_plain"} <= names
