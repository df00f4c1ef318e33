"""Port parity: the models CLI (models/cli.py) and perplexity's command.
One tiny Q4_K llama GGUF with the smoke's synthetic SentencePiece
vocabulary goes through the JAX CLI and the port's (`--device cpu`):
equal stdout for greedy, `--spec 4` and seeded sampled generate, equal
`serve` lines at --max-batch 2 (dense, int8 KV, paged pool; window delta
off on the JAX side, the port's default), the same for tiny gpt2, gptj and
expert-llama files in the Q4_K_M recipe (serve for gpt2 and the expert
llama), what the port does not serve (an unknown architecture, serve on
gptj, --spec beyond the dense llama), perplexity.main, and `python -m` of
the CLI."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from ggml_gfx906_tpu.gguf import GGUFReader as JReader
from ggml_gfx906_tpu.models import cli as jcli
from ggml_gfx906_tpu.models import perplexity as jppl
from ggml_gfx906_tpu.quant.types import GGMLType
from ggml_gfx906_tpu.utils import config as jconfig
from ggml_gfx906_tpu_torch.gguf import GGUFWriter
from ggml_gfx906_tpu_torch.models import cli as tcli
from ggml_gfx906_tpu_torch.models import perplexity as tppl
from ggml_gfx906_tpu_torch.utils import config as tconfig

from _torch_port import (one_torch_thread, recipe_cfg, recipe_weights,  # noqa: F401
                         write_recipe_gguf)

ROOT = Path(__file__).resolve().parents[1]
N_VOCAB = 512
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    cfg = recipe_cfg(512, n_layer=2, n_ctx=256, n_vocab=N_VOCAB)
    path = tmp_path_factory.mktemp("cli") / "tiny_q4_k_spm.gguf"
    write_recipe_gguf(path, cfg, recipe_weights(lambda *a: GGMLType.Q4_K, cfg, seed=11),
                      vocab=True)
    return str(path)


def _prompt(seed, n_words=6):
    return chip_smoke.synthetic_text(n_words, seed, N_VOCAB)


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    return cap.out, cap.err


@pytest.fixture
def restore_configs():
    """The CLIs set config kv_quant globally (as the reference's does):
    restore both packages' configs after each test."""
    yield
    for c in (jconfig, tconfig):
        c.unset("kv_quant")
        c.unset("engine_window_delta")


GENERATE = {"greedy": ["--greedy"], "spec": ["--spec", "4"],
            "sampled": ["-s", "3", "--temp", "0.8"]}


@pytest.mark.parametrize("mode", list(GENERATE))
def test_generate_stdout_equals_reference(model, capsys, mode):
    argv = ["-m", model, "-p", _prompt(1), "-n", "8"] + GENERATE[mode]
    want, _ = _run(jcli.main, argv, capsys)
    got, err = _run(tcli.main, argv + CPU, capsys)
    assert got == want and got.strip()
    assert "prompt tokens:" in err and "device: cpu" in err
    if mode == "spec":
        assert "accept" in err and "tok/verify" in err
        greedy, _ = _run(tcli.main, argv[:-2] + ["--greedy"] + CPU, capsys)
        assert got == greedy


SERVE = {"dense": [], "kv_quant": ["--kv-quant"], "paged": ["--paged-pages", "3"]}


@pytest.mark.parametrize("mode", list(SERVE))
def test_serve_lines_equal_reference(model, capsys, tmp_path, restore_configs, mode):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(_prompt(s, n) for s, n in ((2, 3), (3, 9), (4, 5))) + "\n")
    argv = (["serve", "-m", model, "--prompts", str(prompts), "-n", "5", "--max-batch", "2",
             "--max-seq", "64"] + SERVE[mode])
    jconfig.set("engine_window_delta", False)
    want, _ = _run(jcli.main, argv, capsys)
    tconfig.unset("kv_quant")
    got, err = _run(tcli.main, argv + CPU, capsys)
    assert tconfig.get("kv_quant") is ("--kv-quant" in argv)
    lines = got.splitlines()
    assert sorted(ln.split("]")[0] for ln in lines) == ["[0", "[1", "[2"]
    assert got == want
    assert "tok/s aggregate" in err and "device: cpu" in err


def _arch_file(path, arch, experts=0):
    w = GGUFWriter()
    w.set("general.architecture", arch)
    if experts:
        w.set("llama.expert_count", experts)
    chip_smoke.write_vocab(w, N_VOCAB)
    w.add_array_tensor("dummy", np.zeros(4, np.float32))
    w.write(path)
    return str(path)


@pytest.fixture(scope="module")
def family_files(tmp_path_factory):
    """Tiny GGUFs of the three other families in llama.cpp's Q4_K_M recipe,
    with the synthetic SentencePiece vocabulary (chip_smoke's writer); the
    expert llama with 4 experts (the reference's interpret-mode kernels
    take most of this file's time)."""
    d = tmp_path_factory.mktemp("families")
    out = {}
    for arch, fcfg in chip_smoke.TINY_FAMILIES.items():
        if arch == "moe":
            fcfg = dict(fcfg, n_expert=4)
        out[arch] = d / f"tiny_{arch}.gguf"
        chip_smoke.write_family_gguf(out[arch], fcfg, 2, random_scales=True)
    return {k: str(v) for k, v in out.items()}


@pytest.fixture
def reference_reads_stacked_experts(monkeypatch):
    """The reference's moe.load splits a quantized expert stack's blocks as
    (E·n_out, nb) rows (its :234-238), which its reader gives as (E, n_out,
    nb): the blocks are handed to it flattened."""
    real = JReader.tensor_blocks
    monkeypatch.setattr(JReader, "tensor_blocks",
                        lambda self, name: (lambda b: b.reshape(-1, b.shape[-1]))(real(self, name)))


@pytest.mark.parametrize("arch", ["gpt2", "gptj", "moe"])
def test_family_cli_equals_reference(family_files, capsys, tmp_path, restore_configs,
                                     reference_reads_stacked_experts, arch):
    """gpt2, gptj and the expert llama are served: greedy generate's stdout
    equals the reference CLI's, and for gpt2 and the expert llama so do the
    `serve` lines at --max-batch 2 (window delta off on the JAX side, the
    port's default)."""
    path = family_files[arch]
    argv = ["-m", path, "-p", _prompt(4), "-n", "6", "--greedy"]
    want, _ = _run(jcli.main, argv, capsys)
    got, err = _run(tcli.main, argv + CPU, capsys)
    assert got == want and got.strip() and "device: cpu" in err
    if arch == "gptj":
        return
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(_prompt(s, n) for s, n in ((2, 3), (3, 9), (4, 5))) + "\n")
    argv = ["serve", "-m", path, "--prompts", str(prompts), "-n", "4", "--max-batch", "2",
            "--max-seq", "64"]
    jconfig.set("engine_window_delta", False)
    want, _ = _run(jcli.main, argv, capsys)
    got, err = _run(tcli.main, argv + CPU, capsys)
    assert got == want and sorted(ln.split("]")[0] for ln in got.splitlines()) == \
        ["[0", "[1", "[2"]


@pytest.mark.parametrize("case", ["falcon generate", "falcon serve", "gptj serve",
                                  "gpt2 --spec", "moe --spec"])
def test_architectures_not_served_exit_1(family_files, tmp_path, capsys, case):
    """What the port does not serve exits 1 and says why: an architecture
    it does not know (falcon), as in the reference, for both commands;
    `serve` on a gptj file (no batched forward: the reference's Engine
    would fail); `--spec` on anything but the dense llama, as in the
    reference."""
    arch, cmd = case.split()
    path = _arch_file(tmp_path / "falcon.gguf", "falcon") if arch == "falcon" \
        else family_files[arch]
    prompts = tmp_path / "p.txt"
    prompts.write_text("ab\n")
    argv = (["serve", "-m", path, "--prompts", str(prompts)] if cmd == "serve"
            else ["-m", path, "-p", "ab"] + (["--spec", "4"] if cmd == "--spec" else []))
    assert tcli.main(argv + CPU) == 1
    err = capsys.readouterr().err
    want = {"falcon": "unsupported architecture 'falcon'",
            "gptj": "serve needs a batched forward",
            "gpt2": "--spec supports the llama architecture",
            "moe": "--spec supports the llama architecture"}[arch]
    assert want in err


def test_perplexity_main_matches_reference(model, capsys, tmp_path):
    text = tmp_path / "corpus.txt"
    text.write_text(chip_smoke.synthetic_text(90, 5, N_VOCAB))
    argv = ["--model", model, "--text", str(text), "--n-ctx", "32"]
    want, _ = _run(jppl.main, argv, capsys)
    got, _ = _run(tppl.main, argv + CPU, capsys)

    def nums(line):   # "ppl = P  (nll N over T tokens)"
        f = line.replace("(", " ").split()
        return float(f[2]), float(f[4]), int(f[6])

    (p, n, t), (wp, wn, wt) = nums(got), nums(want)
    assert t == wt and t > 32
    assert abs(p - wp) / wp < 2e-3, (got, want)


def test_python_dash_m_runs_the_cli(model):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "ggml_gfx906_tpu_torch.models.cli", "-m", model,
                          "--tokens", "1,5,9", "-n", "3", "--greedy"] + CPU,
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() and "generated 3 tokens" in res.stderr
