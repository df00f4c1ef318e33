"""A whole run of the harness at tiny sizes on the CPU (the look for a card
skipped), sound and with its timed path broken."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ggml_gfx906_tpu_torch.runtime import engine as engine_mod
from port_bench import run

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**33 + 17


def _run(root, man, capsys, cell="tiny.moe", trace=0, seconds=2):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
                   "--trace", str(trace)], device="cpu", manifest=man, root=root)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("cell", ["tiny.moe", "tiny.gpt2"])
def test_a_sound_run_is_correct(tiny_bench, capsys, cell):
    rc, out, err = _run(*tiny_bench, capsys, cell=cell)
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert list(res)[-1] == "checks" and "logit_gap" in res["checks"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert {"gen_tok_s", "setup_s"} <= set(res["metrics"])
    assert err.strip().splitlines()[-1].startswith("logit_gap ")
    setup = json.loads(next(l for l in err.splitlines() if l.startswith("setup: "))[7:])
    assert setup["captures_in_window"] == 0     # every window the loop reached was warmed


def test_a_traced_run_reports_its_per_layer_metrics(tiny_bench, capsys):
    rc, out, err = _run(*tiny_bench, capsys, trace=1)
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    for name in ("engine.window_ms", "engine.tokens_per_window", "model.step_mfu",
                 "device.idle_share"):
        assert name in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_token_altered_where_it_is_produced_is_caught(tiny_bench, capsys, monkeypatch):
    real = engine_mod.sample_batch

    def altered(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine_mod, "sample_batch", altered)
    rc, out, err = _run(*tiny_bench, capsys)
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["logit_gap"]["value"] > res["checks"]["logit_gap"]["limit"]


def test_no_card_no_result(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "gpt2l.short", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "no result" in err


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "gpt2l.short",
                        "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""

