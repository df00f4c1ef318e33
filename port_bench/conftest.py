"""The benchmark's own tests (`python -m pytest port_bench -q`): on the CPU
at tiny sizes; tests marked `card` need a CUDA device and skip without one
(run them on the card with `python -m pytest port_bench -q -m card`)."""
import json
from pathlib import Path

import pytest

TINY_MOE = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, intermediate_size=512, num_local_experts=8,
                num_experts_per_tok=2, rope_theta=1e6, rms_norm_eps=1e-5,
                max_position_embeddings=1024)
TINY_GPT2 = dict(vocab_size=512, n_embd=256, n_layer=2, n_head=4, n_positions=1024,
                 layer_norm_epsilon=1e-5)
TINY_MIX = {"loop": "closed", "clients": 6, "slots": 4, "max_seq": 128,
            "prompt": {"mean": 12, "lo": 1}, "output": {"mean": 8, "lo": 1}, "pool": 64,
            "warm_completions": 4, "trace_seconds": 1,
            "check": {"min_tokens": 40, "max_requests": 4, "max_rows": 1024}}
# the tiny cells' limit: the port computes in f32 on the CPU here and reads
# 0 (an f32 rounding at most), the float8 control above it (test_pb_control.py)
TINY_LIMIT = 1e-3


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_bench(tmp_path):
    """(root, manifest) of a checkout holding two tiny cells, `tiny.moe` and
    `tiny.gpt2`, beside the real manifest's cells."""
    (tmp_path / "port_bench" / "traffic").mkdir(parents=True)
    (tmp_path / "port_bench" / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    man = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
    for name, arch, hp in (("moe", "mixtral", TINY_MOE), ("gpt2", "gpt2", TINY_GPT2)):
        conf = {"arch": arch, "hf_config": hp, "compute_dtype": "float32",
                "knobs": {"engine_chunk_size": 16}, "check": {"number": "logit_gap", "limit": TINY_LIMIT}}
        (tmp_path / f"{name}.json").write_text(json.dumps(conf))
        man["configs"].append({"name": f"tiny-{name}", "file": f"{name}.json"})
        man["workloads"].append({"name": f"tiny.{name}", "config": f"tiny-{name}",
                                 "traffic": "tiny", "chips": 1})
    return tmp_path, man
