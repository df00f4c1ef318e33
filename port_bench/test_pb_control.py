"""The control of `correct`: the reference in float8 reads a logit gap above
the limit where the port reads below it. At tiny sizes on the CPU here; at
the cells' own sizes on the card (`-m card`, from dumps of real runs)."""
import json
from pathlib import Path

import pytest
import torch

from port_bench import check, run
from port_bench.conftest import TINY_GPT2, TINY_LIMIT, TINY_MOE
from port_bench.ref import gpt2, mixtral

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("ref,hp", [(mixtral, TINY_MOE), (gpt2, TINY_GPT2)],
                         ids=["moe", "gpt2"])
@pytest.mark.parametrize("seed", [2**33 + 1, 2**33 + 2, 2**33 + 3])
def test_the_float8_control_fails_the_tiny_limit(ref, hp, seed):
    g = torch.Generator().manual_seed(seed % 2**31)
    seqs = [(torch.randint(1, 512, (40,), generator=g).tolist(),
             torch.randint(1, 512, (24,), generator=g).tolist()) for _ in range(4)]
    # served tokens: the f32 reference's own greedy choice at each position
    lg = ref.logits(hp, seed, seqs, "cpu")
    best = lg.argmax(-1).tolist()
    seqs = [(p, best[24 * i:24 * i + 24]) for i, (p, _) in enumerate(seqs)]
    out = check.control_gap(ref, hp, seed, seqs, "cpu")
    assert out["control_gap"] > TINY_LIMIT


@pytest.mark.card
def test_the_control_at_the_cells_size(card, tmp_path):
    """One short run per cell; its control fails the cell's limit: the port
    with the lower-precision path of `check.control_knobs` switched on, or
    else the float8 reference at the run's dumped prompts and tokens."""
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in man["configs"]}
    for w in man["workloads"]:
        conf = json.loads((ROOT / files[w["config"]]).read_text())
        number, limit = conf["check"]["number"], conf["check"]["limit"]
        dump = tmp_path / f"{w['name']}.json"
        argv = ["--workload", w["name"], "--seed", "3000000011", "--seconds", "8", "--trace", "0"]
        assert run.main(argv + ["--dump", str(dump)]) == 0
        d = json.loads(dump.read_text())
        assert d["check"][number]["value"] <= limit
        knobs = conf["check"].get("control_knobs")
        if knobs:
            ctl = tmp_path / f"{w['name']}.control.json"
            extra = sum((["--knob", f"{k}={json.dumps(v)}"] for k, v in knobs.items()), [])
            assert run.main(argv + extra + ["--dump", str(ctl)]) == 0
            reading = json.loads(ctl.read_text())["check"][number]["value"]
        else:
            ref = {"mixtral": mixtral, "gpt2": gpt2}[conf["arch"]]
            reading = check.control_gap(ref, conf["hf_config"], d["seed"], d["seqs"],
                                        card)["control_gap"]
        assert reading > limit
