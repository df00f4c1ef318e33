"""The control of `correct`: the reference computed in float8 (every
product's operands rounded to e4m3, one scale per row), put in the port's
place at the prompts and served tokens of runs dumped by `run.py --dump`;
it must read a widest logit gap above the configuration's limit, where
the port's own runs read below it.

    python3 port_bench/control.py DUMP.json [DUMP.json ...]

prints one JSON line per dump: the port's gap (served_gap) and the
control's (control_gap), both against the f32 reference."""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dumps", nargs="+")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench import check

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in manifest["configs"]}
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for path in args.dumps:
        d = json.loads(Path(path).read_text())
        conf = json.loads((ROOT / files[d["config"]]).read_text())
        ref = importlib.import_module(f"port_bench.ref.{conf['arch']}")
        out = check.control_gap(ref, conf["hf_config"], d["seed"], d["seqs"], dev)
        print(json.dumps(dict(out, dump=path, workload=d["workload"], seed=d["seed"],
                              limit=conf["check"]["limit"])), flush=True)
        check.free_cuda()
    return 0


if __name__ == "__main__":
    sys.exit(main())
