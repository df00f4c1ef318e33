"""What the harness and the reference load, compared by whole top-level
module names: never JAX or the JAX package (`ggml_gfx906_tpu`, whose name
the port's begins with), and the reference nothing of the port."""
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PROBE = """
import sys, runpy
sys.path.insert(0, {root!r})
for m in {mods!r}:
    __import__(m)
for name in {files!r}:
    runpy.run_path(name)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(mods, files=()):
    code = PROBE.format(root=str(ROOT), mods=list(mods), files=[str(f) for f in files])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert p.returncode == 0, p.stderr
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    mods = ["port_bench.run", "port_bench.driver", "port_bench.trace", "port_bench.check",
            "port_bench.context", "port_bench.port.mixtral", "port_bench.port.gpt2",
            "ggml_gfx906_tpu_torch.runtime.engine"]
    top = _top_level(mods, sorted((ROOT / "port_bench" / "metrics").glob("*.py")))
    assert "ggml_gfx906_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "ggml_gfx906_tpu"}


@pytest.mark.parametrize("mod", ["port_bench.ref.mixtral", "port_bench.ref.gpt2",
                                 "port_bench.quant"])
def test_the_reference_loads_nothing_of_the_port(mod):
    top = _top_level([mod])
    assert not top & {"jax", "jaxlib", "flax", "ggml_gfx906_tpu", "ggml_gfx906_tpu_torch"}
