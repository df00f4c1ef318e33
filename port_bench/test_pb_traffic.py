import json
from pathlib import Path

import numpy as np
import pytest

from port_bench.traffic import Mix, pool, quantile_lengths

MIXES = sorted((Path(__file__).parent / "traffic").glob("*.json"))


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_pool_matches_the_mix_file(path):
    mix = json.loads(path.read_text())
    assert mix["source"] and mix["loop"] == "closed"
    for key in ("prompt", "output"):
        spec = mix[key]
        n = quantile_lengths(spec, mix["pool"])
        assert min(n) >= spec["lo"]
        # the pool's mean is the published mean the mix names
        assert abs(np.mean(n) - spec["mean"]) <= 0.01 * spec["mean"] + 1
    pairs = pool(mix)
    assert len(pairs) == mix["pool"]
    assert all(p >= 1 and o >= 1 and p + o < mix["max_seq"] for p, o in pairs)


def test_deterministic_by_seed_and_same_sizes_for_every_seed():
    mix = json.loads(MIXES[0].read_text())
    a, b, c = Mix(mix, 2**33 + 1, 32000), Mix(mix, 2**33 + 1, 32000), Mix(mix, 5, 32000)
    n = mix["clients"]
    ra = [a.request(i % n, i // n) for i in range(4 * n)]
    assert ra == [b.request(i % n, i // n) for i in range(4 * n)]
    rc = [c.request(i % n, i // n) for i in range(4 * n)]
    assert ra != rc
    # the k-th round of requests holds the same sizes for every seed
    for k in range(4):
        sizes = [sorted((len(r.prompt), r.max_new) for r in rr[k * n:(k + 1) * n]) for rr in (ra, rc)]
        assert sizes[0] == sizes[1]
    assert sorted(a.pairs) == sorted(pool(mix))
    assert all(1 <= t < 32000 for r in ra for t in r.prompt)
