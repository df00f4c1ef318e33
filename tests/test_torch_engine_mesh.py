"""The serving engine on a mesh (runtime/engine.py's mesh branches, parallel/
tp.py's engine programs) against the JAX package's Engine on the same mesh:
the reference tests/test_engine.py's mesh cases (:137, :290, :383) at tp = 2
and dp = 2 × tp = 2, dense and paged, greedy and sampled, with
engine_window_delta pinned off on both sides (the port's default; the
reference's is on) and, where the flood runs, int8_min_m = 0 on both (every
product on the exact route). The port's ranks are gloo processes
(tests/_torch_mesh.py); every rank returns the same streams."""
import pytest

import _torch_mesh as tm
from _torch_port import one_torch_thread  # noqa: F401
from _torch_port import cfg_fields, jax_params_to_numpy, tp_cfg, tp_qparams
from ggml_gfx906_tpu.models import llama as jllama
from ggml_gfx906_tpu.parallel import make_mesh as jmake_mesh
from ggml_gfx906_tpu.parallel.tp import shard_llama_params as jshard_llama
from ggml_gfx906_tpu.runtime.engine import Engine as JEngine
from ggml_gfx906_tpu.utils import config as jconfig

CFG = tp_cfg(n_vocab=256, n_ctx=64)
SAMPLED = dict(temp=0.8, top_k=8, top_p=0.9)

# (case, params seed, weight scale, dp, tp, paged pages, prompts, new tokens,
#  max_batch, sampling, the flood's int8_min_m pin)
CASES = {
    "tp2": (9, 0.05, 1, 2, None, [[1, 2, 3], [9, 8, 7, 6]], 5, 2, None, False),
    "tp2_paged": (9, 0.05, 1, 2, 8, [[1, 2, 3], [9, 8, 7, 6]], 5, 2, None, False),
    "dp2_tp2_paged": (17, 0.05, 2, 2, 8, [[1, 2, 3], [9, 8, 7, 6]], 5, 2, None, False),
    "dp2_tp2_sampled": (17, 0.05, 2, 2, None, [[1, 2, 3], [9, 8, 7, 6], [4, 4], [5]], 6, 4,
                        SAMPLED, True),
    "flood_scan": (23, 0.1, 2, 2, None, [[1, 2, 3], [9, 8, 7, 6], [4, 4], [5]], 8, 4, None,
                   True),
    "flood_scan_paged": (23, 0.1, 2, 2, 16, [[1, 2, 3], [9, 8, 7, 6], [4, 4], [5]], 8, 4, None,
                         True),
}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tm.start_pool(tmp_path_factory, 4)
    yield p
    p.close()


_PARAMS = {}


def _params(seed, scale):
    if (seed, scale) not in _PARAMS:
        _PARAMS[seed, scale] = tp_qparams(CFG, seed, scale)
    return _PARAMS[seed, scale]


def _knobs(pin_m: bool) -> dict:
    k = {"engine_window_delta": False, "kv_page_size": 16}
    if pin_m:
        k["int8_min_m"] = 0
    return k


def _jax_streams(params, dp, tp, pages, prompts, n_new, max_batch, sample, pin_m):
    knobs = _knobs(pin_m)
    mesh = jmake_mesh(dp=dp, tp=tp)
    for k, v in knobs.items():
        jconfig.set(k, v)
    try:
        eng = JEngine(jllama, CFG, jshard_llama(mesh, params), max_batch=max_batch,
                      max_seq=64, mesh=mesh, paged_pages=pages)
        rids = [eng.submit(p, n_new, seed=31 + i, **(sample or {}))
                for i, p in enumerate(prompts)]
        done = {r.rid: r.out for r in eng.run()}
    finally:
        for k in knobs:
            jconfig.unset(k)
    return [done[r] for r in rids]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_streams_match_jax(pool, case):
    seed, scale, dp, tp, pages, prompts, n_new, max_batch, sample, pin_m = CASES[case]
    params = _params(seed, scale)
    want = _jax_streams(params, dp, tp, pages, prompts, n_new, max_batch, sample, pin_m)
    got = pool.run(tm.engine_run, cfg_fields(CFG), jax_params_to_numpy(params), prompts, n_new,
                   dp, tp, _knobs(pin_m), pages, max_batch, [31 + i for i in range(len(prompts))],
                   sample, case.startswith("flood"))
    for r in got[:dp * tp]:
        assert r["streams"] == want, (r["streams"], want)
        assert r["kv_slots"] == max_batch // dp and r["kv_heads"] == CFG.n_kv_head // tp
        assert not r["captured"]                     # the CPU: direct calls
        if case.startswith("flood"):
            # the flood admitted, decode ran as scan windows, at most the
            # final drain on per-step dispatches
            assert r["hits"]["flood"] >= 1, r["hits"]
            assert r["hits"]["scan"] >= 1 and r["hits"]["step"] <= 2, r["hits"]
    assert all(r is None for r in got[dp * tp:])
