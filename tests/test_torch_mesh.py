"""The port's mesh (ggml_gfx906_tpu_torch/parallel/mesh.py) against the JAX
package's: every rank's shards from shard_array, shard_quant_tensor and
shard_gpt2_params equal the JAX arrays' addressable shards on the device at
the rank's coordinates, field for field (the JAX kernel layout's fields
through the port's converter), in the kernel and int8 layouts;
QuantTensor.localize's shapes; a column shard's product is its part of
the unsharded product. The ranks are four gloo processes started once for
the file (tests/_torch_mesh.py)."""
import numpy as np
import pytest
import torch

import _torch_mesh as tm
from _torch_port import one_torch_thread  # noqa: F401
from _torch_port import jax_params_to_numpy, jax_shard_of, tp_cfg, tp_qparams
from ggml_gfx906_tpu.models import gpt2 as jgpt2
from ggml_gfx906_tpu.ops.quantized import QuantTensor as JQuantTensor
from ggml_gfx906_tpu.ops.quantized import to_int8_layout as j_to_int8
from ggml_gfx906_tpu.parallel import make_mesh as jmake_mesh
from ggml_gfx906_tpu.parallel import mesh as jmesh_mod
from ggml_gfx906_tpu.parallel import tp as jtp
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor, dequant, qmatmul
from ggml_gfx906_tpu_torch.parallel import P
from ggml_gfx906_tpu_torch.parallel.mesh import Mesh, shard_quant_tensor
from ggml_gfx906_tpu_torch.quant.types import GGMLType
from jax.sharding import PartitionSpec as JP

CFG = tp_cfg()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = tm.start_pool(tmp_path_factory, 4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jparams():
    return tp_qparams(CFG)


def _port_fields(jfields: dict, qtype, local_shape, layout: str) -> dict:
    """A JAX shard's fields as the port's (the kernel layout converted)."""
    if layout == "int8":
        return jfields
    qt = QuantTensor.from_reference_kernel_layout(qtype, local_shape, jfields, "cpu")
    return {k: v.numpy() for k, v in qt.fields.items()}


def _check_quant(jqt, got: list, jmesh, local_shape):
    for r in got:
        if r is None:
            continue
        sh = r["shards"]["w"]
        assert sh["shape"] == sh["local_shape"] == local_shape
        jf = {k: jax_shard_of(v, jmesh, r["coords"]) for k, v in jqt.fields.items()}
        want = _port_fields(jf, jqt.qtype, local_shape, jqt.layout)
        assert set(want) == set(sh["fields"])
        for k, v in want.items():
            np.testing.assert_array_equal(sh["fields"][k], v, err_msg=k)


@pytest.mark.parametrize("layout", ["kernel", "int8"])
def test_row_shards_match_jax(pool, jparams, layout):
    """shard_quant_tensor(P('tp', None)) of a Q4_K weight at dp = 2 × tp = 2:
    the kernel layout's fields on axis 0, the int8 layout's on axis 1."""
    jqt = jparams["blocks"][0]["wq"]
    if layout == "int8":
        jqt = j_to_int8(jqt)
    jm = jmake_mesh(dp=2, tp=2)
    jsh = jmesh_mod.shard_quant_tensor(jm, jqt, JP("tp", None))
    tree = {"w": jax_params_to_numpy(jqt)}
    got = pool.run(tm.mesh_shards, tree, 2, 2, {"w": ("tp", None)})
    _check_quant(jsh, got, jm, (CFG.n_embd // 2, CFG.n_embd))


@pytest.mark.parametrize("layout", ["kernel", "int8"])
@pytest.mark.parametrize("name", ["wo", "w_down"])
def test_column_shards_match_jax(pool, jparams, layout, name):
    """shard_quant_tensor(P(None, 'tp')) against the JAX tp placement of wo
    and w_down (column splits at superblock / tile boundaries; the JAX
    tp.py's per-field specs, which its shard_map programs slice by: axis 1
    of the kernel layout's fields, axis 0, the K-tiles, of the int8
    layout's)."""
    w = jparams["blocks"][1][name]
    if layout == "int8":
        w = j_to_int8(w)
    jm = jmake_mesh(dp=1, tp=2)
    fs = jtp._field_spec(w, jtp.COL)
    jqt = JQuantTensor(w.qtype, w.shape, {k: jmesh_mod.shard_array(jm, v, fs(v))
                                          for k, v in w.fields.items()}, w.layout)
    got = pool.run(tm.mesh_shards, {"w": jax_params_to_numpy(w)}, 1, 2, {"w": (None, "tp")})
    n, k = w.shape
    _check_quant(jqt, got, jm, (n, k // 2))


def test_shard_array_matches_jax(pool, jparams):
    jm = jmake_mesh(dp=2, tp=2)
    wte = jparams["wte"]
    specs = {"rows": ("tp", None), "cols": (None, "tp"), "both": ("dp", "tp"),
             "rep": ()}
    tree = {k: np.asarray(wte) for k in specs}
    got = pool.run(tm.mesh_shards, tree, 2, 2, specs)
    for r in got:
        for k, spec in specs.items():
            want = jax_shard_of(jmesh_mod.shard_array(jm, wte, JP(*spec)), jm, r["coords"])
            np.testing.assert_array_equal(r["shards"][k], want, err_msg=k)


def test_gpt2_shards_match_jax(pool):
    """shard_gpt2_params under GPT2_RULES on dense gpt2 params at tp = 2
    (the JAX package's shard_quant_tensor replicates a quantized weight's
    column split, the port splits it: only dense trees compare)."""
    cfg = jgpt2.GPT2Config(n_vocab=128, n_ctx=32, n_embd=64, n_head=4, n_layer=2)
    params = jgpt2.random_params(cfg, seed=4)
    jm = jmake_mesh(dp=1, tp=2)
    jsh = jmesh_mod.shard_gpt2_params(jm, params)
    got = pool.run(tm.gpt2_shards, jax_params_to_numpy(params), 2)
    for rank, r in enumerate(got):
        if r is None:
            continue
        coords = {"dp": 0, "tp": rank}
        for k, v in r["top"].items():
            np.testing.assert_array_equal(v, jax_shard_of(jsh[k], jm, coords), err_msg=k)
        for b, jb in zip(r["blocks"], jsh["blocks"]):
            for k, v in b.items():
                np.testing.assert_array_equal(v, jax_shard_of(jb[k], jm, coords), err_msg=k)


def _fake_mesh(tp: int, t: int) -> Mesh:
    """A rank's Mesh for sharding alone (no process group is needed to cut
    a shard)."""
    return Mesh({"dp": 1, "tp": tp, "sp": 1}, {"dp": 0, "tp": t, "sp": 0}, {}, {},
                torch.device("cpu"), "gloo")


def _quantized(qtype, n, k, seed=0):
    rng = np.random.default_rng(seed)
    return QuantTensor.quantize(qtype, (rng.standard_normal((n, k)) * 0.05).astype(np.float32),
                                "cpu")


def test_localize_shapes():
    from ggml_gfx906_tpu_torch.ops.quantized import to_int8_layout

    # K / 4 a whole number of superblocks (and of int8 tiles of 128)
    for qtype, n, k in ((GGMLType.Q4_K, 512, 1024), (GGMLType.Q6_K, 256, 1024),
                        (GGMLType.Q8_0, 256, 1024), (GGMLType.Q3_K, 256, 1024)):
        qt = _quantized(qtype, n, k)
        assert qt.localize() is qt
        for layout, w in (("kernel", qt), ("int8", to_int8_layout(qt, 128))):
            assert w.layout == layout
            row = shard_quant_tensor(_fake_mesh(2, 1), w, P("tp", None))
            col = shard_quant_tensor(_fake_mesh(4, 3), w, P(None, "tp"))
            assert row.shape == (n // 2, k), (qtype, layout)
            assert col.shape == (n, k // 4), (qtype, layout)
            assert row.localize() is row and col.localize() is col
            # a shard's fields under the whole weight's shape, as the
            # reference's shards carry it
            for sh in (row, col):
                whole = QuantTensor(qtype, (n, k), sh.fields, layout)
                assert whole.localize().shape == sh.shape, (qtype, layout)
            np.testing.assert_array_equal(dequant(row).numpy(), dequant(w).numpy()[n // 2:])
            np.testing.assert_array_equal(dequant(col).numpy(),
                                          dequant(w).numpy()[:, 3 * k // 4:])


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K])
def test_column_shard_computes_its_partial_sum(qtype):
    """Each column shard of a Q4_K and a Q6_K weight, localized (K from its
    fields), computes x[:, part] @ W[:, part].T, and the parts add up to the
    unsharded product: what the tp all-reduce sums."""
    n, k, tp = 256, 1024, 2
    w = _quantized(qtype, n, k, seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((5, k)).astype(np.float32))
    wd = dequant(w)
    parts = []
    for t in range(tp):
        loc = shard_quant_tensor(_fake_mesh(tp, t), w, P(None, "tp"))
        ks = slice(t * k // tp, (t + 1) * k // tp)
        got = qmatmul(x[:, ks], loc)
        want = x[:, ks] @ wd[:, ks].T
        assert got.shape == (5, n)
        assert float(((got - want) ** 2).mean() / (want ** 2).mean()) < 1e-12
        parts.append(got)
    full = qmatmul(x, w)
    total = parts[0] + parts[1]
    assert float(((total - full) ** 2).mean() / (full ** 2).mean()) < 1e-12
