"""The port's training layer (ggml_gfx906_tpu_torch/training) against the
JAX package's on the CPU: the dataset's shuffles and batches, AdamW and SGD
(and torch.optim.AdamW), gradient accumulation, `fit` with a validation
split and an accuracy, and the checkpoint: the RNG round trip, a resume bit
for bit against the port's own uninterrupted run, pruning, every dtype of
the state tree.

Tolerances: AdamW nmse < 1e-12 per leaf (the same gradients; XLA's CPU
compiler may contract the moment updates to FMA), torch.optim.AdamW at the
reference test's rtol 2e-5 / atol 2e-6, `fit`'s params nmse < 1e-10 and its
loss and accuracy lists within rel 1e-6 (each side's gradients are its own
f32 sums); the dataset and the resume bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import nmse
from ggml_gfx906_tpu import training as jtr
from ggml_gfx906_tpu.training import dataset as jds
from ggml_gfx906_tpu.training import fit as jfit
from ggml_gfx906_tpu_torch import training as ttr
from ggml_gfx906_tpu_torch.training import checkpoint as tckpt
from ggml_gfx906_tpu_torch.training import dataset as tds
from ggml_gfx906_tpu_torch.training import fit as tfit


@pytest.mark.parametrize("shard,n", [(1, None), (1, 6), (2, 6), (2, None)])
def test_dataset_batches_equal_the_reference(shard, n):
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    labels = np.arange(20, dtype=np.float32)[:, None]
    jd, td = jds.Dataset(data, labels, shard), tds.Dataset(data, labels, shard)
    jr, tr = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        jd.shuffle(jr, n)
        td.shuffle(tr, n)
        for i in range(20 // 4):
            for a, b in zip(jd.get_batch(i, 4), td.get_batch(i, 4)):
                np.testing.assert_array_equal(a, b)
    if n is not None:   # the tail past n (the validation split) never moves
        np.testing.assert_array_equal(td.get_batch(4, 4)[0], data[16:20])


def _trees(rng):
    """The same params tree (nested dicts and a list) for both packages."""
    a = {"w": rng.standard_normal((4, 6)).astype(np.float32),
         "blk": [{"b": rng.standard_normal(6).astype(np.float32)},
                 {"b": rng.standard_normal(6).astype(np.float32)}]}
    return (jax.tree.map(jnp.asarray, a),
            ttr.opt.tree_map(lambda x: torch.from_numpy(x.copy()), a), a)


@pytest.mark.parametrize("hp", [ttr.AdamWParams(),
                                ttr.AdamWParams(alpha=0.01, beta2=0.95, wd=0.1)],
                         ids=["default", "decay"])
def test_adamw_steps_equal_the_reference(hp):
    rng = np.random.default_rng(0)
    jp, tp, _ = _trees(rng)
    jhp = jtr.AdamWParams(**hp.__dict__)
    js, ts = jtr.adamw_init(jp), ttr.adamw_init(tp)
    assert ts["iter"].dtype == torch.int32 and int(ts["iter"]) == 1
    for _ in range(5):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
        jp, js = jtr.adamw_step(jp, jax.tree.map(jnp.asarray, g), js, jhp)
        tp, ts = ttr.adamw_step(tp, ttr.opt.tree_map(torch.from_numpy, g), ts, hp)
    assert int(ts["iter"]) == int(js["iter"]) == 6
    errs = ttr.opt.tree_map(lambda got, want: nmse(got.numpy(), np.asarray(want)),
                            [tp, ts["m"], ts["v"]], [jp, js["m"], js["v"]])
    assert max(ttr.opt.tree_leaves(errs)) < 1e-12, errs


def test_adamw_matches_torch_optim():
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 6)).astype(np.float32)
    hp = ttr.AdamWParams(alpha=0.01, beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1)
    tw = torch.nn.Parameter(torch.tensor(w0.copy()))
    topt = torch.optim.AdamW([tw], lr=hp.alpha, betas=(hp.beta1, hp.beta2),
                             eps=hp.eps, weight_decay=hp.wd)
    params = {"w": torch.tensor(w0.copy())}
    state = ttr.adamw_init(params)
    for it in range(5):
        g = rng.standard_normal((4, 6)).astype(np.float32)
        tw.grad = torch.tensor(g)
        topt.step()
        params, state = ttr.adamw_step(params, {"w": torch.tensor(g)}, state, hp)
        np.testing.assert_allclose(params["w"].numpy(), tw.detach().numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=f"iter {it}")


def test_sgd_step_equals_the_reference():
    rng = np.random.default_rng(1)
    jp, tp, _ = _trees(rng)
    g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
    want = jtr.sgd_step(jp, jax.tree.map(jnp.asarray, g), jtr.SGDParams(alpha=0.1, wd=0.5))
    got = ttr.sgd_step(tp, ttr.opt.tree_map(torch.from_numpy, g), ttr.SGDParams(alpha=0.1, wd=0.5))
    ttr.opt.tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), np.asarray(b)),
                     got, want)
    w = ttr.sgd_step({"w": torch.ones(3)}, {"w": torch.full((3,), 2.0)},
                     ttr.SGDParams(alpha=0.1, wd=0.5))["w"]
    np.testing.assert_allclose(w.numpy(), 0.75, rtol=1e-6)   # 1·(1-0.05) - 0.1·2


def _lin_loss(p, x, y):
    return ((x @ p["w"] - y) ** 2).mean()


def test_grad_accumulation_equivalence():
    """opt_period=2 on half batches == one step on the full batch (the
    loss is a mean, so the mean of the halves' gradients is the full
    batch's), and both equal the reference's accumulation."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((8, 4)).astype(np.float32)
    Y = X @ rng.standard_normal((4, 1)).astype(np.float32)
    w0 = rng.standard_normal((4, 1)).astype(np.float32)
    hp = ttr.AdamWParams(alpha=0.01)

    def run(opt_period):
        p = {"w": torch.tensor(w0)}
        st, acc = ttr.adamw_init(p), {"w": torch.zeros(4, 1)}
        step = tfit.make_train_step(_lin_loss, hp, opt_period)
        n = 8 // opt_period
        for ib in range(opt_period):
            p, st, acc, _ = step(p, st, acc, ib, torch.tensor(X[ib * n:(ib + 1) * n]),
                                 torch.tensor(Y[ib * n:(ib + 1) * n]))
        assert not acc["w"].any() and int(st["iter"]) == 2
        return p["w"].numpy()

    full, halves = run(1), run(2)
    np.testing.assert_allclose(full, halves, rtol=1e-5, atol=1e-7)
    jstep = jfit.make_train_step(_lin_loss, jtr.AdamWParams(alpha=0.01), 2)
    p = {"w": jnp.asarray(w0)}
    st, acc = jtr.adamw_init(p), {"w": jnp.zeros((4, 1))}
    for ib in range(2):
        p, st, acc, _ = jstep(p, st, acc, jnp.int32(ib), jnp.asarray(X[ib * 4:(ib + 1) * 4]),
                              jnp.asarray(Y[ib * 4:(ib + 1) * 4]))
    assert nmse(halves, np.asarray(p["w"])) < 1e-12


def _problem(pkg: str, seed=0):
    """The reference checkpoint test's regression (tests/test_checkpoint.py
    ::_problem) for either package."""
    rng = np.random.default_rng(seed)
    w_true = rng.standard_normal((4, 3)).astype(np.float32)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    y = x @ w_true + 0.01 * rng.standard_normal((64, 3)).astype(np.float32)
    if pkg == "jax":
        params = {"w": jnp.zeros((4, 3), jnp.float32), "b": jnp.zeros((3,), jnp.float32)}
        return params, jds.Dataset(x, y), lambda p, bx, by: jnp.mean(
            (bx @ p["w"] + p["b"] - by) ** 2), lambda p, bx, by: jnp.mean(
            jnp.abs(bx @ p["w"] + p["b"] - by) < 0.5)
    params = {"w": torch.zeros(4, 3), "b": torch.zeros(3)}
    return params, tds.Dataset(x, y), lambda p, bx, by: torch.mean(
        (bx @ p["w"] + p["b"] - by) ** 2), lambda p, bx, by: torch.mean(
        ((bx @ p["w"] + p["b"] - by).abs() < 0.5).float())


def test_fit_equals_the_reference():
    kw = dict(batch_size=8, n_epochs=3, val_split=0.25, hp=jtr.AdamWParams(alpha=1e-2),
              opt_period=2, seed=7, verbose=False)
    jp, jd, jl, ja = _problem("jax")
    want, wres = jfit.fit(jl, jp, jd, accuracy_fn=ja, **kw)
    tp, td, tl, ta = _problem("torch")
    got, gres = tfit.fit(tl, tp, td, accuracy_fn=ta, **dict(kw, hp=ttr.AdamWParams(alpha=1e-2)))
    assert not tp["w"].any(), "fit trained the caller's tree in place"
    for k in want:
        assert nmse(got[k].numpy(), np.asarray(want[k])) < 1e-10, k
    for name in ("train_loss", "val_loss", "val_acc"):
        assert len(getattr(gres, name)) == 3
        assert getattr(gres, name) == pytest.approx(getattr(wres, name), rel=1e-6), name


def test_rng_roundtrip():
    rng = np.random.default_rng(123)
    rng.standard_normal(10)
    rng2 = tckpt.decode_rng(tckpt.encode_rng(rng))
    np.testing.assert_array_equal(rng.standard_normal(5), rng2.standard_normal(5))


def test_fit_resume_bit_exact(tmp_path):
    hp = ttr.AdamWParams(alpha=1e-2)
    params, ds, loss, _ = _problem("torch")
    straight, res_s = tfit.fit(loss, params, ds, batch_size=8, n_epochs=4, hp=hp,
                               verbose=False, seed=7)
    params2, ds2, _, _ = _problem("torch")
    d = str(tmp_path / "ck")
    tfit.fit(loss, params2, ds2, batch_size=8, n_epochs=2, hp=hp, verbose=False, seed=7,
             checkpoint_dir=d)
    assert tckpt.all_steps(d) == [0, 1]
    params3, ds3, _, _ = _problem("torch")   # a fresh call resumes after epoch 2
    resumed, res_r = tfit.fit(loss, params3, ds3, batch_size=8, n_epochs=4, hp=hp,
                              verbose=False, seed=7, checkpoint_dir=d)
    for k in straight:
        assert torch.equal(straight[k], resumed[k]), k
    assert res_r.train_loss == res_s.train_loss
    assert tckpt.all_steps(d) == [2, 3]


def test_checkpoint_prunes_old_steps(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(4):
        tckpt.save(d, s, {"x": np.full(3, s)})
    assert tckpt.all_steps(d) == [2, 3]
    assert int(tckpt.restore_latest(d)["x"][0]) == 3
    assert tckpt.restore_latest(str(tmp_path / "empty")) is None


def test_checkpoint_keeps_every_dtype(tmp_path):
    """The state tree of `fit` round-trips with its structure and dtypes:
    f32 and bf16 tensors, the int32 `iter`, numpy's int64 permutation and
    uint8 RNG and metrics buffers, an int64 scalar, nested dicts and lists."""
    rng = np.random.default_rng(2)
    state = {"params": {"w": torch.randn(3, 2), "blocks": [{"g": torch.randn(2).bfloat16()}]},
             "opt_state": {"iter": torch.ones((), dtype=torch.int32) * 7},
             "rng": tckpt.encode_rng(rng), "dataset_perm": rng.permutation(10),
             "epoch": np.int64(4), "metrics": np.frombuffer(b'{"a": 1}', np.uint8).copy()}
    tckpt.save(str(tmp_path), 4, state)
    back = tckpt.restore(str(tmp_path), 4)
    assert torch.equal(back["params"]["w"], state["params"]["w"])
    g = back["params"]["blocks"][0]["g"]
    assert g.dtype == torch.bfloat16 and torch.equal(g, state["params"]["blocks"][0]["g"])
    it = back["opt_state"]["iter"]
    assert it.dtype == torch.int32 and int(it) == 7
    perm = back["dataset_perm"]
    assert perm.dtype == torch.int64 and np.array_equal(perm.numpy(), state["dataset_perm"])
    assert back["rng"].dtype == torch.uint8 and back["metrics"].dtype == torch.uint8
    assert tckpt.decode_rng(back["rng"]).random() == tckpt.decode_rng(state["rng"]).random()
    assert back["epoch"].dtype == torch.int64 and int(back["epoch"]) == 4
    assert bytes(back["metrics"].numpy()) == b'{"a": 1}'
