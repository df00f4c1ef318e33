"""The port's MNIST trainer (models/mnist.py, mnist_cli.py) against the JAX
package's on the CPU: the init draws bit for bit, the fc and cnn forwards
(nmse < 1e-10), the loss and every leaf's gradient against jax.grad on 64
synthetic images (nmse < 1e-10), three train steps at batch 100 with
opt_period 2 (params, moments and the accumulator nmse < 1e-9), `train` to
the reference test's accuracy, the GGUF files byte for byte and each
package reading the other's, and the CLI's train then eval."""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import nmse
from ggml_gfx906_tpu.models import mnist as jm
from ggml_gfx906_tpu.training import AdamWParams as JAdamW
from ggml_gfx906_tpu.training import adamw_init as jinit
from ggml_gfx906_tpu.training.fit import make_train_step as jstep
from ggml_gfx906_tpu_torch.models import mnist as tm
from ggml_gfx906_tpu_torch.models import mnist_cli
from ggml_gfx906_tpu_torch.training import AdamWParams, adamw_init
from ggml_gfx906_tpu_torch.training.fit import make_train_step
from ggml_gfx906_tpu_torch.training.opt import tree_leaves, tree_map

ARCHS = ("fc", "cnn")


def _jfwd(arch):
    return jm.forward_fc if arch == "fc" else jm.forward_cnn


def _pair(arch, seed=3):
    jp = (jm.init_fc if arch == "fc" else jm.init_cnn)(seed)
    return jp, tm.INIT[arch](seed, device="cpu")


def _errs(got, want) -> dict:
    return tree_map(lambda g, w: nmse(g.detach().numpy(), np.asarray(w)), got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_is_bit_equal(arch):
    jp, tp = _pair(arch)
    assert list(tp) == list(jp)
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_forward_and_gradients(arch):
    jp, tp = _pair(arch)
    x, y = tm.synthetic_mnist(64, seed=4)
    np.testing.assert_array_equal(x, jm.synthetic_mnist(64, seed=4)[0])
    want = np.asarray(jax.jit(_jfwd(arch))(jp, jnp.asarray(x)))
    assert nmse(tm.FORWARD[arch](tp, torch.from_numpy(x)).detach().numpy(), want) < 1e-10
    jloss = jm.loss_fn(_jfwd(arch))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, jnp.asarray(x), jnp.asarray(y))
    live = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tl = tm.loss_fn(tm.FORWARD[arch])(live, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(tl, tree_leaves(live))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
    errs = _errs(dict(zip(live, grads)), jg)
    assert max(errs.values()) < 1e-10, errs


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_equal_the_reference(arch):
    """Three micro-batches of 100 at opt_period 2: one AdamW step, then one
    gradient left in the accumulator."""
    jp, tp = _pair(arch)
    x, y = tm.synthetic_mnist(300, seed=5)
    js, ts = jinit(jp), adamw_init(tp)
    jacc, tacc = jax.tree.map(jnp.zeros_like, jp), tree_map(torch.zeros_like, tp)
    jfn = jstep(jm.loss_fn(_jfwd(arch)), JAdamW(), 2)
    tfn = make_train_step(tm.loss_fn(tm.FORWARD[arch]), AdamWParams(), 2)
    for ib in range(3):
        bx, by = x[ib * 100:(ib + 1) * 100], y[ib * 100:(ib + 1) * 100]
        jp, js, jacc, jl = jfn(jp, js, jacc, jnp.int32(ib), jnp.asarray(bx), jnp.asarray(by))
        tp, ts, tacc, tl = tfn(tp, ts, tacc, ib, torch.from_numpy(bx), torch.from_numpy(by))
        assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert int(ts["iter"]) == int(js["iter"]) == 2
    errs = _errs({"p": tp, "m": ts["m"], "v": ts["v"], "acc": tacc},
                 {"p": jp, "m": js["m"], "v": js["v"], "acc": jacc})
    assert max(tree_leaves(errs)) < 1e-9, errs


def test_train_fc_reaches_the_reference_accuracy(tmp_path):
    """The reference's test_mnist_fc_trains_and_saves on the port: 2 epochs
    on 2,000 synthetic images, > 0.9 on 500 held out, and the same accuracy
    after a GGUF round trip."""
    X, Y = tm.synthetic_mnist(2000, seed=0)
    params, result = tm.train("fc", X, Y, n_epochs=2, batch_size=100, verbose=False,
                              device="cpu")
    assert len(result.train_loss) == len(result.val_acc) == 2
    Xt, Yt = tm.synthetic_mnist(500, seed=1)
    acc = tm.evaluate("fc", params, Xt, Yt)
    assert acc > 0.9, acc
    tm.save_gguf("fc", params, tmp_path / "fc.gguf")
    arch, back = tm.load_gguf(tmp_path / "fc.gguf", device="cpu")
    assert arch == "fc" and tm.evaluate("fc", back, Xt, Yt) == acc


@pytest.mark.parametrize("arch", ARCHS)
def test_gguf_bytes_equal_the_reference(arch, tmp_path):
    jp, tp = _pair(arch, seed=6)
    jm.save_gguf(arch, jp, tmp_path / "j.gguf")
    tm.save_gguf(arch, tp, tmp_path / "t.gguf")
    assert (tmp_path / "j.gguf").read_bytes() == (tmp_path / "t.gguf").read_bytes()
    a1, from_ref = tm.load_gguf(tmp_path / "j.gguf", device="cpu")
    a2, from_port = jm.load_gguf(tmp_path / "t.gguf")
    assert a1 == a2 == arch
    for k in jp:
        np.testing.assert_array_equal(from_ref[k].numpy(), np.asarray(jp[k]))
        np.testing.assert_array_equal(np.asarray(from_port[k]), tp[k].numpy())


def _idx(tmp_path, n=300, seed=7):
    """An idx3 / idx1 pair of n synthetic images, bytes as MNIST's files."""
    x, y = tm.synthetic_mnist(n, seed=seed)
    img = tmp_path / "images-idx3-ubyte"
    lbl = tmp_path / "labels-idx1-ubyte"
    img.write_bytes(struct.pack(">IIII", 2051, n, 28, 28)
                    + np.clip(x * 255, 0, 255).astype(np.uint8).tobytes())
    lbl.write_bytes(struct.pack(">II", 2049, n) + y.argmax(1).astype(np.uint8).tobytes())
    return str(img), str(lbl), y


def test_cli_train_then_eval(tmp_path, capsys):
    img, lbl, y = _idx(tmp_path)
    np.testing.assert_array_equal(mnist_cli.load_idx_labels(lbl), y)
    assert mnist_cli.load_idx_images(img).shape == (300, 784)
    out = str(tmp_path / "m.gguf")
    assert mnist_cli.main(["train", "--arch", "cnn", "--images", img, "--labels", lbl,
                           "--epochs", "1", "--batch-size", "100", "-o", out,
                           "--device", "cpu"]) == 0
    assert mnist_cli.main(["eval", "-m", out, "--images", img, "--labels", lbl,
                           "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("accuracy: ") and line.endswith("(cnn, 300 samples)")
    assert mnist_cli.main(["eval", "--device", "cpu"]) == 1
    with pytest.raises(ValueError, match="magic"):
        mnist_cli.load_idx_images(lbl)
