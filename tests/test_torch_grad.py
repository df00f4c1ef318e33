"""Gradients of the port's ops against jax.grad of the JAX package's — the
counterpart of tests/test_grad.py, op for op, on the CPU.

For each op, torch.autograd.grad of sum(c · op(x)) is held against jax.grad
of the same sum over the reference op, on the same f32 inputs and the same
fixed random weights c, at nmse < 1e-10 per input (each side's gradients
are its own f32 sums). The weights c stand in for test_grad.py's random
directions: a plain sum has a zero gradient through soft_max and the norms.
Also: the differentiable K2 path (`ops.attention._CausalKernel`) equals
autograd through `_causal_ref` bit for bit, its int8-K/V route refuses a
gradient, and a tiny GPT-2's loss and 28 parameter gradients through
`forward_train` and `cross_entropy_loss` equal the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import nmse
from ggml_gfx906_tpu import ops as jops
from ggml_gfx906_tpu.models import gpt2 as jgpt2
from ggml_gfx906_tpu_torch import ops as tops
from ggml_gfx906_tpu_torch.models import gpt2 as tgpt2
from ggml_gfx906_tpu_torch.ops import attention as tattn
from ggml_gfx906_tpu_torch.ops.cuda import K2
from ggml_gfx906_tpu_torch.training.opt import tree_leaves, tree_map

BOUND = 1e-10


def _x(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _check(jfn, tfn, *arrays, seed=0):
    """Gradients of sum(c · fn(*arrays)) in both packages, c ~ N(0, 1)."""
    t_in = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = tfn(*t_in)
    c = np.random.default_rng(seed + 1000).standard_normal(tuple(out.shape)).astype(np.float32)
    tg = torch.autograd.grad((out.float() * torch.from_numpy(c)).sum(), t_in)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a).astype(jnp.float32) * c),
                          argnums=tuple(range(len(arrays)))))(*[jnp.asarray(a) for a in arrays])
    errs = [nmse(g.numpy(), np.asarray(w)) for g, w in zip(tg, jg)]
    assert max(errs) < BOUND, errs


UNARY = [("gelu", ()), ("gelu_erf", ()), ("gelu_quick", ()), ("silu", ()), ("elu", ()),
         ("sigmoid", ()), ("tanh", ()), ("exp", ()), ("hardswish", ()), ("hardsigmoid", ()),
         ("neg", ()), ("leaky_relu", (0.1,)), ("softcap", (30.0,)), ("scale", (0.7,)),
         ("soft_max", ()), ("norm", (1e-5,)), ("rms_norm", (1e-6,)), ("l2_norm", ()),
         ("sum_rows", ()), ("mean", ()), ("swiglu", ()), ("reglu", ()), ("geglu", ()),
         ("geglu_erf", ()), ("geglu_quick", ())]


@pytest.mark.parametrize("name,args", UNARY, ids=[n for n, _ in UNARY])
def test_grad_unary(name, args):
    x = _x(np.random.default_rng(len(name)), 4, 16)
    _check(lambda a: getattr(jops, name)(a, *args), lambda a: getattr(tops, name)(a, *args), x)


def test_grad_group_norm():
    _check(lambda x: jops.group_norm(x, 2), lambda x: tops.group_norm(x, 2),
           _x(np.random.default_rng(1), 1, 4, 3, 8))


def test_grad_soft_max_ext():
    rng = np.random.default_rng(2)
    mask = np.where(rng.random((8, 8)) < 0.2, -np.inf, 0.0).astype(np.float32)
    mask[:, 0] = 0.0        # no row all masked
    _check(lambda a: jops.soft_max_ext(a, jnp.asarray(mask), scale=0.3),
           lambda a: tops.soft_max_ext(a, torch.from_numpy(mask), scale=0.3),
           _x(rng, 2, 3, 8, 8))


def test_grad_cross_entropy():
    rng = np.random.default_rng(3)
    labels = rng.random((5, 11)).astype(np.float32)
    labels /= labels.sum(-1, keepdims=True)
    _check(lambda lg: jops.cross_entropy_loss(lg, jnp.asarray(labels))[None],
           lambda lg: tops.cross_entropy_loss(lg, torch.from_numpy(labels))[None],
           _x(rng, 5, 11))


def test_grad_out_prod():
    rng = np.random.default_rng(4)
    _check(jops.out_prod, tops.out_prod, _x(rng, 6, 5), _x(rng, 6, 7))


CONVS = [("conv_1d", (1, 3, 10), (4, 3, 3), dict(stride=1, padding=1)),
         ("conv_2d", (1, 2, 6, 6), (3, 2, 3, 3), dict(stride=(1, 1), padding=(1, 1))),
         ("conv_3d", (1, 2, 4, 4, 4), (3, 2, 2, 2, 2), {}),
         ("conv_transpose_1d", (1, 3, 6), (3, 4, 3), dict(stride=2))]


@pytest.mark.parametrize("name,xs,ws,kw", CONVS, ids=[c[0] for c in CONVS])
def test_grad_convs(name, xs, ws, kw):
    rng = np.random.default_rng(5)
    _check(lambda x, w: getattr(jops, name)(x, w, **kw),
           lambda x, w: getattr(tops, name)(x, w, **kw), _x(rng, *xs), _x(rng, *ws))


def test_conv_pins_hold_in_forward_and_backward(monkeypatch):
    """A conv op's forward runs with cuDNN's TF32 off and the caller's
    algorithm choice; its backward with TF32 off and a deterministic
    algorithm chosen without benchmarking; the caller's flags come back
    after each, and the gradients are the unpinned ones' on the CPU."""
    from ggml_gfx906_tpu_torch.ops import conv

    cudnn, seen = torch.backends.cudnn, {}
    flags = ("allow_tf32", "deterministic", "benchmark")

    def record(where, fn):
        def f(*a, **k):
            seen[where] = tuple(getattr(cudnn, n) for n in flags)
            return fn(*a, **k)
        return f

    monkeypatch.setattr(conv, "_CONV", {2: record("forward", torch.nn.functional.conv2d)})
    monkeypatch.setattr(torch.ops.aten, "convolution_backward",
                        record("backward", torch.ops.aten.convolution_backward))
    for name, val in zip(flags, (True, False, True)):
        monkeypatch.setattr(cudnn, name, val)
    rng = np.random.default_rng(7)
    x, w = (torch.from_numpy(_x(rng, *s)).requires_grad_() for s in ((2, 2, 6, 6), (3, 2, 3, 3)))
    got = torch.autograd.grad(tops.conv_2d(x, w, padding=(1, 1)).sum(), (x, w))
    want = torch.autograd.grad(torch.nn.functional.conv2d(x, w, padding=1).sum(), (x, w))
    assert seen == {"forward": (False, False, True), "backward": (False, True, False)}
    assert tuple(getattr(cudnn, n) for n in flags) == (True, False, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_grad_pool_im2col():
    rng = np.random.default_rng(6)
    _check(lambda x: jops.pool_2d(x, "avg", (2, 2), (2, 2)),
           lambda x: tops.pool_2d(x, "avg", (2, 2), (2, 2)), _x(rng, 1, 2, 6, 6))
    _check(lambda x: jops.im2col(x, 3, 3, (1, 1), (1, 1)),
           lambda x: tops.im2col(x, 3, 3, (1, 1), (1, 1)), _x(rng, 1, 2, 5, 5))


ROPES = [("normal", {}), ("neox", dict(mode=2)),
         ("neox_yarn", dict(mode=2, ext_factor=1.0, n_ctx_orig=64, freq_scale=0.5))]


@pytest.mark.parametrize("kw", [k for _, k in ROPES], ids=[n for n, _ in ROPES])
def test_grad_rope(kw):
    pos = np.arange(5, dtype=np.int32)
    _check(lambda a: jops.rope_ext(a, jnp.asarray(pos), 16, **kw),
           lambda a: tops.rope_ext(a, torch.from_numpy(pos), 16, **kw),
           _x(np.random.default_rng(7), 5, 2, 16))


@pytest.mark.parametrize("sections,vision", [([2, 1, 1, 0], False), ([3, 3, 2, 0], True)],
                         ids=["mrope", "vision"])
def test_grad_rope_multi(sections, vision):
    rng = np.random.default_rng(8)
    pos = rng.integers(0, 16, (4, 5)).astype(np.int32)
    kw = dict(mode=jops.ROPE_TYPE_VISION) if vision else {}
    _check(lambda a: jops.rope_multi(a, jnp.asarray(pos), 8, sections, **kw),
           lambda a: tops.rope_multi(a, torch.from_numpy(pos), 8, sections, **kw),
           _x(rng, 5, 2, 16))


def test_grad_attention():
    rng = np.random.default_rng(9)
    _check(jops.attention_ref, tops.attention_ref, _x(rng, 1, 2, 4, 8), _x(rng, 1, 2, 6, 8),
           _x(rng, 1, 2, 6, 8))


def test_grad_ssm_scan():
    rng = np.random.default_rng(10)
    args = [_x(rng, *s, scale=0.1) for s in ((2, 3, 4), (2, 5, 3), (2, 5, 3), (3, 4),
                                              (2, 5, 4), (2, 5, 4))]
    _check(lambda *a: jops.ssm_scan(*a)[0], lambda *a: tops.ssm_scan(*a)[0], *args)


def test_grad_matmul_dense():
    rng = np.random.default_rng(11)
    _check(jops.qmatmul, tops.qmatmul, _x(rng, 3, 16), _x(rng, 5, 16))


def _qkv(seed=12):
    rng = np.random.default_rng(seed)
    return _x(rng, 1, 4, 4, 8), _x(rng, 1, 2, 8, 8), _x(rng, 1, 2, 8, 8)


def test_grad_causal_flash_attn():
    """The reference test's GQA shape: q (1, 4, 4, 8), k/v (1, 2, 8, 8) at
    pos 2 (4 query heads on 2 KV heads)."""
    _check(lambda a, b, c: jops.causal_flash_attn(a, b, c, 2),
           lambda a, b, c: tops.causal_flash_attn(a, b, c, 2), *_qkv())


def test_causal_kernel_backward_is_autograd_through_causal_ref():
    """The Function's q/k/v gradients equal, bit for bit, autograd through
    `_causal_ref` on the same inputs; the forward is K2's (its plain version
    here) and K2 counts one launch per forward at most (none on the CPU),
    none in the backward; a k/v that wants no gradient gets none."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _qkv())
    g = torch.from_numpy(_x(np.random.default_rng(13), 1, 4, 4, 8))
    before = K2.launches
    out = tops.causal_flash_attn(q, k, v, 2)
    assert "CausalKernel" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (q, k, v), g)
    assert K2.launches == before
    ref_out = tattn._causal_ref(q, k, v, torch.tensor([2], dtype=torch.int32),
                                1.0 / 8 ** 0.5, 0.0)
    want = torch.autograd.grad(ref_out, (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out2 = tops.causal_flash_attn(q, k.detach(), v.detach(), 2)
    (dq,) = torch.autograd.grad(out2, (q,), g)
    assert torch.equal(dq, got[0])


def test_int8_kv_route_refuses_a_gradient():
    q = torch.randn(1, 2, 1, 8, requires_grad=True)
    k8 = torch.randint(-127, 128, (1, 2, 4, 8), dtype=torch.int8)
    sc = torch.full((1, 2, 4), 0.01)
    with pytest.raises(RuntimeError, match="inference-only"):
        tops.causal_flash_attn(q, k8, k8, 3, k_scale=sc, v_scale=sc)
    with torch.no_grad():
        assert tops.causal_flash_attn(q, k8, k8, 3, k_scale=sc, v_scale=sc).shape == (1, 2, 1, 8)


def test_gpt2_forward_train_gradients():
    """A tiny GPT-2 (2 layers, n_embd 64, 4 heads, vocab 96; 2 sequences of
    16 tokens): the loss cross_entropy_loss(forward_train(x), one_hot(y))
    and its gradient in each of the 28 parameters against the reference."""
    jcfg = jgpt2.GPT2Config(n_vocab=96, n_ctx=32, n_embd=64, n_head=4, n_layer=2)
    tcfg = tgpt2.GPT2Config(n_vocab=96, n_ctx=32, n_embd=64, n_head=4, n_layer=2)
    seq = np.random.default_rng(14).integers(0, 96, (2, 17)).astype(np.int32)
    x, y = seq[:, :-1], seq[:, 1:]
    onehot = np.eye(96, dtype=np.float32)[y]

    def jloss(p):
        return jops.cross_entropy_loss(jgpt2.forward_train(jcfg, p, jnp.asarray(x)),
                                       jnp.asarray(onehot))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jgpt2.random_params(jcfg, seed=3))
    live = tree_map(lambda t: t.requires_grad_(),
                    tgpt2.random_params(tcfg, seed=3, device="cpu"))
    leaves = tree_leaves(live)
    assert len(leaves) == 28
    tl = tops.cross_entropy_loss(tgpt2.forward_train(tcfg, live, torch.from_numpy(x).long()),
                                 torch.nn.functional.one_hot(torch.from_numpy(y).long(), 96))
    it = iter(torch.autograd.grad(tl, leaves))
    grads = tree_map(lambda _: next(it), live)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
    errs = tree_map(lambda g, w: nmse(g.numpy(), np.asarray(w)), grads, jg)
    assert max(tree_leaves(errs)) < BOUND, errs
