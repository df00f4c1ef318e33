"""ops/conv.py of the port against the JAX package's, name for name, on the
same seeded numpy inputs: the data-movement ops and max pooling bit for
bit, the convolutions, avg pooling, bilinear interpolation and the SSM ops
at nmse < 1e-12; and the convolutions keep f32 whatever cuDNN's TF32 flag
says."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import nmse, one_torch_thread  # noqa: F401
from ggml_gfx906_tpu.ops import conv as jconv
from ggml_gfx906_tpu_torch.ops import conv as tconv

TOL = 1e-12


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(fn, *arrays, **kw):
    """(the reference's output, jitted, the port's) of `fn` on the same
    arrays; the other arguments are static."""
    idx = [i for i, a in enumerate(arrays) if isinstance(a, np.ndarray)]

    def ref_fn(*xs):
        args = list(arrays)
        for i, x in zip(idx, xs):
            args[i] = x
        return getattr(jconv, fn)(*args, **kw)
    ref = jax.jit(ref_fn)(*(jnp.asarray(arrays[i]) for i in idx))
    got = getattr(tconv, fn)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                               for a in arrays), **kw)
    return np.asarray(ref), got.numpy()


def _close(fn, *arrays, **kw):
    ref, got = _both(fn, *arrays, **kw)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert nmse(got, ref) < TOL, (fn, kw, nmse(got, ref))


def _equal(fn, *arrays, **kw):
    ref, got = _both(fn, *arrays, **kw)
    np.testing.assert_array_equal(got, ref)


CONV_1D = [dict(stride=1, padding=0, dilation=1), dict(stride=2, padding=1, dilation=1),
           dict(stride=1, padding=2, dilation=2), dict(stride=3, padding=1, dilation=2),
           dict(stride=5, padding=1, dilation=1)]
CONV_2D = [dict(stride=(1, 1), padding=(0, 0), dilation=(1, 1)),
           dict(stride=(2, 1), padding=(1, 2), dilation=(1, 1)),
           dict(stride=(1, 2), padding=(2, 1), dilation=(2, 1)),
           dict(stride=2, padding=1, dilation=2)]


@pytest.mark.parametrize("kw", CONV_1D)
def test_conv_1d_and_depthwise(kw):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 6, 23)
    _close("conv_1d", x, _rand(rng, 5, 6, 3), **kw)
    _close("conv_1d_dw", x, _rand(rng, 6, 1, 3), **kw)


@pytest.mark.parametrize("kw", CONV_2D)
def test_conv_2d_and_depthwise(kw):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 4, 13, 11)
    _close("conv_2d", x, _rand(rng, 7, 4, 3, 3), **kw)
    _close("conv_2d_dw", x, _rand(rng, 4, 1, 3, 2), **kw)


@pytest.mark.parametrize("kw", [dict(), dict(stride=(2, 1, 1), padding=(1, 0, 1),
                                             dilation=(1, 2, 1)),
                                dict(stride=2, padding=1, dilation=1)])
def test_conv_3d(kw):
    rng = np.random.default_rng(2)
    _close("conv_3d", _rand(rng, 1, 3, 7, 8, 9), _rand(rng, 4, 3, 3, 2, 3), **kw)


@pytest.mark.parametrize("kw", CONV_1D)
def test_conv_transpose_1d(kw):
    """(IC, OC, K) weights; `padding` crops the full output at both ends."""
    rng = np.random.default_rng(3)
    _close("conv_transpose_1d", _rand(rng, 2, 5, 9), _rand(rng, 5, 3, 4), **kw)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_conv_transpose_2d(stride):
    """At stride 3 the (2, 3) kernel is shorter than the stride along one
    axis: the reference's output is longer there by zeros."""
    rng = np.random.default_rng(4)
    _close("conv_transpose_2d", _rand(rng, 2, 6, 5, 7), _rand(rng, 6, 4, 2, 3), stride=stride)


def test_convs_keep_f32_with_the_tf32_flag_on(monkeypatch):
    """With cuDNN's TF32 flag at PyTorch's default (True), each convolution
    runs with it off and sets it back after; its output still meets the
    f32 bound."""
    seen = []
    for name in ("conv1d", "conv2d", "conv3d", "conv_transpose1d", "conv_transpose2d"):
        real = getattr(torch.nn.functional, name)

        def spy(*a, real=real, **k):
            seen.append(torch.backends.cudnn.allow_tf32)
            return real(*a, **k)
        monkeypatch.setitem(tconv._CONV if "transpose" not in name else tconv._CONV_T,
                            int(name[-2]), spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    rng = np.random.default_rng(5)
    _close("conv_1d", _rand(rng, 1, 3, 10), _rand(rng, 2, 3, 3))
    _close("conv_2d", _rand(rng, 1, 3, 9, 9), _rand(rng, 2, 3, 3, 3), padding=1)
    _close("conv_3d", _rand(rng, 1, 2, 5, 5, 5), _rand(rng, 2, 2, 3, 3, 3))
    _close("conv_transpose_1d", _rand(rng, 1, 3, 6), _rand(rng, 3, 2, 3), padding=1)
    _close("conv_transpose_2d", _rand(rng, 1, 3, 4, 4), _rand(rng, 3, 2, 2, 2), stride=2)
    assert seen == [False] * 5
    assert torch.backends.cudnn.allow_tf32 is True


@pytest.mark.parametrize("kw", [dict(kh=3, kw=3), dict(kh=3, kw=2, stride=(2, 1), padding=(1, 0)),
                                dict(kh=2, kw=3, stride=2, padding=1, dilation=(2, 1))])
def test_im2col_is_bit_equal(kw):
    rng = np.random.default_rng(6)
    _equal("im2col", _rand(rng, 2, 3, 9, 8), **kw)


@pytest.mark.parametrize("args", [((2, 2), (2, 2), (0, 0)), ((3, 3), (2, 2), (1, 1)),
                                  ((3, 2), (1, 2), (1, 0)), (2, 1, 0)])
def test_pool_2d(args):
    """max bit for bit (its -inf padding included), avg (count_include_pad)
    at nmse < 1e-12."""
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 3, 9, 10)
    k, s, p = args
    _equal("pool_2d", x, "max", k, s, p)
    _close("pool_2d", x, "avg", k, s, p)


@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 1, 1), (4, 3, 2)])
def test_pool_1d(k, s, p):
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 3, 17)
    _equal("pool_1d", x, "max", k, s, p)
    _close("pool_1d", x, "avg", k, s, p)


@pytest.mark.parametrize("sh,sw", [(2, 2), (1, 3), (3, 2)])
def test_upscale_nearest_is_bit_equal(sh, sw):
    _equal("upscale_nearest", _rand(np.random.default_rng(9), 1, 2, 4, 5), sh, sw)


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("out", [(12, 17), (5, 3), (9, 9)])
def test_interpolate_bilinear(align, out):
    """Up and down, both corner conventions, the reference's four-corner
    formula."""
    rng = np.random.default_rng(10)
    _close("interpolate_bilinear", _rand(rng, 2, 3, 7, 9), *out, align_corners=align)


@pytest.mark.parametrize("h,w,win", [(14, 14, 7), (16, 13, 14), (9, 20, 4)])
def test_win_part_and_unpart_are_bit_equal(h, w, win):
    """Zero padding to whole windows, and back."""
    rng = np.random.default_rng(11)
    x = _rand(rng, 2, h, w, 3)
    _equal("win_part", x, win)
    parts = np.array(jconv.win_part(jnp.asarray(x), win))
    _equal("win_unpart", parts, h, w, win)


@pytest.mark.parametrize("qh,kh", [(14, 14), (16, 16), (5, 9)])
def test_get_rel_pos_is_bit_equal(qh, kh):
    rng = np.random.default_rng(12)
    _equal("get_rel_pos", _rand(rng, 2 * max(qh, kh) - 1, 6), qh, kh)


def test_add_rel_pos_is_bit_equal():
    rng = np.random.default_rng(13)
    qh, qw, kh, kw = 3, 4, 5, 2
    attn = _rand(rng, 2, 3, qh * qw, kh * kw)
    _equal("add_rel_pos", attn, _rand(rng, 2, 3, qh * qw, kw), _rand(rng, 2, 3, qh * qw, kh),
           qh, qw, kh, kw)


@pytest.mark.parametrize("k", [1, 4])
def test_ssm_conv(k):
    rng = np.random.default_rng(14)
    _close("ssm_conv", _rand(rng, 2, 5, 11 + k - 1), _rand(rng, 5, k))


def test_ssm_scan():
    """y and the final state of the selective scan, dt through softplus."""
    rng = np.random.default_rng(15)
    B, L, D, N = 2, 7, 6, 4
    args = (_rand(rng, B, D, N), _rand(rng, B, L, D), _rand(rng, B, L, D) * 2,
            -np.abs(_rand(rng, D, N)), _rand(rng, B, L, N), _rand(rng, B, L, N))
    ry, rs = jconv.ssm_scan(*(jnp.asarray(a) for a in args))
    gy, gs = tconv.ssm_scan(*(torch.from_numpy(a) for a in args))
    assert gy.shape == (B, L, D) and gs.shape == (B, D, N)
    assert nmse(gy.numpy(), ry) < TOL and nmse(gs.numpy(), rs) < TOL
