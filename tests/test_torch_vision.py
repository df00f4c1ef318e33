"""The vision and classifier models of the port against the JAX package's on
the CPU, on the same seeded inputs and weights: YOLOv3-tiny at 128 (the
forward, detect after NMS, the letterbox resize), Magika (the golden
params, prepare_input), SAM with a 96-wide 4-layer encoder at image 256
and the published decoder (encode_image, decode_masks, the pytree GGUF
files in both directions). The reference's calls run jitted."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (jax_params_to_numpy, nmse, one_torch_thread,  # noqa: F401
                         rand_yolo_gguf, sam_state)
from ggml_gfx906_tpu.models import magika as jmagika
from ggml_gfx906_tpu.models import sam as jsam
from ggml_gfx906_tpu.models import yolo as jyolo
from ggml_gfx906_tpu_torch.models import magika as tmagika
from ggml_gfx906_tpu_torch.models import sam as tsam
from ggml_gfx906_tpu_torch.models import yolo as tyolo

NET = 128


@pytest.fixture(scope="module")
def yolo_layers(tmp_path_factory):
    """(the reference's layers, the port's from the same file, the port's
    carried across from the reference's as numpy)."""
    path = tmp_path_factory.mktemp("yolo") / "yolo.gguf"
    rand_yolo_gguf(path, np.random.default_rng(0))
    jl = jyolo.load(path)
    return jl, tyolo.load(path, device="cpu"), tyolo.params_from_numpy(
        jax_params_to_numpy(jl), device="cpu")


def test_yolo_recipe_is_the_reference_tests(tmp_path):
    """The GGUF recipe draws the reference test's weights, byte for byte."""
    from test_vision_models import _rand_yolo_gguf

    rand_yolo_gguf(tmp_path / "a.gguf", np.random.default_rng(5))
    _rand_yolo_gguf(tmp_path / "b.gguf", np.random.default_rng(5))
    assert (tmp_path / "a.gguf").read_bytes() == (tmp_path / "b.gguf").read_bytes()


def test_yolo_forward(yolo_layers):
    """Both heads at 128x128, nmse < 1e-9, with the layers from the file
    and carried across."""
    jl, tl, carried = yolo_layers
    img = np.random.default_rng(1).random((1, 3, NET, NET), dtype=np.float32)
    ref = jax.jit(jyolo.forward)(jl, jnp.asarray(img))
    for layers in (tl, carried):
        got = tyolo.forward(layers, torch.from_numpy(img))
        for g, r in zip(got, ref):
            assert tuple(g.shape) == r.shape
            assert nmse(g.numpy(), r) < 1e-9, nmse(g.numpy(), r)


def test_yolo_detect(yolo_layers):
    """detect on a 3x96x150 photo at 128 (threshold 0.4: 81 detections;
    NMS is quadratic in Python): the same detections after NMS, boxes
    within 1e-5 of their size (w and h pass through exp, which turns the
    heads' f32 rounding into a relative error), the class vectors nonzero
    in the same classes and within 1e-5."""
    jl, tl, _ = yolo_layers
    img = np.random.default_rng(2).random((3, 96, 150), dtype=np.float32)
    ref = jyolo.detect(jl, img, netw=NET, neth=NET, thresh=0.4)
    got = tyolo.detect(tl, img, netw=NET, neth=NET, thresh=0.4)
    assert len(ref) > 0 and len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.box, r.box, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(g.classes > 0, r.classes > 0)
        np.testing.assert_allclose(g.classes, r.classes, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape,net", [((3, 480, 640), 416), ((3, 96, 150), 128),
                                       ((3, 100, 100), 416)])
def test_letterbox(shape, net):
    """Two downscales and an upscale onto the gray canvas, within 2e-5 of
    the reference's antialiased bilinear resize."""
    img = np.random.default_rng(3).random(shape, dtype=np.float32)
    got, ref = tyolo.letterbox(img, net, net), jyolo.letterbox(img, net, net)
    assert got.shape == ref.shape == (3, net, net)
    assert np.abs(got - ref).max() <= 2e-5


def _magika_golden_params():
    """The params of tests/test_vision_models.py::test_magika_golden."""
    rng = np.random.default_rng(0)

    def t(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {
        "dense_w": t(128, 257), "dense_b": t(128),
        "ln_g": t(384, scale=1.0), "ln_b": t(384),
        "dense1_w": t(256, 512), "dense1_b": t(256),
        "dense2_w": t(256, 256), "dense2_b": t(256),
        "ln1_g": t(256, scale=1.0), "ln1_b": t(256),
        "label_w": t(113, 256), "label_b": t(113),
    }
    return params, rng.integers(0, 256, 100, np.uint8).tobytes()


def test_magika_golden():
    """The golden params and file: probabilities within 1e-6 of the
    reference's, top 3 labels [106, 77, 38]."""
    params, data = _magika_golden_params()
    ref = jmagika.classify_bytes({k: jnp.asarray(v) for k, v in params.items()}, data)
    got = tmagika.classify_bytes(tmagika.params_from_numpy(params, device="cpu"), data)
    assert got.shape == (113,)
    assert np.abs(got - ref).max() < 1e-6
    np.testing.assert_array_equal(np.argsort(-got)[:3], [106, 77, 38])


@pytest.mark.parametrize("n", [0, 2, 511, 512, 513, 1025, 1536, 5000])
def test_magika_prepare_input(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    np.testing.assert_array_equal(tmagika.prepare_input(data), jmagika.prepare_input(data))


GLOBAL = (1, 3)
SAM_CFG = dict(n_enc_state=96, n_enc_layer=4, n_enc_head=12, n_img_size=256)


@pytest.fixture(scope="module")
def sam_models():
    """(state dict, the reference's config and params, the port's), both
    from from_hf with GLOBAL_ATTN (1, 3) in both modules."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsam, "GLOBAL_ATTN", GLOBAL)
        mp.setattr(tsam, "GLOBAL_ATTN", GLOBAL)
        sd = sam_state(**SAM_CFG, seed=7)
        _, jp = jsam.from_hf(sd, n_layer=SAM_CFG["n_enc_layer"])
        _, tp = tsam.from_hf(sd, n_layer=SAM_CFG["n_enc_layer"], device="cpu")
        jcfg = jsam.SamConfig(**SAM_CFG)
        tcfg = tsam.SamConfig(**SAM_CFG)
        yield sd, (jcfg, jp), (tcfg, tp)


@pytest.fixture
def sam_global(monkeypatch):
    monkeypatch.setattr(jsam, "GLOBAL_ATTN", GLOBAL)
    monkeypatch.setattr(tsam, "GLOBAL_ATTN", GLOBAL)


def _sam_inputs():
    rng = np.random.default_rng(8)
    img = rng.standard_normal((1, 3, 256, 256)).astype(np.float32)
    return img, np.array([[[100.0, 120.0], [30.0, 200.0]]], np.float32), np.array([[1, 0]],
                                                                                  np.int32)


def test_sam_encode_image(sam_models, sam_global):
    """Windowed layers (the grid of 16 padded to 28) and global ones, the
    neck: image embeddings nmse < 1e-9."""
    _, (jcfg, jp), (tcfg, tp) = sam_models
    img, _, _ = _sam_inputs()
    ref = jax.jit(lambda p, x: jsam.encode_image(jcfg, p, x))(jp["enc"], jnp.asarray(img))
    got = tsam.encode_image(tcfg, tp["enc"], torch.from_numpy(img))
    assert tuple(got.shape) == ref.shape == (1, 256, 16, 16)
    assert nmse(got.numpy(), ref) < 1e-9, nmse(got.numpy(), ref)


def test_sam_decode_masks(sam_models, sam_global):
    """A foreground and a background point through the prompt encoder and
    the two-way decoder: masks nmse < 1e-9, iou within rtol 1e-5."""
    _, (jcfg, jp), (tcfg, tp) = sam_models
    img, pts, lbl = _sam_inputs()

    @jax.jit
    def ref_fn(p, x):
        emb = jsam.encode_image(jcfg, p["enc"], x)
        return jsam.decode_masks(jcfg, p["dec"], p["pe"], emb,
                                 jsam.encode_points(jcfg, p["pe"], pts, lbl))

    rm, ri = ref_fn(jp, jnp.asarray(img))
    emb = tsam.encode_image(tcfg, tp["enc"], torch.from_numpy(img))
    gm, gi = tsam.decode_masks(tcfg, tp["dec"], tp["pe"], emb,
                               tsam.encode_points(tcfg, tp["pe"], pts, lbl))
    assert tuple(gm.shape) == rm.shape == (1, 4, 64, 64) and tuple(gi.shape) == (1, 4)
    assert nmse(gm.numpy(), rm) < 1e-9, nmse(gm.numpy(), rm)
    np.testing.assert_allclose(gi.numpy(), ri, rtol=1e-5, atol=0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_sam_pytree_gguf_files(sam_models, tmp_path):
    """The port's save_gguf file is byte for byte the reference's, and each
    package's load_gguf reads the other's file back exactly."""
    _, (jcfg, jp), (tcfg, tp) = sam_models
    jsam.save_gguf(tmp_path / "ref.gguf", jcfg, jp)
    tsam.save_gguf(tmp_path / "port.gguf", tcfg, tp)
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()
    cfg, back = tsam.load_gguf(tmp_path / "ref.gguf", device="cpu")
    assert cfg == tcfg and isinstance(cfg.ln_eps, float)
    jcfg2, jback = jsam.load_gguf(tmp_path / "port.gguf")
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(jcfg)
    want = _leaves(jp)
    for got in (_leaves(back), _leaves(jback)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.reshape(w.shape), w)


def test_sam_params_carried_across(sam_models):
    """params_from_numpy of the reference's params equals the port's
    from_hf of the same state dict, leaf for leaf."""
    _, (_, jp), (_, tp) = sam_models
    carried = tsam.params_from_numpy(jax_params_to_numpy(jp), device="cpu")
    a, b = _leaves(carried), _leaves(tp)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
