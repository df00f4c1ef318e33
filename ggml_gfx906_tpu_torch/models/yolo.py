"""YOLOv3-tiny object detection — the port of ggml_gfx906_tpu/models/yolo.py.

ref: examples/yolo/yolov3-tiny.cpp — 13 conv layers with batch-norm +
leaky-relu (apply_conv2d :170), maxpools (incl. darknet's stride-1 "same"
pool, build_graph :421), route/upsample/concat head, two yolo detection
layers (16: mask {3,4,5}, 23: mask {0,1,2}, anchors :459-475), logistic
activations on xy/objectness/classes (apply_yolo :193), box decode
(get_yolo_box :207) and NMS.

Weights GGUF tensor names: l{i}_weights/biases/scales/rolling_mean/
rolling_variance (load_model :122-136).

`load` and `params_from_numpy` run on the card unless device="cpu" is
passed. `detect` runs the network eagerly on the layers' device (the
reference jits it); the letterbox resize, the decode and NMS run on the
host, the decode and NMS in float64 numpy as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops
from ..gguf import GGUFReader
from ..utils.device import resolve, tree_device
from . import llama as _llama

# layers without batch-norm / activation / padding (ref :113-121)
NO_PAD = {7, 9, 10, 12}
NO_BN = {9, 12}

ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]
MASK16 = [3, 4, 5]
MASK23 = [0, 1, 2]
N_CLASSES = 80


def load(path, device=None) -> list[dict]:
    """A YOLOv3-tiny GGUF → 13 layers of f32 tensors on `device`."""
    device = resolve(device)
    r = GGUFReader(path)

    def t(name):
        return torch.from_numpy(r.tensor_float(name)).to(device)

    layers = []
    for i in range(13):
        lyr = {"w": t(f"l{i}_weights"), "b": t(f"l{i}_biases").reshape(-1)}
        if i not in NO_BN:
            lyr["scale"] = t(f"l{i}_scales").reshape(-1)
            lyr["mean"] = t(f"l{i}_rolling_mean").reshape(-1)
            lyr["var"] = t(f"l{i}_rolling_variance").reshape(-1)
        layers.append(lyr)
    return layers


def params_from_numpy(tree: list, device=None) -> list[dict]:
    """The JAX package's yolo layers (numpy leaves) → the port's."""
    return _llama.params_from_numpy(tree, device)


def _conv(x, lyr, idx: int):
    """apply_conv2d: conv 3x3(p1)/1x1(p0) → bn (no epsilon, as the
    reference) → bias → leaky(0.1)."""
    pad = 0 if idx in NO_PAD else lyr["w"].shape[-1] // 2
    y = ops.conv_2d(x, lyr["w"], padding=(pad, pad))
    c = y.shape[1]
    if idx not in NO_BN:
        y = (y - lyr["mean"].reshape(1, c, 1, 1)) / torch.sqrt(lyr["var"].reshape(1, c, 1, 1))
        y = y * lyr["scale"].reshape(1, c, 1, 1)
    y = y + lyr["b"].reshape(1, c, 1, 1)
    if idx not in NO_BN:
        y = ops.leaky_relu(y, 0.1)
    return y


def _pool2(x):
    return ops.pool_2d(x, "max", (2, 2), (2, 2))


def _pool_same(x):
    """darknet stride-1 'same' maxpool: pad right/bottom with -inf."""
    return ops.pool_2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), "max", (2, 2), (1, 1))


def forward(layers: list[dict], img: torch.Tensor):
    """img (1, 3, H, W) f32 in [0,1] → (layer_15 (1,255,h,w), layer_22)."""
    x = _conv(img, layers[0], 0)
    x = _pool2(x)
    x = _conv(x, layers[1], 1)
    x = _pool2(x)
    x = _conv(x, layers[2], 2)
    x = _pool2(x)
    x = _conv(x, layers[3], 3)
    x = _pool2(x)
    x = _conv(x, layers[4], 4)
    layer_8 = x
    x = _pool2(x)
    x = _conv(x, layers[5], 5)
    x = _pool_same(x)
    x = _conv(x, layers[6], 6)
    x = _conv(x, layers[7], 7)
    layer_13 = x
    x = _conv(x, layers[8], 8)
    layer_15 = _conv(x, layers[9], 9)

    y = _conv(layer_13, layers[10], 10)
    y = ops.upscale_nearest(y, 2, 2)
    y = ops.concat(y, layer_8, axis=1)
    y = _conv(y, layers[11], 11)
    layer_22 = _conv(y, layers[12], 12)
    return layer_15, layer_22


@dataclass
class Detection:
    box: tuple  # (x, y, w, h) relative to the original image
    classes: np.ndarray = field(default=None)
    objectness: float = 0.0


def decode_yolo_layer(pred: np.ndarray, mask, netw: int, neth: int,
                      img_w: int, img_h: int, thresh: float):
    """ref: apply_yolo + get_yolo_box + get_yolo_detections (:193-260):
    logistic on xy/objectness/classes, anchor box decode, letterbox
    correction. pred: (255, h, w) f32."""
    n_anchor = len(mask)
    _, h, w = pred.shape
    p = pred.reshape(n_anchor, 4 + 1 + N_CLASSES, h, w).astype(np.float64)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))
    xy = sig(p[:, 0:2])
    wh = p[:, 2:4]
    obj = sig(p[:, 4])
    cls = sig(p[:, 5:])

    # letterbox scaling (correct_yolo_box semantics)
    if netw / img_w < neth / img_h:
        new_w, new_h = netw, (img_h * netw) // img_w
    else:
        new_h, new_w = neth, (img_w * neth) // img_h

    dets = []
    cols, rows = np.meshgrid(np.arange(w), np.arange(h))
    for a in range(n_anchor):
        bx = (cols + xy[a, 0]) / w
        by = (rows + xy[a, 1]) / h
        bw = np.exp(wh[a, 0]) * ANCHORS[2 * mask[a]] / netw
        bh = np.exp(wh[a, 1]) * ANCHORS[2 * mask[a] + 1] / neth
        keep = obj[a] > thresh
        for r, c in zip(*np.nonzero(keep)):
            x = (bx[r, c] - (netw - new_w) / 2.0 / netw) / (new_w / netw)
            y = (by[r, c] - (neth - new_h) / 2.0 / neth) / (new_h / neth)
            ww = bw[r, c] * netw / new_w
            hh = bh[r, c] * neth / new_h
            probs = obj[a, r, c] * cls[a, :, r, c]
            probs[probs <= thresh] = 0.0
            dets.append(Detection((x, y, ww, hh), probs, float(obj[a, r, c])))
    return dets


def _iou(a, b):
    def corners(t):
        x, y, w, h = t
        return x - w / 2, y - h / 2, x + w / 2, y + h / 2

    ax0, ay0, ax1, ay1 = corners(a)
    bx0, by0, bx1, by1 = corners(b)
    iw = max(0.0, min(ax1, bx1) - max(ax0, bx0))
    ih = max(0.0, min(ay1, by1) - max(ay0, by0))
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / union if union > 0 else 0.0


def nms(dets: list[Detection], iou_thresh: float = 0.45) -> list[Detection]:
    """per-class greedy NMS (ref do_nms_sort semantics)."""
    for k in range(N_CLASSES):
        order = sorted(range(len(dets)), key=lambda i: -dets[i].classes[k])
        for ii in range(len(order)):
            i = order[ii]
            if dets[i].classes[k] == 0:
                continue
            for jj in range(ii + 1, len(order)):
                j = order[jj]
                if _iou(dets[i].box, dets[j].box) > iou_thresh:
                    dets[j].classes[k] = 0.0
    return [d for d in dets if d.classes.max() > 0]


def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) f32 weights of a triangle-kernel resize along one axis,
    widened by the scale on a downscale (antialiased), each column
    normalised, columns outside the input zeroed: the weights of
    jax.image.resize(..., "bilinear") (jax/_src/image/scale.py
    compute_weight_mat)."""
    inv = np.float32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / max(inv, np.float32(1.0))
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32))


def letterbox(img: np.ndarray, netw: int, neth: int) -> np.ndarray:
    """img (3, H, W) in [0,1] → (3, neth, netw) aspect-preserving resize
    onto a 0.5-gray canvas (ref letterbox_image). The resize is the
    reference's antialiased bilinear one, as two small products on the
    host (an axis whose size does not change is left as it is)."""
    _, h, w = img.shape
    if netw / w < neth / h:
        new_w, new_h = netw, (h * netw) // w
    else:
        new_h, new_w = neth, (w * neth) // h
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    if new_h != h:
        x = torch.einsum("chw,hk->ckw", x, _resize_weights(h, new_h))
    if new_w != w:
        x = torch.einsum("chw,wk->chk", x, _resize_weights(w, new_w))
    out = np.full((3, neth, netw), 0.5, np.float32)
    dy, dx = (neth - new_h) // 2, (netw - new_w) // 2
    out[:, dy:dy + new_h, dx:dx + new_w] = x.numpy()
    return out


def detect(layers: list[dict], img: np.ndarray, netw: int = 416,
           neth: int = 416, thresh: float = 0.5) -> list[Detection]:
    """Full pipeline: letterbox → network (on the layers' device) → two
    yolo heads → NMS."""
    _, img_h, img_w = img.shape
    sized = letterbox(img, netw, neth)
    with torch.inference_mode():
        l15, l22 = forward(layers, torch.from_numpy(sized[None]).to(tree_device(layers)))
        l15, l22 = l15[0].cpu().numpy(), l22[0].cpu().numpy()
    dets = decode_yolo_layer(l15, MASK16, netw, neth, img_w, img_h, thresh)
    dets += decode_yolo_layer(l22, MASK23, netw, neth, img_w, img_h, thresh)
    return nms(dets)
