"""MNIST train+eval — the port of ggml_gfx906_tpu/models/mnist.py, the
reference's end-to-end training example.

ref: examples/mnist/mnist-common.cpp — fc model (784→500 relu→10,
MNIST_NHIDDEN=500 mnist-common.h:32) and cnn model (2× [conv3x3 + relu +
pool2x2] with 8/16 channels MNIST_CNN_NCB=8, then dense→10), trained via
ggml_opt_fit with AdamW and cross-entropy; weights saved/loaded as GGUF.

`init_fc`, `init_cnn`, `train`, `load_gguf` and `params_from_numpy` run on
the card unless device="cpu" is passed; `evaluate` runs where the params
live, eagerly under torch.inference_mode() where the reference jits. The
init functions draw the reference's numpy values, so equal seeds give its
weights bit for bit, and `save_gguf` writes its bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import ops
from ..gguf import GGUFReader, GGUFWriter
from ..training import AdamWParams
from ..training.dataset import Dataset
from ..training.fit import fit
from ..training.opt import tree_map
from ..utils.device import resolve, to_device, tree_device

HW = 28
NINPUT = HW * HW
NCLASSES = 10
NHIDDEN = 500
CNN_NCB = 8

_GGUF_NAMES = {
    "fc": (("fc1_w", "fc1.weight"), ("fc1_b", "fc1.bias"), ("fc2_w", "fc2.weight"),
           ("fc2_b", "fc2.bias")),
    "cnn": (("conv1_k", "conv1.kernel"), ("conv1_b", "conv1.bias"),
            ("conv2_k", "conv2.kernel"), ("conv2_b", "conv2.bias"),
            ("dense_w", "dense.weight"), ("dense_b", "dense.bias")),
}


def params_from_numpy(tree: dict, device=None) -> dict:
    """The reference's params (numpy or jax arrays) → f32 tensors on
    `device` (the card unless "cpu")."""
    device = resolve(device)
    return tree_map(lambda a: to_device(np.asarray(a, np.float32), device), tree)


# ---------------------------------------------------------------- fc model

def init_fc(seed: int = 0, device=None) -> dict:
    device = resolve(device)
    rng = np.random.default_rng(seed)
    s1 = np.sqrt(2.0 / NINPUT)
    s2 = np.sqrt(2.0 / NHIDDEN)
    return params_from_numpy({
        "fc1_w": rng.standard_normal((NHIDDEN, NINPUT)).astype(np.float32) * s1,
        "fc1_b": np.zeros((NHIDDEN,), np.float32),
        "fc2_w": rng.standard_normal((NCLASSES, NHIDDEN)).astype(np.float32) * s2,
        "fc2_b": np.zeros((NCLASSES,), np.float32),
    }, device)


def forward_fc(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 784) → logits (B, 10)."""
    h = ops.relu(x @ params["fc1_w"].T + params["fc1_b"])
    return h @ params["fc2_w"].T + params["fc2_b"]


# ---------------------------------------------------------------- cnn model

def init_cnn(seed: int = 0, device=None) -> dict:
    device = resolve(device)
    rng = np.random.default_rng(seed)

    def w(*shape, fan_in):
        return rng.standard_normal(shape).astype(np.float32) * np.sqrt(2.0 / fan_in)

    ncb = CNN_NCB
    return params_from_numpy({
        "conv1_k": w(ncb, 1, 3, 3, fan_in=9),
        "conv1_b": np.zeros((ncb,), np.float32),
        "conv2_k": w(ncb * 2, ncb, 3, 3, fan_in=9 * ncb),
        "conv2_b": np.zeros((ncb * 2,), np.float32),
        "dense_w": w(NCLASSES, (HW // 4) ** 2 * ncb * 2, fan_in=(HW // 4) ** 2 * ncb * 2),
        "dense_b": np.zeros((NCLASSES,), np.float32),
    }, device)


def forward_cnn(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 784) → logits (B, 10). conv3x3(pad1)+relu+pool2x2, twice, dense."""
    b = x.shape[0]
    h = x.reshape(b, 1, HW, HW)
    h = ops.conv_2d(h, params["conv1_k"], padding=(1, 1))
    h = ops.relu(h + params["conv1_b"][None, :, None, None])
    h = ops.pool_2d(h, "max", (2, 2), (2, 2))
    h = ops.conv_2d(h, params["conv2_k"], padding=(1, 1))
    h = ops.relu(h + params["conv2_b"][None, :, None, None])
    h = ops.pool_2d(h, "max", (2, 2), (2, 2))
    h = h.reshape(b, -1)
    return h @ params["dense_w"].T + params["dense_b"]


FORWARD = {"fc": forward_fc, "cnn": forward_cnn}
INIT = {"fc": init_fc, "cnn": init_cnn}


# ---------------------------------------------------------------- training

def loss_fn(forward):
    def f(params, x, y):
        logits = forward(params, x)
        return ops.cross_entropy_loss(logits, y)
    return f


def accuracy_fn(forward):
    def f(params, x, y):
        logits = forward(params, x)
        return (logits.argmax(-1) == y.argmax(-1)).float().mean()
    return f


def train(arch: str, data: np.ndarray, labels_onehot: np.ndarray,
          n_epochs: int = 3, batch_size: int = 500, lr: float = 1e-3,
          val_split: float = 0.05, seed: int = 0, verbose=True, device=None):
    """mnist_model_train analogue (ref mnist-common.cpp:412 → ggml_opt_fit),
    on `device` (the card unless "cpu")."""
    forward = FORWARD[arch]
    params = INIT[arch](seed, device)
    ds = Dataset(data.astype(np.float32), labels_onehot.astype(np.float32))
    params, result = fit(
        loss_fn(forward), params, ds, batch_size, n_epochs=n_epochs,
        val_split=val_split, hp=AdamWParams(alpha=lr),
        accuracy_fn=accuracy_fn(forward), seed=seed, verbose=verbose)
    return params, result


@torch.inference_mode()
def evaluate(arch: str, params: dict, data, labels_onehot) -> float:
    """Accuracy of the params on (data, one-hot labels), on the params'
    device."""
    device = tree_device(params)
    logits = FORWARD[arch](params, to_device(np.asarray(data, np.float32), device))
    labels = to_device(np.asarray(labels_onehot), device)
    return float((logits.argmax(-1) == labels.argmax(-1)).float().mean())


# ---------------------------------------------------------------- GGUF io
# (ref: the mnist example saves trained weights as GGUF; tensor names match
# mnist-common.cpp:160-210)

def save_gguf(arch: str, params: dict, path):
    w = GGUFWriter()
    w.set("general.architecture", f"mnist-{arch}")
    for key, name in _GGUF_NAMES[arch]:
        w.add_array_tensor(name, params[key].detach().cpu().numpy())
    w.write(path)


def load_gguf(path, device=None) -> tuple[str, dict]:
    """(arch, params) of an MNIST GGUF, the params on `device` (the card
    unless "cpu")."""
    device = resolve(device)
    r = GGUFReader(path)
    arch = r.kv["general.architecture"].removeprefix("mnist-")
    return arch, params_from_numpy({key: r.tensor_float(name)
                                    for key, name in _GGUF_NAMES[arch]}, device)


def synthetic_mnist(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Class-dependent blob images (stand-in for the real MNIST files, which
    are not in the repository). Learnable but not trivial; the reference's
    draws, so equal seeds give its images."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, NCLASSES, n)
    xs = rng.random((n, HW, HW), dtype=np.float32) * 0.3
    for i, y in enumerate(ys):
        r, c = divmod(int(y), 4)
        xs[i, 4 + r * 7:11 + r * 7, 3 + c * 6:9 + c * 6] += 0.7
    onehot = np.eye(NCLASSES, dtype=np.float32)[ys]
    return xs.reshape(n, NINPUT), onehot
