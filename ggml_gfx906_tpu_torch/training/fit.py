"""High-level training loops: eval / epoch / fit (the port of
ggml_gfx906_tpu/training/fit.py).

ref: src/ggml-opt.cpp — ggml_opt_eval :781, ggml_opt_epoch :880 (train/val
split, per-batch loss/accuracy accumulation), ggml_opt_fit :998 (epoch
loop with progress output). The reference jits one train step (loss,
gradients and update fused by XLA); here the step runs eagerly: the
gradients come from torch.autograd.grad over the tree's leaves and the
update is in place. Gradient accumulation over opt_period mirrors the
reference's accumulate-then-step. Everything runs on the params' device;
batches reach it from pinned host memory.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..quant.numerics import const
from ..utils import abort
from ..utils.device import to_device
from . import checkpoint as ckpt
from .dataset import Dataset
from .opt import AdamWParams, adamw_init, adamw_step, tree_leaves, tree_map


@dataclass
class FitResult:
    train_loss: list = field(default_factory=list)
    val_loss: list = field(default_factory=list)
    val_acc: list = field(default_factory=list)


def _like(tree, leaves: list):
    """`tree`'s structure with `leaves` in its leaves' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def make_train_step(loss_fn: Callable, hp: AdamWParams, opt_period: int = 1):
    """loss_fn(params, batch_x, batch_y) → scalar loss.

    Returns step(params, opt_state, grad_acc, ibatch, x, y) → (params,
    opt_state, grad_acc, loss): the gradients of the loss are added to
    grad_acc, and after every opt_period-th micro-batch their mean steps
    AdamW and grad_acc is zeroed (the reference accumulates grads in the
    graph and steps every opt_period evals, src/ggml-opt.cpp:700-780).
    params, the optimizer state and grad_acc are updated in place; a leaf
    the loss does not reach gets a zero gradient, as jax.grad gives."""

    def step(params, opt_state, grad_acc, ibatch: int, x, y):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        loss = loss_fn(_like(params, live), x, y)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        with torch.no_grad():
            acc = tree_leaves(grad_acc)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g)
            if (int(ibatch) + 1) % opt_period == 0:
                mean = _like(params, [a / const(opt_period, a) for a in acc])
                params, opt_state = adamw_step(params, mean, opt_state, hp)
                for a in acc:
                    a.zero_()
        return params, opt_state, grad_acc, loss.detach()

    return step


def _floats(ts: list) -> list:
    """Scalar tensors as Python floats, with one copy to the host."""
    return torch.stack(ts).tolist() if ts else []


def fit(loss_fn: Callable,
        params,
        dataset: Dataset,
        batch_size: int,
        n_epochs: int = 1,
        val_split: float = 0.0,
        hp: AdamWParams = AdamWParams(),
        opt_period: int = 1,
        accuracy_fn: Callable | None = None,
        seed: int = 0,
        verbose: bool = True,
        checkpoint_dir: str | None = None) -> tuple[object, FitResult]:
    """ggml_opt_fit analogue. Returns (trained params, FitResult); the
    caller's tree is left as it was (the training runs on a copy).

    checkpoint_dir: when set, the full training state (params, optimizer
    moments, grad accumulator, RNG + dataset shuffle state, metrics) is
    checkpointed after every epoch via training/checkpoint.py, and a fresh
    call with the same directory resumes bit-exactly after the last
    completed epoch, on the params' device."""
    device = tree_leaves(params)[0].device
    rng = np.random.default_rng(seed)
    n = dataset.ndata
    n_train = int(n * (1.0 - val_split)) // batch_size * batch_size
    n_batches = n_train // batch_size
    n_val_batches = (n - n_train) // batch_size

    step = make_train_step(loss_fn, hp, opt_period)
    params = tree_map(torch.clone, params)
    opt_state = adamw_init(params)
    grad_acc = tree_map(torch.zeros_like, params)
    result = FitResult()
    start_epoch = 0

    if checkpoint_dir is not None:
        saved = ckpt.restore_latest(checkpoint_dir)
        if saved is not None:
            to_dev = lambda t: t.to(device)   # noqa: E731
            params = tree_map(to_dev, saved["params"])
            opt_state = tree_map(to_dev, saved["opt_state"])
            grad_acc = tree_map(to_dev, saved["grad_acc"])
            rng = ckpt.decode_rng(saved["rng"])
            dataset._perm[:] = np.asarray(saved["dataset_perm"])
            metrics = json.loads(bytes(np.asarray(saved["metrics"], np.uint8)).decode())
            result = FitResult(metrics["train_loss"], metrics["val_loss"],
                               metrics["val_acc"])
            start_epoch = int(saved["epoch"]) + 1
            if verbose and start_epoch < n_epochs:
                print(f"resuming from epoch {start_epoch}", file=sys.stderr)

    def batch(ib):
        x, y = dataset.get_batch(ib, batch_size)
        return to_device(x, device), to_device(y, device)

    if start_epoch == 0:
        dataset.shuffle(rng)  # initial shuffle over everything (incl. val)
    for epoch in range(start_epoch, n_epochs):
        dataset.shuffle(rng, n_train)  # reshuffle only the training split
        t0 = time.time()
        losses = []
        for ib in range(n_batches):
            abort.check()   # cooperative-cancel poll point per batch
            params, opt_state, grad_acc, loss = step(params, opt_state, grad_acc, ib,
                                                     *batch(ib))
            losses.append(loss)
        result.train_loss.append(float(np.mean(_floats(losses))))
        vl, va = [], []
        with torch.no_grad():
            for ib in range(n_batches, n_batches + n_val_batches):
                x, y = batch(ib)
                vl.append(loss_fn(params, x, y))
                if accuracy_fn is not None:
                    va.append(accuracy_fn(params, x, y))
        vl, va = _floats(vl), _floats(va)
        if vl:
            result.val_loss.append(float(np.mean(vl)))
        if va:
            result.val_acc.append(float(np.mean(va)))
        if verbose:
            msg = (f"epoch {epoch + 1}/{n_epochs}: "
                   f"train_loss={result.train_loss[-1]:.4f}")
            if vl:
                msg += f" val_loss={result.val_loss[-1]:.4f}"
            if va:
                msg += f" val_acc={result.val_acc[-1]:.4f}"
            msg += f" ({time.time() - t0:.1f}s)"
            print(msg, file=sys.stderr)
        if checkpoint_dir is not None:
            metrics = json.dumps({
                "train_loss": result.train_loss,
                "val_loss": result.val_loss,
                "val_acc": result.val_acc,
            })
            ckpt.save(checkpoint_dir, epoch, {
                "params": params,
                "opt_state": opt_state,
                "grad_acc": grad_acc,
                "rng": ckpt.encode_rng(rng),
                "dataset_perm": np.asarray(dataset._perm),
                "epoch": np.int64(epoch),
                "metrics": np.frombuffer(metrics.encode(), np.uint8).copy(),
            })
    return params, result
