"""Optimizers as ops: AdamW and SGD with ggml's exact update rules (the
port of ggml_gfx906_tpu/training/opt.py).

ref: src/ggml-opt.cpp (param block :228-232, beta1h/beta2h bias correction
:788-800) and ggml_compute_forward_opt_step_adamw_f32
(src/ggml-cpu/ops.cpp:10302-10368) / opt_step_sgd (:10380-10424). The
reference's step is a pure function that XLA fuses; here each leaf is
updated in place under torch.no_grad() (the counterpart of a donated
buffer), in the reference's order of operations, and the functions still
return the trees. Every division is a division of tensors: on the card a
tensor divided by a Python scalar is multiplied by its reciprocal instead.

Trees are nested dicts and lists of tensors; `tree_leaves` walks them in
insertion order, `tree_map` matches the leaves of several trees by key.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWParams:
    """Defaults match ggml_opt_default_optimizer_params (ggml-opt.cpp:228)."""

    alpha: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    wd: float = 0.0


@dataclass(frozen=True)
class SGDParams:
    alpha: float = 1e-3
    wd: float = 0.0


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the same leaves of `rest`), keeping
    its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def adamw_init(params) -> dict:
    """Zero moments shaped as the params, and `iter` an int32 that starts
    at 1, on the params' device."""
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(torch.zeros_like, params), "v": tree_map(torch.zeros_like, params),
            "iter": torch.ones((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def adamw_step(params, grads, state: dict, hp: AdamWParams = AdamWParams()):
    """One AdamW update, weight decay decoupled, the bias corrections
    beta1h = 1 / (1 - beta1^iter), beta2h likewise, in f32. The params and
    the moments are updated in place; returns (params, new state), the
    state's `iter` one more."""
    it = state["iter"].float()
    one = torch.ones_like(it)
    beta1h = one / (one - torch.pow(torch.full_like(it, hp.beta1), it))
    beta2h = one / (one - torch.pow(torch.full_like(it, hp.beta2), it))
    keep = 1.0 - hp.alpha * hp.wd

    def upd(w, g, m, v):
        g = g.float()
        m.mul_(hp.beta1).add_(g * (1.0 - hp.beta1))
        v.mul_(hp.beta2).add_(g * g * (1.0 - hp.beta2))
        mh = m * beta1h
        vh = torch.sqrt(v * beta2h) + hp.eps
        w.mul_(keep).sub_((mh * hp.alpha) / vh)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "iter": state["iter"] + 1}


@torch.no_grad()
def sgd_step(params, grads, hp: SGDParams = SGDParams()):
    """w = w*(1 - alpha*wd) - alpha*g (ref opt_step_sgd), in place; returns
    the params."""
    keep = 1.0 - hp.alpha * hp.wd
    tree_map(lambda w, g: w.mul_(keep).sub_(g * hp.alpha), params, grads)
    return params
