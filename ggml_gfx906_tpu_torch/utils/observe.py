"""Per-node observation hook — the eval-callback analogue (the port of
ggml_gfx906_tpu/utils/observe.py).

ref: ggml_backend_sched_eval_callback (include/ggml-backend.h:282-289):
the scheduler can call back with every computed node for tensor-level
debugging. Here the model code calls `tap(name, value)` at named points
(models/llama.py: `blk.{i}.attn_out`, `blk.{i}.ffn_out`, `logits`); with an
observer installed each tap hands it a host copy:

    def spy(name, value):          # value is a host numpy array (f32)
        print(name, value.shape, float(abs(value).mean()))

    with observe.observer(spy):
        logits, _ = llama.forward(cfg, params, toks, kv, 0)

Without an observer a tap does no work and no host sync: `_forward` is
also the body of every captured decode graph. Deliberate difference from
the reference: there, jitted taps fire on every call of the traced
program; here a tap copies to the host, which a CUDA graph cannot hold, so
a tap with an observer installed raises while a graph is being captured
(runtime/graphs.py) — observe eager calls, not replays.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch

_state = threading.local()


def _current() -> Callable | None:
    return getattr(_state, "observer", None)


@contextlib.contextmanager
def observer(fn: Callable):
    """Install fn(name: str, value: np.ndarray) for the taps run inside."""
    prev = _current()
    _state.observer = fn
    try:
        yield
    finally:
        _state.observer = prev


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def tap(name: str, value: torch.Tensor) -> torch.Tensor:
    """Observation point: hands the active observer `value` as a host f32
    numpy array and returns `value` unchanged. No work without an
    observer; raises under a CUDA graph capture with one."""
    cb = _current()
    if cb is None:
        return value
    if _capturing():
        raise RuntimeError(f"tap {name!r}: an observer cannot read a tensor inside a CUDA "
                           "graph capture (a host copy); observe an eager call")
    cb(name, value.detach().float().cpu().numpy())
    return value
