"""Cooperative cancellation — the abort-callback surface (the counterpart
of ggml_gfx906_tpu/utils/abort.py).

ref: ggml_set_abort_callback / ggml_abort_callback
(include/ggml.h:650-653): the reference polls the callback between graph
nodes and stops compute when it returns true. A replayed CUDA graph cannot
be interrupted mid-replay, so the poll points are the host boundaries
between dispatches — `llama.generate`'s decode loop, `Engine.step` and
`Engine.run`'s windows all call `check()` — which bounds cancellation
latency by one step (one window for a scan window).

    from ggml_gfx906_tpu_torch.utils import abort
    abort.set_abort_callback(lambda: stop_requested)
    try:
        engine.run()
    except abort.Aborted:
        ...
"""
from __future__ import annotations

import threading
from typing import Callable

_cb_lock = threading.Lock()
_callback: Callable[[], bool] | None = None


class Aborted(RuntimeError):
    """Raised at the next poll point after the abort callback returns True."""


def set_abort_callback(cb: Callable[[], bool] | None) -> None:
    """Install (or clear with None) the global abort callback."""
    global _callback
    with _cb_lock:
        _callback = cb


def check() -> None:
    """Poll point: raises Aborted if the installed callback returns True."""
    cb = _callback
    if cb is not None and cb():
        raise Aborted("aborted by callback")


def aborting() -> bool:
    """Non-raising poll (for loops that prefer to drain gracefully)."""
    cb = _callback
    return cb is not None and bool(cb())
