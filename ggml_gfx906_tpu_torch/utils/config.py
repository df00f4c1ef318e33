"""Runtime configuration registry of the port.

The counterpart of ggml_gfx906_tpu/utils/config.py, holding only the knobs
the ported path reads. Precedence is the reference's: built-in default <
GGML_TORCH_<NAME> env var < programmatic `set()`.

    from ggml_gfx906_tpu_torch.utils import config
    config.get("int8_min_m")          # 64
    config.set("int8_min_m", 128)     # highest precedence
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class _Entry:
    default: Any
    parse: Callable[[str], Any]
    help: str
    choices: tuple = ()     # the values a string knob takes, when it is an enum


_REGISTRY: dict[str, _Entry] = {}
_OVERRIDES: dict[str, Any] = {}


def _bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def register(name: str, default, help: str, parse=None, choices: tuple = ()):
    """Declare a knob. parse defaults to the type of `default`; choices
    lists the values of an enumerated knob (any other raises ValueError)."""
    if parse is None:
        parse = _bool if isinstance(default, bool) else type(default)
    _REGISTRY[name] = _Entry(default, parse, help, choices)
    return name


def _env_key(name: str) -> str:
    return "GGML_TORCH_" + name.upper()


def _check(name: str, value):
    e = _REGISTRY[name]
    if e.choices and value not in e.choices:
        raise ValueError(f"config {name}={value!r}: one of {list(e.choices)}")
    return value


def get(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; have {sorted(_REGISTRY)}")
    if name in _OVERRIDES:
        return _OVERRIDES[name]
    raw = os.environ.get(_env_key(name))
    if raw is not None:
        return _check(name, _REGISTRY[name].parse(raw))
    return _REGISTRY[name].default


def set(name: str, value) -> None:   # noqa: A001 - mirrors the reference
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; have {sorted(_REGISTRY)}")
    _OVERRIDES[name] = _check(name, value)


def unset(name: str) -> None:
    _OVERRIDES.pop(name, None)


# ---------------------------------------------------------------- knobs

register("int8_min_m", 64,
         "batch-size threshold at which Q4_K, Q8_0 and Q4_0 matmuls switch "
         "from the f32 kernels (K1, K5, K6) to the int8 kernels (K3, K5-i8, "
         "K6-i8); 0 disables the int8 path")
register("qmm_pipeline", "off",
         "single-stream (M = 1) Q4_K decode matvecs through K10 "
         "(qmm_q4_K_pipelined: x in bf16, scales on per-group sums): 'on', "
         "'auto' (on for operands on the card) or 'off' (K1)",
         choices=("off", "on", "auto"))
register("int8_tile", 512,
         "K-tile width of the int8 execution layout (per-(row, tile) requant "
         "scale granularity); halved while K % tile != 0 and, for this "
         "default, while K / tile < 8, down to 128 (ops/quantized.py::"
         "_choose_tile)")
register("weights_layout", "kernel",
         "quantized weight execution layout: 'kernel' (the GGUF types' "
         "fields and their matmul kernels K1-K10), 'int8' (tile-major int8 "
         "+ per-tile f32 scales, exact per-tile integer dots in plain torch) "
         "or 'auto' (measure both once per process and pick; utils/"
         "autotune.py::choose)",
         choices=("kernel", "int8", "auto"))
register("attn_impl", "pallas",
         "causal attention implementation: 'pallas' (kernel K2, ops/cuda/"
         "flash_attn.py) or 'xla' (the plain materialized-mask attention "
         "ops/attention.py::_causal_ref); the reference's value names, so "
         "that a setting and utils/autotune.py::choose_attn read the same in "
         "both packages",
         choices=("pallas", "xla"))
register("engine_chunk_size", 128,
         "prompt tokens prefilled per engine step during admission")
register("engine_min_window", 32,
         "smallest attention-window bucket the engine's decode step uses")
register("engine_harvest_depth", 8,
         "decode steps chained on the device per harvest in Engine.run; "
         "windows are pipelined (window k is read back after window k+1 is "
         "dispatched). Token streams are bit-identical to depth 1 — "
         "completed slots' in-flight extra steps are discarded at harvest")
register("engine_scan_window", True,
         "run each harvest window as ONE replay of a CUDA graph captured "
         "for (window bucket, depth) when no admission can occur "
         "mid-window (the reference's lax.scan window, its own analogue of "
         "ref src/ggml-cuda/ggml-cuda.cu:2962). Token streams stay "
         "bit-identical. False = one replay of the one-step graph per step "
         "within pipelined windows")
register("kv_quant", False,
         "store serving KV caches as int8 with per-(head,pos) scales "
         "(Engine; llama.generate takes kv_quant= directly)")
register("kv_attn_int8_dot", True,
         "quantized-KV attention on the plain path (attn_impl='xla', window-"
         "delta decode) computes the decode score dot int8 x int8 (q rows "
         "quantized per (slot, head); ggml's Q8_1 analogue, ref vecdotq.cuh) "
         "instead of converting the int8 cache inside the dot; bf16-compute "
         "paths only (f32 keeps exact dots). K2 takes the int8 cache as it is")
register("engine_window_delta", False,
         "scan-window decode writes each step's K/V rows into a small "
         "per-window delta buffer at a uniform column and absorbs the whole "
         "window once; attention merges the two segments at score level in "
         "plain torch (ops/attention.py::causal_attn_delta), in place of K2. "
         "Numerically equivalent, not bitwise (the delta rounds P and the "
         "fresh rows to bf16). Deliberately off here, where the reference "
         "defaults to on: on the H100 the per-slot write it saves is one small "
         "kernel per layer, and the delta window replaces K2 with einsums "
         "(a 32-layer 7B-width depth-8 window at attention window 256 on an "
         "H100 80GB HBM3: 168 ms on the delta against 141 ms strict)")
register("kv_page_size", 64,
         "positions per page of the paged serving KV pool "
         "(Engine(paged_pages=N); runtime/paged_kv.py)")
