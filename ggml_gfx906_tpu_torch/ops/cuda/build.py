"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` becomes `build/torch_kernels/lib<name>-<hash>.so` at
the root of the checkout, compiled for Hopper (`sm_90a`) with a plain C
interface. The hash covers the source, the headers in `csrc/` and the
source's flags (`flags`), so an edited source or header builds anew and an
unchanged one is reused. Builds happen at first use,
never at import: `build_all()` starts one nvcc per source, all at once, and
waits for them; `library(name)` builds one source if it is missing.

Every exported function takes pointers and the stream as `c_void_p`, ints
as `c_int` / `c_longlong`, floats as `c_float`, and returns a cudaError_t
(0 = success) that the wrapper turns into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# flags of one source after NVCC_FLAGS: the IQ searches must round every
# f32 product and sum as numpy does, so nvcc may not contract a*b + c into
# an FMA there (the matmul kernels keep their FMAs)
SOURCE_FLAGS = {"iq_search": ["--fmad=false"]}

# C signatures: name → (source, argtypes)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "qmm_q4k_f32": ("qmm_q4k", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "qmm_q4k_i8_quant_x": ("qmm_q4k", [_P, _I] + [_P] * 4 + [_I, _I, _P]),
    "qmm_q4k_i8": ("qmm_q4k", [_P] * 8 + [_I, _I, _I, _P]),
    "qmm_q6k_f32": ("qmm_q6k", [_P] * 6 + [_I, _I, _I, _P]),
    "qmm_q8_0_f32": ("qmm_q8_0", [_P] * 4 + [_I, _I, _I, _P]),
    "qmm_q8_0_i8_quant_x": ("qmm_q8_0", [_P, _I, _P, _P, _I, _I, _P]),
    "qmm_q8_0_i8": ("qmm_q8_0", [_P] * 5 + [_I, _I, _I, _P]),
    "qmm_q4_0_f32": ("qmm_legacy", [_P] * 4 + [_I, _I, _I, _P]),
    "qmm_q4_0_i8_quant_x": ("qmm_q4_0", [_P, _I] + [_P] * 4 + [_I, _I, _P]),
    "qmm_q4_0_i8": ("qmm_q4_0", [_P] * 7 + [_I, _I, _I, _P]),
    "qmm_q5k_f32": ("qmm_q5k", [_P] * 6 + [_I, _I, _I, _P]),
    "qmm_q4_1_f32": ("qmm_legacy", [_P] * 5 + [_I, _I, _I, _P]),
    "qmm_q5_0_f32": ("qmm_legacy", [_P] * 5 + [_I, _I, _I, _P]),
    "qmm_q5_1_f32": ("qmm_legacy", [_P] * 6 + [_I, _I, _I, _P]),
    "qmm_q2k_f32": ("qmm_q23k", [_P] * 6 + [_I, _I, _I, _P]),
    "qmm_q3k_f32": ("qmm_q23k", [_P] * 6 + [_I, _I, _I, _P]),
    "qmm_q4k_pipe": ("qmm_q4k_pipe", [_P] * 5 + [_I, _I, _P]),
    "flash_attn_fwd": ("flash_attn", [_P] * 8 + [_I] * 6 + [_L, _L]
                       + [_F, _F, _F, _I, _I, _P]),
    "dma_copy_f32": ("dma_copy", [_P, _P, _L, _P]),
    "iq3_search": ("iq_search", [_I, _P, _P, _I, _L] + [_P] * 4 + [_I, _P]),
    "iq2_search": ("iq_search", [_I, _P, _P, _I, _L] + [_P] * 4 + [_I, _P]),
    "iq1_search": ("iq_search", [_I, _P, _P, _I, _L] + [_P] * 4 + [_I, _P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}     # source → {"seconds", "ptxas"}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def flags(name: str) -> list[str]:
    """nvcc's flags for `csrc/<name>.cu`: NVCC_FLAGS, then its own."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, [])


def digest(name: str, csrc: Path = CSRC) -> str:
    """The hash of `csrc/<name>.cu`, of every header in `csrc/` (a source
    may include any of them) and of its flags, which names its build."""
    h = hashlib.sha256()
    h.update((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{digest(name)}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every missing library, one nvcc process per source, all
    started together. Raises with nvcc's output if any build fails."""
    names = names or sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        target = _target(name)
        out[name] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    errors = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, (src, argtypes) in SIGNATURES.items():
            if src == name:
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def call(fn: str, *args) -> None:
    """Call an exported kernel launcher; raise on a non-zero cudaError_t."""
    err = getattr(library(SIGNATURES[fn][0]), fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA error {err} at launch")
