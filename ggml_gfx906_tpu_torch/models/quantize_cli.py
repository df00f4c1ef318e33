"""Model quantization CLI (the `gpt-2-quantize` / common-ggml analogue).

The port of ggml_gfx906_tpu/models/quantize_cli.py (ggml's
examples/common-ggml.cpp:41 ggml_common_quantize_0: the 2-D matmul weights
go to the target type, everything else is copied; ggml_quantize_chunk's
quant_weights for the imatrix, include/ggml.h:2406-2416). Each eligible
tensor is read, moved to the device and quantized there by the port's
codecs; its bytes come back for the writer. Given the same file, type and
imatrix, the output is byte-identical to the reference's.

    python -m ggml_gfx906_tpu_torch.models.quantize_cli in.gguf out.gguf q4_K \
        [--imatrix cal.imatrix.npz] [--device cpu]

It takes every type the reference's does, the IQ grid searches included
(ops/cuda/iq_search.py: the kernels S1-S3 on the card). Two differences
from the reference's command, both deliberate: `--device` (default cuda:
the card; the command raises where there is none unless given --device
cpu), and a type that needs an imatrix given none (IQ2_XXS, IQ2_XS,
IQ1_S) prints an error and exits 1 where the reference's command raises.
"""
from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np
import torch

from ..gguf import GGUFReader, GGUFWriter
from ..quant import GGMLType, TYPE_TRAITS
from ..ops.cuda.iq_search import IMATRIX_REQUIRED
from ..quant.registry import _QUANTIZE_IMATRIX, quantize, supported_quant_types
from ..utils.device import resolve
from .convert import QUANT_PATTERNS


def _read_float(r: GGUFReader, name: str, device) -> torch.Tensor:
    """An F32 or F16 tensor's data on `device` as f32 (F16 converted there)."""
    host = torch.from_numpy(np.array(r.tensor_array(name)))
    return host.to(device).to(torch.float32)


def quantize_gguf(src_path, dst_path, ftype: GGMLType, verbose: bool = True,
                  imatrix: dict | None = None, device=None):
    """Copy a GGUF with its eligible F32/F16 matrices quantized to ftype on
    `device` (the card unless device="cpu"). imatrix: {tensor name: (K,)
    importance row} (models/imatrix.py). Returns (bytes in, bytes out)."""
    device = resolve(device)
    r = GGUFReader(src_path)
    w = GGUFWriter(alignment=r.alignment)
    for key, value in r.kv.items():
        if key == "general.alignment":
            continue
        w.set(key, value, r.kv_types[key])
    w.set("general.file_type", int(ftype))

    total_in = total_out = 0
    for name, ti in r.tensors.items():
        t0 = time.time()
        eligible = (ti.type in (GGMLType.F32, GGMLType.F16) and len(ti.ne) == 2
                    and any(re.fullmatch(p, name) for p in QUANT_PATTERNS)
                    and ti.ne[0] % TYPE_TRAITS[ftype].blck_size == 0)
        if eligible:
            qw = imatrix.get(name) if imatrix else None
            if ftype in IMATRIX_REQUIRED and qw is None:
                raise ValueError(
                    f"{TYPE_TRAITS[ftype].name} requires an imatrix entry "
                    f"for {name!r} (--imatrix, models/imatrix.py)")
            if qw is not None and ftype not in _QUANTIZE_IMATRIX:
                qw = None          # the type has no imatrix-aware path
            if qw is not None:
                qw = torch.as_tensor(np.asarray(qw, np.float32), device=device)
            raw = quantize(ftype, _read_float(r, name, device), qw).cpu().numpy().reshape(-1)
            out_type = ftype
        else:
            raw = np.array(r.tensor_bytes(name))
            out_type = ti.type
        w.add_tensor(name, ti.ne, out_type, raw)
        total_in += ti.n_bytes
        total_out += len(raw)
        if verbose:
            tag = f"→ {TYPE_TRAITS[out_type].name}" if eligible else "(copy)"
            print(f"  {name:40s} {str(ti.shape):>16s} "
                  f"{ti.n_bytes/1e6:8.2f} MB {tag} ({time.time()-t0:.1f}s)",
                  file=sys.stderr)
    w.write(dst_path)
    if verbose:
        print(f"total: {total_in/1e6:.1f} MB → {total_out/1e6:.1f} MB "
              f"({100*total_out/max(total_in,1):.1f}%)", file=sys.stderr)
    return total_in, total_out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Quantize a GGUF model")
    ap.add_argument("src")
    ap.add_argument("dst")
    all_types = sorted(set(supported_quant_types()) | set(_QUANTIZE_IMATRIX))
    ap.add_argument("type", help="target type: " + ", ".join(
        t.name.lower() for t in all_types))
    ap.add_argument("--imatrix", help="importance matrix .npz "
                    "(models/imatrix.py output; required for "
                    + ", ".join(t.name.lower() for t in sorted(IMATRIX_REQUIRED)) + ")")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the codecs run: cuda (default, the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    try:
        ftype = GGMLType[args.type.upper()]
    except KeyError:
        print(f"error: unknown type {args.type!r}", file=sys.stderr)
        return 1
    if not TYPE_TRAITS[ftype].is_quantized:
        print(f"error: {args.type} is not a quantized type", file=sys.stderr)
        return 1
    im = dict(np.load(args.imatrix)) if args.imatrix else None
    try:
        quantize_gguf(args.src, args.dst, ftype, verbose=not args.quiet, imatrix=im,
                      device=device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
