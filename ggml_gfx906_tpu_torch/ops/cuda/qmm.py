"""Q4_K matmul kernels K1 (f32, M < int8_min_m) and K3 (int8, M >= it),
and the operand checks, f32 launch and int8 operand preparation that the
other formats' kernels (qmm_q6k.py, qmm_q8_0.py, qmm_legacy.py, ...) share
with them.

Kernel source: csrc/qmm_q4k.cu (fuller notes there); K1 is the format Q4K
on the shared f32 body csrc/qmm_f32_tiled.cuh.

- K1 `qmm_q4_K` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_K.
  The C entry point picks the body's kernel by M: at M <= 8 (decode) lanes
  over the K chunks with x staged in shared memory, bound by the packed
  weight bytes (~0.59 B per weight, read once); at larger M a block
  dequantizes a weight tile once into shared memory for 32 or 64
  activation rows, bound by the f32 FMA rate. One summation order at
  every M (32 slots over the K chunks, then the xor-butterfly tree), so a
  row's bits do not depend on M (no TF32, no atomics).
- K3 `qmm_q4_K_i8` replaces ggml_gfx906_tpu/ops/pallas/qmm.py::qmm_q4_K_i8.
  Bound on the H100: operations at large M (int8), the weight bytes and
  their expansion at M≈128. Two launches per call: one kernel quantizes x
  per (row, 128-element tile) (the bits of `split_x` + `quantize_x_tiles`),
  then the int8 body (csrc/qmm_i8_tiled.cuh, format Q4KI8) folds the block
  scales by the per-tile bound and expands the packed weights to int8 in
  shared memory (the bits of `scale_arrays` + `tile_fold` + `expand_w8`),
  takes the integer dots on the int8 tensor cores (mma.sync) and adds the
  f32 epilogue in the reference's order. So its output has the bits of
  its plain version's order of operations at every M.

Weight layout (ggml wire order, struct of arrays; see ops/quantized.py):
qs (N, K/2) u8, scm (N, K/16) u8 = unpacked [sc0..7 | m0..7] per
superblock, dd (N, K/128) f32 = [d, dmin] per superblock.

The int8 tiles group the same elements as the reference's kernel element
order: tile (lo, t) is the 128 low-nibble elements of superblock t, tile
(hi, t) its 128 high-nibble elements (qmm.py:529-542 on q4k_split_x). Here
each tile is laid out in qs byte order.
"""
from __future__ import annotations

import torch

from ...quant.dequant_math import dequant_q4_K_unpacked
from . import K1, K3, build


def check_shapes(want: dict) -> None:
    """want: name → (tensor, shape, dtype); every tensor on the first one's
    device. Raises ValueError naming the first operand that differs."""
    dev = next(iter(want.values()))[0].device
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want {tuple(shape)} {dt}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, the weights on {dev}")


def check_x(x, k_mult: int) -> tuple[int, int]:
    """(M, K) of a 2-D activation whose K is a multiple of k_mult."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    m, k = x.shape
    if k % k_mult:
        raise ValueError(f"K={k} is not a multiple of {k_mult}")
    return m, k


def check_fields(x, widths: dict, **fields) -> None:
    """x is (M, K) with K % 256 == 0, and each field f is (N, K // e) of
    dtype dt where widths[f] = (e, dt): e elements of K per byte or value."""
    _, k = check_x(x, 256)
    n = fields["qs"].shape[0]
    check_shapes({f: (t, (n, k // widths[f][0]), widths[f][1]) for f, t in fields.items()})


def check_q4k_weights(qs, scm, dd, k):
    n, nb = qs.shape[0], k // 256
    check_shapes({"qs": (qs, (n, nb * 128), torch.uint8),
                  "scm": (scm, (n, nb * 16), torch.uint8),
                  "dd": (dd, (n, nb * 2), torch.float32)})


def aligned_x(x):
    """x as a contiguous f32 tensor at a 16-byte aligned address (the f32
    kernels read it with 16-byte loads)."""
    x = x.float().contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def kernel_x(x):
    """x as the x-quantization kernels take it: bf16 or f32, contiguous, at
    a 16-byte aligned address."""
    if x.dtype != torch.bfloat16:
        x = x.float()
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def check_cuda(*ts):
    for t in ts:
        if not t.is_cuda:
            raise ValueError("mixed devices: every operand must be on the card")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def launch_f32(fn: str, kernel, x, *fields):
    """Launch the f32 matmul entry point `fn` (build.SIGNATURES) of a
    kernel whose C signature is (x, fields..., y, M, N, K, stream), on
    CUDA operands with qs first, and count the launch."""
    rows, k = x.shape
    n = fields[0].shape[0]
    x = aligned_x(x)
    y = torch.empty((rows, n), dtype=torch.float32, device=fields[0].device)
    check_cuda(x, *fields)
    build.call(fn, x.data_ptr(), *(f.data_ptr() for f in fields), y.data_ptr(),
               rows, n, k, torch.cuda.current_stream(fields[0].device).cuda_stream)
    kernel.launches += 1
    return y


def scale_arrays(scm, dd):
    """Packed scale fields → the four premultiplied f32 (N, nb*4) arrays
    (dsclo, dschi, dmlo, dmhi) of the even (lo) and odd (hi) sub-blocks —
    the counterpart of qmm.py::q4k_scale_arrays."""
    n = scm.shape[0]
    s = scm.reshape(n, -1, 16).float()
    d = dd.reshape(n, -1, 2)
    dsc = s[:, :, 0:8] * d[:, :, 0:1]
    dm = s[:, :, 8:16] * d[:, :, 1:2]
    r = lambda a: a.reshape(n, -1).contiguous()   # noqa: E731
    return r(dsc[:, :, 0::2]), r(dsc[:, :, 1::2]), r(dm[:, :, 0::2]), r(dm[:, :, 1::2])


def dequant(qs, scm, dd):
    """Dense (N, K) f32 weights, bit-identical to ggml's dequantization."""
    n = qs.shape[0]
    s = scm.reshape(n, -1, 16)
    d = dd.reshape(n, -1, 2)
    return dequant_q4_K_unpacked(d[..., 0], d[..., 1], s[..., 0:8], s[..., 8:16],
                                 qs.reshape(n, -1, 128)).reshape(n, -1)


# ------------------------------------------------------------------ K1

def qmm_q4_K_plain(x, qs, scm, dd):
    """Plain PyTorch K1: dequantize, then one f32 product (TF32 off)."""
    return x.float() @ dequant(qs, scm, dd).T


def qmm_q4_K(x, qs, scm, dd):
    """x (M, K) @ W(N, K).T → (M, N) f32, W in the port's Q4_K layout."""
    m, k = check_x(x, 256)
    check_q4k_weights(qs, scm, dd, k)
    if not qs.is_cuda:
        return qmm_q4_K_plain(x, qs, scm, dd)
    x = aligned_x(x)
    n = qs.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=qs.device)
    check_cuda(x, qs, scm, dd)
    build.call("qmm_q4k_f32", x.data_ptr(), qs.data_ptr(), scm.data_ptr(),
               dd.data_ptr(), y.data_ptr(), m, n, k,
               torch.cuda.current_stream(qs.device).cuda_stream)
    K1.launches += 1
    return y


# ------------------------------------------------------------------ K3

def split_x(x):
    """x (M, K) → x_lo, x_hi (M, K/2): per superblock, the elements under
    the low / high nibbles, in qs byte order (32*g + j ↔ 64*g + j)."""
    m, k = x.shape
    xr = x.reshape(m, k // 256, 4, 2, 32)
    return (xr[:, :, :, 0, :].reshape(m, k // 2),
            xr[:, :, :, 1, :].reshape(m, k // 2))


def _scale_and_inverse(amax):
    """(amax/127, 127/amax or 0) as true f32 divisions. Spelled as
    tensor/tensor on purpose: `127.0 / t` is t.reciprocal() * 127 in torch,
    and a CUDA tensor divided by a Python scalar is multiplied by its
    reciprocal — both round differently from the reference's division."""
    c = torch.full_like(amax, 127.0)
    pos = amax > 0
    inv = torch.where(pos, c / torch.where(pos, amax, torch.ones_like(amax)),
                      torch.zeros_like(amax))
    return amax / c, inv


def quantize_x_tiles(x):
    """Per-(row, 128-element tile) symmetric int8 quantization → qx (M, K)
    int8, ex (M, K/128) f32 — qmm.py::quantize_x_tiles, same roundings
    (round half to even, clip to ±127)."""
    m, k = x.shape
    xt = x.reshape(m, k // 128, 128).float()
    amax = xt.abs().amax(-1)
    ex, inv = _scale_and_inverse(amax)
    qx = torch.clamp(torch.round(xt * inv[..., None]), -127.0, 127.0)
    return qx.to(torch.int8).reshape(m, k), ex


def tile_fold(dsc, dm, blk_per_tile: int, qmax: float):
    """Fold per-block scales by the analytic per-tile bound (qmm.py::
    _tile_fold): dw = max|w|/127 per (row, tile) with |w| ≤ max(|qmax·dsc −
    dm|, |dm|), or ≤ qmax·|dsc| for a symmetric format (dm None); returns
    (dsc/dw, dm/dw or None, dw (N, tiles))."""
    n, nblk = dsc.shape
    kt = nblk // blk_per_tile
    d3 = dsc.reshape(n, kt, blk_per_tile)
    if dm is None:
        bound = qmax * torch.abs(d3)
    else:
        m3 = dm.reshape(n, kt, blk_per_tile)
        bound = torch.maximum(torch.abs(qmax * d3 - m3), torch.abs(m3))
    dw, inv = _scale_and_inverse(bound.amax(-1))
    dm_f = None if dm is None else (m3 * inv[..., None]).reshape(n, nblk).contiguous()
    return (d3 * inv[..., None]).reshape(n, nblk).contiguous(), dm_f, dw.contiguous()


def prepare_i8(x, scm, dd):
    """The operands K3 takes besides qs: (qxlo, exlo, qxhi, exhi, dsclo_f,
    dschi_f, dmlo_f, dmhi_f, dwlo, dwhi)."""
    xlo, xhi = split_x(x.float())
    qxlo, exlo = quantize_x_tiles(xlo)
    qxhi, exhi = quantize_x_tiles(xhi)
    dsclo, dschi, dmlo, dmhi = scale_arrays(scm, dd)
    dsclo_f, dmlo_f, dwlo = tile_fold(dsclo, dmlo, 4, 15.0)
    dschi_f, dmhi_f, dwhi = tile_fold(dschi, dmhi, 4, 15.0)
    return (qxlo, exlo, qxhi, exhi, dsclo_f, dschi_f, dmlo_f, dmhi_f, dwlo, dwhi)


def expand_w8(qs, dsc_f, dm_f, high: bool):
    """Packed nibbles → int8 weights (N, nb*128) in qs byte order, with the
    folded scales: round_half_even(q·dsc' − dm') clipped to ±127 (qmm.py::
    _round_i8). The product and the difference round separately."""
    n = qs.shape[0]
    q = (qs >> 4) if high else (qs & 0xF)
    q = q.reshape(n, -1, 4, 32).float()
    w = q * dsc_f.reshape(n, -1, 4, 1) - dm_f.reshape(n, -1, 4, 1)
    return torch.clamp(torch.round(w), -127.0, 127.0).to(torch.int8).reshape(n, -1)


def qmm_q4_K_i8_plain(qs, qxlo, exlo, qxhi, exhi, dsclo_f, dschi_f, dmlo_f,
                      dmhi_f, dwlo, dwhi):
    """Plain PyTorch K3 on prepared operands. Each tile's integer dot runs
    as an f32 product of int8 values: every partial sum is an integer below
    2^24, so it is exact in f32 whatever the summation order."""
    m = qxlo.shape[0]
    n = qs.shape[0]
    nb = exlo.shape[1]
    wlo = expand_w8(qs, dsclo_f, dmlo_f, False).reshape(n, nb, 128).float()
    whi = expand_w8(qs, dschi_f, dmhi_f, True).reshape(n, nb, 128).float()
    xlo = qxlo.reshape(m, nb, 128).float()
    xhi = qxhi.reshape(m, nb, 128).float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=qs.device)
    for t in range(nb):
        plo = xlo[:, t] @ wlo[:, t].T
        phi = xhi[:, t] @ whi[:, t].T
        acc = acc + plo * exlo[:, t:t + 1] * dwlo[None, :, t]
        acc = acc + phi * exhi[:, t:t + 1] * dwhi[None, :, t]
    return acc


def quantize_x(x):
    """x (M, K) → (qxlo, exlo, qxhi, exhi), K3's activation operands: on
    the card one kernel, on the CPU `split_x` + `quantize_x_tiles` (the
    same bits)."""
    m, k = check_x(x, 256)
    if not x.is_cuda:
        xlo, xhi = split_x(x.float())
        return (*quantize_x_tiles(xlo), *quantize_x_tiles(xhi))
    x = kernel_x(x)
    qx = torch.empty((2, m, k // 2), dtype=torch.int8, device=x.device)
    exlo, exhi = (torch.empty((m, k // 256), dtype=torch.float32, device=x.device)
                  for _ in range(2))
    build.call("qmm_q4k_i8_quant_x", x.data_ptr(), int(x.dtype == torch.bfloat16),
               qx[0].data_ptr(), exlo.data_ptr(), qx[1].data_ptr(), exhi.data_ptr(),
               m, k, torch.cuda.current_stream(x.device).cuda_stream)
    return qx[0], exlo, qx[1], exhi


def qmm_q4_K_i8(x, qs, scm, dd):
    """Integer Q4_K matmul (prefill route): x (M, K) → (M, N) f32."""
    _, k = check_x(x, 256)
    check_q4k_weights(qs, scm, dd, k)
    if not qs.is_cuda:
        return qmm_q4_K_i8_plain(qs, *prepare_i8(x, scm, dd))
    return launch_i8(qs, scm, dd, *quantize_x(x))


def launch_i8(qs, scm, dd, qxlo, exlo, qxhi, exhi):
    """Launch K3's product on quantized x (CUDA tensors; quantize_x's
    output) and the Q4_K weights as K1 takes them."""
    m, n, k = qxlo.shape[0], qs.shape[0], qs.shape[1] * 2
    check_q4k_weights(qs, scm, dd, k)
    check_shapes({"qxlo": (qxlo, (m, k // 2), torch.int8), "qxhi": (qxhi, (m, k // 2), torch.int8),
                  "exlo": (exlo, (m, k // 256), torch.float32),
                  "exhi": (exhi, (m, k // 256), torch.float32)})
    check_cuda(qs, scm, dd, qxlo, exlo, qxhi, exhi)
    y = torch.empty((m, n), dtype=torch.float32, device=qs.device)
    build.call("qmm_q4k_i8", qxlo.data_ptr(), exlo.data_ptr(), qxhi.data_ptr(),
               exhi.data_ptr(), qs.data_ptr(), scm.data_ptr(), dd.data_ptr(), y.data_ptr(),
               m, n, k, torch.cuda.current_stream(qs.device).cuda_stream)
    K3.launches += 1
    return y
