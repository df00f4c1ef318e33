"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--layers N] [--out DIR]

Phases (each failure raises, so the script exits non-zero):
  1. device: requires CUDA; prints `nvidia-smi` name and power limit; TF32
     off for the plain versions;
  2. build: compiles ggml_gfx906_tpu_torch/csrc/*.cu with nvcc (one process
     per source, all at once) into build/torch_kernels/;
  3. kernels: K1 (Q4_K f32 matmul), K3 (Q4_K int8 matmul) and K2 (causal
     flash attention) against their plain PyTorch versions at the main
     path's shapes, each timed with CUDA events beside its plain version,
     its library yardstick and its bound;
  4. main path at full llama-7B width: writes a 7B-shape Q4_K GGUF (random
     but valid blocks, constructed scales; cached under build/), loads it
     to the card, runs `generate`, then serves 8+1 requests through
     `Engine`, asserts engine streams == single-sequence `generate`
     streams, and that K1, K2 and K3 all launched; traces one decode step
     and one 8-slot engine decode step with torch.profiler for the
     device-busy share;
  5. a small-model check of the card's forward against the CPU's.
Detailed results go to DIR/chip_smoke.json (default build/). The second-to-last
stdout line is {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ggml_gfx906_tpu_torch.gguf import GGUFWriter
from ggml_gfx906_tpu_torch.models import llama
from ggml_gfx906_tpu_torch.ops import cuda as kernels
from ggml_gfx906_tpu_torch.ops.cuda import build, flash_attn, qmm
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.quant.kquants import pack_scale_min_k4
from ggml_gfx906_tpu_torch.quant.types import BLOCK_Q4_K, GGMLType
from ggml_gfx906_tpu_torch.runtime.engine import Engine

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and op/s
HBM_BPS = 3.35e12
PEAK = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
CFG_7B = dict(n_vocab=32000, n_ctx=2048, n_embd=4096, n_head=32, n_kv_head=32,
              n_ff=11008)
# (N, K) of the 7B matmuls: wq/wk/wv/wo, w_gate/w_up, w_down, the head
QMM_SHAPES = ((4096, 4096), (11008, 4096), (4096, 11008), (32000, 4096))
PARITY_LENS = (16, 24, 32, 64, 80, 96, 112, 128)
N_NEW = 32


def nmse(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float(((got - ref) ** 2).mean() / (ref ** 2).mean().clamp_min(1e-30))


def log(msg: str):
    print(msg, flush=True)


# ------------------------------------------------------------- timing

class Timer:
    """Median device time of a call, by CUDA events, L2 flushed before each
    launch (the main path streams weights from HBM). A spin kernel ahead of
    each timed call keeps the device busy while the host enqueues it, so the
    interval between the events holds the call's kernels and not the
    host's launch overhead (which the main-path tok/s numbers include)."""

    SPIN_CYCLES = 10_000_000        # ~6 ms at H100 clocks

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def trace_device(fn) -> dict:
    """One call of fn under torch.profiler: the device's busy time (union of
    its kernel and copy intervals), the number of device activities, and
    the busiest kernel names. busy_ms is None when the trace holds no
    device activity (the profiler could not see the card)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda t: t[0])
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in ev:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        key = name[:60]
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy_ms": busy_us / 1e3 if ev else None, "device_activities": len(ev),
            "profiled_wall_ms": wall * 1e3,
            "top_ms": [[name, us / 1e3] for name, us in top]}


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / PEAK[kind] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ------------------------------------------------------------- kernels

def random_q4k(n, k, device, gen):
    """Q4_K weights with random nibbles and 6-bit scales, plausible d."""
    nb = k // 256
    qs = torch.randint(0, 256, (n, nb * 128), dtype=torch.uint8, device=device, generator=gen)
    scm = torch.randint(0, 64, (n, nb * 16), dtype=torch.uint8, device=device, generator=gen)
    dd = torch.rand((n, nb * 2), device=device, generator=gen) * (0.02 / 8)
    return qs, scm, dd


def check_qmm(device, timer, results):
    gen = torch.Generator(device=device).manual_seed(1)
    for n, k in QMM_SHAPES:
        qs, scm, dd = random_q4k(n, k, device, gen)
        w_dense = qmm.dequant(qs, scm, dd)
        wbytes = n * k / 2 + n * k / 16 + n * k / 32
        # decode (1, 8 slots) and the engine's short prefill chunks (16, 32):
        # M > 8 runs the kernel's second and later M tiles, 63 a ragged one
        for m in (1, 8, 16, 32, 63):
            x = torch.randn((m, k), device=device, generator=gen)
            got = qmm.qmm_q4_K(x, qs, scm, dd)
            ref = qmm.qmm_q4_K_plain(x, qs, scm, dd)
            torch.cuda.synchronize()
            e = nmse(got, ref)
            if not e < 1e-10:
                raise AssertionError(f"K1 M={m} N={n} K={k}: nmse {e}")
            b, by = bound(wbytes + m * k * 4 + m * n * 4, 2.0 * m * n * k, "f32")
            results.append(dict(
                kernel="qmm_q4_K", shape=f"M={m} N={n} K={k}", nmse=e,
                max_abs_err=float((got - ref).abs().max()),
                ms=timer(lambda: qmm.qmm_q4_K(x, qs, scm, dd)),
                plain_ms=timer(lambda: qmm.qmm_q4_K_plain(x, qs, scm, dd)),
                library_ms=timer(lambda: torch.matmul(x, w_dense.T)),
                bound_ms=b, bound_by=by))
            log(f"K1 M={m} N={n} K={k} nmse={e:.3e} ms={results[-1]['ms']:.4f}")
        for m in (100, 128, 512):        # 100: the ragged single-stream prefill
            x = torch.randn((m, k), device=device, generator=gen)
            ops = qmm.prepare_i8(x, scm, dd)
            got = qmm.launch_i8(qs, *ops)
            ref = qmm.qmm_q4_K_i8_plain(qs, *ops)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            scale = ref.abs().max()
            if not bool((err <= 1e-5 * ref.abs() + 1e-6 * scale).all()):
                raise AssertionError(f"K3 M={m} N={n} K={k}: rel err "
                                     f"{float((err / ref.abs().clamp_min(1e-30)).max())}")
            b, by = bound(wbytes + m * k * 4 + m * n * 4, 2.0 * m * n * k, "int8")
            results.append(dict(
                kernel="qmm_q4_K_i8", shape=f"M={m} N={n} K={k}", nmse=nmse(got, ref),
                max_abs_err=float(err.max()),
                ms=timer(lambda: qmm.qmm_q4_K_i8(x, qs, scm, dd)),
                kernel_only_ms=timer(lambda: qmm.launch_i8(qs, *ops)),
                plain_ms=timer(lambda: qmm.qmm_q4_K_i8_plain(qs, *qmm.prepare_i8(x, scm, dd))),
                library_ms=timer(lambda: torch.matmul(x, w_dense.T)),
                bound_ms=b, bound_by=by))
            log(f"K3 M={m} N={n} K={k} nmse={results[-1]['nmse']:.3e} "
                f"ms={results[-1]['ms']:.4f}")
        del w_dense


def _sdpa(q, k, v, pos, scale, softcap):
    """The one PyTorch call for the same function (yardstick only)."""
    if softcap or k.dtype == torch.int8:
        return None
    n, m = q.shape[2], k.shape[2]
    mask = (torch.arange(m, device=q.device)[None, None, None, :]
            <= (pos[:, None, None, None] + torch.arange(n, device=q.device)[None, None, :, None]))
    g = q.shape[1] // k.shape[1]
    if g > 1:      # grouped heads, expanded outside the timed call
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    qd = q.to(k.dtype)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, k, v, attn_mask=mask, scale=scale)


def check_attention(device, timer, results):
    gen = torch.Generator(device=device).manual_seed(2)
    D = 128
    cases = []
    for m in (32, 64, 128, 256, 512, 1024):          # decode windows
        pos = torch.randint(0, m, (8,), device=device, generator=gen).to(torch.int32)
        for dt in ("f32", "bf16", "f32q_bf16kv"):
            cases.append((f"decode B=8 H=32 window={m} {dt}", 8, 32, 32, 1, m, pos, dt, 0.0, False))
    for p0 in (0, 256):
        pos = torch.tensor([p0], dtype=torch.int32, device=device)
        for dt in ("f32", "bf16", "f32q_bf16kv"):
            cases.append((f"prefill B=1 N=128 M=1024 pos={p0} {dt}", 1, 32, 32, 128, 1024, pos, dt, 0.0, False))
    pos = torch.tensor([300], dtype=torch.int32, device=device)
    cases.append(("gqa prefill H=32 KVH=8 N=128 M=1024 pos=300 f32", 1, 32, 8, 128, 1024, pos, "f32", 0.0, False))
    pos8 = torch.randint(0, 1024, (8,), device=device, generator=gen).to(torch.int32)
    cases.append(("gqa decode B=8 H=32 KVH=8 window=1024 bf16", 8, 32, 8, 1, 1024, pos8, "bf16", 0.0, False))
    cases.append(("int8 kv decode B=8 H=32 window=1024", 8, 32, 32, 1, 1024, pos8, "f32", 0.0, True))
    cases.append(("int8 kv prefill N=128 M=1024 pos=256", 1, 32, 32, 128, 1024,
                  torch.tensor([256], dtype=torch.int32, device=device), "f32", 0.0, True))
    cases.append(("softcap 30 decode B=8 window=1024 f32", 8, 32, 32, 1, 1024, pos8, "f32", 30.0, False))
    cases.append(("window 200 (ragged tile) decode B=8 f32", 8, 32, 32, 1, 200,
                  torch.randint(0, 200, (8,), device=device, generator=gen).to(torch.int32), "f32", 0.0, False))
    scale = 1.0 / D ** 0.5
    for name, B, H, KVH, N, M, pos, dt, softcap, quant in cases:
        qdt = torch.bfloat16 if dt == "bf16" else torch.float32
        kvdt = torch.float32 if dt == "f32" else torch.bfloat16
        q = torch.randn((B, H, N, D), device=device, generator=gen).to(qdt)
        k = torch.randn((B, KVH, M, D), device=device, generator=gen)
        v = torch.randn((B, KVH, M, D), device=device, generator=gen)
        kd = vd = None
        if quant:
            kd = k.abs().amax(-1) / 127.0
            vd = v.abs().amax(-1) / 127.0
            k = torch.round(k / kd[..., None]).to(torch.int8)
            v = torch.round(v / vd[..., None]).to(torch.int8)
        else:
            k, v = k.to(kvdt), v.to(kvdt)
        fn = lambda: flash_attn.causal_flash_attention(q, k, v, pos, scale, softcap, kd, vd)  # noqa: E731
        got = fn()
        ref = flash_attn.causal_flash_attention_plain(q, k, v, pos, scale, softcap, kd, vd)
        torch.cuda.synchronize()
        e = nmse(got.float(), ref.float())
        tol = 2e-4 if qdt == torch.bfloat16 else 1e-10
        if not e < tol:
            raise AssertionError(f"K2 {name}: nmse {e} >= {tol}")
        need = [min(M, int(p) + N) for p in pos.tolist()]          # positions read
        rows = sum(sum(int(p) + n + 1 for n in range(N)) for p in pos.tolist())
        kv_el = k.element_size()
        nbytes = (q.numel() * q.element_size() * 2
                  + sum(need) * KVH * D * kv_el * 2
                  + (sum(need) * KVH * 8 if quant else 0))
        kind = "int8" if quant else ("bf16" if kv_el == 2 else "f32")
        b, by = bound(nbytes, 4.0 * D * H * rows, kind)
        lib = _sdpa(q, k, v, pos, scale, softcap)
        results.append(dict(
            kernel="causal_flash_attention", shape=name, nmse=e,
            max_abs_err=float((got.float() - ref.float()).abs().max()),
            ms=timer(fn),
            plain_ms=timer(lambda: flash_attn.causal_flash_attention_plain(
                q, k, v, pos, scale, softcap, kd, vd)),
            library_ms=timer(lib) if lib is not None else None,
            bound_ms=b, bound_by=by))
        log(f"K2 {name} nmse={e:.3e} ms={results[-1]['ms']:.4f}")


# ------------------------------------------------------------- main path

def write_gguf(path: Path, cfg: dict, n_layer: int):
    """The 7B-shape Q4_K GGUF of bench.py:88-152 with the port's writer:
    valid blocks, constructed scales (sc=32, m=60, d=e, dmin=4e, e =
    1.356e-4: weights ~N(0, 0.02)-scale and centred), random nibbles."""
    if path.exists():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    w = GGUFWriter()
    A = "llama"
    w.set("general.architecture", A)
    w.set(f"{A}.context_length", cfg["n_ctx"])
    w.set(f"{A}.embedding_length", cfg["n_embd"])
    w.set(f"{A}.attention.head_count", cfg["n_head"])
    w.set(f"{A}.attention.head_count_kv", cfg["n_kv_head"])
    w.set(f"{A}.block_count", n_layer)
    w.set(f"{A}.feed_forward_length", cfg["n_ff"])
    w.set(f"{A}.vocab_size", cfg["n_vocab"])
    w.set(f"{A}.attention.layer_norm_rms_epsilon", 1e-5)
    scales12 = pack_scale_min_k4(np.full((1, 8), 32, np.uint8),
                                 np.full((1, 8), 60, np.uint8))[0]
    e = np.float16(1.356e-4)

    def q4k(name, n, k):
        sb = n * (k // 256)
        blocks = np.zeros(sb, BLOCK_Q4_K)
        blocks["d"] = e
        blocks["dmin"] = np.float16(4 * float(e))
        blocks["scales"] = scales12
        blocks["qs"] = np.frombuffer(rng.bytes(sb * 128), np.uint8).reshape(sb, 128)
        w.add_tensor(name, (k, n), GGMLType.Q4_K, blocks.view(np.uint8))

    D, V, FF = cfg["n_embd"], cfg["n_vocab"], cfg["n_ff"]
    KVD = cfg["n_kv_head"] * (D // cfg["n_head"])
    ones = np.ones(D, np.float32)
    q4k("token_embd.weight", V, D)
    w.add_array_tensor("output_norm.weight", ones)
    for i in range(n_layer):
        q4k(f"blk.{i}.attn_q.weight", D, D)
        q4k(f"blk.{i}.attn_k.weight", KVD, D)
        q4k(f"blk.{i}.attn_v.weight", KVD, D)
        q4k(f"blk.{i}.attn_output.weight", D, D)
        q4k(f"blk.{i}.ffn_gate.weight", FF, D)
        q4k(f"blk.{i}.ffn_up.weight", FF, D)
        q4k(f"blk.{i}.ffn_down.weight", D, FF)
        w.add_array_tensor(f"blk.{i}.attn_norm.weight", ones)
        w.add_array_tensor(f"blk.{i}.ffn_norm.weight", ones)
    tmp = path.with_suffix(".tmp")
    w.write(tmp)
    tmp.rename(path)


def launches():
    return {k.name: k.launches for k in kernels.KERNELS}


def main_path(device, n_layer: int, label: str) -> dict:
    out = {"layers": n_layer}
    path = ROOT / "build" / f"smoke_llama7b_q4k_L{n_layer}.gguf"
    t0 = time.perf_counter()
    write_gguf(path, CFG_7B, n_layer)
    out["gguf_write_s"] = time.perf_counter() - t0
    out["gguf_gb"] = path.stat().st_size / 1e9

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = llama.load(path, device=device)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    leaves = [params["wte"], params["out_norm"]] + [t for b in params["blocks"] for t in b.values()]
    for t in leaves:
        fields = t.fields.values() if isinstance(t, QuantTensor) else [t]
        assert all(f.device.type == device.type for f in fields), \
            f"a weight is not on {device}"
    out["weights_gb"] = sum(t.nbytes if isinstance(t, QuantTensor)
                            else t.numel() * t.element_size() for t in leaves) / 1e9
    log(f"loaded {n_layer}-layer 7B-width Q4_K GGUF in {out['load_s']:.2f} s ({label})")

    rng = np.random.default_rng(5)
    kernels.reset_launches()
    with torch.inference_mode():
        # single-stream prefill and decode, timed step by step
        prompt = [int(t) for t in rng.integers(1, cfg.n_vocab, 100)]
        kv = llama.make_cache(cfg, 1024, device=device)
        toks = torch.tensor(prompt, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, kv = llama.forward(cfg, params, toks, kv, 0)
        torch.cuda.synchronize()
        out["prefill_100_s"] = time.perf_counter() - t0
        assert logits.shape == (100, cfg.n_vocab) and bool(torch.isfinite(logits).all())
        stream = prompt + [int(logits[-1].argmax())]
        per_step = {}
        t0 = time.perf_counter()
        for i in range(N_NEW - 1):
            before = launches()
            lg, kv = llama.forward(cfg, params, torch.tensor([stream[-1]], device=device),
                                   kv, len(stream) - 1)
            stream.append(int(lg[-1].argmax()))
            if i == 0:
                per_step = {k: v - before[k] for k, v in launches().items()}
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t0
        out["launches_per_decode_step"] = per_step
        assert stream == llama.generate(cfg, params, prompt, N_NEW, max_seq=1024, device=device)
        out["decode_step_ms"] = out["decode_s"] / (N_NEW - 1) * 1e3
        out["decode_step_trace"] = trace_device(lambda: llama.forward(
            cfg, params, torch.tensor([stream[-1]], device=device), kv, len(stream) - 1))
        # one 128-token prefill chunk
        before = launches()
        llama.forward(cfg, params, torch.tensor(prompt + prompt[:28], device=device),
                      llama.make_cache(cfg, 1024, device=device), 0)
        out["launches_per_prefill_chunk_128"] = {k: v - before[k] for k, v in launches().items()}

        # the engine: 8 parity requests + one 300-token prompt
        prompts = [[int(t) for t in rng.integers(1, cfg.n_vocab, n)] for n in PARITY_LENS]
        long_prompt = [int(t) for t in rng.integers(1, cfg.n_vocab, 300)]
        eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
        rids = [eng.submit(p, N_NEW) for p in prompts]
        eng.submit(long_prompt, N_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = {r.rid: r for r in eng.run()}
        torch.cuda.synchronize()
        out["engine_s"] = time.perf_counter() - t0
        out["engine_tokens"] = sum(len(r.out) for r in done.values())
        out["engine_steps"] = len(eng.window_log)
        mismatches = []
        for rid, p in zip(rids, prompts):
            ref = llama.generate(cfg, params, p, N_NEW, max_seq=1024, device=device)
            if p + done[rid].out != ref:
                mismatches.append(len(p))
        if mismatches:
            raise AssertionError(f"engine streams differ from generate for prompt "
                                 f"lengths {mismatches}")

        # engine decode steps at steady state: 8 active slots, no admission
        del eng                          # one engine's KV cache at a time
        eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
        for p in prompts:
            eng.submit(p, 64)
        while eng.queue or eng.pending is not None:
            eng.step()
        assert all(s is not None for s in eng.slots)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            eng.step()
        out["engine_decode_step_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        out["engine_step_trace"] = trace_device(eng.step)
    for key, step_ms in (("decode_step_trace", out["decode_step_ms"]),
                         ("engine_step_trace", out["engine_decode_step_ms"])):
        busy = out[key]["busy_ms"]
        out[key]["busy_share"] = None if busy is None else busy / step_ms
    out["launches"] = launches()
    missing = [k for k, v in out["launches"].items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["prefill_tok_s"] = 100 / out["prefill_100_s"]
    out["decode_tok_s"] = (N_NEW - 1) / out["decode_s"]
    out["engine_tok_s"] = out["engine_tokens"] / out["engine_s"]
    del params, eng
    torch.cuda.empty_cache()
    return out


def small_model_check(device) -> dict:
    """The card's forward against the CPU's (plain versions) on a tiny
    Q4_K model: f32 route nmse < 1e-9, int8 route within its error class."""
    rng = np.random.default_rng(3)

    def q4k(n, k):
        b = np.zeros((n, k // 256), BLOCK_Q4_K)
        b["d"] = np.float16(0.002)
        b["dmin"] = np.float16(0.008)
        b["scales"] = pack_scale_min_k4(rng.integers(0, 64, (n * (k // 256), 8)),
                                        rng.integers(0, 64, (n * (k // 256), 8))).reshape(n, k // 256, 12)
        b["qs"] = rng.integers(0, 256, (n, k // 256, 128), dtype=np.uint8)
        return b

    cfg = llama.LlamaConfig(n_vocab=512, n_ctx=256, n_embd=256, n_head=4,
                            n_kv_head=2, n_layer=2, n_ff=512)
    blocks = {"wte": q4k(512, 256), "blocks": [
        {"wq": q4k(256, 256), "wk": q4k(128, 256), "wv": q4k(128, 256),
         "wo": q4k(256, 256), "w_gate": q4k(512, 256), "w_up": q4k(512, 256),
         "w_down": q4k(256, 512)} for _ in range(2)]}

    def params(dev):
        one = torch.ones(256, device=dev)
        return {"wte": QuantTensor.from_blocks(GGMLType.Q4_K, blocks["wte"], dev),
                "out_norm": one,
                "blocks": [dict({k: QuantTensor.from_blocks(GGMLType.Q4_K, v, dev)
                                 for k, v in b.items()}, attn_norm=one, ffn_norm=one)
                           for b in blocks["blocks"]]}

    res = {}
    pc, pg = params("cpu"), params(device)
    for n_tok, tol in ((7, 1e-9), (70, 2e-4)):
        toks = torch.from_numpy(rng.integers(0, 512, n_tok))
        with torch.inference_mode():
            lc, _ = llama.forward(cfg, pc, toks, llama.make_cache(cfg, 128, device="cpu"), 0)
            lg, _ = llama.forward(cfg, pg, toks.to(device),
                                  llama.make_cache(cfg, 128, device=device), 0)
        e = nmse(lg.cpu(), lc)
        if not e < tol:
            raise AssertionError(f"small model {n_tok} tokens: card vs CPU nmse {e}")
        res[f"nmse_{n_tok}_tokens"] = e
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the 7B-width model (width is never cut)")
    ap.add_argument("--out", type=Path, default=ROOT / "build",
                    help="directory for chip_smoke.json, the detailed results")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    label = f"{smi}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build {build_s:.1f} s")
    for name, info in build.BUILD_LOG.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    timer = Timer(device)
    results = []
    check_qmm(device, timer, results)
    check_attention(device, timer, results)

    small = small_model_check(device)
    log(f"small model card vs CPU: {small}")

    mp = main_path(device, args.layers, label)
    cut = "" if args.layers == 32 else f" (depth cut to {args.layers} of 32 layers)"
    log(f"main path{cut} [{label}]: load {mp['load_s']:.2f} s, "
        f"prefill {mp['prefill_tok_s']:.1f} tok/s (100-token prompt), "
        f"decode {mp['decode_tok_s']:.2f} tok/s (single stream), "
        f"engine {mp['engine_tok_s']:.1f} tok/s aggregate "
        f"({mp['engine_tokens']} tokens, {mp['engine_steps']} steps), "
        f"peak device memory {mp['peak_mem_gb']:.2f} GB")
    log(f"launches per decode step {mp['launches_per_decode_step']}, "
        f"per 128-token prefill chunk {mp['launches_per_prefill_chunk_128']}")
    for key, step in (("decode_step_trace", "decode_step_ms"),
                      ("engine_step_trace", "engine_decode_step_ms")):
        t = mp[key]
        log(f"{key} [{label}]: step {mp[step]:.3f} ms unprofiled, device busy "
            f"{t['busy_ms']} ms ({t['device_activities']} activities; "
            f"profiled wall {t['profiled_wall_ms']:.3f} ms), busy share "
            f"{t['busy_share']}; busiest {t['top_ms'][:5]}")

    rep = {"qmm_q4_K": "M=8 N=11008 K=4096",
           "qmm_q4_K_i8": "M=128 N=11008 K=4096",
           "causal_flash_attention": "decode B=8 H=32 window=1024 f32q_bf16kv"}
    line = []
    for kern in kernels.KERNELS:
        rows = [r for r in results if r["kernel"] == kern.name]
        r = next(r for r in rows if r["shape"] == rep[kern.name])
        line.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces, "launches": mp["launches"][kern.name],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    detail = {"device": smi, "build_s": build_s, "build": build.BUILD_LOG,
              "kernels": results, "main_path": mp, "small_model": small}
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
