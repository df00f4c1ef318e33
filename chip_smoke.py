"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--layers N] [--out DIR] [--checks A,B] [--paths P,Q]

Phases (each failure raises, so the script exits non-zero):
  1. device: requires CUDA; prints `nvidia-smi` name and power limit; TF32
     off for the plain versions;
  2. build: compiles ggml_gfx906_tpu_torch/csrc/*.cu with nvcc (one process
     per source, all at once) into build/torch_kernels/;
  3. kernels: K1 (Q4_K f32 matmul), K3 (Q4_K int8 matmul), K2 (causal
     flash attention), K4 (Q6_K f32 matmul), K5 (Q8_0 f32 matmul), K5-i8
     (Q8_0 int8 matmul), K6 (Q4_0 f32 matmul), K6-i8 (Q4_0 int8 matmul),
     K7 (Q5_K f32 matmul), K8 (Q4_1, Q5_0 and Q5_1 f32 matmuls), K9 (Q2_K
     and Q3_K f32 matmuls), K10 (the pipelined M = 1 Q4_K matvec) and K11
     (the autotuner's streaming copy, bit for bit against copy_) against
     their plain PyTorch versions at the main paths' shapes, each timed
     with CUDA events beside its plain version, its library yardstick and
     its bound, and a sha256 of every f32 kernel's output (fixed seeds: a
     kernel that keeps its summation order keeps its digests from one tree
     to another); the kernels on the f32 body (K1, K4, K5, K6, K7, K8,
     K9) also row by row: on each shape the rows of one 128-row product equal,
     bit for bit, those of the same x cut to M in {1, 8, 16, 63, 100} and
     of single rows (check_rows), and K3 likewise; the int8 kernels K3,
     K5-i8 and K6-i8 in their two launches (check_i8), the x quantization
     bit for bit against the plain x operands, the product against the
     plain version and by the sha256 of its output, timed with and without
     the x quantization, and their rows bit for bit across M (K5-i8 and
     K6-i8 at M in {64, 100, 128} against a 512-row product); K2's rows bit
     for bit across the window, N, B and the chunk split at its chunk edges
     (check_attention_rows); K10 and K1 at M = 1 also in a chain of 56
     decode products, 8 layers' seven, one CUDA-event interval (chain_ms);
     the IQ grid searches S1 (IQ3_XXS, IQ3_S), S2 (IQ2_XXS, IQ2_XS, IQ2_S)
     and S3 (IQ1_S, IQ1_M) byte for byte against their plain versions on
     the CPU, with and without an importance row, timed at 4096 x 4096
     beside each kernel's plain version on the card, and the six lattice
     tables rebuilt on the card against the shipped files
     (check_iq_search, `--checks iq_search`);
  4. a small-model check of the card's forward against the CPU's, for a
     tiny Q4_K, Q4_K_M-mixture, Q8_0, Q5_K_M-mixture, Q4_0, Q4_1, Q5_0,
     Q5_1, Q2_K-mixture and Q3_K_M-mixture model, and the Q4_K and Q3_K_M
     models again in the int8 execution layout; the tiny Q4_K model's
     perplexity on the card against the CPU's;
  5. the autotuner from a fresh cache directory (so that K11 really runs):
     `choose` and `choose_attn` on the card, K11's and the library's GB/s,
     the two M = 1 times and both decisions;
  6. ten main paths at full llama-7B width, one GGUF each (random but
     valid blocks, constructed scales; written under build/ and removed
     after its path): pure Q4_K with the head tied to token_embd;
     llama.cpp's Q4_K_M and Q5_K_M mixtures (Q4_K or Q5_K, with Q6_K in
     output.weight and in attn_v/ffn_down of half the layers); Q8_0
     throughout; Q4_0, Q4_1, Q5_0 and Q5_1 with a Q6_K head; and
     llama.cpp's Q2_K and Q3_K_M mixtures (Q2_K or Q3_K, with Q3_K, Q4_K
     or Q5_K in attn_v, attn_output and ffn_down and a Q6_K head). The
     Q4_K file runs at 32 layers (--layers), the other nine at
     SHORT_LAYERS = 8; the Q4_K file runs twice more, in the int8 execution
     layout at 32 layers (only K2 launches) and under weights_layout="auto"
     at SHORT_LAYERS (layouts equal to choose's answer, generate equal to
     the layout given explicitly, and one decode step under attn_impl="xla"
     with no K2 launch, its logits at f32 compute on the f32 kernels within
     K2's card-vs-plain distance of the step on K2). Each loads its file to the card, runs
     `generate`, serves 8+1 requests through `Engine`, holds its streams
     against single-sequence `generate` (below), asserts that its kernels launched as many
     times per decode step and per 128-token prefill chunk as its tensor
     types predict, and traces one decode step and one 8-slot engine decode
     step with torch.profiler for the device-busy share (and, on the
     paths of TRACE_PREFILL, one more 100-token prefill, with the device
     time of the file's int8 kernels), and records a
     sha256 of its greedy streams. The engine floods the 8 short prompts
     (one forward_batch at M = 8·128), so engine == generate is asserted
     for the requests both prefill on one matmul route (every request on
     the files without an int8 route and in the int8 layout; prompts of at
     least int8_min_m tokens elsewhere) and recorded (first divergence) for
     the others; the 8-layer Q4_0 file serves the 8+1 requests again at
     int8_min_m = 0 (all f32, flooded), equal to generate there for every
     request. The 32-layer Q4_K file adds two phases: `admission`, one
     whole traced engine run split by the engine's own spans (flood,
     chunk, replay, capture, harvest, wait; each flood span held against
     its profiler event within 1 ms), one flood alone traced, and one
     flood of the 8 short prompts beside a decoding slot of a 16-slot
     engine, its 8 rows against the 16-row block (first tokens and K/V
     rows bit-equal, both floods' device ms);
     `kv_variants`, the engine on the int8 cache (== generate(kv_quant=
     True) where one route, K2 on int8 K/V), on a paged pool of half the
     dense pages (== the dense engine, with and without kv_quant) and with
     window delta (one window's logits against the strict window's within
     a bound from bf16 rounding, the streams' agreement, the two windows
     timed); `tools`, text from the file alone (every file carries a
     synthetic SentencePiece vocabulary of n_vocab tokens, spm_vocab): the
     tokenizer from its metadata, speculative decoding by prompt lookup
     at k = 8 and 7 on a repetitive and a plain encoded prompt and with a
     4-layer layer-skip draft at k = 4 (each stream == `generate`'s greedy
     one; accept rates, tok/s beside decode_chunk's; one replayed verify
     step's launches asserted, timed and traced), perplexity over 2,048
     tokens at n_ctx 512 (n_tokens by the window rule, nll within 1e-5 of
     llama.forward's logits summed in float64) and the CLI in-process
     (greedy == generate on the encoded text, --spec 8 == greedy, a
     sampled run, serve of the 8+1 prompts as text == a direct Engine
     run). The 32-layer Q4_K file also traces one
     8-slot decode step at window 1024 (long_window_step). The Q4_K file
     then decodes again with qmm_pipeline="on" (K10 in place of K1),
     traced, with one step's logits held against the flag off within the
     int8 route's distance from them. The launch counts are set to 0 just
     before each path (and the K10 and autotune phases) and read just after
     it.
  7. quantize: the codecs and the quantize tools at llama-7B width and
     SHORT_LAYERS depth (quantize_phase): a seeded state dict converted to
     an F16 GGUF, an imatrix collected over two 512-token chunks of
     synthetic text, the file quantized on the card to Q4_K (with the
     imatrix), Q8_0, IQ4_XS and IQ2_XXS (with the imatrix; S2 on every
     matrix), 256 sampled rows of five matrices of each (64 of the IQ2_XXS
     file) held against the CPU codec byte for byte, each file loaded and
     generating 32 greedy tokens after 100 with its launches asserted
     (IQ4_XS and IQ2_XXS in the int8 layout: K2 only), the Q4_K file's
     fields against QuantTensor.quantize on the card, and every codec card
     vs CPU on 64 x 4096 rows (bytes and dequantized bits; the seven IQ
     searches with the importance row, and without where they take none)
     with its rate on 4096 x 4096.
  8. families: the other served families at published width (families_
     phase): Mixtral-8x7B (8 of 32 layers), GPT-2-large (all 36) and
     GPT-J-6B (8 of 28), one GGUF each in llama.cpp's Q4_K_M recipe
     (family_type: the 8-expert Q8_0 attn_k / attn_v and Q5_K
     attn_output, GPT-2's Q5_K attn_qkv and Q6_K tied head), after tiny
     models of each family card vs CPU: each file loaded, prefilled,
     decoded eagerly (== generate) and through decode_step's captured
     graph (== eager, logits bit-equal), its launches per step, replayed
     step and 128-token chunk asserted, its decode step, replayed step,
     prefill and (MoE, GPT-2) 8-slot engine step traced, the 8+1
     requests served (engine == generate where one route), and on the
     GPT-2 file one request to n_ctx at the default harvest depth
     (== generate, past the position table's last row); the Mixtral
     file split by OffloadSplit (half the layers and the head on the
     CPU) against the all-card forward, the GPT-2 file through the CLI
     (generate, serve). Phase 3's `families` check holds K2 at head dims
     64 and 256 and K1 / K3 / K4 at N = 50257 and 50400.
  9. vision: the vision and classifier models at published width
     (vision_phase), random weights from fixed seeds: YOLOv3-tiny at 416
     (its GGUF loaded on the card and the CPU, both heads card vs CPU with
     cuDNN's TF32 flag at PyTorch's default, the forward timed, detect end
     to end on a 480x640 photo with the host time of letterbox, forward and
     decode + NMS); SAM ViT-B (an HF-style state dict through from_hf,
     save_gguf and load_gguf; the first 3 encoder layers and the decoder
     card vs CPU on a 1024 image, TF32 flag on; then all 12 layers on the
     card: encode, one point prompt, decode, shapes and finite values,
     encode and decode timed, peak memory, one encode and one decode
     traced); Magika (64 synthetic files of 0 bytes to 1 MB card vs CPU,
     files/s one by one and in one batch). No counted kernel launches in
     the phase.
 10. training (training_phase), each check under PyTorch's default flags
     (cuDNN TF32 on, its non-deterministic algorithms allowed): K2's
     gradient at llama-7B attention (B 1, H 32, D 128, N = M = 512, pos 0;
     and KVH 8) == autograd through `_causal_ref` on the card bit for bit,
     near the CPU's, its forward == K2's plain version, one K2 launch per
     forward and none in the backward, timed beside SDPA's forward +
     backward; MNIST fc and cnn at the reference's widths on 12,000
     synthetic images: 3 steps card vs CPU (and the cnn with TF32 convs,
     which must fail),
     `train` for 2 epochs to the reference tests' accuracies, the GGUF
     round trip, a resumed `fit` bit-equal to the straight one; GPT-2 124M
     at full width, f32: 2 layers card vs CPU (loss and every gradient),
     `fit` at 4 x 1024 tokens with 2 micro-batches a step for 4 AdamW steps
     (losses finite and falling, two runs bit-equal), ms per micro-batch,
     tokens/s, peak memory, one micro-batch traced, cross_entropy_loss
     timed. No counted kernel launches across the MNIST and GPT-2 runs.
11. parallel (parallel_phase): parallel/ on one card, a Llama-3-8B-width
     GGUF (meta-llama/Meta-Llama-3-8B config.json: 4096, 32 heads / 8 KV,
     14336, vocab 128256, rope θ 500000) in llama.cpp's Q4_K_M recipe at
     SHORT_LAYERS, written under build/ and removed: (b) a real NCCL group
     at world size 1 in this process: make_mesh(tp=1) →
     shard_llama_params → tp_forward / tp_decode_step bit-equal to
     llama.forward / generate, Engine(mesh=) over the 8+1 requests == the
     mesh-free Engine, its windows captured on the NCCL mesh (at world
     size 1 the all-reduce launches no kernel, so no collective kernel
     sits in the graphs), launches per replay == the mesh-free engine's,
     one steady window of each traced; then two spawned gloo processes
     sharing cuda:0: (c) tp = 2 (each rank its half of every weight):
     tp_forward's logits against the single-process forward's, on the f32
     route within 1e-9 nmse at f32 compute and within the single forward's
     own bf16-vs-f32 distance at bf16, on the default route (K3 at the
     100-token prompt) within TP_INT8_BOUND, the greedy
     tp_decode_step stream's first divergence from generate's, the mesh
     Engine (uncaptured) over the 8+1 requests == the mesh's
     tp_decode_step greedy streams at int8_min_m = 0, a decode step's ms
     and one all-reduce's; dp = 2, tp = 1: the mesh Engine == the mesh-free
     Engine; (d) ep = 2: Mixtral-8x7B's Q4_K expert stack (8 × 14336 ×
     4096, top-2, 100 tokens), ep_mul_mat_id == ops.mul_mat_id bit for
     bit; (e) sp = 2: ring_self_attention, contiguous and zigzag, at H 32 /
     KV 8, D 128, S 4096 within 1e-10 of _causal_ref; pp = 2: pp_forward
     with 4 micro-batches over 4 dense bf16 blocks at the file's width
     within 2^-14 of the single-process forward. Phase 3's `tp` check holds
     K1, K3 and K4 at the file's tp = 2 shard shapes, timed beside the
     whole shapes. Launch counts (this process's and the ranks') are set to
     0 before the phase and read after it. One H100 shows no multi-card
     speedup. Both groups come up through parallel/launch.py::initialize
     (a tcp:// store on 127.0.0.1).
 12. utilities (utilities_phase), on phase 11's file before it is removed
     (written here under --paths utilities): (a) tools/backend_ops.py's
     test (every case card vs CPU within its nmse_max; each qmm case's
     launches hold the kernel dispatch.route names), grad (f64 against
     central differences), perf and support modes, main == 0, the text in
     DIR/backend_ops.txt; (b) utils/perf.py's main over its op table with
     the H100's rooflines; the simple example's two styles; (c)
     launch.serve_model of the file, sync_model into build/ (sha256 equal
     to the file's), a second sync_model from the cache, both timed; the
     rebuilt file loaded and its greedy 32 tokens after the 100-token
     prompt == the original's; local_topology on the card; (d) the
     launches of one replayed decode step == expected_launches, a
     trace.profile of one replayed step naming K1 and K2, and
     dump_graph(stage="kernels") of one eager step whose K1-K4 entries
     equal the launch counters' delta; (e) the taps of one eager forward
     (2·n_layer + 1, the logits tap == the logits), an observer around a
     captured decode_step raises, and a fresh capture without one launches
     what (d) counted. Launch counts are set to 0 before the phase.
--checks and --paths cut phases 3 and 6 to the named checks and paths,
--paths quantize runs phase 7, --paths families (or mixtral,
gpt2_large, gptj) phase 8, --paths vision phase 9, --paths training
phase 10, --paths parallel phase 11 and --paths utilities phase 12 (a
cut run skips phases 4 and 5
and prints no result line).
Detailed results go to DIR/chip_smoke.json (default build/). The second-to-last
stdout line is {"kernels": [...]}; the last is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import inspect
import io
import json
import os
import queue as queue_mod
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from ggml_gfx906_tpu_torch.gguf import GGUFReader, GGUFWriter
from ggml_gfx906_tpu_torch.models import llama
from ggml_gfx906_tpu_torch.ops import cuda as kernels
from ggml_gfx906_tpu_torch.ops.cuda import (build, dispatch, dma_copy, flash_attn, qmm,
                                            qmm_legacy, qmm_pipe, qmm_q4_0, qmm_q5k, qmm_q6k,
                                            qmm_q8_0, qmm_q23k)
from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
from ggml_gfx906_tpu_torch.quant.kquants import pack_q3_scales, pack_scale_min_k4
from ggml_gfx906_tpu_torch.quant.types import (BLOCK_Q2_K, BLOCK_Q3_K, BLOCK_Q4_0, BLOCK_Q4_1,
                                               BLOCK_Q4_K, BLOCK_Q5_0, BLOCK_Q5_1, BLOCK_Q5_K,
                                               BLOCK_Q6_K, BLOCK_Q8_0, TYPE_TRAITS, GGMLType)
try:    # the tools slice; its phases are skipped on a tree without it
    from ggml_gfx906_tpu_torch.models import cli, perplexity, speculative, tokenizer
    HAS_TOOLS = True
except ImportError:
    HAS_TOOLS = False
try:    # the codecs and the quantize tools; the quantize phase needs them
    from ggml_gfx906_tpu_torch.models import convert, imatrix, quantize_cli
    from ggml_gfx906_tpu_torch.quant import registry
    HAS_QUANT = True
except ImportError:
    HAS_QUANT = False
try:    # the other families; the families phase needs them
    from ggml_gfx906_tpu_torch.models import gpt2, gptj, moe, offload
    HAS_FAMILIES = True
except ImportError:
    HAS_FAMILIES = False
try:    # the vision and classifier models; the vision phase needs them
    from ggml_gfx906_tpu_torch.models import magika, sam, yolo
    HAS_VISION = True
except ImportError:
    HAS_VISION = False
try:    # the training layer and MNIST; the training phase needs them
    from ggml_gfx906_tpu_torch import ops
    from ggml_gfx906_tpu_torch.models import mnist
    from ggml_gfx906_tpu_torch.training import AdamWParams, adamw_init
    from ggml_gfx906_tpu_torch.training.dataset import Dataset
    from ggml_gfx906_tpu_torch.training.fit import fit, make_train_step
    from ggml_gfx906_tpu_torch.training.opt import tree_leaves, tree_map
    HAS_TRAINING = True
except ImportError:
    HAS_TRAINING = False
try:    # parallelism; the parallel phase needs it
    import torch.distributed as dist

    from ggml_gfx906_tpu_torch.ops import attention as attn_ops
    from ggml_gfx906_tpu_torch.parallel import launch, make_mesh, tp
    from ggml_gfx906_tpu_torch.parallel.ep import ep_mul_mat_id, make_ep_mesh, shard_experts
    from ggml_gfx906_tpu_torch.parallel.mesh import all_reduce
    from ggml_gfx906_tpu_torch.parallel.pp import _block_apply as pp_block
    from ggml_gfx906_tpu_torch.parallel.pp import make_pp_mesh, pp_forward, shard_pp, stack_blocks
    from ggml_gfx906_tpu_torch.parallel.sp import ring_self_attention
    HAS_PARALLEL = True
except ImportError:
    HAS_PARALLEL = False
try:    # the last modules (transport, launch, logger, taps, trace, perf, backend_ops)
    from ggml_gfx906_tpu_torch.examples import simple
    from ggml_gfx906_tpu_torch.parallel.transport import TransportClient
    from ggml_gfx906_tpu_torch.tools import backend_ops
    from ggml_gfx906_tpu_torch.utils import observe, perf, trace
    HAS_UTILITIES = True
except ImportError:
    HAS_UTILITIES = False
from ggml_gfx906_tpu_torch.runtime.batched_kv import BatchedKVCache
from ggml_gfx906_tpu_torch.runtime.engine import Engine
from ggml_gfx906_tpu_torch.utils import autotune, config

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
# whether this tree decodes on CUDA graphs, floods admission and has the
# int8 / paged / window-delta caches (a parent tree's comparison run with
# this smoke, cut by --paths, skips the checks it lacks)
HAS_GRAPHS = hasattr(llama, "decode_chunk")
HAS_FLOOD = hasattr(Engine, "_admit_batch")
HAS_KV_VARIANTS = "quant" in inspect.signature(BatchedKVCache.create).parameters


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


def trace_device(fn, match: tuple = ()) -> dict:
    """One call of fn under torch.profiler: the device's busy time (union of
    its kernel and copy intervals), the number of device activities, the
    busiest kernel names and (matched_ms) the device time of the activities
    whose name holds one of `match`. busy_ms is None when the trace holds
    no device activity (the profiler could not see the card)."""
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
    matched = sum(e - s for s, e, name in ev if any(m in name for m in match))
    return {"busy_ms": busy_us / 1e3 if ev else None, "device_activities": len(ev),
            "profiled_wall_ms": wall * 1e3, "matched_ms": matched / 1e3,
            "top_ms": [[name, us / 1e3] for name, us in top]}


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BPS * 1e3, ops / PEAK[kind] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ------------------------------------------------------------- kernels

def check_f32(timer, results, label, kernel, fn, plain, x, w_dense, wbytes):
    """Hold an f32 matmul kernel fn(x) against its plain version plain(x)
    (nmse < 1e-10) and time both beside torch.matmul on the dense weight
    and the bound (weight bytes `wbytes` in the port's layout); record the
    sha256 of the kernel's output bytes."""
    m, k = x.shape
    n = w_dense.shape[0]
    got, ref = fn(x), plain(x)
    torch.cuda.synchronize()
    e = nmse(got, ref)
    if not e < 1e-10:
        raise AssertionError(f"{label} M={m} N={n} K={k}: nmse {e}")
    b, by = bound(wbytes + m * k * 4 + m * n * 4, 2.0 * m * n * k, "f32")
    results.append(dict(
        kernel=kernel.name, shape=f"M={m} N={n} K={k}", nmse=e,
        max_abs_err=float((got - ref).abs().max()),
        sha256=hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(),
        ms=timer(lambda: fn(x)), plain_ms=timer(lambda: plain(x)),
        library_ms=timer(lambda: torch.matmul(x, w_dense.T)),
        bound_ms=b, bound_by=by))
    log(f"{label} M={m} N={n} K={k} nmse={e:.3e} ms={results[-1]['ms']:.4f}")


@dataclasses.dataclass
class I8Kernel:
    """An int8 kernel (K3, K5-i8, K6-i8) in its two launches, as check_i8
    holds it: quant(x) quantizes x, product(*quant(x)) is the product;
    prepare(x) forms the plain version's operands in plain torch, whose
    first nx are the x operands that quant's first nx must equal bit for
    bit; plain(*prepare(x)) is the plain version, full(x) the entry point as
    the main path calls it."""
    label: str
    kernel: object
    nx: int
    quant: object
    product: object
    prepare: object
    plain: object
    full: object


def i8_launches(label, kernel, nx, module, prepare, plain, full, *weights) -> I8Kernel:
    """The I8Kernel of `module`'s int8 kernel on `weights`. A tree from
    before the kernel's x-quantization kernel (no `quantize_x` in its
    module) prepared every operand in torch (prepare_i8) and its launch_i8
    took them all after qs; taking that interface too lets this script time
    and digest such a tree's kernel beside this one's in one call."""
    if hasattr(module, "quantize_x"):
        return I8Kernel(label, kernel, nx, module.quantize_x,
                        lambda *xo: module.launch_i8(*weights, *xo), prepare, plain, full)
    return I8Kernel(label, kernel, nx, prepare,
                    lambda *ops: module.launch_i8(weights[0], *ops), prepare, plain, full)


def k3_launches(qs, scm, dd) -> I8Kernel:
    return i8_launches("K3", kernels.K3, 4, qmm, lambda x: qmm.prepare_i8(x, scm, dd),
                       lambda *ops: qmm.qmm_q4_K_i8_plain(qs, *ops),
                       lambda x: qmm.qmm_q4_K_i8(x, qs, scm, dd), qs, scm, dd)


def k5_i8_launches(qs, d) -> I8Kernel:
    return i8_launches("K5-i8", kernels.K5_I8, 2, qmm_q8_0, lambda x: qmm_q8_0.prepare_i8(x, d),
                       lambda *ops: qmm_q8_0.qmm_q8_0_i8_plain(qs, *ops),
                       lambda x: qmm_q8_0.qmm_q8_0_i8(x, qs, d), qs, d)


def k6_i8_launches(qs, d) -> I8Kernel:
    return i8_launches("K6-i8", kernels.K6_I8, 4, qmm_q4_0, lambda x: qmm_q4_0.prepare_i8(x, d),
                       lambda *ops: qmm_q4_0.qmm_q4_0_i8_plain(qs, *ops),
                       lambda x: qmm_q4_0.qmm_q4_0_i8(x, qs, d), qs, d)


def check_i8(timer, results, k: I8Kernel, x, w_dense, wbytes):
    """An int8 kernel in its two launches (I8Kernel): its x quantization
    bit for bit against the plain x operands (split_x + quantize_x_tiles,
    or quantize_x_tiles alone for K5-i8), for f32 and bf16 x; the product
    against the plain version on prepare_i8's operands, element-wise within
    1e-5 relative plus 1e-6 of the largest output (both sum exact integer
    dots), whether it equals it bit for bit, and the sha256 of its output
    (its dots are exact and its roundings the reference's, so the digest is
    the same in any tree that keeps them); timed with the quantization (as
    the main path calls it), without it, and the quantization alone, beside
    the plain version, torch.matmul on the dense weight and the bound."""
    m, kk = x.shape
    n = w_dense.shape[0]
    for xx in (x, x.bfloat16()):
        want = k.prepare(xx.float())[:k.nx]
        if not all(torch.equal(a, b) for a, b in zip(k.quant(xx)[:k.nx], want)):
            raise AssertionError(f"{k.label} x quantization M={m} K={kk} {xx.dtype}: differs "
                                 "from the plain x operands")
    xo = k.quant(x)
    ops = k.prepare(x)
    got, ref = k.product(*xo), k.plain(*ops)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    if not bool((err <= 1e-5 * ref.abs() + 1e-6 * ref.abs().max()).all()):
        raise AssertionError(f"{k.label} M={m} N={n} K={kk}: rel err "
                             f"{float((err / ref.abs().clamp_min(1e-30)).max())}")
    b, by = bound(wbytes + m * kk * 4 + m * n * 4, 2.0 * m * n * kk, "int8")
    results.append(dict(
        kernel=k.kernel.name, shape=f"M={m} N={n} K={kk}", nmse=nmse(got, ref),
        max_abs_err=float(err.max()), equal_to_plain=bool(torch.equal(got, ref)),
        sha256=hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(),
        ms=timer(lambda: k.full(x)),
        kernel_only_ms=timer(lambda: k.product(*xo)), quant_x_ms=timer(lambda: k.quant(x)),
        plain_ms=timer(lambda: k.plain(*k.prepare(x))),
        library_ms=timer(lambda: torch.matmul(x, w_dense.T)),
        bound_ms=b, bound_by=by))
    r = results[-1]
    log(f"{k.label} M={m} N={n} K={kk} x quantization bit-equal, equal to plain "
        f"{r['equal_to_plain']}, sha256 {r['sha256'][:16]}, ms={r['ms']:.4f} (product "
        f"{r['kernel_only_ms']:.4f}, x quantization {r['quant_x_ms']:.4f})")


# K3's M: 100, the ragged single-stream prefill; 128, a prefill chunk; 512
K3_MS = (100, 128, 512)
# K5-i8's and K6-i8's: K3's and the smallest M of the int8 route
# (int8_min_m = 64); their rows are checked across these M
I8_MS = (64,) + K3_MS


def random_q4k(n, k, device, gen):
    """Q4_K weights with random nibbles and 6-bit scales, plausible d."""
    nb = k // 256
    qs = torch.randint(0, 256, (n, nb * 128), dtype=torch.uint8, device=device, generator=gen)
    scm = torch.randint(0, 64, (n, nb * 16), dtype=torch.uint8, device=device, generator=gen)
    dd = torch.rand((n, nb * 2), device=device, generator=gen) * (0.02 / 8)
    return qs, scm, dd


def check_qmm(device, timer, results):
    """K1 on the 7B shapes (every matrix of the Q4_K file, the tied head
    included) at TILED_MS and Q4_EXTRA_MS, and its rows bit for bit across
    M (check_rows); K3 at K3_MS (check_i8) and its rows across M."""
    gen = torch.Generator(device=device).manual_seed(1)
    rows = {}
    for n, k in QMM_SHAPES:
        qs, scm, dd = random_q4k(n, k, device, gen)
        w_dense = qmm.dequant(qs, scm, dd)
        wbytes = n * k / 2 + n * k / 16 + n * k / 32
        for m in sorted(TILED_MS + Q4_EXTRA_MS):
            check_f32(timer, results, "K1", kernels.K1,
                      lambda x: qmm.qmm_q4_K(x, qs, scm, dd),
                      lambda x: qmm.qmm_q4_K_plain(x, qs, scm, dd),
                      torch.randn((m, k), device=device, generator=gen), w_dense, wbytes)
        rows[f"N={n} K={k}"] = check_rows("K1", lambda x: qmm.qmm_q4_K(x, qs, scm, dd),
                                          torch.randn((128, k), device=device, generator=gen))
        k3 = k3_launches(qs, scm, dd)
        for m in K3_MS:
            check_i8(timer, results, k3, torch.randn((m, k), device=device, generator=gen),
                     w_dense, wbytes)
        rows[f"K3 N={n} K={k}"] = check_rows("K3", lambda x: qmm.qmm_q4_K_i8(x, qs, scm, dd),
                                             torch.randn((128, k), device=device, generator=gen))
        del w_dense
    return rows


# The timed M of the kernels on the f32 body: decode (1, 8 slots), the
# engine's short chunks (16), a ragged 63, the single-stream 100-token
# prefill and a 128-row chunk. K1 and K6 also at Q4_EXTRA_MS: 2 and 4
# (the decode kernel's narrower register tiles; K1 changes kernel between
# M = 1 and 2) and 32 (the tiled kernel's narrow tile); the main path gives
# them M < int8_min_m = 64 only.
TILED_MS = (1, 8, 16, 63, 100, 128)
Q4_EXTRA_MS = (2, 4, 32)
ROW_MS = (1, 8, 16, 63, 100)
ROW_IS = (0, 37, 99, 127)


def check_rows(label, fn, x, ms=ROW_MS) -> dict:
    """Invariant of the tiled kernels: a row's bits do not depend on M.
    fn(x)[:m] must equal fn(x[:m]) for m in ms, and fn(x)[i] must equal
    fn(x[i:i+1])[0] for the rows in ROW_IS, bit for bit (torch.equal)."""
    full = fn(x)
    bad = [m for m in ms if not torch.equal(full[:m], fn(x[:m]))]
    bad += [f"row {i}" for i in ROW_IS if not torch.equal(full[i], fn(x[i:i + 1])[0])]
    if bad:
        raise AssertionError(f"{label} N={full.shape[1]} K={x.shape[1]}: the rows of a "
                             f"{x.shape[0]}-row product differ from those at M = {bad}")
    log(f"{label} N={full.shape[1]} K={x.shape[1]}: rows bit-equal at M = "
        f"{list(ms) + [x.shape[0]]} and rows {list(ROW_IS)} alone")
    return {"ms": list(ms) + [x.shape[0]], "rows": list(ROW_IS), "equal": True}


def check_q6k(device, timer, results):
    """K4 at the Q4_K_M file's Q6_K shapes: attn_v, ffn_down (43
    superblocks per row, an odd count) and the head, from decode to a
    128-row prefill chunk (Q6_K has no int8 twin), and its rows bit for bit
    across M (check_rows)."""
    gen = torch.Generator(device=device).manual_seed(4)
    rows = {}
    for n, k in ((4096, 4096), (4096, 11008), (32000, 4096)):
        nb = k // 256
        w = (torch.randint(0, 256, (n, nb * 128), dtype=torch.uint8, device=device, generator=gen),
             torch.randint(0, 256, (n, nb * 64), dtype=torch.uint8, device=device, generator=gen),
             torch.randint(-128, 128, (n, nb * 16), dtype=torch.int8, device=device, generator=gen),
             torch.rand((n, nb), device=device, generator=gen) * 1e-3)
        w_dense = qmm_q6k.dequant(*w)
        for m in TILED_MS:
            check_f32(timer, results, "K4", kernels.K4,
                      lambda x: qmm_q6k.qmm_q6_K(x, *w),
                      lambda x: qmm_q6k.qmm_q6_K_plain(x, *w),
                      torch.randn((m, k), device=device, generator=gen), w_dense,
                      n * k * 6.625 / 8)
        del w_dense
        rows[f"N={n} K={k}"] = check_rows("K4", lambda x: qmm_q6k.qmm_q6_K(x, *w),
                                          torch.randn((128, k), device=device, generator=gen))
    return rows


def check_q8_0(device, timer, results):
    """K5 at decode and short-chunk M and its rows bit for bit across M
    (check_rows), K5-i8 at I8_MS (check_i8) and its rows across M, on the
    7B shapes (every matrix of a Q8_0 file)."""
    gen = torch.Generator(device=device).manual_seed(5)
    rows = {}
    for n, k in QMM_SHAPES:
        qs = torch.randint(-128, 128, (n, k), dtype=torch.int8, device=device, generator=gen)
        d = torch.rand((n, k // 32), device=device, generator=gen) * 1e-3
        w_dense = qmm_q8_0.dequant(qs, d)
        wbytes = n * k * 9 / 8
        for m in (1, 8, 16, 63):
            check_f32(timer, results, "K5", kernels.K5,
                      lambda x: qmm_q8_0.qmm_q8_0(x, qs, d),
                      lambda x: qmm_q8_0.qmm_q8_0_plain(x, qs, d),
                      torch.randn((m, k), device=device, generator=gen), w_dense, wbytes)
        rows[f"N={n} K={k}"] = check_rows("K5", lambda x: qmm_q8_0.qmm_q8_0(x, qs, d),
                                          torch.randn((128, k), device=device, generator=gen))
        k5 = k5_i8_launches(qs, d)
        for m in I8_MS:
            check_i8(timer, results, k5, torch.randn((m, k), device=device, generator=gen),
                     w_dense, wbytes)
        rows[f"K5-i8 N={n} K={k}"] = check_rows(
            "K5-i8", k5.full, torch.randn((I8_MS[-1], k), device=device, generator=gen),
            I8_MS[:-1])
        del w_dense
    return rows


def check_q4_0(device, timer, results):
    """K6 at TILED_MS and Q4_EXTRA_MS and its rows bit for bit across M
    (check_rows), K6-i8 at I8_MS (check_i8) and its rows, on the 7B shapes
    (every matrix of a Q4_0 file but its Q6_K head; the 11008-wide ffn_down has 43 spans of
    256 and 344 blocks, which 32 slots do not divide)."""
    gen = torch.Generator(device=device).manual_seed(6)
    rows = {}
    for n, k in QMM_SHAPES:
        qs = torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device=device, generator=gen)
        d = torch.rand((n, k // 32), device=device, generator=gen) * 1e-2
        w_dense = qmm_q4_0.dequant(qs, d)
        wbytes = n * k * 5 / 8
        for m in sorted(TILED_MS + Q4_EXTRA_MS):
            check_f32(timer, results, "K6", kernels.K6,
                      lambda x: qmm_q4_0.qmm_q4_0(x, qs, d),
                      lambda x: qmm_q4_0.qmm_q4_0_plain(x, qs, d),
                      torch.randn((m, k), device=device, generator=gen), w_dense, wbytes)
        rows[f"N={n} K={k}"] = check_rows("K6", lambda x: qmm_q4_0.qmm_q4_0(x, qs, d),
                                          torch.randn((128, k), device=device, generator=gen))
        k6 = k6_i8_launches(qs, d)
        for m in I8_MS:
            check_i8(timer, results, k6, torch.randn((m, k), device=device, generator=gen),
                     w_dense, wbytes)
        rows[f"K6-i8 N={n} K={k}"] = check_rows(
            "K6-i8", k6.full, torch.randn((I8_MS[-1], k), device=device, generator=gen),
            I8_MS[:-1])
        del w_dense
    return rows


def check_q5k(device, timer, results):
    """K7 at the Q5_K_M file's Q5_K shapes: attention, ffn_gate/up and
    ffn_down (43 superblocks per row, an odd count), from decode to a
    128-row prefill chunk (Q5_K has no int8 twin), and its rows bit for bit
    across M (check_rows)."""
    gen = torch.Generator(device=device).manual_seed(7)
    rows = {}
    for n, k in ((4096, 4096), (11008, 4096), (4096, 11008)):
        nb = k // 256
        w = (torch.randint(0, 256, (n, nb * 128), dtype=torch.uint8, device=device, generator=gen),
             torch.randint(0, 256, (n, nb * 32), dtype=torch.uint8, device=device, generator=gen),
             torch.randint(0, 64, (n, nb * 16), dtype=torch.uint8, device=device, generator=gen),
             torch.rand((n, nb * 2), device=device, generator=gen) * 1e-3)
        w_dense = qmm_q5k.dequant(*w)
        for m in TILED_MS:
            check_f32(timer, results, "K7", kernels.K7,
                      lambda x: qmm_q5k.qmm_q5_K(x, *w),
                      lambda x: qmm_q5k.qmm_q5_K_plain(x, *w),
                      torch.randn((m, k), device=device, generator=gen), w_dense,
                      n * k * 5.75 / 8)
        del w_dense
        rows[f"N={n} K={k}"] = check_rows("K7", lambda x: qmm_q5k.qmm_q5_K(x, *w),
                                          torch.randn((128, k), device=device, generator=gen))
    return rows


# K8's types: (type, kernel, bits per weight in the port's layout)
LEGACY = ((GGMLType.Q4_1, kernels.K8_Q4_1, 6), (GGMLType.Q5_0, kernels.K8_Q5_0, 6),
          (GGMLType.Q5_1, kernels.K8_Q5_1, 7))


def check_legacy(device, timer, results):
    """K8's three entry points at every matrix shape of the Q4_1, Q5_0 and
    Q5_1 files but their Q6_K head, from decode to a 128-row prefill chunk
    (none has an int8 twin; the 11008-wide ffn_down has 344 blocks per
    row, which 32 slots do not divide), and their rows bit for bit across
    M (check_rows)."""
    gen = torch.Generator(device=device).manual_seed(8)
    rows = {}
    for qtype, kern, bpw in LEGACY:
        name = qtype.name.lower()
        fn, plain = getattr(qmm_legacy, f"qmm_{name}"), getattr(qmm_legacy, f"qmm_{name}_plain")
        for n, k in ((4096, 4096), (11008, 4096), (4096, 11008)):
            w = {"qs": torch.randint(0, 256, (n, k // 2), dtype=torch.uint8, device=device,
                                     generator=gen),
                 "qh": torch.randint(0, 256, (n, k // 8), dtype=torch.uint8, device=device,
                                     generator=gen),
                 "d": torch.rand((n, k // 32), device=device, generator=gen) * 1e-2,
                 "m": torch.rand((n, k // 32), device=device, generator=gen) * -0.1}
            fields = [w[f] for f in dispatch.FIELDS[qtype]]
            w_dense = getattr(qmm_legacy, f"dequant_{name}")(*fields)
            for m in TILED_MS:
                check_f32(timer, results, f"K8 {qtype.name}", kern,
                          lambda x: fn(x, *fields), lambda x: plain(x, *fields),
                          torch.randn((m, k), device=device, generator=gen), w_dense,
                          n * k * bpw / 8)
            del w_dense
            rows[f"{qtype.name} N={n} K={k}"] = check_rows(
                f"K8 {qtype.name}", lambda x: fn(x, *fields),
                torch.randn((128, k), device=device, generator=gen))
    return rows


# K9's types: (type, kernel, bits per weight in the port's layout)
Q23K = ((GGMLType.Q2_K, kernels.K9_Q2_K, 2.75), (GGMLType.Q3_K, kernels.K9_Q3_K, 3.625))


def check_q23k(device, timer, results):
    """K9's two entry points at every matrix shape of the Q2_K and Q3_K_M
    files that their types take (the 11008-wide ffn_down has 43
    superblocks per row, an odd count), from decode to a 128-row prefill
    chunk (neither type has an int8 twin), and their rows bit for bit
    across M (check_rows)."""
    gen = torch.Generator(device=device).manual_seed(9)
    rows = {}
    for qtype, kern, bpw in Q23K:
        name = qtype.name[:2].lower() + "_K"
        fn, plain = getattr(qmm_q23k, f"qmm_{name}"), getattr(qmm_q23k, f"qmm_{name}_plain")
        for n, k in ((4096, 4096), (11008, 4096), (4096, 11008)):
            rand_u8 = lambda cols: torch.randint(0, 256, (n, cols), dtype=torch.uint8,  # noqa: E731
                                                 device=device, generator=gen)
            w = {"qs": rand_u8(k // 4), "scales": rand_u8(k // 16), "hmask": rand_u8(k // 8),
                 "sc": torch.randint(-32, 32, (n, k // 16), dtype=torch.int8, device=device,
                                     generator=gen),
                 "d": torch.rand((n, k // 256), device=device, generator=gen) * 1e-3,
                 "dmin": torch.rand((n, k // 256), device=device, generator=gen) * 1e-3}
            fields = [w[f] for f in dispatch.FIELDS[qtype]]
            w_dense = getattr(qmm_q23k, f"dequant_{name}")(*fields)
            for m in TILED_MS:
                check_f32(timer, results, f"K9 {qtype.name}", kern,
                          lambda x: fn(x, *fields), lambda x: plain(x, *fields),
                          torch.randn((m, k), device=device, generator=gen), w_dense,
                          n * k * bpw / 8)
            del w_dense
            rows[f"{qtype.name} N={n} K={k}"] = check_rows(
                f"K9 {qtype.name}", lambda x: fn(x, *fields),
                torch.randn((128, k), device=device, generator=gen))
    return rows


# (N, K) of a llama-7B layer's seven products, in the order a layer runs
# them: wq, wk, wv, wo, w_gate, w_up, w_down
LAYER_PRODUCTS = ((4096, 4096),) * 4 + ((11008, 4096),) * 2 + ((4096, 11008),)
CHAIN_LAYERS = 8


def chain_ms(fn, reps: int = 10) -> float:
    """Median device ms of fn(), a chain of launches like a decode step's
    products, each run as one CUDA-event interval behind a spin kernel (L2
    not flushed: a step's products follow one another). At M = 1 this
    ranks kernels as a step does; flushed per-call times do not."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(Timer.SPIN_CYCLES)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def check_pipe(device, timer, results):
    """K10 at M = 1 on every matrix shape of the Q4_K file (the head tied to
    token_embd included), x in f32 so that its bf16 rounding is exercised;
    then K10 and K1 (M = 1) each in a chain of CHAIN_LAYERS layers' seven
    products with weights of their own (chain_ms)."""
    gen = torch.Generator(device=device).manual_seed(10)
    for n, k in QMM_SHAPES:
        qs, scm, dd = random_q4k(n, k, device, gen)
        w_dense = qmm.dequant(qs, scm, dd)
        check_f32(timer, results, "K10", kernels.K10,
                  lambda x: qmm_pipe.qmm_q4_K_pipelined(x, qs, scm, dd),
                  lambda x: qmm_pipe.qmm_q4_K_pipelined_plain(x, qs, scm, dd),
                  torch.randn((1, k), device=device, generator=gen), w_dense,
                  n * k * 4.75 / 8)
        del w_dense
    ws = [random_q4k(n, k, device, gen) for _ in range(CHAIN_LAYERS) for n, k in LAYER_PRODUCTS]
    xs = {k: torch.randn((1, k), device=device, generator=gen) for k in (4096, 11008)}
    chain = {"layers": CHAIN_LAYERS, "products": len(ws),
             "bound_ms": bound(sum(w[0].shape[0] * w[0].shape[1] * 2 * 4.75 / 8 for w in ws),
                               2.0 * sum(w[0].shape[0] * w[0].shape[1] * 2 for w in ws), "f32")[0]}
    for name, fn in (("K10", qmm_pipe.qmm_q4_K_pipelined), ("K1", qmm.qmm_q4_K)):
        chain[f"{name}_ms"] = chain_ms(lambda fn=fn: [fn(xs[w[0].shape[1] * 2], *w) for w in ws])
    log(f"K10 in a chain of {len(ws)} decode products ({CHAIN_LAYERS} layers) "
        f"{chain['K10_ms']:.4f} ms, K1 at M = 1 {chain['K1_ms']:.4f} ms, bound "
        f"{chain['bound_ms']:.4f} ms")
    return {"chain": chain}


def check_dma(device, timer, results):
    """K11 on the autotuner's (4096, 4096) f32 array: bit for bit against
    copy_, its plain version and the one PyTorch call for the same function;
    bound: 2 × 64 MiB over the card's memory rate."""
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((4096, 4096), device=device, generator=gen)
    out = torch.empty_like(x)
    got = dma_copy.dma_copy(x, torch.empty_like(x))
    ref = dma_copy.dma_copy_plain(x, torch.empty_like(x))
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("K11 dma_copy differs from copy_")
    b, by = bound(2 * x.numel() * x.element_size(), 0.0, "f32")
    results.append(dict(
        kernel=kernels.K11.name, shape="copy 4096x4096 f32", nmse=0.0,
        max_abs_err=float((got - ref).abs().max()),
        ms=timer(lambda: dma_copy.dma_copy(x, out)),
        plain_ms=timer(lambda: dma_copy.dma_copy_plain(x, out)),
        library_ms=timer(lambda: out.copy_(x)), bound_ms=b, bound_by=by))
    log(f"K11 copy 4096x4096 f32 bit-exact ms={results[-1]['ms']:.4f} "
        f"(copy_ {results[-1]['library_ms']:.4f}, bound {b:.4f})")


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
    attention_cases(timer, results, cases, D, gen)
    return {"rows": check_attention_rows(device)}


def attention_cases(timer, results, cases, D: int, gen):
    """K2 on each case (name, B, H, KVH, N, M, pos, dtypes, softcap, int8
    K/V) at head dim D against its plain version (nmse < 1e-10 at f32 q,
    2e-4 at bf16), timed beside it, SDPA and its bound."""
    device = gen.device
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


# K2's chunk edges: a chunk holds flash_attn.CHUNK = 128 positions
EDGE_POS = (127, 128, 129, 261)


def check_attention_rows(device) -> dict:
    """K2's rows bit for bit (torch.equal): a query row at each position of
    EDGE_POS gives the bits it has with the window cut at its position + 1
    also with the window 1024, as row 3 of a 7-row prefill, as slot 1 of 3
    (the other slots at other positions), and with one chunk range and with
    one per chunk (the wrapper's `_split`, where it has one), for bf16 and
    f32 K/V with grouped heads (H = 32, KVH = 8)."""
    gen = torch.Generator(device=device).manual_seed(12)
    fn = flash_attn.causal_flash_attention
    has_split = "_split" in inspect.signature(fn).parameters
    D, H, KVH, M = 128, 32, 8, 1024
    scale = 1.0 / D ** 0.5
    for dt in (torch.bfloat16, torch.float32):
        k = torch.randn((3, KVH, M, D), device=device, generator=gen).to(dt)
        v = torch.randn((3, KVH, M, D), device=device, generator=gen).to(dt)
        for p in EDGE_POS:
            q = torch.randn((1, H, 1, D), device=device, generator=gen)
            q7 = torch.randn((1, H, 7, D), device=device, generator=gen)
            q7[:, :, 3] = q[:, :, 0]
            q3 = torch.randn((3, H, 1, D), device=device, generator=gen)
            q3[1] = q[0]
            pos3 = torch.tensor([40, p, 900], dtype=torch.int32, device=device)
            one = fn(q, k[1:2, :, :p + 1], v[1:2, :, :p + 1], p, scale)
            got = {"window 1024": fn(q, k[1:2], v[1:2], p, scale),
                   "row 3 of N=7": fn(q7, k[1:2], v[1:2], p - 3, scale)[:, :, 3:4],
                   "slot 1 of B=3": fn(q3, k, v, pos3, scale)[1:2]}
            if has_split:
                got["split 1"] = fn(q, k[1:2], v[1:2], p, scale, _split=1)
                got["split 8"] = fn(q, k[1:2], v[1:2], p, scale, _split=M // 128)
            bad = [name for name, t in got.items() if not torch.equal(t, one)]
            if bad:
                raise AssertionError(f"K2 {dt} row at position {p}: bits differ from the "
                                     f"window {p + 1} ones at {bad}")
    cases = ["window 1024", "row 3 of N=7", "slot 1 of B=3"] + (
        ["split 1", "split 8"] if has_split else [])
    log(f"K2 rows bit-equal at positions {list(EDGE_POS)} (bf16 and f32 K/V): "
        f"window p + 1 vs {cases}")
    return {"positions": list(EDGE_POS), "cases": cases, "equal": True}


# ------------------------------------------------------------- main path

def _matrices(cfg: dict, n_layer: int):
    """(tensor, layer or None, rows, cols) of every matrix of a llama GGUF."""
    D, V, FF = cfg["n_embd"], cfg["n_vocab"], cfg["n_ff"]
    KVD = cfg["n_kv_head"] * (D // cfg["n_head"])
    yield "token_embd", None, V, D
    yield "output", None, V, D
    for i in range(n_layer):
        for name, r, c in (("attn_q", D, D), ("attn_k", KVD, D), ("attn_v", KVD, D),
                           ("attn_output", D, D), ("ffn_gate", FF, D),
                           ("ffn_up", FF, D), ("ffn_down", D, FF)):
            yield name, i, r, c


def k_m_type(base: GGMLType, name: str, layer: int | None, n_layer: int) -> GGMLType:
    """llama.cpp's tensor type for the _K_M file types over their base type
    (LLAMA_FTYPE_MOSTLY_Q4_K_M: Q4_K, _Q5_K_M: Q5_K; src/llama-quant.cpp,
    llama_tensor_get_type with use_more_bits): output.weight is Q6_K;
    attn_v and ffn_down are Q6_K in the first and last eighth of the layers
    and in every third layer between (16 of 32), the base type elsewhere;
    every other matrix, token_embd included, is the base type."""
    if name == "output":
        return GGMLType.Q6_K
    if name in ("attn_v", "ffn_down"):
        e = n_layer // 8
        if layer < e or layer >= 7 * n_layer // 8 or (layer - e) % 3 == 2:
            return GGMLType.Q6_K
    return base


q4_k_m_type = functools.partial(k_m_type, GGMLType.Q4_K)


def legacy_type(base: GGMLType, name: str, layer: int | None, n_layer: int) -> GGMLType:
    """llama.cpp's tensor type for its legacy file types without an
    importance matrix (LLAMA_FTYPE_MOSTLY_Q4_0, _Q4_1, _Q5_0, _Q5_1;
    llama_tensor_get_type): output.weight is Q6_K, every other matrix,
    token_embd included, is the base type."""
    return GGMLType.Q6_K if name == "output" else base


def q2_k_type(name: str, layer: int | None, n_layer: int) -> GGMLType:
    """llama.cpp's tensor type for LLAMA_FTYPE_MOSTLY_Q2_K without an
    importance matrix, for a llama with n_gqa = 1 (src/llama-quant.cpp,
    llama_tensor_get_type): attn_v (Q4_K only from n_gqa >= 4), attn_output
    and ffn_down are Q3_K; output.weight is Q6_K; every other matrix,
    token_embd included, is Q2_K."""
    if name == "output":
        return GGMLType.Q6_K
    return GGMLType.Q3_K if name in ("attn_v", "attn_output", "ffn_down") else GGMLType.Q2_K


def q3_k_m_type(name: str, layer: int | None, n_layer: int) -> GGMLType:
    """llama.cpp's tensor type for LLAMA_FTYPE_MOSTLY_Q3_K_M without an
    importance matrix (llama_tensor_get_type): attn_v is Q5_K in its first
    two layers (i_attention_wv < 2) and Q4_K after; attn_output is Q4_K;
    ffn_down is Q5_K in the layers below n_layer / 16 and Q4_K after;
    output.weight is Q6_K; every other matrix, token_embd included, is
    Q3_K."""
    if name == "output":
        return GGMLType.Q6_K
    if name == "attn_v":
        return GGMLType.Q5_K if layer < 2 else GGMLType.Q4_K
    if name == "ffn_down":
        return GGMLType.Q5_K if layer < n_layer // 16 else GGMLType.Q4_K
    return GGMLType.Q4_K if name == "attn_output" else GGMLType.Q3_K


# file recipe → the type of each matrix; None: no output.weight, the head
# is tied to token_embd
RECIPES = {
    "q4_k": lambda name, layer, n_layer: None if name == "output" else GGMLType.Q4_K,
    "q4_k_m": q4_k_m_type,
    "q8_0": lambda name, layer, n_layer: GGMLType.Q8_0,
    "q5_k_m": functools.partial(k_m_type, GGMLType.Q5_K),
    "q4_0": functools.partial(legacy_type, GGMLType.Q4_0),
    "q4_1": functools.partial(legacy_type, GGMLType.Q4_1),
    "q5_0": functools.partial(legacy_type, GGMLType.Q5_0),
    "q5_1": functools.partial(legacy_type, GGMLType.Q5_1),
    "q2_k": q2_k_type,
    "q3_k_m": q3_k_m_type,
}
# the recipes whose paths run at full depth (--layers); the others, whose
# kernels the smoke has held at full depth since the PR that added them, at
# SHORT_LAYERS, so that twelve paths fit the smoke's time
FULL_DEPTH = ("q4_k",)
SHORT_LAYERS = 8
# the recipes whose 100-token prefill is traced too: those whose prefill
# products run on the f32 body (K4, K7, K8, K9; K3 takes the Q4_K_M file's
# Q4_K ones and some of the Q3_K_M file's) or on K5-i8 (Q8_0) and K6-i8
# (Q4_0); with the kernel names whose device time the trace sums
# (matched_ms): the int8 kernels, their x quantization and the earlier
# dp4a kernels' names, so that a parent tree's trace reads the same
K3_TRACE_NAMES = ("Q4KI8", "XQ4K", "q4k_quant_x")
TRACE_PREFILL = {"q4_k_m": K3_TRACE_NAMES, "q5_k_m": (), "q4_1": (), "q5_0": (), "q5_1": (),
                 "q2_k": (), "q3_k_m": K3_TRACE_NAMES,
                 "q8_0": ("Q80I8", "XQ80", "qmm_q8_0_i8_kernel"),
                 "q4_0": ("Q40I8", "XQ40", "qmm_q4_0_i8_kernel")}


def _rand_u8(rng, shape):
    """rng.bytes(n) as a uint8 array of `shape`. For n % 8 == 0 the bit
    generator's raw 64-bit words are those bytes (Generator.bytes draws
    whole uint32 pairs of them, low word first) and leave the generator in
    the same state, at ~2.5x the rate: the files' bytes stay as they were."""
    n = int(np.prod(shape))
    if n % 8:
        return np.frombuffer(rng.bytes(n), np.uint8).reshape(shape)
    return rng.bit_generator.random_raw(n // 8).view(np.uint8).reshape(shape)


def make_blocks(qtype: GGMLType, rng, n: int, k: int, random_scales: bool):
    """Valid wire blocks (n, k/blck) of qtype with random quants. The
    constructed scales give zero-mean weights ~N(0, 0.02) in scale
    (bench.py:88-152's recipe for Q4_K: sc=32, m=60, d=e, dmin=4e, e =
    1.356e-4; Q5_K sc=32, m=60, d=6.77e-5, dmin=5.60e-4, centring the 5-bit
    q of mean 15.5, std 9.23; Q6_K sc=16, d=6.77e-5; Q8_0 d=2.706e-4; Q4_0
    d=4.34e-3, q − 8 having std 4.61; Q4_1 d=4.34e-3, m=−7.5·d; Q5_0
    d=2.17e-3, q − 16 having std 9.23; Q5_1 d=2.17e-3, m=−15.5·d; Q2_K
    sc=8, m=12, d=dmin=2.236e-3, centring the 2-bit q of mean 1.5, std
    1.118; Q3_K sc=8, d=1.091e-3, q − 4 of mean −0.5, std 2.291);
    random_scales draws them instead."""
    if qtype == GGMLType.Q2_K:
        b = np.zeros((n, k // 256), BLOCK_Q2_K)
        if random_scales:
            b["d"], b["dmin"] = np.float16(0.004), np.float16(0.006)
            b["scales"] = _rand_u8(rng, (n, k // 256, 16))
        else:
            b["d"] = b["dmin"] = np.float16(2.236e-3)
            b["scales"] = 8 | (12 << 4)
        b["qs"] = _rand_u8(rng, (n, k // 256, 64))
    elif qtype == GGMLType.Q3_K:
        b = np.zeros((n, k // 256), BLOCK_Q3_K)
        if random_scales:
            b["d"] = np.float16(0.001)
            b["scales"] = pack_q3_scales(rng.integers(-32, 32, (n, k // 256, 16)))
        else:
            b["d"] = np.float16(1.091e-3)
            b["scales"] = pack_q3_scales(np.full(16, 8))
        b["hmask"] = _rand_u8(rng, (n, k // 256, 32))
        b["qs"] = _rand_u8(rng, (n, k // 256, 64))
    elif qtype == GGMLType.Q5_K:
        b = np.zeros((n, k // 256), BLOCK_Q5_K)
        if random_scales:
            b["d"], b["dmin"] = np.float16(0.001), np.float16(0.015)
            b["scales"] = pack_scale_min_k4(rng.integers(0, 64, (n * (k // 256), 8)),
                                            rng.integers(0, 64, (n * (k // 256), 8))
                                            ).reshape(n, k // 256, 12)
        else:
            b["d"], b["dmin"] = np.float16(6.77e-5), np.float16(5.60e-4)
            b["scales"] = pack_scale_min_k4(np.full((1, 8), 32, np.uint8),
                                            np.full((1, 8), 60, np.uint8))[0]
        b["qh"] = _rand_u8(rng, (n, k // 256, 32))
        b["qs"] = _rand_u8(rng, (n, k // 256, 128))
    elif qtype == GGMLType.Q4_0:
        b = np.zeros((n, k // 32), BLOCK_Q4_0)
        b["d"] = (rng.uniform(0.5, 1.5, (n, k // 32)) * 3e-2).astype(np.float16) \
            if random_scales else np.float16(4.34e-3)
        b["qs"] = _rand_u8(rng, (n, k // 32, 16))
    elif qtype in (GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        b = np.zeros((n, k // 32), {GGMLType.Q4_1: BLOCK_Q4_1, GGMLType.Q5_0: BLOCK_Q5_0,
                                    GGMLType.Q5_1: BLOCK_Q5_1}[qtype])
        centre = 7.5 if qtype == GGMLType.Q4_1 else 15.5     # the mean of q
        d0 = 4.34e-3 if qtype == GGMLType.Q4_1 else 2.17e-3
        d = (rng.uniform(0.5, 1.5, (n, k // 32)) * 7 * d0 if random_scales
             else np.full((n, k // 32), d0)).astype(np.float16)
        b["d"] = d
        if "m" in b.dtype.names:
            c = rng.uniform(centre - 1, centre + 1, d.shape) if random_scales else centre
            b["m"] = (-c * d.astype(np.float32)).astype(np.float16)
        if "qh" in b.dtype.names:
            b["qh"] = _rand_u8(rng, (n, k // 32, 4))
        b["qs"] = _rand_u8(rng, (n, k // 32, 16))
    elif qtype == GGMLType.Q4_K:
        b = np.zeros((n, k // 256), BLOCK_Q4_K)
        if random_scales:
            b["d"], b["dmin"] = np.float16(0.002), np.float16(0.008)
            b["scales"] = pack_scale_min_k4(rng.integers(0, 64, (n * (k // 256), 8)),
                                            rng.integers(0, 64, (n * (k // 256), 8))
                                            ).reshape(n, k // 256, 12)
        else:
            e = np.float16(1.356e-4)
            b["d"], b["dmin"] = e, np.float16(4 * float(e))
            b["scales"] = pack_scale_min_k4(np.full((1, 8), 32, np.uint8),
                                            np.full((1, 8), 60, np.uint8))[0]
        b["qs"] = _rand_u8(rng, (n, k // 256, 128))
    elif qtype == GGMLType.Q6_K:
        b = np.zeros((n, k // 256), BLOCK_Q6_K)
        b["d"] = np.float16(0.0005) if random_scales else np.float16(6.77e-5)
        b["scales"] = rng.integers(-64, 64, (n, k // 256, 16)) if random_scales else 16
        b["ql"] = _rand_u8(rng, (n, k // 256, 128))
        b["qh"] = _rand_u8(rng, (n, k // 256, 64))
    else:
        b = np.zeros((n, k // 32), BLOCK_Q8_0)
        b["d"] = (rng.uniform(0.5, 1.5, (n, k // 32)) * 2e-3).astype(np.float16) \
            if random_scales else np.float16(2.706e-4)
        b["qs"] = _rand_u8(rng, (n, k // 32, 32)).view(np.int8)
    return b


TT_NORMAL, TT_UNKNOWN, TT_CONTROL, TT_BYTE = 1, 2, 3, 6     # gguf token types
_LETTERS = "etaoinshrdlcumwfgypbvkjxqz"


def spm_words(n: int, seed: int = 7) -> list[str]:
    """n distinct lowercase words of 2-8 letters, made from a fixed seed."""
    rng = np.random.default_rng(seed)
    p = np.linspace(2.0, 0.5, len(_LETTERS))
    letters = rng.choice(len(_LETTERS), (2 * n, 8), p=p / p.sum())
    lengths = rng.integers(2, 9, 2 * n)
    words = dict.fromkeys("".join(_LETTERS[c] for c in row[:m])
                          for row, m in zip(letters, lengths))
    assert len(words) >= n
    return list(words)[:n]


@functools.lru_cache(maxsize=4)
def spm_vocab(n_vocab: int, seed: int = 7):
    """A synthetic SentencePiece vocabulary of exactly n_vocab tokens,
    (tokens, scores, token types): <unk>, <s>, </s>, the 256 <0xXX> byte
    tokens, then unique pieces with scores: ▁, the letters and some
    punctuation, then every prefix of spm_words(seed), bare and after ▁,
    shorter first, until the vocabulary is full. Text made of those words
    (synthetic_text) encodes to multi-letter pieces."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [TT_UNKNOWN, TT_CONTROL, TT_CONTROL] + [TT_BYTE] * 256
    pieces = dict.fromkeys(["▁"] + list(_LETTERS) + list(".,"))
    for w in spm_words(n_vocab // 2, seed):
        if len(tokens) + len(pieces) >= n_vocab:
            break
        for i in range(2, len(w) + 1):
            pieces.setdefault("▁" + w[:i])
            pieces.setdefault(w[:i])
    pieces = list(pieces)[:n_vocab - len(tokens)]
    scores = [0.0] * len(tokens) + [-1.0 - r / len(pieces) for r in range(len(pieces))]
    assert len(tokens) + len(pieces) == n_vocab
    return (tuple(tokens + pieces), tuple(scores),
            tuple(types + [TT_NORMAL] * len(pieces)))


@functools.lru_cache(maxsize=4)
def _whole_words(n_vocab: int) -> tuple:
    """The spm_words that spm_vocab(n_vocab) holds whole (after ▁)."""
    have = set(spm_vocab(n_vocab)[0])
    return tuple(w for w in spm_words(n_vocab // 2) if "▁" + w in have)


def synthetic_text(n_words: int, seed: int, n_vocab: int = 32000) -> str:
    """n_words words drawn from a fixed seed among the spm_words that
    spm_vocab(n_vocab) holds whole, with a sentence mark every 12 words:
    text that does not repeat."""
    words = _whole_words(n_vocab)
    rng = np.random.default_rng(seed)
    out = [words[i] for i in rng.integers(0, len(words), n_words)]
    return " ".join(w + ("." if j % 12 == 11 else "") for j, w in enumerate(out))


def write_vocab(w, n_vocab: int):
    """spm_vocab(n_vocab) as the GGUF tokenizer metadata of llama.cpp's SPM
    files (scores written as floats, token types as ints)."""
    tokens, scores, types = spm_vocab(n_vocab)
    w.set("tokenizer.ggml.model", "llama")
    w.set("tokenizer.ggml.tokens", list(tokens))
    w.set("tokenizer.ggml.scores", [float(s) for s in scores])
    w.set("tokenizer.ggml.token_type", [int(t) for t in types])
    w.set("tokenizer.ggml.bos_token_id", 1)
    w.set("tokenizer.ggml.eos_token_id", 2)
    w.set("tokenizer.ggml.unknown_token_id", 0)
    w.set("tokenizer.ggml.add_bos_token", True)


def write_gguf(path: Path, cfg: dict, n_layer: int, recipe: str,
               random_scales: bool = False):
    """A llama GGUF of `cfg`'s width with each matrix in the recipe's type
    (make_blocks, seed 0), f32 norm weights and the SentencePiece vocabulary
    spm_vocab(n_vocab), written with the port's writer; an existing file is
    kept. The norm weights are ones, or with
    random_scales 1 + N(0, 0.1): a Q8_0 embedding row is an exact grid of
    q·d, and under norms of ones the first layer's per-tile int8
    activations sit on rounding ties that any last-bit difference flips,
    which makes a tiny model's int8 route chaotic."""
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
    if "rope_base" in cfg:
        w.set(f"{A}.rope.freq_base", float(cfg["rope_base"]))
    write_vocab(w, cfg["n_vocab"])
    for name, layer, r, c in _matrices(cfg, n_layer):
        qtype = RECIPES[recipe](name, layer, n_layer)
        if qtype is not None:
            gname = f"{name}.weight" if layer is None else f"blk.{layer}.{name}.weight"
            w.add_tensor(gname, (c, r), qtype, make_blocks(
                qtype, rng, r, c, random_scales).reshape(-1).view(np.uint8))
    def norm():
        g = 1 + 0.1 * rng.standard_normal(cfg["n_embd"]) if random_scales else 1
        return np.full(cfg["n_embd"], g, np.float32)

    w.add_array_tensor("output_norm.weight", norm())
    for i in range(n_layer):
        w.add_array_tensor(f"blk.{i}.attn_norm.weight", norm())
        w.add_array_tensor(f"blk.{i}.ffn_norm.weight", norm())
    tmp = path.with_suffix(".tmp")
    w.write(tmp)
    tmp.rename(path)


def expected_launches(recipe, n_layer: int, m: int, layout: str = "kernel") -> dict:
    """Kernel launches of one forward over m tokens of the recipe's file on
    the card, under the current config: one K2 per layer, and in the kernel
    layout one per matrix product (the head's type is token_embd's when
    tied; the embedding is a row gather). The int8 layout's products are
    plain torch. `recipe` is a name in RECIPES or a recipe function."""
    out = {kernels.K2.name: n_layer}
    if layout == "int8":
        return out
    types = recipe if callable(recipe) else RECIPES[recipe]
    for name, layer, r, c in _matrices(CFG_7B, n_layer):
        if name == "token_embd":
            continue
        qtype = types(name, layer, n_layer) or types("token_embd", None, n_layer)
        kern = dispatch.KERNEL_OF[(qtype, dispatch.route(m, qtype, (r, c), cuda=True))].name
        out[kern] = out.get(kern, 0) + 1
    return out


def launches():
    return {k.name: k.launches for k in kernels.KERNELS}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items() if v - before[k]}


def _leaves(params) -> list:
    return ([params["wte"], params["out_norm"]] + [params[k] for k in ("lm_head",) if k in params]
            + [t for b in params["blocks"] for t in b.values()])


def _probe_step(cfg, params, device, prompt) -> torch.Tensor:
    """The logits of one decode step at position len(prompt), token
    prompt[0], after a prefill of `prompt` into a fresh cache: the same
    inputs whatever the weights' layout."""
    kv = llama.make_cache(cfg, 1024, device=device)
    _, kv = llama.forward(cfg, params, torch.tensor(prompt, device=device), kv, 0)
    lg, _ = llama.forward(cfg, params, torch.tensor(prompt[:1], device=device), kv, len(prompt))
    return lg[-1].float()


def main_path(device, n_layer: int, recipe: str, layout: str = "kernel",
              keep_file: bool = False, attn_bound: float | None = None) -> dict:
    """One file's path: load (in `layout`; "auto" through config
    weights_layout, as a user sets it), generate, the engine, launches per
    step and per chunk, two traced steps. With attn_bound, one decode step
    under attn_impl="xla" too, held against the step on K2 within
    attn_bound."""
    out = {"layers": n_layer, "recipe": recipe, "layout_asked": layout}
    path = ROOT / "build" / f"smoke_llama7b_{recipe}_L{n_layer}.gguf"
    t0 = time.perf_counter()
    write_gguf(path, CFG_7B, n_layer, recipe)
    out["gguf_write_s"] = time.perf_counter() - t0
    out["gguf_gb"] = path.stat().st_size / 1e9

    torch.cuda.reset_peak_memory_stats()
    PEAKS_GB.clear()
    t0 = time.perf_counter()
    if layout == "auto":
        config.set("weights_layout", "auto")
        try:
            cfg, params = llama.load(path, device=device)
        finally:
            config.unset("weights_layout")
        layout = autotune.choose(device)
    else:
        cfg, params = llama.load(path, device=device, layout=layout)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["layout"] = layout
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    leaves = _leaves(params)
    for t in leaves:
        fields = t.fields.values() if isinstance(t, QuantTensor) else [t]
        assert all(f.device.type == device.type for f in fields), \
            f"a weight is not on {device}"
    out["tensor_types"] = {}
    for t in leaves:
        if isinstance(t, QuantTensor):
            out["tensor_types"][t.qtype.name] = out["tensor_types"].get(t.qtype.name, 0) + 1
    layouts = {t.layout for t in leaves if isinstance(t, QuantTensor)}
    if layouts != {layout}:
        raise AssertionError(f"{recipe}: matrices in layouts {layouts}, asked for {layout}")
    assert ("lm_head" in params) == (RECIPES[recipe]("output", None, n_layer) is not None)
    out["weights_gb"] = sum(t.nbytes if isinstance(t, QuantTensor)
                            else t.numel() * t.element_size() for t in leaves) / 1e9
    log(f"loaded {n_layer}-layer 7B-width {recipe} GGUF in the {layout} layout in "
        f"{out['load_s']:.2f} s (matrices by type {out['tensor_types']})")
    if out["layout_asked"] == "auto":
        # the same file loaded with the chosen layout given explicitly
        _, explicit = llama.load(path, device=device, layout=layout)
        prompt8 = [1, 2, 3, 4, 5, 6, 7, 8]
        if (llama.generate(cfg, params, prompt8, 8, max_seq=64, device=device)
                != llama.generate(cfg, explicit, prompt8, 8, max_seq=64, device=device)):
            raise AssertionError(f"{recipe}: the auto load's stream differs from the "
                                 f"{layout} load's")
        del explicit
    if not keep_file:
        path.unlink()                # the 7B files together hold ~38 GB
    want_step = expected_launches(recipe, n_layer, 1, layout)
    want_chunk = expected_launches(recipe, n_layer, 128, layout)

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
        if recipe in TRACE_PREFILL:
            out["prefill_trace"] = trace_device(lambda: llama.forward(
                cfg, params, toks, llama.make_cache(cfg, 1024, device=device), 0),
                TRACE_PREFILL[recipe])
        stream = prompt + [int(logits[-1].argmax())]
        per_step = {}
        t0 = time.perf_counter()
        for i in range(N_NEW - 1):
            before = launches()
            lg, kv = llama.forward(cfg, params, torch.tensor([stream[-1]], device=device),
                                   kv, len(stream) - 1)
            stream.append(int(lg[-1].argmax()))
            if i == 0:
                per_step = _delta(before)
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
        out["launches_per_prefill_chunk_128"] = _delta(before)
        for key, want in (("launches_per_decode_step", want_step),
                          ("launches_per_prefill_chunk_128", want_chunk)):
            if out[key] != want:
                raise AssertionError(f"{recipe}: {key} {out[key]}, its tensor types "
                                     f"predict {want}")

        # the engine: 8 parity requests + one 300-token prompt
        prompts = [[int(t) for t in rng.integers(1, cfg.n_vocab, n)] for n in PARITY_LENS]
        long_prompt = [int(t) for t in rng.integers(1, cfg.n_vocab, 300)]
        eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
        out["engine_depth"] = int(config.get("engine_harvest_depth"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = serve(eng, prompts + [long_prompt], N_NEW)
        torch.cuda.synchronize()
        out["engine_first_run_s"] = time.perf_counter() - t0     # the captures included
        out["engine_vs_generate"] = engine_vs_generate(
            recipe, cfg, params, device, prompts, done,
            int8_route=bool(I8_KERNELS & set(want_chunk)))
        # the same requests again on the same engine (its graphs captured)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = serve(eng, prompts + [long_prompt], N_NEW)
        torch.cuda.synchronize()
        out["engine_s"] = time.perf_counter() - t0
        if again != done:
            raise AssertionError(f"{recipe}: the engine's second run differs from its first")
        out["engine_tokens"] = sum(map(len, again))
        out["engine_steps"] = len(eng.window_log)
        out["engine_window_tokens"] = [n for _, n in eng.window_log]
        out["engine_graphs"] = graph_stats(getattr(eng, "graphs", None))
        # the greedy streams, to compare two trees' paths token for token
        out["streams_sha256"] = hashlib.sha256(json.dumps(
            [stream] + done[:len(prompts)]).encode()).hexdigest()
        if recipe == "q4_k" and out["layout_asked"] == "kernel" and HAS_GRAPHS:
            del eng
            gc.collect()
            out["engine_depths"] = depth_checks(device, cfg, params, prompts, long_prompt, done)
            eng = None
            out["admission"] = admission_phase(device, cfg, params, prompts, long_prompt, done)
            if HAS_KV_VARIANTS:
                out["kv_variants"] = kv_variants_phase(device, cfg, params, prompts,
                                                       long_prompt, done)
        if recipe == "q4_0" and HAS_FLOOD:
            del eng
            gc.collect()
            out["engine_f32_route"] = f32_route_check(device, cfg, params, prompts, long_prompt)
            eng = None

        # engine decode steps at steady state: 8 active slots, no admission
        del eng                          # one engine's KV cache at a time
        gc.collect()                     # (an engine and its graphs' closures form a cycle)
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
        if HAS_GRAPHS:
            out["scan_window"] = scan_window(eng)
        if recipe == "q4_k" and out["layout_asked"] == "kernel":
            eng = None                   # its KV cache goes before the long-window one
            gc.collect()
            out["long_window"] = long_window_step(device, cfg, params)
    for key, step_ms in (("decode_step_trace", out["decode_step_ms"]),
                         ("engine_step_trace", out["engine_decode_step_ms"]),
                         ("prefill_trace", out["prefill_100_s"] * 1e3)):
        if key not in out:
            continue
        busy = out[key]["busy_ms"]
        out[key]["busy_share"] = None if busy is None else busy / step_ms
    out["launches"] = launches()
    missing = [k for k in {**want_step, **want_chunk} if out["launches"][k] == 0]
    if missing:
        raise AssertionError(f"{recipe}: kernels never launched on its path: {missing}")
    out["peak_mem_gb"] = max([torch.cuda.max_memory_allocated() / 1e9] + PEAKS_GB)
    out["prefill_tok_s"] = 100 / out["prefill_100_s"]
    out["prefill_100_ms"] = out["prefill_100_s"] * 1e3
    out["decode_tok_s"] = (N_NEW - 1) / out["decode_s"]
    out["engine_tok_s"] = out["engine_tokens"] / out["engine_s"]
    del eng
    gc.collect()
    with torch.inference_mode():
        if recipe == "q4_k":
            out["probe_logits"] = _probe_step(cfg, params, device, prompt).cpu()
        if attn_bound is not None:
            out["attn_xla"] = attn_xla_check(device, cfg, params, prompt, attn_bound)
    if recipe == "q4_k" and layout == "kernel":
        if HAS_GRAPHS and out["layout_asked"] == "kernel":
            with torch.inference_mode():
                out["graphs"] = graphs_phase(device, cfg, params, n_layer, prompt, stream)
        if HAS_TOOLS and keep_file:
            out["tools"] = tools_phase(device, cfg, params, n_layer, path)
        out["pipeline"] = pipeline_phase(device, cfg, params, n_layer)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve(eng, prompts, n_new, **kw) -> list:
    """The streams of `prompts` served by `eng` (request j seeded j)."""
    rids = [eng.submit(p, n_new, seed=j, **kw) for j, p in enumerate(prompts)]
    done = {r.rid: r.out for r in eng.run()}
    return [done[r] for r in rids]


I8_KERNELS = {kernels.K3.name, kernels.K5_I8.name, kernels.K6_I8.name}


def first_divergence(a: list, b: list) -> int | None:
    """The first index where two streams differ (None when equal)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def engine_vs_generate(recipe, cfg, params, device, prompts, done, int8_route: bool,
                       mod=llama) -> dict:
    """Each engine stream against `generate`'s for its prompt: asserted equal
    where both prefill the prompt on one matmul route, recorded (the first
    divergence) elsewhere. A flood's products take the routes of M =
    B·s_pad, so on a file with an int8 route (Q4_K, Q8_0, Q4_0 tensors in the kernel layout) a
    flooded prompt shorter than int8_min_m takes K3 / K5-i8 / K6-i8 where
    `generate` takes the f32 kernel; a tree without the flood admits
    request by request, on generate's route. `mod`: the model's module."""
    min_m = int(config.get("int8_min_m"))
    out = {"asserted": [], "recorded": {}}
    mismatches = []
    for p, got in zip(prompts, done):
        ref = mod.generate(cfg, params, p, N_NEW, max_seq=1024, device=device)[len(p):]
        if not (HAS_FLOOD and int8_route) or len(p) >= min_m:
            out["asserted"].append(len(p))
            if got != ref:
                mismatches.append(len(p))
        else:
            out["recorded"][len(p)] = first_divergence(got, ref)
    if mismatches:
        raise AssertionError(f"{recipe}: engine streams differ from generate for "
                             f"prompt lengths {mismatches}")
    return out


def spans_since(t0: int, name: str | None = None) -> list:
    """The engine's spans (utils/trace.py) that started at or after t0
    (perf_counter ns), of `name` alone when given."""
    return [s for s in trace.RECORDER.overlapping(t0, time.perf_counter_ns())
            if s.t0 >= t0 and (name is None or s.name == name)]


def floods_since(t0: int) -> list:
    """The requests each engine flood since t0 admitted, from its span."""
    return [s.attrs["requests"] for s in spans_since(t0, "engine.flood")]


@torch.inference_mode()
def f32_route_check(device, cfg, params, prompts, long_prompt) -> dict:
    """On a file with an int8 route, the 8+1 requests served with
    int8_min_m = 0 (every product on the f32 kernels, the prompts flooded)
    equal `generate` at int8_min_m = 0 bit for bit, every request."""
    config.set("int8_min_m", 0)
    try:
        eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
        t0 = time.perf_counter_ns()
        done = serve(eng, prompts + [long_prompt], N_NEW)
        floods = floods_since(t0)
        bad = [len(p) for p, got in zip(prompts, done)
               if p + got != llama.generate(cfg, params, p, N_NEW, max_seq=1024, device=device)]
    finally:
        config.unset("int8_min_m")
    if not floods or bad:
        raise AssertionError(f"int8_min_m=0: floods {floods}, engine streams differ from "
                             f"generate for prompt lengths {bad}")
    del eng
    gc.collect()
    return {"floods": floods, "asserted": [len(p) for p in prompts]}


def _merged(spans) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> float:
    """The total length of the intersection of two disjoint sorted lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        total += max(0.0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


ADMISSION_RUN = "smoke.admission_run"


@torch.inference_mode()
def admission_phase(device, cfg, params, prompts, long_prompt, streams) -> dict:
    """Where a whole engine run of the 8+1 requests spends its time (the
    32-layer Q4_K file): one `Engine.run` (its graphs captured by a first
    run) traced under a `smoke.admission_run` range that marks it in the
    profile, read through the engine's own spans (utils/trace.py), each
    leaf a `record_function` of its name under the profiler: flood, chunk,
    replay, harvest, and graphs.py's captures and host waits on the card.
    Host seconds and calls per span name; device busy ms per name: the
    union of the run's device activities inside the device-side ranges the
    profiler draws for the name (from its first to its last correlated
    activity), the rest ("unlabelled") being the graph replays, whose
    kernels the profiler does not tie to the range that launched them; the
    run's device busy ms (union of its activities, less the range drawn
    for the marker) and wall. Each flood's span
    against its event in the trace: the offsets of its two ends after
    `trace.to_trace_ns` (held within 1 ms on the card) and whether its first
    kernel starts after the span does. Then, on a tree with the flood, one
    flood of the 8 short prompts alone, synchronised: host ms unprofiled,
    and traced: busy ms, its share, the device ms of K3 and its x
    quantization. `floods`: the requests of each flood of the phase."""
    from torch.profiler import ProfilerActivity, profile

    eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
    t_phase = time.perf_counter_ns()
    flood = getattr(eng, "_admit_batch", None)
    if serve(eng, prompts + [long_prompt], N_NEW) != streams:
        raise AssertionError("admission phase: streams differ from the main path's engine")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        with torch.profiler.record_function(ADMISSION_RUN):
            again = serve(eng, prompts + [long_prompt], N_NEW)
            torch.cuda.synchronize()
        wall = (time.perf_counter_ns() - t0) / 1e9
    if again != streams:
        raise AssertionError("admission phase: the traced run's streams differ")
    leaves = [s for s in spans_since(t0) if s.name.startswith(("engine.", "graphs."))
              and s.name != "engine.window"]
    host = {s.name: 0.0 for s in leaves}
    calls = dict.fromkeys(host, 0)
    for s in leaves:
        host[s.name] += (s.t1 - s.t0) / 1e9
        calls[s.name] += 1
    events = list(prof.profiler.kineto_results.events())
    ranges = {label: [] for label in host}
    spans = []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() != ADMISSION_RUN:
            (ranges[e.name()] if e.name() in ranges else spans).append(
                (e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3))
    spans = _merged(spans)
    busy = sum(b - a for a, b in spans)
    dev = {label: _overlap(spans, _merged(r)) / 1e3 for label, r in ranges.items()}
    dev["unlabelled"] = busy / 1e3 - sum(dev.values())
    out = {"run_wall_s": wall, "run_busy_ms": busy / 1e3,
           "run_busy_share": busy / 1e3 / (wall * 1e3), "tokens": sum(map(len, again)),
           "host_s": host, "calls": calls, "device_busy_ms": dev,
           "tok_s_traced": sum(map(len, again)) / wall,
           "flood_clock": flood_clock([s for s in leaves if s.name == "engine.flood"],
                                      events, device.type == "cuda")}
    if flood is None:
        out["floods"] = floods_since(t_phase)
        del eng
        gc.collect()
        return out
    # one flood alone: the 8 short prompts into the idle engine
    for j, p in enumerate(prompts):
        eng.submit(p, N_NEW, seed=j)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flood()
    torch.cuda.synchronize()
    out["flood_ms"] = (time.perf_counter() - t0) * 1e3
    eng.run()
    for j, p in enumerate(prompts):
        eng.submit(p, N_NEW, seed=j)
    out["flood_trace"] = trace_device(flood, K3_TRACE_NAMES)
    busy = out["flood_trace"]["busy_ms"]
    out["flood_trace"]["busy_share"] = None if busy is None else busy / out["flood_ms"]
    eng.run()
    out["floods"] = floods_since(t_phase)
    del eng, flood
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(Engine, "_flood_rows"):
        out["compact_flood"] = compact_flood_check(device, cfg, params, prompts, long_prompt)
    return out


def compact_flood_check(device, cfg, params, prompts, long_prompt) -> dict:
    """One flood of the 8 short prompts into a 16-slot engine whose first
    slot decodes the long prompt (admitted in chunks), run as the engine
    sizes it (the admitted rows, `Engine._flood_rows`) and as the full block
    of every slot's row, each in an engine of its own: the first tokens, the
    admitted slots' lengths and their installed K/V rows [0, plen) of every
    layer must be bit-equal. Each flood traced alone (`trace_device`): its
    device busy ms. `blocks`: the token block's (rows, s_pad) each time."""
    got, out = {}, {}
    for mode in ("compact", "full"):
        eng = Engine(llama, cfg, params, max_batch=16, max_seq=1024, device=device)
        if mode == "full":
            eng._flood_rows = lambda n, s_pad: eng.max_batch
        blocks, prefill = [], eng._prefill_flood

        def spy(toks, *a, prefill=prefill, blocks=blocks, **kw):
            blocks.append(list(toks.shape))
            return prefill(toks, *a, **kw)

        eng._prefill_flood = spy
        eng.submit(long_prompt, N_NEW)
        while eng.pending is not None or eng.queue:
            eng.step()
        for j, p in enumerate(prompts):
            eng.submit(p, N_NEW, seed=j)
        rec = trace_device(eng._admit_batch)
        firsts = {b: tok.item(j) for _, b, tok, j in eng._first_pending}   # the flood's
        slots = sorted(firsts)
        rows = [[(eng.kv.k[li][b, :, :len(eng.slots[b].prompt)].clone(),
                  eng.kv.v[li][b, :, :len(eng.slots[b].prompt)].clone())
                 for li in range(cfg.n_layer)] for b in slots]
        got[mode] = (slots, firsts, eng.kv.lengths[slots].tolist(), rows)
        out[mode] = {"blocks": blocks, "device_busy_ms": rec["busy_ms"],
                     "profiled_wall_ms": rec["profiled_wall_ms"], "top_ms": rec["top_ms"][:4]}
        eng.run()
        del eng, spy
        gc.collect()
        torch.cuda.empty_cache()
    (slots, firsts, lengths, rows), (slots_f, firsts_f, lengths_f, rows_f) = (
        got["compact"], got["full"])
    kv_equal = all(torch.equal(a, c) and torch.equal(b, d)
                   for slot, slot_f in zip(rows, rows_f)
                   for (a, b), (c, d) in zip(slot, slot_f))
    out.update(slots=slots, first_tokens=[firsts[b] for b in slots],
               equal=slots == slots_f and firsts == firsts_f and lengths == lengths_f and kv_equal)
    if not out["equal"] or out["compact"]["blocks"][0][0] >= 16:
        raise AssertionError(f"compact flood against the full block: {out}")
    return out


def flood_clock(floods: list, events: list, on_card: bool) -> dict:
    """Each flood span against the profiler's events of its name, in order:
    the offsets (ms) of the CPU event's start and end from the span's after
    `trace.to_trace_ns`, their median and largest size, and, per flood, how
    far its device-side range (its first kernel) starts after the span's
    start (None without one). On the card every offset must lie within
    1 ms: the recorder and the profiler keep one clock."""
    cpu, gpu = [], []
    for e in events:
        if e.name() == "engine.flood":
            (gpu if e.device_type() == torch.autograd.DeviceType.CUDA else cpu).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    cpu.sort()
    gpu.sort()
    offs, lead = [], []
    for i, (s, (a, b)) in enumerate(zip(sorted(floods, key=lambda s: s.t0), cpu)):
        offs += [(a - trace.to_trace_ns(s.t0)) / 1e6, (b - trace.to_trace_ns(s.t1)) / 1e6]
        lead.append((gpu[i][0] - trace.to_trace_ns(s.t0)) / 1e6 if i < len(gpu) else None)
    size = [abs(o) for o in offs]
    out = {"floods": len(floods), "events": len(cpu), "offsets_ms": offs,
           "median_abs_ms": float(np.median(size)) if size else None,
           "max_abs_ms": max(size) if size else None, "first_kernel_after_ms": lead,
           "first_kernel_after_start": all(x is not None and x >= 0 for x in lead)}
    if on_card and (len(cpu) != len(floods) or not size or max(size) > 1.0):
        raise AssertionError(f"flood spans against the profiler's events: {out}")
    return out


def _kv_bytes(kv) -> int:
    return sum(t.numel() * t.element_size()
               for t in kv.k + kv.v + list(getattr(kv, "k_d", [])) + list(getattr(kv, "v_d", [])))


# device-memory peaks taken before a phase resets the peak statistics, so
# that a main path's peak_mem_gb still covers the whole path
PEAKS_GB: list = []


def _timed_serve(eng, reqs) -> tuple[list, float, float]:
    """(streams, seconds, peak device GB) of a second run of `reqs` on `eng`
    (its graphs captured by a first run, whose streams must be the same)."""
    first = serve(eng, reqs, N_NEW)
    torch.cuda.synchronize()
    PEAKS_GB.append(torch.cuda.max_memory_allocated() / 1e9)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = serve(eng, reqs, N_NEW)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    if again != first:
        raise AssertionError("an engine's second run differs from its first")
    return again, sec, torch.cuda.max_memory_allocated() / 1e9


@torch.inference_mode()
def kv_variants_phase(device, cfg, params, prompts, long_prompt, streams) -> dict:
    """The 32-layer Q4_K file (kernel layout, bf16 compute) served on the
    other KV caches, each engine timed on its second run of the 8+1
    requests beside the dense engine's in this phase:
    - kv_quant: the streams equal generate(kv_quant=True) for the prompts
      prefilled on one route (as in `engine_vs_generate`); one replayed
      8-slot step launches K2 once per layer, on int8 K/V (the dtypes K2's
      wrapper saw while the graphs were captured); KV bytes against the
      dense cache's;
    - paged, paged_pages = half the dense pool: the streams equal the dense
      engine's (with kv_quant: the kv_quant engine's); tok/s, peak device
      memory and pool bytes;
    - window delta: one depth-8 window from the same 8-slot state run
      strictly and on the delta (teacher-forced with the strict tokens):
      each step's logits nmse, held to (n_layer · 2^-7)² — per layer the
      delta rounds P to bf16 (2^-9) and its output may round to the other
      bf16 neighbour (2^-8), added over the layers — and the greedy 8+1
      streams' agreement; scan windows timed strict and delta in turns."""
    out = {}
    reqs = prompts + [long_prompt]
    min_m = int(config.get("int8_min_m"))
    eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
    got, sec, peak = _timed_serve(eng, reqs)
    if got != streams:
        raise AssertionError("kv_variants: the dense engine's streams differ")
    n_tok = sum(map(len, got))
    out["dense"] = {"tok_s": n_tok / sec, "peak_gb": peak, "kv_bytes": _kv_bytes(eng.kv)}
    del eng
    gc.collect()

    seen = set()
    k2 = flash_attn.causal_flash_attention

    def k2_spy(q, k, v, *a, **kw):
        seen.add(str(k.dtype))
        return k2(q, k, v, *a, **kw)

    flash_attn.causal_flash_attention = k2_spy
    config.set("kv_quant", True)
    try:
        eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
        q_streams, sec, peak = _timed_serve(eng, reqs)
        assert eng.kv.k[0].dtype == torch.int8
        rec = {"tok_s": n_tok / sec, "peak_gb": peak, "kv_bytes": _kv_bytes(eng.kv),
               "k2_kv_dtypes": sorted(seen), "asserted": [], "recorded": {}}
        for p, g in zip(prompts, q_streams):
            ref = llama.generate(cfg, params, p, N_NEW, max_seq=1024, device=device,
                                 kv_quant=True)[len(p):]
            if len(p) >= min_m:
                rec["asserted"].append(len(p))
                if g != ref:
                    raise AssertionError(f"kv_quant engine differs from generate(kv_quant="
                                         f"True) for prompt length {len(p)}")
            else:
                rec["recorded"][len(p)] = first_divergence(g, ref)
        for p in prompts:                            # 8 active slots, then steady steps
            eng.submit(p, 64)
        while eng.queue or eng.pending is not None:
            eng.step()
        eng.step()
        before = launches()
        eng.step()
        rec["launches_per_replayed_step"] = _delta(before)
        if rec["launches_per_replayed_step"].get(kernels.K2.name) != cfg.n_layer \
                or "torch.int8" not in seen:
            raise AssertionError(f"kv_quant step: launches {rec['launches_per_replayed_step']},"
                                 f" K2 saw K/V {seen}")
        out["kv_quant"] = rec
    finally:
        flash_attn.causal_flash_attention = k2
        config.unset("kv_quant")
    del eng
    gc.collect()

    pages = 8 * 1024 // int(config.get("kv_page_size")) // 2
    for kvq, want in ((False, streams), (True, q_streams)):
        config.set("kv_quant", kvq)
        try:
            eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device,
                         paged_pages=pages)
            got, sec, peak = _timed_serve(eng, reqs)
        finally:
            config.unset("kv_quant")
        if got != want:
            raise AssertionError(f"paged engine (kv_quant={kvq}) differs from the dense one")
        out["paged_int8" if kvq else "paged"] = {
            "pages": pages, "tok_s": n_tok / sec, "peak_gb": peak, "kv_bytes": _kv_bytes(eng.kv)}
        del eng
        gc.collect()
    out["delta"] = delta_window_check(device, cfg, params, prompts, reqs, streams)
    torch.cuda.empty_cache()
    return out


def delta_window_check(device, cfg, params, prompts, reqs, streams) -> dict:
    """See kv_variants_phase: the delta window against the strict one."""
    from ggml_gfx906_tpu_torch.runtime.batched_kv import WindowDelta

    out = {}
    config.set("engine_window_delta", True)
    try:
        eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
        got = serve(eng, reqs, N_NEW)
    finally:
        config.unset("engine_window_delta")
    out["streams_equal"] = sum(g == s for g, s in zip(got, streams))
    out["first_divergence"] = {len(p): first_divergence(g, s)
                               for p, g, s in zip(reqs, got, streams) if g != s}
    for j, p in enumerate(prompts):
        eng.submit(p, 128, seed=j)
    while eng.queue or eng.pending is not None:
        eng.step()
    W = eng._window(int(eng.host_len.max()) + 8)
    with torch.inference_mode():
        base = eng.kv
        kv_s, kv_d = (BatchedKVCache([t[:, :, :W].clone() for t in base.k],
                                     [t[:, :, :W].clone() for t in base.v], [], [],
                                     base.lengths.clone()) for _ in range(2))
        tok = eng._tok.clone()
        strict, inputs = [], []
        for i in range(8):
            inputs.append(tok)
            lg, _ = llama.forward_batch(cfg, params, tok[:, None], kv_s, kv_s.lengths,
                                        attn_window=W)
            strict.append(lg[:, 0])
            tok = lg[:, 0].argmax(-1)
            kv_s.lengths.add_(1)
        len0 = kv_d.lengths.clone()
        d = WindowDelta.create(cfg.n_layer, 8, cfg.n_kv_head, 8, cfg.head_dim, device=device)
        nm = []
        for i in range(8):
            lg, d = llama.forward_batch(cfg, params, inputs[i][:, None], kv_d, len0 + i,
                                        attn_window=W, window_delta=(d, i, len0))
            nm.append(nmse(lg[:, 0], strict[i]))
    del kv_s, kv_d
    out["window"] = W
    out["logits_nmse_per_step"] = nm
    out["bound"] = (cfg.n_layer * 2.0 ** -7) ** 2
    if not max(nm) <= out["bound"]:
        raise AssertionError(f"delta window logits nmse {nm} above {out['bound']}")
    for key, delta in (("strict_window", False), ("delta_window", True)):
        config.set("engine_window_delta", delta)
        try:
            out[key] = scan_window(eng)
        finally:
            config.unset("engine_window_delta")
    del eng
    gc.collect()
    return out


def graph_stats(cache) -> dict | None:
    """Captures, capture seconds and pool bytes of a GraphCache."""
    if cache is None:
        return None
    return {"graphs": len(cache.graphs), "capture_s": cache.capture_s(),
            "pool_bytes": cache.pool_bytes(),
            "keys": [[str(x) for x in k[3:7]] for k in cache.graphs]}


SAMPLED = dict(temp=0.9, top_k=20, top_p=0.85)


def depth_checks(device, cfg, params, prompts, long_prompt, depth8) -> dict:
    """The Q4_K file's engine at engine_harvest_depth 1 against the default
    depth 8: the same 8+1 greedy requests give the same streams (`depth8`,
    served at the default), and a seeded temp > 0 request set gives the
    same streams at both depths (and not the greedy ones). Timed: the
    depth-1 run of the 8+1 requests, its graphs captured by a first run."""
    out = {}
    config.set("engine_harvest_depth", 1)
    try:
        eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
        if serve(eng, prompts + [long_prompt], N_NEW) != depth8:
            raise AssertionError("q4_k engine: depth-1 streams differ from depth 8")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(eng, prompts + [long_prompt], N_NEW)
        torch.cuda.synchronize()
        out["depth1_engine_s"] = time.perf_counter() - t0
        out["depth1_engine_tok_s"] = sum(len(o) for o in depth8) / out["depth1_engine_s"]
        sampled1 = serve(eng, prompts, 16, **SAMPLED)
    finally:
        config.unset("engine_harvest_depth")
    del eng
    gc.collect()
    eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
    sampled8 = serve(eng, prompts, 16, **SAMPLED)
    if sampled8 != sampled1:
        raise AssertionError("q4_k engine: sampled streams differ between depth 8 and 1")
    if sampled8 == [o[:16] for o in depth8[:len(prompts)]]:
        raise AssertionError("q4_k engine: the sampled streams are the greedy ones")
    out["sampled_streams_sha256"] = hashlib.sha256(json.dumps(sampled8).encode()).hexdigest()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def scan_window(eng, match: tuple = ()) -> dict:
    """Depth-8 scan windows of the steady-state 8-slot engine (no
    admission pending): one window captures its graph, three are timed on
    the host clock (dispatch and harvest, synchronised), one is traced
    (matched_ms: the device time of the kernels named by `match`)."""
    def window():
        d, aborted = eng._dispatch_window(8)
        assert aborted is None and len(d) == 1, "not a scan window"
        return eng._harvest(d)

    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = sum(window() for _ in range(3))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = {"window_ms": ms / 3, "host_ms_per_token": ms / tokens, "tokens": tokens,
           "trace": trace_device(window, match)}
    busy = out["trace"]["busy_ms"]
    out["trace"]["busy_share"] = None if busy is None else busy / out["window_ms"]
    out["graphs"] = graph_stats(eng.graphs)
    return out


def graphs_phase(device, cfg, params, n_layer: int, prompt, stream) -> dict:
    """Single-stream greedy decode of the 32-layer Q4_K file on CUDA graphs
    (llama.decode_chunk / decode_scan / decode_step), after an eager
    prefill of `prompt` into one cache: `decode_chunk` (the one-step graph
    replayed) and `decode_scan` (one graph of N_NEW - 1 steps) give the
    eager stream `stream`, each timed on a second run (its graph already
    captured) beside the eager decode loop in the same phase; one replayed
    step's logits are torch.equal to the eager `forward` step's at the same
    cache state, and its launches are what the tensor types predict; one
    replayed step is traced. Then the same under qmm_pipeline="on" (K10
    captured): decode_chunk's stream equals the eager generate's under the
    flag. Launch counts are set to 0 before and read after."""
    out = {"layers": n_layer}
    n = N_NEW - 1
    start = len(prompt)
    want = stream[start + 1:]
    kv = llama.make_cache(cfg, 1024, device=device)
    toks = torch.tensor(prompt, device=device)

    def prefill():
        kv.length = 0
        logits, _ = llama.forward(cfg, params, toks, kv, 0)
        return torch.stack([logits[-1].argmax().to(torch.int32),
                            torch.tensor(start, dtype=torch.int32, device=device)])

    def timed(fn) -> tuple:
        carry = prefill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(carry)
        torch.cuda.synchronize()
        return got.tolist(), time.perf_counter() - t0

    kernels.reset_launches()
    chunk = lambda c: llama.decode_chunk(cfg, params, kv, c, n)[0]     # noqa: E731
    scan = lambda c: llama.decode_scan(cfg, params, kv, c[0], c[1], n)[0]   # noqa: E731
    for name, fn in (("decode_chunk", chunk), ("decode_scan", scan)):
        first, out[f"{name}_first_s"] = timed(fn)       # with its capture
        got, sec = timed(fn)
        if first != want or got != want:
            raise AssertionError(f"q4_k {name}: stream differs from the eager generate's")
        out[f"{name}_ms_per_step"] = sec / n * 1e3
        out[f"{name}_tok_s"] = n / sec
    # the eager loop in the same phase, as main_path times it
    prefill()
    tok = stream[start]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        lg, _ = llama.forward(cfg, params, torch.tensor([tok], device=device), kv, start + i)
        tok = int(lg[-1].argmax())
    torch.cuda.synchronize()
    out["eager_ms_per_step"] = (time.perf_counter() - t0) / n * 1e3
    out["eager_tok_s"] = 1e3 / out["eager_ms_per_step"]
    # one replayed step against the eager step at the same cache state
    tok = torch.tensor([stream[-2]], device=device)
    pos = len(stream) - 2
    before = launches()
    llama.decode_step(cfg, params, tok, kv, pos)
    out["launches_per_replayed_step"] = _delta(before)
    want_step = expected_launches("q4_k", n_layer, 1)
    if out["launches_per_replayed_step"] != want_step:
        raise AssertionError(f"q4_k replayed step: launches {out['launches_per_replayed_step']}, "
                             f"its tensor types predict {want_step}")
    replayed = llama.step_graph(cfg, params, kv).outputs[1].clone()
    eager, _ = llama.forward(cfg, params, tok, kv, pos)
    if not torch.equal(replayed, eager[-1:]):
        raise AssertionError(f"q4_k replayed step: logits differ from the eager step's "
                             f"(max abs {float((replayed - eager[-1:]).abs().max())})")
    out["replayed_logits_equal_eager"] = True
    out["replayed_step_trace"] = trace_device(lambda: llama.decode_step(cfg, params, tok, kv, pos))
    busy = out["replayed_step_trace"]["busy_ms"]
    out["replayed_step_trace"]["busy_share"] = (None if busy is None
                                                else busy / out["decode_chunk_ms_per_step"])
    # K10 captured: qmm_pipeline="on"
    config.set("qmm_pipeline", "on")
    try:
        ref = llama.generate(cfg, params, prompt, N_NEW, max_seq=1024, device=device)
        got, sec = timed(chunk)
        got, sec = timed(chunk)
        before = launches()
        llama.decode_step(cfg, params, tok, kv, pos)
        out["pipeline_launches_per_replayed_step"] = _delta(before)
        want_step = expected_launches("q4_k", n_layer, 1)
    finally:
        config.unset("qmm_pipeline")
    if got != ref[start + 1:]:
        raise AssertionError("q4_k decode_chunk under qmm_pipeline=on: stream differs from "
                             "the eager generate's under the flag")
    if out["pipeline_launches_per_replayed_step"] != want_step:
        raise AssertionError(f"q4_k replayed step under qmm_pipeline=on: launches "
                             f"{out['pipeline_launches_per_replayed_step']}, predicted {want_step}")
    out["pipeline_decode_chunk_tok_s"] = n / sec
    out["graphs"] = graph_stats(kv.graphs.graphs)
    out["launches"] = launches()
    return out


SPEC_KS = (8, 7)       # the reference's default k (verify at M = 9) and M = 8
SPEC_NEW = 128
SPEC_SEQ = 1024
PPL_TOKENS, PPL_CTX = 2048, 512
SERVE_WORDS = PARITY_LENS + (300,)     # the CLI's serve prompts: the 8+1 requests as text


def spec_prompts(n_vocab: int, tok) -> dict:
    """The two prompts of the speculative runs, encoded from text: an
    8-word phrase repeated to ~100 tokens, and ~100 words that do not
    repeat."""
    phrase = synthetic_text(8, 21, n_vocab)
    return {"repetitive": tok.encode(" ".join([phrase] * 12)),
            "plain": tok.encode(synthetic_text(100, 22, n_vocab))}


def ppl_window_count(n: int, n_ctx: int, warmup: int) -> int:
    """The predictions perplexity_stream counts for n tokens: each window's
    targets, less the warm-up after the first window."""
    return sum(max(0, min(n_ctx, n - 1 - s) - (warmup if s else 0))
               for s in range(0, n - 1, n_ctx))


def ppl_reference_nll(cfg, params, ids, n_ctx: int, device) -> float:
    """The mean nll of perplexity_stream's windows from `llama.forward`
    logits (a fresh cache per window), summed in float64 on the host."""
    ids = np.asarray(ids, np.int64)
    total, n = 0.0, 0
    for s in range(0, len(ids) - 1, n_ctx):
        win = ids[s:s + n_ctx + 1]
        inp, tgt = win[:-1], win[1:]
        logits, _ = llama.forward(cfg, params,
                                  torch.from_numpy(np.pad(inp, (0, n_ctx - len(inp)))).to(device),
                                  llama.make_cache(cfg, n_ctx, device=device), 0)
        lp = torch.log_softmax(logits.double(), -1).cpu().numpy()
        first = 0 if s == 0 else n_ctx // 4
        total += -sum(lp[i, tgt[i]] for i in range(first, len(tgt)))
        n += max(0, len(tgt) - first)
    return total / n


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    return got, time.perf_counter() - t0


def verify_step(device, cfg, params, n_layer: int, ids, k: int) -> dict:
    """One replayed spec step (prompt lookup + the verify forward at M =
    k+1 from the device position + accept + append) after a prefill of
    `ids`: its launches against the tensor types' prediction at m = k+1,
    its time over 7 more replays (chained on the device), and one replay
    traced."""
    kv, g, b, _ = speculative._prefilled(cfg, params, ids, k, SPEC_SEQ, 8, device)
    b["i"].zero_()
    before = launches()
    g.replay()
    out = {"launches": _delta(before)}
    want = expected_launches("q4_k", n_layer, k + 1)
    if out["launches"] != want:
        raise AssertionError(f"verify step k={k}: launches {out['launches']}, its tensor types "
                             f"predict {want}")
    b["i"].zero_()
    _, sec = _timed(lambda: [g.replay() for _ in range(7)])
    out["step_ms"] = sec / 7 * 1e3
    b["i"].zero_()
    out["trace"] = trace_device(g.replay)
    busy = out["trace"]["busy_ms"]
    out["trace"]["busy_share"] = None if busy is None else busy / out["step_ms"]
    return out


def _cli(argv) -> tuple[str, str, str]:
    """(stdout, stderr, the tok/s line) of one in-process CLI command."""
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = cli.main(argv)
    gc.collect()
    torch.cuda.empty_cache()
    if rc != 0:
        raise AssertionError(f"cli {argv}: exit {rc}: {e.getvalue()[-2000:]}")
    rate = [ln for ln in e.getvalue().splitlines() if "tok/s" in ln]
    return o.getvalue(), e.getvalue(), rate[-1] if rate else ""


def cli_phase(device, cfg, params, path: Path, tok) -> dict:
    """The CLI in-process on the GGUF (f32 compute, as it loads): greedy
    generate's ids equal `generate`'s on tok.encode(TEXT); --spec 8 prints
    the greedy run's stdout; a seeded sampled run prints; `serve` of the
    8+1 prompts as text at --max-batch 8 gives one completion per prompt,
    each equal to a direct Engine run of the same ids and settings."""
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    text = synthetic_text(24, 24, cfg.n_vocab)
    ids = tok.encode(text)
    out = {"prompt_tokens": len(ids)}
    dev = ["--device", device.type]
    base = ["-m", str(path), "-p", text, "-n", str(N_NEW)] + dev
    g_out, g_err, out["greedy_rate"] = _cli(base + ["--greedy"])
    ref = llama.generate(cfg32, params, ids, N_NEW, device=device)
    if f"prompt tokens: {ids}" not in g_err or g_out != tok.decode(ref) + "\n":
        raise AssertionError("cli --greedy: its ids differ from generate's on the encoded text")
    s_out, _, out["spec_rate"] = _cli(base + ["--spec", "8"])
    if s_out != g_out:
        raise AssertionError("cli --spec 8: stdout differs from the greedy run's")
    r_out, _, out["sampled_rate"] = _cli(base + ["-s", "1", "--temp", "0.8"])
    if not r_out.strip():
        raise AssertionError("cli -s 1 --temp 0.8 printed nothing")
    out["sampled_differs_from_greedy"] = r_out != g_out
    lines = [synthetic_text(n, 30 + n, cfg.n_vocab) for n in SERVE_WORDS]
    pfile = path.with_name("smoke_prompts.txt")
    pfile.write_text("\n".join(lines) + "\n")
    v_out, _, out["serve_rate"] = _cli(["serve", "-m", str(path), "--prompts", str(pfile),
                                        "-n", str(N_NEW), "--max-batch", "8",
                                        "--max-seq", str(SPEC_SEQ)] + dev)
    pfile.unlink()
    served = {int(ln[1:ln.index("]")]): ln[ln.index("]") + 2:] for ln in v_out.splitlines()}
    eng = Engine(llama, cfg32, params, max_batch=8, max_seq=SPEC_SEQ, device=device)
    rids = [eng.submit(tok.encode(ln), N_NEW, eos_id=tok.eos_id, top_k=40, top_p=0.9, seed=i)
            for i, ln in enumerate(lines)]
    direct = {r.rid: tok.decode(r.out) for r in eng.run()}
    del eng
    gc.collect()
    if sorted(served) != list(range(len(lines))) or any(served[i] != direct[r]
                                                       for i, r in enumerate(rids)):
        raise AssertionError("cli serve: completions differ from a direct Engine run")
    out["serve_requests"] = len(served)
    return out


@torch.inference_mode()
def tools_phase(device, cfg, params, n_layer: int, path: Path) -> dict:
    """Text from the GGUF file alone on the 32-layer Q4_K file: the
    tokenizer from its metadata; speculative decoding by prompt lookup at
    k = 8 and 7 on a repetitive and a plain prompt (SPEC_NEW tokens each,
    streams == generate's greedy stream, accept rates, tok/s beside
    decode_chunk's, the replayed verify step's launches, time and trace),
    with a 4-layer layer-skip draft at k = 4 and with the full model as its
    own draft (its first step accepts all k); perplexity over
    PPL_TOKENS tokens at n_ctx PPL_CTX (n_tokens by the window rule, nll
    against llama.forward's logits in float64); the CLI in-process.
    Launch counts are set to 0 before and read after."""
    kernels.reset_launches()
    t0 = time.perf_counter()
    tok = tokenizer.from_gguf(GGUFReader(path))
    if tok is None or tok.n_vocab != cfg.n_vocab:
        raise AssertionError("the GGUF's tokenizer is missing or not n_vocab tokens")
    out = {"spec": {}, "verify_step": {}}
    prompts = spec_prompts(cfg.n_vocab, tok)
    refs = {}
    for name, ids in prompts.items():
        ref = refs[name] = llama.generate(cfg, params, ids, SPEC_NEW, max_seq=SPEC_SEQ,
                                          device=device)
        row = {"prompt_tokens": len(ids)}

        def chunk():
            kv = llama.make_cache(cfg, SPEC_SEQ, device=device)
            logits, kv = llama.forward(cfg, params, torch.tensor(ids, device=device), kv, 0)
            first = logits[-1].argmax().reshape(1)
            toks, _, _ = llama.decode_chunk(cfg, params, kv, [first, len(ids)], SPEC_NEW - 1)
            return ids + torch.cat([first, toks.to(first.dtype)]).tolist()

        got, sec = _timed(chunk)       # a fresh cache and its capture, as spec_generate's
        if got != ref:
            raise AssertionError(f"decode_chunk on {name}: stream differs from generate's")
        row["decode_chunk_tok_s"] = SPEC_NEW / sec
        for k in SPEC_KS:
            (got, stats), sec = _timed(lambda: speculative.spec_generate(
                cfg, params, ids, SPEC_NEW, k=k, max_seq=SPEC_SEQ, return_stats=True,
                device=device))
            if got != ref:
                raise AssertionError(f"spec k={k} on {name}: stream differs from greedy at "
                                     f"{first_divergence(got, ref)}")
            row[f"k{k}"] = {"accept_rate": stats["accept_rate"],
                            "tokens_per_verify": stats["tokens_per_step"],
                            "spec_steps": stats["spec_steps"], "tok_s": SPEC_NEW / sec}
        (got, stats), sec = _timed(lambda: speculative.model_spec_generate(
            cfg, params, ids, SPEC_NEW, draft_layers=4, k=4, max_seq=SPEC_SEQ,
            return_stats=True, device=device))
        if got != ref:
            raise AssertionError(f"4-layer draft on {name}: stream differs from greedy at "
                                 f"{first_divergence(got, ref)}")
        row["draft4_k4"] = {"accept_rate": stats["accept_rate"],
                            "spec_steps": stats["spec_steps"], "tok_s": SPEC_NEW / sec}
        out["spec"][name] = row
        gc.collect()
    # the full model as its own draft: its first step accepts all k (the
    # verify's m == k branch on the card); after a full accept the draft's
    # cache lacks the row of its last proposal, which the reference's
    # model_spec_step never feeds, so later steps accept less
    ids = prompts["plain"]
    (got, stats), sec = _timed(lambda: speculative.model_spec_generate(
        cfg, params, ids, N_NEW, draft=(cfg, params), k=4, max_seq=SPEC_SEQ,
        return_stats=True, device=device))
    if got != refs["plain"][:len(ids) + N_NEW] or stats["accepted_per_step"][0] != 4:
        raise AssertionError(f"self-draft: stream differs or its first step rejected ({stats})")
    out["self_draft_k4"] = {"accepted_per_step": stats["accepted_per_step"],
                            "accept_rate": stats["accept_rate"], "tok_s": N_NEW / sec}
    # the replayed decode step in the same phase, for the verify's cost in steps
    kv = llama.make_cache(cfg, SPEC_SEQ, device=device)
    llama.forward(cfg, params, torch.tensor(ids, device=device), kv, 0)
    llama.decode_chunk(cfg, params, kv, [1, len(ids)], 1)
    _, sec = _timed(lambda: llama.decode_chunk(cfg, params, kv, [1, len(ids)], 16))
    out["decode_step_ms"] = sec / 16 * 1e3
    del kv
    for k in SPEC_KS:
        vs = out["verify_step"][f"k{k}"] = verify_step(device, cfg, params, n_layer, ids, k)
        # a verify's cost in decode steps: the tokens per verify where lookup breaks even
        vs["decode_steps"] = vs["step_ms"] / out["decode_step_ms"]
        vs["tok_s_all_accepted"] = (k + 1) / vs["step_ms"] * 1e3
    gc.collect()
    # perplexity
    ids = tok.encode(synthetic_text(2 * PPL_TOKENS, 23, cfg.n_vocab))[:PPL_TOKENS]
    res, sec = _timed(lambda: perplexity.perplexity_llama(cfg, params, ids, n_ctx=PPL_CTX,
                                                          device=device))
    want_n = ppl_window_count(len(ids), PPL_CTX, PPL_CTX // 4)
    if res["n_tokens"] != want_n:
        raise AssertionError(f"perplexity: n_tokens {res['n_tokens']}, the window rule {want_n}")
    ref_nll = ppl_reference_nll(cfg, params, ids, PPL_CTX, device)
    rel = abs(res["nll"] - ref_nll) / abs(ref_nll)
    if not rel < 1e-5:
        raise AssertionError(f"perplexity: nll {res['nll']} vs {ref_nll} from llama.forward "
                             f"(relative {rel:.3e})")
    windows = len(range(0, len(ids) - 1, PPL_CTX))
    out["perplexity"] = dict(res, tokens=len(ids), windows=windows, seconds=sec,
                             tokens_per_s=windows * PPL_CTX / sec, nll_rel_vs_forward=rel)
    gc.collect()
    out["cli"] = cli_phase(device, cfg, params, path, tok)
    out["launches"] = launches()
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------ quantize

# the files the quantize phase writes from one F16 file: (name, type, with
# the imatrix); llama.cpp's Q4_K north-star file, Q8_0, IQ4_XS and IQ2_XXS
# (the last two in the int8 layout)
QUANT_FILES = (("q4_k", GGMLType.Q4_K, True), ("q8_0", GGMLType.Q8_0, False),
               ("iq4_xs", GGMLType.IQ4_XS, True), ("iq2_xxs", GGMLType.IQ2_XXS, True))
QUANT_CALIB = 2            # calibration chunks of QUANT_CHUNK tokens for the imatrix
QUANT_CHUNK = 512
QUANT_ROWS = 256           # rows of each sampled matrix quantized again on the CPU
# a quarter of them for the grid searches, whose plain versions take ~2 s
# per 1024 super-blocks on the CPU: 64 rows of the IQ2_XXS file
QUANT_ROWS_DIV = {GGMLType.IQ2_XXS: 4}
QUANT_TYPE_ROWS = 64       # rows of the per-type card-vs-CPU codec checks
QUANT_RATE_ROWS = 4096     # rows of the per-type timing on the card (64 MB of f32 at 4096)
QUANT_SAMPLED = ("blk.0.attn_q.weight", "blk.0.ffn_gate.weight", "blk.0.ffn_down.weight",
                 "output.weight", "token_embd.weight")


def hf_state(cfg: dict, n_layer: int, device, seed: int = 16) -> dict:
    """A Hugging Face LlamaForCausalLM state dict of cfg's width, random
    from a seeded generator on `device` (matrices ~N(0, 0.02), norm weights
    1 + N(0, 0.1)), with its own lm_head."""
    gen = torch.Generator(device=device).manual_seed(seed)
    D, FF, V = cfg["n_embd"], cfg["n_ff"], cfg["n_vocab"]
    KVD = cfg["n_kv_head"] * (D // cfg["n_head"])

    def mat(r, c):
        return torch.randn(r, c, generator=gen, device=device) * 0.02

    def norm():
        return 1 + 0.1 * torch.randn(D, generator=gen, device=device)

    sd = {"model.embed_tokens.weight": mat(V, D), "model.norm.weight": norm(),
          "lm_head.weight": mat(V, D)}
    for i in range(n_layer):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": norm(),
                   p + "post_attention_layernorm.weight": norm(),
                   p + "self_attn.q_proj.weight": mat(D, D),
                   p + "self_attn.k_proj.weight": mat(KVD, D),
                   p + "self_attn.v_proj.weight": mat(KVD, D),
                   p + "self_attn.o_proj.weight": mat(D, D),
                   p + "mlp.gate_proj.weight": mat(FF, D),
                   p + "mlp.up_proj.weight": mat(FF, D),
                   p + "mlp.down_proj.weight": mat(D, FF)})
    return sd


def codec_rows(rng, rows: int, width: int) -> np.ndarray:
    """rows x width f32 for the per-type checks: Gaussian rows of three
    scales, rows with all-zero blocks, rows with one outlier per 32-block,
    and rows of 32-blocks whose absmax sits at MXFP4's exponent edges
    (2^k(1 - 2^-24), 2^k, 2^k(1 + 2^-23), -40 <= k <= 12)."""
    q = rows // 8
    g = rng.standard_normal((rows - 3 * q, width)).astype(np.float32)
    g *= np.float32([1.0, 1e-3, 30.0])[np.arange(len(g)) % 3][:, None]
    zero = rng.standard_normal((q, width)).astype(np.float32)
    zero.reshape(q, -1, 32)[:, ::3] = 0
    outl = (0.01 * rng.standard_normal((q, width))).astype(np.float32)
    outl.reshape(q, -1, 32)[:, :, 7] = 5.0
    # k up to 12: larger blocks overflow the f16 scales of the other types,
    # whose inf and NaN bits are the hardware's own
    amax = np.array([np.float32(np.ldexp(f, k)) for k in range(-40, 13)
                     for f in (1 - 2.0 ** -24, 1.0, 1 + 2.0 ** -23)], np.float32)
    edge = (0.001 * rng.standard_normal((q, width))).astype(np.float32)
    eb = edge.reshape(-1, 32)
    eb[:, 3] = np.resize(amax, len(eb))
    return np.concatenate([g, zero, outl, edge])


def _random_wire(qtype, rng, rows: int, width: int) -> np.ndarray:
    """Random wire blocks of `qtype` with finite f16 scales, (rows, bytes)."""
    from ggml_gfx906_tpu_torch.quant.types import TYPE_TRAITS

    dt = TYPE_TRAITS[qtype].block_dtype
    nb = width // TYPE_TRAITS[qtype].blck_size
    b = rng.integers(0, 256, (rows, nb * dt.itemsize), dtype=np.uint8).view(dt)
    for f in ("d", "dmin", "m"):
        if f in dt.names:
            b[f] = rng.uniform(-0.05, 0.05, b.shape).astype(dt[f].base)
    if qtype == GGMLType.IQ1_M:
        b["scales"][..., 7] &= 0xBF          # the f16 scale's top exponent bit: finite
    return b.view(np.uint8).reshape(rows, -1)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def codec_checks(device, width: int) -> dict:
    """Every type the registry quantizes, on QUANT_TYPE_ROWS x width rows
    (codec_rows) on the card and on the CPU, without an importance row
    where the type takes none (supported_quant_types) and with one where it
    takes or ignores one: the wire bytes must be equal, and so must every
    dequantizer's bits. Each type's rate on the card: f32 input GB/s of
    one call on QUANT_RATE_ROWS x width Gaussian rows."""
    rng = np.random.default_rng(19)
    x = torch.from_numpy(codec_rows(rng, QUANT_TYPE_ROWS, width))
    qw = torch.from_numpy(rng.uniform(0.05, 3.0, width).astype(np.float32))
    xd, qwd = x.to(device), qw.to(device)
    big = torch.randn(QUANT_RATE_ROWS, width, generator=torch.Generator(device=device)
                      .manual_seed(20), device=device)
    out = {}
    plain = set(registry.supported_quant_types())
    for t in sorted(plain | set(registry._QUANTIZE_IMATRIX)):
        for weighted in (False, True):
            if not weighted and t not in plain:
                continue
            if weighted and t not in registry._QUANTIZE_IMATRIX \
                    and t not in registry._IMATRIX_IGNORED:
                continue
            card = registry.quantize(t, xd, qwd if weighted else None)
            t0 = time.perf_counter()
            cpu = registry.quantize(t, x, qw if weighted else None)
            cpu_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            registry.quantize(t, big, qwd if weighted else None)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            key = t.name + ("+imatrix" if weighted else "")
            if card.device.type != device.type or not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"{key}: the card's bytes differ from the CPU's")
            if not _bits_equal(registry.dequantize(t, card, width),
                               registry.dequantize(t, cpu, width)):
                raise AssertionError(f"{key}: dequantization differs between card and CPU")
            out[key] = {"rate_s": sec, "gb_per_s": big.numel() * 4 / sec / 1e9,
                        "cpu_s": cpu_s}
    return out


IQ_SEARCH_ROWS = 8          # codec_rows x 4096 per type, held card vs the CPU's plain version
IQ_SEARCH_RATE = 4096       # rows of 4096 of the timed call (64 MiB of f32)
# the row of each search kernel in the kernels line, whose plain version is timed
IQ_REP = {"iq3_search": "IQ3_XXS", "iq2_search": "IQ2_XXS+imatrix",
          "iq1_search": "IQ1_S+imatrix"}


def check_iq_search(device, timer, results):
    """S1-S3, the IQ grid searches: every type, with and without an
    importance row (with one only where the type requires it), on
    IQ_SEARCH_ROWS x 4096 codec_rows and an importance row with zeros: the
    kernel's bytes equal the plain version's on the CPU copy, and so do
    their dequantized bits; one launch each. Each type timed at
    IQ_SEARCH_RATE x 4096 Gaussian rows (ms, f32 GB/s; bound: f32 in and
    wire bytes out over the card's memory rate), the plain version on the
    card for each kernel's IQ_REP type (one call, host clock). Then the six
    lattice tables rebuilt on the card (iquants.build_machinery) against
    the shipped files."""
    from ggml_gfx906_tpu_torch.ops.cuda import iq_search
    from ggml_gfx906_tpu_torch.quant import iquants

    rng = np.random.default_rng(18)
    width = 4096
    x = torch.from_numpy(codec_rows(rng, IQ_SEARCH_ROWS, width))
    qw = torch.from_numpy(rng.uniform(0.05, 3.0, width).astype(np.float32))
    qw[::13] = 0
    xd, qwd = x.to(device), qw.to(device)
    big = torch.randn(IQ_SEARCH_RATE, width, generator=torch.Generator(device=device)
                      .manual_seed(21), device=device)
    for t, (kern, _, _, _, _) in iq_search.ROUTES.items():
        for weighted in (False, True):
            if not weighted and t in iq_search.IMATRIX_REQUIRED:
                continue
            key = t.name + ("+imatrix" if weighted else "")
            w, wd = (qw, qwd) if weighted else (None, None)
            before = kern.launches
            t0 = time.perf_counter()
            card = iq_search.quantize(t, xd, wd)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            if kern.launches != before + 1:
                raise AssertionError(f"{key}: {kern.name} launched {kern.launches - before} times")
            cpu = iq_search.quantize_plain(t, x, w)
            if not torch.equal(card.cpu(), cpu):
                bad = torch.nonzero((card.cpu() != cpu).any(1))[:, 0].tolist()
                raise AssertionError(f"{key}: {kern.name}'s bytes differ from the plain "
                                     f"version's in rows {bad}")
            deq_card = registry.dequantize(t, card, width)
            deq_cpu = registry.dequantize(t, cpu, width)
            if not _bits_equal(deq_card, deq_cpu):
                raise AssertionError(f"{key}: dequantization differs between card and CPU")
            ms = timer(lambda: iq_search.quantize(t, big, wd), iters=3, warmup=1)
            out_bytes = big.shape[0] * TYPE_TRAITS[t].type_size * width // 256
            b, by = bound(big.numel() * 4 + out_bytes + (width * 4 if weighted else 0), 0.0,
                          "f32")
            row = dict(kernel=kern.name, shape=f"{key} {IQ_SEARCH_RATE}x{width}", nmse=0.0,
                       max_abs_err=float((deq_card.cpu() - deq_cpu).abs().max()), ms=ms,
                       gb_per_s=big.numel() * 4 / ms / 1e6, bound_ms=b, bound_by=by,
                       library_ms=None, plain_ms=None, first_call_s=first_s,
                       rows_equal=IQ_SEARCH_ROWS)
            if IQ_REP[kern.name] == key:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                iq_search.quantize_plain(t, big, wd)
                torch.cuda.synchronize()
                row["plain_ms"] = (time.perf_counter() - t0) * 1e3
            results.append(row)
            log(f"{kern.name} {key}: {IQ_SEARCH_ROWS}x{width} rows == plain version, "
                f"{IQ_SEARCH_RATE}x{width} in {ms:.3f} ms ({row['gb_per_s']:.3f} GB/s of f32; "
                f"bound {b:.4f} ms; plain {row['plain_ms']} ms)")
    tables = {}
    for kind in iquants.MACHINERY_KINDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built = iquants.build_machinery(kind, device)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        shipped = iquants.machinery(kind, torch.device("cpu"))
        for f in ("grid", "kmap", "neigh"):
            if not torch.equal(getattr(built, f).cpu(), getattr(shipped, f)):
                raise AssertionError(f"machinery {kind}: the rebuilt {f} differs from the file")
        tables[kind] = {"build_s": sec, "neigh": int(built.neigh.numel())}
    log(f"lattice tables rebuilt on the card == the shipped files: {tables}")
    return {"machinery": tables}


def rows_vs_cpu(f16: Path, dst: Path, qtype, im) -> dict:
    """QUANT_ROWS (/ QUANT_ROWS_DIV) rows of each QUANT_SAMPLED matrix of the F16 file,
    quantized again on the CPU (with the file's importance row), against the
    rows of `dst` that the card wrote: equal bytes, or the phase fails."""
    src, got = GGUFReader(f16), GGUFReader(dst)
    rng = np.random.default_rng(17)
    out = {}
    for name in QUANT_SAMPLED:
        n_rows = src.tensors[name].shape[0]
        want = QUANT_ROWS // QUANT_ROWS_DIV.get(qtype, 1)
        idx = np.sort(rng.choice(n_rows, min(want, n_rows), replace=False))
        x = torch.from_numpy(src.tensor_array(name)[idx].astype(np.float32))
        qw = None if im is None else torch.from_numpy(im[name])
        cpu = registry.quantize(qtype, x, qw).numpy()
        card = np.asarray(got.tensor_bytes(name)).reshape(n_rows, -1)[idx]
        if not np.array_equal(cpu, card):
            raise AssertionError(f"{dst.name} {name}: the card's rows differ from the CPU's")
        out[name] = len(idx)
    return out


def search_launches(cfg: dict, n_layer: int, qtype) -> dict:
    """The search kernel's launches that quantizing every matrix of a
    cfg-width llama file to qtype takes: one per chunk of rows
    (registry._CHUNK elements); none for a type without a search."""
    from ggml_gfx906_tpu_torch.ops.cuda import iq_search

    if qtype not in iq_search.ROUTES:
        return {}
    n = sum(-(-rows // max(1, registry._CHUNK // cols))
            for _, _, rows, cols in _matrices(cfg, n_layer))
    return {iq_search.ROUTES[qtype][0].name: n}


def load_and_generate(device, path: Path, qtype, n_layer: int, prompt):
    """Load a quantized file (its load seconds and peak memory), generate
    N_NEW greedy tokens after `prompt` at bf16 compute, and hold the
    launches to what the file's types predict (the prefill at M =
    len(prompt), N_NEW - 1 decode steps; K2 only in the int8 layout).
    Returns (the numbers, cfg, params)."""
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, params = llama.load(path, device=device)
    torch.cuda.synchronize()
    out = {"load_s": time.perf_counter() - t0,
           "load_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    quant = [t for t in _leaves(params) if isinstance(t, QuantTensor)]
    out["layouts"] = sorted({t.layout for t in quant})
    layout = "int8" if qtype not in dispatch.KERNEL_TYPES else "kernel"
    if out["layouts"] != [layout] or {t.qtype for t in quant} != {qtype}:
        raise AssertionError(f"{path.name}: matrices {out['layouts']}, expected {qtype.name} "
                             f"in the {layout} layout")
    out["weights_gb"] = sum(t.nbytes for t in quant) / 1e9
    types = lambda name, layer, n: qtype                                   # noqa: E731
    want = {}
    for m, times in ((len(prompt), 1), (1, N_NEW - 1)):
        for k, v in expected_launches(types, n_layer, m, layout).items():
            want[k] = want.get(k, 0) + v * times
    before = launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stream = llama.generate(cfg, params, prompt, N_NEW, max_seq=1024, device=device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    got = _delta(before)
    if got != want:
        raise AssertionError(f"{path.name}: launches {got}, its tensor types predict {want}")
    out.update(generate_s=gen_s, tok_s=N_NEW / gen_s, launches=got,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               stream_sha256=hashlib.sha256(json.dumps(stream).encode()).hexdigest())
    return out, cfg, params


@torch.inference_mode()
def quantize_phase(device, cfg: dict, n_layer: int) -> dict:
    """The codecs and the quantize tools on the card at cfg's width:
    convert a seeded random state dict to an F16 GGUF (with the synthetic
    SentencePiece vocabulary), collect an imatrix over QUANT_CALIB chunks of
    synthetic_text (dense torch.matmul products, K2), quantize the file on
    the card to each of QUANT_FILES (seconds, GB/s), hold sampled rows of
    each against the CPU codec (rows_vs_cpu), load and generate from each
    (load_and_generate: K1 and K3 on Q4_K, K5 and K5-i8 on Q8_0, K2 alone
    on IQ4_XS and IQ2_XXS in the int8 layout; S2 quantized the IQ2_XXS
    file), hold the Q4_K file's fields against
    QuantTensor.quantize on the card, and every codec card vs CPU
    (codec_checks). Files are deleted once used. Launch counts are set to 0
    before and read after."""
    kernels.reset_launches()
    t_phase = time.perf_counter()
    work = ROOT / "build"
    work.mkdir(parents=True, exist_ok=True)
    out = {"layers": n_layer, "files": {}}
    f16 = work / f"smoke_llama7b_f16_L{n_layer}.gguf"
    hf_cfg = SimpleNamespace(
        vocab_size=cfg["n_vocab"], max_position_embeddings=cfg["n_ctx"],
        hidden_size=cfg["n_embd"], num_hidden_layers=n_layer, intermediate_size=cfg["n_ff"],
        num_attention_heads=cfg["n_head"], num_key_value_heads=cfg["n_kv_head"],
        rms_norm_eps=1e-5, rope_theta=10000.0)
    tokens, scores, types = spm_vocab(cfg["n_vocab"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = hf_state(cfg, n_layer, device)
    convert.convert_llama(sd, hf_cfg, f16, ftype=GGMLType.F16, tokens=list(tokens),
                          scores=list(scores), token_types=list(types))
    out["convert_s"] = time.perf_counter() - t0
    out["f16_gb"] = f16.stat().st_size / 1e9
    log(f"quantize phase: F16 file {out['f16_gb']:.2f} GB in {out['convert_s']:.1f} s")
    del sd
    gc.collect()
    torch.cuda.empty_cache()

    # the imatrix over calibration text, on the F16 model's dense products
    t0 = time.perf_counter()
    fcfg, fparams = llama.load(f16, device=device)
    torch.cuda.synchronize()
    out["f16_load_s"] = time.perf_counter() - t0
    tok = tokenizer.from_gguf(GGUFReader(f16))
    ids = tok.encode(synthetic_text(QUANT_CALIB * QUANT_CHUNK, 31, cfg["n_vocab"]))
    chunks = [ids[i * QUANT_CHUNK:(i + 1) * QUANT_CHUNK] for i in range(QUANT_CALIB)]
    assert all(len(c) == QUANT_CHUNK for c in chunks)
    before = launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    im = imatrix.collect_llama(fcfg, fparams, chunks, max_seq=QUANT_CHUNK, device=device)
    torch.cuda.synchronize()
    out["imatrix_s"] = time.perf_counter() - t0
    out["imatrix_launches"] = _delta(before)
    if (len(im) != 7 * n_layer + 2 or out["imatrix_launches"] != {
            kernels.K2.name: n_layer * QUANT_CALIB}
            or not all(np.isfinite(v).all() and (v > 0).all() for v in im.values())):
        raise AssertionError(f"imatrix: {len(im)} entries, launches "
                             f"{out['imatrix_launches']}")
    del fparams
    gc.collect()
    torch.cuda.empty_cache()

    prompt = [int(t) for t in np.random.default_rng(5).integers(1, cfg["n_vocab"], 100)]
    for name, qtype, use_im in QUANT_FILES:
        dst = work / f"smoke_llama7b_{name}_L{n_layer}.gguf"
        torch.cuda.synchronize()
        before = launches()
        t0 = time.perf_counter()
        b_in, b_out = quantize_cli.quantize_gguf(f16, dst, qtype, verbose=False,
                                                 imatrix=im if use_im else None, device=device)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        row = {"type": qtype.name, "imatrix": use_im, "quantize_s": sec,
               "gb_in": b_in / 1e9, "gb_out": b_out / 1e9, "gb_per_s": b_in / sec / 1e9,
               "file_gb": dst.stat().st_size / 1e9, "quantize_launches": _delta(before)}
        want = search_launches(cfg, n_layer, qtype)
        if row["quantize_launches"] != want:
            raise AssertionError(f"{name}: quantize launches {row['quantize_launches']}, "
                                 f"its matrices' chunks predict {want}")
        t0 = time.perf_counter()
        row["rows_equal_cpu"] = rows_vs_cpu(f16, dst, qtype, im if use_im else None)
        row["rows_check_s"] = time.perf_counter() - t0
        got, qcfg, params = load_and_generate(device, dst, qtype, n_layer, prompt)
        row.update(got)
        if qtype == GGMLType.Q4_K:
            # the file's tensor == QuantTensor.quantize on the card from the F16 rows
            nm = "blk.0.attn_q.weight"
            x = torch.from_numpy(np.array(GGUFReader(f16).tensor_array(nm))).to(device)
            qt = QuantTensor.quantize(qtype, x.float(), device, quant_weights=im[nm])
            loaded = params["blocks"][0]["wq"]
            if qt.fields.keys() != loaded.fields.keys() or not all(
                    torch.equal(qt.fields[f], loaded.fields[f]) for f in qt.fields):
                raise AssertionError("the Q4_K file's fields differ from QuantTensor.quantize's")
            row["fields_equal_quantize"] = nm
        del params
        gc.collect()
        torch.cuda.empty_cache()
        dst.unlink()
        out["files"][name] = row
        log(f"quantize phase: {name} {row['quantize_s']:.1f} s, load {row['load_s']:.1f} s, "
            f"{row['tok_s']:.1f} tok/s")
    f16.unlink()
    t0 = time.perf_counter()
    out["codecs"] = codec_checks(device, cfg["n_embd"])
    out["codec_checks_s"] = time.perf_counter() - t0
    out["launches"] = launches()
    missing = [k.name for k in (kernels.S1, kernels.S2, kernels.S3) if not out["launches"][k.name]]
    if missing:
        raise AssertionError(f"quantize phase: kernels never launched: {missing}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# K2's kernels in a trace: this tree's (fa::fwd_kernel, fa::combine_kernel)
# and the single-kernel design before it (flash_fwd_kernel)
K2_TRACE_NAMES = ("fa::", "flash_fwd_kernel")


def long_window_step(device, cfg, params) -> dict:
    """One 8-slot `forward_batch` decode step at window 1024, as the engine
    runs it when its longest slot holds 900-1000 positions: the slots' bf16
    caches are filled with random K/V (the values do not change K2's work:
    a timing trace, not a correctness check). Host-clock time of the step
    (median of 5, synchronised) and one traced step: busy ms, K2's device
    ms, activities, busy share."""
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=device).manual_seed(7)
    kv = BatchedKVCache.create(cfg.n_layer, 8, 1024, cfg.n_kv_head, cfg.head_dim,
                               dtype=cfg.compute_dtype, device=device)
    for t in kv.k + kv.v:
        t.normal_(generator=gen)
    lengths = torch.tensor(rng.integers(900, 1001, 8), dtype=torch.int32, device=device)
    tok = torch.tensor(rng.integers(1, cfg.n_vocab, (8, 1)), device=device)
    step = lambda: llama.forward_batch(cfg, params, tok, kv, lengths, attn_window=1024)  # noqa: E731
    step()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"window": 1024, "slot_lengths": lengths.tolist(),
           "step_ms": float(np.median(times)),
           "trace": trace_device(step, K2_TRACE_NAMES)}
    busy = out["trace"]["busy_ms"]
    out["trace"]["busy_share"] = None if busy is None else busy / out["step_ms"]
    del kv
    torch.cuda.empty_cache()
    return out


def attn_xla_check(device, cfg, params, prompt, attn_bound: float) -> dict:
    """One decode step under attn_impl="xla" (the plain materialized-mask
    attention on the card) against the same step on K2: no K2 launch, and
    the logits within attn_bound, K2's card-vs-plain distance in phase 3,
    where nothing between the attentions rounds coarsely: f32 compute (an
    f32 KV cache) and the f32 matmul kernels at every M (int8_min_m = 0).
    As served (bf16 KV cache, the int8 route for the 100-token prefill) the
    distance is only reported: the cache's bf16 rounding and the per-tile
    int8 activations turn the attentions' last-bit differences into
    rounding flips that grow layer by layer (2.7e-5 at 4 layers on the
    card, where K2 against its plain version is 1.2e-9)."""
    out = {}
    for name, c, min_m in (("exact", dataclasses.replace(cfg, compute_dtype=torch.float32), 0),
                           ("served", cfg, None)):
        if min_m is not None:
            config.set("int8_min_m", min_m)
        try:
            on_k2 = _probe_step(c, params, device, prompt)
            config.set("attn_impl", "xla")
            kv = llama.make_cache(c, 1024, device=device)
            _, kv = llama.forward(c, params, torch.tensor(prompt, device=device), kv, 0)
            before = launches()
            lg, _ = llama.forward(c, params, torch.tensor(prompt[:1], device=device), kv,
                                  len(prompt))
            step = _delta(before)
        finally:
            config.unset("attn_impl")
            config.unset("int8_min_m")
        if kernels.K2.name in step:
            raise AssertionError(f"attn_impl=xla: K2 launched {step}")
        out["launches_per_decode_step"] = step
        out[f"logits_nmse_xla_vs_k2_{name}"] = nmse(lg[-1].float(), on_k2)
    out["bound"] = attn_bound
    if not out["logits_nmse_xla_vs_k2_exact"] <= attn_bound:
        raise AssertionError(f"attn_impl=xla vs K2 (f32, f32 kernels): decode logits nmse "
                             f"{out['logits_nmse_xla_vs_k2_exact']}, K2's own distance "
                             f"{attn_bound}")
    return out


def pipeline_phase(device, cfg, params, n_layer: int) -> dict:
    """The Q4_K file's single-stream prefill and decode with qmm_pipeline
    "on": every single-row Q4_K product takes K10 in place of K1 (the
    100-token prefill still takes K3). The launch counts are set to 0 just
    before and read just after; then one decode step's logits with the flag
    on are held against the flag off at the same position. K10 rounds x to
    bf16, and x reaches the matmuls in f32 even at bf16 compute (the f32
    norm weights promote it), so the two differ by the rounding of the
    activations, compounded over the layers. The bound is measured on the
    same step: the int8 route (K3 at M = 1, int8_min_m = 1), whose per-tile
    int8 activations round more coarsely than bf16, must stray further from
    the flag-off logits than K10 does. Engine
    streams are not held against generate here: under the flag a step with
    one active slot takes K10 and one with more takes K1, as in the
    reference."""
    out = {"layers": n_layer}
    rng = np.random.default_rng(6)
    prompt = [int(t) for t in rng.integers(1, cfg.n_vocab, 100)]
    config.set("qmm_pipeline", "on")
    try:
        want_prefill = expected_launches("q4_k", n_layer, 100)
        want_step = expected_launches("q4_k", n_layer, 1)
        kv = llama.make_cache(cfg, 1024, device=device)
        kernels.reset_launches()
        with torch.inference_mode():
            logits, kv = llama.forward(cfg, params, torch.tensor(prompt, device=device), kv, 0)
            out["launches_prefill_100"] = {k: v for k, v in launches().items() if v}
            stream = prompt + [int(logits[-1].argmax())]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N_NEW - 1):
                before = launches()
                lg, kv = llama.forward(cfg, params, torch.tensor([stream[-1]], device=device),
                                       kv, len(stream) - 1)
                stream.append(int(lg[-1].argmax()))
                if i == 0:
                    out["launches_per_decode_step"] = _delta(before)
            torch.cuda.synchronize()
            out["decode_s"] = time.perf_counter() - t0
            tok = torch.tensor([stream[-1]], device=device)
            out["decode_step_trace"] = trace_device(
                lambda: llama.forward(cfg, params, tok, kv, len(stream) - 1))
            out["launches"] = launches()
            on, _ = llama.forward(cfg, params, tok, kv, len(stream) - 1)
            config.set("qmm_pipeline", "off")
            off, _ = llama.forward(cfg, params, tok, kv, len(stream) - 1)
            config.set("int8_min_m", 1)
            i8, _ = llama.forward(cfg, params, tok, kv, len(stream) - 1)
    finally:
        config.unset("qmm_pipeline")
        config.unset("int8_min_m")
    for key, want in (("launches_prefill_100", want_prefill),
                      ("launches_per_decode_step", want_step)):
        if out[key] != want:
            raise AssertionError(f"q4_k with qmm_pipeline=on: {key} {out[key]}, its tensor "
                                 f"types predict {want}")
    out["logits_nmse_on_vs_off"] = nmse(on[-1], off[-1])
    out["logits_nmse_i8_vs_off"] = nmse(i8[-1], off[-1])
    if not out["logits_nmse_on_vs_off"] < out["logits_nmse_i8_vs_off"]:
        raise AssertionError(f"qmm_pipeline on vs off: decode logits nmse "
                             f"{out['logits_nmse_on_vs_off']}, the int8 route's "
                             f"{out['logits_nmse_i8_vs_off']}")
    out["decode_step_ms"] = out["decode_s"] / (N_NEW - 1) * 1e3
    out["decode_tok_s"] = (N_NEW - 1) / out["decode_s"]
    busy = out["decode_step_trace"]["busy_ms"]
    out["decode_step_trace"]["busy_share"] = None if busy is None else busy / out["decode_step_ms"]
    return out


def small_model_check(device) -> dict:
    """The card's forward against the CPU's (plain versions) on a tiny
    model of each recipe, loaded from a GGUF with random scales and norm
    weights: f32 route
    nmse < 1e-9, int8 route within its error class (the 70-token prompts
    of the recipes whose types have an int8 twin). The mixtures' n_ff of
    768 gives layer 0's Q4_K or Q5_K ffn_down and layer 1's Q6_K one an odd
    superblock count; the legacy 5-bit files' 768 gives ffn_down 24 blocks
    per row, which the reference pads to 32; the Q2_K and Q3_K_M files'
    gives their Q3_K and Q4_K ffn_down three superblocks. The Q4_K and
    Q3_K_M models (five dequantized types: Q3_K, Q4_K, Q5_K, Q6_K and the
    embedding's) run again in the int8 execution layout: the requantized
    weights on the card equal the CPU's bit for bit, the logits within the
    int8 routes' error class (nmse < 2e-4)."""
    res = {}
    for recipe, n_ff, tol_70 in (("q4_k", 512, 2e-4), ("q4_k_m", 768, 2e-4),
                                 ("q8_0", 512, 2e-4), ("q5_k_m", 768, 2e-4),
                                 ("q4_0", 512, 2e-4), ("q4_1", 768, 1e-9),
                                 ("q5_0", 768, 1e-9), ("q5_1", 768, 1e-9),
                                 ("q2_k", 768, 1e-9), ("q3_k_m", 768, 2e-4)):
        small = dict(n_vocab=512, n_ctx=256, n_embd=256, n_head=4, n_kv_head=2, n_ff=n_ff)
        path = ROOT / "build" / f"smoke_small_{recipe}.gguf"
        write_gguf(path, small, 2, recipe, random_scales=True)
        (cfg, pc), (_, pg) = llama.load(path, device="cpu"), llama.load(path, device=device)
        rng = np.random.default_rng(3)
        for n_tok, tol in ((7, 1e-9), (70, tol_70)):
            toks = torch.from_numpy(rng.integers(0, 512, n_tok))
            with torch.inference_mode():
                lc, _ = llama.forward(cfg, pc, toks, llama.make_cache(cfg, 128, device="cpu"), 0)
                lg, _ = llama.forward(cfg, pg, toks.to(device),
                                      llama.make_cache(cfg, 128, device=device), 0)
            e = nmse(lg.cpu(), lc)
            if not e < tol:
                raise AssertionError(f"small {recipe} model {n_tok} tokens: card vs CPU nmse {e}")
            res[f"{recipe}_nmse_{n_tok}_tokens"] = e
        if recipe == "q4_k" and HAS_TOOLS:
            res["q4_k_perplexity"] = small_perplexity(device, cfg, pc, pg)
        if recipe not in ("q4_k", "q3_k_m"):
            continue
        (cfg, pc), (_, pg) = (llama.load(path, device="cpu", layout="int8"),
                              llama.load(path, device=device, layout="int8"))
        for tc, tg in zip(_leaves(pc), _leaves(pg)):
            if isinstance(tc, QuantTensor):
                assert tc.layout == tg.layout == "int8"
                for f in ("w8t", "dwt"):
                    if not torch.equal(tc.fields[f], tg.fields[f].cpu()):
                        raise AssertionError(f"small {recipe} int8 load: {f} differs card vs CPU")
        for n_tok in (7, 70):
            toks = torch.from_numpy(rng.integers(0, 512, n_tok))
            with torch.inference_mode():
                lc, _ = llama.forward(cfg, pc, toks, llama.make_cache(cfg, 128, device="cpu"), 0)
                lg, _ = llama.forward(cfg, pg, toks.to(device),
                                      llama.make_cache(cfg, 128, device=device), 0)
            e = nmse(lg.cpu(), lc)
            if not e < 2e-4:
                raise AssertionError(f"small {recipe} int8 model {n_tok} tokens: card vs CPU "
                                     f"nmse {e}")
            res[f"{recipe}_int8_nmse_{n_tok}_tokens"] = e
    return res


def small_perplexity(device, cfg, pc, pg, n_ctx: int = 32, tol: float = 1e-9) -> dict:
    """perplexity_llama of the tiny model on the card against the CPU's over
    96 tokens in windows of n_ctx (the f32 route, M = 32): the nll within
    sqrt(tol) relative, tol the bound of the forward comparison on that
    route (logits nmse), and n_tokens equal."""
    ids = np.random.default_rng(9).integers(0, cfg.n_vocab, 96)
    cpu = perplexity.perplexity_llama(cfg, pc, ids, n_ctx=n_ctx, device="cpu")
    card = perplexity.perplexity_llama(cfg, pg, ids, n_ctx=n_ctx, device=device)
    rel = abs(card["nll"] - cpu["nll"]) / abs(cpu["nll"])
    if card["n_tokens"] != cpu["n_tokens"] or not rel < tol ** 0.5:
        raise AssertionError(f"small q4_k perplexity card {card} vs CPU {cpu} (nll relative "
                             f"{rel:.3e}, bound {tol ** 0.5:.3e})")
    return {"card": card, "cpu": cpu, "nll_rel": rel, "bound": tol ** 0.5}


def autotune_phase(device) -> dict:
    """`choose` and `choose_attn` on the card from a fresh cache directory,
    so that K11 runs (one warm and three timed calls) in every smoke run."""
    cache = ROOT / "build" / "autotune_cache"
    shutil.rmtree(cache, ignore_errors=True)
    os.environ["GGML_TORCH_CACHE"] = str(cache)
    kernels.reset_launches()
    t0 = time.perf_counter()
    layout = autotune.choose(device)
    attn = autotune.choose_attn(device)
    out = dict(autotune.measure(device), layout=layout, attn_impl=attn,
               seconds=time.perf_counter() - t0, launches=launches())
    if out["launches"][kernels.K11.name] != 4:
        raise AssertionError(f"K11 launched {out['launches'][kernels.K11.name]} times "
                             "from a fresh cache, not 4")
    if not (cache / "autotune.json").exists():
        raise AssertionError("the autotune cache was not written")
    return out


# ------------------------------------------------------------- families
# The other served families at their published widths: Mixtral-8x7B
# (mistralai/Mixtral-8x7B-v0.1 config.json), GPT-2-large
# (openai-community/gpt2-large) and GPT-J-6B (EleutherAI/gpt-j-6b), each
# a GGUF of random valid blocks (make_blocks) in llama.cpp's Q4_K_M recipe
# with the synthetic SentencePiece vocabulary of its n_vocab.

MIXTRAL_8X7B = dict(arch="moe", n_vocab=32000, n_ctx=32768, n_embd=4096, n_head=32,
                    n_kv_head=8, n_ff=14336, n_expert=8, n_expert_used=2, rope_base=1e6)
GPT2_LARGE = dict(arch="gpt2", n_vocab=50257, n_ctx=1024, n_embd=1280, n_head=20)
GPTJ_6B = dict(arch="gptj", n_vocab=50400, n_ctx=2048, n_embd=4096, n_head=16, n_rot=64,
               n_ff=16384)
# name → (config, depth): GPT-2-large whole (36 layers, ~0.5 GB); Mixtral
# and GPT-J cut to SHORT_LAYERS (~6.5 GB of experts at 8 of 32 layers; ~1.5
# GB at 8 of 28)
FAMILIES = {"mixtral": (MIXTRAL_8X7B, SHORT_LAYERS), "gpt2_large": (GPT2_LARGE, 36),
            "gptj": (GPTJ_6B, SHORT_LAYERS)}
if HAS_FAMILIES:
    FAMILY_MODULES = {"moe": moe, "gpt2": gpt2, "gptj": gptj}


# tiny configurations of the families (the Mixtral recipe's 8 experts, GPT-2's
# head dim 64, GPT-J's 256 with n_rot 64), for the card-vs-CPU check
TINY_FAMILIES = {"moe": dict(MIXTRAL_8X7B, n_vocab=512, n_ctx=1024, n_embd=256, n_head=4,
                             n_kv_head=2, n_ff=512),
                 "gpt2": dict(GPT2_LARGE, n_vocab=512, n_ctx=1024, n_embd=256, n_head=4),
                 "gptj": dict(GPTJ_6B, n_vocab=512, n_ctx=1024, n_embd=512, n_head=2,
                              n_ff=2048)}


def family_matrices(cfg: dict, n_layer: int):
    """(tensor, layer or None, rows, cols, experts) of every matrix of a
    family's GGUF; experts > 0 for a stacked (experts, rows, cols) tensor.
    GPT-2's head is token_embd (tied)."""
    D, V = cfg["n_embd"], cfg["n_vocab"]
    yield "token_embd", None, V, D, 0
    if cfg["arch"] != "gpt2":
        yield "output", None, V, D, 0
    for i in range(n_layer):
        if cfg["arch"] == "gpt2":
            mats = (("attn_qkv", 3 * D, D, 0), ("attn_output", D, D, 0),
                    ("ffn_up", 4 * D, D, 0), ("ffn_down", D, 4 * D, 0))
        elif cfg["arch"] == "gptj":
            FF = cfg["n_ff"]
            mats = (("attn_q", D, D, 0), ("attn_k", D, D, 0), ("attn_v", D, D, 0),
                    ("attn_output", D, D, 0), ("ffn_up", FF, D, 0), ("ffn_down", D, FF, 0))
        else:
            FF, E = cfg["n_ff"], cfg["n_expert"]
            KVD = cfg["n_kv_head"] * (D // cfg["n_head"])
            mats = (("attn_q", D, D, 0), ("attn_k", KVD, D, 0), ("attn_v", KVD, D, 0),
                    ("attn_output", D, D, 0), ("ffn_gate_exps", FF, D, E),
                    ("ffn_up_exps", FF, D, E), ("ffn_down_exps", D, FF, E))
        for name, r, c, e in mats:
            yield name, i, r, c, e


def family_type(cfg: dict, name: str, layer: int | None, n_layer: int) -> GGMLType:
    """llama.cpp's tensor type for LLAMA_FTYPE_MOSTLY_Q4_K_M without an
    importance matrix (src/llama-quant.cpp, llama_tensor_get_type), for the
    three families: the head (output.weight, or GPT-2's tied token_embd)
    is Q6_K; with 8 experts attn_k and attn_v are Q8_0 and attn_output
    Q5_K; a fused attn_qkv is Q5_K; attn_v and ffn_down (ffn_down_exps,
    whose name holds "ffn_down", counted alike) are Q6_K in the
    use_more_bits layers (k_m_type); every other matrix is Q4_K."""
    if name == "output" or (name == "token_embd" and cfg["arch"] == "gpt2"):
        return GGMLType.Q6_K
    if cfg.get("n_expert") == 8:
        if name in ("attn_k", "attn_v"):
            return GGMLType.Q8_0
        if name == "attn_output":
            return GGMLType.Q5_K
    if name == "attn_qkv":
        return GGMLType.Q5_K
    return k_m_type(GGMLType.Q4_K, name.replace("_exps", ""), layer, n_layer)


def write_family_gguf(path: Path, cfg: dict, n_layer: int, random_scales: bool = False):
    """A family's GGUF at `cfg`'s width: the matrices of family_matrices in
    family_type's types (make_blocks, seed 0; a stacked expert tensor's ne
    is (cols, rows, experts)), F32 norms (ones, or 1 + N(0, 0.1) with
    random_scales), F32 biases, position embeddings and router weights
    ~N(0, 0.02), the vocabulary spm_vocab(n_vocab); an existing file is
    kept."""
    if path.exists():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    arch, D = cfg["arch"], cfg["n_embd"]
    A = "llama" if arch == "moe" else arch
    w = GGUFWriter()
    w.set("general.architecture", A)
    keys = {"vocab_size": cfg["n_vocab"], "context_length": cfg["n_ctx"],
            "embedding_length": D, "block_count": n_layer,
            "attention.head_count": cfg["n_head"]}
    if arch == "moe":
        keys.update({"attention.head_count_kv": cfg["n_kv_head"],
                     "feed_forward_length": cfg["n_ff"], "expert_count": cfg["n_expert"],
                     "expert_used_count": cfg["n_expert_used"]})
        w.set(f"{A}.rope.freq_base", float(cfg["rope_base"]))
        w.set(f"{A}.attention.layer_norm_rms_epsilon", 1e-5)
    else:
        w.set(f"{A}.attention.layer_norm_epsilon", 1e-5)
    if arch == "gptj":
        keys["rope.dimension_count"] = cfg["n_rot"]
    for key, val in keys.items():
        w.set(f"{A}.{key}", int(val))
    write_vocab(w, cfg["n_vocab"])
    for name, layer, r, c, e in family_matrices(cfg, n_layer):
        qtype = family_type(cfg, name, layer, n_layer)
        gname = f"{name}.weight" if layer is None else f"blk.{layer}.{name}.weight"
        ne = (c, r, e) if e else (c, r)
        w.add_tensor(gname, ne, qtype, make_blocks(qtype, rng, r * max(e, 1), c,
                                                   random_scales).reshape(-1).view(np.uint8))

    def vec(*shape, gain=False):
        if gain:
            g = 1 + 0.1 * rng.standard_normal(shape) if random_scales else np.ones(shape)
            return g.astype(np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    norms = ["output_norm"] + [f"blk.{i}.{n}" for i in range(n_layer)
                               for n in ("attn_norm", "ffn_norm") if arch != "gptj" or
                               n == "attn_norm"]
    for n in norms:
        w.add_array_tensor(f"{n}.weight", vec(D, gain=True))
        if arch != "moe":
            w.add_array_tensor(f"{n}.bias", vec(D))
    for i in range(n_layer):
        b = f"blk.{i}."
        if arch == "moe":
            w.add_array_tensor(b + "ffn_gate_inp.weight", vec(cfg["n_expert"], D))
        elif arch == "gpt2":
            for n, size in (("attn_qkv", 3 * D), ("attn_output", D), ("ffn_up", 4 * D),
                            ("ffn_down", D)):
                w.add_array_tensor(f"{b}{n}.bias", vec(size))
        else:
            w.add_array_tensor(b + "ffn_up.bias", vec(cfg["n_ff"]))
            w.add_array_tensor(b + "ffn_down.bias", vec(D))
    if arch == "gpt2":
        w.add_array_tensor("position_embd.weight", vec(cfg["n_ctx"], D))
    if arch == "gptj":
        w.add_array_tensor("output.bias", vec(cfg["n_vocab"]))
    tmp = path.with_suffix(".tmp")
    w.write(tmp)
    tmp.rename(path)


def family_launches(cfg: dict, n_layer: int, m: int) -> dict:
    """Kernel launches of one forward over m tokens of a family's file on
    the card: one K2 per layer and one launch per matrix product, an
    expert stack's E products each at the capacity buffer's C = m·U rows
    (every expert runs every step); the embedding is a row gather."""
    out = {kernels.K2.name: n_layer}
    for name, layer, r, c, e in family_matrices(cfg, n_layer):
        if name == "token_embd" and cfg["arch"] != "gpt2":
            continue
        qtype = family_type(cfg, name, layer, n_layer)
        rows = m * cfg["n_expert_used"] if e else m
        kern = dispatch.KERNEL_OF[(qtype, dispatch.route(rows, qtype, (r, c), cuda=True))].name
        out[kern] = out.get(kern, 0) + max(e, 1)
    return out


def family_bytes(cfg: dict, n_layer: int) -> float:
    """The bytes of a family file's matrices as the card holds them (the
    weight stream of one decode step: every matrix once, every expert)."""
    total = 0.0
    for name, layer, r, c, e in family_matrices(cfg, n_layer):
        if name == "token_embd" and cfg["arch"] != "gpt2":
            continue
        tt = TYPE_TRAITS[family_type(cfg, name, layer, n_layer)]
        total += r * max(e, 1) * c // tt.blck_size * tt.type_size
    return total


def check_family_shapes(device, timer, results):
    """The kernels at the families' shapes that the 7B checks never give
    them: K2 at head dim 64 (GPT-2-large, H = 20) and 256 (GPT-J, H = 16)
    in decode windows 128 and 1024 (8 slots, bf16 q and K/V as served) and
    a 128-row prefill (f32); K1, K3 and K4 at GPT-2-large's odd head N =
    50257 x K = 1280 and K1 and K4 at GPT-J's N = 50400 x K = 4096, each
    against its plain version, timed beside the library call and its bound,
    its rows bit for bit across M."""
    gen = torch.Generator(device=device).manual_seed(17)
    for D, H in ((64, 20), (256, 16)):
        cases = []
        for m in (128, 1024):
            pos = torch.randint(0, m, (8,), device=device, generator=gen).to(torch.int32)
            cases.append((f"decode B=8 H={H} D={D} window={m} bf16", 8, H, H, 1, m, pos,
                          "bf16", 0.0, False))
        cases.append((f"prefill B=1 H={H} D={D} N=128 M=1024 pos=256 f32", 1, H, H, 128, 1024,
                      torch.tensor([256], dtype=torch.int32, device=device), "f32", 0.0, False))
        attention_cases(timer, results, cases, D, gen)
    rows = {}
    for n, k, k3 in ((50257, 1280, True), (50400, 4096, False)):
        qs, scm, dd = random_q4k(n, k, device, gen)
        w_dense = qmm.dequant(qs, scm, dd)
        for m in (1, 8, 100):
            check_f32(timer, results, "K1", kernels.K1,
                      lambda x: qmm.qmm_q4_K(x, qs, scm, dd),
                      lambda x: qmm.qmm_q4_K_plain(x, qs, scm, dd),
                      torch.randn((m, k), device=device, generator=gen), w_dense,
                      n * k * 4.5 / 8)
        rows[f"K1 N={n} K={k}"] = check_rows("K1", lambda x: qmm.qmm_q4_K(x, qs, scm, dd),
                                             torch.randn((128, k), device=device, generator=gen))
        if k3:
            k3l = k3_launches(qs, scm, dd)
            for m in (100, 128):
                check_i8(timer, results, k3l, torch.randn((m, k), device=device, generator=gen),
                         w_dense, n * k * 4.5 / 8)
            rows[f"K3 N={n} K={k}"] = check_rows(
                "K3", lambda x: qmm.qmm_q4_K_i8(x, qs, scm, dd),
                torch.randn((128, k), device=device, generator=gen))
        del w_dense, qs, scm, dd
        nb = k // 256
        w = (torch.randint(0, 256, (n, nb * 128), dtype=torch.uint8, device=device, generator=gen),
             torch.randint(0, 256, (n, nb * 64), dtype=torch.uint8, device=device, generator=gen),
             torch.randint(-128, 128, (n, nb * 16), dtype=torch.int8, device=device, generator=gen),
             torch.rand((n, nb), device=device, generator=gen) * 1e-3)
        w_dense = qmm_q6k.dequant(*w)
        for m in (1, 8, 100):
            check_f32(timer, results, "K4", kernels.K4, lambda x: qmm_q6k.qmm_q6_K(x, *w),
                      lambda x: qmm_q6k.qmm_q6_K_plain(x, *w),
                      torch.randn((m, k), device=device, generator=gen), w_dense,
                      n * k * 6.5625 / 8)
        rows[f"K4 N={n} K={k}"] = check_rows("K4", lambda x: qmm_q6k.qmm_q6_K(x, *w),
                                             torch.randn((128, k), device=device, generator=gen))
        del w_dense, w
        torch.cuda.empty_cache()
    return rows


@torch.inference_mode()
def family_path(device, name: str, fcfg: dict, n_layer: int) -> dict:
    """One family file's path on the card, as main_path runs a llama file:
    write and load it, prefill 100 tokens, decode N_NEW - 1 tokens eagerly
    (== generate), the same steps replayed through decode_step's captured
    graph (== the eager stream; one replayed step's logits torch.equal to
    the eager step's), the launches per decode step, per replayed step and
    per 128-token prefill chunk against family_launches, one decode step
    traced; where the module has a batched forward (MoE, GPT-2), the 8+1
    requests through the Engine, == generate where both prefill on one
    route (engine_vs_generate), timed on a second run, and one steady 8-slot
    engine step traced; for GPT-2 one request to n_ctx (to_n_ctx_check)."""
    mod = FAMILY_MODULES[fcfg["arch"]]
    out = {"layers": n_layer, "family": name}
    path = ROOT / "build" / f"smoke_{name}_L{n_layer}.gguf"
    t0 = time.perf_counter()
    write_family_gguf(path, fcfg, n_layer)
    out["gguf_write_s"] = time.perf_counter() - t0
    out["gguf_gb"] = path.stat().st_size / 1e9
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params = mod.load(path, device=device)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["weights_gb"] = offload._tree_bytes(params) / 1e9
    out["matrix_bytes_predicted_gb"] = family_bytes(fcfg, n_layer) / 1e9
    cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    types = {}

    def count(t):
        if isinstance(t, QuantTensor):
            types[t.qtype.name] = types.get(t.qtype.name, 0) + 1
            assert t.layout == "kernel" and all(f.device.type == device.type
                                                for f in t.fields.values()), name
        elif isinstance(t, dict):
            for v in t.values():
                count(v)
        elif isinstance(t, list):
            for v in t:
                count(v)
        else:
            assert t.device.type == device.type, name
    count(params)
    out["tensor_types"] = types
    log(f"loaded {n_layer}-layer {name} GGUF in {out['load_s']:.2f} s (matrices by type "
        f"{types}, {out['weights_gb']:.2f} GB on the card)")
    want_step = family_launches(fcfg, n_layer, 1)
    want_chunk = family_launches(fcfg, n_layer, 128)

    rng = np.random.default_rng(5)
    kernels.reset_launches()
    prompt = [int(t) for t in rng.integers(1, cfg.n_vocab, 100)]
    toks = torch.tensor(prompt, device=device)
    kv = mod.make_cache(cfg, 1024, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, kv = mod.forward(cfg, params, toks, kv, 0)
    torch.cuda.synchronize()
    out["prefill_100_s"] = time.perf_counter() - t0
    assert logits.shape == (100, cfg.n_vocab) and bool(torch.isfinite(logits).all())
    out["prefill_trace"] = trace_device(lambda: mod.forward(
        cfg, params, toks, mod.make_cache(cfg, 1024, device=device), 0), K3_TRACE_NAMES)
    stream = prompt + [int(logits[-1].argmax())]
    t0 = time.perf_counter()
    for i in range(N_NEW - 1):
        before = launches()
        lg, kv = mod.forward(cfg, params, torch.tensor([stream[-1]], device=device), kv,
                             len(stream) - 1)
        stream.append(int(lg[-1].argmax()))
        if i == 0:
            out["launches_per_decode_step"] = _delta(before)
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    if stream != mod.generate(cfg, params, prompt, N_NEW, max_seq=1024, device=device):
        raise AssertionError(f"{name}: the eager decode differs from generate")
    out["decode_step_trace"] = trace_device(lambda: mod.forward(
        cfg, params, torch.tensor([stream[-1]], device=device), kv, len(stream) - 1))
    # the same steps replayed through decode_step's captured graph
    kv2 = mod.make_cache(cfg, 1024, device=device)
    mod.forward(cfg, params, toks, kv2, 0)
    tok = torch.tensor([stream[100]], device=device)
    replayed = []
    for i in range(N_NEW - 1):
        if i == 1:                   # the first step captured the graph
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = launches()
        tok, kv2 = mod.decode_step(cfg, params, tok, kv2, 100 + i)
        if i == 1:
            out["launches_per_replayed_step"] = _delta(before)
        replayed.append(int(tok))
    torch.cuda.synchronize()
    out["replayed_step_ms"] = (time.perf_counter() - t0) / (N_NEW - 2) * 1e3
    if replayed != stream[101:]:
        raise AssertionError(f"{name}: decode_step's replayed stream differs from the eager one")
    pos = len(stream) - 2
    t = torch.tensor([stream[-2]], device=device)
    mod.decode_step(cfg, params, t, kv2, pos)
    graph_logits = llama.step_graph(cfg, params, kv2, 1, mod._forward).outputs[1].clone()
    eager, _ = mod.forward(cfg, params, t, kv2, pos)
    if not torch.equal(graph_logits, eager[-1:]):
        raise AssertionError(f"{name}: the replayed step's logits differ from the eager step's")
    out["replayed_logits_equal_eager"] = True
    out["replayed_step_trace"] = trace_device(lambda: mod.decode_step(cfg, params, t, kv2, pos))
    del kv2
    before = launches()
    mod.forward(cfg, params, torch.tensor(prompt + prompt[:28], device=device),
                mod.make_cache(cfg, 1024, device=device), 0)
    out["launches_per_prefill_chunk_128"] = _delta(before)
    for key, want in (("launches_per_decode_step", want_step),
                      ("launches_per_replayed_step", want_step),
                      ("launches_per_prefill_chunk_128", want_chunk)):
        if out[key] != want:
            raise AssertionError(f"{name}: {key} {out[key]}, its tensor types predict {want}")
    out["decode_step_ms"] = out["decode_s"] / (N_NEW - 1) * 1e3
    out["decode_tok_s"] = (N_NEW - 1) / out["decode_s"]
    out["replayed_tok_s"] = 1e3 / out["replayed_step_ms"]
    out["prefill_tok_s"] = 100 / out["prefill_100_s"]
    out["prefill_100_ms"] = out["prefill_100_s"] * 1e3
    out["step_bytes_bound_ms"] = family_bytes(fcfg, n_layer) / HBM_BPS * 1e3

    if hasattr(mod, "forward_batch"):
        prompts = [[int(t) for t in rng.integers(1, cfg.n_vocab, n)] for n in PARITY_LENS]
        long_prompt = [int(t) for t in rng.integers(1, cfg.n_vocab, 300)]
        eng = Engine(mod, cfg, params, max_batch=8, max_seq=1024, device=device)
        t0 = time.perf_counter()
        done = serve(eng, prompts + [long_prompt], N_NEW)
        torch.cuda.synchronize()
        out["engine_first_run_s"] = time.perf_counter() - t0
        out["engine_vs_generate"] = engine_vs_generate(
            name, cfg, params, device, prompts, done,
            int8_route=bool(I8_KERNELS & set(want_chunk)), mod=mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = serve(eng, prompts + [long_prompt], N_NEW)
        torch.cuda.synchronize()
        out["engine_s"] = time.perf_counter() - t0
        if again != done:
            raise AssertionError(f"{name}: the engine's second run differs from its first")
        out["engine_tokens"] = sum(map(len, again))
        out["engine_tok_s"] = out["engine_tokens"] / out["engine_s"]
        del eng
        gc.collect()
        eng = Engine(mod, cfg, params, max_batch=8, max_seq=1024, device=device)
        for p in prompts:
            eng.submit(p, 64)
        while eng.queue or eng.pending is not None:
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            eng.step()
        out["engine_decode_step_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        out["engine_step_trace"] = trace_device(eng.step)
        del eng
        gc.collect()
    for key, step_ms in (("decode_step_trace", out["decode_step_ms"]),
                         ("replayed_step_trace", out["replayed_step_ms"]),
                         ("engine_step_trace", out.get("engine_decode_step_ms")),
                         ("prefill_trace", out["prefill_100_ms"])):
        if key in out:
            busy = out[key]["busy_ms"]
            out[key]["busy_share"] = None if busy is None else busy / step_ms
    if fcfg["arch"] == "gpt2":
        out["to_n_ctx"] = to_n_ctx_check(name, mod, cfg, params, device, rng)
    out["launches"] = launches()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if fcfg["arch"] == "moe":
        out["offload"] = offload_check(device, cfg, params, n_layer)
    if fcfg["arch"] == "gpt2":
        out["cli"] = family_cli(device, mod, dataclasses.replace(cfg, compute_dtype=torch.float32),
                                params, path)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    path.unlink()
    return out


def to_n_ctx_check(name, mod, cfg, params, device, rng) -> dict:
    """One request whose prompt and N_NEW tokens fill max_seq = n_ctx (the
    rows of GPT-2's position table), served alone by a fresh Engine at the
    default harvest depth: its slot steps on past n_ctx to the end of its
    pipelined windows, where the port reads the table's last row as the
    reference's gather does. Its stream == generate's (every prefill chunk
    on the int8 route on both sides)."""
    prompt = [int(t) for t in rng.integers(1, cfg.n_vocab, cfg.n_ctx - N_NEW)]
    eng = Engine(mod, cfg, params, max_batch=8, max_seq=cfg.n_ctx, device=device)
    t0 = time.perf_counter()
    got = serve(eng, [prompt], N_NEW)[0]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    del eng
    gc.collect()
    ref = mod.generate(cfg, params, prompt, N_NEW, max_seq=cfg.n_ctx, device=device)
    if got != ref[len(prompt):]:
        raise AssertionError(f"{name}: the engine's stream to n_ctx differs from generate "
                             f"(first divergence {first_divergence(got, ref[len(prompt):])})")
    log(f"  {name}: a {len(prompt)}-token prompt + {N_NEW} tokens to n_ctx = {cfg.n_ctx} "
        f"through the Engine at harvest depth {config.get('engine_harvest_depth')} "
        f"({serve_s:.2f} s) == generate")
    return {"prompt_tokens": len(prompt), "n_new": N_NEW, "max_seq": cfg.n_ctx,
            "harvest_depth": int(config.get("engine_harvest_depth")), "serve_s": serve_s,
            "equal_generate": True}


OFFLOAD_BOUND = 1e-9      # the f32 route's card-vs-CPU bound (small_model_check)


def offload_check(device, cfg, params, n_layer: int) -> dict:
    """The file split by OffloadSplit with layers [n_layer / 2, n_layer) and
    the head on the CPU (plain versions): an 8-token prefill's logits
    against the all-card forward at f32 compute (the f32 route, C = 16),
    nmse < OFFLOAD_BOUND."""
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    toks = [int(t) for t in np.random.default_rng(21).integers(1, cfg.n_vocab, 8)]
    t0 = time.perf_counter()
    split = offload.OffloadSplit.build(cfg32, params, n_layer // 2, device=device,
                                       ffn=moe.block_ffn(cfg32))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, _ = split.forward(toks, split.make_caches(64), 0)
    fwd_s = time.perf_counter() - t0
    ref, _ = moe.forward(cfg32, params, torch.tensor(toks, device=device),
                         moe.make_cache(cfg32, 64, device=device), 0)
    e = nmse(got, ref.cpu())
    if not e < OFFLOAD_BOUND:
        raise AssertionError(f"offload split: logits nmse {e} against the all-card forward")
    del split
    gc.collect()
    log(f"  offload split (layers {n_layer // 2}-{n_layer - 1} and the head on the CPU): "
        f"build {build_s:.1f} s, 8-token prefill {fwd_s:.2f} s, logits nmse {e:.3e} against "
        f"the all-card forward")
    return {"n_device_layers": n_layer // 2, "build_s": build_s, "forward_s": fwd_s,
            "logits_nmse": e, "bound": OFFLOAD_BOUND}


def family_cli(device, mod, cfg, params, path: Path) -> dict:
    """The CLI in-process on a family file: greedy generate's ids equal
    mod.generate's on the encoded text, and `serve` of the 8+1 prompts as
    text equals a direct Engine run of the same ids and settings."""
    tok = tokenizer.from_gguf(GGUFReader(path))
    text = synthetic_text(24, 24, cfg.n_vocab)
    ids = tok.encode(text)
    dev = ["--device", device.type]
    g_out, g_err, rate = _cli(["-m", str(path), "-p", text, "-n", str(N_NEW), "--greedy"] + dev)
    if g_out != tok.decode(mod.generate(cfg, params, ids, N_NEW, device=device)) + "\n":
        raise AssertionError(f"cli --greedy on {path.name}: differs from generate")
    out = {"greedy_rate": rate}
    lines = [synthetic_text(n, 30 + n, cfg.n_vocab) for n in SERVE_WORDS]
    pfile = path.with_name("smoke_family_prompts.txt")
    pfile.write_text("\n".join(lines) + "\n")
    v_out, _, out["serve_rate"] = _cli(["serve", "-m", str(path), "--prompts", str(pfile),
                                        "-n", str(N_NEW), "--max-batch", "8",
                                        "--max-seq", "1024"] + dev)
    pfile.unlink()
    served = {int(ln[1:ln.index("]")]): ln[ln.index("]") + 2:] for ln in v_out.splitlines()}
    eng = Engine(mod, cfg, params, max_batch=8, max_seq=1024, device=device)
    rids = [eng.submit(tok.encode(ln), N_NEW, eos_id=tok.eos_id, top_k=40, top_p=0.9, seed=i)
            for i, ln in enumerate(lines)]
    direct = {r.rid: tok.decode(r.out) for r in eng.run()}
    del eng
    gc.collect()
    if sorted(served) != list(range(len(lines))) or any(served[i] != direct[r]
                                                       for i, r in enumerate(rids)):
        raise AssertionError(f"cli serve on {path.name}: completions differ from the Engine's")
    out["serve_requests"] = len(served)
    log(f"  cli on {path.name}: greedy == generate ({rate}); serve {len(served)} requests == "
        f"Engine ({out['serve_rate']})")
    return out


def small_family_check(device) -> dict:
    """The card's forward against the CPU's (plain versions) on a tiny model
    of each family, loaded from a GGUF with random scales and norm weights
    1 + N(0, 0.1) (write_family_gguf): 7 tokens on the f32 route at nmse <
    1e-9, 70 tokens within the int8 route's error class (2e-4)."""
    res = {}
    for arch, fcfg in TINY_FAMILIES.items():
        mod = FAMILY_MODULES[arch]
        path = ROOT / "build" / f"smoke_small_{arch}.gguf"
        write_family_gguf(path, fcfg, 2, random_scales=True)
        (cfg, pc), (_, pg) = mod.load(path, device="cpu"), mod.load(path, device=device)
        rng = np.random.default_rng(3)
        for n_tok, tol in ((7, 1e-9), (70, 2e-4)):
            toks = torch.from_numpy(rng.integers(0, 512, n_tok))
            with torch.inference_mode():
                lc, _ = mod.forward(cfg, pc, toks, mod.make_cache(cfg, 128, device="cpu"), 0)
                lg, _ = mod.forward(cfg, pg, toks.to(device),
                                    mod.make_cache(cfg, 128, device=device), 0)
            e = nmse(lg.cpu(), lc)
            if not e < tol:
                raise AssertionError(f"small {arch} model {n_tok} tokens: card vs CPU nmse {e}")
            res[f"{arch}_nmse_{n_tok}_tokens"] = e
    return res


def families_phase(device, names) -> dict:
    """The families phase: tiny models card vs CPU, then each family file's
    path (family_path; the Mixtral file also through OffloadSplit, the
    GPT-2-large file also through the CLI)."""
    t0 = time.perf_counter()
    out = {"small": small_family_check(device)}
    log(f"small family models card vs CPU: {out['small']}")
    for name in names:
        fcfg, depth = FAMILIES[name]
        out[name] = family_path(device, name, fcfg, depth)
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------- vision
# The vision and classifier models at their published widths, random
# weights from fixed seeds: YOLOv3-tiny at 416 (darknet yolov3-tiny.cfg;
# examples/yolo/yolov3-tiny.cpp:113-136), SAM ViT-B (sam_vit_b of
# facebookresearch/segment-anything: 768 wide, 12 layers, 12 heads, image
# 1024, window 14, global layers 2, 5, 8, 11, the 256-wide two-way decoder)
# and Magika (examples/magika/main.cpp:181-251: 1536 input bytes, 257 →
# 128, 384 x 512, 256, 113 labels). None of them reaches a quantized kernel.

VISION_BOUND = 1e-9          # card vs CPU nmse of every f32 vision output
YOLO_CHANS = ((3, 16), (16, 32), (32, 64), (64, 128), (128, 256), (256, 512),
              (512, 1024), (1024, 256), (256, 512), (512, 255), (256, 128),
              (384, 256), (256, 255))
YOLO_KSIZE = (3,) * 7 + (1, 3, 1, 1, 3, 1)
YOLO_NET = 416
YOLO_IMAGE = (3, 480, 640)   # detect's photo: a letterbox downscale
YOLO_OBJ_BIAS = -0.5         # the objectness bias of both heads (yolo_gguf)
SAM_VIT_B = dict(n_enc_state=768, n_enc_layer=12, n_enc_head=12, n_img_size=1024)
SAM_CHECK_LAYERS = 3         # card vs CPU: layers 0 and 1 windowed, 2 global
SAM_POINT = ((500.0, 375.0),)
MAGIKA_LABELS = 113
MAGIKA_FILES = 64
MAGIKA_MAX_BYTES = 1 << 20


def yolo_gguf(path: Path, rng, obj_bias: float | None = None):
    """A YOLOv3-tiny GGUF of random weights with the reference's tensor
    names and shapes (load_model yolov3-tiny.cpp:122-136), drawn in the
    order of the reference's test recipe (tests/test_vision_models.py).
    obj_bias sets the objectness bias of both heads, as a trained net's
    prior does (most cells hold no object): random heads with the
    recipe's bias put about half of the 2,535 cells at 416 over the 0.5
    threshold (1,225 candidates, 3.9 s of NMS on the host), at -0.5 a
    tenth of them, and NMS is quadratic in the candidates."""
    w = GGUFWriter()
    for i, ((ic, oc), k) in enumerate(zip(YOLO_CHANS, YOLO_KSIZE)):
        w.add_array_tensor(f"l{i}_weights",
                           (rng.standard_normal((oc, ic, k, k)) * 0.05).astype(np.float32))
        bias = (rng.standard_normal((oc, 1, 1)) * 0.1).astype(np.float32)
        if obj_bias is not None and oc == 255:
            bias[4::85] = obj_bias
        w.add_array_tensor(f"l{i}_biases", bias)
        if i not in yolo.NO_BN:
            w.add_array_tensor(f"l{i}_scales",
                               (1 + 0.1 * rng.standard_normal((oc, 1, 1))).astype(np.float32))
            w.add_array_tensor(f"l{i}_rolling_mean",
                               (0.1 * rng.standard_normal((oc, 1, 1))).astype(np.float32))
            w.add_array_tensor(f"l{i}_rolling_variance",
                               (1 + 0.1 * rng.random((oc, 1, 1))).astype(np.float32))
    w.write(path)


def sam_state(n_enc_state: int, n_enc_layer: int, n_enc_head: int, n_img_size: int,
              seed: int = 0) -> dict:
    """An HF SamModel state dict (the keys sam.from_hf reads; torch
    tensors) of random weights at the given encoder widths and the
    published 256-wide decoder: matrices N(0, 1/fan_in), norm weights
    1 + N(0, 0.1), small biases, the relative-position tables sized for a
    window of sam.WINDOW (global layers, sam.GLOBAL_ATTN: the grid)."""
    rng = np.random.default_rng(seed)
    C, E, grid = n_enc_state, 256, n_img_size // 16
    sd = {}

    def w(*shape, fan=None):
        fan = fan or shape[-1]
        return torch.from_numpy((rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32))

    def lin(prefix, n_out, n_in, *kernel):
        sd[prefix + ".weight"] = w(n_out, n_in, *kernel, fan=n_in * int(np.prod(kernel)))
        sd[prefix + ".bias"] = w(n_out, fan=100)

    def ln(prefix, n):
        sd[prefix + ".weight"] = 1 + w(n, fan=100)
        sd[prefix + ".bias"] = w(n, fan=100)

    v = "vision_encoder."
    lin(v + "patch_embed.projection", C, 3, 16, 16)
    sd[v + "pos_embed"] = w(1, grid, grid, C, fan=100)
    for i in range(n_enc_layer):
        p = f"{v}layers.{i}."
        n_rel = 2 * (grid if i in sam.GLOBAL_ATTN else sam.WINDOW) - 1
        ln(p + "layer_norm1", C)
        lin(p + "attn.qkv", 3 * C, C)
        lin(p + "attn.proj", C, C)
        sd[p + "attn.rel_pos_h"] = w(n_rel, C // n_enc_head, fan=100)
        sd[p + "attn.rel_pos_w"] = w(n_rel, C // n_enc_head, fan=100)
        ln(p + "layer_norm2", C)
        lin(p + "mlp.lin1", 4 * C, C)
        lin(p + "mlp.lin2", C, 4 * C)
    sd[v + "neck.conv1.weight"] = w(E, C, 1, 1, fan=C)
    ln(v + "neck.layer_norm1", E)
    sd[v + "neck.conv2.weight"] = w(E, E, 3, 3, fan=9 * E)
    ln(v + "neck.layer_norm2", E)
    sd["prompt_encoder.shared_embedding.positional_embedding"] = w(2, E // 2, fan=1)
    sd["shared_image_embedding.positional_embedding"] = w(2, E // 2, fan=1)
    for name in ("point_embed.0", "point_embed.1", "not_a_point_embed", "no_mask_embed"):
        sd[f"prompt_encoder.{name}.weight"] = w(1, E, fan=1)
    m = "mask_decoder."
    sd[m + "iou_token.weight"] = w(1, E, fan=1)
    sd[m + "mask_tokens.weight"] = w(4, E, fan=1)
    lin(m + "upscale_conv1", E, E // 4, 2, 2)         # ConvTranspose2d: (IC, OC, KH, KW)
    sd[m + "upscale_conv1.bias"] = w(E // 4, fan=100)
    ln(m + "upscale_layer_norm", E // 4)
    lin(m + "upscale_conv2", E // 4, E // 8, 2, 2)
    sd[m + "upscale_conv2.bias"] = w(E // 8, fan=100)
    for prefix, n_out in [(f"{m}output_hypernetworks_mlps.{i}.", E // 8) for i in range(4)] + [
            (m + "iou_prediction_head.", 4)]:
        lin(prefix + "proj_in", E, E)
        lin(prefix + "layers.0", E, E)
        lin(prefix + "proj_out", n_out, E)

    def attn(prefix, inner):
        for s in ("q", "k", "v"):
            lin(f"{prefix}{s}_proj", inner, E)
        lin(prefix + "out_proj", E, inner)

    t = m + "transformer."
    for i in range(2):
        p = f"{t}layers.{i}."
        attn(p + "self_attn.", E)
        attn(p + "cross_attn_token_to_image.", E // 2)
        attn(p + "cross_attn_image_to_token.", E // 2)
        for j in range(1, 5):
            ln(p + f"layer_norm{j}", E)
        lin(p + "mlp.lin1", 2048, E)
        lin(p + "mlp.lin2", E, 2048)
    attn(t + "final_attn_token_to_image.", E // 2)
    ln(t + "layer_norm_final_attn", E)
    return sd


def magika_gguf(path: Path, seed: int = 0):
    """A Magika GGUF of random weights under the reference's TF-style
    tensor names, drawn as the reference's golden test draws its params."""
    rng = np.random.default_rng(seed)
    shapes = {"dense_w": (128, 257), "dense_b": (128,), "ln_g": (384,), "ln_b": (384,),
              "dense1_w": (256, 512), "dense1_b": (256,), "dense2_w": (256, 256),
              "dense2_b": (256,), "ln1_g": (256,), "ln1_b": (256,),
              "label_w": (MAGIKA_LABELS, 256), "label_b": (MAGIKA_LABELS,)}
    w = GGUFWriter()
    for key, shape in shapes.items():
        scale = 1.0 if key in ("ln_g", "ln1_g") else 0.1
        w.add_array_tensor(magika.TENSORS[key],
                           (rng.standard_normal(shape) * scale).astype(np.float32))
    w.write(path)


@contextlib.contextmanager
def torch_default_flags():
    """PyTorch's default flags for the enclosed checks (cuDNN's TF32 on,
    its non-deterministic algorithms allowed, matmul TF32 off), the smoke's
    settings restored after: the conv ops keep f32 in the forward and the
    backward, deterministic in the backward, whatever their caller set."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = (cudnn.allow_tf32, cudnn.deterministic, matmul.allow_tf32)
    cudnn.allow_tf32, cudnn.deterministic, matmul.allow_tf32 = True, False, False
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic, matmul.allow_tf32 = prev


def yolo_check(device) -> dict:
    """YOLOv3-tiny at YOLO_NET: the file loaded on the card and the CPU,
    both heads card vs CPU (cuDNN's TF32 flag at its default), one conv of
    the net through F.conv2d under TF32 (the error the ops keep out), the
    forward timed, and detect end to end on a YOLO_IMAGE photo beside the
    host time of its steps."""
    path = ROOT / "build" / "smoke_yolo.gguf"
    yolo_gguf(path, np.random.default_rng(11), YOLO_OBJ_BIAS)
    out = {"gguf_mb": path.stat().st_size / 1e6}
    lg, out["load_s"] = _timed(lambda: yolo.load(path, device=device))
    lc = yolo.load(path, device="cpu")
    path.unlink()
    out["params"] = sum(t.numel() for lyr in lc for t in lyr.values())
    timer = Timer(device)
    x = torch.from_numpy(np.random.default_rng(12).random((1, 3, YOLO_NET, YOLO_NET),
                                                           dtype=np.float32))
    xd = x.to(device)
    with torch.inference_mode():
        with torch_default_flags():
            got = [h.cpu() for h in yolo.forward(lg, xd)]
            h6 = torch.randn(1, 512, YOLO_NET // 32, YOLO_NET // 32,
                             generator=torch.Generator().manual_seed(13))
            tf32 = F.conv2d(h6.to(device), lg[6]["w"], padding=1).cpu()
        ref = yolo.forward(lc, x)
        out["tf32_conv_nmse"] = nmse(tf32, F.conv2d(h6, lc[6]["w"], padding=1))
        out["forward_ms"] = timer(lambda: yolo.forward(lg, xd), iters=5, warmup=1)
    out["images_per_s"] = 1e3 / out["forward_ms"]
    for name, g, r in zip(("layer_15", "layer_22"), got, ref):
        e = nmse(g, r)
        if not (e < VISION_BOUND and g.shape == r.shape):
            raise AssertionError(f"yolo {name} card vs CPU nmse {e} (bound {VISION_BOUND})")
        out[f"{name}_nmse"] = e
        out[f"{name}_shape"] = list(g.shape)
    photo = np.random.default_rng(14).random(YOLO_IMAGE, dtype=np.float32)
    dets, out["detect_s"] = _timed(lambda: yolo.detect(lg, photo, YOLO_NET, YOLO_NET))
    sized, out["letterbox_s"] = _timed(lambda: yolo.letterbox(photo, YOLO_NET, YOLO_NET))
    with torch.inference_mode():
        heads, out["detect_forward_s"] = _timed(lambda: [h[0].cpu().numpy() for h in yolo.forward(
            lg, torch.from_numpy(sized[None]).to(device))])
    _, img_h, img_w = YOLO_IMAGE

    def decode():
        d = yolo.decode_yolo_layer(heads[0], yolo.MASK16, YOLO_NET, YOLO_NET, img_w, img_h, 0.5)
        d += yolo.decode_yolo_layer(heads[1], yolo.MASK23, YOLO_NET, YOLO_NET, img_w, img_h, 0.5)
        return len(d), yolo.nms(d)

    (out["candidates"], split), out["decode_nms_s"] = _timed(decode)
    out["detections"] = len(dets)
    if not all(np.isfinite(d.box).all() and np.isfinite(d.classes).all() for d in dets):
        raise AssertionError("yolo detect gave a box or class vector that is not finite")
    if [d.box for d in split] != [d.box for d in dets]:
        raise AssertionError(f"detect kept {len(dets)} boxes, its steps {len(split)}")
    return out


def sam_flops(n_enc_state: int, n_enc_layer: int, n_enc_head: int, n_img_size: int) -> float:
    """Operations (2 per multiply-add) of encode_image as formulated: the
    patch conv; each layer's qkv, proj and MLP products over its tokens (a
    windowed layer's include the window padding: 25 windows of 196 tokens
    at grid 64), its materialised scores, their product with v and the
    two relative-position products; the neck's two convs."""
    C, grid, hd = n_enc_state, n_img_size // 16, n_enc_state // n_enc_head
    total = 2.0 * grid * grid * C * 3 * 16 * 16
    for i in range(n_enc_layer):
        side = grid if i in sam.GLOBAL_ATTN else sam.WINDOW
        n_win = 1 if i in sam.GLOBAL_ATTN else (-(-grid // sam.WINDOW)) ** 2
        T = side * side
        total += 2.0 * n_win * T * C * C * (3 + 1 + 4 + 4)
        total += n_win * n_enc_head * (2.0 * 2 * T * T * hd + 2.0 * 2 * T * side * hd)
    return total + 2.0 * grid * grid * 256 * (C + 256 * 9)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in (tree.values() if isinstance(tree, dict) else tree)
            for t in _tensors(v)]


def sam_check(device) -> dict:
    """SAM ViT-B (SAM_VIT_B): the params of an HF-style state dict
    written by save_gguf and read by load_gguf on the card and the CPU;
    the first SAM_CHECK_LAYERS encoder layers and the decoder card vs CPU
    on a full image (cuDNN's TF32 flag at its default); then every layer
    on the card: encode, one point prompt, decode, checked for shape and
    finite values, timed, and one encode and one decode traced."""
    cfg0 = sam.SamConfig(**SAM_VIT_B)
    path = ROOT / "build" / "smoke_sam.gguf"
    _, p0 = sam.from_hf(sam_state(**SAM_VIT_B, seed=21), cfg0.n_enc_layer, device="cpu")
    _, write_s = _timed(lambda: sam.save_gguf(path, cfg0, p0))
    del p0
    out = {"gguf_mb": path.stat().st_size / 1e6, "gguf_write_s": write_s}
    (cfg, pg), out["load_s"] = _timed(lambda: sam.load_gguf(path, device=device))
    _, pc = sam.load_gguf(path, device="cpu")
    path.unlink()
    out["params"] = sum(t.numel() for t in _tensors(pc))
    img = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (1, 3, cfg.n_img_size, cfg.n_img_size)).astype(np.float32))
    x = img.to(device)
    pts = np.asarray([SAM_POINT], np.float32)
    lbl = np.ones((1, len(SAM_POINT)), np.int32)
    cut = dataclasses.replace(cfg, n_enc_layer=SAM_CHECK_LAYERS)

    def run(c, p, im):
        enc = dict(p["enc"], blocks=p["enc"]["blocks"][:c.n_enc_layer])
        emb = sam.encode_image(c, enc, im)
        masks, iou = sam.decode_masks(c, p["dec"], p["pe"], emb,
                                      sam.encode_points(c, p["pe"], pts, lbl))
        return emb, masks, iou

    with torch.inference_mode():
        with torch_default_flags():
            got = [t.cpu() for t in run(cut, pg, x)]
        ref, out["cpu_check_s"] = _timed(lambda: run(cut, pc, img))
        del pc
        for name, g, r in zip(("embeddings", "masks", "iou"), got, ref):
            e = nmse(g, r)
            if not e < VISION_BOUND:
                raise AssertionError(f"sam {SAM_CHECK_LAYERS}-layer {name} card vs CPU nmse {e}")
            out[f"check_{name}_nmse"] = e
        torch.cuda.reset_peak_memory_stats()
        emb, masks, iou = run(cfg, pg, x)
        out["shapes"] = [list(t.shape) for t in (emb, masks, iou)]
        want = [[1, cfg.n_embed, cfg.n_grid, cfg.n_grid],
                [1, 4, 4 * cfg.n_grid, 4 * cfg.n_grid], [1, 4]]
        if out["shapes"] != want or not all(bool(torch.isfinite(t).all())
                                            for t in (emb, masks, iou)):
            raise AssertionError(f"sam {cfg.n_enc_layer} layers: shapes {out['shapes']} "
                                 f"(want {want}) or values not finite")
        timer = Timer(device)
        out["encode_ms"] = timer(lambda: sam.encode_image(cfg, pg["enc"], x), iters=3, warmup=1)
        out["decode_ms"] = timer(lambda: sam.decode_masks(
            cfg, pg["dec"], pg["pe"], emb, sam.encode_points(cfg, pg["pe"], pts, lbl)),
            iters=3, warmup=1)
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["encode_trace"] = trace_device(lambda: sam.encode_image(cfg, pg["enc"], x))
        out["decode_trace"] = trace_device(lambda: sam.decode_masks(
            cfg, pg["dec"], pg["pe"], emb, sam.encode_points(cfg, pg["pe"], pts, lbl)))
    out["iou"] = iou.cpu().tolist()
    for key in ("encode", "decode"):
        t = out[f"{key}_trace"]
        out[f"{key}_busy_share"] = (t["busy_ms"] / t["profiled_wall_ms"]
                                    if t["busy_ms"] is not None else None)
    out["encode_flops"] = sam_flops(**SAM_VIT_B)
    out["encode_bound_ms"] = out["encode_flops"] / PEAK["f32"] * 1e3
    return out


def synthetic_files(n: int, max_bytes: int, seed: int) -> list[bytes]:
    """n files of 0 to max_bytes bytes (the edges of the 512-byte blocks,
    then sizes spaced geometrically), random bytes, text, or half zeros."""
    rng = np.random.default_rng(seed)
    sizes = [0, 1, 511, 512, 513, 1535, 1536, 1537]
    sizes += np.geomspace(2048, max_bytes, max(n - len(sizes), 0)).astype(int).tolist()
    letters = np.frombuffer(_LETTERS.encode() + b" \n", np.uint8)
    files = []
    for k, size in enumerate(sizes[:n]):
        b = rng.choice(letters, size) if k % 3 == 1 else rng.integers(0, 256, size, np.uint8)
        if k % 3 == 2:
            b[: size // 2] = 0
        files.append(b.tobytes())
    return files


def magika_check(device) -> dict:
    """Magika: the file loaded on the card and the CPU; MAGIKA_FILES
    synthetic files classified on the card one by one (classify_bytes) and
    as one batch, against the CPU's batch: probabilities within 1e-6, the
    same labels; files/s of both on the card."""
    path = ROOT / "build" / "smoke_magika.gguf"
    magika_gguf(path, seed=31)
    pg, pc = magika.load(path, device=device), magika.load(path, device="cpu")
    path.unlink()
    files = synthetic_files(MAGIKA_FILES, MAGIKA_MAX_BYTES, seed=32)
    magika.classify_bytes(pg, files[0])       # warm-up
    one, one_s = _timed(lambda: np.stack([magika.classify_bytes(pg, f) for f in files]))

    def batch(p, dev):
        toks = torch.from_numpy(np.stack([magika.prepare_input(f) for f in files])).to(dev)
        with torch.inference_mode():
            return magika.forward(p, toks).cpu().numpy()

    many, many_s = _timed(lambda: batch(pg, device))
    ref = batch(pc, "cpu")
    err = float(max(np.abs(one - ref).max(), np.abs(many - ref).max()))
    same = bool((one.argmax(1) == ref.argmax(1)).all() and (many.argmax(1) == ref.argmax(1)).all())
    if not (err < 1e-6 and same):
        raise AssertionError(f"magika card vs CPU: max abs {err}, labels equal {same}")
    return {"files": len(files), "max_bytes": max(len(f) for f in files), "max_abs_err": err,
            "labels_equal": same, "labels": np.bincount(ref.argmax(1)).nonzero()[0].tolist(),
            "files_per_s_batch1": len(files) / one_s, "files_per_s_batch": len(files) / many_s}


def vision_phase(device) -> dict:
    """The vision phase: YOLOv3-tiny, SAM ViT-B and Magika (yolo_check,
    sam_check, magika_check); no counted kernel launches in it."""
    t0 = time.perf_counter()
    kernels.reset_launches()
    out = {"yolo": yolo_check(device), "sam": sam_check(device),
           "magika": magika_check(device), "launches": launches()}
    if _nonzero(out["launches"]):
        raise AssertionError(f"the vision phase launched {_nonzero(out['launches'])}")
    out["seconds"] = time.perf_counter() - t0
    return out


# ------------------------------------------------------------- phase 10: training

TRAIN_BOUND = 1e-10          # card vs CPU nmse: K2's gradients, MNIST's at equal params
# card vs CPU nmse of MNIST params after 3 independent steps: AdamW's first steps
# divide each gradient by its own magnitude, so a near-zero one turns f32 rounding
# into a move of up to alpha (the gradients themselves hold TRAIN_BOUND)
ADAM_BOUND = 1e-7
GPT2_TRAIN_BOUND = 1e-9      # card vs CPU nmse of GPT-2's loss and every gradient
K2_GRAD_CASES = ((32, 32), (32, 8))    # (H, KVH): llama-7B attention and a GQA case
K2_GRAD_N = 512              # N = M at pos 0, B 1, head dim 128
MNIST_IMAGES = 12000
MNIST_TEST = 2000
MNIST_BATCH = 500
MNIST_EPOCHS = 2
MNIST_ACC = {"fc": 0.9, "cnn": 0.85}   # the reference's tests' accuracies (tests/test_opt.py)
GPT2_124M = dict(n_vocab=50257, n_ctx=1024, n_embd=768, n_head=12, n_layer=12)
GPT2_SEQS = 32               # synthetic sequences of n_ctx + 1 tokens
GPT2_IDS = 512               # distinct token ids they draw from (so the loss can fall)
GPT2_BATCH = 4
GPT2_PERIOD = 2              # micro-batches per AdamW step
GPT2_CHECK = (2, 128)        # layers and tokens of the card-vs-CPU gradient check


def k2_grad_check(device, timer) -> dict:
    """K2's gradient (ops.causal_flash_attn on float K/V, the autograd
    Function): at B 1, N = M = K2_GRAD_N, D 128, pos 0, for each (H, KVH)
    of K2_GRAD_CASES, dq / dk / dv on the card == autograd through
    `_causal_ref` on the card bit for bit, within TRAIN_BOUND of the CPU's;
    the forward's output within TRAIN_BOUND of K2's plain version on the
    same card inputs; K2 launches once in the forward and never in the
    backward; forward + backward timed beside the plain recompute's and
    SDPA's, and its bound (pos a device
    tensor, as the engine passes it: an int is uploaded by a blocking copy,
    which would put the host's launches inside the timed interval)."""
    from ggml_gfx906_tpu_torch.ops import attention

    out = {}
    N, D = K2_GRAD_N, 128
    scale = 1.0 / D ** 0.5
    for H, KVH in K2_GRAD_CASES:
        rng = np.random.default_rng(40 + KVH)
        host = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                for shape in ((1, H, N, D), (1, KVH, N, D), (1, KVH, N, D), (1, H, N, D))]
        q, k, v, g = (t.to(device).requires_grad_(i < 3) for i, t in enumerate(host))
        pos = torch.zeros(1, dtype=torch.int32, device=device)

        def fwd_bwd(q=q, k=k, v=v, g=g):
            return torch.autograd.grad(ops.causal_flash_attn(q, k, v, pos), (q, k, v), g)

        def plain(q=q, k=k, v=v, g=g):
            return torch.autograd.grad(attention._causal_ref(q, k, v, pos, scale, 0.0),
                                       (q, k, v), g)

        b0 = kernels.K2.launches
        o = ops.causal_flash_attn(q, k, v, pos)
        b1 = kernels.K2.launches
        got = torch.autograd.grad(o, (q, k, v), g)
        b2 = kernels.K2.launches
        if not (b1 - b0 == int(q.is_cuda) and b2 == b1 and o.grad_fn is not None):
            raise AssertionError(f"K2 launches forward {b1 - b0}, backward {b2 - b1}, "
                                 f"grad_fn {o.grad_fn}")
        with torch.no_grad():
            fwd_plain = flash_attn.causal_flash_attention_plain(q, k, v, pos, scale)
        want = plain()
        hq, hk, hv = (t.requires_grad_() for t in host[:3])
        cpu = torch.autograd.grad(ops.causal_flash_attn(hq, hk, hv, pos.cpu()), (hq, hk, hv),
                                  host[3])
        row = {"fwd_nmse_vs_plain": nmse(o.detach(), fwd_plain),
               "fwd_max_abs_err": float((o.detach() - fwd_plain).abs().max()),
               "bit_equal_to_plain": all(torch.equal(a, b) for a, b in zip(got, want)),
               "nmse_vs_cpu": max(nmse(a.cpu(), b) for a, b in zip(got, cpu))}
        if not (row["fwd_nmse_vs_plain"] < TRAIN_BOUND and row["bit_equal_to_plain"]
                and row["nmse_vs_cpu"] < TRAIN_BOUND):
            raise AssertionError(f"K2 gradient H={H} KVH={KVH}: {row}")
        ks, vs = (t.detach().repeat_interleave(H // KVH, dim=1).requires_grad_() for t in (k, v))
        qs = q.detach().requires_grad_()
        sdpa = lambda: torch.autograd.grad(F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, is_causal=True, scale=scale), (qs, ks, vs), g)
        with torch.no_grad():
            row["fwd_ms"] = timer(lambda: ops.causal_flash_attn(q, k, v, pos), iters=10)
        row["fwd_bwd_ms"] = timer(fwd_bwd, iters=10)
        row["plain_fwd_bwd_ms"] = timer(plain, iters=10)
        row["sdpa_fwd_bwd_ms"] = timer(sdpa, iters=10)
        row["trace"], row["plain_trace"] = trace_device(fwd_bwd), trace_device(plain)
        # what forward + backward needs: QK^T and PV forward, dV, dP, dQ and
        # dK backward, each over the N(N+1)/2 unmasked scores at pos 0, 2
        # operations per multiply-add (the backward's recompute of the
        # forward is the port's choice, not counted); q, k, v and g read,
        # o, dq, dk and dv written once
        row["flops"] = 12.0 * D * H * (N * (N + 1) // 2)
        nbytes = 2 * 4 * (2 * q.numel() + 2 * k.numel())
        row["bound_ms"], row["bound_by"] = bound(nbytes, row["flops"], "f32")
        out[f"H={H} KVH={KVH}"] = row
    return out


def _tree_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def forward_cnn_tf32(params, x):
    """mnist.forward_cnn with its two convolutions through F.conv2d, outside
    the conv ops' pins: under PyTorch's default flags their forward and
    backward round through TF32. The control that ADAM_BOUND and
    TRAIN_BOUND must fail."""
    b, hw = x.shape[0], mnist.HW
    h = x.reshape(b, 1, hw, hw)
    for i in (1, 2):
        h = F.conv2d(h, params[f"conv{i}_k"], padding=(1, 1))
        h = ops.relu(h + params[f"conv{i}_b"][None, :, None, None])
        h = ops.pool_2d(h, "max", (2, 2), (2, 2))
    return h.reshape(b, -1) @ params["dense_w"].T + params["dense_b"]


def _loss_grads(fwd, params, x, y) -> list:
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = mnist.loss_fn(fwd)(live, x, y)
    return [loss.detach()] + list(torch.autograd.grad(loss, tree_leaves(live)))


def mnist_steps(arch, X, Y, device, fwd=None) -> dict:
    """3 train steps at MNIST_BATCH card vs CPU through `fwd` (the arch's
    forward by default): the loss and every gradient of each step on the
    card at the CPU's params (max nmse over the leaves, per step), and the
    params after the card's own 3 steps against the CPU's (max nmse over
    the leaves). For the leaf furthest apart: its elements, how many
    differ at all and by more than alpha / 1000, the largest difference;
    at the elements over alpha / 1000 the CPU's first moment |m| (the
    gradients' running mean; largest and median) and the largest of their
    smallest |gradient| over the steps, each beside its median over the
    leaf."""
    fwd, B = fwd or mnist.FORWARD[arch], MNIST_BATCH
    hp = AdamWParams()
    step = make_train_step(mnist.loss_fn(fwd), hp, 1)
    batches = [(torch.from_numpy(X[ib * B:(ib + 1) * B]), torch.from_numpy(Y[ib * B:(ib + 1) * B]))
               for ib in range(3)]
    ends, grads, moments, cpu_grads = [], [], None, []
    for side, dev in enumerate((torch.device("cpu"), device)):
        p = mnist.INIT[arch](0, dev)
        st, acc = adamw_init(p), tree_map(torch.zeros_like, p)
        for ib, (x, y) in enumerate(batches):
            if side == 0:
                ref = _loss_grads(fwd, p, x, y)
                cpu_grads.append(dict(zip(p, ref[1:])))
                got = _loss_grads(fwd, tree_map(lambda t: t.to(device), p), x.to(device),
                                  y.to(device))
                grads.append(max(nmse(a.cpu(), b) for a, b in zip(got, ref)))
            p, st, acc, _ = step(p, st, acc, ib, x.to(dev), y.to(dev))
        ends.append(p)
        if side == 0:
            moments = st["m"]
    apart = {name: nmse(ends[1][name].cpu(), ref) for name, ref in ends[0].items()}
    name = max(apart, key=apart.get)
    diff = (ends[1][name].cpu() - ends[0][name]).abs().flatten()
    m = moments[name].abs().flatten()
    g = torch.stack([step_grads[name].abs().flatten() for step_grads in cpu_grads])
    big = diff > hp.alpha / 1000
    there = big.any()
    worst = {"leaf": name, "elements": diff.numel(), "differ": int((diff > 0).sum()),
             "over_alpha_1e-3": int(big.sum()), "max_abs_diff": float(diff.max()),
             "m_abs_max_there": float(m[big].max()) if there else None,
             "m_abs_median_there": float(m[big].median()) if there else None,
             "m_abs_median": float(m.median()),
             "g_abs_min_over_steps_max_there": float(g.min(0).values[big].max()) if there else None,
             "g_abs_median": float(g.median())}
    return {"grads_nmse_vs_cpu": grads, "params": ends[1], "steps_nmse_vs_cpu": apart[name],
            "worst_leaf": worst}


def mnist_check(device, timer) -> dict:
    """MNIST fc and cnn at the reference's widths on MNIST_IMAGES synthetic
    images, with PyTorch's default flags: 3 train steps at MNIST_BATCH card
    vs CPU (mnist_steps: each step's gradients < TRAIN_BOUND, the params
    after the steps < ADAM_BOUND; for the cnn the same through
    forward_cnn_tf32, which must exceed both); a step timed; `train` for MNIST_EPOCHS with
    val_split 0.05 to MNIST_ACC on MNIST_TEST held-out images; the GGUF
    round trip; `fit` for one epoch with a checkpoint directory, then a
    fresh call to MNIST_EPOCHS, bit-equal to `train`."""
    X, Y = mnist.synthetic_mnist(MNIST_IMAGES, seed=0)
    Xt, Yt = mnist.synthetic_mnist(MNIST_TEST, seed=1)
    B = MNIST_BATCH
    out = {}
    for arch in ("fc", "cnn"):
        fwd = mnist.FORWARD[arch]
        step = make_train_step(mnist.loss_fn(fwd), AdamWParams(), 1)
        r = mnist_steps(arch, X, Y, device)
        p = r.pop("params")
        if not (max(r["grads_nmse_vs_cpu"]) < TRAIN_BOUND and r["steps_nmse_vs_cpu"] < ADAM_BOUND):
            raise AssertionError(f"mnist {arch} card vs CPU: gradients per step "
                                 f"{r['grads_nmse_vs_cpu']} (bound {TRAIN_BOUND}), params after "
                                 f"3 steps {r['steps_nmse_vs_cpu']} (bound {ADAM_BOUND})")
        if arch == "cnn":
            tf32 = mnist_steps(arch, X, Y, device, fwd=forward_cnn_tf32)
            r["tf32_grads_nmse_vs_cpu"] = tf32["grads_nmse_vs_cpu"]
            r["tf32_steps_nmse_vs_cpu"] = tf32["steps_nmse_vs_cpu"]
            r["tf32_worst_leaf"] = tf32["worst_leaf"]
            if device.type == "cuda" and not (min(tf32["grads_nmse_vs_cpu"]) > TRAIN_BOUND
                                              and tf32["steps_nmse_vs_cpu"] > ADAM_BOUND):
                raise AssertionError(f"mnist cnn: the TF32 control passed the bounds "
                                     f"(gradients {tf32['grads_nmse_vs_cpu']}, params "
                                     f"{tf32['steps_nmse_vs_cpu']}): they do not separate")
        x, y = torch.from_numpy(X[:B]).to(device), torch.from_numpy(Y[:B]).to(device)
        st, acc = adamw_init(p), tree_map(torch.zeros_like, p)
        r["step_device_ms"] = timer(lambda: step(p, st, acc, 0, x, y), iters=10)
        _, wall = _timed(lambda: [step(p, st, acc, 0, x, y) for _ in range(20)])
        r["step_ms"] = wall / 20 * 1e3
        r["images_per_s"] = B / (wall / 20)
        kw = dict(n_epochs=MNIST_EPOCHS, batch_size=B, val_split=0.05, seed=0, verbose=False)
        (params, res), r["train_s"] = _timed(lambda: mnist.train(arch, X, Y, device=device, **kw))
        r["train_loss"], r["val_acc"] = res.train_loss, res.val_acc
        r["accuracy"] = mnist.evaluate(arch, params, Xt, Yt)
        if not r["accuracy"] > MNIST_ACC[arch]:
            raise AssertionError(f"mnist {arch}: accuracy {r['accuracy']} after "
                                 f"{MNIST_EPOCHS} epochs (want > {MNIST_ACC[arch]})")
        path = ROOT / "build" / f"smoke_mnist_{arch}.gguf"
        mnist.save_gguf(arch, params, path)
        arch2, back = mnist.load_gguf(path, device=device)
        path.unlink()
        if not (arch2 == arch and mnist.evaluate(arch, back, Xt, Yt) == r["accuracy"]):
            raise AssertionError(f"mnist {arch}: the GGUF round trip changed the accuracy")
        ck = ROOT / "build" / f"smoke_ckpt_{arch}"
        shutil.rmtree(ck, ignore_errors=True)

        def run(n_epochs):
            return fit(mnist.loss_fn(fwd), mnist.INIT[arch](0, device),
                       Dataset(X.astype(np.float32), Y.astype(np.float32)),
                       hp=AdamWParams(alpha=1e-3), accuracy_fn=mnist.accuracy_fn(fwd),
                       checkpoint_dir=str(ck), **dict(kw, n_epochs=n_epochs))

        run(1)
        resumed, rres = run(MNIST_EPOCHS)
        shutil.rmtree(ck)
        r["resume_bit_equal"] = _tree_equal(params, resumed) and rres.train_loss == res.train_loss
        if not r["resume_bit_equal"]:
            raise AssertionError(f"mnist {arch}: the resumed fit differs from the straight one")
        out[arch] = r
    return out


def gpt2_loss(cfg):
    """cross_entropy_loss(forward_train(x), one_hot(y)), the one-hot built
    on the labels' device."""
    def f(params, x, y):
        onehot = torch.zeros(*y.shape, cfg.n_vocab, device=y.device).scatter_(
            -1, y[..., None], 1.0)
        return ops.cross_entropy_loss(gpt2.forward_train(cfg, params, x), onehot)
    return f


def gpt2_train_flops(cfg, tokens: int, seq: int) -> float:
    """Operations (2 per multiply-add) of one forward + backward as
    formulated: each matrix (the tied head included) once forward and
    twice backward over the tokens, and the materialised attention's two
    products over full S x S scores, likewise three times."""
    D = cfg.n_embd
    mats = cfg.n_layer * 12 * D * D + cfg.n_vocab * D
    attn = cfg.n_layer * 2 * 2 * seq * D * tokens
    return 3 * (2.0 * mats * tokens + attn)


def gpt2_check(device, timer) -> dict:
    """GPT-2 124M (GPT2_124M, OpenAI's gpt2 config.json; f32, weights from
    gpt2.random_params) trained on GPT2_SEQS synthetic sequences: at full
    width cut to GPT2_CHECK, the loss and every gradient card vs CPU (and
    two equal card passes bit-equal); `fit` at GPT2_BATCH x n_ctx tokens
    with GPT2_PERIOD micro-batches a step, one epoch (finite losses, the
    last below the first), run twice for bit-equal params; ms per
    micro-batch, tokens/s, peak memory, one micro-batch traced;
    cross_entropy_loss's forward + backward at the run's shape beside
    F.cross_entropy's."""
    cfg = gpt2.GPT2Config(**GPT2_124M)
    S, V = cfg.n_ctx, cfg.n_vocab
    rng = np.random.default_rng(50)
    ids = rng.choice(V, GPT2_IDS, replace=False)
    seqs = ids[rng.integers(0, GPT2_IDS, (GPT2_SEQS, S + 1))].astype(np.int64)
    loss_fn = gpt2_loss(cfg)
    out = {"flops_per_micro_batch": gpt2_train_flops(cfg, GPT2_BATCH * S, S)}
    out["bound_ms"] = out["flops_per_micro_batch"] / PEAK["f32"] * 1e3

    n_layer, T = GPT2_CHECK
    small = dataclasses.replace(cfg, n_layer=n_layer)
    pc = gpt2.random_params(small, seed=51, device="cpu")
    x, y = torch.from_numpy(seqs[:1, :T]), torch.from_numpy(seqs[:1, 1:T + 1])

    def grads(p, dev):
        live = tree_map(lambda t: t.to(dev).requires_grad_(), p)
        loss = gpt2_loss(small)(live, x.to(dev), y.to(dev))
        return [loss.detach()] + list(torch.autograd.grad(loss, tree_leaves(live)))

    got, again, ref = grads(pc, device), grads(pc, device), grads(pc, "cpu")
    out["check_bit_equal_twice"] = all(torch.equal(a, b) for a, b in zip(got, again))
    out["check_nmse"] = [nmse(a.cpu(), b) for a, b in zip(got, ref)]
    if not (out["check_bit_equal_twice"] and max(out["check_nmse"]) < GPT2_TRAIN_BOUND):
        raise AssertionError(f"gpt2 {n_layer} layers card vs CPU: loss and gradient nmse "
                             f"{out['check_nmse']}, two passes bit-equal "
                             f"{out['check_bit_equal_twice']}")
    del got, again, ref, pc

    params, out["init_s"] = _timed(lambda: gpt2.random_params(cfg, seed=52, device=device))
    out["params"] = sum(t.numel() for t in tree_leaves(params))
    losses = []

    def recorded(p, bx, by):
        loss = loss_fn(p, bx, by)
        losses.append(loss.detach())
        return loss

    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        losses.clear()
        ds = Dataset(seqs[:, :-1], seqs[:, 1:])
        (trained, _), wall = _timed(lambda: fit(recorded, params, ds, GPT2_BATCH,
                                                opt_period=GPT2_PERIOD, verbose=False))
        runs.append((trained, torch.stack(losses).tolist(), wall))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["losses"] = runs[1][1]
    out["micro_batches"] = len(out["losses"])
    out["adamw_steps"] = out["micro_batches"] // GPT2_PERIOD
    out["deterministic"] = _tree_equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    out["fit_s"] = [r[2] for r in runs]
    out["ms_per_micro_batch"] = runs[1][2] / out["micro_batches"] * 1e3
    out["tokens_per_s"] = out["micro_batches"] * GPT2_BATCH * S / runs[1][2]
    ls = out["losses"]
    if not (all(np.isfinite(ls)) and ls[-1] < ls[0] and out["deterministic"]):
        raise AssertionError(f"gpt2 training: losses {ls}, two runs bit-equal "
                             f"{out['deterministic']}")
    del runs

    step = make_train_step(loss_fn, AdamWParams(), GPT2_PERIOD)
    p = tree_map(torch.clone, params)
    st, acc = adamw_init(p), tree_map(torch.zeros_like, p)
    bx = torch.from_numpy(seqs[:GPT2_BATCH, :-1]).to(device)
    by = torch.from_numpy(seqs[:GPT2_BATCH, 1:]).to(device)
    step(p, st, acc, 0, bx, by)
    _, ms = _timed(lambda: step(p, st, acc, 1, bx, by))
    out["micro_batch_with_step_ms"] = ms * 1e3
    out["trace"] = trace_device(lambda: step(p, st, acc, 1, bx, by))
    t = out["trace"]
    out["busy_share"] = (t["busy_ms"] / out["micro_batch_with_step_ms"]
                         if t["busy_ms"] is not None else None)
    del p, st, acc
    logits = torch.randn(GPT2_BATCH, S, V, device=device, requires_grad=True)
    onehot = torch.zeros(GPT2_BATCH, S, V, device=device).scatter_(-1, by[..., None], 1.0)
    out["cross_entropy_fwd_bwd_ms"] = timer(lambda: torch.autograd.grad(
        ops.cross_entropy_loss(logits, onehot), logits), iters=5, warmup=1)
    out["library_cross_entropy_fwd_bwd_ms"] = timer(lambda: torch.autograd.grad(
        F.cross_entropy(logits.view(-1, V), by.reshape(-1)), logits), iters=5, warmup=1)
    return out


def training_phase(device) -> dict:
    """The training phase (k2_grad_check, mnist_check, gpt2_check), each
    under PyTorch's default flags; no counted kernel launches across the
    MNIST and GPT-2 runs."""
    t0 = time.perf_counter()
    timer = Timer(device)
    with torch_default_flags():
        out = {"k2_grad": k2_grad_check(device, timer)}
        kernels.reset_launches()
        out["mnist"] = mnist_check(device, timer)
        out["gpt2"] = gpt2_check(device, timer)
        out["launches"] = launches()
    if _nonzero(out["launches"]):
        raise AssertionError(f"the MNIST and GPT-2 runs launched {_nonzero(out['launches'])}")
    out["seconds"] = time.perf_counter() - t0
    return out


# phase 3, by name (--checks)
# ------------------------------------------------------------- parallel

# Llama-3-8B at its published width (meta-llama/Meta-Llama-3-8B config.json:
# 4096, 32 heads / 8 KV, 14336, vocab 128256, rope θ 500000, RMS eps 1e-5):
# n_ff 14336 = 56·256 splits by column at tp = 2, where Llama-2-7B's 11008 =
# 43·256 does not
LLAMA3_8B = dict(n_vocab=128256, n_ctx=8192, n_embd=4096, n_head=32, n_kv_head=8,
                 n_ff=14336, rope_base=500000.0)
# (tp = 2 shard, whole) (N, K) of the file's products and the kernels that
# take them: K1 at decode (M = 8 slots), K3 at a 128-row prefill chunk, K4
# on the Q4_K_M file's Q6_K attn_v / ffn_down
TP_SHAPES = ((((2048, 4096), (4096, 4096)), "wq rows", False),
             (((512, 4096), (1024, 4096)), "wk / wv rows", True),
             (((7168, 4096), (14336, 4096)), "w_gate / w_up rows", False),
             (((4096, 2048), (4096, 4096)), "wo columns", False),
             (((4096, 7168), (4096, 14336)), "w_down columns", True))
# the phase's sizes: the file (Llama-3-8B at SHORT_LAYERS); ep: Mixtral-8x7B's
# expert stack (mistralai/Mixtral-8x7B-v0.1: 8 experts of 14336 x 4096,
# w_gate's, top-2) for ep_tokens tokens; sp: ring attention at Llama-3-8B's
# (B, H, KV heads, S, D); pp: (dense bf16 blocks at Llama-3-8B's width,
# micro-batches, tokens per micro-batch)
PAR_SIZES = {"cfg": LLAMA3_8B, "layers": SHORT_LAYERS, "ep": (8, 14336, 4096),
             "ep_tokens": 100, "sp": (1, 32, 8, 4096, 128), "pp": (4, 4, 128)}
SP_BOUND = 1e-10                   # the reference tests/test_sp.py's bound
# bf16 logits: the stages run the single forward's blocks at its shapes, and
# the head's product over all micro-batches at once may round a logit one
# bf16 ulp (up to 2^-7 relative) away from the per-micro-batch product's
PP_BOUND = 2.0 ** -14
# gloo tp = 2's logits on the default route (K3 at the 100-token prompt)
# against the single forward's on the same route: the activations'
# per-tile int8 quantization turns the all-reduce's last-bit differences
# into whole int8 steps (8.8e-4 on the card), a quarter of the distance
# that the int8 route itself keeps from the f32 route (3.65e-3, recorded
# as int8_vs_f32_route_logits_nmse); a sharding fault gives O(1)
TP_INT8_BOUND = 2e-3
AR_REPS = 200


def check_tp(device, timer, results):
    """K1 (M = 8), K3 (M = 128) and K4 (M = 8, the Q6_K products) at the
    Llama-3-8B-width file's tp = 2 shard shapes, each held against its
    plain version (check_f32 / check_i8, rows in `results`) and timed beside
    the whole shape it is cut from."""
    gen = torch.Generator(device=device).manual_seed(8)
    pairs = []
    for (shard, whole), what, q6 in TP_SHAPES:
        ms = {}
        for tag, (n, k) in (("shard", shard), ("whole", whole)):
            qs, scm, dd = random_q4k(n, k, device, gen)
            w_dense = qmm.dequant(qs, scm, dd)
            wbytes = n * k / 2 + n * k / 16 + n * k / 32
            check_f32(timer, results, "K1 tp", kernels.K1,
                      lambda x: qmm.qmm_q4_K(x, qs, scm, dd),
                      lambda x: qmm.qmm_q4_K_plain(x, qs, scm, dd),
                      torch.randn((8, k), device=device, generator=gen), w_dense, wbytes)
            ms[f"K1 {tag}"] = results[-1]["ms"]
            check_i8(timer, results, k3_launches(qs, scm, dd),
                     torch.randn((128, k), device=device, generator=gen), w_dense, wbytes)
            ms[f"K3 {tag}"] = results[-1]["ms"]
            if q6:
                nb = k // 256
                w = (torch.randint(0, 256, (n, nb * 128), dtype=torch.uint8, device=device,
                                   generator=gen),
                     torch.randint(0, 256, (n, nb * 64), dtype=torch.uint8, device=device,
                                   generator=gen),
                     torch.randint(-128, 128, (n, nb * 16), dtype=torch.int8, device=device,
                                   generator=gen),
                     torch.rand((n, nb), device=device, generator=gen) * 1e-3)
                check_f32(timer, results, "K4 tp", kernels.K4,
                          lambda x: qmm_q6k.qmm_q6_K(x, *w),
                          lambda x: qmm_q6k.qmm_q6_K_plain(x, *w),
                          torch.randn((8, k), device=device, generator=gen), qmm_q6k.dequant(*w),
                          n * k * 6.625 / 8)
                ms[f"K4 {tag}"] = results[-1]["ms"]
            del w_dense
        pairs.append({"what": what, "shard": list(shard), "whole": list(whole), "ms": ms})
        log(f"tp shard {what} {shard} vs whole {whole}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()))
    return {"pairs": pairs}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _greedy_tp(mesh, cfg, params, prompt, n_new, device) -> tuple[list, list]:
    """prompt + n_new greedy tokens through tp_forward and tp_decode_step
    on a fresh head-shard cache, and each step's host ms (the token read
    back each step)."""
    kv = tp.shard_kv(mesh, llama.make_cache(cfg, 1024, device=device), batched=False)
    logits, kv = tp.tp_forward(mesh, cfg, params, torch.tensor(prompt, device=device), kv, 0)
    tok = torch.argmax(logits[-1]).to(torch.int32)[None]
    out, step_ms = list(prompt) + [int(tok[0])], []
    for i in range(n_new - 1):
        t0 = time.perf_counter()
        tok, kv = tp.tp_decode_step(mesh, cfg, params, tok, kv, len(prompt) + i)
        out.append(int(tok[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return out, step_ms


def free_port() -> int:
    """A TCP port of 127.0.0.1 that is free now (a store's rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _replay_launches(eng) -> dict:
    """Each captured window's kernel launches per replay, by window/depth/flow."""
    return {f"{key[5]}/{key[6]}/{key[8]}": {k.name: n for k, n in g.launches}
            for key, g in eng.graphs.graphs.items()}


def _steady(eng, prompts):
    """The engine with every slot decoding and no admission pending."""
    for p in prompts:
        eng.submit(p, 64)
    while eng.queue or eng.pending is not None:
        eng.step()
    assert all(s is not None for s in eng.slots)


@torch.inference_mode()
def parallel_nccl(device, cfg, params, refs: dict) -> dict:
    """Phase 11 b: a mesh at world size 1 (launch.initialize, a tcp:// store) in this process,
    NCCL on the card (gloo on the CPU, where the phase is rehearsed), the
    mesh's collectives on the capture-friendly path. tp_forward and the
    tp_decode_step stream are bit-equal to llama.forward and generate; the
    mesh Engine's 8+1 streams equal the mesh-free Engine's, its windows are
    captured on the NCCL mesh (at world size 1 the all-reduce launches no
    kernel: the capture holds no collective), their launches per replay equal
    the mesh-free engine's, and one steady-state window is traced. Fills
    refs with the single-process results the gloo ranks check against."""
    launch.initialize(f"127.0.0.1:{free_port()}", 1, 0, device=device)   # NCCL on the card
    out = {}
    n_new, reqs = refs["n_new"], refs["prompts"] + [refs["long_prompt"]]
    try:
        mesh = make_mesh(tp=1, device=device)
        out["backend"], out["device"] = mesh.backend, str(mesh.device)
        sp = tp.shard_llama_params(mesh, params)
        toks = torch.tensor(refs["prompt"], device=device)

        def fwd(c, p, cache):
            return llama.forward(c, p, toks, cache(llama.make_cache(c, 1024, device=device)),
                                 0)[0]

        single, tp1 = (lambda kv: kv), (lambda kv: tp.shard_kv(mesh, kv, batched=False))
        ref_i8 = fwd(cfg, params, single)       # the default route: K3 at M = 100
        if not torch.equal(tp.tp_forward(mesh, cfg, sp, toks, tp1(llama.make_cache(
                cfg, 1024, device=device)), 0)[0], ref_i8):
            raise AssertionError("tp=1: tp_forward differs from llama.forward")
        # the references of the gloo ranks' tp = 2 forward, every product on
        # the f32 route (int8_min_m = 0: the int8 route's per-tile activation
        # quantization turns a last-bit difference of the partial sums into
        # a whole quantization step), at bf16 and at f32 compute; their
        # distance is what bf16 rounding alone makes
        f32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
        config.set("int8_min_m", 0)
        try:
            ref, ref32 = fwd(cfg, params, single), fwd(f32, params, single)
        finally:
            config.unset("int8_min_m")
        out["bf16_vs_f32_logits_nmse"] = nmse(ref, ref32)
        out["int8_vs_f32_route_logits_nmse"] = nmse(ref_i8, ref)
        generated = llama.generate(cfg, params, refs["prompt"], n_new, max_seq=1024,
                                   device=device)
        stream, step_ms = _greedy_tp(mesh, cfg, sp, refs["prompt"], n_new, device)
        if stream != generated:
            raise AssertionError("tp=1: the tp_decode_step stream differs from generate's")
        out["tp_decode_step_ms"] = float(np.median(step_ms))
        base = Engine(llama, cfg, params, max_batch=8, max_seq=1024, device=device)
        base_done = serve(base, reqs, n_new)
        eng = Engine(llama, cfg, sp, max_batch=8, max_seq=1024, mesh=mesh)
        _sync(device)
        t0 = time.perf_counter()
        done = serve(eng, reqs, n_new)
        _sync(device)
        out["engine_first_run_s"] = time.perf_counter() - t0
        if done != base_done:
            raise AssertionError("tp=1: the mesh Engine's streams differ from the mesh-free "
                                 "Engine's")
        out["captured"] = eng.graphs.captured
        if device.type == "cuda" and not (eng.graphs.captured and eng.graphs.graphs):
            raise AssertionError("NCCL tp=1: the mesh Engine's windows were not captured")
        out["launches_per_replay"] = _replay_launches(eng)
        if out["launches_per_replay"] != _replay_launches(base):
            raise AssertionError(f"tp=1: launches per replay {out['launches_per_replay']}, "
                                 f"the mesh-free engine's {_replay_launches(base)}")
        _sync(device)
        t0 = time.perf_counter()
        if serve(eng, reqs, n_new) != done:
            raise AssertionError("tp=1: the mesh Engine's second run differs")
        _sync(device)
        out["engine_s"] = time.perf_counter() - t0
        out["engine_tok_s"] = sum(map(len, done)) / out["engine_s"]
        out["graphs"] = graph_stats(eng.graphs)
        del base, eng
        gc.collect()
        for name, mk in (("mesh_free_window", lambda: Engine(llama, cfg, params, max_batch=8,
                                                             max_seq=1024, device=device)),
                         ("nccl_window", lambda: Engine(llama, cfg, sp, max_batch=8,
                                                        max_seq=1024, mesh=mesh))):
            e = mk()
            _steady(e, refs["prompts"])
            out[name] = scan_window(e, ("nccl", "Nccl"))
            del e
            gc.collect()
        refs.update(logits=ref.float().cpu(), logits_f32=ref32.cpu(),
                    logits_int8_route=ref_i8.float().cpu(), generate=generated,
                    engine=base_done, bf16_nmse=out["bf16_vs_f32_logits_nmse"])
    finally:
        dist.destroy_process_group()
    return out


def _ar_ms(mesh, device, width: int) -> float:
    """ms of one all-reduce of a decode step's (1, width) bf16 sublayer
    output on the tp group, host clock over AR_REPS synchronised calls."""
    t = torch.randn((1, width), device=device).to(torch.bfloat16)
    for _ in range(10):
        all_reduce(t, mesh.groups["tp"])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(AR_REPS):
        all_reduce(t, mesh.groups["tp"])
    _sync(device)
    return (time.perf_counter() - t0) / AR_REPS * 1e3


def _load(path: Path, device):
    cfg, params = llama.load(path, device=device)
    return dataclasses.replace(cfg, compute_dtype=torch.bfloat16), params


@torch.inference_mode()
def gloo_tp2(device, path: Path, refs: dict) -> dict:
    """Phase 11 c at tp = 2: this rank's half of every weight; tp_forward's
    logits against the single-process forward's on the f32 route
    (int8_min_m = 0), at f32 compute within the reference test's 1e-9 and
    at bf16 within the distance bf16 rounding itself makes (the single
    forward at bf16 against f32: the tp sums add two roundings a layer to
    the many every activation takes); on the default route (K3 for the
    100-token prompt) within TP_INT8_BOUND; the greedy tp_decode_step
    stream's first divergence from generate's, the mesh Engine (uncaptured) over the 8+1
    requests == the mesh's tp_decode_step greedy streams, every request (at
    int8_min_m = 0: the flood and a lone prompt on one route), the time of a
    decode step and of one all-reduce."""
    out = {}
    mesh = make_mesh(tp=2, device=device, backend="gloo")
    cfg, full = _load(path, device)
    params = tp.shard_llama_params(mesh, full)
    del full
    gc.collect()
    out["weights_gb"] = sum(t.nbytes if isinstance(t, QuantTensor)
                            else t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    n_new, reqs = refs["n_new"], refs["prompts"] + [refs["long_prompt"]]
    toks = torch.tensor(refs["prompt"], device=device)

    def logits_nmse(c, key):
        kv = tp.shard_kv(mesh, llama.make_cache(c, 1024, device=device), batched=False)
        return nmse(tp.tp_forward(mesh, c, params, toks, kv, 0)[0].float().cpu(), refs[key])

    config.set("int8_min_m", 0)
    try:
        for c, key, want in ((dataclasses.replace(cfg, compute_dtype=torch.float32),
                              "logits_f32", 1e-9), (cfg, "logits", refs["bf16_nmse"])):
            out[key + "_nmse"], out[key + "_bound"] = logits_nmse(c, key), want
            if not out[key + "_nmse"] < want:
                raise AssertionError(f"gloo tp=2: {key} nmse {out[key + '_nmse']:.3e} over "
                                     f"the bound {want:.3e}")
    finally:
        config.unset("int8_min_m")
    out["logits_int8_route_nmse"] = logits_nmse(cfg, "logits_int8_route")
    out["logits_int8_route_bound"] = TP_INT8_BOUND
    if not out["logits_int8_route_nmse"] < TP_INT8_BOUND:
        raise AssertionError(f"gloo tp=2: int8-route logits nmse "
                             f"{out['logits_int8_route_nmse']:.3e} over {TP_INT8_BOUND}")
    stream, step_ms = _greedy_tp(mesh, cfg, params, refs["prompt"], n_new, device)
    out["first_divergence_vs_generate"] = first_divergence(stream, refs["generate"])
    out["decode_step_ms"] = float(np.median(step_ms))
    out["all_reduce_ms"] = _ar_ms(mesh, device, cfg.n_embd)
    out["all_reduces_per_step"] = 2 * cfg.n_layer
    out["all_reduce_share"] = (out["all_reduce_ms"] * out["all_reduces_per_step"]
                               / out["decode_step_ms"])
    if device.type == "cuda":
        kv = tp.shard_kv(mesh, llama.make_cache(cfg, 1024, device=device), batched=False)
        tok = torch.tensor([stream[-1]], device=device)
        t = out["decode_step_trace"] = trace_device(
            lambda: tp.tp_decode_step(mesh, cfg, params, tok, kv, 0), ("Memcpy", "memcpy"))
        t["busy_share"] = None if t["busy_ms"] is None else t["busy_ms"] / out["decode_step_ms"]
    config.set("int8_min_m", 0)
    try:
        eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, mesh=mesh)
        _sync(device)
        t0 = time.perf_counter()
        done = serve(eng, reqs, n_new)
        _sync(device)
        out["engine_s"] = time.perf_counter() - t0
        out["engine_captured"] = eng.graphs.captured
        greedy = [_greedy_tp(mesh, cfg, params, p, n_new, device)[0][len(p):] for p in reqs]
    finally:
        config.unset("int8_min_m")
    bad = [len(p) for p, a, b in zip(reqs, done, greedy) if a != b]
    if bad or eng.graphs.captured:
        raise AssertionError(f"gloo tp=2: engine streams differ from tp_decode_step's for "
                             f"prompt lengths {bad} (captured {eng.graphs.captured})")
    out["engine_tok_s"] = sum(map(len, done)) / out["engine_s"]
    out["engine_asserted"] = [len(p) for p in reqs]
    del eng, params
    gc.collect()
    return out


@torch.inference_mode()
def gloo_dp2(device, path: Path, refs: dict) -> dict:
    """Phase 11 c at dp = 2, tp = 1: every weight on both ranks, four slots
    each; the mesh Engine's 8+1 streams == the mesh-free Engine's."""
    mesh = make_mesh(dp=2, device=device, backend="gloo")
    cfg, params = _load(path, device)
    params = tp.shard_llama_params(mesh, params)
    reqs = refs["prompts"] + [refs["long_prompt"]]
    eng = Engine(llama, cfg, params, max_batch=8, max_seq=1024, mesh=mesh)
    done = serve(eng, reqs, refs["n_new"])
    if done != refs["engine"]:
        raise AssertionError("gloo dp=2: the mesh Engine's streams differ from the mesh-free "
                             "Engine's")
    _sync(device)
    t0 = time.perf_counter()
    serve(eng, reqs, refs["n_new"])
    _sync(device)
    s = time.perf_counter() - t0
    out = {"engine_s": s, "engine_tok_s": sum(map(len, done)) / s,
           "slots_per_rank": eng.kv.lengths.shape[0]}
    del eng, params
    gc.collect()
    return out


def _timed_ms(fn, device) -> tuple[object, float]:
    _sync(device)
    t0 = time.perf_counter()
    r = fn()
    _sync(device)
    return r, (time.perf_counter() - t0) * 1e3


@torch.inference_mode()
def gloo_ep2(device, sizes: dict) -> dict:
    """Phase 11 d: an expert stack of Q4_K weights over ep = 2 (half the
    experts per rank), top-2 routing of bf16 tokens: ep_mul_mat_id ==
    ops.mul_mat_id bit for bit (each output row has one non-zero partial)."""
    mesh = make_ep_mesh(2, device=device, backend="gloo")
    gen = torch.Generator(device=device).manual_seed(21)
    (E, N, K), T = sizes["ep"], sizes["ep_tokens"]
    experts = [QuantTensor(GGMLType.Q4_K, (N, K), dict(zip(("qs", "scm", "dd"),
                                                           random_q4k(N, K, device, gen))))
               for _ in range(E)]
    x = torch.randn((T, 2, K), device=device, generator=gen).to(torch.bfloat16)
    ids = torch.rand((T, E), device=device, generator=gen).topk(2, dim=1).indices
    local = shard_experts(mesh, experts)
    ep_mul_mat_id(mesh, local, x, ids)
    got, ms = _timed_ms(lambda: ep_mul_mat_id(mesh, local, x, ids), device)
    ref, ref_ms = _timed_ms(lambda: ops.mul_mat_id(experts, x, ids), device)
    if not torch.equal(got, ref):
        raise AssertionError(f"ep=2: ep_mul_mat_id differs from mul_mat_id (max abs "
                             f"{float((got.float() - ref.float()).abs().max()):.3e})")
    return {"experts": E, "local": len(local), "shape": [N, K], "tokens": T,
            "ep_ms": ms, "single_ms": ref_ms, "equal": True}


@torch.inference_mode()
def gloo_sp2(device, sizes: dict) -> dict:
    """Phase 11 e: ring_self_attention over sp = 2, contiguous and zigzag,
    against _causal_ref (SP_BOUND)."""
    mesh = make_mesh(sp=2, device=device, backend="gloo")
    gen = torch.Generator(device=device).manual_seed(31)
    B, H, KVH, S, D = sizes["sp"]
    q = torch.randn((B, H, S, D), device=device, generator=gen)
    k = torch.randn((B, KVH, S, D), device=device, generator=gen)
    v = torch.randn((B, KVH, S, D), device=device, generator=gen)
    ref, ref_ms = _timed_ms(lambda: attn_ops._causal_ref(q, k, v, 0, 1.0 / D ** 0.5, 0.0), device)
    out = {"shape": list(sizes["sp"]), "bound": SP_BOUND, "causal_ref_ms": ref_ms}
    for schedule in ("contiguous", "zigzag"):
        got, ms = _timed_ms(lambda: ring_self_attention(mesh, q, k, v, schedule=schedule), device)
        e = nmse(got, ref)
        if not e < SP_BOUND:
            raise AssertionError(f"sp=2 {schedule}: nmse {e:.3e} over {SP_BOUND}")
        out[schedule] = {"nmse": e, "ms": ms}
    return out


def _dense_blocks(cfg, device, gen) -> dict:
    """Dense bf16 llama params at cfg's width, N(0, 0.02) from `gen`, norms ones."""
    D, FF, KVD = cfg.n_embd, cfg.n_ff, cfg.n_kv_head * cfg.head_dim

    def w(r, c):
        return (torch.randn((r, c), device=device, generator=gen) * 0.02).to(torch.bfloat16)

    one = torch.ones(D, dtype=torch.bfloat16, device=device)
    return {"wte": w(cfg.n_vocab, D), "out_norm": one, "blocks": [
        {"attn_norm": one, "wq": w(D, D), "wk": w(KVD, D), "wv": w(KVD, D), "wo": w(D, D),
         "ffn_norm": one, "w_gate": w(FF, D), "w_up": w(FF, D), "w_down": w(D, FF)}
        for _ in range(cfg.n_layer)]}


@torch.inference_mode()
def gloo_pp2(device, sizes: dict) -> dict:
    """Phase 11 e: pp_forward over pp = 2 stages, dense bf16 blocks at the
    file's width, against the single-process forward of the same blocks per
    micro-batch (PP_BOUND; whether bit-equal is recorded)."""
    mesh = make_pp_mesh(2, device=device, backend="gloo")
    layers, micro, seq = sizes["pp"]
    cfg = llama.LlamaConfig(n_layer=layers, compute_dtype=torch.bfloat16, **sizes["cfg"])
    gen = torch.Generator(device=device).manual_seed(41)
    params = _dense_blocks(cfg, device, gen)
    toks = torch.randint(0, cfg.n_vocab, (micro, seq), device=device, generator=gen)
    sharded = shard_pp(mesh, stack_blocks(params))
    pp_forward(mesh, cfg, sharded, toks, micro)
    got, ms = _timed_ms(lambda: pp_forward(mesh, cfg, sharded, toks, micro), device)

    def single():
        outs = []
        for m in range(micro):
            x = params["wte"][toks[m:m + 1]]
            for blk in params["blocks"]:
                x = pp_block(cfg, blk, x)
            outs.append(ops.rms_norm(x, cfg.rms_eps) * params["out_norm"] @ params["wte"].T)
        return torch.cat(outs)

    ref, ref_ms = _timed_ms(single, device)
    e = nmse(got, ref)
    if not e < PP_BOUND:
        raise AssertionError(f"pp=2: nmse {e:.3e} over {PP_BOUND}")
    return {"layers": layers, "micro_batches": micro, "seq": seq, "nmse": e,
            "bit_equal": bool(torch.equal(got, ref)), "pp_ms": ms, "single_ms": ref_ms}


def _gloo_rank(rank: int, addr: str, device: str, path: str, refs: dict, sizes: dict, q):
    """One of phase 11's two gloo ranks (a spawned process; on the card both
    on cuda:0): c, d and e in order, the results (or the traceback) put on
    q. Its launch counts start at 0 and are returned."""
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        launch.initialize(addr, 2, rank, device=device)     # two ranks, one card: gloo
        try:
            out = {"tp2": gloo_tp2(device, Path(path), refs),
                   "dp2": gloo_dp2(device, Path(path), refs),
                   "ep2": gloo_ep2(device, sizes), "sp2": gloo_sp2(device, sizes),
                   "pp2": gloo_pp2(device, sizes), "launches": launches()}
        finally:
            dist.destroy_process_group()
        q.put((rank, out))
    except BaseException:
        import traceback

        q.put((rank, traceback.format_exc()))


def run_gloo_ranks(device, path: Path, refs: dict, sizes: dict, timeout_s: float = 900) -> list:
    """Phase 11 c-e in two spawned processes on one gloo world (sharing the
    card); raises on a rank's failure; every process is joined, or
    terminated."""
    addr = f"127.0.0.1:{free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    dev = "cuda:0" if device.type == "cuda" else "cpu"
    procs = [ctx.Process(target=_gloo_rank, args=(r, addr, dev, str(path), refs, sizes, q))
             for r in range(2)]
    for p in procs:
        p.start()
    res, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(res) < 2:
            try:
                rank, r = q.get(timeout=5)
                res[rank] = r
            except queue_mod.Empty:
                # a rank that raised put its traceback; one that died did not
                died = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if died or time.monotonic() > deadline:
                    raise AssertionError(f"gloo ranks: results from {sorted(res)} only "
                                         f"(exit codes {[p.exitcode for p in procs]})")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    errors = [f"rank {k}:\n{v}" for k, v in sorted(res.items()) if isinstance(v, str)]
    if errors:
        raise AssertionError("\n".join(errors))
    return [res[0], res[1]]


def parallel_phase(device, sizes: dict | None = None, keep_file: bool = False) -> dict:
    """Phase 11 (module docstring): the file of `sizes` (PAR_SIZES: the
    Llama-3-8B-width Q4_K_M file at SHORT_LAYERS) on a mesh, at world size
    1 in this process, then two gloo ranks sharing the card (tp = 2, dp =
    2, ep = 2, sp = 2, pp = 2). The launch counts are set to 0 just before
    and read just after, this process's and the ranks' added. keep_file
    leaves the file for phase 12 (out["path"], with the 100-token prompt
    and generate's greedy stream after it in out["stream"])."""
    sizes = sizes or PAR_SIZES
    t_phase = time.perf_counter()
    out = {"layers": sizes["layers"], "source": "meta-llama/Meta-Llama-3-8B config.json"}
    path = ROOT / "build" / f"smoke_llama3_q4_k_m_L{sizes['layers']}.gguf"
    t0 = time.perf_counter()
    write_gguf(path, sizes["cfg"], sizes["layers"], "q4_k_m")
    out["gguf_write_s"] = time.perf_counter() - t0
    out["gguf_gb"] = path.stat().st_size / 1e9
    cfg, params = _load(path, device)
    assert (cfg.n_kv_head, cfg.n_ff, cfg.rope_base, cfg.n_vocab) == tuple(
        sizes["cfg"][k] for k in ("n_kv_head", "n_ff", "rope_base", "n_vocab"))
    out["weights_gb"] = sum(t.nbytes if isinstance(t, QuantTensor)
                            else t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    rng = np.random.default_rng(11)
    refs = {"prompt": [int(t) for t in rng.integers(1, cfg.n_vocab, 100)],
            "prompts": [[int(t) for t in rng.integers(1, cfg.n_vocab, n)] for n in PARITY_LENS],
            "long_prompt": [int(t) for t in rng.integers(1, cfg.n_vocab, 300)],
            "n_new": N_NEW}
    kernels.reset_launches()
    t0 = time.perf_counter()
    out["nccl"] = parallel_nccl(device, cfg, params, refs)
    out["nccl"]["seconds"] = time.perf_counter() - t0
    mine = launches()
    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = run_gloo_ranks(device, path, refs, sizes)
    finally:
        if not keep_file:
            path.unlink()
    out["gloo_seconds"] = time.perf_counter() - t0
    if keep_file:
        out["path"] = str(path)
        out["stream"] = {"prompt": refs["prompt"], "generate": refs["generate"]}
    for key in ("tp2", "dp2", "ep2", "sp2", "pp2"):
        out[key] = ranks[0][key]
        out[key + "_rank1"] = ranks[1][key]
    out["launches"] = {k: mine[k] + ranks[0]["launches"][k] + ranks[1]["launches"][k]
                       for k in mine}
    missing = [k.name for k in (kernels.K1, kernels.K2, kernels.K3, kernels.K4)
               if out["launches"][k.name] == 0]
    if device.type == "cuda" and missing:
        raise AssertionError(f"parallel: kernels never launched on its path: {missing}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------------------ phase 12: utilities

SYNC_CACHE = ROOT / "build" / "smoke_sync_cache"
TRACE_DIR = ROOT / "build" / "smoke_trace"
# substrings of each launch-counted kernel's device kernel names (the
# product's kernel only: K2's combine kernel and K3's x quantization are
# launched by the same wrapper call and not counted apart)
KERNEL_NAMES = {kernels.K1.name: ("QK45<false>", "qmm_q4k_f32_kernel"),
                kernels.K2.name: ("fwd_kernel",), kernels.K3.name: ("Q4KI8",),
                kernels.K4.name: ("Q6K",)}


def kernel_of_name(name: str) -> str | None:
    """The launch counter of a device kernel's name among K1-K4, if any."""
    hits = [k for k, subs in KERNEL_NAMES.items() if any(s in name for s in subs)]
    if len(hits) > 1:
        raise AssertionError(f"kernel {name!r} matches {hits}")
    return hits[0] if hits else None


def _captured_stdout(fn) -> tuple:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    return rc, buf.getvalue()


def backend_ops_check(device, out_dir: Path) -> dict:
    """12 a: tools/backend_ops.py's test, grad, perf and support modes on the
    card (its full text into DIR/backend_ops.txt): main returns 0, so every
    case is within its nmse_max of the CPU and every qmm case launched the
    kernel its route names."""
    rec = {}
    t0 = time.perf_counter()
    rc, text = _captured_stdout(lambda: backend_ops.main(
        ["test", "grad", "perf", "support", "--verbose"], rec))
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "backend_ops.txt").write_text(text)
    fails = [ln for ln in text.splitlines() if "FAIL" in ln]
    if rc != 0:
        raise AssertionError(f"backend_ops exited {rc}: {fails}")
    qmm = [r for r in rec["test"] if "kernel" in r]
    if len(qmm) != 20 or not all(r["launches"].get(r["kernel"]) for r in qmm):
        raise AssertionError(f"backend_ops: qmm cases without their kernel: {qmm}")
    return {"seconds": time.perf_counter() - t0,
            "summary": [ln for ln in text.splitlines() if ln.startswith(("test:", "grad:"))],
            "grad_on_cpu": [ln.strip() for ln in text.splitlines() if "f64 leg on the CPU" in ln
                            and "grad" in ln],
            "qmm_launches": {r["name"]: r["launches"] for r in qmm},
            "worst_test_nmse": max((r["nmse"], r["name"]) for r in rec["test"]),
            "worst_grad_relerr": max((r["relerr"], r["name"]) for r in rec["grad"]),
            "perf_ms": {r["name"]: r["ms"] for r in rec["perf"]}}


def perf_check() -> dict:
    """12 b: utils/perf.py's main over its whole table on the card."""
    res = []
    t0 = time.perf_counter()
    rc, text = _captured_stdout(lambda: perf.main([], res))
    if rc != 0 or len(res) != len(perf.ALL):
        raise AssertionError(f"perf.main: rc {rc}, {len(res)} of {len(perf.ALL)} ops")
    return {"seconds": time.perf_counter() - t0, "lines": text.splitlines(), "results": res,
            "hbm_gbs_measured": perf.measure_hbm_bw() / 1e9}


def example_check() -> dict:
    """The simple example's two styles on the card."""
    before = launches()
    rc, text = _captured_stdout(lambda: simple.main([]))
    if rc != 0 or "style backend" not in text:
        raise AssertionError(f"examples.simple: rc {rc}\n{text}")
    return {"lines": text.splitlines(), "launches": _delta(before)}


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            h.update(chunk)
    return h.hexdigest()


def transport_check(path: Path) -> tuple[dict, Path]:
    """12 c: serve_model on the file, sync_model into a cache under build/
    (byte-identical by sha256), a second sync_model from the cache. Both
    ends in this process on one host: a loopback rate, not a network's."""
    shutil.rmtree(SYNC_CACHE, ignore_errors=True)
    nbytes = path.stat().st_size
    out = {"bytes": nbytes}
    t0 = time.perf_counter()
    srv, manifest = launch.serve_model(path, port=0)
    out["serve_s"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        local = launch.sync_model(path, "127.0.0.1", srv.port, SYNC_CACHE, manifest)
        out["sync_s"] = time.perf_counter() - t0
        mtime = local.stat().st_mtime_ns
        t0 = time.perf_counter()
        again = launch.sync_model(path, "127.0.0.1", srv.port, SYNC_CACHE, manifest)
        out["cache_hit_s"] = time.perf_counter() - t0
        with TransportClient(port=srv.port) as c:
            out["server_blobs"], out["server_bytes"] = c.stat()
    finally:
        srv.stop()
    if again != local or local.stat().st_mtime_ns != mtime:
        raise AssertionError("the second sync_model did not reuse the cached file")
    out["sha256"], sha_local = _sha256(path), _sha256(local)
    if sha_local != out["sha256"]:
        raise AssertionError("sync_model's file differs from the served one")
    out["tensors"] = len(manifest) - 1
    for k in ("serve", "sync", "cache_hit"):
        out[f"{k}_gb_per_s"] = nbytes / out[f"{k}_s"] / 1e9
    return out, local


def topology_check(device) -> dict:
    """12 c: local_topology on the card: one device of the card's name and
    its memory byte counters."""
    top = launch.local_topology()
    name = torch.cuda.get_device_name(device)
    mem = top.get("memory", {})
    if (top["n_devices"], top["n_local_devices"], top["process_count"]) != (1, 1, 1) or \
            top["devices"][0]["kind"] != name or top["devices"][0]["platform"] != "gpu":
        raise AssertionError(f"local_topology: {top}")
    if not (mem.get("bytes_free", 0) > 0 and mem.get("bytes_limit", 0) > 0
            and mem.get("allocated_bytes_all_current", 0) > 0):
        raise AssertionError(f"local_topology memory counters: {mem}")
    return top


def _decode_fixture(cfg, params, device, prompt):
    """A fresh cache with `prompt` prefilled; the first decode token and position."""
    kv = llama.make_cache(cfg, 1024, device=device)
    llama.forward(cfg, params, torch.tensor(prompt, device=device), kv, 0)
    return kv, torch.tensor([prompt[0]], device=device), len(prompt)


@torch.inference_mode()
def trace_check(device, cfg, params, n_layer: int, prompt) -> dict:
    """12 d: the launches of one replayed decode step (== expected_launches);
    trace.profile around one replayed step writes a trace naming K1 and K2;
    dump_graph(stage="kernels") of one eager decode step lists its kernels
    in order, and its K1-K4 entries equal the launch counters' delta."""
    out = {}
    kv, tok, pos = _decode_fixture(cfg, params, device, prompt)
    llama.decode_step(cfg, params, tok, kv, pos)            # the capture
    before = launches()
    llama.decode_step(cfg, params, tok, kv, pos)
    out["launches_per_replayed_step"] = base = _delta(before)
    want = expected_launches("q4_k_m", n_layer, 1)
    if base != want:
        raise AssertionError(f"replayed step launches {base}, expected {want}")
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with trace.profile(TRACE_DIR) as tpath:
        with trace.named_scope("smoke.replayed_step"):
            llama.decode_step(cfg, params, tok, kv, pos)
    text = tpath.read_text()
    out["trace_bytes"] = len(text)
    out["trace_names"] = {k: sum(text.count(s) for s in subs)
                          for k, subs in KERNEL_NAMES.items()}
    if not (out["trace_names"][kernels.K1.name] and out["trace_names"][kernels.K2.name]
            and "smoke.replayed_step" in text):
        raise AssertionError(f"the trace names no K1 / K2 kernel: {out['trace_names']}")
    before = launches()
    names = trace.dump_graph(lambda: llama.forward(cfg, params, tok, kv, pos),
                             stage="kernels").splitlines()
    delta = _delta(before)
    counted = {}
    for name in names:
        k = kernel_of_name(name)
        if k is not None:
            counted[k] = counted.get(k, 0) + 1
    want = {k: delta[k] for k in KERNEL_NAMES if k in delta}
    out.update(eager_kernels=len(names), eager_counted=counted, eager_launches=delta,
               first_kernels=[n[:80] for n in names[:12]])
    if counted != want:
        raise AssertionError(f"dump_graph kernels {counted}, launch counters {want}")
    return out


@torch.inference_mode()
def observe_check(device, cfg, params, n_layer: int, prompt, base: dict) -> dict:
    """12 e: the taps of one eager forward of the prompt (2·n_layer + 1
    names, the logits tap bit-equal to the logits); an observer around a
    captured decode_step raises; without one, a fresh capture's replay
    launches `base`."""
    taps = []
    kv = llama.make_cache(cfg, 1024, device=device)
    with observe.observer(lambda name, v: taps.append((name, v))):
        logits, _ = llama.forward(cfg, params, torch.tensor(prompt, device=device), kv, 0)
    names = [f"blk.{i}.{s}" for i in range(n_layer) for s in ("attn_out", "ffn_out")]
    if [n for n, _ in taps] != names + ["logits"]:
        raise AssertionError(f"taps {[n for n, _ in taps]}")
    if not np.array_equal(taps[-1][1], logits.float().cpu().numpy()):
        raise AssertionError("the logits tap differs from the logits")
    out = {"taps": len(taps), "tap_shapes": sorted({v.shape for _, v in taps})}
    kv, tok, pos = _decode_fixture(cfg, params, device, prompt)
    try:
        with observe.observer(lambda name, v: None):
            llama.decode_step(cfg, params, tok, kv, pos)
    except RuntimeError as e:
        out["capture_error"] = str(e)[:160]
    if "CUDA graph capture" not in out.get("capture_error", ""):
        raise AssertionError(f"an observer around a captured step did not raise: {out}")
    kv, tok, pos = _decode_fixture(cfg, params, device, prompt)
    llama.decode_step(cfg, params, tok, kv, pos)
    before = launches()
    llama.decode_step(cfg, params, tok, kv, pos)
    out["launches_per_replayed_step"] = _delta(before)
    if out["launches_per_replayed_step"] != base:
        raise AssertionError(f"replay launches {out['launches_per_replayed_step']} != {base}")
    return out


def utilities_phase(device, out_dir: Path, path: Path | None = None,
                    stream: dict | None = None) -> dict:
    """Phase 12 (module docstring): the last modules on the card, on phase
    11's Llama-3-8B-width Q4_K_M file (`path`, with its 100-token prompt
    and generate's greedy stream; without them, as under --paths
    utilities, the file is written and the stream generated here). The
    launch counts are set to 0 just before and read just after."""
    t_phase = time.perf_counter()
    own = path is None
    if own:
        path = ROOT / "build" / f"smoke_llama3_q4_k_m_L{SHORT_LAYERS}.gguf"
        write_gguf(path, LLAMA3_8B, SHORT_LAYERS, "q4_k_m")
    kernels.reset_launches()
    out = {"file": path.name}
    try:
        out["backend_ops"] = backend_ops_check(device, out_dir)
        out["perf"] = perf_check()
        out["example"] = example_check()
        if stream is None:
            cfg, params = _load(path, device)
            prompt = [int(t) for t in np.random.default_rng(11).integers(1, cfg.n_vocab, 100)]
            stream = {"prompt": prompt, "generate": llama.generate(
                cfg, params, prompt, N_NEW, max_seq=1024, device=device)}
            del params
        out["transport"], local = transport_check(path)
        t0 = time.perf_counter()
        cfg, params = _load(local, device)
        out["rebuilt_load_s"] = time.perf_counter() - t0
        got = llama.generate(cfg, params, stream["prompt"], N_NEW, max_seq=1024, device=device)
        if got != stream["generate"]:
            raise AssertionError("the rebuilt file's greedy stream differs from the original's")
        out["greedy_equal"] = N_NEW
        out["topology"] = topology_check(device)
        out["trace"] = trace_check(device, cfg, params, SHORT_LAYERS, stream["prompt"])
        out["observe"] = observe_check(device, cfg, params, SHORT_LAYERS, stream["prompt"],
                                       out["trace"]["launches_per_replayed_step"])
        del params
    finally:
        shutil.rmtree(SYNC_CACHE, ignore_errors=True)
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
        Path(str(path) + ".manifest.json").unlink(missing_ok=True)
        if own:
            path.unlink(missing_ok=True)
    out["launches"] = launches()
    out["seconds"] = time.perf_counter() - t_phase
    return out


CHECKS = {"qmm": check_qmm, "attention": check_attention, "q6k": check_q6k,
          "q8_0": check_q8_0, "q4_0": check_q4_0, "q5k": check_q5k,
          "legacy": check_legacy, "q23k": check_q23k, "pipe": check_pipe,
          "dma": check_dma, "families": check_family_shapes, "iq_search": check_iq_search,
          "tp": check_tp}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the 7B-width Q4_K file (kernel and int8 layouts), and "
                         f"at most {SHORT_LAYERS} of the other nine and of the Q4_K file "
                         "under weights_layout=auto (width is never cut)")
    ap.add_argument("--out", type=Path, default=ROOT / "build",
                    help="directory for chip_smoke.json, the detailed results")
    ap.add_argument("--checks", default=",".join(CHECKS),
                    help="comma-separated kernel checks of phase 3 (default: all; "
                         "'none' for no check)")
    ap.add_argument("--paths", default=None,
                    help="comma-separated main paths of phase 6 (default: all), "
                         "'quantize' for phase 7, 'families' (or mixtral, gpt2_large, gptj) "
                         "for phase 8, 'vision' for phase 9, 'training' for phase 10, "
                         "'parallel' for phase 11, 'utilities' for phase 12; a run "
                         "cut by --checks or --paths "
                         "skips phases 4 and 5 and prints no result line")
    args = ap.parse_args(argv)
    checks = [] if args.checks == "none" else args.checks.split(",")
    unknown = set(checks) - set(CHECKS)
    if unknown:
        ap.error(f"unknown checks {sorted(unknown)}; known: {list(CHECKS)}")

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
        entry = ""
        for line in info["ptxas"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            if "registers" in line or "spill" in line:
                log(f"  {name} {entry}: {line.strip()}")

    timer = Timer(device)
    results = []
    row_checks = {}
    for name in checks:
        got = CHECKS[name](device, timer, results)
        if got is not None:
            row_checks[name] = got
    partial = len(checks) < len(CHECKS) or args.paths is not None
    if not (HAS_GRAPHS or partial):
        raise AssertionError("llama.decode_chunk is missing: the graphs phase cannot run")
    if not (HAS_QUANT or partial):
        raise AssertionError("the codecs are missing: the quantize phase cannot run")

    small = {} if partial else small_model_check(device)
    if not partial:
        log(f"small models card vs CPU: {small}")

    tune = {"launches": launches()} if partial else autotune_phase(device)
    if not partial:
        log(f"autotune [{label}]: K11 {tune['dma_gbs']:.1f} GB/s, library reduction "
            f"{tune['hbm_gbs']:.1f} GB/s; M=1 2048x2048 Q4_K qmatmul kernel layout "
            f"{tune.get('t_kernel_s', float('nan')) * 1e3:.4f} ms, int8 layout "
            f"{tune.get('t_int8_s', float('nan')) * 1e3:.4f} ms; weights_layout=auto -> "
            f"{tune['layout']}, attn_impl -> {tune['attn_impl']} ({tune['seconds']:.1f} s, "
            f"launches {_nonzero(tune['launches'])})")
    k2_dist = max((r["nmse"] for r in results if r["kernel"] == kernels.K2.name),
                  default=None)

    log(f"free disk under build/: {shutil.disk_usage(ROOT / 'build').free / 1e9:.1f} GB")
    short = min(args.layers, SHORT_LAYERS)
    # (name, recipe, depth, layout, keep the file for the next entry)
    plan = [("q4_k", "q4_k", args.layers, "kernel", True),
            ("q4_k int8", "q4_k", args.layers, "int8", False)]
    plan += [(r, r, args.layers if r in FULL_DEPTH else short, "kernel", False)
             for r in RECIPES if r != "q4_k"]
    plan.append(("q4_k auto", "q4_k", short, "auto", False))
    if args.paths is not None:
        plan = [p for p in plan if p[0] in args.paths.split(",")]
    paths = {}
    for name, recipe, depth, layout, keep in plan:
        cut = "" if depth == 32 else f" (depth cut to {depth} of 32 layers)"
        mp = paths[name] = main_path(device, depth, recipe, layout, keep_file=keep,
                                     attn_bound=k2_dist if layout == "auto" else None)
        log(f"main path {name}{cut} [{label}]: load {mp['load_s']:.2f} s "
            f"({mp['gguf_gb']:.2f} GB file, written in {mp['gguf_write_s']:.1f} s; "
            f"{mp['weights_gb']:.2f} GB of weights on the card), "
            f"prefill {mp['prefill_tok_s']:.1f} tok/s (100-token prompt), "
            f"decode {mp['decode_tok_s']:.2f} tok/s (single stream), "
            f"engine {mp['engine_tok_s']:.1f} tok/s aggregate "
            f"({mp['engine_tokens']} tokens, {mp['engine_steps']} windows of depth "
            f"{mp['engine_depth']}; the first run, captures included, "
            f"{mp['engine_first_run_s']:.2f} s), "
            f"peak device memory {mp['peak_mem_gb']:.2f} GB "
            f"({mp['load_peak_gb']:.2f} GB at the end of the load)")
        log(f"  launches per decode step {mp['launches_per_decode_step']}, "
            f"per 128-token prefill chunk {mp['launches_per_prefill_chunk_128']}, "
            f"in the whole path {mp['launches']}")
        for key, step in (("decode_step_trace", "decode_step_ms"),
                          ("engine_step_trace", "engine_decode_step_ms"),
                          ("prefill_trace", "prefill_100_ms")):
            if key not in mp:
                continue
            t = mp[key]
            log(f"  {key} [{label}]: step {mp[step]:.3f} ms unprofiled, device busy "
                f"{t['busy_ms']} ms ({t['device_activities']} activities; "
                f"profiled wall {t['profiled_wall_ms']:.3f} ms), busy share "
                f"{t['busy_share']}; int8 kernels with their x quantization "
                f"{t['matched_ms']:.3f} ms; busiest {t['top_ms'][:5]}")
        if "attn_xla" in mp:
            ax = mp["attn_xla"]
            log(f"  attn_impl=xla [{label}]: launches per decode step "
                f"{ax['launches_per_decode_step']}, decode logits nmse vs K2 "
                f"{ax['logits_nmse_xla_vs_k2_exact']:.3e} at f32 with the f32 kernels (K2's "
                f"card-vs-plain distance {ax['bound']:.3e}), "
                f"{ax['logits_nmse_xla_vs_k2_served']:.3e} as served")
        if "long_window" in mp:
            lw = mp["long_window"]
            t = lw["trace"]
            log(f"  8-slot decode step at window 1024 (slots at {lw['slot_lengths']}) "
                f"[{label}]: {lw['step_ms']:.3f} ms unprofiled, device busy {t['busy_ms']} ms "
                f"({t['device_activities']} activities), busy share {t['busy_share']}, K2 "
                f"{t['matched_ms']:.3f} ms; busiest {t['top_ms'][:4]}")
        if "pipeline" in mp:
            pp = mp["pipeline"]
            t = pp["decode_step_trace"]
            log(f"  qmm_pipeline=on [{label}]: decode {pp['decode_tok_s']:.2f} tok/s "
                f"(single stream; {mp['decode_tok_s']:.2f} with the flag off), launches "
                f"per decode step {pp['launches_per_decode_step']}, in the 100-token "
                f"prefill {pp['launches_prefill_100']}; decode step {pp['decode_step_ms']:.3f} "
                f"ms unprofiled, device busy {t['busy_ms']} ms ({t['device_activities']} "
                f"activities), busy share {t['busy_share']}; busiest {t['top_ms'][:5]}; "
                f"decode logits nmse on vs off {pp['logits_nmse_on_vs_off']:.3e} "
                f"(int8 route vs off {pp['logits_nmse_i8_vs_off']:.3e})")

        if "graphs" in mp:
            gp = mp["graphs"]
            t = gp["replayed_step_trace"]
            gs = gp["graphs"]
            log(f"  graphs [{label}]: single-stream decode eager {gp['eager_tok_s']:.2f} tok/s "
                f"({gp['eager_ms_per_step']:.3f} ms/step), decode_chunk (the one-step graph "
                f"replayed) {gp['decode_chunk_tok_s']:.2f} tok/s "
                f"({gp['decode_chunk_ms_per_step']:.3f} ms/step), decode_scan (one graph of "
                f"{N_NEW - 1} steps) {gp['decode_scan_tok_s']:.2f} tok/s "
                f"({gp['decode_scan_ms_per_step']:.3f} ms/step), first runs with capture "
                f"{gp['decode_chunk_first_s']:.2f} / {gp['decode_scan_first_s']:.2f} s; "
                f"qmm_pipeline=on decode_chunk {gp['pipeline_decode_chunk_tok_s']:.2f} tok/s; "
                f"replayed logits == eager; launches per replayed step "
                f"{gp['launches_per_replayed_step']} (K10 on: "
                f"{gp['pipeline_launches_per_replayed_step']}); replayed step device busy "
                f"{t['busy_ms']} ms ({t['device_activities']} activities), busy share "
                f"{t['busy_share']}; {gs['graphs']} graphs captured in {gs['capture_s']:.2f} s, "
                f"pool {gs['pool_bytes']} bytes")
        if "tools" in mp:
            tl = mp["tools"]
            for name, row in tl["spec"].items():
                log(f"  speculative on the {name} prompt ({row['prompt_tokens']} tokens, "
                    f"{SPEC_NEW} new) [{label}]: == generate's greedy stream at k = "
                    f"{', '.join(str(k) for k in SPEC_KS)} and with the 4-layer draft; "
                    + "; ".join(f"k={k} accept {row[f'k{k}']['accept_rate']:.3f}, "
                                f"{row[f'k{k}']['tokens_per_verify']:.2f} tok/verify, "
                                f"{row[f'k{k}']['tok_s']:.1f} tok/s" for k in SPEC_KS)
                    + f"; 4-layer draft k=4 accept {row['draft4_k4']['accept_rate']:.3f}, "
                    f"{row['draft4_k4']['tok_s']:.1f} tok/s; decode_chunk "
                    f"{row['decode_chunk_tok_s']:.1f} tok/s (each on a fresh cache, its "
                    f"capture included)")
            sd = tl["self_draft_k4"]
            log(f"  self-draft k=4 [{label}]: accepted per step {sd['accepted_per_step']} "
                f"(rate {sd['accept_rate']:.3f}), {sd['tok_s']:.1f} tok/s over {N_NEW} tokens")
            for k, vs in tl["verify_step"].items():
                t = vs["trace"]
                log(f"  replayed verify step {k} [{label}]: {vs['step_ms']:.3f} ms (decode "
                    f"step {tl['decode_step_ms']:.3f} ms: {vs['decode_steps']:.2f} steps; "
                    f"{vs['tok_s_all_accepted']:.1f} tok/s if all accepted), launches {vs['launches']}, device "
                    f"busy {t['busy_ms']} ms (share {t['busy_share']}); busiest "
                    f"{t['top_ms'][:4]}")
            pp = tl["perplexity"]
            log(f"  perplexity [{label}]: ppl {pp['ppl']:.4f}, nll {pp['nll']:.6f} over "
                f"{pp['n_tokens']} tokens ({pp['windows']} windows of {PPL_CTX}), "
                f"{pp['tokens_per_s']:.1f} tokens/s, nll vs llama.forward's "
                f"{pp['nll_rel_vs_forward']:.2e} relative")
            c = tl["cli"]
            log(f"  tools phase {tl['seconds']:.1f} s; cli [{label}]: greedy: {c['greedy_rate']} | --spec 8: {c['spec_rate']} | "
                f"-s 1 --temp 0.8: {c['sampled_rate']} | serve {c['serve_requests']} "
                f"requests == Engine: {c['serve_rate']}")
        if "scan_window" in mp:
            sw = mp["scan_window"]
            t = sw["trace"]
            log(f"  engine depth-8 scan window [{label}]: {sw['window_ms']:.3f} ms for "
                f"{sw['tokens'] // 3} tokens ({sw['host_ms_per_token']:.3f} host ms per "
                f"token), device busy {t['busy_ms']} ms ({t['device_activities']} "
                f"activities), busy share {t['busy_share']}; its engine's graphs "
                f"{sw['graphs']}")
        if "engine_depths" in mp:
            ed = mp["engine_depths"]
            log(f"  engine depth 1 [{label}]: the same streams as depth 8 (greedy 8+1 and "
                f"seeded sampled 8 requests), {ed['depth1_engine_tok_s']:.1f} tok/s "
                f"against {mp['engine_tok_s']:.1f} at depth {mp['engine_depth']}")
        ev = mp["engine_vs_generate"]
        log(f"  engine == generate asserted for prompt lengths {ev['asserted']}; recorded "
            f"(first divergence, None = equal) {ev['recorded']}")
        if "engine_f32_route" in mp:
            log(f"  int8_min_m=0 [{label}]: floods {mp['engine_f32_route']['floods']}, engine "
                f"== generate for every prompt length {mp['engine_f32_route']['asserted']}")
        if "admission" in mp:
            ad = mp["admission"]
            log(f"  admission [{label}]: traced run {ad['tok_s_traced']:.1f} tok/s, wall "
                f"{ad['run_wall_s']:.3f} s, device busy {ad['run_busy_ms']:.1f} ms (share "
                f"{ad['run_busy_share']:.3f}); host s {ad['host_s']}; device busy ms "
                f"{ad['device_busy_ms']}; calls {ad['calls']}; floods {ad['floods']}")
            fc = ad["flood_clock"]
            log(f"  flood spans vs profiler [{label}]: {fc['floods']} spans, {fc['events']} "
                f"events, |offset| median {fc['median_abs_ms']} ms, max {fc['max_abs_ms']} ms, "
                f"first kernel after the span's start {fc['first_kernel_after_start']} "
                f"({fc['first_kernel_after_ms']} ms)")
            if "flood_trace" in ad:
                t = ad["flood_trace"]
                log(f"  one flood of 8 prompts [{label}]: {ad['flood_ms']:.3f} ms unprofiled, "
                    f"device busy {t['busy_ms']} ms (share {t['busy_share']}), K3 with its x "
                    f"quantization {t['matched_ms']:.3f} ms; busiest {t['top_ms'][:5]}")
        if "kv_variants" in mp:
            kv = mp["kv_variants"]
            kq, dl = kv["kv_quant"], kv["delta"]
            log(f"  kv_variants [{label}]: dense {kv['dense']['tok_s']:.1f} tok/s, peak "
                f"{kv['dense']['peak_gb']:.2f} GB, KV {kv['dense']['kv_bytes']} B; kv_quant "
                f"{kq['tok_s']:.1f} tok/s, KV {kq['kv_bytes']} B, == generate(kv_quant) for "
                f"{kq['asserted']} (recorded {kq['recorded']}), K2 saw {kq['k2_kv_dtypes']}, "
                f"launches per replayed step {kq['launches_per_replayed_step']}; paged "
                f"({kv['paged']['pages']} pages) {kv['paged']['tok_s']:.1f} tok/s, peak "
                f"{kv['paged']['peak_gb']:.2f} GB, pool {kv['paged']['kv_bytes']} B; paged "
                f"int8 {kv['paged_int8']['tok_s']:.1f} tok/s, pool "
                f"{kv['paged_int8']['kv_bytes']} B")
            log(f"  window delta [{label}]: logits nmse per step {dl['logits_nmse_per_step']} "
                f"(bound {dl['bound']:.3e}, window {dl['window']}); greedy streams equal to "
                f"the strict engine's {dl['streams_equal']} of 9 (first divergences "
                f"{dl['first_divergence']}); depth-8 window strict "
                f"{dl['strict_window']['window_ms']:.3f} ms (busy "
                f"{dl['strict_window']['trace']['busy_ms']} ms), delta "
                f"{dl['delta_window']['window_ms']:.3f} ms (busy "
                f"{dl['delta_window']['trace']['busy_ms']} ms)")

    quant = None
    if HAS_QUANT and (not partial or "quantize" in (args.paths or "").split(",")):
        quant = quantize_phase(device, CFG_7B, short)
        log(f"quantize phase ({short} of 32 layers) [{label}]: convert to F16 "
            f"{quant['convert_s']:.1f} s ({quant['f16_gb']:.2f} GB), F16 load "
            f"{quant['f16_load_s']:.1f} s, imatrix over {QUANT_CALIB}x{QUANT_CHUNK} tokens "
            f"{quant['imatrix_s']:.2f} s (launches {quant['imatrix_launches']})")
        for name, row in quant["files"].items():
            log(f"  {name} ({row['type']}{' + imatrix' if row['imatrix'] else ''}) "
                f"[{label}]: quantized on the card in {row['quantize_s']:.2f} s "
                f"({row['gb_per_s']:.2f} GB/s of F16 input; {row['file_gb']:.3f} GB file), "
                f"sampled rows == CPU codec {row['rows_equal_cpu']} ({row['rows_check_s']:.1f} s), "
                f"load {row['load_s']:.2f} s in the {row['layouts']} layout (peak "
                f"{row['load_peak_gb']:.2f} GB; {row['weights_gb']:.2f} GB of weights), "
                f"generate {N_NEW} tokens after 100 at {row['tok_s']:.2f} tok/s, "
                f"launches {row['launches']}, stream sha256 {row['stream_sha256'][:16]}")
        log(f"  codecs card == CPU for {len(quant['codecs'])} type checks "
            f"({quant['codec_checks_s']:.1f} s); GB/s of f32 input on "
            f"{QUANT_RATE_ROWS}x4096 [{label}]: "
            + ", ".join(f"{k} {v['gb_per_s']:.3f}" for k, v in quant["codecs"].items()
                        if "gb_per_s" in v)
            + f"; quantize phase {quant['seconds']:.1f} s")
    fams = None
    asked = set((args.paths or "").split(","))
    fam_names = [n for n in FAMILIES if not partial or n in asked or "families" in asked]
    if not (HAS_FAMILIES or partial):
        raise AssertionError("models/moe.py, gpt2.py or gptj.py is missing: the families "
                             "phase cannot run")
    if HAS_FAMILIES and fam_names:
        fams = families_phase(device, fam_names)
        for name in fam_names:
            fp = fams[name]
            log(f"family {name} ({fp['layers']} layers) [{label}]: {fp['gguf_gb']:.2f} GB file "
                f"written in {fp['gguf_write_s']:.1f} s, load {fp['load_s']:.2f} s "
                f"({fp['weights_gb']:.2f} GB on the card), prefill {fp['prefill_tok_s']:.1f} "
                f"tok/s (100-token prompt), decode {fp['decode_tok_s']:.2f} tok/s eager "
                f"({fp['decode_step_ms']:.3f} ms/step; the weights' bytes bound "
                f"{fp['step_bytes_bound_ms']:.3f} ms), decode_step replayed "
                f"{fp['replayed_tok_s']:.2f} tok/s ({fp['replayed_step_ms']:.3f} ms/step, "
                f"after its capture) == eager, "
                + (f"engine {fp['engine_tok_s']:.1f} tok/s aggregate "
                   f"(steady 8-slot step {fp['engine_decode_step_ms']:.3f} ms), "
                   if "engine_tok_s" in fp else "no engine (no batched forward), ")
                + f"peak device memory {fp['peak_mem_gb']:.2f} GB")
            log(f"  launches per decode step {fp['launches_per_decode_step']}, per replayed "
                f"step {fp['launches_per_replayed_step']}, per 128-token prefill chunk "
                f"{fp['launches_per_prefill_chunk_128']}")
            for key in ("decode_step_trace", "replayed_step_trace", "engine_step_trace",
                        "prefill_trace"):
                if key in fp:
                    t = fp[key]
                    log(f"  {key} [{label}]: device busy {t['busy_ms']} ms "
                        f"({t['device_activities']} activities), busy share {t['busy_share']}; "
                        f"busiest {t['top_ms'][:5]}")
            if "engine_vs_generate" in fp:
                ev = fp["engine_vs_generate"]
                log(f"  engine == generate asserted for prompt lengths {ev['asserted']}; "
                    f"recorded (first divergence, None = equal) {ev['recorded']}")
        log(f"families phase {fams['seconds']:.1f} s")
    vision = None
    if not HAS_VISION and (not partial or "vision" in asked):
        raise AssertionError("models/yolo.py, sam.py or magika.py is missing: the vision "
                             "phase cannot run")
    if HAS_VISION and (not partial or "vision" in asked):
        vision = vision_phase(device)
        yo, sa, mg = vision["yolo"], vision["sam"], vision["magika"]
        log(f"vision: YOLOv3-tiny at {YOLO_NET} [{label}]: {yo['params']} parameters "
            f"({yo['gguf_mb']:.1f} MB file, load {yo['load_s']:.2f} s), heads card vs CPU "
            f"nmse {yo['layer_15_nmse']:.3e} / {yo['layer_22_nmse']:.3e} with cuDNN's TF32 "
            f"flag on (one conv through F.conv2d under TF32: {yo['tf32_conv_nmse']:.3e}), "
            f"forward {yo['forward_ms']:.3f} ms ({yo['images_per_s']:.1f} images/s); detect "
            f"on a {YOLO_IMAGE[1]}x{YOLO_IMAGE[2]} photo {yo['detect_s'] * 1e3:.1f} ms "
            f"(letterbox {yo['letterbox_s'] * 1e3:.1f} ms, forward with its copies "
            f"{yo['detect_forward_s'] * 1e3:.1f} ms, decode + NMS "
            f"{yo['decode_nms_s'] * 1e3:.1f} ms; {yo['candidates']} candidates, "
            f"{yo['detections']} detections)")
        t = sa["encode_trace"]
        log(f"vision: SAM ViT-B [{label}]: {sa['params']} parameters ({sa['gguf_mb']:.1f} MB "
            f"file written in {sa['gguf_write_s']:.1f} s, load {sa['load_s']:.2f} s); "
            f"{SAM_CHECK_LAYERS}-layer card vs CPU nmse embeddings "
            f"{sa['check_embeddings_nmse']:.3e}, masks {sa['check_masks_nmse']:.3e}, iou "
            f"{sa['check_iou_nmse']:.3e} (CPU {sa['cpu_check_s']:.1f} s); "
            f"{SAM_VIT_B['n_enc_layer']} layers: encode {sa['encode_ms']:.3f} ms "
            f"({sa['encode_flops'] / 1e12:.3f} TFLOP, f32 bound {sa['encode_bound_ms']:.3f} "
            f"ms), decode {sa['decode_ms']:.3f} ms, peak device memory "
            f"{sa['peak_mem_gb']:.2f} GB; traced encode device busy {t['busy_ms']} ms "
            f"(share {sa['encode_busy_share']}, {t['device_activities']} activities); "
            f"busiest {t['top_ms'][:5]}; traced decode device busy "
            f"{sa['decode_trace']['busy_ms']} ms (share {sa['decode_busy_share']}, "
            f"{sa['decode_trace']['device_activities']} activities)")
        log(f"vision: Magika [{label}]: {mg['files']} files of 0 to {mg['max_bytes']} bytes "
            f"card vs CPU max abs {mg['max_abs_err']:.3e}, labels equal; "
            f"{mg['files_per_s_batch1']:.1f} files/s one by one, "
            f"{mg['files_per_s_batch']:.1f} files/s in one batch of {mg['files']}")
        log(f"vision phase {vision['seconds']:.1f} s, launches {_nonzero(vision['launches'])}")
    training = None
    if not HAS_TRAINING and (not partial or "training" in asked):
        raise AssertionError("training/ or models/mnist.py is missing: the training phase "
                             "cannot run")
    if HAS_TRAINING and (not partial or "training" in asked):
        training = training_phase(device)
        for case, row in training["k2_grad"].items():
            log(f"training: K2 gradient B=1 {case} N=M={K2_GRAD_N} D=128 pos 0 [{label}]: "
                f"forward vs K2's plain version nmse {row['fwd_nmse_vs_plain']:.3e} (max abs "
                f"{row['fwd_max_abs_err']:.3e}); dq/dk/dv == autograd through _causal_ref on "
                f"the card, nmse vs CPU {row['nmse_vs_cpu']:.3e}; K2 forward "
                f"{row['fwd_ms']:.4f} ms, forward + backward {row['fwd_bwd_ms']:.4f} ms (plain "
                f"recompute {row['plain_fwd_bwd_ms']:.4f}, SDPA {row['sdpa_fwd_bwd_ms']:.4f}; "
                f"bound {row['bound_ms']:.4f} by {row['bound_by']}, "
                f"{row['flops'] / 1e9:.3f} GFLOP); traced busy {row['trace']['busy_ms']} ms, busiest "
                f"{row['trace']['top_ms'][:4]}; plain {row['plain_trace']['busy_ms']} ms, "
                f"busiest {row['plain_trace']['top_ms'][:4]}")
        for arch, r in training["mnist"].items():
            log(f"training: MNIST {arch} [{label}]: 3 steps at batch {MNIST_BATCH} card vs CPU: "
                f"loss and gradients at equal params nmse "
                f"{[f'{e:.3e}' for e in r['grads_nmse_vs_cpu']]}, params after the steps "
                f"{r['steps_nmse_vs_cpu']:.3e}, worst leaf {r['worst_leaf']}"
                + (f" (TF32 convs, the control: gradients "
                   f"{[f'{e:.3e}' for e in r['tf32_grads_nmse_vs_cpu']]}, params "
                   f"{r['tf32_steps_nmse_vs_cpu']:.3e}, worst leaf {r['tf32_worst_leaf']})"
                   if "tf32_steps_nmse_vs_cpu" in r else "")
                + f"; step {r['step_ms']:.3f} ms host ({r['step_device_ms']:.3f} device), "
                f"{r['images_per_s']:.0f} images/s; train {MNIST_EPOCHS} epochs on "
                f"{MNIST_IMAGES} images {r['train_s']:.2f} s, accuracy {r['accuracy']:.4f} on "
                f"{MNIST_TEST} held out; GGUF round trip equal; resume bit-equal")
        g2 = training["gpt2"]
        t = g2["trace"]
        log(f"training: GPT-2 124M ({g2['params']} parameters, f32) [{label}]: "
            f"{GPT2_CHECK[0]} layers x {GPT2_CHECK[1]} tokens card vs CPU max nmse "
            f"{max(g2['check_nmse']):.3e} (loss and every gradient), two passes bit-equal; fit "
            f"{g2['micro_batches']} micro-batches of {GPT2_BATCH}x{GPT2_124M['n_ctx']} tokens "
            f"({g2['adamw_steps']} AdamW steps): losses {[round(x, 4) for x in g2['losses']]}, "
            f"{g2['ms_per_micro_batch']:.1f} ms per micro-batch, {g2['tokens_per_s']:.0f} "
            f"tokens/s (f32 bound {g2['bound_ms']:.1f} ms for "
            f"{g2['flops_per_micro_batch'] / 1e12:.3f} TFLOP), two runs bit-equal, peak "
            f"{g2['peak_mem_gb']:.2f} GB; one micro-batch with its step "
            f"{g2['micro_batch_with_step_ms']:.1f} ms unprofiled, traced busy {t['busy_ms']} ms "
            f"(share {g2['busy_share']}, {t['device_activities']} activities), busiest "
            f"{t['top_ms'][:5]}; cross_entropy_loss forward + backward "
            f"{g2['cross_entropy_fwd_bwd_ms']:.3f} ms (F.cross_entropy "
            f"{g2['library_cross_entropy_fwd_bwd_ms']:.3f})")
        log(f"training phase {training['seconds']:.1f} s, launches across MNIST and GPT-2 "
            f"{_nonzero(training['launches'])}")
    parallel = None
    if not HAS_PARALLEL and (not partial or "parallel" in asked):
        raise AssertionError("parallel/ is missing: the parallel phase cannot run")
    if not HAS_UTILITIES and (not partial or "utilities" in asked):
        raise AssertionError("the utilities (parallel/transport.py, tools/backend_ops.py, ...) "
                             "are missing: phase 12 cannot run")
    run_utilities = HAS_UTILITIES and (not partial or "utilities" in asked)
    if HAS_PARALLEL and (not partial or "parallel" in asked):
        parallel = parallel_phase(device, keep_file=run_utilities)
        nc, t2, d2 = parallel["nccl"], parallel["tp2"], parallel["dp2"]
        log(f"parallel: Llama-3-8B width, {parallel['layers']} layers, Q4_K_M "
            f"({parallel['gguf_gb']:.2f} GB file, {parallel['weights_gb']:.2f} GB on the card) "
            f"[{label}; one H100: NCCL at world size 1, gloo with two processes on one card; "
            f"no multi-card figure]")
        log(f"  NCCL tp=1: tp_forward == llama.forward, tp_decode_step stream == generate, "
            f"mesh Engine == mesh-free Engine (8+1 requests), windows captured on the "
            f"NCCL mesh ({nc['graphs']['graphs']} graphs; at world size 1 the all-reduce "
            f"launches no kernel), launches per replay == the mesh-free engine's "
            f"{nc['launches_per_replay']}; engine {nc['engine_tok_s']:.1f} tok/s; depth-8 "
            f"window {nc['nccl_window']['window_ms']:.3f} ms (NCCL kernels "
            f"{nc['nccl_window']['trace']['matched_ms']:.3f} ms, busy "
            f"{nc['nccl_window']['trace']['busy_ms']} ms) against "
            f"{nc['mesh_free_window']['window_ms']:.3f} ms mesh-free; tp_decode_step "
            f"{nc['tp_decode_step_ms']:.3f} ms")
        log(f"  gloo tp=2: logits nmse vs the single-process forward on the f32 route at "
            f"f32 {t2['logits_f32_nmse']:.3e} (bound 1e-9), at bf16 {t2['logits_nmse']:.3e} "
            f"(bound: bf16 vs f32 of the single forward, {t2['logits_bound']:.3e}); on the "
            f"int8 route {t2['logits_int8_route_nmse']:.3e} (bound {TP_INT8_BOUND}; the single "
            f"forward's int8 route vs "
            f"its f32 route {nc['int8_vs_f32_route_logits_nmse']:.3e}); greedy stream's "
            f"first divergence from generate "
            f"{t2['first_divergence_vs_generate']}, engine == tp_decode_step streams for "
            f"{t2['engine_asserted']} (uncaptured: {not t2['engine_captured']}), "
            f"{t2['engine_tok_s']:.1f} tok/s; decode step {t2['decode_step_ms']:.3f} ms, "
            f"all-reduce {t2['all_reduce_ms']:.4f} ms x {t2['all_reduces_per_step']} = share "
            f"{t2['all_reduce_share']:.3f}; {t2['weights_gb']:.2f} GB of weights per rank")
        log(f"  gloo dp=2: engine == mesh-free engine, {d2['engine_tok_s']:.1f} tok/s, "
            f"{d2['slots_per_rank']} slots per rank")
        e2, s2, p2 = parallel["ep2"], parallel["sp2"], parallel["pp2"]
        log(f"  ep=2: {e2['experts']} experts {e2['shape']} Q4_K, {e2['tokens']} tokens top-2: "
            f"== mul_mat_id bit for bit; {e2['ep_ms']:.3f} ms (mul_mat_id {e2['single_ms']:.3f})")
        log(f"  sp=2 at {s2['shape']}: contiguous nmse {s2['contiguous']['nmse']:.3e} "
            f"{s2['contiguous']['ms']:.2f} ms, zigzag nmse {s2['zigzag']['nmse']:.3e} "
            f"{s2['zigzag']['ms']:.2f} ms (_causal_ref {s2['causal_ref_ms']:.2f} ms)")
        log(f"  pp=2: {p2['layers']} bf16 blocks, {p2['micro_batches']} micro-batches of "
            f"{p2['seq']} tokens: nmse {p2['nmse']:.3e} (bit-equal {p2['bit_equal']}), "
            f"{p2['pp_ms']:.2f} ms (single {p2['single_ms']:.2f})")
        log(f"parallel phase {parallel['seconds']:.1f} s (gloo ranks "
            f"{parallel['gloo_seconds']:.1f} s), launches {_nonzero(parallel['launches'])}")
    utilities = None
    if run_utilities:
        kept = parallel.pop("path", None) if parallel else None
        stream = parallel.pop("stream", None) if parallel else None
        try:
            utilities = utilities_phase(device, args.out, kept and Path(kept), stream)
        finally:
            if kept:
                Path(kept).unlink(missing_ok=True)
        bo, tr, ob = utilities["backend_ops"], utilities["transport"], utilities["trace"]
        log(f"utilities: backend_ops [{label}] {bo['summary']} in {bo['seconds']:.1f} s (worst "
            f"test nmse {bo['worst_test_nmse']}, worst grad relerr {bo['worst_grad_relerr']}); "
            f"qmm launches {bo['qmm_launches']}; {bo['grad_on_cpu']}; full text in "
            f"{args.out / 'backend_ops.txt'}")
        pf = utilities["perf"]
        log(f"utilities: utils.perf [{label}] (measured HBM read "
            f"{pf['hbm_gbs_measured']:.1f} GB/s; in {pf['seconds']:.1f} s):")
        for line in pf["lines"]:
            log(f"  {line}")
        log(f"utilities: examples.simple [{label}]: {utilities['example']['lines']} launches "
            f"{utilities['example']['launches']}")
        log(f"utilities: transport [{label}; one host, loopback, both ends in one process: no "
            f"network or multi-card figure]: {tr['bytes'] / 1e9:.3f} GB ({tr['tensors']} "
            f"tensors) served in {tr['serve_s']:.2f} s ({tr['serve_gb_per_s']:.2f} GB/s), "
            f"synced in {tr['sync_s']:.2f} s ({tr['sync_gb_per_s']:.2f} GB/s), cache hit "
            f"(full validation) {tr['cache_hit_s']:.2f} s ({tr['cache_hit_gb_per_s']:.2f} "
            f"GB/s); sha256 equal {tr['sha256'][:16]}; rebuilt file loaded in "
            f"{utilities['rebuilt_load_s']:.2f} s, greedy {N_NEW} tokens == the original's")
        log(f"utilities: local_topology [{label}]: {utilities['topology']}")
        log(f"utilities: trace [{label}]: replayed step launches "
            f"{ob['launches_per_replayed_step']}, trace {ob['trace_bytes']} bytes naming "
            f"{ob['trace_names']}; dump_graph(kernels) of an eager step: {ob['eager_kernels']} "
            f"kernels, K1-K4 {ob['eager_counted']} == launches; first {ob['first_kernels'][:6]}")
        obs = utilities["observe"]
        log(f"utilities: observe [{label}]: {obs['taps']} taps (logits tap == logits), a "
            f"captured step under an observer raised ({obs['capture_error'][:80]}), replay "
            f"launches without one {obs['launches_per_replayed_step']}")
        log(f"utilities phase {utilities['seconds']:.1f} s, launches "
            f"{_nonzero(utilities['launches'])}")
    rep = {"qmm_q4_K": "M=8 N=11008 K=4096",
           "qmm_q4_K_i8": "M=128 N=11008 K=4096",
           "causal_flash_attention": "decode B=8 H=32 window=1024 f32q_bf16kv",
           "qmm_q6_K": "M=8 N=4096 K=11008",
           "qmm_q8_0": "M=8 N=11008 K=4096",
           "qmm_q8_0_i8": "M=128 N=11008 K=4096",
           "qmm_q4_0": "M=8 N=11008 K=4096",
           "qmm_q4_0_i8": "M=128 N=11008 K=4096",
           "qmm_q5_K": "M=8 N=11008 K=4096",
           "qmm_q4_1": "M=8 N=11008 K=4096",
           "qmm_q5_0": "M=8 N=11008 K=4096",
           "qmm_q5_1": "M=8 N=11008 K=4096",
           "qmm_q2_K": "M=8 N=11008 K=4096",
           "qmm_q3_K": "M=8 N=11008 K=4096",
           "qmm_q4_K_pipelined": "M=1 N=11008 K=4096",
           "dma_copy": "copy 4096x4096 f32",
           **{k: f"{v} {IQ_SEARCH_RATE}x4096" for k, v in IQ_REP.items()}}
    if partial:
        detail = {"device": smi, "build_s": build_s, "build": build.BUILD_LOG,
                  "kernels": results, "row_checks": row_checks, "main_paths": paths,
                  "quantize": quant, "families": fams, "vision": vision,
                  "training": training, "parallel": parallel, "utilities": utilities,
                  "checks": checks,
                  "partial": True}
        for mp in paths.values():
            mp.pop("probe_logits", None)
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
        log(f"partial run ({checks}, paths {list(paths)}): no result line")
        return 0
    int8_nmse = nmse(paths["q4_k int8"].pop("probe_logits"), paths["q4_k"].pop("probe_logits"))
    paths["q4_k int8"]["probe_logits_nmse_vs_kernel_layout"] = int8_nmse
    paths["q4_k auto"].pop("probe_logits")
    log(f"q4_k int8 layout vs kernel layout [{label}]: one decode step's logits nmse "
        f"{int8_nmse:.3e}")
    runs = ([tune] + list(paths.values()) + ([quant] if quant else [])
            + ([fams[n] for n in fam_names] if fams else []) + [parallel, utilities]
            + [mp[k] for mp in paths.values() for k in ("graphs", "pipeline", "tools") if k in mp])
    line = []
    for kern in kernels.KERNELS:
        rows = [r for r in results if r["kernel"] == kern.name]
        r = next(r for r in rows if r["shape"] == rep[kern.name])
        line.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces,
            "launches": sum(run["launches"][kern.name] for run in runs),
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    detail = {"device": smi, "build_s": build_s, "build": build.BUILD_LOG,
              "kernels": results, "row_checks": row_checks, "autotune": tune,
              "main_paths": paths, "quantize": quant, "families": fams, "vision": vision,
              "training": training, "parallel": parallel, "utilities": utilities,
              "small_model": small}
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "chip_smoke.json").write_text(json.dumps(detail, indent=1, default=str))
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
