"""A pool of gloo processes for the port's mesh tests (tests/test_torch_
mesh.py, test_torch_tp.py, test_torch_engine_mesh.py, test_torch_ep_sp_pp.py).

Each test file starts its pool once (a module-scoped fixture): N spawned
processes in one torch.distributed world on gloo, rendezvous through a
file under the test's tmp_path (so that xdist workers never collide on a
port), one torch thread each. `GlooPool.run(fn, *args)` runs fn(*args) on
every rank and returns the ranks' results in rank order; fn is a function
of this module or of another module the children can import without JAX
(this file imports none: the children import torch and the port only).
"""
from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback

import torch

TIMEOUT_S = 240


def _worker(rank: int, world: int, init_file: str, inq, outq):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    while True:
        job = inq.get()
        if job is None:
            break
        fn, args = job
        try:
            outq.put((rank, True, fn(*args)))
        except BaseException:       # reported to the parent, which raises
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class GlooPool:
    def __init__(self, world: int, init_file: str):
        ctx = mp.get_context("spawn")
        self.world = world
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(world)]
        self.procs = [ctx.Process(target=_worker, args=(r, world, init_file, self.inqs[r],
                                                        self.outq), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args) -> list:
        for q in self.inqs:
            q.put((fn, args))
        out = [None] * self.world
        errors = []
        deadline = time.monotonic() + TIMEOUT_S
        for _ in range(self.world):
            while True:
                try:
                    rank, ok, res = self.outq.get(timeout=1.0)
                    break
                except queue.Empty:
                    alive = [p.is_alive() for p in self.procs]
                    if not all(alive) or time.monotonic() > deadline:
                        raise RuntimeError(f"no result from every gloo rank within "
                                           f"{TIMEOUT_S} s, or a rank died (alive: {alive})")
            if ok:
                out[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self):
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)


def start_pool(tmp_path_factory, world: int = 4):
    """A pool of `world` ranks, rendezvous in a fresh temporary directory."""
    return GlooPool(world, str(tmp_path_factory.mktemp("gloo") / "init"))


def to_numpy(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()
    if isinstance(t, (list, tuple)):
        return type(t)(to_numpy(x) for x in t)
    if isinstance(t, dict):
        return {k: to_numpy(v) for k, v in t.items()}
    return t


# ------------------------------------------------- the ranks' side of the tests

def port_params(tree):
    from ggml_gfx906_tpu_torch.models import llama

    return llama.params_from_numpy(tree, device="cpu")


def _cfg(fields: dict):
    from ggml_gfx906_tpu_torch.models import llama

    return llama.LlamaConfig(**fields)


def mesh_shards(np_tree: dict, dp: int, tp: int, specs: dict):
    """Each rank's shard_array / shard_quant_tensor of named leaves under the
    given specs: {name: fields or array} of numpy, or None off the mesh."""
    from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
    from ggml_gfx906_tpu_torch.parallel import P, make_mesh, shard_array, shard_quant_tensor

    mesh = make_mesh(dp=dp, tp=tp, device="cpu")
    if mesh is None:
        return None
    tree = port_params(np_tree)
    out = {}
    for name, spec in specs.items():
        x = tree[name]
        if isinstance(x, QuantTensor):
            s = shard_quant_tensor(mesh, x, P(*spec))
            loc = s.localize()
            out[name] = {"fields": to_numpy(s.fields), "shape": s.shape,
                         "local_shape": loc.shape}
        else:
            out[name] = to_numpy(shard_array(mesh, x, P(*spec)))
    return {"coords": mesh.coords, "shards": out}


def gpt2_shards(np_tree: dict, tp: int):
    from ggml_gfx906_tpu_torch.models import gpt2
    from ggml_gfx906_tpu_torch.ops.quantized import QuantTensor
    from ggml_gfx906_tpu_torch.parallel import make_mesh, shard_gpt2_params

    mesh = make_mesh(tp=tp, device="cpu")
    if mesh is None:
        return None
    sp = shard_gpt2_params(mesh, gpt2.params_from_numpy(np_tree, device="cpu"))

    def leaf(x):
        return to_numpy(x.fields) if isinstance(x, QuantTensor) else to_numpy(x)
    return {"top": {k: leaf(v) for k, v in sp.items() if k != "blocks"},
            "blocks": [{k: leaf(v) for k, v in b.items()} for b in sp["blocks"]]}


def tp_forward_run(cfg_fields: dict, np_tree: dict, toks, steps: int):
    """tp_forward of the prompt at tp = 2, then `steps` greedy
    tp_decode_steps: the logits, the tokens, the cache's length and heads."""
    from ggml_gfx906_tpu_torch.models import llama
    from ggml_gfx906_tpu_torch.parallel import make_mesh
    from ggml_gfx906_tpu_torch.parallel.tp import (shard_kv, shard_llama_params,
                                                   tp_decode_step, tp_forward)

    mesh = make_mesh(tp=2, device="cpu")
    if mesh is None:
        return None
    cfg = _cfg(cfg_fields)
    sp = shard_llama_params(mesh, port_params(np_tree))
    kv = shard_kv(mesh, llama.make_cache(cfg, 128, device="cpu"), batched=False)
    logits, kv = tp_forward(mesh, cfg, sp, torch.as_tensor(toks), kv, 0)
    out = to_numpy(logits)
    tok = torch.argmax(logits[-1]).to(torch.int32)[None]
    got = [int(tok[0])]
    for i in range(steps):
        tok, kv = tp_decode_step(mesh, cfg, sp, tok, kv, len(toks) + i)
        got.append(int(tok[0]))
    return {"logits": out, "tokens": got, "length": kv.length,
            "kv_heads": kv.k[0].shape[0]}


def tp_batch_run(cfg_fields: dict, np_tree: dict, toks, dp: int, tp: int):
    from ggml_gfx906_tpu_torch.parallel import make_mesh
    from ggml_gfx906_tpu_torch.parallel.tp import shard_kv, shard_llama_params, tp_forward_batch
    from ggml_gfx906_tpu_torch.runtime.batched_kv import BatchedKVCache

    mesh = make_mesh(dp=dp, tp=tp, device="cpu")
    if mesh is None:
        return None
    cfg = _cfg(cfg_fields)
    sp = shard_llama_params(mesh, port_params(np_tree))
    toks = torch.as_tensor(toks)
    B = toks.shape[0]
    kv = shard_kv(mesh, BatchedKVCache.create(cfg.n_layer, B, 128, cfg.n_kv_head,
                                              cfg.head_dim), batched=True)
    logits, kv = tp_forward_batch(mesh, cfg, sp, toks, kv, torch.zeros(B, dtype=torch.int32))
    return {"logits": to_numpy(logits), "lengths": to_numpy(kv.lengths),
            "kv_shape": tuple(kv.k[0].shape)}


def shard_rejects(cfg_fields: dict, np_tree: dict, tp: int, case: str):
    """shard_llama_params's refusal in `case` (its message), or None."""
    from ggml_gfx906_tpu_torch.parallel import make_mesh
    from ggml_gfx906_tpu_torch.parallel.tp import shard_llama_params

    mesh = make_mesh(tp=tp, device="cpu")
    if mesh is None:
        return None
    params = port_params(np_tree)
    blk = params["blocks"][0]
    if case == "wire":
        blk["wo"].layout = "wire"
    try:
        shard_llama_params(mesh, params)
    except ValueError as e:
        return str(e)
    return "accepted"


def engine_run(cfg_fields: dict, np_tree: dict, prompts, n_new: int, dp: int, tp: int,
               knobs: dict, paged_pages=None, max_batch: int = 2, seeds=None,
               sample: dict | None = None, spy: bool = False):
    """The mesh Engine's streams (rank order of submission), and with spy
    how often the flood, the scan windows and the per-step dispatches ran."""
    from ggml_gfx906_tpu_torch.models import llama
    from ggml_gfx906_tpu_torch.parallel import make_mesh
    from ggml_gfx906_tpu_torch.parallel.tp import shard_llama_params
    from ggml_gfx906_tpu_torch.runtime.engine import Engine
    from ggml_gfx906_tpu_torch.utils import config

    mesh = make_mesh(dp=dp, tp=tp, device="cpu")
    if mesh is None:
        return None
    cfg = _cfg(cfg_fields)
    sp = shard_llama_params(mesh, port_params(np_tree))
    for k, v in knobs.items():
        config.set(k, v)
    try:
        eng = Engine(llama, cfg, sp, max_batch=max_batch, max_seq=64, mesh=mesh,
                     paged_pages=paged_pages)
        hits = {"flood": [], "scan": [], "step": []}
        if spy:
            orig = (eng._admit_batch, eng._dispatch_scan, eng._dispatch)
            eng._admit_batch = lambda: (r := orig[0](), hits["flood"].append(r))[0]
            eng._dispatch_scan = lambda d: (hits["scan"].append(d), orig[1](d))[1]
            eng._dispatch = lambda: (hits["step"].append(1), orig[2]())[1]
        rids = [eng.submit(p, n_new, seed=(seeds[i] if seeds else 0), **(sample or {}))
                for i, p in enumerate(prompts)]
        done = {r.rid: r.out for r in eng.run()}
    finally:
        for k in knobs:
            config.unset(k)
    return {"streams": [done[r] for r in rids],
            "hits": {k: len(v) if k != "flood" else sum(map(bool, v)) for k, v in hits.items()},
            "kv_slots": eng.kv.lengths.shape[0], "kv_heads": eng.kv.k[0].shape[1],
            "captured": eng.graphs.captured}


def ep_run(np_experts, x, ids, ep: int, dp: int, capacity=None):
    from ggml_gfx906_tpu_torch.parallel.ep import ep_mul_mat_id, make_ep_mesh, shard_experts

    mesh = make_ep_mesh(ep=ep, dp=dp, device="cpu")
    if mesh is None:
        return None
    ex = shard_experts(mesh, torch.as_tensor(np_experts))
    return to_numpy(ep_mul_mat_id(mesh, ex, torch.as_tensor(x), torch.as_tensor(ids), capacity))


def sp_run(q, k, v, sp: int, dp: int, schedule: str, scale=None, softcap: float = 0.0,
           counts: bool = False, bf16: bool = False):
    from ggml_gfx906_tpu_torch.parallel import make_mesh
    from ggml_gfx906_tpu_torch.parallel.sp import ring_self_attention

    mesh = make_mesh(dp=dp, sp=sp, device="cpu")
    if mesh is None:
        return None
    qkv = [torch.as_tensor(a) for a in (q, k, v)]
    if bf16:
        qkv = [t.to(torch.bfloat16) for t in qkv]
    out = ring_self_attention(mesh, *qkv, scale=scale, logit_softcap=softcap,
                              schedule=schedule, return_work_counts=counts)
    out, n = out if counts else (out, None)
    return {"out": to_numpy(out), "dtype": str(out.dtype), "counts": to_numpy(n)}


def pp_run(cfg_fields: dict, np_tree: dict, toks, pp: int, n_micro: int):
    from ggml_gfx906_tpu_torch.parallel.pp import make_pp_mesh, pp_forward, shard_pp, stack_blocks

    mesh = make_pp_mesh(pp, device="cpu")
    if mesh is None:
        return None
    cfg = _cfg(cfg_fields)
    try:
        sharded = shard_pp(mesh, stack_blocks(port_params(np_tree)))
    except ValueError as e:
        return {"rejected": str(e)}
    return {"logits": to_numpy(pp_forward(mesh, cfg, sharded, torch.as_tensor(toks),
                                          n_micro))}

