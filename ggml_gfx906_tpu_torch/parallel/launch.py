"""Launch across processes: the torch.distributed bring-up and the model
sync by content hash — the port of ggml_gfx906_tpu/parallel/launch.py.

Every process runs the same program under one torch.distributed group
(`initialize`; parallel/mesh.py::build_mesh asks for it); before compute
starts, the model's bytes reach each host once through the native tensor
transport (FNV-1a dedup + a local disk cache — the SET_TENSOR_HASH path).
Collectives ride NCCL between cards (gloo on the CPU); there is no graph
offload protocol to replicate.

Typical flow:
    coordinator:  serve_model(gguf_path, port)                 # host 0
    all hosts:    initialize("host0:29500", n_proc, rank)      # torch.distributed
                  path = sync_model(gguf_path, "host0", port, cache, manifest)
                  cfg, params = llama.load(path)

Deliberate differences from the reference: `initialize` brings up
torch.distributed, not jax.distributed, and its env fallbacks are
torchrun's MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK, where the
reference reads JAX_COORDINATOR, JAX_NUM_PROCESSES and JAX_PROCESS_ID.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import torch
import torch.distributed as dist

from ..utils import log


def _coordinator_from_env() -> str | None:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None) -> bool:
    """Bring up the torch.distributed group: init_process_group(backend,
    init_method="tcp://<coordinator_address>", world_size=num_processes,
    rank=process_id). Without a coordinator (argument or MASTER_ADDR +
    MASTER_PORT) it starts no group and returns False (a single-process
    run); else True. Env fallbacks: WORLD_SIZE (1) and RANK (0).

    backend: the caller's, else NCCL where the device is the card and each
    rank has a card of its own (then rank r takes cuda:r), gloo otherwise.
    device: None is the card; "cpu" asks for gloo."""
    coordinator_address = coordinator_address or _coordinator_from_env()
    if coordinator_address is None:
        log.info("single-process run (no coordinator configured)")
        return False
    num_processes = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    process_id = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if backend is None:
        on_card = torch.device("cuda" if device is None else device).type == "cuda"
        own_card = on_card and torch.cuda.is_available() and \
            torch.cuda.device_count() >= num_processes
        backend = "nccl" if own_card else "gloo"
        if own_card:
            torch.cuda.set_device(process_id)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    log.info(f"torch.distributed up: process {process_id}/{num_processes} ({backend})")
    return True


HEADER_KEY = "__header__"


def serve_model(gguf_path, port: int = 18515, cache_dir: str | None = None):
    """Host-0 side: start the native transport server and publish the
    model's header (KV metadata + tensor directory, everything before the
    data section) and per-tensor blobs. Returns (server, manifest), where
    the manifest maps tensor name → FNV-1a hash plus HEADER_KEY → the
    header's hash (the serve half of the reference's model-upload loop,
    src/ggml-rpc/ggml-rpc.cpp:1387-1654); writes it as JSON beside the file."""
    from ..gguf import GGUFReader
    from .transport import TransportClient, TransportServer, distribute_gguf

    srv = TransportServer(port=port, cache_dir=cache_dir)
    with TransportClient(port=srv.port) as c:
        manifest = distribute_gguf(gguf_path, c)
        r = GGUFReader(gguf_path, header_only=True)
        with open(gguf_path, "rb") as f:
            hdr = f.read(r.data_offset)
        manifest[HEADER_KEY], _ = c.put(hdr)
    Path(str(gguf_path) + ".manifest.json").write_text(json.dumps(
        {"tensors": {k: str(v) for k, v in manifest.items()}}))
    log.info(f"serving {len(manifest) - 1} tensors on port {srv.port}")
    return srv, manifest


def _validate_local(path: Path, manifest: dict[str, int]) -> bool:
    """Full hash validation of a cached or rebuilt GGUF: every tensor's
    bytes (and the header when the manifest carries one) must match — a
    torn or partly written file with valid leading tensors must not pass."""
    from ..gguf import GGUFReader
    from .transport import fnv1a

    try:
        r = GGUFReader(path)
    except Exception:    # noqa: BLE001 - any unreadable file is invalid
        return False
    names = [n for n in manifest if n != HEADER_KEY]
    if set(names) != set(r.tensors):
        return False
    if HEADER_KEY in manifest:
        with open(path, "rb") as f:
            if fnv1a(f.read(r.data_offset)) != manifest[HEADER_KEY]:
                return False
    return all(fnv1a(r.tensor_bytes(n)) == manifest[n] for n in names)


def sync_model(gguf_path, host: str, port: int, cache_dir: str,
               manifest: dict[str, int]) -> Path:
    """Worker side: rebuild a byte-identical local GGUF through the
    transport — header fetch → directory parse → per-tensor GET (each blob
    hash-checked) → placement at the original offsets → full-file
    revalidation. A cached copy is reused only if it passes the full
    validation (the client half of the reference's model-upload protocol,
    src/ggml-rpc/ggml-rpc.cpp:1387-1654)."""
    from ..gguf import GGUFReader
    from .transport import TransportClient, fnv1a

    cache = Path(cache_dir)
    cache.mkdir(parents=True, exist_ok=True)
    local = cache / Path(str(gguf_path)).name
    if local.exists() and _validate_local(local, manifest):
        log.info(f"model already cached at {local}")
        return local

    with TransportClient(host, port) as c:
        hdr = c.get(manifest[HEADER_KEY])
        if hdr is None or fnv1a(hdr) != manifest[HEADER_KEY]:
            raise IOError("header blob missing or corrupt")
        tmp = local.with_suffix(local.suffix + ".part")
        tmp.write_bytes(hdr)
        r = GGUFReader(tmp, header_only=True)
        total = r.data_offset + max(
            (ti.offset + ti.n_bytes for ti in r.tensors.values()), default=0)
        with open(tmp, "r+b") as f:
            f.truncate(total)  # zero fill = the writer's alignment padding
            for name, ti in r.tensors.items():
                blob = c.get(manifest[name], ti.n_bytes)
                if blob is None or fnv1a(blob) != manifest[name]:
                    raise IOError(f"tensor blob {name} missing or corrupt")
                if len(blob) != ti.n_bytes:
                    raise IOError(f"tensor {name}: size {len(blob)} != {ti.n_bytes}")
                f.seek(r.data_offset + ti.offset)
                f.write(blob)
    tmp.rename(local)
    if not _validate_local(local, manifest):
        raise IOError("rebuilt GGUF failed full-hash validation")
    log.info(f"model rebuilt at {local} ({total} bytes)")
    return local


def local_topology(device=None) -> dict:
    """Device and process inventory (the ggml_backend_dev_memory analogue):
    process_index / process_count (0 / 1 without a group), n_devices (this
    process's, summed over the ranks by an all-gather when a group is up),
    n_local_devices, devices [{id, kind, platform}] and, on the card, memory
    (the byte counters of torch.cuda.mem_get_info and memory_stats).
    device: None is the card (raises without one); "cpu" reports the CPU
    and opens no CUDA context."""
    from ..utils.device import resolve

    device = resolve(device)
    up = dist.is_available() and dist.is_initialized()
    if device.type == "cuda":
        n_local = torch.cuda.device_count()
        devices = [{"id": i, "kind": torch.cuda.get_device_name(i), "platform": "gpu"}
                   for i in range(n_local)]
        free, total = torch.cuda.mem_get_info(device)
        memory = {"bytes_free": int(free), "bytes_limit": int(total)}
        memory.update({k.replace(".", "_"): int(v)
                       for k, v in torch.cuda.memory_stats(device).items()
                       if "bytes" in k and k.endswith(".all.current")})
    else:
        n_local = 1
        devices = [{"id": 0, "kind": "cpu", "platform": "cpu"}]
        memory = None
    n_devices = n_local
    if up:
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, n_local)
        n_devices = sum(counts)
    out = {"process_index": dist.get_rank() if up else 0,
           "process_count": dist.get_world_size() if up else 1,
           "n_devices": n_devices, "n_local_devices": n_local, "devices": devices}
    if memory is not None:
        out["memory"] = memory
    return out
