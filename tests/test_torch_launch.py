"""The port's launch layer (parallel/launch.py): `initialize` brings up a
torch.distributed group from a coordinator address (or torchrun's env
keys) and starts none without one; `local_topology` reports the processes
and devices. Two gloo processes on 127.0.0.1 all-gather their ranks."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch.distributed as dist

from ggml_gfx906_tpu_torch.parallel import launch

ROOT = Path(__file__).resolve().parents[1]

_RANK = """
import sys
import torch, torch.distributed as dist
from ggml_gfx906_tpu_torch.parallel import launch
torch.set_num_threads(1)
addr, rank = sys.argv[1], int(sys.argv[2])
assert launch.initialize(addr, 2, rank, device="cpu")
assert dist.get_backend() == "gloo"
got = [None, None]
dist.all_gather_object(got, dist.get_rank())
top = launch.local_topology(device="cpu")
assert got == [0, 1], got
assert top["process_count"] == 2 and top["process_index"] == rank, top
assert top["n_devices"] == 2 and top["n_local_devices"] == 1, top
assert top["devices"] == [{"id": 0, "kind": "cpu", "platform": "cpu"}], top
assert "memory" not in top
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def test_no_coordinator_starts_no_group(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert launch.initialize() is False
    assert not dist.is_initialized()
    top = launch.local_topology(device="cpu")
    assert (top["process_index"], top["process_count"], top["n_devices"]) == (0, 1, 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torchrun_env_keys(monkeypatch):
    """MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK stand in for the
    arguments (a one-process gloo world here, destroyed after)."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        assert launch.initialize(device="cpu") is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        top = launch.local_topology(device="cpu")
        assert (top["process_index"], top["process_count"], top["n_devices"]) == (0, 1, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_gloo_processes():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, f"127.0.0.1:{port}", str(rank)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)
    assert [("RANK_OK", str(r)) in [tuple(ln.split()) for ln in o.splitlines()]
            for r, o in enumerate(outs)] == [True, True]
