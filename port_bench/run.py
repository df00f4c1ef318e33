"""One run of one cell of the port's benchmark:

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (configs/<name>.json: the published sizes, the model's
architecture file under port/ and ref/, the knobs, the limit of the check)
and its traffic mix (traffic/<name>.json); each per-layer metric is a
reader metrics/<name>.py. Set-up makes the weights on the card from the
seed, warms every window the traffic reaches, and runs the closed loop
until the window opens; the window lasts --seconds; with --trace 1 its
last `trace_seconds` are traced and the per-layer metrics reported in
place of the end-to-end ones. The last line of standard output is one
JSON object; the numbers compared for `correct` are the last lines of
standard error and the last key of that object."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# modules that may not be loaded in the process that prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "ggml_gfx906_tpu")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--knob", action="append", default=[], metavar="NAME=VALUE",
                    help="set a port config knob over the configuration's own (a control "
                         "run: the port with a lower-precision path switched on)")
    ap.add_argument("--dump", default=None,
                    help="write the checked requests (prompts, served tokens) to this JSON "
                         "file, for control.py")
    return ap.parse_args(argv)


def cell_spec(manifest: dict, name: str) -> dict:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in manifest["configs"]}[w["config"]]

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {"cell": w, "config": cfg,
            "end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
            "per_layer": [m for m in manifest["per_layer"] if mine(m)]}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("port_bench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def clipped_tokens(harvests, t0: float, t1: float) -> float:
    """Tokens harvested in [t0, t1], each harvested window's tokens counted
    by the share of its interval that lies inside."""
    n = 0.0
    for t_end, d, tokens in harvests:
        a, b = t_end - d, t_end
        if d <= 0:
            n += tokens if t0 <= b <= t1 else 0
            continue
        ov = min(b, t1) - max(a, t0)
        if ov > 0:
            n += tokens * ov / d
    return n


def end_to_end(res, names) -> dict:
    win = res.t_close - res.t_open
    out = {}
    if "gen_tok_s" in names:
        out["gen_tok_s"] = {"value": clipped_tokens(res.harvests, res.t_open, res.t_close) / win,
                            "unit": "tokens/s"}
    if "latency_p95_ms" in names:
        lat = [(d.t_finish - d.t_submit) * 1e3 for d in res.done
               if res.t_open <= d.t_finish <= res.t_close]
        if len(lat) >= 2:
            out["latency_p95_ms"] = {"value": statistics.quantiles(lat, n=20)[18], "unit": "ms"}
    return out


def main(argv=None, device=None, manifest: dict | None = None, root: Path = ROOT) -> int:
    """device: run there, without the look for a card; manifest and root:
    another BENCHMARK.json and checkout (tests)."""
    args = parse(argv)
    manifest = manifest or json.loads((root / "BENCHMARK.json").read_text())
    spec = cell_spec(manifest, args.workload)
    w = spec["cell"]
    conf = json.loads((root / spec["config"]["file"]).read_text())
    mix = json.loads((root / "port_bench" / "traffic" / f"{w['traffic']}.json").read_text())
    os.environ["GGML_TORCH_CACHE"] = str(root / "build" / "port_bench" / "autotune")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
            log(f"no result: the cell needs {w['chips']} CUDA device(s), "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    sys.path.insert(0, str(ROOT))
    from ggml_gfx906_tpu_torch.runtime.engine import Engine
    from ggml_gfx906_tpu_torch.utils import config

    from port_bench import check, driver, traffic

    port = importlib.import_module(f"port_bench.port.{conf['arch']}")
    ref = importlib.import_module(f"port_bench.ref.{conf['arch']}")
    setup = {}
    t = time.perf_counter()
    if device.type == "cuda":
        from ggml_gfx906_tpu_torch.ops.cuda import build

        build.build_all()
        setup["nvcc_built"] = sorted(build.BUILD_LOG)
        torch.cuda.reset_peak_memory_stats()
    setup["build_s"] = time.perf_counter() - t
    knobs = dict(conf.get("knobs", {}))
    for kv in args.knob:
        name, value = kv.split("=", 1)
        knobs[name] = json.loads(value)
    for k, v in knobs.items():
        config.set(k, v)
    hp = conf["hf_config"]
    t = time.perf_counter()
    mod, cfg, params = port.build(hp, args.seed, device,
                                  compute_dtype=getattr(torch, conf["compute_dtype"]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup["weights_s"] = time.perf_counter() - t
    proxy = driver.ModelProxy(mod)
    eng = Engine(proxy, cfg, params, max_batch=int(mix["slots"]), max_seq=int(mix["max_seq"]),
                 device=device)
    t = time.perf_counter()
    setup["warm_requests"] = driver.warm(eng, mix, cfg.n_vocab, args.seed)
    setup["warm_s"] = time.perf_counter() - t
    tracer = None
    if args.trace:
        from port_bench.trace import Tracer

        tracer = Tracer()
    loop = driver.ClosedLoop(eng, traffic.Mix(mix, args.seed, cfg.n_vocab), args.seconds,
                             tracer=tracer)
    res = loop.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup["ramp_s"] = res.t_open - loop.t_loop
    setup["capture_s"] = eng.graphs.capture_s()
    setup["graphs"] = len(eng.graphs.graphs)
    setup_s = res.t_open - T_START
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        log(f"no result: the process holds {bad} once the window has closed")
        return 3
    log("setup: " + json.dumps(dict(setup, setup_s=setup_s, opened_by=res.opened_by,
                                    captures_in_window=res.captures_in_window)))
    win = [d for d in res.done if res.t_open <= d.t_finish <= res.t_close]
    result = {"correct": False, "attempted": res.attempted, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu", "count": int(w["chips"]), "memory_peak_bytes": int(peak)}}
    if not args.trace:
        result["metrics"] = end_to_end(res, {m["name"] for m in spec["end_to_end"]})
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        from port_bench import context

        summ = tracer.summary()
        ctx = context.Context(res=res, trace=summ, prefills=proxy.prefills, hp=hp, ref=ref,
                              n_layer=cfg.n_layer)
        for m in spec["per_layer"]:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"]["busy_s"] = summ.busy_s
        result["device"]["window_s"] = summ.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in summ.by_name[:10]],
                               "idle_gaps": [[n, s] for n, s in summ.gaps[:10]]}
        span = res.trace_span[1] - res.trace_span[0] if res.trace_span else None
        log(f"trace: kernels {len(summ.kernels)}, launches found {summ.launches_found}, "
            f"marked {summ.window_s:.4f} s, host span {span}, K2 {res.k2_span}, "
            f"prefills {len(ctx.prefill_rows(*res.trace_span)) if span else None}")
    log(f"window: {res.t_close - res.t_open:.3f} s, {len(win)} requests completed, "
        f"{len(res.harvests)} harvests, {res.attempted} submitted")
    # the check: the port's state is freed first, the reference fits after
    mc, ms = conf["check"], mix["check"]
    picked = check.sample(win, args.seed, ms["min_tokens"], ms["max_requests"], ms["max_rows"])
    del eng, params, loop, proxy, res
    check.free_cuda()
    t = time.perf_counter()
    gap = check.compare(ref, hp, args.seed, picked, device) if picked else None
    number = mc["number"]
    checks = {number: {"value": gap[number] if gap else None, "limit": mc["limit"]}}
    result["correct"] = bool(gap is not None and gap[number] <= mc["limit"])
    result["checks"] = checks
    log("check: " + json.dumps(dict(gap or {}, seconds=time.perf_counter() - t)))
    if args.dump:
        Path(args.dump).write_text(json.dumps({
            "config": spec["config"]["name"], "workload": args.workload, "seed": args.seed,
            "seqs": [[d.prompt, d.out] for d in picked], "check": checks}))
    for k, v in checks.items():
        log(f"{k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
