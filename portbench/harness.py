"""The benchmark of ``repro_torch``: one run of one cell.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

- its configuration, ``configs/<config>.json``: the deployment's sizes,
  guarantees, limits and the name of its deployment kind and reference;
- its traffic, ``traffic/<traffic>.json``: parameters that one generator
  (``datagen``) and one loop kind read;
- the deployment kind, ``deployments/<deployment>.py``, the loop kind,
  ``loops/<loop>.py``, and the reference, ``reference/<reference>.py``;
- each per-layer metric, ``metrics/<metric>.py``, a reader of the traced
  run's record.

A dotted name falls back to its quantity: where ``metrics/<metric>.py`` is
missing, the reader of the name less its last dotted part reads it
(``device.idle_pct`` reads ``device.idle_pct.batch`` and
``device.idle_pct.single``), and an end-to-end metric such as
``queries_per_s.<cells>`` would be the loop's ``queries_per_s``, kept
apart so that a cell's spread gets a bound of its own.

A run: make the collection and the queries from the seed, deploy (set-up,
timed from the start of the process, compiles included), drive the window,
read the peak memory, free the program's state, then judge a sample of the
window's answers, drawn from the seed, against the reference. A traced run
drives a window of at most the traffic's ``trace_seconds``, where it has
one, so that the trace of a loop with many launches a second is read in
the time a run has; it reports the per-layer metrics alone.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

import torch

from portbench import datagen, judge
from portbench.tracing import Tracer, sync

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


def load_spec() -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _named(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def read_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the harness."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def plugin(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the harness."""
    return importlib.import_module(f"portbench.{kind}.{name}")


def quantities(name: str) -> list:
    """``name``, then ``name`` less its last dotted parts, one at a time:
    ``a.b.c``, ``a.b``, ``a``."""
    parts = name.split(".")
    return [".".join(parts[:i]) for i in range(len(parts), 0, -1)]


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, else
    that of its quantity (``quantities``)."""
    for stem in quantities(name):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            break
    else:
        raise FileNotFoundError(f"no reader of {name!r} under metrics/")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_plan(spec: dict, workload: str) -> dict:
    """What ``BENCHMARK.json`` says of one cell: its entry, configuration,
    traffic, and the end-to-end and per-layer metrics it reports."""
    cell = _named(spec["workloads"], workload, "workload")

    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if m["moves"] in e2e_names and mine(m)]
    return dict(cell=cell, cfg=read_json("configs", cell["config"]),
                traffic=read_json("traffic", cell["traffic"]),
                end_to_end=e2e, per_layer=layer)


def forbidden_modules(names=None) -> list:
    """Top-level names of JAX's and the JAX package's among ``names`` (the
    loaded modules by default), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    """One line on standard error."""
    print(msg, file=sys.stderr, flush=True)


def device_info(device, peak: int) -> dict:
    """The result's ``device`` entry."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(dev),
                    count=1, memory_peak_bytes=int(peak))
    return dict(platform="cpu", kind="cpu", count=1,
                memory_peak_bytes=int(peak))


class Laps:
    """Seconds of each step of set-up by the host clock, each step's device
    work waited for: ``laps("name")`` ends the step that began at the last
    lap (the first at ``t0``)."""

    def __init__(self, t0: float, device):
        self.t = t0
        self.device = device
        self.parts = {}

    def __call__(self, name: str) -> None:
        if torch.device(self.device).type != "cuda" or \
                torch.cuda.is_initialized():  # never start the device here
            sync(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


def deploy(plan: dict, seed: int, device, laps=None) -> tuple:
    """Make the collection and the queries of ``seed`` and deploy the
    program over the collection: (handle, (pool, n) queries, loop)."""
    laps = laps or (lambda name: None)
    cfg, traffic = plan["cfg"], plan["traffic"]
    raw = datagen.collection(int(cfg["num_series"]),
                             int(cfg["series_length"]), seed, device)
    laps("collection")
    queries = datagen.queries(traffic, int(cfg["series_length"]), seed,
                              device, raw=raw)
    laps("queries")
    kind = plugin("deployments", cfg["deployment"])
    loop = plugin("loops", traffic["loop"])
    laps("program_import")
    handle = kind.deploy(cfg, raw, device)
    laps("build")
    return handle, queries, loop


def reference_check(plan: dict, out, queries, seed: int, device) -> dict:
    """Judge a sample of the window's answers against the reference."""
    cfg, traffic = plan["cfg"], plan["traffic"]
    sel = datagen.sample(out.attempted, traffic["sample"], seed)
    sel = sel[out.answered[sel]]
    k = out.dists.shape[1]
    qs = queries[torch.as_tensor(out.ids[sel], device=queries.device)]
    ref = plugin("reference", cfg["reference"])
    chunks = datagen.collection_chunks(
        int(cfg["num_series"]), int(cfg["series_length"]), seed, device)
    ref_d, _, probe_d = ref.knn(
        chunks, qs, k, probe=torch.as_tensor(out.pos[sel], device=device))
    values = judge.numbers(out.dists[sel], out.pos[sel], ref_d.cpu().numpy(),
                           probe_d.cpu().numpy(), out.failed)
    values["sampled"] = int(sel.shape[0])
    return values


def run_cell(plan: dict, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start=None, overrides=None) -> dict:
    """One run of a plan (``cell_plan``): the result's dict, the compared
    numbers last under ``checks``.

    ``overrides`` ({"cfg": {...}, "traffic": {...}}) changes sizes for the
    tests on the CPU; the benchmark's runs pass none.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    plan = dict(plan)
    for part, extra in (overrides or {}).items():
        plan[part] = {**plan[part], **extra}
    cfg, traffic = plan["cfg"], plan["traffic"]
    dev = torch.device(device)
    laps = Laps(t_start, dev)
    laps("start")  # the interpreter, torch and the harness imported
    torch.empty(1, device=dev)
    laps("device")
    handle, queries, loop = deploy(plan, seed, dev, laps)
    tracer = Tracer(trace, dev)
    loop.warm(handle, cfg, traffic, queries, tracer)
    laps("warm")
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] {plan['cfg']['name']} under {plan['traffic']['loop']}"
        f" seed {seed}: set-up {setup_s} s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in laps.parts.items()))

    if trace and "trace_seconds" in traffic:
        seconds = min(seconds, float(traffic["trace_seconds"]))
    with tracer:
        out = loop.run(handle, cfg, traffic, queries, seconds, seed, tracer)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if dev.type == "cuda":
        mem = torch.cuda.memory_stats(dev)
        out.counters.update(
            alloc_retries=mem.get("num_alloc_retries", 0),
            reserved_peak_bytes=mem.get("reserved_bytes.all.peak", 0))
    handle.close()
    del handle
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    values = reference_check(plan, out, queries, seed, dev)
    correct, checks = judge.verdict(values, cfg["limits"])

    result = dict(correct=correct, attempted=out.attempted,
                  failed=out.failed, metrics={})
    if trace:
        record = dict(tracer.record, params=dict(cfg, **traffic),
                      counters=out.counters)
        for m in plan["per_layer"]:
            value = metric_reader(m["name"])(record)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=value,
                                                    unit=m["unit"])
    else:
        for m in plan["end_to_end"]:
            value = (setup_s if m["name"] == "setup_s" else next(
                out.metrics[q] for q in quantities(m["name"])
                if q in out.metrics))
            result["metrics"][m["name"]] = dict(value=value, unit=m["unit"])
    result["device"] = device_info(dev, peak)
    if trace:
        result["device"].update(busy_s=record["busy_s"],
                                window_s=record["window_s"])
        result["breakdown"] = record["breakdown"]
    result["counters"] = {k: v for k, v in out.counters.items()
                          if isinstance(v, (int, float))}
    result["counters"].update(
        {f"setup.{k}": v for k, v in laps.parts.items()})
    result["checks"] = checks
    return result


def finite(x):
    """``x`` with every non-finite float written as the string "inf" or
    "nan", so that the result stays strict JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return "nan" if math.isnan(x) else ("inf" if x > 0 else "-inf")
    return x


def main(argv=None, t_start=None) -> int:
    """The command line: run one cell on this machine's card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    plan = cell_plan(load_spec(), args.workload)
    need = int(plan["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"[portbench] {args.workload} needs {need} CUDA device(s); "
            f"found {torch.cuda.device_count()}: no result")
        return 2
    result = run_cell(plan, args.seed, args.seconds, bool(args.trace),
                      device="cuda:0", t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"[portbench] the process loaded {bad}: no result")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0
