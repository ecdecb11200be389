"""The device's idle gaps and the host's syncs of a traced window, put down
to the program's own steps.

While a profiler runs, ``repro_torch`` marks each step of its two search
engines with a ``paris.*`` range (``repro_torch.core.trace``): the batch
engine's ``paris.engine`` and its ``.view``, ``.prep``, ``.seed``,
``.bounds``, ``.select``, ``.round``, ``.fallback_round`` and ``.sync``;
the one-query engine's ``paris.single`` and its ``.prep``, ``.seed``,
``.bounds``, ``.sort``, ``.round`` and ``.sync``. ``reduce`` takes a
window's kineto events and gives, for each of those names, its calls, its
host seconds, the idle gaps whose innermost span it is, and the
synchronising CUDA runtime calls whose innermost program span on their
thread it is; and the idle gaps of the window labelled with their innermost
span of either family (the benchmark's ``portbench.*`` or the program's).

    python3 portbench/spans.py --workload <name> --seed <n> --seconds <s>

runs one cell as a traced run does (the same set-up, warm-up and window;
no reference check) and prints one JSON line: the loop's end-to-end
numbers under the profiler, the idle share, the labelled gaps, ``spans``
and each engine's ``families`` figures.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import time

import torch

if __package__ in (None, ""):
    ROOT = pathlib.Path(__file__).resolve().parent.parent
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]

from portbench import harness, tracing  # noqa: E402

PROGRAM = "paris."
HARNESS = "portbench."
# Runtime calls that block the host until the device has caught up.
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
# Each engine's family of spans: its top span and every ``<top>.*``.
FAMILIES = {"batch": "paris.engine", "single": "paris.single"}
ROUNDS = ("paris.engine.round", "paris.engine.fallback_round")


def innermost(spans: list, points: list) -> list:
    """For each of the ascending ``points``, the name of the latest-started
    of the (name, start, end) ``spans`` with start <= point <= end, or
    None. Exact for any intervals: a span popped off the stack ended before
    an earlier point, and the stack is in order of start."""
    spans = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][1] <= t:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def _is_sync(name: str) -> bool:
    """Whether a runtime call waits for the device (``cudaMemcpy`` and
    ``cudaMemcpy_v3020`` do; ``cudaMemcpyAsync`` does not)."""
    return name.split("_")[0] in SYNC_CALLS


def _gaps(busy: list, window: tuple) -> list:
    """(start, end) of the window's idle gaps between the merged busy
    intervals, as ``tracing.reduce_events`` cuts them."""
    w0, w1 = window
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    out = []
    for s, e in zip(edges[0::2], edges[1::2]):
        s, e = max(s, w0), min(e, w1)
        if e > s:
            out.append((s, e))
    return out


def reduce(events, window_s: float) -> dict:
    """The traced window's record (``tracing.reduce_events``) with the
    program's spans added: ``idle_gaps``, ``spans`` and ``families``."""
    record = tracing.reduce_events(events, window_s)
    cuda = torch.autograd.DeviceType.CUDA
    host, syncs = [], collections.defaultdict(list)
    for e in events:
        if e.device_type() == cuda:
            continue
        name = e.name()
        s = e.start_ns() / 1e3
        end = s + e.duration_ns() / 1e3
        if name.startswith((PROGRAM, HARNESS)):
            host.append((name, s, end, e.start_thread_id()))
        elif _is_sync(name):
            syncs[e.start_thread_id()].append(s)
    # Program annotations on the device are ranges, not work.
    kernels = [k for k in record["kernels"] if not k[0].startswith(PROGRAM)]
    busy = tracing._union([(s, e) for _, s, e in kernels])
    window = [(s, e) for n, s, e, _ in host if n == tracing.WINDOW_SPAN]

    spans = collections.defaultdict(lambda: dict(
        calls=0, host_s=0.0, device_s=0.0, idle_s=0.0, gaps=0,
        longest_s=0.0, syncs=0))
    for n, s, e, _ in host:
        if n.startswith(PROGRAM):
            spans[n]["calls"] += 1
            spans[n]["host_s"] += (e - s) / 1e6
    labels = collections.defaultdict(lambda: [0.0, 0, 0.0])
    if window:
        gaps = _gaps(busy, window[0])
        named = [(n, s, e) for n, s, e, _ in host if n != tracing.WINDOW_SPAN]
        for (s, e), n in zip(gaps, innermost(named,
                                             [(s + e) / 2 for s, e in gaps])):
            g = labels[n or "outside portbench spans"]
            g[0] += (e - s) / 1e6
            g[1] += 1
            g[2] = max(g[2], (e - s) / 1e6)
    for n, sp in spans.items():
        sp["device_s"] = record["ops"].get(n, 0.0) / 1e6
        sp["idle_s"], sp["gaps"], sp["longest_s"] = labels.get(
            n, (0.0, 0, 0.0))
    outside = 0
    for thread, starts in syncs.items():
        mine = [(n, s, e) for n, s, e, t in host
                if t == thread and n.startswith(PROGRAM)]
        for n in innermost(mine, sorted(starts)):
            if n is None:
                outside += 1
            else:
                spans[n]["syncs"] += 1
    spans = dict(sorted(spans.items()))
    return dict(
        record,
        kernels_named_as_spans=len(record["kernels"]) - len(kernels),
        idle_s=sum(v[0] for v in labels.values()),
        program_idle_s=sum(v["idle_s"] for v in spans.values()),
        idle_gaps=sorted(([n, s, c, m] for n, (s, c, m) in labels.items()),
                         key=lambda x: -x[1]),
        spans=spans, syncs_outside_program=outside,
        families=families(spans))


def families(spans: dict) -> dict:
    """Each engine's figures, where its top span ran: syncs and idle
    milliseconds a call (over its family of spans), and for the batch
    engine idle milliseconds a round (under the round spans and their
    ``.sync`` children, over the round spans)."""
    out = {}
    for fam, top in FAMILIES.items():
        calls = spans.get(top, {}).get("calls", 0)
        if not calls:
            continue
        mine = [v for n, v in spans.items()
                if n == top or n.startswith(top + ".")]
        out[fam] = dict(
            calls=calls,
            syncs_per_call=sum(v["syncs"] for v in mine) / calls,
            idle_ms_per_call=1e3 * sum(v["idle_s"] for v in mine) / calls)
    rounds = sum(spans.get(n, {}).get("calls", 0) for n in ROUNDS)
    if "batch" in out and rounds:
        idle = sum(spans.get(n, {}).get("idle_s", 0.0)
                   for n in ROUNDS + ("paris.engine.sync",))
        out["batch"]["idle_ms_per_round"] = 1e3 * idle / rounds
    return out


class _Keep(tracing.Tracer):
    """A traced run's tracer whose record is ``reduce``'s."""

    def __exit__(self, *exc):
        tracing.sync(self.device)
        window_s = time.perf_counter() - self._t0
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.record = reduce(
                self._prof.profiler.kineto_results.events(), window_s)
        self._prof = None
        return False


KEPT = ("window_s", "busy_s", "breakdown", "idle_s", "program_idle_s",
        "idle_gaps", "spans", "syncs_outside_program", "families",
        "kernels_named_as_spans")


def run(plan: dict, seed: int, seconds: float, *, device="cuda:0",
        overrides=None) -> dict:
    """One traced window of a plan (``harness.cell_plan``), reduced."""
    plan = dict(plan)
    for part, extra in (overrides or {}).items():
        plan[part] = {**plan[part], **extra}
    cfg, traffic = plan["cfg"], plan["traffic"]
    dev = torch.device(device)
    torch.empty(1, device=dev)
    handle, queries, loop = harness.deploy(plan, seed, dev)
    tracer = _Keep(True, dev)
    loop.warm(handle, cfg, traffic, queries, tracer)
    with tracer:
        out = loop.run(handle, cfg, traffic, queries, seconds, seed, tracer)
    handle.close()
    rec = tracer.record
    return dict({k: rec[k] for k in KEPT}, end_to_end=out.metrics,
                counters={k: v for k, v in out.counters.items()
                          if isinstance(v, (int, float))},
                idle_pct=100.0 * (1.0 - rec["busy_s"] / rec["window_s"]),
                device=harness.device_info(dev, 0))


def main(argv=None) -> int:
    """The command line: one cell on this machine's card."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("[spans] no CUDA device: no result")
        return 2
    plan = harness.cell_plan(harness.load_spec(), args.workload)
    got = run(plan, args.seed, args.seconds)
    print(json.dumps(harness.finite(dict(workload=args.workload,
                                         seed=args.seed, **got))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
