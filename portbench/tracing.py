"""The traced run's record: ``torch.profiler`` over the window, and the
benchmark's own spans around its calls into each layer.

``Tracer`` is a no-op unless tracing is on. When on, it profiles CPU and
CUDA activity over the window and reduces the trace to a record that the
per-layer metric readers (``metrics/<name>.py``) take:

- ``kernels``: (name, start us, end us) of every device operation;
- ``ops``: device microseconds launched under each host operation, by
  name (its own launches and its children's), e.g. ``aten::topk``;
- ``window_s``: the traced window by the host clock; ``busy_s``: the union
  of the device operations' intervals;
- ``breakdown``: the device operations that took most time, and the idle
  gaps of the device grouped by the innermost ``portbench.*`` span that
  the host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

TOP = 10  # entries of each breakdown list
WINDOW_SPAN = "portbench.window"


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _union(intervals: list) -> list:
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _labeller(spans: list):
    """A function of a time: the name of the innermost span covering it
    (the latest-started of those that cover it), else ``outside``."""
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [s for _, s, _ in spans]

    def label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 8, -1), -1):
            if spans[j][2] >= t:
                return spans[j][0]
        return "outside portbench spans"
    return label


def _annotation(e) -> bool:
    """Whether a kineto event is a user annotation (a span, not work)."""
    is_ann = getattr(e, "is_user_annotation", None)
    return bool(is_ann()) if is_ann is not None else False


def _device_under_ops(cpu: list, launched: dict) -> dict:
    """Device microseconds launched under each host operation, by name.

    ``cpu`` holds (name, start, end, correlation, thread) of the host
    events; ``launched`` the device microseconds of each CUPTI
    correlation, which a device event shares with the runtime call
    (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that issued it. A
    runtime call's device time counts once for every distinct name on the
    stack of host operations that encloses the call on its thread:
    ``aten::topk`` gets the launches of its children too.
    """
    out = collections.Counter()
    by_thread = collections.defaultdict(list)
    for ev in cpu:
        by_thread[ev[4]].append(ev)
    for evs in by_thread.values():
        evs.sort(key=lambda ev: (ev[1], -ev[2]))
        stack = []
        for name, s, e, corr, _ in evs:
            while stack and stack[-1][1] <= s:
                stack.pop()
            if name.startswith("cu"):
                us = launched.get(corr)
                if us:
                    for op in {n for n, _ in stack}:
                        out[op] += us
            else:
                stack.append((name, e))
    return dict(out)


def reduce_events(events, window_s: float) -> dict:
    """The record of a profiler's kineto events (see the module
    docstring)."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, cpu = [], []
    launched = collections.Counter()
    for e in events:
        name = e.name()
        s = e.start_ns() / 1e3
        end = s + e.duration_ns() / 1e3
        if e.device_type() == cuda:
            if name.startswith("portbench.") or _annotation(e):
                continue
            kernels.append((name, s, end))
            launched[e.correlation_id()] += end - s
        else:
            cpu.append((name, s, end, e.correlation_id(),
                        e.start_thread_id()))
    spans = [(n, s, e) for n, s, e, _, _ in cpu if n.startswith("portbench.")]
    ops = _device_under_ops(cpu, launched)
    busy = _union([(s, e) for _, s, e in kernels])
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_name = collections.Counter()
    for name, s, e in kernels:
        by_name[name] += (e - s) / 1e6
    window = [(s, e) for n, s, e in spans if n == WINDOW_SPAN]
    label = _labeller([sp for sp in spans if sp[0] != WINDOW_SPAN])
    gaps = collections.defaultdict(lambda: [0.0, 0, 0.0])
    if window:
        w0, w1 = window[0]
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        for s, e in zip(edges[0::2], edges[1::2]):
            s, e = max(s, w0), min(e, w1)
            if e > s:
                g = gaps[label((s + e) / 2)]
                g[0] += (e - s) / 1e6
                g[1] += 1
                g[2] = max(g[2], (e - s) / 1e6)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:TOP]
    return dict(
        kernels=kernels, ops=ops, window_s=window_s, busy_s=busy_s,
        breakdown=dict(
            device_ops=[[n[:160], s] for n, s in by_name.most_common(TOP)],
            idle_gaps=[[f"{n} ({c} gaps, longest {m} s)", s]
                       for n, (s, c, m) in idle]))


class Tracer:
    """Profiles the window when ``on``; ``span(name)`` marks host spans."""

    def __init__(self, on: bool, device):
        self.on = bool(on)
        self.device = device
        self.record = None
        self._prof = None
        self._window = None

    def span(self, name: str):
        """A ``record_function`` span when tracing, else nothing."""
        if self.on:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._window = torch.profiler.record_function(WINDOW_SPAN)
            self._window.__enter__()
        sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        window_s = time.perf_counter() - self._t0
        if self.on:
            self._window.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.record = reduce_events(
                    self._prof.profiler.kineto_results.events(), window_s)
            self._prof = None
        return False
