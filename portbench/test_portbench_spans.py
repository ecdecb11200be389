"""The program's spans in a traced window (``spans.py``) on the CPU: each
idle gap goes to its innermost span of either family, each synchronising
runtime call to its innermost program span, no idle time is lost or counted
twice, and the traced run's own record and readers read the same numbers
whether or not the program marks its steps."""

import random
import types

import pytest
import torch

from portbench import harness, spans, tracing

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU
SEED = 2**31 + 12345


def _event(name, dev, start_us, dur_us, corr=0, thread=1, annotation=False):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: dev,
        start_ns=lambda: int(start_us * 1000),
        duration_ns=lambda: int(dur_us * 1000),
        correlation_id=lambda: corr, linked_correlation_id=lambda: 0,
        start_thread_id=lambda: thread,
        is_user_annotation=lambda: annotation)


def _span(name, start, end, dev=CPU):
    return _event(name, dev, start, end - start, annotation=True)


# One batch (portbench.batch, 1-150 us) whose engine call (8-112) uploads in
# .view, launches in .prep, .seed, .bounds and .select, runs one round and
# ends on the second round's check, then one fallback check; a sync in
# the harness's own span and a launch after the batch.
HARNESS = [
    _span(tracing.WINDOW_SPAN, 0, 200),
    _span("portbench.batch", 1, 150),
    _event("cudaStreamSynchronize", CPU, 145, 1),
    _event("aten::add", CPU, 155, 4, corr=101),
    _event("cudaLaunchKernel", CPU, 156, 1, corr=6),
    _event("add_kernel", CUDA, 160, 10, corr=6),
]
PROGRAM_HOST = [
    _span("paris.engine.view", 2, 7),
    _event("cudaMemcpyAsync", CPU, 3, 0.5),
    _event("cudaStreamSynchronize", CPU, 3.5, 0.5),
    _span("paris.engine", 8, 112),
    _span("paris.engine.prep", 9, 30),
    _span("paris.engine.seed", 31, 40),
    _event("cudaStreamSynchronize", CPU, 35, 1),
    _span("paris.engine.bounds", 41, 50),
    _span("paris.engine.select", 51, 60),
    _span("paris.engine.round", 61, 90),
    _span("paris.engine.sync", 62, 72),
    _event("cudaStreamSynchronize", CPU, 63, 7),
    _span("paris.engine.round", 91, 100),
    _span("paris.engine.sync", 92, 99),
    _event("cudaStreamSynchronize", CPU, 92.5, 1),
    _span("paris.engine.fallback_round", 101, 110),
    _span("paris.engine.sync", 102, 109),
    _event("cudaStreamSynchronize_v3020", CPU, 102.5, 1),
]
# Host ops and launches: the same with or without the program's spans.
WORK = [
    _event("aten::add", CPU, 10, 2, corr=102),
    _event("cudaLaunchKernel", CPU, 10.5, 1, corr=1),
    _event("aten::topk", CPU, 52, 6, corr=103),
    _event("cudaLaunchKernel", CPU, 53, 1, corr=3),
    _event("cudaLaunchKernel", CPU, 42, 1, corr=2),
    _event("cudaLaunchKernel", CPU, 32, 1, corr=4),
    _event("cudaLaunchKernel", CPU, 74, 1, corr=5),
    _event("cudaLaunchKernel", CPU, 103, 1, corr=7),
    _event("add_kernel", CUDA, 12, 2, corr=1),
    _event("seed_kernel", CUDA, 33, 3, corr=4),
    _event("lb_kernel<16, 0, 128, 4>", CUDA, 45, 15, corr=2),
    _event("topk_kernel", CUDA, 60, 10, corr=3),
    _event("euclid_gather_kernel", CUDA, 76, 4, corr=5),
    _event("euclid_gather_kernel", CUDA, 104, 1, corr=7),
]
# The device-side twins of the annotations, as kineto reports them.
TWINS = [_span("portbench.batch", 12, 105, CUDA),
         _span("paris.engine", 12, 105, CUDA),
         _span("paris.engine.round", 76, 80, CUDA)]
WINDOW = 2e-4


def _plain_events():
    return HARNESS + WORK + TWINS[:1]


def _program_events():
    return HARNESS + PROGRAM_HOST + WORK + TWINS


def _brute_label(named, t):
    """The latest-started span covering ``t``, by a scan of every span."""
    cover = [sp for sp in named if sp[1] <= t <= sp[2]]
    return max(cover, key=lambda sp: (sp[1], -sp[2]))[0] if cover else None


@pytest.mark.parametrize("nested", [True, False])
def test_innermost_is_the_latest_started_cover(nested):
    rng = random.Random(5 + nested)
    named = []
    if nested:  # a call stack: spans close in reverse order of opening
        t, stack = 0.0, []
        for i in range(400):
            t += rng.random()
            if stack and rng.random() < 0.5:
                name, s = stack.pop()
                named.append((name, s, t))
            else:
                stack.append((f"s{i}", t))
        named += [(name, s, t + 1) for name, s in stack]
    else:
        for i in range(300):
            s = rng.uniform(0, 100)
            named.append((f"s{i}", s, s + rng.expovariate(0.2)))
    points = sorted(rng.uniform(-1, 130) for _ in range(500))
    assert spans.innermost(named, points) == [
        _brute_label(named, t) for t in points]


def test_each_gap_goes_to_its_innermost_span():
    got = spans.reduce(_program_events(), WINDOW)
    gaps = {n: (s, c) for n, s, c, _ in got["idle_gaps"]}
    # Busy: 12-14, 33-36, 45-70, 76-80, 104-105, 160-170 (45 us).
    assert got["busy_s"] == pytest.approx(45e-6)
    want = {
        "paris.engine.view": (12e-6, 1),     # 0-12, middle 6
        "paris.engine.prep": (19e-6, 1),     # 14-33, middle 23.5
        "paris.engine": (9e-6, 1),           # 36-45, middle 40.5
        "paris.engine.round": (6e-6, 1),     # 70-76, middle 73
        "paris.engine.sync": (24e-6, 1),     # 80-104, middle 92
        "portbench.batch": (55e-6, 1),       # 105-160, middle 132.5
        "outside portbench spans": (30e-6, 1),  # 170-200
    }
    assert set(gaps) == set(want)
    for name, (s, c) in want.items():
        assert gaps[name][0] == pytest.approx(s), name
        assert gaps[name][1] == c, name
    # Nothing lost or counted twice: the labels make up the idle window.
    assert sum(s for s, _ in gaps.values()) == pytest.approx(
        got["window_s"] - got["busy_s"])
    assert got["idle_s"] == pytest.approx(155e-6)
    assert got["program_idle_s"] == pytest.approx(70e-6)
    assert got["kernels_named_as_spans"] == 0


def test_spans_hold_calls_idle_and_syncs():
    sp = spans.reduce(_program_events(), WINDOW)["spans"]
    assert {n: v["calls"] for n, v in sp.items()} == {
        "paris.engine": 1, "paris.engine.view": 1, "paris.engine.prep": 1,
        "paris.engine.seed": 1, "paris.engine.bounds": 1,
        "paris.engine.select": 1, "paris.engine.round": 2,
        "paris.engine.fallback_round": 1, "paris.engine.sync": 3}
    assert {n: v["syncs"] for n, v in sp.items() if v["syncs"]} == {
        "paris.engine.view": 1, "paris.engine.seed": 1,
        "paris.engine.sync": 3}
    assert sp["paris.engine.round"]["host_s"] == pytest.approx(38e-6)
    assert sp["paris.engine.sync"]["idle_s"] == pytest.approx(24e-6)
    assert sp["paris.engine.sync"]["longest_s"] == pytest.approx(24e-6)
    # Device time launched under each step, through its runtime calls.
    assert sp["paris.engine.select"]["device_s"] == pytest.approx(10e-6)
    assert sp["paris.engine"]["device_s"] == pytest.approx(35e-6)
    got = spans.reduce(_program_events(), WINDOW)
    assert got["syncs_outside_program"] == 1
    fam = got["families"]
    assert set(fam) == {"batch"}
    assert fam["batch"]["calls"] == 1
    assert fam["batch"]["syncs_per_call"] == 5
    assert fam["batch"]["idle_ms_per_call"] == pytest.approx(70e-3)
    # 6 us under .round and 24 us under .sync, over 3 round spans.
    assert fam["batch"]["idle_ms_per_round"] == pytest.approx(10e-3)


def test_syncs_go_to_spans_of_their_own_thread():
    other = [_event("cudaStreamSynchronize", CPU, 35, 1, thread=2)]
    sp = spans.reduce(_program_events() + other, WINDOW)
    assert sp["spans"]["paris.engine.seed"]["syncs"] == 1
    assert sp["syncs_outside_program"] == 2


def test_the_traced_record_reads_the_same_with_program_spans():
    plain = tracing.reduce_events(_plain_events(), WINDOW)
    marked = tracing.reduce_events(_program_events(), WINDOW)
    for key in ("kernels", "busy_s", "window_s", "breakdown"):
        assert marked[key] == plain[key], key
    assert marked["ops"]["aten::topk"] == plain["ops"]["aten::topk"]
    params = {"num_series": 1 << 24, "segments": 16, "series_length": 256}
    counters = {"batches": 1, "queries": 64, "reads": 4096, "batch": 64,
                "rounds": 2}
    names = sorted(p.stem for p in (harness.HERE / "metrics").glob("*.py"))
    for name in names:
        read = harness.metric_reader(name)
        a = read(dict(plain, params=params, counters=counters))
        b = read(dict(marked, params=params, counters=counters))
        assert a == b, name
    assert {harness.metric_reader(m["name"]).__module__
            for m in harness.load_spec()["per_layer"]} <= {
        harness.metric_reader(n).__module__ for n in names}


@pytest.mark.parametrize("cell", ["rw-batch-hard", "rw-single-easy"])
def test_a_window_on_the_cpu_counts_each_engine_call(cell):
    plan = harness.cell_plan(harness.load_spec(), cell)
    got = spans.run(plan, SEED, 0.2, device="cpu", overrides={
        "cfg": {"num_series": 4096, "round_size": 256},
        "traffic": {"pool": 256}})
    c, sp = got["counters"], got["spans"]
    assert got["device"]["platform"] == "cpu"
    if "batches" in c:
        assert sp["paris.engine"]["calls"] == c["batches"]
        assert got["families"]["batch"]["calls"] == c["batches"]
        loops = (sp["paris.engine.round"]["calls"]
                 + sp.get("paris.engine.fallback_round", {"calls": 0})[
                     "calls"])
        assert sp["paris.engine.sync"]["calls"] == loops
        assert c["rounds"] <= loops <= c["rounds"] + 2 * c["batches"]
        assert "paris.single" not in sp
    else:
        assert sp["paris.single"]["calls"] == c["queries"]
        assert sp["paris.single.sync"]["calls"] == sp[
            "paris.single.round"]["calls"]
        assert "paris.engine" not in sp
    assert got["busy_s"] == 0 and got["idle_s"] == pytest.approx(
        got["window_s"], rel=0.05)
