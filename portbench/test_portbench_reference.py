"""The yardstick on the CPU: the reference against a float64 loop, the
frozen roofline counts against hand-worked numbers, the judge, the trace
reduction and the per-layer readers on hand-made records."""

import math
import types

import numpy as np
import pytest
import torch

from portbench import cost, datagen, harness, judge, tracing
from portbench.reference import bruteforce

DEVICE_CUDA = torch.autograd.DeviceType.CUDA
DEVICE_CPU = torch.autograd.DeviceType.CPU


def f64_knn(raw: np.ndarray, q: np.ndarray, k: int) -> tuple:
    """The plainest exact k-NN: float64 loops over z-normed rows."""
    def z(x):
        c = x - x.mean()
        return c / (np.sqrt((c * c).mean()) + 1e-8)
    rows = [z(r) for r in raw.astype(np.float64)]
    out_d, out_p = [], []
    for qq in q.astype(np.float64):
        qz = z(qq)
        d = np.array([((r - qz) ** 2).sum() for r in rows])
        order = np.argsort(d, kind="stable")[:k]
        out_d.append(d[order])
        out_p.append(order)
    return np.array(out_d), np.array(out_p)


@pytest.mark.parametrize("k", [1, 8])
def test_reference_equals_a_float64_loop(monkeypatch, k):
    monkeypatch.setattr(datagen, "WALK_CHUNK", 700)
    n, num = 64, 2000
    raw = datagen.collection(num, n, 5, "cpu")
    gen = datagen.generator(5, datagen.QUERIES, "cpu")
    qs = torch.randn((6, n), generator=gen).cumsum(1)  # fresh walks
    want_d, want_p = f64_knn(raw.numpy(), qs.numpy(), k)
    probe = torch.tensor(want_p[:, ::-1].copy())
    d, p, probe_d = bruteforce.knn(
        datagen.collection_chunks(num, n, 5, "cpu"), qs, k, probe=probe,
        rows=300)
    assert np.allclose(d.numpy(), want_d, rtol=1e-5)
    assert np.array_equal(p.numpy(), want_p)
    assert np.allclose(probe_d.numpy(), want_d[:, ::-1], rtol=1e-5)
    bad = bruteforce.knn(datagen.collection_chunks(num, n, 5, "cpu"), qs, k,
                         probe=torch.full((6, 1), num))[2]
    assert torch.isinf(bad).all()


def test_roofline_counts_equal_hand_worked_numbers():
    flop, nbytes = cost.lb_batch_work(64, 1 << 24, 16)
    assert flop == 64 * 16777216 * 16 == 17179869184
    # SAX 268,435,456 + PAA 4,096 + bounds 4,294,967,296 bytes.
    assert nbytes == 268435456 + 4096 + 4294967296 == 4563406848
    least = cost.least_seconds(flop, nbytes)
    assert least == pytest.approx(4563406848 / 3.35e12)  # byte-bound
    assert least == pytest.approx(1.3622e-3, rel=1e-4)
    assert cost.roofline_pct(least, 3.06e-3) == pytest.approx(44.52, rel=1e-3)
    flop, nbytes = cost.euclid_work(1000, 256, 3, 64)
    assert flop == 512000
    assert nbytes == 1000 * 256 * 4 + 3 * 64 * 256 * 4 == 1220608
    assert cost.roofline_pct(0.0, 1.0) is None
    assert cost.roofline_pct(1.0, 0.0) is None


def test_judge_passes_exact_answers_and_fails_altered_ones():
    ref = np.array([[1.0, 2.0], [3.0, 4.0]])
    ok = judge.numbers(ref * (1 + 1e-7), np.array([[5, 6], [7, 8]]),
                       ref, ref, 0)
    assert judge.verdict(ok, {"missing": 0, "dist_gap": 1e-4,
                              "pos_gap": 1e-4})[0]
    limits = {"missing": 0, "dist_gap": 1e-4, "pos_gap": 1e-4}
    wrong_pos = judge.numbers(ref, np.array([[5, 6], [7, 8]]), ref,
                              ref * np.array([[1.0, 1.01], [1, 1]]), 0)
    assert wrong_pos["pos_gap"] == pytest.approx(0.01)
    assert not judge.verdict(wrong_pos, limits)[0]
    dup = judge.numbers(ref, np.array([[5, 5], [7, 8]]), ref, ref, 0)
    assert math.isinf(dup["pos_gap"])
    missing = judge.numbers(ref, np.array([[5, 6], [7, 8]]), ref, ref, 1)
    assert not judge.verdict(missing, limits)[0]
    gone = judge.numbers(np.array([[1.0, np.inf], [3.0, 4.0]]),
                         np.array([[5, -1], [7, 8]]), ref,
                         np.array([[1.0, np.inf], [3.0, 4.0]]), 0)
    assert math.isinf(gone["dist_gap"]) and math.isinf(gone["pos_gap"])


def _event(name, dev, start_us, dur_us, corr=0, linked=0, thread=1,
           annotation=False):
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: dev,
        start_ns=lambda: int(start_us * 1000),
        duration_ns=lambda: int(dur_us * 1000),
        correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
        start_thread_id=lambda: thread, is_user_annotation=lambda: annotation)


def test_trace_reduction_attributes_launches_to_their_host_ops():
    # A device event shares its CUPTI correlation with the runtime call
    # that issued it; host operations have correlations of their own, from
    # another count, which may coincide with CUPTI's.
    ev = [
        _event(tracing.WINDOW_SPAN, DEVICE_CPU, 0, 100, corr=1,
               annotation=True),
        _event("portbench.batch", DEVICE_CPU, 1, 60, corr=2,
               annotation=True),
        _event("aten::topk", DEVICE_CPU, 2, 20, corr=11),
        _event("aten::sort", DEVICE_CPU, 3, 5, corr=12),
        _event("cudaLaunchKernel", DEVICE_CPU, 4, 1, corr=11, linked=12),
        _event("cudaLaunchKernel", DEVICE_CPU, 10, 1, corr=12, linked=11),
        _event("aten::add", DEVICE_CPU, 30, 5, corr=13),
        _event("cudaLaunchKernel", DEVICE_CPU, 31, 1, corr=13, linked=13),
        _event("portbench.batch", DEVICE_CUDA, 1, 60, corr=14, linked=2,
               annotation=True),
        _event("sort_kernel", DEVICE_CUDA, 10, 10, corr=11, linked=12),
        _event("topk_kernel", DEVICE_CUDA, 20, 5, corr=12, linked=11),
        _event("add_kernel", DEVICE_CUDA, 40, 10, corr=13, linked=13),
    ]
    rec = tracing.reduce_events(ev, 1e-4)
    assert rec["ops"]["aten::topk"] == pytest.approx(15.0)
    assert rec["ops"]["aten::sort"] == pytest.approx(10.0)
    assert rec["ops"]["aten::add"] == pytest.approx(10.0)
    assert rec["ops"]["portbench.batch"] == pytest.approx(25.0)
    assert [k[0] for k in rec["kernels"]] == [
        "sort_kernel", "topk_kernel", "add_kernel"]
    assert rec["busy_s"] == pytest.approx(25e-6)
    gaps = dict(rec["breakdown"]["idle_gaps"])
    total = sum(gaps.values())
    assert total == pytest.approx(75e-6)
    # Gaps [0, 10] and [25, 40] fall in the batch span, [50, 100] outside.
    assert sum(v for k, v in gaps.items()
               if k.startswith("portbench.batch")) == pytest.approx(25e-6)
    assert sum(v for k, v in gaps.items()
               if k.startswith("outside")) == pytest.approx(50e-6)


def test_readers_on_a_hand_made_record():
    names = sorted(p.stem for p in (harness.HERE / "metrics").glob("*.py"))
    lb = "void (anonymous namespace)::lb_kernel<16, 0, 128, 4>(float const*)"
    record = dict(
        kernels=[(lb, 0.0, 3000.0), (lb, 5000.0, 8000.0),
                 ("void (anonymous namespace)::lb_kernel<16, 1, 128, 4>()",
                  9000.0, 9500.0),
                 ("void (anonymous namespace)::euclid_gather_kernel<true, "
                  "256, 4>(float const*)", 10000.0, 10100.0)],
        ops={"aten::topk": 80000.0}, window_s=0.5, busy_s=0.4,
        params={"num_series": 1 << 24, "segments": 16,
                "series_length": 256},
        counters={"batches": 2, "queries": 128, "reads": 25600,
                  "batch": 64, "rounds": 9})
    got = {name: harness.metric_reader(name)(record) for name in names}
    assert got["engine.reads_per_query"] == 200.0
    assert got["engine.rounds_per_batch"] == 4.5
    assert got["selection.topk_ms_per_batch"] == 40.0
    assert got["lb_batch_roofline"] == pytest.approx(
        100 * 2 * 4563406848 / 3.35e12 / 6e-3)
    assert got["euclid_roofline"] == pytest.approx(
        100 * (25600 * 1024 + 64 * 1024) / 3.35e12 / 1e-4)
    assert got["device.idle_pct"] == pytest.approx(20.0)
    empty = dict(kernels=[], ops={}, window_s=0.5, busy_s=0.0, params={},
                 counters={})
    for name in names:
        assert harness.metric_reader(name)(empty) is None
