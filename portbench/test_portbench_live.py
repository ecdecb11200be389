"""The live-store cell on the CPU at 4096 series: the deployment leaves the
configured tiers and keeps nothing of the collection, every call of the
window takes the fused path, the answers are the reference's and the
per-component path's, the store's spans and counters show under a profiler,
a broken store path is not correct, and the cell's frozen count and readers
read hand-worked numbers."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import cost_live, datagen, harness
from portbench.deployments import live
from portbench.reference import bruteforce
from repro_torch.core.ingest import MutableIndex
from repro_torch.core.search import Tier

SEED = 2**31 + 4242
CELL = "live-batch-easy"
N = 4096
# Rounds of 256 candidates: several rounds and the exactness fallback's
# reach at this size, in a fraction of the time of the cell's 4096.
TINY = {"cfg": {"num_series": N, "round_size": 256},
        "traffic": {"pool": 256, "sample": 16}}
ROUND = 256


def _plan(**traffic):
    plan = harness.cell_plan(harness.load_spec(), CELL)
    plan["cfg"] = {**plan["cfg"], "num_series": N}
    plan["traffic"] = {**plan["traffic"], "pool": 256, "sample": 16,
                       **traffic}
    return plan


@pytest.fixture(scope="module")
def built():
    """(cfg, raw, handle) of the cell's deployment at 4096 series."""
    cfg = _plan()["cfg"]
    raw = datagen.collection(N, int(cfg["series_length"]), SEED, "cpu")
    return cfg, raw, live.deploy(cfg, raw, "cpu")


def test_the_deployment_leaves_the_configured_tiers(built):
    cfg, raw, handle = built
    part = N // 63  # 65 rows; the last append takes the 1 left over
    assert live.tiers(handle.store) == dict(
        base=[48 * part], runs=[4 * part] * 3,
        deltas=[part, part, part + 1])
    s = handle.stats()
    assert (s["num_series"], s["live_components"]) == (N, 7)
    assert (s["base_series"], s["num_runs"], s["num_deltas"]) == (
        48 * part, 3, 3)
    assert s["compactions"] == 8 and s["appends"] == 31
    held = {raw.untyped_storage().data_ptr()}
    for ix, _ in handle.store.snapshot().components():
        for t in (ix.raw, ix.sax, ix.pos):
            assert t.untyped_storage().data_ptr() not in held


def test_a_store_with_other_tiers_is_refused(built):
    cfg, raw, _ = built
    other = dict(cfg, components=dict(cfg["components"], run_parts=[4, 4]))
    with pytest.raises(RuntimeError, match="expects"):
        live.deploy(other, raw, "cpu")


def test_every_window_call_takes_the_fused_path():
    result = harness.run_cell(_plan(), SEED, 0.2, False, device="cpu",
                              overrides=TINY)
    c = result["counters"]
    assert result["correct"] is True, result["checks"]
    assert c["fused_calls"] == c["batches"] >= 1
    assert (c["live_components"], c["num_series"]) == (7, N)
    assert c["packed_rows"] > N


@pytest.mark.parametrize("noise", [0.1, 0.25])
@pytest.mark.parametrize("k", [1, 4])
def test_answers_equal_the_reference_and_the_per_component_path(
        built, k, noise):
    cfg, raw, handle = built
    traffic = dict(_plan()["traffic"], noise=noise, pool=16)
    qs = datagen.queries(traffic, int(cfg["series_length"]), SEED, "cpu",
                         raw=raw)
    store = handle.store
    d, p = store.exact_knn_batch(qs, k=k, round_size=ROUND)
    chunks = datagen.collection_chunks(N, int(cfg["series_length"]), SEED,
                                       "cpu")
    ref_d, ref_p, _ = bruteforce.knn(chunks, qs, k)
    np.testing.assert_array_equal(p.long().numpy(), ref_p.numpy())
    np.testing.assert_allclose(d.numpy(), ref_d.numpy(), rtol=1e-5)
    before = store.stats()
    d2, p2 = store.exact_knn_batch(qs, k=k, fused=False, round_size=ROUND)
    np.testing.assert_array_equal(p2.long().numpy(), p.long().numpy())
    after = store.stats()
    assert after["component_calls"] == before["component_calls"] + 1
    assert after["fused_calls"] == before["fused_calls"]


def test_spans_and_counters_under_a_profiler(built):
    cfg, raw, _ = built
    handle = live.deploy(cfg, raw, "cpu")  # no packed view built yet
    store = handle.store
    assert store.stats()["packed_rows"] == 0
    qs = raw[:8] + 0.1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        store.exact_knn_batch(qs, k=1)
        store.exact_knn_batch(qs, k=1, fused=False)
        store.knn_batch_tiered(qs, Tier.epsilon(0.1), k=1)
        store.knn_batch_tiered(qs, Tier.exact(), k=1)  # one range, not two
    names = [e.name for e in prof.events() if e.name.startswith("paris.")]
    assert names.count("paris.live") == 4
    assert names.count("paris.live.pack") == 3
    assert names.count("paris.live.merge") == 1
    # The fused calls, then one engine a tier of the per-component call.
    assert names.count("paris.engine") == 3 + 7
    s = store.stats()
    packer = store._packer
    assert s["live_components"] == 7
    assert s["packed_rows"] == packer._cap_blocks * packer.block > N
    assert (s["fused_calls"], s["component_calls"]) == (3, 1)


def test_spans_are_off_without_a_profiler(built):
    _, raw, handle = built
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    handle.store.exact_knn_batch(raw[:2], k=1)
    assert not [e for e in prof.events() if e.name.startswith("paris.")]


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch_left_out"])
def test_a_broken_store_path_is_not_correct(monkeypatch, fault):
    real = MutableIndex.exact_knn_batch

    def broken(*args, **kwargs):
        d, p, *rest = real(*args, **kwargs)
        if fault == "altered_answer":
            p = torch.where(p >= 0, (p + 1) % N, p)
        else:
            half = d.shape[0] // 2
            d, p = d.clone(), p.clone()
            d[half:], p[half:] = float("inf"), -1
        return (d, p, *rest)

    plan = harness.cell_plan(harness.load_spec(), CELL)
    assert harness.run_cell(plan, SEED, 0.2, False, device="cpu",
                            overrides=TINY)["correct"]
    monkeypatch.setattr(MutableIndex, "exact_knn_batch", broken)
    assert not harness.run_cell(plan, SEED, 0.2, False, device="cpu",
                                overrides=TINY)["correct"]


def test_a_store_without_the_new_counters_still_runs(monkeypatch):
    """A program whose store reports none of the live counters (as before
    they were added) runs the cell: the counters and their metrics are
    left out, nothing raises."""
    real = MutableIndex.stats
    new = ("live_components", "packed_rows", "fused_calls",
           "component_calls")

    def older(self):
        return {k: v for k, v in real(self).items() if k not in new}

    monkeypatch.setattr(MutableIndex, "stats", older)
    plan = harness.cell_plan(harness.load_spec(), CELL)
    result = harness.run_cell(plan, SEED, 0.2, True, device="cpu",
                              overrides=TINY)
    assert result["correct"] is True
    assert not set(new) & set(result["counters"])
    assert "live.dead_rows_pct" not in result["metrics"]
    assert "engine.rounds_per_batch.live" in result["metrics"]


def test_lb_multi_work_equals_hand_worked_numbers():
    flop, nbytes = cost_live.lb_multi_work(64, 16515072, 16)
    assert flop == 64 * 16515072 * 16 == 16911433728
    # SAX 264,241,152 + PAA 4,096 + bounds 4,227,858,432 bytes.
    assert nbytes == 264241152 + 4096 + 4227858432 == 4492103680
    assert 4492103680 / 3.35e12 == pytest.approx(1.3409e-3, rel=1e-4)


MASKED = "void (anonymous namespace)::lb_kernel<16, 1, 128, 4>(float const*)"
BATCH = "void (anonymous namespace)::lb_kernel<16, 0, 128, 4>(float const*)"


def test_the_live_readers_on_a_hand_made_record():
    record = dict(
        kernels=[(MASKED, 0.0, 4000.0), (BATCH, 5000.0, 9000.0),
                 (MASKED, 10000.0, 12000.0)],
        ops={}, window_s=0.5, busy_s=0.4,
        params={"num_series": 16515072, "segments": 16,
                "series_length": 256},
        counters={"batches": 2, "queries": 128, "batch": 64,
                  "packed_rows": 18579456, "num_series": 16515072})
    roof = harness.metric_reader("lb_multi_roofline")(record)
    assert roof == pytest.approx(100 * 2 * 4492103680 / 3.35e12 / 6e-3)
    dead = harness.metric_reader("live.dead_rows_pct")(record)
    assert dead == 12.5
    no_masked = dict(record, kernels=[(BATCH, 0.0, 4000.0)])
    assert harness.metric_reader("lb_multi_roofline")(no_masked) is None
    parent = dict(record, counters={"batches": 2, "queries": 128,
                                    "batch": 64})
    assert harness.metric_reader("live.dead_rows_pct")(parent) is None
