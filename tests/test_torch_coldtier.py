"""Port parity, the cold tier: repro_torch.core.coldtier against
repro.core.coldtier.

One index, built by the reference and carried to the port through its
arrays (``convert.index_from_arrays``), is spilled as a cold epoch by both
packages: the catalogs and the epoch files are byte-identical. Over those
epochs the port's cold engine must answer as the reference's does and as
the port's in-memory engine does — positions exact, distances bitwise
(the same rows meet the same kernel) — at block-cache budgets {0, tiny,
unlimited}, reading no more blocks than the reference. A demoted store written
by either package is recovered by the other. The demotion protocol is
swept at a bounded set of kill points.
"""

import dataclasses
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BlockCache as JBlockCache
from repro.core import MutableIndex as JMutable
from repro.core import build_index as j_build_index
from repro.core import coldtier as jcold
from repro_torch import convert
from repro_torch.core import coldtier, durable, search
from repro_torch.core.block_cache import BlockCache, ColdReader
from repro_torch.core.build_pipeline import keys_to_u64, refine_key
from repro_torch.core.durable import FaultError, fail_at
from repro_torch.core.index import build_index
from repro_torch.core.ingest import MutableIndex
from repro_torch.core.search import (SearchConfig, Tier, exact_knn_batch,
                                     exact_search_batch, knn_batch_tiered,
                                     make_batch_engine)
from test_torch_search import assert_float_parity

RNG = np.random.default_rng(7)
LENGTH = 64
ROUND = 128
RAW = RNG.standard_normal((420, LENGTH)).cumsum(axis=1).astype(np.float32)
QUERIES = RNG.standard_normal((4, LENGTH)).cumsum(axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def index_pair():
    """(reference index over RAW[:350], the port's over its arrays)."""
    j = j_build_index(jnp.asarray(RAW[:350]))
    t = convert.index_from_arrays(
        np.asarray(j.sax), np.asarray(j.pos), np.asarray(j.bucket_offsets),
        np.asarray(j.raw), j.series_length, j.segments, j.cardinality,
        device="cpu")
    return j, t


def _spill_port(workdir, idx, name="e0", cache=None):
    keys = keys_to_u64(refine_key(idx.sax, 4, idx.cardinality))
    pos = idx.pos.numpy()
    ref = coldtier.spill_cold_component(
        workdir, name, keys, idx.sax.numpy(), pos, idx.raw.numpy()[pos],
        base=0, series_length=idx.series_length)
    coldtier.catalog_add(workdir, name, coldtier.epoch_entry(
        workdir, name, base=0, num_series=idx.num_series,
        series_length=idx.series_length, bucket_offsets=idx.bucket_offsets))
    return coldtier.load_cold_shard(
        workdir, ref, cache=cache or BlockCache(block_rows=8),
        segments=idx.segments, cardinality=idx.cardinality, device="cpu")


def _spill_ref(workdir, idx, name="e0", cache=None):
    from repro.core.build_pipeline import _host_refine_key

    keys = _host_refine_key(np.asarray(idx.sax), 4, idx.cardinality)
    pos = np.asarray(idx.pos)
    ref = jcold.spill_cold_component(
        workdir, name, keys, np.asarray(idx.sax), pos,
        np.asarray(idx.raw)[pos], base=0, series_length=idx.series_length)
    jcold.catalog_add(workdir, name, jcold.epoch_entry(
        workdir, name, base=0, num_series=idx.num_series,
        series_length=idx.series_length,
        bucket_offsets=np.asarray(idx.bucket_offsets)))
    return jcold.load_cold_shard(
        workdir, ref, cache=cache or JBlockCache(block_rows=8),
        segments=idx.segments, cardinality=idx.cardinality)


def test_cold_epoch_files_byte_identical(tmp_path):
    j, t = index_pair()
    wt, wj = str(tmp_path / "port"), str(tmp_path / "ref")
    os.makedirs(wt)
    os.makedirs(wj)
    shard = _spill_port(wt, t)
    _spill_ref(wj, j)
    for rel in ("COLD_CATALOG.json", "e0/keys.npy", "e0/sax.npy",
                "e0/pos.npy", "e0/raw_leaf.npy", "e0/meta.json"):
        with open(os.path.join(wt, rel), "rb") as a, \
                open(os.path.join(wj, rel), "rb") as b:
            assert a.read() == b.read(), rel
    # the pointer index names each bucket's rows, in leaf order on disk
    entry = coldtier.read_catalog(wt)["epochs"]["e0"]
    off = t.bucket_offsets.numpy()
    key = int(np.flatnonzero(np.diff(off))[0])
    start, length = coldtier.byte_range(entry, key)
    with open(os.path.join(wt, "e0", coldtier.COLD_RAW), "rb") as f:
        f.seek(start)
        rows = np.frombuffer(f.read(length), np.float32).reshape(-1, LENGTH)
    s, e = off[key], off[key + 1]
    np.testing.assert_array_equal(rows, t.raw.numpy()[t.pos.numpy()[s:e]])
    assert coldtier.byte_range(entry, int(np.flatnonzero(
        np.diff(off) == 0)[0])) is None
    np.testing.assert_array_equal(shard.bucket_offsets.numpy(), off)
    np.testing.assert_array_equal(keys_to_u64(shard.keys),
                                  np.load(os.path.join(wj, "e0/keys.npy")))


@pytest.mark.parametrize("budget", [0, 2048, None])
def test_cold_answers_at_every_cache_budget(tmp_path, budget):
    """Budget 0 (re-read everything), tiny (eviction) and None: the same
    bits as the reference's cold engine and the in-memory engine."""
    j, t = index_pair()
    wt, wj = str(tmp_path / "port"), str(tmp_path / "ref")
    os.makedirs(wt)
    os.makedirs(wj)
    st = _spill_port(wt, t, cache=BlockCache(budget, block_rows=8))
    sj = _spill_ref(wj, j, cache=JBlockCache(budget, block_rows=8))
    got = coldtier.cold_exact_knn_batch(st, QUERIES, k=5, round_size=ROUND,
                                        stats=True)
    want = jcold.cold_exact_knn_batch(sj, jnp.asarray(QUERIES), k=5,
                                      round_size=ROUND, stats=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert_float_parity(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[2:4], want[2:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[4] == int(want[4])
    # The reference reads every candidate of a round; the port only those
    # the round's mask keeps: never more blocks.
    cs, cj = st.reader.cache.stats(), sj.reader.cache.stats()
    assert cs["misses"] <= cj["misses"]
    assert cs["bytes_read"] <= cj["bytes_read"]
    mem = exact_knn_batch(t, QUERIES, k=5, round_size=ROUND, stats=True)
    for g, w in zip(got[:4], mem[:4]):
        assert torch.equal(g, w)
    cs = st.reader.cache.stats()
    assert cs["misses"] > 0 and cs["bytes_read"] > 0
    if budget == 0:
        assert cs["cached_bytes"] == 0
    elif budget is not None:
        assert 0 < cs["cached_bytes"] <= budget and cs["evictions"] > 0


def test_cold_tiers_1nn_and_engine_match_memory(tmp_path):
    _, t = index_pair()
    shard = _spill_port(str(tmp_path), t)
    for tier in (Tier.epsilon(0.2), Tier.budget(1)):
        want = knn_batch_tiered(t, QUERIES, tier, k=3, round_size=ROUND)
        got = coldtier.cold_knn_batch_tiered(shard, QUERIES, tier, k=3,
                                             round_size=ROUND)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    cfg = SearchConfig(round_size=ROUND)
    for sort in (True, False):
        cfg = dataclasses.replace(cfg, sort=sort)
        want = exact_search_batch(t, QUERIES, cfg)
        got = coldtier.cold_exact_search_batch(shard, QUERIES, cfg)
        for name in ("dist_sq", "position", "raw_reads", "bsf_updates"):
            assert torch.equal(getattr(got, name), getattr(want, name))
        assert got.rounds == want.rounds
    eng_m = make_batch_engine(t, k=3, round_size=ROUND)
    eng_c = coldtier.make_cold_batch_engine(shard, k=3, round_size=ROUND)
    for a, b in zip(eng_m(QUERIES[:3]), eng_c(QUERIES[:3])):
        assert torch.equal(a, b)
    assert eng_c.bucket(3) == 4
    # an unlimited cache reads each block once
    first = shard.reader.cache.stats()["bytes_read"]
    coldtier.cold_exact_knn_batch(shard, QUERIES, k=2, round_size=ROUND)
    assert shard.reader.cache.stats()["bytes_read"] == first


@pytest.mark.parametrize("store", ["index", "packed", "cold", "live"])
def test_every_store_checks_queries_and_k_alike(tmp_path, store):
    """Each store's k-NN entry goes through the engine's one front door:
    k < 1 and malformed queries raise, and a k past the store's size is
    answered with every series and (INF, NO_POS) in the slots past it."""
    _, t = index_pair()
    n = t.num_series
    if store == "index":
        def call(qs, k):
            return exact_knn_batch(t, qs, k=k, round_size=ROUND)
    elif store == "packed":
        packed = search.pack_components([(t, 0)])

        def call(qs, k):
            return search.exact_knn_batch_packed(packed, qs, k=k,
                                                 round_size=ROUND)
    elif store == "cold":
        shard = _spill_port(str(tmp_path), t)

        def call(qs, k):
            return coldtier.cold_exact_knn_batch(shard, qs, k=k,
                                                 round_size=ROUND)
    else:
        live = MutableIndex(t, device="cpu")

        def call(qs, k):
            return live.exact_knn_batch(qs, k=k, fused=True,
                                        round_size=ROUND)
    with pytest.raises(ValueError, match="k must be"):
        call(QUERIES, 0)
    with pytest.raises(ValueError, match="queries must be"):
        call(QUERIES[:, :LENGTH - 1], 1)
    d, p = call(QUERIES, n + 3)
    assert torch.isinf(d[:, n:]).all() and (p[:, n:] == search.NO_POS).all()
    assert torch.isfinite(d[:, :n]).all()
    for row in p[:, :n]:
        assert sorted(row.tolist()) == list(range(n))


@pytest.mark.parametrize("budget", [0, None])
def test_block_cache_times_block_reads_and_gathers(tmp_path, budget):
    """``read_time`` grows with block reads only (misses), ``gathers`` and
    ``gather_time`` with every :meth:`ColdReader.rows` call."""
    path = str(tmp_path / "raw.npy")
    np.save(path, RAW)
    cache = BlockCache(budget, block_rows=8)
    reader = ColdReader(path, cache)
    ids = np.array([5, 0, 17, 5, 409])  # blocks 0, 0, 2, 0, 51
    np.testing.assert_array_equal(reader.rows(ids), RAW[ids])
    s1 = cache.stats()
    assert s1["gathers"] == 1 and s1["misses"] == 3
    assert 0 < s1["read_time"] <= s1["gather_time"]
    np.testing.assert_array_equal(reader.rows(ids), RAW[ids])
    s2 = cache.stats()
    assert s2["gathers"] == 2 and s2["gather_time"] > s1["gather_time"]
    if budget is None:  # every block stayed: no read
        assert s2["misses"] == 3 and s2["read_time"] == s1["read_time"]
    else:
        assert s2["misses"] == 6 and s2["read_time"] > s1["read_time"]


def _assert_oracle(m, n, k=4):
    oracle = build_index(RAW[:n], device="cpu")
    want_d, want_p = exact_knn_batch(oracle, QUERIES, k=k, round_size=ROUND)
    got_d, got_p = m.exact_knn_batch(QUERIES, k=k, round_size=ROUND)
    np.testing.assert_array_equal(got_p.numpy(), want_p.numpy())
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())


def _demoted(make, workdir):
    """An empty durable store, 260 series demoted, 70 appended on top."""
    m = make(workdir)
    m.append(RAW[:150])
    m.append(RAW[150:260])
    m.compact(tier="minor")
    res = m.demote()
    assert res.cold is not None
    m.append(RAW[260:330])
    return m


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_demoted_store_recovered_across_packages(tmp_path, direction):
    workdir = str(tmp_path / "store")
    if direction == "ref_to_port":
        w = _demoted(lambda d: JMutable(series_length=LENGTH, workdir=d),
                     workdir)
        r = MutableIndex.recover(workdir, device="cpu")
    else:
        w = _demoted(lambda d: MutableIndex(series_length=LENGTH,
                                            workdir=d, device="cpu"),
                     workdir)
        r = JMutable.recover(workdir)
    want = w.exact_knn_batch(QUERIES, k=4, round_size=ROUND)
    got = r.exact_knn_batch(QUERIES, k=4, round_size=ROUND)
    np.testing.assert_array_equal(np.array(got[1]), np.array(want[1]))
    assert_float_parity(np.array(got[0]), np.array(want[0]))
    snap = r.snapshot()
    assert len(snap.cold) == 1 and snap.base_offset == 260
    assert r.num_series == 330 and r.num_deltas == 1
    port = r if direction == "ref_to_port" else w
    _assert_oracle(port, 330)
    cat = coldtier.read_catalog(workdir)
    assert set(cat["epochs"]) == {c.dir for c in
                                  durable.read_manifest(workdir).cold}


def test_demotion_paths_and_refusals(tmp_path):
    m = _demoted(lambda d: MutableIndex(series_length=LENGTH, workdir=d,
                                        device="cpu"),
                 str(tmp_path / "store"))
    _assert_oracle(m, 330)
    oracle = build_index(RAW[:330], device="cpu")
    r = m.exact_search_batch(QUERIES, SearchConfig(round_size=ROUND))
    want = exact_search_batch(oracle, QUERIES, SearchConfig(round_size=ROUND))
    assert torch.equal(r.dist_sq, want.dist_sq)
    assert torch.equal(r.position, want.position)
    d, _, ach = m.knn_batch_tiered(QUERIES, Tier.epsilon(0.1), k=3,
                                   round_size=ROUND)
    exact_d, _ = exact_knn_batch(oracle, QUERIES, k=3, round_size=ROUND)
    assert np.all(ach <= 0.1 + 1e-6)
    assert torch.all(d.sqrt() <= 1.1 * exact_d.sqrt() * (1 + 1e-5))
    with pytest.raises(ValueError, match="fused"):
        m.exact_knn_batch(QUERIES, k=2, fused=True)
    st = m.stats()
    assert st["demotions"] == 1 and st["cold_series"] == 260
    # a second demotion stacks a second epoch, and that recovers too
    m.compact(tier="minor")
    assert m.demote() is not None
    r2 = MutableIndex.recover(m.workdir, device="cpu")
    assert [c.base for c in r2.snapshot().cold] == [0, 260]
    _assert_oracle(r2, 330)
    mem = MutableIndex(series_length=LENGTH, device="cpu")
    mem.append(RAW[:50])
    with pytest.raises(ValueError, match="durable"):
        mem.demote()
    with pytest.raises(ValueError, match="major"):
        m.compact(tier="minor", demote=True)


def _run_killable_demoting(workdir, crash_at):
    hook = fail_at(crash_at)
    acked, boundaries = 0, {0}
    try:
        m = MutableIndex(series_length=LENGTH, workdir=workdir, fault=hook,
                         device="cpu")
        for sz in (60, 50):
            boundaries.add(acked + sz)
            m.append(RAW[acked: acked + sz])
            acked += sz
        m.compact(tier="minor")
        m.demote()
        boundaries.add(acked + 40)
        m.append(RAW[acked: acked + 40])
        acked += 40
        m.compact(tier="minor")
        m.demote()
    except FaultError:
        pass
    return acked, boundaries


@pytest.mark.parametrize("crash_at", range(0, 64, 7))
def test_kill_and_recover_across_demotions(tmp_path, crash_at):
    workdir = str(tmp_path / "store")
    acked, boundaries = _run_killable_demoting(workdir, crash_at)
    man = durable.read_manifest(workdir)
    if man is None:
        assert acked == 0
        return
    r = MutableIndex.recover(workdir, device="cpu")
    n = r.num_series
    assert n >= acked and n in boundaries, (n, acked)
    if n:
        _assert_oracle(r, n)
    man = durable.read_manifest(workdir)
    assert set(coldtier.read_catalog(workdir)["epochs"]) == {
        c.dir for c in man.cold}
    live = {c.dir for c in man.runs + man.deltas + man.cold}
    if man.base:
        live.add(man.base.dir)
    assert {d for d in os.listdir(workdir) if d.startswith("e")} == live
    r.append(RAW[n: n + 10])
    assert MutableIndex.recover(workdir, device="cpu").num_series == n + 10


def test_gc_honors_catalog_and_format1_reads(tmp_path):
    workdir = str(tmp_path / "store")
    m = MutableIndex(series_length=LENGTH, workdir=workdir, device="cpu")
    m.append(RAW[:80])
    m.compact(tier="minor")
    m.demote()
    cold_dir = m.snapshot().cold[0].dir
    man = durable.read_manifest(workdir)
    durable.write_manifest(workdir, dataclasses.replace(
        man, version=man.version + 1, cold=()))
    man2 = durable.read_manifest(workdir)
    durable.gc_orphans(workdir, man2)
    assert os.path.isdir(os.path.join(workdir, cold_dir))  # protected
    assert coldtier.reconcile_catalog(workdir, man2, ())[0] == [cold_dir]
    durable.gc_orphans(workdir, man2)
    assert not os.path.exists(os.path.join(workdir, cold_dir))

    w1 = str(tmp_path / "v1")
    m1 = MutableIndex(series_length=LENGTH, workdir=w1, device="cpu")
    m1.append(RAW[:90])
    m1.compact(tier="minor")
    path = os.path.join(w1, durable.MANIFEST)
    with open(path) as f:
        doc = json.load(f)
    doc["format"] = 1
    doc.pop("cold")
    with open(path, "w") as f:
        json.dump(doc, f)
    r = MutableIndex.recover(w1, device="cpu")
    assert r.num_series == 90 and not r.snapshot().cold
    _assert_oracle(r, 90)
