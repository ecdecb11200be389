"""Port parity, live ingest: repro_torch.core.ingest against repro.core.ingest.

One fixed sequence of appends and folds runs through a reference
``MutableIndex`` and through the port's (both in memory, ``pack_block``
128): after the appends, after a minor fold, across an append racing a
fold's publish, after a major fold and after a full fold, the fused and the
per-component paths must answer as the reference's do — positions exact,
distances bitwise where the reference sums like the port
(``reference_sums_like_port``), else within 1e-6. The reference runs the
sequence once per worker (its engines compile per component).

The rest holds the port to its own one-shot ``build_index``: torch tensors
are not immutable, so a snapshot taken before a fold must keep its answers
(and its packed tensors' bytes) after the fold and later appends; the
incremental packer must equal a from-scratch pack after every swap.
"""

import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MutableIndex as JMutable
from repro.core import build_index as j_build_index
from repro.core.ingest import CompactionPolicy as JPolicy
from repro_torch.core import isax as tx
from repro_torch.core import ingest as ti
from repro_torch.core.index import build_index
from repro_torch.core.search import (SearchConfig, Tier, exact_knn_batch,
                                     exact_knn_batch_packed, pack_components)
from test_torch_search import assert_float_parity

RNG = np.random.default_rng(77)
LENGTH = 64
ROUND = 128
N_BASE = 220
# Ragged sizes (no multiple of the 128-row block), few distinct shapes:
# the reference compiles its summarization once per batch shape.
APPENDS = (61, 40, 61, 40, 61, 40)
RAW = RNG.standard_normal(
    (N_BASE + sum(APPENDS), LENGTH)).cumsum(axis=1).astype(np.float32)
QUERIES = RNG.standard_normal((4, LENGTH)).cumsum(axis=1).astype(np.float32)
CHECKPOINTS = ("appends", "minor", "raced", "major", "full")


def _knn(m, fused, k=4):
    d, p = m.exact_knn_batch(QUERIES, k=k, fused=fused, round_size=ROUND)
    return np.array(d), np.array(p)


def _sequence(make, append):
    """Run the fixed op sequence; yields (checkpoint, store) as it goes."""
    m = make(RAW[:N_BASE])
    o = N_BASE
    for a in APPENDS[:3]:
        append(m, RAW[o: o + a])
        o += a
    yield "appends", m
    m.compact("minor")
    yield "minor", m
    n = o

    def race():
        append(m, RAW[n: n + APPENDS[3]])

    m.compact("major", on_before_publish=race)
    yield "raced", m
    o += APPENDS[3]
    append(m, RAW[o: o + APPENDS[4]])
    o += APPENDS[4]
    m.compact("minor")
    m.compact("major")
    yield "major", m
    append(m, RAW[o: o + APPENDS[5]])
    m.compact("full")
    yield "full", m


# Where the reference's per-component path is compared too: the
# checkpoints with several components (it compiles an engine for each).
PER_COMPONENT = ("appends", "raced")


@functools.lru_cache(maxsize=None)
def reference_answers() -> dict:
    """checkpoint -> {fused: (d, p)} from the reference store."""
    out = {}
    for name, m in _sequence(
            lambda raw: JMutable(j_build_index(jnp.asarray(raw)),
                                 pack_block=128),
            lambda m, batch: m.append(batch)):
        paths = (True, False) if name in PER_COMPONENT else (True,)
        out[name] = {fused: _knn(m, fused) for fused in paths}
        out[name]["n"] = m.num_series
    return out


@functools.lru_cache(maxsize=None)
def port_answers() -> dict:
    out = {}
    for name, m in _sequence(
            lambda raw: ti.MutableIndex(build_index(raw, device="cpu"),
                                        pack_block=128, device="cpu"),
            lambda m, batch: m.append(batch)):
        out[name] = {fused: _knn(m, fused) for fused in (True, False)}
        out[name]["n"] = m.num_series
        out[name]["shape"] = (m.num_runs, m.num_deltas,
                              m.snapshot().base.num_series)
    return out


@pytest.mark.parametrize("checkpoint", CHECKPOINTS)
def test_live_store_matches_reference(checkpoint):
    want, got = reference_answers()[checkpoint], port_answers()[checkpoint]
    assert got["n"] == want["n"]
    for fused in (True, False) if checkpoint in PER_COMPONENT else (True,):
        np.testing.assert_array_equal(got[fused][1], want[fused][1])
        assert_float_parity(got[fused][0], want[fused][0])
    # ... and both are the one-shot build over the acknowledged data.
    oracle = build_index(RAW[:got["n"]], device="cpu")
    d, p = exact_knn_batch(oracle, QUERIES, k=4, round_size=ROUND)
    for fused in (True, False):
        np.testing.assert_array_equal(got[fused][1], p.numpy())
        np.testing.assert_array_equal(got[fused][0], d.numpy())


def test_sequence_shapes():
    shapes = {name: a["shape"] for name, a in port_answers().items()}
    assert shapes["appends"] == (0, 3, N_BASE)
    assert shapes["minor"] == (1, 0, N_BASE)
    assert shapes["raced"] == (0, 1, N_BASE + sum(APPENDS[:3]))
    assert shapes["major"] == (0, 0, len(RAW) - APPENDS[5])
    assert shapes["full"] == (0, 0, len(RAW))


def _grown(upto=3, **kw):
    m = ti.MutableIndex(build_index(RAW[:N_BASE], device="cpu"),
                        device="cpu", **kw)
    o = N_BASE
    for a in APPENDS[:upto]:
        m.append(RAW[o: o + a])
        o += a
    return m, o


def _assert_oracle(m, n, k=4, **kw):
    oracle = build_index(RAW[:n], device="cpu")
    want_d, want_p = exact_knn_batch(oracle, QUERIES, k=k, round_size=ROUND)
    got_d, got_p = m.exact_knn_batch(QUERIES, k=k, round_size=ROUND, **kw)
    np.testing.assert_array_equal(got_p.numpy(), want_p.numpy())
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())


def test_mid_compaction_snapshot_is_exact():
    """Queries and appends in the merge->publish window stay exact."""
    m, n = _grown(2)
    seen = {}

    def hook():
        _assert_oracle(m, n)
        m.append(RAW[n: n + APPENDS[2]])
        seen["deltas"] = m.num_deltas

    assert m.compact(on_before_publish=hook) is not None
    assert m.num_deltas == 1 and seen["deltas"] == 3
    _assert_oracle(m, n + APPENDS[2])


def _packed_bytes(packed):
    return {name: getattr(packed, name).clone()
            for name in ("sax", "gpos", "block_len")} | {
        "raw": packed.raw[: packed.num_series].clone()}


@pytest.mark.parametrize("tier", ["minor", "major", "full"])
def test_old_snapshot_keeps_its_answers_across_a_fold(tier):
    """A snapshot's packed view is never written by a later fold or append.

    The fold rewrites the packed tail the old view covers, and the appends
    after it grow the raw buffer in place (within its capacity): the old
    view's tensors must keep their bytes and its answers.
    """
    m, n = _grown(3, pack_block=32)
    old = m.snapshot()
    old_packed = m._packed_view(old)
    before = _packed_bytes(old_packed)
    want = exact_knn_batch_packed(old_packed, QUERIES, k=4, round_size=ROUND)

    m.compact(tier)
    o = n
    for a in (30, 60):  # within the raw capacity, then past it
        m.append(RAW[o: o + a])
        o += a
        _assert_oracle(m, o, fused=True)  # packs every new snapshot
        if a == 30:
            new_packed = m._packed_view(m.snapshot())
            assert new_packed.raw.data_ptr() == old_packed.raw.data_ptr(), (
                "an append within capacity grows the raw buffer in place")

    for name, t in _packed_bytes(old_packed).items():
        assert torch.equal(t, before[name]), name
    got = exact_knn_batch_packed(old_packed, QUERIES, k=4, round_size=ROUND)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert old.num_series == n


def test_incremental_pack_matches_scratch_after_random_sequences():
    rng = np.random.default_rng(20260810)
    m = ti.MutableIndex(build_index(RAW[:60], device="cpu"), pack_block=32,
                        device="cpu")
    n = 60

    def check():
        snap = m.snapshot()
        inc = m._packed_view(snap)
        want = pack_components(snap.components(), block=32)
        bl = inc.block_len.numpy()
        used = int(np.count_nonzero(bl))
        assert np.all(bl[used:] == 0)
        np.testing.assert_array_equal(bl[:used], want.block_len.numpy())
        rows = used * inc.block
        np.testing.assert_array_equal(inc.sax[:rows].numpy(),
                                      want.sax.numpy())
        np.testing.assert_array_equal(inc.gpos[:rows].numpy(),
                                      want.gpos.numpy())
        np.testing.assert_array_equal(inc.raw[:inc.num_series].numpy(),
                                      want.raw.numpy())

    check()
    for _ in range(14):
        op = rng.choice(["append", "append", "append", "minor", "major",
                         "full"])
        if op == "append" and n < len(RAW):
            size = min(int(rng.integers(1, 40)), len(RAW) - n)
            m.append(RAW[n: n + size])
            n += size
        else:
            m.compact(tier=op if op != "append" else "full")
        check()
    _assert_oracle(m, n, fused=True)


def test_policy_plans_like_reference():
    """The same append/maybe_compact sequence folds the same tiers."""
    pols = (dict(max_deltas=2, major_ratio=0.5),
            dict(max_deltas=3, max_delta_series=70, major_ratio=0.25),
            dict(max_deltas=2, leveled=False))
    for kw in pols:
        tiers = {}
        for name, make, policy in (
                ("port", lambda raw: ti.MutableIndex(
                    build_index(raw, device="cpu"), device="cpu"),
                 ti.CompactionPolicy(**kw)),
                ("ref", lambda raw: JMutable(j_build_index(jnp.asarray(raw))),
                 JPolicy(**kw))):
            m = make(RAW[:N_BASE])
            o, seen = N_BASE, []
            for a in APPENDS:
                m.append(RAW[o: o + a])
                o += a
                res = m.maybe_compact(policy)
                seen.append(None if res is None else res.tier)
            tiers[name] = (seen, m.num_runs, m.num_deltas)
        assert tiers["port"] == tiers["ref"], kw
    with pytest.raises(ValueError, match="major_ratio"):
        ti.CompactionPolicy(major_ratio=0)


def test_other_search_paths_match_oracle():
    m, n = _grown(3)
    oracle = build_index(RAW[:n], device="cpu")
    for fused in (True, False):
        r = m.exact_search_batch(QUERIES, SearchConfig(round_size=ROUND),
                                 fused=fused)
        d, p = exact_knn_batch(oracle, QUERIES, k=1, round_size=ROUND)
        np.testing.assert_array_equal(r.position.numpy(), p[:, 0].numpy())
        np.testing.assert_array_equal(r.dist_sq.numpy(), d[:, 0].numpy())
        d_eps, p_eps, ach = m.knn_batch_tiered(
            QUERIES, Tier.epsilon(0.1), k=4, fused=fused, round_size=ROUND)
        exact_d, _ = exact_knn_batch(oracle, QUERIES, k=4, round_size=ROUND)
        assert np.all(ach <= 0.1 + 1e-6)
        assert torch.all(d_eps.sqrt() <= 1.1 * exact_d.sqrt() * (1 + 1e-6))
        qz = tx.znorm(torch.from_numpy(QUERIES))
        direct = ((oracle.raw[p_eps.long()] - qz[:, None]) ** 2).sum(-1)
        torch.testing.assert_close(direct, d_eps, rtol=1e-5, atol=1e-5)
    # k past the live series: sentinel slots, on both paths.
    small = ti.MutableIndex(build_index(RAW[:3], device="cpu"), device="cpu")
    small.append(RAW[3:5])
    for fused in (True, False):
        d, p = small.exact_knn_batch(QUERIES, k=8, fused=fused)
        assert (p[:, 5:] == -1).all() and torch.isinf(d[:, 5:]).all()


def test_empty_start_and_bad_batches():
    m = ti.MutableIndex(series_length=LENGTH, device="cpu")
    d, p = m.exact_knn_batch(QUERIES, k=3)
    assert torch.isinf(d).all() and (p == -1).all()
    for bad in (np.zeros((0, LENGTH), np.float32), np.zeros(LENGTH)):
        with pytest.raises(ValueError, match="non-empty"):
            m.append(bad)
    with pytest.raises(ValueError, match="series_length"):
        ti.MutableIndex(device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            ti.MutableIndex(series_length=LENGTH)
        with pytest.raises(RuntimeError, match="cuda"):
            ti.build_delta_shard(RAW[:10], 0)
    # A CPU base for a store on the card: "base index on cpu" with a card,
    # "no card" without one; never a silent move.
    with pytest.raises((ValueError, RuntimeError), match="cpu"):
        ti.MutableIndex(build_index(RAW[:10], device="cpu"))
    pipe = ti.IngestPipeline(m, chunk_series=50)
    shards = pipe.append(RAW[:120])
    assert [s.num_series for s in shards] == [50, 50, 20]
    assert pipe.stats.series == 120 and pipe.stats.series_per_sec > 0
    _assert_oracle(m, 120)


def test_concurrent_appends_and_queries():
    """Appenders and readers in threads: every answer is some prefix's."""
    import sys

    m = ti.MutableIndex(build_index(RAW[:N_BASE], device="cpu"),
                        device="cpu")
    sizes = APPENDS
    bounds = np.cumsum((N_BASE,) + sizes)
    errors = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def appender(lo, hi):
            try:
                m.append(RAW[lo:hi])
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        def reader():
            try:
                for _ in range(3):
                    m.exact_knn_batch(QUERIES, k=2, round_size=ROUND)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=appender, args=(a, b))
                   for a, b in zip(bounds[:-1], bounds[1:])]
        threads += [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    assert not errors, errors
    assert m.num_series == len(RAW) and m.stats()["appends"] == len(sizes)
    # Offsets follow append order, which the threads chose: rebuild the
    # file order the store saw and hold it to the one-shot build.
    order = sorted(m.snapshot().deltas, key=lambda s: s.base)
    assert [s.base for s in order] == list(
        np.cumsum([N_BASE] + [s.num_series for s in order])[:-1])
