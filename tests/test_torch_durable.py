"""Port parity, durability: a store spilled by one package is recovered by
the other.

The bridge between the packages is the on-disk store itself
(``MANIFEST.json`` format 2 and the ``e{N}`` component dirs). The same op
sequence runs through a reference and a port ``MutableIndex`` with their
own workdirs: every file of the two workdirs is byte-identical where the
reference sums like the port (``reference_sums_like_port``); elsewhere the
manifests and every component's ``keys``, ``sax`` and ``pos`` are. Each
package then recovers the other's store and must answer as the writer
did: positions exact, distances bitwise there, else within 1e-6.

The port's own crash protocol is swept at a bounded set of kill points:
the recovered store holds an op-boundary prefix containing every
acknowledged append, answers as the one-shot build over it, and leaves no
unreferenced ``e{N}`` dir.
"""

import functools
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MutableIndex as JMutable
from repro.core import build_index as j_build_index
from repro.core import durable as jdurable
from repro_torch.core import durable
from repro_torch.core.durable import FaultError, fail_at
from repro_torch.core.index import build_index
from repro_torch.core.ingest import CompactionPolicy, MutableIndex
from repro_torch.core.search import exact_knn_batch
from test_torch_search import assert_float_parity, reference_sums_like_port

RNG = np.random.default_rng(99)
LENGTH = 64
ROUND = 128
RAW = RNG.standard_normal((360, LENGTH)).cumsum(axis=1).astype(np.float32)
QUERIES = RNG.standard_normal((4, LENGTH)).cumsum(axis=1).astype(np.float32)


def _files(workdir) -> dict:
    out = {}
    for root, _, names in os.walk(workdir):
        for name in names:
            path = os.path.join(root, name)
            out[os.path.relpath(path, workdir)] = path
    return out


def _grow(m, append_sizes=(40, 30), o=150):
    """base 150, two appends, a minor fold, one more append: 3 tiers."""
    for sz in append_sizes:
        m.append(RAW[o: o + sz])
        o += sz
    m.compact(tier="minor")
    m.append(RAW[o: o + 25])
    return o + 25


def _answers(m, fused):
    d, p = m.exact_knn_batch(QUERIES, k=4, fused=fused, round_size=ROUND)
    return np.array(d), np.array(p)


@functools.lru_cache(maxsize=None)
def stores(root: str) -> tuple:
    """(reference workdir, port workdir, series) after the same ops."""
    wj, wt = os.path.join(root, "ref"), os.path.join(root, "port")
    j = JMutable(j_build_index(jnp.asarray(RAW[:150])), workdir=wj,
                 pack_block=128)
    t = MutableIndex(build_index(RAW[:150], device="cpu"), workdir=wt,
                     pack_block=128, device="cpu")
    n = _grow(j)
    assert _grow(t) == n
    return wj, wt, n


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("stores"))


def test_workdirs_byte_identical(store_root):
    wj, wt, n = stores(store_root)
    fj, ft = _files(wj), _files(wt)
    assert sorted(fj) == sorted(ft)
    assert durable.read_manifest(wt) == durable.read_manifest(wj)
    mj = jdurable.read_manifest(wj)
    assert (mj.num_series, len(mj.runs), len(mj.deltas)) == (n, 1, 1)
    for rel in sorted(fj):
        name = os.path.basename(rel)
        if name in ("keys.npy", "sax.npy", "pos.npy"):
            a, b = np.load(fj[rel]), np.load(ft[rel])
            assert a.dtype == b.dtype, rel
            np.testing.assert_array_equal(b, a)
        if name in ("keys.npy", "sax.npy", "pos.npy", "meta.json",
                    "MANIFEST.json") or reference_sums_like_port():
            with open(fj[rel], "rb") as fa, open(ft[rel], "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_recovered_across_packages(store_root, direction, fused):
    wj, wt, n = stores(store_root)
    if direction == "ref_to_port":
        writer_dir = wj
        want = _answers(JMutable.recover(wj, pack_block=128), fused)
        got_store = MutableIndex.recover(wj, pack_block=128, device="cpu")
        got = _answers(got_store, fused)
    else:
        writer_dir = wt
        want = _answers(MutableIndex.recover(wt, pack_block=128,
                                             device="cpu"), fused)
        got = _answers(JMutable.recover(wt, pack_block=128), fused)
    np.testing.assert_array_equal(got[1], want[1])
    assert_float_parity(got[0], want[0])
    if direction == "ref_to_port":
        assert got_store.num_series == n
        assert (got_store.num_runs, got_store.num_deltas) == (1, 1)
        # components reload the reference's arrays byte for byte
        snap = got_store.snapshot()
        base = durable.load_component(
            writer_dir, durable.read_manifest(writer_dir).base)
        np.testing.assert_array_equal(snap.base.sax.numpy(), base[1])
        np.testing.assert_array_equal(snap.base.raw.numpy(), base[3])
    # both equal the one-shot build over every acknowledged series
    oracle = build_index(RAW[:n], device="cpu")
    d, p = exact_knn_batch(oracle, QUERIES, k=4, round_size=ROUND)
    np.testing.assert_array_equal(got[1], p.numpy())


def _assert_prefix(m, n, k=4):
    oracle = build_index(RAW[:n], device="cpu")
    want_d, want_p = exact_knn_batch(oracle, QUERIES, k=k, round_size=ROUND)
    got_d, got_p = m.exact_knn_batch(QUERIES, k=k, round_size=ROUND)
    np.testing.assert_array_equal(got_p.numpy(), want_p.numpy())
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())


def _run_killable(workdir, crash_at):
    """One fixed op sequence under a fault hook; returns acked boundaries."""
    hook = fail_at(crash_at)
    acked, boundaries = 0, {0}
    try:
        m = MutableIndex(build_index(RAW[:120], device="cpu"),
                         workdir=workdir, fault=hook, device="cpu")
        acked = 120
        boundaries.add(120)
        for sz in (40, 30, 35):
            boundaries.add(acked + sz)
            m.append(RAW[acked: acked + sz])
            acked += sz
        m.compact(tier="minor")
        boundaries.add(acked + 25)
        m.append(RAW[acked: acked + 25])
        acked += 25
        m.compact(tier="full")
    except FaultError:
        pass
    return acked, boundaries


@pytest.mark.parametrize("crash_at", range(0, 56, 5))
def test_kill_and_recover_at_fixed_points(tmp_path, crash_at):
    """The spill->commit->publish->GC protocol survives a kill anywhere."""
    workdir = str(tmp_path / "store")
    acked, boundaries = _run_killable(workdir, crash_at)
    man = durable.read_manifest(workdir)
    if man is None:
        assert acked == 0  # crashed before anything was acknowledged
        return
    r = MutableIndex.recover(workdir, device="cpu")
    n = r.num_series
    assert n >= acked and n in boundaries, (n, acked)
    _assert_prefix(r, n)
    man = durable.read_manifest(workdir)
    live = {c.dir for c in man.runs + man.deltas}
    if man.base:
        live.add(man.base.dir)
    assert {d for d in os.listdir(workdir) if d.startswith("e")} == live
    r.append(RAW[n: n + 10])  # the recovered store resumes durably
    assert MutableIndex.recover(workdir, device="cpu").num_series == n + 10


def test_recover_sweeps_orphans_and_refuses_misuse(tmp_path):
    workdir = str(tmp_path / "store")
    with pytest.raises(ValueError, match="no durable store"):
        MutableIndex.recover(str(tmp_path), device="cpu")
    m = MutableIndex(series_length=LENGTH, workdir=workdir, device="cpu")
    with pytest.raises(ValueError, match="recover"):
        MutableIndex(series_length=LENGTH, workdir=workdir, device="cpu")
    assert durable.read_manifest(workdir).version == 0
    m.append(RAW[:30])
    m.append(RAW[30:50])
    assert durable.read_manifest(workdir).version == m.snapshot().version
    os.makedirs(os.path.join(workdir, "e77"))
    np.save(os.path.join(workdir, "e77", "keys.npy"), np.zeros(3))
    open(os.path.join(workdir, durable.MANIFEST_TMP), "w").close()
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            MutableIndex.recover(workdir)
    r = MutableIndex.recover(workdir, device="cpu")
    assert not os.path.exists(os.path.join(workdir, "e77"))
    assert not os.path.exists(os.path.join(workdir, durable.MANIFEST_TMP))
    _assert_prefix(r, 50)


def test_spill_gap_is_never_acknowledged(tmp_path):
    """A later appender's complete spill behind a failed earlier one is
    never acknowledged; both dirs are swept at recovery."""
    workdir = str(tmp_path / "store")
    a_started, b_spilled = threading.Event(), threading.Event()
    boom = FaultError("injected crash in A's spill")

    def hook(point):
        if point.startswith("spill:e0:"):
            a_started.set()
            if point == "spill:e0:raw.npy":
                assert b_spilled.wait(timeout=30)
                raise boom
        if point == "spill:e1:done":
            b_spilled.set()

    m = MutableIndex(series_length=LENGTH, workdir=workdir, fault=hook,
                     device="cpu")
    errors = {}

    def appender(name, lo, hi):
        try:
            m.append(RAW[lo:hi])
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors[name] = e

    ta = threading.Thread(target=appender, args=("a", 0, 30))
    ta.start()
    assert a_started.wait(timeout=30)
    tb = threading.Thread(target=appender, args=("b", 30, 50))
    tb.start()
    ta.join(timeout=60)
    tb.join(timeout=60)
    assert not ta.is_alive() and not tb.is_alive()
    assert errors.get("a") is boom
    assert "aborted" in str(errors.get("b"))
    assert durable.read_manifest(workdir).num_series == 0
    r = MutableIndex.recover(workdir, device="cpu")
    assert r.num_series == 0
    assert not [d for d in os.listdir(workdir) if d.startswith("e")]
    r.append(RAW[:10])
    _assert_prefix(MutableIndex.recover(workdir, device="cpu"), 10, k=2)


def test_group_commit_and_leveled_policy(tmp_path):
    """Concurrent durable appends commit in offset order; the leveled
    policy folds durably; the reference recovers the result."""
    workdir = str(tmp_path / "store")
    m = MutableIndex(build_index(RAW[:100], device="cpu"), workdir=workdir,
                     device="cpu")
    sizes = (40, 30, 35, 25)
    offs = np.cumsum((100,) + sizes)
    threads = [threading.Thread(target=m.append, args=(RAW[o - sz: o],))
               for sz, o in zip(sizes, offs[1:])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    st = m.stats()
    assert m.num_series == int(offs[-1]) and st["appends"] == len(sizes)
    assert st["spill_queue_depth"] == 0
    assert 1 <= st["group_commits"] <= len(sizes)
    bases = sorted(d.base for d in m.snapshot().deltas)
    assert bases[0] == 100 and len(bases) == len(sizes)
    pol = CompactionPolicy(max_deltas=2, major_ratio=0.5)
    tiers = [r.tier for r in iter(lambda: m.maybe_compact(pol), None)]
    assert tiers and tiers[-1] == "major" and m.num_runs == 0
    # The file order the threads chose is the store's: the reference
    # recovers it to the same positions.
    j = JMutable.recover(workdir)
    assert j.num_series == m.num_series
    got_p = m.exact_knn_batch(QUERIES, k=4, round_size=ROUND)[1].numpy()
    want_p = np.asarray(j.exact_knn_batch(QUERIES, k=4, round_size=ROUND)[1])
    np.testing.assert_array_equal(got_p, want_p)
    assert torch.equal(m.snapshot().base.raw,
                       MutableIndex.recover(workdir, device="cpu")
                       .snapshot().base.raw)
