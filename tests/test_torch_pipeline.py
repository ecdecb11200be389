"""Port parity, the pipelined build: repro_torch.core.build_pipeline against
repro.core.build_pipeline.

Both packages build the same random walks (N = 3000, n = 64, chunks of
512) in every mode, with one epoch and with a memory limit below a chunk
(every chunk closes an epoch). The port's index must be byte-identical to
its own ``build_index``; against the reference, the index, the epoch
shards' ``keys``/``sax``/``pos`` arrays and the shard files themselves are
identical wherever the reference sums like the port
(``reference_sums_like_port``), and the z-normed raw agrees bit for bit
there and to rounding elsewhere. The packed refine key fills all 64 bits:
keys with bit 63 set must sort, search and merge as the reference's uint64
keys do.
"""

import os

import numpy as np
import pytest
import torch

from repro.core import build_pipeline as jbp
from repro.core import datagen as jdatagen
from repro_torch.core import build_pipeline as tbp
from repro_torch.core import datagen as tdatagen
from repro_torch.core.index import build_index, validate_index
from test_torch_search import assert_float_parity, reference_sums_like_port

N, LENGTH, CHUNK = 3000, 64, 512
RAW = np.random.default_rng(21).standard_normal(
    (N, LENGTH)).cumsum(axis=1).astype(np.float32)


def _index_arrays(index):
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in (index.sax, index.pos, index.bucket_offsets)]


def _shard_files(workdir):
    return sorted(d for d in os.listdir(workdir) if d.startswith("e"))


@pytest.mark.parametrize("mem_limit", [None, CHUNK // 2])
@pytest.mark.parametrize("mode", ["paris+", "paris", "serial"])
def test_pipeline_byte_identical(tmp_path, mode, mem_limit):
    src_t = tdatagen.SeriesSource.from_array(RAW, chunk_series=CHUNK)
    src_j = jdatagen.SeriesSource.from_array(RAW, chunk_series=CHUNK)
    wt, wj = tmp_path / "port", tmp_path / "ref"
    t_index, t_stats = tbp.PipelineBuilder(
        mode=mode, n_workers=3, mem_limit_series=mem_limit,
        workdir=str(wt), device="cpu").build(src_t)
    j_index, j_stats = jbp.PipelineBuilder(
        mode=mode, n_workers=3, mem_limit_series=mem_limit,
        workdir=str(wj)).build(src_j)

    # Against the port's one-shot build: every array, bit for bit.
    want = build_index(RAW, device="cpu")
    for got, exp in zip(_index_arrays(t_index), _index_arrays(want)):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(t_index.raw.numpy(), want.raw.numpy())
    assert all(validate_index(t_index).values())
    epochs = src_t.num_chunks if mem_limit else 1
    assert t_stats.epochs == j_stats.epochs == epochs
    assert t_stats.chunks == j_stats.chunks == src_t.num_chunks
    assert t_stats.total_time > 0 and 0 <= t_stats.overlap_efficiency <= 1

    # Against the reference: the index and every epoch shard.
    assert_float_parity(t_index.raw.numpy(), j_index.raw)
    assert _shard_files(wt) == _shard_files(wj) == [
        f"e{i}" for i in range(epochs)]
    if not reference_sums_like_port():
        return
    for got, exp in zip(_index_arrays(t_index), _index_arrays(j_index)):
        np.testing.assert_array_equal(got, exp)
    for d in _shard_files(wt):
        for name, dtype in (("keys.npy", np.uint64), ("sax.npy", np.uint8),
                            ("pos.npy", np.int32)):
            got, exp = np.load(wt / d / name), np.load(wj / d / name)
            assert got.dtype == exp.dtype == dtype, (d, name)
            np.testing.assert_array_equal(got, exp)
            assert (wt / d / name).read_bytes() == (wj / d / name).read_bytes()


def _sax_across_bit63(w, card, seed):
    """SAX rows whose packed keys lie on both sides of bit 63, with ties."""
    rng = np.random.default_rng(seed)
    sax = rng.integers(0, card, size=(4000, w)).astype(np.uint8)
    sax[::2, 0] |= card // 2  # root bit of segment 0 set: bit 63 at w=16
    sax[1::2, 0] &= card // 2 - 1  # ... and clear
    sax[::5] = sax[1::5][: len(sax[::5])]  # exact duplicates: key ties
    return sax


@pytest.mark.parametrize("w,card,bits", [(16, 256, 4), (16, 256, 3),
                                         (8, 64, 6), (32, 256, 2)])
def test_refine_keys_across_bit63(w, card, bits):
    sax = _sax_across_bit63(w, card, seed=w + bits)
    want = jbp._host_refine_key(sax, bits, card)
    keys = tbp.refine_key(torch.from_numpy(sax), bits, card)
    np.testing.assert_array_equal(tbp.keys_to_u64(keys), want)
    np.testing.assert_array_equal(
        tbp.keys_from_u64(want, "cpu").numpy(), keys.numpy())
    if w * bits == 64:
        assert (want >= np.uint64(1 << 63)).mean() == pytest.approx(0.5)
    # Sort: the stable order of the sortable int64 keys is numpy's uint64.
    _, order = torch.sort(keys, stable=True)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(want, kind="stable"))
    # Search: both sides of the merge's searchsorted agree with numpy's.
    sk, su = torch.sort(keys).values, np.sort(want)
    probe = tbp.keys_from_u64(want[:500], "cpu")
    for side in ("left", "right"):
        np.testing.assert_array_equal(
            torch.searchsorted(sk, probe, side=side).numpy(),
            np.searchsorted(su, want[:500], side=side))


@pytest.mark.parametrize("n_runs", [1, 2, 5])
def test_merge_runs_like_reference(n_runs):
    """File-offset-ordered runs merge to the reference's bytes, ties to the
    lower position — a stable sort of the concatenated input."""
    sax = _sax_across_bit63(16, 256, seed=n_runs)
    bounds = np.linspace(0, len(sax), n_runs + 1).astype(int)
    runs_j, runs_t = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        k = jbp._host_refine_key(sax[a:b], 4, 256)
        order = np.argsort(k, kind="stable")
        pos = np.arange(a, b, dtype=np.int32)[order]
        runs_j.append((k[order], [sax[a:b][order], pos]))
        runs_t.append((tbp.keys_from_u64(k[order], "cpu"),
                       [torch.from_numpy(sax[a:b][order]),
                        torch.from_numpy(pos)]))
    kj, (sj, pj) = jbp.merge_runs(runs_j)
    kt, (st, pt) = tbp.merge_runs(runs_t)
    np.testing.assert_array_equal(tbp.keys_to_u64(kt), kj)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(pt.numpy(), pj)
    full = jbp._host_refine_key(sax, 4, 256)
    np.testing.assert_array_equal(pt.numpy(),
                                  np.argsort(full, kind="stable"))


@pytest.mark.parametrize("presort", [True, False])
def test_bulk_load_chunk_like_reference(presort):
    chunk = RAW[:700]
    kj, sj, pj = jbp.bulk_load_chunk(chunk, 1000, segments=16,
                                     cardinality=256, presort=presort)
    kt, st, pt = tbp.bulk_load_chunk(chunk, 1000, segments=16,
                                     cardinality=256, presort=presort,
                                     device="cpu")
    assert kt.dtype == torch.int64 and st.dtype == torch.uint8
    assert pt.dtype == torch.int32
    if reference_sums_like_port():
        np.testing.assert_array_equal(tbp.keys_to_u64(kt), kj)
        np.testing.assert_array_equal(st.numpy(), sj)
        np.testing.assert_array_equal(pt.numpy(), pj)
    assert sorted(pt.tolist()) == list(range(1000, 1700))


@pytest.mark.parametrize("mode", ["paris+", "paris", "serial"])
def test_empty_source_returns_empty_index(mode):
    src = tdatagen.SeriesSource.from_array(np.zeros((0, LENGTH), np.float32))
    index, stats = tbp.PipelineBuilder(mode=mode, device="cpu").build(src)
    assert index.num_series == 0 and index.series_length == LENGTH
    assert stats.epochs == 0 and stats.chunks == 0
    assert all(validate_index(index).values())


class _FailingSource(tdatagen.SeriesSource):
    """Raises on a chunk read past ``fail_at`` (a mid-build I/O failure)."""

    fail_at = 3

    def read(self, i):
        if i >= self.fail_at:
            raise IOError("disk died")
        return super().read(i)


def test_failed_build_cleans_partial_epoch_dirs(tmp_path):
    workdir = tmp_path / "build"
    workdir.mkdir()
    (workdir / "keep.txt").write_text("caller-owned")
    builder = tbp.PipelineBuilder(
        mode="paris+", n_workers=2, mem_limit_series=CHUNK // 2,
        workdir=str(workdir), device="cpu")
    with pytest.raises(IOError):
        builder.build(_FailingSource(RAW, chunk_series=CHUNK))
    assert not _shard_files(workdir)  # epochs were flushed, then removed
    assert (workdir / "keep.txt").exists()


def test_successful_build_keeps_caller_workdir_epochs(tmp_path):
    workdir = tmp_path / "build"
    src = tdatagen.SeriesSource.from_array(RAW, chunk_series=CHUNK)
    index, stats = tbp.PipelineBuilder(
        mode="paris+", mem_limit_series=CHUNK, workdir=str(workdir),
        device="cpu").build(src)
    assert index.num_series == N
    assert len(_shard_files(workdir)) == stats.epochs > 1


def test_source_from_file_matches_reference(tmp_path):
    pt, pj = tmp_path / "port.bin", tmp_path / "ref.bin"
    tdatagen.write_dataset(str(pt), 1000, 64, seed=3, chunk=300)
    jdatagen.write_dataset(str(pj), 1000, 64, seed=3, chunk=300)
    assert pt.read_bytes() == pj.read_bytes()
    src = tdatagen.SeriesSource.from_file(str(pt), 64, chunk_series=300)
    ref = jdatagen.SeriesSource.from_file(str(pj), 64, chunk_series=300)
    assert (src.num_series, src.length, src.num_chunks) == (1000, 64, 4)
    for i in range(src.num_chunks):
        (a, oa), (b, ob) = src.read(i), ref.read(i)
        assert oa == ob
        np.testing.assert_array_equal(a, b)
    index, _ = tbp.PipelineBuilder(mode="paris+", device="cpu").build(src)
    want = build_index(np.fromfile(pt, np.float32).reshape(1000, 64),
                       device="cpu")
    for got, exp in zip(_index_arrays(index), _index_arrays(want)):
        np.testing.assert_array_equal(got, exp)


def test_stats_and_argument_checks():
    assert tbp.BuildStats().overlap_efficiency == 1.0
    assert tbp.BuildStats(convert_time=1.0).overlap_efficiency == 0.0
    done = tbp.BuildStats(convert_time=1.0, total_time=1.2, read_time=1.1)
    assert 0.0 <= done.overlap_efficiency <= 1.0
    with pytest.raises(ValueError):
        tbp.merge_runs([])
    with pytest.raises(ValueError, match="mode"):
        tbp.PipelineBuilder(mode="fast", device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            tbp.PipelineBuilder()
