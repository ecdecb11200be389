"""Port parity, exact engine: repro_torch.core.search against repro.core.search.

Both engines run over ONE identical index: the port's is built from the JAX
index's arrays (``convert.index_from_arrays``), and both get the same numpy
queries. Three fixtures, each with a small round size so several rounds run:

  * ``golden`` — the reference's golden raw: duplicated rows (exact distance
    ties) and a query that is a datastore row (a zero-distance tie);
  * ``walk``   — random walks, queries near datastore rows and fresh walks;
  * ``noise``  — random walks against white-noise queries: loose bounds, so
    the candidate list runs out and the exactness fallback scans.

Positions must be identical and distances agree within rtol 1e-5. Reads,
BSF updates and rounds must be identical wherever the reference sums in the
port's order (``reference_sums_like_port``); the comparison is with live JAX
output, not the golden arrays (those drift by up to 9.5e-6 on current jax).
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as j_build_index
from repro.core import datagen
from repro.core import isax as jx
from repro.core import search as js
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import isax as tx
from repro_torch.core import search as ts
from repro_torch.kernels import ref as tref

# The fixtures and comparisons below are shared with the other
# tests/test_torch_*.py files, which import them from this module.

# The port's CPU tests run small tensors; PyTorch's default of one thread
# per core in every xdist worker oversubscribes the host and slows the
# reference's timing-sensitive tests (router deadlines) in other workers.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def reference_sums_like_port() -> bool:
    """Whether this host's XLA sums in the port's order (``isax.sum_last``).

    XLA's CPU code generation varies with the host: the reference's own
    golden arrays drift on some hosts and not on others. The port sums as
    XLA does on the hosts these tests were written on, and there its
    z-norms and distances are bit-identical to the reference's. This probes
    both, eagerly and inside a jitted vmap as the engine runs them.
    """
    for n in (64, 256):
        x = datagen.random_walk(48, n, seed=n)
        z = np.array(jx.znorm(jnp.asarray(x)))  # a writable copy for torch
        if not np.array_equal(z, tx.znorm(torch.from_numpy(x)).numpy()):
            return False
        rows = np.stack([z[8:40]] * 4)
        fused = jax.jit(jax.vmap(
            lambda a, b: jops.euclid_sq(a, b, impl="ref")))(z[:4], rows)
        plain = tref.euclid_sq_gather(
            torch.from_numpy(z[:4]), torch.from_numpy(z),
            torch.arange(8, 40).expand(4, -1))
        if not np.array_equal(np.asarray(fused), plain.numpy()):
            return False
    return True


def assert_float_parity(got, want):
    """Bit-identical where the reference sums like the port, else to rounding."""
    got, want = np.asarray(got), np.asarray(want)
    if reference_sums_like_port():
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def assert_count_parity(got, want):
    """Engine counters: identical where the reference sums like the port.

    Elsewhere a rounding difference can flip the order of candidates whose
    bounds or distances tie to the last bit, which moves a count by a few:
    within 1% (at least 2) of the reference's.
    """
    got, want = np.asarray(got), np.asarray(want)
    if reference_sums_like_port():
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= np.maximum(2, 0.01 * np.abs(want)))

GOLDEN = np.load(pathlib.Path(__file__).parent / "golden_engine_core.npz")


def fixture_data(name):
    """(raw, queries, round size) of the fixture ``name``."""
    if name == "golden":
        return GOLDEN["raw"], GOLDEN["queries"], int(GOLDEN["round"])
    raw = datagen.random_walk(3000 if name == "walk" else 2000, 64, seed=5)
    rng = np.random.default_rng(7)
    if name == "walk":
        near = raw[[3, 100]] + 0.01 * rng.standard_normal((2, 64))
        queries = np.concatenate([near.astype(np.float32),
                                  datagen.random_walk(6, 64, seed=9)])
        return raw, queries, 64
    return raw, rng.standard_normal((6, 64)).astype(np.float32), 32


def port_index(j):
    """The port's index over the JAX index's own arrays."""
    return convert.index_from_arrays(
        np.asarray(j.sax), np.asarray(j.pos), np.asarray(j.bucket_offsets),
        np.asarray(j.raw), j.series_length, j.segments, j.cardinality,
        device="cpu")


def assert_same_answers(j_out, t_out):
    """Exact-engine 5-tuples: positions, counters, distances (rtol 1e-5)."""
    jd, jp, jr, ju, jrn = j_out
    td, tp, tr, tu, trn = t_out
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert_count_parity(tr.numpy(), jr)
    assert_count_parity(tu.numpy(), ju)
    assert_count_parity(trn, int(jrn))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def fixture_pair(name):
    """(JAX index, the port's index over its arrays, queries, round size)."""
    raw, queries, rnd = fixture_data(name)
    j = j_build_index(jnp.asarray(raw))
    return j, port_index(j), queries, rnd


# The whole k x sort matrix on the golden fixture (exact ties, a zero-
# distance tie); the sorted path at k = 1 and 8 on the other two.
CASES = ([("golden", k, sort) for k in (1, 4, 8) for sort in (True, False)]
         + [(name, k, True) for name in ("walk", "noise") for k in (1, 8)])


@pytest.mark.parametrize("name,k,sort", CASES)
def test_exact_knn_batch_parity(name, k, sort):
    j, t, queries, rnd = fixture_pair(name)
    assert_same_answers(
        js.exact_knn_batch(j, jnp.asarray(queries), k=k, round_size=rnd,
                           sort=sort, stats=True),
        ts.exact_knn_batch(t, queries, k=k, round_size=rnd, sort=sort,
                           stats=True))
