"""Port parity for the rest of the search layer's slice: the k-NN classifier
(``repro_torch.core.classifier``), ``isax.batched_euclid_sq``, the scalar
Table-1 baseline ``ops.lower_bound_sq(impl="sisd")``, and the two ParIS+
examples of ``repro_torch.examples``.

The classifier runs on ONE identical index in both packages (the port's is
built from the JAX index's arrays): a two-class set of random walks of
length 128 with opposite drift, labels in file order. For k in {1, 5} the
port's ``predict`` and ``predict_brute`` must equal the reference's
``KnnClassifier`` on the same seeded queries, and so must the neighbour
positions of both paths. ``batched_euclid_sq`` agrees with the reference's
within rtol 1e-5 (the matrix products round differently). The SISD bound is
bitwise the port's plain batch bound (the same sums in the same order), and
within rtol 1e-6 of the reference's SISD bound: XLA compiles the
reference's scalar loop into sums that sit up to an ulp from the
reference's own plain bound (about 30% of rows differ by 1-2e-7
relative), so no bitwise target exists there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as j_build_index
from repro.core import isax as jx
from repro.core import search as js
from repro.core.classifier import KnnClassifier as JKnn
from repro.kernels import ops as jops
from repro_torch.core import isax as tx
from repro_torch.core.classifier import KnnClassifier
from repro_torch.examples import knn_classifier as knn_example
from repro_torch.examples import quickstart
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_search import port_index

N_PER, LENGTH, DRIFT = 1500, 128, 0.06


@functools.lru_cache(maxsize=None)
def drift_classes():
    """(raw, labels, queries): two drift classes and 5 drifted queries."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((N_PER, LENGTH)) + DRIFT).cumsum(axis=1)
    b = (rng.standard_normal((N_PER, LENGTH)) - DRIFT).cumsum(axis=1)
    raw = np.concatenate([a, b]).astype(np.float32)
    labels = np.concatenate([np.zeros(N_PER, np.int32),
                             np.ones(N_PER, np.int32)])
    drifts = rng.choice([-DRIFT, DRIFT], size=5)
    queries = (rng.standard_normal((5, LENGTH)) + drifts[:, None]).cumsum(
        axis=1).astype(np.float32)
    return raw, labels, queries


@functools.lru_cache(maxsize=None)
def indexes():
    raw = drift_classes()[0]
    j = j_build_index(jnp.asarray(raw))
    return j, port_index(j)


@pytest.mark.parametrize("k", [1, 5])
def test_classifier_matches_reference(k):
    _, labels, queries = drift_classes()
    j_index, t_index = indexes()
    jc = JKnn(j_index, labels, k=k, round_size=256)
    tc = KnnClassifier(t_index, labels, k=k, round_size=256)
    for q in queries:
        want = js.exact_knn(j_index, jnp.asarray(q), k=k, round_size=256)
        d, pos = tc.kneighbors(q)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(d.numpy(), np.asarray(want[0]), rtol=1e-5)
        jd = jx.euclid_sq(jx.znorm(jnp.asarray(q)), j_index.raw)
        bd, bpos = tc.brute_kneighbors(q)
        np.testing.assert_array_equal(
            bpos.numpy(), np.asarray(jnp.argsort(jd)[:k]))
        np.testing.assert_allclose(bd.numpy(), np.asarray(jd)[bpos.numpy()],
                                   rtol=1e-5)
        assert tc.predict(q) == jc.predict(jnp.asarray(q))
        assert tc.predict_brute(q) == jc.predict_brute(jnp.asarray(q))
        assert tc.predict(q) == tc.predict_brute(q)


def test_classifier_votes_like_jnp_argmax():
    """Ties go to the first (smallest) label, as ``jnp.argmax`` gives them;
    labels are checked against the index."""
    _, t_index = indexes()
    labels = np.arange(t_index.num_series) % 3
    tc = KnnClassifier(t_index, labels, k=4)
    for pos, want in (([0, 1, 2, 3], 0), ([1, 2, 4, 5], 1), ([2, 5, 1, 0], 2)):
        got = tc.vote(torch.tensor(pos))
        assert got == want == int(jnp.argmax(jnp.bincount(
            jnp.asarray(labels[pos]), length=3)))
    with pytest.raises(ValueError, match="one label a series"):
        KnnClassifier(t_index, labels[:-1])


def test_batched_euclid_sq_matches_reference():
    rng = np.random.default_rng(11)
    q = np.array(jx.znorm(jnp.asarray(
        rng.standard_normal((5, 64)).cumsum(axis=1).astype(np.float32))))
    data = np.array(jx.znorm(jnp.asarray(
        rng.standard_normal((300, 64)).cumsum(axis=1).astype(np.float32))))
    data[7] = q[2]  # a zero distance: the clamp at 0
    got = tx.batched_euclid_sq(torch.from_numpy(q), torch.from_numpy(data))
    want = np.asarray(jx.batched_euclid_sq(jnp.asarray(q), jnp.asarray(data)))
    assert got.shape == (5, 300) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    direct = tx.euclid_sq(torch.from_numpy(q)[:, None, :],
                          torch.from_numpy(data)[None, :, :])
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("w", [8, 16])
def test_sisd_baseline_matches_reference(w):
    rng = np.random.default_rng(w)
    bpp = np.array(jx.padded_breakpoints(256))
    sax = rng.integers(0, 256, (120, w), dtype=np.uint8)
    sax[:4] = [0, 255] * (w // 2)  # the regions at the +-BIG pads
    qp = rng.standard_normal(w).astype(np.float32)
    qp[0] = bpp[sax[5, 0]]  # exactly on a breakpoint: d = 0 by the branch
    got = tops.lower_bound_sq(torch.from_numpy(qp), torch.from_numpy(sax),
                              torch.from_numpy(bpp), 256, impl="sisd")
    plain = tref.lower_bound_sq_batch(torch.from_numpy(qp)[None],
                                      torch.from_numpy(sax),
                                      torch.from_numpy(bpp), 256)[0]
    assert torch.equal(got, plain)
    want = np.asarray(jops.lower_bound_sq(
        jnp.asarray(qp), jnp.asarray(sax), jnp.asarray(bpp), 256,
        impl="sisd"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_sisd_only_on_request(monkeypatch):
    """``auto`` never reaches the scalar baseline; a bad impl names it."""
    def refuse(*a):
        raise AssertionError("auto reached the SISD baseline")

    monkeypatch.setattr(tref, "lower_bound_sq_sisd", refuse)
    sax = torch.zeros((4, 8), dtype=torch.uint8)
    bpp = tx.padded_breakpoints(256)
    tops.lower_bound_sq(torch.zeros(8), sax, bpp, 64)
    with pytest.raises(ValueError, match="'sisd'"):
        tops.lower_bound_sq_batch(torch.zeros((1, 8)), sax, bpp, 64,
                                  impl="pallas")


def test_quickstart_example_runs_exact_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu", "--series", "2000",
                            "--queries", "3", "--chunk", "512"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("query ")]
    assert len(lines) == 3 and all("exact=True" in ln for ln in lines)


def test_knn_classifier_example_agrees_on_cpu(capsys):
    assert knn_example.main(["--device", "cpu", "--per-class", "500",
                             "--trials", "4"])
    out = capsys.readouterr().out
    assert "agreement with brute force: 4/4" in out
