"""Port parity, service tiers and the batch engine factory.

``knn_batch_tiered`` and ``make_batch_engine`` of both packages over one
identical index (see ``test_torch_search.py``), with exact / epsilon / budget
mixes. Positions are identical and distances within rtol 1e-5. The
achieved epsilon, ``sqrt(factor) - 1``, is compared with rtol 1e-5 plus
atol 1e-6: the reference's fused division leaves its squared factor up to
1 ulp (1.2e-7 relative) from the port's, and near 0 the subtraction turns
that ulp into an absolute, not a relative, difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import search as js
from repro_torch.core import search as ts
from test_torch_search import assert_count_parity, fixture_pair

MIXES = {
    "eps": lambda m: [m.Tier.epsilon(0.1)],
    "budget1": lambda m: [m.Tier.budget(1)],
    "budget2": lambda m: [m.Tier.budget(2)],
    "mixed": lambda m: [m.Tier.exact(), m.Tier.epsilon(0.05), m.Tier.budget(1),
                        m.Tier.epsilon(0.2), m.Tier.budget(3), m.Tier.exact()],
}


@pytest.fixture(scope="module", params=["golden", "noise"])
def pair(request):
    return fixture_pair(request.param)


def _tiers(mix, module, n_q):
    tiers = MIXES[mix](module)
    return tiers[0] if len(tiers) == 1 else (tiers * n_q)[:n_q]


def _same_tiered(j_out, t_out):
    jd, jp, ja = j_out
    td, tp, ta = t_out
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mix", list(MIXES))
@pytest.mark.parametrize("k", [1, 8])
def test_knn_batch_tiered_parity(pair, k, mix):
    j, t, queries, rnd = pair
    n_q = len(queries)
    _same_tiered(
        js.knn_batch_tiered(j, jnp.asarray(queries), _tiers(mix, js, n_q),
                            k=k, round_size=rnd),
        ts.knn_batch_tiered(t, queries, _tiers(mix, ts, n_q), k=k,
                            round_size=rnd))


def test_exact_tier_equals_exact_engine(pair):
    _, t, queries, rnd = pair
    d, p, ach = ts.knn_batch_tiered(t, queries, ts.Tier.exact(), k=4,
                                    round_size=rnd)
    d0, p0 = ts.exact_knn_batch(t, queries, k=4, round_size=rnd)
    np.testing.assert_array_equal(p.numpy(), p0.numpy())
    np.testing.assert_array_equal(d.numpy(), d0.numpy())
    assert np.all(ach == 0.0)


@pytest.mark.parametrize("k", [None, 4])
def test_make_batch_engine_parity_with_padding(pair, k):
    j, t, queries, rnd = pair
    qs = queries[:5]  # pads to a bucket of 8 rows
    je = js.make_batch_engine(j, k=k, round_size=rnd)
    te = ts.make_batch_engine(t, k=k, round_size=rnd)
    assert te.bucket(5) == je.bucket(5) == 8
    jr, tr = je(jnp.asarray(qs)), te(qs)
    if k is None:
        np.testing.assert_array_equal(tr.position.numpy(),
                                      np.asarray(jr.position))
        assert_count_parity(tr.raw_reads.numpy(), jr.raw_reads)
        assert_count_parity(tr.bsf_updates.numpy(), jr.bsf_updates)
        assert_count_parity(tr.rounds, int(jr.rounds))
        np.testing.assert_allclose(tr.dist_sq.numpy(), np.asarray(jr.dist_sq),
                                   rtol=1e-5)
        return
    np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))
    mixed_j = [js.Tier.budget(1), js.Tier.exact(), js.Tier.epsilon(0.1),
               js.Tier.exact(), js.Tier.budget(2)]
    mixed_t = [ts.Tier(x.kind, x.eps, x.budget_rounds) for x in mixed_j]
    _same_tiered(je(jnp.asarray(qs), tiers=mixed_j), te(qs, tiers=mixed_t))


def test_tier_validation_and_errors():
    _, t, queries, _ = fixture_pair("golden")
    with pytest.raises(ValueError, match="eps >= 0"):
        ts.Tier.epsilon(-0.1)
    with pytest.raises(ValueError, match="budget_rounds >= 1"):
        ts.Tier.budget(0)
    with pytest.raises(ValueError, match="tier kind"):
        ts.Tier("fast")
    with pytest.raises(ValueError, match="tiers for"):
        ts.knn_batch_tiered(t, queries, [ts.Tier.exact()], k=1)
    with pytest.raises(ValueError, match="k-NN mode"):
        ts.make_batch_engine(t)(queries[:2], tiers=[ts.Tier.epsilon(0.1)] * 2)
    fac, bud = ts.tier_arrays([ts.Tier.epsilon(0.5), ts.Tier.budget(3),
                               ts.Tier.exact()], device="cpu")
    jfac, jbud = js.tier_arrays([js.Tier.epsilon(0.5), js.Tier.budget(3),
                                 js.Tier.exact()])
    np.testing.assert_array_equal(fac.numpy(), np.asarray(jfac))
    np.testing.assert_array_equal(bud.numpy(), np.asarray(jbud))
    np.testing.assert_array_equal(
        ts.achieved_epsilon(np.array([1.0, 1.21, 0.5, np.inf], np.float32)),
        js.achieved_epsilon(np.array([1.0, 1.21, 0.5, np.inf], np.float32)))


def test_tier_arrays_default_to_the_card():
    # Like every entry point, tier_arrays runs on the card unless asked for
    # the CPU: without a card the bare call raises, never falls back.
    # (tests/test_torch_cuda.py checks the card's side.)
    tiers = [ts.Tier.epsilon(0.5), ts.Tier.exact()]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ts.tier_arrays(tiers)
    fac, bud = ts.tier_arrays(tiers, device="cpu")
    assert fac.device.type == bud.device.type == "cpu"
