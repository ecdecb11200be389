"""Port parity of the engine whose candidate list is ordered lazily.

``_engine_core`` orders its candidate list one prefix at a time
(``search.CandidateList``): two rounds' worth first (here more than a 32nd
of the list), then four times the prefix whenever a round reaches past
it. Over a 2^14-series index with
rounds of 16 (a list of 1024 entries: 64 rounds, extents 32, 128, 512 and
1024), white-noise queries run every round, so the list is extended three
times, and then fall back to the full scan; members plus noise stop after
a round or a few. Both engines run over one identical index (see
``test_torch_search.py``): positions, reads, BSF updates, rounds, and the
tiered path's achieved epsilon must be the reference's.
"""

import collections
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import build_index as j_build_index
from repro.core import datagen
from repro.core import search as js
from repro_torch.core import search as ts
from test_torch_search import assert_same_answers, port_index
from test_torch_select import extents
from test_torch_tiers import _same_tiered

N, LENGTH, ROUND = 1 << 14, 64, 16


@functools.lru_cache(maxsize=None)
def _pair():
    raw = datagen.random_walk(N, LENGTH, seed=29)
    j = j_build_index(jnp.asarray(raw))
    return j, port_index(j), raw


def _queries(kind: str) -> np.ndarray:
    """``noise``: white noise (every round, then the fallback); ``near``:
    members plus 0.3-sd noise (a few rounds); ``easy``: members plus a
    little noise (one round)."""
    rng = np.random.default_rng(291)
    if kind == "noise":
        return rng.standard_normal((4, LENGTH)).astype(np.float32)
    raw = _pair()[2]
    rows = raw[rng.integers(0, N, 4)]
    sd = 0.3 if kind == "near" else 0.01
    noise = sd * rows.std(axis=1, keepdims=True) * rng.standard_normal(
        rows.shape)
    return (rows + noise).astype(np.float32)


@pytest.mark.parametrize("kind,k", [("noise", 1), ("noise", 4),
                                    ("near", 1), ("easy", 1), ("easy", 2)])
def test_lazy_list_keeps_the_reference_answers(kind, k, monkeypatch):
    j, t, _ = _pair()
    qs = _queries(kind)
    want = js.exact_knn_batch(j, jnp.asarray(qs), k=k, round_size=ROUND,
                              stats=True)
    ranges = []
    order_range = ts.ops.order_range

    def counted(bounds, cols, lo, hi, *prev, **kw):
        ranges.append((lo, hi))
        return order_range(bounds, cols, lo, hi, *prev, **kw)

    monkeypatch.setattr(ts.ops, "order_range", counted)
    got = ts.exact_knn_batch(t, qs, k=k, round_size=ROUND, stats=True)
    assert_same_answers(want, got)
    # The main loop read the heads up to the one that stopped it (or the
    # last round's): every extent at or below it was extended past.
    sel = ts.select_len(N, ROUND)
    main = -(-sel // ROUND)
    last_head = min(got[4], main - 1) * ROUND
    steps = extents(sel, ROUND)
    assert [hi for _, hi in ranges] == [steps[0]] + [
        b for a, b in zip(steps, steps[1:]) if a <= last_head]
    if kind == "noise":  # every round, three extensions, then the fallback
        assert got[4] > main and len(ranges) == 4
    if kind == "easy" and k == 1:
        assert got[4] == 1 and len(ranges) == 1


def test_extensions_run_under_their_span():
    """Each extension is one ``paris.engine.select.extend`` range inside a
    ``paris.engine.select`` range of its own."""
    _, t, _ = _pair()
    qs = _queries("near")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        *_, rounds = ts.exact_knn_batch(t, qs, k=1, round_size=ROUND,
                                        stats=True)
    spans = collections.Counter(e.name for e in prof.events())
    steps = extents(ts.select_len(N, ROUND), ROUND)
    extended = sum(a <= rounds * ROUND for a in steps[:-1])
    assert extended >= 1
    assert spans["paris.engine.select.extend"] == extended
    assert spans["paris.engine.select"] == 1 + extended


@pytest.mark.parametrize("mix", ["eps", "budget", "mixed"])
def test_lazy_list_keeps_the_reference_tiers(mix):
    j, t, _ = _pair()
    qs = np.concatenate([_queries("noise")[:2], _queries("near")[:2]])
    tiers = {"eps": lambda m: m.Tier.epsilon(0.1),
             "budget": lambda m: m.Tier.budget(40),
             "mixed": lambda m: [m.Tier.exact(), m.Tier.budget(9),
                                 m.Tier.epsilon(0.05), m.Tier.budget(2)]}
    _same_tiered(
        js.knn_batch_tiered(j, jnp.asarray(qs), tiers[mix](js), k=2,
                            round_size=ROUND),
        ts.knn_batch_tiered(t, qs, tiers[mix](ts), k=2, round_size=ROUND))


def test_lazy_list_reads_what_the_full_sort_reads(monkeypatch):
    """The engine with the lazy list against the same engine fed the whole
    sorted list at once (one ``order_range`` over the whole list): identical
    tensors."""
    _, t, _ = _pair()
    qs = torch.from_numpy(_queries("noise"))

    class Sorted(ts.CandidateList):
        def __init__(self, lb, sel_len, round_size, impl):
            super().__init__(lb, sel_len, round_size, impl)
            self._order(sel_len)

    got = ts.exact_knn_batch(t, qs, k=3, round_size=ROUND, stats=True)
    monkeypatch.setattr(ts, "CandidateList", Sorted)
    want = ts.exact_knn_batch(t, qs, k=3, round_size=ROUND, stats=True)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert got[4] == want[4]
