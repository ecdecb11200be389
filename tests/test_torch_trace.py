"""The engines' spans (``repro_torch.core.trace``) on the CPU.

Under ``torch.profiler`` each engine call is one ``paris.engine`` or
``paris.single`` range, each loop iteration one round range holding the
one readback that decides whether to go on (``.sync``), and the answers,
reads and rounds are those of the same call with no profiler running.
Without a profiler ``trace.span`` hands back one shared no-op context.
"""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import search, trace
from repro_torch.core.index import build_index

N, LENGTH, ROUND = 2048, 64, 16


def _raw():
    gen = torch.Generator().manual_seed(7)
    return torch.randn((N, LENGTH), generator=gen).cumsum(1)


def _queries(kind: str):
    """``easy``: members plus a little noise (one round, no fallback);
    ``fallback``: white noise, whose 1-NN lies past the selected bounds."""
    gen = torch.Generator().manual_seed(11)
    if kind == "easy":
        rows = torch.randint(0, N, (4,), generator=gen)
        return _raw()[rows] + 0.01 * torch.randn((4, LENGTH), generator=gen)
    return torch.randn((4, LENGTH), generator=gen)


def _spans(prof) -> collections.Counter:
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("paris."))


def _profiled(call):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = call()
    return out, _spans(prof)


@pytest.fixture(scope="module")
def index():
    return build_index(_raw(), segments=16, cardinality=256, device="cpu")


@pytest.mark.parametrize("kind", ["easy", "fallback"])
def test_batch_engine_spans(index, kind):
    qs = _queries(kind)

    def call():
        return search.exact_knn_batch(index, qs, k=1, round_size=ROUND,
                                      stats=True)

    plain = call()
    got, spans = _profiled(call)
    for a, b in zip(plain[:4], got[:4]):
        assert torch.equal(a, b)
    assert plain[4] == got[4]
    rounds = got[4]
    main = -(-search.select_len(N, ROUND) // ROUND)
    assert (rounds > main) == (kind == "fallback")
    for name in ("paris.engine", "paris.engine.view", "paris.engine.prep",
                 "paris.engine.seed", "paris.engine.bounds"):
        assert spans[name] == 1, name
    # The list's first prefix covers two rounds of its 8; the fallback
    # batch runs them all, so its list is ordered once more, to the end,
    # under a second select span.
    extend = spans["paris.engine.select.extend"]
    assert extend == (kind == "fallback")
    assert spans["paris.engine.select"] == 1 + extend
    assert spans["paris.engine.sync"] == (
        spans["paris.engine.round"] + spans["paris.engine.fallback_round"])
    # The fallback runs only after the main list ran out, so the rounds
    # split as below; a loop that its own check ended has one span more.
    r_main, r_fallback = min(rounds, main), max(rounds - main, 0)
    assert spans["paris.engine.round"] == r_main + (r_main < main)
    assert spans["paris.engine.fallback_round"] == r_fallback + (
        r_fallback < -(-N // ROUND))


def test_tiered_and_packed_engines_open_one_engine_span(index):
    qs = _queries("fallback")
    _, spans = _profiled(lambda: search.knn_batch_tiered(
        index, qs, search.Tier.budget(2), k=2, round_size=ROUND))
    assert spans["paris.engine"] == 1
    assert spans["paris.engine.sync"] == (
        spans["paris.engine.round"] + spans["paris.engine.fallback_round"])
    packed = search.pack_components([(index, 0)])
    (_, _, _, _, rounds), spans = _profiled(
        lambda: search.exact_knn_batch_packed(packed, qs, round_size=ROUND,
                                              stats=True))
    assert spans["paris.engine"] == 1 and "paris.engine.seed" not in spans
    assert spans["paris.engine.round"] + spans[
        "paris.engine.fallback_round"] >= rounds


@pytest.mark.parametrize("kind", ["easy", "fallback"])
def test_single_engine_spans(index, kind):
    q = _queries(kind)[0]
    cfg = search.SearchConfig(round_size=ROUND)

    def call():
        return search.exact_search_single(index, q, cfg)

    plain = call()
    got, spans = _profiled(call)
    for field in ("dist_sq", "position", "raw_reads", "bsf_updates"):
        assert torch.equal(getattr(plain, field), getattr(got, field))
    assert plain.rounds == got.rounds
    for name in ("paris.single", "paris.single.prep", "paris.single.seed",
                 "paris.single.bounds", "paris.single.sort"):
        assert spans[name] == 1, name
    assert spans["paris.single.sync"] == spans["paris.single.round"]
    ended_on_check = got.rounds < -(-N // ROUND)
    assert spans["paris.single.round"] == got.rounds + ended_on_check
    assert "paris.engine" not in spans


def test_two_calls_open_two_top_spans(index):
    qs = _queries("easy")
    _, spans = _profiled(lambda: [
        search.exact_knn_batch(index, qs, k=1, round_size=ROUND)
        for _ in range(2)] + [
        search.exact_search_single(index, qs[0],
                                   search.SearchConfig(round_size=ROUND))
        for _ in range(3)])
    assert spans["paris.engine"] == 2 and spans["paris.single"] == 3


def test_no_profiler_no_range():
    off = trace.span("paris.engine")
    assert off is trace.span("paris.single.round")
    assert isinstance(off, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        on = trace.span("paris.engine")
    assert not isinstance(on, contextlib.nullcontext)
    assert trace.span("paris.engine") is off
