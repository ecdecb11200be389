"""The batch engine's round as one step: ``ops.engine_round``.

``ref.engine_round`` (the plain version, and the CPU's path) is held bit
for bit to the round body of the engine's main loop as the host ran it
before (``_old_round`` below, copied from it), on hand-made rounds: k = 1
and 4, ties between columns and with the incumbent, +inf bounds, ``NO_POS``
pads, rounds with every candidate or none masked in, tier arrays whose
budgets end mid-list, and the exit flag. Then the engine over a small
index answers as the JAX reference does, with one ``engine_round`` a round
the loop tries on the index and packed views and none on a cold shard,
whose rows come from the host.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as j_build_index
from repro.core import datagen
from repro.core import search as js
from repro_torch.core import coldtier, search as ts
from repro_torch.core.block_cache import BlockCache
from repro_torch.core.build_pipeline import keys_to_u64, refine_key
from repro_torch.kernels import ops, ref
from test_torch_search import assert_same_answers, port_index
from test_torch_tiers import _same_tiered

INF = float("inf")


def _old_round(r, cols, bounds, rs, pos_table, raw, qs, top_d, top_p,
               reads, updates, tiers):
    """One main-loop round of ``_engine_core`` as it was: (go, (top_d,
    top_p, reads, updates, skip_lb))."""
    eps_factor_sq, budget_rounds, skip_lb = tiers
    tiered = eps_factor_sq is not None
    kth = top_d[:, -1]
    head = bounds[:, 0]
    if tiered:
        go = ((r < budget_rounds) & (head * eps_factor_sq < kth)).any()
    else:
        go = (head < kth).any()
    if not bool(go):
        return False, (top_d, top_p, reads, updates, skip_lb)
    cand_rows = ts._cols(cols, 0, rs, 0)
    lbs = ts._cols(bounds, 0, rs, INF)
    if tiered:
        would = lbs < kth[:, None]
        mask = ((lbs * eps_factor_sq[:, None] < kth[:, None])
                & (r < budget_rounds)[:, None])
        skip_lb = torch.minimum(
            skip_lb, torch.where(would & ~mask, lbs, INF).amin(dim=1))
    else:
        mask = lbs < kth[:, None]
    cand_pos = pos_table[cand_rows.to(torch.int64)]
    d = ref.euclid_sq_gather(qs, raw, cand_pos)
    d = torch.where(mask, d, INF)
    improved = d.amin(dim=1) < top_d[:, -1]
    top_d, top_p = ts.merge_round(top_d, top_p, cand_pos, d)
    return True, (top_d, top_p, reads + mask.sum(dim=1, dtype=torch.int32),
                  updates + improved.to(torch.int32), skip_lb)


Q, N_RAW, N_ROWS, LENGTH, RS = 5, 12, 16, 8, 8


def _round_case(name: str, k: int) -> dict:
    """A hand-made round: queries, raw rows (rows 3 and 7 equal, so their
    distances tie), a position table with ``NO_POS`` pads, round r's columns
    and bounds, and result lists (some at +inf)."""
    g = torch.Generator().manual_seed(10 * NAMES.index(name) + k)
    raw = torch.randn((N_RAW, LENGTH), generator=g)
    raw[7] = raw[3]
    qs = torch.randn((Q, LENGTH), generator=g)
    qs[0] = raw[3] + 0.01 * qs[0]  # rows 3 and 7 are query 0's nearest
    pos_table = torch.randperm(N_RAW, generator=g).to(torch.int32)
    pos_table = torch.cat([pos_table, torch.full((N_ROWS - N_RAW,), -1,
                                                 dtype=torch.int32)])
    width = RS - 3 if name == "list_end" else RS
    cols = torch.stack([torch.randperm(N_ROWS, generator=g)[:width]
                        for _ in range(Q)]).to(torch.int32)
    # Query 0 has the tie of rows 3 and 7 at its columns 1 and 4.
    three = int((pos_table == 3).nonzero()[0, 0])
    seven = int((pos_table == 7).nonzero()[0, 0])
    rest = [c for c in torch.randperm(N_ROWS, generator=g).tolist()
            if c not in (three, seven)]
    cols[0] = torch.tensor(rest[:1] + [seven] + rest[1:3] + [three]
                           + rest[3:width - 2], dtype=torch.int32)
    bounds = torch.sort(torch.rand((Q, width), generator=g) * 6, 1).values
    pads = pos_table[cols.long()] < 0
    bounds[pads] = INF  # a pad row's bound, as the packed sweep gives it
    d_all = ref.euclid_sq_gather(qs, raw, pos_table[cols.long()])
    top_d = torch.full((Q, k), INF)
    top_p = torch.full((Q, k), -1, dtype=torch.int32)
    fill = torch.sort(torch.rand((Q, k), generator=g) * 40, 1).values
    top_d[1:3], top_p[1:3] = fill[1:3], torch.arange(2 * k).view(2, k).int()
    if name == "incumbent_tie":  # query 1's k-th best is a candidate's
        bounds[1] = 0.0
        top_d[1, -1] = d_all[1].min()
    if name == "all_in":
        bounds.zero_()
    if name == "none_in":  # the exit test fails
        top_d.zero_()
    if name == "one_query":  # only query 4's head beats its k-th best
        top_d[:4] = 0.0
    return dict(cols=cols, bounds=bounds, pos_table=pos_table, raw=raw,
                qs=qs, top_d=top_d, top_p=top_p,
                reads=torch.arange(Q, dtype=torch.int32),
                updates=torch.zeros(Q, dtype=torch.int32), d_all=d_all)


def _tiers(name: str, r: int):
    if name not in ("tiered", "budget_spent"):
        return (None, None, None)
    budget = ([0, r, r + 1, 9, r + 1] if name == "tiered"
              else [0, r, r - 1, 1, r])  # every budget spent: no test passes
    return (torch.tensor([1.0, 1.21, 4.0, 1.0, 2.25]),
            torch.tensor(budget, dtype=torch.int32),
            torch.tensor([INF, 3.0, INF, 0.5, INF]))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    return a is None and b is None or torch.equal(_bits(a), _bits(b))


NAMES = ["mixed", "incumbent_tie", "list_end", "all_in", "none_in",
         "one_query", "tiered", "budget_spent"]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", NAMES)
def test_plain_round_is_the_old_round_body(name, k):
    c = _round_case(name, k)
    r = 2
    tiers = _tiers(name, r)
    go, want = _old_round(r, c["cols"], c["bounds"], RS, c["pos_table"],
                          c["raw"], c["qs"], c["top_d"], c["top_p"],
                          c["reads"], c["updates"], tiers)
    got = [c[x].clone() for x in ("top_d", "top_p", "reads", "updates")]
    skip = None if tiers[2] is None else tiers[2].clone()
    state = torch.zeros(3 * Q + 2, dtype=torch.int64)
    out = ((torch.full((Q, RS), -7.0), torch.full((Q, RS), 9,
                                                  dtype=torch.int32))
           if k > 1 else (None, None))
    ops.engine_round(c["cols"], c["bounds"], r, RS, (c["pos_table"],
                     c["raw"]), c["qs"], *got, state,
                     tiers=(tiers[0], tiers[1], skip), out=out)
    assert int(state[-1]) == int(go)
    assert not state[:-1].any()  # the kernel's words stay 0
    if go and k > 1:
        got[:2] = ts.merge_round(got[0], got[1], out[1], out[0])
    for a, b in zip(got + [skip], want):
        assert _same(a, b)
    if k > 1 and go:  # the merge's inputs: masked distances and positions
        w = c["cols"].shape[1]
        kept = out[0] < INF
        assert not kept[:, w:].any()
        assert (out[1][~kept] == -1).all()
        assert torch.equal(_bits(out[0][:, :w][kept[:, :w]]),
                           _bits(c["d_all"][kept[:, :w]]))
    if not go:  # the exit test failed: nothing but the flag was written
        assert out[0] is None or (out[0] == -7.0).all()
    assert go == (name not in ("none_in", "budget_spent"))


def test_round_cases_cover_what_they_name():
    """The cases do what their names say: ties among the masked-in
    columns, a tie with the incumbent, a short round, every or no
    candidate masked in, budgets that end at this round."""
    c = _round_case("mixed", 1)
    assert torch.equal(c["d_all"][0, 1], c["d_all"][0, 4])
    assert c["d_all"][0, 1] == c["d_all"][0].min()
    assert (c["bounds"] == INF).any()
    assert _round_case("list_end", 1)["cols"].shape[1] < RS
    c = _round_case("incumbent_tie", 1)
    assert (c["d_all"][1] == c["top_d"][1, -1]).any()
    eps, budget, _ = _tiers("tiered", 2)
    assert (budget <= 2).any() and (budget > 2).any()
    # budget_spent: heads beat their k-th bests, but no budget is left,
    # so the test fails and the bounds it would have skipped stay unfolded
    c = _round_case("budget_spent", 1)
    assert (c["bounds"][:, 0] < c["top_d"][:, -1]).any()
    assert (_tiers("budget_spent", 2)[1] <= 2).all()


# --- The engine over a small index, against the JAX reference ------------

N, ROUND = 1 << 12, 16  # a list of 256 entries: 16 rounds, first prefix 2


@functools.lru_cache(maxsize=None)
def _pair():
    raw = datagen.random_walk(N, 64, seed=31)
    j = j_build_index(jnp.asarray(raw))
    return j, port_index(j), raw


def _queries(sd: float) -> np.ndarray:
    """Members plus noise of ``sd`` x their own sd: 0.02 ends in a round;
    0.4 at k = 3 runs past the list's first prefix (15 rounds), 0.6 through
    the whole list and into the fallback."""
    rng = np.random.default_rng(311)
    raw = _pair()[2]
    rows = raw[rng.integers(0, N, 4)]
    noise = sd * rows.std(axis=1, keepdims=True) * rng.standard_normal(
        rows.shape)
    return (rows + noise).astype(np.float32)


@pytest.fixture
def round_calls(monkeypatch):
    """Counts the engine's calls of ``ops.engine_round`` (on the CPU its
    plain version, which launches nothing and leaves the kernel's launch
    counter at 0: that counter proves a launch on the card alone)."""
    calls = []
    real = ops.engine_round

    def spy(*args, **kwargs):
        calls.append(args[2])
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "engine_round", spy)
    ops.reset_launch_counts()
    yield calls
    assert ops.launch_counts()["engine_round"] == 0


def _tried(rounds: int) -> int:
    """Main-loop rounds the engine tried: those it ran, and the one whose
    exit test ended the loop, if one did."""
    main = -(-ts.select_len(N, ROUND) // ROUND)
    return min(rounds, main) + (rounds < main)


@pytest.mark.parametrize("sd,k", [(0.02, 1), (0.4, 3), (0.6, 1)])
def test_engine_takes_one_round_step_and_keeps_the_reference(sd, k,
                                                            round_calls):
    j, t, _ = _pair()
    qs = _queries(sd)
    want = js.exact_knn_batch(j, jnp.asarray(qs), k=k, round_size=ROUND,
                              stats=True)
    got = ts.exact_knn_batch(t, qs, k=k, round_size=ROUND, stats=True)
    assert_same_answers(want, got)
    assert round_calls == list(range(_tried(got[4])))
    if sd > 0.1:  # past the first prefix: an extension inside the loop
        assert got[4] > ts.CandidateList.first_prefix(
            ts.select_len(N, ROUND), ROUND) // ROUND


def test_tiered_engine_takes_the_round_step_and_keeps_the_reference(
        round_calls):
    j, t, _ = _pair()
    qs = _queries(0.4)
    tiers = lambda m: [m.Tier.exact(), m.Tier.budget(3),  # noqa: E731
                       m.Tier.epsilon(0.05), m.Tier.budget(1)]
    got = ts.knn_batch_tiered(t, qs, tiers(ts), k=2, round_size=ROUND)
    assert len(round_calls) > 0
    _same_tiered(js.knn_batch_tiered(j, jnp.asarray(qs), tiers(js), k=2,
                                     round_size=ROUND), got)


def test_packed_view_takes_one_round_step_a_round(round_calls):
    _, t, _ = _pair()
    qs = _queries(0.4)
    packed = ts.pack_components([(t, 0)])
    got = ts.exact_knn_batch_packed(packed, qs, round_size=ROUND, stats=True)
    assert round_calls == list(range(_tried(got[4])))
    want = ts.exact_knn_batch(t, qs, round_size=ROUND, stats=True,
                              impl="ref")
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def test_cold_shard_keeps_the_round_body(tmp_path, round_calls):
    """A cold shard's rows come from the host: its view gives no device
    rows, so no round goes through ``engine_round``, and it answers as the
    in-memory index does."""
    _, t, _ = _pair()
    keys = keys_to_u64(refine_key(t.sax, 4, t.cardinality))
    pos = t.pos.numpy()
    ref_ = coldtier.spill_cold_component(
        str(tmp_path), "e0", keys, t.sax.numpy(), pos, t.raw.numpy()[pos],
        base=0, series_length=t.series_length)
    shard = coldtier.load_cold_shard(
        str(tmp_path), ref_, cache=BlockCache(block_rows=64),
        segments=t.segments, cardinality=t.cardinality, device="cpu")
    assert coldtier._cold_view(shard, leaf_cap=256).rows is None
    qs = _queries(0.4)
    got = coldtier.cold_exact_knn_batch(shard, qs, k=2, round_size=ROUND,
                                        stats=True)
    assert round_calls == []
    want = ts.exact_knn_batch(t, qs, k=2, round_size=ROUND, stats=True)
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert got[4] == want[4]


def test_serial_scan_keeps_the_round_body(round_calls):
    _, t, _ = _pair()
    ts.exact_knn_batch(t, _queries(0.02), k=1, round_size=1024, sort=False)
    assert round_calls == []


def test_operator_traces_on_fake_cuda_tensors():
    """Under ``FakeTensorMode`` the operator runs its fake (it writes its
    arguments in place and returns nothing), and the FLOP counter reads
    ``roofline.kernel_cost``'s most a round can do: every candidate in."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import roofline

    q, rs, n = 4, 64, 32
    with FakeTensorMode():
        def t(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="cuda")

        i32 = torch.int32
        args = (t(q, rs, dtype=i32), t(q, rs), 3, rs, t(100, dtype=i32),
                t(90, n), t(q, n), t(q, 1), t(q, 1, dtype=i32),
                t(q, dtype=i32), t(q, dtype=i32),
                t(3 * q + 2, dtype=torch.int64))
        with FlopCounterMode(display=False) as fc:
            out = torch.ops.repro_torch.engine_round(*args)
    assert out is None
    assert fc.get_total_flops() == roofline.kernel_cost(
        "engine_round", q=q, r=rs, n=n)["ops"] == q * rs * 3 * n
