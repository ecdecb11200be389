"""Exact and approximate similarity search over a ParIS index (paper §3.3).

Counterpart of ``repro/core/search.py`` for the single-index main path. All
algorithms work on *squared* distances and return file-order positions.

  approximate search     -> :func:`approx_search_batch`: the query's root
                            bucket, then true distances over one
                            ``leaf_cap`` window of index-sorted entries.
  LBC pass               -> one (Q, N) lower-bound kernel launch.
  candidate list         -> the ``select_len`` smallest bounds per query,
                            ties toward the lower row (as ``lax.top_k``).
  RDC rounds + BSF       -> :func:`_engine_core`: rounds of ``round_size``
                            candidates per query, masked by the current
                            k-th best, distanced and merged into the result
                            list; over stores whose rows lie on the device
                            a round is one launch (:func:`ops.engine_round`)
                            with its exit test.
  early exit, fallback   -> the loop stops when no query's next bound beats
                            its k-th best; the exactness fallback scans the
                            rows the selection cut off, only when needed.

The engine is ONE function, :func:`_engine_core`, behind the
:class:`EngineView` hooks, and answers the exact path (5-tuple) and the
service tiers (6-tuple, :class:`Tier`). Every store's entry points (the
index here, the packed store, the cold shard, the live store) build their
store's view and go through ONE front door, :func:`_engine_call`, which
checks the queries and k, builds the tier rows and pads the answer. The
reference runs the engine as a jitted
``while_loop``; here it is a host loop over device tensors, and each round
reads one flag back from the device to decide whether to go on. The round
count is the reference's: ``rounds`` and ``reads`` are outputs the tests
compare. While a profiler runs, each step of both engines is a named
``paris.*`` range (:func:`repro_torch.core.trace.span`).

Positions inside the engine are int32; ``NO_POS`` (-1) marks an unfilled
result slot with an INF distance.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import isax, trace, tuning
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.index import ParISIndex
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

INF = float("inf")
NO_POS = -1  # sentinel position of an unfilled k-NN result slot
_BUDGET_UNLIMITED = np.iinfo(np.int32).max  # "no round budget"


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Knobs of the exact-search paths (see field comments)."""
    round_size: int = 4096  # candidates distance-checked per BSF round
    leaf_cap: int = 256  # approximate-search window ("leaf" size)
    sort: bool = True  # sort candidate list by lower bound (ParIS+)
    impl: str = "auto"  # kernel dispatch (ops.py)
    workers: int = 16  # nb- variant only: #independent scan blocks
    select: str = "topk"  # candidate ordering: "topk" partial / "sort" full


@dataclasses.dataclass(frozen=True)
class Tier:
    """A per-request service tier: how exact must this answer be?

      ``Tier.exact()``        the default; the exact answer.
      ``Tier.epsilon(eps)``   answer provably within ``(1+eps)`` of the
                              exact distance (``eps >= 0``).
      ``Tier.budget(rounds)`` best answer after at most ``rounds``
                              candidate rounds (``rounds >= 1``), with
                              the achieved error bound reported.

    Parameters are validated at construction.
    """

    kind: str = "exact"  # "exact" | "epsilon" | "budget"
    eps: float = 0.0  # epsilon tier: relative error bound, >= 0
    budget_rounds: int = 0  # budget tier: max candidate rounds, >= 1

    def __post_init__(self):
        if self.kind not in ("exact", "epsilon", "budget"):
            raise ValueError(
                f"unknown tier kind {self.kind!r}: expected 'exact', "
                "'epsilon' or 'budget'")
        if self.kind == "epsilon":
            eps = float(self.eps)
            if not eps >= 0.0:  # rejects NaN too
                raise ValueError(
                    f"epsilon tier needs eps >= 0, got {self.eps!r} "
                    "(eps is the relative error bound: the answer is "
                    "guaranteed within (1+eps) of the exact distance)")
        if self.kind == "budget":
            if int(self.budget_rounds) < 1:
                raise ValueError(
                    f"budget tier needs budget_rounds >= 1, got "
                    f"{self.budget_rounds!r} (the engine must run at "
                    "least one candidate round to produce an answer)")

    @staticmethod
    def exact() -> "Tier":
        """The exact tier."""
        return Tier("exact")

    @staticmethod
    def epsilon(eps: float) -> "Tier":
        """An epsilon tier: answers within ``(1+eps)`` of exact."""
        return Tier("epsilon", eps=float(eps))

    @staticmethod
    def budget(rounds: int) -> "Tier":
        """A budget tier: best answer after ``rounds`` candidate rounds."""
        return Tier("budget", budget_rounds=int(rounds))


def as_tier(tier) -> Tier:
    """Normalize a user-facing tier argument (None, "exact", Tier) to a Tier."""
    if tier is None:
        return Tier.exact()
    if isinstance(tier, Tier):
        return tier
    if tier == "exact":
        return Tier.exact()
    raise ValueError(
        f"tier must be None, 'exact' or a Tier instance, got {tier!r}")


def tier_arrays(tiers, device="cuda") -> tuple:
    """Per-row engine parameters for a sequence of :class:`Tier` values.

    Returns ``((Q,) float32 eps_factor_sq, (Q,) int32 budget_rounds)`` on
    ``device`` (the card unless the caller asks for the CPU; see
    :func:`repro_torch.core.device.resolve_device`): epsilon rows carry the
    squared-space factor ``(1+eps)**2``, budget rows their round budget;
    the others factor 1.0 and an unlimited budget.
    """
    dev = resolve_device(device)
    fac = np.ones((len(tiers),), np.float32)
    bud = np.full((len(tiers),), _BUDGET_UNLIMITED, np.int32)
    for i, t in enumerate(tiers):
        if t.kind == "epsilon":
            fac[i] = (1.0 + t.eps) ** 2
        elif t.kind == "budget":
            bud[i] = t.budget_rounds
    return (torch.tensor(fac, device=dev), torch.tensor(bud, device=dev))


def achieved_epsilon(achieved_factor_sq) -> np.ndarray:
    """Squared-space achieved factor -> achieved epsilon (numpy, host side).

    ``achieved_eps = sqrt(factor) - 1``, clamped at 0; ``inf`` means a budget
    so tight the engine can certify nothing.
    """
    if isinstance(achieved_factor_sq, torch.Tensor):
        achieved_factor_sq = achieved_factor_sq.cpu().numpy()
    f = np.asarray(achieved_factor_sq, np.float64)
    return np.maximum(np.sqrt(np.maximum(f, 1.0)) - 1.0, 0.0)


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """One exact 1-NN answer per query plus the paper's instrumentation."""
    dist_sq: torch.Tensor  # squared distance of the 1-NN
    position: torch.Tensor  # file-order offset of the 1-NN
    raw_reads: torch.Tensor  # series whose raw data was fetched (Fig. 20b)
    bsf_updates: torch.Tensor  # BSF improvements after init (Fig. 20a)
    rounds: int  # candidate rounds executed


def bucket_window_start(bucket_offsets: torch.Tensor, keys: torch.Tensor,
                        leaf_cap: int, num_series: int) -> torch.Tensor:
    """Start row of each query's ``leaf_cap`` seed window, in leaf order.

    The window is centered on the query's root bucket (an empty or small
    bucket degrades to its leaf-order neighbors) and clamped to the array.
    """
    keys = keys.to(torch.int64)
    starts = bucket_offsets[keys]
    ends = bucket_offsets[keys + 1]
    pad = torch.clamp_min(leaf_cap - (ends - starts), 0) // 2
    return torch.clamp(starts - pad, 0, num_series - leaf_cap)


def approx_search_batch(index: ParISIndex, queries, leaf_cap: int = 256,
                        impl: str = "auto") -> tuple:
    """(Q, n) queries -> ((Q,) bsf, (Q,) int32 pos): the bucket-window seed.

    The window's distances go through the ``euclid_sq`` kernel; ties go to
    the first row of the window, as ``argmin`` does in the reference.
    """
    leaf_cap = min(int(leaf_cap), index.num_series)
    qs = isax.znorm(as_f32(queries, index.device))
    qsax = isax.sax_from_paa(isax.paa(qs, index.segments), index.cardinality)
    keys = isax.root_key(qsax, index.cardinality)
    s = bucket_window_start(
        index.bucket_offsets, keys, leaf_cap, index.num_series)
    rows = s.to(torch.int64)[:, None] + torch.arange(
        leaf_cap, device=index.device)
    window = index.pos[rows]  # (Q, leaf_cap) file positions
    d = ops.euclid_sq_gather(qs, index.raw, window, impl=impl)
    j = torch.argmin(d, dim=1, keepdim=True)
    return d.gather(1, j)[:, 0], window.gather(1, j)[:, 0]


def approx_search(index: ParISIndex, query, leaf_cap: int = 256,
                  impl: str = "auto") -> tuple:
    """Single-query :func:`approx_search_batch`: (n,) -> (bsf_sq, position)."""
    d, p = approx_search_batch(
        index, as_f32(query, index.device)[None, :], leaf_cap, impl)
    return d[0], p[0]


def select_len(n: int, round_size: int) -> int:
    """Per-query candidate-list length of the partial selection."""
    return min(n, max(n // 16, 4 * round_size))


# The candidate list is ordered lazily: first the entries of at least
# FIRST_PREFIX_ROUNDS rounds and at least 1/FIRST_PREFIX_SHARE of the list,
# then, each time a round needs more, PREFIX_GROWTH times as many. Every
# ordering reads the whole list, so the first one sorts a share of it that
# costs a fraction of that read and spares a loop of a few rounds the
# reread of an extension.
FIRST_PREFIX_ROUNDS = 2
FIRST_PREFIX_SHARE = 32
PREFIX_GROWTH = 4


class CandidateList:
    """Each query's ``sel_len`` smallest bounds, put in order lazily.

    What the round loop reads of the reference's sorted ``top_k`` list,
    ties toward the lower column: round r's columns and bounds, the head
    bound of round r, and the last selected bound. :func:`ops.select`
    picks the entries, in column order, and each row's last (the k-th
    smallest) bound; :func:`ops.order_range` sorts a prefix of them, first
    :meth:`first_prefix` entries, then ``PREFIX_GROWTH`` times the prefix
    whenever a round reaches past it. Each prefix is a contiguous
    rank range of one total order, so the entries read are those of the
    whole sorted list. The host decides every extension from the round
    number alone: the list reads nothing back. An extension runs under a
    ``paris.engine.select.extend`` span inside ``paris.engine.select``.
    """

    def __init__(self, lb: torch.Tensor, sel_len: int, round_size: int,
                 impl: str):
        self.sel_len = sel_len
        self.round_size = round_size
        self._impl = impl
        self._cols, self._bounds, self.last = ops.select(lb, sel_len,
                                                         impl=impl)
        self._parts = []  # (lo, (Q, hi - lo) columns, bounds), by rank
        self.ordered = 0
        self._order(self.first_prefix(sel_len, round_size))

    @staticmethod
    def first_prefix(sel_len: int, round_size: int) -> int:
        """Entries ordered right after the select: whole rounds, at least
        ``FIRST_PREFIX_ROUNDS`` of them and 1/``FIRST_PREFIX_SHARE`` of the
        list, never past its end."""
        n = max(FIRST_PREFIX_ROUNDS * round_size,
                sel_len // FIRST_PREFIX_SHARE)
        return min(sel_len, -(-n // round_size) * round_size)

    def _order(self, hi: int) -> None:
        prev = ((self._parts[-1][2][:, -1], self._parts[-1][1][:, -1])
                if self._parts else (None, None))
        cols, bounds = ops.order_range(self._bounds, self._cols, self.ordered,
                                       hi, *prev, impl=self._impl)
        self._parts.append((self.ordered, cols, bounds))
        self.ordered = hi

    def _reach(self, end: int) -> None:
        """Order at least the first ``end`` entries (all, past the end)."""
        if end <= self.ordered or self.ordered == self.sel_len:
            return
        rs = self.round_size
        with trace.span("paris.engine.select"):
            with trace.span("paris.engine.select.extend"):
                self._order(min(self.sel_len,
                                max(-(-end // rs) * rs,
                                    PREFIX_GROWTH * self.ordered)))

    def _part(self, i: int) -> tuple:
        for part in reversed(self._parts):
            if part[0] <= i:
                return part
        raise IndexError(i)

    def head(self, r: int) -> torch.Tensor:
        """(Q,) bound of round r's first entry (r * round_size < sel_len)."""
        return self.window(r)[1][:, 0]

    def window(self, r: int) -> tuple:
        """Round r's ((Q, W) columns, (Q, W) bounds), W <= round_size (short
        at the list's end): views of the part that holds them, no copy.
        It orders what :meth:`head` orders: every prefix ends on a whole
        round or the list's end, so the part holding round r's first entry
        holds the round."""
        rs = self.round_size
        i = r * rs
        self._reach(i + 1)
        lo, cols, bounds = self._part(i)
        return cols[:, i - lo:i - lo + rs], bounds[:, i - lo:i - lo + rs]

    def round(self, r: int) -> tuple:
        """Round r's ((Q, rs) columns, (Q, rs) bounds), padded past the
        list's end with column 0 and +inf."""
        cols, bounds = self.window(r)
        rs = self.round_size
        return _cols(cols, 0, rs, 0), _cols(bounds, 0, rs, INF)


def dedup_mask(cand_pos: torch.Tensor, top_d: torch.Tensor,
               top_p: torch.Tensor) -> torch.Tensor:
    """(Q, R) mask of candidates already present in the (Q, k) result list.

    A candidate can only be a duplicate if its position sits in ``top_p``
    with a finite distance; unfilled slots (INF, ``NO_POS``) match nothing.
    """
    return (
        (cand_pos[:, :, None] == top_p[:, None, :])
        & (top_d[:, None, :] < INF)
    ).any(dim=2)


def merge_round(top_d: torch.Tensor, top_p: torch.Tensor,
                cand_pos: torch.Tensor, d: torch.Tensor) -> tuple:
    """The (Q, k) result lists merged with a round's (Q, R) candidates,
    whose distances are +inf outside the round's mask.

    k = 1: argmin and strict improvement (ties keep the incumbent). k > 1:
    a candidate already in the list is dropped (:func:`dedup_mask`), then a
    stable sort, so ties keep the lower column and the incumbent wins.
    """
    k = top_d.shape[1]
    if k == 1:
        j = torch.argmin(d, dim=1, keepdim=True)
        dj = d.gather(1, j)
        better = dj < top_d
        return (torch.where(better, dj, top_d),
                torch.where(better, cand_pos.gather(1, j), top_p))
    d = torch.where(dedup_mask(cand_pos, top_d, top_p), INF, d)
    md = torch.cat([top_d, d], dim=1)
    mp = torch.cat([top_p, cand_pos], dim=1)
    vals, sel = torch.sort(md, dim=1, stable=True)
    return vals[:, :k], mp.gather(1, sel[:, :k])


def merge_top_lists(dists: list, positions: list, k: int) -> tuple:
    """Merge ownership-disjoint (..., k_i) top lists into the global top-k.

    Host-side (numpy), as in the reference: lists are concatenated along
    the last axis in ascending file-offset order and reduced with a stable
    ascending argsort, so ties resolve toward the lower file position and
    sentinel (INF, ``NO_POS``) slots sink.
    """
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    d = np.concatenate([host(x) for x in dists], axis=-1)
    p = np.concatenate([host(x) for x in positions], axis=-1)
    order = np.argsort(d, axis=-1, kind="stable")[..., :k]
    return (
        np.take_along_axis(d, order, axis=-1),
        np.take_along_axis(p, order, axis=-1),
    )


@dataclasses.dataclass(frozen=True)
class EngineView:
    """The storage hooks that specialize the ONE RDC engine core.

      n_rows        candidate rows the LBC pass covers
      num_series    real series behind those rows: :func:`_engine_call`
                    clamps k to it
      segments      PAA word width of the stored SAX rows
      lower_bounds  ((Q, w) query PAA, impl) -> (Q, n_rows) squared lower
                    bounds; padding rows must come back +inf
      positions     candidate row ids -> int32 file positions
      distances     ((Q, n) z-normed queries, positions (Q, R) or shared
                    (R,), impl, (Q, R) bool mask) -> (Q, R) squared
                    distances to the raw rows at those positions; the
                    gather is clipped (NO_POS reads row 0 harmlessly: its
                    +inf bound keeps it out of every mask). Only entries
                    inside ``mask`` are used; the engine sets the others
                    to +inf, so a view may skip their rows (the cold tier
                    reads no row the round's mask discards). The reference
                    splits this into ``gather_raw`` and ``euclid_sq``; the
                    port's kernel fuses the two.
      seed          ((Q, n) queries, impl) -> ((Q,) bsf, (Q,) pos, leaf
                    reads): the approximate-search BSF seed, or None for a
                    cold start at (+inf, ``NO_POS``)
      rows          ((n_rows,) int32 position table, (N, n) raw rows), both
                    on the device, where ``positions`` is a lookup in that
                    table and ``distances`` reads those rows: then each
                    round of the sorted main loop is one
                    :func:`ops.engine_round` (the cold tier, whose rows come
                    from the host, gives None and runs the plain round)
    """

    n_rows: int
    num_series: int
    segments: int
    lower_bounds: Callable
    positions: Callable
    distances: Callable
    seed: Optional[Callable] = None
    rows: Optional[tuple] = None


def _index_view(index: ParISIndex, *, leaf_cap: int) -> EngineView:
    """Single-index hooks: identity positions + approx-seeded BSF. The
    breakpoint upload runs under a ``paris.engine.view`` span."""
    with trace.span("paris.engine.view"):
        bpp = isax.padded_breakpoints(index.cardinality, index.device)
    leaf = min(int(leaf_cap), index.num_series)

    def lower_bounds(qps, impl):
        return ops.lower_bound_sq_batch(
            qps, index.sax, bpp, index.series_length, impl=impl)

    def seed(queries, impl):
        bsf0, pos0 = approx_search_batch(index, queries, leaf, impl)
        return bsf0, pos0, leaf

    return EngineView(
        n_rows=index.num_series,
        num_series=index.num_series,
        segments=index.segments,
        lower_bounds=lower_bounds,
        positions=lambda idx: index.pos[idx.to(torch.int64)],
        distances=lambda qs, pos, impl, mask: ops.euclid_sq_gather(
            qs, index.raw, pos, impl=impl),
        seed=seed,
        rows=(index.pos, index.raw),
    )


def _cols(x: torch.Tensor, start: int, width: int, fill) -> torch.Tensor:
    """Columns [start, start + width) of a (Q, L) tensor, padded with
    ``fill`` past its end."""
    piece = x[:, start:start + width]
    short = width - piece.shape[1]
    if short > 0:
        piece = torch.cat([piece, piece.new_full((x.shape[0], short), fill)],
                          dim=1)
    return piece


def _round_cols(x: torch.Tensor, r: int, rs: int, fill) -> torch.Tensor:
    """Columns [r*rs, (r+1)*rs) of a (Q, L) tensor, padded with ``fill``."""
    return _cols(x, r * rs, rs, fill)


def _round_rows(n_rows: int, r: int, rs: int, device) -> torch.Tensor:
    """Row ids [r*rs, (r+1)*rs) of the row order, padded with row 0."""
    idx = torch.arange(r * rs, (r + 1) * rs, dtype=torch.int64, device=device)
    return torch.where(idx < n_rows, idx, 0)


def _engine_core(
    view: EngineView,
    queries: torch.Tensor,
    *,
    k: int,
    round_size: int,
    sort: bool,
    select: str,
    impl: str,
    eps_factor_sq: Optional[torch.Tensor] = None,
    budget_rounds: Optional[torch.Tensor] = None,
    seed0: Optional[tuple] = None,
) -> tuple:
    """THE batched RDC loop — the single engine core behind every search.

    (Q, n) queries -> ((Q, k) dists, (Q, k) int32 positions, (Q,) reads,
    (Q,) bsf updates, rounds), for 1 <= k <= the view's ``num_series``
    (:func:`_engine_call` clamps it). One host loop drives all Q queries:
    per-query BSF vector, per-query candidate order, per-query round masks,
    and a joint early exit once no query's next lower bound beats its k-th
    best.

    ``select="topk"`` keeps only the ``select_len`` smallest bounds per
    query; exactness is kept by a fallback scan over the full row order that
    runs only for queries whose last selected bound still beats their k-th
    best when the list is used up. For k > 1 every merge masks candidates
    already in the result list (:func:`dedup_mask`). ``sort=False`` is the
    ADS+-style serial scan (row order, no early exit).

    Every round is one round step: its exit test, mask, distances, counters
    and (k = 1) merge, after which the host reads its exit flag back; k > 1
    merges its masked distances here. Where the view gives its device
    ``rows``, a main-loop round is one :func:`ops.engine_round`; otherwise,
    and in the fallback, the plain round (``kernels.ref.engine_round``)
    runs over the view's ``positions`` and ``distances``. Rounds, reads,
    updates and answers are the same either way.

    Passing ``eps_factor_sq`` and ``budget_rounds`` ((Q,) tensors,
    :func:`tier_arrays`) runs the TIERED variant, which returns a sixth
    output, the per-query achieved squared error factor; tiers require
    ``sort=True``. Without them the engine is the exact path.

    The BSF starts from ``seed0 = ((Q,) dist, (Q,) pos)`` when given (reads
    start at 0), else from the view's seed hook (reads start at its window
    size), else cold at (+inf, ``NO_POS``) with reads at 0.
    """
    tiered = eps_factor_sq is not None
    if tiered and not sort:
        raise ValueError("service tiers require the sorted-candidate "
                         "engine (sort=True)")
    with trace.span("paris.engine"):
        dev = queries.device
        n_rows = view.n_rows
        n_q = queries.shape[0]
        rs = round_size
        with trace.span("paris.engine.prep"):
            qs = isax.znorm(queries)
            qps = isax.paa(qs, view.segments)

        # Result lists: slot 0 holds the seed (if any), the rest
        # (INF, NO_POS).
        top_d = torch.full((n_q, k), INF, device=dev)
        top_p = torch.full((n_q, k), NO_POS, dtype=torch.int32, device=dev)
        reads0 = 0
        if seed0 is None and view.seed is not None:
            with trace.span("paris.engine.seed"):
                bsf0, pos0, reads0 = view.seed(queries, impl)
            seed0 = (bsf0, pos0)
        if seed0 is not None:
            top_d[:, 0] = seed0[0]
            top_p[:, 0] = seed0[1].to(torch.int32)
        reads = torch.full((n_q,), reads0, dtype=torch.int32, device=dev)
        updates = torch.zeros((n_q,), dtype=torch.int32, device=dev)
        skip_lb = torch.full((n_q,), INF, device=dev) if tiered else None

        # --- LBC phase: ONE fused (Q, n_rows) pass over the SAX rows. ---
        with trace.span("paris.engine.bounds"):
            lb = view.lower_bounds(qps, impl)

        # --- Per-query candidate orders, ties toward the lower row. ---
        if sort:
            sel_len = select_len(n_rows, rs) if select == "topk" else n_rows
            with trace.span("paris.engine.select"):
                cands = CandidateList(lb, sel_len, rs, impl)
        else:
            sel_len = n_rows
        n_rounds = -(-sel_len // rs)

        def read_back(flag) -> bool:
            # The one host readback of a round: it waits for the device.
            with trace.span("paris.engine.sync"):
                return bool(flag)

        # Round hooks for the plain round (ref.engine_round): positions of
        # each query's own columns (the candidate list), or of one row
        # order shared by every query (the serial scan, the fallback).
        per_query = (view.positions,
                     lambda q, pos, mask: view.distances(q, pos, impl, mask))
        shared = (lambda c: view.positions(c[0]).expand(n_q, -1),
                  lambda q, pos, mask: view.distances(q, pos[0], impl, mask))
        tiers = (eps_factor_sq, budget_rounds, skip_lb)
        # the round kernel's words, then the exit flag
        state = torch.zeros((3 * n_q + 2,), dtype=torch.int64, device=dev)

        def step(cols, bounds, r, hooks, head=None, test=True) -> bool:
            """One round: ops.engine_round over the view's device rows
            (``hooks`` None), else the plain round over ``hooks``; then the
            exit flag read back (``test``) and the k > 1 merge. False where
            the round's exit test failed, and nothing changed."""
            nonlocal top_d, top_p
            out = ((torch.empty((n_q, rs), device=dev),
                    torch.empty((n_q, rs), dtype=torch.int32, device=dev))
                   if k > 1 else (None, None))
            if hooks is None:
                ops.engine_round(cols, bounds, r, rs, view.rows, qs, top_d,
                                 top_p, reads, updates, state, tiers=tiers,
                                 out=out, impl=impl)
            else:
                kref.engine_round(cols, bounds, r, rs, *hooks, qs, top_d,
                                  top_p, reads, updates, state, *tiers, *out,
                                  head=head)
            if test and not read_back(state[-1]):
                return False
            if k > 1:
                top_d, top_p = merge_round(top_d, top_p, out[1], out[0])
            return True

        def row_order(r):  # round r of the row order, as every query's
            return _round_rows(n_rows, r, rs, dev)[None].expand(n_q, -1)

        main = None if view.rows is not None else per_query
        no_test = torch.full((n_q,), -INF, device=dev)  # passes every test
        r = 0
        while r < n_rounds:
            with trace.span("paris.engine.round"):
                if sort:  # joint early exit: every next bound >= its BSF
                    if not step(*cands.window(r), r, main):
                        break
                else:  # the serial scan: every round, no exit test
                    step(row_order(r), _round_cols(lb, r, rs, INF), r,
                         shared, head=no_test, test=False)
                r += 1
        r_main = r

        fb_r2 = None
        if sort and select == "topk" and sel_len < n_rows:
            # Exactness fallback: a query whose last *selected* bound still
            # beats its BSF might have unselected qualifying candidates —
            # scan the full row order, with that bound as each query's
            # head, re-evaluated every round. In the common case no query
            # needs it and the loop stops before its first round.
            kth_bound = cands.last
            all_rounds = -(-n_rows // rs)
            r2 = 0
            while r2 < all_rounds:
                with trace.span("paris.engine.fallback_round"):
                    # The test comes first: in the common case it fails
                    # at once, and the round's work is not launched.
                    if not read_back(kref.exit_test(
                            kth_bound, top_d[:, -1], r_main + r2,
                            eps_factor_sq, budget_rounds)):
                        break
                    # A bound below the K-th skips a candidate the main loop
                    # already had (everything strictly below it was
                    # selected); ties at the bound re-distance harmlessly.
                    lbs = _round_cols(lb, r2, rs, INF)
                    lbs = torch.where(lbs >= kth_bound[:, None], lbs, INF)
                    step(row_order(r2), lbs, r_main + r2, shared,
                         head=kth_bound, test=False)
                    r2 += 1
            fb_r2 = r2
            r = r + r2

        if tiered:
            # Achieved squared error factor: the BSF over the smallest lower
            # bound never distance-checked — (a) tier-skipped candidates
            # (skip_lb), (b) the unprocessed tail of the selected list (its
            # head bound, the frontier), (c) under select="topk", unselected
            # rows the fallback never reached (charged only when it did not
            # scan the whole row order). If that minimum still meets the BSF
            # the answer is certified exact (factor 1.0).
            kth_final = top_d[:, -1]
            if r_main < n_rounds:
                denom = torch.minimum(skip_lb, cands.head(r_main))
            else:
                denom = skip_lb
            if fb_r2 is not None and fb_r2 < all_rounds:
                denom = torch.minimum(denom, kth_bound)
            one = torch.ones((), device=dev)
            achieved_sq = torch.where(denom >= kth_final, one,
                                      kth_final / denom)
            return top_d, top_p, reads, updates, r, achieved_sq

        return top_d, top_p, reads, updates, r


def _queries(store, queries) -> torch.Tensor:
    """(Q, n) float32 queries on the device of an index or packed store."""
    qs = as_f32(queries, store.device)
    if qs.dim() != 2 or qs.shape[1] != store.series_length:
        raise ValueError(
            f"queries must be (Q, {store.series_length}), got {tuple(qs.shape)}")
    return qs


def _tier_list(tier, n_q: int) -> list:
    """One :class:`Tier` per query from one tier or a sequence of them."""
    if isinstance(tier, (Tier, str)) or tier is None:
        return [as_tier(tier)] * n_q
    tiers = [as_tier(t) for t in tier]
    if len(tiers) != n_q:
        raise ValueError(f"got {len(tiers)} tiers for {n_q} queries")
    return tiers


def _pad_missing(top_d, top_p, k: int):
    # Tiny index (k > num_series): sentinel-pad the missing neighbors.
    short = k - top_d.shape[1]
    if short <= 0:
        return top_d, top_p
    n_q = top_d.shape[0]
    return (torch.cat([top_d, top_d.new_full((n_q, short), INF)], dim=1),
            torch.cat([top_p, top_p.new_full((n_q, short), NO_POS)], dim=1))


def _engine_call(store, view: EngineView, queries, *, k: int,
                 round_size: int, select: str, impl: str, sort: bool = True,
                 tier=None, seed: Optional[tuple] = None,
                 pad: int = 0) -> tuple:
    """The call protocol of every store's entries around :func:`_engine_core`.

    ``queries`` must be (Q, n) for ``store`` (an index, a packed store or a
    cold shard) and on its device. ``k < 1`` raises; a larger k than the
    view's ``num_series`` is answered with the real neighbors and (INF,
    ``NO_POS``) in the remaining slots. ``tier=None`` runs the exact
    engine; otherwise ``tier`` is one :class:`Tier` or one a query, and the
    last ``pad`` rows of ``queries``, which only fill a bucket
    (:func:`_batch_engine`), get factor 1 and a zero round budget: inert
    rows, which never extend the loop. ``seed`` is a ``((Q,) dist, (Q,)
    pos)`` BSF seed; without one the view's seed hook seeds the BSF, or it
    starts cold at (+inf, ``NO_POS``).

    Returns ((Q, k) dists ascending, (Q, k) int32 positions, (Q,) reads,
    (Q,) bsf updates, rounds) and, tiered, the (Q,) numpy achieved epsilon.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    qs = _queries(store, queries)
    if view.num_series < 1:
        raise ValueError("the store holds no series")
    tier_rows = {}
    if tier is not None:
        eps_f, budget = tier_arrays(_tier_list(tier, qs.shape[0] - pad),
                                    qs.device)
        if pad:
            eps_f = torch.cat([eps_f, eps_f.new_ones(pad)])
            budget = torch.cat([budget, budget.new_zeros(pad)])
        tier_rows = dict(eps_factor_sq=eps_f, budget_rounds=budget)
    if seed is not None:
        seed = (as_f32(seed[0], qs.device),
                torch.as_tensor(seed[1], device=qs.device).to(torch.int32))
    top_d, top_p, *rest = _engine_core(
        view, qs, k=min(k, view.num_series), round_size=round_size,
        sort=sort, select=select, impl=impl, seed0=seed, **tier_rows)
    top_d, top_p = _pad_missing(top_d, top_p, k)
    if tier is not None:
        rest[-1] = achieved_epsilon(rest[-1])
    return (top_d, top_p, *rest)


def knn_batch_tiered(
    index: ParISIndex,
    queries,
    tier,
    k: int = 1,
    round_size: int = 4096,
    impl: str = "auto",
    select: str = "topk",
    leaf_cap: int = 256,
) -> tuple:
    """Tiered batched k-NN over one index (see :class:`Tier`).

    (Q, n) queries -> ((Q, k) dists ascending, (Q, k) positions,
    (Q,) numpy achieved epsilon). ``tier`` is one value for the whole batch
    or a sequence of per-query :class:`Tier` values. Runs on the index's
    device.
    """
    top_d, top_p, *_, eps = _engine_call(
        index, _index_view(index, leaf_cap=leaf_cap), queries, k=k,
        round_size=round_size, select=select, impl=impl, tier=tier)
    return top_d, top_p, eps


# --- The packed multi-component path: base + runs + deltas in one sweep. ---

# Rows per block of the packed layout: the lb_multi registry default.
DEFAULT_PACK_BLOCK = tuning.KERNELS["lb_multi"].defaults["block_n"]


def _pack_block(block: Optional[int], num_series: int, device) -> int:
    """The packed layout's ``block_n``: ``block``, else the tuning table's.

    The block is a layout baked into the buffer (appends extend it in
    block units), so a store resolves it once: the ``lb_multi`` entry for
    Q = ``tuning.PACK_Q``, its canonical batch, and ``num_series`` on
    ``device``; :data:`DEFAULT_PACK_BLOCK`, 128, on a miss, as on the CPU.
    """
    if block is not None:
        return block
    return tuning.resolve_blocks("lb_multi", q=tuning.PACK_Q,
                                 n=max(num_series, 1),
                                 device=device)["block_n"]


@dataclasses.dataclass(frozen=True)
class PackedComponents:
    """A multi-component store (base + runs + deltas) packed for ONE sweep.

    Each component's leaf-sorted SAX rows are padded to a ``block``
    multiple and concatenated in ascending file-offset order, so the fused
    lower-bound kernel (:func:`ops.lower_bound_sq_multi`) covers the whole
    store in one (Q, N_pad) pass. The block alignment means appending a
    component only appends blocks: earlier components' rows never move.
    ``gpos`` maps packed rows to global file positions (:data:`NO_POS` at
    pad rows, so a pad that reaches a result list is already the
    sentinel), ``block_len`` is the kernel's per-block count of real rows
    (0 for a dead tail block), and ``raw`` is the file-order concatenation
    of the components' raws (they cover contiguous, adjacent file ranges),
    which candidate gathers index directly by global position.
    """

    sax: torch.Tensor  # (N_pad, w) uint8, per-component leaf order
    gpos: torch.Tensor  # (N_pad,) int32 global file positions; NO_POS at pads
    block_len: torch.Tensor  # (N_pad // block,) int32 real rows per block
    raw: torch.Tensor  # (N_total, n) f32, file order
    num_series: int  # real rows (N_total)
    block: int
    series_length: int
    segments: int
    cardinality: int

    @property
    def device(self) -> torch.device:
        """The device every array of the store lives on."""
        return self.sax.device


def pack_one_component(ix: ParISIndex, off: int, block: int) -> tuple:
    """One component's packed parts: (sax, gpos, block_len) on its device.

    The per-component packing primitive of :func:`pack_components`: the
    rows padded to a ``block`` multiple with zero symbols, ``NO_POS``
    positions and a short last block.
    """
    m = ix.num_series
    pad = (-m) % block
    sax = ix.sax
    gp = ix.pos + off
    if pad:
        sax = torch.cat([sax, sax.new_zeros((pad, sax.shape[1]))])
        gp = torch.cat([gp, gp.new_full((pad,), NO_POS)])
    bl = torch.full(((m + pad) // block,), block, dtype=torch.int32,
                    device=ix.device)
    if pad:
        bl[-1] = block - pad
    return sax, gp.to(torch.int32), bl


def pack_components(components, block: Optional[int] = None
                    ) -> PackedComponents:
    """Pack (index, file offset) components for the fused multi-sweep.

    ``components`` must come in ascending offset order and cover
    contiguous, adjacent file ranges starting at 0. Zero-series components
    are skipped. ``block=None`` resolves the layout's ``block_n`` through
    the tuning table for the store's total size on the components' device
    (:func:`_pack_block`).
    """
    comps = [(ix, off) for ix, off in components if ix.num_series]
    if not comps:
        raise ValueError("pack_components needs at least one nonempty "
                         "component")
    block = _pack_block(block, sum(ix.num_series for ix, _ in comps),
                        comps[0][0].device)
    expect = 0
    for ix, off in comps:
        if off != expect:
            raise ValueError(
                f"components not contiguous: offset {off}, expected "
                f"{expect}")
        expect += ix.num_series
    parts = [pack_one_component(ix, off, block) for ix, off in comps]
    first = comps[0][0]
    return PackedComponents(
        sax=torch.cat([p[0] for p in parts]),
        gpos=torch.cat([p[1] for p in parts]),
        block_len=torch.cat([p[2] for p in parts]),
        raw=torch.cat([ix.raw for ix, _ in comps]),
        num_series=expect,
        block=block,
        series_length=first.series_length,
        segments=first.segments,
        cardinality=first.cardinality,
    )


def _packed_view(packed: PackedComponents) -> EngineView:
    """Packed-buffer hooks: the fused multi-component sweep over the core.

    ONE masked lower-bound pass over the packed SAX buffer, candidate
    positions through the ``gpos`` translation, distances to the
    file-order raw rows at those global positions (``NO_POS`` and
    dead-block rows clip to row 0 harmlessly: their +inf bound keeps them
    out of every mask). No seed hook: a packed buffer has no global
    bucket table, so the BSF starts at +inf unless the caller seeds it.
    """
    bpp = isax.padded_breakpoints(packed.cardinality, packed.device)

    def lower_bounds(qps, impl):
        return ops.lower_bound_sq_multi(
            qps, packed.sax, bpp, packed.series_length, packed.block_len,
            impl=impl, block_n=packed.block)

    return EngineView(
        n_rows=packed.sax.shape[0],
        num_series=packed.num_series,
        segments=packed.segments,
        lower_bounds=lower_bounds,
        positions=lambda idx: packed.gpos[idx.to(torch.int64)],
        distances=lambda qs, pos, impl, mask: ops.euclid_sq_gather(
            qs, packed.raw, pos, impl=impl),
        seed=None,
        rows=(packed.gpos, packed.raw),
    )


def packed_engine_args(
    sax: torch.Tensor,
    gpos: torch.Tensor,
    block_len: torch.Tensor,
    raw: torch.Tensor,
    queries: torch.Tensor,
    *,
    block: int,
    series_length: int,
    segments: int,
    cardinality: int,
    k: int,
    round_size: int,
    select: str = "topk",
    impl: str = "auto",
    eps_factor_sq: Optional[torch.Tensor] = None,
    budget_rounds: Optional[torch.Tensor] = None,
    seed_d: Optional[torch.Tensor] = None,
    seed_p: Optional[torch.Tensor] = None,
) -> tuple:
    """The fused packed engine over buffers passed as arguments.

    The buffers may be capacity-padded (dead tail blocks with
    ``block_len == 0``). The engine core runs as given: callers clamp
    ``k`` themselves, since the store's real size is not known here.
    Tiered calls pass ``eps_factor_sq``/``budget_rounds``
    (:func:`tier_arrays`) and get the 6-tuple, the squared factor last;
    ``seed_d``/``seed_p`` optionally seed each query's BSF with a
    (distance, global position) pair (:func:`packed_seed`).
    """
    packed = PackedComponents(
        sax=sax, gpos=gpos, block_len=block_len, raw=raw,
        num_series=raw.shape[0],  # an upper bound; the core reads no count
        block=block, series_length=series_length, segments=segments,
        cardinality=cardinality)
    seed0 = None if seed_d is None else (seed_d, seed_p)
    return _engine_core(
        _packed_view(packed), as_f32(queries, sax.device), k=k,
        round_size=round_size, sort=True, select=select, impl=impl,
        eps_factor_sq=eps_factor_sq, budget_rounds=budget_rounds,
        seed0=seed0)


def exact_knn_batch_packed(
    packed: PackedComponents,
    queries,
    k: int = 1,
    round_size: int = 4096,
    impl: str = "auto",
    select: str = "topk",
    stats: bool = False,
) -> tuple:
    """Batched exact k-NN over a packed multi-component store.

    One fused lower-bound pass and one RDC loop for base + runs + deltas
    together; positions are global file offsets. Same clamp/sentinel
    protocol as :func:`exact_knn_batch`, and the same answers as that
    function over one index built from the concatenated data.
    """
    out = _engine_call(packed, _packed_view(packed), queries, k=k,
                       round_size=round_size, select=select, impl=impl)
    return out if stats else out[:2]


def packed_seed(components, queries, leaf_cap: int = 256) -> tuple:
    """Approximate BSF seed for a packed engine call.

    The packed view has no global bucket table; this seeds each query from
    the bucket table of the LARGEST live component (the first of equal
    size), with positions translated to global file offsets. Returns
    ``((Q,) float32 distances, (Q,) int32 global positions)``: true
    distances at real positions, so the engine's dedup keeps the result
    list duplicate-free when it meets them again.
    """
    comps = [(ix, off) for ix, off in components if ix.num_series]
    if not comps:
        raise ValueError("packed_seed needs at least one nonempty "
                         "component")
    ix, off = max(comps, key=lambda c: c[0].num_series)
    seed_d, seed_p = approx_search_batch(
        ix, queries, min(int(leaf_cap), ix.num_series))
    return seed_d, seed_p.to(torch.int32) + off


def knn_batch_packed_tiered(
    packed: PackedComponents,
    queries,
    tier,
    k: int = 1,
    round_size: int = 4096,
    impl: str = "auto",
    select: str = "topk",
    seed: Optional[tuple] = None,
) -> tuple:
    """Tiered batched k-NN over a packed multi-component store.

    Same contract as :func:`knn_batch_tiered`, over the fused packed
    sweep. ``seed`` is an optional ``((Q,) dist, (Q,) global pos)`` BSF
    seed (:func:`packed_seed`); without one the BSF starts at
    (+inf, ``NO_POS``), which weakens (never breaks) the budget tier's
    achieved bounds.
    """
    top_d, top_p, *_, eps = _engine_call(
        packed, _packed_view(packed), queries, k=k, round_size=round_size,
        select=select, impl=impl, tier=tier, seed=seed)
    return top_d, top_p, eps


def exact_search_batch_packed(
    packed: PackedComponents,
    queries,
    cfg: SearchConfig = SearchConfig(),
) -> SearchResult:
    """Batched exact 1-NN over a packed multi-component store.

    Only the sorted-candidate engine exists for the packed layout:
    ``cfg.sort=False`` (the serial scan) is refused rather than answered by
    another algorithm.
    """
    if not cfg.sort:
        raise ValueError(
            "the packed engine has no sort=False (serial-scan) mode; use "
            "the per-component path")
    top_d, top_p, *rest = _engine_call(
        packed, _packed_view(packed), queries, k=1,
        round_size=cfg.round_size, select=cfg.select, impl=cfg.impl)
    return SearchResult(top_d[:, 0], top_p[:, 0], *rest)


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo)."""
    return 1 << (max(n, lo) - 1).bit_length()


def make_batch_engine(
    index: ParISIndex,
    *,
    k: Optional[int] = None,
    round_size: int = 4096,
    leaf_cap: int = 256,
    sort: bool = True,
    select: str = "topk",
    impl: str = "auto",
    min_bucket: int = 1,
):
    """A reusable batch engine over one index with power-of-two Q buckets.

    Any (Q, n) call is padded up to ``pow2_bucket(Q, min_bucket)`` rows
    (pad rows repeat row 0 and are discarded), so streaming callers see
    the shapes the reference's jitted engines see.

    ``k=None``: exact 1-NN, returns a ``SearchResult`` of (Q,) tensors.
    ``k >= 1``: exact k-NN, returns ((Q, k) dists ascending, (Q, k) pos).
    ``engine(queries, tiers=[...])`` (k-NN mode only) answers each row at
    its own tier and returns a third array, the achieved epsilon; pad rows
    get factor 1 and a zero round budget, so they never extend the loop.
    ``engine.bucket(qn)`` is the padded batch size of a Q-query call.
    """
    return _batch_engine(
        index, lambda: _index_view(index, leaf_cap=leaf_cap), k=k,
        round_size=round_size, sort=sort, select=select, impl=impl,
        min_bucket=min_bucket)


def _batch_engine(store, view_of: Callable, *, k, round_size, sort, select,
                  impl, min_bucket):
    """:func:`make_batch_engine` over any store: ``view_of()`` builds the
    store's :class:`EngineView` for a call (the in-memory index's, or the
    cold tier's over a ``ColdShard``)."""
    if k is not None and k < 1:
        raise ValueError(f"k must be None (1-NN mode) or >= 1, got {k}")

    def bucket(qn: int) -> int:
        return pow2_bucket(qn, min_bucket)

    def engine(queries, tiers=None):
        qs = _queries(store, queries)
        qn = qs.shape[0]
        if tiers is not None:
            tiers = _tier_list(tiers, qn)
            if all(t.kind == "exact" for t in tiers):
                tiers = None  # pure-exact batch: the exact path
            elif k is None:
                raise ValueError(
                    "service tiers need k-NN mode (k >= 1); the 1-NN "
                    "SearchResult mode answers tier='exact' only")
        b = bucket(qn)
        if b > qn:  # pad rows repeat a real query; sliced off below
            qs = torch.cat([qs, qs[:1].expand(b - qn, -1)])
        top_d, top_p, reads, updates, rounds, *eps = _engine_call(
            store, view_of(), qs, k=1 if k is None else k,
            round_size=round_size, sort=sort, select=select, impl=impl,
            tier=tiers, pad=b - qn)
        if tiers is not None:
            return top_d[:qn], top_p[:qn], eps[0][:qn]
        if k is None:
            return SearchResult(
                top_d[:qn, 0], top_p[:qn, 0], reads[:qn], updates[:qn],
                rounds)
        return top_d[:qn], top_p[:qn]

    engine.bucket = bucket
    engine.index = store
    engine.k = k
    return engine


def exact_search_batch(
    index: ParISIndex, queries, cfg: SearchConfig = SearchConfig()
) -> SearchResult:
    """Batched ParIS+ exact 1-NN: (Q, n) queries -> SearchResult of (Q,)."""
    top_d, top_p, *rest = _engine_call(
        index, _index_view(index, leaf_cap=cfg.leaf_cap), queries, k=1,
        round_size=cfg.round_size, sort=cfg.sort, select=cfg.select,
        impl=cfg.impl)
    return SearchResult(top_d[:, 0], top_p[:, 0], *rest)


def exact_knn_batch(
    index: ParISIndex,
    queries,
    k: int = 1,
    round_size: int = 4096,
    impl: str = "auto",
    select: str = "topk",
    sort: bool = True,
    leaf_cap: int = 256,
    stats: bool = False,
) -> tuple:
    """Batched exact k-NN: (Q, n) -> ((Q, k) dists ascending, (Q, k) pos).

    Runs on the index's device. ``k < 1`` raises; ``k > num_series`` is
    answered with the real neighbors and (INF, ``NO_POS``) in the remaining
    slots. ``stats=True`` appends the per-query (raw_reads, bsf_updates)
    and the round count.
    """
    out = _engine_call(
        index, _index_view(index, leaf_cap=leaf_cap), queries, k=k,
        round_size=round_size, sort=sort, select=select, impl=impl)
    return out if stats else out[:2]


def exact_search(
    index: ParISIndex, query, cfg: SearchConfig = SearchConfig()
) -> SearchResult:
    """ParIS+ exact 1-NN of one (n,) query (``cfg.sort=False``: serial scan)."""
    res = exact_search_batch(index, as_f32(query, index.device)[None, :], cfg)
    return SearchResult(res.dist_sq[0], res.position[0], res.raw_reads[0],
                        res.bsf_updates[0], res.rounds)


def exact_knn(
    index: ParISIndex,
    query,
    k: int = 1,
    round_size: int = 4096,
    impl: str = "auto",
    select: str = "topk",
) -> tuple:
    """Exact k-NN of one (n,) query: ((k,) dists ascending, (k,) positions)."""
    top_d, top_p = exact_knn_batch(
        index, as_f32(query, index.device)[None, :], k=k,
        round_size=round_size, impl=impl, select=select)
    return top_d[0], top_p[0]


# --- The paper's single-query algorithms: ParIS+, nb-ParIS+, UCR-Suite. ---


def _query(index: ParISIndex, query) -> torch.Tensor:
    q = as_f32(query, index.device)
    if q.shape != (index.series_length,):
        raise ValueError(
            f"query must be ({index.series_length},), got {tuple(q.shape)}")
    return q


def _query_paa(index: ParISIndex, query: torch.Tensor) -> tuple:
    q = isax.znorm(query)
    return q, isax.paa(q, index.segments)


def _pad_to(x: torch.Tensor, size: int, fill) -> torch.Tensor:
    pad = size - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x.new_full((pad,), fill)])


def _exact_search_impl(
    index: ParISIndex,
    query: torch.Tensor,
    *,
    round_size: int,
    leaf_cap: int,
    sort: bool,
    impl: str,
) -> SearchResult:
    n_series = index.num_series
    rs = round_size
    with trace.span("paris.single"):
        with trace.span("paris.single.prep"):
            q, qp = _query_paa(index, query)
        with trace.span("paris.single.seed"):
            bsf, bsfpos = approx_search(index, query, leaf_cap, impl)
            bsfpos = bsfpos.to(torch.int32)

        # --- LBC phase: one pass over the whole SAX array. ---
        with trace.span("paris.single.bounds"):
            bpp = isax.padded_breakpoints(index.cardinality, index.device)
            lb = ops.lower_bound_sq(qp, index.sax, bpp, index.series_length,
                                    impl=impl)

        # --- Candidate list (sorted for ParIS+; SAX order for the ADS+ mode). ---
        n_rounds = -(-n_series // rs)
        with trace.span("paris.single.sort"):
            if sort:
                order = torch.argsort(lb, stable=True)  # jnp.argsort is stable
                lb_sorted = lb[order]
            else:
                order = torch.arange(n_series, device=index.device)
                lb_sorted = lb
            order = _pad_to(order, n_rounds * rs, 0)
            lb_sorted = _pad_to(lb_sorted, n_rounds * rs, INF)

        # --- RDC phase: rounds of fused gather + distance against one BSF. ---
        reads = torch.tensor(leaf_cap, dtype=torch.int32, device=index.device)
        updates = torch.zeros((), dtype=torch.int32, device=index.device)
        r = 0
        while r < n_rounds:
            with trace.span("paris.single.round"):
                # A sorted list: everything past a pruned head is pruned too.
                if sort:
                    with trace.span("paris.single.sync"):
                        go = bool(lb_sorted[r * rs] < bsf)
                    if not go:
                        break
                lbs = lb_sorted[r * rs:(r + 1) * rs]
                mask = lbs < bsf
                cand_pos = index.pos[order[r * rs:(r + 1) * rs]]
                d = ops.euclid_sq_gather(q[None, :], index.raw, cand_pos,
                                         impl=impl)[0]  # the "disk reads"
                d = torch.where(mask, d, INF)
                j = torch.argmin(d)
                better = d[j] < bsf
                bsf = torch.where(better, d[j], bsf)
                bsfpos = torch.where(better, cand_pos[j], bsfpos)
                reads = reads + mask.sum(dtype=torch.int32)
                updates = updates + better.to(torch.int32)
                r += 1
    return SearchResult(bsf, bsfpos, reads, updates, r)


def exact_search_single(
    index: ParISIndex, query, cfg: SearchConfig = SearchConfig()
) -> SearchResult:
    """ParIS+ with the original one-query engine (full argsort candidates).

    One (n,) query on the index's device: the approximate seed, one
    lower-bound pass over all N rows, a stable argsort of the bounds, then
    rounds of ``cfg.round_size`` candidates against one BSF until the
    sorted head reaches it (``cfg.sort=False``: every round, in SAX order).
    The baseline the batch engine is measured against.
    """
    return _exact_search_impl(
        index, _query(index, query), round_size=cfg.round_size,
        leaf_cap=cfg.leaf_cap, sort=cfg.sort, impl=cfg.impl)


def _nb_exact_search_impl(
    index: ParISIndex,
    query: torch.Tensor,
    *,
    round_size: int,
    leaf_cap: int,
    workers: int,
    impl: str,
) -> SearchResult:
    n_series = index.num_series
    rs = round_size
    dev = index.device
    q, qp = _query_paa(index, query)
    bsf0, pos0 = approx_search(index, query, leaf_cap, impl)
    bpp = isax.padded_breakpoints(index.cardinality, dev)
    lb = ops.lower_bound_sq(qp, index.sax, bpp, index.series_length,
                            impl=impl)

    # Worker w scans rows [w * rounds * rs, (w + 1) * rounds * rs) in SAX
    # order, round by round, against its own BSF: no sharing, no sort.
    per = -(-n_series // workers)
    rounds = -(-per // rs)
    padded = workers * rounds * rs
    idx_blocks = _pad_to(torch.arange(n_series, device=dev), padded,
                         0).reshape(workers, rounds, rs)
    lb_blocks = _pad_to(lb, padded, INF).reshape(workers, rounds, rs)
    qw = q[None, :].expand(workers, -1)
    bsf = bsf0.expand(workers).clone()
    pos = pos0.to(torch.int32).expand(workers).clone()
    reads = torch.zeros((workers,), dtype=torch.int32, device=dev)
    updates = torch.zeros((workers,), dtype=torch.int32, device=dev)
    for r in range(rounds):  # the reference's scan: no read-back per round
        lbs = lb_blocks[:, r]
        mask = lbs < bsf[:, None]  # local BSF only (nb- semantics)
        cand_pos = index.pos[idx_blocks[:, r]]  # (workers, rs)
        d = torch.where(mask, ops.euclid_sq_gather(qw, index.raw, cand_pos,
                                                   impl=impl), INF)
        j = torch.argmin(d, dim=1, keepdim=True)
        dj = d.gather(1, j)[:, 0]
        better = dj < bsf
        bsf = torch.where(better, dj, bsf)
        pos = torch.where(better, cand_pos.gather(1, j)[:, 0], pos)
        reads = reads + mask.sum(dim=1, dtype=torch.int32)
        updates = updates + better.to(torch.int32)
    j = torch.argmin(bsf)  # the first worker on ties
    return SearchResult(
        bsf[j], pos[j], reads.sum(dtype=torch.int32) + leaf_cap,
        updates.sum(dtype=torch.int32), rounds)


def nb_exact_search(
    index: ParISIndex, query, cfg: SearchConfig = SearchConfig()
) -> SearchResult:
    """nb-ParIS+: ``cfg.workers`` independent workers, local BSFs (Fig. 8).

    ``rounds`` is the per-worker round count; ``raw_reads`` sums every
    worker's reads plus the seed window.
    """
    return _nb_exact_search_impl(
        index, _query(index, query), round_size=cfg.round_size,
        leaf_cap=cfg.leaf_cap, workers=cfg.workers, impl=cfg.impl)


def brute_force(index: ParISIndex, query, impl: str = "auto") -> SearchResult:
    """UCR-Suite analogue: one fused scan of every raw row, no index.

    On the card the ``euclid_min`` kernel reduces the N distances to the
    first row at the smallest one without writing them out.
    """
    q = isax.znorm(_query(index, query))
    d, j = ops.euclid_min(q, index.raw, impl=impl)
    n = torch.tensor(index.num_series, dtype=torch.int32, device=index.device)
    one = torch.ones((), dtype=torch.int32, device=index.device)
    return SearchResult(d, j, n, one, 1)
