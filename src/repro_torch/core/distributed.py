"""Mesh-distributed ParIS+ search and build over ``torch.distributed``.

Counterpart of ``repro/core/distributed.py``. The paper maps onto ranks as
the reference maps it onto devices:

  * every rank is one LBC+RDC worker pair over its own partition of N: the
    SAX array, the index-ordered raw data and the position map are cut
    along N into equal contiguous shards (:func:`shard_of`);
  * the paper's atomically updated shared BSF becomes a per-round
    ``all_reduce(MIN)`` over the group: each round every rank distances one
    tile of its own sorted candidate list, then the BSF is agreed before
    the next round;
  * nb-ParIS+ (local BSFs, Fig. 8) is ``shared_bsf=False``: ranks scan
    independently and agree once at the end;
  * early termination compares the *global* minimum unprocessed bound with
    the BSF, so every rank runs the same number of rounds.

The reference runs each rank's body under ``shard_map``, with its loops as
``while_loop``s whose ``cond`` issues a collective on every device in every
iteration. Here each loop is a host loop, and each of its decisions is a
host read of a value that a collective has just made equal on every rank.
So every rank issues the same collectives in the same order; a rank that
took another branch would leave the others waiting in a collective until
the group's timeout ends the run. The shard sizes are equal (the padding
of :func:`dist_index_from`), so every loop bound agrees too.

``NamedSharding`` and ``index_shardings`` have no counterpart: the port
does not place one global array over devices. :func:`shard_of` hands each
rank its rows as views, and :func:`spawn_mesh` starts the ranks (the
counterpart of ``jax.make_mesh`` over forced host devices). Every mesh in
the repository is 1-D (``("shard",)``), so the reference's loop over
``axis_names`` is one process group here.

The reference gathers every candidate row into round order before its
loops, only to avoid a gather bug of older JAX inside ``shard_map``; the
port distances the same rows in place with ``ops.euclid_sq_gather``, with
per-query ``(Q, R)`` row ids in the main loops and shared ``(R,)`` row ids
in the file-order fallbacks, so no ``(Q, padded, n)`` copy is made. A
selected list (``select="topk"`` and the batch bodies) is the single-host
engine's ``search.CandidateList``, ordered one prefix at a time as the
round loop reaches it; ``select="sort"`` keeps the full stable argsort.
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import queue as queue_mod
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.paris import CONFIG
from repro_torch.core import isax
from repro_torch.core.device import as_f32, resolve_device
from repro_torch.core.index import ParISIndex
from repro_torch.core.search import (
    INF, NO_POS, CandidateList, SearchResult, _round_cols, dedup_mask,
    select_len,
)
from repro_torch.kernels import ops

IMAX = 2**31 - 1  # int32 max: a position that loses every min
FILLER = 1e9  # raw value of padding rows: their distance never wins
# The batch bodies cap the selected candidates at this many f32 values a
# rank (Q * rows * n), as the reference sized its pre-gathered block.
SELECT_BUDGET_VALUES = 64 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class DistIndex:
    """Index arrays laid out for the mesh, all cut along N (axis 0)."""

    sax: torch.Tensor  # (N, w) uint8, index order
    raw_sorted: torch.Tensor  # (N, n) f32, index order (beside its sax)
    pos: torch.Tensor  # (N,) int32, index order -> file offset; NO_POS pads
    series_length: int
    segments: int
    cardinality: int

    @property
    def num_rows(self) -> int:
        """Rows held, padding included."""
        return self.sax.shape[0]

    @property
    def device(self) -> torch.device:
        """The device the arrays live on."""
        return self.sax.device


def dist_index_from(index: ParISIndex, num_shards: int) -> DistIndex:
    """Pad N to the shard count and materialize index-ordered raw data.

    Padding rows have zero SAX words, ``NO_POS`` positions (the k-NN body
    drops them from its lists) and raw values of ``FILLER``, whose distance
    can never win a 1-NN.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    n = index.num_series
    pad = -(-n // num_shards) * num_shards - n
    sax = torch.nn.functional.pad(index.sax, (0, 0, 0, pad))
    pos = torch.nn.functional.pad(index.pos, (0, pad), value=NO_POS)
    raw_sorted = index.raw[index.pos.to(torch.int64)]
    if pad:
        filler = raw_sorted.new_full((pad, index.series_length), FILLER)
        raw_sorted = torch.cat([raw_sorted, filler])
    return DistIndex(sax=sax, raw_sorted=raw_sorted, pos=pos,
                     series_length=index.series_length,
                     segments=index.segments, cardinality=index.cardinality)


def shard_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/world of ``x``'s rows (a view)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} rows do not split into {world} "
                         "equal shards (pad with dist_index_from)")
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def shard_of(dindex: DistIndex, rank: int, world: int) -> DistIndex:
    """Rank ``rank``'s shard of ``dindex``: its rows of each array (views)."""
    return dataclasses.replace(
        dindex, sax=shard_rows(dindex.sax, rank, world),
        raw_sorted=shard_rows(dindex.raw_sorted, rank, world),
        pos=shard_rows(dindex.pos, rank, world))


# --- The collective layer -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a 1-D mesh: its rank, the group and its device.

    ``collectives`` counts the collective calls this rank issued.
    """

    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None  # None: the default group
    collectives: list = dataclasses.field(default_factory=lambda: [0])


def _copy(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` for one collective, counted."""
    mesh.collectives[0] += 1
    return x.clone(memory_format=torch.contiguous_format)


def all_reduce(mesh: Mesh, x: torch.Tensor, op) -> torch.Tensor:
    """``x`` reduced over the mesh by ``op`` (a ``dist.ReduceOp``), a copy."""
    t = _copy(mesh, x)
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def gmin(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise minimum over the mesh (int32 or float32)."""
    return all_reduce(mesh, x, dist.ReduceOp.MIN)


def gsum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Elementwise sum over the mesh (int32 or float32)."""
    return all_reduce(mesh, x, dist.ReduceOp.SUM)


def all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x``, stacked in rank order: (world, *x.shape)."""
    t = _copy(mesh, x)
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts)


def _any_rank(mesh: Mesh, flag: torch.Tensor) -> bool:
    """Whether ``flag`` (a 0-d bool) holds on some rank; the same on all."""
    bit = torch.where(flag, 0, 1).to(torch.int32).reshape(1)
    return bool(gmin(mesh, bit)[0] < 1)


def _agree_1nn(mesh: Mesh, bsf: torch.Tensor, pos: torch.Tensor) -> tuple:
    """Global (min distance, smallest position at it) of per-rank 1-NNs."""
    gb = gmin(mesh, bsf)
    return gb, gmin(mesh, torch.where(bsf <= gb, pos, IMAX))


# --- Per-rank search bodies -----------------------------------------------


def _wrap_rows(r: int, rs: int, n_local: int, device) -> torch.Tensor:
    """Round ``r`` of the file-order scan: rows r*rs.. wrapping past the end
    to the shard's first rows, as the reference's ``raw_file`` does."""
    idx = torch.arange(r * rs, (r + 1) * rs, dtype=torch.int64, device=device)
    return idx % n_local


def _seed(shard: DistIndex, qs: torch.Tensor, leaf_cap: int,
          impl: str) -> tuple:
    """Each query's distances to the shard's first ``leaf_cap`` rows."""
    cap = min(leaf_cap, shard.num_rows)
    rows = torch.arange(cap, dtype=torch.int32, device=qs.device)
    return cap, ops.euclid_sq_gather(qs, shard.raw_sorted, rows, impl=impl)


def _argmin_pick(d: torch.Tensor, cand_pos: torch.Tensor) -> tuple:
    """Per-row (min, position at the first argmin) of (Q, R) distances."""
    j = torch.argmin(d, dim=1, keepdim=True)
    if cand_pos.dim() == 1:
        return d.gather(1, j)[:, 0], cand_pos[j[:, 0]]
    return d.gather(1, j)[:, 0], cand_pos.gather(1, j)[:, 0]


def _local_exact_search(
    mesh: Mesh,
    shard: DistIndex,
    queries: torch.Tensor,
    *,
    round_size: int,
    leaf_cap: int,
    shared_bsf: bool,
    select: str,
    impl: str,
) -> tuple:
    """Per-rank body of the single-query search, for (Q, n) queries at once.

    Each query runs its own loop, as the reference's ``vmap`` of the
    single-query ``while_loop`` runs it: a query's state stops changing
    once its own condition fails, so its answer and its round count are
    those of its run alone. The collectives of every query of a round go
    in one call. Returns (Q,) (dist, pos, reads, updates, rounds).
    """
    raw_l, pos_l = shard.raw_sorted, shard.pos
    n_local = shard.num_rows
    n_q = queries.shape[0]
    rs = round_size
    dev = queries.device
    qs = isax.znorm(queries)
    qps = isax.paa(qs, shard.segments)
    bpp = isax.padded_breakpoints(shard.cardinality, dev)

    # Approximate search: every rank scans its first leaf_cap rows; the
    # global minimum seeds the BSF.
    cap, d0 = _seed(shard, qs, leaf_cap, impl)
    bsf, bsfpos = _agree_1nn(mesh, *_argmin_pick(d0, pos_l[:cap]))

    # LBC on the local shard: one single-query pass a query.
    lb = torch.stack([ops.lower_bound_sq(qp, shard.sax, bpp,
                                         shard.series_length, impl=impl)
                      for qp in qps])
    cands = None
    if shared_bsf and select == "topk":
        sel_len = min(max(n_local // 16, rs), n_local)
        cands = CandidateList(lb, sel_len, rs, impl)
    elif shared_bsf:
        sel_len = n_local
        order = torch.argsort(lb, dim=1, stable=True)  # jnp.argsort is stable
        lb_sorted = lb.gather(1, order)
    else:  # nb-: SAX order, no early exit (Alg. 8)
        sel_len = n_local
        order = torch.arange(n_local, device=dev).expand(n_q, -1)
        lb_sorted = lb
    n_rounds = -(-sel_len // rs)

    def head(r):  # (Q,) bound of round r's first entry
        return cands.head(r) if cands is not None else lb_sorted[:, r * rs]

    def round_of(r):  # round r's ((Q, rs) rows, (Q, rs) bounds)
        if cands is not None:
            return cands.round(r)
        return (_round_cols(order, r, rs, 0),
                _round_cols(lb_sorted, r, rs, INF))

    reads = torch.full((n_q,), cap, dtype=torch.int32, device=dev)
    updates = torch.zeros((n_q,), dtype=torch.int32, device=dev)
    rounds = torch.zeros((n_q,), dtype=torch.int32, device=dev)
    active = torch.ones((n_q,), dtype=torch.bool, device=dev)

    def step(active, bsf, bsfpos, reads, updates, lbs, rows, cand_pos,
             agree):
        mask = lbs < bsf[:, None]
        d = ops.euclid_sq_gather(qs, raw_l, rows, impl=impl)
        dj, pj = _argmin_pick(torch.where(mask, d, INF), cand_pos)
        better = dj < bsf
        bsf_new = torch.where(better, dj, bsf)
        pos_new = torch.where(better, pj, bsfpos)
        if agree:
            bsf_new, pos_new = _agree_1nn(mesh, bsf_new, pos_new)
        return (torch.where(active, bsf_new, bsf),
                torch.where(active, pos_new, bsfpos),
                reads + torch.where(active, mask.sum(1, dtype=torch.int32),
                                    0),
                updates + (better & active).to(torch.int32))

    for r in range(n_rounds):
        if shared_bsf:
            # Global early stop: gmin(next bound) < bsf is replicated.
            active = active & (gmin(mesh, head(r)) < bsf)
            if not bool(active.any()):
                break
        rows, lbs = round_of(r)
        bsf, bsfpos, reads, updates = step(
            active, bsf, bsfpos, reads, updates, lbs, rows,
            pos_l[rows.long()], shared_bsf)
        rounds += active.to(torch.int32)

    if shared_bsf and select == "topk" and sel_len < n_local:
        # Exactness fallback: a query whose last selected bound beats the
        # BSF on some rank scans every shard in SAX order with BSF pruning
        # (re-reading the rows it already had, as the reference counts).
        kth = cands.last
        need = gmin(mesh, torch.where(kth < bsf, 0, 1).to(torch.int32)) < 1
        if bool(need.any()):
            for r2 in range(-(-n_local // rs)):
                rows = _wrap_rows(r2, rs, n_local, dev)
                bsf, bsfpos, reads, updates = step(
                    need, bsf, bsfpos, reads, updates,
                    _round_cols(lb, r2, rs, INF), rows, pos_l[rows], True)

    bsf, bsfpos = _agree_1nn(mesh, bsf, bsfpos)  # no-op once shared
    return (bsf, bsfpos, gsum(mesh, reads), gsum(mesh, updates), rounds)


def _select(shard: DistIndex, qps: torch.Tensor, round_size: int,
            impl: str) -> tuple:
    """The batch bodies' LBC pass and capped per-query selection.

    Returns ((Q, N_local) bounds, their :class:`CandidateList`).
    """
    n_local = shard.num_rows
    n_q = qps.shape[0]
    bpp = isax.padded_breakpoints(shard.cardinality, qps.device)
    lb = ops.lower_bound_sq_batch(qps, shard.sax, bpp, shard.series_length,
                                  impl=impl)
    budget_rows = SELECT_BUDGET_VALUES // max(1, n_q * shard.series_length)
    sel_len = min(select_len(n_local, round_size),
                  max(round_size, budget_rows))
    return lb, CandidateList(lb, sel_len, round_size, impl)


def _local_batch_search(
    mesh: Mesh,
    shard: DistIndex,
    queries: torch.Tensor,
    *,
    round_size: int,
    leaf_cap: int,
    impl: str,
) -> tuple:
    """Per-rank body of the batched 1-NN: ONE loop for all Q queries.

    Each round min-reduces the whole (Q,) BSF vector and its positions
    across ranks, so Q queries cost one collective a round instead of Q.
    """
    raw_l, pos_l = shard.raw_sorted, shard.pos
    n_local = shard.num_rows
    n_q = queries.shape[0]
    rs = round_size
    dev = queries.device
    qs = isax.znorm(queries)
    qps = isax.paa(qs, shard.segments)

    cap, d0 = _seed(shard, qs, leaf_cap, impl)
    bsf, bsfpos = _agree_1nn(mesh, *_argmin_pick(d0, pos_l[:cap]))
    lb, cands = _select(shard, qps, rs, impl)
    kth_bound = cands.last  # worst selected bound per query
    n_rounds = -(-cands.sel_len // rs)
    reads = torch.full((n_q,), cap, dtype=torch.int32, device=dev)
    updates = torch.zeros((n_q,), dtype=torch.int32, device=dev)

    def step(bsf, bsfpos, reads, updates, mask, rows, cand_pos):
        d = ops.euclid_sq_gather(qs, raw_l, rows, impl=impl)
        dj, pj = _argmin_pick(torch.where(mask, d, INF), cand_pos)
        better = dj < bsf
        bsf, bsfpos = _agree_1nn(mesh, torch.where(better, dj, bsf),
                                 torch.where(better, pj, bsfpos))
        return (bsf, bsfpos, reads + mask.sum(1, dtype=torch.int32),
                updates + better.to(torch.int32))

    r = 0
    while r < n_rounds:
        # bsf is agreed every round, so "any query live on any rank" is
        # replicated and every rank leaves at the same round.
        if not bool((gmin(mesh, cands.head(r)) < bsf).any()):
            break
        rows, lbs = cands.round(r)
        bsf, bsfpos, reads, updates = step(
            bsf, bsfpos, reads, updates, lbs < bsf[:, None], rows,
            pos_l[rows.long()])
        r += 1

    if cands.sel_len < n_local:
        # Exactness fallback over the whole shard in SAX order. Rows below
        # the K-th bound were selected already and are skipped.
        r2 = 0
        while r2 < -(-n_local // rs):
            if not _any_rank(mesh, (kth_bound < bsf).any()):
                break
            lbs = _round_cols(lb, r2, rs, INF)
            mask = ((lbs < bsf[:, None]) & (lbs >= kth_bound[:, None])
                    & (kth_bound < bsf)[:, None])
            rows = _wrap_rows(r2, rs, n_local, dev)
            bsf, bsfpos, reads, updates = step(
                bsf, bsfpos, reads, updates, mask, rows, pos_l[rows])
            r2 += 1
        r += r2
    return bsf, bsfpos, gsum(mesh, reads), gsum(mesh, updates), r


def _local_batch_knn(
    mesh: Mesh,
    shard: DistIndex,
    queries: torch.Tensor,
    *,
    k: int,
    round_size: int,
    leaf_cap: int,
    impl: str,
) -> tuple:
    """Per-rank body of the batched exact k-NN.

    The single-host k-safe ``select="topk"`` protocol on top of a per-rank
    (Q, k) list holding only this rank's positions (shards partition the
    data, so the lists are disjoint). Each round the ranks agree on the
    k-th best distance by an all-gather of their lists' distances; the
    positions are merged once at exit. Every merge is a stable ascending
    sort over the rank-major concatenation, which breaks ties toward the
    lower rank and column as ``lax.top_k`` does.
    """
    raw_l, pos_l = shard.raw_sorted, shard.pos
    n_local = shard.num_rows
    n_q = queries.shape[0]
    rs = round_size
    dev = queries.device
    qs = isax.znorm(queries)
    qps = isax.paa(qs, shard.segments)

    def rank_major(x):  # (S, Q, k) -> (Q, S*k)
        return x.permute(1, 0, 2).reshape(n_q, -1)

    def gkth(d):  # the globally agreed k-th best distance: the threshold
        return torch.sort(rank_major(all_gather(mesh, d)), dim=1,
                          stable=True).values[:, k - 1]

    def merge(loc_d, loc_p, cand_pos, d):
        d = torch.where(dedup_mask(cand_pos, loc_d, loc_p), INF, d)
        vals, sel = torch.sort(torch.cat([loc_d, d], dim=1), dim=1,
                               stable=True)
        mp = torch.cat([loc_p, cand_pos], dim=1)
        return vals[:, :k], mp.gather(1, sel[:, :k])

    # Seed row 0 of the local list with the shard's best over its first
    # cap rows (filler rows skipped); rows 1..k-1 stay (INF, NO_POS).
    cap, d0 = _seed(shard, qs, leaf_cap, impl)
    d0 = torch.where(pos_l[None, :cap] < 0, INF, d0)
    seed_d, seed_p = _argmin_pick(d0, pos_l[:cap])
    seed_p = torch.where(torch.isfinite(seed_d), seed_p, NO_POS)
    loc_d = torch.full((n_q, k), INF, device=dev)
    loc_p = torch.full((n_q, k), NO_POS, dtype=torch.int32, device=dev)
    loc_d[:, 0] = seed_d
    loc_p[:, 0] = seed_p.to(torch.int32)

    lb, cands = _select(shard, qps, rs, impl)
    kth_bound = cands.last
    n_rounds = -(-cands.sel_len // rs)
    reads = torch.full((n_q,), cap, dtype=torch.int32, device=dev)
    updates = torch.zeros((n_q,), dtype=torch.int32, device=dev)

    def step(loc_d, loc_p, kth, reads, updates, mask, rows, cand_pos):
        d = ops.euclid_sq_gather(qs, raw_l, rows, impl=impl)
        d = torch.where(mask & (cand_pos >= 0), d, INF)  # drop filler rows
        improved = d.amin(dim=1) < kth
        loc_d, loc_p = merge(loc_d, loc_p, cand_pos, d)
        return (loc_d, loc_p, gkth(loc_d),
                reads + mask.sum(1, dtype=torch.int32),
                updates + improved.to(torch.int32))

    kth = gkth(loc_d)
    r = 0
    while r < n_rounds:
        if not bool((gmin(mesh, cands.head(r)) < kth).any()):
            break
        rows, lbs = cands.round(r)
        loc_d, loc_p, kth, reads, updates = step(
            loc_d, loc_p, kth, reads, updates, lbs < kth[:, None], rows,
            pos_l[rows.long()])
        r += 1

    if cands.sel_len < n_local:
        r2 = 0
        while r2 < -(-n_local // rs):
            if not _any_rank(mesh, (kth_bound < kth).any()):
                break
            lbs = _round_cols(lb, r2, rs, INF)
            mask = ((lbs < kth[:, None]) & (lbs >= kth_bound[:, None])
                    & (kth_bound < kth)[:, None])
            rows = _wrap_rows(r2, rs, n_local, dev)
            loc_d, loc_p, kth, reads, updates = step(
                loc_d, loc_p, kth, reads, updates, mask, rows,
                pos_l[rows][None, :].expand(n_q, rs))
            r2 += 1
        r += r2

    d_all = rank_major(all_gather(mesh, loc_d))
    p_all = rank_major(all_gather(mesh, loc_p))
    vals, sel = torch.sort(d_all, dim=1, stable=True)
    return (vals[:, :k], p_all.gather(1, sel[:, :k]), gsum(mesh, reads),
            gsum(mesh, updates), r)


# --- Public steps ---------------------------------------------------------


def _check_shard(shard: DistIndex, mesh: Mesh) -> None:
    if shard.device != mesh.device:
        raise ValueError(f"shard on {shard.device}, mesh rank on "
                         f"{mesh.device}")


def make_distributed_search(
    mesh: Mesh,
    *,
    round_size: int = CONFIG.round_size,
    leaf_cap: int = CONFIG.leaf_cap,
    shared_bsf: bool = True,
    impl: str = "auto",
    batch_queries: int = 0,
    select: str = "sort",
) -> Callable:
    """The mesh's exact single-query search step for this rank.

    Returns ``step(shard, query) -> SearchResult`` where ``shard`` is this
    rank's :func:`shard_of` the :class:`DistIndex` and ``query`` is (n,),
    the same on every rank; every field of the result is the same on every
    rank. ``batch_queries > 0``: the step takes (Q, n) and answers each
    query as its own single-query run would, with the collectives of every
    query of a round in one call; each field, ``rounds`` too, is then (Q,).
    ``rounds`` counts the main loop only. Series length, segments and
    cardinality are the shard's (the reference takes them as arguments).
    """
    if select not in ("sort", "topk"):
        raise ValueError(f"select must be 'sort' or 'topk', got {select!r}")

    def step(shard: DistIndex, query) -> SearchResult:
        _check_shard(shard, mesh)
        qs = as_f32(query, shard.device)
        if not batch_queries:
            qs = qs[None, :]
        d, p, reads, updates, rounds = _local_exact_search(
            mesh, shard, qs, round_size=round_size, leaf_cap=leaf_cap,
            shared_bsf=shared_bsf, select=select, impl=impl)
        if batch_queries:
            return SearchResult(d, p, reads, updates, rounds)
        return SearchResult(d[0], p[0], reads[0], updates[0],
                            int(rounds[0]))

    return step


def make_distributed_batch_search(
    mesh: Mesh,
    *,
    round_size: int = CONFIG.round_size,
    leaf_cap: int = CONFIG.leaf_cap,
    impl: str = "auto",
    k: int = 1,
) -> Callable:
    """The mesh's batched search step for this rank.

    Returns ``step(shard, queries) -> SearchResult`` for (Q, n) queries,
    the same on every rank: every field is (Q,) (``rounds`` an int, the
    main loop's plus the fallback's). Unlike ``make_distributed_search(...,
    batch_queries=Q)`` this runs ONE loop whose collectives reduce the
    whole BSF vector a round, so their count does not grow with Q.

    ``k > 1`` answers exact k-NN: ``dist_sq``/``position`` are (Q, k),
    ascending, with (INF, ``NO_POS``) slots when the index holds fewer
    than k real series.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")

    def step(shard: DistIndex, queries) -> SearchResult:
        _check_shard(shard, mesh)
        qs = as_f32(queries, shard.device)
        if k > 1:
            out = _local_batch_knn(mesh, shard, qs, k=k,
                                   round_size=round_size, leaf_cap=leaf_cap,
                                   impl=impl)
        else:
            out = _local_batch_search(mesh, shard, qs, round_size=round_size,
                                      leaf_cap=leaf_cap, impl=impl)
        return SearchResult(*out)

    return step


def make_distributed_build(
    mesh: Mesh,
    *,
    segments: int = CONFIG.segments,
    cardinality: int = CONFIG.cardinality,
    impl: str = "auto",
) -> Callable:
    """The mesh's bulk-loading step: this rank's raw rows -> (sax, root keys).

    The conversion (Stage 2) is embarrassingly parallel over ranks and
    issues no collective; the global leaf-order sort stays with the build
    pipeline, which consumes the per-rank outputs.
    """
    bp = isax.gaussian_breakpoints(cardinality, mesh.device)

    def step(rows) -> tuple:
        x = isax.znorm(as_f32(rows, mesh.device))
        sax, _ = ops.paa_isax(x, bp, segments, impl=impl, normalize=False)
        return sax, isax.root_key(sax, cardinality)

    return step


# --- Ranks ----------------------------------------------------------------


def rank_device(device, rank: int) -> torch.device:
    """A rank's device: ``"cuda"`` means ``cuda:{rank % device_count}``."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)  # raises without a card
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(dev)


def _rank_main(fn, rank, world, backend, device, init_method, timeout_s,
               inputs, results) -> None:
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)  # one worker pair a rank, as a core
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = Mesh(rank=rank, world=world, device=dev,
                    group=dist.group.WORLD)
        args = inputs.get(timeout=timeout_s)
        out = fn(mesh, *args)
        # A CUDA tensor received by IPC stays mapped, and its sender cannot
        # free it, until this process drops it: drop before reporting.
        del args
        gc.collect()
        results.put((rank, True, out))
    except Exception:  # the rank's boundary: report, the parent raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(fn: Callable, world_size: int, *, backend: str,
               init_method: str, timeout: float, join_timeout: float,
               device="cuda", args: tuple = ()) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` new ranks; their results.

    Each rank is a process started with the ``spawn`` method on
    :func:`rank_device` ``(device, rank)``, in one process group of
    ``backend`` that meets at ``init_method`` (for example ``file://`` a
    path no earlier group used). The caller names the backend: ``"gloo"``
    for several ranks on one card (NCCL refuses two ranks on one device;
    gloo takes CUDA tensors and copies them through the host itself),
    ``"nccl"`` for one card a rank. ``fn`` must be importable by name (a
    module-level function of this package): a spawned rank imports it.
    ``args`` travel by ``torch.multiprocessing``: CUDA tensors by IPC,
    without a copy; the caller keeps them alive until this returns, and
    each rank drops them before it reports, so the caller can free them
    afterwards. Results should be host objects. A collective that waits
    ``timeout`` seconds raises in its rank; any rank's error, a rank that
    dies, or ``join_timeout`` seconds without every result raise here,
    after every rank is stopped.
    """
    rank_device(device, 0)  # fail here, not in every rank
    ctx = torch.multiprocessing.get_context("spawn")
    inputs, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, rank, world_size, backend, str(device), init_method, timeout,
        inputs, results), daemon=True) for rank in range(world_size)]
    for p in procs:
        p.start()
    for _ in procs:  # every rank takes one copy
        inputs.put(args)
    out = {}
    deadline = time.monotonic() + join_timeout
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(out))
                raise TimeoutError(f"mesh ranks {missing} returned nothing "
                                   f"within {join_timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(1.0, left))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"mesh ranks {dead} died (exit codes "
                        f"{[procs[r].exitcode for r in dead]})") from None
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]


# --- The rank entry point of the tests and of chip_smoke.py ----------------


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _sync(mesh: Mesh) -> None:
    """Wait for this rank's device, then for every rank."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    gsum(mesh, torch.zeros(1, dtype=torch.int32, device=mesh.device))


def run_plan(mesh: Mesh, dindex: DistIndex, queries, plan: list,
             rows=None) -> dict:
    """Run each step of ``plan`` on this rank and return host results.

    ``plan`` holds ``(name, kind, kwargs)`` entries; a ``"queries"`` key
    in ``kwargs`` limits the step to that many leading queries:

      * ``"search"``: :func:`make_distributed_search` (kwargs) over this
        rank's shard of ``dindex``, once a query of ``queries`` (all of
        them in one call when ``batch_queries`` is set);
      * ``"batch"``: :func:`make_distributed_batch_search` on all queries;
      * ``"build"``: :func:`make_distributed_build` on this rank's share of
        ``rows``;
      * ``"collectives"``: ``kwargs["calls"]`` ``gmin`` calls on a (Q,)
        float32 vector, then as many ``all_gather`` calls on a (Q, k)
        one: the cost of one collective.

    Each entry of the result maps field names to numpy arrays, plus
    ``seconds`` (wall time between two mesh-wide syncs) and
    ``collectives`` (calls issued). The result also holds the rank's
    ``launches`` (:func:`ops.launch_counts`) and, on a card, its
    ``peak_bytes`` (``torch.cuda.max_memory_allocated``).
    """
    shard = shard_of(dindex, mesh.rank, mesh.world)
    out = {}
    for name, kind, kw in plan:
        kw = dict(kw)
        qs = queries[:kw.pop("queries")] if "queries" in kw else queries
        _sync(mesh)
        calls0 = mesh.collectives[0]
        t0 = time.perf_counter()
        if kind == "search":
            step = make_distributed_search(mesh, **kw)
            if kw.get("batch_queries"):
                res = [step(shard, qs)]
            else:
                res = [step(shard, q) for q in qs]
            got = {f.name: np.stack([_host(getattr(x, f.name)) for x in res])
                   for f in dataclasses.fields(SearchResult)}
            if kw.get("batch_queries"):
                got = {f: v[0] for f, v in got.items()}
        elif kind == "batch":
            res = make_distributed_batch_search(mesh, **kw)(shard, qs)
            got = {f.name: _host(getattr(res, f.name))
                   for f in dataclasses.fields(SearchResult)}
        elif kind == "build":
            sax, keys = make_distributed_build(mesh, **kw)(
                shard_rows(rows, mesh.rank, mesh.world))
            got = dict(sax=_host(sax), keys=_host(keys))
        elif kind == "collectives":
            calls = kw["calls"]
            v = torch.zeros(len(qs), device=mesh.device)
            m = torch.zeros((len(qs), kw["k"]), device=mesh.device)
            for _ in range(calls):
                gmin(mesh, v)
            t1 = time.perf_counter()
            for _ in range(calls):
                all_gather(mesh, m)
            got = dict(gmin_ms=1e3 * (t1 - t0) / calls,
                       all_gather_ms=1e3 * (time.perf_counter() - t1) / calls)
        else:
            raise ValueError(f"unknown plan step kind {kind!r}")
        _sync(mesh)
        got["seconds"] = time.perf_counter() - t0
        got["collectives"] = mesh.collectives[0] - calls0
        out[name] = got
    out["launches"] = ops.launch_counts()
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(mesh.device)
                         if mesh.device.type == "cuda" else 0)
    return out
