"""The nine kernel entries as PyTorch operators: ``torch.ops.repro_torch.*``.

A ``*_cuda`` wrapper hands raw pointers to ``ctypes``, so it cannot run on
a fake tensor, and a tracer cannot see through it. Each entry is therefore
defined as an operator of the ``repro_torch`` namespace:

  * its ``CUDA`` implementation is the existing wrapper, unchanged: it
    builds the kernels at first use, launches and counts the launch
    (``LaunchCounter``), so a launch is counted only when one happens;
  * its fake implementation (``torch.library.register_fake``) returns the
    output shapes and dtypes, so ``FakeTensorMode`` — the dry-run
    (``launch/dryrun.py``) — traces the card's path without a card;
  * its FLOP formula (``torch.utils.flop_counter.register_flop_formula``)
    is the kernel's fp32 operations from ``launch/roofline.kernel_cost``,
    which ``FlopCounterMode`` and the dry-run's counting mode read.

The launch knobs stay optional (``int?``, keyword-only as in the
wrappers). The operators are defined with ``torch.library.Library``
``define`` + ``impl``, not the ``custom_op`` decorator, whose Python layer
costs more a call. ``kernels/ops.py`` calls these operators for tensors on
the card; the ``*_cuda`` wrappers stay callable directly.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import euclidean as _euclid
from repro_torch.kernels import lower_bound as _lb
from repro_torch.kernels import paa_isax as _pi
from repro_torch.kernels import select as _select

NAMESPACE = "repro_torch"

# op name -> (schema, the CUDA wrapper it runs)
SCHEMAS = {
    "paa_isax": (
        "paa_isax(Tensor series, Tensor breakpoints, int segments, "
        "bool normalize=True, *, int? threads=None) -> (Tensor, Tensor)",
        _pi.paa_isax_cuda),
    "lower_bound_sq_batch": (
        "lower_bound_sq_batch(Tensor query_paa, Tensor sax, "
        "Tensor bp_padded, int series_length, *, int? block_q=None, "
        "int? threads=None, int? rows=None) -> Tensor",
        _lb.lower_bound_sq_batch_cuda),
    "lower_bound_sq": (
        "lower_bound_sq(Tensor query_paa, Tensor sax, Tensor bp_padded, "
        "int series_length, *, int? threads=None, "
        "int? blocks_per_sm=None) -> Tensor",
        _lb.lower_bound_sq_cuda),
    "lower_bound_sq_multi": (
        "lower_bound_sq_multi(Tensor query_paa, Tensor sax, "
        "Tensor bp_padded, int series_length, Tensor block_len, "
        "int block_n, *, int? block_q=None, int? threads=None, "
        "int? rows=None) -> Tensor",
        _lb.lower_bound_sq_multi_cuda),
    "euclid_sq_gather": (
        "euclid_sq_gather(Tensor queries, Tensor raw, Tensor positions, *, "
        "int? threads=None, int? rows_per_warp=None) -> Tensor",
        _euclid.euclid_sq_gather_cuda),
    "euclid_min": (
        "euclid_min(Tensor query, Tensor data) -> (Tensor, Tensor)",
        _euclid.euclid_min_cuda),
    "select": (
        "select(Tensor lb, int k) -> (Tensor, Tensor, Tensor)",
        _select.select_cuda),
    "order_range": (
        "order_range(Tensor bounds, Tensor cols, int lo, int hi, "
        "Tensor? prev_bounds=None, Tensor? prev_cols=None) "
        "-> (Tensor, Tensor)",
        _select.order_range_cuda),
    "engine_round": (
        "engine_round(Tensor cols, Tensor bounds, int r, int round_size, "
        "Tensor pos_table, Tensor raw, Tensor queries, Tensor(a!) top_d, "
        "Tensor(b!) top_p, Tensor(c!) reads, Tensor(d!) updates, "
        "Tensor(e!) state, Tensor? eps_factor_sq=None, "
        "Tensor? budget_rounds=None, Tensor(f!)? skip_lb=None, "
        "Tensor(g!)? out_d=None, Tensor(h!)? out_p=None) -> ()",
        _euclid.engine_round_cuda),
}

_lib = torch.library.Library(NAMESPACE, "DEF")
for _name, (_schema, _wrapper) in SCHEMAS.items():
    _lib.define(_schema)
    _lib.impl(_name, _wrapper, "CUDA")


def _empty(like: torch.Tensor, *shape, dtype=torch.float32):
    return like.new_empty(shape, dtype=dtype)


@torch.library.register_fake(f"{NAMESPACE}::paa_isax")
def _paa_isax_fake(series, breakpoints, segments, normalize=True, *,
                   threads=None):
    b = series.shape[0]
    return (_empty(series, b, segments, dtype=torch.uint8),
            _empty(series, b, segments))


@torch.library.register_fake(f"{NAMESPACE}::lower_bound_sq_batch")
def _lb_batch_fake(query_paa, sax, bp_padded, series_length, *,
                   block_q=None, threads=None, rows=None):
    return _empty(sax, query_paa.shape[0], sax.shape[0])


@torch.library.register_fake(f"{NAMESPACE}::lower_bound_sq")
def _lb_single_fake(query_paa, sax, bp_padded, series_length, *,
                    threads=None, blocks_per_sm=None):
    return _empty(sax, sax.shape[0])


@torch.library.register_fake(f"{NAMESPACE}::lower_bound_sq_multi")
def _lb_multi_fake(query_paa, sax, bp_padded, series_length, block_len,
                   block_n, *, block_q=None, threads=None, rows=None):
    return _empty(sax, query_paa.shape[0], sax.shape[0])


@torch.library.register_fake(f"{NAMESPACE}::euclid_sq_gather")
def _euclid_fake(queries, raw, positions, *, threads=None,
                 rows_per_warp=None):
    return _empty(raw, queries.shape[0], positions.shape[-1])


@torch.library.register_fake(f"{NAMESPACE}::euclid_min")
def _euclid_min_fake(query, data):
    return _empty(data), _empty(data, dtype=torch.int32)


@torch.library.register_fake(f"{NAMESPACE}::select")
def _select_fake(lb, k):
    return (_empty(lb, lb.shape[0], k, dtype=torch.int32),
            _empty(lb, lb.shape[0], k), _empty(lb, lb.shape[0]))


@torch.library.register_fake(f"{NAMESPACE}::order_range")
def _order_range_fake(bounds, cols, lo, hi, prev_bounds=None,
                      prev_cols=None):
    return (_empty(bounds, bounds.shape[0], hi - lo, dtype=torch.int32),
            _empty(bounds, bounds.shape[0], hi - lo))


@torch.library.register_fake(f"{NAMESPACE}::engine_round")
def _engine_round_fake(cols, bounds, r, round_size, pos_table, raw, queries,
                       top_d, top_p, reads, updates, state,
                       eps_factor_sq=None, budget_rounds=None, skip_lb=None,
                       out_d=None, out_p=None):
    return None  # it writes its arguments in place


def _flops(op: str):
    """Register ``op``'s FLOP formula: :func:`roofline.kernel_cost`'s
    operations at the call's shapes."""
    from torch.utils.flop_counter import register_flop_formula

    from repro_torch.launch import roofline

    def formula(*args, out_val=None, **kwargs):
        return roofline.kernel_cost_of_call(op, args, kwargs)["ops"]

    register_flop_formula(getattr(torch.ops.repro_torch, op),
                          get_raw=True)(formula)


for _name in SCHEMAS:
    _flops(_name)
