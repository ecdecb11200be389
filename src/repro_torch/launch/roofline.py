"""Roofline terms of a traced cell against the NVIDIA H100 SXM.

The port of ``repro/launch/roofline.py``. The reference parses the
compiled HLO of a cell; PyTorch runs eagerly and has no HLO, so the port
counts what the cell's function runs instead: :class:`CostMode`, a
``TorchDispatchMode`` that sees every aten op of one rank (under a
``FakeTensorMode`` in ``launch/dryrun.py``: shapes only, nothing allocated)
and keeps

  * FLOPs — ``torch.utils.flop_counter``'s formulas (the registry
    ``FlopCounterMode`` reads, which also holds the seven kernel ops through
    :func:`kernel_cost`), split by the dtype of the operands: bf16 / fp16
    products run on the tensor cores, fp32 ones and the kernels' fp32
    operations outside them (TF32 off, as ``chip_smoke.py`` sets it);
  * HBM bytes — inputs + outputs of every op, read once and written once.
    Views and metadata ops count nothing (the reference's
    ``_SKIP_BYTES_OPS``); gathers and scatters move their rows twice, not
    their whole table; the kernel ops count their :func:`kernel_cost`
    bytes. Ops are not fused here, so this is the traffic of the port's
    eager kernels, not of a fused program;
  * collective bytes — the reference's ring terms (all-reduce 2(n-1)/n of
    the buffer, all-gather and reduce-scatter (n-1)/n of the full buffer,
    all-to-all (n-1)/n, broadcast 1x) for DTensor's ``_c10d_functional``
    ops and the classic ``c10d`` ops of ``core/distributed.py``, with n the
    size of the op's group, each on the link that carries it: NVLink when
    every rank of the group sits in one 8-card node, InfiniBand otherwise;
  * host reads of device values (``aten._local_scalar_dense``): answered
    from a shadow value where the value derives from small integer tensors
    made by the function itself (positions, ``arange``), otherwise decided
    per call site — the site's first read says "yes", later ones "no", so a
    data-dependent loop body counts once (as the reference counts a
    ``while`` body whose trip count XLA does not know) — and the site is
    listed in ``unknown_trip_bodies``.

:class:`RooflineReport` keeps the reference's fields and JSON keys; its
terms are seconds on one card against the constants below.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

# NVIDIA H100 SXM5 80GB, per card (NVIDIA H100 Tensor Core GPU data sheet):
HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, 3.35 TB/s
FP32_OPS_PER_S = 67e12  # FP32 outside the tensor cores, 67 TFLOP/s
BF16_OPS_PER_S = 989e12  # BF16 / FP16 tensor cores, dense, 989 TFLOP/s
# NVLink 4 (same data sheet): 900 GB/s a card, both directions together.
NVLINK_BYTES_PER_S = 450e9  # each way
# Between nodes (NVIDIA DGX H100 data sheet: 8 H100 and 8 single-port
# ConnectX-7 400 Gb/s InfiniBand adapters for the compute fabric, one a
# card): 400 Gb/s = 50 GB/s a card each way.
IB_BYTES_PER_S = 50e9
NODE_CARDS = 8  # cards a node (DGX H100); rank r sits in node r // 8

LINK_BYTES_PER_S = {"nvlink": NVLINK_BYTES_PER_S, "ib": IB_BYTES_PER_S}
DTYPE_OPS_PER_S = {"bf16": BF16_OPS_PER_S, "fp32": FP32_OPS_PER_S}


# ---------------------------------------------------------------------------
# The kernels' bytes and operations
# ---------------------------------------------------------------------------

def kernel_cost(name: str, **shape) -> dict:
    """Bytes each of the port's kernels must move (each input read once,
    each output written once) and the fp32 operations it does, at a call's
    shape. ``name`` is the kernel's row name in ``chip_smoke.py``:

      * ``paa_isax`` (``b`` series of ``n`` values, ``w`` segments,
        ``n_bp`` breakpoints): reads the series and the breakpoints,
        writes (b, w) uint8 symbols and (b, w) f32 PAA; one add a value
        read and 9 operations a (series, segment) pair;
      * ``lower_bound_sq_batch`` (``q`` queries, ``n_rows`` SAX rows of
        ``w``, ``n_bp`` padded breakpoints): reads Q·w·4 + N·w + n_bp·4,
        writes Q·N·4, does Q·N·(6w+1);
      * ``lower_bound_sq`` (one query): the same with Q = 1;
      * ``lower_bound_sq_multi`` (``q``, ``n_pad`` packed rows,
        ``blocks`` block lengths, ``real_rows`` of them real): the batch
        form over the packed buffer, operations on the real rows;
      * ``euclid_sq`` (``q`` queries of ``n``, ``r`` positions a query,
        ``shared_positions`` when one (R,) vector serves every query,
        ``rows_read`` distinct rows, default every position): the
        gathered rows, the queries, the positions and the (Q, R) output;
        3 operations a value;
      * ``euclid_min`` (``b`` rows of ``n``): the rows, the query and one
        8-byte key; 3 operations a value;
      * ``select`` (``q`` rows of ``n`` bounds, ``k`` kept a row): the
        bounds read once, the (Q, k) int32 columns and f32 bounds and the
        (Q,) k-th bounds written once; no fp32 arithmetic;
      * ``order_range`` (``q`` rows of a list of ``n`` entries, ``m`` =
        hi - lo ordered a row): the list's bounds read once, the ``m``
        columns of the range read, and the (Q, m) pairs written;
      * ``engine_round`` (``q`` queries of ``n``, ``r`` candidates a round,
        ``rows_read`` masked-in rows, default all ``q * r``, ``k``): the
        masked-in rows, the queries, the round's int32 columns and float32
        bounds, and for k > 1 the (Q, r) distances and positions written;
        3 operations a value read.
    """
    s = dict(shape)
    if name == "paa_isax":
        b, n, w, n_bp = s["b"], s["n"], s["w"], s["n_bp"]
        return dict(bytes=b * n * 4 + n_bp * 4 + b * w * 5,
                    ops=b * n + b * w * 9)
    if name == "lower_bound_sq_batch":
        q, rows, w, n_bp = s["q"], s["n_rows"], s["w"], s["n_bp"]
        return dict(bytes=q * w * 4 + rows * w + n_bp * 4 + q * rows * 4,
                    ops=q * rows * (6 * w + 1))
    if name == "lower_bound_sq":
        rows, w, n_bp = s["n_rows"], s["w"], s["n_bp"]
        return dict(bytes=rows * w + n_bp * 4 + w * 4 + rows * 4,
                    ops=rows * (6 * w + 1))
    if name == "lower_bound_sq_multi":
        q, n_pad, w, n_bp = s["q"], s["n_pad"], s["w"], s["n_bp"]
        real = s.get("real_rows") or n_pad
        return dict(bytes=q * w * 4 + n_pad * w + s["blocks"] * 4
                    + n_bp * 4 + q * n_pad * 4,
                    ops=q * real * (6 * w + 1))
    if name == "euclid_sq":
        q, r, n = s["q"], s["r"], s["n"]
        rows = s.get("rows_read")
        rows = q * r if rows is None else rows
        n_pos = r if s.get("shared_positions") else q * r
        return dict(bytes=rows * n * 4 + q * n * 4 + n_pos * 4 + q * r * 4,
                    ops=q * r * 3 * n)
    if name == "euclid_min":
        b, n = s["b"], s["n"]
        return dict(bytes=b * n * 4 + n * 4 + 8, ops=b * 3 * n)
    if name == "select":
        q, n, k = s["q"], s["n"], s["k"]
        return dict(bytes=q * n * 4 + q * k * 8 + q * 4, ops=0)
    if name == "order_range":
        q, n, m = s["q"], s["n"], s["m"]
        return dict(bytes=q * n * 4 + q * m * 12, ops=0)
    if name == "engine_round":
        q, r, n = s["q"], s["r"], s["n"]
        rows = s.get("rows_read")
        rows = q * r if rows is None else rows
        out = q * r * 8 if s.get("k", 1) > 1 else 0
        return dict(bytes=rows * n * 4 + q * n * 4 + q * r * 8 + out,
                    ops=rows * 3 * n)
    raise KeyError(f"unknown kernel {name!r}")


def bound_seconds(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """(the least seconds for these bytes and fp32 operations on one card,
    which of the two binds: ``"bytes"`` or ``"operations"``)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineReport:
    """One rank's counts for one call of a cell's function (the
    reference's fields, plus the port's split of FLOPs by dtype and of
    collective bytes by link)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0  # wire bytes per device
    collective_by_op: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_count: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    dot_flops_top: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    hbm_top: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list)
    unknown_trip_bodies: List[str] = dataclasses.field(default_factory=list)
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_by_link: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def terms_seconds(self) -> Dict[str, float]:
        """compute (FLOPs by dtype over each dtype's peak), memory (HBM
        bytes over 3.35 TB/s) and collective (each link's wire bytes over
        its rate) seconds on one H100."""
        return {
            "compute_s": sum(f / DTYPE_OPS_PER_S[d]
                             for d, f in self.flops_by_dtype.items()),
            "memory_s": self.hbm_bytes / HBM_BYTES_PER_S,
            "collective_s": sum(b / LINK_BYTES_PER_S[k]
                                for k, b in self.collective_by_link.items()),
        }

    @property
    def dominant(self) -> str:
        """The largest of the three terms."""
        t = self.terms_seconds()
        return max(t, key=t.get)

    def to_json(self) -> dict:
        """The report as a JSON-able dict, with its terms and dominant."""
        d = dataclasses.asdict(self)
        d.update(self.terms_seconds())
        d["dominant"] = self.dominant
        return d


def model_flops(param_count: int, active_param_count: int, tokens: int,
                kind: str) -> float:
    """MODEL_FLOPS = 6 N_active D (train) / 2 N_active D (inference)."""
    n = active_param_count
    return (6.0 if kind == "train" else 2.0) * n * tokens


# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

# collective op -> (wire factor of (n-1)/n, None for 1x; the buffer it
# applies to: its first argument, or its output)
_RING = {
    "all_reduce": (2.0, "arg0"), "allreduce_": (2.0, "arg0"),
    "all_gather_into_tensor": (1.0, "out"), "allgather_": (1.0, "arg0"),
    "reduce_scatter_tensor": (1.0, "arg0"),
    "all_to_all_single": (1.0, "arg0"),
    "broadcast": (None, "arg0"), "broadcast_": (None, "arg0"),
}
_GATHERS = {"index", "gather", "index_select", "embedding", "take"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "index_add",
             "index_add_"}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "lift_fresh"}
SHADOW_MAX_NUMEL = 1 << 22  # the largest integer tensor a shadow follows
_SKIP_FRAMES = (os.sep + "torch" + os.sep, "roofline.py", "contextlib.py",
                os.sep + "kernels" + os.sep,
                "functools.py")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _site() -> str:
    """``file:function:line`` of the innermost frame of this repository's
    code (outside torch) that is running."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if not any(s in name for s in _SKIP_FRAMES) and "repro" in name:
            i = name.find("repro_torch")
            short = name[i:] if i >= 0 else os.path.basename(name)
            return f"{short}:{f.f_code.co_name}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


def _site_text(site: str) -> Tuple[str, str]:
    """(function, stripped source line) of a :func:`_site` string."""
    import linecache

    path, func, line = site.rsplit(":", 2)
    for p in sys.path:
        cand = os.path.join(p, path)
        if os.path.exists(cand):
            return func, linecache.getline(cand, int(line)).strip()
    return func, ""


def set_value(t, value) -> None:
    """Give fake tensor ``t`` a known value (a host tensor or a number),
    so that a host read of it during a :class:`CostMode` count is
    answered: a decode position, say."""
    import torch

    with _real():
        setattr(t, "_roofline_value", (torch.as_tensor(value).to(t.dtype),
                                       t._version))


def _real():
    """A context in which no dispatch mode is active (real host tensors:
    the shadow values)."""
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


def _group_of(func, args, kwargs):
    """(size, global ranks) of a collective's group."""
    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    name = kwargs.get("group_name")
    if name is None:
        name = next((a for a in reversed(args) if isinstance(a, str)), None)
    if name is not None:
        pg = c10d._resolve_process_group(name)
    else:
        obj = next(a for a in args if isinstance(a, torch.ScriptObject))
        pg = dist.ProcessGroup.unbox(obj)
    return pg.size(), dist.get_process_group_ranks(pg)


class CostMode:
    """Count one rank's FLOPs, HBM bytes, collective bytes and host reads
    (module docstring) while active: ``with CostMode() as cm: fn(...)``,
    then ``cm.report()``. ``reads`` maps (function, source line) of a
    read site to the answers its reads take in turn, for sites where "yes
    once, then no" would be wrong (``specs.Cell.reads``)."""

    def __init__(self, reads: Optional[dict] = None):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return outer._dispatch(func, types, args, kwargs or {})

        self._mode = _Mode()
        self._fake_on_entry = None
        self.reads = dict(reads or {})
        self.flops_by_dtype: Dict[str, float] = {}
        self.hbm_bytes = 0.0
        self.collective_by_op: Dict[str, float] = {}
        self.collective_count: Dict[str, int] = {}
        self.collective_by_link: Dict[str, float] = {}
        self._dots: Dict[str, float] = {}
        self._hbm: Dict[str, float] = {}
        self._sites: Dict[str, int] = {}
        self.unknown_sites: List[str] = []

    def __enter__(self):
        from torch._guards import active_fake_mode

        # DTensor's sharding propagation runs some ops under a fake mode of
        # its own to learn their output shapes: only ops under the mode
        # active here are the rank's work (as MemTracker tells them apart).
        self._fake_on_entry = active_fake_mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    # -- dispatch ---------------------------------------------------------
    def _dispatch(self, func, types, args, kwargs):
        import torch
        from torch._subclasses.fake_tensor import FakeTensor

        if func is torch.ops.prim.device.default:
            # a device query: no work, and most of a trace's dispatches
            # (autograd asks it of every gradient): the tensor answers
            return args[0].device
        if any(t not in (torch.Tensor, FakeTensor, torch.nn.Parameter)
               for t in types):
            return NotImplemented  # a DTensor: count its local ops instead
        from torch._guards import active_fake_mode

        if active_fake_mode() is not self._fake_on_entry:
            return func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        if name == "_local_scalar_dense":
            return self._read(args[0])
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d"):
            self._collective(func, name, args, kwargs, out)
        elif ns == "repro_torch":
            self._kernel(func, name, args, kwargs, out)
        elif ns == "aten":
            self._aten(func, name, args, kwargs, out)
        self._shadow(func, args, kwargs, out)
        return out

    def _aten(self, func, name, args, kwargs, out):
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        import torch

        packet = func._overloadpacket
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            if f:
                t0 = next(x for x in tree_leaves(args)
                          if isinstance(x, torch.Tensor))
                dt = "bf16" if t0.dtype in (torch.bfloat16,
                                            torch.float16) else "fp32"
                self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + f
                key = f"{_site()}/{name}"
                self._dots[key] = self._dots.get(key, 0.0) + f
        if name in _NO_BYTES or self._is_view(func):
            return
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        ins = [x for x in tree_leaves((args, kwargs))
               if isinstance(x, torch.Tensor)]
        if name in _GATHERS:
            b = 2 * sum(_nbytes(x) for x in outs) + sum(
                _nbytes(x) for x in ins[1:]
                if not x.is_floating_point())
        elif name in _SCATTERS:
            vals = ins[-1] if ins else None
            b = 2 * (_nbytes(vals) if vals is not None else 0) + sum(
                _nbytes(x) for x in outs)
        else:
            b = sum(_nbytes(x) for x in ins) + sum(_nbytes(x) for x in outs)
        self._add_bytes(name, b)

    @staticmethod
    def _is_view(func) -> bool:
        rets = func._schema.returns
        return bool(rets) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in rets)

    def _add_bytes(self, name, b):
        self.hbm_bytes += b
        self._hbm[name] = self._hbm.get(name, 0.0) + b

    def _kernel(self, func, name, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        cost = kernel_cost_of_call(name, args, kwargs)
        self._add_bytes(f"repro_torch.{name}", cost["bytes"])
        f = float(flop_registry[func._overloadpacket](*args, **kwargs,
                                                      out_val=out))
        self.flops_by_dtype["fp32"] = self.flops_by_dtype.get("fp32", 0) + f
        key = f"{_site()}/repro_torch.{name}"
        self._dots[key] = self._dots.get(key, 0.0) + f

    def _collective(self, func, name, args, kwargs, out):
        import torch
        from torch.utils._pytree import tree_leaves

        if name not in _RING:
            return
        factor, which = _RING[name]
        n, ranks = _group_of(func, args, kwargs)
        buf = sum(_nbytes(x) for x in tree_leaves(
            args[0] if which == "arg0" else out)
            if isinstance(x, torch.Tensor))
        wire = float(buf) if factor is None else (
            factor * (n - 1) / max(n, 1) * buf)
        key = name.rstrip("_")
        self.collective_by_op[key] = self.collective_by_op.get(key, 0) + wire
        self.collective_count[key] = self.collective_count.get(key, 0) + 1
        link = ("nvlink" if len({r // NODE_CARDS for r in ranks}) <= 1
                else "ib")
        self.collective_by_link[link] = self.collective_by_link.get(
            link, 0.0) + wire
        self._add_bytes(key, 2 * buf)

    # -- host reads and shadow values ---------------------------------------
    @staticmethod
    def _value(t):
        v = getattr(t, "_roofline_value", None)
        if v is None or v[1] != t._version:
            return None
        return v[0]

    def _shadow(self, func, args, kwargs, out):
        """Follow the value of a small integer result whose inputs all have
        known values (or that a factory made from numbers)."""
        import torch
        from torch.utils._pytree import tree_flatten, tree_unflatten

        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not outs or not all(
                isinstance(o, torch.Tensor) and not o.is_floating_point()
                and not o.is_complex() and o.numel() <= SHADOW_MAX_NUMEL
                for o in outs):
            return
        name = func.__name__.split(".")[0]
        if name.startswith("empty") or name.startswith("new_empty"):
            return
        leaves, spec = tree_flatten((args, kwargs))
        vals = []
        for x in leaves:
            if isinstance(x, torch.Tensor):
                v = self._value(x)
                if v is None:
                    const = getattr(x, "constant", None)
                    if const is None:
                        return
                    v = const
                vals.append(v)
            elif isinstance(x, torch.device):
                vals.append(torch.device("cpu"))
            else:
                vals.append(x)
        a, k = tree_unflatten(vals, spec)
        try:
            with _real():
                v = func(*a, **k)
        except Exception:  # an op the host cannot replay: value unknown
            return
        vs = v if isinstance(v, (tuple, list)) else (v,)
        if len(vs) == len(outs) and all(isinstance(x, torch.Tensor)
                                        for x in vs):
            for o, x in zip(outs, vs):
                setattr(o, "_roofline_value", (x, o._version))
            for i, arg in enumerate(func._schema.arguments):
                if arg.alias_info is not None and arg.alias_info.is_write \
                        and i < len(args) and isinstance(args[i],
                                                         torch.Tensor):
                    setattr(args[i], "_roofline_value", (a[i],
                                                         args[i]._version))

    def _read(self, t):
        """Answer a host read of ``t``: its known value, or the site's
        answer (first read yes, later ones no, unless ``reads`` says)."""
        import torch

        v = self._value(t)
        if v is not None:
            with _real():
                return v.item()
        site = _site()
        k = self._sites.get(site, 0)
        self._sites[site] = k + 1
        if site not in self.unknown_sites:
            self.unknown_sites.append(site)
        answers = self.reads.get(_site_text(site)) if self.reads else None
        if answers is not None:
            ans = answers[min(k, len(answers) - 1)]
        else:
            ans = k == 0
        if t.dtype == torch.bool:
            return bool(ans)
        if t.is_floating_point():
            return float(ans)
        return int(ans)

    # -- result --------------------------------------------------------------
    def report(self) -> RooflineReport:
        """The counts so far as a :class:`RooflineReport`."""
        return RooflineReport(
            flops=sum(self.flops_by_dtype.values()),
            hbm_bytes=self.hbm_bytes,
            collective_bytes=sum(self.collective_by_op.values()),
            collective_by_op=dict(self.collective_by_op),
            collective_count=dict(self.collective_count),
            dot_flops_top=sorted(self._dots.items(),
                                 key=lambda x: -x[1])[:12],
            hbm_top=sorted(self._hbm.items(), key=lambda x: -x[1])[:12],
            unknown_trip_bodies=list(self.unknown_sites),
            flops_by_dtype=dict(self.flops_by_dtype),
            collective_by_link=dict(self.collective_by_link))


def kernel_cost_of_call(op: str, args, kwargs) -> dict:
    """:func:`kernel_cost` of one call of a ``torch.ops.repro_torch`` op
    (its tensors' shapes; ``op`` is the op's name)."""
    if op == "paa_isax":
        series, bp, w = args[0], args[1], args[2]
        return kernel_cost("paa_isax", b=series.shape[0], n=series.shape[1],
                           w=w, n_bp=bp.numel())
    if op == "lower_bound_sq_batch":
        qp, sax, bpp = args[0], args[1], args[2]
        return kernel_cost("lower_bound_sq_batch", q=qp.shape[0],
                           n_rows=sax.shape[0], w=sax.shape[1],
                           n_bp=bpp.numel())
    if op == "lower_bound_sq":
        sax, bpp = args[1], args[2]
        return kernel_cost("lower_bound_sq", n_rows=sax.shape[0],
                           w=sax.shape[1], n_bp=bpp.numel())
    if op == "lower_bound_sq_multi":
        qp, sax, bpp, block_len = args[0], args[1], args[2], args[4]
        return kernel_cost("lower_bound_sq_multi", q=qp.shape[0],
                           n_pad=sax.shape[0], w=sax.shape[1],
                           n_bp=bpp.numel(), blocks=block_len.shape[0])
    if op == "euclid_sq_gather":
        qs, raw, pos = args[0], args[1], args[2]
        return kernel_cost("euclid_sq", q=qs.shape[0], r=pos.shape[-1],
                           n=raw.shape[1], shared_positions=pos.dim() == 1)
    if op == "euclid_min":
        data = args[1]
        return kernel_cost("euclid_min", b=data.shape[0], n=data.shape[1])
    if op == "select":
        lb, k = args[0], args[1]
        return kernel_cost("select", q=lb.shape[0], n=lb.shape[1], k=k)
    if op == "order_range":
        bounds, lo, hi = args[0], args[2], args[3]
        return kernel_cost("order_range", q=bounds.shape[0],
                           n=bounds.shape[1], m=hi - lo)
    if op == "engine_round":  # every candidate masked in: the most
        queries, top_d = args[6], args[7]
        return kernel_cost("engine_round", q=queries.shape[0], r=args[3],
                           n=queries.shape[1], k=top_d.shape[1])
    raise KeyError(f"unknown kernel op {op!r}")


__all__ = ["HBM_BYTES_PER_S", "FP32_OPS_PER_S", "BF16_OPS_PER_S",
           "NVLINK_BYTES_PER_S", "IB_BYTES_PER_S", "RooflineReport",
           "CostMode", "kernel_cost", "kernel_cost_of_call", "bound_seconds",
           "model_flops", "set_value"]
