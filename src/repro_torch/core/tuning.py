"""Kernel launch-shape registry, autotuner and the committed H100 table.

Counterpart of ``repro/core/tuning.py``. Every hand-written kernel of the
port (``kernels/csrc/*.cu``) takes its launch shape as arguments, and this
module decides them:

  * a **registry** (:data:`KERNELS`) of every tunable kernel, under the
    reference's names: its knobs (the CUDA launch shapes the kernel really
    has, not the TPU's ``block_*``), today's defaults (the fallback for
    every table miss: the shapes the kernels had before they were tunable),
    the lattice of admitted values, and the canonical (Q, N) shapes the
    committed table must cover. A lattice admits only shapes that leave
    each output's arithmetic unchanged (the same segments and the same sums
    in the same order, in one thread or one warp), so every admitted shape
    gives the default's bits; the CUDA sources instantiate exactly these;
  * an **autotuner** (:func:`autotune`, :func:`retune`) that hillclimbs the
    lattice with CUDA-event timings on the card, through
    :func:`repro_torch.launch.hillclimb.coordinate_descent`, with a relative
    ``min_gain`` so that timer noise cannot move a winner off the defaults;
  * the **committed table** (``src/repro_torch/TUNING.json``, or the file
    ``REPRO_TORCH_TUNING_PATH`` names; the root ``TUNING.json`` belongs to
    the JAX package), keyed ``kernel|backend|dtype|q<pow2>|n<pow2>`` as the
    reference's is. The backend is ``cpu`` on the CPU and the compute
    capability on a card (``cuda-sm90`` on an H100), so another card misses
    and runs the defaults. Entries name the card and its power limit;
  * **resolution** (:func:`resolve_blocks`): an explicit kwarg wins, a
    table hit supplies the tuned shape, and a miss falls back to the
    registry default. The kernel wrappers resolve through
    :func:`launch_shape`, memoized until :func:`set_table`; the packers
    resolve ``lb_multi``'s layout once, at :data:`PACK_Q`.

On the CPU the plain versions run and every knob but ``lb_multi``'s
``block_n`` (the packed layout) is dead; the table holds no ``cpu`` row,
so the packed block resolves to 128 there, as the reference's CPU row has
it. ``python -m repro_torch.core.tuning --validate`` checks the table
against the registry without touching a card; ``--retune`` measures on
one and rewrites the table, keeping other backends' rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.hillclimb import coordinate_descent

TABLE_VERSION = 1

#: Environment override for the table location (tests, other checkouts).
TABLE_ENV = "REPRO_TORCH_TUNING_PATH"

#: Most lattice points a kernel may admit, its default included: each
#: point is a set of template instantiations for every w and form, and
#: each adds to the first-use build.
MAX_POINTS = 8


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One tunable kernel: knobs, defaults, admitted lattice, committed grid.

    ``defaults`` are the shapes the kernel launched at before it was
    tunable: the fallback for every table miss. ``candidates`` list each
    knob's admitted values, in the order the search steps through them
    (every committed value must come from them, and a wrapper refuses any
    other). ``canonical`` is the (Q, N) grid :func:`retune` measures, and
    the grid the committed table must cover. ``layout`` names knobs that
    describe the caller's data rather than the launch (``lb_multi``'s
    ``block_n``, the packed buffer's block): a wrapper takes them as given.
    """

    name: str
    defaults: Dict[str, int]
    candidates: Dict[str, Tuple[int, ...]]
    canonical: Tuple[Tuple[int, int], ...]
    layout: Tuple[str, ...] = ()

    def points(self) -> int:
        """Admitted lattice points: the product of the knobs' value counts."""
        n = 1
        for values in self.candidates.values():
            n *= len(values)
        return n


#: The registered tunable kernels, under the reference's names. (Q, N) of
#: a key: the bound kernels' queries and SAX rows (``lb_multi``: the packed
#: rows), ``euclid``'s queries and rows a query, ``paa_isax``'s 1 and
#: series. ``rows`` 0 means the width's default (4 rows a thread, 2 at
#: w = 32); ``blocks_per_sm`` 0 means as many as the occupancy allows.
#: ``euclid_min`` keeps its fixed shape and is not registered.
KERNELS: Dict[str, KernelSpec] = {
    "lb_single": KernelSpec(
        name="lb_single",
        defaults={"threads": 512, "blocks_per_sm": 0},
        candidates={"threads": (256, 512), "blocks_per_sm": (2, 3, 0)},
        canonical=((1, 1 << 24), (1, 1 << 22)),
    ),
    "lb_batch": KernelSpec(
        name="lb_batch",
        defaults={"block_q": 64, "threads": 128, "rows": 0},
        candidates={"block_q": (32, 64), "threads": (128, 256),
                    "rows": (2, 0)},
        canonical=((64, 1 << 24), (16, 1 << 22)),
    ),
    "lb_multi": KernelSpec(
        name="lb_multi",
        defaults={"block_q": 64, "threads": 128, "rows": 0, "block_n": 128},
        candidates={"block_q": (64,), "threads": (128, 256), "rows": (2, 0),
                    "block_n": (128, 256)},
        canonical=((64, 1 << 24),),
        layout=("block_n",),
    ),
    "euclid": KernelSpec(
        name="euclid",
        defaults={"threads": 256, "rows_per_warp": 4},
        candidates={"threads": (128, 256), "rows_per_warp": (2, 4, 8)},
        canonical=((64, 4096),),
    ),
    "paa_isax": KernelSpec(
        name="paa_isax",
        defaults={"threads": 256},
        candidates={"threads": (128, 256, 512, 1024)},
        canonical=((1, 1 << 24), (1, 1 << 18)),
    ),
}

#: The Q at which the packers (``search.pack_components``, ``MutableIndex``)
#: resolve ``lb_multi``'s ``block_n``: the Q of its canonical cell, so a
#: card's committed row is the one they read, and the layout a store is
#: packed with is the one tuned for the batch it serves. (The reference
#: keys both its packers and its canonical cell at 8.)
PACK_Q = 64

#: Fields an entry may carry besides its knobs: the reference's, and the
#: card's name and power limit as ``nvidia-smi`` gives them.
_META_FIELDS = ("us_per_call", "default_us_per_call", "impl", "evals",
                "card", "power_limit")


def _pow2(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo): the batch-bucket rule."""
    return 1 << (max(int(n), lo) - 1).bit_length()


def default_rows(segments: int) -> int:
    """The rows a thread of the batch bound kernels take at ``rows`` 0: 4,
    or 2 at w = 32 (``kRows<W>`` in ``kernels/csrc/lower_bound.cu``)."""
    return 2 if segments == 32 else 4


def make_key(kernel: str, backend: str, dtype: str, q: int, n: int) -> str:
    """Table key ``kernel|backend|dtype|q{bucket}|n{bucket}``, (Q, N) bucketed
    to powers of two as the reference's keys are."""
    return f"{kernel}|{backend}|{dtype}|q{_pow2(q)}|n{_pow2(n)}"


def parse_key(key: str) -> Tuple[str, str, str, int, int]:
    """Inverse of :func:`make_key`; raises ``ValueError`` on malformed keys."""
    parts = key.split("|")
    if len(parts) != 5:
        raise ValueError(f"tuning key {key!r}: want 5 '|' fields")
    kernel, backend, dtype, qs, ns = parts
    if not (qs.startswith("q") and ns.startswith("n")):
        raise ValueError(f"tuning key {key!r}: want q<bucket>|n<bucket>")
    q, n = int(qs[1:]), int(ns[1:])
    if q != _pow2(q) or n != _pow2(n):
        raise ValueError(f"tuning key {key!r}: buckets must be powers of 2")
    return kernel, backend, dtype, q, n


def default_table_path() -> str:
    """The port's committed ``TUNING.json`` beside the package (env override)."""
    env = os.environ.get(TABLE_ENV)
    if env:
        return env
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(pkg, "TUNING.json")


class TuningTable:
    """The committed launch-shape table: key -> winner entry.

    An entry holds the tuned knob values of its kernel and bookkeeping:
    ``us_per_call`` measured at tune time, ``default_us_per_call`` for the
    same shape at the registry defaults, ``impl``, ``evals``, and on a card
    its ``card`` name and ``power_limit``. Plain JSON, so a re-tune on new
    hardware reviews like code.
    """

    def __init__(self, entries: Optional[Dict[str, dict]] = None,
                 version: int = TABLE_VERSION):
        self.version = version
        self.entries: Dict[str, dict] = dict(entries or {})

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        """Read a table from ``path`` (raises ``OSError`` if missing)."""
        with open(path) as f:
            doc = json.load(f)
        return cls(doc.get("entries", {}), doc.get("version", 0))

    def save(self, path: str) -> None:
        """Write the table with sorted keys (stable, reviewable diffs)."""
        doc = {"version": self.version,
               "entries": {k: self.entries[k] for k in sorted(self.entries)}}
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")

    def lookup(self, kernel: str, backend: str, dtype: str,
               q: int, n: int) -> Optional[dict]:
        """Exact-bucket entry or None (a miss: the caller falls back)."""
        return self.entries.get(make_key(kernel, backend, dtype, q, n))


_TABLE: Optional[TuningTable] = None
_TABLE_LOADED = False


def get_table() -> TuningTable:
    """The process-global table, loaded at first use from
    :func:`default_table_path`. A missing or unreadable file gives an empty
    table: every lookup misses and every kernel runs at its defaults."""
    global _TABLE, _TABLE_LOADED
    if not _TABLE_LOADED:
        try:
            _TABLE = TuningTable.load(default_table_path())
        except (OSError, ValueError):
            _TABLE = TuningTable()
        _TABLE_LOADED = True
    return _TABLE


def set_table(table: Optional[TuningTable]) -> None:
    """Install ``table`` as the process-global table (None: reload lazily).

    Test and retune hook. It forgets every resolved launch shape, so the
    next launch resolves against the new table. (Edit an installed table's
    entries only through another ``set_table``.)
    """
    global _TABLE, _TABLE_LOADED
    _TABLE = table
    _TABLE_LOADED = table is not None
    _SHAPES.clear()


_CAPABILITY: Dict[int, str] = {}


def backend_of(device) -> str:
    """The table's backend name for ``device``: ``cpu``, or ``cuda-sm<XY>``
    from the card's compute capability (``cuda-sm90`` on an H100)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"no tuning backend for device {dev}")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    name = _CAPABILITY.get(idx)
    if name is None:
        major, minor = torch.cuda.get_device_capability(idx)
        name = _CAPABILITY[idx] = f"cuda-sm{major}{minor}"
    return name


def resolve_blocks(kernel: str, *, q: int, n: int, dtype: str = "f32",
                   backend: Optional[str] = None, device=None,
                   **overrides) -> Dict[str, int]:
    """A kernel's launch shape: explicit kwargs > table entry > defaults.

    ``overrides`` are the caller's explicit knobs; ``None`` means "not
    given" and falls through to the table, keyed on ``backend`` (or the
    backend of ``device``; with neither, the card if there is one, else
    the CPU), then to the registry defaults. Returns every knob of the
    kernel. An unknown knob name raises; values are checked against the
    lattice where a kernel launches (:func:`launch_shape`).
    """
    spec = KERNELS[kernel]
    for name in overrides:
        if name not in spec.defaults:
            raise ValueError(
                f"{kernel} has no tunable {name!r}; knobs: "
                f"{sorted(spec.defaults)}")
    if backend is None:
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        backend = backend_of(device)
    out = dict(spec.defaults)
    entry = get_table().lookup(kernel, backend, dtype, q, n)
    if entry:
        out.update({k: int(entry[k]) for k in spec.defaults if k in entry})
    out.update({k: int(v) for k, v in overrides.items() if v is not None})
    return out


def lattice_points(kernel: str) -> List[Dict[str, int]]:
    """Every admitted launch shape of ``kernel``: the product of its knobs'
    values, in lattice order (at most :data:`MAX_POINTS`)."""
    spec = KERNELS[kernel]
    return [dict(zip(spec.candidates, values))
            for values in itertools.product(*spec.candidates.values())]


#: Resolved launch shapes, memoized by kernel, device, (Q, N) buckets and
#: the caller's explicit knobs; :func:`set_table` empties it. A launch is
#: on the host's critical path (nb-ParIS+ makes one a round), so a shape
#: is resolved once, not at every launch.
_SHAPES: Dict[tuple, Dict[str, int]] = {}


def launch_shape(kernel: str, device, *, q: int, n: int,
                 **overrides) -> Dict[str, int]:
    """:func:`resolve_blocks` for a launch on ``device``, every launch knob
    checked against its admitted values: a shape the CUDA source does not
    instantiate raises ``ValueError`` here, before anything launches.
    Layout knobs (``lb_multi``'s ``block_n``) are the caller's to give.
    Returns a new dict; the resolution is memoized until the next
    :func:`set_table`."""
    memo = (kernel, device, _pow2(q), _pow2(n), *overrides.items())
    shape = _SHAPES.get(memo)
    if shape is None:
        spec = KERNELS[kernel]
        shape = resolve_blocks(kernel, q=q, n=n, device=device, **overrides)
        for name, value in shape.items():
            if name not in spec.layout and value not in spec.candidates[name]:
                raise ValueError(
                    f"{kernel}: {name}={value} is not an admitted launch "
                    f"shape {spec.candidates[name]}")
        _SHAPES[memo] = shape
    return dict(shape)


# ------------------------------------------------------------- measurement
def card_and_power_limit() -> Tuple[str, str]:
    """(name, power limit) of the first card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = line.rsplit(",", 1)
    return name.strip(), limit.strip()


#: Series the ``paa_isax`` measurement z-norms at once.
ZNORM_CHUNK = 1 << 20

#: Raw rows the ``euclid`` measurement gathers from: 1 GiB at n = 256, far
#: beyond the card's 50 MB L2, as the engine's rounds find the raw series
#: (a key's N is the candidates a query, not the raw rows).
EUCLID_RAW_ROWS = 1 << 20


def kernel_runner(kernel: str, *, q: int, n: int, impl: str = "auto",
                  length: int = 256, segments: int = 16, seed: int = 0,
                  raw_rows: int = EUCLID_RAW_ROWS,
                  device="cuda") -> Callable[..., object]:
    """``run(params=None)``: one call of a registered kernel at (Q, N) at the
    given knobs (the defaults for any not given), always on the same inputs:
    made once, from ``seed``, on ``device``, in the production dtypes
    (uniform symbols, normal PAA, random-walk series, z-normed for
    ``paa_isax``; ``euclid`` gathers its N rows a query from ``raw_rows`` of
    them). Every shape compared on one
    runner reads the same bytes at the same addresses."""
    from repro_torch.core import isax
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    defaults = KERNELS[kernel].defaults
    gen = torch.Generator(device=dev).manual_seed(seed)
    bpp = isax.padded_breakpoints(256, dev)

    def knobs(params):
        return {**defaults, **(params or {})}

    if kernel in ("lb_single", "lb_batch", "lb_multi"):
        sax = torch.randint(0, 256, (n, segments), generator=gen, device=dev,
                            dtype=torch.uint8)
        qp = torch.randn((max(q, 1), segments), generator=gen, device=dev)
        if kernel == "lb_single":
            qp1 = qp[0].contiguous()
            return lambda params=None: ops.lower_bound_sq(
                qp1, sax, bpp, length, impl=impl, **knobs(params))
        if kernel == "lb_batch":
            return lambda params=None: ops.lower_bound_sq_batch(
                qp, sax, bpp, length, impl=impl, **knobs(params))
        packed = {}  # block_n -> (the rows padded to it, block_len)

        def run_multi(params=None):
            p = knobs(params)
            bn = p.pop("block_n")
            if bn not in packed:
                n_pad = -(-n // bn) * bn
                lens = torch.full((n_pad // bn,), bn, dtype=torch.int32,
                                  device=dev)
                if n % bn:
                    lens[-1] = n % bn
                packed[bn] = (torch.cat([sax, sax.new_zeros((n_pad - n,
                                                             segments))]),
                              lens)
            sax_p, lens = packed[bn]
            return ops.lower_bound_sq_multi(qp, sax_p, bpp, length, lens,
                                            impl=impl, block_n=bn, **p)
        return run_multi
    if kernel == "euclid":
        raw = torch.randn((raw_rows, length), generator=gen,
                          device=dev).cumsum_(dim=1)
        qs = torch.randn((max(q, 1), length), generator=gen,
                         device=dev).cumsum_(dim=1)
        pos = torch.randint(0, raw_rows, (max(q, 1), n), generator=gen,
                            device=dev, dtype=torch.int32)
        return lambda params=None: ops.euclid_sq_gather(
            qs, raw, pos, impl=impl, **knobs(params))
    if kernel == "paa_isax":
        # z-normed, as build_index hands them to the kernel: the symbol
        # searches' shared-memory reads depend on where the PAA values fall.
        data = torch.empty((n, length), device=dev)
        for s in range(0, n, ZNORM_CHUNK):
            e = min(s + ZNORM_CHUNK, n)
            data[s:e] = isax.znorm(torch.randn(
                (e - s, length), generator=gen, device=dev).cumsum_(dim=1))
        bp = isax.gaussian_breakpoints(256, dev)
        return lambda params=None: ops.paa_isax(
            data, bp, segments, impl=impl, normalize=False, **knobs(params))
    raise ValueError(f"unknown kernel {kernel!r}")


def time_us(fn: Callable[[], object], *, device, repeats: int = 5,
            warmup: int = 2, calls: int = 10) -> float:
    """Median microseconds a call of ``fn`` over ``repeats`` runs of
    ``calls`` calls each, after ``warmup`` calls: CUDA events on a card,
    the host clock on the CPU (where every call is synchronous)."""
    for _ in range(warmup):
        fn()
    times = []
    dev = torch.device(device)
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) * 1e3 / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e6 / calls)
    times.sort()
    return float(times[len(times) // 2])


def measure_kernel(kernel: str, *, q: int, n: int,
                   params: Optional[Dict[str, int]] = None,
                   impl: str = "auto", length: int = 256, segments: int = 16,
                   repeats: int = 5, warmup: int = 2, calls: int = 10,
                   seed: int = 0, device="cuda") -> float:
    """Median microseconds a call of one registered kernel at (Q, N) with
    the given knobs (on a :func:`kernel_runner`, timed by :func:`time_us`).

    ``impl="auto"`` times what production runs on ``device``: the CUDA
    kernel on a card; on the CPU the plain version, for which every launch
    knob is dead (the hillclimb's ``min_gain`` then keeps the defaults).
    """
    run = kernel_runner(kernel, q=q, n=n, impl=impl, length=length,
                        segments=segments, seed=seed, device=device)
    return time_us(lambda: run(params), device=device, repeats=repeats,
                   warmup=warmup, calls=calls)


# --------------------------------------------------------------- autotuner
@dataclasses.dataclass
class TuneResult:
    """One autotune outcome: the table key, its entry, and search stats."""

    key: str
    params: Dict[str, int]
    us_per_call: float
    default_us_per_call: float
    evals: int

    def entry(self, impl: str, card: Optional[str] = None,
              power_limit: Optional[str] = None) -> dict:
        """The JSON entry this result commits into the table."""
        e = dict(self.params)
        e.update(us_per_call=round(self.us_per_call, 2),
                 default_us_per_call=round(self.default_us_per_call, 2),
                 impl=impl, evals=self.evals)
        if card is not None:
            e.update(card=card, power_limit=power_limit)
        return e


def autotune(kernel: str, *, q: int, n: int, dtype: str = "f32",
             backend: Optional[str] = None, device=None, impl: str = "auto",
             timer: Optional[Callable[[Dict[str, int]], float]] = None,
             min_gain: float = 0.03, repeats: int = 5, warmup: int = 2,
             max_steps: int = 64) -> TuneResult:
    """Search one kernel's lattice at one (Q, N) cell.

    Coordinate descent from the registry defaults: a knob steps to a
    lattice neighbour only when the measured time improves by more than
    ``min_gain`` (relative), so a winner is never slower than the defaults
    as measured, and noise keeps them. ``timer`` (params -> us) is
    injectable; the default times the real kernel on ``device`` (the card
    unless given), every point on one :func:`kernel_runner`'s inputs.
    """
    spec = KERNELS[kernel]
    device = "cuda" if device is None else device
    if timer is None:  # every lattice point on the same inputs
        run = kernel_runner(kernel, q=q, n=n, impl=impl, device=device)

        def timer(params: Dict[str, int]) -> float:
            return time_us(lambda: run(params), device=device,
                           repeats=repeats, warmup=warmup)
    best_params, best_us, history = coordinate_descent(
        timer, dict(spec.defaults), spec.candidates,
        min_gain=min_gain, max_steps=max_steps)
    return TuneResult(
        key=make_key(kernel, backend or backend_of(device), dtype, q, n),
        params=best_params,
        us_per_call=float(best_us),
        default_us_per_call=float(history[0][1]),
        evals=len(history),
    )


def retune(*, kernels: Optional[Sequence[str]] = None, impl: str = "auto",
           backend: Optional[str] = None, device=None,
           table: Optional[TuningTable] = None,
           timer_for: Optional[Callable[..., Callable]] = None,
           min_gain: float = 0.03, repeats: int = 5, warmup: int = 2,
           card: Optional[str] = None, power_limit: Optional[str] = None,
           ) -> Tuple[TuningTable, List[dict]]:
    """Search every registered kernel's canonical grid on one backend.

    Returns ``(table, diffs)``: a copy of ``table`` (default: the committed
    one) with this backend's winners written in and every other row kept,
    and one diff row per cell with its key, the previously committed entry
    (None for a fresh cell) and the new one. ``timer_for(kernel, q=, n=)``
    optionally supplies a stub timer per cell (tests); by default the real
    measurement runs on the card. ``card`` and ``power_limit`` go into
    every new entry.
    """
    if table is None:
        try:
            table = TuningTable.load(default_table_path())
        except (OSError, ValueError):
            table = TuningTable()
    table = TuningTable(table.entries, table.version)
    diffs: List[dict] = []
    for name in kernels or sorted(KERNELS):
        spec = KERNELS[name]
        for q, n in spec.canonical:
            timer = timer_for(name, q=q, n=n) if timer_for else None
            res = autotune(name, q=q, n=n, backend=backend, device=device,
                           impl=impl, timer=timer, min_gain=min_gain,
                           repeats=repeats, warmup=warmup)
            new = res.entry(impl, card, power_limit)
            diffs.append(dict(key=res.key, old=table.entries.get(res.key),
                              new=new))
            table.entries[res.key] = new
    return table, diffs


# -------------------------------------------------------------- validation
def validate(table: TuningTable,
             registry: Optional[Dict[str, KernelSpec]] = None) -> List[str]:
    """Schema and staleness check of a table against the kernel registry.

    Returns problem strings; empty means the table is valid and fresh:
    every key parses and names a registered kernel; every entry carries
    every knob with a value from its lattice, a positive measured time,
    and on a card its name and power limit; every registered kernel's
    canonical grid is covered on some backend, and no kernel admits more
    than :data:`MAX_POINTS` lattice points.
    """
    registry = KERNELS if registry is None else registry
    problems: List[str] = []
    if table.version != TABLE_VERSION:
        problems.append(
            f"table version {table.version} != expected {TABLE_VERSION}")
    covered = set()
    for key, entry in table.entries.items():
        try:
            kernel, backend, dtype, q, n = parse_key(key)
        except ValueError as e:
            problems.append(str(e))
            continue
        spec = registry.get(kernel)
        if spec is None:
            problems.append(
                f"{key}: kernel {kernel!r} is not in the registry "
                "(stale entry: drop it or register the kernel)")
            continue
        if not isinstance(entry, dict):
            problems.append(f"{key}: entry must be an object")
            continue
        for knob, lattice in spec.candidates.items():
            if knob not in entry:
                problems.append(f"{key}: missing knob {knob!r}")
            elif entry[knob] not in lattice:
                problems.append(
                    f"{key}: {knob}={entry[knob]} not in the candidate "
                    f"lattice {lattice} (stale vs the registry)")
        unknown = set(entry) - set(spec.candidates) - set(_META_FIELDS)
        if unknown:
            problems.append(f"{key}: unknown fields {sorted(unknown)}")
        us = entry.get("us_per_call")
        if not isinstance(us, (int, float)) or us <= 0:
            problems.append(f"{key}: us_per_call must be a positive number")
        if backend.startswith("cuda") and not (
                entry.get("card") and entry.get("power_limit")):
            problems.append(f"{key}: a card's entry must name the card and "
                            "its power limit")
        covered.add((kernel, q, n))
    for name, spec in registry.items():
        if spec.points() > MAX_POINTS:
            problems.append(f"registry: {name} admits {spec.points()} "
                            f"lattice points, more than {MAX_POINTS}")
        for q, n in spec.canonical:
            if (name, _pow2(q), _pow2(n)) not in covered:
                problems.append(
                    f"stale table: no entry covers registered kernel "
                    f"{name!r} at canonical (q={q}, n={n}) on any backend: "
                    "run python -m repro_torch.core.tuning --retune on the "
                    "card and commit the result")
    return problems


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: ``--validate`` (registry and table only, on any machine) and
    ``--retune`` (on a card: search, rewrite the table, then validate)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", default=None,
                    help="table path (default: the committed TUNING.json)")
    ap.add_argument("--validate", action="store_true",
                    help="schema and registry-staleness check")
    ap.add_argument("--show", action="store_true",
                    help="print the table entries")
    ap.add_argument("--retune", action="store_true",
                    help="measure every canonical cell on the card and "
                    "rewrite the table (other backends' rows are kept)")
    ap.add_argument("--kernels", nargs="*", default=None,
                    help="with --retune: only these kernels")
    ap.add_argument("--min-gain", type=float, default=0.03)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    path = args.table or default_table_path()
    if args.retune:
        if not torch.cuda.is_available():
            print("TUNING: --retune needs a card (torch.cuda.is_available() "
                  "is False)", file=sys.stderr)
            raise SystemExit(2)
        card, limit = card_and_power_limit()
        try:
            old = TuningTable.load(path)
        except OSError:
            old = TuningTable()
        table, diffs = retune(kernels=args.kernels, table=old,
                              device="cuda", min_gain=args.min_gain,
                              repeats=args.repeats, card=card,
                              power_limit=limit)
        print(f"# retuned on {card}, {limit}")
        for d in diffs:
            new, was = d["new"], d["old"]
            knobs = {k: new[k] for k in KERNELS[parse_key(d["key"])[0]]
                     .defaults}
            print(f"{d['key']}: {knobs} {new['us_per_call']} us "
                  f"(default {new['default_us_per_call']} us, "
                  f"{new['evals']} evals; was "
                  f"{None if was is None else was.get('us_per_call')})")
        table.save(path)
    try:
        table = TuningTable.load(path)
    except OSError as e:
        print(f"TUNING-GATE: cannot read {path}: {e}", file=sys.stderr)
        raise SystemExit(1)
    except ValueError as e:
        print(f"TUNING-GATE: {path} is not valid JSON: {e}",
              file=sys.stderr)
        raise SystemExit(1)
    if args.show:
        for key in sorted(table.entries):
            print(f"{key}: {table.entries[key]}")
    problems = validate(table)
    for p in problems:
        print(f"TUNING-GATE: {p}", file=sys.stderr)
    if problems:
        raise SystemExit(1)
    print(f"# tuning table ok: {len(table.entries)} entries cover "
          f"{len(KERNELS)} registered kernels")


if __name__ == "__main__":
    # ``python -m`` runs a second copy of this file after the package has
    # imported the first (search and the kernel wrappers use it): run the
    # package's copy, so the CLI and the wrappers share one table.
    from repro_torch.core import tuning as _tuning

    _tuning.main()
