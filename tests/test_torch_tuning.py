"""The port's launch-shape tuner and its hooks: repro_torch.core.tuning.

Mirrors ``tests/test_tuning.py`` case for case with STUBBED timers (the key
algebra, save/load, resolution precedence, the hillclimb on planted optima
and on noise below ``min_gain``, autotune, retune, validation, the packed
block), and holds the port to the reference where both define the same
thing: the same key strings and the same search trajectory on the same
cost surfaces. The CUDA kernels cannot run here, so the wrappers are driven
against a stand-in for the built library that records what each C entry
was given: a table entry, an explicit kwarg, an empty table (the shapes the
kernels had before they were tunable) and a refused shape all show in the
arguments of the launch. The card tests in ``tests/test_torch_cuda.py`` hold
every admitted shape bitwise to the default on the H100.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import tuning as jtuning
from repro.launch import hillclimb as jhill
from repro_torch.core import build_index, isax, search, tuning
from repro_torch.core.ingest import MutableIndex
from repro_torch.core.datagen import random_walk
from repro_torch.kernels import _build, euclidean, lower_bound, ops, paa_isax
from repro_torch.launch.hillclimb import coordinate_descent, snap_to_lattice


@pytest.fixture
def clean_table():
    """Install an empty table for the test; restore lazy loading after."""
    tuning.set_table(tuning.TuningTable())
    yield
    tuning.set_table(None)


def _table_with(kernel, backend, q, n, **params):
    t = tuning.TuningTable()
    entry = dict(params)
    entry.update(us_per_call=1.0, default_us_per_call=2.0,
                 impl="auto", evals=1)
    t.entries[tuning.make_key(kernel, backend, "f32", q, n)] = entry
    return t


# ------------------------------------------------------------- key algebra
def test_make_key_buckets_like_jit_cache():
    key = tuning.make_key("lb_batch", "cpu", "f32", 3000, 50000)
    assert key == "lb_batch|cpu|f32|q4096|n65536"


@pytest.mark.parametrize("q,n", [(1, 1), (3, 5), (64, 1 << 24), (17, 4097),
                                 (3000, 50000)])
@pytest.mark.parametrize("backend", ["cpu", "cuda-sm90", "tpu"])
def test_keys_are_the_references(backend, q, n):
    for kernel in tuning.KERNELS:
        key = tuning.make_key(kernel, backend, "f32", q, n)
        assert key == jtuning.make_key(kernel, backend, "f32", q, n)
        assert tuning.parse_key(key) == jtuning.parse_key(key)


def test_parse_key_round_trips():
    for kernel in tuning.KERNELS:
        for q, n in tuning.KERNELS[kernel].canonical:
            key = tuning.make_key(kernel, "cuda-sm90", "f32", q, n)
            assert tuning.parse_key(key) == (
                kernel, "cuda-sm90", "f32", tuning._pow2(q), tuning._pow2(n))


def test_parse_key_rejects_malformed():
    for bad in ("nope", "a|b|c|d", "k|b|f32|qx|n8", "k|b|f32|q3|n8",
                "k|b|f32|q8|n8|extra"):
        with pytest.raises(ValueError):
            tuning.parse_key(bad)


def test_table_save_load_round_trip(tmp_path):
    t = _table_with("lb_batch", "cpu", 8, 65536, block_q=32, threads=256,
                    rows=2)
    path = str(tmp_path / "TUNING.json")
    t.save(path)
    back = tuning.TuningTable.load(path)
    assert back.version == tuning.TABLE_VERSION
    assert back.entries == t.entries
    raw = open(path).read()
    assert raw.endswith("\n") and json.loads(raw)["version"] == 1


# ------------------------------------------------------------- the registry
def test_registry_names_lattices_and_defaults():
    assert set(tuning.KERNELS) == set(jtuning.KERNELS)
    for name, spec in tuning.KERNELS.items():
        assert spec.name == name
        assert set(spec.defaults) == set(spec.candidates)
        assert 1 <= spec.points() <= tuning.MAX_POINTS
        for knob, value in spec.defaults.items():
            assert value in spec.candidates[knob]
        assert set(spec.layout) <= set(spec.defaults)
    assert tuning.validate(tuning.TuningTable(), {}) == []


# ------------------------------------------------------------- resolution
def test_miss_falls_back_to_registry_defaults(clean_table):
    for kernel, spec in tuning.KERNELS.items():
        assert tuning.resolve_blocks(
            kernel, q=8, n=4096, backend="cpu") == spec.defaults
        assert tuning.resolve_blocks(
            kernel, q=8, n=4096, device="cpu") == spec.defaults


def test_table_hit_supplies_tuned_shape():
    tuning.set_table(_table_with("lb_batch", "cpu", 8, 65536, block_q=32,
                                 threads=256, rows=2))
    try:
        got = tuning.resolve_blocks("lb_batch", q=8, n=65536, backend="cpu")
        assert got == {"block_q": 32, "threads": 256, "rows": 2}
        other = tuning.resolve_blocks("lb_batch", q=8, n=1024, backend="cpu")
        assert other == tuning.KERNELS["lb_batch"].defaults
        # another backend misses: a card other than the tuned one runs
        # the defaults
        assert tuning.resolve_blocks(
            "lb_batch", q=8, n=65536, backend="cuda-sm80") == \
            tuning.KERNELS["lb_batch"].defaults
    finally:
        tuning.set_table(None)


def test_explicit_kwarg_beats_table():
    tuning.set_table(_table_with("lb_batch", "cpu", 8, 65536, block_q=32,
                                 threads=256, rows=2))
    try:
        got = tuning.resolve_blocks("lb_batch", q=8, n=65536, backend="cpu",
                                    threads=128, rows=None)
        assert got == {"block_q": 32, "threads": 128, "rows": 2}
    finally:
        tuning.set_table(None)


def test_unknown_knob_rejected(clean_table):
    with pytest.raises(ValueError, match="no tunable"):
        tuning.resolve_blocks("euclid", q=1, n=64, backend="cpu", block_q=8)


def test_missing_table_file_degrades_to_defaults(monkeypatch, tmp_path):
    monkeypatch.setenv(tuning.TABLE_ENV, str(tmp_path / "absent.json"))
    tuning.set_table(None)
    try:
        assert tuning.get_table().entries == {}
        assert tuning.resolve_blocks("euclid", q=1, n=64, backend="cpu") == {
            "threads": 256, "rows_per_warp": 4}
    finally:
        tuning.set_table(None)


def test_launch_shape_refuses_unadmitted_values(clean_table):
    with pytest.raises(ValueError, match="not an admitted"):
        tuning.launch_shape("lb_batch", "cpu", q=8, n=64, threads=96)
    with pytest.raises(ValueError, match="not an admitted"):
        tuning.launch_shape("euclid", "cpu", q=8, n=64, rows_per_warp=3)
    # the packed layout is the caller's data, not a launch knob
    got = tuning.launch_shape("lb_multi", "cpu", q=8, n=64, block_n=64)
    assert got["block_n"] == 64


# -------------------------------------------------------------- the search
def test_hillclimb_converges_to_planted_optimum():
    lattice = (64, 128, 256, 512, 1024, 2048)

    def cost(params):  # V-shaped around 512, big (>>min_gain) steps
        return 1.0 + abs(np.log2(params["threads"]) - np.log2(512))

    best, best_cost, history = coordinate_descent(
        cost, {"threads": 64}, {"threads": lattice}, min_gain=0.03)
    assert best == {"threads": 512} and best_cost == 1.0
    assert len(history) <= len(lattice)


def test_hillclimb_noise_below_min_gain_stays_at_defaults():
    def cost(params):  # a dead knob: +-1% deterministic "noise"
        return 100.0 * (1.0 + 0.01 * ((params["threads"] // 128) % 3 - 1))

    best, _, _ = coordinate_descent(
        cost, {"threads": 256}, {"threads": (128, 256, 512, 1024)},
        min_gain=0.03)
    assert best == {"threads": 256}


def test_snap_to_lattice():
    assert snap_to_lattice(300, (64, 256, 1024)) == 256
    assert snap_to_lattice(640, (256, 1024)) == 256  # tie -> smaller
    for v in (0, 1, 3, 100, 700, 5000):
        lat = (2, 3, 0)
        assert snap_to_lattice(v, lat) == jhill.snap_to_lattice(v, lat)


def _surfaces():
    """Cost surfaces over every registered kernel's lattice, deterministic:
    a planted optimum, a flat one, noise under min_gain, and a plateau."""
    def planted(spec):
        far = {k: v[-1] for k, v in spec.candidates.items()}
        return lambda p: 10.0 + sum(abs(p[k] - far[k]) for k in p)

    def noisy(spec):
        return lambda p: 100.0 * (1.0 + 0.01 * (sum(p.values()) % 3 - 1))

    def stairs(spec):
        return lambda p: 50.0 - sum(spec.candidates[k].index(p[k])
                                    for k in p) * 5.0

    return {"planted": planted, "flat": lambda s: (lambda p: 7.0),
            "noisy": noisy, "stairs": stairs}


@pytest.mark.parametrize("surface", ["planted", "flat", "noisy", "stairs"])
def test_coordinate_descent_takes_the_references_trajectory(surface):
    for name, spec in tuning.KERNELS.items():
        cost = _surfaces()[surface](spec)
        ours = coordinate_descent(cost, dict(spec.defaults), spec.candidates,
                                  min_gain=0.03)
        theirs = jhill.coordinate_descent(
            cost, dict(spec.defaults), spec.candidates, min_gain=0.03)
        assert ours == theirs, name


def test_autotune_with_stub_timer_plants_optimum():
    def timer(params):
        return 10.0 + abs(params["block_q"] - 32) + \
            abs(params["threads"] - 256) / 64 + params["rows"]

    res = tuning.autotune("lb_batch", q=8, n=65536, backend="cpu",
                          timer=timer)
    assert res.params == {"block_q": 32, "threads": 256, "rows": 0}
    assert res.key == "lb_batch|cpu|f32|q8|n65536"
    assert res.evals >= 1 and res.default_us_per_call >= res.us_per_call
    entry = res.entry("auto", "NVIDIA H100 80GB HBM3", "700.00 W")
    assert entry["block_q"] == 32 and entry["impl"] == "auto"
    assert entry["card"] == "NVIDIA H100 80GB HBM3"
    assert entry["power_limit"] == "700.00 W"


def test_retune_covers_canonical_grid_and_diffs():
    def timer_for(kernel, *, q, n):
        return lambda params: 100.0  # flat surface: stays at defaults

    old = _table_with("lb_batch", "cpu", 8, 65536, block_q=32, threads=256,
                      rows=2)
    table, diffs = tuning.retune(
        table=old, backend="cuda-sm90", timer_for=timer_for,
        card="NVIDIA H100 80GB HBM3", power_limit="700.00 W")
    want = sum(len(s.canonical) for s in tuning.KERNELS.values())
    assert len(diffs) == want == len(table.entries) - 1
    assert all(d["old"] is None for d in diffs)
    assert table.entries["lb_batch|cpu|f32|q8|n65536"] == \
        old.entries["lb_batch|cpu|f32|q8|n65536"]  # other backends kept
    assert len(old.entries) == 1  # the table given is not modified
    for name, spec in tuning.KERNELS.items():
        for q, n in spec.canonical:
            entry = table.lookup(name, "cuda-sm90", "f32", q, n)
            for knob, default in spec.defaults.items():
                assert entry[knob] == default
            assert entry["card"] and entry["power_limit"]
    del table.entries["lb_batch|cpu|f32|q8|n65536"]
    assert tuning.validate(table) == []
    table2, diffs2 = tuning.retune(
        table=table, backend="cuda-sm90", timer_for=timer_for,
        card="NVIDIA H100 80GB HBM3", power_limit="700.00 W")
    assert all(d["old"] is not None for d in diffs2)


# -------------------------------------------------------------- validation
def test_validate_flags_stale_and_malformed():
    problems = tuning.validate(tuning.TuningTable())
    want = sum(len(s.canonical) for s in tuning.KERNELS.values())
    assert len(problems) == want
    assert all("stale table" in p for p in problems)

    t = _table_with("no_such_kernel", "cpu", 8, 65536, threads=8)
    assert any("not in the registry" in p for p in tuning.validate(t))

    t = _table_with("lb_batch", "cpu", 8, 65536, block_q=3, threads=128,
                    rows=0)
    assert any("not in the candidate lattice" in p
               for p in tuning.validate(t))

    t = _table_with("lb_batch", "cpu", 8, 65536, block_q=64, threads=128)
    assert any("missing knob 'rows'" in p for p in tuning.validate(t))

    t = _table_with("euclid", "cuda-sm90", 64, 4096, threads=256,
                    rows_per_warp=4)
    assert any("name the card" in p for p in tuning.validate(t))

    t = tuning.TuningTable(version=0)
    assert any("version" in p for p in tuning.validate(t))

    wide = dict(tuning.KERNELS)
    wide["paa_isax"] = tuning.KernelSpec(
        "paa_isax", {"threads": 256},
        {"threads": tuple(range(32, 1056, 32))}, ())
    assert any("lattice points" in p
               for p in tuning.validate(tuning.TuningTable(), wide))


def test_committed_table_is_valid_and_covers_the_card(capsys):
    table = tuning.TuningTable.load(tuning.default_table_path())
    assert tuning.validate(table) == []
    for name, spec in tuning.KERNELS.items():
        for q, n in spec.canonical:
            entry = table.lookup(name, "cuda-sm90", "f32", q, n)
            assert entry is not None, (name, q, n)
            assert entry["card"] and entry["power_limit"]
            assert entry["us_per_call"] <= entry["default_us_per_call"]
    assert not any(tuning.parse_key(k)[1] == "cpu" for k in table.entries)
    tuning.main(["--validate"])  # the CLI gate: returns, no SystemExit
    assert "tuning table ok" in capsys.readouterr().out


# ------------------------------------------------- the wrappers' launches
class _Lib:
    """Stands in for the built library: records each C entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrappers' CUDA checks and library, replaced so that they run on
    CPU tensors; every launch lands in the returned recorder."""
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "require", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return lib


def _launch_all(q=8, n=700, w=16):
    """One call of each tunable wrapper on CPU tensors; its knobs resolve
    for the CPU backend."""
    rng = np.random.default_rng(3)
    sax = torch.from_numpy(rng.integers(0, 256, (n, w), dtype=np.uint8))
    qp = torch.from_numpy(rng.standard_normal((q, w), dtype=np.float32))
    bpp = isax.padded_breakpoints(256)
    raw = torch.from_numpy(random_walk(64, 256, seed=4))
    lower_bound.lower_bound_sq_batch_cuda(qp, sax, bpp, 256)
    lower_bound.lower_bound_sq_cuda(qp[0].contiguous(), sax, bpp, 256)
    sax_p = torch.cat([sax, sax.new_zeros((-n % 128, w))])
    lens = torch.full((sax_p.shape[0] // 128,), 128, dtype=torch.int32)
    lower_bound.lower_bound_sq_multi_cuda(qp, sax_p, bpp, 256, lens, 128)
    pos = torch.zeros((q, 300), dtype=torch.int32)
    euclidean.euclid_sq_gather_cuda(raw[:q].contiguous(), raw, pos)
    paa_isax.paa_isax_cuda(raw, isax.gaussian_breakpoints(256), w, False)


# The shapes every kernel launched at before they were tunable: kQueryBlock
# 64, kThreads 128 and kRows<W> (rows 0) of the batch bounds, the single
# query's 512 threads at the occupancy's blocks an SM (0), euclid_sq_gather's
# 256 threads of 4 rows a warp, paa_isax's 256 threads.
UNTUNED_SHAPES = {
    "lower_bound_sq_batch_launch": {"block_q": 64, "threads": 128, "rows": 0},
    "lower_bound_sq_launch": {"threads": 512, "blocks_per_sm": 0},
    "lower_bound_sq_multi_launch": {"block_q": 64, "threads": 128, "rows": 0},
    "euclid_sq_gather_launch": {"threads": 256, "rows_per_warp": 4},
    "paa_isax_launch": {"threads": 256},
}


def _shape_args(call):
    """The launch-shape arguments of one recorded C call, by name."""
    name, args = call
    knobs = list(UNTUNED_SHAPES[name])
    return name, dict(zip(knobs, args[-1 - len(knobs):-1]))


def test_empty_table_launches_the_untuned_shapes(fake_lib, clean_table):
    _launch_all()
    got = dict(_shape_args(c) for c in fake_lib.calls)
    assert got == UNTUNED_SHAPES
    for spec in tuning.KERNELS.values():  # rows 0 is the width's kRows
        assert all(v in spec.candidates[k] for k, v in spec.defaults.items())
    assert (tuning.default_rows(16), tuning.default_rows(32)) == (4, 2)


def test_table_entry_drives_the_launch(fake_lib):
    t = _table_with("lb_batch", "cpu", 8, 700, block_q=32, threads=256,
                    rows=2)
    t.entries.update(_table_with("euclid", "cpu", 8, 300, threads=128,
                                 rows_per_warp=8).entries)
    t.entries.update(_table_with("lb_single", "cpu", 1, 700, threads=256,
                                 blocks_per_sm=3).entries)
    t.entries.update(_table_with("paa_isax", "cpu", 1, 64,
                                 threads=1024).entries)
    t.entries.update(_table_with("lb_multi", "cpu", 8, 768, block_q=64,
                                 threads=256, rows=2, block_n=256).entries)
    tuning.set_table(t)
    try:
        _launch_all()
        got = dict(_shape_args(c) for c in fake_lib.calls)
        assert got["lower_bound_sq_batch_launch"] == {
            "block_q": 32, "threads": 256, "rows": 2}
        assert got["euclid_sq_gather_launch"] == {
            "threads": 128, "rows_per_warp": 8}
        assert got["lower_bound_sq_launch"] == {
            "threads": 256, "blocks_per_sm": 3}
        assert got["paa_isax_launch"] == {"threads": 1024}
        # the packed layout stays the buffer's (128), the launch is tuned
        multi = [a for n, a in fake_lib.calls
                 if n == "lower_bound_sq_multi_launch"][0]
        assert multi[9] == 128
        assert got["lower_bound_sq_multi_launch"] == {
            "block_q": 64, "threads": 256, "rows": 2}
        # an explicit kwarg wins over the table, through ops as well
        fake_lib.calls.clear()
        rng = np.random.default_rng(5)
        sax = torch.from_numpy(rng.integers(0, 256, (700, 16),
                                            dtype=np.uint8))
        qp = torch.from_numpy(rng.standard_normal((8, 16), dtype=np.float32))
        lower_bound.lower_bound_sq_batch_cuda(
            qp, sax, isax.padded_breakpoints(256), 256, threads=128)
        assert _shape_args(fake_lib.calls[0])[1] == {
            "block_q": 32, "threads": 128, "rows": 2}
    finally:
        tuning.set_table(None)


def test_unadmitted_shape_raises_before_launching(fake_lib, clean_table):
    rng = np.random.default_rng(6)
    sax = torch.from_numpy(rng.integers(0, 256, (300, 16), dtype=np.uint8))
    qp = torch.from_numpy(rng.standard_normal((4, 16), dtype=np.float32))
    bpp = isax.padded_breakpoints(256)
    for kw in (dict(threads=64), dict(rows=4), dict(block_q=16)):
        with pytest.raises(ValueError, match="not an admitted"):
            lower_bound.lower_bound_sq_batch_cuda(qp, sax, bpp, 256, **kw)
    with pytest.raises(ValueError, match="not an admitted"):
        lower_bound.lower_bound_sq_cuda(qp[0].contiguous(), sax, bpp, 256,
                                        threads=1024)
    assert fake_lib.calls == []


def _outputs(result):
    return result if isinstance(result, tuple) else (result,)


@pytest.mark.parametrize("kernel", sorted(tuning.KERNELS))
def test_tuned_shapes_leave_the_plain_path_bit_exact(kernel, clean_table):
    """On the CPU every launch knob is dead: any admitted point gives the
    default's bits (the card test holds the kernels to the same rule)."""
    spec = tuning.KERNELS[kernel]
    q, n = (4, 500) if kernel != "paa_isax" else (1, 300)
    run = tuning.kernel_runner(kernel, q=q, n=n, raw_rows=2000, device="cpu")
    base = _outputs(run())
    for knob, values in spec.candidates.items():
        if knob in spec.layout:
            continue
        for v in values:
            got = _outputs(run({knob: v}))
            assert all(torch.equal(a, b) for a, b in zip(base, got))


def test_measure_kernel_times_the_plain_version_on_cpu():
    us = tuning.measure_kernel("lb_batch", q=2, n=256, repeats=1, warmup=0,
                               calls=1, device="cpu")
    assert us > 0


# --------------------------------------------------- the search layer
def _small(n=1500, length=64, seed=8):
    return build_index(random_walk(n, length, seed=seed), segments=16,
                       device="cpu")


def test_pack_components_resolves_block_via_table():
    index = _small(700)
    tuning.set_table(_table_with("lb_multi", "cpu", tuning.PACK_Q, 700,
                                 block_q=64, threads=128, rows=0,
                                 block_n=256))
    try:
        assert search.pack_components([(index, 0)]).block == 256
        assert MutableIndex(index, device="cpu").pack_block == 256
        assert MutableIndex(index, device="cpu", pack_block=64).pack_block \
            == 64
    finally:
        tuning.set_table(None)
    assert search.pack_components([(index, 0)], block=128).block == 128
    assert search.pack_components([(index, 0)]).block == 128  # no cpu rows


def test_packers_read_the_committed_canonical_row():
    """The packers key ``block_n`` at a Q the table really holds: the Q of
    ``lb_multi``'s canonical cell, whose committed card row they read."""
    spec = tuning.KERNELS["lb_multi"]
    canon = [n for q, n in spec.canonical if q == tuning.PACK_Q]
    assert canon
    table = tuning.TuningTable.load(tuning.default_table_path())
    for n in canon:
        entry = table.lookup("lb_multi", "cuda-sm90", "f32", tuning.PACK_Q, n)
        assert entry is not None and entry["block_n"] in \
            spec.candidates["block_n"]


def test_launch_shape_is_resolved_once_until_set_table(monkeypatch):
    calls = []
    real = tuning.resolve_blocks

    def counting(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(tuning, "resolve_blocks", counting)
    tuning.set_table(_table_with("euclid", "cpu", 8, 4096, threads=128,
                                 rows_per_warp=8))
    try:
        for r in (4096, 3000, 4096):  # one (Q, N) bucket
            shape = tuning.launch_shape("euclid", "cpu", q=7, n=r,
                                        threads=None, rows_per_warp=None)
            assert shape == {"threads": 128, "rows_per_warp": 8}
            shape["threads"] = 1  # the caller's copy, not the memo
        assert len(calls) == 1
        # an explicit kwarg is its own memo entry, and still wins
        assert tuning.launch_shape("euclid", "cpu", q=8, n=4096,
                                   threads=256, rows_per_warp=None) == {
            "threads": 256, "rows_per_warp": 8}
        assert len(calls) == 2
        # another table: the next launch resolves against it
        tuning.set_table(tuning.TuningTable())
        assert tuning.launch_shape("euclid", "cpu", q=8, n=4096,
                                   threads=None, rows_per_warp=None) == \
            tuning.KERNELS["euclid"].defaults
        assert len(calls) == 3
    finally:
        tuning.set_table(None)


def test_refused_shape_is_refused_again(clean_table):
    for _ in range(2):  # a refusal is never memoized as a shape
        with pytest.raises(ValueError, match="not an admitted"):
            tuning.launch_shape("paa_isax", "cpu", q=1, n=64, threads=64)
