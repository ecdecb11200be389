"""Port parity, the launch tools: repro_torch.launch against repro.launch.

One JAX subprocess (512 forced host devices, ``eval_shape`` only, nothing
compiled) builds the reference's cells with ``repro.launch.specs`` and
writes, for every argument leaf, its global shape, dtype,
``PartitionSpec`` and per-device ``shard_shape``, and each cell's
``meta`` and ``model_flops``, to a JSON file under ``tmp_path``. The port
builds the same cells with ``repro_torch.launch.specs`` in this process,
as rank 0 of a ``fake`` process group of 512 ranks (started and destroyed
by one module fixture), on fake ``cuda`` tensors: every leaf must have
the same global shape and dtype, the same spec (the stacking axes of the
reference's scanned leaves dropped: the port keeps one tensor a layer),
placements that follow from that spec, and a rank-0 block equal to
``shard_shape``; and every cell the same ``meta`` and ``model_flops``.
Building a cell allocates nothing and runs no step (that is
``tests/test_torch_dryrun.py``).

The variant sweep's table and its printed line equal the reference's, and
``roofline.kernel_cost`` gives the kernel table's bounds in ``PERF.md``
(``chip_smoke.py``'s phase 6 shapes) to the last digit.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (arch, shape, mesh): every granite-34b shape, one of each other arch, the
# paris cells, and one multi-pod cell.
CELLS = [
    ("granite-34b", "train_4k", "single"),
    ("granite-34b", "prefill_32k", "single"),
    ("granite-34b", "decode_32k", "single"),
    ("granite-34b", "long_500k", "single"),  # skipped by both
    ("granite-34b", "train_4k", "multi"),
    ("gemma3-27b", "long_500k", "single"),
    ("internlm2-20b", "prefill_32k", "single"),
    ("starcoder2-15b", "decode_32k", "single"),
    ("hubert-xlarge", "train_4k", "single"),
    ("olmoe-1b-7b", "train_4k", "single"),
    ("deepseek-moe-16b", "decode_32k", "single"),
    ("jamba-v0.1-52b", "long_500k", "single"),
    ("qwen2-vl-2b", "prefill_32k", "single"),
    ("rwkv6-1.6b", "decode_32k", "single"),
    ("paris", "search", "single"),
    ("paris", "build", "single"),
]

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax
    from repro.launch import roofline, specs
    from repro.launch.mesh import make_production_mesh

    def key(k):
        for a in ("key", "idx", "name"):
            if hasattr(k, a):
                return getattr(k, a)
        return str(k)

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    out = {}
    for arch, shape, mesh_kind in json.loads(sys.argv[1]):
        mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
        name = f"{arch}/{shape}/{mesh_kind}"
        try:
            cell = specs.build_cell(arch, shape, mesh)
        except ValueError as e:
            out[name] = {"skip": str(e)}
            continue
        leaves = jax.tree_util.tree_flatten_with_path(cell.args)[0]
        shards = jax.tree_util.tree_leaves(cell.in_shardings)
        assert len(leaves) == len(shards), name
        args = {}
        for (path, leaf), sh in zip(leaves, shards):
            args[json.dumps([key(k) for k in path])] = dict(
                shape=list(leaf.shape), dtype=str(leaf.dtype),
                spec=spec(sh), shard=list(sh.shard_shape(leaf.shape)))
        m = cell.meta
        mf = None
        if m.get("kind") in ("train", "prefill", "decode"):
            mf = roofline.model_flops(
                m["params"], m["active_params"], m["tokens"],
                "train" if m["kind"] == "train" else "serve")
        out[name] = dict(args=args, meta=m, model_flops=mf)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, json.dumps(CELLS)], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    path = tmp_path_factory.mktemp("launch") / "reference.json"
    path.write_text(out.stdout.strip().splitlines()[-1])
    return json.loads(path.read_text())


_PORT_SCRIPT = textwrap.dedent("""
    import json, sys
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.layers import is_dtensor
    from repro_torch.models.model import jax_leaf
    from repro_torch.training import sharding

    def leaves(cell):
        # (JAX tree path, stacking depth, tensor, NamedSharding)
        kind = cell.meta["kind"]
        out = []
        if kind == "search":
            dindex, query = cell.args
            ish, qsh = cell.in_shardings
            for f in ("sax", "raw_sorted", "pos"):
                out.append(([0, f], 0, getattr(dindex, f), getattr(ish, f)))
            return out + [([1], 0, query, qsh)]
        if kind == "build":
            return [([0], 0, cell.args[0], cell.in_shardings[0])]
        params, pshard = cell.args[0], cell.in_shardings[0]
        for name, p in params.items():
            path, stack = jax_leaf(name)
            out.append(([0, *path], len(stack), p, pshard[name]))
        at = 1
        if kind == "train":
            opt, osh = cell.args[1], cell.in_shardings[1]
            out.append(([1, "step"], 0, opt.step, osh.step))
            for field in ("mu", "nu"):
                for name, t, sh in zip(params, getattr(opt, field),
                                       getattr(osh, field)):
                    path, stack = jax_leaf(name)
                    out.append(([1, field, *path], len(stack), t, sh))
            at = 2
        for k, t in cell.args[at].items():
            out.append(([at, k], 0, t, cell.in_shardings[at][k]))
        if kind == "decode":
            def walk(tree, sh, path):
                for k, v in tree.items():
                    if isinstance(v, dict):
                        walk(v, sh[k], path + [k])
                    else:
                        out.append((path + [k], 0, v, sh[k]))
            walk(cell.args[2], cell.in_shardings[2], [2])
            out.append(([3], 0, cell.args[3], cell.in_shardings[3]))
        return out

    out = {}
    with dryrun.fake_world():
        for arch, shape, mesh_kind in json.loads(sys.argv[1]):
            mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
            name = f"{arch}/{shape}/{mesh_kind}"
            try:
                with FakeTensorMode(allow_non_fake_inputs=True):
                    cell = (specs.build_paris_cell(shape, mesh)
                            if arch == "paris"
                            else specs.build_cell(arch, shape, mesh))
                    rows = []
                    for path, depth, t, sh in leaves(cell):
                        dt = is_dtensor(t)
                        rows.append(dict(
                            path=path, depth=depth, shape=list(t.shape),
                            dtype=str(t.dtype).replace("torch.", ""),
                            spec=[list(e) if isinstance(e, tuple) else e
                                  for e in sh.spec],
                            local=list((t.to_local() if dt else t).shape),
                            dtensor=dt,
                            placed=(not dt) or tuple(t.placements) ==
                            sharding.spec_placements(sh.mesh, sh.spec)))
                    out[name] = dict(leaves=rows, meta=cell.meta)
            except ValueError as e:
                out[name] = {"skip": str(e)}
            finally:
                sharding.clear_logical_rules()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def port():
    """The port's cells, built in one process of their own: the fake
    process group and the fake CUDA stand-in (a PyTorch without CUDA)
    stay there."""
    from repro_torch.launch import fake_cuda

    env = fake_cuda.child_env()
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-c", _PORT_SCRIPT, json.dumps(CELLS)], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _norm(spec, ndim):
    """A spec padded to ``ndim`` entries, each a tuple of axis names."""
    spec = list(spec) + [None] * (ndim - len(spec))
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


@pytest.mark.parametrize("arch,shape,mesh_kind", CELLS,
                         ids=["/".join(c) for c in CELLS])
def test_cell_matches_reference(reference, port, arch, shape, mesh_kind):
    name = f"{arch}/{shape}/{mesh_kind}"
    ref, got = reference[name], port[name]
    if "skip" in ref:
        assert "cell skipped" in got.get("skip", ""), got
        return
    assert "skip" not in got, got
    assert got["meta"] == ref["meta"]
    mf = ref["model_flops"]
    if mf is not None:
        m = got["meta"]
        assert roofline.model_flops(
            m["params"], m["active_params"], m["tokens"],
            "train" if m["kind"] == "train" else "serve") == mf
    seen = set()
    for leaf in got["leaves"]:
        key, d = json.dumps(leaf["path"]), leaf["depth"]
        assert key in ref["args"], key
        want = ref["args"][key]
        seen.add(key)
        assert leaf["shape"] == want["shape"][d:], key
        assert leaf["dtype"] == want["dtype"], key
        jspec = _norm(want["spec"], len(want["shape"]))[d:]
        assert _norm(leaf["spec"], len(leaf["shape"])) == jspec, key
        assert leaf["placed"], key  # placements follow from the spec
        assert leaf["local"] == want["shard"][d:], key
        if not leaf["dtensor"]:  # a plain tensor is replicated
            assert all(not e for e in jspec), key
    # every reference leaf is covered (a scanned one by a tensor a layer)
    assert seen == set(ref["args"])


def test_variants_match_reference():
    from repro.launch import hillclimb as jhc

    from repro_torch.launch import hillclimb

    assert hillclimb.VARIANTS == jhc.VARIANTS


@pytest.mark.parametrize("rec", [
    dict(status="ok", roofline=dict(compute_s=0.0123, memory_s=1.5,
                                    collective_s=0.25, dominant="memory_s"),
         memory=dict(peak_estimate_bytes=3 * 2**30 + 12345),
         model_flops_ratio=0.75),
    dict(status="error", error="RuntimeError: " + "x" * 300)],
    ids=["ok", "error"])
def test_show_prints_reference_line(rec):
    from repro.launch import hillclimb as jhc

    from repro_torch.launch import hillclimb

    lines = []
    for mod in (jhc, hillclimb):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.show(rec, "baseline")
        lines.append(buf.getvalue())
    assert lines[0] == lines[1]


def test_hillclimb_imports_nothing():
    """Importing the module does not import the dry-run, the cell builder
    or the fake CUDA stand-in: the sweep imports them when it runs."""
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.launch.hillclimb; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "'repro_torch.launch.') and m.split('.')[-1] in "
            "('dryrun', 'specs', 'fake_cuda')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr[-2000:]


# The kernel table's bounds in PERF.md (chip_smoke.py phase 6 and 7 shapes:
# N = 2^24 series of 256, w = 16, 257 padded breakpoints, Q = 64).
N, Q, W, L, BP = 1 << 24, 64, 16, 256, 257


@pytest.mark.parametrize("name,shape,bound_ms,by", [
    ("paa_isax", dict(b=N, n=L, w=W, n_bp=BP - 2), 5.528969398208956,
     "bytes"),
    ("lower_bound_sq_batch", dict(q=Q, n_rows=N, w=W, n_bp=BP),
     1.5545217451940299, "operations"),
    ("euclid_sq", dict(q=Q, r=4096, n=L, rows_read=259818),
     0.08006457313432835, "bytes"),
    ("lower_bound_sq", dict(n_rows=N, w=W, n_bp=BP), 0.10016280955223882,
     "bytes"),
    ("lower_bound_sq_multi", dict(q=Q, n_pad=16777344, w=W, n_bp=BP,
                                  blocks=16777344 // 128, real_rows=N),
     1.5545217451940299, "operations"),
    ("euclid_min", dict(b=N, n=L), 5.128319467462687, "bytes"),
])
def test_kernel_cost_gives_perf_table_bounds(name, shape, bound_ms, by):
    cost = roofline.kernel_cost(name, **shape)
    got, got_by = roofline.bound_seconds(cost["bytes"], cost["ops"])
    assert got * 1e3 == pytest.approx(bound_ms, rel=1e-12)
    assert got_by == by


def test_lower_bound_batch_cost_spelled_out():
    cost = roofline.kernel_cost("lower_bound_sq_batch", q=Q, n_rows=N, w=W,
                                n_bp=BP)
    assert cost["ops"] == Q * N * (6 * W + 1)  # 104 G fp32 operations
    assert round(cost["ops"] / 1e9) == 104
    assert cost["bytes"] == Q * W * 4 + N * W + BP * 4 + Q * N * 4


def test_roofline_terms_use_the_h100_peaks():
    rep = roofline.RooflineReport(
        flops=3e12, hbm_bytes=6.7e12, collective_bytes=1e11,
        flops_by_dtype={"bf16": 989e12 * 2, "fp32": 67e12},
        collective_by_link={"nvlink": 450e9, "ib": 50e9})
    t = rep.terms_seconds()
    assert t["compute_s"] == pytest.approx(3.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(2.0)
    assert rep.dominant == "compute_s"
    js = rep.to_json()
    for k in ("flops", "hbm_bytes", "collective_bytes", "collective_by_op",
              "collective_count", "dot_flops_top", "hbm_top",
              "unknown_trip_bodies", "compute_s", "memory_s",
              "collective_s", "dominant"):
        assert k in js


def test_model_flops_matches_reference():
    from repro.launch import roofline as jroof

    for kind in ("train", "serve"):
        assert roofline.model_flops(10, 7, 1000, kind) == jroof.model_flops(
            10, 7, 1000, kind)


def test_dot_flops_counted_exactly():
    """The counterpart of the reference's HLO test: a (64, 128) x (128,
    32) product counts 2 m k n FLOPs, fp32, and its bytes."""
    m, k, n = 64, 128, 32
    a, b = torch.ones(m, k), torch.ones(k, n)
    with roofline.CostMode() as cm:
        a @ b
    rep = cm.report()
    assert rep.flops == 2 * m * k * n
    assert rep.flops_by_dtype == {"fp32": 2 * m * k * n}
    assert rep.hbm_bytes == 4 * (m * k + k * n + m * n)


def test_loop_body_counted_every_trip():
    """The counterpart of the scan test: an eager loop's body counts once
    a trip (PyTorch runs it; there is no trip count to read)."""
    trips, d = 9, 32
    h, xs = torch.ones(d, d), torch.ones(trips, d, d)
    with roofline.CostMode() as cm:
        for x in xs:
            h = h @ x
    assert cm.report().flops == trips * 2 * d ** 3
