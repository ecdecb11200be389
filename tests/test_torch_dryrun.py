"""Port parity, the dry-run: repro_torch.launch.dryrun against the
reference's HLO roofline.

One module fixture runs the port's traces in a process of their own
(``fake_cuda.child_env``: the fake process group, and on a PyTorch built
without CUDA the preloaded stand-in, stay there): granite's smoke config
on a (1, 1) mesh as a prefill and a train cell, the same train cell on a
(2, 2) fake mesh, and the full paris search cell on a (2, 2) fake mesh.
Bounds, stated once:

- prefill: the counted FLOPs within 1% of ``repro.launch.roofline
  .analyze`` on the JAX cell's compiled HLO (one device), at a shape under
  the dense-attention threshold (the port's flash path skips the causal
  blocks above the diagonal, which the reference's computes);
- train: within 2%. The port's FLOPs are what eager PyTorch runs: the
  forward, the recomputed forward of every remat block and the backward.
  XLA compiles the same program but may drop or share work across the
  remat boundary, so the two counts differ by a few tenths of a percent
  here; 2% holds that gap with room and still fails a missing or doubled
  layer (a third of the smoke config's matmul FLOPs);
- the (2, 2) train cell issues collectives (bytes > 0), the search cell
  names its round's host read in ``unknown_trip_bodies``.

In this process: every ``torch.ops.repro_torch`` operator's fake output
has the shape and dtype of its plain version's output on the CPU, and
``FlopCounterMode`` counts it at ``roofline.kernel_cost``;
``sharding.local_block`` gives the same block under fake mode as outside
it; ``resolve_device("cuda")`` resolves under ``FakeTensorMode`` without a
card and raises outside it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFILL = (2, 64)  # rows x tokens: dense attention (threshold 2048)
TRAIN = (4, 64, 2)  # rows x tokens x microbatches

_PORT_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_debug_mesh

    (pb, ps), (tb, ts, tm) = json.loads(sys.argv[1])
    smoke = configs.get_smoke_config("granite-34b")
    over = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)}
    out = {}
    with dryrun.fake_world(8):
        for name, shape, kind, shape_cfg in (
                ("prefill11", (1, 1), "prefill",
                 ShapeConfig("t", ps, pb, "prefill")),
                ("train11", (1, 1), "train",
                 ShapeConfig("t", ts, tb, "train")),
                ("train22", (2, 2), "train",
                 ShapeConfig("t", ts, tb, "train"))):
            mesh = make_debug_mesh(shape)
            dp = shape[0]
            out[name] = dryrun.traced(lambda: specs.build_cell(
                "granite-34b", "t", mesh, overrides=over, shape=shape_cfg,
                microbatch_tokens_per_device=ts * tb // tm // dp),
                shape[0] * shape[1])
        mesh = make_debug_mesh((2, 2))
        out["search22"] = dryrun.traced(
            lambda: specs.build_paris_cell("search", mesh), 4)
    print(json.dumps(out, default=str))
""")


@pytest.fixture(scope="module")
def records():
    from repro_torch.launch import fake_cuda

    env = fake_cuda.child_env()
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-c", _PORT_SCRIPT, json.dumps([PREFILL, TRAIN])],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _jax_flops(kind: str) -> float:
    """The reference's HLO FLOPs of granite's smoke step on one device."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.launch import roofline as jroof
    from repro.models import Model
    from repro.serving.serve_step import make_prefill_step
    from repro.training import optimizer as jopt
    from repro.training.train_step import TrainConfig, make_train_step

    cfg = jconfigs.get_smoke_config("granite-34b")
    model = Model(cfg, remat=kind == "train")
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    if kind == "prefill":
        b, s = PREFILL
        params = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, jnp.bfloat16)
            if a.dtype == jnp.float32 and a.ndim > 1 else a, params)
        batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
        comp = jax.jit(make_prefill_step(model)).lower(params,
                                                       batch).compile()
    else:
        b, s, m = TRAIN
        opt = jax.eval_shape(jopt.init_opt_state, params)
        batch = {k: jax.ShapeDtypeStruct((b, s), jnp.int32)
                 for k in ("tokens", "labels")}
        step = make_train_step(model, TrainConfig(microbatches=m))
        comp = jax.jit(step).lower(params, opt, batch).compile()
    return jroof.analyze(comp.as_text(), 1).flops


def test_prefill_flops_match_reference_hlo(records):
    rec = records["prefill11"]
    assert rec["status"] == "ok"
    got, want = rec["roofline"]["flops"], _jax_flops("prefill")
    assert abs(got - want) / want < 0.01, (got, want)


def test_train_flops_match_reference_hlo(records):
    rec = records["train11"]
    assert rec["status"] == "ok"
    assert rec["meta"]["microbatches"] == TRAIN[2]
    got, want = rec["roofline"]["flops"], _jax_flops("train")
    assert abs(got - want) / want < 0.02, (got, want)


def test_sharded_train_cell_issues_collectives(records):
    rec = records["train22"]
    assert rec["status"] == "ok"
    r = rec["roofline"]
    assert r["collective_bytes"] > 0
    assert r["collective_count"]
    assert r["collective_s"] > 0
    # a (2, 2) mesh sits in one node: every collective rides NVLink
    assert set(r["collective_by_link"]) == {"nvlink"}
    # rank 0 holds a quarter of the sharded state, less than the whole
    one = records["train11"]["memory"]["argument_bytes"]
    assert rec["memory"]["argument_bytes"] < one
    assert rec["memory"]["peak_estimate_bytes"] > 0


def test_paris_search_lists_its_round(records):
    rec = records["search22"]
    assert rec["status"] == "ok"
    sites = rec["roofline"]["unknown_trip_bodies"]
    assert any("_local_exact_search" in s for s in sites), sites
    assert rec["meta"]["num_series"] == 100_000_000
    # rank 0's quarter of the index: sax, raw rows and positions
    n = 100_000_000 // 4
    assert rec["memory"]["argument_bytes"] == n * (16 + 256 * 4 + 4) \
        + 256 * 4
    assert rec["roofline"]["flops_by_dtype"]["fp32"] > 0  # the kernels


# --- in this process ---------------------------------------------------------

N, Q, W, L, R = 96, 3, 8, 64, 5


def _inputs():
    from repro_torch.core import isax

    g = torch.Generator().manual_seed(0)
    series = torch.randn(N, L, generator=g)
    bp = isax.gaussian_breakpoints(256)
    bpp = isax.padded_breakpoints(256)
    sax = torch.randint(0, 256, (N, W), generator=g, dtype=torch.uint8)
    qp = torch.randn(Q, W, generator=g)
    block_len = torch.tensor([32, 20, 32], dtype=torch.int32)
    pos = torch.randint(0, N, (Q, R), generator=g, dtype=torch.int32)
    queries = torch.randn(Q, L, generator=g)
    cases = {
        "paa_isax": ((series, bp, W, False), dict(b=N, n=L, w=W,
                                                   n_bp=255)),
        "lower_bound_sq_batch": ((qp, sax, bpp, L), dict(
            q=Q, n_rows=N, w=W, n_bp=257)),
        "lower_bound_sq": ((qp[0], sax, bpp, L), dict(n_rows=N, w=W,
                                                      n_bp=257)),
        "lower_bound_sq_multi": ((qp, sax, bpp, L, block_len, 32), dict(
            q=Q, n_pad=N, w=W, n_bp=257, blocks=3)),
        "euclid_sq_gather": ((queries, series, pos), dict(q=Q, r=R, n=L)),
        "euclid_min": ((queries[0], series), dict(b=N, n=L)),
        "select": ((series[:Q].abs(), 7), dict(q=Q, n=L, k=7)),
        "order_range": ((series[:Q].abs(), torch.arange(
            L, dtype=torch.int32).expand(Q, -1).contiguous(), 0, 5),
            dict(q=Q, n=L, m=5)),
    }
    return cases


def _plain(name, args):
    from repro_torch.kernels import ops

    fn = {"paa_isax": lambda s, bp, w, norm: ops.paa_isax(
              s, bp, w, normalize=norm, impl="ref"),
          "lower_bound_sq_batch": lambda *a: ops.lower_bound_sq_batch(
              *a, impl="ref"),
          "lower_bound_sq": lambda *a: ops.lower_bound_sq(*a, impl="ref"),
          "lower_bound_sq_multi": lambda q, s, b, n, bl, bn:
              ops.lower_bound_sq_multi(q, s, b, n, bl, block_n=bn,
                                       impl="ref"),
          "euclid_sq_gather": lambda *a: ops.euclid_sq_gather(*a,
                                                              impl="ref"),
          "euclid_min": lambda *a: ops.euclid_min(*a, impl="ref"),
          "select": lambda *a: ops.select(*a, impl="ref"),
          "order_range": lambda *a: ops.order_range(*a, impl="ref")}[name]
    return fn(*args)


@pytest.mark.parametrize("name", ["paa_isax", "lower_bound_sq_batch",
                                  "lower_bound_sq", "lower_bound_sq_multi",
                                  "euclid_sq_gather", "euclid_min",
                                  "select", "order_range"])
def test_op_fake_output_and_flops(name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    cpu_args, _ = _inputs()[name]  # made before the fake mode
    want = _plain(name, cpu_args)
    want = want if isinstance(want, tuple) else (want,)
    cost_name = "euclid_sq" if name == "euclid_sq_gather" else name
    cases = _inputs()
    with FakeTensorMode():
        args, cost = {k: (tuple(
            torch.empty(a.shape, dtype=a.dtype, device="cuda")
            if isinstance(a, torch.Tensor) else a for a in v[0]), v[1])
            for k, v in cases.items()}[name]
        with FlopCounterMode(display=False) as fc:
            got = getattr(torch.ops.repro_torch, name)(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == [
        (tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "cuda" for t in got)
    assert fc.get_total_flops() == roofline.kernel_cost(cost_name,
                                                        **cost)["ops"]


def test_op_on_a_cpu_tensor_has_no_kernel():
    """The operators are the card's path only: a CPU tensor reaches no
    implementation (``kernels/ops.py`` takes the plain version there)."""
    args, _ = _inputs()["lower_bound_sq_batch"]
    with pytest.raises(NotImplementedError):
        torch.ops.repro_torch.lower_bound_sq_batch(*args)


@pytest.fixture
def fake_group():
    from repro_torch.launch import dryrun

    with dryrun.fake_world(8):
        yield


@pytest.mark.parametrize("spec", [("data", "model"), (None, "model"),
                                  (("data", "model"), None), ()])
def test_local_block_same_under_fake_mode(fake_group, spec):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import sharding

    mesh = make_debug_mesh((2, 4), device_type="cpu")
    pl = sharding.spec_placements(mesh, spec)
    shape = (16, 24)
    real = sharding.local_block(shape, mesh, pl)
    with FakeTensorMode():
        fake = sharding.local_block(shape, mesh, pl)
    assert fake == real
    assert all(isinstance(s.start, int) for s in fake)


def test_resolve_device_cuda_only_under_fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.device import resolve_device

    with FakeTensorMode():
        dev = resolve_device("cuda")
        assert dev.type == "cuda" and dev.index is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_record_keeps_reference_keys(records):
    rec = records["prefill11"]
    for k in ("status", "memory", "roofline", "meta", "model_flops",
              "model_flops_ratio", "trace_s"):
        assert k in rec
    for k in ("argument_bytes", "output_bytes", "temp_bytes",
              "alias_bytes", "peak_estimate_bytes"):
        assert k in rec["memory"]
    assert dataclasses.fields(roofline.RooflineReport)
