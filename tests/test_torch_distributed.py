"""Port parity, the mesh: repro_torch's distributed against repro's.

The reference runs in ONE subprocess with 8 forced host devices, over
meshes of 4 and 1 devices, and writes every variant's answers to an .npz
(this module imports no JAX itself). The port runs the same arrays through
``spawn_mesh`` over ``gloo`` on the CPU, one spawn per world size with
every variant inside it (``run_plan``); its ``DistIndex`` is the
reference's, carried across by ``convert.dist_index_from_arrays``.

Data: N = 6001 random walks of n = 128 (world 4 pads 3 filler rows),
round 256, leaf cap 4, and 8 queries in the cold-BSF regime: stored series
plus noise of sigma 1.5, four on the raw series (they converge in a round)
and four on the z-normed ones (loose bounds: the batch forms run their
exactness fallback). Positions must be identical; distances bitwise where
the reference sums like the port (else rtol 1e-5); reads, updates and
rounds identical there too (``assert_count_parity``); every rank the same.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import distributed as tdist
from repro_torch.core.datagen import random_walk
from repro_torch.core.search import select_len

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LENGTH, ROUND, LEAF_CAP, N_Q = 6001, 128, 256, 4, 8
WORLDS = (4, 1)
FIELDS = ("dist_sq", "position", "raw_reads", "bsf_updates", "rounds")
KW = dict(round_size=ROUND, leaf_cap=LEAF_CAP)
# name -> (run_plan kind, kwargs); the reference script runs the same set.
VARIANTS = {
    "sort": ("search", dict(KW)),
    "topk": ("search", dict(KW, select="topk")),
    "nb": ("search", dict(KW, shared_bsf=False)),
    "bq_sort": ("search", dict(KW, batch_queries=N_Q)),
    "bq_topk": ("search", dict(KW, select="topk", batch_queries=N_Q)),
    "k1": ("batch", dict(KW, k=1)),
    "k8": ("batch", dict(KW, k=8)),
}
GROUP_TIMEOUT_S = 20  # a collective that waits this long fails its rank
JOIN_TIMEOUT_S = 55  # a mesh that hangs fails the test within a minute

REFERENCE = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from repro.core import build_index, distributed as dist
FIELDS = ("dist_sq", "position", "raw_reads", "bsf_updates", "rounds")
d = np.load(sys.argv[1])
raw, queries, rows = d["raw"], d["queries"], d["rows"]
kw = dict(series_length=raw.shape[1], round_size=int(d["round"]),
          leaf_cap=int(d["leaf_cap"]))
variants = {"sort": {}, "topk": dict(select="topk"),
            "nb": dict(shared_bsf=False),
            "bq_sort": dict(batch_queries=len(queries)),
            "bq_topk": dict(select="topk", batch_queries=len(queries))}
index = build_index(jnp.asarray(raw))
out = dict(sax=index.sax, pos=index.pos, offsets=index.bucket_offsets,
           raw=index.raw)
for world in (4, 1):
    mesh = jax.make_mesh((world,), ("shard",), devices=jax.devices()[:world])
    di = dist.dist_index_from(index, world)
    sh = dist.index_shardings(mesh, ("shard",))
    di = dist.DistIndex(
        sax=jax.device_put(di.sax, sh.sax),
        raw_sorted=jax.device_put(di.raw_sorted, sh.raw_sorted),
        pos=jax.device_put(di.pos, sh.pos), series_length=di.series_length,
        segments=di.segments, cardinality=di.cardinality)
    out.update({f"w{world}_dsax": di.sax, f"w{world}_draw": di.raw_sorted,
                f"w{world}_dpos": di.pos})
    results = {}
    for name, extra in variants.items():
        step = jax.jit(dist.make_distributed_search(mesh, ("shard",), **kw,
                                                    **extra))
        if "batch_queries" in extra:
            results[name] = step(di, jnp.asarray(queries))
        else:
            res = [step(di, jnp.asarray(q)) for q in queries]
            results[name] = {f: np.stack([np.asarray(getattr(r, f))
                                          for r in res]) for f in FIELDS}
    for k in (1, 8):
        step = jax.jit(dist.make_distributed_batch_search(mesh, ("shard",),
                                                          **kw, k=k))
        results[f"k{k}"] = step(di, jnp.asarray(queries))
    for name, res in results.items():
        for f in FIELDS:
            got = res[f] if isinstance(res, dict) else getattr(res, f)
            out[f"w{world}_{name}_{f}"] = got
    build = jax.jit(dist.make_distributed_build(mesh, ("shard",)))
    sax, keys = build(jnp.asarray(rows))
    out[f"w{world}_build_sax"], out[f"w{world}_build_keys"] = sax, keys
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def data():
    raw = random_walk(N, LENGTH, seed=5)
    rng = np.random.default_rng(7)
    base = raw[rng.integers(0, N, N_Q)].astype(np.float64)
    z = (base - base.mean(1, keepdims=True)) / base.std(1, keepdims=True)
    base[N_Q // 2:] = z[N_Q // 2:]
    queries = (base + 1.5 * rng.standard_normal(base.shape)).astype(
        np.float32)
    return dict(raw=raw, queries=queries, rows=random_walk(4096, LENGTH,
                                                           seed=6))


@pytest.fixture(scope="module")
def reference(data, tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ref")
    np.savez(d / "in.npz", round=ROUND, leaf_cap=LEAF_CAP, **data)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(d / "in.npz"),
         str(d / "out.npz")], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def port_dindex(ref, world):
    return convert.dist_index_from_arrays(
        ref[f"w{world}_dsax"], ref[f"w{world}_draw"], ref[f"w{world}_dpos"],
        LENGTH, 16, 256, device="cpu")


@pytest.fixture(scope="module")
def port(data, reference, tmp_path_factory):
    """world -> every rank's ``run_plan`` result."""
    d = tmp_path_factory.mktemp("mesh_port")
    plan = [(name, kind, kw) for name, (kind, kw) in VARIANTS.items()]
    plan.append(("build", "build", {}))
    return {world: tdist.spawn_mesh(
        tdist.run_plan, world, backend="gloo",
        init_method=f"file://{d}/store_w{world}", timeout=GROUP_TIMEOUT_S,
        join_timeout=JOIN_TIMEOUT_S, device="cpu",
        args=(port_dindex(reference, world), data["queries"], plan,
              torch.from_numpy(data["rows"])))
        for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_dist_index_from_matches_reference(reference, world):
    index = convert.index_from_arrays(
        reference["sax"], reference["pos"], reference["offsets"],
        reference["raw"], LENGTH, 16, 256, device="cpu")
    got = tdist.dist_index_from(index, world)
    assert got.num_rows == -(-N // world) * world
    np.testing.assert_array_equal(got.sax.numpy(), reference[f"w{world}_dsax"])
    np.testing.assert_array_equal(got.pos.numpy(), reference[f"w{world}_dpos"])
    np.testing.assert_array_equal(got.raw_sorted.numpy(),
                                  reference[f"w{world}_draw"])
    shards = [tdist.shard_of(got, r, world) for r in range(world)]
    assert torch.equal(torch.cat([s.pos for s in shards]), got.pos)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mesh_matches_reference(reference, port, world, variant):
    from test_torch_search import (assert_count_parity,
                                   reference_sums_like_port)

    got = port[world][0][variant]
    want = {f: reference[f"w{world}_{variant}_{f}"] for f in FIELDS}
    np.testing.assert_array_equal(got["position"], want["position"])
    assert got["position"].dtype == np.int32
    if reference_sums_like_port():
        np.testing.assert_array_equal(got["dist_sq"], want["dist_sq"])
    else:
        np.testing.assert_allclose(got["dist_sq"], want["dist_sq"], rtol=1e-5)
    for f in ("raw_reads", "bsf_updates", "rounds"):
        assert_count_parity(got[f], want[f])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_ranks_agree_and_single_runs_equal_batched(port, world):
    ranks = port[world]
    for other in ranks[1:]:
        for name in VARIANTS:
            for f in FIELDS:
                np.testing.assert_array_equal(other[name][f],
                                              ranks[0][name][f])
    # batch_queries answers each query as its own single-query run does.
    for single, batched in (("sort", "bq_sort"), ("topk", "bq_topk")):
        for f in FIELDS:
            np.testing.assert_array_equal(ranks[0][batched][f],
                                          ranks[0][single][f])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_batch_runs_the_exactness_fallback(port, world):
    n_local = -(-N // world)
    budget = tdist.SELECT_BUDGET_VALUES // (N_Q * LENGTH)
    sel = min(select_len(n_local, ROUND), max(ROUND, budget))
    assert sel < n_local
    for name in ("k1", "k8"):
        assert port[world][0][name]["rounds"] > math.ceil(sel / ROUND)
    # the z-normed half of the queries runs more rounds than the rest
    rounds = port[world][0]["sort"]["rounds"]
    assert rounds[N_Q // 2:].min() > rounds[:N_Q // 2].max()


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_build_matches_reference(reference, port, world):
    sax = np.concatenate([r["build"]["sax"] for r in port[world]])
    keys = np.concatenate([r["build"]["keys"] for r in port[world]])
    np.testing.assert_array_equal(sax, reference[f"w{world}_build_sax"])
    np.testing.assert_array_equal(
        keys.astype(np.int64),
        reference[f"w{world}_build_keys"].astype(np.int64))


def test_spawn_mesh_raises_a_rank_error(reference, tmp_path):
    with pytest.raises(RuntimeError, match="unknown plan step kind"):
        tdist.spawn_mesh(
            tdist.run_plan, 2, backend="gloo",
            init_method=f"file://{tmp_path}/store", timeout=GROUP_TIMEOUT_S,
            join_timeout=JOIN_TIMEOUT_S, device="cpu",
            args=(port_dindex(reference, 4), np.zeros((1, LENGTH),
                                                      np.float32),
                  [("bad", "no-such-kind", {})]))


def test_shard_rows_rejects_uneven_and_bad_ranks():
    x = torch.arange(10)
    with pytest.raises(ValueError, match="equal shards"):
        tdist.shard_rows(x, 0, 3)
    with pytest.raises(ValueError, match="outside"):
        tdist.shard_rows(x, 2, 2)
    assert torch.equal(tdist.shard_rows(x, 1, 2), torch.arange(5, 10))
