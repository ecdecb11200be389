"""Port parity, sharded training: repro_torch's mesh against repro's rules.

The placement policy is held to the JAX package's exactly: every
parameter's spec (``param_pspec``, the stacking axes dropped), the
activation rules and the KV-cache specs, for every architecture of the zoo
(smoke configs) over meshes (2, 2), (4, 2), (1, 4) and (8, 1). The JAX
functions read only ``mesh.shape``, so a stand-in with a ``shape`` dict
serves both.

The sharded runs use ``gloo`` ranks on the CPU (``spawn_mesh``, one spawn
per world size in a module fixture, every case inside; rank entry point
``sharding.run_plan``). JAX runs on one device, in process. Bounds,
stated once:

- internlm2 smoke in float32 on a (2, 2) mesh, ``synthetic_batch(0, 4,
  16)``, warmup 0 of 10: loss and every parameter within 1e-4 of the JAX
  single-device step (the JAX test's bounds, ``tests/test_distributed.py``);
- the same with 2 microbatches and int8 gradients, against the port's
  single-process step: the same bounds;
- olmoe smoke on a (4, 2) mesh at capacity 64: local against global
  dispatch within 1e-3 (the JAX test's bound), global against the
  unsharded model within 1e-4;
- local dispatch at olmoe's own capacity (drops happen) against JAX's
  ``_moe_core`` on each group's rows on one device: the same slots, and
  outputs within 1e-5;
- checkpoints: an arange saved from a (4,) mesh restores onto (2, 2)
  exactly; a train state saved from (2, 2) restores onto (4, 1) and onto
  one process exactly, and its files are byte-identical to the JAX
  package's ``checkpoint.save`` of the same values.

Nothing here checks speed.
"""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.serving import kv_cache as jkv
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import sharding as jsm
from repro.training import train_step as jts
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import distributed as tdist
from repro_torch.launch import mesh as tmesh
from repro_torch.models import Model as TModel
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models.model import jax_leaf, jax_shape
from repro_torch.serving import kv_cache as tkv
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import sharding as tsm
from repro_torch.training import train_step as tts

MESHES = ((2, 2), (4, 2), (1, 4), (8, 1))
AXES = (("data", "model"), (None, "model"), ("data", None), (None, None))
TOL = 1e-4  # loss and parameters, as the JAX test
MOE_TOL = 1e-3  # local against global logits, as the JAX test
GROUP_TIMEOUT_S = 30  # a collective that waits this long fails its rank
JOIN_TIMEOUT_S = 55  # a mesh that hangs fails the test within a minute


def _stand_in(shape):
    return types.SimpleNamespace(shape={"data": shape[0], "model": shape[1]})


def _norm(spec):
    """A spec with each one-name tuple written as the name (the JAX
    package's ``PartitionSpec`` stores ("data",) as "data")."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


# ---------------------------------------------------------------------------
# (i)-(iii): the policy, exactly as the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_pspec_matches_jax(arch):
    sds = jax.eval_shape(JModel(jconfigs.get_smoke_config(arch)).init_params,
                         jax.random.PRNGKey(0))
    leaves = {jsm._path_str(p): (p, leaf) for p, leaf in
              jax.tree_util.tree_flatten_with_path(sds)[0]}
    model = TModel(tconfigs.get_smoke_config(arch), device="cpu")
    n = 0
    for shape in MESHES:
        mesh = _stand_in(shape)
        for fsdp, tp in AXES:
            for name, p in model.named_parameters():
                path, stack = jax_leaf(name)
                jpath, jleaf = leaves["/".join(str(k) for k in path)]
                assert tuple(jleaf.shape) == jax_shape(model, name, p)
                want = tuple(jsm.param_pspec(jpath, jleaf, fsdp_axis=fsdp,
                                             tp_axis=tp, mesh=mesh))
                got = tsm.param_pspec(name, jax_shape(model, name, p),
                                      fsdp_axis=fsdp, tp_axis=tp, mesh=mesh)
                assert got == want[len(stack):], (name, shape, fsdp, tp)
                n += 1
    assert n == len(MESHES) * len(AXES) * len(list(model.parameters()))


@pytest.mark.parametrize("batch_axes", [("data",), ("pod", "data"), ()])
def test_activation_rules_match_jax(batch_axes):
    for shape in MESHES:
        mesh = _stand_in(shape)
        assert tsm.activation_rules(mesh, batch_axes) == \
            jsm.activation_rules(mesh, batch_axes)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cache_pspec_tree_matches_jax(arch):
    jcfg, tcfg = (jconfigs.get_smoke_config(arch),
                  tconfigs.get_smoke_config(arch))
    jcache = jax.eval_shape(lambda: JModel(jcfg).init_cache(2, 8))
    tcache = TModel(tcfg, device="cpu").init_cache(2, 8)
    for model_size in (1, 2, 4):
        for seq_axes in ((), ("model",), ("data", "model")):
            for batch_axes in (("data",), ("pod", "data")):
                want = jkv.cache_pspec_tree(jcache, jcfg, batch_axes, "model",
                                            model_size, seq_axes)
                got = tkv.cache_pspec_tree(tcache, tcfg, batch_axes, "model",
                                           model_size, seq_axes)
                flat = jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]
                assert len(flat) == len(list(_walk(got)))
                for path, spec in flat:
                    node = got
                    for k in path:
                        node = node[k.key]
                    assert _norm(node) == tuple(spec), (path, model_size,
                                                        seq_axes)


def _walk(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _walk(v)
        else:
            yield v


def test_logical_is_the_identity_without_rules():
    x = torch.randn(2, 3, 4)
    assert tlayers._LOGICAL_RULES is None
    assert tlayers.logical(x, "batch", "seq", "embed") is x


def test_logical_ignores_plain_tensors_under_rules():
    tsm.use_logical_rules(_stand_in((2, 2)), ("data",))
    try:
        x = torch.randn(2, 3, 4)
        assert tlayers.logical(x, "batch", "seq", "embed") is x
    finally:
        tsm.clear_logical_rules()
    assert tlayers._LOGICAL_RULES is None


def test_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        tmesh.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        tmesh.make_production_mesh(multi_pod=True, device_type="cpu")


def test_batch_axes_of():
    for names, want in ((("data", "model"), ("data",)),
                        (("pod", "data", "model"), ("pod", "data")),
                        (("model",), ())):
        assert tmesh.batch_axes_of(types.SimpleNamespace(
            mesh_dim_names=names)) == want


# ---------------------------------------------------------------------------
# The sharded runs
# ---------------------------------------------------------------------------

OCFG = dict(warmup_steps=0, total_steps=10)
INTERN = dataclasses.replace(jconfigs.get_smoke_config("internlm2-20b"),
                             dtype="float32")
T_INTERN = dataclasses.replace(tconfigs.get_smoke_config("internlm2-20b"),
                               dtype="float32")
T_OLMOE = dataclasses.replace(tconfigs.get_smoke_config("olmoe-1b-7b"),
                              dtype="float32", capacity_factor=64.0)
MOE_LAYER = dict(d=32, f=48, e=8, k=2, rows=8, seq=16)


@functools.lru_cache(maxsize=None)
def _intern_init():
    return jax.tree.map(np.asarray, jax.jit(
        JModel(INTERN, remat=False).init_params)(jax.random.PRNGKey(0)))


def _intern_batch():
    return jdata.synthetic_batch(0, 4, 16, INTERN.vocab_size)


@functools.lru_cache(maxsize=None)
def _jax_intern_step():
    """The JAX single-device step (the JAX test's reference): its state
    after one step as numpy, and its loss."""
    params = jax.tree.map(jnp.asarray, _intern_init())
    tcfg = jts.TrainConfig(optimizer=jopt.OptimizerConfig(**OCFG))
    p, o, m = jax.jit(jts.make_train_step(JModel(INTERN, remat=False),
                                          tcfg))(
        params, jopt.init_opt_state(params),
        {k: jnp.asarray(v) for k, v in _intern_batch().items()})
    return jax.tree.map(np.asarray, (p, o)), float(m["loss"])


@functools.lru_cache(maxsize=None)
def _moe_layer_inputs():
    c = MOE_LAYER
    p = jax.tree.map(np.asarray, jax.jit(
        jmoe.init_moe, static_argnums=(1, 2, 3))(
            jax.random.PRNGKey(3), c["d"], c["f"], c["e"]))
    # Tokens near one common state route alike: the capacity drops some.
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(c["d"]) + 0.3 * rng.standard_normal(
        (c["rows"], c["seq"], c["d"]))).astype(np.float32)
    return p, x


def _micro_int8_tcfg():
    return tts.TrainConfig(optimizer=topt.OptimizerConfig(**OCFG),
                           microbatches=2, grad_compression="int8")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The world-4 spawn: (iv), (v) and (viii)."""
    d = tmp_path_factory.mktemp("shard4")
    tcfg = tts.TrainConfig(optimizer=topt.OptimizerConfig(**OCFG))
    jstate, _ = _jax_intern_step()
    plan = [
        ("step", "train", dict(cfg=T_INTERN, tcfg=tcfg, shape=(2, 2),
                               init=_intern_init(), batches=[_intern_batch()],
                               return_state=True)),
        ("micro_int8", "train", dict(cfg=T_INTERN, tcfg=_micro_int8_tcfg(),
                                     shape=(2, 2), init=_intern_init(),
                                     batches=[_intern_batch()],
                                     return_state=True)),
        ("ckpt", "ckpt", dict(arange_dir=str(d / "arange"),
                              arange_shape=(2, 2), cfg=T_INTERN,
                              init=_intern_init(), state=jstate,
                              save_shape=(2, 2), restore_shape=(4, 1),
                              state_dir=str(d / "state"))),
    ]
    ranks = tdist.spawn_mesh(
        tsm.run_plan, 4, backend="gloo", init_method=f"file://{d}/store",
        timeout=GROUP_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S, device="cpu",
        args=(plan,))
    return dict(ranks=ranks, dir=d)


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """The world-8 spawn: (vi) and (vii)."""
    d = tmp_path_factory.mktemp("shard8")
    p, x = _moe_layer_inputs()
    c = MOE_LAYER
    tokens = np.random.default_rng(1).integers(
        0, T_OLMOE.vocab_size, (8, 16)).astype(np.int64)
    plan = [
        ("moe", "moe", dict(cfg=T_OLMOE, shape=(4, 2), init=0,
                            tokens=tokens, dispatch=("global", "local"))),
        ("layer", "moe_layer", dict(
            shape=(4, 2), dims=(c["d"], c["f"], c["e"]), params=p, x=x,
            top_k=c["k"], capacity_factor=tconfigs.get_smoke_config(
                "olmoe-1b-7b").capacity_factor, dispatch="local")),
    ]
    ranks = tdist.spawn_mesh(
        tsm.run_plan, 8, backend="gloo", init_method=f"file://{d}/store",
        timeout=GROUP_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S, device="cpu",
        args=(plan,))
    return dict(ranks=ranks, tokens=tokens)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_leaves_with_path(tree)]


def _params_close(got, want, tol):
    got, want = _leaves(got[0]), _leaves(want[0])
    assert [p for p, _ in got] == [p for p, _ in want]
    worst = 0.0
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        worst = max(worst, float(np.abs(g.astype(np.float64) - w).max()))
    assert worst < tol, worst


def test_sharded_step_matches_jax_single_device(world4):
    jstate, jloss = _jax_intern_step()
    for r in world4["ranks"]:  # every rank reports the same metrics
        assert r["step"]["losses"] == world4["ranks"][0]["step"]["losses"]
    got = world4["ranks"][0]["step"]
    assert abs(got["losses"][0] - jloss) < TOL
    _params_close(got["state"], jstate, TOL)
    assert got["collectives"] > 0


def test_sharded_state_is_a_quarter_a_rank(world4):
    model = TModel(T_INTERN, device="cpu")
    full = 12 * sum(p.numel() for p in model.parameters())  # p, mu, nu
    held = [r["step"]["state_bytes"] for r in world4["ranks"]]
    assert sum(held) >= full  # norms are replicated on every rank
    assert max(held) < 0.3 * full


def test_sharded_microbatches_int8_match_one_process(world4):
    model = convert.model_from_arrays(T_INTERN, _intern_init(), "cpu")
    model.remat = False
    state = tts.init_train_state(model)
    state, m = tts.make_train_step(model, _micro_int8_tcfg())(
        state, {k: torch.from_numpy(v) for k, v in _intern_batch().items()})
    got = world4["ranks"][0]["micro_int8"]
    assert abs(got["losses"][0] - float(m["loss"])) < TOL
    assert abs(got["grad_norms"][0] - float(m["grad_norm"])) < TOL
    _params_close(got["state"], convert.train_state_to_arrays(state), TOL)


def test_elastic_arange_restores_across_mesh_shapes(world4):
    out = world4["ranks"][0]["ckpt"]
    assert all(r["ckpt"]["arange_equal"] for r in world4["ranks"])
    assert out["arange_placements"] == "(Shard(dim=0), Shard(dim=1))"
    jdir = world4["dir"] / "arange_jax"
    jckpt.save(str(jdir), 1, {"w": np.arange(64, dtype=np.float32).reshape(
        8, 8)})
    _same_files(world4["dir"] / "arange" / "step_00000001",
                jdir / "step_00000001")


def test_train_state_resumes_onto_another_mesh_and_one_process(world4):
    jstate, _ = _jax_intern_step()
    out = world4["ranks"][0]["ckpt"]
    assert out["restored_step"] == 2
    restored = out["restored"]  # resumed onto (4, 1)
    for (pa, a), (pb, b) in zip(_leaves(restored), _leaves(jstate)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # onto one process
    state = tts.init_train_state(TModel(T_INTERN, device="cpu"))
    _, step = tckpt.restore_latest(str(world4["dir"] / "state"), state)
    assert step == 2
    for (_, a), (_, b) in zip(_leaves(convert.train_state_to_arrays(state)),
                              _leaves(jstate)):
        np.testing.assert_array_equal(a, b)
    # the files are the JAX package's save of the same values
    jdir = world4["dir"] / "state_jax"
    jckpt.save(str(jdir), 2, jstate)
    _same_files(world4["dir"] / "state" / "step_00000002",
                jdir / "step_00000002")


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_moe_local_dispatch_matches_global(world8):
    out = world8["ranks"][0]["moe"]
    err = float(np.max(np.abs(out["global"] - out["local"])))
    assert err < MOE_TOL, err
    # global dispatch over the mesh is the unsharded model
    model = TModel(T_OLMOE, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _ = model.forward_train(
            {"tokens": torch.from_numpy(world8["tokens"])})
    np.testing.assert_allclose(out["global"], want.numpy(), rtol=0,
                               atol=TOL)


def _jax_slots(p, x, e, k, cf):
    """The JAX package's ``_moe_core`` routing (its own lines), up to the
    buffer row of each sorted assignment (-1: dropped)."""
    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax((jnp.asarray(x).reshape(t, -1) @ p["router"])
                           .astype(jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    capacity = max(int(k * t * cf / e), 4)
    e_flat = expert_idx.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted = jnp.take(e_flat, order)
    seg_start = jnp.searchsorted(e_sorted, jnp.arange(e), side="left")
    rank_sorted = jnp.arange(t * k) - jnp.take(seg_start, e_sorted)
    keep = rank_sorted < capacity
    return np.asarray(jnp.where(keep, e_sorted * capacity + rank_sorted, -1))


def test_local_dispatch_with_drops_matches_jax_per_group(world8):
    c = MOE_LAYER
    cf = tconfigs.get_smoke_config("olmoe-1b-7b").capacity_factor
    p, x = _moe_layer_inputs()
    groups = 4  # the data axis of the (4, 2) mesh
    rows = c["rows"] // groups
    layer = tmoe.MoE(tlayers.Init(torch.device("cpu"), None), c["d"], c["f"],
                     c["e"])
    for name, param in layer.named_parameters():
        param.data = torch.from_numpy(np.array(p[name]))
    want, dropped = [], 0
    for g in range(groups):
        xg = x[g * rows:(g + 1) * rows]
        out, _ = jax.jit(functools.partial(
            jmoe._moe_core, num_experts=c["e"], top_k=c["k"],
            capacity_factor=cf, renormalize=True))(
                {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(xg))
        want.append(np.asarray(out))
        jslot = _jax_slots(p, xg, c["e"], c["k"], cf)
        r = tmoe._route(layer.router.detach(), torch.from_numpy(
            xg.reshape(-1, c["d"])), num_experts=c["e"], top_k=c["k"],
            capacity_factor=cf, renormalize=True)
        tslot = torch.where(r["keep"], r["slot"], -1).numpy()
        np.testing.assert_array_equal(tslot, jslot)
        dropped += int((jslot < 0).sum())
    assert dropped > 0  # the config's capacity drops assignments
    got = world8["ranks"][0]["layer"]["out"]
    np.testing.assert_allclose(got, np.concatenate(want), rtol=0, atol=1e-5)
