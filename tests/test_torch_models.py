"""The port's LM architecture zoo against the JAX package's, on the CPU.

Every architecture's smoke config: the JAX model's ``init_params(PRNGKey(0))``
goes through ``convert.model_from_arrays``, and the same numpy batch (made
from a seed) goes through both models. Tolerances, stated once:

- float32: rtol = atol = 1e-4 on logits, aux and every cache leaf (the two
  differ by the order of float sums, ~1e-6 here);
- bfloat16 (granite's smoke config): rtol 2e-2 and atol 2e-2 of the
  largest absolute logit. The port rounds each op to bfloat16 as JAX's
  layer functions do, op by op (``layers.silu``, ``gelu_tanh``), but the
  JAX model runs its layers inside ``lax.scan``, whose compiled fusions
  skip some of those roundings: JAX's own scan and its own unrolled layers
  differ by up to 0.035 on logits of size 4 here.

MoE routing is held both dropless (capacity factor 16) and at the default
1.25, where assignments are dropped (checked): a different drop would move
the output by a whole expert's contribution, far outside 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import Model as JModel
from repro.models import layers as jlayers
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.serving.kv_cache import pad_cache_to as jpad
from repro_torch import configs as tconfigs
from repro_torch.convert import _leaf, cache_from_arrays, model_from_arrays
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.serving.kv_cache import pad_cache_to as tpad

F32 = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
DECODERS = [a for a in jconfigs.ARCH_IDS
            if not jconfigs.get_smoke_config(a).is_encoder]


@functools.lru_cache(maxsize=None)
def _params(arch):
    """JAX's ``init_params(PRNGKey(0))`` for a smoke config (the fields the
    tests override change no shape), initialized once per architecture."""
    cfg = jconfigs.get_smoke_config(arch)
    return jax.jit(JModel(cfg, remat=False).init_params)(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _models(arch, over=()):
    """(cfg, JAX model, JAX params, port model) for a smoke config."""
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **dict(over))
    params = _params(arch)
    tm = model_from_arrays(cfg, jax.tree.map(np.asarray, params), CPU)
    return cfg, JModel(cfg, remat=False), params, tm


@functools.lru_cache(maxsize=None)
def _jit(arch, over, name):
    """JAX's ``Model.<name>`` for a smoke config, jitted once, so that the
    tests that call it share its compiled code."""
    return jax.jit(getattr(_models(arch, over)[1], name))


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
        if cfg.frontend == "vision":
            out["vision_embeds"] = (0.1 * rng.standard_normal(
                (b, cfg.vision_tokens, cfg.frontend_dim))).astype(np.float32)
    return out


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tx(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i"
                                else v) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _close_tree(got, want, path="", **tol):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close_tree(got[k], want[k], f"{path}/{k}", **tol)
        return
    assert tuple(got.shape) == tuple(want.shape), path
    assert got.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32,
                         "int32": torch.int64}[np.dtype(want.dtype).name], path
    np.testing.assert_allclose(_np(got), _np(want), err_msg=path, **tol)


def _load(module, tree):
    """Fill a port layer module with a JAX layer's parameter dict."""
    for name, p in module.named_parameters():
        p.data = torch.from_numpy(np.array(_leaf(tree, name), np.float32))
    return module


# ---------------------------------------------------------------------------
# Config registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ALL_IDS)
def test_config_registry_matches_jax(arch):
    assert tconfigs.ALL_IDS == jconfigs.ALL_IDS
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if arch == "paris":
            continue
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        for i in range(got.num_layers):
            assert got.layer_is_global(i) == want.layer_is_global(i)
        assert {k: dataclasses.asdict(v) for k, v in
                tconfigs.SHAPES.items()} == {
            k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
        for name in jconfigs.SHAPES:
            assert tconfigs.shape_applicable(got, tconfigs.SHAPES[name]) == \
                jconfigs.shape_applicable(want, jconfigs.SHAPES[name])


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_apply_matches_jax(arch):
    over = (("dtype", "float32"),)
    cfg, jm, params, tm = _models(arch, over)
    batch = _batch(cfg)
    jl, _, jaux = _jit(arch, over, "apply")(params, _jx(batch))
    tl, _, taux = tm.apply(_tx(batch))
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    _close(tl, jl, **F32)
    _close(taux, jaux, **F32)


@functools.lru_cache(maxsize=None)
def _prefill_decode(arch, over, s=16, pad=4):
    """Prefill s-1 tokens, pad the cache to s + pad, decode token s-1, in
    both packages; the JAX cache goes through ``pad_cache_to`` (JAX's) and
    the port's through its own. Computed once per (arch, over): the tests
    that read it share it. ``padded_cache`` is JAX's cache as decode reads
    it."""
    cfg, _, params, tm = _models(arch, over)
    batch = _batch(cfg, s=s)
    pre = dict(batch, tokens=batch["tokens"][:, :s - 1])
    jl, jc = _jit(arch, over, "prefill")(params, _jx(pre))
    tl, tc = tm.prefill(_tx(pre))
    out = {"prefill": (tl, jl), "prefill_cache": (tc, jc)}
    jc, tc = jpad(jc, s + pad), tpad(tc, s + pad)
    last = batch["tokens"][:, s - 1:]
    jd, jc2 = _jit(arch, over, "decode_step")(
        params, {"tokens": jnp.asarray(last)}, jc, jnp.int32(s - 1))
    td, tc2 = tm.decode_step(_tx({"tokens": last}), tc, s - 1)
    out.update(decode=(td, jd), decode_cache=(tc2, jc2), padded_cache=jc,
               last=last, position=s - 1)
    return out


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_pad_decode_matches_jax(arch):
    res = _prefill_decode(arch, (("dtype", "float32"),))
    _close(*res["prefill"], **F32)
    _close_tree(*res["prefill_cache"], **F32)
    _close(*res["decode"], **F32)
    _close_tree(*res["decode_cache"], **F32)


@pytest.mark.parametrize("arch,dtype", [("jamba-v0.1-52b", "float32"),
                                        ("granite-34b", "bfloat16")])
def test_decode_from_a_jax_cache(arch, dtype):
    """``cache_from_arrays`` carries JAX's cache (bf16 leaves included)
    into the port's decode; the port's decode then reads the same cache
    JAX's decode reads."""
    over = (("dtype", dtype),) if dtype == "float32" else ()
    cfg, _, _, tm = _models(arch, over)
    assert cfg.dtype == dtype
    res = _prefill_decode(arch, over)  # JAX's prefill, pad and decode
    jc = res["padded_cache"]
    tc = cache_from_arrays(jax.tree.map(np.asarray, jc), CPU)
    _close_tree(tc, jc, rtol=0, atol=0)
    _, jd = res["decode"]
    td, _ = tm.decode_step(_tx({"tokens": res["last"]}), tc, res["position"])
    if dtype == "float32":
        _close(td, jd, **F32)
    else:
        _close(td, jd, rtol=2e-2, atol=2e-2 * float(np.abs(_np(jd)).max()))


def test_bfloat16_granite_matches_jax():
    cfg, jm, params, tm = _models("granite-34b")
    assert cfg.dtype == "bfloat16"
    batch = _batch(cfg)
    jl, _, _ = _jit("granite-34b", (), "apply")(params, _jx(batch))
    tl, _, _ = tm.apply(_tx(batch))
    assert tl.dtype == torch.bfloat16
    scale = float(np.abs(_np(jl)).max())
    _close(tl, jl, rtol=2e-2, atol=2e-2 * scale)
    res = _prefill_decode("granite-34b", ())
    for key in ("prefill", "decode"):
        got, want = res[key]
        _close(got, want, rtol=2e-2, atol=2e-2 * float(np.abs(
            _np(want)).max()))
    for key in ("prefill_cache", "decode_cache"):
        got, want = res[key]
        _close_tree(got, want, rtol=2e-2, atol=2e-2 * float(np.abs(
            _np(want["blocks"]["k"])).max()))


def test_cast_split_matches_jax():
    """Exactly the leaves JAX's ``_cast`` casts are bfloat16 in the port."""
    cfg, jm, params, tm = _models("jamba-v0.1-52b")
    from repro.models.model import _cast
    cast = _cast(params, jnp.bfloat16)
    for name, p in tm.named_parameters():
        node = cast
        for part in name.split("."):
            if not part.isdigit():
                node = node[part]
            elif isinstance(node, list):
                node = node[int(part)]
        want = torch.bfloat16 if node.dtype == jnp.bfloat16 else torch.float32
        assert p.dtype == want, name
    _, _, params_p, tm_p = _models("deepseek-moe-16b")
    assert tm_p.prefix[0].ln1.scale.dtype == torch.float32  # 1-D, unstacked
    assert tm_p.blocks[0].ln1.scale.dtype == torch.bfloat16  # (L, d) in JAX
    assert tm_p.final_norm.scale.dtype == torch.float32


@pytest.mark.parametrize("arch,s", [("granite-34b", 32), ("gemma3-27b", 30),
                                    ("hubert-xlarge", 30)])
def test_flash_path_matches_jax(arch, s):
    over = (("dtype", "float32"), ("attn_dense_threshold", 8),
            ("attn_flash_q_block", 8), ("attn_flash_kv_block", 8))
    cfg, jm, params, tm = _models(arch, over)
    batch = _batch(cfg, s=s)
    jl, jc, _ = jax.jit(jm.apply)(params, _jx(batch))
    tl, tc, _ = tm.apply(_tx(batch))
    _close(tl, jl, **F32)
    _close_tree(tc, jc, **F32)


@pytest.mark.parametrize("causal,window",
                         [(True, 0), (True, 10), (False, 18)],
                         ids=["causal", "causal_window", "window"])
@pytest.mark.parametrize("q_block,k_block", [(8, 8), (4, 16), (16, 4)])
def test_flash_block_skip_is_bitwise(causal, window, q_block, k_block):
    """Skipping the kv blocks that every query of a block masks changes no
    bit of the output: the same inputs with every block visited."""
    rng = np.random.default_rng(15)
    b, s, h, kv, hd = 2, 37, 4, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, hd)).astype(
        np.float32)) for n in (h, kv, kv))
    pos = torch.arange(s)
    for dt in (torch.float32, torch.bfloat16):
        args = (q.to(dt), k.to(dt), v.to(dt), pos, pos, causal, window,
                q_block, k_block)
        got = tlayers._sdpa_flash(*args)
        want = tlayers._sdpa_flash(*args, skip_masked=False)
        assert got.dtype == dt and torch.equal(got, want)


@functools.lru_cache(maxsize=None)
def _granite_prefilled():
    """11 tokens of granite's float32 smoke config, the first 10 prefilled
    in both packages and each cache padded to 16; shared by the cases."""
    cfg, jm, params, tm = _models("granite-34b", (("dtype", "float32"),))
    tokens = _batch(cfg, s=11)["tokens"]
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(tokens[:, :10])})
    _, tc = tm.prefill(_tx({"tokens": tokens[:, :10]}))
    return tokens, jpad(jc, 16), tpad(tc, 16)


@pytest.mark.parametrize("cache_pos", [(10, 7), (15, 20), 20],
                         ids=["per_row", "per_row_past_end", "scalar_past_end"])
def test_cache_position_paths_match_jax(cache_pos):
    """Per-slot (B,) write positions, and writes past the cache end, which
    clamp so that the update fits (as ``dynamic_update_slice`` does)."""
    cfg, jm, params, tm = _models("granite-34b", (("dtype", "float32"),))
    tokens, jc, tc = _granite_prefilled()
    cp = np.asarray(cache_pos)
    pos = np.broadcast_to(cp, (2,))[:, None]
    step = {"tokens": tokens[:, 10:], "positions": pos.astype(np.int32)}
    jl, jc2, _ = jm.apply(params, _jx(step), jc, jnp.asarray(cp, jnp.int32))
    tcp = torch.from_numpy(cp) if cp.ndim else int(cp)
    tl, tc2, _ = tm.apply(_tx(step), tc, tcp)
    _close(tl, jl, **F32)
    _close_tree(tc2, jc2, **F32)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b",
                                  "jamba-v0.1-52b"])
def test_moe_dropless_matches_jax(arch):
    cfg, jm, params, tm = _models(arch, (("dtype", "float32"),
                                         ("capacity_factor", 16.0)))
    batch = _batch(cfg)
    jl, _, jaux = jax.jit(jm.apply)(params, _jx(batch))
    tl, _, taux = tm.apply(_tx(batch))
    _close(tl, jl, **F32)
    _close(taux, jaux, **F32)


@pytest.mark.parametrize("cf", [16.0, 1.25])
def test_moe_core_drops_match_jax(cf):
    d, f, e, k, t = 32, 48, 8, 2, 64
    p = jax.jit(jmoe.init_moe, static_argnums=(1, 2, 3, 4))(
        jax.random.PRNGKey(3), d, f, e, 1)
    # Tokens near one common state route alike, so the default capacity
    # drops assignments.
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(d) + 0.3 * rng.standard_normal(
        (2, t // 2, d))).astype(np.float32)
    jo, jaux = jax.jit(functools.partial(
        jmoe.moe_ffn, num_experts=e, top_k=k, capacity_factor=cf))(
            p, jnp.asarray(x))
    tp = _load(tmoe.MoE(tlayers.Init(CPU, None), d, f, e, 1),
               jax.tree.map(np.asarray, p))
    to, taux = tmoe.moe_ffn(tp, torch.from_numpy(x), num_experts=e, top_k=k,
                            capacity_factor=cf)
    _close(to, jo, **F32)
    _close(taux, jaux, **F32)
    # How many assignments the capacity drops (from JAX's routing).
    probs = jax.nn.softmax(jnp.asarray(x).reshape(t, d) @ p["router"])
    _, idx = jax.lax.top_k(probs, k)
    load = np.bincount(np.asarray(idx).ravel(), minlength=e)
    capacity = max(int(k * t * cf / e), 4)
    dropped = int(np.maximum(load - capacity, 0).sum())
    assert (dropped > 0) == (cf == 1.25), (load, capacity)


def test_moe_top_k_ties_toward_lower_index():
    x = torch.tensor([[0.25, 0.5, 0.25, 0.5, 0.0]])
    vals, idx = tmoe._top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 3, 0]]
    _close(vals, jv, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    norm = _load(tlayers.RMSNorm(tlayers.Init(CPU, None), 64),
                 {"scale": scale})
    _close(tlayers.rmsnorm(norm, torch.from_numpy(x)), want, **F32)


@pytest.mark.parametrize("sections", [None, (2, 3, 3), "rope"])
def test_rope_matches_jax(sections):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    if sections == "rope":
        pos, sections = rng.integers(0, 50, (2, 9)), None
    else:
        pos = rng.integers(0, 50, (2, 9, 3))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                              1e4, sections)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4,
                             sections)
    _close(got, want, **F32)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_jax(mlp_type, dtype):
    p = jlayers.init_mlp(jax.random.PRNGKey(7), 32, 96, mlp_type)
    x = np.random.default_rng(8).standard_normal((2, 5, 32)).astype(
        np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jlayers.mlp(jax.tree.map(lambda a: a.astype(jdt), p),
                       jnp.asarray(x).astype(jdt), mlp_type)
    mod = _load(tlayers.MLP(tlayers.Init(CPU, None), 32, 96, mlp_type),
                jax.tree.map(np.asarray, p)).to(tdt)
    got = tlayers.mlp(mod, torch.from_numpy(x).to(tdt), mlp_type)
    assert got.dtype == tdt
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    _close(got, want, **tol)


def test_ssm_chunked_matches_jax():
    rng = np.random.default_rng(9)
    b, s, c, n = 2, 24, 16, 4
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    dt = (0.1 * np.abs(rng.standard_normal((b, s, c)))).astype(np.float32)
    bt = rng.standard_normal((b, s, n)).astype(np.float32)
    ct = rng.standard_normal((b, s, n)).astype(np.float32)
    a = np.tile(np.arange(1, n + 1, dtype=np.float32), (c, 1))
    h0 = rng.standard_normal((b, c, n)).astype(np.float32)
    jy, jh = jax.jit(jmamba._ssm_chunked, static_argnums=6)(
        *map(jnp.asarray, (x, dt, bt, ct, a, h0)), 8)
    ty, th = tmamba._ssm_chunked(*map(torch.from_numpy, (x, dt, bt, ct, a,
                                                         h0)), 8)
    _close(ty, jy, **F32)
    _close(th, jh, **F32)


def test_mamba_decode_step_matches_jax():
    p = jax.jit(jmamba.init_mamba, static_argnums=(1, 2))(
        jax.random.PRNGKey(10), 16, 4)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 1, 16)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 32)).astype(np.float32)
    ssm = rng.standard_normal((2, 32, 4)).astype(np.float32)
    jy, (jc, js) = jax.jit(functools.partial(jmamba.mamba_block, d_state=4))(
        p, jnp.asarray(x), state=(jnp.asarray(conv), jnp.asarray(ssm)))
    mod = _load(tmamba.Mamba(tlayers.Init(CPU, None), 16, 4),
                jax.tree.map(np.asarray, p))
    ty, (tc, ts) = tmamba.mamba_block(mod, torch.from_numpy(x), d_state=4,
                                      state=(torch.from_numpy(conv),
                                             torch.from_numpy(ssm)))
    for got, want in ((ty, jy), (tc, jc), (ts, js)):
        _close(got, want, **F32)


def test_wkv_chunked_matches_jax():
    rng = np.random.default_rng(12)
    b, s, h, d = 2, 24, 2, 8
    r, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    logw = -np.abs(rng.standard_normal((b, s, h, d))).astype(np.float32)
    logw = np.maximum(logw, -2.0)
    u = (0.1 * rng.standard_normal((h, d))).astype(np.float32)
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32)
    jo, js = jax.jit(jrwkv._wkv_chunked, static_argnums=6)(
        *map(jnp.asarray, (r, k, v, logw, u, s0)), 8)
    to, ts = trwkv._wkv_chunked(*map(torch.from_numpy, (r, k, v, logw, u,
                                                        s0)), 8)
    _close(to, jo, **F32)
    _close(ts, js, **F32)


def test_rwkv_timemix_decode_matches_jax():
    p = jax.jit(jrwkv.init_rwkv_timemix, static_argnums=(1, 2))(
        jax.random.PRNGKey(13), 32, 8)
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    last = rng.standard_normal((2, 32)).astype(np.float32)
    st = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    jy, (jl, js) = jax.jit(functools.partial(jrwkv.rwkv_timemix, head_dim=8))(
        p, jnp.asarray(x), state=(jnp.asarray(last), jnp.asarray(st)))
    mod = _load(trwkv.TimeMix(tlayers.Init(CPU, None), 32, 8),
                jax.tree.map(np.asarray, p))
    ty, (tl, ts) = trwkv.rwkv_timemix(mod, torch.from_numpy(x), head_dim=8,
                                      state=(torch.from_numpy(last),
                                             torch.from_numpy(st)))
    for got, want in ((ty, jy), (tl, jl), (ts, js)):
        _close(got, want, **F32)
