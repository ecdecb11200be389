"""Config-driven model assembly for the architecture zoo.

The port of ``repro/models/model.py``: one :class:`Model` (an
``nn.Module`` that owns its parameters) covers all 10 architectures
through two layer-stack shapes:

  * homogeneous stack (dense / uniform-MoE / RWKV): a loop over
    ``blocks``, with an unrolled dense prefix (DeepSeek-MoE's
    first-k-dense layers) and a per-layer window schedule (Gemma-3's 5:1
    local:global attention);
  * period stack (Jamba): a loop over repeating periods whose body unrolls
    the (mamba x7 + attn x1, alternating MLP/MoE) pattern.

The JAX package scans over L-stacked parameters; here each layer is its
own module in an ``nn.ModuleList``, and ``convert.model_from_arrays`` takes
the stacked arrays apart. Cache trees keep the JAX layouts
(``serving/kv_cache.py`` lists them), so a cache can be carried between
the two packages leaf for leaf.

Where the cast happens: the JAX package's ``apply`` casts every float32
leaf of its *stacked* parameter tree with ``ndim > 1`` to the compute
dtype, on every call. The port casts once, when the model is built, and
keeps the same split: a parameter is cast when its rank in JAX's tree
(:func:`jax_rank`: its own ndim plus its stacking depth, 1 under
``blocks``, 2 under ``periods``, 0 elsewhere) is above 1. So under
bfloat16 the per-layer norm scales of ``blocks`` and ``periods`` are
bfloat16, as in JAX, while ``final_norm`` and the ``prefix`` layers' 1-D
leaves stay float32. Training keeps float32 masters of the cast leaves
(``training/train_step.py``), and its weight decay follows the same rank.

``remat`` (default on, as in JAX) recomputes each block of ``blocks``,
each period and each RWKV layer in the backward pass
(``torch.utils.checkpoint``), as ``jax.checkpoint`` wraps each scan step;
it acts only while a gradient is being recorded, so serving never sees it.

Under a mesh (``training/sharding.py``'s ``shard_model``) each parameter is
a DTensor placed by ``param_pspec``, and ``gather_keep`` names the mesh
dims whose placement a parameter keeps inside the forward (the
tensor-parallel ``model`` axis). Each layer redistributes its own
parameters to ``Replicate()`` on every other dim (the FSDP all-gather over
``data``) when it runs, inside the recomputed function, so remat gathers
them again in the backward pass, and their gradients come back
reduce-scattered into the stored placements. The forward then runs on
DTensors, with the logical annotations of ``layers.logical`` at the JAX
package's sites and plain constants (positions, masks) taken as
replicated.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import frontend, layers, mamba, moe, rwkv
from repro_torch.models.layers import Init


def jax_leaf(name: str) -> tuple:
    """Where parameter ``name`` (a ``named_parameters`` name) lives in the
    JAX package's tree: (the path of its leaf, its index along the leaf's
    stacking axes). A layer number indexes a list in JAX's tree under
    ``prefix`` and a stacking axis elsewhere: ``blocks.3.attn.wq`` is
    ``(("blocks", "attn", "wq"), (3,))``, ``periods.1.mamba.2.mix.D`` is
    ``(("periods", "mamba", "mix", "D"), (1, 2))`` and ``prefix.0.mlp.wo``
    is ``(("prefix", 0, "mlp", "wo"), ())``."""
    path, stack = [], []
    for part in name.split("."):
        if not part.isdigit():
            path.append(part)
        elif path[-1] == "prefix":
            path.append(int(part))
        else:
            stack.append(int(part))
    return tuple(path), tuple(stack)


def jax_rank(name: str, p: torch.Tensor) -> int:
    """The rank of parameter ``name``'s leaf in the JAX package's stacked
    tree: its own ndim plus the leaf's stacking axes (1 under ``blocks``,
    2 under ``periods``)."""
    return p.dim() + len(jax_leaf(name)[1])


def jax_shape(model: nn.Module, name: str, p: torch.Tensor) -> tuple:
    """The shape of parameter ``name``'s leaf in the JAX package's stacked
    tree: the lengths of its stacking axes (the ``blocks`` list, the
    ``periods`` list and a period's layer list), then its own shape."""
    lens, mod = [], model
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part.isdigit():
            if parts[i - 1] != "prefix":
                lens.append(len(mod))
            mod = mod[int(part)]
        else:
            mod = getattr(mod, part)
    return tuple(lens) + tuple(p.shape)


class Block(nn.Module):
    """One layer of the homogeneous stack: attention + MLP/MoE, or RWKV."""

    def __init__(self, init: Init, cfg: ModelConfig, force_dense: bool):
        super().__init__()
        self.ln1 = layers.RMSNorm(init, cfg.d_model)
        self.ln2 = layers.RMSNorm(init, cfg.d_model)
        if cfg.rwkv:
            self.tm = rwkv.TimeMix(init, cfg.d_model, cfg.rwkv_head_dim)
            self.cm = rwkv.ChannelMix(init, cfg.d_model, cfg.d_ff)
            return
        self.attn = layers.Attention(init, cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.head_dim)
        if cfg.num_experts and not force_dense:
            self.moe = moe.MoE(init, cfg.d_model, cfg.d_ff_expert,
                               cfg.num_experts, cfg.num_shared_experts)
        else:
            self.mlp = layers.MLP(init, cfg.d_model, cfg.d_ff, cfg.mlp_type)


class PeriodLayer(nn.Module):
    """A sequence mixer (attention or mamba) with its two norms."""

    def __init__(self, init: Init, cfg: ModelConfig, kind: str):
        super().__init__()
        self.ln1 = layers.RMSNorm(init, cfg.d_model)
        self.ln2 = layers.RMSNorm(init, cfg.d_model)
        if kind == "attn":
            self.mix = layers.Attention(init, cfg.d_model, cfg.num_heads,
                                        cfg.num_kv_heads, cfg.head_dim)
        else:
            self.mix = mamba.Mamba(init, cfg.d_model, cfg.mamba_d_state,
                                   cfg.mamba_d_conv, cfg.mamba_expand)


class Period(nn.Module):
    """One repeat of ``block_pattern``: its mixers and FFNs by kind."""

    def __init__(self, init: Init, cfg: ModelConfig):
        super().__init__()
        self.attn, self.mamba = nn.ModuleList(), nn.ModuleList()
        self.mlp, self.moe = nn.ModuleList(), nn.ModuleList()
        for i, kind in enumerate(cfg.block_pattern):
            (self.attn if kind == "attn" else self.mamba).append(
                PeriodLayer(init, cfg, kind))
            if cfg.num_experts and i % cfg.moe_every == cfg.moe_offset:
                self.moe.append(moe.MoE(
                    init, cfg.d_model, cfg.d_ff_expert, cfg.num_experts,
                    cfg.num_shared_experts))
            else:
                self.mlp.append(layers.MLP(init, cfg.d_model, cfg.d_ff,
                                           cfg.mlp_type))


class Model(nn.Module):
    """A config-driven LM on ``device`` (``"cuda"`` unless the caller asks
    for the CPU). Parameters are drawn from ``generator`` (a
    ``torch.Generator`` on that device); with no generator they are left
    uninitialized, for ``convert.model_from_arrays`` to fill. ``remat``
    recomputes each block in the backward pass (module docstring)."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 remat: bool = True):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        # Set by ``training.sharding.shard_model`` (module docstring).
        self.gather_keep: Optional[tuple] = None
        self.compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                              else torch.float32)
        init = Init(resolve_device(device), generator)
        self.embed = self._cast(
            layers.Embedding(init, cfg.vocab_size, cfg.d_model), "embed")
        self.final_norm = layers.RMSNorm(init, cfg.d_model)
        if not cfg.tie_embeddings:
            self.lm_head = self._cast(
                layers.Head(init, cfg.d_model, cfg.vocab_size), "lm_head")
        if cfg.frontend != "none":
            self.frontend = self._cast(
                frontend.Frontend(init, cfg.frontend_dim, cfg.d_model),
                "frontend")
        if cfg.block_pattern:  # Jamba period stack
            period = len(cfg.block_pattern)
            n_periods = cfg.num_layers // period
            if n_periods * period != cfg.num_layers:
                raise ValueError("block_pattern must tile num_layers")
            self.periods = nn.ModuleList(
                self._cast(Period(init, cfg), f"periods.{i}")
                for i in range(n_periods))
        else:
            n_prefix = cfg.first_k_dense
            self.prefix = nn.ModuleList(
                self._cast(Block(init, cfg, force_dense=True), f"prefix.{i}")
                for i in range(n_prefix))
            self.blocks = nn.ModuleList(
                self._cast(Block(init, cfg, force_dense=False),
                           f"blocks.{i}")
                for i in range(cfg.num_layers - n_prefix))

    def _cast(self, module: nn.Module, prefix: str) -> nn.Module:
        """Cast the float32 parameters of ``module`` (the model's attribute
        ``prefix``, such as ``blocks.3``) whose :func:`jax_rank` is above 1
        to the compute dtype."""
        for name, p in module.named_parameters():
            if p.dtype == torch.float32 and jax_rank(f"{prefix}.{name}",
                                                     p) > 1:
                p.data = p.data.to(self.compute_dtype)
        return module

    @contextlib.contextmanager
    def gathered(self, *modules: nn.Module):
        """Inside this context, the DTensor parameters of ``modules`` are
        gathered to ``Replicate()`` on every mesh dim but ``gather_keep``'s
        and plain tensors mix with DTensors as replicated ones. A no-op on
        a model of plain tensors."""
        if self.gather_keep is None:
            yield
            return
        from torch.distributed.tensor import Replicate

        saved = []
        try:
            for module in modules:
                for sub in module.modules():
                    for name, p in list(sub._parameters.items()):
                        if not layers.is_dtensor(p):
                            continue
                        saved.append((sub, name, p))
                        sub._parameters[name] = p.redistribute(
                            p.device_mesh,
                            [pl if i in self.gather_keep else Replicate()
                             for i, pl in enumerate(p.placements)])
            with layers.replicated_constants():
                yield
        finally:
            for sub, name, p in saved:
                sub._parameters[name] = p

    def _step(self, fn, lp, *args, remat: bool = True):
        """``fn(lp, *args)`` with layer ``lp``'s parameters gathered,
        recomputed in the backward pass when ``remat`` is on and a
        gradient is being recorded for the parameters."""
        def run(lp, *args):
            with self.gathered(lp):
                return fn(lp, *args)

        if (remat and self.remat and torch.is_grad_enabled()
                and self.embed.table.requires_grad):
            return checkpoint(run, lp, *args, use_reentrant=False)
        return run(lp, *args)

    @property
    def device(self) -> torch.device:
        """The device that holds the parameters."""
        return self.embed.table.device

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------
    def _attention(self, p, x, positions, window, kv_cache, cache_pos,
                   causal, mrope_sections):
        cfg = self.cfg
        return layers.attention(
            p, x, positions,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, causal=causal, window=window,
            rope_theta=cfg.rope_theta, mrope_sections=mrope_sections,
            kv_cache=kv_cache, cache_position=cache_pos,
            flash_q_block=cfg.attn_flash_q_block,
            flash_kv_block=cfg.attn_flash_kv_block,
            dense_threshold=cfg.attn_dense_threshold)

    def _ffn(self, p_moe, p_mlp, h):
        cfg = self.cfg
        if p_moe is not None:
            return moe.moe_ffn(p_moe, h, num_experts=cfg.num_experts,
                               top_k=cfg.num_experts_per_tok,
                               capacity_factor=cfg.capacity_factor,
                               dispatch=cfg.moe_dispatch)
        return layers.mlp(p_mlp, h, cfg.mlp_type), self._zero()

    def _attn_ffn_block(self, lp, x, positions, window, kv_cache, cache_pos):
        cfg = self.cfg
        h = layers.rmsnorm(lp.ln1, x, cfg.norm_eps)
        out, new_kv = self._attention(lp.attn, h, positions, window,
                                      kv_cache, cache_pos, cfg.causal,
                                      cfg.mrope_sections)
        x = x + out
        h = layers.rmsnorm(lp.ln2, x, cfg.norm_eps)
        f, aux = self._ffn(getattr(lp, "moe", None), getattr(lp, "mlp", None),
                           h)
        return layers.logical(x + f, "batch", "seq", "embed"), new_kv, aux

    def _rwkv_block(self, lp, x, state):
        cfg = self.cfg
        h = layers.rmsnorm(lp.ln1, x, cfg.norm_eps)
        out, (tm_x, wkv) = rwkv.rwkv_timemix(
            lp.tm, h, head_dim=cfg.rwkv_head_dim, chunk=cfg.rwkv_chunk,
            state=(state["tm_x"], state["wkv"]))
        x = x + out
        h = layers.rmsnorm(lp.ln2, x, cfg.norm_eps)
        out, cm_x = rwkv.rwkv_channelmix(lp.cm, h, state["cm_x"])
        return x + out, {"tm_x": tm_x, "wkv": wkv, "cm_x": cm_x}

    # ------------------------------------------------------------------
    # Backbones. cache=None => train/prefill (attention archs);
    # cache given => decode (or stateful prefill for rwkv/jamba).
    # ------------------------------------------------------------------
    def _backbone(self, x, positions, cache, cache_pos):
        if self.cfg.block_pattern:
            return self._backbone_periods(x, positions, cache, cache_pos)
        if self.cfg.rwkv:
            return self._backbone_rwkv(x, cache)
        return self._backbone_attn(x, positions, cache, cache_pos)

    def _backbone_rwkv(self, x, cache):
        st = (cache["blocks"] if cache is not None else
              self._rwkv_zero_state(x.shape[0], x.dtype,
                                    self.cfg.num_layers))
        new = {name: [] for name in st}
        for i, lp in enumerate(self.blocks):
            x, s = self._step(self._rwkv_block, lp, x,
                              {n: v[i] for n, v in st.items()})
            for name in new:
                new[name].append(s[name])
        new_cache = None
        if cache is not None:
            new_cache = {"blocks": {n: torch.stack(v) for n, v in
                                    new.items()}}
        return x, new_cache, self._zero()

    def _backbone_attn(self, x, positions, cache, cache_pos):
        cfg = self.cfg
        aux_total = self._zero()
        new_cache = {}
        for stack, offset in (("prefix", 0), ("blocks", cfg.first_k_dense)):
            ks, vs, auxs = [], [], []
            for i, lp in enumerate(getattr(self, stack)):
                kvc = None
                if cache is not None and stack in cache:
                    kvc = (cache[stack]["k"][i], cache[stack]["v"][i])
                args = (lp, x, positions, self._window(i + offset), kvc,
                        cache_pos)
                # JAX scans (and remats) ``blocks``; ``prefix`` is unrolled.
                x, new_kv, aux = self._step(self._attn_ffn_block, *args,
                                            remat=stack == "blocks")
                ks.append(new_kv[0])
                vs.append(new_kv[1])
                auxs.append(aux)
            if ks:
                new_cache[stack] = {"k": torch.stack(ks),
                                    "v": torch.stack(vs)}
                aux_total = aux_total + torch.stack(auxs).sum()
        return x, new_cache, aux_total

    def _backbone_periods(self, x, positions, cache, cache_pos):
        names = ("attn_k", "attn_v", "mamba_conv", "mamba_ssm")
        new = {n: [] for n in names}
        auxs = []
        h = x
        for pi, pp in enumerate(self.periods):
            st = (None if cache is None else
                  {n: v[pi] for n, v in cache["periods"].items()})
            h, per, aux_p = self._step(self._period, pp, h, positions, st,
                                       cache_pos)
            auxs.append(aux_p)
            if cache is not None:
                for n in names:
                    new[n].append(torch.stack(per[n]))
        new_cache = None
        if cache is not None:
            new_cache = {"periods": {n: torch.stack(v) for n, v in
                                     new.items()}}
        return h, new_cache, torch.stack(auxs).sum()

    def _period(self, pp, h, positions, st, cache_pos):
        """One repeat of ``block_pattern``: (h, its new states by name, its
        summed aux loss)."""
        cfg = self.cfg
        per = {n: [] for n in ("attn_k", "attn_v", "mamba_conv",
                               "mamba_ssm")}
        ia = im = imlp = imoe = 0
        aux_p = self._zero()
        for i, kind in enumerate(cfg.block_pattern):
            if kind == "attn":
                lp = pp.attn[ia]
                kvc = None if st is None else (
                    st["attn_k"][ia], st["attn_v"][ia])
                hn = layers.rmsnorm(lp.ln1, h, cfg.norm_eps)
                out, new_kv = self._attention(
                    lp.mix, hn, positions, 0, kvc, cache_pos, True, None)
                per["attn_k"].append(new_kv[0])
                per["attn_v"].append(new_kv[1])
                ia += 1
            else:
                lp = pp.mamba[im]
                mst = None if st is None else (
                    st["mamba_conv"][im], st["mamba_ssm"][im])
                hn = layers.rmsnorm(lp.ln1, h, cfg.norm_eps)
                out, (conv, ssm) = mamba.mamba_block(
                    lp.mix, hn, d_state=cfg.mamba_d_state,
                    chunk=cfg.mamba_chunk, state=mst)
                per["mamba_conv"].append(conv)
                per["mamba_ssm"].append(ssm)
                im += 1
            h = h + out
            hn = layers.rmsnorm(lp.ln2, h, cfg.norm_eps)
            if cfg.num_experts and i % cfg.moe_every == cfg.moe_offset:
                f, aux = self._ffn(pp.moe[imoe], None, hn)
                aux_p = aux_p + aux
                imoe += 1
            else:
                f, _ = self._ffn(None, pp.mlp[imlp], hn)
                imlp += 1
            h = h + f
        return h, per, aux_p

    # ------------------------------------------------------------------
    def _window(self, i: int) -> int:
        cfg = self.cfg
        if cfg.sliding_window <= 0:
            return 0
        return 0 if cfg.layer_is_global(i) else cfg.sliding_window

    def _rwkv_zero_state(self, bsz, dtype, n_layers):
        cfg = self.cfg
        h = cfg.d_model // cfg.rwkv_head_dim
        dev = self.device
        return {
            "tm_x": torch.zeros((n_layers, bsz, cfg.d_model), dtype=dtype,
                                device=dev),
            "wkv": torch.zeros((n_layers, bsz, h, cfg.rwkv_head_dim,
                                cfg.rwkv_head_dim), dtype=torch.float32,
                               device=dev),
            "cm_x": torch.zeros((n_layers, bsz, cfg.d_model), dtype=dtype,
                                device=dev),
        }

    # ------------------------------------------------------------------
    # Public entry points
    # ------------------------------------------------------------------
    def _embed_inputs(self, batch):
        cfg = self.cfg
        if cfg.frontend == "audio":
            x = frontend.audio_embed(
                self.frontend, batch["frames"].to(self.compute_dtype))
            bsz, s = x.shape[0], x.shape[1]
        else:
            x = layers.embed(self.embed, batch["tokens"]).to(
                self.compute_dtype)
            bsz, s = batch["tokens"].shape
            if cfg.frontend == "vision" and "vision_embeds" in batch:
                x = frontend.vision_merge(self.frontend, x,
                                          batch["vision_embeds"])
        if "positions" in batch:
            positions = batch["positions"]
        else:
            positions = torch.arange(s, device=x.device)[None].expand(bsz, s)
            if cfg.mrope_sections is not None:
                positions = positions[..., None].expand(bsz, s, 3)
        return x, positions

    def apply(self, batch: dict, cache=None, cache_pos=None):
        """Shared forward: returns (logits, new_cache, aux_loss).

        ``batch`` holds tensors on the model's device: ``tokens`` (B, S)
        (or ``frames`` for audio), optionally ``vision_embeds`` and
        ``positions``. ``cache_pos`` is a scalar write index or a (B,)
        tensor of per-row indices.
        """
        cfg = self.cfg
        top = [getattr(self, n) for n in ("embed", "final_norm", "lm_head",
                                          "frontend") if hasattr(self, n)]
        with self.gathered(*top):
            x, positions = self._embed_inputs(batch)
            x, new_cache, aux = self._backbone(x, positions, cache,
                                               cache_pos)
            x = layers.rmsnorm(self.final_norm, x, cfg.norm_eps)
            x = layers.logical(x, "batch", "seq", "embed")
            logits = layers.unembed(self.embed, x, None if cfg.tie_embeddings
                                    else self.lm_head)
            logits = layers.logical(logits, "batch", "logits_seq", "vocab")
        return logits, new_cache, aux

    def forward_train(self, batch: dict):
        """The training forward: (logits, aux). Differentiable; with
        ``remat`` each block is recomputed in the backward pass."""
        logits, _, aux = self.apply(batch)
        return logits, aux

    def prefill(self, batch: dict):
        """Full-sequence forward returning (logits, cache)."""
        cfg = self.cfg
        if cfg.rwkv or cfg.block_pattern:
            bsz, s = batch["tokens"].shape
            cache = self.init_cache(bsz, s)
            logits, new_cache, _ = self.apply(batch, cache, 0)
            return logits, new_cache
        logits, kv, _ = self.apply(batch)
        return logits, kv

    def decode_step(self, batch: dict, cache, position: int):
        """One new token per sequence against an existing cache.

        batch: {"tokens": (B, 1)}; position: scalar write index, the same
        for all rows (per-row offsets go through ``apply`` with a (B,)
        ``cache_pos`` and a ``positions`` entry, as ``SlotBatcher`` does).
        Returns (logits (B, V), new cache).
        """
        b = dict(batch)
        bsz = b["tokens"].shape[0]
        pos = torch.full((bsz, 1), int(position), dtype=torch.long,
                         device=self.device)
        if self.cfg.mrope_sections is not None:
            pos = pos[..., None].expand(bsz, 1, 3)
        b["positions"] = pos
        logits, new_cache, _ = self.apply(b, cache, int(position))
        return logits[:, -1], new_cache

    # ------------------------------------------------------------------
    def init_cache(self, bsz: int, max_len: int) -> dict:
        """A zero cache tree in the JAX package's layout."""
        cfg = self.cfg
        dt, dev = self.compute_dtype, self.device

        def zeros(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if cfg.rwkv:
            return {"blocks": self._rwkv_zero_state(bsz, dt, cfg.num_layers)}
        if cfg.block_pattern:
            pattern = cfg.block_pattern
            n_periods = cfg.num_layers // len(pattern)
            n_attn = sum(k == "attn" for k in pattern)
            n_mamba = len(pattern) - n_attn
            di = cfg.mamba_expand * cfg.d_model
            return {"periods": {
                "attn_k": zeros(n_periods, n_attn, bsz, max_len,
                                cfg.num_kv_heads, cfg.head_dim),
                "attn_v": zeros(n_periods, n_attn, bsz, max_len,
                                cfg.num_kv_heads, cfg.head_dim),
                "mamba_conv": zeros(n_periods, n_mamba, bsz,
                                    cfg.mamba_d_conv - 1, di),
                "mamba_ssm": zeros(n_periods, n_mamba, bsz, di,
                                   cfg.mamba_d_state, dtype=torch.float32),
            }}
        n_stack = cfg.num_layers - cfg.first_k_dense
        cache = {"blocks": {
            "k": zeros(n_stack, bsz, max_len, cfg.num_kv_heads,
                       cfg.head_dim),
            "v": zeros(n_stack, bsz, max_len, cfg.num_kv_heads,
                       cfg.head_dim)}}
        if cfg.first_k_dense:
            cache["prefix"] = {
                "k": zeros(cfg.first_k_dense, bsz, max_len,
                           cfg.num_kv_heads, cfg.head_dim),
                "v": zeros(cfg.first_k_dense, bsz, max_len,
                           cfg.num_kv_heads, cfg.head_dim)}
        return cache
