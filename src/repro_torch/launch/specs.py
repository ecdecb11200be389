"""Cell builder: (arch, shape, mesh) -> (step function, arguments,
placements).

The port of ``repro/launch/specs.py``: the single source of truth for how
every dry-run cell is built — which step function runs, what its inputs
look like, and how everything is placed on the production mesh.
``launch/dryrun.py`` and ``launch/hillclimb.py`` consume it.

The reference's arguments are ``ShapeDtypeStruct`` trees; the port's are
fake tensors, so the builders run under a ``FakeTensorMode`` (the
dry-run's) and never allocate. Each tensor is placed as the JAX package
places it, by the port's own rules: parameters by
``training/sharding.py`` (``param_shardings`` through ``shard_model``),
optimizer state by ``opt_state_shardings``, batches by
:func:`_batch_shardings`, caches by ``serving/kv_cache.cache_sharding_tree``
— each a DTensor of this rank's block over a ``DeviceMesh``. The model
owns its parameters (``nn.Module``), so a cell's function closes over its
model and takes the parameter tree only to mirror the reference's
signature. Train cells pass the float32 masters as ``params`` (the JAX
package's float32 parameters); the model's bf16 compute copies are state
the port keeps beside them (``Cell.resident``).

``lower_cell`` has no counterpart: PyTorch runs eagerly, so there is
nothing to lower. The dry-run runs ``cell.fn(*cell.args)`` once on fake
tensors in its place (``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import batch_axes_of
from repro_torch.training import sharding as shard_mod
from repro_torch.training.sharding import NamedSharding


@dataclasses.dataclass
class Cell:
    """One dry-run cell: ``fn(*args)`` is the step, ``in_shardings`` the
    placements of ``args`` (trees of ``NamedSharding``), ``meta`` the
    reference's keys. Port-only: ``reads`` answers host reads of device
    values at named sites (``roofline.CostMode``), and ``resident`` holds
    tensors the step keeps that are not arguments."""

    arch: str
    shape: str
    fn: Callable
    args: Tuple[Any, ...]  # fake tensors (DTensors under a mesh)
    in_shardings: Tuple[Any, ...]
    out_shardings: Any  # None: as the step leaves them
    donate: Tuple[int, ...] = ()
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    reads: Dict[Tuple[str, str], list] = dataclasses.field(
        default_factory=dict)
    resident: Tuple[Any, ...] = ()


def _sds(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _rep(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _batch_sds(cfg: ModelConfig, shape: ShapeConfig, with_labels: bool,
               device=None) -> dict:
    """The global batch of ``shape`` for ``cfg`` (fake tensors)."""
    dev = device if device is not None else torch.device("cuda", 0)
    b, s = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.frontend == "audio":
        batch["frames"] = _sds((b, s, cfg.frontend_dim), torch.float32, dev)
    else:
        batch["tokens"] = _sds((b, s), torch.int32, dev)
        if cfg.frontend == "vision":
            batch["vision_embeds"] = _sds((b, cfg.vision_tokens,
                                           cfg.frontend_dim), torch.float32,
                                          dev)
        if cfg.mrope_sections is not None:
            batch["positions"] = _sds((b, s, 3), torch.int32, dev)
    if with_labels:
        batch["labels"] = _sds((b, s), torch.int32, dev)
    return batch


def _batch_shardings(batch: dict, mesh, batch_axes) -> dict:
    """Rows over ``batch_axes`` where they divide, else replicated."""
    def spec(leaf):
        if leaf.dim() >= 2 and leaf.shape[0] % _axes_size(mesh,
                                                          batch_axes) == 0:
            return NamedSharding(mesh, (tuple(batch_axes),)
                                 + (None,) * (leaf.dim() - 1))
        return _rep(mesh)

    return {k: spec(v) for k, v in batch.items()}


def _axes_size(mesh, axes) -> int:
    sizes = shard_mod.axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _place_tree(tree, shardings):
    """Place every tensor of a dict tree under its ``NamedSharding``."""
    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k]) for k, v in tree.items()}
    return shardings.place(tree)


def build_cell(arch: str, shape_name: str, mesh, *,
               microbatch_tokens_per_device: int = 4096,
               grad_compression: str = "none",
               cache_seq_shard_threshold: int = 1,
               overrides: Optional[dict] = None,
               logical_overrides: Optional[dict] = None,
               shape: Optional[ShapeConfig] = None) -> Cell:
    """Construct the cell for one (arch x shape x mesh), under the
    caller's ``FakeTensorMode``. ``shape`` (port-only) gives a
    ``ShapeConfig`` that is not in ``configs.SHAPES``, such as
    ``chip_smoke.py``'s calibration step; ``shape_name`` then only names
    it. The activation rules stay installed for the step
    (``sharding.clear_logical_rules`` removes them)."""
    from repro_torch.models import Model
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.serve_step import (make_decode_step,
                                                make_prefill_step)
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts_mod

    if arch == "paris":
        return build_paris_cell(shape_name, mesh)
    cfg: ModelConfig = configs.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = shape if shape is not None else configs.SHAPES[shape_name]
    skip = configs.shape_applicable(cfg, shape)
    if skip:
        raise ValueError(f"cell skipped: {skip}")
    batch_axes = batch_axes_of(mesh)
    dp = _axes_size(mesh, batch_axes)
    dev = shard_mod.mesh_device(mesh)
    model = Model(cfg, device=dev, remat=(shape.kind == "train"))
    shard_mod.use_logical_rules(mesh, batch_axes, extra=logical_overrides)
    shard_mod.shard_model(model, mesh)
    pshard = shard_mod.param_shardings(model, mesh)
    meta = dict(params=cfg.param_count(),
                active_params=cfg.active_param_count())

    if shape.kind == "train":
        # microbatching: keep per-device microbatch tokens bounded so the
        # remat carry fits HBM (per-device microbatch >= 1 sample).
        per_dev_batch = max(shape.global_batch // dp, 1)
        mb_samples = max(microbatch_tokens_per_device // shape.seq_len, 1)
        microbatches = max(per_dev_batch // mb_samples, 1)
        names = [n for n, _ in model.named_parameters()]
        tcfg = ts_mod.TrainConfig(
            optimizer=opt_mod.OptimizerConfig(),
            microbatches=microbatches,
            grad_compression=grad_compression,
            pod_axis="pod" if "pod" in mesh.mesh_dim_names else None)
        state = ts_mod.init_train_state(model)
        step_fn = ts_mod.make_train_step(model, tcfg)
        params = dict(zip(names, state.master))
        batch = _batch_sds(cfg, shape, with_labels=True, device=dev)
        bshard = _batch_shardings(batch, mesh, batch_axes)
        batch = _place_tree(batch, bshard)
        oshard = shard_mod.opt_state_shardings(state.opt, pshard, mesh)

        def train_fn(params, opt, batch):
            state.master = [params[n] for n in names]
            state.opt = opt
            new, metrics = step_fn(state, batch)
            return dict(zip(names, new.master)), new.opt, metrics

        return Cell(
            arch=arch, shape=shape_name, fn=train_fn,
            args=(params, state.opt, batch),
            in_shardings=(pshard, oshard, bshard),
            out_shardings=None, donate=(0, 1),
            meta=dict(kind="train", microbatches=microbatches,
                      tokens=shape.global_batch * shape.seq_len, **meta),
            resident=tuple(p for p, m in zip(state.params, state.master)
                           if p.dtype != m.dtype))

    # Serving cells use bf16 params: the model holds them so.
    params = dict(model.named_parameters())
    if shape.kind == "prefill":
        step = make_prefill_step(model)
        batch = _batch_sds(cfg, shape, with_labels=False, device=dev)
        bshard = _batch_shardings(batch, mesh, batch_axes)
        batch = _place_tree(batch, bshard)
        return Cell(
            arch=arch, shape=shape_name,
            fn=lambda params, batch: step(batch),
            args=(params, batch), in_shardings=(pshard, bshard),
            out_shardings=None,
            meta=dict(kind="prefill",
                      tokens=shape.global_batch * shape.seq_len, **meta))

    # decode: one token against a seq_len-deep cache.
    if cfg.frontend == "audio":
        raise ValueError("encoder-only arch has no decode step")
    step = make_decode_step(model)
    b = shape.global_batch
    cache = model.init_cache(b, shape.seq_len)
    # cache sharding policy: batch when it divides dp, else shard the
    # sequence axis (long-context small-batch layout).
    if b % dp == 0 and b >= dp:
        cshard = kvc.cache_sharding_tree(cache, mesh, cfg,
                                         batch_axes=batch_axes)
    else:
        cshard = kvc.cache_sharding_tree(
            cache, mesh, cfg, batch_axes=(),
            seq_axes=("data",) if "data" in mesh.mesh_dim_names else ())
    cache = _place_tree(cache, cshard)
    batch = {"tokens": _sds((b, 1), torch.int32, dev)}
    bshard = _batch_shardings(batch, mesh, batch_axes)
    batch = _place_tree(batch, bshard)
    pos = _sds((), torch.int32, dev)
    from repro_torch.launch import roofline

    # The write position is a host int inside the step; the trace writes
    # the cache's last slot, so every position is attended.
    roofline.set_value(pos, shape.seq_len - 1)
    return Cell(
        arch=arch, shape=shape_name,
        fn=lambda params, batch, cache, pos: step(batch, cache, pos),
        args=(params, batch, cache, pos),
        in_shardings=(pshard, bshard, cshard, _rep(mesh)),
        out_shardings=None, donate=(2,),
        meta=dict(kind="decode", tokens=shape.global_batch,
                  cache_tokens=shape.seq_len, **meta))


# ---------------------------------------------------------------------------
# The paper's own workload as dry-run cells.
# ---------------------------------------------------------------------------

# The single-query ``select="topk"`` fallback is entered by a host read and
# then runs n_local / round_size rounds with no read to stop it: the trace
# answers its entry "no", so it counts at most once (here: not at all), and
# lists the site.
_TOPK_FALLBACK = ("_local_exact_search", "if bool(need.any()):")


def build_paris_cell(shape_name: str, mesh, *,
                     round_size: Optional[int] = None,
                     batch_queries: int = 0,
                     select: str = "sort") -> Cell:
    """The ParIS+ mesh search or build as a cell: rank 0's step over its
    shard of a fake ``DistIndex`` of the paper's 100M series, cut along N
    over every mesh axis flattened into one group (the reference's ``axes
    = mesh.axis_names``); ``n`` rounds up to a multiple of the rank count.
    Each array is a DTensor sharded on N over all the mesh's axes, so rank
    0's block is ``core.distributed.shard_of(dindex, 0, ranks)``."""
    import torch.distributed as dist

    from repro_torch.core import distributed as pdist

    pcfg = configs.get_config("paris")
    axes = tuple(mesh.mesh_dim_names)
    n_shards = math.prod(mesh.shape)
    n = -(-pcfg.num_series // n_shards) * n_shards
    dev = shard_mod.mesh_device(mesh)
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():  # the mesh's rank table is a host tensor
        ranks = mesh.mesh.flatten().tolist()
        group = dist.new_group(ranks=ranks) if n_shards > 1 else None
    rank_mesh = pdist.Mesh(rank=0, world=n_shards, device=dev, group=group)
    spec = NamedSharding(mesh, (axes,))

    def local(dindex):  # rank 0's shard_of the index: its DTensor blocks
        return dataclasses.replace(
            dindex, sax=dindex.sax.to_local(),
            raw_sorted=dindex.raw_sorted.to_local(),
            pos=dindex.pos.to_local())

    if shape_name == "search":
        step = pdist.make_distributed_search(
            rank_mesh, round_size=round_size or pcfg.round_size,
            leaf_cap=pcfg.leaf_cap, batch_queries=batch_queries,
            select=select)
        dindex = pdist.DistIndex(
            sax=spec.place(_sds((n, pcfg.segments), torch.uint8, dev)),
            raw_sorted=spec.place(_sds((n, pcfg.series_length),
                                       torch.float32, dev)),
            pos=spec.place(_sds((n,), torch.int32, dev)),
            series_length=pcfg.series_length, segments=pcfg.segments,
            cardinality=pcfg.cardinality)
        qshape = ((batch_queries, pcfg.series_length) if batch_queries
                  else (pcfg.series_length,))
        query = _sds(qshape, torch.float32, dev)
        ish = dataclasses.replace(dindex, sax=spec, raw_sorted=spec,
                                  pos=spec)
        return Cell(
            arch="paris", shape=shape_name,
            fn=lambda dindex, query: step(local(dindex), query),
            args=(dindex, query), in_shardings=(ish, _rep(mesh)),
            out_shardings=None,
            meta=dict(kind="search", num_series=n,
                      series_length=pcfg.series_length),
            reads={_TOPK_FALLBACK: [False]})
    if shape_name == "build":
        step = pdist.make_distributed_build(
            rank_mesh, segments=pcfg.segments,
            cardinality=pcfg.cardinality)
        chunk = 1 << 22  # 4M series per ingest macro-chunk
        rshard = NamedSharding(mesh, (axes, None))
        rows = rshard.place(_sds((chunk, pcfg.series_length), torch.float32,
                                 dev))
        return Cell(
            arch="paris", shape=shape_name,
            fn=lambda rows: step(rows.to_local()),
            args=(rows,), in_shardings=(rshard,),
            out_shardings=None,
            meta=dict(kind="build", chunk=chunk,
                      series_length=pcfg.series_length))
    raise KeyError(f"unknown paris shape {shape_name!r}")


__all__ = ["Cell", "build_cell", "build_paris_cell"]
