"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake tensors.

The port of ``repro/launch/dryrun.py``. The reference lowers and compiles
each cell for 512 placeholder devices; PyTorch runs eagerly, so the port
runs each cell's step once, as rank 0 of a ``fake`` process group of 512
ranks (``torch.distributed``'s fake backend: collectives return at once),
on fake tensors (``FakeTensorMode``: shapes and dtypes, nothing allocated,
nothing run). The production meshes take the first 256 ranks (``single``,
(16, 16)) or all 512 (``multi``, (2, 16, 16)), as
``launch/mesh.make_production_mesh`` builds them.

For every cell this script:
  1. builds the step, its fake arguments and their placements via
     ``launch/specs.py`` (the tensors are rank 0's DTensor blocks);
  2. runs ``cell.fn(*cell.args)`` once under ``roofline.CostMode`` (one
     rank's FLOPs by dtype, HBM bytes, collective bytes and host reads)
     and ``torch.distributed._tools.mem_tracker.MemTracker`` (the live
     bytes over the step: the peak), timed as ``trace_s``;
  3. records rank 0's argument, output, temporary and peak bytes (uneven
     dims stay replicated, ``layers.logical``, so rank 0 holds the most
     bytes of any rank), the roofline terms against the H100's peaks and
     the model-FLOPs ratio;
  4. writes one JSON record per cell under ``experiments/dryrun_torch/``.

The fake tensors are ``cuda`` tensors on every machine, so the trace
counts the card's path: the seven kernels through their fake
implementations (``kernels/library.py``), never their plain versions. On
a PyTorch built without CUDA, :func:`main` starts itself again with
``launch/fake_cuda.py``'s stand-in preloaded. A dry-run never runs in a
process that also runs real work: the fake group is the process's default
group until :func:`fake_world` ends.

Usage:
  python -m repro_torch.launch.dryrun --mesh single --arch granite-34b \\
      --shape train_4k
  python -m repro_torch.launch.dryrun --mesh both --all [--skip-existing]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

FAKE_WORLD = 512  # the multi-pod mesh's ranks
RANK0_NOTE = ("rank 0's bytes: dims a mesh axis does not divide stay "
              "replicated, so rank 0 holds the most bytes of any rank")


@contextlib.contextmanager
def fake_world(world: int = FAKE_WORLD):
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks, for the duration of the context (then destroyed)."""
    import logging

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    # DTensor warns at every two-axis reduction that it issues one
    # collective a mesh dim; the counts are in the records.
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _dtensor_under_fake():
    """Two repairs that let DTensor run on the trace's fake tensors:

    * DTensor computes a ``_StridedShard``'s offsets (the FSDP gather of a
      tensor sharded on one dim over two mesh axes) by building an
      ``arange`` and reading it back to the host, which a fake tensor
      cannot answer: that method runs outside fake mode, on host integers;
    * DTensor learns an op's output shape by running it on global-shape
      fake tensors under the fake mode it finds active — the trace's own,
      where the counting modes would take that run for the rank's work
      (and MemTracker its global-shape outputs for the rank's bytes): it
      gets a fake mode of its own instead, which both modes skip."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _sharding_prop
    from torch.distributed.tensor.placement_types import _StridedShard

    # (Releases of PyTorch that lack either piece need no repair there.)
    orig = _StridedShard.__dict__.get("local_shard_size_and_offset")
    detect = getattr(_sharding_prop, "detect_fake_mode", None)

    def outside(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    if orig is not None:
        _StridedShard.local_shard_size_and_offset = outside
    if detect is not None:
        _sharding_prop.detect_fake_mode = lambda *a, **k: None
    try:
        yield
    finally:
        if orig is not None:
            _StridedShard.local_shard_size_and_offset = orig
        if detect is not None:
            _sharding_prop.detect_fake_mode = detect


def _leaves(tree):
    """Every tensor of a tree of dicts, lists, tuples and dataclasses."""
    import dataclasses

    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _local_nbytes(t) -> int:
    """Rank 0's bytes of ``t``: a DTensor's block, or all of a plain
    (replicated) tensor."""
    from repro_torch.models.layers import is_dtensor

    if is_dtensor(t):
        t = t.to_local()
    return t.numel() * t.element_size()


def _storage_ids(tensors) -> set:
    from repro_torch.models.layers import is_dtensor

    out = set()
    for t in tensors:
        local = t.to_local() if is_dtensor(t) else t
        out.add(local.untyped_storage()._cdata)
    return out


def _trace(cell, n_dev: int) -> dict:
    """Run ``cell.fn(*cell.args)`` once under the counting modes (the
    caller's ``FakeTensorMode`` active) and return the record's fields."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch import roofline

    args = list(_leaves(cell.args))
    arg_bytes = sum(_local_nbytes(t) for t in args)
    resident_bytes = sum(_local_nbytes(t) for t in cell.resident)
    tracker = MemTracker()
    tracker.track_external(*args, *cell.resident)
    cost = roofline.CostMode(reads=cell.reads)
    t0 = time.perf_counter()
    with _dtensor_under_fake(), tracker, cost:
        out = cell.fn(*cell.args)
    trace_s = time.perf_counter() - t0
    peak = max(tracker.get_tracker_snapshot("peak").values(),
               key=lambda d: d["Total"])["Total"]
    arg_ids = _storage_ids(args + list(cell.resident))
    outs = list(_leaves(out))
    alias = [t for t in outs if _storage_ids([t]) <= arg_ids]
    out_bytes = sum(_local_nbytes(t) for t in outs if not any(
        t is a for a in alias))
    alias_bytes = sum(_local_nbytes(t) for t in alias)
    rep = cost.report()
    del out, outs, alias
    rec = dict(
        status="ok", trace_s=trace_s, rank=0, per_rank=RANK0_NOTE,
        memory=dict(
            argument_bytes=arg_bytes, resident_bytes=resident_bytes,
            output_bytes=out_bytes, alias_bytes=alias_bytes,
            temp_bytes=max(peak - arg_bytes - resident_bytes - out_bytes, 0),
            peak_estimate_bytes=peak),
        roofline=rep.to_json(), meta=cell.meta)
    meta = cell.meta
    if meta.get("kind") in ("train", "prefill", "decode"):
        mf = roofline.model_flops(
            meta.get("params", 0), meta.get("active_params", 0),
            meta.get("tokens", 0),
            "train" if meta.get("kind") == "train" else "serve")
        rec["model_flops"] = mf
        total = rep.flops * n_dev
        rec["model_flops_ratio"] = (mf / total) if total else None
    return rec


def traced(build, n_dev: int) -> dict:
    """Build a cell with ``build()`` under a fresh ``FakeTensorMode`` and
    :func:`_trace` it: run ``cell.fn(*cell.args)`` once under the
    counting modes and return the record's fields. The activation rules are
    cleared after."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.training import sharding

    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            return _trace(build(), n_dev)
    finally:
        sharding.clear_logical_rules()


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: str,
             overrides=None, tag: str = "", build_kwargs=None) -> dict:
    """Trace one cell on the ``single`` or ``multi`` production mesh and
    write its record (failures are records too) to ``outdir``."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = math.prod(mesh.shape)
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_kind, devices=n_dev,
               tag=tag)

    def build():
        if arch == "paris":
            return specs.build_paris_cell(shape_name, mesh,
                                          **(build_kwargs or {}))
        return specs.build_cell(arch, shape_name, mesh, overrides=overrides,
                                **(build_kwargs or {}))

    try:
        rec.update(traced(build, n_dev))
    except Exception as e:  # record failures as artifacts too
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    os.makedirs(outdir, exist_ok=True)
    fn = os.path.join(outdir,
                      f"{mesh_kind}__{arch}__{shape_name}"
                      f"{('__' + tag) if tag else ''}.json")
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def iter_cells():
    """Every (arch, shape, skip reason) the dry-run covers."""
    from repro_torch import configs

    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        for shape_name in configs.SHAPES:
            reason = configs.shape_applicable(cfg, configs.SHAPES[shape_name])
            yield arch, shape_name, reason
    yield "paris", "search", None
    yield "paris", "build", None


def main(argv=None):
    """CLI entry (module docstring)."""
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if not (args.all or (args.arch and args.shape)):
        ap.error("--arch and --shape required without --all")

    from repro_torch.launch import fake_cuda

    fake_cuda.ensure("repro_torch.launch.dryrun", argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = (list(iter_cells()) if args.all
             else [(args.arch, args.shape, None)])
    results = []
    with fake_world():
        for mesh_kind in meshes:
            for arch, shape_name, skip_reason in cells:
                key = f"{mesh_kind}/{arch}/{shape_name}"
                fn = os.path.join(args.outdir,
                                  f"{mesh_kind}__{arch}__{shape_name}.json")
                if skip_reason:
                    os.makedirs(args.outdir, exist_ok=True)
                    with open(fn, "w") as f:
                        json.dump(dict(arch=arch, shape=shape_name,
                                       mesh=mesh_kind, status="skipped",
                                       reason=skip_reason), f, indent=1)
                    print(f"[skip] {key}: {skip_reason}", flush=True)
                    continue
                if args.skip_existing and os.path.exists(fn):
                    try:
                        with open(fn) as f:
                            if json.load(f).get("status") == "ok":
                                print(f"[keep] {key}", flush=True)
                                continue
                    except (OSError, ValueError):
                        pass
                t0 = time.time()
                rec = run_cell(arch, shape_name, mesh_kind, args.outdir)
                dt = time.time() - t0
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"[ok]   {key} {dt:.0f}s "
                          f"compute={r['compute_s']:.4f}s "
                          f"mem={r['memory_s']:.4f}s "
                          f"coll={r['collective_s']:.4f}s "
                          f"dom={r['dominant']} "
                          f"peak={rec['memory']['peak_estimate_bytes'] / 2**30:.2f}"
                          f"GiB trace={rec['trace_s']:.1f}s", flush=True)
                else:
                    print(f"[ERR]  {key} {dt:.0f}s {rec['error']}",
                          flush=True)
                results.append(rec)
    ok = sum(1 for r in results if r["status"] == "ok")
    print(f"done: {ok}/{len(results)} cells ok", flush=True)


if __name__ == "__main__":
    main()
