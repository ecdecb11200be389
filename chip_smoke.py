#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ParIS+ on one NVIDIA card and check it.

Run from the repository root, on a machine with a card and ``nvcc``:

    python3 chip_smoke.py [--seed 0] [--log2-n 24] [--queries 64] [--k 8]

Phases, each of which raises (exit code 1) on a failed check:

  1. device   — the card's name, count, and ``nvidia-smi`` name/power limit;
  2. build    — builds the CUDA kernels from ``src/repro_torch/kernels/csrc``
                (one ``nvcc`` per source, in parallel) and prints ptxas lines;
  3. quickstart — the README quickstart through the port on the card
                (4096 x 128, k = 4, exact + epsilon 0.1 + budget 2 tiers),
                held against the same engine on the plain versions and a
                brute-force oracle;
  4. full size — the paper's synthetic workload (Gaussian random walks,
                n = 256, w = 16, card = 256) at N = 2**log2_n series made on
                the card from ``--seed``: ``build_index``, ``exact_knn_batch``
                (Q queries, k, round 4096, leaf 256) and ``knn_batch_tiered``
                at epsilon 0.1 and budget 2. Answers are held against an
                on-card brute-force oracle;
  5. baselines — the paper's single-query algorithms on phase 4's index,
                for its first 8 queries: ``exact_search_single`` (ParIS+),
                ``nb_exact_search`` (nb-ParIS+, 16 workers) and
                ``brute_force`` (the UCR-Suite scan), each 1-NN held against
                the oracle, with per-query times, raw reads and rounds;
  classify    — the paper's Fig. 18 k-NN classifier
                (``repro_torch.core.classifier``) over phase 4's index, each
                series labelled by its trend (last value above its first),
                on 16 random-walk queries made from ``--seed``, k = 5:
                ``predict`` (the index's exact k-NN) must equal
                ``predict_brute`` (a full scan) and the vote of
                ``oracle_knn``'s neighbours, and its neighbours the
                oracle's; the mean time a query of both;
  6. kernels  — each kernel against its plain version on the same inputs,
                at the shapes the paths gave it, timed with CUDA events
                beside its bound (the larger of bytes over 3.35 TB/s and
                fp32 operations over 67 TFLOP/s, the H100 SXM peaks; both
                counts from ``repro_torch.launch.roofline.kernel_cost``),
                with the launch shape each ran at; the engine's candidate
                selection, top 2^20 of (64, 2^24), in its two phases
                (``select``, then ``order_range`` over the first prefix
                and the first extension) bit for bit, also against the
                int64-key ``torch.topk`` oracle ``ref.smallest``;
  tuning      — the launch-shape table (``repro_torch.core.tuning``): the
                committed table validates; for each registered kernel at a
                moderate shape, every admitted lattice point's output equals
                the default shape's bit for bit, and the default equals its
                plain version; at each canonical shape of the table, the
                default and the table's winner are timed with CUDA events
                (a ``{"tuning": ...}`` JSON line);
  serve       — the serving fabric (``repro_torch.serving``) over phase 4's
                index and queries, the queries sent as host rows: (a) a
                ``ShardedSearchRouter`` of 4 file-order shards (views of
                phase 4's raw) x 2 replicas, its daemons started, fed by 4
                client threads; (b) ``search_batch`` at epsilon 0.1 and
                budget 2, and a ``TierDegradePolicy`` router whose
                deadline-bearing requests come back degraded; (c)
                ``FaultInjector`` faults: a failed replica (retried), a
                slow replica (hedged), a blackholed shard (every future
                fails with ``DeadlineExceededError`` by its deadline) and
                a failed shard (``ShardFailedError`` naming it, caused by
                the injected fault); (d) an ``IngestingRouter`` over
                ``build_index`` of the first half of phase 4's series (made
                again from ``--seed``), the other half appended as card
                tensors while a client thread streams queries, then a full
                fold. Every exact answer must equal phase 4's bit for bit;
                peak device memory under 70 GiB;
  mesh        — the mesh (``repro_torch.core.distributed``) over phase 4's
                index and queries, round and leaf cap from
                ``repro_torch/configs/paris.py``: (a) ``dist_index_from``
                into 4 shards of 2^22 rows, 4 ranks spawned on the one card
                over ``gloo`` (it copies CUDA tensors through the host),
                each handed its shard by CUDA IPC,
                ``make_distributed_batch_search`` at k and at 1, positions
                equal to phase 4's; (b)
                ``make_distributed_search`` on the first 8 queries with
                ``select="sort"``, ``"topk"``, ``shared_bsf=False`` and
                ``batch_queries=8``, positions equal to (a)'s; (c)
                ``make_distributed_build`` over the first 2^22 series, SAX
                and root keys bitwise to the plain versions; (d) (a)'s k-NN
                batch on one ``nccl`` rank. Every rank's answers must agree,
                the summed peak device memory of the parent and the ranks
                stay under 70 GiB; launches are summed over the parent and
                the ranks. Four ranks on one card are not a multi-card
                figure. Then its four kernels against their plain versions
                at its shapes (one shard, shared fallback rows);
  7. packed   — phase 4's index is freed (its answers kept), the same
                series are made again from ``--seed``, cut into five
                contiguous components (a base, two runs, two deltas; no
                size a multiple of the 128-row block), built and packed:
                ``exact_knn_batch_packed`` must return phase 4's positions
                and bit-identical distances, and ``knn_batch_packed_tiered``
                at epsilon 0.1, seeded by ``packed_seed``, the (1 + eps)
                guarantee; peak device memory must stay under 70 GiB. Then
                the packed lower-bound kernel's row of phase 6;
  8. disk     — the paper's disk path at N = 2**disk_log2_n (default
                2**min(log2_n, 21): the phase writes over 4.5 times its
                raw bytes, and prints what it wrote; the H100 hosts it runs
                on stop a command past 45 GiB of disk writes, and the shard
                phase writes a 12.7 GiB checkpoint). Phase 4's first N series, made
                again on the card, are written to a float32 file in a fresh
                directory under ``--disk-dir`` (fsync'd, then dropped from
                the page cache) and built from it by ``PipelineBuilder`` in
                ParIS+ and ParIS mode (4 epochs); then a durable live store
                (a base of N/2, eight appends through ``IngestPipeline``,
                minor folds by ``maybe_compact``, a major fold), queried
                fused after the appends and again after the fold;
                ``recover`` from its directory; ``demote`` and the cold
                query, then the same queries through an ``IngestingRouter``
                over the demoted store (its cold shard routed), which must
                answer as the cold query did. Every index must equal
                ``build_index`` over the same series, and every answer that
                index's (checked against an on-card oracle) bit for bit; at
                phase 4's N, phase 4's index and answers. Peak device
                memory under 70 GiB;
  lm          — the LM serving path (``repro_torch.models``,
                ``repro_torch.serving``) at granite-34b's full width (d_model
                6144, 48 heads, MQA, d_ff 24576, vocab 49152, bf16), 8 of its
                88 layers (47.2 B parameters do not fit one card), weights
                drawn on the card from ``--seed``: (a) a kNN-LM datastore:
                256 bigram sequences of 4096 tokens through ``Model.apply``
                (flash attention) in chunks of 4, the first 256 logits of
                each position kept, 2^20 (state, next token) pairs, then
                ``build_index``; (b) the kNN-LM loop of
                ``examples/retrieval_serve.py`` (16 sequences, 16-token
                prompts, 16 steps, k 8, lam 0.3, round 512) over an
                ``IngestingRouter`` of 2 base shards, each step's states
                appended and the deltas folded every 4 steps; every step's
                positions equal an on-card brute force over the datastore
                as it stands, distances within 1e-4 relative; (c) a
                ``SlotBatcher`` (8 slots, 32 requests of 4-12 tokens, 32 new
                tokens each); then (e) its kernels against their plain
                versions at its shapes and (d) float32 checks: depth 2 on
                the card against the host CPU (prefill and 8 greedy steps,
                logits within 1e-3 of the largest, tokens equal), decode
                after prefill against the full forward at depth 8, and each
                batcher answer against its own greedy generation. It prints
                the datastore's tokens/s beside its FLOP bound, decode ms
                beside its byte bound, retrieval, append and compaction ms,
                and the peak device memory (under 70 GiB). With
                ``--profile-lm`` it then traces, by ``torch.profiler`` and
                after the launch counts are read, three windows over the
                phase's own objects: one datastore chunk, prefill and 8
                decode steps, and one retrieval step of a step's LM states
                over a fresh router on the phase's datastore; each window's
                wall, busy time, idle share and top kernels go into the
                ``{"lm": ...}`` line under ``profile``;
  train       — LM training (``repro_torch.training``) on a card that
                holds nothing of the lm phase: (a) granite-34b at full
                width, 4 of its 88 layers (2.724 B parameters; 45.7 GiB of
                state: float32 masters of the bf16 weights, the bf16
                copies, float32 gradient sums, mu and nu), remat, bigram
                batches of 4 x 2048 tokens from ``--seed`` through
                ``PrefetchingLoader``, 2 microbatches, z-loss 1e-4, AdamW
                with warmup 2 of 10 steps: one warm-up step and 8 timed
                ones (host clock around a synchronised step), the median
                step and tokens/s beside the FLOP bound (remat's recompute
                counted, less the MLP down-projection's, which the
                recompute's early stop skips; dense attention included; at
                989 TFLOP/s), the
                optimizer update and bf16 refresh by CUDA events beside
                its byte bound (30 B a parameter at 3.35 TB/s), every
                step's loss and grad norm (finite), the peak (under 70
                GiB); (b) the same generator-made granite at depth 1 in
                float32 on the card and on the host CPU: the loss within
                1e-5 relative and every gradient within 1e-3 of its
                leaf's largest; (c) ``repro_torch.examples.train_lm`` at
                its defaults (lm-22m, 300 steps, B 8 x S 128, checkpoints
                under ``--disk-dir``): the loss below 2.5 at step 300;
                then 6 steps straight against 3 + ``checkpoint.save`` +
                ``restore`` into a fresh model and optimizer + 3, masters,
                moments and step bitwise, and one such step traced by
                ``torch.profiler``. It prints a ``{"train": ...}``
                line before the kernels line. Training runs no ParIS+
                kernel: its launch counts are read and are all 0;
  dryrun      — the launch tools (``repro_torch.launch``: ``specs``,
                ``dryrun``, ``roofline``), in a child process of their own
                (the fake process group of 512 ranks never touches this
                one): (a) the train phase's step — granite-34b at full
                width, 4 layers, B 4 x S 2048, 2 microbatches
                (``microbatch_tokens_per_device`` 4096), bf16 with float32
                masters, remat — built by ``specs.build_cell`` on a (1, 1)
                mesh and traced once on fake CUDA tensors: its counted
                FLOPs within 1% of the train phase's ``train_flops``, its
                traced peak beside the measured one (within 25%; PERF.md
                states the prediction), its compute and memory terms
                beside the measured step; (b) the paris ``search`` and
                ``build`` cells on the (16, 16) mesh, with their terms and
                the host reads counted once. Production LM cells trace for
                minutes and run alone (``python -m
                repro_torch.launch.dryrun``). It prints a ``{"dryrun":
                ...}`` line before the kernels line, with the host cost of
                a kernel call through ``torch.ops.repro_torch`` and
                through its wrapper (timed after phase 6). It launches no
                kernel: its launch counts are read and are all 0;
  shard       — sharded training over a ("data", "model") ``DeviceMesh``
                (``repro_torch.training.sharding``): (a) one NCCL rank on a
                (1, 1) mesh, granite-34b at full width, 2 of its 88
                layers, bf16 with float32 masters, remat, B 4 x S 2048 in 2
                microbatches: 2 plain steps and 2 steps on the distributed
                state from the same init and batches, losses, grad norms
                and every master bitwise, the step times of both; (b) 4
                gloo ranks on the card, a (2, 2) mesh, granite-34b at full
                width, 1 layer, float32 (1.134 B parameters), B 4 x S 512,
                warmup 0: each rank holds its ``param_pspec`` blocks (its
                state bytes against the unsharded state's), the first
                batch's loss and gradients (each within 1e-3 of its leaf's
                largest) and 2 steps against the single-card step (losses
                within 1e-5 relative, masters within lr / 4), a checkpoint
                after step 1; (c) 2 gloo ranks, a (2, 1) mesh, olmoe-1b-7b at
                full width, 1 layer, float32, capacity 64, 2 x 128 tokens a
                rank: local against global dispatch logits within 1e-3, and
                two runs of forward + backward bitwise; (d) (b)'s checkpoint
                restored onto a (4, 1) mesh and step 2 taken again: its
                loss within 1e-5 of (b)'s, masters within lr / 4 of the
                single card's, and the checkpoint's files byte-identical to
                a single-process save of the same state (restored on the
                host; the bytes made in memory). It prints wall times,
                every rank's peak (summed with the parent's: under 70 GiB)
                and collective counts (``CommDebugMode``), and a
                ``{"shard": ...}`` line before the kernels line. The gloo
                ranks share the one card (NCCL takes one rank a card) and
                stage DTensor's collectives through the host: no figure of
                this phase is a multi-card one. Its launch counts are read
                and are all 0.

Phases 4, 5, classify, serve, mesh, 7, 8, lm, train, dryrun and shard each drive a path
with every launch count set to 0 just before and read just after; each
kernel of a path must have launched on it, and a kernel's ``launches`` are
its counts summed over those paths. Phase 2 prints the build's nvcc seconds and fails
if any kernel instantiation spills registers. The last ten lines of
standard output are the tuning phase's JSON object, the serve phase's, the
mesh phase's, the lm phase's, the train phase's, the dryrun phase's, the
shard phase's, the kernels' JSON object,
the ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
...}``.
It imports no JAX: the port is the package ``repro_torch`` under ``src/``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

SRC = pathlib.Path(__file__).resolve().parent / "src"
KERNEL_ROWS = {  # name -> (source, TPU kernel it replaces)
    "paa_isax": ("src/repro_torch/kernels/csrc/paa_isax.cu",
                 "src/repro/kernels/paa_isax.py:24"),
    "lower_bound_sq_batch": ("src/repro_torch/kernels/csrc/lower_bound.cu",
                             "src/repro/kernels/lower_bound.py:54"),
    "euclid_sq": ("src/repro_torch/kernels/csrc/euclidean.cu",
                  "src/repro/kernels/euclidean.py:21"),
    "lower_bound_sq": ("src/repro_torch/kernels/csrc/lower_bound.cu",
                       "src/repro/kernels/lower_bound.py:26"),  # and :42
    "lower_bound_sq_multi": ("src/repro_torch/kernels/csrc/lower_bound.cu",
                             "src/repro/kernels/lower_bound.py:77"),
    "euclid_min": ("src/repro_torch/kernels/csrc/euclidean.cu",
                   "src/repro/kernels/euclidean.py:54"),
    "select": ("src/repro_torch/kernels/csrc/select.cu",
               "none (phase 1 of the reference's jax.lax.top_k, "
               "src/repro/core/search.py:592)"),
    "order_range": ("src/repro_torch/kernels/csrc/select.cu",
                    "none (phase 2 of the reference's jax.lax.top_k)"),
    "engine_round": ("src/repro_torch/kernels/csrc/euclidean.cu",
                     "none (the reference's round body, XLA ops in its "
                     "while_loop, src/repro/core/search.py:655)"),
}
# The kernels each driven path must launch.
PATH_KERNELS = {
    "full": ("paa_isax", "lower_bound_sq_batch", "euclid_sq", "select",
             "order_range", "engine_round"),
    "baselines": ("lower_bound_sq", "euclid_sq", "euclid_min"),
    "classify": ("lower_bound_sq_batch", "euclid_sq"),
    "serve": ("paa_isax", "lower_bound_sq_batch", "euclid_sq"),
    "packed": ("paa_isax", "lower_bound_sq_multi", "euclid_sq",
               "engine_round"),
    "disk": ("paa_isax", "lower_bound_sq_batch", "lower_bound_sq_multi",
             "euclid_sq"),
    "mesh": ("paa_isax", "lower_bound_sq_batch", "lower_bound_sq",
             "euclid_sq"),
    "lm": ("paa_isax", "lower_bound_sq_batch", "euclid_sq"),
    "train": (),  # LM training runs no ParIS+ kernel
    "dryrun": (),  # nor does the dry-run: it traces fake tensors
    "shard": (),  # nor does sharded training
}
# Each kernel's name in the launch-shape registry (euclid_min keeps a fixed
# shape: 256 threads, 4 rows a warp, at most 2048 blocks).
TUNED_AS = {"paa_isax": "paa_isax", "lower_bound_sq_batch": "lb_batch",
            "euclid_sq": "euclid", "lower_bound_sq": "lb_single",
            "lower_bound_sq_multi": "lb_multi"}
MAX_PEAK_GIB = 70.0  # the packed and disk phases' device-memory limit
DISK_CHUNK = 1 << 18  # pipeline chunk (series): the double-buffer size
DISK_EPOCHS = 4  # the pipeline's memory limit is N / 4 series
APPEND_BATCH = 1 << 20  # series per live append
# The disk phase writes several times its raw bytes (the file, the
# pipelines' epoch shards, the base, the appends, the runs, the major
# fold's base, the cold epoch; it prints what it wrote), and the H100
# hosts it runs on stop a command whose disk writes pass 45 GiB, deleted
# files included: 2^24 series (16 GiB of raw) do not fit, and 2^23 (37
# GiB written) leaves no room for the shard phase's 12.7 GiB checkpoint.
# 2^21 (9.3 GiB written, about 30 s) keeps the script within 10 minutes
# with the dryrun phase; --disk-log2-n 22 runs 2^22 series.
DISK_LOG2_N_MAX = 21


class CheckFailed(AssertionError):
    """A check of this script failed."""


def expect(cond, what: str) -> None:
    """Raise :class:`CheckFailed` unless ``cond`` holds."""
    if not bool(cond):
        raise CheckFailed(what)


def log(msg: str) -> None:
    """Print one progress line and flush it."""
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch

    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    """(the least time in ms for these bytes and fp32 operations, which of
    the two binds), at the H100 peaks of ``repro_torch.launch.roofline``."""
    from repro_torch.launch import roofline

    t, by = roofline.bound_seconds(n_bytes, n_ops)
    return t * 1e3, by


def launch_shape(name: str, q: int, n: int, dev) -> dict:
    """The launch shape kernel ``name`` resolves to for a (Q, N) call on
    ``dev``: its tuning-table entry or its defaults (``euclid_min``: fixed)."""
    from repro_torch.core import tuning

    if name not in TUNED_AS:
        return {"threads": 256, "rows_per_warp": 4, "max_blocks": 2048}
    return tuning.resolve_blocks(TUNED_AS[name], q=q, n=n, device=dev)


def kernel_row(name, err, ms, plain_ms, cost, shape) -> dict:
    """One kernel's entry of the JSON line; ``launches`` is filled in later.
    ``cost`` is ``roofline.kernel_cost``'s bytes and operations at the
    timed call, ``shape`` the launch shape it was timed at."""
    n_bytes, n_ops = cost["bytes"], cost["ops"]
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    src, replaces = KERNEL_ROWS[name]
    log(f"[kernel] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms); bytes "
        f"{n_bytes:.4g} ops {n_ops:.4g}; bound {b_ms:.4f} ms by {b_by}; "
        f"{100 * b_ms / ms:.1f}% of bound; max abs err {err:.3g}; shape "
        f"{shape}")
    return dict(name=name, route="cuda", source=src, replaces=replaces,
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, shape=shape)


def path_counts(path: str, counts=None) -> dict:
    """Read the launch counts after driving ``path`` (or take ``counts``,
    summed over its processes); each of its kernels must have launched."""
    from repro_torch.kernels import ops

    if counts is None:
        counts = ops.launch_counts()
    log(f"[{path}] launches {counts}")
    for name in PATH_KERNELS[path]:
        expect(counts[name] > 0, f"kernel {name} never launched on the "
               f"{path} path")
    return counts


WALK_CHUNK = 1 << 20  # series made per generator call


def walk_chunks(num: int, n: int, gen, device):
    """Random walks made on ``device``, ``WALK_CHUNK`` series at a time:
    yields (start, (rows, n) tensor)."""
    import torch

    for s in range(0, num, WALK_CHUNK):
        e = min(s + WALK_CHUNK, num)
        yield s, torch.randn((e - s, n), generator=gen,
                             device=device).cumsum_(dim=1)


def random_walks(num: int, n: int, gen, device) -> "torch.Tensor":
    """``num`` random walks of length ``n``, made on ``device``."""
    import torch

    out = torch.empty((num, n), dtype=torch.float32, device=device)
    for s, chunk in walk_chunks(num, n, gen, device):
        out[s:s + chunk.shape[0]] = chunk
    return out


def oracle_knn(raw, qz, k: int, chunk: int = 8192) -> tuple:
    """Brute force: direct-difference distances, stable (lower position) ties."""
    import torch

    n_q = qz.shape[0]
    best_d = torch.full((n_q, k), float("inf"), device=raw.device)
    best_p = torch.full((n_q, k), -1, dtype=torch.int64, device=raw.device)
    for s in range(0, raw.shape[0], chunk):
        x = raw[s:s + chunk]
        d = ((x[None, :, :] - qz[:, None, :]) ** 2).sum(dim=-1)
        pos = torch.arange(s, s + x.shape[0], device=raw.device)
        md = torch.cat([best_d, d], dim=1)
        mp = torch.cat([best_p, pos[None, :].expand(n_q, -1)], dim=1)
        vals, sel = torch.sort(md, dim=1, stable=True)
        best_d, best_p = vals[:, :k], mp.gather(1, sel[:, :k])
    return best_d, best_p


def check_against_oracle(raw, qz, d, p, od, what: str) -> None:
    """Exact answers: distances match the oracle's and each position is real."""
    import torch

    expect(torch.isfinite(d).all(), f"{what}: non-finite distances")
    expect(torch.allclose(d, od, rtol=1e-5, atol=1e-5),
           f"{what}: distances differ from the oracle, max rel "
           f"{((d - od).abs() / od.clamp_min(1e-30)).max().item():.3e}")
    direct = ((raw[p.long()] - qz[:, None, :]) ** 2).sum(dim=-1)
    expect(torch.allclose(direct, od, rtol=1e-5, atol=1e-5),
           f"{what}: a returned position is not at an oracle distance")


def phase_device() -> tuple:
    """The card's name, count and ``nvidia-smi`` name and power limit."""
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return name, count, smi


# A lower-bound kernel's mangled name: lb_kernel<w, form, threads, rows>
# with an int form (0 batch, 1 masked), or lb_single_kernel<w, threads>; in
# builds before the launch shape was a template argument, lb_kernel<w,
# form> and lb_single_kernel<w> (and, before the forms had kernels of their
# own, lb_kernel<w, masked> with a bool).
LB_NAME = re.compile(
    r"lb_(?:kernelILi(\d+)EL[bi](\d)E(?:Li(\d+)ELi(\d+)E)?"
    r"|single_kernelILi(\d+)E(?:Li(\d+)E)?)")


def lb_instance(mangled: str):
    """(``lb_kernel<w=16, batch>``, w) for a mangled lower-bound kernel at
    its default launch shape (128 threads of 4 rows, 2 at w = 32; the
    single query's 512 threads), ``lb_kernel<w=16, batch, threads=256,
    rows=2>`` at another; else (None, 0)."""
    m = LB_NAME.search(mangled)
    if m is None:
        return None, 0
    if m.group(5):
        w, threads = int(m.group(5)), m.group(6)
        extra = "" if threads in (None, "512") else f", threads={threads}"
        return f"lb_kernel<w={w}, single{extra}>", w
    w, form = int(m.group(1)), ("batch", "masked")[int(m.group(2))]
    threads, rows = m.group(3), m.group(4)
    default = (threads is None
               or (int(threads), int(rows)) == (128, 2 if w == 32 else 4))
    extra = "" if default else f", threads={threads}, rows={rows}"
    return f"lb_kernel<w={w}, {form}{extra}>", w


def ptxas_entries(build_log: str) -> list:
    """(entry, registers, spill stores, spill loads, static smem bytes) for
    each entry function in the ``-Xptxas -v`` output of a build."""
    rows, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = [m.group(1), None, 0, 0, 0]
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur[2], cur[3] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[1] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur[4] = int(sm.group(1)) if sm else 0
    return [tuple(r) for r in rows]


def cuobjdump_path():
    """``cuobjdump`` beside ``nvcc``, or on PATH; None if there is none."""
    from repro_torch.kernels import _build

    cand = pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"
    return str(cand) if cand.is_file() else shutil.which("cuobjdump")


def sass_functions(so_path) -> dict:
    """Mangled name -> [(address, opcode, text)] from ``cuobjdump -sass``,
    or {} without ``cuobjdump``."""
    tool = cuobjdump_path()
    if tool is None:
        return {}
    text = subprocess.run([tool, "-sass", str(so_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            body = re.sub(r"^@!?U?P[T\d]+\s+", "", m.group(2))
            cur.append((int(m.group(1), 16), body.split()[0], body))
    return funcs


def hot_loop(insts: list, w: int):
    """The inner loop of a lower-bound kernel's SASS: of the innermost
    loops (backward branches whose range holds no other), the one with the
    fewest instructions per (query, row) pair. Each pair takes w + 1 FMULs
    (w squares and the scale), so a loop's pairs are its FMULs / (w + 1).
    Returns (instructions, pairs, per pair, per segment, opcode counts), or
    None where no loop holds a pair (a kernel in which each thread computes
    one pair; the single query's grid-stride loop holds one a row)."""
    loops = []
    for addr, op, body in insts:
        m = re.search(r"BRA\S*\s+(?:`\()?(0x[0-9a-f]+)", body)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(a, b) for a, b in loops if not any(
        a <= c and d <= b and (c, d) != (a, b) for c, d in loops)]
    best = None
    for a, b in inner:
        counts = {}
        for addr, op, _ in insts:
            if a <= addr <= b:
                counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
        pairs = counts.get("FMUL", 0) / (w + 1)
        n = sum(counts.values())
        if pairs >= 1 and (best is None or n / pairs < best[2]):
            best = (n, pairs, n / pairs, n / pairs / w, counts)
    return best


def report_lb_code(tag: str, build_log: str, so_path) -> dict:
    """Print each lower-bound instantiation's registers, spills and shared
    memory, and (with ``cuobjdump``) the inner loop's instruction count of
    each instantiation at its default launch shape; returns the
    instructions per (query, row) pair by instantiation."""
    per_pair = {}
    for entry, regs, st, ld, smem in ptxas_entries(build_log):
        inst, _ = lb_instance(entry)
        if inst:
            log(f"[{tag}] {inst}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B, static smem {smem} B")
    funcs = sass_functions(so_path)
    if not funcs:
        log(f"[{tag}] cuobjdump not found: no SASS instruction counts")
    for entry, insts in sorted(funcs.items()):
        inst, w = lb_instance(entry)
        if inst is None or "threads=" in inst:  # default shapes only
            continue
        loop = hot_loop(insts, w)
        if loop is None:
            log(f"[{tag}] {inst} SASS: no loop holds a (query, row) pair, "
                f"{len(insts)} instructions in all")
            continue
        n, pairs, per_pair[inst], per_seg, counts = loop
        top = ", ".join(f"{k} {v}" for k, v in sorted(
            counts.items(), key=lambda kv: -kv[1])[:8])
        log(f"[{tag}] {inst} SASS inner loop: {n} instructions for "
            f"{pairs:g} (query, row) pairs: {per_pair[inst]:.2f} a pair, "
            f"{per_seg:.3f} a segment; {top}")
    return per_pair


def phase_build() -> None:
    """Build every kernel source with ``nvcc``; fail on register spills."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s, {len(_build.UNITS)} units in "
        "parallel)")
    for line in _build.build_log.splitlines():
        if ("ptxas info" in line or "spill" in line
                or line.startswith("---")):
            log(f"[build]   {line.strip()}")
    report_lb_code("build", _build.build_log, _build.library_path)
    entries = ptxas_entries(_build.build_log)
    spills = [e for e in entries if e[2] or e[3]]
    log(f"[build] {len(entries)} kernel instantiations, {len(spills)} spill")
    expect(not spills, f"instantiations that spill registers (drop their "
           f"shapes from the lattice): {[e[0] for e in spills]}")


def phase_quickstart(dev) -> None:
    """A small index built by the kernels and by the plain versions, and
    its exact and tiered answers, held to each other."""
    import numpy as np
    import torch

    from repro_torch.core import Tier, build_index, isax
    from repro_torch.core.search import exact_knn_batch, knn_batch_tiered

    rng = np.random.default_rng(0)
    raw = rng.standard_normal((4096, 128), dtype=np.float32).cumsum(axis=1)
    queries = rng.standard_normal((8, 128), dtype=np.float32).cumsum(axis=1)
    index = build_index(raw, device=dev)
    plain = build_index(raw, device=dev, impl="ref")
    expect(torch.equal(index.sax, plain.sax) and torch.equal(
        index.pos, plain.pos), "quickstart: kernel build != plain build")
    d, p = exact_knn_batch(index, queries, k=4)
    d_ref, p_ref = exact_knn_batch(plain, queries, k=4, impl="ref")
    qz = isax.znorm(torch.tensor(queries, device=dev))
    od, _ = oracle_knn(index.raw, qz, 4)
    check_against_oracle(index.raw, qz, d, p, od, "quickstart exact")
    expect(torch.allclose(d, d_ref, rtol=1e-5, atol=1e-5),
           "quickstart: kernel engine != plain engine")
    d_eps, _, achieved = knn_batch_tiered(index, queries, Tier.epsilon(0.1),
                                          k=4)
    expect(np.all(achieved <= 0.1 + 1e-6), "quickstart: epsilon bound")
    expect(torch.all(d_eps.sqrt() <= 1.1 * d.sqrt() * (1 + 1e-5)),
           "quickstart: epsilon answer worse than (1+eps) x exact")
    d_b, _, ach_b = knn_batch_tiered(index, queries, Tier.budget(2), k=4)
    expect(torch.all(d_b >= d * (1 - 1e-5)), "quickstart: budget below exact")
    log(f"[quickstart] exact kth {d[:, -1].tolist()}")
    log(f"[quickstart] epsilon achieved {achieved.tolist()}; budget achieved "
        f"{ach_b.tolist()}")


def phase_full(args, dev) -> dict:
    """The main path at full size: build the index, answer the queries
    exact and tiered, hold them to the oracle; returns what later phases
    reuse."""
    import numpy as np
    import torch

    from repro_torch.core import Tier, build_index, isax
    from repro_torch.core.search import exact_knn_batch, knn_batch_tiered
    from repro_torch.kernels import ops

    n_series, n, k, rs = 1 << args.log2_n, 256, args.k, 4096
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    raw = random_walks(n_series, n, gen, dev)
    queries = random_walks(args.queries, n, gen, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    index = build_index(raw, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    del raw  # the index holds the z-normed copy
    t0 = time.perf_counter()
    d, p, reads, updates, rounds = exact_knn_batch(
        index, queries, k=k, round_size=rs, leaf_cap=256, stats=True)
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_eps, p_eps, ach_eps = knn_batch_tiered(
        index, queries, Tier.epsilon(0.1), k=k, round_size=rs)
    torch.cuda.synchronize()
    t_eps = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_bud, p_bud, ach_bud = knn_batch_tiered(
        index, queries, Tier.budget(2), k=k, round_size=rs)
    torch.cuda.synchronize()
    t_bud = time.perf_counter() - t0
    counts = path_counts("full")
    peak = torch.cuda.max_memory_allocated()

    log(f"[full] N={n_series} n={n} Q={args.queries} k={k} round={rs} "
        f"seed={args.seed}")
    log(f"[full] build_index {t_build:.3f} s; exact_knn_batch {t_exact:.3f} s "
        f"({rounds} rounds, reads/query mean "
        f"{reads.double().mean().item():.1f} max {reads.max().item()}, "
        f"{100 * reads.double().mean().item() / n_series:.3f}% of N); "
        f"epsilon 0.1 {t_eps:.3f} s; budget 2 {t_bud:.3f} s")
    log(f"[full] peak device memory {peak / 2**30:.2f} GiB")

    t0 = time.perf_counter()
    qz = isax.znorm(queries)
    od, op = oracle_knn(index.raw, qz, k)
    torch.cuda.synchronize()
    log(f"[full] brute-force oracle {time.perf_counter() - t0:.2f} s")
    check_against_oracle(index.raw, qz, d, p, od, "full exact")
    expect(np.all(ach_eps <= 0.1 + 1e-6), "full: epsilon achieved > 0.1")
    expect(torch.all(d_eps.sqrt() <= 1.1 * d.sqrt() * (1 + 1e-5)),
           "full: epsilon answer worse than 1.1 x exact")
    for dd, pp, what in ((d_eps, p_eps, "epsilon"), (d_bud, p_bud, "budget")):
        direct = ((index.raw[pp.long()] - qz[:, None, :]) ** 2).sum(dim=-1)
        expect(torch.allclose(direct, dd, rtol=1e-5, atol=1e-5),
               f"full {what}: a position is not at its reported distance")
        expect(torch.all(dd >= od * (1 - 1e-5)), f"full {what}: below exact")
    log(f"[full] exact answers match the oracle; epsilon achieved max "
        f"{ach_eps.max():.4f}; budget achieved max {ach_bud.max():.4f}")
    return dict(index=index, queries=queries, qz=qz, counts=counts, d=d, p=p,
                od=od, op=op, args=args)


def phase_baselines(full: dict) -> dict:
    """The single-query baselines on phase 4's index, every 1-NN held to
    the oracle; returns the path's launch counts."""
    import torch

    from repro_torch.core import SearchConfig
    from repro_torch.core.search import (brute_force, exact_search_single,
                                         nb_exact_search)
    from repro_torch.kernels import ops

    index, queries, qz = full["index"], full["queries"], full["qz"]
    od, op = full["od"][:, 0], full["op"][:, 0]
    n_series = index.num_series
    n_q = min(8, queries.shape[0])
    cfg = SearchConfig()
    algos = (("exact_search_single", lambda q: exact_search_single(index, q,
                                                                   cfg)),
             ("nb_exact_search", lambda q: nb_exact_search(index, q, cfg)),
             ("brute_force", lambda q: brute_force(index, q)))
    log(f"[baselines] N={n_series} queries={n_q} round={cfg.round_size} "
        f"leaf={cfg.leaf_cap} workers={cfg.workers}")
    ops.reset_launch_counts()
    results = {name: [] for name, _ in algos}
    for i in range(n_q):
        for name, fn in algos:
            t0 = time.perf_counter()
            res = fn(queries[i])
            torch.cuda.synchronize()
            results[name].append((time.perf_counter() - t0, res))
    counts = path_counts("baselines")

    for name, _ in algos:
        times = []
        for i, (dt, res) in enumerate(results[name]):
            d, pos = res.dist_sq, int(res.position)
            direct = ((index.raw[pos] - qz[i]) ** 2).sum()
            expect(torch.isfinite(d) and torch.allclose(
                d, od[i], rtol=1e-5, atol=1e-5),
                f"{name} query {i}: distance {d.item()} != oracle "
                f"{od[i].item()}")
            expect(pos == int(op[i]) or torch.allclose(
                direct, od[i], rtol=1e-5, atol=1e-5),
                f"{name} query {i}: position {pos} is not an oracle 1-NN")
            reads = int(res.raw_reads)
            log(f"[baselines] {name} q{i}: {1e3 * dt:.3f} ms; raw_reads "
                f"{reads} ({100 * reads / n_series:.4f}% of N); rounds "
                f"{res.rounds}")
            times.append(dt)
        log(f"[baselines] {name}: mean {1e3 * sum(times) / len(times):.3f} ms"
            f" per query; every 1-NN matches the oracle")
    return counts


CLASSIFY_QUERIES = 16  # the classify phase's random-walk queries
CLASSIFY_K = 5


def phase_classify(full: dict) -> dict:
    """The k-NN classifier over phase 4's index (see the module docstring);
    returns the path's launch counts."""
    import torch

    from repro_torch.core import isax
    from repro_torch.core.classifier import KnnClassifier
    from repro_torch.kernels import ops

    index, args = full["index"], full["args"]
    dev, n = index.device, index.series_length
    labels = (index.raw[:, -1] > index.raw[:, 0]).to(torch.int64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)  # not phase 4's stream: other queries
    queries = random_walks(CLASSIFY_QUERIES, n, gen, dev)
    clf = KnnClassifier(index, labels, k=CLASSIFY_K)
    log(f"[classify] N={index.num_series} labels: trend up "
        f"{int(labels.sum())}, down {index.num_series - int(labels.sum())}; "
        f"{CLASSIFY_QUERIES} queries, k={CLASSIFY_K}")

    ops.reset_launch_counts()  # the classify path starts here
    found, times = [], {"predict": [], "predict_brute": []}
    for q in queries:
        for name in times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            label = getattr(clf, name)(q)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            found.append((name, label))
        found.append(("neighbours", clf.kneighbors(q)[1]))
    counts = path_counts("classify")  # the classify path ends here
    classify_kernel_checks(index, queries[0], clf.round_size)

    od, op = oracle_knn(index.raw, isax.znorm(queries), CLASSIFY_K)
    for i in range(CLASSIFY_QUERIES):
        (_, pred), (_, brute), (_, nbrs) = found[3 * i:3 * i + 3]
        want = clf.vote(op[i])
        expect(pred == brute == want, f"classify query {i}: predict {pred}, "
               f"predict_brute {brute}, the oracle's vote {want}")
        expect(torch.equal(torch.sort(nbrs.long()).values,
                           torch.sort(op[i]).values),
               f"classify query {i}: neighbours {nbrs.tolist()} are not the "
               f"oracle's {op[i].tolist()}")
    for name, ts in times.items():
        log(f"[classify] {name}: mean {1e3 * sum(ts) / len(ts):.3f} ms a "
            f"query")
    log(f"[classify] every query: predict == predict_brute == the oracle's "
        f"vote, neighbours the oracle's")
    return counts


def first_round(lb, num_series: int, rs: int):
    """Each query's first round of the engine's candidate list over
    ``lb``: (Q, rs) int64 rows, as ``CandidateList`` gives them."""
    from repro_torch.core.search import CandidateList, select_len

    cands = CandidateList(lb, select_len(num_series, rs), rs, "auto")
    return cands.round(0)[0].long()


def classify_kernel_checks(index, query, rs: int) -> None:
    """The classify path's kernels against their plain versions at its
    shapes (``exact_knn`` runs the batch engine at Q = 1):
    ``lower_bound_sq_batch`` on one query's (1, w) PAA over the index's SAX,
    ``euclid_sq`` on that query's first-round (1, rs) candidate gather."""
    import torch

    from repro_torch.core import isax
    from repro_torch.core.search import _queries
    from repro_torch.kernels import ops

    n, w = index.series_length, index.segments
    qs = isax.znorm(_queries(index, query[None, :]))
    qps = isax.paa(qs, w)
    bpp = isax.padded_breakpoints(index.cardinality, index.device)
    lb = ops.lower_bound_sq_batch(qps, index.sax, bpp, n)
    expect(torch.equal(lb, ops.lower_bound_sq_batch(
        qps, index.sax, bpp, n, impl="ref")), "classify: lower_bound_sq_batch"
        " at Q=1 not bitwise equal to its plain version")
    pos = index.pos[first_round(lb, index.num_series, rs)].contiguous()
    del lb
    got = ops.euclid_sq_gather(qs, index.raw, pos)
    plain = ops.euclid_sq_gather(qs, index.raw, pos, impl="ref")
    expect(torch.allclose(got, plain, rtol=1e-5, atol=1e-5),
           "classify: euclid_sq differs from its plain version")
    log(f"[classify] lower_bound_sq_batch (1 x {index.num_series}) bitwise "
        f"equal to its plain version; euclid_sq (1 x {pos.shape[1]} "
        "first-round gather) within 1e-5 of its plain version")


def phase_kernels(full: dict) -> list:
    """Each kernel against its plain version at the full phase's shapes,
    timed beside its bound and the plain version; the kernels line's rows."""
    import torch

    from repro_torch.core import isax
    from repro_torch.core.search import (PREFIX_GROWTH, CandidateList,
                                         select_len)
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.roofline import kernel_cost

    index, qz = full["index"], full["qz"]
    dev = index.device
    n_series, n = index.raw.shape
    w, card = index.segments, index.cardinality
    n_q = qz.shape[0]
    rows = []
    row = lambda *a: rows.append(kernel_row(*a))  # noqa: E731

    # paa_isax on the z-normed full-size series, as build_index calls it.
    bp = isax.gaussian_breakpoints(card, dev)
    sax_k, paa_k = ops.paa_isax(index.raw, bp, w, normalize=False)
    sax_p, paa_p = ops.paa_isax(index.raw, bp, w, normalize=False, impl="ref")
    mism = int((sax_k != sax_p).sum())
    err = (paa_k - paa_p).abs().max().item()
    log(f"[kernel] paa_isax: {mism} symbol mismatches of {sax_k.numel()}")
    expect(mism == 0 and err == 0.0, "paa_isax differs from its plain version")
    del sax_p, paa_p, paa_k
    row("paa_isax", err,
        time_ms(lambda: ops.paa_isax(index.raw, bp, w, normalize=False), 10),
        time_ms(lambda: ops.paa_isax(index.raw, bp, w, normalize=False,
                                     impl="ref"), 2),
        kernel_cost("paa_isax", b=n_series, n=n, w=w, n_bp=bp.numel()),
        launch_shape("paa_isax", 1, n_series, dev))

    # lower_bound_sq_batch: the engine's (Q, N) pass.
    qps = isax.paa(qz, w)
    bpp = isax.padded_breakpoints(card, dev)
    lb_k = ops.lower_bound_sq_batch(qps, index.sax, bpp, n)
    lb_p = ops.lower_bound_sq_batch(qps, index.sax, bpp, n, impl="ref")
    err = (lb_k - lb_p).abs().max().item()
    expect(torch.equal(lb_k, lb_p),
           f"lower_bound_sq_batch not bitwise equal to plain (max {err})")
    del lb_p
    row("lower_bound_sq_batch", err,
        time_ms(lambda: ops.lower_bound_sq_batch(qps, index.sax, bpp, n), 10),
        time_ms(lambda: ops.lower_bound_sq_batch(qps, index.sax, bpp, n,
                                                 impl="ref"), 2),
        kernel_cost("lower_bound_sq_batch", q=n_q, n_rows=n_series, w=w,
                    n_bp=bpp.numel()),
        launch_shape("lower_bound_sq_batch", n_q, n_series, dev))

    # select and order_range: the engine's candidate selection, (Q, N) ->
    # (Q, select_len), in its two phases. The row of order_range is the
    # list's first prefix, what a batch that ends in one round orders; its
    # first extension is logged beside it. Both are held to the whole
    # sorted list of the oracle, the int64-key torch.topk.
    rs = 4096
    sel = select_len(n_series, rs)
    order, sel_k = ref.smallest(lb_k, sel)
    got = ops.select(lb_k, sel)
    plain = ops.select(lb_k, sel, impl="ref")
    expect(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, plain)),
           "select not bitwise equal to its plain version")
    del plain
    row("select", 0.0, time_ms(lambda: ops.select(lb_k, sel), 10),
        time_ms(lambda: ops.select(lb_k, sel, impl="ref"), 3),
        kernel_cost("select", q=n_q, n=n_series, k=sel), {})
    cols_s, bounds_s, _ = got
    del got
    first = CandidateList.first_prefix(sel, rs)
    part = ops.order_range(bounds_s, cols_s, 0, first)
    plain = ops.order_range(bounds_s, cols_s, 0, first, impl="ref")
    # the first extension, [2^15, 2^17) at the full size
    ext = (min(first, sel // 2), min(PREFIX_GROWTH * first, sel))
    cut = (sel_k[:, ext[0] - 1], order[:, ext[0] - 1])  # rank lo - 1
    sel_k_all = sel_k  # the rounds' bounds, for the engine_round row
    part_x = ops.order_range(bounds_s, cols_s, *ext, *cut)
    same = (torch.equal(part[0], plain[0])
            and torch.equal(part[1].view(torch.int32),
                            plain[1].view(torch.int32))
            and torch.equal(part[0], order[:, :first])
            and torch.equal(part_x[0], order[:, ext[0]:ext[1]])
            and torch.equal(part_x[1], sel_k[:, ext[0]:ext[1]]))
    ext_ms = time_ms(lambda: ops.order_range(bounds_s, cols_s, *ext, *cut),
                     10)
    log(f"[kernel] order_range: ranks [0, {first}) and [{ext[0]}, {ext[1]})"
        f" of the selected {sel} bitwise equal to their plain version and "
        f"to ref.smallest: {same}; [{ext[0]}, {ext[1]}) in {ext_ms:.4f} ms")
    expect(same, "order_range not bitwise equal to its plain version")
    del plain, part, part_x, sel_k
    row("order_range", 0.0,
        time_ms(lambda: ops.order_range(bounds_s, cols_s, 0, first), 10),
        time_ms(lambda: ops.order_range(bounds_s, cols_s, 0, first,
                                        impl="ref"), 3),
        kernel_cost("order_range", q=n_q, n=sel, m=first), {})
    del cols_s, bounds_s

    # euclid_sq: the first RDC round's (Q, 4096) candidates of every query.
    del lb_k
    pos = index.pos[order[:, :rs].long()].contiguous()
    d_k = ops.euclid_sq_gather(qz, index.raw, pos)
    d_p = ops.euclid_sq_gather(qz, index.raw, pos, impl="ref")
    err = (d_k - d_p).abs().max().item()
    rel = ((d_k - d_p).abs() / d_p.abs().clamp_min(1e-30)).max().item()
    expect(torch.allclose(d_k, d_p, rtol=1e-5, atol=1e-5),
           f"euclid_sq differs from its plain version (max rel {rel:.3e})")
    log(f"[kernel] euclid_sq: max rel err {rel:.3g}")
    uniq = torch.unique(pos).numel()
    row("euclid_sq", err,
        time_ms(lambda: ops.euclid_sq_gather(qz, index.raw, pos), 50),
        time_ms(lambda: ops.euclid_sq_gather(qz, index.raw, pos,
                                             impl="ref"), 5),
        kernel_cost("euclid_sq", q=n_q, r=rs, n=n, rows_read=uniq),
        launch_shape("euclid_sq", n_q, rs, dev))
    del pos, d_k, d_p
    rows.append(engine_round_row(index, qz, order, sel_k_all, full))
    del sel_k_all

    del order

    # lower_bound_sq: one query against all N rows, as the baselines call
    # it, in both of the reference's layouts (the same kernel here).
    qp1 = qps[0].contiguous()
    lb_p = ops.lower_bound_sq(qp1, index.sax, bpp, n, impl="ref")
    for transposed in (False, True):
        lb_k = ops.lower_bound_sq(qp1, index.sax, bpp, n,
                                  transposed=transposed)
        expect(torch.equal(lb_k, lb_p), f"lower_bound_sq (transposed="
               f"{transposed}) not bitwise equal to plain")
    err = (lb_k - lb_p).abs().max().item()
    del lb_k, lb_p
    row("lower_bound_sq", err,
        time_ms(lambda: ops.lower_bound_sq(qp1, index.sax, bpp, n), 50),
        time_ms(lambda: ops.lower_bound_sq(qp1, index.sax, bpp, n,
                                           impl="ref"), 3),
        kernel_cost("lower_bound_sq", n_rows=n_series, w=w,
                    n_bp=bpp.numel()),
        launch_shape("lower_bound_sq", 1, n_series, dev))

    # euclid_min: one query's brute-force scan of the raw rows.
    q1 = qz[0].contiguous()
    dk, ik = ops.euclid_min(q1, index.raw)
    dp, ip = ops.euclid_min(q1, index.raw, impl="ref")
    at_ik = ops.euclid_sq(q1, index.raw[int(ik)][None, :], impl="ref")[0]
    err = (dk - dp).abs().item()
    expect(torch.allclose(dk, dp, rtol=1e-5, atol=0),
           f"euclid_min distance {dk.item()} != plain {dp.item()}")
    expect(int(ik) == int(ip) or torch.allclose(at_ik, dp, rtol=1e-5, atol=0),
           f"euclid_min row {int(ik)} is not the plain argmin {int(ip)}")
    log(f"[kernel] euclid_min: row {int(ik)} (plain {int(ip)}), distance "
        f"{dk.item()} (plain {dp.item()})")
    row("euclid_min", err,
        time_ms(lambda: ops.euclid_min(q1, index.raw), 10),
        time_ms(lambda: ops.euclid_min(q1, index.raw, impl="ref"), 1),
        kernel_cost("euclid_min", b=n_series, n=n),
        launch_shape("euclid_min", 1, n_series, dev))
    return rows


def engine_round_row(index, qz, order, bounds, full) -> dict:
    """The engine's round at the main path's shape (Q = 64, rounds of 4096
    columns of the selected list, (Q, 4096) views of it with its row stride)
    through ``engine_round``, bit for bit against its plain version given
    the gather kernel's distances: result lists, reads, updates, skip_lb,
    the state words with the exit flag, and the k > 1 distances and
    positions. Round 0 from the bucket seed's k-th bests at k = 1 and 4
    (nearly every candidate masked in); round 1 from the seed at k = 8 with
    the tiers as ``tier_arrays`` makes them (exact, epsilon 0.1, and
    budgets that end at and after the round); and a later round from the
    exact answer's k-th bests at k = 1 and 8, plain and tiered, the round by
    which three quarters of the queries are done, so few candidates are
    masked in, as late in a hard batch. Then timed: each launch alone by
    CUDA events on fresh result lists at round 0 from the seed, the plain
    version with its own distances."""
    import torch

    from repro_torch.core import Tier
    from repro_torch.core.search import approx_search_batch, tier_arrays
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.roofline import kernel_cost

    dev = index.device
    n_q = qz.shape[0]
    rs = 4096
    n = index.raw.shape[1]
    bsf, bpos = approx_search_batch(index, qz, 256)
    store = (index.pos, index.raw)
    hooks = (ref.row_hooks(index.pos, index.raw)[0],
             lambda q, pos, mask: ops.euclid_sq_gather(q, index.raw, pos))
    kx = min(8, full["d"].shape[1])
    # the round by which three quarters of the queries have no bound left
    # below their exact k-th best
    below = (bounds < full["d"][:, kx - 1:kx]).sum(dim=1)
    late = int(torch.quantile(below.double(), 0.75).item()) // rs
    late = min(late, bounds.shape[1] // rs - 1)

    def fresh(k, start):
        if start == "exact":
            top_d = full["d"][:, :k].clone()
            top_p = full["p"][:, :k].to(torch.int32).clone()
        else:
            top_d = torch.full((n_q, k), float("inf"), device=dev)
            top_p = torch.full((n_q, k), -1, dtype=torch.int32, device=dev)
            top_d[:, 0], top_p[:, 0] = bsf, bpos  # the engine's seed slot
        return [top_d, top_p, torch.zeros(n_q, dtype=torch.int32, device=dev),
                torch.zeros(n_q, dtype=torch.int32, device=dev),
                torch.zeros(3 * n_q + 2, dtype=torch.int64, device=dev)]

    def tiers(r, tiered):
        if not tiered:
            return [None, None, None]
        kinds = [Tier.exact(), Tier.epsilon(0.1), Tier.budget(r + 1),
                 Tier.budget(max(r, 1))]  # a budget is one round or more
        eps, budget = tier_arrays([kinds[i % 4] for i in range(n_q)], dev)
        return [eps, budget, torch.full((n_q,), float("inf"), device=dev)]

    def outs(k):
        return ((torch.empty((n_q, rs), device=dev),
                 torch.empty((n_q, rs), dtype=torch.int32, device=dev))
                if k > 1 else (None, None))

    def window(r):
        return order[:, r * rs:(r + 1) * rs], bounds[:, r * rs:(r + 1) * rs]

    def bits(t):
        return t.view(torch.int32) if t.is_floating_point() else t

    same, read = True, []
    for start, k, r, tiered in (("seed", 1, 0, False), ("seed", 4, 0, False),
                                ("seed", kx, 1, True),
                                ("exact", 1, late, False),
                                ("exact", kx, late, False),
                                ("exact", kx, late, True)):
        got, want = fresh(k, start), fresh(k, start)
        t_k, t_p = tiers(r, tiered), tiers(r, tiered)
        o_k, o_p = outs(k), outs(k)
        ops.engine_round(*window(r), r, rs, store, qz, *got, tiers=t_k,
                         out=o_k)
        ref.engine_round(*window(r), r, rs, *hooks, qz, *want, *t_p, *o_p)
        pairs = [(a, b) for a, b in zip(got + t_k + list(o_k),
                                        want + t_p + list(o_p))
                 if a is not None]
        ok = all(torch.equal(bits(a), bits(b)) for a, b in pairs)
        same &= ok
        n_read = int(got[2].sum())
        read.append(n_read)
        log(f"[kernel] engine_round: {start} k = {k} round {r}"
            f"{' tiered' if tiered else ''}: bitwise equal {ok}, flag "
            f"{int(got[4][-1])}, {n_read} of {n_q * rs} candidates read")
    expect(same, "engine_round not bitwise equal to its plain version")
    expect(0 < read[3] < n_q * rs // 2,
           f"engine_round: the late round read {read[3]} candidates, not a "
           f"sparse mask")
    cols0, bounds0 = window(0)
    base = fresh(1, "seed")
    work = fresh(1, "seed")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(50)]
    for ev0, ev1 in events:
        for a, b in zip(work, base):
            a.copy_(b)
        ev0.record()
        ops.engine_round(cols0, bounds0, 0, rs, store, qz, *work)
        ev1.record()
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in events[1:]) / (len(events) - 1)

    def plain():
        ops.engine_round(cols0, bounds0, 0, rs, store, qz, *fresh(1, "seed"),
                         impl="ref")
    return kernel_row("engine_round", 0.0, ms, time_ms(plain, 3),
                      kernel_cost("engine_round", q=n_q, r=rs, n=n,
                                  rows_read=read[0]),
                      {"threads": 256, "rows_per_warp": 4})


# The tuning phase's moderate shapes (Q, N) for the bitwise checks of every
# admitted launch shape: bounds 64 x 2^20 (one query for the single form),
# one 4096-row round, 2^20 series.
TUNING_CHECK_SHAPES = {"lb_batch": (64, 1 << 20), "lb_multi": (64, 1 << 20),
                       "lb_single": (1, 1 << 20), "euclid": (64, 4096),
                       "paa_isax": (1, 1 << 20)}


def phase_tuning(dev) -> list:
    """The launch-shape table on the card (see the module docstring);
    returns the rows of the ``{"tuning": ...}`` line."""
    import torch

    from repro_torch.core import tuning

    table = tuning.get_table()
    problems = tuning.validate(table)
    expect(not problems, f"the committed tuning table: {problems}")
    backend = tuning.backend_of(dev)
    card, limit = tuning.card_and_power_limit()
    log(f"[tuning] table {tuning.default_table_path()}: "
        f"{len(table.entries)} entries, valid; this card's backend "
        f"{backend}")

    def outputs(run, kernel, n, params=None):
        out = run(params)
        out = out if isinstance(out, tuple) else (out,)
        return tuple(o[..., :n] if kernel == "lb_multi" else o for o in out)

    for kernel, (q, n) in TUNING_CHECK_SHAPES.items():
        run = tuning.kernel_runner(kernel, q=q, n=n, device=dev, seed=7)
        base = outputs(run, kernel, n)
        plain = outputs(tuning.kernel_runner(kernel, q=q, n=n, impl="ref",
                                             device=dev, seed=7), kernel, n)
        if kernel == "euclid":  # summed in another order than the plain
            expect(torch.allclose(base[0], plain[0], rtol=1e-5, atol=1e-5),
                   "euclid: the default shape differs from the plain version")
        else:
            expect(all(torch.equal(a, b) for a, b in zip(base, plain)),
                   f"{kernel}: the default shape is not bitwise equal to the "
                   "plain version")
        del plain
        points = tuning.lattice_points(kernel)
        for point in points:
            got = outputs(run, kernel, n, point)
            expect(all(torch.equal(a, b) for a, b in zip(base, got)),
                   f"{kernel} at {point}: not bitwise equal to the default "
                   "shape")
        del run, base, got
        torch.cuda.empty_cache()
        log(f"[tuning] {kernel} (Q={q}, N={n}): all {len(points)} admitted "
            f"shapes bitwise equal to the default, and the default to its "
            f"plain version")

    rows = []
    for kernel, spec in tuning.KERNELS.items():
        for q, n in spec.canonical:
            key = tuning.make_key(kernel, backend, "f32", q, n)
            entry = table.entries.get(key)
            winner = tuning.resolve_blocks(kernel, q=q, n=n, backend=backend)
            run = tuning.kernel_runner(kernel, q=q, n=n, device=dev)
            shapes = {"default": spec.defaults, "winner": winner}
            us = {k: [] for k in shapes}
            for k in ("default", "winner", "winner", "default"):  # in turns
                us[k].append(tuning.time_us(lambda: run(shapes[k]),
                                            device=dev))
            del run
            torch.cuda.empty_cache()
            row = dict(key=key, winner=winner,
                       us=sum(us["winner"]) / 2,
                       default_us=sum(us["default"]) / 2,
                       table_us=entry and entry["us_per_call"],
                       table_default_us=entry and entry["default_us_per_call"],
                       card=card, power_limit=limit)
            log(f"[tuning] {key}: winner {winner} {row['us']:.2f} us, default "
                f"{row['default_us']:.2f} us (table: {row['table_us']} and "
                f"{row['table_default_us']} us); {card}, {limit}")
            rows.append(row)
    return rows


SERVE_SHARDS = 4  # file-order shards of the serve phase's routers
SERVE_REPLICAS = 2  # replicas a shard
SERVE_CLIENTS = 4  # client threads of step (a)
SERVE_WAIT_S = 120.0  # any one future's timeout: a hang fails the run
DEADLINE_SLACK_S = 1.0  # how late a deadline may fail its future


def submit_all(router, queries, clients: int = 1, **kw) -> tuple:
    """Every query submitted from ``clients`` threads at once (client c
    sends rows c, c + clients, ...); returns (the futures' results in row
    order, wall seconds from the first submit to the last result)."""
    import threading

    futs = [None] * len(queries)

    def client(c):
        for i in range(c, len(queries), clients):
            futs[i] = router.submit(queries[i], **kw)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=SERVE_WAIT_S)
        expect(not th.is_alive(), "serve: a client thread hung")
    res = [f.result(timeout=SERVE_WAIT_S) for f in futs]
    return res, time.perf_counter() - t0


def stacked(res) -> tuple:
    """((Q, k) dists, (Q, k) positions) of a list of per-query answers."""
    import numpy as np

    return np.stack([r[0] for r in res]), np.stack([r[1] for r in res])


def finite(x):
    """``x`` as a float, or None where it is not finite (JSON has no inf)."""
    x = float(x)
    return x if x == x and abs(x) != float("inf") else None


def router_figures(s: dict) -> dict:
    """The router ``stats()`` keys the serve line reports."""
    keys = ("batches", "batch_size_avg", "latency_ms_avg", "latency_ms_max",
            "merges", "merge_ms_avg", "merge_ms_max", "qps", "retries",
            "hedges", "hedges_won", "hedges_denied", "deadline_expired",
            "shard_failures", "degraded", "blackholed")
    return {k: s[k] for k in keys}


def phase_serve(full: dict) -> tuple:
    """The serving fabric over phase 4's index: (a) the replicated router
    fed by client threads, (b) tiers and degradation, (c) injected faults,
    (d) the live-ingest router. Returns (the path's launch counts, the
    figures of the ``{"serve": ...}`` line)."""
    import numpy as np
    import torch

    from repro_torch.core import Tier, build_sharded_index
    from repro_torch.core.search import make_batch_engine, pow2_bucket
    from repro_torch.kernels import ops
    from repro_torch.serving import ShardedSearchRouter, TierDegradePolicy

    index, args, qz = full["index"], full["args"], full["qz"]
    k, rs = args.k, 4096
    host_q = full["queries"].cpu().numpy()  # clients send host rows
    want_d, want_p = full["d"].cpu().numpy(), full["p"].cpu().numpy()
    n_q = host_q.shape[0]
    fig = {}
    log(f"[serve] N={index.num_series} Q={n_q} k={k} round={rs}: "
        f"{SERVE_SHARDS} shards x {SERVE_REPLICAS} replicas, max_batch 64")

    def same(res, what):
        d, p = stacked(res)
        expect(np.array_equal(p, want_p), f"serve {what}: positions differ "
               "from phase 4's")
        expect(np.array_equal(d, want_d), f"serve {what}: distances not "
               "bitwise equal to phase 4's")

    def certified(d, p, ach, eps, what):
        """Each squared distance within (1 + achieved)^2 of the exact one in
        its column, at the distance of its position; achieved <= eps."""
        expect(np.all(ach <= eps + 1e-5), f"serve {what}: achieved epsilon "
               f"{ach.max()} > {eps}")
        fac = (1.0 + ach.astype(np.float64))[:, None] ** 2
        bound = np.where(np.isfinite(fac), fac * want_d, np.inf)
        expect(np.all(d <= bound * (1 + 1e-5)), f"serve {what}: an answer "
               "outside its certificate")
        expect(np.all(d >= want_d * (1 - 1e-5)), f"serve {what}: below exact")
        pos = torch.from_numpy(p).to(index.device).long()
        direct = ((index.raw[pos] - qz[:, None, :]) ** 2).sum(dim=-1)
        expect(torch.allclose(direct.cpu(), torch.from_numpy(d), rtol=1e-5,
                              atol=1e-5),
               f"serve {what}: a position is not at its reported distance")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the serve path starts here
    sharded = build_sharded_index(index, SERVE_SHARDS)  # views of the raw
    knobs = dict(k=k, replicas=SERVE_REPLICAS, max_batch=64, round_size=rs)

    def serving(**kw):
        router = ShardedSearchRouter(sharded, **knobs, **kw)
        router.start()
        return router

    # (a) Sharded, replicated, concurrent.
    router = serving()
    try:
        res, t_a = submit_all(router, host_q, clients=SERVE_CLIENTS)
    finally:
        router.stop()
    same(res, "(a)")
    fig["a"] = dict(wall_s=t_a, answers_per_s=n_q / t_a,
                    **router_figures(router.stats()))
    log(f"[serve] (a) {n_q} answers from {SERVE_CLIENTS} client threads in "
        f"{t_a:.4f} s, equal to phase 4's bit for bit; {fig['a']}")

    # (b) Tiers through the fan-out, then degradation by deadline slack.
    router = serving()
    try:
        for tier, what in ((Tier.epsilon(0.1), "epsilon 0.1"),
                           (Tier.budget(2), "budget 2")):
            (d, p, ach), t = timed(lambda: router.search_batch(host_q,
                                                               tier=tier))
            certified(d, p, ach, 0.1 if tier.kind == "epsilon" else np.inf,
                      what)
            fig[what] = dict(s=t, achieved_max=finite(ach.max()))
            log(f"[serve] (b) {what}: {t:.4f} s, achieved max "
                f"{ach.max():.5f}, every answer within its certificate")
    finally:
        router.stop()
    router = serving(degrade=TierDegradePolicy(
        epsilon_slack_ms=1e6, budget_slack_ms=1.0, epsilon=0.25))
    try:
        res, t = submit_all(router, host_q, deadline_ms=60_000.0)
    finally:
        router.stop()
    expect(all(len(r) == 3 for r in res), "serve: degraded answers must "
           "carry their achieved epsilon")
    d, p = stacked(res)
    certified(d, p, np.array([r[2] for r in res]), 0.25, "degraded")
    s = router.stats()
    expect(s["degraded"] == n_q, f"serve: {s['degraded']} degraded, not {n_q}")
    fig["degraded"] = dict(s=t, degraded=s["degraded"],
                           achieved_max=s["achieved_eps_max"])
    log(f"[serve] (b) degradation: {n_q} deadline-bearing requests in "
        f"{t:.4f} s, {s['degraded']} degraded to epsilon 0.25 (achieved max "
        f"{s['achieved_eps_max']:.5f})")

    # (c) Faults: rerouted, hedged, expired, typed.
    fig["faults"] = serve_faults(serving, host_q, same, fig["a"])

    # (d) The live-ingest router.
    fig["ingest"], chunk = serve_ingest(full, host_q, same)
    counts = path_counts("serve")  # the serve path ends here

    # Each kernel of the path against its plain version at the path's
    # shapes (after the counts were read: these launches do not count).
    cohort = min(n_q, pow2_bucket(math.ceil(fig["a"]["batch_size_avg"])))
    serve_kernel_checks(sharded.shards[0], host_q[:cohort], chunk, k, rs)
    del chunk

    # The layer below the router: the four shard engines called one after
    # another from this thread on all the queries, with no threads,
    # cohorts or merges (after the counts: not part of the path).
    engines = [make_batch_engine(sh, k=k, round_size=rs)
               for sh in sharded.shards]
    _, t_serial = timed(lambda: [e(host_q) for e in engines])
    fig["a"]["shard_engines_serial_s"] = t_serial
    log(f"[serve] the {SERVE_SHARDS} shard engines one after another on all "
        f"{n_q} queries: {t_serial:.4f} s (the router: {t_a:.4f} s)")
    # (a) again with one replica a shard and a wait no cohort reaches: each
    # shard answers all the queries as one cohort (not part of the path).
    router = ShardedSearchRouter(sharded, k=k, replicas=1, max_batch=n_q,
                                 max_wait_ms=1e3 * SERVE_WAIT_S,
                                 round_size=rs)
    router.start(tick_ms=0.5)  # the daemons' tick at the default wait
    try:
        res, t_one = submit_all(router, host_q, clients=SERVE_CLIENTS)
    finally:
        router.stop()
    same(res, "one replica, one cohort a shard")
    s = router.stats()
    fig["one_cohort"] = dict(wall_s=t_one, batches=s["batches"],
                             batch_size_avg=s["batch_size_avg"],
                             latency_ms_max=s["latency_ms_max"])
    log(f"[serve] one replica a shard, one cohort of {n_q} a shard: {n_q} "
        f"answers from {SERVE_CLIENTS} client threads in {t_one:.4f} s; "
        f"{fig['one_cohort']}")
    del engines, sharded
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] peak device memory {peak:.2f} GiB (limit "
        f"{MAX_PEAK_GIB:.0f})")
    expect(peak < MAX_PEAK_GIB, f"serve peak memory {peak:.2f} GiB")
    fig["peak_gib"] = peak
    fig["launches"] = counts
    return counts, fig


def serve_kernel_checks(shard, cohort_q, chunk, k: int, rs: int) -> None:
    """The serve path's kernels against their plain versions at its shapes:
    ``lower_bound_sq_batch`` on one cohort's padded PAA over a router shard
    and over one appended chunk, ``euclid_sq`` on that cohort's (Q, rs)
    gather (the shard engine's answers, then the first round's candidates),
    ``paa_isax`` on one appended chunk as Stage 2 calls it."""
    import torch

    from repro_torch.core import isax
    from repro_torch.core.search import _queries, make_batch_engine
    from repro_torch.kernels import ops

    n, w, card = shard.series_length, shard.segments, shard.cardinality
    dev = shard.device
    q_n = cohort_q.shape[0]

    # paa_isax: z-norm, then the kernel without its own z-norm.
    x = isax.znorm(chunk)
    bp = isax.gaussian_breakpoints(card, dev)
    got = ops.paa_isax(x, bp, w, normalize=False)
    plain = ops.paa_isax(x, bp, w, normalize=False, impl="ref")
    expect(all(torch.equal(g, e) for g, e in zip(got, plain)),
           "serve: paa_isax on an appended chunk differs from its plain "
           "version")
    chunk_sax = got[0]
    del x, got, plain

    # lower_bound_sq_batch: the engine's pass, as its round loop starts it.
    qs = isax.znorm(_queries(shard, cohort_q))
    qps = isax.paa(qs, w)
    bpp = isax.padded_breakpoints(card, dev)
    for sax, what in ((chunk_sax, "an appended chunk"),
                      (shard.sax, "a router shard")):
        lb = ops.lower_bound_sq_batch(qps, sax, bpp, n)
        expect(torch.equal(lb, ops.lower_bound_sq_batch(
            qps, sax, bpp, n, impl="ref")), f"serve: lower_bound_sq_batch "
            f"over {what} not bitwise equal to its plain version")
    del chunk_sax

    # euclid_sq: the shard engine's answers to the cohort, then the first
    # round's candidates, gathered from the shard's rows.
    d_e, p_e = make_batch_engine(shard, k=k, round_size=rs)(cohort_q)
    cand = shard.pos[first_round(lb, shard.num_series, rs)[:, :rs - k]]
    del lb
    pos = torch.cat([p_e.to(cand.dtype), cand], dim=1).contiguous()
    got = ops.euclid_sq_gather(qs, shard.raw, pos)
    expect(torch.equal(got[:, :k], d_e), "serve: euclid_sq differs from the "
           "shard engine's answers")
    plain = ops.euclid_sq_gather(qs, shard.raw, pos, impl="ref")
    expect(torch.allclose(got, plain, rtol=1e-5, atol=1e-5),
           "serve: euclid_sq differs from its plain version")
    log(f"[serve] paa_isax (appended chunk of {chunk.shape[0]}), "
        f"lower_bound_sq_batch ({q_n}-query cohort over a chunk and over a "
        f"shard of {shard.num_series} rows) bitwise equal to their plain "
        f"versions; euclid_sq ({q_n} x {pos.shape[1]} gather) bitwise equal "
        "to the shard engine's answers and within 1e-5 of its plain version")


def serve_faults(serving, host_q, same, healthy: dict) -> dict:
    """Step (c): each fault on a fresh router of the same shape."""
    from repro_torch.serving import (DeadlineExceededError, FaultInjector,
                                     InjectedFaultError, ShardFailedError)

    out = {}
    inj = FaultInjector()
    inj.fail_replica(0, 0)
    router = serving(fault_injector=inj)
    try:
        res, t = submit_all(router, host_q)
    finally:
        router.stop()
    same(res, "(c) failed replica")
    s = router.stats()
    expect(s["retries"] >= 1, "serve: the failed replica was never retried")
    out["failed_replica"] = dict(s=t, retries=s["retries"],
                                 fired=inj.fired()["replica:0:0:fail"])
    log(f"[serve] (c) fail_replica(0, 0): {t:.4f} s, {s['retries']} retries,"
        f" answers bitwise")

    # A hedge fires past the healthy router's slowest sub-query; the slow
    # replica's first cohort answers long after the hedge could have.
    hedge_ms = max(50.0, 1.5 * healthy["latency_ms_max"])
    slow_ms = 4.0 * hedge_ms + 1000.0
    inj = FaultInjector()
    inj.slow_replica(1, 0, ms=slow_ms, times=1)
    router = serving(fault_injector=inj, hedge_ms=hedge_ms, hedge_budget=1.0)
    try:
        res, t = submit_all(router, host_q)
    finally:
        router.stop()
    same(res, "(c) slow replica")
    s = router.stats()
    expect(s["hedges_won"] >= 1, "serve: no hedge beat the slow replica")
    out["slow_replica"] = dict(s=t, hedge_ms=hedge_ms, slow_ms=slow_ms,
                               hedges=s["hedges"], hedges_won=s["hedges_won"])
    log(f"[serve] (c) slow_replica(1, 0, ms={slow_ms:.1f}), hedge_ms "
        f"{hedge_ms:.1f}: {t:.4f} s, hedges {s['hedges']}, won "
        f"{s['hedges_won']}, answers bitwise")

    # A blackholed shard: every future fails at its deadline, none hangs.
    deadline_ms = max(1000.0, 2.0 * healthy["latency_ms_max"])
    inj = FaultInjector()
    inj.blackhole_replica(2)
    router = serving(fault_injector=inj)
    late = []
    try:
        futs = []
        for q in host_q[:8]:
            t0 = time.monotonic()
            f = router.submit(q, deadline_ms=deadline_ms)
            f.add_done_callback(
                lambda _, t0=t0: late.append(time.monotonic() - t0))
            futs.append(f)
        for f in futs:
            exc = f.exception(timeout=deadline_ms / 1e3 + SERVE_WAIT_S)
            expect(type(exc) is DeadlineExceededError, f"serve: a blackholed "
                   f"request ended with {exc!r}, not DeadlineExceededError")
    finally:
        router.stop()
    worst = max(late) - deadline_ms / 1e3
    expect(len(late) == 8 and worst <= DEADLINE_SLACK_S,
           f"serve: a deadline failed its future {worst:.3f} s late")
    out["blackholed_shard"] = dict(deadline_ms=deadline_ms, late_s_max=worst,
                                   expired=router.stats()["deadline_expired"])
    log(f"[serve] (c) blackhole_replica(2), deadline {deadline_ms:.1f} ms: "
        f"8 of 8 DeadlineExceededError, at most {worst:.4f} s after the "
        "deadline")

    # A failed shard: typed, named, caused by the injected fault.
    inj = FaultInjector()
    inj.fail_replica(3)
    router = serving(fault_injector=inj)
    try:
        futs = [router.submit(q) for q in host_q[:8]]
        for f in futs:
            try:
                f.result(timeout=SERVE_WAIT_S)
            except ShardFailedError as e:
                expect(e.sid == 3, f"serve: ShardFailedError names shard "
                       f"{e.sid}, not 3")
                expect(isinstance(e.__cause__, InjectedFaultError),
                       f"serve: a shard failed of {e.__cause__!r}, not the "
                       "injected fault")
                continue
            raise CheckFailed("serve: answered although shard 3 failed")
    finally:
        router.stop()
    out["failed_shard"] = dict(shard_failures=router.stats()[
        "shard_failures"])
    log("[serve] (c) fail_replica(3): 8 of 8 ShardFailedError(sid=3) caused "
        "by InjectedFaultError")
    return out


def serve_ingest(full: dict, host_q, same) -> tuple:
    """Step (d): a live-ingest router grown from half of phase 4's series
    to all of them by card-tensor appends, queried as it grows. Returns
    (its figures, the first appended chunk)."""
    import itertools
    import threading

    import numpy as np
    import torch

    from repro_torch.core import build_index
    from repro_torch.serving import IngestingRouter

    args, dev = full["args"], full["qz"].device
    n_series, n = full["index"].raw.shape
    k, rs = args.k, 4096
    want_d = full["d"].cpu().numpy()
    half = n_series // 2
    batch = min(APPEND_BATCH, n_series // 16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    chunks = walk_chunks(n_series, n, gen, dev)  # phase 4's series again
    base_raw = torch.empty((half, n), dtype=torch.float32, device=dev)
    tail = None
    for s, chunk in chunks:
        base_raw[s:min(s + chunk.shape[0], half)] = chunk[:half - s]
        if s + chunk.shape[0] >= half:
            tail = chunk[half - s:]
            break
    base, t_base = timed(lambda: build_index(base_raw, device=dev))
    del base_raw

    def appended():  # made one chunk at a time, as the appends take them
        for part in itertools.chain([tail], (c for _, c in chunks)):
            for s in range(0, part.shape[0], batch):
                yield part[s:s + batch]

    svc = IngestingRouter(base, SERVE_SHARDS, k=k, replicas=SERVE_REPLICAS,
                          max_batch=64, round_size=rs,
                          compaction_policy=None)
    del base
    svc.start()
    stop = threading.Event()
    streamed, errors = [], []

    def stream():
        i = 0
        try:
            while not stop.is_set():
                d, p = svc.submit(host_q[i]).result(timeout=SERVE_WAIT_S)
                streamed.append((i, d, p))
                i = (i + 1) % len(host_q)
        except Exception as e:  # noqa: BLE001 — surfaced as a failed check
            errors.append(e)

    first = None  # one appended chunk, for the kernel checks
    try:
        client = threading.Thread(target=stream)
        client.start()
        t0 = time.perf_counter()
        for part in appended():
            svc.append(part)  # a tensor on the card: no copy
            if first is None:
                first = part
        torch.cuda.synchronize()
        t_app = time.perf_counter() - t0
        stop.set()
        client.join(timeout=SERVE_WAIT_S)
        expect(not client.is_alive(), "serve: the streaming client hung")
        if errors:
            raise errors[0]
        # An answer over a prefix of the series is never better than the
        # whole set's, column by column (the same per-series distances).
        for i, d, p in streamed:
            expect(np.all(d >= want_d[i]) and np.all(p < n_series),
                   f"serve (d): streamed answer to query {i} is better than "
                   "the exact one over all the series")
        shards = svc.stats()["num_shards"]
        (d, p), t_q = timed(lambda: svc.search_batch(host_q))
        same(list(zip(d, p)), "(d) after the appends")
        res, t_fold = timed(lambda: svc.compact_now("full"))
        expect(res is not None and res.base.num_series == n_series,
               "serve (d): the full fold")
        (d, p), t_q2 = timed(lambda: svc.search_batch(host_q))
        same(list(zip(d, p)), "(d) after the full fold")
        s = svc.stats()
    finally:
        stop.set()
        svc.stop()
    out = dict(base_build_s=t_base, appends=s["ingest"]["appends"],
               append_s=t_app, series_per_s=(n_series - half) / t_app,
               streamed=len(streamed), shards_before_fold=shards,
               query_s=t_q, fold_s=t_fold, merge_s=res.merge_time,
               stall_s=res.stall_time, query_after_fold_s=t_q2,
               shards_after_fold=s["num_shards"])
    log(f"[serve] (d) base of {half} built in {t_base:.3f} s; "
        f"{out['appends']} card-tensor appends of {batch} in {t_app:.3f} s "
        f"({out['series_per_s']:.0f} series/s) while {len(streamed)} "
        f"streamed answers came back; {shards} shards: search_batch "
        f"{t_q:.4f} s, equal to phase 4's bit for bit; full fold "
        f"{t_fold:.3f} s (merge {res.merge_time:.3f} s, stall "
        f"{res.stall_time:.6f} s), {s['num_shards']} shards: search_batch "
        f"{t_q2:.4f} s, equal to phase 4's bit for bit")
    return out, first


MESH_WORLD = 4  # ranks of the mesh phase's gloo mesh, all on the one card
MESH_GROUP_TIMEOUT_S = 120  # a collective that waits this long fails
MESH_JOIN_TIMEOUT_S = 420  # a mesh that has not returned by then fails
MESH_SINGLE_QUERIES = 8  # queries of step (b)'s single-query searches
MESH_COLLECTIVE_CALLS = 200  # calls a collective is timed over


def run_mesh(world: int, backend: str, args: tuple) -> tuple:
    """Spawn ``world`` ranks over ``backend`` on the device of ``args``'s
    ``DistIndex`` and run ``run_plan``; returns (every rank's result, the
    parent's peak bytes while they ran, wall seconds)."""
    import torch

    from repro_torch.core import distributed as mesh_mod

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        ranks = mesh_mod.spawn_mesh(
            mesh_mod.run_plan, world, backend=backend,
            init_method=f"file://{store}/rendezvous",
            timeout=MESH_GROUP_TIMEOUT_S, join_timeout=MESH_JOIN_TIMEOUT_S,
            device=args[0].device, args=args)
    return ranks, torch.cuda.max_memory_allocated(), time.perf_counter() - t0


def mesh_same_on_every_rank(ranks, what: str) -> None:
    """Every rank returned the same answer for every search step."""
    import numpy as np

    for name, got in ranks[0].items():
        if not isinstance(got, dict) or "position" not in got:
            continue  # not a search step
        for other in ranks[1:]:
            for f in ("dist_sq", "position", "raw_reads", "bsf_updates",
                      "rounds"):
                expect(np.array_equal(other[name][f], got[f]),
                       f"mesh {what} {name}: ranks disagree on {f}")


def mesh_step_figures(ranks, name: str) -> dict:
    """Wall time (the slowest rank), rounds, reads a query, collectives."""
    r0 = ranks[0][name]
    reads = r0["raw_reads"].astype("float64")
    return dict(wall_s=max(r[name]["seconds"] for r in ranks),
                rounds=r0["rounds"].tolist(),
                reads_mean=float(reads.mean()), reads_max=int(reads.max()),
                collectives=int(r0["collectives"]))


def phase_mesh(full: dict) -> tuple:
    """The mesh (``repro_torch.core.distributed``) over phase 4's index and
    queries: (a) 4 gloo ranks on the card, each with a quarter of N by
    CUDA IPC, batch k-NN and 1-NN; (b) the single-query search in its four
    modes on 8 queries; (c) the distributed build over 2^22 series; (d) the
    batch k-NN again on one nccl rank. Returns (the path's launch counts,
    summed over the parent and every rank, and the ``{"mesh": ...}``
    figures)."""
    import numpy as np
    import torch

    from repro_torch.configs.paris import CONFIG
    from repro_torch.core import distributed as mesh_mod
    from repro_torch.core import isax
    from repro_torch.core.search import select_len
    from repro_torch.kernels import ops

    index, args, queries = full["index"], full["args"], full["queries"]
    k, rs, leaf = args.k, CONFIG.round_size, CONFIG.leaf_cap
    n_series, n_q = index.num_series, queries.shape[0]
    want_d, want_p = full["d"].cpu().numpy(), full["p"].cpu().numpy()
    expect(n_series % MESH_WORLD == 0, "mesh: N must split into 4 shards")
    n_local = n_series // MESH_WORLD
    fig = dict(world=MESH_WORLD, backend="gloo", n=n_series, shard=n_local,
               queries=n_q, k=k, round=rs, leaf=leaf)
    log(f"[mesh] N={n_series} over {MESH_WORLD} gloo ranks on one card "
        f"({n_local} rows a shard, by CUDA IPC); Q={n_q} k={k} round={rs} "
        f"leaf={leaf}")

    alloc0 = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dindex = mesh_mod.dist_index_from(index, MESH_WORLD)
    torch.cuda.synchronize()
    fig["layout_s"] = time.perf_counter() - t0
    # N = 2^24 pads no row at either world size, so world 1 shares it.
    expect(dindex.num_rows == n_series, "mesh: unexpected padding rows")
    build_rows = index.raw[:n_local]  # (c): the first 2^22 series
    kw = dict(round_size=rs, leaf_cap=leaf)
    one = dict(kw, queries=MESH_SINGLE_QUERIES)
    timing = ("collectives", "collectives",
              dict(calls=MESH_COLLECTIVE_CALLS, k=k, queries=n_q))
    plan = [("k", "batch", dict(kw, k=k)), ("k1", "batch", dict(kw, k=1)),
            ("sort", "search", one),
            ("topk", "search", dict(one, select="topk")),
            ("nb", "search", dict(one, shared_bsf=False)),
            ("bq", "search", dict(one, batch_queries=MESH_SINGLE_QUERIES)),
            ("build", "build", {}), timing]
    ranks, parent_peak, wall = run_mesh(
        MESH_WORLD, "gloo", (dindex, queries, plan, build_rows))
    mesh_same_on_every_rank(ranks, "gloo")
    fig["spawn_wall_s"] = wall
    peak4 = (parent_peak + sum(r["peak_bytes"] for r in ranks)) / 2**30
    fig["peak_gib"] = dict(parent=parent_peak / 2**30, ranks=[
        r["peak_bytes"] / 2**30 for r in ranks], summed=peak4)
    log(f"[mesh] {MESH_WORLD} ranks spawned, run and joined in {wall:.2f} s;"
        f" summed peak device memory {peak4:.2f} GiB (parent "
        f"{parent_peak / 2**30:.2f}, ranks "
        f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]})")
    expect(peak4 < MAX_PEAK_GIB, f"mesh summed peak {peak4:.2f} GiB")
    r0 = ranks[0]

    # (a) the batch forms against phase 4's single-index answers.
    for name, dd, pp in (("k", want_d, want_p),
                         ("k1", want_d[:, 0], want_p[:, 0])):
        got = r0[name]
        expect(np.array_equal(got["position"], pp), f"mesh (a) {name}: "
               "positions differ from phase 4's")
        rel = float(np.max(np.abs(got["dist_sq"] - dd) / np.maximum(
            np.abs(dd), 1e-30)))
        bitwise = bool(np.array_equal(got["dist_sq"], dd))
        expect(rel <= 1e-6, f"mesh (a) {name}: distances off by {rel:.3e}")
        fig[name] = dict(mesh_step_figures(ranks, name), bitwise=bitwise,
                         max_rel_err=rel)
        log(f"[mesh] (a) k={k if name == 'k' else 1}: positions equal phase "
            f"4's; distances {'bitwise' if bitwise else 'within'} (max rel "
            f"{rel:.3g}); {fig[name]}")
    sel = min(select_len(n_local, rs), max(
        rs, mesh_mod.SELECT_BUDGET_VALUES // (n_q * index.series_length)))
    fig["selected_rows"] = sel
    log(f"[mesh] selection budget: {sel} rows a query a shard, so "
        f"{-(-sel // rs)} main round(s) before the file-order fallback")

    # (b) the single-query search, every mode, on the first 8 queries.
    first = want_p[:MESH_SINGLE_QUERIES, 0]
    for name in ("sort", "topk", "nb", "bq"):
        got = r0[name]
        expect(np.array_equal(got["position"], first),
               f"mesh (b) {name}: positions differ from (a)'s 1-NN")
        expect(np.allclose(got["dist_sq"], want_d[:MESH_SINGLE_QUERIES, 0],
                           rtol=1e-6, atol=0),
               f"mesh (b) {name}: distances differ from phase 4's")
        fig[name] = mesh_step_figures(ranks, name)
        log(f"[mesh] (b) {name}: 8 positions equal (a)'s; {fig[name]}")

    # (c) the distributed build against the plain versions on the card.
    x = isax.znorm(build_rows)
    bp = isax.gaussian_breakpoints(index.cardinality, x.device)
    sax_p, _ = ops.paa_isax(x, bp, index.segments, normalize=False,
                            impl="ref")
    keys_p = isax.root_key(sax_p, index.cardinality)
    del x
    sax_m = np.concatenate([r["build"]["sax"] for r in ranks])
    keys_m = np.concatenate([r["build"]["keys"] for r in ranks])
    expect(np.array_equal(sax_m, sax_p.cpu().numpy())
           and np.array_equal(keys_m, keys_p.cpu().numpy()),
           "mesh (c): build SAX or root keys differ from the plain versions")
    del sax_p, keys_p
    fig["build"] = dict(wall_s=max(r["build"]["seconds"] for r in ranks),
                        series=n_local)
    col = [r["collectives"] for r in ranks]
    fig["collective_ms"] = dict(
        gmin=max(c["gmin_ms"] for c in col),
        all_gather=max(c["all_gather_ms"] for c in col))
    log(f"[mesh] (c) build of {n_local} series: SAX and root keys equal the "
        f"plain versions bit for bit, {fig['build']['wall_s']:.3f} s; one "
        f"collective (gloo, {MESH_WORLD} ranks on one card, Q={n_q}): "
        f"{fig['collective_ms']}")

    # (d) one nccl rank over the whole index: the selection now runs over
    # 2^24 rows, so rounds and reads differ; positions may not.
    plan1 = [("k", "batch", dict(kw, k=k)), timing]
    ranks1, parent_peak1, wall1 = run_mesh(1, "nccl",
                                           (dindex, queries, plan1))
    got = ranks1[0]["k"]
    expect(np.array_equal(got["position"], r0["k"]["position"]),
           "mesh (d): nccl world 1 positions differ from (a)'s")
    peak1 = (parent_peak1 + ranks1[0]["peak_bytes"]) / 2**30
    expect(peak1 < MAX_PEAK_GIB, f"mesh (d) summed peak {peak1:.2f} GiB")
    fig["nccl_world1"] = dict(
        mesh_step_figures(ranks1, "k"), spawn_wall_s=wall1, peak_gib=peak1,
        collective_ms=dict(gmin=ranks1[0]["collectives"]["gmin_ms"],
                           all_gather=ranks1[0]["collectives"][
                               "all_gather_ms"]))
    log(f"[mesh] (d) nccl world 1: positions equal (a)'s; "
        f"{fig['nccl_world1']}")

    counts = ops.launch_counts()  # the parent launched nothing on the path
    for r in ranks + ranks1:
        for name, c in r["launches"].items():
            counts[name] += c
    counts = path_counts("mesh", counts)
    fig["launches"] = counts
    mesh_kernel_checks(dindex, queries, rs)
    # The ranks dropped what they received by IPC, so the layout frees.
    del dindex, build_rows
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_allocated() - alloc0) / 2**30
    log(f"[mesh] {held:.3f} GiB still allocated after the phase")
    expect(held < 1.0, f"mesh: {held:.2f} GiB not freed after the phase")
    return counts, fig


def mesh_kernel_checks(dindex, queries, rs: int) -> None:
    """The mesh path's kernels against their plain versions at its shapes
    (after its counts): ``lower_bound_sq_batch`` and ``lower_bound_sq``
    over one 2^22-row shard, ``euclid_sq`` on shared (4096,) rows as the
    fallback scans them, ``paa_isax`` on 2^22 series."""
    import torch

    from repro_torch.core import distributed as mesh_mod
    from repro_torch.core import isax
    from repro_torch.kernels import ops

    shard = mesh_mod.shard_of(dindex, MESH_WORLD - 1, MESH_WORLD)
    n, w = shard.series_length, shard.segments
    dev = shard.device
    qs = isax.znorm(queries)
    qps = isax.paa(qs, w)
    bpp = isax.padded_breakpoints(shard.cardinality, dev)
    times = {}

    lb = ops.lower_bound_sq_batch(qps, shard.sax, bpp, n)
    expect(torch.equal(lb, ops.lower_bound_sq_batch(qps, shard.sax, bpp, n,
                                                    impl="ref")),
           "mesh: lower_bound_sq_batch over a shard not bitwise equal to "
           "its plain version")
    del lb
    times["lower_bound_sq_batch"] = time_ms(
        lambda: ops.lower_bound_sq_batch(qps, shard.sax, bpp, n), 10)
    qp1 = qps[0].contiguous()
    expect(torch.equal(ops.lower_bound_sq(qp1, shard.sax, bpp, n),
                       ops.lower_bound_sq(qp1, shard.sax, bpp, n,
                                          impl="ref")),
           "mesh: lower_bound_sq over a shard not bitwise equal to plain")
    times["lower_bound_sq"] = time_ms(
        lambda: ops.lower_bound_sq(qp1, shard.sax, bpp, n), 50)
    # The fallback's last round: (4096,) rows shared by every query.
    last = -(-shard.num_rows // rs) - 1
    rows = mesh_mod._wrap_rows(last, rs, shard.num_rows, dev).to(torch.int32)
    got = ops.euclid_sq_gather(qs, shard.raw_sorted, rows)
    plain = ops.euclid_sq_gather(qs, shard.raw_sorted, rows, impl="ref")
    expect(torch.allclose(got, plain, rtol=1e-5, atol=1e-5),
           "mesh: euclid_sq on shared rows differs from its plain version")
    times["euclid_sq"] = time_ms(
        lambda: ops.euclid_sq_gather(qs, shard.raw_sorted, rows), 50)
    x = isax.znorm(shard.raw_sorted)
    bp = isax.gaussian_breakpoints(shard.cardinality, dev)
    got = ops.paa_isax(x, bp, w, normalize=False)
    plain = ops.paa_isax(x, bp, w, normalize=False, impl="ref")
    expect(all(torch.equal(g, e) for g, e in zip(got, plain)),
           "mesh: paa_isax on 2^22 series not bitwise equal to plain")
    del got, plain
    times["paa_isax"] = time_ms(
        lambda: ops.paa_isax(x, bp, w, normalize=False), 10)
    del x
    log(f"[mesh] kernels at the mesh's shapes against their plain versions: "
        f"lower_bound_sq_batch ({qps.shape[0]}, {shard.num_rows}) and "
        f"lower_bound_sq ({shard.num_rows},) bitwise, euclid_sq ({qs.shape[0]}"
        f" x {rs} shared rows) within 1e-5, paa_isax ({shard.num_rows} series)"
        f" bitwise; ms {times}")


def component_sizes(n_series: int) -> list:
    """Five contiguous components: a base of ~N/2, runs of ~N/4 and ~N/8,
    and two deltas of the rest; no size a multiple of the 128-row block."""
    from repro_torch.core.search import DEFAULT_PACK_BLOCK as block

    sizes = [n_series // 2 - 3, n_series // 4 - 5, n_series // 8 - 7]
    rest = n_series - sum(sizes)
    sizes += [rest // 2 - 11, rest - (rest // 2 - 11)]
    for i in range(len(sizes) - 1):
        if sizes[i] % block == 0:  # move one series to the next component
            sizes[i] -= 1
            sizes[i + 1] += 1
    expect(sum(sizes) == n_series and all(s % block for s in sizes),
           f"component sizes {sizes}")
    return sizes


def phase_packed(full: dict) -> tuple:
    """The packed store's search paths, held to phase 4's index; returns
    (the path's launch counts, the packed kernel's row)."""
    import numpy as np
    import torch

    from repro_torch.core import Tier, build_index, isax
    from repro_torch.core.search import (exact_knn_batch_packed,
                                         knn_batch_packed_tiered,
                                         pack_components, packed_seed)
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import kernel_cost

    args, queries, qz = full["args"], full["queries"], full["qz"]
    d1, p1 = full["d"], full["p"]
    dev = qz.device
    n_series, n, k, rs = full["index"].num_series, qz.shape[1], args.k, 4096
    del full["index"]  # phase 4's index: its answers are kept
    # The serve phase's futures keep exception tracebacks whose frames hold
    # its shard engines (views of phase 4's raw) in reference cycles: they
    # and the index free only when the cycles are collected.
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[packed] {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated "
        "after phase 4's index was freed")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    raw = random_walks(n_series, n, gen, dev)  # the same series again
    torch.cuda.synchronize()
    sizes = component_sizes(n_series)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    log(f"[packed] N={n_series} in components {sizes}")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    comps = [(build_index(raw[a:b], device=dev), a)
             for a, b in zip(offsets[:-1], offsets[1:])]
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    del raw  # each component holds its z-normed rows
    t0 = time.perf_counter()
    packed = pack_components(comps)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, p, reads, updates, rounds = exact_knn_batch_packed(
        packed, queries, k=k, round_size=rs, stats=True)
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    t0 = time.perf_counter()
    seed = packed_seed(comps, queries)
    d_eps, p_eps, ach = knn_batch_packed_tiered(
        packed, queries, Tier.epsilon(0.1), k=k, round_size=rs, seed=seed)
    torch.cuda.synchronize()
    t_eps = time.perf_counter() - t0
    counts = path_counts("packed")
    peak = torch.cuda.max_memory_allocated() / 2**30

    log(f"[packed] 5 builds {t_build:.3f} s; pack_components {t_pack:.3f} s "
        f"(N_pad={packed.sax.shape[0]}); exact_knn_batch_packed "
        f"{t_exact:.3f} s ({rounds} rounds, reads/query mean "
        f"{reads.double().mean().item():.1f} max {reads.max().item()}, "
        f"{100 * reads.double().mean().item() / n_series:.3f}% of N); "
        f"packed_seed + epsilon 0.1 {t_eps:.3f} s")
    log(f"[packed] peak device memory {peak:.2f} GiB (limit "
        f"{MAX_PEAK_GIB:.0f})")
    expect(peak < MAX_PEAK_GIB, f"packed peak memory {peak:.2f} GiB")
    expect(torch.equal(p, p1), "packed exact positions differ from the "
           "single index's")
    expect(torch.equal(d, d1), "packed exact distances not bitwise equal "
           "to the single index's")
    expect(np.all(ach <= 0.1 + 1e-6), "packed: epsilon achieved > 0.1")
    expect(torch.all(d_eps.sqrt() <= 1.1 * d.sqrt() * (1 + 1e-5)),
           "packed: epsilon answer worse than 1.1 x exact")
    direct = ((packed.raw[p_eps.long()] - qz[:, None, :]) ** 2).sum(dim=-1)
    expect(torch.allclose(direct, d_eps, rtol=1e-5, atol=1e-5),
           "packed epsilon: a position is not at its reported distance")
    log(f"[packed] exact answers equal phase 4's bit for bit; epsilon "
        f"achieved max {ach.max():.4f}")

    # The packed lower-bound kernel's row, on the buffer the path swept.
    bpp = isax.padded_breakpoints(packed.cardinality, dev)
    qps = isax.paa(qz, packed.segments)
    w, n_pad, n_q = packed.segments, packed.sax.shape[0], qz.shape[0]

    def multi(impl="auto"):
        return ops.lower_bound_sq_multi(qps, packed.sax, bpp, n,
                                        packed.block_len, impl=impl,
                                        block_n=packed.block)

    lb_k, lb_p = multi(), multi("ref")
    fin = torch.isfinite(lb_p)
    err = (lb_k[fin] - lb_p[fin]).abs().max().item()
    expect(torch.equal(lb_k, lb_p), "lower_bound_sq_multi not bitwise equal "
           "to plain")
    del lb_k, lb_p, fin
    row = kernel_row(
        "lower_bound_sq_multi", err, time_ms(multi, 10),
        time_ms(lambda: multi("ref"), 2),
        kernel_cost("lower_bound_sq_multi", q=n_q, n_pad=n_pad, w=w,
                    n_bp=bpp.numel(), blocks=packed.block_len.numel(),
                    real_rows=n_series),
        {**launch_shape("lower_bound_sq_multi", n_q, n_pad, dev),
         "block_n": packed.block})
    return counts, row


def fs_of(path: str) -> str:
    """Filesystem type of the mount holding ``path`` (from /proc/mounts)."""
    real, best, fstype = os.path.realpath(path), "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                mnt = parts[1]
                inside = real == mnt or real.startswith(
                    mnt.rstrip("/") + "/")
                if inside and len(mnt) >= len(best):
                    best, fstype = mnt, parts[2]
    except OSError:
        pass
    return f"{fstype} on {best or '?'}"


def dir_bytes(path: str) -> int:
    """Bytes of the files under ``path``."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def drop_cache(path: str) -> None:
    """Ask the kernel to drop ``path``'s pages, so the next read is a disk
    read (the pages are clean: the file was fsync'd)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def written() -> dict:
    """This process's write counters from ``/proc/self/io``: ``wchar``
    (bytes passed to write calls) and ``write_bytes`` (bytes sent to the
    storage layer; 0 where the filesystem bypasses it)."""
    with open("/proc/self/io") as f:
        io = dict(line.split(": ") for line in f.read().splitlines())
    return {k: int(io[k]) for k in ("wchar", "write_bytes")}


def io_delta(before: dict) -> str:
    """Bytes this process wrote since ``before = written()``."""
    now = written()
    return (f"{now['wchar'] - before['wchar']} bytes (wchar; write_bytes "
            f"{now['write_bytes'] - before['write_bytes']})")


def timed(fn):
    """(result, seconds) of ``fn()`` with the card synchronised after it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_disk(full: dict) -> dict:
    """The disk path: file -> pipelined build, live durable store, recover,
    cold tier. Returns the launch counts of the phase."""
    import torch

    from repro_torch.kernels import ops

    args, qz = full["args"], full["qz"]
    dev = qz.device
    n, k, rs = qz.shape[1], args.k, 4096
    n_series = 1 << args.disk_log2_n
    same_n = n_series == full["host"]["pos"].shape[0]
    raw_bytes = n_series * n * 4
    # The file, then (once it is gone) the store: a fold or a demotion
    # writes its new component beside the one it replaces.
    need = max(raw_bytes + raw_bytes // 8, 2 * raw_bytes) + (1 << 30)
    os.makedirs(args.disk_dir, exist_ok=True)
    root = tempfile.mkdtemp(prefix="paris_disk_", dir=args.disk_dir)
    st = os.statvfs(root)
    free = st.f_bavail * st.f_frsize
    log(f"[disk] N={n_series} n={n} in {root}: filesystem {fs_of(root)}, "
        f"{free} bytes free, {need} needed")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    w0 = written()
    try:
        expect(free >= need, f"disk: {free / 2**30:.1f} GiB free under "
               f"{args.disk_dir}, the phase needs {need / 2**30:.1f} GiB "
               f"at N = 2^{args.disk_log2_n}; pass --disk-dir or a smaller "
               "--disk-log2-n")
        counts = _disk_steps(full, root, n_series, same_n, dev, n, k, rs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[disk] the phase wrote {io_delta(w0)}, "
        f"{(written()['wchar'] - w0['wchar']) / raw_bytes:.3f} times its "
        f"{raw_bytes} raw bytes")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[disk] peak device memory {peak:.2f} GiB (limit "
        f"{MAX_PEAK_GIB:.0f})")
    expect(peak < MAX_PEAK_GIB, f"disk peak memory {peak:.2f} GiB")
    return counts


def _disk_steps(full, root, n_series, same_n, dev, n, k, rs) -> dict:
    """Steps (a)-(e) of the disk phase; returns the path's launch counts.

    The counts are set to 0 after the data file and the reference answers
    are made, and read before the kernels are held against their plain
    versions at this path's shapes.
    """
    import numpy as np
    import torch

    from repro_torch.core import (CompactionPolicy, IngestPipeline,
                                  MutableIndex, PipelineBuilder,
                                  SeriesSource, build_index, coldtier, isax)
    from repro_torch.core.search import exact_knn_batch
    from repro_torch.kernels import ops
    from repro_torch.serving import IngestingRouter

    args, queries, qz = full["args"], full["queries"], full["qz"]

    # (a) The data file: phase 4's series made again on the card, kept on
    # the host for the live store's appends.
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    series = np.empty((n_series, n), np.float32)
    path = os.path.join(root, "series.f32")

    def write():
        with open(path, "wb") as f:
            for s, chunk in walk_chunks(n_series, n, gen, dev):
                host = chunk.cpu().numpy()
                series[s:s + host.shape[0]] = host
                host.tofile(f)
            f.flush()
            os.fsync(f.fileno())
        drop_cache(path)

    w0 = written()
    _, t_write = timed(write)
    log(f"[disk] (a) wrote {os.path.getsize(path)} bytes in {t_write:.3f} s "
        f"({os.path.getsize(path) / t_write / 1e9:.3f} GB/s, fsync'd); "
        f"{io_delta(w0)}")

    # What every answer is held to: phase 4's, or at another N an on-card
    # oracle over this phase's series.
    if same_n:
        want_d, want_p = full["d"], full["p"]
        host = full["host"]
    else:
        ref_index = build_index(series, device=dev)
        want_d, want_p = exact_knn_batch(ref_index, queries, k=k,
                                         round_size=rs, leaf_cap=256)
        od, _ = oracle_knn(ref_index.raw, qz, k)
        check_against_oracle(ref_index.raw, qz, want_d, want_p, od,
                             "disk oracle")
        host = dict(sax=ref_index.sax.cpu(), pos=ref_index.pos.cpu(),
                    offsets=ref_index.bucket_offsets.cpu())
        del ref_index, od
        torch.cuda.empty_cache()

    held_to = "phase 4's" if same_n else "the on-card oracle's"
    chunk_series = min(DISK_CHUNK, n_series // 16)
    chunk0 = series[:chunk_series].copy()  # Stage 2's first chunk
    ops.reset_launch_counts()  # the disk path starts here

    def same_answers(d, p, what):
        expect(torch.equal(p, want_p), f"disk {what}: positions differ")
        expect(torch.equal(d, want_d),
               f"disk {what}: distances not bitwise equal")

    # (b) The pipeline from the file, in both modes.
    src = SeriesSource.from_file(path, n, chunk_series=chunk_series)
    w0 = written()
    expect(src.num_series == n_series, "disk: file holds the wrong count")
    for mode in ("paris+", "paris"):
        drop_cache(path)
        workdir = os.path.join(root, f"build-{mode}")
        builder = PipelineBuilder(
            mode=mode, mem_limit_series=n_series // DISK_EPOCHS,
            workdir=workdir, device=dev)
        (index, bs), t = timed(lambda: builder.build(src))
        expect(bs.epochs == DISK_EPOCHS, f"disk {mode}: {bs.epochs} epochs")
        expect(torch.equal(index.sax.cpu(), host["sax"])
               and torch.equal(index.pos.cpu(), host["pos"])
               and torch.equal(index.bucket_offsets.cpu(), host["offsets"]),
               f"disk {mode}: the pipeline's index differs from phase 4's")
        (d, p), t_q = timed(lambda: exact_knn_batch(
            index, queries, k=k, round_size=rs, leaf_cap=256))
        same_answers(d, p, f"pipeline {mode}")
        log(f"[disk] (b) PipelineBuilder({mode!r}) {t:.3f} s, "
            f"{n_series / t:.0f} series/s: read {bs.read_time:.3f} s, "
            f"convert {bs.convert_time:.3f} s, construct "
            f"{bs.construct_time:.3f} s, flush {bs.flush_time:.3f} s, "
            f"finalize {bs.finalize_time:.3f} s, total {bs.total_time:.3f} s,"
            f" {bs.epochs} epochs of {bs.chunks} chunks, overlap_efficiency "
            f"{bs.overlap_efficiency:.4f}; shards {dir_bytes(workdir)} bytes;"
            f" exact_knn_batch {t_q:.3f} s, answers equal {held_to}")
        shutil.rmtree(workdir)
        del index, d, p
        torch.cuda.empty_cache()
    os.remove(path)
    log(f"[disk] (b) the pipelines wrote {io_delta(w0)}")

    # (c) The live durable store: base of N/2, appends of 2^20.
    store = os.path.join(root, "store")
    w0 = written()
    half = n_series // 2
    (m, t_base) = timed(lambda: MutableIndex(
        build_index(series[:half], device=dev), workdir=store, device=dev))
    log(f"[disk] (c) base of {half} series built and spilled in "
        f"{t_base:.3f} s")
    pipe = IngestPipeline(m)
    policy = CompactionPolicy(max_deltas=4, major_ratio=1.0)
    folds = []
    batch = min(APPEND_BATCH, n_series // 16)  # 8 appends at least
    offsets = list(range(half, n_series, batch))

    def ingest():
        for i, s in enumerate(offsets):
            pipe.append(series[s:s + batch])
            if i < len(offsets) - 1:
                res = m.maybe_compact(policy)
                if res is not None:
                    folds.append((res.tier, res.merge_time, res.stall_time))

    s0 = m.stats()
    _, t_ingest = timed(ingest)
    s1 = m.stats()
    comps = len(m.snapshot().components())
    (d, p, reads, _, rounds), t_q = timed(lambda: m.exact_knn_batch(
        queries, k=k, round_size=rs, leaf_cap=256, stats=True))
    same_answers(d, p, "live store after the appends (fused)")
    live = m._packed_view(m.snapshot())  # what the fused search swept
    multi_in = (live.sax.clone(), live.block_len.clone(), live.block)
    multi_rows = live.sax.shape[0]
    del live
    log(f"[disk] (c) {len(offsets)} appends in {t_ingest:.3f} s "
        f"({pipe.stats.series_per_sec:.0f} series/s of append time, "
        f"{pipe.stats.series / t_ingest:.0f} with the folds), of which "
        f"spills {s1['spill_time'] - s0['spill_time']:.3f} s in "
        f"{s1['spills'] - s0['spills']} (appends and runs), group commits "
        f"{s1['group_commits'] - s0['group_commits']}; folds (tier, merge "
        f"with spill s, stall s) {folds}; fused exact_knn_batch over {comps} "
        f"components "
        f"{t_q:.3f} s ({rounds} rounds, reads/query mean "
        f"{reads.double().mean().item():.1f})")
    res = m.maybe_compact(policy)
    expect(res is not None and res.tier == "minor", "disk: last minor fold")
    res, t_major = timed(lambda: m.compact("major"))
    expect(res.base.num_series == n_series, "disk: the major fold's base")
    (d, p), t_q = timed(lambda: m.exact_knn_batch(
        queries, k=k, round_size=rs, leaf_cap=256))
    same_answers(d, p, "live store after the major fold")
    s_ = m.stats()
    log(f"[disk] (c) major fold {t_major:.3f} s (merge {res.merge_time:.3f}"
        f" s, stall {res.stall_time:.6f} s); query {t_q:.3f} s; spills "
        f"{s_['spills']} ({s_['spill_time']:.3f} s), group commits "
        f"{s_['group_commits']}, compactions {s_['compactions']}, merge "
        f"{s_['merge_time']:.3f} s, stall max {s_['stall_time_max']:.6f} s, "
        f"pack builds {s_['pack_builds']} ({s_['pack_time']:.3f} s); "
        f"{dir_bytes(store)} bytes on disk; the store wrote "
        f"{io_delta(w0)}")
    del m, pipe, res, series
    torch.cuda.empty_cache()

    # (d) Recovery from the directory alone.
    r, t_rec = timed(lambda: MutableIndex.recover(store, device=dev))
    (d, p), t_q = timed(lambda: r.exact_knn_batch(
        queries, k=k, round_size=rs, leaf_cap=256))
    same_answers(d, p, "recovered store")
    log(f"[disk] (d) recover {t_rec:.3f} s ({r.num_series} series); query "
        f"{t_q:.3f} s; answers equal {held_to}")

    # (e) The cold tier.
    w0 = written()
    res, t_dem = timed(r.demote)
    expect(res is not None and res.cold is not None, "disk: demotion")
    log(f"[disk] (e) demote wrote {io_delta(w0)}")
    shard = r.snapshot().cold[0]
    torch.cuda.empty_cache()
    cache = r.stats()["cold_cache"]
    (d, p), t_q = timed(lambda: r.exact_knn_batch(
        queries, k=k, round_size=rs, leaf_cap=256))
    same_answers(d, p, "cold tier")
    after = r.stats()["cold_cache"]
    raw_leaf = shard.reader.total_bytes
    read = after["bytes_read"] - cache["bytes_read"]
    n_q = queries.shape[0]
    log(f"[disk] (e) demote {t_dem:.3f} s; cold exact_knn_batch {t_q:.3f} s,"
        f" of which host row gathers "
        f"{after['gather_time'] - cache['gather_time']:.3f} s in "
        f"{after['gathers'] - cache['gathers']} calls (block reads "
        f"{after['read_time'] - cache['read_time']:.3f} s);"
        f" raw bytes read {read} = "
        f"{read / n_q} a query, {100 * read / n_q / raw_leaf:.4f}% of "
        f"raw_leaf.npy ({raw_leaf} bytes) a query, {100 * read / raw_leaf:.3f}"
        f"% for the batch; block cache hits {after['hits'] - cache['hits']},"
        f" misses {after['misses'] - cache['misses']}; {dir_bytes(store)} "
        f"bytes on disk")
    # The demoted store behind the router: its cold shard gets a
    # disk-backed engine of its own, over the block cache the cold query
    # warmed.
    w0 = written()
    svc = IngestingRouter(r, k=k, round_size=rs, compaction_policy=None)
    try:
        (dr, pr), t_r = timed(lambda: svc.search_batch(queries))
    finally:
        svc.stop()
    expect(np.array_equal(pr, p.cpu().numpy())
           and np.array_equal(dr, d.cpu().numpy()),
           "disk: the cold shard through the router differs from the cold "
           "query")
    counts = path_counts("disk")  # the disk path ends here
    log(f"[disk] (e) the cold shard through IngestingRouter: search_batch "
        f"{t_r:.3f} s, equal to the cold query bit for bit; wrote "
        f"{io_delta(w0)}")

    # Each kernel of the path against its plain version at the path's
    # shapes (after the counts were read: these launches do not count).
    # paa_isax on Stage 2's first chunk, as the pipeline calls it.
    w, card = shard.segments, shard.cardinality
    x = isax.znorm(torch.from_numpy(chunk0).to(dev))
    bp = isax.gaussian_breakpoints(card, dev)
    got = ops.paa_isax(x, bp, w, normalize=False)
    plain = ops.paa_isax(x, bp, w, normalize=False, impl="ref")
    expect(all(torch.equal(g, e) for g, e in zip(got, plain)),
           "disk: paa_isax on a Stage-2 chunk differs from its plain version")
    del x, got, plain
    # lower_bound_sq_multi over the live store's packed view.
    qps = isax.paa(qz, w)
    bpp = isax.padded_breakpoints(card, dev)
    sax_live, block_len, block = multi_in
    got = ops.lower_bound_sq_multi(qps, sax_live, bpp, n, block_len,
                                   block_n=block)
    plain = ops.lower_bound_sq_multi(qps, sax_live, bpp, n, block_len,
                                     block_n=block, impl="ref")
    expect(torch.equal(got, plain), "disk: lower_bound_sq_multi over the "
           "live store not bitwise equal to its plain version")
    del got, plain, multi_in, sax_live, block_len
    # lower_bound_sq_batch over the cold shard's SAX.
    got = ops.lower_bound_sq_batch(qps, shard.sax, bpp, n)
    plain = ops.lower_bound_sq_batch(qps, shard.sax, bpp, n, impl="ref")
    expect(torch.equal(got, plain), "disk: lower_bound_sq_batch over the "
           "cold shard not bitwise equal to its plain version")
    del got, plain
    # euclid_sq over the cold view's staged rows: the answers' rows give
    # the in-memory distances, through the kernel and the plain version.
    view = coldtier._cold_view(shard, leaf_cap=256)
    local = want_p.to(torch.int32)
    every = torch.ones(local.shape, dtype=torch.bool, device=dev)
    got = view.distances(qz, local, "auto", every)
    expect(torch.equal(got, want_d), "disk: cold staged distances differ "
           f"from {held_to}")
    plain = view.distances(qz, local, "ref", every)
    expect(torch.allclose(got, plain, rtol=1e-5, atol=1e-5),
           "disk: cold staged distances differ from the plain version")
    log(f"[disk] every index and answer equals {held_to} bit for bit; "
        f"paa_isax (chunk of {chunk_series}), lower_bound_sq_multi (live "
        f"store, {qps.shape[0]} x {multi_rows} rows), lower_bound_sq_batch "
        f"(cold shard, {shard.num_series} rows) bitwise equal to their plain "
        f"versions, euclid_sq (cold staged rows) within 1e-5")
    return counts


LM_ARCH = "granite-34b"
LM_LAYERS = 8  # of granite-34b's 88: one card holds 4.84 B bf16 parameters
LM_CORPUS = (256, 4096)  # bigram sequences x positions: 2^20 pairs, n = 256
LM_CHUNK = 4  # corpus sequences an apply
LM_SHARDS = 2  # base shards of the kNN-LM router
LM_BATCH, LM_STEPS, LM_PROMPT = 16, 16, 16  # sequences, decode steps, prompt
# (16 steps, not the example's 64: the shard phase needs the time)
LM_K, LM_LAM, LM_ROUND = 8, 0.3, 512  # the example's k, lam and round size
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_MAX_NEW = 8, 256, 32, 32
LM_TOL = 1e-3  # (d): logits within 1e-3 of the largest absolute logit


def lm_close(got, want, what: str) -> float:
    """Logits within ``LM_TOL`` of the largest absolute one; the max error
    over that scale."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    expect(bool(got.isfinite().all()) and err <= LM_TOL * scale,
           f"lm (d) {what}: max abs error {err:.3g} > {LM_TOL} x {scale:.3g}")
    return err / scale


def phase_lm(args, dev) -> tuple:
    """The LM serving path at granite-34b's full width, 8 layers, bf16:
    (a) the kNN-LM datastore, (b) kNN-LM serving over an IngestingRouter,
    every retrieval held to an on-card oracle, (c) the SlotBatcher; then
    (d) the float32 checks and (e) the path's kernels against their plain
    versions. Returns (the path's launch counts, the ``{"lm": ...}``
    figures)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import build_index, isax
    from repro_torch.examples import retrieval_serve as rs
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    from repro_torch.models import Model
    from repro_torch.serving import IngestingRouter
    from repro_torch.serving.batcher import Request, SlotBatcher
    from repro_torch.training import data as data_mod

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(configs.get_config(LM_ARCH),
                              num_layers=LM_LAYERS)
    (model, t_init) = timed(lambda: Model(
        cfg, device=dev, generator=torch.Generator(dev).manual_seed(
            args.seed)))
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[lm] {LM_ARCH} at full width, {LM_LAYERS} of "
        f"{configs.get_config(LM_ARCH).num_layers} layers, {cfg.dtype}: "
        f"{n_params / 1e9:.3f} B parameters, {w_bytes / 2**30:.2f} GiB, "
        f"made on the card in {t_init:.2f} s")
    fig = dict(arch=LM_ARCH, layers=LM_LAYERS, params=n_params,
               param_gib=w_bytes / 2**30, dtype=cfg.dtype)

    ops.reset_launch_counts()  # the LM path starts here
    # (a) The datastore: the corpus through Model.apply, its first 256
    # logits a position kept, then build_index over the 2^20 series.
    rows, seq = LM_CORPUS
    corpus = data_mod.bigram_batch(0, rows, seq, cfg.vocab_size,
                                   seed=args.seed)
    (vecs, values), t_ds = timed(lambda: rs.datastore(
        model, corpus["tokens"], corpus["labels"], chunk=LM_CHUNK))
    n_tok = rows * seq
    ds_bound = 2 * n_params * n_tok / roofline.BF16_OPS_PER_S
    expect(torch.isfinite(vecs).all(), "lm (a): non-finite datastore logits")
    index, t_build = timed(lambda: build_index(vecs, segments=16,
                                               device=dev))
    log(f"[lm] (a) datastore: {rows} x {seq} tokens through Model.apply in "
        f"chunks of {LM_CHUNK} (flash attention above "
        f"{cfg.attn_dense_threshold}): {t_ds:.3f} s, {n_tok / t_ds:.0f} "
        f"tokens/s; FLOP bound 2 x {n_params:.4g} x {n_tok} = "
        f"{2 * n_params * n_tok:.4g} at 989 TFLOP/s dense bf16 (H100 SXM "
        f"data sheet): {ds_bound:.3f} s; build_index over {index.num_series} "
        f"series: {t_build:.3f} s")
    fig["datastore"] = dict(tokens=n_tok, s=t_ds, tokens_per_s=n_tok / t_ds,
                            flop_bound_s=ds_bound, build_index_s=t_build)

    # (b) kNN-LM serving, every retrieval held to an on-card oracle over
    # the datastore as it stands at that step.
    store = torch.empty((index.num_series + LM_BATCH * LM_STEPS,
                         index.series_length), device=dev)
    store[:index.num_series] = index.raw  # z-normed, file order
    live = [index.num_series]
    checked = dict(max_rel=0.0)
    kept = {}  # one step's states and delta, for (e)

    svc = IngestingRouter(
        index, LM_SHARDS, k=LM_K, max_batch=LM_BATCH, max_wait_ms=50.0,
        round_size=LM_ROUND, max_pending=4 * LM_BATCH, policy="shed-oldest",
        compaction_policy=None)

    def observe(step, states, dists, pos):
        n = live[0]
        qz = isax.znorm(states)
        od, op = oracle_knn(store[:n], qz, LM_K, chunk=1 << 16)
        expect(np.array_equal(pos, op.cpu().numpy()),
               f"lm (b) step {step}: positions differ from the oracle's")
        od = od.cpu().numpy()
        rel = np.abs(dists - od) / np.maximum(od, 1e-30)
        expect(np.all(rel <= 1e-4), f"lm (b) step {step}: distances "
               f"{rel.max():.3g} from the oracle's (relative)")
        checked["max_rel"] = max(checked["max_rel"], float(rel.max()))
        store[n:n + states.shape[0]] = qz
        live[0] = n + states.shape[0]
        snap = svc.mutable.snapshot()
        if "delta" not in kept and snap.deltas:
            kept.update(states=states.clone(), delta=snap.deltas[0].index)

    times = {}
    prompts = torch.from_numpy(
        corpus["tokens"][:LM_BATCH, :LM_PROMPT].astype(np.int64)).to(dev)
    try:
        (outs, values, compactions), t_gen = timed(lambda: rs.generate(
            model, svc, values, prompts, steps=LM_STEPS, lam=LM_LAM,
            observe=observe, times=times))
        s = svc.stats()
        base = svc.mutable.snapshot().base
    finally:
        svc.stop()
    expect(outs.shape == (LM_BATCH, LM_PROMPT + LM_STEPS)
           and np.all((outs >= 0) & (outs < cfg.vocab_size)),
           "lm (b): generated tokens out of range")
    expect(live[0] == svc.num_series == index.num_series + LM_BATCH
           * LM_STEPS, "lm (b): the datastore did not grow by every step")

    def ms(name):
        v = times.get(name, [])
        return 1e3 * sum(v) / max(len(v), 1)

    router = {key: s[key] for key in (
        "answered", "batches", "batch_size_avg", "latency_ms_avg",
        "latency_ms_max", "merge_ms_avg", "queue_depth_peak", "shed",
        "retired_shards", "num_shards")}
    fig["serve"] = dict(
        sequences=LM_BATCH, steps=LM_STEPS, k=LM_K, round_size=LM_ROUND,
        wall_s=t_gen, prefill_ms=ms("prefill"), decode_ms=ms("decode"),
        decode_bound_ms=w_bytes / roofline.HBM_BYTES_PER_S * 1e3,
        retrieve_ms=ms("retrieve"), mix_ms=ms("mix"), append_ms=ms("append"),
        compaction_ms=ms("compact"), compactions=compactions,
        oracle_max_rel=checked["max_rel"], router=router)
    f = fig["serve"]
    log(f"[lm] (b) kNN-LM: {LM_BATCH} sequences x {LM_STEPS} steps, k "
        f"{LM_K}, lam {LM_LAM}, round {LM_ROUND}, {LM_SHARDS} base shards: "
        f"{t_gen:.3f} s; prefill ({LM_BATCH} x {LM_PROMPT}) "
        f"{f['prefill_ms']:.3f} ms; decode {f['decode_ms']:.3f} ms a step "
        f"(byte bound {w_bytes / 2**30:.2f} GiB of weights at 3.35 TB/s, "
        f"H100 SXM data sheet: {f['decode_bound_ms']:.3f} ms); retrieval "
        f"{f['retrieve_ms']:.3f} ms a step; mix {f['mix_ms']:.3f} ms; append "
        f"{f['append_ms']:.3f} ms; {compactions} compactions of "
        f"{f['compaction_ms']:.3f} ms; every step's positions equal the "
        f"on-card oracle's, distances within {checked['max_rel']:.3g} "
        f"relative; router {router}")

    # (c) The launch path's continuous batcher.
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 13)))
               .astype(np.int32) for _ in range(LM_REQUESTS)]
    batcher = SlotBatcher(model, LM_SLOTS, LM_MAX_LEN)
    for rid, p in enumerate(prompts):
        batcher.submit(Request(rid=rid, prompt=p, max_new=LM_MAX_NEW))
    done, t_b = timed(lambda: batcher.run(LM_REQUESTS * (LM_MAX_NEW + 4)))
    expect(sorted(done) == list(range(LM_REQUESTS)),
           f"lm (c): {len(done)} of {LM_REQUESTS} requests finished")
    expect(all(np.array_equal(done[r][:len(p)], p)
               and len(done[r]) == len(p) + LM_MAX_NEW
               for r, p in enumerate(prompts)),
           "lm (c): an answer is not its prompt and max_new tokens")
    gen_tok = LM_REQUESTS * LM_MAX_NEW
    fig["batcher"] = dict(slots=LM_SLOTS, max_len=LM_MAX_LEN,
                          requests=LM_REQUESTS, max_new=LM_MAX_NEW, s=t_b,
                          tokens_per_s=gen_tok / t_b)
    log(f"[lm] (c) SlotBatcher: {LM_REQUESTS} requests (prompts 4-12, "
        f"max_new {LM_MAX_NEW}) on {LM_SLOTS} slots: {t_b:.3f} s, "
        f"{gen_tok / t_b:.1f} generated tokens/s")
    counts = path_counts("lm")  # the LM path ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    fig["launches"] = counts
    if args.profile_lm:
        fig["profile"] = lm_profile(model, corpus, index, kept["states"])
    del batcher, done, model
    gc.collect()
    torch.cuda.empty_cache()

    # (e) The path's kernels against their plain versions at its shapes.
    lm_kernel_checks(vecs, base, kept, LM_K, LM_ROUND)
    del vecs, index, base, kept, store
    gc.collect()
    torch.cuda.empty_cache()

    # (d) Float32 checks (TF32 is off for the whole script).
    fig["checks"] = lm_f32_checks(cfg, dev, args.seed)
    peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    log(f"[lm] peak device memory {peak:.2f} GiB (limit {MAX_PEAK_GIB:.0f})")
    expect(peak < MAX_PEAK_GIB, f"lm peak memory {peak:.2f} GiB")
    fig["peak_gib"] = peak
    return counts, fig


KERNEL_KINDS = (  # a card kernel's kind, by the first pattern in its name
    ("matmul", ("gemm", "gemv", "xmma", "nvjet", "cutlass", "cublas")),
    ("reduction", ("reduce", "softmax")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy",
                     "fill")),
)


def kernel_kind(name: str) -> str:
    """``KERNEL_KINDS``' kind of a card kernel's name, else ``other``."""
    low = name.lower()
    for kind, pats in KERNEL_KINDS:
        if any(p in low for p in pats):
            return kind
    return "other"


def profile_window(name: str, fn, top: int = 8, tag: str = "lm") -> dict:
    """Trace ``fn()`` once by ``torch.profiler``, after a warm-up call: the
    wall time, the summed time of the card's kernels (one stream, so the
    busy time), the idle share 1 - busy / wall, the busy time by kernel
    kind (``kernel_kind``) and the top kernels."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            n += 1
    busy = sum(by_name.values()) / 1e6
    expect(n > 0, f"{tag} profile {name}: the trace holds no kernel")
    by_kind = collections.Counter()
    for k, v in by_name.items():
        by_kind[kernel_kind(k)] += v / 1e6
    out = dict(wall_s=wall, busy_s=busy, idle_share=1 - busy / wall,
               kernels=n, by_kind=dict(by_kind),
               top=[(k[:90], v / 1e6) for k, v in by_name.most_common(top)])
    log(f"[{tag}] profile {name}: wall {wall:.4f} s; {n} kernels, busy "
        f"{busy:.4f} s; idle share {out['idle_share']:.3f}; busy by kind "
        + ", ".join(f"{k} {v:.4f} s" for k, v in by_kind.most_common()))
    for k, v in out["top"]:
        log(f"[{tag}] profile {name}:   {v:.4f} s  {k}")
    return out


def lm_profile(model, corpus, index, states) -> dict:
    """``--profile-lm``: where the lm phase's time goes, on its own model,
    corpus and datastore. Three windows: one datastore chunk through
    ``Model.apply``; prefill and 8 decode steps at the phase's batch; one
    retrieval step (``submit`` and ``drain`` of one step's LM states) over
    a fresh router on the datastore's base index, as the phase builds it."""
    import numpy as np
    import torch

    from repro_torch.examples import retrieval_serve as rs
    from repro_torch.serving import IngestingRouter
    from repro_torch.serving.kv_cache import pad_cache_to

    dev = model.device
    out = {}
    out["datastore_chunk"] = profile_window(
        "datastore chunk", lambda: rs.datastore(
            model, corpus["tokens"][:LM_CHUNK], corpus["labels"][:LM_CHUNK]))
    prompts = torch.from_numpy(
        corpus["tokens"][:LM_BATCH, :LM_PROMPT].astype(np.int64)).to(dev)

    def decode8():
        logits, cache = model.prefill({"tokens": prompts})
        cache = pad_cache_to(cache, LM_PROMPT + 8)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for i in range(8):
            last, cache = model.decode_step({"tokens": nxt}, cache,
                                            LM_PROMPT + i)
            nxt = torch.argmax(last, dim=-1)[:, None]

    out["prefill_and_8_decode_steps"] = profile_window(
        "prefill + 8 decode steps", decode8)
    queries = states.float().cpu().numpy()
    svc = IngestingRouter(
        index, LM_SHARDS, k=LM_K, max_batch=LM_BATCH, max_wait_ms=50.0,
        round_size=LM_ROUND, max_pending=4 * LM_BATCH, policy="shed-oldest",
        compaction_policy=None)

    def retrieve():
        futs = [svc.submit(q) for q in queries]
        svc.drain()
        return [f.result() for f in futs]

    try:
        out["retrieval_step"] = profile_window("retrieval step", retrieve)
    finally:
        svc.stop()
    return out


def lm_kernel_checks(vecs, base, kept: dict, k: int, rs: int) -> None:
    """``paa_isax`` on the 2^20 datastore rows and on one step's appended
    rows, ``lower_bound_sq_batch`` on that step's PAA over a base shard's
    and a delta shard's SAX (bitwise), ``euclid_sq`` on its first-round
    gather over the base shard (within 1e-5)."""
    import torch

    from repro_torch.core import build_sharded_index, isax
    from repro_torch.kernels import ops

    expect("delta" in kept, "lm (e): no delta shard was seen")
    shard = build_sharded_index(base, LM_SHARDS).shards[0]
    delta, states = kept["delta"], kept["states"]
    w, card, n = shard.segments, shard.cardinality, shard.series_length
    dev = shard.device
    bp = isax.gaussian_breakpoints(card, dev)
    for rows, what in ((vecs, f"{vecs.shape[0]} datastore rows"),
                       (states, f"{states.shape[0]} appended rows")):
        x = isax.znorm(rows)
        got = ops.paa_isax(x, bp, w, normalize=False)
        plain = ops.paa_isax(x, bp, w, normalize=False, impl="ref")
        expect(all(torch.equal(g, e) for g, e in zip(got, plain)),
               f"lm (e): paa_isax on {what} differs from its plain version")
        del x, got, plain
    qs = isax.znorm(states)
    qps = isax.paa(qs, w)
    bpp = isax.padded_breakpoints(card, dev)
    for sax, what in ((delta.sax, "a delta shard"), (shard.sax,
                                                     "a base shard")):
        lb = ops.lower_bound_sq_batch(qps, sax, bpp, n)
        expect(torch.equal(lb, ops.lower_bound_sq_batch(
            qps, sax, bpp, n, impl="ref")), f"lm (e): lower_bound_sq_batch "
            f"over {what} not bitwise equal to its plain version")
    pos = shard.pos[first_round(lb, shard.num_series, rs)].contiguous()
    got = ops.euclid_sq_gather(qs, shard.raw, pos)
    plain = ops.euclid_sq_gather(qs, shard.raw, pos, impl="ref")
    expect(torch.allclose(got, plain, rtol=1e-5, atol=1e-5),
           "lm (e): euclid_sq differs from its plain version")
    log(f"[lm] (e) paa_isax ({vecs.shape[0]} datastore rows, "
        f"{states.shape[0]} appended rows) and lower_bound_sq_batch "
        f"({qps.shape[0]} x {w} PAA over a delta shard of {delta.num_series} "
        f"and a base shard of {shard.num_series} rows) bitwise equal to their "
        f"plain versions; euclid_sq ({tuple(pos.shape)} first-round gather) "
        "within 1e-5")


def lm_f32_checks(cfg, dev, seed: int) -> dict:
    """(d): the same generator-made model at depth 2 in float32 on the card
    and on the host CPU (prefill, 8 greedy steps); decode after prefill
    against the full forward at depth 8 on the card; each SlotBatcher
    answer against its own greedy generation."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import Model
    from repro_torch.serving.batcher import Request, SlotBatcher
    from repro_torch.serving.kv_cache import pad_cache_to
    from repro_torch.serving.serve_step import greedy_generate

    out = {}
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    c2 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    card = Model(c2, device=dev,
                 generator=torch.Generator(dev).manual_seed(seed))
    host = Model(c2, device="cpu")  # filled from the card's parameters
    host.load_state_dict(card.state_dict())
    t0 = time.perf_counter()
    errs = []
    res = []
    for m in (card, host):
        t = tokens.to(m.device)
        logits, cache = m.prefill({"tokens": t})
        cache = pad_cache_to(cache, 16 + 8)
        steps = [logits[:, -1]]
        res.append((m, cache, steps, logits))
    errs.append(lm_close(res[0][3], res[1][3], "prefill, card vs host"))
    last = [r[2][0] for r in res]
    caches = [r[1] for r in res]
    for i in range(8):
        nxt = [torch.argmax(x, dim=-1) for x in last]
        expect(torch.equal(nxt[0].cpu(), nxt[1]), f"lm (d): greedy token "
               f"{i} differs between the card and the host")
        for j, m in enumerate((card, host)):
            last[j], caches[j] = m.decode_step(
                {"tokens": nxt[j][:, None]}, caches[j], 16 + i)
        errs.append(lm_close(last[0], last[1], f"decode step {i}, card vs "
                             "host"))
    out["card_vs_host_max_rel"] = max(errs)
    log(f"[lm] (d) depth 2, float32, full width: prefill 2 x 16 and 8 greedy "
        f"steps on the card equal the host CPU's tokens, logits within "
        f"{max(errs):.3g} of the largest ({time.perf_counter() - t0:.1f} s)")
    del host, res, caches, last

    # Each SlotBatcher answer is its own greedy generation (depth 2, f32).
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 12)]
    b = SlotBatcher(card, 2, 32)
    for i, p in enumerate(prompts):
        b.submit(Request(rid=i, prompt=p, max_new=8))
    done = b.run(64)
    for i, p in enumerate(prompts):
        single = greedy_generate(card, torch.from_numpy(
            p[None].astype(np.int64)).to(dev), max_new=8)[0].cpu().numpy()
        expect(i in done and np.array_equal(done[i], single),
               f"lm (d): batcher answer {i} differs from its greedy "
               "generation")
    log("[lm] (d) SlotBatcher (2 slots, 3 requests) answers equal their own "
        "greedy generations")
    del card, b
    gc.collect()
    torch.cuda.empty_cache()

    # Decode after prefill of s-1 tokens == the full forward's last row.
    c8 = dataclasses.replace(cfg, dtype="float32")
    m8 = Model(c8, device=dev,
               generator=torch.Generator(dev).manual_seed(seed))
    t = tokens.to(dev)
    full, _, _ = m8.apply({"tokens": t})
    _, cache = m8.prefill({"tokens": t[:, :15]})
    last, _ = m8.decode_step({"tokens": t[:, 15:]}, pad_cache_to(cache, 16),
                             15)
    out["decode_vs_forward_max_rel"] = lm_close(
        last, full[:, -1], f"depth {c8.num_layers} decode vs forward")
    expect(torch.equal(torch.argmax(last, -1), torch.argmax(full[:, -1], -1)),
           "lm (d): decode and forward pick different tokens")
    log(f"[lm] (d) depth {c8.num_layers}, float32: decode after prefill of "
        f"15 tokens equals the full forward's last position within "
        f"{out['decode_vs_forward_max_rel']:.3g} of the largest logit")
    del m8, full, cache, last
    gc.collect()
    torch.cuda.empty_cache()
    return out

TRAIN_ARCH = "granite-34b"
TRAIN_LAYERS = 4  # of 88: 2.724 B parameters, 45.7 GiB of training state
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 4, 2048, 2  # rows, tokens, microbatches
TRAIN_STEPS = 8  # timed steps, after one warm-up step
TRAIN_OPT_ITERS = 3  # optimizer updates timed by CUDA events
TRAIN_HOST_BATCH = (2, 64)  # (b): rows x tokens on the card and the host
TRAIN_LOSS_RTOL = 1e-5  # (b): the loss within 1e-5 relative
TRAIN_GRAD_TOL = 1e-3  # (b): each gradient within 1e-3 of its leaf's largest
TRAIN_LM_MAX_LOSS = 2.5  # (c): the example's loss at step 300
ADAM_BYTES_PER_PARAM = 30  # read master, grad, mu, nu (4 each); write
# master, mu, nu (4 each) and the bf16 compute copy (2)


def train_flops(cfg, n_block_mm: int, n_head: int, tokens: int,
                n_down: int = 0) -> float:
    """FLOPs of one remat training step: 8 a parameter a token in the
    blocks' matmuls (forward, recompute, backward), 6 in the head's, plus
    the dense attention's two (S, S) products, 4 passes of 4 B S^2 H hd
    each (forward, recompute, two backward) a layer. Less 2 a parameter a
    token of the ``n_down`` MLP down-projection parameters: a block's
    recompute stops once the tensors its backward saved are back
    (``torch.utils.checkpoint``'s early stop), and the down-projection's
    output is saved by nothing, so it runs twice, not three times."""
    b, s = TRAIN_BATCH, TRAIN_SEQ
    attn = 16 * cfg.num_layers * b * s * s * cfg.num_heads * cfg.head_dim
    return tokens * (8 * n_block_mm + 6 * n_head - 2 * n_down) + attn


def phase_train(args, dev) -> tuple:
    """LM training on one card: (a) granite-34b at full width, 4 layers,
    bf16 with float32 masters, remat, microbatches, the prefetching loader;
    (b) depth 1 in float32 on the card against the host CPU (loss and
    every gradient); (c) the ``train_lm`` example at its defaults, then 6
    steps straight against 3 + save + restore into a fresh state + 3,
    bitwise. Returns (the path's launch counts, the ``{"train": ...}``
    figures)."""
    import dataclasses
    import statistics

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    from repro_torch.models import Model
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts_mod

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              num_layers=TRAIN_LAYERS)
    model = Model(cfg, device=dev, remat=True,
                  generator=torch.Generator(dev).manual_seed(args.seed))
    state = ts_mod.init_train_state(model)
    n_params = sum(p.numel() for p in state.params)
    n_block_mm = sum(p.numel() for n, p in zip(state.names, state.params)
                     if n.startswith("blocks.") and p.dim() >= 2)
    n_head = model.lm_head.w.numel()
    state_gib = (  # compute copies, separate masters, mu + nu + grad sums
        sum(p.numel() * p.element_size() for p in state.params)
        + sum(4 * p.numel() for p in state.params
              if p.dtype != torch.float32)
        + 12 * n_params) / 2**30
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_down = sum(p.numel() for n, p in zip(state.names, state.params)
                 if n.startswith("blocks.") and n.endswith(".mlp.wo"))
    flops = train_flops(cfg, n_block_mm, n_head, tokens, n_down)
    bound_s = flops / roofline.BF16_OPS_PER_S
    log(f"[train] (a) {TRAIN_ARCH} at full width, {TRAIN_LAYERS} of "
        f"{configs.get_config(TRAIN_ARCH).num_layers} layers, {cfg.dtype} "
        f"with float32 masters, remat: {n_params / 1e9:.3f} B parameters; "
        f"state {state_gib:.2f} GiB; B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
        f"{TRAIN_MICRO} microbatches; FLOP bound {flops:.4g} a step "
        f"({flops / tokens / 1e9:.2f} GFLOP a token of matmuls and "
        f"attention) at 989 TFLOP/s dense bf16: {bound_s:.4f} s")
    tcfg = ts_mod.TrainConfig(
        optimizer=opt_mod.OptimizerConfig(warmup_steps=2, total_steps=10),
        microbatches=TRAIN_MICRO, z_loss=1e-4)
    step_fn = ts_mod.make_train_step(model, tcfg)
    ops.reset_launch_counts()  # the train path starts here
    loader = data_mod.PrefetchingLoader(
        data_mod.bigram_batch, TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size,
        seed=args.seed, device=dev)
    secs, losses, norms = [], [], []
    try:
        for i in range(1 + TRAIN_STEPS):
            _, batch = next(loader)
            (state, m), dt = timed(lambda: step_fn(state, batch))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if i:
                secs.append(dt)
            log(f"[train] (a) step {i}: {dt * 1e3:.1f} ms, loss "
                f"{losses[-1]:.5f}, grad_norm {norms[-1]:.5f}, lr "
                f"{float(m['lr']):.3g}")
    finally:
        loader.close()
    counts = path_counts("train")  # the train path ends here
    expect(all(math.isfinite(x) for x in losses + norms),
           "train (a): a non-finite loss or grad_norm")
    step_s = statistics.median(secs)
    # Where a step's time goes: one more step (after another warm-up one)
    # traced by torch.profiler, after the counts are read.
    prof_batch = batch
    profile = profile_window(
        "one step", lambda: step_fn(state, prof_batch), tag="train")

    # The optimizer update (and the bf16 refresh) alone, by CUDA events.
    grads = [torch.randn_like(m).mul_(1e-3) for m in state.master]
    opt_ms = time_ms(lambda: (opt_mod.adamw_update(
        tcfg.optimizer, state.master, grads, state.opt, state.ranks),
        state.refresh()), TRAIN_OPT_ITERS)
    opt_bytes = ADAM_BYTES_PER_PARAM * n_params
    opt_bound_ms = opt_bytes / roofline.HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    fig = dict(
        arch=TRAIN_ARCH, layers=TRAIN_LAYERS, params=n_params,
        dtype=cfg.dtype, state_gib=state_gib, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, microbatches=TRAIN_MICRO, remat=True,
        step_ms=[x * 1e3 for x in secs], median_step_ms=step_s * 1e3,
        tokens_per_s=tokens / step_s, flop_per_step=flops,
        flop_bound_ms=bound_s * 1e3, flop_bound_share=bound_s / step_s,
        loss=losses, grad_norm=norms, optimizer_ms=opt_ms,
        optimizer_bytes=opt_bytes, optimizer_bound_ms=opt_bound_ms,
        peak_gib=peak, launches=counts, profile=profile)
    log(f"[train] (a) median step {step_s * 1e3:.2f} ms over {TRAIN_STEPS} "
        f"(host clock around a synchronised step), {tokens / step_s:.0f} "
        f"tokens/s; {100 * bound_s / step_s:.1f}% of the FLOP bound "
        f"({bound_s * 1e3:.2f} ms); optimizer + bf16 refresh {opt_ms:.3f} ms "
        f"by CUDA events against {opt_bound_ms:.3f} ms ({opt_bytes:.4g} B "
        f"at 3.35 TB/s, {ADAM_BYTES_PER_PARAM} B a parameter); peak "
        f"{peak:.2f} GiB (limit {MAX_PEAK_GIB:.0f})")
    expect(peak < MAX_PEAK_GIB, f"train (a) peak memory {peak:.2f} GiB")
    del grads, state, model, step_fn, batch, m
    gc.collect()
    torch.cuda.empty_cache()

    fig["card_vs_host"] = train_host_check(cfg, dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    fig["train_lm"] = train_lm_check(args, dev)
    return counts, fig


def train_host_check(cfg, dev, seed: int) -> dict:
    """(b): the same generator-made model at depth 1 in float32 on the card
    and on the host CPU: one batch's loss and every gradient."""
    import dataclasses

    import torch

    from repro_torch.models import Model
    from repro_torch.training import data as data_mod
    from repro_torch.training import train_step as ts_mod

    c1 = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    card = Model(c1, device=dev, generator=torch.Generator(dev).manual_seed(
        seed))
    host = Model(c1, device="cpu")  # filled from the card's parameters
    host.load_state_dict(card.state_dict())
    b, s = TRAIN_HOST_BATCH
    batch = data_mod.bigram_batch(0, b, s, c1.vocab_size, seed=seed)
    t0 = time.perf_counter()
    out = []
    for m in (card, host):
        st = ts_mod.init_train_state(m)
        x = {k: torch.from_numpy(v).to(m.device) for k, v in batch.items()}
        loss, _ = ts_mod.make_loss_fn(m, ts_mod.TrainConfig(z_loss=1e-4))(x)
        out.append((st.names, loss.detach().cpu(),
                    [g.cpu() for g in torch.autograd.grad(loss, st.params)]))
        del st, x, loss
    (names, loss_c, g_c), (_, loss_h, g_h) = out
    rel = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    expect(math.isfinite(float(loss_c)) and rel <= TRAIN_LOSS_RTOL,
           f"train (b): loss {float(loss_c)} on the card, {float(loss_h)} "
           "on the host")
    worst = 0.0
    for name, gc_, gh in zip(names, g_c, g_h):
        scale = float(gh.abs().max())
        err = float((gc_ - gh).abs().max()) / max(scale, 1e-30)
        expect(bool(gc_.isfinite().all()) and err <= TRAIN_GRAD_TOL,
               f"train (b): gradient {name} {err:.3g} of its largest "
               f"({scale:.3g}) from the host's")
        worst = max(worst, err)
    n = sum(p.numel() for p in card.parameters())
    log(f"[train] (b) depth 1, float32, full width ({n / 1e9:.3f} B "
        f"parameters), {b} x {s} tokens: the card's loss {float(loss_c):.6f} "
        f"within {rel:.3g} of the host's, every gradient within {worst:.3g} "
        f"of its leaf's largest ({time.perf_counter() - t0:.1f} s)")
    del card, host, out
    return dict(params=n, loss_rel=rel, grad_max_rel=worst)


def train_lm_check(args, dev) -> dict:
    """(c): ``repro_torch.examples.train_lm`` at its defaults on the card,
    then 6 steps straight against 3 + save + restore into a fresh model
    and optimizer + 3, masters, moments and step bitwise; then one of its
    steps traced (busy time, idle share, kernels)."""
    import torch

    from repro_torch import convert
    from repro_torch.examples import train_lm
    from repro_torch.models import Model
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts_mod

    root = tempfile.mkdtemp(prefix="paris_train_", dir=args.disk_dir)
    try:
        res = train_lm.main(["--ckpt-dir", os.path.join(root, "example"),
                             "--device", str(dev)])
        expect(res["steps"] == 300 and res["last_loss"] < TRAIN_LM_MAX_LOSS,
               f"train (c): the example's loss {res['last_loss']} at step "
               f"300 (limit {TRAIN_LM_MAX_LOSS})")
        log(f"[train] (c) train_lm (lm-22m, 300 steps, B 8 x S 128): loss "
            f"{res['first_loss']:.4f} -> {res['last_loss']:.4f}, "
            f"{res['tokens_per_s']:.0f} tokens/s, {res['seconds']:.2f} s "
            "with its checkpoints")
        cfg = train_lm.model_config(False)
        tcfg = ts_mod.TrainConfig(optimizer=opt_mod.OptimizerConfig(
            learning_rate=1e-3, warmup_steps=20, total_steps=300))

        def fresh(seed):
            model = Model(cfg, device=dev, remat=False,
                          generator=torch.Generator(dev).manual_seed(seed))
            return ts_mod.init_train_state(model), ts_mod.make_train_step(
                model, tcfg)

        def run(st, fn, start, n):
            for i in range(start, start + n):
                b = data_mod.bigram_batch(i, 8, 128, cfg.vocab_size)
                st, _ = fn(st, {k: torch.from_numpy(v).to(dev)
                                for k, v in b.items()})
            return st

        st, fn = fresh(args.seed)
        straight = convert.train_state_to_arrays(run(st, fn, 0, 6))
        st, fn = fresh(args.seed)
        ckpt_mod.save(os.path.join(root, "resume"), 3, run(st, fn, 0, 3))
        del st, fn
        st, fn = fresh(args.seed + 1)
        _, step = ckpt_mod.restore_latest(os.path.join(root, "resume"), st)
        resumed = convert.train_state_to_arrays(run(st, fn, 3, 3))
        same = step == 3 and all(
            a.dtype == b.dtype and (a == b).all()
            for a, b in zip(_leaves(straight), _leaves(resumed)))
        expect(same, "train (c): 3 + restore + 3 steps differ from 6 "
               "straight")
        log("[train] (c) 6 steps straight and 3 + save + restore into a "
            "fresh model and optimizer + 3: masters, moments and step "
            "bitwise equal")
        res["resume_bitwise"] = True
        # Where the example's step goes (host or card): one traced step.
        b = {k: torch.from_numpy(v).to(dev) for k, v in
             data_mod.bigram_batch(6, 8, 128, cfg.vocab_size).items()}
        res["profile"] = profile_window("train_lm step",
                                        lambda: fn(st, b), tag="train")
        return res
    finally:
        shutil.rmtree(root, ignore_errors=True)


DRYRUN_TIMEOUT_S = 300  # the child process's limit
DRYRUN_FLOP_RTOL = 0.01  # (a): counted FLOPs within 1% of train_flops
# (a): the traced peak against the train phase's measured one. PERF.md
# states the prediction (within 10%); this bound only catches nonsense.
DRYRUN_PEAK_RTOL = 0.25
OVERHEAD_CALLS = 2000  # calls a wrapper's host cost is timed over


def op_overhead(dev) -> dict:
    """Host microseconds a call of ``euclid_sq_gather`` (one query, 64
    rows of 256: the launch dominates) through ``ops.euclid_sq_gather``
    (the port's entry: device rule, casts, then the operator), through
    ``torch.ops.repro_torch.euclid_sq_gather`` directly, and through the
    ``*_cuda`` wrapper, timed in turns over ``OVERHEAD_CALLS`` calls each."""
    import torch

    from repro_torch.kernels import euclidean as keu
    from repro_torch.kernels import ops

    raw = torch.randn(1 << 16, 256, device=dev)
    q = torch.randn(1, 256, device=dev)
    pos = torch.arange(64, dtype=torch.int32, device=dev)[None]
    op = torch.ops.repro_torch.euclid_sq_gather
    calls = {"entry": lambda: ops.euclid_sq_gather(q, raw, pos),
             "operator": lambda: op(q, raw, pos),
             "wrapper": lambda: keu.euclid_sq_gather_cuda(q, raw, pos)}
    out = {k: [] for k in calls}
    for _ in range(2):
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OVERHEAD_CALLS):
                fn()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) / OVERHEAD_CALLS
                             * 1e6)
    fig = {f"{k}_us": min(v) for k, v in out.items()}
    fig["operator_minus_wrapper_us"] = fig["operator_us"] - fig["wrapper_us"]
    log(f"[kernels] a call's host cost (euclid_sq_gather, 1 x 64 rows, best "
        f"of 2 turns of {OVERHEAD_CALLS}): {fig['entry_us']:.2f} us through "
        f"ops.euclid_sq_gather, {fig['operator_us']:.2f} us through "
        f"torch.ops.repro_torch, {fig['wrapper_us']:.2f} us through the "
        f"wrapper alone")
    return fig


def dryrun_child() -> None:
    """The dryrun phase's traces, in a process of its own (the fake
    process group never touches the main process): (a) the train phase's
    step as a cell on a (1, 1) mesh, (b) the paris cells on the (16, 16)
    mesh. Prints one JSON line of their records."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    out = {}
    with dryrun.fake_world():
        mesh = make_debug_mesh((1, 1))
        calib = ShapeConfig("calibration", TRAIN_SEQ, TRAIN_BATCH, "train")
        out["calibration"] = dryrun.traced(lambda: specs.build_cell(
            TRAIN_ARCH, "calibration", mesh,
            overrides={"num_layers": TRAIN_LAYERS}, shape=calib,
            microbatch_tokens_per_device=4096), 1)
        single = make_production_mesh()
        for shape in ("search", "build"):
            out[f"paris/{shape}"] = dryrun.traced(
                lambda: specs.build_paris_cell(shape, single), 256)
    print(json.dumps(out, default=str))


def phase_dryrun(train_fig: dict) -> tuple:
    """The launch tools (``repro_torch.launch``: ``specs``, ``dryrun``,
    ``roofline``) on the card's machine, in a child process: (a) the train
    phase's own step traced on fake CUDA tensors and held to that phase's
    measurements (FLOPs within 1% of ``train_flops``, the traced peak
    beside the measured one, the roofline terms beside the step time);
    (b) the paris search and build cells on the (16, 16) mesh. Returns
    (the launch counts, all 0, and the ``{"dryrun": ...}`` figures)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()  # the dryrun path starts here
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         "--dryrun-child"], env=env, capture_output=True, text=True,
        timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if done.returncode:
        log(done.stderr[-4000:])
    expect(done.returncode == 0, f"dryrun child exited {done.returncode}")
    recs = json.loads(done.stdout.strip().splitlines()[-1])
    counts = path_counts("dryrun")  # the dryrun path ends here
    expect(not any(counts.values()), "the dryrun phase launched a kernel")
    for name, rec in recs.items():
        expect(rec["status"] == "ok", f"dryrun {name}: {rec.get('error')}")

    a = recs["calibration"]
    r, mem = a["roofline"], a["memory"]
    want = train_fig["flop_per_step"]
    flop_err = abs(r["flops"] - want) / want
    peak = mem["peak_estimate_bytes"] / 2**30
    measured = train_fig["peak_gib"]
    peak_err = (peak - measured) / measured
    step_s = train_fig["median_step_ms"] / 1e3
    log(f"[dryrun] (a) {TRAIN_ARCH} depth {TRAIN_LAYERS}, B {TRAIN_BATCH} x "
        f"S {TRAIN_SEQ}, {a['meta']['microbatches']} microbatches, (1, 1) "
        f"mesh, traced in {a['trace_s']:.2f} s: FLOPs {r['flops']:.6g} "
        f"against the train phase's {want:.6g} ({100 * flop_err:.3f}%); "
        f"peak {peak:.2f} GiB against the measured {measured:.2f} GiB "
        f"({100 * peak_err:+.1f}%); compute {r['compute_s']:.4f} s, memory "
        f"{r['memory_s']:.4f} s against the measured step {step_s:.4f} s")
    expect(flop_err <= DRYRUN_FLOP_RTOL, f"dryrun (a): FLOPs off by "
           f"{100 * flop_err:.3f}%")
    expect(abs(peak_err) <= DRYRUN_PEAK_RTOL, f"dryrun (a): peak off by "
           f"{100 * peak_err:+.1f}%")
    fig = dict(calibration=dict(
        flops=r["flops"], flops_by_dtype=r["flops_by_dtype"],
        train_flops=want, flop_rel_err=flop_err, hbm_bytes=r["hbm_bytes"],
        peak_gib=peak, measured_peak_gib=measured, peak_rel_err=peak_err,
        compute_s=r["compute_s"], memory_s=r["memory_s"],
        collective_s=r["collective_s"], measured_step_s=step_s,
        microbatches=a["meta"]["microbatches"], trace_s=a["trace_s"]))
    for shape in ("search", "build"):
        b = recs[f"paris/{shape}"]
        rb = b["roofline"]
        fig[f"paris_{shape}"] = dict(
            compute_s=rb["compute_s"], memory_s=rb["memory_s"],
            collective_s=rb["collective_s"], dominant=rb["dominant"],
            flops=rb["flops"], hbm_bytes=rb["hbm_bytes"],
            collective_bytes=rb["collective_bytes"],
            collective_by_link=rb["collective_by_link"],
            unknown_trip_bodies=rb["unknown_trip_bodies"],
            peak_gib=b["memory"]["peak_estimate_bytes"] / 2**30,
            trace_s=b["trace_s"])
        log(f"[dryrun] (b) paris/{shape} on (16, 16), rank 0: compute "
            f"{rb['compute_s']:.3g} s, memory {rb['memory_s']:.3g} s, "
            f"collective {rb['collective_s']:.3g} s ({rb['dominant']}); peak "
            f"{fig[f'paris_{shape}']['peak_gib']:.3f} GiB; host reads "
            f"counted once at {rb['unknown_trip_bodies']}")
    log("[dryrun] (c) granite-34b/train_4k on (16, 16) traces for over an "
        "hour of host CPU (88 layers x 16 microbatches through DTensor): "
        "run it alone with python -m repro_torch.launch.dryrun")
    fig.update(child_wall_s=wall, launches=counts)
    return counts, fig


SHARD_ARCH = "granite-34b"
SHARD_A_LAYERS = 2  # (a): of 88, bf16 with float32 masters, remat
SHARD_A_BATCH = (4, 2048, 2)  # (a): rows, tokens, microbatches
SHARD_A_STEPS = 2  # (a): steps of each state
SHARD_B_LAYERS = 1  # (b): float32, 1.134 B parameters
SHARD_B_BATCH = (4, 512)  # (b), (d): rows x tokens a step
SHARD_B_WORLD, SHARD_B_SHAPE = 4, (2, 2)  # (b): gloo ranks on the one card
SHARD_D_SHAPE = (4, 1)  # (d): the mesh (b)'s checkpoint is restored onto
SHARD_C_ARCH = "olmoe-1b-7b"  # (c): full width, depth 1, float32
SHARD_C_TOKENS = (2, 128)  # (c): rows x tokens a rank
SHARD_C_CAPACITY = 64.0  # (c): dropless, as the JAX test
SHARD_LOSS_RTOL = 1e-5  # (b), (d): loss within 1e-5 relative
SHARD_GRAD_TOL = 1e-3  # (b): each gradient within 1e-3 of its leaf's largest
SHARD_MOE_TOL = 1e-3  # (c): local against global logits (the JAX test's)
SHARD_LR = 3e-4  # OptimizerConfig's default peak; warmup 0
SHARD_PARAM_TOL = SHARD_LR / 4  # (b), (d): masters within lr / 4
SHARD_GROUP_TIMEOUT_S = 300  # a collective that waits this long fails
SHARD_JOIN_TIMEOUT_S = 600  # a mesh that has not returned by then fails


def run_shard(world: int, backend: str, plan: list, dev) -> tuple:
    """Spawn ``world`` ranks over ``backend`` on the card and run
    ``sharding.run_plan(plan)``; returns (every rank's result, the
    parent's peak bytes while they ran, wall seconds)."""
    import torch

    from repro_torch.core import distributed as mesh_mod
    from repro_torch.training import sharding

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store:
        ranks = mesh_mod.spawn_mesh(
            sharding.run_plan, world, backend=backend,
            init_method=f"file://{store}/rendezvous",
            timeout=SHARD_GROUP_TIMEOUT_S, join_timeout=SHARD_JOIN_TIMEOUT_S,
            device=dev, args=(plan,))
    return ranks, torch.cuda.max_memory_allocated(), time.perf_counter() - t0


def shard_figures(ranks, name: str, parent_peak: int, wall: float,
                  full_bytes: int) -> dict:
    """A multi-rank step's figures: wall time, the slowest rank's steps,
    every rank's state bytes against the unsharded state's, peaks (summed
    with the parent's, which must stay under the limit), collectives."""
    rs = [r[name] for r in ranks]
    peaks = [r["peak_bytes"] for r in rs]
    total = (sum(peaks) + parent_peak) / 2**30
    expect(total < MAX_PEAK_GIB, f"shard {name}: peak memory summed over "
           f"the parent and the ranks {total:.2f} GiB")
    return dict(wall_s=wall, steps_s=max(r["seconds"] for r in rs),
                state_bytes=[r["state_bytes"] for r in rs],
                unsharded_state_bytes=full_bytes,
                rank_peak_gib=[p / 2**30 for p in peaks],
                parent_peak_gib=parent_peak / 2**30, peak_sum_gib=total,
                collectives=[r["collectives"] for r in rs])


def phase_shard(args, dev) -> tuple:
    """Sharded training over a ("data", "model") ``DeviceMesh``
    (``repro_torch.training.sharding``): (a) one NCCL rank, a (1, 1) mesh,
    granite-34b at full width, depth 2, bf16: the plain step and the step
    on the distributed state bitwise; (b) 4 gloo ranks on the card, a
    (2, 2) mesh, depth 1 in float32, 2 steps against the single-card step
    (loss, every gradient, the masters), a checkpoint after step 1; (c) 2
    gloo ranks, a (2, 1) mesh, olmoe-1b-7b at full width, depth 1: local
    against global dispatch, and two runs of forward + backward bitwise;
    (d) (b)'s checkpoint restored onto a (4, 1) mesh and step 2 taken
    again, its files byte-identical to a single-process save of the same
    state. Several ranks on one card are not a multi-card figure. Returns
    (the path's launch counts, the ``{"shard": ...}`` figures)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training import data as data_mod
    from repro_torch.training import optimizer as opt_mod
    from repro_torch.training import train_step as ts_mod

    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()  # the shard path starts here
    fig = {"note": "gloo ranks share the one card and stage DTensor's "
           "collectives through the host: no figure here is a multi-card "
           "one"}
    base = configs.get_config(SHARD_ARCH)
    tcfg = ts_mod.TrainConfig(optimizer=opt_mod.OptimizerConfig(
        learning_rate=SHARD_LR, warmup_steps=0, total_steps=10),
        z_loss=1e-4)

    # (a) one NCCL rank: the plain state against the distributed one.
    b, s, micro = SHARD_A_BATCH
    cfg_a = dataclasses.replace(base, num_layers=SHARD_A_LAYERS)
    plan = [("a", "plain_vs_sharded", dict(
        cfg=cfg_a, tcfg=dataclasses.replace(tcfg, microbatches=micro),
        seed=args.seed, axes=("data", "model"), remat=True,
        batches=[data_mod.bigram_batch(i, b, s, cfg_a.vocab_size,
                                       seed=args.seed)
                 for i in range(SHARD_A_STEPS)]))]
    ranks, parent_peak, wall = run_shard(1, "nccl", plan, dev)
    a = ranks[0]["a"]
    log(f"[shard] (a) {SHARD_ARCH} at full width, {SHARD_A_LAYERS} layers, "
        f"bf16 with float32 masters, remat, B {b} x S {s} in {micro} "
        f"microbatches, one NCCL rank on a (1, 1) mesh: {a['params'] / 1e9:.3f}"
        f" B parameters; losses plain {a['plain_losses']} sharded "
        f"{a['sharded_losses']}; step s plain {a['plain_step_s']} sharded "
        f"{a['sharded_step_s']} (the first step of each carries its "
        f"warm-up); masters max diff {a['master_max_diff']}; rank peak "
        f"{a['peak_bytes'] / 2**30:.2f} GiB; {wall:.1f} s")
    expect(a["loss_equal"] and a["norm_equal"] and a["master_equal"],
           f"shard (a): the sharded step differs from the plain one (loss "
           f"{a['loss_equal']}, grad norm {a['norm_equal']}, masters max "
           f"diff {a['master_max_diff']})")
    fig["a"] = dict(a, wall_s=wall, parent_peak_gib=parent_peak / 2**30)

    # (b) the single-card float32 reference, then 4 gloo ranks.
    cfg_b = dataclasses.replace(base, num_layers=SHARD_B_LAYERS,
                                dtype="float32")
    b, s = SHARD_B_BATCH
    batches = [data_mod.bigram_batch(i, b, s, cfg_b.vocab_size,
                                     seed=args.seed) for i in range(2)]
    t0 = time.perf_counter()
    model = Model(cfg_b, device=dev, remat=False,
                  generator=torch.Generator(dev).manual_seed(args.seed))
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = ts_mod.init_train_state(model)
    on_card = [{k: torch.from_numpy(v).to(dev) for k, v in x.items()}
               for x in batches]
    loss, _ = ts_mod.make_loss_fn(model, tcfg)(on_card[0])
    ref_grads = dict(zip(state.names, (g.detach() for g in
                                       torch.autograd.grad(loss,
                                                           state.params))))
    step_fn = ts_mod.make_train_step(model, tcfg)
    ref_losses = []
    for x in on_card:
        state, m = step_fn(state, x)
        ref_losses.append(float(m["loss"]))
    ref_master = dict(zip(state.names, state.master))
    n_params = sum(p.numel() for p in state.params)
    full_bytes = 12 * n_params  # float32 masters (the parameters), mu, nu
    del state, step_fn, loss, m, on_card, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[shard] (b) reference: {SHARD_ARCH} at full width, "
        f"{SHARD_B_LAYERS} layer, float32, {n_params / 1e9:.3f} B "
        f"parameters, B {b} x S {s}, one card: losses {ref_losses} "
        f"({time.perf_counter() - t0:.1f} s)")
    root = tempfile.mkdtemp(prefix="paris_shard_", dir=args.disk_dir)
    try:
        ckpt = os.path.join(root, "b")
        plan = [("b", "train", dict(
            cfg=cfg_b, tcfg=tcfg, shape=SHARD_B_SHAPE, init=None, source=init,
            batches=batches, ref_grads=ref_grads, ref_master=ref_master,
            save={1: ckpt}))]
        ranks, parent_peak, wall = run_shard(SHARD_B_WORLD, "gloo", plan, dev)
        r = ranks[0]["b"]
        for other in ranks[1:]:
            expect(other["b"]["losses"] == r["losses"],
                   "shard (b): ranks disagree on the losses")
        worst_g = max(x["b"]["grad_err"] for x in ranks)
        worst_m = max(x["b"]["master_err"] for x in ranks)
        rel = [abs(x - y) / abs(y) for x, y in zip(r["losses"], ref_losses)]
        fig["b"] = dict(shard_figures(ranks, "b", parent_peak, wall,
                                      full_bytes),
                        params=n_params, losses=r["losses"],
                        ref_losses=ref_losses, loss_rel=rel,
                        grad_max_rel=worst_g, master_max_abs=worst_m)
        log(f"[shard] (b) {SHARD_B_WORLD} gloo ranks on the card, a "
            f"{SHARD_B_SHAPE} mesh: losses {r['losses']} (relative to the "
            f"card's {rel}); first batch's gradients within {worst_g:.3g} "
            f"of each leaf's largest; masters after step 2 within "
            f"{worst_m:.3g} (lr / 4 = {SHARD_PARAM_TOL:.3g}); state bytes a "
            f"rank {fig['b']['state_bytes']} against {full_bytes} "
            f"unsharded; rank peaks {fig['b']['rank_peak_gib']} GiB, summed "
            f"with the parent's {fig['b']['peak_sum_gib']:.2f} GiB; "
            f"collectives a rank {fig['b']['collectives']}; steps "
            f"{fig['b']['steps_s']:.1f} s (grads + 2 steps + the save), "
            f"wall {wall:.1f} s")
        expect(all(x <= SHARD_LOSS_RTOL for x in rel),
               f"shard (b): losses {r['losses']} against {ref_losses}")
        expect(worst_g <= SHARD_GRAD_TOL,
               f"shard (b): a gradient {worst_g:.3g} of its leaf's largest "
               "from the single card's")
        expect(worst_m <= SHARD_PARAM_TOL,
               f"shard (b): a master {worst_m:.3g} from the single card's")
        del ref_grads
        gc.collect()
        torch.cuda.empty_cache()

        # (d) (b)'s step-1 checkpoint onto a (4, 1) mesh, then step 2.
        plan = [("d", "train", dict(
            cfg=cfg_b, tcfg=tcfg, shape=SHARD_D_SHAPE, init=None,
            restore=(ckpt, 1), batches=batches[1:],
            ref_master=ref_master))]
        ranks, parent_peak, wall = run_shard(
            math.prod(SHARD_D_SHAPE), "gloo", plan, dev)
        d = ranks[0]["d"]
        rel_d = abs(d["losses"][0] - r["losses"][1]) / abs(r["losses"][1])
        worst_d = max(x["d"]["master_err"] for x in ranks)
        del ref_master, init
        gc.collect()
        torch.cuda.empty_cache()
        # The files against a single-process save of the same state: the
        # checkpoint restored on the host, its save's bytes made in memory.
        t0 = time.perf_counter()
        host = ts_mod.init_train_state(Model(cfg_b, device="cpu"))
        ckpt_mod.restore(ckpt, 1, host)
        step_dir = os.path.join(ckpt, "step_00000001")
        same, n_files, n_bytes = True, 0, 0
        for fn, data in ckpt_mod.encoded(host, 1):
            with open(os.path.join(step_dir, fn), "rb") as f:
                same &= f.read() == data
            n_files += 1
            n_bytes += len(data)
        same &= n_files == len(os.listdir(step_dir))
        del host
        gc.collect()
        fig["d"] = dict(shard_figures(ranks, "d", parent_peak, wall,
                                      full_bytes),
                        loss=d["losses"][0], loss_rel_to_b=rel_d,
                        master_max_abs=worst_d, files=n_files,
                        file_bytes=n_bytes, bytes_identical=same,
                        compare_s=time.perf_counter() - t0)
        log(f"[shard] (d) (b)'s step-1 checkpoint ({n_files} files, "
            f"{n_bytes / 2**30:.2f} GiB) restored onto a {SHARD_D_SHAPE} mesh "
            f"of {math.prod(SHARD_D_SHAPE)} gloo ranks: step 2 loss "
            f"{d['losses'][0]} ({rel_d:.3g} relative to (b)'s), masters "
            f"within {worst_d:.3g} of the single card's; files "
            f"byte-identical to a single-process save: {same}; rank peaks "
            f"{fig['d']['rank_peak_gib']} GiB; collectives a rank "
            f"{fig['d']['collectives']}; wall {wall:.1f} s")
        expect(rel_d <= SHARD_LOSS_RTOL, f"shard (d): step 2 loss "
               f"{d['losses'][0]} against (b)'s {r['losses'][1]}")
        expect(worst_d <= SHARD_PARAM_TOL,
               f"shard (d): a master {worst_d:.3g} from the single card's")
        expect(same, "shard (d): the sharded save's files differ from a "
               "single-process save of the same state")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (c) olmoe: local against global dispatch, and replays bitwise.
    cfg_c = dataclasses.replace(configs.get_config(SHARD_C_ARCH),
                                num_layers=1, dtype="float32",
                                capacity_factor=SHARD_C_CAPACITY)
    rows, seq = SHARD_C_TOKENS
    tokens = torch.randint(0, cfg_c.vocab_size, (2 * rows, seq),
                           generator=torch.Generator().manual_seed(args.seed))
    model = Model(cfg_c, device=dev, remat=False,
                  generator=torch.Generator(dev).manual_seed(args.seed))
    init = {n: p.detach() for n, p in model.named_parameters()}
    plan = [("c", "moe", dict(cfg=cfg_c, shape=(2, 1), init=None,
                              source=init, tokens=tokens.numpy(),
                              dispatch=("global", "local"), runs=2,
                              backward=True))]
    ranks, parent_peak, wall = run_shard(2, "gloo", plan, dev)
    c = ranks[0]["c"]
    err = float(abs(c["global"] - c["local"]).max())
    replay = all(x["c"][f"{k}_replay_bitwise"] for x in ranks
                 for k in ("global", "local"))
    peaks = [x["c"]["peak_bytes"] / 2**30 for x in ranks]
    total = sum(peaks) + parent_peak / 2**30
    n_c = sum(p.numel() for p in model.parameters())
    del model, init
    gc.collect()
    torch.cuda.empty_cache()
    fig["c"] = dict(params=n_c, local_vs_global=err, replay_bitwise=replay,
                    rank_peak_gib=peaks, peak_sum_gib=total, wall_s=wall)
    log(f"[shard] (c) {SHARD_C_ARCH} at full width, 1 layer, float32, "
        f"capacity {SHARD_C_CAPACITY}, {n_c / 1e9:.3f} B parameters, 2 gloo "
        f"ranks on a (2, 1) mesh, {rows} x {seq} tokens a rank: local "
        f"against global logits {err:.3g} (limit {SHARD_MOE_TOL}); two runs "
        f"of forward + backward bitwise: {replay}; rank peaks {peaks} GiB, "
        f"summed with the parent's {total:.2f} GiB; wall {wall:.1f} s")
    expect(err <= SHARD_MOE_TOL, f"shard (c): local dispatch {err:.3g} from "
           "global")
    expect(replay, "shard (c): two runs of the MoE forward + backward differ")
    expect(total < MAX_PEAK_GIB, f"shard (c): peak memory {total:.2f} GiB")
    counts = path_counts("shard")  # the shard path ends here
    for name, n in counts.items():
        expect(n == 0, f"shard: kernel {name} launched {n} times")
    fig["launches"] = counts
    return counts, fig


def _leaves(tree) -> list:
    """A train-state tree's numpy leaves in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def main(argv=None) -> int:
    """Run every phase on the card; exit 0 only if all of them passed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log2-n", type=int, default=24,
                    help="full-size phase holds 2**log2_n series")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--disk-dir", default=tempfile.gettempdir(),
                    help="where the disk phase writes its file and store")
    ap.add_argument("--disk-log2-n", type=int, default=None,
                    help="the disk phase's 2**N series (default: --log2-n, "
                    f"at most {DISK_LOG2_N_MAX})")
    ap.add_argument("--profile-lm", action="store_true",
                    help="trace the lm phase's datastore chunk, decode "
                    "steps and a retrieval step by torch.profiler")
    ap.add_argument("--dryrun-child", action="store_true",
                    help=argparse.SUPPRESS)  # the dryrun phase's process
    args = ap.parse_args(argv)
    if args.disk_log2_n is None:
        args.disk_log2_n = min(args.log2_n, DISK_LOG2_N_MAX)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    if args.dryrun_child:
        dryrun_child()
        return 0

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase(label, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"[{label}] phase {time.perf_counter() - t0:.2f} s")
        return out

    name, count, smi = phase("device", phase_device)
    phase("build", phase_build)
    phase("quickstart", phase_quickstart, dev)
    full = phase("full", phase_full, args, dev)
    base_counts = phase("baselines", phase_baselines, full)
    classify_counts = phase("classify", phase_classify, full)
    rows = phase("kernels", phase_kernels, full)
    overhead = op_overhead(dev)
    tuning_rows = phase("tuning", phase_tuning, dev)
    serve_counts, serve_fig = phase("serve", phase_serve, full)
    mesh_counts, mesh_fig = phase("mesh", phase_mesh, full)
    torch.cuda.empty_cache()
    index = full["index"]  # phase 8 is held to phase 4's index: host copies
    full["host"] = dict(sax=index.sax.cpu(), pos=index.pos.cpu(),
                        offsets=index.bucket_offsets.cpu())
    del index
    packed_counts, multi_row = phase("packed", phase_packed, full)
    rows.append(multi_row)
    disk_counts = phase("disk", phase_disk, full)
    full_counts = full["counts"]
    del full  # the LM phase starts from a card holding no index
    lm_counts, lm_fig = phase("lm", phase_lm, args, dev)
    train_counts, train_fig = phase("train", phase_train, args, dev)
    dryrun_counts, dryrun_fig = phase("dryrun", phase_dryrun, train_fig)
    dryrun_fig["op_overhead"] = overhead
    shard_counts, shard_fig = phase("shard", phase_shard, args, dev)
    for row in rows:  # launches: summed over the driven paths
        row["launches"] = sum(c[row["name"]] for c in (
            full_counts, base_counts, classify_counts, serve_counts,
            mesh_counts, packed_counts, disk_counts, lm_counts,
            train_counts, dryrun_counts, shard_counts))
        expect(row["launches"] > 0, f"{row['name']} never launched")
    expect(sorted(r["name"] for r in rows) == sorted(KERNEL_ROWS),
           "the kernels line must list every kernel")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"tuning": tuning_rows}))
    print(json.dumps({"serve": serve_fig}))
    print(json.dumps({"mesh": mesh_fig}))
    print(json.dumps({"lm": lm_fig}))
    print(json.dumps({"train": train_fig}))
    print(json.dumps({"dryrun": dryrun_fig}))
    print(json.dumps({"shard": shard_fig}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
