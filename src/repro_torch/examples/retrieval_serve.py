"""ParIS+ as the retrieval engine inside LM serving (kNN-LM-style).

The port of ``examples/retrieval_serve.py``. An LM produces state vectors
(here the first 256 logits of each position, the same retrieval geometry
as the pre-unembed hidden state); ParIS+ indexes them; at decode time each
new state queries the index for its nearest memorized states, whose next
tokens form a retrieval distribution that is interpolated with the LM
logits (Khandelwal et al.'s kNN-LM, with ParIS+ replacing the FAISS
store).

Serving is streamed, sharded and ingesting: the datastore lives in a
``MutableIndex`` behind an :class:`IngestingRouter`. Every decoding
sequence submits its query to the router; each shard's batcher answers
the step's arrivals with one engine call over its partition, and the
router merges the per-shard top lists into the exact global k-NN. After
every step the step's (state, chosen token) pairs are appended (a delta
shard, queryable at once), so later steps retrieve from earlier steps of
the same generation; the deltas are folded into the base whenever four
have built up. Every answer is exact at its point in the stream.

:func:`generate` is the decode loop; the tests and ``chip_smoke.py``'s LM
phase drive it with their own models and datastores.

    PYTHONPATH=src python -m repro_torch.examples.retrieval_serve
        [--device cpu] [--seed 0]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import build_index
from repro_torch.core.device import resolve_device
from repro_torch.models import Model
from repro_torch.serving.ingest import IngestingRouter
from repro_torch.serving.kv_cache import pad_cache_to
from repro_torch.training import data as data_mod

NUM_SHARDS = 2
SERIES_LENGTH = 256  # a state's series: its first 256 logits


def knn_mix_logits(lm_logits, dists, neighbor_tokens, vocab_size: int,
                   lam: float) -> torch.Tensor:
    """kNN-LM interpolation, one scatter for the whole batch.

    lm_logits (B, V); dists (B, k) squared distances ascending;
    neighbor_tokens (B, k) the next token of each retrieved state. The
    retrieval distribution is a softmax over -sqrt(d) whose per-token mass
    is the MAX over neighbors sharing that token (one segment-max
    scatter). Returns (1 - lam) log_softmax(lm) + lam log_softmax(knn) in
    float32.
    """
    bsz, _ = dists.shape
    w = torch.softmax(-torch.sqrt(torch.clamp(dists, min=0.0)), dim=1)
    knn_logits = torch.full((bsz, vocab_size), -1e9, dtype=torch.float32,
                            device=dists.device)
    knn_logits.scatter_reduce_(1, neighbor_tokens, torch.log(w + 1e-9),
                               reduce="amax")
    return (1 - lam) * torch.log_softmax(lm_logits.float(), dim=-1) + \
        lam * torch.log_softmax(knn_logits, dim=-1)


def _clock(dev: torch.device) -> float:
    """The host clock once the device has finished its work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def datastore(model: Model, tokens: np.ndarray, next_tokens: np.ndarray,
              chunk: Optional[int] = None):
    """The (state, next token) pairs of a corpus.

    ``tokens`` (R, S) go through ``model.apply`` ``chunk`` rows at a time;
    the state at position t < T of a row is its first ``SERIES_LENGTH``
    logits and its value ``next_tokens[row, t]``, T = next_tokens.shape[1].
    Only those logits are kept. Returns ((R*T, 256) float32 states on the
    model's device, (R*T,) int64 values on the host).
    """
    dev = model.device
    rows, keep = next_tokens.shape
    chunk = chunk or rows
    vecs = torch.empty((rows * keep, SERIES_LENGTH), dtype=torch.float32,
                       device=dev)
    for r in range(0, rows, chunk):
        tk = torch.from_numpy(np.asarray(tokens[r:r + chunk], np.int64))
        logits, _, _ = model.apply({"tokens": tk.to(dev)})
        vecs[r * keep:(r + tk.shape[0]) * keep] = logits[
            :, :keep, :SERIES_LENGTH].reshape(-1, SERIES_LENGTH)
        del logits
    return vecs, np.asarray(next_tokens, np.int64).reshape(-1)


def generate(model: Model, svc: IngestingRouter, values: np.ndarray,
             prompts: torch.Tensor, *, steps: int, lam: float,
             compact_every: int = 4,
             observe: Optional[Callable] = None,
             times: Optional[dict] = None):
    """The kNN-LM decode loop over a live datastore.

    ``svc`` routes over the states whose next tokens are ``values``;
    ``prompts`` (B, P) on the model's device. Each step submits B queries
    (host rows), drains the router, mixes the retrieval distribution into
    the LM's, takes the argmax, appends the B states (a tensor on the
    model's device) and their tokens, and folds the deltas once
    ``compact_every`` have built up. ``observe(step, states, dists,
    positions)`` sees each step's answers before the append; ``times``
    collects seconds a phase (``prefill``, ``decode``, ``retrieve``,
    ``mix``, ``append``, ``compact``). Returns ((B, P + steps) tokens,
    the grown values, compactions).
    """
    dev = model.device
    vocab = model.cfg.vocab_size
    bsz, plen = prompts.shape

    def timed(name, t0):
        t1 = _clock(dev)
        if times is not None:
            times.setdefault(name, []).append(t1 - t0)
        return t1

    t = _clock(dev)
    logits, cache = model.prefill({"tokens": prompts})
    cache = pad_cache_to(cache, plen + steps)
    last = logits[:, -1]  # (B, vocab)
    t = timed("prefill", t)
    outs = [prompts.cpu().numpy()]
    compactions = 0
    for i in range(steps):
        states = last[:, :SERIES_LENGTH].float().contiguous()
        host = states.cpu().numpy()  # one retrieval query a sequence
        futs = [svc.submit(host[b]) for b in range(bsz)]
        svc.drain()  # answers every shard's queued batch at the barrier
        res = [f.result() for f in futs]
        dists = np.stack([d for d, _ in res])
        pos = np.stack([p for _, p in res])
        t = timed("retrieve", t)
        if observe is not None:
            observe(i, states, dists, pos)
            t = _clock(dev)
        toks = torch.from_numpy(values[pos]).to(dev)  # (B, k)
        mix = knn_mix_logits(last, torch.from_numpy(dists).to(dev), toks,
                             vocab, lam)
        nxts = torch.argmax(mix, dim=-1)
        nxt_host = nxts.cpu().numpy()
        outs.append(nxt_host[:, None])
        t = timed("mix", t)
        # memorize-as-you-decode: this step's states become a delta shard
        # (queryable by step i+1) and their tokens extend the values.
        svc.append(states)
        values = np.concatenate([values, nxt_host.astype(values.dtype)])
        t = timed("append", t)
        if svc.mutable.num_deltas >= compact_every:  # fold mid-stream
            svc.compact_now()
            compactions += 1
            t = timed("compact", t)
        if i + 1 < steps:  # the last token needs no decode step
            last, cache = model.decode_step(
                {"tokens": nxts[:, None].to(prompts.dtype)}, cache, plen + i)
            t = timed("decode", t)
    return np.concatenate(outs, axis=1), values, compactions


def run(model: Model, *, bsz: int = 4, steps: int = 8, k: int = 8,
        lam: float = 0.3) -> np.ndarray:
    """The example at its defaults: a 16 x 64-token bigram corpus, a
    datastore of its states, B sequences decoding over 2 base shards.
    Prints what the JAX package's example prints; returns the tokens."""
    dev = model.device
    print("building the hidden-state datastore ...")
    corpus = data_mod.bigram_batch(0, 16, 64, model.cfg.vocab_size)
    tokens = corpus["tokens"]
    vecs, values = datastore(model, tokens, tokens[:, 1:])
    index = build_index(vecs, segments=16, device=dev)
    print(f"indexed {index.num_series} (state, next-token) pairs")

    # Admission control: bounded queues, shed-oldest. Compaction is
    # explicit, so the example is deterministic (compaction_policy=None
    # runs no daemon).
    svc = IngestingRouter(
        index, NUM_SHARDS, k=k, max_batch=bsz, max_wait_ms=50.0,
        round_size=512, max_pending=4 * bsz, policy="shed-oldest",
        compaction_policy=None)
    try:
        prompts = torch.from_numpy(tokens[:bsz, :8].astype(np.int64)).to(dev)
        outs, _, compactions = generate(model, svc, values, prompts,
                                        steps=steps, lam=lam)
        s = svc.stats()
    finally:
        svc.stop()
    for b in range(bsz):
        print(f"seq {b} prompt + generated:", outs[b].tolist())
    ing = s["ingest"]
    print("(retrieval hits informed every step; ParIS+ answered",
          f"{s['answered']} streamed shard requests in",
          f"{s['batches']} batches (avg size {s['batch_size_avg']:.1f},",
          f"avg latency {s['latency_ms_avg']:.1f} ms,",
          f"merge avg {s['merge_ms_avg']:.2f} ms,",
          f"queue depth peak {s['queue_depth_peak']}, shed {s['shed']})",
          f"over a live datastore that grew {index.num_series} ->",
          f"{svc.num_series} vectors across {ing['appends']} appends,",
          f"{compactions} compactions ({s['retired_shards']} shards",
          "retired) — every answer exact at its point in the stream)")
    return outs


def main(argv=None) -> np.ndarray:
    """Granite's smoke config at d_model 64, vocab 512, float32."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = dataclasses.replace(configs.get_smoke_config("granite-34b"),
                              d_model=64, vocab_size=512, dtype="float32")
    model = Model(cfg, device=dev,
                  generator=torch.Generator(dev).manual_seed(args.seed))
    return run(model)


if __name__ == "__main__":
    main()
