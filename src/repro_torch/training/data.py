"""Token data pipeline with double-buffered host prefetch (the port of
the JAX package's ``training/data.py``).

The sources are numpy only, so their arrays equal JAX's for the same
arguments: ``synthetic_batch`` is uniform-random tokens, deterministic per
step (elastic restarts replay exactly); ``bigram_batch`` follows a fixed
random bigram (Markov) chain, so the stream has low conditional entropy
(training loss visibly drops; the kNN-LM example and the card's LM phase
index (state, next token) pairs over it); ``memmap_batch_fn`` reads
windows of a token file.

:class:`PrefetchingLoader` mirrors the paper's Stage-1 coordinator: a
daemon thread assembles batch k+1 on the host, into a 2-deep queue, while
the device runs step k; each batch is pinned and copied to the device
without blocking the host (on a card).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np
import torch

from repro_torch.core.device import resolve_device

JOIN_TIMEOUT_S = 10.0  # PrefetchingLoader.close's wait for its thread


def synthetic_batch(step: int, batch: int, seq: int, vocab: int,
                    seed: int = 0):
    """Deterministic synthetic LM batch for step N (replayable)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    tokens = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def bigram_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0):
    """Learnable synthetic LM data: a fixed random bigram (Markov) chain."""
    master = np.random.default_rng(seed)
    # each token deterministically maps to a small candidate set
    nexts = master.integers(0, vocab, (vocab, 4))
    rng = np.random.default_rng(np.uint64(seed * 999_983 + step + 1))
    tok = np.empty((batch, seq + 1), np.int32)
    tok[:, 0] = rng.integers(0, vocab, batch)
    choices = rng.integers(0, 4, (batch, seq))
    for t in range(seq):
        tok[:, t + 1] = nexts[tok[:, t], choices[:, t]]
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def memmap_batch_fn(path: str, seq: int, vocab: int):
    """A batch function over a flat int32 token file: each row a window of
    ``seq_len + 1`` tokens at a random multiple of ``seq_len``."""
    data = np.memmap(path, np.int32, "r")

    def fn(step: int, batch: int, seq_len: int, _vocab: int, seed: int = 0):
        n = (len(data) - 1) // seq_len
        rng = np.random.default_rng(np.uint64(seed * 7 + step))
        idx = rng.integers(0, n, (batch,))
        tok = np.stack([data[i * seq_len: i * seq_len + seq_len + 1]
                        for i in idx])
        return {"tokens": tok[:, :-1].astype(np.int32),
                "labels": tok[:, 1:].astype(np.int32)}

    return fn


class PrefetchingLoader:
    """2-deep prefetch queue (the double buffer) feeding ``device``.

    A daemon thread calls ``batch_fn(step, batch, seq, vocab, seed)`` for
    ``start_step``, ``start_step + 1``, ... and queues each host batch
    (pinned when ``device`` is a card). ``next(loader)`` returns ``(step,
    batch)`` with the arrays as tensors on ``device``; ``close()`` stops
    the thread and joins it.
    """

    def __init__(self, batch_fn: Callable, batch: int, seq: int, vocab: int,
                 *, start_step: int = 0, seed: int = 0, depth: int = 2,
                 device="cuda"):
        self.batch_fn = batch_fn
        self.args = (batch, seq, vocab)
        self.seed = seed
        self.device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self._step
        pin = self.device.type == "cuda"
        while not self._stop.is_set():
            try:
                host = {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in self.batch_fn(step, *self.args,
                                                  self.seed).items()}
                if pin:
                    host = {k: v.pin_memory() for k, v in host.items()}
            except Exception as exc:  # handed to the consumer, who raises
                host = exc
            while not self._stop.is_set():
                try:
                    self._q.put((step, host), timeout=0.5)
                    step += 1
                    break
                except queue.Full:
                    continue
            if isinstance(host, Exception):
                return

    def __next__(self):
        step, host = self._q.get()
        if isinstance(host, Exception):
            raise RuntimeError(f"batch {step} failed") from host
        return step, {k: v.to(self.device, non_blocking=True)
                      for k, v in host.items()}

    def close(self):
        """Stop the filling thread and wait for it (at most
        ``JOIN_TIMEOUT_S``: a batch function that hangs is not waited on
        forever)."""
        self._stop.set()
        self._thread.join(JOIN_TIMEOUT_S)
