"""Host-side request batcher for decode serving.

The port of ``repro/serving/batcher.py``. Fixed-slot continuous batching:
the decode step always runs at batch B; the batcher multiplexes live
requests onto slots. A slot frees when its request emits EOS or hits
max_new. Per-slot positions ride on the model's positions array and a
(B,) cache write index, so each slot decodes at its own offset while
sharing one step.

This mirrors the paper's RDC-worker fetch&add: a shared queue hands work
(requests) to fixed workers (slots) so all finish "at about the same time".
"""

from __future__ import annotations

import dataclasses
import queue
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import Model
from repro_torch.serving.kv_cache import pad_cache_to
from repro_torch.serving.util import pow2_bucket


@dataclasses.dataclass
class Request:
    """One decode request: prompt tokens + generation limits."""
    rid: int
    prompt: np.ndarray  # (P,) int
    max_new: int = 32
    eos_id: int = -1  # -1: never
    out: Optional[np.ndarray] = None


class SlotBatcher:
    """Decode-side batcher: requests -> slots of one decode step."""

    def __init__(self, model: Model, batch_size: int, max_len: int):
        self.model = model
        self.B = batch_size
        self.max_len = max_len
        self.cache = model.init_cache(batch_size, max_len)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.slot_pos = np.zeros(batch_size, np.int64)  # next write index
        self.slot_tok = np.zeros(batch_size, np.int64)
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.done: Dict[int, np.ndarray] = {}

    def _step(self, tokens, positions):
        """One token a slot at per-slot positions; returns the argmax."""
        pos = positions[:, None]
        if self.model.cfg.mrope_sections is not None:
            pos = pos[..., None].expand(*pos.shape, 3)
        logits, self.cache, _ = self.model.apply(
            {"tokens": tokens, "positions": pos}, self.cache, positions)
        return torch.argmax(logits[:, -1], dim=-1)

    def submit(self, req: Request):
        """Enqueue one request for the next admission scan."""
        self.queue.put(req)

    def _admit(self):
        dev = self.model.device
        for i in range(self.B):
            if self.slots[i] is None and not self.queue.empty():
                req = self.queue.get()
                plen = len(req.prompt)
                tokens = np.asarray(req.prompt, np.int64)[None]
                # Pad the prompt to a power-of-two bucket. Causal attention
                # makes the position-(plen-1) logits and the cache rows
                # [0, plen) independent of the right pads (pad K/V rows sit
                # at positions the decode mask never attends). Recurrent
                # models (rwkv / block_pattern) fold every token into their
                # state, so they prefill unpadded.
                cfg = self.model.cfg
                if not (cfg.rwkv or cfg.block_pattern):
                    bucket = min(pow2_bucket(plen), self.max_len)
                    if bucket > plen:
                        tokens = np.pad(tokens, ((0, 0), (0, bucket - plen)))
                logits, cache1 = self.model.prefill(
                    {"tokens": torch.from_numpy(tokens).to(dev)})
                self._copy_slot(pad_cache_to(cache1, self.max_len), i)
                self.slots[i] = req
                self.slot_pos[i] = plen
                last = int(torch.argmax(logits[0, plen - 1]))
                self.slot_tok[i] = last
                req.out = np.concatenate([np.asarray(req.prompt, np.int32),
                                          np.asarray([last], np.int32)])

    def _copy_slot(self, cache1, slot: int):
        """Copy a 1-batch cache into slot ``slot`` of the big cache (in
        place: the batcher owns its cache)."""
        def walk(big, small):
            if isinstance(big, dict):
                for k in big:
                    walk(big[k], small[k])
                return
            bax = _batch_axis(big.dim(), small.shape, big.shape)
            big.narrow(bax, slot, 1).copy_(small.to(big.dtype))

        walk(self.cache, cache1)

    def run(self, steps: int):
        """Drive up to ``steps`` decode iterations.

        Returns the requests that finished since the last ``run`` call,
        draining them from the batcher — each request is reported exactly
        once.
        """
        dev = self.model.device
        for _ in range(steps):
            self._admit()
            live = [i for i in range(self.B) if self.slots[i] is not None]
            if not live:
                break
            tokens = torch.from_numpy(self.slot_tok[:, None].copy()).to(dev)
            positions = torch.from_numpy(self.slot_pos.copy()).to(dev)
            nxt = self._step(tokens, positions).cpu().numpy()
            for i in live:
                req = self.slots[i]
                tok = int(nxt[i])
                req.out = np.concatenate(
                    [req.out, np.asarray([tok], np.int32)])
                self.slot_pos[i] += 1
                self.slot_tok[i] = tok
                done_len = len(req.out) - len(req.prompt)
                if tok == req.eos_id or done_len >= req.max_new or \
                        self.slot_pos[i] >= self.max_len - 1:
                    self.done[req.rid] = req.out
                    self.slots[i] = None
        finished, self.done = self.done, {}
        return finished


def _batch_axis(ndim: int, small_shape, big_shape) -> int:
    """Find the axis where small=1 and big=B (the batch axis)."""
    for ax in range(ndim):
        if small_shape[ax] == 1 and big_shape[ax] != small_shape[ax]:
            return ax
    # batch == 1 server: first axis whose small==big==1 after stacks
    for ax in range(ndim):
        if small_shape[ax] == 1:
            return ax
    raise ValueError(f"no batch axis in {small_shape} vs {big_shape}")
