"""Serving steps: prefill and single-token decode, plus greedy generation.

The port of ``repro/serving/serve_step.py``. PyTorch runs eagerly, so the
steps are the model's own calls; ``make_prefill_step`` and
``make_decode_step`` keep the JAX package's entry names and signatures
(less the parameters, which the model owns).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import Model
from repro_torch.serving.kv_cache import pad_cache_to


def make_prefill_step(model: Model):
    """Wrap ``model.prefill`` as a batch -> (last logits, cache) step."""
    def prefill_step(batch):
        logits, cache = model.prefill(batch)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(model: Model):
    """Wrap ``model.decode_step`` as a single-token decode step."""
    def decode_step(batch, cache, position):
        """batch: {"tokens": (B, 1)}; position: scalar int (cache write
        index; same for all rows of the batch)."""
        return model.decode_step(batch, cache, position)

    return decode_step


def greedy_generate(model: Model, prompt_tokens: torch.Tensor,
                    max_new: int = 16, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Host-side loop: prefill the prompt, then decode max_new tokens.

    ``prompt_tokens`` (B, P) on the model's device. With ``temperature >
    0`` and a ``generator`` each token is sampled from
    softmax(logits / temperature); otherwise it is the argmax (first
    maximum). Returns (B, P + max_new) tokens.
    """
    bsz, plen = prompt_tokens.shape
    logits, cache = model.prefill({"tokens": prompt_tokens})
    cache = pad_cache_to(cache, plen + max_new)
    out = [prompt_tokens]
    last = logits[:, -1]
    for i in range(max_new):
        if temperature > 0 and generator is not None:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        nxt = nxt[:, None].to(prompt_tokens.dtype)
        out.append(nxt)
        if i + 1 < max_new:  # the last token needs no decode step
            last, cache = model.decode_step({"tokens": nxt}, cache, plen + i)
    return torch.cat(out, dim=1)
