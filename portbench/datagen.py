"""The inputs of every cell, made from ``--seed``: the collection, the
queries and the sample of answers that is judged.

``walk_chunks`` is a frozen copy of ``chip_smoke.walk_chunks``: random walks
(cumulative sums of N(0, 1) steps) made on the device ``WALK_CHUNK`` series
at a time by one generator. The reference makes the same series again,
chunk by chunk, from the same seed, so it needs nothing the program made.

Each input has a stream of its own, so the queries do not depend on how the
collection was drawn. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

WALK_CHUNK = 1 << 20  # series made per generator call

# One random stream per kind of input (a second word of the seed). The
# numbers are fixed: a run's inputs depend on them.
COLLECTION, QUERIES, SAMPLE = 0, 1, 3


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of ``seed``; any whole ``seed`` >= 0."""
    words = np.random.SeedSequence([int(seed), stream]).generate_state(2)
    return int((int(words[0]) << 31) ^ int(words[1])) & ((1 << 63) - 1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one stream of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one stream of ``seed`` (host-side choices)."""
    return np.random.default_rng(stream_seed(seed, stream))


def walk_chunks(num: int, n: int, gen, device):
    """Random walks made on ``device``, ``WALK_CHUNK`` series at a time:
    yields (start, (rows, n) tensor)."""
    for s in range(0, num, WALK_CHUNK):
        e = min(s + WALK_CHUNK, num)
        yield s, torch.randn((e - s, n), generator=gen,
                             device=device).cumsum_(dim=1)


def collection_chunks(num: int, n: int, seed: int, device):
    """The collection of ``seed``, chunk by chunk (see ``walk_chunks``)."""
    return walk_chunks(num, n, generator(seed, COLLECTION, device), device)


def collection(num: int, n: int, seed: int, device) -> torch.Tensor:
    """The whole (num, n) float32 collection of ``seed`` on ``device``."""
    out = torch.empty((num, n), dtype=torch.float32, device=device)
    for s, chunk in collection_chunks(num, n, seed, device):
        out[s:s + chunk.shape[0]] = chunk
    return out


def noisy_member_queries(count: int, n: int, gen, device, raw=None,
                         noise: float = 0.1, **_) -> torch.Tensor:
    """Collection series picked by ``gen``, plus pointwise Gaussian noise
    of standard deviation ``noise`` times that series' own: queries of
    controlled hardness (Zoumpatianos et al., VLDB J. 2018)."""
    idx = torch.randint(0, raw.shape[0], (count,), generator=gen,
                        device=device)
    base = raw[idx]
    sd = base.std(dim=1, unbiased=False, keepdim=True)
    eps = torch.randn((count, n), generator=gen, device=device)
    return base + noise * sd * eps


QUERY_KINDS = {"noisy_member": noisy_member_queries}


def queries(traffic: dict, n: int, seed: int, device, raw=None
            ) -> torch.Tensor:
    """The (pool, n) float32 queries of one traffic mix and ``seed``."""
    make = QUERY_KINDS[traffic["queries"]]
    extra = {k: traffic[k] for k in ("noise",) if k in traffic}
    return make(int(traffic["pool"]), n, generator(seed, QUERIES, device),
                device, raw=raw, **extra).contiguous()


def sample(count: int, size: int, seed: int) -> np.ndarray:
    """``size`` of ``count`` request indices, drawn from ``seed``, sorted."""
    size = min(int(size), int(count))
    return np.sort(rng(seed, SAMPLE).choice(count, size=size, replace=False))
