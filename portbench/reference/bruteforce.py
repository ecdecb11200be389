"""Exact k-NN by brute force: a z-norm of its own and direct differences.

The plain reference of the ParIS+ configurations. It reads the collection
as chunks of raw series (made again from the seed by ``datagen``), z-norms
each series with the population standard deviation plus 1e-8 (the
configurations' stated z-norm), and takes squared Euclidean distances by
direct differences, ``rows`` series at a time, in float32 with TF32 off.
It imports nothing of the program and takes nothing the program made.

With ``dtype=torch.bfloat16`` the same code is the control: the reference
computed one precision below the configuration's float32.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def znorm(x: torch.Tensor) -> torch.Tensor:
    """Z-normalise each row: population standard deviation plus ``EPS``."""
    x = x.float()
    c = x - x.mean(dim=-1, keepdim=True)
    sd = c.square().mean(dim=-1, keepdim=True).sqrt()
    return c / (sd + EPS)


def _dist(x: torch.Tensor, q: torch.Tensor, dtype) -> torch.Tensor:
    """(Q, m) squared distances of (m, n) rows to (Q, n) queries."""
    x, q = x.to(dtype), q.to(dtype)
    return (x[None, :, :] - q[:, None, :]).square().sum(dim=-1).float()


def knn(chunks, queries: torch.Tensor, k: int, *, probe=None,
        dtype=torch.float32, rows: int = 8192) -> tuple:
    """Exact k-NN of raw ``queries`` over the raw series of ``chunks``.

    ``chunks`` yields (start row, (m, n) raw series) in file order.
    Returns ((Q, k) squared distances ascending, (Q, k) int64 positions,
    and, for a (Q, P) int64 ``probe`` of positions, the (Q, P) distance of
    each probed series to its query, always in float32: inf where the
    position is not in the collection). Distances are float32 whatever
    ``dtype`` computes them.
    """
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = queries.device
        qz = znorm(queries)
        n_q = qz.shape[0]
        best_d = torch.full((n_q, k), float("inf"), device=dev)
        best_p = torch.full((n_q, k), -1, dtype=torch.int64, device=dev)
        probe_d = None
        if probe is not None:
            probe = probe.to(device=dev, dtype=torch.int64)
            probe_d = torch.full(probe.shape, float("inf"), device=dev)
        for start, chunk in chunks:
            z = znorm(chunk.to(dev))
            for s in range(0, z.shape[0], rows):
                x = z[s:s + rows]
                lo = start + s
                d = _dist(x, qz, dtype)
                m = min(k, d.shape[1])
                cd, cj = torch.topk(d, m, dim=1, largest=False, sorted=True)
                md = torch.cat([best_d, cd], dim=1)
                mp = torch.cat([best_p, cj + lo], dim=1)
                vals, sel = torch.sort(md, dim=1, stable=True)
                best_d, best_p = vals[:, :k], mp.gather(1, sel[:, :k])
            if probe_d is not None:
                qi, pj = ((probe >= start) & (probe < start + z.shape[0])
                          ).nonzero(as_tuple=True)
                r = z[probe[qi, pj] - start]
                probe_d[qi, pj] = (r - qz[qi]).square().sum(dim=-1)
        return best_d, best_p, probe_d
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
