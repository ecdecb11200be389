"""Wrapper of the hand-written selection kernels (``csrc/select.cu``).

:func:`smallest_cuda` gives the k smallest bounds of each row of a (Q, L)
float32 tensor, ascending, ties toward the lower column: ((Q, k) int32
columns, (Q, k) float32 bounds), bit for bit what ``ref.smallest`` (the
int64-key ``torch.topk``) gives. It replaces no TPU kernel: the reference
selects with ``jax.lax.top_k``. The source's note gives the design: a radix
select on the bounds' own 32 bits, one stable compaction in column order
and a stable LSD radix sort of the k pairs. It takes no launch knob and
reads nothing back to the host: every kernel's size follows from (Q, L, k).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# One launch set (every kernel of one call) since the caller last set it to 0.
launches = _build.LaunchCounter()

MAX_ROWS = 65535  # one grid row per bound row


def smallest_cuda(lb: torch.Tensor, k: int) -> tuple:
    """(Q, L) f32 bounds on the card -> ((Q, k) int32 columns, (Q, k) f32)."""
    _build.require(lb, "lb", torch.float32, 2)
    n_q, n = lb.shape
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    if n_q > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got {n_q}")
    if n > 2 ** 31 - 1:
        raise ValueError(f"at most 2**31 - 1 columns (int32), got {n}")
    cols = torch.empty((n_q, k), dtype=torch.int32, device=lb.device)
    bounds = torch.empty((n_q, k), dtype=torch.float32, device=lb.device)
    if n_q == 0:
        return cols, bounds
    lib = _build.load()
    words = lib.smallest_scratch_words(n_q, n, k)
    scratch = torch.empty((words,), dtype=torch.int32, device=lb.device)
    err = lib.smallest_launch(lb.data_ptr(), cols.data_ptr(),
                              bounds.data_ptr(), scratch.data_ptr(), words,
                              n_q, n, k, _build.stream_of(lb))
    _build.check(err, "smallest")
    launches.add()
    return cols, bounds
