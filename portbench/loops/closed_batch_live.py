"""Loop ``closed_batch_live``: ``closed_batch``'s closed loop (one client,
batches of ``batch`` queries back to back, each after the last was
answered) through the live store's ``MutableIndex.exact_knn_batch``.

``warm`` and ``run`` are ``closed_batch``'s own functions with the module's
``_call`` bound to the store's, so the two loops time a batch the same way
and the only difference between their cells is what answers. The first
warm-up batch builds the store's packed view, in set-up.

End to end: ``queries_per_s``, as ``closed_batch``. Counters:
``closed_batch``'s, and the store's (``MutableIndex.stats``) where the
program has them: ``num_series``, ``live_components``, ``packed_rows``
(N_pad of the packed view) and ``fused_calls`` (the window's calls down
the fused path).
"""

from __future__ import annotations

import types

from portbench.loops import Outcome, closed_batch


def _call(handle, cfg, traffic, qs):
    return handle.store.exact_knn_batch(
        qs, k=int(traffic["k"]), round_size=int(cfg["round_size"]),
        stats=True)


def _bound(fn):
    """``closed_batch``'s ``fn`` calling this module's ``_call``."""
    return types.FunctionType(
        fn.__code__, dict(vars(closed_batch), _call=_call), fn.__name__,
        fn.__defaults__, fn.__closure__)


warm = _bound(closed_batch.warm)
_run = _bound(closed_batch.run)


def run(handle, cfg, traffic, queries, seconds, seed, tracer) -> Outcome:
    """``closed_batch``'s window, then the store's counters."""
    before = handle.stats()
    out = _run(handle, cfg, traffic, queries, seconds, seed, tracer)
    after = handle.stats()
    out.counters.update({key: after[key] for key in (
        "num_series", "live_components", "packed_rows") if key in after})
    if "fused_calls" in after:
        out.counters["fused_calls"] = (after["fused_calls"]
                                       - before["fused_calls"])
    return out
