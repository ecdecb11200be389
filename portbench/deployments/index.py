"""Deployment ``index``: one ParIS+ index over the whole collection on one
device, built by ``repro_torch.core.index.build_index`` (the z-normed copy
of the series, the ``paa_isax`` kernel, the leaf-order sort)."""

from __future__ import annotations

from repro_torch.core import index as paris_index


class Handle:
    """The built index; ``close`` frees it."""

    def __init__(self, index):
        self.index = index

    def stats(self) -> dict:
        """No counters of its own."""
        return {}

    def close(self) -> None:
        """Drop the index (its series and SAX words)."""
        self.index = None


def deploy(cfg: dict, raw, device) -> Handle:
    """Build the index of the (N, n) raw series ``raw`` on ``device``."""
    return Handle(paris_index.build_index(
        raw, segments=int(cfg["segments"]),
        cardinality=int(cfg["cardinality"]), device=device))
