"""Small shared serving helpers.

``pow2_bucket`` lives in :mod:`repro_torch.core.search` (the engine factory
pads batch shapes itself); it is re-exported here for serving callers.
"""

from __future__ import annotations

from repro_torch.core.search import pow2_bucket

__all__ = ["pow2_bucket"]
