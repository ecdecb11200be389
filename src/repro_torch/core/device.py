"""Where the port runs: an explicit device, never a silent fallback.

The entry points take ``device="cuda"`` by default. A CUDA request on a
machine without a card raises here instead of running on the CPU; the CPU
runs only when the caller asks for it (``device="cpu"``, as the tests do).
The one exception is a ``FakeTensorMode`` (``launch/dryrun.py``): while one
is active nothing can allocate or run, so ``"cuda"`` resolves to
``cuda:0`` without a card and the trace takes the card's path.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """Validate a user's device argument and return it as a ``torch.device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            if fake_mode_active():
                return dev if dev.index is not None else torch.device(
                    "cuda", 0)
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions on the "
                "CPU")
        if dev.index is None:  # "cuda" -> "cuda:<current>", as tensors report
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: 'cuda' or 'cpu'")
    return dev


def fake_mode_active() -> bool:
    """Whether a ``FakeTensorMode`` is active (tensors are fake: nothing
    allocates or runs)."""
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


def as_f32(x, device: torch.device) -> torch.Tensor:
    """Host data (numpy, lists) or a tensor already on ``device`` -> float32.

    A tensor on another device raises: moving it would make one device
    quietly stand in for the other.
    """
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(
                f"tensor on {x.device} passed to an index on {device}")
        return x.to(torch.float32)
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
