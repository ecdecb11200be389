"""Architecture zoo of the port: config-driven models over shared torch
layers (the JAX package's ``repro.models``)."""

from repro_torch.models.model import Model

__all__ = ["Model"]
