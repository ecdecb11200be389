"""Deployment kinds, one module a kind, named by a configuration's
``"deployment"``. Each has ``deploy(cfg, raw, device)``, which builds the
program over the (N, n) raw series and returns a handle with ``close``."""
