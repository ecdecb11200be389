"""The benchmark of ``repro_torch`` on NVIDIA cards (``run.py`` runs one cell).

It imports torch, numpy and the port; never JAX or the JAX package.
"""
