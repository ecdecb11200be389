"""Workload configurations of the port (the JAX package's ``configs`` for
the index; the LM configurations have no counterpart yet)."""
