"""Entry-point helpers of the port (the JAX package's ``launch``): so far
the lattice search of the kernel autotuner."""
