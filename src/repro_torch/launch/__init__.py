"""Entry points of the port (the JAX package's ``launch``): the lattice
search of the kernel autotuner (``hillclimb``) and the decode-serving
launcher (``python -m repro_torch.launch.serve``)."""
