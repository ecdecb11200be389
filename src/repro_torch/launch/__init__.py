"""Entry points of the port (the JAX package's ``launch``): the lattice
search of the kernel autotuner (``hillclimb``), the mesh builder
(``mesh``), the decode-serving launcher (``python -m
repro_torch.launch.serve``) and the training launcher (``python -m
repro_torch.launch.train``)."""
