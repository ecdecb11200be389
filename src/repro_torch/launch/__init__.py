"""Entry points of the port (the JAX package's ``launch``): the mesh
builder (``mesh``), the decode-serving launcher (``python -m
repro_torch.launch.serve``), the training launcher (``python -m
repro_torch.launch.train``), the cell builder (``specs``), the dry-run
over fake ranks (``python -m repro_torch.launch.dryrun``) with its fake
CUDA stand-in for CPU-only PyTorch (``fake_cuda``), the H100 roofline
(``roofline``), and the kernel autotuner's lattice search with the
dry-run variant sweep (``hillclimb``, ``python -m
repro_torch.launch.hillclimb``)."""
