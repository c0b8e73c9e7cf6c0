"""sortbench: the benchmark of the PyTorch and CUDA port (``repro_torch``).

See ``README.md``.  Nothing here imports the JAX package or its harness.
"""
