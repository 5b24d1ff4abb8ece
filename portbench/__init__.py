"""The benchmark of the PyTorch / CUDA port (``ganleaks_tpu_torch``):
see ``README.md``."""
