"""The benchmark of the PyTorch/CUDA port ``pnp_svrg_tpu_torch`` (see README.md)."""
