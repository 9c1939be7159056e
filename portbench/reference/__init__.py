"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy only: nothing here imports the program under test
(``pnp_svrg_tpu_torch``), JAX or the JAX package. Each module is a frozen copy
of the arithmetic a configuration states (the problems' gradients, the
wavelet noise estimate, BM3D's plain path, the DnCNN forward pass, the
loops' updates), so that a later change to the program is held to what the
program computed when the benchmark was written.

Every function takes ``tf32``: False is the reference (float32 with TF32
off, float64 where a module says so), True the control, the same arithmetic
one precision step lower (TF32 products, FFT inputs rounded to TF32).
"""
