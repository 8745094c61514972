"""The port's field engine: plain torch versions and hand-written CUDA
kernels for Hopper (csrc/), one thread per lane with the whole loop of a
pairing or subgroup check inside the kernel, as on the TPU."""
