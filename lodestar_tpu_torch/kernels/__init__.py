"""The port's field engine: plain torch versions and hand-written CUDA
kernels for Hopper (csrc/), the whole loop of a pairing or subgroup
check inside the kernel, as on the TPU: one thread per lane, or one warp
per lane for the Miller loop and the final exponentiation."""
