"""Matrix-function numerics kernels (L1 of the stack).

Everything here is pure jax.numpy/lax and jit/vmap-safe.
"""
