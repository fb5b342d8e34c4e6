"""PyTorch/CUDA port of the Bertha reconfigurable network stack.

The JAX package ``repro`` is the reference; this package imports neither it
nor ``jax``. See ``repro_torch.backend`` for the device choice and the build
of the Hopper kernels.
"""
