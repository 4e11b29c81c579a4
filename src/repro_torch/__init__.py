"""PyTorch/CUDA port of the bridge, one slice at a time.

The JAX package ``repro`` is the reference; this package imports neither it
nor ``jax``.  Module names mirror the reference so each counterpart is easy
to find.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; kernels in :mod:`repro_torch.kernels` launch hand-written
CUDA on CUDA tensors and run their plain PyTorch versions on CPU tensors.
"""
