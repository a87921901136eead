"""PyTorch/CUDA port of the periodic-asynchrony RL system, beside the JAX
reference package ``repro``.

The layout and module names follow ``src/repro/`` so each module's
counterpart is easy to find. This package imports ``torch``, numpy and the
standard library only; it never imports ``jax`` or anything of ``repro``.
Every attention kernel the TPU package wrote in Pallas is a CUDA kernel
written by hand for Hopper (``kernels/csrc/``), chosen by the tensor's
device: a CUDA tensor launches the kernel, a CPU tensor takes the kernel's
plain PyTorch version.
"""
