"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors the JAX package's layout (``core/``, ``configs/``, ``kernels/``,
``nn/``, ``launch/``) so each module has an obvious counterpart. It imports
torch, numpy and the standard library only; it never imports jax or repro.
The hand-written CUDA kernels live in ``csrc/`` and are built with nvcc at
first use (``kernels/build.py``).
"""
