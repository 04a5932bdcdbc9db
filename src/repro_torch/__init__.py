"""PyTorch/CUDA port of ColA's serving and training paths (the JAX package
``repro`` is the reference). Plain tensor code is PyTorch; every Pallas TPU
kernel on the ported paths is a hand-written CUDA kernel for Hopper
(``kernels/csrc``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
CPU the kernel wrappers take their plain PyTorch versions.
"""
