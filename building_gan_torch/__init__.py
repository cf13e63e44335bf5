"""PyTorch / CUDA port of the Building-GAN framework, for one NVIDIA H100.

The package mirrors the module names of ``building_gan_tpu`` (the JAX
reference, kept beside it) and imports only ``torch``, ``numpy`` and the
standard library.  Plain tensor code is PyTorch; the hourglass forward runs
through a hand-written CUDA kernel (``csrc/hourglass.cu``) on CUDA tensors
and through its plain PyTorch version on CPU tensors.
"""

from .config import COLORS, NUM_CLASSES, PROGRAM_NAMES, Configuration

__version__ = "0.1.0"
