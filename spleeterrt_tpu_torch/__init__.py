"""SpleeterRT in PyTorch for one NVIDIA H100.

A port of the JAX package `spleeterrt_tpu` (which stays the reference it is
tested against): 4-stem offline Spleeter U-Net separation at 44.1 kHz, with
the transform's two fused kernels written by hand in CUDA C++ for Hopper
(`csrc/`, built with nvcc at first use) and the U-Net in plain
`torch.nn.functional` convolutions. The package imports torch and numpy,
never jax.
"""

from spleeterrt_tpu_torch.config import SeparatorConfig, TransformConfig
from spleeterrt_tpu_torch.core import model, separate, transform, weights

__version__ = "0.1.0"

__all__ = [
    "SeparatorConfig",
    "TransformConfig",
    "transform",
    "model",
    "separate",
    "weights",
]
