"""SpleeterRT in PyTorch for one NVIDIA H100.

A port of the JAX package `spleeterrt_tpu` (which stays the reference it is
tested against): Spleeter U-Net separation at 44.1 kHz into 2, 3, 4 or 5
stems offline (`cli`, `core.separate`, with batched forms over many
tracks), a chunked executor for long tracks (`runtime.executor`), an HTTP
service (`runtime.server`), the streaming engine (`cli_stream`,
`runtime.stream`), and training (`core.train`, `core.checkpoint`,
`data.dataset`, `examples.train`). Ten kernels written by hand in CUDA C++
for Hopper (`csrc/`, built with nvcc at first use, wrapped in `kernels/`)
replace the JAX package's ten Pallas kernels: the fused STFT, the packed
U-Net's enc1, enc2-enc4, up4, up5 and head, the round-3 head, the masked
iSTFT and the 4096-point inverse FFT, plain and masked. Only the U-Net's
deep trunk (enc5..up3, or enc4..up5 on the round-3 route) and the
canonical route stay torch convolutions, as the JAX package left them to
XLA. The package imports torch and numpy, never jax.
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
