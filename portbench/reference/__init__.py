"""The plain float32 reference that decides `correct`: the U-Net
(`unet`), offline separation (`offline`) and the streaming engine
(`stream`), in PyTorch with TF32 off (`fp32_exact`). It imports nothing of
the program under test and takes nothing the program made: the benchmark
hands both sides the same audio and weights."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN convolutions and matrix products inside."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
