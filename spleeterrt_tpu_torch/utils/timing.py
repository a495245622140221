"""Tracing / profiling utilities.

The reference's observability is wall/CPU-clock printf timing
(Executable/main.c:21-52, :772-965) and a disabled PNG spectrogram dumper
(VST/Source/Spleeter4Stems.c:218-256). The reference package's
spleeterrt_tpu/utils/timing.py, kept as the port's own copy: stage timers
that wait for the card before they read the clock, a `torch.profiler`
trace scope, and spectrogram dumps to PNG in pure NumPy.
"""

from __future__ import annotations

import contextlib
import os
import struct
import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch


def _cuda_devices(tree) -> set[torch.device]:
    """The CUDA devices of the tensors in a tree of tensors (dicts, lists,
    tuples)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return set()
    return set().union(*map(_cuda_devices, tree))


def _host(x) -> np.ndarray:
    """An array, or a tensor on the host (bf16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


@dataclass
class StageTimer:
    """Named stage wall-clock timing with device sync, printf-style report."""

    stages: dict[str, float] = field(default_factory=dict)
    verbose: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, sync: object = None):
        """Time the body; where `sync` is a CUDA tensor or a tree of them,
        wait for each of their devices before reading the clock, so the
        stage holds the work it queued there."""
        devices = _cuda_devices(sync)
        t0 = time.perf_counter()
        yield
        for dev in devices:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        if self.verbose:
            print(f"{name} takes {dt:.6f} sec")

    def report(self) -> dict[str, float]:
        return dict(self.stages)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(log_dir: str | os.PathLike | None):
    """Scoped torch.profiler trace written as a chrome trace to
    `log_dir`/trace.json: CPU activity always, CUDA activity where a card
    is present; a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def write_gray_png(path: str, img) -> None:
    """Minimal 8-bit grayscale PNG writer (no deps); `img` is an array or a
    tensor of shape (h, w)."""
    img = _host(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def dump_spectrogram_pngs(x, folder: str, lin_gain: float = 10.0) -> list[str]:
    """Per-channel magnitude/mask plane dumps, the debug instrument of
    `writeNChannelsImg2Folder` (VST/Source/Spleeter4Stems.c:220-256); `x`
    is an array or a tensor of shape (channels, h, w)."""
    os.makedirs(folder, exist_ok=True)
    x = _host(x)
    paths = []
    for s in range(x.shape[0]):
        img = np.abs(x[s]) * lin_gain
        p = f"{folder}/{s}.png"
        write_gray_png(p, img)
        paths.append(p)
    return paths
