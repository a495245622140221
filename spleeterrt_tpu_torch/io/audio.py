"""Audio file I/O: a from-scratch RIFF/WAVE codec in NumPy, and FLAC.

Reads PCM 8/16/24/32, IEEE float32/64 and WAVE_FORMAT_EXTENSIBLE; writes
float32 (the reference's stem format, Executable/main.c:812-843).
`WavReader` opens a WAV header-only and decodes frame ranges (the training
dataset's streaming reads). FLAC decodes through io/flac.py. MP3 is not
decoded by this package yet (see ROADMAP.md): it raises
:class:`UnsupportedFormatError` before any device or weight work.
"""

from __future__ import annotations

import io
import os
import struct
from dataclasses import dataclass

import numpy as np

from spleeterrt_tpu_torch.io import flac

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class AudioData:
    samples: np.ndarray  # (channels, n) float32 in [-1, 1]
    sample_rate: int


class UnsupportedFormatError(ValueError):
    """Input format this package cannot decode. Raised before any device
    or weight work so the CLI fails fast with an actionable message."""


def check_decodable(path: str | os.PathLike) -> None:
    """Fail fast unless `path` is a WAV or FLAC file."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".wav", ".flac"):
        return
    raise UnsupportedFormatError(
        f"cannot decode {path}: this package reads WAV and FLAC only so far "
        f"({ext or 'unknown'} decoding is still to be ported, see "
        f"ROADMAP.md). Convert to WAV first, e.g. `ffmpeg -i {path} "
        f"track.wav`."
    )


def read_wav(path: str | os.PathLike | bytes) -> AudioData:
    """Parse a RIFF/WAVE file into float32 (channels, n)."""
    if isinstance(path, (bytes, bytearray)):
        f = io.BytesIO(path)
    else:
        f = open(path, "rb")
    with f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            payload = f.read(csize)
            if csize % 2:
                f.read(1)  # chunks are word-aligned
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
                if fmt is not None:
                    break
        if fmt is None or data is None:
            raise ValueError("missing fmt/data chunk")
        tag, channels, rate, bits = _parse_fmt(fmt, "<wav bytes>")
        x = _decode_pcm(data, tag, bits)
        n = x.size // channels
        samples = x[: n * channels].reshape(n, channels).T
        return AudioData(np.ascontiguousarray(samples), rate)


class WavReader:
    """Seekable WAV handle: header-only open, frame-range reads (the
    reference package's `WavReader`).

    Backs the streaming training dataset (data/dataset.py): tracks are never
    held in RAM; each crop seeks into the data chunk and decodes only the
    requested frames, in every format `read_wav` reads.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        with open(self.path, "rb") as f:
            riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
            if riff != b"RIFF" or wave != b"WAVE":
                raise ValueError(f"not a RIFF/WAVE file: {self.path}")
            fmt = None
            self._data_off = None
            self._data_size = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, csize = struct.unpack("<4sI", hdr)
                if cid == b"fmt ":
                    fmt = f.read(csize)
                    if csize % 2:
                        f.read(1)
                elif cid == b"data":
                    self._data_off = f.tell()
                    self._data_size = csize
                    if fmt is not None:
                        break
                    f.seek(csize + csize % 2, 1)
                else:
                    f.seek(csize + csize % 2, 1)
            if fmt is None or self._data_off is None:
                raise ValueError(f"missing fmt/data chunk: {self.path}")
        tag, channels, rate, bits = _parse_fmt(fmt, self.path)
        if channels < 1:
            raise ValueError(f"unsupported WAV layout (0 channels): {self.path}")
        self.tag, self.channels, self.sample_rate, self.bits = (
            tag, channels, rate, bits,
        )
        self._frame_bytes = channels * (bits // 8)
        self.n_frames = self._data_size // self._frame_bytes

    def read(self, start: int, count: int) -> np.ndarray:
        """Frames [start, start+count) as (channels, count) float32; frames
        out of range read as silence."""
        lo = max(0, min(start, self.n_frames))
        hi = max(0, min(start + count, self.n_frames))
        out = np.zeros((self.channels, count), np.float32)
        if hi > lo:
            with open(self.path, "rb") as f:
                f.seek(self._data_off + lo * self._frame_bytes)
                raw = f.read((hi - lo) * self._frame_bytes)
            x = _decode_pcm(raw, self.tag, self.bits)
            n = x.size // self.channels
            out[:, lo - start : lo - start + n] = (
                x[: n * self.channels].reshape(n, self.channels).T
            )
        return out


# Valid bit depths per format tag; anything else is rejected at header
# parse time instead of decoding garbage.
_VALID_BITS = {
    WAVE_FORMAT_PCM: (8, 16, 24, 32),
    WAVE_FORMAT_IEEE_FLOAT: (32, 64),
}


def _parse_fmt(fmt: bytes, path: str) -> tuple[int, int, int, int]:
    """Validate a fmt chunk -> (tag, channels, rate, bits)."""
    if len(fmt) < 16:
        raise ValueError(f"short fmt chunk: {path}")
    tag, channels, rate, _bps, _align, bits = struct.unpack("<HHIIHH", fmt[:16])
    if tag == WAVE_FORMAT_EXTENSIBLE:
        # Subformat GUID's first two bytes carry the real format tag.
        if len(fmt) < 26:
            raise ValueError(f"short EXTENSIBLE fmt chunk: {path}")
        tag = struct.unpack("<H", fmt[24:26])[0]
    if tag not in _VALID_BITS:
        raise ValueError(f"unsupported WAVE format tag 0x{tag:04x}: {path}")
    if bits not in _VALID_BITS[tag]:
        raise ValueError(
            f"unsupported WAV layout ({bits}-bit, tag 0x{tag:04x}): {path}"
        )
    return tag, channels, rate, bits


def _decode_pcm(data: bytes, tag: int, bits: int) -> np.ndarray:
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        return np.frombuffer(data, dtype=dtype).astype(np.float32)
    if bits == 16:
        return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    if bits == 32:
        return np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    if bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8)
        raw = raw[: raw.size // 3 * 3].reshape(-1, 3)
        val = (
            raw[:, 0].astype(np.int32)
            | (raw[:, 1].astype(np.int32) << 8)
            | (raw[:, 2].astype(np.int32) << 16)
        )
        val = (val << 8) >> 8  # sign extend
        return val.astype(np.float32) / 8388608.0
    return (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0


def write_wav(
    path: str | os.PathLike | io.BufferedIOBase, samples: np.ndarray,
    sample_rate: int = 44100,
) -> None:
    """Write (channels, n) or (n,) samples as 32-bit float, the
    reference's stem format (Executable/main.c:816-823), to a file path or
    a binary stream."""
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 1:
        x = x[None]
    channels, _ = x.shape
    payload = np.ascontiguousarray(x.T).astype("<f4").tobytes()
    tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
    block = channels * bits // 8
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF",
        36 + len(payload),
        b"WAVE",
        b"fmt ",
        16,
        tag,
        channels,
        sample_rate,
        sample_rate * block,
        block,
        bits,
        b"data",
        len(payload),
    )
    if hasattr(path, "write"):
        path.write(hdr + payload)
        return
    with open(path, "wb") as f:
        f.write(hdr + payload)


def load_audio(path: str | os.PathLike) -> AudioData:
    """Decode a WAV or FLAC file; any other format raises
    UnsupportedFormatError."""
    check_decodable(path)
    if os.path.splitext(str(path))[1].lower() == ".flac":
        with open(path, "rb") as f:
            samples, rate = flac.decode_flac(f.read())
        return AudioData(samples, rate)
    return read_wav(path)
