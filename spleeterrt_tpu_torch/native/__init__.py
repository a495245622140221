"""ctypes binding for the native host runtime (audioio.cpp, flacdec.cpp).

The reference package's native runtime (spleeterrt_tpu/native), kept as
the port's own copy: WAV parse and encode, the polyphase resampler,
channel split and join, and FLAC decode, with the same `srt_*` symbols
and entry points. Host code only: no tensor crosses this boundary.

The library builds with g++ at first use into `build/native/` at the root
of the checkout, named by a hash of its sources and flags, so an edited
source builds anew and a stale library is never loaded. g++ writes a
temporary file that is renamed into place, so processes that build at the
same moment (test workers) each load a whole library. Nothing is built at
import time. Every entry point has a pure-NumPy counterpart in
spleeterrt_tpu_torch/io, so the package works without a toolchain:
`get_lib()` returns None where g++ is absent or the build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "audioio.cpp", _HERE / "flacdec.cpp")
BUILD_DIR = _HERE.parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False

u64 = ctypes.c_uint64
i32 = ctypes.c_int32
f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsrt_audioio_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> str | None:
    """Compile the sources into the library unless it exists; returns its
    path, or None where g++ is absent or fails."""
    out = library_path()
    if out.exists() and not force:
        return str(out)
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return None
    try:
        subprocess.run(["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    except (subprocess.CalledProcessError, OSError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(out)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.srt_wav_info.argtypes = [
            u8p, u64, ctypes.POINTER(i32), ctypes.POINTER(i32),
            ctypes.POINTER(i32), ctypes.POINTER(i32), ctypes.POINTER(u64),
            ctypes.POINTER(u64), ctypes.POINTER(u64),
        ]
        lib.srt_wav_info.restype = i32
        lib.srt_wav_decode.argtypes = [u8p, u64, i32, i32, i32, f32p, u64]
        lib.srt_wav_decode.restype = i32
        lib.srt_wav_encode.argtypes = [f32p, i32, u64, i32, u8p]
        lib.srt_wav_encode.restype = i32
        lib.srt_resample.argtypes = [f32p, u64, i32, f64p, i32, i32, i32, f32p, u64]
        lib.srt_resample.restype = i32
        lib.srt_split_channels.argtypes = [f32p, i32, u64, u64, u64, f32p]
        lib.srt_split_channels.restype = None
        lib.srt_join_channels.argtypes = [f32p, i32, u64, u64, u64, f32p]
        lib.srt_join_channels.restype = None
        lib.srt_version.argtypes = []
        lib.srt_version.restype = ctypes.c_char_p
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.srt_flac_info.argtypes = [
            u8p, u64, ctypes.POINTER(i32), ctypes.POINTER(i32),
            ctypes.POINTER(i32), ctypes.POINTER(u64), ctypes.POINTER(u64),
        ]
        lib.srt_flac_info.restype = i32
        lib.srt_flac_decode.argtypes = [u8p, u64, u64, i32, i32, u64, i32p]
        lib.srt_flac_decode.restype = ctypes.c_int64
        _lib = lib
        return _lib


def read_wav_native(data: bytes):
    """Returns (planar float32 (ch, n), sample_rate) or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    ch, rate, bits, tag = i32(), i32(), i32(), i32()
    frames, off, dlen = u64(), u64(), u64()
    rc = lib.srt_wav_info(
        buf, buf.size, ctypes.byref(ch), ctypes.byref(rate),
        ctypes.byref(bits), ctypes.byref(tag), ctypes.byref(frames),
        ctypes.byref(off), ctypes.byref(dlen),
    )
    if rc != 0:
        raise ValueError(f"native WAV parse failed ({rc})")
    out = np.empty((ch.value, frames.value), np.float32)
    payload = np.ascontiguousarray(buf[off.value : off.value + dlen.value])
    rc = lib.srt_wav_decode(
        payload, dlen.value, ch.value, bits.value, tag.value, out, frames.value
    )
    if rc != 0:
        raise ValueError(f"native WAV decode failed ({rc})")
    return out, rate.value


def resample_native(
    x: np.ndarray, h: np.ndarray, p: int, q: int, n_out: int
) -> np.ndarray | None:
    """Polyphase resample (batch, n) with filter h; None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    batch, n = x.shape
    h = np.ascontiguousarray(h, np.float64)
    out = np.empty((batch, n_out), np.float32)
    rc = lib.srt_resample(x, n, batch, h, h.size, p, q, out, n_out)
    if rc != 0:
        raise ValueError(f"native resample failed ({rc})")
    return out


def decode_flac_native(data: bytes):
    """FLAC bytes -> (float32 planar (ch, n), rate); None if lib missing."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    ch, rate, bps = i32(), i32(), i32()
    total, off = u64(), u64()
    rc = lib.srt_flac_info(
        buf, buf.size, ctypes.byref(ch), ctypes.byref(rate),
        ctypes.byref(bps), ctypes.byref(total), ctypes.byref(off),
    )
    if rc != 0:
        raise ValueError(f"native FLAC parse failed ({rc})")
    n = total.value
    out = np.zeros((ch.value, n), np.int32)
    done = lib.srt_flac_decode(
        buf, buf.size, off.value, ch.value, bps.value, n, out
    )
    if done < 0:
        raise ValueError(f"native FLAC decode failed ({done})")
    scale = np.float32(1 << (bps.value - 1))
    return out[:, :done].astype(np.float32) / scale, rate.value
