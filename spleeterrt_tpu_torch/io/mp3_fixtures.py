"""MP3 bytes made on the spot, for the MP3 tests and the smoke run.

No MP3 file ships with the repository and none is fetched. Where the
system's libmp3lame loads, `lame_encode` encodes float32 audio with it
(ctypes, constant bitrate). `silent_frames` needs no library: it
assembles MPEG-1 Layer III frames by hand, each a header and all-zero
side information and main data, which every decoder turns into digital
silence (no Huffman data, so every spectral value is zero).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

# MPEG-1 Layer III, no CRC (0xFFFB); 128 kbit/s, 44.1 kHz, no padding
# (0x90); stereo, no mode extension (0x00).
_SILENT_HEADER = bytes([0xFF, 0xFB, 0x90, 0x00])
_SILENT_FRAME_BYTES = 144 * 128000 // 44100  # 417
SAMPLES_PER_FRAME = 1152


def silent_frames(n_frames: int) -> bytes:
    """`n_frames` frames of stereo digital silence at 44.1 kHz."""
    frame = _SILENT_HEADER + bytes(_SILENT_FRAME_BYTES - len(_SILENT_HEADER))
    return frame * n_frames


@functools.cache
def _lame():
    for name in ("libmp3lame.so.0", "libmp3lame.so", ctypes.util.find_library("mp3lame")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    lib.lame_init.restype = ctypes.c_void_p
    lib.lame_init.argtypes = []
    for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
               "lame_set_brate", "lame_set_quality"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_int
    lib.lame_init_params.argtypes = [ctypes.c_void_p]
    lib.lame_init_params.restype = ctypes.c_int
    lib.lame_encode_buffer_interleaved.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int]
    lib.lame_encode_buffer_interleaved.restype = ctypes.c_int
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int]
    lib.lame_encode_flush.restype = ctypes.c_int
    lib.lame_close.argtypes = [ctypes.c_void_p]
    lib.lame_close.restype = ctypes.c_int
    return lib


def lame_available() -> bool:
    return _lame() is not None


def lame_encode(x: np.ndarray, sample_rate: int = 44100, kbps: int = 192) -> bytes:
    """(2, n) float32 in [-1, 1] -> MP3 bytes by libmp3lame (stereo, CBR)."""
    lib = _lame()
    if lib is None:
        raise RuntimeError("libmp3lame not available")
    pcm = np.ascontiguousarray(
        np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").T)
    n, channels = pcm.shape
    if channels != 2:
        raise ValueError(f"expected (2, n) audio, got {x.shape}")
    g = lib.lame_init()
    if not g:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(g, sample_rate)
        lib.lame_set_num_channels(g, channels)
        lib.lame_set_brate(g, kbps)
        lib.lame_set_quality(g, 5)
        if lib.lame_init_params(g) < 0:
            raise RuntimeError("lame_init_params failed")
        cap = int(1.25 * n) + 7200  # LAME's worst case for one call
        buf = (ctypes.c_ubyte * cap)()
        k = lib.lame_encode_buffer_interleaved(g, pcm.ctypes.data, n, buf, cap)
        if k < 0:
            raise RuntimeError(f"lame_encode_buffer_interleaved failed ({k})")
        out = bytes(buf[:k])
        k = lib.lame_encode_flush(g, buf, cap)
        if k < 0:
            raise RuntimeError(f"lame_encode_flush failed ({k})")
        return out + bytes(buf[:k])
    finally:
        lib.lame_close(g)
