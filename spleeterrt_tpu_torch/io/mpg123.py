"""MP3 decode via the system's libmpg123 (ctypes, no vendoring).

The reference decodes MP3 through its vendored dr_mp3.h inside
loadAudioFile (Executable/main.c:241-245). This is the reference package's
binding (spleeterrt_tpu/io/mpg123.py), kept as the port's own copy: the
bitstream codec is the system library, linked at run time, and
soundfile/ffmpeg act as fallbacks on machines without it
(io/audio.py::load_audio).

Only the small, stable subset of the mpg123 API needed for whole-file
decode is bound; output is the library's default signed-16 interleaved
PCM, converted to float32 planar (-1, 1) host-side.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import os

import numpy as np

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_ENC_SIGNED_16 = 0x040 | 0x080 | 0x10  # MPG123_ENC_SIGNED_16


@functools.cache
def _lib():
    for name in ("libmpg123.so.0", "libmpg123.so", "mpg123"):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        found = ctypes.util.find_library("mpg123")
        if not found:
            return None
        lib = ctypes.CDLL(found)

    lib.mpg123_init()
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mpg123_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_plain_strerror.restype = ctypes.c_char_p
    lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
    lib.mpg123_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.mpg123_param.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double,
    ]
    return lib


def decode_bytes(data: bytes) -> tuple[np.ndarray, int, int]:
    """Feed-mode decode of a raw MP3 byte stream (no file, no id3).

    Returns ((n, channels) int16 PCM, sample_rate, channels). Exists for
    in-memory decode paths (e.g. crafted-frame experiments); file decode
    goes through :func:`decode_mp3`."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        rc = lib.mpg123_open_feed(h)
        if rc != _MPG123_OK:
            raise RuntimeError(f"mpg123_open_feed failed (rc={rc})")
        out = (ctypes.c_char * (1 << 20))()
        done = ctypes.c_size_t(0)
        chunks = []
        rate, channels = 0, 1
        fed = False
        while True:
            src, n = (data, len(data)) if not fed else (None, 0)
            fed = True
            rc = lib.mpg123_decode(h, src, n, out, len(out), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(out[: done.value]))
            if rc == _MPG123_NEW_FORMAT:
                r = ctypes.c_long(0)
                c = ctypes.c_int(0)
                e = ctypes.c_int(0)
                lib.mpg123_getformat(
                    h, ctypes.byref(r), ctypes.byref(c), ctypes.byref(e)
                )
                rate, channels = int(r.value), int(c.value)
                continue
            if rc in (_MPG123_OK,) and done.value:
                continue
            break  # NEED_MORE / DONE / error: stream drained
        pcm = np.frombuffer(b"".join(chunks), dtype="<i2")
        n = pcm.size // max(1, channels)
        return pcm[: n * channels].reshape(n, max(1, channels)), rate, channels
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def available() -> bool:
    return _lib() is not None


def decode_mp3(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Whole-file decode -> ((channels, n) float32 in [-1, 1], sample_rate)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libmpg123 not available")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        rc = lib.mpg123_open(h, os.fsencode(os.fspath(path)))
        if rc != _MPG123_OK:
            raise ValueError(f"mpg123 cannot open {path} (rc={rc})")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        rc = lib.mpg123_getformat(
            h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(encoding)
        )
        if rc != _MPG123_OK:
            raise ValueError(f"mpg123_getformat failed (rc={rc})")
        if encoding.value != _ENC_SIGNED_16:
            raise ValueError(
                f"unexpected mpg123 default encoding 0x{encoding.value:x}"
            )

        chunks = []
        buf = (ctypes.c_char * (1 << 18))()
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                # Rate/channel change mid-stream: re-read the format; the
                # test corpus is single-format, so only track the first.
                lib.mpg123_getformat(
                    h, ctypes.byref(rate), ctypes.byref(channels),
                    ctypes.byref(encoding),
                )
                continue
            if rc not in (_MPG123_OK,):
                raise ValueError(
                    f"mpg123_read failed: "
                    f"{lib.mpg123_plain_strerror(rc).decode()}"
                )
        pcm = np.frombuffer(b"".join(chunks), dtype="<i2")
        ch = max(1, channels.value)
        n = pcm.size // ch
        samples = (
            pcm[: n * ch].reshape(n, ch).T.astype(np.float32) / 32768.0
        )
        return np.ascontiguousarray(samples), int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
