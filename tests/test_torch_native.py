"""The port's native host runtime (spleeterrt_tpu_torch/native) against its
NumPy paths and the JAX package's native runtime, on the CPU.

The three cases of tests/test_native.py at the same tolerances, each
native output also bit for bit with the JAX package's native library on
the same input; native FLAC decode bit for bit with the Python decoder
and with the JAX package's `decode_flac`; and two processes that build
the library into one empty directory at the same moment both load it.
Skips where g++ is absent.
"""

import ctypes
import shutil
import subprocess
import sys
import tempfile
import textwrap
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from spleeterrt_tpu import native as jnative
from spleeterrt_tpu.io import audio as jaudio
from spleeterrt_tpu.io import flac as jflac
from spleeterrt_tpu_torch import native
from spleeterrt_tpu_torch.io import audio, flac, resample

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native runtime cannot build")
    lib = native.get_lib()
    assert lib is not None, "g++ is present but the native library did not build"
    return lib


def _wav_bytes(x, sr, fmt):
    """WAV bytes in `fmt` from the JAX package's writer (the port writes
    float32 only)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "x.wav"
        jaudio.write_wav(path, x, sr, fmt=fmt)
        return path.read_bytes()


@pytest.mark.parametrize("fmt", ["float32", "pcm16"])
def test_native_wav_matches_numpy(lib, rng, fmt):
    x = np.clip(rng.standard_normal((2, 4000)) * 0.3, -0.9, 0.9).astype(
        np.float32
    )
    data = _wav_bytes(x, 44100, fmt)
    planar, rate = native.read_wav_native(data)
    ref = audio.read_wav(data)
    assert rate == ref.sample_rate == 44100
    np.testing.assert_array_equal(planar, ref.samples)
    jplanar, jrate = jnative.read_wav_native(data)
    assert jrate == rate
    np.testing.assert_array_equal(planar, jplanar)


def test_native_resample_matches_numpy(lib, rng):
    sr_in, sr_out = 48000, 44100
    x = (rng.standard_normal((2, 20000)) * 0.5).astype(np.float32)
    ref = resample.resample(x, sr_in, sr_out)

    frac = Fraction(sr_out, sr_in)
    p, q = frac.numerator, frac.denominator
    h = resample.kaiser_sinc_filter(p, q)
    got = native.resample_native(x, h, p, q, ref.shape[-1])
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_array_equal(
        got, jnative.resample_native(x, h, p, q, ref.shape[-1]))


def test_native_channel_ops(lib, rng):
    x = rng.standard_normal(3 * 100).astype(np.float32)  # interleaved, 3 ch
    out_len = 150
    planar = np.empty((3, out_len), np.float32)
    lib.srt_split_channels(x, 3, 100, 30, out_len, planar)
    ref = np.zeros((3, out_len), np.float32)
    ref[:, 30:130] = x.reshape(100, 3).T
    np.testing.assert_array_equal(planar, ref)

    inter = np.empty(100 * 3, np.float32)
    lib.srt_join_channels(planar, 3, out_len, 30, 100, inter)
    np.testing.assert_array_equal(inter, x)

    jlib = jnative.get_lib()
    jplanar = np.empty((3, out_len), np.float32)
    jlib.srt_split_channels(x, 3, 100, 30, out_len, jplanar)
    jinter = np.empty(100 * 3, np.float32)
    jlib.srt_join_channels(jplanar, 3, out_len, 30, 100, jinter)
    np.testing.assert_array_equal(planar, jplanar)
    np.testing.assert_array_equal(inter, jinter)
    assert lib.srt_version() == jlib.srt_version()


@pytest.mark.parametrize("channels, n, rate, bps", [
    (2, 3 * 4096 + 517, 44100, 16),
    (1, 5000, 22050, 16),
    (2, 9000, 48000, 24),
])
def test_native_flac_matches_python_and_jax(lib, rng, channels, n, rate, bps):
    x = np.clip(rng.standard_normal((channels, n)) * 0.3, -0.99, 0.99)
    data = flac.encode_flac(x.astype(np.float32), rate, bps=bps)
    got, got_rate = native.decode_flac_native(data)
    py, py_rate = flac.decode_flac(data, prefer_native=False)
    auto, _ = flac.decode_flac(data)
    jx, jrate = jflac.decode_flac(data)
    assert got_rate == py_rate == jrate == rate
    assert got.dtype == py.dtype == np.float32
    np.testing.assert_array_equal(got, py)
    np.testing.assert_array_equal(auto, got)
    np.testing.assert_array_equal(got, jx)


def test_concurrent_builds_both_load(lib, tmp_path):
    """Two processes build into one empty directory at once; each loads a
    whole library and decodes a WAV with it."""
    script = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        sys.path.insert(0, {str(REPO)!r})
        from spleeterrt_tpu_torch import native
        native.BUILD_DIR = Path({str(tmp_path)!r})
        lib = native.get_lib()
        assert lib is not None, "no library"
        print(lib.srt_version().decode())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == lib.srt_version().decode()
    built = sorted(tmp_path.iterdir())
    assert [p.name for p in built] == [native.library_path().name]
    ctypes.CDLL(str(built[0]))  # the renamed file is a whole library
