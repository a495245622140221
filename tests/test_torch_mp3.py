"""MP3 input in the port (io/mpg123.py and io/audio.py's reader order)
against the JAX package's, on the CPU.

The MP3 bytes are made here: frames of digital silence assembled by hand,
and a two-tone signal through libmp3lame by ctypes where it loads
(spleeterrt_tpu_torch/io/mp3_fixtures.py). Decodes must be bit for bit
with the JAX package's binding; `check_decodable`/`load_audio` must take
JAX's reader order and give its messages; the CPU CLI on an MP3 must
write the JAX CLI's stems to 2e-4. Skips where libmpg123 is absent.
"""

import numpy as np
import pytest

from spleeterrt_tpu import cli as jcli
from spleeterrt_tpu.io import audio as jaudio
from spleeterrt_tpu.io import mpg123 as jmpg123
from spleeterrt_tpu_torch import cli
from spleeterrt_tpu_torch.core import weights
from spleeterrt_tpu_torch.io import audio, mp3_fixtures, mpg123


@pytest.fixture(autouse=True)
def _needs_mpg123():
    if not mpg123.available():
        pytest.skip("libmpg123 is absent")


def _tones(seconds=1.0, rate=44100):
    t = np.arange(int(seconds * rate)) / rate
    return np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                     0.2 * np.sin(2 * np.pi * 660 * t + 1.0)]).astype(np.float32)


def _streams():
    yield "silence", mp3_fixtures.silent_frames(40)
    if mp3_fixtures.lame_available():
        yield "lame tones", mp3_fixtures.lame_encode(_tones())


@pytest.mark.parametrize("kind", ["silence", "lame tones"])
def test_decode_matches_jax(tmp_path, kind):
    streams = dict(_streams())
    if kind not in streams:
        pytest.skip("libmp3lame is absent")
    data = streams[kind]
    pcm, rate, ch = mpg123.decode_bytes(data)
    jpcm, jrate, jch = jmpg123.decode_bytes(data)
    assert (rate, ch) == (jrate, jch) == (44100, 2)
    assert pcm.dtype == np.dtype("<i2")
    np.testing.assert_array_equal(pcm, jpcm)
    path = tmp_path / "x.mp3"
    path.write_bytes(data)
    x, rate = mpg123.decode_mp3(path)
    jx, jrate = jmpg123.decode_mp3(path)
    assert rate == jrate == 44100
    assert x.dtype == np.float32 and x.shape[0] == 2
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(x, pcm.T.astype(np.float32) / 32768.0)
    if kind == "silence":
        assert x.shape[1] >= 30 * mp3_fixtures.SAMPLES_PER_FRAME
        assert not np.any(x)
    else:
        assert np.abs(x).max() > 0.1
    got = audio.load_audio(path)
    np.testing.assert_array_equal(got.samples, x)
    assert got.sample_rate == 44100


def _no_ffmpeg(monkeypatch):
    for mod in (audio, jaudio):
        monkeypatch.setattr(mod.shutil, "which", lambda name: None)


def test_mp3_routing_matches_jax(tmp_path, monkeypatch):
    """A corrupt .mp3 passes check_decodable (libmpg123 is there), then
    every reader's failure lands in one UnsupportedFormatError with JAX's
    text; a missing file the same."""
    _no_ffmpeg(monkeypatch)
    bad = tmp_path / "bad.mp3"
    bad.write_bytes(b"ID3\0\0\0\0")
    for path in (bad, tmp_path / "missing.mp3"):
        audio.check_decodable(path)
        jaudio.check_decodable(path)
        with pytest.raises(audio.UnsupportedFormatError) as got:
            audio.load_audio(path)
        with pytest.raises(jaudio.UnsupportedFormatError) as ref:
            jaudio.load_audio(path)
        assert str(got.value) == str(ref.value)
        assert "mpg123:" in str(got.value)


def test_reader_order_matches_jax(tmp_path, monkeypatch):
    """With the readers replaced by recorders, .mp3 tries mpg123, then
    soundfile, then ffmpeg, and other extensions soundfile, then ffmpeg; a
    reader that raises falls through, one that declines (None) too; the
    first that returns wins."""
    def recorders(mod, log, fail):
        def make(name):
            def reader(path):
                log.append(name)
                if name in fail:
                    if fail[name] == "raise":
                        raise ValueError(f"{name} choked")
                    return None
                return mod.AudioData(np.zeros((2, 3), np.float32), 8000)
            reader.__name__ = f"_read_via_{name}"
            return reader
        for name in ("mpg123", "soundfile", "ffmpeg"):
            monkeypatch.setattr(mod, f"_read_via_{name}", make(name))
        monkeypatch.setattr(mod.shutil, "which", lambda name: f"/bin/{name}")

    cases = [
        ("a.mp3", {}),
        ("a.mp3", {"mpg123": "raise"}),
        ("a.mp3", {"mpg123": "none", "soundfile": "raise"}),
        ("a.ogg", {}),
        ("a.ogg", {"soundfile": "raise"}),
        ("a.ogg", {"soundfile": "raise", "ffmpeg": "raise"}),
        ("a.mp3", {"mpg123": "raise", "soundfile": "none", "ffmpeg": "raise"}),
    ]
    for name, fail in cases:
        path = tmp_path / name
        results = []
        for mod in (audio, jaudio):
            log = []
            recorders(mod, log, fail)
            try:
                out = mod.load_audio(path)
                results.append((log, "ok", out.sample_rate))
            except mod.UnsupportedFormatError as e:
                results.append((log, "error", str(e)))
        assert results[0] == results[1], (name, fail)


def test_unknown_format_guidance_matches_jax(tmp_path, monkeypatch):
    """No libmpg123, soundfile or ffmpeg: check_decodable refuses an .mp3
    and an unknown extension with JAX's guidance, and so does the CLI."""
    _no_ffmpeg(monkeypatch)
    monkeypatch.setattr(mpg123, "available", lambda: False)
    monkeypatch.setattr(jmpg123, "available", lambda: False)
    for name in ("a.mp3", "a.xyz", "noext"):
        path = tmp_path / name
        path.write_bytes(b"\0" * 16)
        with pytest.raises(audio.UnsupportedFormatError) as got:
            audio.check_decodable(path)
        with pytest.raises(jaudio.UnsupportedFormatError) as ref:
            jaudio.check_decodable(path)
        assert str(got.value) == str(ref.value)
    with pytest.raises(SystemExit, match="requires the 'soundfile' package"):
        cli.main([str(tmp_path / "a.mp3"), "--device", "cpu"])


def test_cli_on_mp3_matches_jax_cli(tmp_path, rng):
    """Four random VST blobs through both CLIs in fp32 on one MP3 (LAME's
    two tones, else silence); the stems agree to 2e-4 and are as long as
    the decoded input."""
    blobs = tmp_path / "weights"
    blobs.mkdir()
    for name in weights.VST_BLOB_FILENAMES.values():
        (blobs / name).write_bytes(weights.random_blob(rng))
    data = dict(_streams()).get("lame tones") or mp3_fixtures.silent_frames(12)
    song = tmp_path / "song.mp3"
    song.write_bytes(data)
    n = mpg123.decode_mp3(song)[0].shape[1]
    common = [str(song), "--stems", "4", "--time-step", "64", "--bin-limit",
              "512", "--weights", str(blobs), "--fp32"]
    assert jcli.main(common + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["--output-dir", str(tmp_path / "torch"),
                              "--device", "cpu"]) == 0
    for stem in ("Drum", "Bass", "Accompaniment", "Vocal"):
        got = audio.read_wav(tmp_path / "torch" / f"song_{stem}.wav")
        ref = audio.read_wav(tmp_path / "jax" / f"song_{stem}.wav")
        assert got.samples.shape == ref.samples.shape == (2, n)
        assert np.all(np.isfinite(got.samples))
        np.testing.assert_allclose(got.samples, ref.samples, atol=2e-4)
