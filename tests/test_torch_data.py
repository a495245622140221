"""spleeterrt_tpu_torch.data.dataset, io.flac and io.audio's WavReader and
FLAC branch against the JAX package, on the CPU.

The same corpus and seed give the same crops bit for bit (both packages
draw `np.random.default_rng` in one order and decode the same bytes).
Magnitudes are float32 FFTs that round in another order: held to 1e-5 of
the batch's max magnitude. The FLAC codecs are held bit for bit: the
port's encoder writes the JAX encoder's bytes, and each decoder reads the
other's streams to the same samples.
"""

import struct

import numpy as np
import pytest
import torch

from spleeterrt_tpu.config import SeparatorConfig as JConfig
from spleeterrt_tpu.data import dataset as jds
from spleeterrt_tpu.io import audio as jaudio
from spleeterrt_tpu.io import flac as jflac
from spleeterrt_tpu_torch.config import SeparatorConfig
from spleeterrt_tpu_torch.data import dataset as ds
from spleeterrt_tpu_torch.io import audio, flac

torch.set_num_threads(2)

MAG_REL = 1e-5  # of the max magnitude
STEMS = ("vocals", "accompaniment")
CFG = SeparatorConfig(bin_limit=512, time_step=64, num_stems=2,
                      compute_dtype=torch.float32)
JCFG = JConfig(bin_limit=512, time_step=64, num_stems=2)


def _make_corpus(root, rng, n_tracks=3, n=70000, flac_track=1):
    """Tracks of a tone (vocals) and noise (accompaniment); track
    `flac_track`'s stems as FLAC (the port's encoder), the rest WAV."""
    for k in range(n_tracks):
        d = root / f"track{k}"
        d.mkdir(parents=True)
        t = np.arange(n + 1000 * k) / 44100.0
        vocals = (0.3 * np.sin(2 * np.pi * (300 + 100 * k) * t))[None].repeat(2, 0)
        acc = 0.1 * rng.standard_normal((2, t.size))
        for name, x in (("vocals", vocals), ("accompaniment", acc)):
            x = x.astype(np.float32)
            if k == flac_track:
                (d / f"{name}.flac").write_bytes(flac.encode_flac(x))
            else:
                audio.write_wav(d / f"{name}.wav", x)
        audio.write_wav(d / "mixture.wav", (vocals + acc).astype(np.float32))
    return root


def test_sample_crops_match_jax_bit_for_bit(tmp_path, rng):
    root = _make_corpus(tmp_path, rng)
    port, ref = ds.StemDataset(root, STEMS), jds.StemDataset(root, STEMS)
    assert [t.streaming for t in port.tracks] == [True, False, True]
    assert [t.n_frames for t in port.tracks] == [t.n_frames for t in ref.tracks]
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(6):
        mix, stems = port.sample_crop(a, ds.crop_samples(CFG))
        jmix, jstems = ref.sample_crop(b, jds.crop_samples(JCFG))
        assert mix.shape == (2, 68608) and stems.shape == (2, 2, 68608)
        np.testing.assert_array_equal(mix, jmix)
        np.testing.assert_array_equal(stems, jstems)


def test_batches_match_jax(tmp_path, rng):
    root = _make_corpus(tmp_path, rng)
    got = list(ds.batches(ds.StemDataset(root, STEMS), CFG, batch_size=3,
                          seed=5, steps=2, device="cpu"))
    ref = list(jds.batches(jds.StemDataset(root, STEMS), JCFG, batch_size=3,
                           seed=5, steps=2))
    assert len(got) == len(ref) == 2
    for (mix, tgt, active), (jmix, jtgt, jactive) in zip(got, ref):
        assert mix.shape == (3, 64, 512, 2) and tgt.shape == (2, 3, 64, 512, 2)
        assert mix.device.type == "cpu" and mix.dtype == torch.float32
        scale = float(np.abs(np.asarray(jtgt)).max())
        np.testing.assert_allclose(mix.numpy(), np.asarray(jmix), rtol=0,
                                   atol=MAG_REL * scale)
        np.testing.assert_allclose(tgt.numpy(), np.asarray(jtgt), rtol=0,
                                   atol=MAG_REL * scale)
        np.testing.assert_array_equal(active.numpy(), np.asarray(jactive))


def test_to_magnitudes_matches_jax(rng):
    n = ds.crop_samples(CFG)
    mix = (0.3 * rng.standard_normal((2, 2, n))).astype(np.float32)
    stems = (0.3 * rng.standard_normal((2, 3, 2, n))).astype(np.float32)
    got = ds.to_magnitudes(torch.from_numpy(mix), torch.from_numpy(stems), CFG)
    ref = jds.to_magnitudes(mix, stems, JCFG)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=MAG_REL * np.abs(r).max())


def test_streaming_crop_matches_full_decode(tmp_path, rng):
    """Seeked partial reads == slices of the fully decoded track, zero-padded
    past the end; the FLAC track's crops come from its decoded cache."""
    root = _make_corpus(tmp_path, rng, n_tracks=2, flac_track=1)
    data = ds.StemDataset(root, STEMS)
    full = audio.read_wav(root / "track0" / "mixture.wav").samples
    tr = data.tracks[0]
    mix, _ = tr.read_crop(12345, 4096)
    np.testing.assert_array_equal(mix, full[:, 12345 : 12345 + 4096])
    n = tr.n_frames
    mix2, _ = tr.read_crop(n - 100, 256)
    np.testing.assert_array_equal(mix2[:, :100], full[:, n - 100 :])
    assert np.all(mix2[:, 100:] == 0)
    flac_vocals = audio.load_audio(root / "track1" / "vocals.flac").samples
    _, stems = data.tracks[1].read_crop(-50, 1000)
    assert np.all(stems[0, :, :50] == 0)
    np.testing.assert_array_equal(stems[0, :, 50:], flac_vocals[:, :950])


def test_missing_mixture_synthesised(tmp_path, rng):
    d = tmp_path / "t0"
    d.mkdir()
    x1 = (0.2 * rng.standard_normal((2, 30000))).astype(np.float32)
    x2 = (0.2 * rng.standard_normal((2, 30000))).astype(np.float32)
    audio.write_wav(d / "vocals.wav", x1)
    audio.write_wav(d / "accompaniment.wav", x2)
    got = ds.StemDataset(tmp_path, STEMS).tracks[0].mixture
    np.testing.assert_array_equal(got, x1 + x2)
    np.testing.assert_array_equal(got, jds.StemDataset(tmp_path, STEMS).tracks[0].mixture)
    track = ds.load_track(d, STEMS)
    np.testing.assert_array_equal(track.mixture, x1 + x2)
    np.testing.assert_array_equal(track.stems["vocals"], x1)


def test_load_track_matches_jax(tmp_path, rng):
    root = _make_corpus(tmp_path, rng, n_tracks=1, flac_track=-1)
    got = ds.load_track(root / "track0", STEMS)
    ref = jds.load_track(root / "track0", STEMS)
    np.testing.assert_array_equal(got.mixture, ref.mixture)
    for s in STEMS:
        np.testing.assert_array_equal(got.stems[s], ref.stems[s])


def test_stem_activity_matches_jax(rng):
    stems = (0.1 * rng.standard_normal((3, 2, 2, 500))).astype(np.float32)
    stems[0, 1] = 0.0
    stems[2, 0] = 1e-7
    got = ds.stem_activity(stems)
    np.testing.assert_array_equal(got, jds.stem_activity(stems))
    np.testing.assert_array_equal(got, [[1, 1, 0], [0, 1, 1]])
    assert got.dtype == np.float32


@pytest.mark.parametrize("fmt", ["float32", "pcm16"])
def test_wav_reader_matches_jax(tmp_path, rng, fmt):
    x = np.clip(0.4 * rng.standard_normal((2, 5000)), -0.99, 0.99).astype(np.float32)
    path = tmp_path / "a.wav"
    jaudio.write_wav(path, x, 44100, fmt=fmt)
    got, ref = audio.WavReader(path), jaudio.WavReader(path)
    assert (got.n_frames, got.channels, got.sample_rate) == (5000, 2, 44100)
    for start, count in ((0, 5000), (1234, 777), (4900, 300), (-20, 50)):
        np.testing.assert_array_equal(got.read(start, count), ref.read(start, count))
    np.testing.assert_array_equal(got.read(0, 5000), audio.read_wav(path).samples)


# (channels, n, bits, block size): 16- and 24-bit, one and two channels,
# silence and constants, a last block shorter than the rest, blocks of 1-4
# samples (residual-free subframes).
FLAC_CASES = [(2, 5000, 16, 4096), (2, 4000, 24, 1024), (1, 3000, 16, 512),
              (1, 2560, 16, 256), (2, 10, 16, 4), (2, 3, 16, 4096)]


def _flac_signal(rng, chans, n):
    x = np.clip(rng.standard_normal((chans, n)) * 0.3, -0.99, 0.99)
    x[:, : n // 4] = 0.0
    x[:, n // 4 : n // 3] = 0.25
    return x.astype(np.float32)


@pytest.mark.parametrize("chans,n,bps,block", FLAC_CASES)
def test_flac_codecs_match_jax_bit_for_bit(rng, chans, n, bps, block):
    x = _flac_signal(rng, chans, n)
    ref = jflac.encode_flac(x, 44100, bps=bps, block_size=block)
    got = flac.encode_flac(x, 44100, bps=bps, block_size=block)
    assert got == ref
    samples, rate = flac.decode_flac(ref)
    jsamples, jrate = jflac.decode_flac(got, prefer_native=False)
    assert rate == jrate == 44100
    np.testing.assert_array_equal(samples, jsamples)
    scale = 1 << (bps - 1)
    pcm = np.clip(np.round(x * scale), -scale, scale - 1)
    np.testing.assert_array_equal(np.round(samples * scale), pcm)


def test_flac_lpc_subframe_decodes_like_jax(rng):
    """A hand-built LPC frame (the JAX package's bit writer, as
    tests/test_flac.py builds it): both decoders invert the predictor."""
    n, order, coeffs, shift, bps = 256, 2, [3, -1], 1, 16
    x = (rng.standard_normal(n) * 2000).astype(np.int64)
    res = [int(x[i] - ((coeffs[0] * x[i - 1] + coeffs[1] * x[i - 2]) >> shift))
           for i in range(order, n)]
    bw = jflac.BitWriter()
    for val, width in ((0x3FFE, 14), (0, 1), (0, 1), (7, 4), (9, 4), (0, 4),
                       (4, 3), (0, 1), (0, 8), (n - 1, 16)):
        bw.write(val, width)
    hdr = bw.tobytes()
    body = jflac.BitWriter()
    for b in hdr:
        body.write(b, 8)
    body.write(jflac._crc8(hdr), 8)
    body.write(0, 1)
    body.write(0x20 | (order - 1), 6)
    body.write(0, 1)
    for v in x[:order]:
        body.write_signed(int(v), bps)
    body.write(15 - 1, 4)  # precision 15
    body.write_signed(shift, 5)
    for c in coeffs:
        body.write_signed(c, 15)
    jflac._write_residual(body, np.asarray(res))
    frame = body.tobytes()
    packed = (44100 << 44) | ((bps - 1) << 36) | n
    si = struct.pack(">HH", n, n) + b"\0" * 6 + packed.to_bytes(8, "big") + b"\0" * 16
    stream = (b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big") + si + frame
              + struct.pack(">H", jflac._crc16(frame)))
    got, _ = flac.decode_flac(stream)
    ref, _ = jflac.decode_flac(stream, prefer_native=False)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.round(got[0] * 32768).astype(np.int64), x)


def test_flac_frame_numbers_past_2047(rng):
    """More than 2048 frames: the port writes the longer UTF-8 frame
    numbers, and the stream decodes losslessly."""
    x = (rng.standard_normal((1, 2100 * 16)) * 0.1).astype(np.float32)
    got, rate = flac.decode_flac(flac.encode_flac(x, 22050, block_size=16))
    assert rate == 22050
    np.testing.assert_array_equal(np.round(got * 32768), np.round(x * 32768))
    assert flac._utf8_coded(2047) == b"\xdf\xbf"
    assert flac._utf8_coded(2048) == b"\xe0\xa0\x80"


def test_flac_rejects_garbage():
    with pytest.raises(ValueError):
        flac.decode_flac(b"not a flac stream at all")


def test_load_audio_flac(tmp_path, rng):
    x = np.clip(rng.standard_normal((2, 3000)) * 0.3, -0.99, 0.99).astype(np.float32)
    path = tmp_path / "a.flac"
    path.write_bytes(flac.encode_flac(x, 22050))
    audio.check_decodable(path)
    got = audio.load_audio(path)
    assert got.sample_rate == 22050
    np.testing.assert_allclose(got.samples, x, atol=1.0 / 32768.0)
    np.testing.assert_array_equal(got.samples, jaudio.load_audio(path).samples)
    # An MP3 that no reader can open is refused as the JAX package refuses it.
    with pytest.raises(audio.UnsupportedFormatError) as got:
        audio.load_audio(tmp_path / "a.mp3")
    with pytest.raises(jaudio.UnsupportedFormatError) as ref:
        jaudio.load_audio(tmp_path / "a.mp3")
    assert str(got.value) == str(ref.value)
