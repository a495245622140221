"""The streaming engine and its CLI against the JAX package and the
hop-by-hop oracle of the C engine, on the CPU (fp32, bin_limit 512,
time_step 64).

The JAX side runs on the CPU, where its engine takes plain XLA (no Pallas
kernel); the port's wrappers take their plain versions for CPU tensors.
Bounds: 1e-4 against JAX's engine, 5e-4 against the oracle (the bound the
JAX package holds its own engine to, tests/test_stream.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spleeterrt_tpu import cli_stream as jcli_stream
from spleeterrt_tpu.config import SeparatorConfig as JSeparatorConfig
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu.runtime import stream as jstream
from spleeterrt_tpu_torch import cli_stream, kernels
from spleeterrt_tpu_torch.config import SeparatorConfig
from spleeterrt_tpu_torch.core import model, weights
from spleeterrt_tpu_torch.io import audio
from spleeterrt_tpu_torch.runtime import stream
from tests.oracle import reference_oracle, streaming_oracle

torch.set_num_threads(2)

CFG = SeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                      compute_dtype=torch.float32)
JCFG = JSeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                        compute_dtype=jnp.float32)
OUT_BAND = (0.25, 0.0)
BLOCK = CFG.time_step * stream.HOP


def _setup(rng, n_stems=2):
    """The same random blobs as (port params, JAX params, oracle fields)."""
    blobs = [weights.random_blob(rng, 0.02) for _ in range(n_stems)]
    return (
        weights.stack_params([weights.blob_to_params(b) for b in blobs]),
        jweights.stack_params([jweights.blob_to_params(b) for b in blobs]),
        [reference_oracle.unpack_blob(b) for b in blobs],
    )


def _tone_audio(rng, n):
    t = np.arange(n) / 44100.0
    x = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return np.stack([x, 0.7 * x])


@pytest.mark.parametrize("freq_temporal", [0.5, 1.0, 3.0])
def test_windows_match_oracle(freq_temporal):
    wa_o, ws_o = streaming_oracle.asymmetric_windows(freq_temporal)
    wa, ws = stream.asymmetric_windows(freq_temporal)
    np.testing.assert_allclose(wa, wa_o, atol=1e-12)
    np.testing.assert_allclose(ws, ws_o[: stream.SYNTH_LEN], atol=1e-12)


@pytest.mark.parametrize("freq_temporal", [0.5, 1.0, 3.0])
def test_stream_scan_matches_jax(rng, freq_temporal):
    """3.0 exercises the 2.0 clamp of the rising tail's exponent."""
    params, jparams, _ = _setup(rng)
    audio_np = _tone_audio(rng, 3 * BLOCK)
    got = stream.stream_scan(params, torch.from_numpy(audio_np), CFG, 2,
                             OUT_BAND, freq_temporal).numpy()
    ref = np.asarray(jstream.stream_scan(
        jparams, jnp.asarray(audio_np), JCFG, 2, OUT_BAND,
        freq_temporal=freq_temporal,
    ))
    assert got.shape == ref.shape == (2, 2, 3 * BLOCK)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("freq_temporal", [1.0, 3.0])
def test_stream_scan_matches_hop_oracle(rng, freq_temporal):
    """The block engine == the literal hop-by-hop VST engine semantics."""
    params, _, fields = _setup(rng)
    audio_np = _tone_audio(rng, 3 * BLOCK)
    got = stream.stream_scan(params, torch.from_numpy(audio_np), CFG, 2,
                             OUT_BAND, freq_temporal).numpy()
    ref = streaming_oracle.stream_oracle(
        fields, audio_np.astype(np.float64), CFG.bin_limit, CFG.time_step,
        OUT_BAND, freq_temporal=freq_temporal,
    )
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=5e-4)


def test_stream_latency_reconstruction():
    """With pass-through masks (up7 bias +20: the sigmoid saturates to 1)
    the output is the input delayed by exactly (2T + 1) hops."""
    params = model.init_params(torch.Generator().manual_seed(0))
    params = {k: {f: torch.zeros_like(v) for f, v in ly.items()}
              for k, ly in params.items()}
    params["up7"]["b"] = torch.full((2,), 20.0)
    stacked = weights.stack_params([params])
    n = 4 * BLOCK
    x = (0.4 * np.sin(2 * np.pi * 1000 * np.arange(n) / 44100.0)).astype(
        np.float32)  # in band
    out = stream.stream_scan(stacked, torch.from_numpy(np.stack([x, x])), CFG,
                             1, (0.25,))[0].numpy()
    delay = (2 * CFG.time_step + 1) * stream.HOP
    lo, hi = delay + 4096, n - 4096
    np.testing.assert_allclose(out[0, lo:hi], x[lo - delay : hi - delay],
                               atol=2e-3)
    np.testing.assert_allclose(out[1, lo:hi], x[lo - delay : hi - delay],
                               atol=2e-3)


def test_first_two_blocks_are_silence(rng):
    """Zero spectra in the carry: the first two output blocks are exact
    zeros, and the third is not."""
    params, _, _ = _setup(rng)
    x = torch.from_numpy((rng.standard_normal((2, 3 * BLOCK)) * 0.3).astype(
        np.float32))
    out = stream.stream_scan(params, x, CFG, 2, OUT_BAND)
    assert torch.all(out[..., : 2 * BLOCK] == 0)
    assert out[..., 2 * BLOCK :].abs().max() > 0.01
    assert torch.all(torch.isfinite(out))


def test_streaming_separator_chunked_equals_scan(rng):
    """Pushing chunks of any size gives the scan's output one block later
    (the silence played while the first block fills), sample for sample."""
    params, jparams, _ = _setup(rng)
    n = 3 * BLOCK + 5000
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    scan = stream.stream_scan(params, torch.from_numpy(x), CFG, 2,
                              OUT_BAND).numpy()  # 3 blocks
    sep = stream.StreamingSeparator(params, CFG, 2, OUT_BAND)
    outs, pos = [], 0
    for size in (1, 333, 1024, 7777, n):
        take = min(size, n - pos)
        outs.append(sep.process(x[:, pos : pos + take]))
        pos += take
    got = np.concatenate(outs, axis=-1)
    assert got.shape == (2, 2, n)
    assert np.all(got[..., :BLOCK] == 0)
    np.testing.assert_allclose(got[..., BLOCK:], scan[..., : n - BLOCK],
                               atol=2e-5)
    # The reference's push API has the same extra block.
    jsep = jstream.StreamingSeparator(jparams, JCFG, 2, OUT_BAND)
    ref = np.concatenate([jsep.process(x[:, i : i + 7777])
                          for i in range(0, n, 7777)], axis=-1)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_block_step_streams_matches_independent(rng):
    """K batched streams against each stream alone, three blocks each (the
    third is the first with sound): bit-exact on the CPU, where torch's
    convolutions give each image of a batch the same sums as alone."""
    params, _, _ = _setup(rng)
    k = 2
    blocks = torch.from_numpy(
        (rng.standard_normal((3, k, 2, BLOCK)) * 0.3).astype(np.float32))
    state_k = stream.init_state_streams(CFG, 2, k)
    outs_k = []
    for i in range(3):
        state_k, out = stream.block_step_streams(params, state_k, blocks[i],
                                                 CFG, 2, OUT_BAND)
        outs_k.append(out)
    assert outs_k[2].abs().max() > 0.01
    for s in range(k):
        state = stream.init_state(CFG, 2)
        for i in range(3):
            state, out = stream.block_step(params, state, blocks[i, s], CFG, 2,
                                           OUT_BAND)
            assert torch.equal(outs_k[i][s], out)
        assert torch.equal(state_k.masks2[:, s], state.masks2[:, 0])


def _write_blobs(tmp_path, rng):
    d = tmp_path / "weights"
    d.mkdir()
    for name in weights.VST_BLOB_FILENAMES.values():
        (d / name).write_bytes(weights.random_blob(rng, 0.02))
    return d


@pytest.mark.parametrize("split", [True, False])
def test_cli_stream_matches_jax_cli_stream(tmp_path, rng, split):
    """Four random VST blobs through both streaming CLIs in fp32."""
    blobs = _write_blobs(tmp_path, rng)
    n = 3 * BLOCK + 3000
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    song = tmp_path / "song.wav"
    audio.write_wav(song, x)
    common = [str(song), "--weights", str(blobs), "--time-step", "64",
              "--bin-limit", "512", "--fp32", "--channel-order", "vocals"]
    common += ["--split"] if split else []
    jout, tout = tmp_path / "jax_out", tmp_path / "torch_out"
    assert jcli_stream.main(common + ["--output", str(jout)]) == 0
    kernels.reset_launch_counts()
    assert cli_stream.main(common + ["--output", str(tout), "--device",
                                     "cpu"]) == 0
    assert not any(kernels.launch_counts().values())
    names = ("vocals", "drums", "bass", "accompaniment")
    if split:
        pairs = [(tout / f"{s}.wav", jout / f"{s}.wav") for s in names]
    else:
        pairs = [(tmp_path / "torch_out.wav", tmp_path / "jax_out.wav")]
    for got_path, ref_path in pairs:
        got, ref = audio.read_wav(got_path), audio.read_wav(ref_path)
        assert got.samples.shape == ref.samples.shape == ((2,) if split else (8,)) + (n,)
        assert np.all(np.isfinite(got.samples))
        assert np.abs(ref.samples).max() > 0.01
        np.testing.assert_allclose(got.samples, ref.samples, atol=1e-4)


def test_cli_stream_raw_stdin(tmp_path, rng, monkeypatch):
    """Raw interleaved float32 stereo on stdin gives what the WAV gives."""
    import io
    import sys

    x = (rng.standard_normal((2, BLOCK + 2500)) * 0.3).astype(np.float32)
    song = tmp_path / "song.wav"
    audio.write_wav(song, x)
    common = ["--random-weights", "--time-step", "64", "--bin-limit", "512",
              "--fp32", "--device", "cpu", "--chunk", "700"]
    assert cli_stream.main([str(song), "--output", str(tmp_path / "wav")]
                           + common) == 0

    class Stdin:
        buffer = io.BytesIO(np.ascontiguousarray(x.T).astype("<f4").tobytes())

    monkeypatch.setattr(sys, "stdin", Stdin)
    assert cli_stream.main(["--raw", "--output", str(tmp_path / "raw")]
                           + common) == 0
    got = audio.read_wav(tmp_path / "raw.wav").samples
    assert got.shape == (8, x.shape[1])
    np.testing.assert_array_equal(got, audio.read_wav(tmp_path / "wav.wav").samples)


def test_cli_stream_refuses_missing_cuda(tmp_path, monkeypatch):
    """--device cuda without a card is an error, and nothing is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    song = tmp_path / "song.wav"
    audio.write_wav(song, np.zeros((2, 5000), np.float32))
    kernels.reset_launch_counts()
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli_stream.main([str(song), "--random-weights", "--split",
                         "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    assert not any(kernels.launch_counts().values())


def test_cli_stream_refuses_other_formats(tmp_path):
    song = tmp_path / "song.mp3"
    song.write_bytes(b"ID3\0\0\0\0")
    with pytest.raises(SystemExit, match="WAV and FLAC only"):
        cli_stream.main([str(song), "--random-weights", "--device", "cpu",
                         "--output", str(tmp_path / "out")])
