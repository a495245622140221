"""The port's canonical transform, U-Net and 2-stem offline graph against
the NumPy oracle of the C reference (tests/oracle/reference_oracle.py), on
the CPU, at the tolerances of the JAX package's own oracle tests
(tests/test_transform.py, tests/test_model.py, tests/test_separate.py)."""

import numpy as np
import pytest
import torch

from spleeterrt_tpu_torch.config import (
    STEM_MODE_2,
    STEM_MODE_4,
    SeparatorConfig,
    TransformConfig,
)
from spleeterrt_tpu_torch.core import model, separate, transform, weights
from tests.oracle import reference_oracle as oracle

torch.set_num_threads(2)

CFG = TransformConfig()
CFG2 = SeparatorConfig(bin_limit=512, time_step=64, num_stems=2,
                       compute_dtype=torch.float32)


def test_stft_matches_oracle(rng):
    """Oracle planes are (spec.real / N, -spec.imag / N) at LAP = 4."""
    n_pcm = 3 * 4096 + 123
    x = rng.standard_normal(n_pcm).astype(np.float32)
    padded = np.zeros(4096 * 4 + 8192, dtype=np.float32)
    padded[4096 : 4096 + n_pcm] = x
    data_size = padded.size

    spec = transform.stft(torch.from_numpy(padded), CFG, data_size).numpy()
    re_o, im_o = oracle.stft_planes(padded.astype(np.float64), data_size)
    assert spec.shape == re_o.shape
    np.testing.assert_allclose(spec.real / oracle.FFTSIZE, re_o,
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(-spec.imag / oracle.FFTSIZE, im_o,
                               atol=1e-6, rtol=1e-5)


def test_istft_matches_oracle(rng):
    """The port's convention: spec = (re - 1j * im) * N. The output peaks
    near 330, so float32 leaves errors of a few 1e-5 (the JAX package's
    own reads 4.6e-05 here); tests/test_transform.py holds it to atol 1e-3,
    rtol 1e-4."""
    n_frames = 8
    re = rng.standard_normal((n_frames, oracle.HALFWNDLEN))
    im = rng.standard_normal((n_frames, oracle.HALFWNDLEN))
    im[:, 0] = 0.0
    im[:, -1] = 0.0

    out_o = oracle.istft_planes(re, im)
    spec = torch.from_numpy((re - 1j * im) * oracle.FFTSIZE).to(torch.complex64)
    out = transform.istft(spec, CFG).numpy()
    assert out.shape == out_o.shape
    np.testing.assert_allclose(out, out_o, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("mode", [STEM_MODE_2, STEM_MODE_4])
def test_unet_forward_matches_oracle(rng, mode):
    """The 13-layer canonical forward on the smallest legal tile, both nets
    from one blob."""
    blob = weights.random_blob(rng, scale=0.02)
    fields = oracle.unpack_blob(blob)
    params = weights.blob_to_params(blob)

    t, f = 64, 512
    mag = np.abs(rng.standard_normal((2, t, f))) * 2.0
    ref = oracle.unet(fields, mag, stem_mode=mode)
    got = model.unet_forward(
        params, torch.from_numpy(mag.transpose(1, 2, 0)[None]).float(),
        stem_mode=mode, compute_dtype=torch.float32)
    got = got[0].numpy().transpose(2, 0, 1)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)


def test_2stem_matches_oracle(rng):
    blob = weights.random_blob(rng, scale=0.02)
    params = weights.blob_to_params(blob)
    fields = oracle.unpack_blob(blob)
    n = 30000
    t = np.arange(n) / 44100.0
    x = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)
    audio = np.stack([x, 0.8 * x]).astype(np.float32)

    got = separate.separate(audio, params=params, cfg=CFG2, device="cpu")
    ref_vocal, ref_acc = oracle.offline_separate_2stem(
        fields, audio.astype(np.float64), n, CFG2.bin_limit, CFG2.time_step)
    vocals, acc = got["vocals"].numpy(), got["accompaniment"].numpy()
    np.testing.assert_allclose(vocals, ref_vocal, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(acc, ref_acc, atol=5e-4, rtol=1e-3)
    # Conservation: vocals + accompaniment == input (time-domain residual).
    np.testing.assert_allclose(vocals + acc, audio, atol=1e-5)
