"""spleeterrt_tpu_torch.core.transform against spleeterrt_tpu.core.transform.

Same numpy inputs through both packages, on the CPU. Spectra agree to
2e-6 * max|X| and audio to 1e-6 * max(1, max|x|): both sides are fp32
FFTs (pocketfft vs XLA's CPU FFT) that differ only in rounding order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spleeterrt_tpu.config import TransformConfig as JTransformConfig
from spleeterrt_tpu.core import transform as jtransform
from spleeterrt_tpu_torch.config import TransformConfig
from spleeterrt_tpu_torch.core import transform

torch.set_num_threads(2)

CFG = TransformConfig()
JCFG = JTransformConfig()


def _audio(rng, n):
    return (rng.standard_normal((2, n)) * 0.3).astype(np.float32)


def test_windows_match():
    np.testing.assert_array_equal(
        transform.analysis_window(4096).numpy(),
        np.asarray(jtransform.analysis_window(4096)),
    )
    np.testing.assert_array_equal(
        transform.synthesis_window(CFG).numpy(),
        np.asarray(jtransform.synthesis_window(JCFG)),
    )


@pytest.mark.parametrize("n", [4096, 5000, 3 * 4096 + 17, 40000])
def test_frame_counts_match(n):
    assert transform.num_output_frames(n, CFG) == jtransform.num_output_frames(n, JCFG)
    assert transform.num_computed_frames(n, CFG) == jtransform.num_computed_frames(
        n, JCFG
    )
    assert transform.offline_pad_sizes(n, CFG) == jtransform.offline_pad_sizes(n, JCFG)


@pytest.mark.parametrize("n", [20000, 30001])
def test_frame_signal_matches(rng, n):
    x = _audio(rng, n)
    got = transform.frame_signal(torch.from_numpy(x), CFG, n).numpy()
    ref = np.asarray(jtransform.frame_signal(jnp.asarray(x), JCFG, n))
    np.testing.assert_array_equal(got, ref)


def test_pad_offline_matches(rng):
    x = _audio(rng, 10001)
    got = transform.pad_offline(torch.from_numpy(x), CFG).numpy()
    ref = np.asarray(jtransform.pad_offline(jnp.asarray(x), JCFG))
    np.testing.assert_array_equal(got, ref)


def test_stft_matches(rng):
    x = _audio(rng, 30000)
    got = transform.stft(torch.from_numpy(x), CFG, x.shape[-1]).numpy()
    ref = np.asarray(jtransform.stft(jnp.asarray(x), JCFG, x.shape[-1]))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max())


def test_overlap_add_matches(rng):
    frames = rng.standard_normal((2, 9, 4096)).astype(np.float32)
    got = transform.overlap_add(torch.from_numpy(frames), CFG).numpy()
    ref = np.asarray(jtransform.overlap_add(jnp.asarray(frames), JCFG))
    np.testing.assert_allclose(got, ref, atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_istft_matches(rng):
    x = _audio(rng, 30000)
    spec = np.asarray(jtransform.stft(jnp.asarray(x), JCFG, x.shape[-1]))
    mask = rng.uniform(0.0, 1.0, spec.shape).astype(np.float32)
    masked = spec * mask
    got = transform.istft(torch.from_numpy(masked), CFG).numpy()
    ref = np.asarray(jtransform.istft(jnp.asarray(masked), JCFG))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6 * max(1.0, np.abs(ref).max()))
