"""The frames-out inverse FFT wrappers' plain versions (K8 `irfft4096`, K9
`masked_irfft4096`) against the JAX package's Pallas kernels, run in
interpret mode as tests/test_pallas_fft.py runs them on the CPU, with that
file's tolerances: 1e-6, and 1e-5 for the masked form.

The CUDA kernel itself runs only on a card (chip_smoke.py and
tests/test_torch_cuda.py hold it against these plain versions there).
Here the wrappers receive CPU tensors, so they take the plain versions and
launch nothing.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import spleeterrt_tpu.kernels.pallas_fft as jpf
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.config import TransformConfig
from spleeterrt_tpu_torch.core import transform
from spleeterrt_tpu_torch.kernels import pallas_fft

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    jpf._irfft_call.clear_cache()
    jpf.masked_irfft4096_pallas.clear_cache()
    yield
    jpf._irfft_call.clear_cache()
    jpf.masked_irfft4096_pallas.clear_cache()


def _spec(rng, shape):
    return (rng.standard_normal((*shape, 2049))
            + 1j * rng.standard_normal((*shape, 2049))).astype(np.complex64)


@pytest.mark.parametrize("shape,windowed", [
    ((3, 5), False),
    ((7,), True),
    ((jpf.FRAMES_PER_BLOCK + 3,), False),  # ragged for the TPU kernel
    ((2, jpf.FRAMES_PER_BLOCK + 3), True),
])
def test_irfft_plain_matches_jax_kernel(rng, interpret_pallas, shape, windowed):
    spec = _spec(rng, shape)
    w = rng.standard_normal(4096).astype(np.float32) if windowed else None
    key = jpf.register_window("_torch_test_w", w) if windowed else None
    ref = np.asarray(jpf.irfft4096_pallas(jnp.asarray(spec), key))
    got = pallas_fft.irfft4096(
        torch.from_numpy(spec), None if w is None else torch.from_numpy(w)
    ).numpy()
    assert got.shape == ref.shape == (*shape, 4096)
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("frames,bin_limit,windowed", [
    (7, 512, True),
    (jpf.FRAMES_PER_BLOCK + 3, 1536, False),
    (5, 2048, True),
])
def test_masked_irfft_plain_matches_jax_kernel(
    rng, interpret_pallas, frames, bin_limit, windowed
):
    spec = _spec(rng, (2, frames))
    masks = rng.uniform(0, 1, (3, 2, frames, bin_limit)).astype(np.float32)
    uw = np.asarray([0.25, 0.0, 0.1], np.float32)  # bass-like 0.0 included
    w = rng.standard_normal(4096).astype(np.float32) if windowed else None
    key = jpf.register_window("_torch_test_mw", w) if windowed else None
    ref = np.asarray(jpf.masked_irfft4096_pallas(
        jnp.asarray(spec), jnp.asarray(masks), jnp.asarray(uw), bin_limit, key
    ))
    got = pallas_fft.masked_irfft4096(
        torch.from_numpy(spec), torch.from_numpy(masks), torch.from_numpy(uw),
        bin_limit, None if w is None else torch.from_numpy(w),
    ).numpy()
    assert got.shape == ref.shape == (3, 2, frames, 4096)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_plain_versions_drop_dc_and_nyquist_imaginary_parts(rng):
    """irfft's semantics, which the kernel implements explicitly: the
    imaginary parts of bins 0 and 2048 do not reach the frame."""
    spec = _spec(rng, (4,))
    real_ends = spec.copy()
    real_ends[:, [0, -1]] = real_ends[:, [0, -1]].real
    got = pallas_fft.irfft4096_plain(torch.from_numpy(spec))
    ref = pallas_fft.irfft4096_plain(torch.from_numpy(real_ends))
    assert torch.equal(got, ref)
    np.testing.assert_allclose(
        got.numpy(), np.fft.irfft(real_ends, n=4096), atol=1e-6
    )


def test_wrappers_take_plain_path_on_cpu(rng):
    """CPU tensors go to the plain versions: outputs equal them exactly
    and the launch counters stay at 0."""
    kernels.reset_launch_counts()
    spec = torch.from_numpy(_spec(rng, (2, 3)))
    w = torch.rand(4096, generator=torch.Generator().manual_seed(0))
    assert torch.equal(pallas_fft.irfft4096(spec, w),
                       pallas_fft.irfft4096_plain(spec, w))
    masks = torch.rand((4, 2, 3, 512), generator=torch.Generator().manual_seed(1))
    ob = torch.tensor([0.25, 0.0, 0.25, 0.25])
    assert torch.equal(pallas_fft.masked_irfft4096(spec, masks, ob, 512, w),
                       pallas_fft.masked_irfft4096_plain(spec, masks, ob, 512, w))
    assert not any(kernels.launch_counts().values())


def test_wrappers_reject_bad_inputs(rng):
    spec = torch.from_numpy(_spec(rng, (2, 3)))
    masks = torch.zeros((4, 2, 3, 512))
    ob = torch.zeros(4)
    with pytest.raises(ValueError, match="complex64"):
        pallas_fft.irfft4096(spec.to(torch.complex128))
    with pytest.raises(ValueError, match="2049 bins"):
        pallas_fft.irfft4096(spec[..., :2048].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        pallas_fft.irfft4096(spec.transpose(0, 1))
    with pytest.raises(ValueError, match="4096 samples"):
        pallas_fft.irfft4096(spec, torch.ones(2048))
    with pytest.raises(ValueError, match="frames"):
        pallas_fft.irfft4096(spec[:0])
    with pytest.raises(ValueError, match="masks"):
        pallas_fft.masked_irfft4096(spec, masks, ob, 1024)
    with pytest.raises(ValueError, match="masks"):
        pallas_fft.masked_irfft4096(spec, masks[:, :1], ob, 512)
    with pytest.raises(ValueError, match="out_band"):
        pallas_fft.masked_irfft4096(spec, masks, ob[:3], 512)


def test_transform_irfft_routes_by_length(rng):
    """n = 4096 goes through the K8 wrapper, any other n to torch.fft; the
    canonical istft takes the K8 route with the synthesis window."""
    kernels.reset_launch_counts()
    spec = torch.from_numpy(_spec(rng, (3,)))
    w = torch.rand(4096, generator=torch.Generator().manual_seed(2))
    assert torch.equal(transform.irfft(spec, 4096, w),
                       pallas_fft.irfft4096_plain(spec, w))
    half = spec[..., :1025].contiguous()
    assert torch.equal(transform.irfft(half, 2048),
                       torch.fft.irfft(half, n=2048, dim=-1))
    cfg = TransformConfig()
    frames = pallas_fft.irfft4096_plain(
        spec, transform.synthesis_window(cfg)
    )
    assert torch.equal(transform.istft(spec, cfg),
                       transform.overlap_add(frames, cfg))
    assert not any(kernels.launch_counts().values())
