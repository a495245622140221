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


# ---------------------------------------------------------------------------
# The register-radix core's host side: its tables and its pass order
# ---------------------------------------------------------------------------


def test_radix_pass_twiddles_match_float64():
    """Each entry is the float64 exp rounded once to complex64 (atol 2**-24:
    half an ulp of a component in [0.5, 1)), in [r][k] order; the kernel's
    table is the 4096-point table followed by them."""
    tab = kernels.radix_pass_twiddles()
    r2, k2 = np.divmod(np.arange(256), 16)
    r3, j3 = np.divmod(np.arange(2048), 256)
    exact = np.concatenate([np.exp(2j * np.pi * r2 * k2 / 256),
                            np.exp(2j * np.pi * r3 * j3 / 2048)])
    assert tab.dtype == np.complex64 and tab.shape == (2304,)
    np.testing.assert_allclose(tab.real, exact.real, rtol=0, atol=2.0**-24)
    np.testing.assert_allclose(tab.imag, exact.imag, rtol=0, atol=2.0**-24)
    full = kernels.irfft_twiddles(torch.device("cpu")).numpy()
    assert np.array_equal(full[:2048], kernels.twiddles4096())
    assert np.array_equal(full[2048:], tab)


def _idft(v: np.ndarray) -> np.ndarray:
    """Unnormalised inverse DFT along the last axis."""
    m = np.arange(v.shape[-1])
    return v @ np.exp(2j * np.pi * np.outer(m, m) / v.shape[-1])


def _radix_model(y: np.ndarray) -> np.ndarray:
    """csrc/irfft.cu's order of work on the masked spectrum y (F, 2049):
    the Hermitian merge, then the three Stockham passes (radix 16, 16, 8)
    with the pass tables, then interleave and scale by 1/4096."""
    tab = kernels.radix_pass_twiddles().astype(np.complex128)
    t2, t3 = tab[:256].reshape(16, 16), tab[256:].reshape(8, 256)
    tw = np.exp(-2j * np.pi * np.arange(2048) / 4096).astype(np.complex64)
    y = y.astype(np.complex128)
    y[:, [0, 2048]] = y[:, [0, 2048]].real
    k = np.arange(2048)
    a, b = y[:, k], np.conj(y[:, 2048 - k])
    z = (a + b) + 1j * np.conj(tw) * (a - b)  # Z[k]
    n_frames = len(y)
    t = np.arange(128)
    # Pass 1 (Ns = 1): thread t takes Z[t + 128 r], writes 16 t + m.
    v = z.reshape(n_frames, 16, 128).transpose(0, 2, 1)
    buf = _idft(v).reshape(n_frames, 2048)
    # Pass 2 (Ns = 16): twiddle r (t mod 16) / 256, write (t / 16) 256 + t mod 16 + 16 m.
    v = buf.reshape(n_frames, 16, 128).transpose(0, 2, 1) * t2[:, t % 16].T
    dst = ((t // 16) * 256 + t % 16)[:, None] + 16 * np.arange(16)
    buf = np.empty_like(buf)
    buf[:, dst] = _idft(v)
    # Pass 3 (Ns = 256): items j < 256, twiddle r j / 2048, write j + 256 m.
    v = buf.reshape(n_frames, 8, 256).transpose(0, 2, 1) * t3.T
    z = _idft(v).transpose(0, 2, 1).reshape(n_frames, 2048)
    out = np.empty((n_frames, 4096))
    out[:, 0::2], out[:, 1::2] = z.real, z.imag
    return out / 4096


@pytest.mark.parametrize("bin_limit", [None, 1, 777, 2049])
def test_radix_pass_order_matches_numpy_irfft(rng, bin_limit):
    """The numpy model of the kernel's passes, unmasked (K8) and masked (K9)
    at the narrowest, an odd and the widest bin limit, equals np.fft.irfft of
    the masked spectrum to 1e-5 of max|x|."""
    spec = _spec(rng, (3,))
    if bin_limit is None:
        y = spec
    else:
        gains = np.full((3, 2049), 0.25, np.float32)
        gains[:, :bin_limit] = rng.uniform(0, 1, (3, bin_limit))
        y = spec * gains
    ref = np.fft.irfft(np.where(np.isin(np.arange(2049), [0, 2048]), y.real, y), n=4096)
    got = _radix_model(y)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
