"""The fused STFT / masked iSTFT wrappers' plain versions against the JAX
package's Pallas kernels (run in interpret mode, as tests/test_stft_fused.py
runs them on the CPU).

The CUDA kernels themselves run only on a card; chip_smoke.py holds them
against these plain versions there. Here the wrappers receive CPU tensors,
so they take the plain versions and launch nothing.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spleeterrt_tpu.config import SeparatorConfig as JSeparatorConfig
from spleeterrt_tpu.core import separate as jseparate
from spleeterrt_tpu.core import transform as jtransform
from spleeterrt_tpu.kernels import stft_fused as jstft_fused
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.config import SeparatorConfig
from spleeterrt_tpu_torch.core import separate, transform
from spleeterrt_tpu_torch.kernels import stft_fused

torch.set_num_threads(2)

CFG = SeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                      compute_dtype=torch.float32)
JCFG = JSeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                        compute_dtype=jnp.float32)


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    jstft_fused.stft4096_packed.clear_cache()
    jstft_fused.masked_istft4096_cd.clear_cache()
    yield
    jstft_fused.stft4096_packed.clear_cache()
    jstft_fused.masked_istft4096_cd.clear_cache()


def _setup(rng, n=90000):
    """Padded audio and the frame counts of the 4-stem graph."""
    audio = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    padded = transform.pad_offline(torch.from_numpy(audio), CFG.transform)
    ds = padded.shape[-1]
    n_out = transform.num_output_frames(ds, CFG.transform)
    n_comp = transform.num_computed_frames(ds, CFG.transform)
    n_req = separate.num_tiles(n_out, CFG.time_step) * CFG.time_step
    return padded.contiguous(), n_out, n_comp, n_req


def _stft(padded, n_comp, n_req):
    return stft_fused.stft4096(
        padded, transform.analysis_window(4096), n_comp, n_req,
        CFG.bin_limit, CFG.time_step,
    )


def test_stft_plain_matches_jax_kernel(rng, interpret_pallas):
    padded, n_out, n_comp, n_req = _setup(rng)
    spec, mag = _stft(padded, n_comp, n_req)
    s_r, s_i = jstft_fused.stft4096_packed(
        jnp.asarray(padded.numpy()), jtransform.analysis_window(4096),
        n_comp, n_req,
    )
    ref = np.asarray(jstft_fused.packed_to_complex(s_r, s_i))[:, :n_req]
    scale = np.abs(ref).max()
    assert spec.shape == ref.shape
    np.testing.assert_allclose(spec.numpy(), ref, atol=2e-6 * scale)
    assert np.all(spec.numpy()[:, n_comp:] == 0)

    # mag is the U-Net's NCHW tile batch: (n_tiles, 2ch, time_step, bins).
    ref_mag = np.asarray(jstft_fused.packed_magnitude(s_r, s_i, CFG.bin_limit))
    nt = n_req // CFG.time_step
    ref_tiles = ref_mag.reshape(2, nt, CFG.time_step, CFG.bin_limit).transpose(
        1, 0, 2, 3
    )
    np.testing.assert_allclose(mag.numpy(), ref_tiles, atol=2e-6 * scale)
    frames = mag.numpy().transpose(1, 0, 2, 3).reshape(2, n_req, -1)
    assert np.all(frames[:, n_comp:] == 0)


def test_masked_istft_plain_matches_jax_kernel(rng, interpret_pallas):
    padded, n_out, n_comp, n_req = _setup(rng)
    spec, _ = _stft(padded, n_comp, n_req)
    s_r, s_i = jstft_fused.stft4096_packed(
        jnp.asarray(padded.numpy()), jtransform.analysis_window(4096),
        n_comp, n_req,
    )
    nt = n_req // CFG.time_step
    s = len(separate.OUT_BAND_4)
    masks_cf = rng.uniform(0.0, 1.0, (s, 2, n_req, CFG.bin_limit)).astype(
        np.float32
    )
    ref = np.asarray(
        jstft_fused.masked_istft4096_packed(
            s_r, s_i, jnp.asarray(masks_cf), jnp.asarray(jseparate.OUT_BAND_4),
            JCFG.bin_limit, jtransform.synthesis_window(JCFG.transform), n_out,
        )
    )
    # The same masks in the layout the torch U-Net emits:
    # (S, n_tiles, 2ch, time_step, bins).
    masks = torch.from_numpy(
        masks_cf.reshape(s, 2, nt, CFG.time_step, CFG.bin_limit)
        .transpose(0, 2, 1, 3, 4).copy()
    )
    got = stft_fused.masked_istft4096(
        spec, masks, torch.tensor(separate.OUT_BAND_4),
        transform.synthesis_window(CFG.transform), n_out,
    ).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6 * max(1.0, np.abs(ref).max()))


def test_mask_of_ones_roundtrip(rng):
    """Unity gain: mask of ones and out_band 1.0 reproduce the input
    (the reference's scale-chain contract, Executable/stftFix.c)."""
    padded, n_out, n_comp, n_req = _setup(rng, n=70000)
    spec, _ = _stft(padded, n_comp, n_req)
    nt = n_req // CFG.time_step
    ones = torch.ones((1, nt, 2, CFG.time_step, CFG.bin_limit))
    out = stft_fused.masked_istft4096(
        spec, ones, torch.tensor([1.0]),
        transform.synthesis_window(CFG.transform), n_out,
    )[0].numpy()
    x = padded.numpy()
    n = 4096
    ds = x.shape[-1]
    np.testing.assert_allclose(out[:, n : ds - n], x[:, n : ds - n], atol=5e-6)


def test_wrappers_take_plain_path_on_cpu(rng):
    """CPU tensors go to the plain versions: outputs equal them exactly
    and the launch counters stay at 0."""
    kernels.reset_launch_counts()
    padded, n_out, n_comp, n_req = _setup(rng, n=20000)
    win = transform.analysis_window(4096)
    spec, mag = _stft(padded, n_comp, n_req)
    pspec, pmag = stft_fused.stft4096_plain(
        padded, win, n_comp, n_req, CFG.bin_limit, CFG.time_step
    )
    assert torch.equal(spec, pspec) and torch.equal(mag, pmag)

    nt = n_req // CFG.time_step
    masks = torch.rand((4, nt, 2, CFG.time_step, CFG.bin_limit),
                       generator=torch.Generator().manual_seed(0))
    args = (spec, masks, torch.tensor(separate.OUT_BAND_4),
            transform.synthesis_window(CFG.transform), n_out)
    assert torch.equal(
        stft_fused.masked_istft4096(*args), stft_fused.masked_istft4096_plain(*args)
    )
    assert not any(kernels.launch_counts().values())


def test_wrappers_reject_bad_inputs(rng):
    padded, n_out, n_comp, n_req = _setup(rng, n=20000)
    win = transform.analysis_window(4096)
    with pytest.raises(ValueError, match="float32"):
        stft_fused.stft4096(padded.double(), win, n_comp, n_req, 512, 64)
    with pytest.raises(ValueError, match="contiguous"):
        stft_fused.stft4096(padded.t().contiguous().t(), win, n_comp, n_req, 512, 64)
    with pytest.raises(ValueError, match="time_step"):
        stft_fused.stft4096(padded, win, n_comp, n_req + 1, 512, 64)
    spec, _ = stft_fused.stft4096(padded, win, n_comp, n_req, 512, 64)
    masks = torch.zeros((4, n_req // 64, 2, 64, 512))
    with pytest.raises(ValueError, match="stems"):
        stft_fused.masked_istft4096(
            spec, masks, torch.zeros(3), transform.synthesis_window(CFG.transform),
            n_out,
        )


def _k7_emulation(spec, masks, out_band, window, n_frames, run_hops):
    """K7's overlap-add in torch, as csrc/istft.cu orders it: the frames
    (irfft of the masked spectrum, times the window) of one (stem, row)
    are walked in runs of run_hops output hops, each run starting with the
    three frames before it (their own hops belong to the run before).
    Thread t of a group owns output positions 2t + e + 256 j (e < 2) in a
    ring of 16 slots, slot j mod 16; frame f adds its samples 256 q + 2t +
    e to j = 4f + q (q < 16), in frame order, and then hop f (slots 4f to
    4f + 3) is final: stored if the run owns it, and cleared. Hops past the
    last frame only store."""
    y = stft_fused.masked_bins(spec, masks, out_band, n_frames)
    s_n, rows = y.shape[:2]
    y[..., 0].imag.zero_()
    y[..., -1].imag.zero_()
    frames = torch.fft.irfft(y, n=4096, dim=-1) * window  # (S, rows, n_frames, 4096)
    n_hops = n_frames + 3
    out = torch.full((s_n, rows, n_hops * 1024), float("nan"))
    for s in range(s_n):
        for r in range(rows):
            for h0 in range(0, n_hops, run_hops):
                h1 = min(h0 + run_hops, n_hops)
                ring = torch.zeros(16, 256)  # [slot][2t + e]
                for fr in range(h0 - 3, h1):
                    if 0 <= fr < n_frames:
                        ring[(4 * fr + torch.arange(16)) % 16] += frames[s, r, fr].view(16, 256)
                    final = (4 * fr + torch.arange(4)) % 16
                    if fr >= h0:
                        out[s, r, 1024 * fr : 1024 * fr + 1024] = ring[final].flatten()
                    ring[final] = 0
    return out


@pytest.mark.parametrize("bin_limit", [1, 1024, 2049])
@pytest.mark.parametrize("n_frames", [
    1, 3, stft_fused.RUN_HOPS - 1, stft_fused.RUN_HOPS + 1,
    3 * stft_fused.RUN_HOPS + 5,  # several runs and a remainder
])
@pytest.mark.parametrize("n_stems", [1, 3, 4])
def test_k7_register_overlap_add_matches_plain(rng, n_stems, n_frames, bin_limit):
    """K7's ownership of output positions by thread and its run-with-carry
    walk, emulated in torch, give masked_istft4096_plain's audio to 1e-6 of
    its largest sample, with every output position written exactly once."""
    time_step, rows = 8, 2
    nt = -(-n_frames // time_step)
    spec = torch.complex(*(torch.from_numpy(
        rng.standard_normal((rows, nt * time_step, 2049)).astype(np.float32))
        for _ in range(2)))
    masks = torch.from_numpy(rng.uniform(0.0, 1.0, (
        n_stems, nt, rows, time_step, bin_limit)).astype(np.float32))
    out_band = torch.from_numpy(rng.uniform(0.0, 1.0, n_stems).astype(np.float32))
    window = transform.synthesis_window(CFG.transform)
    ref = stft_fused.masked_istft4096_plain(spec, masks, out_band, window, n_frames)
    got = _k7_emulation(spec, masks, out_band, window, n_frames, stft_fused.RUN_HOPS)
    assert got.shape == ref.shape == (n_stems, rows, n_frames * 1024 + 3072)
    assert not torch.isnan(got).any()
    assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


# ---------------------------------------------------------------------------
# K1's order of work on the register-radix core
# ---------------------------------------------------------------------------


def _pad(i):
    """fft2048_radix.cuh::radix_pad: one float2 of padding after every 16."""
    return i + (i >> 4)


def _idft(v: np.ndarray) -> np.ndarray:
    """Unnormalised inverse DFT along the last axis."""
    m = np.arange(v.shape[-1])
    return v @ np.exp(2j * np.pi * np.outer(m, m) / v.shape[-1])


def _k1_model(x: np.ndarray, window: np.ndarray) -> np.ndarray:
    """csrc/stft.cu's order of work on frames x (F, 4096): thread t of a
    group loads conj z[t + 128 r], z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1];
    the inverse core's three Stockham passes (radix 16, 16, 8) with the
    pass tables leave conj Z[t + 128 q] in thread t; Z goes through the
    padded exchange buffer, and bin k = t + 128 q is split from Z[k] and
    Z[2048 - k] with tw[k], DC and Nyquist from Z[0]."""
    tab = kernels.radix_pass_twiddles().astype(np.complex128)
    t2, t3 = tab[:256].reshape(16, 16), tab[256:].reshape(8, 256)
    tw = kernels.twiddles4096().astype(np.complex128)
    xw = (x * window).astype(np.float32).astype(np.float64)
    v = np.conj(xw[:, 0::2] + 1j * xw[:, 1::2])  # (F, 2048): conj z
    n_frames = len(v)
    t = np.arange(128)
    # Pass 1 (Ns = 1): thread t takes v[t + 128 r], writes 16 t + m.
    buf = _idft(v.reshape(n_frames, 16, 128).transpose(0, 2, 1)).reshape(n_frames, 2048)
    # Pass 2 (Ns = 16): twiddle r (t mod 16) / 256, write (t / 16) 256 + t mod 16 + 16 m.
    u = buf.reshape(n_frames, 16, 128).transpose(0, 2, 1) * t2[:, t % 16].T
    dst = ((t // 16) * 256 + t % 16)[:, None] + 16 * np.arange(16)
    buf = np.empty_like(buf)
    buf[:, dst] = _idft(u)
    # Pass 3 (Ns = 256): items j < 256, twiddle r j / 2048, write j + 256 m.
    u = buf.reshape(n_frames, 8, 256).transpose(0, 2, 1) * t3.T
    y = _idft(u).transpose(0, 2, 1).reshape(n_frames, 2048)  # conj Z, natural order
    # The exchange: thread t writes conj Z[t + 128 q] at radix_pad(t + 128 q).
    ex = np.full((n_frames, _pad(2048)), np.nan, np.complex128)
    ex[:, _pad(np.arange(2048))] = y
    k = np.arange(1, 2048)
    zk = np.conj(y[:, k])
    zc = np.conj(ex[:, _pad(2048 - k)])  # Z[2048 - k]
    e = 0.5 * (zk + np.conj(zc))
    o = (zk - np.conj(zc)) / 2j
    out = np.empty((n_frames, 2049), np.complex128)
    out[:, 1:2048] = e + tw[k] * o
    z0 = np.conj(y[:, 0])
    out[:, 0], out[:, 2048] = z0.real + z0.imag, z0.real - z0.imag
    return out


def test_k1_radix_order_matches_numpy_rfft(rng):
    """The numpy model of K1's conjugated Stockham passes and its split
    through the exchange buffer equals np.fft.rfft of the windowed frames
    to 1e-5 of max|X|."""
    x = rng.standard_normal((3, 4096)).astype(np.float32) * 0.3
    window = transform.analysis_window(4096).numpy()
    got = _k1_model(x, window)
    ref = np.fft.rfft(x.astype(np.float64) * window, n=4096)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
