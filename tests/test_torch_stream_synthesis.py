"""The streaming synthesis wrapper (`kernels/stream_synthesis.py`) on the
CPU: its plain version against the chain the block step ran before it
(the mask multiply, `transform.irfft` and the tails' overlap-add), bit for
bit, and against a float64 numpy reference of the engine's synthesis, hop
by hop; and its refusals, which count no launch. The kernel itself is held
to the plain version on a card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.core import transform
from spleeterrt_tpu_torch.kernels import stream_synthesis as ss
from spleeterrt_tpu_torch.runtime import stream

torch.set_num_threads(2)

OUT_BAND = (0.25, 0.0, 0.25, 0.7)


def _args(k, s, t, bin_limit, seed=0):
    gen = torch.Generator().manual_seed(seed * 7919 + k * 101 + s * 13 + t + bin_limit)
    re, im = torch.randn((2, k, 2, t, ss.N_BINS), generator=gen)
    spec2 = torch.complex(re, im)
    masks2 = torch.rand((s, k, 2, t, bin_limit), generator=gen)
    out_band = torch.tensor(OUT_BAND[:s], dtype=torch.float32)
    _, ws = stream.window_tensors(1.0, torch.device("cpu"))
    ola_tail = 0.1 * torch.randn((k, s, 2, ss.HOP), generator=gen)
    return spec2, masks2, out_band, ws, ola_tail


def _numpy_synthesis(spec2, masks2, out_band, ws, ola_tail):
    """The engine's synthesis in float64, frame by frame: each stem's masked
    spectrum, its inverse FFT's last 2048 samples times ws, and out hop f =
    tail_f[:1024] + tail_{f-1}[1024:] after the carry."""
    x = spec2.numpy().astype(np.complex128)
    m = masks2.numpy().astype(np.float64)
    ob, w = out_band.numpy().astype(np.float64), ws.numpy().astype(np.float64)
    carry = ola_tail.numpy().astype(np.float64).copy()
    k, _, t, _ = x.shape
    s, bl = m.shape[0], m.shape[-1]
    out = np.zeros((k, s, 2, t * ss.HOP))
    for si in range(s):
        y = x.copy()
        y[..., :bl] *= m[si]
        y[..., bl:] *= ob[si]
        y[..., 0] = y[..., 0].real
        y[..., -1] = y[..., -1].real
        tails = np.fft.irfft(y, n=ss.N, axis=-1)[..., ss.SAMPLE_SHIFT:] * w
        for f in range(t):
            out[:, si, :, f * ss.HOP:(f + 1) * ss.HOP] = (
                tails[..., f, :ss.HOP] + carry[:, si])
            carry[:, si] = tails[..., f, ss.HOP:]
    return out, carry


@pytest.mark.parametrize("n_stems", [2, 4])
@pytest.mark.parametrize("frames", [1, 37, 64])
@pytest.mark.parametrize("bin_limit", [1, 777, 2049])
def test_plain_version_is_the_chain_it_replaced(n_stems, frames, bin_limit):
    """The wrapper's CPU path returns what masked_spectrum -> transform.irfft
    -> synthesize returned in the block step, bit for bit, carry included,
    and both within 1e-5 of the peak of a float64 reference."""
    args = _args(2, n_stems, frames, bin_limit)
    spec2, masks2, out_band, ws, ola_tail = args
    kernels.reset_launch_counts()
    out, tail = ss.stream_synthesis4096(*args)
    assert not any(kernels.launch_counts().values())
    chain = ss.synthesize(
        transform.irfft(ss.masked_spectrum(spec2, masks2, out_band), 4096),
        ola_tail, ws)
    assert out.shape == (2, n_stems, 2, frames * ss.HOP)
    assert tail.shape == (2, n_stems, 2, ss.HOP) and tail.is_contiguous()
    assert torch.equal(out, chain[0]) and torch.equal(tail, chain[1])
    ref, ref_tail = _numpy_synthesis(*args)
    peak = max(np.abs(ref).max(), np.abs(ref_tail).max())
    assert peak > 0.01
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * peak
    assert np.abs(tail.numpy() - ref_tail).max() <= 1e-5 * peak


def test_carry_joins_blocks_as_one_run():
    """Two half blocks, the first's carry fed to the second, give the whole
    block's output and carry: the carry is the only state between blocks."""
    spec2, masks2, out_band, ws, ola_tail = _args(1, 2, 16, 300, seed=1)
    whole, whole_tail = ss.stream_synthesis4096(spec2, masks2, out_band, ws, ola_tail)
    a, tail_a = ss.stream_synthesis4096(
        spec2[:, :, :8].contiguous(), masks2[..., :8, :].contiguous(), out_band, ws,
        ola_tail)
    b, tail_b = ss.stream_synthesis4096(
        spec2[:, :, 8:].contiguous(), masks2[..., 8:, :].contiguous(), out_band, ws,
        tail_a)
    torch.testing.assert_close(torch.cat([a, b], -1), whole, rtol=0, atol=1e-6)
    torch.testing.assert_close(tail_b, whole_tail, rtol=0, atol=1e-6)


def _bad(case):
    spec2, masks2, out_band, ws, ola_tail = _args(1, 2, 3, 64)
    meta = torch.device("meta")
    return {
        "spec2 dtype": ((spec2.to(torch.complex128), masks2, out_band, ws, ola_tail),
                        "complex64"),
        "masks2 dtype": ((spec2, masks2.double(), out_band, ws, ola_tail), "float32"),
        "masks2 frames": ((spec2, masks2[..., :2, :].contiguous(), out_band, ws,
                           ola_tail), "masks2: expected"),
        "bin_limit past the bins": ((spec2, torch.rand((2, 1, 2, 3, 2050)), out_band,
                                     ws, ola_tail), "masks2: expected"),
        "spec2 bins": ((spec2[..., :2048].contiguous(), masks2, out_band, ws, ola_tail),
                       "spec2: expected"),
        "out_band length": ((spec2, masks2, out_band[:1].contiguous(), ws, ola_tail),
                            "out_band: expected 2"),
        "ws length": ((spec2, masks2, out_band, ws[:1024].contiguous(), ola_tail),
                      "ws must have 2048"),
        "ola_tail shape": ((spec2, masks2, out_band, ws, ola_tail[:, :1].contiguous()),
                           "ola_tail: expected"),
        "ola_tail not contiguous": ((spec2, masks2, out_band, ws,
                                     ola_tail.repeat(1, 1, 1, 2)[..., ::2]),
                                    "contiguous"),
        "mixed devices": ((spec2, masks2.to(meta), out_band, ws, ola_tail),
                          "masks2 is on meta"),
        "no frames": ((spec2[:, :, :0].contiguous(), masks2[..., :0, :].contiguous(),
                       out_band, ws, ola_tail), "at least one"),
    }[case]


@pytest.mark.parametrize("case", [
    "spec2 dtype", "masks2 dtype", "masks2 frames", "bin_limit past the bins",
    "spec2 bins", "out_band length", "ws length", "ola_tail shape",
    "ola_tail not contiguous", "mixed devices", "no frames"])
def test_wrapper_refuses_bad_inputs_without_a_launch(case):
    args, match = _bad(case)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        ss.stream_synthesis4096(*args)
    assert not any(kernels.launch_counts().values())


def test_wrapper_refuses_grad():
    spec2, masks2, out_band, ws, ola_tail = _args(1, 2, 3, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        ss.stream_synthesis4096(spec2, masks2.requires_grad_(), out_band, ws, ola_tail)


def test_out_band_tensor_is_cached():
    """The block step's out-of-band weights are made once a device, like
    its windows, not copied to the device every step."""
    cpu = torch.device("cpu")
    a = stream.out_band_tensor((0.25, 0.0), cpu)
    assert a is stream.out_band_tensor((0.25, 0.0), cpu)
    assert a.dtype == torch.float32 and a.tolist() == [0.25, 0.0]
