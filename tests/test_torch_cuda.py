"""The CUDA kernels against their plain versions, on a card.

chip_smoke.py checks the kernels at the main path's shapes; these tests
add edge shapes: lengths that end mid-frame, one and three rows, the
narrowest and widest bin limits, spans that end mid-block. Where there is
no CUDA device every test skips. On a machine with one (which may lack
jax, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds: both sides are fp32 FFTs that round in another order; an
indexing fault gives errors of order max|X|, rounding about 1e-7 of it.
"""

import numpy as np
import pytest
import torch

from spleeterrt_tpu_torch.config import TransformConfig
from spleeterrt_tpu_torch.core import transform
from spleeterrt_tpu_torch.kernels import stft_fused

pytestmark = pytest.mark.cuda

TCFG = TransformConfig()


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(device, rows, n, time_step):
    rng = np.random.default_rng(rows * 1_000_003 + n)
    audio = torch.from_numpy(
        (rng.standard_normal((rows, n)) * 0.3).astype(np.float32)
    ).to(device)
    n_out = transform.num_output_frames(n, TCFG)
    n_comp = transform.num_computed_frames(n, TCFG)
    n_req = -(-n_out // time_step) * time_step
    return audio, n_out, n_comp, n_req


SHAPES = [  # rows, samples, bin_limit, time_step
    (2, 50_000, 512, 64),
    (1, 3 * 4096 + 5, 2048, 64),
    (3, 123_457, 1536, 256),
    (2, 300_001, 1024, 128),
]


@pytest.mark.parametrize("rows,n,bin_limit,time_step", SHAPES)
def test_stft_kernel_matches_plain(device, rows, n, bin_limit, time_step):
    audio, _, n_comp, n_req = _inputs(device, rows, n, time_step)
    args = (audio, transform.analysis_window(4096, device=device), n_comp,
            n_req, bin_limit, time_step)
    before = stft_fused.stft4096.launches
    spec, mag = stft_fused.stft4096(*args)
    assert stft_fused.stft4096.launches == before + 1
    pspec, pmag = stft_fused.stft4096_plain(*args)
    bound = 1e-5 * pspec.abs().max().item()
    assert (spec - pspec).abs().max().item() <= bound
    assert (mag - pmag).abs().max().item() <= bound
    assert torch.all(spec[:, n_comp:] == 0)


@pytest.mark.parametrize("rows,n,bin_limit,time_step", SHAPES)
@pytest.mark.parametrize("n_stems", [1, 4])
def test_masked_istft_kernel_matches_plain(
    device, rows, n, bin_limit, time_step, n_stems
):
    audio, n_out, n_comp, n_req = _inputs(device, rows, n, time_step)
    spec, _ = stft_fused.stft4096_plain(
        audio, transform.analysis_window(4096, device=device), n_comp, n_req,
        bin_limit, time_step,
    )
    gen = torch.Generator(device=device).manual_seed(n_stems)
    nt = n_req // time_step
    masks = torch.rand((n_stems, nt, rows, time_step, bin_limit),
                       generator=gen, device=device)
    out_band = torch.rand((n_stems,), generator=gen, device=device)
    args = (spec, masks, out_band,
            transform.synthesis_window(TCFG, device=device), n_out)
    before = stft_fused.masked_istft4096.launches
    y = stft_fused.masked_istft4096(*args)
    assert stft_fused.masked_istft4096.launches == before + 1
    py = stft_fused.masked_istft4096_plain(*args)
    assert y.shape == py.shape == (n_stems, rows, n_out * 1024 + 3072)
    assert (y - py).abs().max().item() <= 1e-5 * max(1.0, py.abs().max().item())
    assert torch.equal(y, stft_fused.masked_istft4096(*args))  # deterministic


def test_kernel_wrappers_refuse_mixed_devices(device):
    audio, n_out, n_comp, n_req = _inputs(device, 2, 20_000, 64)
    with pytest.raises(ValueError, match="window"):
        stft_fused.stft4096(audio, transform.analysis_window(4096), n_comp,
                            n_req, 512, 64)
    spec, _ = stft_fused.stft4096(
        audio, transform.analysis_window(4096, device=device), n_comp, n_req,
        512, 64,
    )
    masks = torch.zeros((1, n_req // 64, 2, 64, 512))
    with pytest.raises(ValueError, match="masks"):
        stft_fused.masked_istft4096(
            spec, masks, torch.ones(1, device=device),
            transform.synthesis_window(TCFG, device=device), n_out,
        )
