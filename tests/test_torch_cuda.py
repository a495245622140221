"""The CUDA kernels against their plain versions, on a card.

chip_smoke.py checks the kernels at the main path's shapes; these tests
add edge shapes: for K1/K7 lengths that end mid-frame, one and three rows,
the narrowest and widest bin limits, for K1 odd lengths (rows off 8-byte
alignment), zero frames past n_comp and 1 to 4 frames a block with the
last block partly empty (run twice, bit-identical), and for K7 1, 3, 4 and 5 stems and
frame counts below one run of its register overlap-add and past several
(run twice, bit-identical); for K2-K6
the smallest tiles the packed U-Net admits (T = F = 64; K2/K3 also T = 32),
one tile and an odd tile count, one stem and four, both compute dtypes;
bf16 K2 with 1, 2, 3 and 5 stems, H/2 = 1 and widths that are not a
multiple of its pixel tile (run twice, bit-identical), refusing a
magnitude off 8-byte alignment; bf16 K3 and bf16 K4/K5 (the tensor-core templates) with one image, an
output or input height of 1, widths that are not a multiple of the
32-column tile (K4/K5 also W = 8) and two stems over three images each,
each run twice (bit-identical), and K4/K5 refusing a source off 16-byte
alignment; bf16 K6 (its tensor-core template) with one image, H/2 = 1, a
width that is not a multiple of the mask tile (and one whose masks' rows
are not a multiple of 4) and two stems over three images each with odd
H/2, held per pixel to tail.head_error_bound, run twice (bit-identical)
and equal to K10 on the concatenated sources, and K6 and K10 refusing a
bf16 source off 16-byte alignment; for
K8/K9 one frame and odd frame counts, bin limits 1, 512, 777, 2048 and
2049, with and without a window; for K10 one row tile, F/2 = 16, S * B = 1 and 64
and the round-3 route; for the streaming synthesis K = 1, 3 and 64 streams,
T = 1, 37 and 256 frames, bin limits 1, 512, 1536 and 2049, a carry in,
1, 2 and 5 stems, runs of 1 to 300 hops and 1 or 2 groups a block (run
twice, bit-identical); one streaming block step at K = 1; K1 and K7 with
1 to 5 tracks folded into their rows at an odd tile count (each track bit
for bit its lone launch); the 2-, 3- and 4-stem batch graphs' launch
counts over three tracks; every wrapper refusing a grid past CUDA's
65535 blocks in y or z; and `separate.separate` replaying a captured
CUDA graph (core/replay.py) at 30 to 35 s (one tile count, one graph),
2 and 4 stems in bf16, bit for bit its eager answers under
cudnn.deterministic, with kept answers intact after later replays,
weights changed in place seen by the next replay, the counter's eager,
capture and replay counts, and no wrapper launch counted for a capture or
a replay.
Where there is no CUDA device every test skips. On a machine with one
(which may lack jax, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Bounds: K1/K7/K8/K9 are fp32 FFTs that round in another order; an indexing
fault gives errors of order max|X|, rounding about 1e-7 of it. K2-K5 sum
in fp32 like their plain versions (TF32 off): 1e-5 of max|plain| in fp32;
in bf16 the outputs round once, so a sum that lands on the other side of
a rounding boundary differs by one ulp: 2 bf16 ulps of max|plain|. K6's
masks are held pixel by pixel to tail.head_error_bound, K10's to the same
bound on x's two halves.
"""

import math

import numpy as np
import pytest
import torch

from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.config import SeparatorConfig, TransformConfig
from spleeterrt_tpu_torch.core import model, replay, separate, transform, weights
from spleeterrt_tpu_torch.kernels import (
    encoder,
    mask_head,
    pallas_fft,
    stft_fused,
    stream_synthesis,
    tail,
)
from spleeterrt_tpu_torch.runtime import stream

pytestmark = pytest.mark.cuda

TCFG = TransformConfig()


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # the plain versions' convs
    torch.backends.cuda.matmul.allow_tf32 = False
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
    (1, 3 * 4096 + 5, 2048, 64),  # 12 frames: below one K7 run
    (3, 123_457, 1536, 256),
    (2, 300_001, 1024, 128),
]


@pytest.mark.parametrize("rows,n,bin_limit,time_step", SHAPES)
def test_stft_kernel_matches_plain(device, rows, n, bin_limit, time_step):
    audio, _, n_comp, n_req = _inputs(device, rows, n, time_step)
    args = (audio, transform.analysis_window(4096, device=device), n_comp,
            n_req, bin_limit, time_step)
    before = kernels.launch_counts()["stft4096"]
    spec, mag = stft_fused.stft4096(*args)
    assert kernels.launch_counts()["stft4096"] == before + 1
    pspec, pmag = stft_fused.stft4096_plain(*args)
    bound = 1e-5 * pspec.abs().max().item()
    assert (spec - pspec).abs().max().item() <= bound
    assert (mag - pmag).abs().max().item() <= bound
    assert torch.all(spec[:, n_comp:] == 0)
    spec2, mag2 = stft_fused.stft4096(*args)
    assert torch.equal(spec, spec2) and torch.equal(mag, mag2)  # deterministic


K1_EDGES = [  # rows, samples, bin_limit, time_step, extra frames past n_out
    (1, 3 * 4096 + 5, 2049, 1, 0),  # one row, odd length, the widest bin limit
    (3, 40_001, 1, 1, 3),  # odd rows misaligned, narrowest bin limit
    (3, 9 * 1024 + 7, 777, 1, 2),  # 10 frames + 2 zero frames
    (2, 50_000, 512, 7, 0),  # frames a multiple of 7, not of the groups
]


@pytest.mark.parametrize("groups", [1, 2, 3, 4])
@pytest.mark.parametrize("rows,n,bin_limit,time_step,extra", K1_EDGES)
def test_stft_kernel_at_edges(device, monkeypatch, groups, rows, n, bin_limit,
                              time_step, extra):
    """K1 with 1 to 4 frames a block: odd data_size (row starts off 8-byte
    alignment), frames past n_comp (exact zeros), frame counts that leave
    the last block's groups partly empty, bin limits 1, 777 and 2049;
    against the plain version to 1e-5 of max|X|, bit-identical over two
    runs."""
    monkeypatch.setattr(stft_fused, "STFT_GROUPS", groups)
    audio, n_out, n_comp, _ = _inputs(device, rows, n, time_step)
    n_req = -(-(n_out + extra) // time_step) * time_step
    assert n_comp < n_req
    args = (audio, transform.analysis_window(4096, device=device), n_comp,
            n_req, bin_limit, time_step)
    spec, mag = _counted("stft4096", stft_fused.stft4096, *args)
    pspec, pmag = stft_fused.stft4096_plain(*args)
    bound = 1e-5 * pspec.abs().max().item()
    assert (spec - pspec).abs().max().item() <= bound
    assert (mag - pmag).abs().max().item() <= bound
    assert torch.all(spec[:, n_comp:] == 0)
    spec2, mag2 = stft_fused.stft4096(*args)
    assert torch.equal(spec, spec2) and torch.equal(mag, mag2)


@pytest.mark.parametrize("rows,n,bin_limit,time_step", SHAPES)
@pytest.mark.parametrize("n_stems", [1, 3, 4, 5])
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
    before = kernels.launch_counts()["masked_istft4096"]
    y = stft_fused.masked_istft4096(*args)
    assert kernels.launch_counts()["masked_istft4096"] == before + 1
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


# ---------------------------------------------------------------------------
# K2-K6: the packed U-Net kernels
# ---------------------------------------------------------------------------


def _bound(ref: torch.Tensor, dtype) -> float:
    m = ref.float().abs().max().item()
    if dtype == torch.float32:
        return 1e-5 * m
    return 2 * 2.0 ** (math.floor(math.log2(m)) - 7)  # 2 bf16 ulps of m


def _layer(gen, n_stems, w_shape, width, device):
    """Stacked random (w, b, bn_scale, bn_shift) with random biases and
    batch norms; w scaled by its fan-in."""
    fan_in = math.prod(w_shape[1:]) if len(w_shape) == 4 else 1
    w = torch.randn((n_stems, *w_shape), generator=gen) * math.sqrt(2.0 / fan_in)
    b = 0.1 * torch.randn((n_stems, width), generator=gen)
    scale = 1 + 0.3 * torch.randn((n_stems, width), generator=gen)
    shift = 0.2 * torch.randn((n_stems, width), generator=gen)
    return tuple(t.to(device) for t in (w, b, scale, shift))


def _assert_close(got, ref, dtype, what):
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= _bound(ref, dtype), f"{what}: max error {err}"


def _counted(name, fn, *args, **kw):
    before = kernels.launch_counts()[name]
    out = fn(*args, **kw)
    assert kernels.launch_counts()[name] == before + 1
    return out


DTYPES = [torch.float32, torch.bfloat16]
ENC_SHAPES = [  # stems, tiles, T, F
    (1, 1, 32, 64), (4, 3, 64, 64), (1, 3, 64, 128), (4, 1, 32, 128),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_stems,n_tiles,t,f", ENC_SHAPES)
def test_encoder_kernels_match_plain(device, dtype, n_stems, n_tiles, t, f):
    gen = torch.Generator().manual_seed(n_stems * 100 + n_tiles * 10 + t)
    mag = (torch.rand((n_tiles, 2, t, f), generator=gen) * 5).to(device)
    act = "elu" if n_stems == 4 else "leaky"
    ly = _layer(gen, n_stems, (16, 2, 5, 5), 16, device)
    skip, x = _counted("enc1", encoder.enc1, mag, *ly, act=act, dtype=dtype)
    pskip, px = encoder.enc1_plain(mag, *ly, act=act, dtype=dtype)
    _assert_close(skip, pskip, dtype, "enc1 skip")
    _assert_close(x, px, dtype, "enc1 act")
    for c in (16, 32, 64):
        ly = _layer(gen, n_stems, (2 * c, c, 5, 5), 2 * c, device)
        skip, y = _counted("enc_s2", encoder.enc_s2, px, *ly, act=act)
        pskip, py = encoder.enc_s2_plain(px, *ly, act=act)
        _assert_close(skip, pskip, dtype, f"enc_s2({c}) skip")
        _assert_close(y, py, dtype, f"enc_s2({c}) act")
        px = py


ENC1_EDGES = [  # stems, tiles, T, F
    (1, 1, 32, 64),  # one image
    (2, 2, 2, 80),  # H/2 = 1
    (3, 3, 22, 70),  # W/2 = 35, not a multiple of the pixel tile; odd H/2
    (5, 2, 18, 150),  # five stems, W/2 = 75
]


@pytest.mark.parametrize("n_stems,n_tiles,t,f", ENC1_EDGES)
def test_enc1_tensor_cores_at_edges(device, n_stems, n_tiles, t, f):
    """bf16 enc1 (the tensor-core template, every stem in one block) at
    ragged tiles and 1, 2, 3 and 5 stems, against the plain version to 2
    bf16 ulps, and bit-identical over two runs."""
    gen = torch.Generator().manual_seed(n_stems * 100 + n_tiles * 10 + t + f)
    mag = (torch.rand((n_tiles, 2, t, f), generator=gen) * 5).to(device)
    ly = _layer(gen, n_stems, (16, 2, 5, 5), 16, device)
    kw = {"act": "elu", "dtype": torch.bfloat16}
    skip, x = _counted("enc1", encoder.enc1, mag, *ly, **kw)
    pskip, px = encoder.enc1_plain(mag, *ly, **kw)
    _assert_close(skip, pskip, torch.bfloat16, "enc1 skip")
    _assert_close(x, px, torch.bfloat16, "enc1 act")
    skip2, x2 = encoder.enc1(mag, *ly, **kw)
    assert torch.equal(skip, skip2) and torch.equal(x, x2)


def test_enc1_tensor_cores_refuse_misaligned_magnitude(device):
    """bf16 enc1 loads the magnitude as float2 pairs: a magnitude one float
    off 8-byte alignment raises, and nothing launches."""
    gen = torch.Generator().manual_seed(9)
    shape = (1, 2, 32, 64)
    buf = torch.rand(math.prod(shape) + 1, generator=gen).to(device)
    ly = _layer(gen, 1, (16, 2, 5, 5), 16, device)
    before = kernels.launch_counts()["enc1"]
    with pytest.raises(ValueError, match="8-byte aligned"):
        encoder.enc1(buf[1:].view(shape), *ly, act="elu", dtype=torch.bfloat16)
    assert kernels.launch_counts()["enc1"] == before


K3_EDGES = [  # stems, images, H, W
    (1, 1, 32, 64),  # one image
    (1, 2, 2, 64),  # H/2 = 1
    (1, 1, 16, 80),  # W/2 = 40, not a multiple of the 32-column tile
    (2, 6, 18, 70),  # S = 2 over 3 images each; H/2 = 9, W/2 = 35
]


@pytest.mark.parametrize("c", [16, 32, 64])
@pytest.mark.parametrize("n_stems,n_img,h,w", K3_EDGES)
def test_enc_s2_tensor_cores_at_edges(device, c, n_stems, n_img, h, w):
    """bf16 enc2-enc4 (the tensor-core template) at ragged tiles, against
    the plain version to 2 bf16 ulps, and bit-identical over two runs."""
    gen = torch.Generator().manual_seed(c * 1000 + n_img * 100 + h + w)
    x = torch.randn((n_img, h, w, c), generator=gen).to(device, torch.bfloat16)
    ly = _layer(gen, n_stems, (2 * c, c, 5, 5), 2 * c, device)
    skip, y = _counted("enc_s2", encoder.enc_s2, x, *ly, act="elu")
    pskip, py = encoder.enc_s2_plain(x, *ly, act="elu")
    _assert_close(skip, pskip, torch.bfloat16, f"enc_s2({c}) skip")
    _assert_close(y, py, torch.bfloat16, f"enc_s2({c}) act")
    skip2, y2 = encoder.enc_s2(x, *ly, act="elu")
    assert torch.equal(skip, skip2) and torch.equal(y, y2)


UP_EDGES = [  # stems, images, H, W (input resolution)
    (1, 1, 16, 32),  # one image
    (1, 2, 1, 48),  # H = 1
    (1, 1, 6, 8),  # W = 8, a quarter of the 32-column tile
    (1, 2, 10, 40),  # W = 40, not a multiple of the tile
    (2, 6, 9, 24),  # S = 2 over 3 images each, odd H
]


@pytest.mark.parametrize("c", [64, 32])
@pytest.mark.parametrize("n_stems,n_img,h,w", UP_EDGES)
def test_up_shallow_tensor_cores_at_edges(device, c, n_stems, n_img, h, w):
    """bf16 up4/up5 (the tensor-core template) at ragged tiles, against the
    plain version to 2 bf16 ulps, and bit-identical over two runs."""
    gen = torch.Generator().manual_seed(c * 1000 + n_img * 100 + h + w)
    skip, prev = (torch.randn((n_img, h, w, c), generator=gen).to(device, torch.bfloat16)
                  for _ in range(2))
    ly = _layer(gen, n_stems, (2 * c, c // 2, 5, 5), c // 2, device)
    got = _counted(tail.UP_WIDTHS[c], tail.up_shallow, skip, prev, *ly, act="elu")
    _assert_close(got, tail.up_shallow_plain(skip, prev, *ly, act="elu"),
                  torch.bfloat16, tail.UP_WIDTHS[c])
    assert torch.equal(got, tail.up_shallow(skip, prev, *ly, act="elu"))


@pytest.mark.parametrize("misaligned", ["skip", "prev"])
def test_up_shallow_tensor_cores_refuse_misaligned_sources(device, misaligned):
    """The tensor-core template copies 16 bytes at a time: a bf16 source
    one element off 16-byte alignment raises, and nothing launches."""
    gen = torch.Generator().manual_seed(7)
    shape = (1, 8, 16, 64)
    buf = torch.randn((2, math.prod(shape) + 8), generator=gen).to(device, torch.bfloat16)
    srcs = {"skip": buf[0, :math.prod(shape)].view(shape),
            "prev": buf[1, :math.prod(shape)].view(shape)}
    srcs[misaligned] = buf[0 if misaligned == "skip" else 1, 1:1 + math.prod(shape)].view(shape)
    ly = _layer(gen, 1, (128, 32, 5, 5), 32, device)
    before = kernels.launch_counts()["up4"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tail.up_shallow(srcs["skip"], srcs["prev"], *ly, act="elu")
    assert kernels.launch_counts()["up4"] == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_stems,n_tiles", [(1, 1), (4, 3)])
@pytest.mark.parametrize("c", [64, 32])
def test_up_shallow_kernel_matches_plain(device, dtype, n_stems, n_tiles, c):
    """up4 at (T/8, F/8) and up5 at (T/4, F/4) of a T = F = 64 tile."""
    gen = torch.Generator().manual_seed(c + n_stems)
    side = 8 if c == 64 else 16
    shape = (n_stems * n_tiles, side, side, c)
    skip = torch.randn(shape, generator=gen).to(device, dtype)
    prev = torch.randn(shape, generator=gen).to(device, dtype)
    act = "elu" if n_stems == 4 else "relu"
    ly = _layer(gen, n_stems, (2 * c, c // 2, 5, 5), c // 2, device)
    got = _counted(tail.UP_WIDTHS[c], tail.up_shallow, skip, prev, *ly, act=act)
    _assert_close(got, tail.up_shallow_plain(skip, prev, *ly, act=act), dtype,
                  tail.UP_WIDTHS[c])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_stems,n_tiles,t,f", [(1, 1, 64, 64), (4, 3, 64, 128)])
def test_head_kernel_matches_plain(device, dtype, n_stems, n_tiles, t, f):
    gen = torch.Generator().manual_seed(t + f + n_stems)
    shape = (n_stems * n_tiles, t // 2, f // 2, 16)
    skip1 = torch.randn(shape, generator=gen).to(device, dtype)
    up5 = torch.randn(shape, generator=gen).to(device, dtype)
    act = "elu" if n_stems == 4 else "relu"
    w6, b6, s6, h6 = _layer(gen, n_stems, (32, 1, 5, 5), 1, device)
    w7, b7, _, _ = _layer(gen, n_stems, (2, 1, 4, 4), 2, device)
    args = (skip1, up5, w6, b6, s6, h6, w7, b7)
    got = _counted("head", tail.head, *args, act=act)
    ref = tail.head_plain(*args, act=act)
    assert got.shape == (n_stems, n_tiles, 2, t, f)
    assert got.dtype == ref.dtype
    err = (got - ref).abs()
    bound = tail.head_error_bound(*args, act=act)
    assert torch.all(err <= bound), f"head: max error / bound {(err / bound).max()}"


HEAD_EDGES = [  # stems, images, H/2, W/2 (the sources' size)
    (1, 1, 16, 64),  # one image
    (1, 2, 1, 48),  # H/2 = 1
    (1, 1, 12, 70),  # W = 140, not a multiple of the 128-column tile
    (1, 2, 10, 35),  # W = 70: mask rows not a multiple of 4 floats
    (2, 6, 9, 24),  # S = 2 over 3 images each, odd H/2
]


@pytest.mark.parametrize("n_stems,n_img,h2,w2", HEAD_EDGES)
def test_head_tensor_cores_at_edges(device, n_stems, n_img, h2, w2):
    """bf16 K6 (the tensor-core template) at ragged tiles, per pixel within
    tail.head_error_bound of its plain version, bit-identical over two
    runs, and equal bit for bit to K10 (the same template) on the
    concatenated sources."""
    gen = torch.Generator().manual_seed(n_img * 100 + h2 + w2)
    skip1, up5 = (torch.randn((n_img, h2, w2, 16), generator=gen).to(device, torch.bfloat16)
                  for _ in range(2))
    act = "elu" if n_stems == 1 else "relu"
    w6, b6, s6, h6 = _layer(gen, n_stems, (32, 1, 5, 5), 1, device)
    w7, b7, _, _ = _layer(gen, n_stems, (2, 1, 4, 4), 2, device)
    args = (skip1, up5, w6, b6, s6, h6, w7, b7)
    got = _counted("head", tail.head, *args, act=act)
    ref = tail.head_plain(*args, act=act)
    assert got.shape == ref.shape == (n_stems, n_img // n_stems, 2, 2 * h2, 2 * w2)
    err = (got - ref).abs()
    bound = tail.head_error_bound(*args, act=act)
    assert torch.all(err <= bound), f"head: max error / bound {(err / bound).max()}"
    assert torch.equal(got, tail.head(*args, act=act))
    x = torch.cat([skip1, up5], -1).contiguous()
    k10 = _counted("mask_head", mask_head.mask_head, x, *args[2:], act=act)
    assert torch.equal(k10, got.flatten(0, 1))


@pytest.mark.parametrize("misaligned", ["skip1", "up5", "x"])
def test_head_tensor_cores_refuse_misaligned_sources(device, misaligned):
    """The tensor-core head copies 16 bytes at a time: a bf16 source one
    element off 16-byte alignment raises, in K6 and K10, and nothing
    launches."""
    gen = torch.Generator().manual_seed(8)
    w6 = _layer(gen, 1, (32, 1, 5, 5), 1, device)
    w7, b7, _, _ = _layer(gen, 1, (2, 1, 4, 4), 2, device)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        if misaligned == "x":
            shape = (1, 8, 16, 32)
            buf = torch.randn(math.prod(shape) + 8, generator=gen).to(device, torch.bfloat16)
            mask_head.mask_head(buf[1 : 1 + math.prod(shape)].view(shape), *w6, w7, b7,
                                act="elu")
        else:
            shape = (1, 8, 16, 16)
            buf = torch.randn((2, math.prod(shape) + 8), generator=gen).to(device, torch.bfloat16)
            srcs = {"skip1": buf[0, :math.prod(shape)].view(shape),
                    "up5": buf[1, :math.prod(shape)].view(shape)}
            row = 0 if misaligned == "skip1" else 1
            srcs[misaligned] = buf[row, 1 : 1 + math.prod(shape)].view(shape)
            tail.head(srcs["skip1"], srcs["up5"], *w6, w7, b7, act="elu")
    assert kernels.launch_counts() == before


def test_packed_unet_runs_every_kernel_once(device):
    """multi_stem_masks on the card at the gate's smallest tile: K2 once,
    K3 three times, K4, K5 and K6 once, and the masks match the plain
    composition on the CPU."""
    gen = torch.Generator().manual_seed(5)
    stacked = {k: {f: v[None].to(device) for f, v in ly.items()}
               for k, ly in model.init_params(gen).items()}
    mag = torch.rand((3, 2, 64, 64), generator=gen).to(device) * 4
    kernels.reset_launch_counts()
    got = model.multi_stem_masks(stacked, mag)
    counts = kernels.launch_counts()
    assert counts == {"stft4096": 0, "enc1": 1, "enc_s2": 3, "up4": 1,
                      "up5": 1, "head": 1, "masked_istft4096": 0,
                      "irfft4096": 0, "masked_irfft4096": 0, "mask_head": 0,
                      "stream_synthesis4096": 0, "rope_qk": 0}
    cpu = {k: {f: v.cpu() for f, v in ly.items()} for k, ly in stacked.items()}
    ref = model.multi_stem_masks(cpu, mag.cpu())
    assert (got.cpu() - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_stems,n_img,t2,f2", [
    (1, 1, 32, 16),  # one row tile, F/2 = 16
    (1, 1, 96, 48),
    (4, 64, 32, 16),  # S * B = 64, the gate's limit
    (1, 64, 64, 256),
])
def test_mask_head_kernel_matches_plain(device, dtype, n_stems, n_img, t2, f2):
    gen = torch.Generator().manual_seed(n_img + t2 + f2 + n_stems)
    x = torch.randn((n_img, t2, f2, 32), generator=gen).to(device, dtype)
    act = "elu" if n_stems == 4 else "relu"
    w6, b6, s6, h6 = _layer(gen, n_stems, (32, 1, 5, 5), 1, device)
    w7, b7, _, _ = _layer(gen, n_stems, (2, 1, 4, 4), 2, device)
    args = (x, w6, b6, s6, h6, w7, b7)
    got = _counted("mask_head", mask_head.mask_head, *args, act=act)
    ref = mask_head.mask_head_plain(*args, act=act)
    assert got.shape == ref.shape == (n_img, 2, 2 * t2, 2 * f2)
    err = (got - ref).abs()
    bound = mask_head.mask_head_error_bound(*args, act=act)
    assert torch.all(err <= bound), f"mask_head: max error / bound {(err / bound).max()}"
    # K6 on x's two halves is the same kernel: the same masks, bit for bit.
    k6 = tail.head(x[..., :16].contiguous(), x[..., 16:].contiguous(),
                   *args[1:], act=act)
    assert torch.equal(got, k6.flatten(0, 1))


def test_round3_route_runs_its_kernels(device, monkeypatch):
    """multi_stem_masks with FORCE_PACKED_UNET = False on the card: K2 once,
    K3 twice (enc2, enc3), K10 once, no K4/K5/K6; the masks match the same
    route on the CPU."""
    monkeypatch.setattr(model, "FORCE_PACKED_UNET", False)
    gen = torch.Generator().manual_seed(6)
    params = [model.init_params(gen) for _ in range(2)]
    cpu = {k: {f: torch.stack([p[k][f] for p in params]) for f in params[0][k]}
           for k in params[0]}
    stacked = {k: {f: v.to(device) for f, v in ly.items()} for k, ly in cpu.items()}
    mag = torch.rand((3, 2, 64, 128), generator=gen) * 4
    kernels.reset_launch_counts()
    got = model.multi_stem_masks(stacked, mag.to(device))
    assert kernels.launch_counts() == {
        "stft4096": 0, "enc1": 1, "enc_s2": 2, "up4": 0, "up5": 0, "head": 0,
        "masked_istft4096": 0, "irfft4096": 0, "masked_irfft4096": 0,
        "mask_head": 1, "stream_synthesis4096": 0, "rope_qk": 0}
    ref = model.multi_stem_masks(cpu, mag)
    assert (got.cpu() - ref).abs().max().item() <= 1e-4


def test_unet_wrappers_refuse_mixed_and_bad_inputs(device):
    kernels.reset_launch_counts()
    gen = torch.Generator().manual_seed(0)
    mag = torch.rand((1, 2, 64, 64), generator=gen).to(device)
    ly_cpu = _layer(gen, 1, (16, 2, 5, 5), 16, "cpu")
    ly = tuple(t.to(device) for t in ly_cpu)
    with pytest.raises(ValueError, match="is on cpu"):
        encoder.enc1(mag, *ly_cpu, act="elu", dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        encoder.enc1(mag, *ly, act="elu", dtype=torch.float16)
    x = torch.rand((1, 32, 32, 16), generator=gen).to(device)
    ly2 = _layer(gen, 1, (32, 16, 5, 5), 32, device)
    with pytest.raises(ValueError, match="contiguous"):
        encoder.enc_s2(x.transpose(1, 2), *ly2, act="elu")
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        encoder.enc_s2(x.half(), *ly2, act="elu")
    src = torch.rand((1, 8, 8, 64), generator=gen).to(device)
    ly4 = _layer(gen, 1, (128, 32, 5, 5), 32, device)
    with pytest.raises(ValueError, match="prev is on cpu"):
        tail.up_shallow(src, src.cpu(), *ly4, act="elu")
    h = torch.rand((1, 32, 32, 16), generator=gen).to(device)
    w6 = _layer(gen, 1, (32, 1, 5, 5), 1, device)
    w7, b7, _, _ = _layer(gen, 1, (2, 1, 4, 4), 2, device)
    with pytest.raises(ValueError, match="w7 is on cpu"):
        tail.head(h, h, *w6, w7.cpu(), b7, act="elu")
    x = torch.rand((1, 32, 32, 32), generator=gen).to(device)
    with pytest.raises(ValueError, match="w6 is on cpu"):
        mask_head.mask_head(x, *(t.cpu() for t in w6), w7, b7, act="elu")
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# K8/K9: the frames-out inverse FFT, and the streaming block step
# ---------------------------------------------------------------------------


def _spec(device, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    re, im = torch.randn((2, *shape, 2049), generator=gen)
    return torch.complex(re, im).to(device)


def _fft_close(got, ref):
    assert got.shape == ref.shape
    err = (got - ref).abs().max().item()
    assert err <= 1e-5 * max(1.0, ref.abs().max().item()), f"max error {err}"


@pytest.mark.parametrize("shape", [(1,), (3, 37), (2, 4, 2, 65)])
@pytest.mark.parametrize("windowed", [False, True])
def test_irfft_kernel_matches_plain(device, shape, windowed):
    spec = _spec(device, shape, len(shape))
    window = transform.synthesis_window(TCFG, device=device) if windowed else None
    y = _counted("irfft4096", pallas_fft.irfft4096, spec, window)
    _fft_close(y, pallas_fft.irfft4096_plain(spec, window))
    assert torch.equal(y, pallas_fft.irfft4096(spec, window))  # deterministic


@pytest.mark.parametrize("frames", [1, 3, 129])  # odd: a half-full last block
@pytest.mark.parametrize("bin_limit", [1, 512, 777, 2048, 2049])
@pytest.mark.parametrize("windowed", [False, True])
def test_masked_irfft_kernel_matches_plain(device, frames, bin_limit, windowed):
    spec = _spec(device, (2, frames), frames + bin_limit)
    gen = torch.Generator(device=device).manual_seed(frames)
    masks = torch.rand((3, 2, frames, bin_limit), generator=gen, device=device)
    out_band = torch.tensor([0.25, 0.0, 0.7], device=device)
    window = transform.synthesis_window(TCFG, device=device) if windowed else None
    args = (spec, masks, out_band, bin_limit, window)
    y = _counted("masked_irfft4096", pallas_fft.masked_irfft4096, *args)
    assert y.shape == (3, 2, frames, 4096)
    _fft_close(y, pallas_fft.masked_irfft4096_plain(*args))
    assert torch.equal(y, pallas_fft.masked_irfft4096(*args))


def test_irfft_wrappers_refuse_mixed_devices_and_dtypes(device):
    kernels.reset_launch_counts()
    spec = _spec(device, (2, 3), 0)
    with pytest.raises(ValueError, match="window is on cpu"):
        pallas_fft.irfft4096(spec, transform.synthesis_window(TCFG))
    with pytest.raises(ValueError, match="complex64"):
        pallas_fft.irfft4096(spec.to(torch.complex128))
    masks = torch.rand((1, 2, 3, 512), device=device)
    with pytest.raises(ValueError, match="masks is on cpu"):
        pallas_fft.masked_irfft4096(spec, masks.cpu(), torch.ones(1, device=device), 512)
    with pytest.raises(ValueError, match="float32"):
        pallas_fft.masked_irfft4096(spec, masks.half(), torch.ones(1, device=device), 512)
    with pytest.raises(ValueError, match="out_band is on cpu"):
        pallas_fft.masked_irfft4096(spec, masks, torch.ones(1), 512)
    assert not any(kernels.launch_counts().values())


def test_block_step_streams_launches_each_kernel_once(device):
    """One streaming block at K = 1 (one full-width image per stem): K1,
    the packed U-Net and the streaming synthesis once each, K3 three times,
    no K8; the output matches the same block step on CPU tensors."""
    cfg = SeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                          compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    params = [model.init_params(gen) for _ in range(2)]
    cpu = {k: {f: torch.stack([p[k][f] for p in params]) for f in params[0][k]}
           for k in params[0]}
    stacked = {k: {f: v.to(device) for f, v in ly.items()} for k, ly in cpu.items()}
    blocks = torch.randn((3, 1, 2, 64 * 1024), generator=gen) * 0.3
    state = stream.init_state_streams(cfg, 2, 1, device)
    ref_state = stream.init_state_streams(cfg, 2, 1)
    for i in range(3):
        kernels.reset_launch_counts()
        state, out = stream.block_step_streams(stacked, state, blocks[i].to(device),
                                               cfg, 2, (0.25, 0.0))
        assert kernels.launch_counts() == {
            "stft4096": 1, "enc1": 1, "enc_s2": 3, "up4": 1, "up5": 1,
            "head": 1, "masked_istft4096": 0, "irfft4096": 0,
            "masked_irfft4096": 0, "mask_head": 0, "stream_synthesis4096": 1,
            "rope_qk": 0}
        ref_state, ref = stream.block_step_streams(cpu, ref_state, blocks[i], cfg,
                                                   2, (0.25, 0.0))
    assert ref.abs().max() > 0.01
    assert (out.cpu() - ref).abs().max().item() <= 1e-4


def _synthesis_args(device, k, s, t, bin_limit):
    gen = torch.Generator().manual_seed(k * 1009 + s * 101 + t * 7 + bin_limit)
    spec2 = _spec(device, (k, 2, t), k + t + bin_limit)
    masks2 = torch.rand((s, k, 2, t, bin_limit), generator=gen).to(device)
    out_band = torch.tensor([0.25, 0.0, 0.25, 0.7, 0.5][:s], device=device)
    _, ws = stream.window_tensors(1.0, device)
    ola_tail = (torch.randn((k, s, 2, 1024), generator=gen) * 0.02).to(device)
    return spec2, masks2, out_band, ws, ola_tail


def _synthesis_close(args):
    """The kernel against its plain version within _fft_close's bound, the
    carry included; two runs bit-identical; one launch a call."""
    got = _counted("stream_synthesis4096", stream_synthesis.stream_synthesis4096, *args)
    ref = stream_synthesis.stream_synthesis4096_plain(*args)
    peak = max(1.0, ref[0].abs().max().item(), ref[1].abs().max().item())
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        err = (g - r).abs().max().item()
        assert err <= 1e-5 * peak, f"max error {err}, peak {peak}"
    again = stream_synthesis.stream_synthesis4096(*args)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("k", [1, 3, 64])
@pytest.mark.parametrize("t", [1, 37, 256])  # 37: a partly full last run
@pytest.mark.parametrize("bin_limit", [1, 512, 1536, 2049])
def test_stream_synthesis_kernel_matches_plain(device, k, t, bin_limit):
    _synthesis_close(_synthesis_args(device, k, t=t, s=4, bin_limit=bin_limit))


@pytest.mark.parametrize("s", [1, 2, 5])
@pytest.mark.parametrize("run_hops,groups", [(1, 1), (5, 2), (32, 1), (300, 2)])
def test_stream_synthesis_kernel_at_other_launch_shapes(device, monkeypatch, s,
                                                        run_hops, groups):
    """Stem counts other than 4, runs of one hop to more than the block,
    and one or two groups a block with the last block partly empty."""
    monkeypatch.setattr(stream_synthesis, "SYNTH_RUN_HOPS", run_hops)
    monkeypatch.setattr(stream_synthesis, "SYNTH_GROUPS", groups)
    _synthesis_close(_synthesis_args(device, 3, s, 37, 777))


def test_stream_synthesis_refuses_bad_inputs(device):
    """Mixed devices, a window or carry off 8-byte alignment, a wrong dtype
    or out_band length: a ValueError before any launch."""
    spec2, masks2, out_band, ws, ola_tail = _synthesis_args(device, 1, 2, 3, 64)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="ws is on cpu"):
        stream_synthesis.stream_synthesis4096(spec2, masks2, out_band, ws.cpu(), ola_tail)
    buf = torch.zeros(2049, device=device)
    with pytest.raises(ValueError, match="8-byte aligned"):
        stream_synthesis.stream_synthesis4096(spec2, masks2, out_band, buf[1:], ola_tail)
    with pytest.raises(ValueError, match="float32"):
        stream_synthesis.stream_synthesis4096(spec2, masks2.half(), out_band, ws, ola_tail)
    with pytest.raises(ValueError, match="out_band: expected 2"):
        stream_synthesis.stream_synthesis4096(spec2, masks2, out_band[:1], ws, ola_tail)
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# The batch graphs: K1 and K7 with `tracks`, launch counts, grid limits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tracks", [1, 2, 3, 4, 5])
def test_stft_istft_tracks_match_lone_launches(device, tracks):
    """K1 and K7 over `tracks` tracks folded into their rows, at an odd
    tile count (3 tiles of 48 frames, the last part zero): each track's
    spectrum, magnitude images and audio bit-identical to a launch on
    that track alone, and the batch within its bound of the plain
    versions."""
    n, bl, t = 130_001, 777, 48
    rows = 2 * tracks
    audio, n_out, n_comp, n_req = _inputs(device, rows, n, t)
    nt = n_req // t
    assert nt == 3
    win = transform.analysis_window(4096, device=device)
    swin = transform.synthesis_window(TCFG, device=device)
    k1 = (audio, win, n_comp, n_req, bl, t, tracks)
    spec, mag = _counted("stft4096", stft_fused.stft4096, *k1)
    assert mag.shape == (tracks * nt, 2, t, bl)
    pspec, pmag = stft_fused.stft4096_plain(*k1)
    bound = 1e-5 * pspec.abs().max().item()
    assert (spec - pspec).abs().max().item() <= bound
    assert (mag - pmag).abs().max().item() <= bound
    gen = torch.Generator(device=device).manual_seed(tracks)
    masks = torch.rand((4, tracks * nt, 2, t, bl), generator=gen, device=device)
    ob = torch.tensor([0.25, 0.0, 0.25, 0.5], device=device)
    k7 = (spec, masks, ob, swin, n_out, tracks)
    y = _counted("masked_istft4096", stft_fused.masked_istft4096, *k7)
    _fft_close(y, stft_fused.masked_istft4096_plain(*k7))
    for i in range(tracks):
        rows_i, img = slice(2 * i, 2 * i + 2), slice(i * nt, (i + 1) * nt)
        spec1, mag1 = stft_fused.stft4096(audio[rows_i].contiguous(), *k1[1:6])
        assert torch.equal(spec[rows_i], spec1) and torch.equal(mag[img], mag1)
        y1 = stft_fused.masked_istft4096(spec1, masks[:, img].contiguous(), ob,
                                         swin, n_out)
        assert torch.equal(y[:, rows_i], y1)


def _batch_nets(device, n):
    gen = torch.Generator().manual_seed(11)
    cpu = [model.init_params(gen) for _ in range(n)]
    return cpu, [{k: {f: v.to(device) for f, v in p[k].items()} for k in p}
                 for p in cpu]


_NONE = dict.fromkeys(kernels.KERNELS, 0)


@pytest.mark.parametrize("graph", ["4 stems", "2 stems", "3 stems"])
def test_batch_graphs_launch_once(device, graph):
    """Three tracks of different content as one batch (fp32): K1 and K7
    once for the batch, the U-Net's kernels once a pass, and each track
    within 1e-4 of its own single-track run on the card."""
    n_stems = int(graph[0])
    cfg = SeparatorConfig(bin_limit=512, time_step=64, num_stems=n_stems,
                          compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(n_stems)
    tracks = transform.pad_offline(
        torch.randn((3, 2, 70_000), generator=gen) * torch.tensor([0.1, 0.3, 0.5])[
            :, None, None], cfg.transform).to(device).contiguous()
    _, nets = _batch_nets(device, 4 if n_stems == 4 else 2)
    if n_stems == 4:
        stacked = weights.stack_params(nets)
        run = lambda x: separate.separate_nstem_batch(stacked, x, cfg,
                                                      separate.OUT_BAND_4)
        per_pass = {"stft4096": 1, "enc1": 1, "enc_s2": 3, "up4": 1, "up5": 1,
                    "head": 1, "masked_istft4096": 1}
    elif n_stems == 2:
        run = lambda x: separate.separate_2stem_batch(nets[0], x, cfg)
        per_pass = {"stft4096": 1, "enc1": 1, "enc_s2": 3, "up4": 1, "up5": 1,
                    "head": 1, "masked_istft4096": 1}
    else:
        run = lambda x: separate.separate_3stem_batch(nets[0], nets[1], x, cfg)
        per_pass = {"stft4096": 1, "enc1": 2, "enc_s2": 6, "up4": 2, "up5": 2,
                    "head": 2, "masked_istft4096": 1}
    kernels.reset_launch_counts()
    got = run(tracks)
    assert kernels.launch_counts() == {**_NONE, **per_pass}
    for i in range(3):
        one = run(tracks[i : i + 1])[0]
        assert (got[i] - one).abs().max().item() <= 1e-4


def test_wrappers_refuse_grids_past_the_limit(device):
    """More than 65535 images (grid z) or K1 rows (grid y): a ValueError
    before any launch, never a launch over the wrong images."""
    kernels.reset_launch_counts()
    big = kernels.MAX_GRID_YZ + 1
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="grid limit"):
        encoder.enc1(torch.zeros((big, 2, 2, 2), device=device),
                     *_layer(gen, 1, (16, 2, 5, 5), 16, device), act="elu",
                     dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="grid limit"):
        encoder.enc_s2(torch.zeros((big, 2, 2, 16), device=device),
                       *_layer(gen, 1, (32, 16, 5, 5), 32, device), act="elu")
    with pytest.raises(ValueError, match="grid limit"):
        src = torch.zeros((big, 1, 1, 32), device=device)
        tail.up_shallow(src, src, *_layer(gen, 1, (64, 16, 5, 5), 16, device),
                        act="elu")
    w6 = _layer(gen, 1, (32, 1, 5, 5), 1, device)
    w7, b7, _, _ = _layer(gen, 1, (2, 1, 4, 4), 2, device)
    with pytest.raises(ValueError, match="grid limit"):
        src = torch.zeros((big, 1, 1, 16), device=device)
        tail.head(src, src, *w6, w7, b7, act="elu")
    with pytest.raises(ValueError, match="grid limit"):
        mask_head.mask_head(torch.zeros((big, 1, 1, 32), device=device), *w6,
                            w7, b7, act="elu")
    with pytest.raises(ValueError, match="grid limit"):
        stft_fused.stft4096(torch.zeros((big, 4096), device=device),
                            transform.analysis_window(4096, device=device), 1,
                            64, 512, 64)
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# A repeated offline call replayed as one captured CUDA graph
# ---------------------------------------------------------------------------

REPLAY_CONFIGS = {  # the production routes: bf16, the packed U-Net
    "2 stems": SeparatorConfig(bin_limit=1024, time_step=512, num_stems=2,
                               compute_dtype=torch.bfloat16),
    "4 stems": SeparatorConfig(bin_limit=1536, time_step=256, num_stems=4,
                               compute_dtype=torch.bfloat16),
}


# 30 to 35 s: one tile count in both configurations, so one graph (run at
# the tile count's longest padded length) serves every length.
REPLAY_LENGTHS = (30 * 44100, 35 * 44100, 30 * 44100 + 1000, 33 * 44100, 31 * 44100)


@pytest.fixture
def deterministic(device):
    """cuDNN's transposed convolutions (the mid trunk's) move their sums
    from call to call unless deterministic."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield device
    torch.backends.cudnn.deterministic = saved


def _replay_case(device, graph):
    cfg = REPLAY_CONFIGS[graph]
    _, nets = _batch_nets(device, cfg.num_stems)
    kwargs = ({"params": nets[0]} if cfg.num_stems == 2
              else {"stacked_params": weights.stack_params(nets)})
    gen = torch.Generator().manual_seed(cfg.num_stems)
    tracks = [(torch.randn((2, n), generator=gen) * 0.2).to(device)
              for n in REPLAY_LENGTHS]
    return cfg, kwargs, tracks, lambda x: _composed(x, cfg, kwargs)


def _composed(x, cfg, kwargs):
    """`separate.separate`'s stems composed from the stem graph it runs
    eager: pad, separate_2stem or separate_4stem, crop."""
    preshift, _ = transform.offline_pad_sizes(x.shape[-1], cfg.transform)
    padded = transform.pad_offline(x, cfg.transform).contiguous()
    if cfg.num_stems == 2:
        stems = separate.separate_2stem(kwargs["params"], padded, cfg)
    else:
        stems = separate.separate_4stem(kwargs["stacked_params"], padded, cfg)
    return stems[..., preshift : preshift + x.shape[-1]]


@pytest.mark.parametrize("graph", sorted(REPLAY_CONFIGS))
def test_replays_equal_eager_calls_bit_for_bit(deterministic, graph):
    """Five tracks of 30 to 35 s, lengths of one tile count: eager,
    capture, then three replays, each answer kept; after the last call
    every kept answer equals its track's stems from the eager stem graph
    at its own padded length bit for bit (no answer aliases the graph's
    memory), and the counter reads one eager call, one capture and three
    replays."""
    cfg, kwargs, tracks, eager = _replay_case(deterministic, graph)
    replay.reset_counts()
    kernels.reset_launch_counts()
    kept = [separate.separate(t, cfg=cfg, device=deterministic, **kwargs)
            for t in tracks]
    assert replay.counts() == {"eager": 1, "capture": 1, "replay": 3, "fallback": 0}
    # K1 ran from its wrapper for the eager call and the capture's warm-up;
    # what the capture recorded and the replays are no wrapper launches.
    # K7 is in the 2-stem graph, and runs after the 4-stem one, once a call.
    assert kernels.launch_counts()["stft4096"] == 2
    assert kernels.launch_counts()["masked_istft4096"] == (2 if cfg.num_stems == 2 else 5)
    for t, got in zip(tracks, kept):
        want = eager(t)
        assert list(got) == list(cfg.stem_names)
        for stem, y in zip(cfg.stem_names, want):
            assert got[stem].shape == y.shape and got[stem].dtype == y.dtype
            assert got[stem].device == y.device
            assert torch.equal(got[stem], y), stem


def test_a_replay_sees_weights_changed_in_place(deterministic):
    """An optimiser-style in-place step on the weights between replays is
    read by the next replay."""
    cfg, kwargs, tracks, eager = _replay_case(deterministic, "2 stems")
    for t in tracks[:3]:
        separate.separate(t, cfg=cfg, device=deterministic, **kwargs)
    with torch.no_grad():
        for ly in kwargs["params"].values():
            for v in ly.values():
                v.mul_(0.9)
    replay.reset_counts()
    got = separate.separate(tracks[3], cfg=cfg, device=deterministic, **kwargs)
    assert replay.counts()["replay"] == 1
    for stem, y in zip(cfg.stem_names, eager(tracks[3])):
        assert torch.equal(got[stem], y), stem


def test_calls_that_never_replay(device):
    """A lone length, a call from another stream than the default one and
    a call autograd would record run eager, and are counted so."""
    cfg, kwargs, tracks, _ = _replay_case(device, "2 stems")
    replay.reset_counts()
    separate.separate(tracks[0][:, :44100], cfg=cfg, device=device, **kwargs)
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        for t in tracks[:2]:
            separate.separate(t, cfg=cfg, device=device, **kwargs)
    torch.cuda.current_stream(device).wait_stream(side)
    assert replay.counts() == {"eager": 3, "capture": 0, "replay": 0, "fallback": 0}
    w = kwargs["params"]["down1"]["w"]
    assert separate._replayable(tracks[0], [w])
    w.requires_grad_()
    assert not separate._replayable(tracks[0], [w])
    w.requires_grad_(False)
