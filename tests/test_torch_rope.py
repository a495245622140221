"""BS-RoFormer's rotary kernel (`kernels/rope.py`, csrc/rope.cu).

On the CPU: the wrapper's plain version against the chain
core/roformer.py::attention ran before it (a float32 copy of q and k, their
complex64 product with the table, the cast back), bit for bit, at the
benchmark cell's widths (8 heads of 64 in rows of 1544) with the time
layer's 801 positions, the band layer's 62, an odd count and one sequence;
and the wrapper's refusals. None counts a launch.

On a card (marked `cuda`, skipped where there is none), the kernel against
the plain version at both layer shapes of the cell and at odd sizes, with
tables whose every row differs, and the launches of one 300 s call:

    python -m pytest --noconftest -m cuda tests/test_torch_rope.py -q
"""

import pytest
import torch

from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.config import RoformerConfig
from spleeterrt_tpu_torch.core import roformer
from spleeterrt_tpu_torch.kernels import rope

torch.set_num_threads(2)

CFG = RoformerConfig()
HEADS, DH = CFG.heads, CFG.dim_head
WIDTH = 3 * HEADS * DH + HEADS  # to_qkvg's 1544 columns


def _chain(qkvg, rot, heads, dh):
    """What core/roformer.py::attention computed before the kernel."""
    n, length, _ = qkvg.shape
    qk = torch.view_as_complex(
        qkvg[..., : 2 * heads * dh].float().contiguous().view(n, length, 2 * heads, dh // 2, 2))
    return torch.view_as_real(qk * rot[:, None]).to(qkvg.dtype).view(n, length, 2, heads, dh)


def _qkvg(n, length, width, dtype, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed * 7919 + n * 31 + length)
    return (3 * torch.randn((n, length, width), generator=gen)).to(device, dtype)


def _random_table(length, half, seed, device="cpu"):
    """A table whose every row differs: random angles and moduli."""
    gen = torch.Generator().manual_seed(seed + 17)
    angle = 6.3 * torch.rand((length, half), generator=gen)
    return torch.polar(0.5 + torch.rand((length, half), generator=gen), angle).to(device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,length", [(2, 801), (5, 62), (3, 37), (1, 801)])
def test_plain_version_is_the_chain_it_replaced(dtype, n, length):
    qkvg = _qkvg(n, length, WIDTH, dtype, 1)
    for rot in (roformer.rotary(length, CFG, "cpu"), _random_table(length, DH // 2, length)):
        kernels.reset_launch_counts()
        got = rope.rope_qk(qkvg, rot, HEADS)
        assert not any(kernels.launch_counts().values())
        assert got.shape == (n, length, 2, HEADS, DH) and got.dtype == dtype
        assert got.is_contiguous()
        assert torch.equal(got, _chain(qkvg, rot, HEADS, DH))


def test_the_rotation_turns_each_pair_at_its_position():
    """Row l of every sequence turns pair (x0, x1) of each q and k head by
    the table's (c, s) at l: (x0 c - x1 s, x0 s + x1 c)."""
    qkvg = _qkvg(2, 5, WIDTH, torch.float32, 2)
    rot = _random_table(5, DH // 2, 3)
    got = rope.rope_qk(qkvg, rot, HEADS).double()
    x = qkvg[..., : 2 * HEADS * DH].double().view(2, 5, 2, HEADS, DH // 2, 2)
    c, s = rot.real.double()[:, None, None], rot.imag.double()[:, None, None]
    want = torch.stack([x[..., 0] * c - x[..., 1] * s, x[..., 0] * s + x[..., 1] * c], -1)
    assert torch.allclose(got, want.view(got.shape), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_error_bound_takes_one_rounding_and_not_two(dtype):
    """`rope_qk_error`: 0 and all bit-equal for equal results; a value one
    unit in the last place off stays within the bound; one off by 4% of
    itself (five such units in bf16) does not."""
    qkvg = _qkvg(2, 9, WIDTH, dtype, 3)
    rot = _random_table(9, DH // 2, 4)
    want = rope.rope_qk(qkvg, rot, HEADS)
    assert rope.rope_qk_error(want.clone(), want, qkvg, rot, HEADS) == (0.0, 1.0)
    i = want.float().abs().argmax()
    for step, within in ((torch.finfo(dtype).eps, True), (0.04, False)):
        got = want.clone()
        got.view(-1)[i] = (want.view(-1)[i].float() * (1 + step)).to(dtype)
        worst, equal = rope.rope_qk_error(got, want, qkvg, rot, HEADS)
        assert (worst <= 1) is within
        assert equal == pytest.approx(1 - 1 / want.numel(), abs=1e-7)


def _refusal(qkvg, rot, heads=HEADS):
    kernels.reset_launch_counts()
    with pytest.raises((ValueError, RuntimeError)) as err:
        rope.rope_qk(qkvg, rot, heads)
    assert not any(kernels.launch_counts().values())
    return str(err.value)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    rot = roformer.rotary(7, CFG, "cpu")
    good = _qkvg(2, 7, WIDTH, torch.bfloat16, 4)
    assert rope.rope_qk(good, rot, HEADS).shape == (2, 7, 2, HEADS, DH)
    assert "float16" in _refusal(good.half(), rot)  # dtype
    assert "float64" in _refusal(good.double(), rot)
    assert "3-D" in _refusal(good[0], rot)  # rank
    assert "complex64" in _refusal(good, rot.real.contiguous())  # the table's dtype
    assert "positions" in _refusal(good, roformer.rotary(8, CFG, "cpu"))
    assert "columns" in _refusal(good[..., : 2 * HEADS * DH - 8].contiguous(), rot)
    # Row stride: rows of 1545 bf16 elements do not start on 16 bytes.
    assert "rows" in _refusal(_qkvg(2, 7, WIDTH + 1, torch.bfloat16, 4), rot)
    assert "contiguous" in _refusal(good[..., :-8], rot)
    # Misalignment: the same shape one element into a buffer.
    flat = torch.zeros(2 * 7 * WIDTH + 1, dtype=torch.bfloat16)
    assert "aligned" in _refusal(flat[1:].view(2, 7, WIDTH), rot)
    # A head that is not a whole number of 16-byte vectors (dim_head 4 in bf16).
    assert "vectors" in _refusal(_qkvg(2, 7, 16, torch.bfloat16, 4), torch.ones((7, 2),
                                 dtype=torch.complex64), 2)
    assert "on meta" in _refusal(good, rot.to("meta"))
    assert "requires grad" in _refusal(good.float().requires_grad_(), rot)
    with torch.no_grad():  # no grad mode, no refusal
        rope.rope_qk(good.float().requires_grad_(), rot, HEADS)


def test_pack_pads_to_qkvg_rows_to_16_bytes():
    """pack pads `to_qkvg`'s rows with zeros to a multiple of 8 (none at the
    published heads and dim_head), so that the product's rows start where
    the kernel reads vectors; attention reads the gates before the pad."""
    tiny = dict(dim=16, depth=1, freqs_per_bands=(1,) * 9, n_fft=16, hop=4, win=16,
                chunk=400, batch=2)
    for heads, dh, rows in ((HEADS, DH, WIDTH), (2, 8, 56)):
        cfg = RoformerConfig(heads=heads, dim_head=dh, **tiny)
        w = roformer.pack(roformer.init_params(cfg, torch.Generator().manual_seed(1)), cfg)
        assert w["0.band.w_qkvg"].shape == (rows, 16) and w["0.band.b_qkvg"].shape == (rows,)
        pad = slice(3 * heads * dh + heads, None)
        assert not w["0.band.w_qkvg"][pad].any() and not w["0.band.b_qkvg"][pad].any()


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_close(got, want, qkvg, rot, heads):
    """Each value within one rounding to got's dtype, plus the float32
    roundings of its two products (`rope.rope_qk_error`). In bf16,
    bit-equal in at least 99.9% of the values."""
    worst, equal = rope.rope_qk_error(got, want, qkvg, rot, heads)
    assert worst <= 1
    if got.dtype == torch.bfloat16:
        assert equal >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,length,heads,dh,width", [
    (992, 801, HEADS, DH, WIDTH),  # the cell's time layer: 16 chunks x 62 bands
    (12816, 62, HEADS, DH, WIDTH),  # its band layer: 16 chunks x 801 frames
    (3, 37, 3, 24, 224),  # odd sizes: 3 heads of 24
    (1, 1, 1, 8, 24),
    (5, 801, 80, 16, 3920),  # rows wider than one block of 256 vectors
])
def test_kernel_matches_plain(device, dtype, n, length, heads, dh, width):
    qkvg = _qkvg(n, length, width, dtype, 5, device)
    for rot in (roformer.rotary(length, RoformerConfig(dim_head=dh), device),
                _random_table(length, dh // 2, 6, device)):
        before = kernels.launch_counts()["rope_qk"]
        got = rope.rope_qk(qkvg, rot, heads)
        assert kernels.launch_counts()["rope_qk"] == before + 1
        want = rope.rope_qk_plain(qkvg, rot, heads)
        torch.cuda.synchronize()
        _assert_close(got, want, qkvg, rot, heads)
        assert torch.equal(got, rope.rope_qk(qkvg, rot, heads))


@pytest.mark.cuda
def test_a_300s_call_launches_the_kernel_twice_a_block_and_batch(device):
    track = torch.randn((2, 300 * 44100), generator=torch.Generator().manual_seed(8))
    params = roformer.init_params(CFG, torch.Generator(device).manual_seed(9), device)
    kernels.reset_launch_counts()
    roformer.separate_roformer(track.to(device), params, CFG)
    batches = -(-roformer.num_chunks(track.shape[-1], CFG) // CFG.batch)
    assert batches == 5
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.KERNELS, 0),
                                       "rope_qk": 2 * CFG.depth * batches}
