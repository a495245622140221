"""spleeterrt_tpu_torch.kernels.encoder (K2 enc1, K3 enc2-enc4) against the
JAX package's packed encoder, on the CPU.

The JAX side runs spleeterrt_tpu.kernels.encoder.encoder_packed (its Pallas
kernels _enc1_kernel and _s2_kernel in interpret mode) and unpacks each
output with quad_unpack; the port's wrappers take their plain versions for
CPU tensors. Both run in float32 on the same numpy inputs and weights,
with random biases and batch norms; skips and activations agree to
atol 1e-4 / rtol 2e-4, the bound the JAX package holds its own kernels to
(tests/test_encoder.py). The port's ELU uses expm1 and the TPU kernels
exp(x) - 1, about 1e-7 apart.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spleeterrt_tpu.kernels import encoder as jencoder
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.core import weights
from spleeterrt_tpu_torch.kernels import encoder

torch.set_num_threads(2)

LAYERS = ((2, 16), (16, 32), (32, 64), (64, 128))


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _rand_layer(rng, cin, cout):
    """One encoder layer in the JAX package's layout (HWIO kernel)."""
    return {
        "w": (rng.standard_normal((5, 5, cin, cout)) / np.sqrt(12.5 * cin)
              ).astype(np.float32),
        "b": (0.1 * rng.standard_normal(cout)).astype(np.float32),
        "bn_scale": (1 + 0.3 * rng.standard_normal(cout)).astype(np.float32),
        "bn_shift": (0.2 * rng.standard_normal(cout)).astype(np.float32),
    }


def _stacked_encoders(rng, n_stems):
    """({down1..down4} stacked over stems) in the JAX and the port layouts."""
    nets = [
        {f"down{i}": _rand_layer(rng, cin, cout)
         for i, (cin, cout) in enumerate(LAYERS, start=1)}
        for _ in range(n_stems)
    ]
    jstacked = jax.tree.map(lambda *xs: jnp.stack(xs), *nets)
    stacked = weights.stack_params([weights.params_from_jax(n) for n in nets])
    return jstacked, stacked


def _port_encoder(stacked, mag_nhwc, act, dtype=torch.float32):
    """enc1 + enc_s2 x 3 on the port -> (skips, act4), NHWC."""
    mag = torch.from_numpy(np.ascontiguousarray(mag_nhwc.transpose(0, 3, 1, 2)))
    ly = stacked["down1"]
    skip, x = encoder.enc1(mag, ly["w"], ly["b"], ly["bn_scale"],
                           ly["bn_shift"], act=act, dtype=dtype)
    skips = [skip]
    for i in (2, 3, 4):
        ly = stacked[f"down{i}"]
        skip, x = encoder.enc_s2(x, ly["w"], ly["b"], ly["bn_scale"],
                                 ly["bn_shift"], act=act)
        skips.append(skip)
    return skips, x


@pytest.mark.parametrize("act", ["elu", "leaky"])
def test_encoder_matches_jax_packed(rng, act):
    """Two stems over one stem-shared (B=2, 32, 64, 2) magnitude: every
    skip and enc4's activation, image s*B + b from stem s."""
    jstacked, stacked = _stacked_encoders(rng, 2)
    mag = (np.abs(rng.standard_normal((2, 32, 64, 2))) * 2.0).astype(np.float32)
    jskips, jact4 = jencoder.encoder_packed(
        jstacked, jnp.asarray(mag), n_layers=4, act=act,
        compute_dtype=jnp.float32,
    )
    kernels.reset_launch_counts()
    skips, act4 = _port_encoder(stacked, mag, act)
    assert not any(kernels.launch_counts().values())  # CPU: plain versions
    for i, (got, ref) in enumerate(zip(skips + [act4], list(jskips) + [jact4])):
        cout = LAYERS[min(i, 3)][1]
        ref = np.asarray(jencoder.quad_unpack(ref, cout))
        assert got.shape == ref.shape == (4, 32 >> (min(i, 3) + 1),
                                          64 >> (min(i, 3) + 1), cout)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=2e-4)


def test_enc1_bf16_plain_rounds_operands_and_outputs(rng):
    """The bf16 plain version sums bf16-rounded operands in float32 and
    stores bf16: equal to the float32 plain version on rounded inputs,
    rounded once."""
    _, stacked = _stacked_encoders(rng, 1)
    ly = dict(stacked["down1"])
    mag = torch.from_numpy(np.abs(rng.standard_normal((2, 2, 32, 64))).astype(np.float32))
    skip, actv = encoder.enc1(mag, ly["w"], ly["b"], ly["bn_scale"],
                              ly["bn_shift"], act="elu", dtype=torch.bfloat16)
    rounded = lambda t: t.to(torch.bfloat16).float()
    rskip, ractv = encoder.enc1(
        rounded(mag), rounded(ly["w"]), ly["b"], ly["bn_scale"], ly["bn_shift"],
        act="elu", dtype=torch.float32,
    )
    assert skip.dtype == actv.dtype == torch.bfloat16
    assert torch.equal(skip, rskip.to(torch.bfloat16))
    assert torch.equal(actv, ractv.to(torch.bfloat16))


def test_encoder_wrappers_reject_bad_inputs(rng):
    _, stacked = _stacked_encoders(rng, 2)
    d1, d2 = stacked["down1"], stacked["down2"]
    args1 = (d1["w"], d1["b"], d1["bn_scale"], d1["bn_shift"])
    mag = torch.rand(2, 2, 32, 64)
    with pytest.raises(ValueError, match="float32"):
        encoder.enc1(mag.double(), *args1, act="elu", dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        encoder.enc1(mag.transpose(2, 3), *args1, act="elu", dtype=torch.float32)
    with pytest.raises(ValueError, match="act"):
        encoder.enc1(mag, *args1, act="relu", dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        encoder.enc1(mag, *args1, act="elu", dtype=torch.float16)
    with pytest.raises(ValueError, match="w"):
        encoder.enc1(mag, *(a[:, :8] for a in args1), act="elu",
                     dtype=torch.float32)
    args2 = (d2["w"], d2["b"], d2["bn_scale"], d2["bn_shift"])
    with pytest.raises(ValueError, match="C in"):
        encoder.enc_s2(torch.rand(4, 16, 32, 8), *args2, act="elu")
    with pytest.raises(ValueError, match="multiple of 2 stems"):
        encoder.enc_s2(torch.rand(3, 16, 32, 16), *args2, act="elu")
    with pytest.raises(ValueError, match=r"expected \(S, \*\(64, 32, 5, 5\)\)"):
        encoder.enc_s2(torch.rand(4, 16, 32, 32), *args2, act="elu")


# ---------------------------------------------------------------------------
# The tensor-core K3's host side: its weight layout and its tap-by-tap GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,dtype", [
    (2, torch.float32), (2, torch.bfloat16), (16, torch.float32),
    (16, torch.bfloat16), (32, torch.bfloat16), (64, torch.bfloat16),
])
def test_conv_weights_layout_round_trips(rng, cin, dtype):
    """bf16 enc1 gets (S, 16, 64), k = 2 (5 kh + kw) + ci and zeros from 50
    on, and bf16 enc2-enc4 (S, 25, Cout, Cin), tap kh * 5 + kw (the tensor
    cores' B operands); fp32 layers keep (S, 5, 5, Cin, Cout). Either way
    the original weights come back, rounded to dtype."""
    cout = 16 if cin == 2 else 2 * cin
    w = torch.from_numpy(rng.standard_normal((2, cout, cin, 5, 5)).astype(np.float32))
    wk = encoder._conv_weights(w, dtype)
    assert wk.dtype == dtype and wk.is_contiguous()
    if encoder._tensor_cores(cin, dtype) and cin == 2:
        assert wk.shape == (2, 16, encoder.ENC1_K)
        assert not wk[..., 50:].any()
        back = wk[..., :50].reshape(2, 16, 5, 5, 2).permute(0, 1, 4, 2, 3)
    elif encoder._tensor_cores(cin, dtype):
        assert wk.shape == (2, 25, cout, cin)
        back = wk.reshape(2, 5, 5, cout, cin).permute(0, 3, 4, 1, 2)
    else:
        assert wk.shape == (2, 5, 5, cin, cout)
        back = wk.permute(0, 4, 3, 1, 2)
    assert torch.equal(back, w.to(dtype))
    assert encoder._tensor_cores(cin, dtype) == (dtype == torch.bfloat16)


def _implicit_gemm(x, wk, b, bn_scale, bn_shift, act, bper):
    """The tensor-core kernel's arithmetic in torch: for each of the 25 taps
    (kh, kw), the stride-2 pixels (2 ho + kh - 1, 2 wo + kw - 1) of the
    TF-SAME padded NHWC input (pad 1 before, 2 after) times the tap's
    (Cout, Cin) slice of wk, summed tap by tap in float32; then the
    epilogue. Image n uses stem n // bper's weights."""
    n_img, h, w, _ = x.shape
    ho, wo = h // 2, w // 2
    xp = torch.nn.functional.pad(x, (0, 0, 1, 2, 1, 2))
    stem = torch.arange(n_img) // bper
    acc = torch.zeros((n_img, ho, wo, wk.shape[2]))
    for tap in range(25):
        kh, kw = divmod(tap, 5)
        a = xp[:, kh : kh + 2 * ho : 2, kw : kw + 2 * wo : 2, :]  # (N, Ho, Wo, Cin)
        acc += torch.einsum("nhwc,noc->nhwo", a, wk[stem, tap].float())
    skip = acc + b[stem][:, None, None]
    z = bn_scale[stem][:, None, None] * skip + bn_shift[stem][:, None, None]
    return skip, encoder.model.activation(z, act)


@pytest.mark.parametrize("cin", encoder.S2_WIDTHS)
def test_tap_by_tap_implicit_gemm_matches_plain(rng, cin):
    """The emulated implicit GEMM over the (S, 25, Cout, Cin) layout equals
    enc_s2_plain in float32 on bf16-rounded operands, to 1e-5 of max|plain|,
    two stems over B = 2 images of 10 x 14 (H/2, W/2 odd)."""
    ly = _rand_layer(rng, cin, 2 * cin)
    w = torch.from_numpy(np.stack([ly["w"], -ly["w"]]).transpose(0, 4, 3, 1, 2).copy())
    vec = lambda k: torch.from_numpy(np.stack([ly[k], ly[k][::-1].copy()]))
    b, scale, shift = vec("b"), vec("bn_scale"), vec("bn_shift")
    x = torch.from_numpy(rng.standard_normal((4, 10, 14, cin)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    wk = encoder._conv_weights(w, torch.bfloat16)
    got = _implicit_gemm(x, wk, b, scale, shift, "elu", bper=2)
    ref = encoder.enc_s2_plain(x, w.to(torch.bfloat16).float(), b, scale, shift,
                               act="elu")
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (4, 5, 7, 2 * cin)
        assert (g - r).abs().max().item() <= 1e-5 * r.abs().max().item()


# ---------------------------------------------------------------------------
# The tensor-core K2's host side: its staged patch, K order and stores
# ---------------------------------------------------------------------------


def _launched_enc1_tile() -> tuple[int, int]:
    """(TH, TW) of csrc/encoder.cu's ENC1_MMA, the launched pixel tile."""
    src = (encoder._build.CSRC / "encoder.cu").read_text()
    th, tw, _ = map(int, re.search(r"#define ENC1_MMA (\d+), (\d+), (\d+)", src).groups())
    return th, tw


def _quad_transpose(a: list, q: torch.Tensor) -> list:
    """csrc/encoder.cu::quad_transpose over the 32 lanes of a warp: a[i]
    (32, ...) holds lane l's word i; shuffles become gathers from lane l ^
    1 and l ^ 2, selects torch.where on q's bits."""
    lanes = torch.arange(32)
    q0 = (q & 1).bool().view(32, *([1] * (a[0].ndim - 1)))
    q1 = (q & 2).bool().view_as(q0)
    sel = torch.where
    r0 = sel(q0, a[0], a[1])[lanes ^ 1]
    r1 = sel(q0, a[2], a[3])[lanes ^ 1]
    k0, k1 = sel(q0, a[1], a[0]), sel(q0, a[3], a[2])
    c0, c1, c2, c3 = sel(q0, r0, k0), sel(q0, k0, r0), sel(q0, r1, k1), sel(q0, k1, r1)
    u0 = sel(q1, c0, c2)[lanes ^ 2]
    u1 = sel(q1, c1, c3)[lanes ^ 2]
    return [sel(q1, u0, c0), sel(q1, u1, c1), sel(q1, c2, u0), sel(q1, c3, u1)]


def _activate_bf16(z, act):
    """csrc/encoder.cu::activate_bf16: the ELU as exp(z) - 1 (inputs below
    -15 give exactly -1), the other activations as model.activation."""
    if act != "elu":
        return encoder.model.activation(z, act)
    return torch.where(z > 0, z, torch.where(z < -15, -1.0, torch.exp(z) - 1))


def _enc1_mma_model(mag, wk, b, bn_scale, bn_shift, act, th, tw):
    """csrc/encoder.cu::enc1_mma_kernel's indexing in torch, block by block
    and warp tile by warp tile: the patch staged as channel pairs at word
    lr * RS + parity * HS + k (columns split by parity), each lane's A
    words at its taps' offsets (K = (kh, kw, ci), ci innermost, padded
    from 50 to 64 with zero weights whose taps read tap 0's pixel), N =
    16 S over the one shared magnitude, the float32 epilogue (the ELU as
    exp(z) - 1), the quad
    transpose and each lane's 8-channel store. Returns float32 (skip,
    act), unrounded, with NaN where nothing was stored."""
    nb, _, h, w = mag.shape
    s_n = wk.shape[0]
    ho_n, wo_n = h // 2, w // 2
    pr, pp = 2 * th + 3, tw + 2
    hs = pp + (48 - pp % 32) % 32
    rs = 2 * hs + 8
    wkf = wk.float()  # (S, 16, 64)
    lane = torch.arange(32)
    g, q = lane >> 2, lane & 3
    off = torch.empty((4, 2, 32), dtype=torch.long)
    for ks in range(4):
        for hh in range(2):
            tap = 8 * ks + 4 * hh + q
            kh, kw = tap // 5, tap % 5
            off[ks, hh] = torch.where(tap < 25, kh * rs + ((kw + 1) & 1) * hs + ((kw + 1) >> 1), hs)
    outs = [torch.full((s_n * nb, ho_n, wo_n, 16), float("nan")) for _ in range(2)]
    xp = torch.nn.functional.pad(mag, (2, 2 * tw + 4, 1, 2 * th + 4))  # zeros outside
    lr, k = torch.meshgrid(torch.arange(pr), torch.arange(pp), indexing="ij")
    for bb in range(nb):
        for ho0 in range(0, ho_n, th):
            for wo0 in range(0, wo_n, tw):
                # Input row hi0 + lr = 2 ho0 - 1 + lr, column pair wi0 + 2 k.
                rows = xp[bb, :, 2 * ho0 + lr, 2 * wo0 + 2 * k]  # (2 ci, pr, pp), even column
                rows_odd = xp[bb, :, 2 * ho0 + lr, 2 * wo0 + 2 * k + 1]
                patch = torch.full((pr * rs, 2), float("nan"))
                patch[(lr * rs + k).flatten()] = rows.flatten(1).T
                patch[(lr * rs + hs + k).flatten()] = rows_odd.flatten(1).T
                for mt in range(th * tw // 16):
                    r, c = divmod(mt, tw // 16)
                    ho, wo = ho0 + r, wo0 + 16 * c
                    if ho >= ho_n or wo >= wo_n:
                        continue
                    base = 2 * r * rs + 16 * c + g  # (32,)
                    a = torch.zeros((16, 32, 2))  # A[pixel, k pair, ci]
                    for ks in range(4):
                        for hh in range(2):
                            kp = 8 * ks + 4 * hh + q
                            a[g, kp] = patch[base + off[ks, hh]]
                            a[g + 8, kp] = patch[base + off[ks, hh] + 8]
                    wpx = wo + g + 8 * (q >> 1)
                    for s in range(s_n):
                        acc = a.reshape(16, 64) @ wkf[s].T  # (pixel, channel)
                        sk = acc + b[s]
                        av = _activate_bf16(bn_scale[s] * sk + bn_shift[s], act)
                        for out, val in zip(outs, (sk, av)):
                            # Lane (g, q) word 2 h + n: pixel g + 8 h, channels
                            # 8 n + 2 q, + 1.
                            words = [torch.stack([val[g + 8 * (i >> 1), 8 * (i & 1) + 2 * q],
                                                  val[g + 8 * (i >> 1), 8 * (i & 1) + 2 * q + 1]], -1)
                                     for i in range(4)]
                            got = torch.cat(_quad_transpose(words, q), -1)  # (32, 8)
                            keep = wpx < wo_n
                            chans = (8 * (q & 1))[keep, None] + torch.arange(8)
                            out[s * nb + bb, ho, wpx[keep][:, None], chans] = got[keep]
    return tuple(outs)


@pytest.mark.parametrize("tile", ["launched", (2, 32)])
@pytest.mark.parametrize("n_stems", [1, 4])
def test_enc1_tensor_core_model_matches_plain(rng, n_stems, tile):
    """The emulated bf16 enc1 kernel, N = 16 S over one magnitude, equals
    enc1_plain in float32 on bf16-rounded operands to 1e-5 of max|plain|,
    over two tiles of 22 x 70 (H/2 = 11 and W/2 = 35 odd, neither a
    multiple of the pixel tile), with every output written."""
    th, tw = _launched_enc1_tile() if tile == "launched" else tile
    ly = [_rand_layer(rng, 2, 16) for _ in range(n_stems)]
    w = torch.from_numpy(np.stack([l["w"] for l in ly]).transpose(0, 4, 3, 1, 2).copy())
    vec = lambda k: torch.from_numpy(np.stack([l[k] for l in ly]))
    b, scale, shift = vec("b"), vec("bn_scale"), vec("bn_shift")
    mag = torch.from_numpy(np.abs(rng.standard_normal((2, 2, 22, 70))).astype(np.float32))
    mag = mag.to(torch.bfloat16).float()
    wk = encoder._conv_weights(w, torch.bfloat16)
    got = _enc1_mma_model(mag, wk, b, scale, shift, "elu", th, tw)
    ref = encoder.enc1_plain(mag, w.to(torch.bfloat16).float(), b, scale, shift,
                             act="elu", dtype=torch.float32)
    for g_, r_ in zip(got, ref):
        assert g_.shape == r_.shape == (2 * n_stems, 11, 35, 16)
        assert not torch.isnan(g_).any()
        assert (g_ - r_).abs().max().item() <= 1e-5 * r_.abs().max().item()


def test_quad_transpose_gives_each_lane_eight_channels():
    """The two-round shuffle transpose: lane q of every quad ends with word
    j = lane j's word q, for all 32 lanes."""
    lane = torch.arange(32)
    words = [(lane * 4 + i).view(32, 1) for i in range(4)]  # lane l's word i = 4 l + i
    got = torch.cat(_quad_transpose(words, lane & 3), -1)
    quad = lane & ~3
    want = torch.stack([(quad + j) * 4 + (lane & 3) for j in range(4)], -1)
    assert torch.equal(got, want)
