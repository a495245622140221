"""spleeterrt_tpu_torch.kernels.tail (K4 up4, K5 up5, K6 head) and the packed
U-Net route of core/model.py against the JAX package, on the CPU.

The JAX side runs its packed kernels (spleeterrt_tpu/kernels/tail.py, and
for the whole U-Net also kernels/encoder.py) in interpret mode, with
FORCE_PACKED_UNET = True where it goes through core/model.py; the port's
wrappers take their plain versions for CPU tensors, so the CPU runs the
same composition the card runs with the kernels. Tolerances are the JAX
package's own for these kernels (tests/test_tail.py): up4/up5 and the
U-Net atol 1e-4 / rtol 2e-4, the head atol 2e-5 / rtol 1e-4, the
separation atol 5e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from spleeterrt_tpu.config import SeparatorConfig as JSeparatorConfig
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import separate as jseparate
from spleeterrt_tpu.core import transform as jtransform
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu.kernels import stft_fused as jstft_fused
from spleeterrt_tpu.kernels import tail as jtail
from spleeterrt_tpu.kernels.encoder import quad_unpack
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.config import STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu_torch.core import model, separate, weights
from spleeterrt_tpu_torch.kernels import tail

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


def _rand_layer(rng, cin, cout):
    """One 5x5 decoder layer in the JAX package's layout (HWIO kernel),
    random bias and batch norm."""
    return {
        "w": (rng.standard_normal((5, 5, cin, cout)) * 0.2).astype(np.float32),
        "b": (0.1 * rng.standard_normal(cout)).astype(np.float32),
        "bn_scale": (1 + 0.3 * rng.standard_normal(cout)).astype(np.float32),
        "bn_shift": (0.2 * rng.standard_normal(cout)).astype(np.float32),
    }


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tconv_w(w_hwio):
    """HWIO -> (Cin, Cout, kh, kw), as params_from_jax converts up1..up6."""
    return _t(np.asarray(w_hwio).transpose(2, 3, 0, 1))


def _stack(layers):
    """Port-layout stacked (w, b, bn_scale, bn_shift) of per-stem decoder
    layers."""
    return (
        torch.stack([_tconv_w(ly["w"]) for ly in layers]),
        *(torch.stack([_t(ly[k]) for ly in layers])
          for k in ("b", "bn_scale", "bn_shift")),
    )


def _jax_up(layers, skip, prev, t_in, act):
    cs = skip.shape[-1]

    def packed(rows):
        return tuple(jnp.stack(ws) for ws in zip(*[
            jtail._pack_w_up(jnp.asarray(ly["w"])[:, :, rows, :], cs, jnp.float32)
            for ly in layers
        ]))

    epi = jnp.stack([
        jtail._up_epilogue(*(jnp.asarray(ly[k]) for k in ("b", "bn_scale", "bn_shift")))
        for ly in layers
    ])
    out = jtail.up_shallow(
        jtail.pad_pk(jtail.quad_pack_nhwc(jnp.asarray(skip), cs)),
        jtail.pad_pk(jtail.quad_pack_nhwc(jnp.asarray(prev), cs)),
        packed(slice(0, cs)), packed(slice(cs, 2 * cs)), epi,
        t_in=t_in, act=act, out_dtype=jnp.float32,
    )
    return np.asarray(quad_unpack(out, cs // 2))


@pytest.mark.parametrize("cin_src,t_in,f_in", [(64, 8, 8), (32, 16, 16)])
def test_up_shallow_matches_jax(rng, cin_src, t_in, f_in):
    """up4 (64 + 64 -> 32) and up5 (32 + 32 -> 16), one stem."""
    ly = _rand_layer(rng, 2 * cin_src, cin_src // 2)
    skip = rng.standard_normal((2, t_in, f_in, cin_src)).astype(np.float32)
    prev = rng.standard_normal((2, t_in, f_in, cin_src)).astype(np.float32)
    ref = _jax_up([ly], skip, prev, t_in, "elu")
    got = tail.up_shallow(_t(skip), _t(prev), *_stack([ly]), act="elu")
    assert got.shape == ref.shape == (2, 2 * t_in, 2 * f_in, cin_src // 2)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=2e-4)


def test_up_shallow_per_stem_weights(rng):
    """Images [s*B, (s+1)*B) take stem s's weights."""
    cin_src, t_in, f_in = 32, 8, 16
    lys = [_rand_layer(rng, 2 * cin_src, cin_src // 2) for _ in range(2)]
    skip = rng.standard_normal((4, t_in, f_in, cin_src)).astype(np.float32)
    prev = rng.standard_normal((4, t_in, f_in, cin_src)).astype(np.float32)
    ref = _jax_up(lys, skip, prev, t_in, "relu")
    got = tail.up_shallow(_t(skip), _t(prev), *_stack(lys), act="relu")
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=2e-4)


def test_head_matches_jax(rng):
    """up6 + up7 + sigmoid at t2 = 64, f2 = 128 with random biases and batch
    norms, so a missing domain mask on y6 would show at the edges."""
    t2, f2 = 64, 128
    up6 = _rand_layer(rng, 32, 1)
    w7 = (rng.standard_normal((4, 4, 1, 2)) * 0.3).astype(np.float32)
    b7 = (0.1 * rng.standard_normal(2)).astype(np.float32)
    skip1 = rng.standard_normal((2, t2, f2, 16)).astype(np.float32)
    up5o = rng.standard_normal((2, t2, f2, 16)).astype(np.float32)
    j = lambda a: jnp.asarray(a)[None]
    ref = np.asarray(jtail.unpack_mask(
        jtail.head_packed(
            jtail.pad_pk_head(jtail.quad_pack_nhwc(jnp.asarray(skip1), 16)),
            jtail.pad_pk_head(jtail.quad_pack_nhwc(jnp.asarray(up5o), 16)),
            j(up6["w"]), j(up6["b"]), j(up6["bn_scale"]), j(up6["bn_shift"]),
            j(w7), j(b7), t2=t2, act="elu", compute_dtype=jnp.float32,
        ),
        t2, f2,
    ))  # NHWC (B, T, F, 2)
    w6, b6, s6, h6 = _stack([up6])
    got = tail.head(
        _t(skip1), _t(up5o), w6, b6, s6, h6,
        _t(w7.transpose(3, 2, 0, 1))[None], _t(b7)[None], act="elu",
    )
    assert got.shape == (1, 2, 2, 2 * t2, 2 * f2) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), ref,
                               atol=2e-5, rtol=1e-4)


def _faulted_head(skip1, up5, w6, b6, s6, h6, w7, b7, *, act, fault):
    """The head with a planted fault: "domain", y6 not zeroed outside the
    image (the decoder epilogue runs on up6's full transposed conv 3 pixels
    out, where up7 reads it); "shift", up7 reading y6 one column off."""
    dtype = skip1.dtype
    x = torch.cat([skip1, up5], -1).float().permute(0, 3, 1, 2)
    masks = []
    for s, xs in enumerate(x.chunk(w6.shape[0])):
        epi = lambda z: s6[s][:, None, None] * model.activation(
            z + b6[s][:, None, None], act) + h6[s][:, None, None]
        w = w6[s].to(dtype).float()
        w7s = w7[s].to(dtype).float()
        if fault == "domain":  # y6 over [-3, 2H + 3), then up7 unpadded
            y = epi(model.tconv_same(F.pad(xs, (2, 2, 2, 2)), w))[..., 1:-1, 1:-1]
            logit = F.conv2d(y.to(dtype).float(), w7s, dilation=2)
        else:
            y = epi(model.tconv_same(xs, w))
            if fault == "shift":
                y = F.pad(y, (1, 0))[..., :-1]
            logit = model.conv_dilated_final(y.to(dtype).float(), w7s)
        masks.append(torch.sigmoid(logit + b7[s][:, None, None]))
    return torch.stack(masks)


@pytest.mark.parametrize("fault", ["domain", "shift"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_error_bound_fails_planted_faults(rng, dtype, fault):
    """tail.head_error_bound, which the card checks hold K6 to, admits the
    plain head and fails a head without the y6 domain mask or with up7 one
    column off, at 2 stems x 2 tiles with random biases and batch norms."""
    t2, f2 = 32, 64
    w6, b6, s6, h6 = _stack([_rand_layer(rng, 32, 1) for _ in range(2)])
    w7 = _t((rng.standard_normal((2, 2, 1, 4, 4)) * 0.3).astype(np.float32))
    b7 = _t((0.1 * rng.standard_normal((2, 2))).astype(np.float32))
    src = [_t(rng.standard_normal((4, t2, f2, 16)).astype(np.float32)).to(dtype)
           for _ in range(2)]
    args = (*src, w6, b6, s6, h6, w7, b7)
    ref = tail.head(*args, act="elu")
    bound = tail.head_error_bound(*args, act="elu")
    assert bound.shape == ref.shape == (2, 2, 2, 2 * t2, 2 * f2)
    assert torch.all(bound < 0.1)  # on the masks' scale, which is [0, 1]
    clean = _faulted_head(*args, act="elu", fault="none")
    assert torch.all((clean - ref).abs() <= bound)
    err = (_faulted_head(*args, act="elu", fault=fault) - ref).abs()
    assert (err / bound).max() > 10


def _random_nets(rng, n):
    """n full nets: the JAX package's init_params with random biases and
    batch norms; numpy leaves in the JAX layout."""
    nets = []
    for i in range(n):
        p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(i)))
        for ly in p.values():
            c = ly["b"].shape[0]
            ly["b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            if "bn_scale" in ly:
                ly["bn_scale"] = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
                ly["bn_shift"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        nets.append(p)
    return (
        jweights.stack_params(nets),
        weights.stack_params([weights.params_from_jax(p) for p in nets]),
    )


def _jax_packed(fn):
    """fn() with the JAX package forced onto its packed U-Net."""
    try:
        jmodel.FORCE_PACKED_UNET = True
        jmodel.unet_forward.clear_cache()
        return fn()
    finally:
        jmodel.FORCE_PACKED_UNET = None
        jmodel.unet_forward.clear_cache()


def test_packed_unet_matches_jax_packed(rng):
    """The port's multi_stem_forward on the CPU (packed route, plain
    versions) against the JAX package's packed U-Net, 2 stems."""
    jstacked, stacked = _random_nets(rng, 2)
    mag = (np.abs(rng.standard_normal((2, 64, 128, 2))) * 3.0).astype(np.float32)
    assert model.use_packed_unet(stacked, _t(mag.transpose(0, 3, 1, 2)), "exact")
    ref = _jax_packed(lambda: np.asarray(jmodel.multi_stem_forward(
        jstacked, jnp.asarray(mag), compute_dtype=jnp.float32)))
    kernels.reset_launch_counts()
    got = model.multi_stem_forward(stacked, _t(mag), STEM_MODE_4, torch.float32)
    assert not any(kernels.launch_counts().values())
    assert got.shape == ref.shape == (2, *mag.shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=2e-4)


def test_separate_4stem_matches_jax_packed_fused(rng, monkeypatch):
    """4 stems over 2 tiles: the port's separate_nstem against the JAX
    package's fused graph (fused STFT, packed U-Net, fused masked iSTFT)."""
    monkeypatch.setenv("SPLEETERRT_FUSED_STFT", "1")
    cfg = SeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                          compute_dtype=torch.float32)
    jcfg = JSeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                            compute_dtype=jnp.float32)
    jstacked, stacked = _random_nets(rng, 4)
    x = (rng.standard_normal((2, 90_000)) * 0.3).astype(np.float32)
    padded = np.array(jtransform.pad_offline(jnp.asarray(x), jcfg.transform))
    caches = (jseparate.separate_nstem, jstft_fused.stft4096_packed,
              jstft_fused.masked_istft4096_cd)
    for f in caches:
        f.clear_cache()
    try:
        ref = _jax_packed(lambda: np.asarray(jseparate.separate_nstem(
            jstacked, jnp.asarray(padded), jcfg, separate.OUT_BAND_4)))
    finally:
        for f in caches:
            f.clear_cache()
    got = separate.separate_nstem(stacked, _t(padded), cfg, separate.OUT_BAND_4)
    n_out = got.shape[-1] // 1024 - 3
    assert separate.num_tiles(n_out, cfg.time_step) >= 2
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4)


def test_routing_follows_the_reference_gate(monkeypatch):
    """The packed route takes the standard net at tile shapes the kernels
    take with the exact sigmoid, on any device; other shapes leave it, and
    the LUT sigmoid leaves it for the round-3 encoder (K2, K3) with the
    canonical head, as in the reference (its encoder gate ignores the
    sigmoid), which agrees with the canonical per-stem nets."""
    gen = torch.Generator().manual_seed(0)
    stacked = weights.stack_params([model.init_params(gen) for _ in range(2)])
    vst = torch.empty((51, 2, 256, 1536), device="meta")
    assert model.use_packed_unet(stacked, vst, "exact")
    assert not model.use_packed_unet(stacked, vst, "lut")
    for t, f in ((32, 128), (64, 96), (96, 128)):
        assert not model.use_packed_unet(
            stacked, torch.empty((1, 2, t, f), device="meta"), "exact")

    calls = []
    for name in ("packed_unet_masks", "multi_stem_trunk"):
        real = getattr(model, name)
        monkeypatch.setattr(model, name, functools.partial(
            lambda name, real, *a: calls.append(name) or real(*a), name, real))
    mag = torch.rand((1, 2, 64, 128), generator=gen) * 3
    model.multi_stem_masks(stacked, mag, sigmoid="exact")
    assert calls == ["packed_unet_masks"]
    got = model.multi_stem_masks(stacked, mag, sigmoid="lut")
    assert calls == ["packed_unet_masks", "multi_stem_trunk"]
    assert model.use_pallas_encoder(stacked, mag)
    assert not model.use_pallas_head(stacked, mag, "lut")
    ref = torch.stack([
        model.unet_forward_nchw(model.stem_params(stacked, s), mag, sigmoid="lut")
        for s in range(2)
    ])
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-5


def test_tail_wrappers_reject_bad_inputs(rng):
    ly = _rand_layer(rng, 64, 16)
    w, b, s, h = _stack([ly])
    x = torch.rand(2, 8, 8, 32)
    with pytest.raises(ValueError, match="shapes differ"):
        tail.up_shallow(x, torch.rand(2, 8, 4, 32), w, b, s, h, act="elu")
    with pytest.raises(ValueError, match="prev"):
        tail.up_shallow(x, x.to(torch.bfloat16), w, b, s, h, act="elu")
    with pytest.raises(ValueError, match="channels"):
        tail.up_shallow(torch.rand(2, 8, 8, 16), torch.rand(2, 8, 8, 16),
                        w, b, s, h, act="elu")
    with pytest.raises(ValueError, match="act"):
        tail.up_shallow(x, x, w, b, s, h, act="leaky")
    with pytest.raises(ValueError, match="contiguous"):
        tail.up_shallow(x.transpose(1, 2), x, w, b, s, h, act="elu")
    up6 = _rand_layer(rng, 32, 1)
    w6, b6, s6, h6 = _stack([up6])
    w7, b7 = torch.rand(1, 2, 1, 4, 4), torch.rand(1, 2)
    src = torch.rand(2, 32, 32, 16)
    with pytest.raises(ValueError, match="w7"):
        tail.head(src, src, w6, b6, s6, h6, w7[:, :1].contiguous(), b7, act="elu")
    with pytest.raises(ValueError, match="disagree"):
        tail.head(src, src, w6, b6, s6, h6, w7.repeat(2, 1, 1, 1, 1),
                  b7.repeat(2, 1), act="elu")
    with pytest.raises(ValueError, match="16 channels"):
        tail.head(torch.rand(2, 32, 32, 8), torch.rand(2, 32, 32, 8),
                  w6, b6, s6, h6, w7, b7, act="elu")


# ---------------------------------------------------------------------------
# The tensor-core K4/K5's host side: its weight layout and its per-parity GEMM
# ---------------------------------------------------------------------------


def _parity(k):
    """Tap k of a 5-tap axis -> (output parity, input shift): output 2h' +
    dp reads input h' + dh through k = 1 - 2 dh + dp (csrc/tail.cu)."""
    return (0, (1 - k) // 2) if k % 2 else (1, (2 - k) // 2)


@pytest.mark.parametrize("c,dtype", [
    (64, torch.float32), (64, torch.bfloat16), (32, torch.float32),
    (32, torch.bfloat16),
])
def test_up_weights_layout_round_trips(rng, c, dtype):
    """bf16 up4/up5 get (S, 25, C/2, 2C), taps in _UP_TAPS order (the
    tensor cores' B operand, K contiguous); float32 keeps (S, 2C, 5, 5,
    C/2). Either way the original weights come back, rounded to dtype."""
    w = torch.from_numpy(rng.standard_normal((2, 2 * c, c // 2, 5, 5)).astype(np.float32))
    wk = tail._up_weights(w, dtype)
    assert wk.dtype == dtype and wk.is_contiguous()
    if tail._tensor_cores(c, dtype):
        assert wk.shape == (2, 25, c // 2, 2 * c)
        back = torch.empty((2, 25, c // 2, 2 * c), dtype=dtype)
        back[:, list(tail._UP_TAPS)] = wk
        back = back.reshape(2, 5, 5, c // 2, 2 * c).permute(0, 4, 3, 1, 2)
    else:
        assert wk.shape == (2, 2 * c, 5, 5, c // 2)
        back = wk.permute(0, 1, 4, 2, 3)
    assert torch.equal(back, w.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_tensor_cores_rule(dtype):
    """The tensor-core template takes exactly bf16 with C in {64, 32}."""
    for c in (16, 32, 64, 128):
        assert tail._tensor_cores(c, dtype) == (dtype == torch.bfloat16 and c in (64, 32))


def test_up_taps_walk_shifts_in_order():
    """_UP_TAPS holds each of the 25 taps once, grouped by input shift
    (dh, dw) in row-major order, within a shift the parities in the
    accumulator slot order 0, 1, 3, 2: the order the tensor-core kernels
    walk them (csrc/tail.cu::up_tap). Every shift's parities are one run of
    slots, so one wgmma covers them."""
    assert sorted(tail._UP_TAPS) == list(range(25))
    slot = {0: 0, 1: 1, 3: 2, 2: 3}  # parity 2 dp + dq -> slot
    keys = []
    for tap in tail._UP_TAPS:
        (dp, dh), (dq, dw) = _parity(tap // 5), _parity(tap % 5)
        keys.append((dh, dw, slot[2 * dp + dq]))
    assert keys == sorted(keys)
    for shift in sorted({k[:2] for k in keys}):
        slots = [k[2] for k in keys if k[:2] == shift]
        assert slots == list(range(slots[0], slots[0] + len(slots)))
        assert len(slots) in (1, 2, 4)
    shifts = [k[:2] for k in keys]
    assert [shifts.count(s) for s in sorted(set(shifts))] == [4, 4, 2, 4, 4, 2, 2, 2, 1]


def _subpixel_gemm(skip, prev, wk, b, bn_scale, bn_shift, act, bper):
    """The tensor-core kernel's arithmetic in torch: each output parity
    (dp, dq) is a GEMM over its taps, the tap's A operand the concat [skip,
    prev] (K: the skip's channels, then prev's; zeros outside the image)
    shifted by (dh, dw), its B operand the tap's (C/2, 2C) slice of wk,
    summed in float32; then the epilogue, activation before batch norm.
    Image n uses stem n // bper's weights."""
    n_img, h, w, _ = skip.shape
    x = F.pad(torch.cat([skip, prev], -1), (0, 0, 1, 1, 1, 1))
    stem = torch.arange(n_img) // bper
    acc = torch.zeros((n_img, 2, 2, h, w, wk.shape[2]))  # [n][dp][dq]
    for t, tap in enumerate(tail._UP_TAPS):
        (dp, dh), (dq, dw) = _parity(tap // 5), _parity(tap % 5)
        a = x[:, 1 + dh : 1 + dh + h, 1 + dw : 1 + dw + w]  # (N, H, W, 2C)
        acc[:, dp, dq] += torch.einsum("nhwk,nok->nhwo", a, wk[stem, t].float())
    vec = lambda v: v[stem][:, None, None, None, None]
    y = vec(bn_scale) * model.activation(acc + vec(b), act) + vec(bn_shift)
    return y.permute(0, 3, 1, 4, 2, 5).reshape(n_img, 2 * h, 2 * w, -1)


@pytest.mark.parametrize("c,act", [(64, "elu"), (32, "relu")])
def test_per_parity_gemm_matches_plain(rng, c, act):
    """The emulated per-parity GEMM over the (S, 25, C/2, 2C) layout equals
    up_shallow_plain in float32 on bf16-rounded operands, to 1e-5 of
    max|plain|: up4 and up5, two stems over B = 2 images of 5 x 7."""
    lys = [_rand_layer(rng, 2 * c, c // 2) for _ in range(2)]
    w, b, scale, shift = _stack(lys)
    skip, prev = (_t(rng.standard_normal((4, 5, 7, c)).astype(np.float32))
                  .to(torch.bfloat16).float() for _ in range(2))
    wk = tail._up_weights(w, torch.bfloat16)
    got = _subpixel_gemm(skip, prev, wk, b, scale, shift, act, bper=2)
    ref = tail.up_shallow_plain(skip, prev, w.to(torch.bfloat16).float(), b,
                                scale, shift, act=act)
    assert got.shape == ref.shape == (4, 10, 14, c // 2)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


# ---------------------------------------------------------------------------
# The tensor-core K6/K10's host side: its weight layout and its 18-step GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_head_tensor_cores_rule(dtype):
    """The head's tensor-core template takes exactly bf16."""
    assert tail._head_tensor_cores(dtype) == (dtype == torch.bfloat16)


def test_head_weights_round_trip(rng):
    """_head_weights gives (S, 18, 8, 16) bf16: step 9 src + shift, column
    2 dp + dq, K the source's channel. Every tap of w6 rounded to bf16
    comes back once per (source, channel) from the (shift, parity) that
    reads it; the padding columns 4-7 and the 11 (shift, parity) pairs
    with no tap are zero."""
    w6 = _t(rng.standard_normal((2, 32, 1, 5, 5)).astype(np.float32))
    wk = tail._head_weights(w6, torch.bfloat16)
    assert wk.shape == (2, 18, 8, 16) and wk.dtype == torch.bfloat16
    assert wk.is_contiguous()
    back = torch.zeros((2, 32, 25), dtype=torch.bfloat16)
    seen = torch.zeros(25, dtype=torch.int64)
    for sh in range(9):
        dh, dw = sh // 3 - 1, sh % 3 - 1
        for col in range(8):
            dp, dq = divmod(col, 2)
            kh, kw = 1 - 2 * dh + dp, 1 - 2 * dw + dq
            for src in range(2):
                got = wk[:, 9 * src + sh, col]  # (S, 16)
                if col >= 4 or not (0 <= kh < 5 and 0 <= kw < 5):
                    assert torch.all(got == 0)
                    continue
                back[:, 16 * src : 16 * src + 16, 5 * kh + kw] = got
            if col < 4 and 0 <= kh < 5 and 0 <= kw < 5:
                seen[5 * kh + kw] += 1
    assert torch.all(seen == 1)
    assert torch.equal(back.reshape(2, 32, 1, 5, 5), w6.to(torch.bfloat16))


def _head_gemm(skip1, up5, wk, b6, bn_scale6, bn_shift6, act, bper):
    """The tensor-core head's up6 in torch: 18 k16 steps, step 9 src +
    shift taking source src (skip1, then up5; zeros outside the image)
    shifted by (dh, dw) as A and the step's (8, 16) slice of wk as B,
    summed in float32 into 8 columns, of which column 2 dp + dq is output
    parity (dp, dq); then the epilogue, activation before batch norm. Image
    n uses stem n // bper's weights. -> (S, B, 1, 2H, 2W) float32."""
    n_img, h, w, _ = skip1.shape
    stem = torch.arange(n_img) // bper
    acc = torch.zeros((n_img, h, w, 8))
    for src, x in enumerate((skip1, up5)):
        x = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
        for sh in range(9):
            dh, dw = sh // 3 - 1, sh % 3 - 1
            a = x[:, 1 + dh : 1 + dh + h, 1 + dw : 1 + dw + w]
            acc += torch.einsum("nhwk,nck->nhwc", a, wk[stem, 9 * src + sh].float())
    vec = lambda v: v[stem][:, :, None, None]
    z = acc[..., :4].reshape(n_img, h, w, 2, 2).permute(0, 1, 3, 2, 4)
    z = z.reshape(n_img, 1, 2 * h, 2 * w)
    y = vec(bn_scale6) * model.activation(z + vec(b6), act) + vec(bn_shift6)
    return y.reshape(-1, bper, 1, 2 * h, 2 * w)


@pytest.mark.parametrize("act", ["elu", "relu"])
def test_head_gemm_matches_up6_plain(rng, act):
    """The emulated 18-step GEMM over the (S, 18, 8, 16) layout equals
    up6_plain in float32 on bf16-rounded operands, to 1e-5 of max|plain|:
    two stems over B = 2 images of 7 x 9 (odd H and W)."""
    w6, b6, s6, h6 = _stack([_rand_layer(rng, 32, 1) for _ in range(2)])
    skip1, up5 = (_t(rng.standard_normal((4, 7, 9, 16)).astype(np.float32))
                  .to(torch.bfloat16).float() for _ in range(2))
    wk = tail._head_weights(w6, torch.bfloat16)
    got = _head_gemm(skip1, up5, wk, b6, s6, h6, act, bper=2)
    ref = tail.up6_plain(skip1, up5, w6.to(torch.bfloat16).float(), b6, s6, h6,
                         act=act)
    assert got.shape == ref.shape == (2, 2, 1, 14, 18)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
