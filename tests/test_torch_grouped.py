"""spleeterrt_tpu_torch.core.grouped and the stem-stacked stages of
core/model.py against the JAX package and the port's per-stem formulation.

Inputs from a numpy seed, fp32 on the CPU in both packages. Tolerances:

- a grouped layer against the same layer run stem by stem: 1e-6 (each
  output sums the same products; the grouped call may order them
  otherwise);
- whole nets and trunks against the JAX package: 1e-4, as
  tests/test_torch_model.py holds the canonical U-Net (sums of up to
  12,800 products in different orders through the layers);
- gradients of the separation loss, grouped route against the per-stem
  loop: each leaf within 1e-4 of its max |g|, the loss to rtol 1e-5, as
  tests/test_torch_train.py holds the port against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spleeterrt_tpu.core import grouped as jgrouped
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu_torch.config import STEM_MODE_2, STEM_MODE_4
from spleeterrt_tpu_torch.core import grouped, model, train, weights

torch.set_num_threads(2)

LAYER_ATOL = 1e-6
NET_ATOL = 1e-4
GRAD_REL = 1e-4
LOSS_RTOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_stacked(n_stems, seed=0):
    """JAX params of n_stems nets with random epilogues (non-zero biases,
    scales and shifts, so a misplaced channel of a vector shows), as
    numpy leaves."""
    rng = np.random.default_rng(seed + 100)
    nets = []
    for i in range(n_stems):
        p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed + i)))
        for ly in p.values():
            ly["b"] = 0.1 * _rand(rng, *ly["b"].shape)
            if "bn_scale" in ly:
                ly["bn_scale"] = 1.0 + 0.3 * _rand(rng, *ly["b"].shape)
                ly["bn_shift"] = 0.2 * _rand(rng, *ly["b"].shape)
        nets.append(p)
    return jax.tree.map(lambda *a: np.stack(a), *nets)


def _port_stacked(jstacked):
    n = jstacked["up7"]["w"].shape[0]
    return weights.stack_params([
        weights.params_from_jax(jax.tree.map(lambda a: a[s], jstacked))
        for s in range(n)
    ])


# --- the grouped layers against per-stem library calls ----------------------


def _per_stem(fn, x, w, s):
    """fn on each stem's channel slice of x with its weight slice, the
    outputs concatenated stem-major on the channel axis."""
    xs = x.chunk(s, dim=1)
    ws = w.chunk(s, dim=0)
    return torch.cat([fn(xi, wi) for xi, wi in zip(xs, ws)], dim=1)


@pytest.mark.parametrize("s", [1, 2, 4, 5])
@pytest.mark.parametrize("layer", ["conv_g", "tconv_g", "final_g"])
def test_grouped_layer_matches_per_stem_calls(rng, layer, s):
    """A stacked weight viewed by `gw` in one grouped call equals S
    separate library calls with each stem's weight."""
    ci, co = 6, 4
    x = _t(_rand(rng, 2, s * ci, 16, 24)).contiguous(
        memory_format=torch.channels_last)
    if layer == "conv_g":
        w = _t(_rand(rng, s, co, ci, 5, 5))
        ref = _per_stem(lambda xi, wi: F.conv2d(
            F.pad(xi, (1, 2, 1, 2)), wi, stride=2), x, grouped.gw(w), s)
        got = grouped.conv_g(x, grouped.gw(w), s)
    elif layer == "tconv_g":
        w = _t(_rand(rng, s, ci, co, 5, 5))
        ref = _per_stem(lambda xi, wi: F.conv_transpose2d(
            xi, wi, stride=2, padding=1)[..., :32, :48], x, grouped.gw(w), s)
        got = grouped.tconv_g(x, grouped.gw(w), s)
    else:
        w = _t(_rand(rng, s, co, ci, 4, 4))
        ref = _per_stem(lambda xi, wi: F.conv2d(xi, wi, padding=3, dilation=2),
                        x, grouped.gw(w), s)
        got = grouped.final_g(x, grouped.gw(w), s)
    assert grouped.gw(w).data_ptr() == w.data_ptr()  # a view, no copy
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=LAYER_ATOL)


@pytest.mark.parametrize("s", [1, 3])
def test_layout_moves_and_concat(rng, s):
    """to_grouped puts image s * B + b's channel c at channel s * C + c of
    image b, in channels_last memory; from_grouped undoes it; concat_g
    gives each stem [skip_s, y_s]."""
    b, h, w, c = 2, 4, 6, 5
    x = _t(_rand(rng, s * b, h, w, c))
    g = grouped.to_grouped(x, s)
    assert g.shape == (b, s * c, h, w)
    assert g.is_contiguous(memory_format=torch.channels_last)
    for si in range(s):
        np.testing.assert_array_equal(
            g[:, si * c:(si + 1) * c].permute(0, 2, 3, 1).numpy(),
            x[si * b:(si + 1) * b].numpy())
    back = grouped.from_grouped(g, s)
    assert back.is_contiguous()
    np.testing.assert_array_equal(back.numpy(), x.numpy())
    y = grouped.to_grouped(_t(_rand(rng, s * b, h, w, 3)), s)
    cat = grouped.concat_g(g, y, s)
    assert cat.is_contiguous(memory_format=torch.channels_last)
    for si in range(s):
        np.testing.assert_array_equal(
            cat[:, si * 8:(si + 1) * 8].numpy(),
            torch.cat([g[:, si * c:(si + 1) * c], y[:, si * 3:(si + 1) * 3]],
                      dim=1).numpy())


# --- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("sigmoid", ["exact", "lut"])
@pytest.mark.parametrize("stem_mode", [STEM_MODE_4, STEM_MODE_2])
def test_multi_stem_forward_grouped_matches_jax(rng, stem_mode, sigmoid):
    jstacked = _jax_stacked(3)
    mag = np.abs(_rand(rng, 2, 64, 128, 2)) * 3.0
    got = grouped.multi_stem_forward_grouped(
        _port_stacked(jstacked), _t(mag), stem_mode, torch.float32, sigmoid)
    ref = np.asarray(jgrouped.multi_stem_forward_grouped(
        jax.tree.map(jnp.asarray, jstacked), jnp.asarray(mag), stem_mode,
        jnp.float32, sigmoid))
    assert got.shape == ref.shape == (3, *mag.shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=NET_ATOL)


@pytest.mark.parametrize("stem_mode", [STEM_MODE_4, STEM_MODE_2])
def test_mid_trunk_matches_jax_vmap(rng, stem_mode):
    """model.mid_trunk (a loop over stems, which an H100 ran faster than
    the grouped form) against the reference's jax.vmap(_mid_trunk_xla) on
    the same enc4 outputs."""
    s, b, t16, f16 = 4, 2, 4, 8
    jstacked = _jax_stacked(s, seed=7)
    act4 = _rand(rng, s, b, t16, f16, 128)
    skip4 = _rand(rng, s, b, t16, f16, 128)
    got = model.mid_trunk(_port_stacked(jstacked),
                          _t(act4.reshape(s * b, t16, f16, 128)),
                          _t(skip4.reshape(s * b, t16, f16, 128)),
                          stem_mode, torch.float32)
    ref = np.asarray(jax.vmap(
        lambda p, a, k: jmodel._mid_trunk_xla(p, a, k, stem_mode, jnp.float32)
    )(jax.tree.map(jnp.asarray, jstacked), jnp.asarray(act4),
      jnp.asarray(skip4)))
    assert got.shape == (s * b, 2 * t16, 2 * f16, 64)
    np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape),
                               atol=NET_ATOL)


@pytest.mark.parametrize("stem_mode", [STEM_MODE_4, STEM_MODE_2])
def test_multi_stem_trunk_unet_branch_matches_jax(rng, stem_mode):
    """The branch of model.multi_stem_trunk without K2/K3 fronts (every
    layer grouped) against the reference's _multi_stem_trunk with
    pallas_encoder=False."""
    s = 2
    jstacked = _jax_stacked(s, seed=3)
    mag = np.abs(_rand(rng, 2, 64, 128, 2)) * 3.0
    got = model.multi_stem_trunk(
        _port_stacked(jstacked), _t(mag.transpose(0, 3, 1, 2)), stem_mode,
        torch.float32, pallas_encoder=False)
    ref = np.asarray(jmodel._multi_stem_trunk(
        jax.tree.map(jnp.asarray, jstacked), jnp.asarray(mag), stem_mode,
        jnp.float32, pallas_encoder=False))
    assert ref.shape == (s, 2, 32, 64, 32)
    np.testing.assert_allclose(got.numpy(), ref.reshape(got.shape),
                               atol=NET_ATOL)


# --- against the per-stem formulation ---------------------------------------


def _per_stem_masks(stacked, magnitude, stem_mode=STEM_MODE_4,
                    compute_dtype=torch.float32, sigmoid="exact"):
    return torch.stack([
        model.unet_forward_nchw(model.stem_params(stacked, s), magnitude,
                                stem_mode, compute_dtype, sigmoid)
        for s in range(model.num_stems(stacked))
    ])


@pytest.mark.parametrize("route", ["canonical", "round 3, canonical head"])
def test_grouped_routes_match_per_stem_nets(rng, route, monkeypatch):
    """The canonical route and the round-3 route with the canonical head
    (K2/K3 fronts by their plain versions here, the LUT sigmoid keeping
    K10 out) against each stem's unet_forward_nchw, 5 stems."""
    stacked = _port_stacked(_jax_stacked(5, seed=11))
    mag = _t(np.abs(_rand(rng, 2, 2, 64, 128)) * 3.0)
    if route == "canonical":
        got = model.multi_stem_masks_canonical(stacked, mag, STEM_MODE_4,
                                               torch.float32, "lut")
    else:
        monkeypatch.setattr(model, "FORCE_PACKED_UNET", False)
        assert model.use_pallas_encoder(stacked, mag)
        got = model.multi_stem_masks(stacked, mag, STEM_MODE_4, torch.float32,
                                     "lut")
    ref = _per_stem_masks(stacked, mag, sigmoid="lut")
    assert got.shape == ref.shape == (5, 2, 2, 64, 128) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=NET_ATOL)


def _loss_and_grads(stacked, mix, targets):
    params = train.trainable(stacked)
    loss = train.separation_loss(params, mix, targets, STEM_MODE_2,
                                 torch.float32)
    loss.backward()
    return loss.item(), {(ln, fn): v.grad for ln, ly in params.items()
                         for fn, v in ly.items()}


def test_separation_loss_gradients_match_per_stem_loop(rng, monkeypatch):
    """separation_loss's gradients through the grouped canonical route
    against the same loss through a per-stem loop of unet_forward_nchw, 2
    stems, fp32."""
    stacked = _port_stacked(_jax_stacked(2, seed=5))
    mix = _t(np.abs(_rand(rng, 2, 64, 128, 2)))
    targets = _t(np.abs(_rand(rng, 2, 2, 64, 128, 2)) * 0.5)
    loss, grads = _loss_and_grads(stacked, mix, targets)
    monkeypatch.setattr(model, "multi_stem_masks_canonical", _per_stem_masks)
    ref_loss, ref_grads = _loss_and_grads(stacked, mix, targets)
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    assert grads.keys() == ref_grads.keys()
    for key, g in grads.items():
        r = ref_grads[key]
        scale = r.abs().max().item()
        assert scale > 0, key
        err = (g - r).abs().max().item()
        assert err <= GRAD_REL * scale, (key, err, scale)


@pytest.mark.parametrize("stage,n_calls", [
    ("round-3 enc4..up5", 8), ("canonical", 13), ("mid trunk", 20)])
def test_library_convolutions_a_layer(stage, n_calls, monkeypatch):
    """At S = 4 the grouped round-3 enc4..up5 makes 8 library convolution
    calls (enc4..enc6, up1..up5), not 32, and the canonical route 13 (six
    encoder, six decoder, the final conv), not 52. The mid trunk keeps its
    loop over stems, 5 calls a stem: its grouped form made the 4-stem
    graph slower on an H100 (16.185 ms against 15.325 ms with the loop
    at 300 s; PERF.md §6). Every call reads
    channels_last activations."""
    s = 4
    stacked = _port_stacked(_jax_stacked(s))
    calls = []
    for name in ("conv2d", "conv_transpose2d"):
        real = getattr(F, name)

        def counted(x, *a, _real=real, **kw):
            calls.append(x.is_contiguous(memory_format=torch.channels_last))
            return _real(x, *a, **kw)

        monkeypatch.setattr(F, name, counted)
    gen = torch.Generator().manual_seed(0)
    img = lambda c, h, w: torch.randn((s * 2, h, w, c), generator=gen)
    if stage == "mid trunk":
        out = model.mid_trunk(stacked, img(128, 4, 8), img(128, 4, 8),
                              STEM_MODE_4, torch.float32)
        assert out.shape == (s * 2, 8, 16, 64)
    elif stage == "canonical":
        mag = torch.rand((2, 2, 64, 128), generator=gen)
        out = model.multi_stem_masks_canonical(stacked, mag)
        assert out.shape == (s, 2, 2, 64, 128)
    else:
        skips = [grouped.to_grouped(img(c, 64 // d, 128 // d), s)
                 for c, d in ((16, 2), (32, 4), (64, 8))]
        out = grouped.trunk_tail(stacked, grouped.to_grouped(img(64, 8, 16), s),
                                 skips, s, STEM_MODE_4, torch.float32)
        assert out.shape == (2, s * 32, 32, 64)
    assert len(calls) == n_calls
    assert all(calls)
