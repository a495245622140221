"""K10 (kernels/mask_head.py) and the round-3 U-Net route of core/model.py
against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode: mask_head_pallas
directly, and for the whole U-Net the round-3 route of its core/model.py
(encoder3_pallas, XLA enc4..up5, mask_head_pallas), switched on with
FORCE_PALLAS_HEAD / FORCE_PALLAS_ENCODER where its backend check would
skip the kernels. The port's wrappers take their plain versions for CPU
tensors. Tolerances are the JAX package's own for K10
(tests/test_mask_head.py): atol 2e-6 / rtol 1e-5 for one stem, 3e-5 / 1e-4
with stems folded into the batch and for the U-Net end to end.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import spleeterrt_tpu.kernels.mask_head as jmh
from spleeterrt_tpu.config import STEM_MODE_2, STEM_MODE_4
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.core import model, weights
from spleeterrt_tpu_torch.kernels import mask_head

torch.set_num_threads(2)

# A trunk that is not the standard one: down4..up3 narrower, the shallow
# ends (down1..down3, up4..up7) standard. (Cin, Cout) per layer; up2 and up3
# take the skip concat.
NARROW_TRUNK = {"down4": (64, 96), "down5": (96, 192), "down6": (192, 384),
                "up1": (384, 192), "up2": (384, 96), "up3": (192, 64)}


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    jmh.mask_head_pallas.clear_cache()
    yield
    jmh.mask_head_pallas.clear_cache()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _head_params(rng, n_stems):
    """Per-stem head params in the JAX layout, stacked: w6 (S, 5, 5, 32, 1),
    b6, bn_scale6, bn_shift6 (S, 1), w7 (S, 4, 4, 1, 2), b7 (S, 2)."""
    f32 = lambda a: a.astype(np.float32)
    return (
        f32(rng.standard_normal((n_stems, 5, 5, 32, 1)) * 0.2),
        f32(rng.standard_normal((n_stems, 1))),
        f32(rng.standard_normal((n_stems, 1))),
        f32(rng.standard_normal((n_stems, 1))),
        f32(rng.standard_normal((n_stems, 4, 4, 1, 2)) * 0.5),
        f32(rng.standard_normal((n_stems, 2))),
    )


def _port_head_params(ps):
    """The JAX layout -> the port's: w6 (S, 32, 1, 5, 5), w7 (S, 2, 1, 4,
    4), as params_from_jax converts up6 and up7."""
    w6, b6, s6, h6, w7, b7 = ps
    return (_t(w6.transpose(0, 3, 4, 1, 2)), _t(b6), _t(s6), _t(h6),
            _t(w7.transpose(0, 4, 3, 1, 2)), _t(b7))


def _check_head(rng, shape, n_stems, act, atol, rtol):
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    ps = _head_params(rng, n_stems)
    ref = np.asarray(jmh.mask_head_pallas(
        jnp.asarray(x), *map(jnp.asarray, ps), act=act, n_stems=n_stems))
    kernels.reset_launch_counts()
    got = mask_head.mask_head(_t(x), *_port_head_params(ps), act=act)
    assert not any(kernels.launch_counts().values())
    sb, t2, f2, _ = shape
    assert got.shape == ref.shape == (sb, 2, 2 * t2, 2 * f2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("act", ["elu", "relu"])
def test_mask_head_matches_jax(rng, act):
    _check_head(rng, (2, 32, 64, 32), 1, act, 2e-6, 1e-5)


def test_mask_head_several_row_tiles(rng):
    _check_head(rng, (1, 3 * jmh.TT, 32, 32), 1, "elu", 2e-6, 1e-5)


def test_mask_head_several_frequency_chunks(rng, monkeypatch):
    monkeypatch.setattr(jmh, "MAX_NQC", 8)  # 16 quads -> 2 chunks
    _check_head(rng, (1, jmh.TT, 64, 32), 1, "relu", 2e-6, 1e-5)


def test_mask_head_folded_stems(rng):
    """Images [s*B, (s+1)*B) take stem s's weights."""
    _check_head(rng, (3 * 2, jmh.TT, 32, 32), 3, "elu", 3e-5, 1e-4)


def test_mask_head_is_the_head_on_two_halves(rng):
    """K10's plain version and bound are K6's on x's two 16-channel halves,
    and x is passed whole (no copy) to the wrapper."""
    x = _t(rng.standard_normal((4, 32, 32, 32)).astype(np.float32))
    ps = _port_head_params(_head_params(rng, 2))
    got = mask_head.mask_head(x, *ps, act="relu")
    from spleeterrt_tpu_torch.kernels import tail

    ref = tail.head(x[..., :16].contiguous(), x[..., 16:].contiguous(), *ps,
                    act="relu")
    assert torch.equal(got, ref.flatten(0, 1))
    bound = mask_head.mask_head_error_bound(x.to(torch.bfloat16), *ps, act="relu")
    assert bound.shape == got.shape and torch.all(bound > 0)


def test_mask_head_rejects_bad_inputs(rng):
    ps = _port_head_params(_head_params(rng, 2))
    x = torch.rand(4, 32, 32, 32)
    with pytest.raises(ValueError, match="32 channels"):
        mask_head.mask_head(torch.rand(4, 32, 32, 16), *ps, act="elu")
    with pytest.raises(ValueError, match="act"):
        mask_head.mask_head(x, *ps, act="leaky")
    with pytest.raises(ValueError, match="not a multiple of 2 stems"):
        mask_head.mask_head(torch.rand(3, 32, 32, 32), *ps, act="elu")
    with pytest.raises(ValueError, match="contiguous"):
        mask_head.mask_head(x.transpose(1, 2), *ps, act="elu")
    with pytest.raises(ValueError, match="x"):
        mask_head.mask_head(x.half(), *ps, act="elu")


# ---------------------------------------------------------------------------
# The round-3 route end to end
# ---------------------------------------------------------------------------


def _random_net(rng, seed, narrow=False):
    """One net in the JAX layout (numpy leaves) with random biases and batch
    norms; with `narrow`, the NARROW_TRUNK ladder in place of the standard
    deep trunk."""
    p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    if narrow:
        for name, (cin, cout) in NARROW_TRUNK.items():
            w = rng.standard_normal((5, 5, cin, cout)) * np.sqrt(2.0 / (25 * cin))
            p[name] = {"w": w.astype(np.float32),
                       "b": np.zeros(cout, np.float32)}
            if name != "down6":
                p[name]["bn_scale"] = np.ones(cout, np.float32)
                p[name]["bn_shift"] = np.zeros(cout, np.float32)
    for ly in p.values():
        c = ly["b"].shape[0]
        ly["b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        if "bn_scale" in ly:
            ly["bn_scale"] = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
            ly["bn_shift"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return p


def _jax_round3(fn, packed_off: bool):
    """fn() with the JAX package on its round-3 route (head and encoder
    kernels forced on, and with `packed_off` the packed U-Net off)."""
    try:
        jmodel.FORCE_PALLAS_HEAD = True
        jmodel.FORCE_PALLAS_ENCODER = True
        jmodel.FORCE_PACKED_UNET = False if packed_off else None
        jmodel.unet_forward.clear_cache()
        return fn()
    finally:
        jmodel.FORCE_PALLAS_HEAD = None
        jmodel.FORCE_PALLAS_ENCODER = None
        jmodel.FORCE_PACKED_UNET = None
        jmodel.unet_forward.clear_cache()


@pytest.fixture
def count_pallas_head(monkeypatch):
    """The list of the port's pallas_head calls, by stem count."""
    calls = []
    real = model.pallas_head
    monkeypatch.setattr(model, "pallas_head", lambda stacked, x, mode: (
        calls.append(model.num_stems(stacked)) or real(stacked, x, mode)))
    return calls


def _gates(stacked, mag_nchw):
    return (model.use_packed_unet(stacked, mag_nchw, "exact"),
            model.use_pallas_head(stacked, mag_nchw, "exact"),
            model.use_pallas_encoder(stacked, mag_nchw))


@pytest.mark.parametrize("narrow", [False, True], ids=["standard", "narrow"])
@pytest.mark.parametrize("stem_mode", [STEM_MODE_4, STEM_MODE_2])
def test_unet_forward_round3_matches_jax(rng, monkeypatch, count_pallas_head,
                                         narrow, stem_mode):
    """One net: the standard net with FORCE_PACKED_UNET = False on both
    sides, or the narrow-trunk net with no switch in the port."""
    jp = _random_net(rng, 3, narrow)
    params = weights.params_from_jax(jp)
    mag = (np.abs(rng.standard_normal((2, 64, 128, 2))) * 3.0).astype(np.float32)
    if not narrow:
        monkeypatch.setattr(model, "FORCE_PACKED_UNET", False)
    assert _gates(model.with_stem_axis(params), _t(mag.transpose(0, 3, 1, 2))) == (
        False, True, True)
    ref = _jax_round3(lambda: np.asarray(jmodel.unet_forward(
        jp, jnp.asarray(mag), stem_mode, jnp.float32)), packed_off=not narrow)
    kernels.reset_launch_counts()
    got = model.unet_forward(params, _t(mag), stem_mode, torch.float32)
    assert count_pallas_head == [1]
    assert not any(kernels.launch_counts().values())
    assert got.shape == ref.shape == mag.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("narrow", [False, True], ids=["standard", "narrow"])
def test_multi_stem_forward_round3_matches_jax(rng, monkeypatch,
                                               count_pallas_head, narrow):
    """Three stems folded into K10's batch."""
    jps = [_random_net(rng, i, narrow) for i in range(3)]
    stacked = weights.stack_params([weights.params_from_jax(p) for p in jps])
    mag = (np.abs(rng.standard_normal((2, 64, 128, 2))) * 3.0).astype(np.float32)
    if not narrow:
        monkeypatch.setattr(model, "FORCE_PACKED_UNET", False)
    assert _gates(stacked, _t(mag.transpose(0, 3, 1, 2))) == (False, True, True)
    ref = _jax_round3(lambda: np.asarray(jmodel.multi_stem_forward(
        jweights.stack_params(jps), jnp.asarray(mag), STEM_MODE_4,
        jnp.float32)), packed_off=not narrow)
    got = model.multi_stem_forward(stacked, _t(mag), STEM_MODE_4, torch.float32)
    assert count_pallas_head == [3]
    assert got.shape == ref.shape == (3, *mag.shape)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-5, rtol=1e-4)


def test_round3_gates_follow_the_reference(monkeypatch):
    """The batch limit of 64 stem * tile images, the switches, the shape
    conditions, and the canonical head under a round-3 encoder."""
    gen = torch.Generator().manual_seed(0)
    one = model.with_stem_axis(model.init_params(gen))
    meta = lambda b, t=64, f=128: torch.empty((b, 2, t, f), device="meta")
    assert model.use_pallas_head(one, meta(64), "exact")
    assert not model.use_pallas_head(one, meta(65), "exact")
    assert not model.use_pallas_head(one, meta(1), "lut")
    assert not model.use_pallas_head(one, meta(1, 32, 128), "exact")  # T/2 = 16
    assert not model.use_pallas_head(one, meta(1, 64, 80), "exact")  # F/2 = 40
    assert model.use_pallas_encoder(one, meta(64))
    assert not model.use_pallas_encoder(one, meta(65))
    assert not model.use_pallas_encoder(one, meta(1, 64, 80))  # F % 32
    monkeypatch.setattr(model, "FORCE_PALLAS_HEAD", True)
    monkeypatch.setattr(model, "FORCE_PALLAS_ENCODER", False)
    assert model.use_pallas_head(one, meta(204), "exact")
    assert not model.use_pallas_head(one, meta(1, 32, 128), "exact")
    assert not model.use_pallas_encoder(one, meta(1))
    monkeypatch.setattr(model, "FORCE_PACKED_UNET", False)
    assert not model.use_packed_unet(one, meta(1), "exact")

    # Encoder gate on, head gate off: round-3 trunk, canonical head.
    monkeypatch.setattr(model, "FORCE_PALLAS_HEAD", False)
    monkeypatch.setattr(model, "FORCE_PALLAS_ENCODER", None)
    mag = torch.rand((1, 2, 64, 128), generator=gen) * 3
    got = model.multi_stem_masks(one, mag)
    ref = model.unet_forward_nchw(model.stem_params(one, 0), mag)
    assert got.shape == (1, *ref.shape)
    assert (got[0] - ref).abs().max().item() <= 1e-5
