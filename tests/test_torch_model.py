"""spleeterrt_tpu_torch.core.model / weights against the JAX package.

The U-Net runs in fp32 on the CPU on both sides, with the JAX package's
Pallas paths off (pallas_head=False, pallas_encoder=False), so both run
plain convolutions; masks agree to 1e-4 (sums of up to 12,800 products
taken in different orders through twelve layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spleeterrt_tpu.config import STEM_MODE_2, STEM_MODE_4
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu_torch.core import model, weights

torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _conv_w(w_hwio):
    """HWIO -> OIHW, the conversion params_from_jax applies to convs."""
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def test_conv_same_matches(rng):
    x, w = _rand(rng, 2, 16, 32, 8), _rand(rng, 5, 5, 8, 12)
    got = _nhwc(model.conv_same(_nchw(x), _conv_w(w)))
    ref = np.asarray(jmodel._conv_same(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_tconv_same_matches(rng):
    x, w = _rand(rng, 2, 8, 16, 12), _rand(rng, 5, 5, 12, 6)
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 3, 0, 1)))
    got = _nhwc(model.tconv_same(_nchw(x), w_t))
    ref = np.asarray(jmodel._tconv_same(jnp.asarray(x), jnp.asarray(w)))
    assert got.shape == ref.shape == (2, 16, 32, 6)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_conv_dilated_final_matches(rng):
    x, w = _rand(rng, 2, 16, 32, 1), _rand(rng, 4, 4, 1, 2)
    got = _nhwc(model.conv_dilated_final(_nchw(x), _conv_w(w)))
    ref = np.asarray(jmodel._conv_dilated_final(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_elu_clamp_and_lut_sigmoid_match():
    x = np.concatenate([
        np.linspace(-30.0, 30.0, 20001, dtype=np.float32),
        np.array([-15.0, -15.0001, -14.9999, 0.0, -0.0, 7.0, -7.0, 100.0],
                 np.float32),
    ])
    got = model.elu(torch.from_numpy(x)).numpy()
    ref = np.asarray(jmodel._elu(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert np.all(got[x < -15.0] == -1.0)
    got = model.fast_sigmoid(torch.from_numpy(x)).numpy()
    ref = np.asarray(jmodel.fast_sigmoid(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _jax_params(seed):
    return jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))


def test_params_from_jax_layouts():
    jp = _jax_params(0)
    tp = weights.params_from_jax(jp)
    assert set(tp) == set(jp)
    assert tp["down1"]["w"].shape == (16, 2, 5, 5)  # OIHW
    assert tp["up1"]["w"].shape == (512, 256, 5, 5)  # (Cin, Cout, kh, kw)
    assert tp["up7"]["w"].shape == (2, 1, 4, 4)
    np.testing.assert_array_equal(
        tp["down3"]["w"][7, 5, 1, 3].numpy(), jp["down3"]["w"][1, 3, 5, 7]
    )
    np.testing.assert_array_equal(
        tp["up2"]["w"][9, 4, 2, 0].numpy(), jp["up2"]["w"][2, 0, 9, 4]
    )
    np.testing.assert_array_equal(tp["up3"]["bn_scale"].numpy(), jp["up3"]["bn_scale"])


def test_blob_decodes_like_jax(rng):
    blob = weights.random_blob(rng)
    got = weights.blob_to_params(blob)
    ref = weights.params_from_jax(
        jax.tree.map(np.asarray, jweights.blob_to_params(blob))
    )
    assert set(got) == set(ref)
    for ln in ref:
        assert set(got[ln]) == set(ref[ln])
        for fn in ref[ln]:
            np.testing.assert_array_equal(got[ln][fn].numpy(), ref[ln][fn].numpy())


@pytest.mark.parametrize("stem_mode", [STEM_MODE_4, STEM_MODE_2])
def test_unet_forward_matches(rng, stem_mode):
    jp = _jax_params(1)
    mag = np.abs(_rand(rng, 2, 64, 128, 2)) * 3.0
    got = model.unet_forward(
        weights.params_from_jax(jp), torch.from_numpy(mag), stem_mode
    ).numpy()
    ref = np.asarray(jmodel.unet_forward(
        jp, jnp.asarray(mag), stem_mode, jnp.float32, "exact", False, False,
    ))
    assert got.shape == ref.shape == mag.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("sigmoid", ["exact", "lut"])
def test_multi_stem_forward_matches(rng, sigmoid):
    jps = [_jax_params(i) for i in range(4)]
    mag = np.abs(_rand(rng, 2, 64, 128, 2)) * 3.0
    stacked = weights.stack_params([weights.params_from_jax(p) for p in jps])
    got = model.multi_stem_forward(
        stacked, torch.from_numpy(mag), STEM_MODE_4, torch.float32, sigmoid
    ).numpy()
    ref = np.asarray(jmodel.multi_stem_forward(
        jweights.stack_params(jps), jnp.asarray(mag), STEM_MODE_4,
        jnp.float32, sigmoid, pallas_head=False, pallas_encoder=False,
    ))
    assert got.shape == ref.shape == (4, *mag.shape)
    np.testing.assert_allclose(got, ref, atol=1e-4)
