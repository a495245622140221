"""The batched offline graphs of spleeterrt_tpu_torch (`separate_nstem_batch`,
`separate_2stem_batch`, `separate_3stem_batch`) and the track-major tile
layout of K1 and K7 they ride on, against the JAX package on the CPU.

The JAX side runs its fused batch graphs (SPLEETERRT_FUSED_STFT=1, Pallas
in interpret mode) at hop 1024, and its per-track vmap at hop 2048; the
port's wrappers take their plain versions for CPU tensors. B = 3 tracks of
different content, so a swap of tracks and channels in the fold shows.
Stems agree with JAX to 2e-4, the bound the JAX package holds its own
batch graphs to (tests/test_stft_fused.py), and with each track's own
single-track run of the port to 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spleeterrt_tpu.config import SeparatorConfig as JSeparatorConfig
from spleeterrt_tpu.config import TransformConfig as JTransformConfig
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import separate as jseparate
from spleeterrt_tpu.core import transform as jtransform
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu.kernels import stft_fused as jstft_fused
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.config import SeparatorConfig, TransformConfig
from spleeterrt_tpu_torch.core import model, separate, transform, weights
from spleeterrt_tpu_torch.kernels import stft_fused

torch.set_num_threads(2)

B = 3


@pytest.fixture
def fused_jax(monkeypatch):
    """The JAX package's fused batch graphs on the CPU."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    monkeypatch.setenv("SPLEETERRT_FUSED_STFT", "1")
    caches = (jseparate.separate_2stem, jseparate.separate_3stem,
              jseparate.separate_nstem, jseparate.separate_nstem_batch,
              jseparate.separate_2stem_batch, jseparate.separate_3stem_batch,
              jstft_fused.stft4096_packed, jstft_fused.masked_istft4096_cd)
    for f in caches:
        f.clear_cache()
    yield
    for f in caches:
        f.clear_cache()


def _jax_net(rng, seed):
    """init_params with random biases and batch norms, numpy leaves."""
    p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    for ly in p.values():
        c = ly["b"].shape[0]
        ly["b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        if "bn_scale" in ly:
            ly["bn_scale"] = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
            ly["bn_shift"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return p


def _cfgs(n_stems, overlap):
    kw = dict(bin_limit=512, time_step=64, num_stems=n_stems)
    return (JSeparatorConfig(transform=JTransformConfig(overlap=overlap),
                             compute_dtype=jnp.float32, **kw),
            SeparatorConfig(transform=TransformConfig(overlap=overlap),
                            compute_dtype=torch.float32, **kw))


def _tracks(rng, cfg):
    """B pre-padded tracks of different content: (B, 2, data_size) numpy,
    each a different length before the pad to a common one."""
    n = 11000
    x = np.zeros((B, 2, n), np.float32)
    for i, m in enumerate((9000, 11000, 10000)):
        x[i, :, :m] = rng.standard_normal((2, m)) * (0.2 + 0.1 * i)
    x[1, 1] *= 0.5  # channels differ too
    return transform.pad_offline(torch.from_numpy(x), cfg.transform).contiguous()


def _check(got, ref, single):
    """got (B, S, 2, L) against JAX's batch to 2e-4 and each track's own
    single-track run to 1e-5."""
    assert got.shape == ref.shape == (B, *single[0].shape)
    assert np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
    for i in range(B):
        np.testing.assert_allclose(got[i].numpy(), single[i].numpy(), atol=1e-5)
    # Tracks of different content give different stems: no track was
    # written over another.
    assert not np.allclose(got[0].numpy(), got[1].numpy(), atol=1e-3)


def _run(fn):
    kernels.reset_launch_counts()
    out = fn()
    assert not any(kernels.launch_counts().values())  # plain versions only
    return out


@pytest.mark.parametrize("overlap", [4, 2], ids=["hop1024", "hop2048"])
@pytest.mark.parametrize("n_stems", [4, 5])
def test_nstem_batch_matches_jax(rng, fused_jax, n_stems, overlap):
    jcfg, cfg = _cfgs(n_stems, overlap)
    jps = [_jax_net(rng, i) for i in range(n_stems)]
    stacked = weights.stack_params([weights.params_from_jax(p) for p in jps])
    out_band = separate.OUT_BAND_4 if n_stems == 4 else separate.OUT_BAND_5
    tracks = _tracks(rng, cfg)
    ref = np.asarray(jseparate.separate_nstem_batch(
        jweights.stack_params(jps), jnp.asarray(tracks.numpy()), jcfg, out_band))
    got = _run(lambda: separate.separate_nstem_batch(stacked, tracks, cfg, out_band))
    single = [separate.separate_nstem(stacked, a, cfg, out_band) for a in tracks]
    _check(got, ref, single)


@pytest.mark.parametrize("overlap", [4, 2], ids=["hop1024", "hop2048"])
def test_2stem_batch_matches_jax(rng, fused_jax, overlap):
    jcfg, cfg = _cfgs(2, overlap)
    jp = _jax_net(rng, 5)
    params = weights.params_from_jax(jp)
    tracks = _tracks(rng, cfg)
    ref = np.asarray(jseparate.separate_2stem_batch(
        jp, jnp.asarray(tracks.numpy()), jcfg))
    got = _run(lambda: separate.separate_2stem_batch(params, tracks, cfg))
    _check(got, ref, [separate.separate_2stem(params, a, cfg) for a in tracks])
    # accompaniment = padded track - vocals
    err = (got.sum(1)[..., : tracks.shape[-1]] - tracks).abs().max().item()
    assert err <= 1e-5


@pytest.mark.parametrize("overlap", [4, 2], ids=["hop1024", "hop2048"])
def test_3stem_batch_matches_jax(rng, fused_jax, overlap):
    """time_step 64: the reference package's fused 3-stem graph assumes a
    multiple of 32 (its core/separate.py:246)."""
    jcfg, cfg = _cfgs(3, overlap)
    jp4, jp2 = _jax_net(rng, 6), _jax_net(rng, 7)
    p4, p2 = weights.params_from_jax(jp4), weights.params_from_jax(jp2)
    tracks = _tracks(rng, cfg)
    ref = np.asarray(jseparate.separate_3stem_batch(
        jp4, jp2, jnp.asarray(tracks.numpy()), jcfg))
    got = _run(lambda: separate.separate_3stem_batch(p4, p2, tracks, cfg))
    _check(got, ref, [separate.separate_3stem(p4, p2, a, cfg) for a in tracks])


# ---------------------------------------------------------------------------
# K1 and K7 with `tracks`
# ---------------------------------------------------------------------------


def _k1_args(rng, tracks, n=30000, time_step=8, bin_limit=100):
    audio = torch.from_numpy(
        (rng.standard_normal((2 * tracks, n)) * 0.3).astype(np.float32))
    tcfg = TransformConfig()
    n_out = transform.num_output_frames(n, tcfg)
    n_req = -(-n_out // time_step) * time_step
    return (audio, transform.analysis_window(4096),
            transform.num_computed_frames(n, tcfg), n_req, bin_limit, time_step)


@pytest.mark.parametrize("tracks", [1, 2, 3, 5])
def test_k1_k7_plain_tracks_equal_per_track_calls(rng, tracks):
    """The plain versions with `tracks` give each track, bit for bit, what
    a call on that track alone gives; tracks = 1 is the single-track
    layout."""
    audio, win, n_comp, n_req, bl, t = _k1_args(rng, tracks)
    nt = n_req // t
    spec, mag = stft_fused.stft4096(audio, win, n_comp, n_req, bl, t, tracks)
    assert mag.shape == (tracks * nt, 2, t, bl) and mag.is_contiguous()
    masks = torch.from_numpy(rng.uniform(0, 1, (3, tracks * nt, 2, t, bl))
                             .astype(np.float32))
    ob = torch.tensor([0.25, 0.0, 0.5])
    swin = transform.synthesis_window(TransformConfig())
    out = stft_fused.masked_istft4096(spec, masks, ob, swin, n_comp, tracks)
    for i in range(tracks):
        rows, images = slice(2 * i, 2 * i + 2), slice(i * nt, (i + 1) * nt)
        spec1, mag1 = stft_fused.stft4096(audio[rows].contiguous(), win, n_comp,
                                          n_req, bl, t)
        assert torch.equal(spec[rows], spec1) and torch.equal(mag[images], mag1)
        out1 = stft_fused.masked_istft4096(spec1, masks[:, images].contiguous(),
                                           ob, swin, n_comp)
        assert torch.equal(out[:, rows], out1)


def test_kernel_index_maps_match_plain_layout(rng):
    """The store index of csrc/stft.cu and the mask index of csrc/istft.cu,
    written out in numpy, address the elements the plain versions' layout
    puts there: row r = track * c + ch and frame f land in image track *
    n_tiles + f // T, channel ch, row f % T."""
    tracks, c, t, nt, f = 3, 2, 4, 5, 7
    rows, n_req = tracks * c, nt * t
    spec = torch.arange(rows * n_req * f, dtype=torch.float32).reshape(rows, n_req, f)
    # stft4096_plain's tiling of |spec| (the values are their own index).
    plain = (spec.reshape(tracks, c, nt, t, f).transpose(1, 2)
             .reshape(tracks * nt, c, t, f).flatten())
    r, fr, k = np.meshgrid(np.arange(rows), np.arange(n_req), np.arange(f),
                           indexing="ij")
    image = (r // c) * (n_req // t) + fr // t  # stft.cu: mrow
    k1 = ((image * c + r % c) * t + fr % t) * f + k
    kernel = np.empty(plain.numel(), np.float32)
    kernel[k1.ravel()] = spec.numpy().ravel()
    np.testing.assert_array_equal(kernel, plain.numpy())
    # istft.cu's mask_row for stem s reads what masked_bins reads.
    s_n = 2
    masks = torch.arange(s_n * tracks * nt * c * t * f, dtype=torch.float32
                         ).reshape(s_n, tracks * nt, c, t, f)
    x = torch.ones((rows, n_req, 2049), dtype=torch.complex64)
    got = stft_fused.masked_bins(x, masks, torch.zeros(s_n), n_req, tracks)
    s, r, fr, k = np.meshgrid(np.arange(s_n), np.arange(rows), np.arange(n_req),
                              np.arange(f), indexing="ij")
    image0 = (s * (rows // c) + r // c) * nt
    k7 = (((image0 + fr // t) * c + r % c) * t + fr % t) * f + k
    np.testing.assert_array_equal(masks.numpy().ravel()[k7],
                                  got[..., :f].real.numpy())


def test_tracks_must_divide_rows(rng):
    audio, win, n_comp, n_req, bl, t = _k1_args(rng, 3)
    with pytest.raises(ValueError, match="tracks"):
        stft_fused.stft4096(audio, win, n_comp, n_req, bl, t, 4)
    spec, _ = stft_fused.stft4096(audio, win, n_comp, n_req, bl, t, 3)
    masks = torch.zeros((1, 3 * (n_req // t), 2, t, bl))
    with pytest.raises(ValueError, match="tracks"):
        stft_fused.masked_istft4096(spec, masks, torch.zeros(1), win, n_comp, 2)


def test_batch_routing_counts_images():
    """The round-3 gates count stem * track * tile images: a batch can
    leave the round-3 route where each of its tracks alone takes it."""
    gen = torch.Generator().manual_seed(0)
    stacked = weights.stack_params([model.init_params(gen) for _ in range(5)])
    one_track = torch.zeros((4, 2, 64, 512))  # 4 tiles: 20 images
    batch = torch.zeros((3 * 4 + 1, 2, 64, 512))  # 13 tiles: 65 images
    assert model.use_pallas_head(stacked, one_track, "exact")
    assert model.use_pallas_encoder(stacked, one_track)
    assert not model.use_pallas_head(stacked, batch, "exact")
    assert not model.use_pallas_encoder(stacked, batch)
    assert model.use_packed_unet(stacked, batch, "exact")  # the default route
