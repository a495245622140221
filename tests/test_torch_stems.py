"""The 2-, 3- and 5-stem graphs of spleeterrt_tpu_torch, the weight codecs
they need and the CLI's --stems 2/3/5, against the JAX package on the CPU.

The JAX side runs its fused-STFT graphs (SPLEETERRT_FUSED_STFT=1, Pallas in
interpret mode) or, at hop 2048, its canonical graphs; the port's wrappers
take their plain versions for CPU tensors. Stems agree to 2e-4, the bound
the JAX package holds its own fused graphs to (tests/test_stft_fused.py);
the 2-stem graph also keeps vocals + accompaniment equal to the input to
1e-5. The weight codecs agree bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spleeterrt_tpu import cli as jcli
from spleeterrt_tpu.config import SeparatorConfig as JSeparatorConfig
from spleeterrt_tpu.config import TransformConfig as JTransformConfig
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import separate as jseparate
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu.kernels import stft_fused as jstft_fused
from spleeterrt_tpu_torch import cli, kernels
from spleeterrt_tpu_torch.config import SeparatorConfig, TransformConfig
from spleeterrt_tpu_torch.core import separate, weights
from spleeterrt_tpu_torch.io import audio

torch.set_num_threads(2)

NARROW_TRUNK = {"down4": (64, 96), "down5": (96, 192), "down6": (192, 384),
                "up1": (384, 192), "up2": (384, 96), "up3": (192, 64)}


@pytest.fixture
def fused_jax(monkeypatch):
    """The JAX package's fused graphs on the CPU."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    monkeypatch.setenv("SPLEETERRT_FUSED_STFT", "1")
    caches = (jseparate.separate_2stem, jseparate.separate_3stem,
              jseparate.separate_nstem, jstft_fused.stft4096_packed,
              jstft_fused.masked_istft4096_cd)
    for f in caches:
        f.clear_cache()
    yield
    for f in caches:
        f.clear_cache()


def _jax_net(rng, seed, narrow=False):
    """One net in the JAX layout (numpy leaves): init_params with random
    biases and batch norms, and with `narrow` the NARROW_TRUNK ladder in
    place of the standard deep trunk."""
    p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    if narrow:
        for name, (cin, cout) in NARROW_TRUNK.items():
            w = rng.standard_normal((5, 5, cin, cout)) * np.sqrt(2.0 / (25 * cin))
            p[name] = {"w": w.astype(np.float32), "b": np.zeros(cout, np.float32)}
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


def _nets(rng, n_stems):
    """(JAX kwargs, port kwargs) of separate.separate for n_stems."""
    jps = [_jax_net(rng, i) for i in range(n_stems if n_stems > 3 else 2)]
    tps = [weights.params_from_jax(p) for p in jps]
    if n_stems == 2:
        return {"params": jps[0]}, {"params": tps[0]}
    if n_stems == 3:
        return ({"params4": jps[0], "params2": jps[1]},
                {"params4": tps[0], "params2": tps[1]})
    return ({"stacked_params": jweights.stack_params(jps)},
            {"stacked_params": weights.stack_params(tps)})


def _cfgs(n_stems, overlap=4):
    kw = dict(bin_limit=512, time_step=64, num_stems=n_stems)
    return (JSeparatorConfig(transform=JTransformConfig(overlap=overlap),
                             compute_dtype=jnp.float32, **kw),
            SeparatorConfig(transform=TransformConfig(overlap=overlap),
                            compute_dtype=torch.float32, **kw))


def _check_separation(rng, n_stems, overlap, x):
    jcfg, cfg = _cfgs(n_stems, overlap)
    jnets, nets = _nets(rng, n_stems)
    ref = jseparate.separate(x, cfg=jcfg, **jnets)
    kernels.reset_launch_counts()
    got = separate.separate(x, cfg=cfg, device="cpu", **nets)
    assert not any(kernels.launch_counts().values())
    assert list(got) == list(ref) == list(cfg.stem_names)
    for name in ref:
        assert got[name].shape == x.shape
        assert np.abs(np.asarray(ref[name])).max() > 0.01
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=2e-4)
    if n_stems == 2:
        err = (got["vocals"] + got["accompaniment"] - torch.from_numpy(x)).abs()
        assert err.max().item() <= 1e-5


@pytest.mark.parametrize("n_stems", [2, 3, 5])
def test_separate_matches_jax_fused(rng, fused_jax, n_stems):
    """Over 2 tiles: K1, the packed U-Net (once per pass; S = 5 for 5
    stems) and K7 with S = 1, 3 and 5 masks, against JAX's fused graphs."""
    x = (rng.standard_normal((2, 3 * 4096 + 1234)) * 0.3).astype(np.float32)
    _check_separation(rng, n_stems, 4, x)


@pytest.mark.parametrize("n_stems", [2, 3])
def test_separate_overlap2_matches_jax(rng, n_stems):
    """TransformConfig(overlap=2), hop 2048: the canonical graphs, whose
    inverse FFTs go through transform.istft (K8's plain version)."""
    x = (rng.standard_normal((2, 3 * 4096 + 777)) * 0.3).astype(np.float32)
    _check_separation(rng, n_stems, 2, x)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def test_decode_fp16_daz_bit_exact(rng):
    """Every fp16 bit pattern, denormals and both zeros included."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    got = weights.decode_fp16_daz(bits)
    ref = np.asarray(jweights.decode_fp16_daz(bits))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    denormal = ((bits & 0x7C00) == 0) & ((bits & 0x3FF) != 0)
    assert np.all(got[denormal] == 0)
    assert np.all(np.signbit(got[bits >= 0x8000]))
    assert got.view(np.uint32)[0x8000] == 0x80000000  # -0.0 stays signed
    vals = rng.standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(weights.encode_fp16(vals),
                                  jweights.encode_fp16(vals))


def _quantized_file(rng) -> bytes:
    """The exe's two-subnet fp16 model from two seeded random blobs."""
    halves = [weights.encode_fp16(np.frombuffer(weights.random_blob(rng), "<f4"))
              for _ in range(2)]
    return np.concatenate(halves).astype("<u2").tobytes()


def _assert_same_params(got, ref_jax):
    ref = weights.params_from_jax(jax.tree.map(np.asarray, ref_jax))
    assert set(got) == set(ref)
    for ln in ref:
        assert set(got[ln]) == set(ref[ln])
        for fn in ref[ln]:
            np.testing.assert_array_equal(got[ln][fn].numpy(), ref[ln][fn].numpy())


def test_load_quantized_model_matches_jax(rng):
    data = _quantized_file(rng)
    got4, got2 = weights.load_quantized_model(data)
    ref4, ref2 = jweights.load_quantized_model(data)
    _assert_same_params(got4, ref4)
    _assert_same_params(got2, ref2)
    with pytest.raises(ValueError, match="halfwords"):
        weights.load_quantized_model(data[:-2])


def test_params_to_blob_round_trips_through_jax(rng, tmp_path):
    """The port's blob writer -> JAX's blob reader is exact, and so is the
    port's save_coeff_file -> its load_coeff_file."""
    params = weights.blob_to_params(weights.random_blob(rng))
    blob = weights.params_to_blob(params)
    assert len(blob) == weights.COEFF_BLOB_BYTES
    _assert_same_params(params, jweights.blob_to_params(blob))
    path = tmp_path / "net.dat"
    weights.save_coeff_file(params, path)
    assert path.read_bytes() == blob
    back = weights.load_coeff_file(path)
    for ln in params:
        for fn in params[ln]:
            assert torch.equal(back[ln][fn], params[ln][fn])


@pytest.mark.parametrize("narrow", [False, True], ids=["standard", "narrow"])
def test_save_npz_is_read_by_jax(rng, tmp_path, narrow):
    """The port's save_npz writes the reference's layout: JAX's load_npz
    reads the same arrays, and the port's load_npz reads its own file back."""
    jp = _jax_net(rng, 1, narrow)
    params = weights.params_from_jax(jp)
    path = tmp_path / "net.npz"
    weights.save_npz(params, path)
    ref = jweights.load_npz(path)
    assert set(ref) == set(jp)
    for ln in jp:
        assert set(ref[ln]) == set(jp[ln])
        for fn in jp[ln]:
            np.testing.assert_array_equal(np.asarray(ref[ln][fn]), jp[ln][fn])
    back = weights.load_npz(path)
    for ln in params:
        for fn in params[ln]:
            assert torch.equal(back[ln][fn], params[ln][fn])


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["2-std-npz", "3-quantized", "2-narrow-npz"])
def test_cli_matches_jax_cli(tmp_path, rng, case):
    """Both CLIs in fp32 on the same WAV and weight file: a standard npz
    and a narrow-trunk npz (the port's round-3 route) for 2 stems, the
    quantized two-subnet file for 3."""
    n_stems = int(case[0])
    if case == "3-quantized":
        wfile = tmp_path / "model.bin"
        wfile.write_bytes(_quantized_file(rng))
    else:
        wfile = tmp_path / "net.npz"
        weights.save_npz(weights.params_from_jax(
            _jax_net(rng, 2, narrow=case == "2-narrow-npz")), wfile)
    x = (rng.standard_normal((2, 9000)) * 0.3).astype(np.float32)
    song = tmp_path / "song.wav"
    audio.write_wav(song, x)
    common = [str(song), "--stems", str(n_stems), "--time-step", "64",
              "--bin-limit", "512", "--weights", str(wfile), "--fp32"]
    assert jcli.main(common + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["--output-dir", str(tmp_path / "torch"),
                              "--device", "cpu"]) == 0
    names = ("Vocal", "Accompaniment") + ("Drum",) * (n_stems == 3)
    for stem in names:
        got = audio.read_wav(tmp_path / "torch" / f"song_{stem}.wav")
        ref = audio.read_wav(tmp_path / "jax" / f"song_{stem}.wav")
        assert got.samples.shape == ref.samples.shape == x.shape
        assert np.all(np.isfinite(got.samples))
        np.testing.assert_allclose(got.samples, ref.samples, atol=2e-4)


def test_cli_weight_rules(tmp_path, rng):
    """The reference CLI's rules: a directory only for 4 stems, an npz only
    for 2, a quantized file only for 2 or 3; random nets for every count."""
    cfg = lambda n: SeparatorConfig(bin_limit=512, time_step=64, num_stems=n)
    npz = tmp_path / "net.npz"
    weights.save_npz(weights.params_from_jax(_jax_net(rng, 0)), npz)
    with pytest.raises(SystemExit, match="4-stem"):
        cli.load_weights(str(tmp_path), False, 0, cfg(2), "cpu")
    with pytest.raises(SystemExit, match="npz"):
        cli.load_weights(str(npz), False, 0, cfg(3), "cpu")
    with pytest.raises(SystemExit, match="2/3 stems"):
        cli.load_weights(str(tmp_path / "model.bin"), False, 0, cfg(5), "cpu")
    assert set(cli.load_weights(None, True, 0, cfg(2), "cpu")) == {"params"}
    assert set(cli.load_weights(None, True, 0, cfg(3), "cpu")) == {
        "params4", "params2"}
    five = cli.load_weights(None, True, 0, cfg(5), "cpu")["stacked_params"]
    assert five["up7"]["w"].shape == (5, 2, 1, 4, 4)
