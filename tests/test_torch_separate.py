"""The 4-stem slice of spleeterrt_tpu_torch against the JAX package, on the
CPU: the separation graph, its helpers, the CLI end to end, and the rule
that the port never imports jax.

The JAX side runs its fused-STFT graph (SPLEETERRT_FUSED_STFT=1, Pallas in
interpret mode), the graph the port follows; the port's wrappers take
their plain versions for CPU tensors. Stems agree to 2e-4, the bound the
JAX package holds its own fused graph to (tests/test_stft_fused.py).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from spleeterrt_tpu import cli as jcli
from spleeterrt_tpu.config import STEM_MODE_4
from spleeterrt_tpu.config import SeparatorConfig as JSeparatorConfig
from spleeterrt_tpu.config import TransformConfig as JTransformConfig
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import separate as jseparate
from spleeterrt_tpu.core import transform as jtransform
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu.kernels import stft_fused as jstft_fused
from spleeterrt_tpu_torch import cli
from spleeterrt_tpu_torch.config import SeparatorConfig, TransformConfig
from spleeterrt_tpu_torch.core import separate, transform, weights
from spleeterrt_tpu_torch.io import audio
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.kernels import stft_fused

torch.set_num_threads(2)

CFG = SeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                      compute_dtype=torch.float32)
JCFG = JSeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                        compute_dtype=jnp.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fused_jax(monkeypatch):
    """The JAX package's fused 4-stem graph on the CPU."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    monkeypatch.setenv("SPLEETERRT_FUSED_STFT", "1")
    caches = (jseparate.separate_nstem, jstft_fused.stft4096_packed,
              jstft_fused.masked_istft4096_cd)
    for f in caches:
        f.clear_cache()
    yield
    for f in caches:
        f.clear_cache()


def _stacked(seeds):
    jps = [jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(i)))
           for i in seeds]
    return (
        jweights.stack_params(jps),
        weights.stack_params([weights.params_from_jax(p) for p in jps]),
    )


def test_separate_4stem_matches_jax_fused(rng, fused_jax):
    jstacked, stacked = _stacked(range(4))
    x = (rng.standard_normal((2, 3 * 4096)) * 0.3).astype(np.float32)
    ref = jseparate.separate(x, stacked_params=jstacked, cfg=JCFG)
    got = separate.separate(x, stacked_params=stacked, cfg=CFG, device="cpu")
    assert list(got) == list(ref) == ["drums", "bass", "accompaniment", "vocals"]
    for name in ref:
        assert got[name].shape == x.shape
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(ref[name]), atol=2e-4
        )


def test_graph_helpers_match_jax(rng):
    jstacked, stacked = _stacked(range(2))
    x = (rng.standard_normal((2, 20000)) * 0.3).astype(np.float32)
    spec_np = np.array(jtransform.stft(jnp.asarray(x), JCFG.transform, 20000))
    spec = torch.from_numpy(spec_np)
    scale = np.abs(spec_np).max()
    jspec = jnp.asarray(spec_np)

    tiles = separate.spec_to_tiles(spec, CFG)
    np.testing.assert_allclose(  # |z|: hypot rounds differently per library
        tiles.numpy(), np.asarray(jseparate.spec_to_tiles(jspec, JCFG)),
        atol=1e-6 * scale,
    )
    np.testing.assert_array_equal(
        separate.tiles_to_frames(tiles, spec.shape[-2]).numpy(),
        np.asarray(jseparate.tiles_to_frames(jnp.asarray(tiles.numpy()),
                                             spec.shape[-2])),
    )
    masks = separate.compute_masks_multi(stacked, spec, CFG, STEM_MODE_4)
    jmasks = jseparate.compute_masks_multi(
        jstacked, jspec, JCFG, STEM_MODE_4, pallas=False
    )
    assert masks.shape == jmasks.shape
    np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks), atol=1e-4)

    m = masks[0]
    np.testing.assert_allclose(
        separate.apply_mask(spec, m, CFG).numpy(),
        np.asarray(jseparate.apply_mask(jspec, jnp.asarray(m.numpy()), JCFG)),
        atol=1e-6 * scale,
    )


def test_separate_overlap2_matches_jax(rng):
    """TransformConfig(overlap=2), hop 2048: the graph's non-fused branch
    (plain STFT, U-Net, K9's plain version, overlap-add) against the JAX
    package's separate_nstem, whose CPU route is the same computation."""
    jstacked, stacked = _stacked(range(4))
    x = (rng.standard_normal((2, 3 * 4096 + 777)) * 0.3).astype(np.float32)
    cfg = SeparatorConfig(transform=TransformConfig(overlap=2), bin_limit=512,
                          time_step=64, num_stems=4, compute_dtype=torch.float32)
    jcfg = JSeparatorConfig(transform=JTransformConfig(overlap=2),
                            bin_limit=512, time_step=64, num_stems=4,
                            compute_dtype=jnp.float32)
    kernels.reset_launch_counts()
    got = separate.separate(x, stacked_params=stacked, cfg=cfg, device="cpu")
    assert not any(kernels.launch_counts().values())
    ref = jseparate.separate(x, stacked_params=jstacked, cfg=jcfg)
    assert list(got) == list(ref)
    for name in ref:
        assert got[name].shape == x.shape
        assert np.abs(np.asarray(ref[name])).max() > 0.01
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(ref[name]), atol=2e-4
        )


def _check_fft2048(rng, n_stems):
    """n_stems at FFT 2048 (hop 512) against the JAX package's separate."""
    jstacked, stacked = _stacked(range(n_stems))
    kw = dict(bin_limit=512, time_step=64, num_stems=n_stems)
    cfg = SeparatorConfig(transform=TransformConfig(fft_size=2048),
                          compute_dtype=torch.float32, **kw)
    jcfg = JSeparatorConfig(transform=JTransformConfig(fft_size=2048),
                            compute_dtype=jnp.float32, **kw)
    x = (rng.standard_normal((2, 5000)) * 0.3).astype(np.float32)
    kernels.reset_launch_counts()
    got = separate.separate(x, stacked_params=stacked, cfg=cfg, device="cpu")
    assert not any(kernels.launch_counts().values())
    ref = jseparate.separate(x, stacked_params=jstacked, cfg=jcfg)
    assert list(got) == list(ref) == list(cfg.stem_names)
    for name in ref:
        assert got[name].shape == x.shape
        assert np.abs(np.asarray(ref[name])).max() > 0.01
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   atol=2e-4)


def test_fft_sizes_other_than_4096_raise(rng):
    """(Named when this raised.) 4 stems at FFT 2048 run the reference's
    canonical branch, one transform.istft a stem, and match JAX's
    separate_nstem to 2e-4."""
    _check_fft2048(rng, 4)


def test_unported_stem_counts_raise(rng):
    """(Named when 4 and 5 stems raised at other FFT sizes.) No graph
    raises NotImplementedError for any stem count or transform any more:
    5 stems at FFT 2048 match JAX's separate_nstem to 2e-4."""
    assert not hasattr(separate, "check_ported")
    _check_fft2048(rng, 5)


def test_cli_matches_jax_cli(tmp_path, rng):
    """Four random VST blobs through both CLIs in fp32; the stems agree."""
    blobs = tmp_path / "weights"
    blobs.mkdir()
    for name in weights.VST_BLOB_FILENAMES.values():
        (blobs / name).write_bytes(weights.random_blob(rng))
    x = (rng.standard_normal((2, 9000)) * 0.3).astype(np.float32)
    song = tmp_path / "song.wav"
    audio.write_wav(song, x)
    common = [str(song), "--stems", "4", "--time-step", "64", "--bin-limit",
              "512", "--weights", str(blobs), "--fp32"]

    assert jcli.main(common + ["--output-dir", str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["--output-dir", str(tmp_path / "torch"),
                              "--device", "cpu",
                              "--profile", str(tmp_path / "prof")]) == 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    for stem in ("Drum", "Bass", "Accompaniment", "Vocal"):
        got = audio.read_wav(tmp_path / "torch" / f"song_{stem}.wav")
        ref = audio.read_wav(tmp_path / "jax" / f"song_{stem}.wav")
        assert got.sample_rate == ref.sample_rate == 44100
        assert got.samples.shape == ref.samples.shape == x.shape
        assert np.all(np.isfinite(got.samples))
        np.testing.assert_allclose(got.samples, ref.samples, atol=2e-4)


def test_cli_resamples_to_input_rate(tmp_path, rng):
    """A 32 kHz input is separated at 44.1 kHz and, with --output-rate
    input, written back at 32 kHz with its own length."""
    x = (rng.standard_normal((1, 16000)) * 0.3).astype(np.float32)
    song = tmp_path / "song.wav"
    audio.write_wav(song, x, 32000)
    assert cli.main([str(song), "--stems", "4", "--time-step", "64",
                     "--bin-limit", "512", "--random-weights", "--fp32",
                     "--device", "cpu", "--output-rate", "input",
                     "--output-dir", str(tmp_path)]) == 0
    for stem in ("Drum", "Bass", "Accompaniment", "Vocal"):
        y = audio.read_wav(tmp_path / f"song_{stem}.wav")
        assert y.sample_rate == 32000
        assert y.samples.shape[0] == 2  # mono input is separated as stereo
        assert abs(y.samples.shape[1] - 16000) <= 1
        assert np.all(np.isfinite(y.samples))


def test_cli_refuses_missing_cuda(tmp_path, rng, monkeypatch):
    """--device cuda without a card is an error, not a switch to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    song = tmp_path / "song.wav"
    audio.write_wav(song, np.zeros((2, 5000), np.float32))
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main([str(song), "--stems", "4", "--random-weights",
                  "--output-dir", str(tmp_path)])
    assert not list(tmp_path.glob("song_*.wav"))
    assert not any(kernels.launch_counts().values())


def test_package_never_imports_jax():
    code = (
        "import sys\n"
        "import spleeterrt_tpu_torch, spleeterrt_tpu_torch.cli\n"
        "import spleeterrt_tpu_torch.kernels.stft_fused\n"
        "import spleeterrt_tpu_torch.kernels.encoder\n"
        "import spleeterrt_tpu_torch.kernels.tail\n"
        "import spleeterrt_tpu_torch.kernels.pallas_fft\n"
        "import spleeterrt_tpu_torch.kernels.mask_head\n"
        "import spleeterrt_tpu_torch.runtime.stream, spleeterrt_tpu_torch.cli_stream\n"
        "import spleeterrt_tpu_torch.runtime.executor\n"
        "import spleeterrt_tpu_torch.runtime.server\n"
        "import spleeterrt_tpu_torch.io.resample, spleeterrt_tpu_torch.utils.metrics\n"
        "import spleeterrt_tpu_torch.io.mpg123, spleeterrt_tpu_torch.io.mp3_fixtures\n"
        "import spleeterrt_tpu_torch.native, spleeterrt_tpu_torch.utils.timing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'spleeterrt_tpu' or m.startswith('spleeterrt_tpu.')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
