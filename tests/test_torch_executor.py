"""The chunked executor of spleeterrt_tpu_torch (`runtime/executor.py`)
against the JAX package's and against the port's monolithic graph, on the
CPU.

The JAX executor runs its canonical chunk step (rfft, the U-Net, irfft,
overlap-add by .at[].add); the port's runs K1, the U-Net and K7 a chunk at
hop 1024 (their plain versions on CPU tensors), K9 at hop 2048, and the
canonical inverse at FFT 2048. The two executors agree to 2e-4, the bound
JAX's own test holds its executor to against its graph, and the port's
executor agrees with the port's monolithic `separate` to 1e-5: the seams
between chunks only reorder the overlap-add's sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spleeterrt_tpu.config import SeparatorConfig as JSeparatorConfig
from spleeterrt_tpu.config import TransformConfig as JTransformConfig
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu.runtime import executor as jexecutor
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.config import SeparatorConfig, TransformConfig
from spleeterrt_tpu_torch.core import separate, weights
from spleeterrt_tpu_torch.runtime import executor

torch.set_num_threads(2)


def _nets(rng):
    jps = [jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(i)))
           for i in range(4)]
    for p in jps:  # random biases and batch norms
        for ly in p.values():
            c = ly["b"].shape[0]
            ly["b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
            if "bn_scale" in ly:
                ly["bn_scale"] = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
                ly["bn_shift"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return (jweights.stack_params(jps),
            weights.stack_params([weights.params_from_jax(p) for p in jps]))


def _cfgs(fft_size=4096, overlap=4):
    kw = dict(bin_limit=512, time_step=64, num_stems=4)
    return (JSeparatorConfig(transform=JTransformConfig(fft_size, overlap),
                             compute_dtype=jnp.float32, **kw),
            SeparatorConfig(transform=TransformConfig(fft_size, overlap),
                            compute_dtype=torch.float32, **kw))


@pytest.mark.parametrize("n", [200_000, 262_144 - 8192], ids=["partial", "whole"])
def test_chunked_matches_jax_and_monolithic(rng, n):
    """Hop 1024, chunk_tiles 2 (131,072 samples a chunk): 200,000 samples
    end in a partial chunk; 253,952 pad to exactly two whole chunks."""
    jstacked, stacked = _nets(rng)
    jcfg, cfg = _cfgs()
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    kernels.reset_launch_counts()
    got = executor.separate_4stem_chunked(stacked, x, cfg, chunk_tiles=2)
    assert not any(kernels.launch_counts().values())
    assert isinstance(got, np.ndarray) and got.shape == (4, 2, n)
    assert got.dtype == np.float32
    ref = np.asarray(jexecutor.separate_4stem_chunked(jstacked, x, jcfg,
                                                      chunk_tiles=2))
    assert np.abs(ref).max() > 0.01
    np.testing.assert_allclose(got, ref, atol=2e-4)
    mono = separate.separate(x, stacked_params=stacked, cfg=cfg, device="cpu")
    for i, stem in enumerate(cfg.stem_names):
        np.testing.assert_allclose(got[i], mono[stem].numpy(), atol=1e-5,
                                   err_msg=stem)


@pytest.mark.parametrize("fft_size,overlap", [(4096, 2), (2048, 4)],
                         ids=["hop2048", "fft2048"])
def test_chunked_other_transforms(rng, fft_size, overlap):
    """Hop 2048 (K9's plain version a chunk) and FFT 2048 (the canonical
    inverse a chunk), each over three chunks, the last partial, against
    JAX's executor and the port's monolithic graph."""
    jstacked, stacked = _nets(rng)
    jcfg, cfg = _cfgs(fft_size, overlap)
    n = 150_000 if fft_size == 2048 else 230_000
    x = (rng.standard_normal((2, n)) * 0.3).astype(np.float32)
    got = executor.separate_4stem_chunked(stacked, x, cfg, chunk_tiles=1)
    ref = np.asarray(jexecutor.separate_4stem_chunked(jstacked, x, jcfg,
                                                      chunk_tiles=1))
    np.testing.assert_allclose(got, ref, atol=2e-4)
    mono = separate.separate(x, stacked_params=stacked, cfg=cfg, device="cpu")
    for i, stem in enumerate(cfg.stem_names):
        np.testing.assert_allclose(got[i], mono[stem].numpy(), atol=1e-5,
                                   err_msg=stem)
