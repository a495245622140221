"""spleeterrt_tpu_torch.core.train / checkpoint against the JAX package.

Inputs from a seed with numpy, 2 stems, fp32, B <= 2 tiles of 64 x 512, on
the CPU in both packages (the JAX package's loss takes its canonical XLA
route there, as the port's takes its canonical torch route). Tolerances:

- the loss agrees to rtol 1e-5 and each gradient leaf to 1e-4 of the
  leaf's max |g| (both sum the same products in another order through
  twelve layers; 4.4e-6 measured);
- Adam's first steps are lr * m / (sqrt(v) + eps), so a gradient near eps
  turns rounding into an update of order lr. A step taken from the same
  state in both packages is held to an absolute `ADAM_ATOL` (lr * 1e-2;
  1e-3 of max |g| carries the gradients' 4e-6 to about 4e-3 lr) where |g|
  exceeds 1e-3 of its leaf's max |g|; elsewhere each package may move an
  entry by at most lr a step. The EMA is held like the params it averages;
- SI-SDR agrees to 0.01 dB.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spleeterrt_tpu.config import SeparatorConfig as JConfig
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import train as jtrain
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu.data import dataset as jds
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.config import STEM_MODE_2, STEM_MODE_4, SeparatorConfig
from spleeterrt_tpu_torch.core import checkpoint, model, train, weights
from spleeterrt_tpu_torch.data import dataset as ds
from spleeterrt_tpu_torch.examples import train as train_example
from spleeterrt_tpu_torch.examples import train_and_deploy
from spleeterrt_tpu_torch.io import audio
from spleeterrt_tpu_torch.kernels import (
    encoder,
    mask_head,
    pallas_fft,
    stft_fused,
    tail,
)

torch.set_num_threads(2)

LR = 1e-3
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4  # of each leaf's max |g|
ADAM_ATOL = LR * 1e-2
SI_SDR_DB = 0.01
STEMS = ("vocals", "accompaniment")
CFG = SeparatorConfig(bin_limit=512, time_step=64, num_stems=2,
                      compute_dtype=torch.float32)
JCFG = JConfig(bin_limit=512, time_step=64, num_stems=2,
               compute_dtype=jnp.float32)


def _jax_stacked(n=2, seed=0):
    nets = [jmodel.init_params(jax.random.PRNGKey(seed + i)) for i in range(n)]
    return jax.tree.map(np.asarray, jweights.stack_params(nets))


def _torch(tree):
    """A stacked JAX tree (numpy leaves) in the port's layout."""
    return checkpoint.stacked_from_jax(jax.tree.map(np.asarray, tree))


def _batch(rng, b=2, s=2):
    mix = np.abs(rng.standard_normal((b, 64, 512, 2))).astype(np.float32)
    tgt = np.abs(rng.standard_normal((s, b, 64, 512, 2))).astype(np.float32)
    return mix, tgt


def _loss_and_grads(params, mix, tgt, stem_mode=STEM_MODE_4, active=None,
                    compute_dtype=torch.float32):
    p = train.trainable(params)
    loss = train.separation_loss(
        p, torch.from_numpy(mix), torch.from_numpy(tgt), stem_mode,
        compute_dtype, None if active is None else torch.from_numpy(active),
    )
    loss.backward()
    return loss.detach(), {ln: {fn: v.grad for fn, v in ly.items()}
                           for ln, ly in p.items()}


def _leaves(params):
    return {f"{ln}/{fn}": v for ln, ly in params.items() for fn, v in ly.items()}


def _assert_grads_close(got, ref):
    for key, r in _leaves(ref).items():
        g, r = _leaves(got)[key].numpy(), r.numpy()
        scale = max(float(np.abs(r).max()), 1e-30)
        assert np.abs(g - r).max() <= GRAD_REL * scale, key


@pytest.mark.parametrize("stem_mode", [STEM_MODE_4, STEM_MODE_2])
@pytest.mark.parametrize("weighted", [False, True])
def test_separation_loss_and_grads_match_jax(rng, stem_mode, weighted):
    jp = _jax_stacked()
    mix, tgt = _batch(rng)
    active = np.array([[1.0, 0.0], [1.0, 1.0]], np.float32) if weighted else None
    jloss, jgrads = jax.value_and_grad(jtrain.separation_loss)(
        jp, jnp.asarray(mix), jnp.asarray(tgt), stem_mode, jnp.float32,
        None if active is None else jnp.asarray(active),
    )
    loss, grads = _loss_and_grads(_torch(jp), mix, tgt, stem_mode, active)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads_close(grads, _torch(jgrads))


def test_silent_stem_has_zero_gradient(rng):
    """A stem marked silent contributes nothing: its net's gradient is 0."""
    mix, tgt = _batch(rng)
    tgt[1] = 0.0
    active = np.array([[1.0, 1.0], [0.0, 0.0]], np.float32)
    _, grads = _loss_and_grads(_torch(_jax_stacked()), mix, tgt, active=active)
    for key, g in _leaves(grads).items():
        assert torch.all(g[1] == 0.0), key
    assert any(torch.any(g[0] != 0.0) for g in _leaves(grads).values())


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_grads_finite_at_huge_preactivations(compute_dtype):
    """The counterpart of tests/test_aux.py's ELU check: pre-activations far
    past exp's float32 overflow (~88) leave the loss and every gradient
    finite (the port's elu is F.elu under a where, whose backward never
    multiplies an unselected branch)."""
    p = _torch(_jax_stacked())
    p["down1"]["w"] = p["down1"]["w"] * 1e4
    p["down1"]["b"] = p["down1"]["b"] + 500.0
    mix = np.abs(np.random.default_rng(0).standard_normal((2, 64, 512, 2)))
    tgt = np.abs(np.random.default_rng(1).standard_normal((2, 2, 64, 512, 2)))
    loss, grads = _loss_and_grads(p, mix.astype(np.float32),
                                  tgt.astype(np.float32), STEM_MODE_4,
                                  compute_dtype=compute_dtype)
    assert torch.isfinite(loss)
    for key, g in _leaves(grads).items():
        assert torch.all(torch.isfinite(g)), key


def test_loss_differentiates_with_routes_forced(rng, monkeypatch):
    """With every routing switch forced on, the loss still takes the
    canonical route (same gradients bit for bit) and never reaches a
    kernel wrapper, which would raise on the grad-requiring params; the
    inference route with the same params does reach one and raises."""
    p = _torch(_jax_stacked())
    mix, tgt = _batch(rng, b=1)
    loss0, grads0 = _loss_and_grads(p, mix, tgt)
    monkeypatch.setattr(model, "FORCE_PACKED_UNET", True)
    monkeypatch.setattr(model, "FORCE_PALLAS_HEAD", True)
    monkeypatch.setattr(model, "FORCE_PALLAS_ENCODER", True)
    loss1, grads1 = _loss_and_grads(p, mix, tgt)
    assert torch.equal(loss0, loss1)
    for key, g in _leaves(grads1).items():
        assert torch.equal(g, _leaves(grads0)[key]), key
    mag = torch.from_numpy(np.ascontiguousarray(mix.transpose(0, 3, 1, 2)))
    with pytest.raises(RuntimeError, match="enc1: .*no backward"):
        model.multi_stem_masks(train.trainable(p), mag)
    with torch.no_grad():  # inference on the same params is fine
        masks = model.multi_stem_masks(train.trainable(p), mag)
    assert masks.shape == (2, 1, 2, 64, 512)


def _wrapper_calls():
    """One call per kernel wrapper, with a grad-requiring tensor among its
    inputs (the guard runs before any shape check)."""
    g = lambda *shape: torch.zeros(shape, requires_grad=True)
    z = torch.zeros
    w16 = lambda *shape: z(1, *shape)
    return {
        "stft4096": lambda: stft_fused.stft4096(g(2, 8192), z(4096), 5, 64, 512, 64),
        "masked_istft4096": lambda: stft_fused.masked_istft4096(
            z(2, 64, 2049, dtype=torch.complex64), g(1, 1, 2, 64, 512), z(1),
            z(4096), 64),
        "enc1": lambda: encoder.enc1(z(1, 2, 64, 64), g(1, 16, 2, 5, 5), z(1, 16),
                                     z(1, 16), z(1, 16), act="elu",
                                     dtype=torch.float32),
        "enc_s2": lambda: encoder.enc_s2(g(1, 8, 8, 16), w16(32, 16, 5, 5),
                                         z(1, 32), z(1, 32), z(1, 32), act="elu"),
        "up_shallow": lambda: tail.up_shallow(
            z(1, 4, 4, 64), z(1, 4, 4, 64), g(1, 128, 32, 5, 5), z(1, 32),
            z(1, 32), z(1, 32), act="elu"),
        "head": lambda: tail.head(z(1, 4, 4, 16), z(1, 4, 4, 16), w16(32, 1, 5, 5),
                                  z(1, 1), z(1, 1), z(1, 1), w16(2, 1, 4, 4),
                                  g(1, 2), act="elu"),
        "irfft4096": lambda: pallas_fft.irfft4096(
            z(3, 2049, dtype=torch.complex64), g(4096)),
        "masked_irfft4096": lambda: pallas_fft.masked_irfft4096(
            z(3, 2049, dtype=torch.complex64), g(1, 3, 512), z(1), 512),
        "mask_head": lambda: mask_head.mask_head(
            g(1, 4, 4, 32), w16(32, 1, 5, 5), z(1, 1), z(1, 1), z(1, 1),
            w16(2, 1, 4, 4), z(1, 2), act="elu"),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrappers_refuse_grad(name):
    """No kernel has a backward: every wrapper raises on a grad-requiring
    input under grad mode (on every device; here the CPU), instead of
    returning outputs without a grad_fn."""
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        _wrapper_calls()[name]()
    assert not any(kernels.launch_counts().values())


def test_deploy_params_folds_like_jax(rng):
    """deploy_params equals the JAX package's, and net(mag / 4096) ==
    deploy_params(net)(mag)."""
    jp = _jax_stacked(n=1, seed=7)
    got = train.deploy_params(_torch(jp), 4096)
    ref = _torch(jtrain.deploy_params(jp, 4096))
    for key, v in _leaves(ref).items():
        assert torch.equal(_leaves(got)[key], v), key
    mag = torch.from_numpy(
        np.abs(rng.standard_normal((1, 64, 512, 2))).astype(np.float32) * 100)
    a = model.multi_stem_forward(_torch(jp), mag / 4096.0, STEM_MODE_4,
                                 torch.float32)
    b = model.multi_stem_forward(got, mag, STEM_MODE_4, torch.float32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _jax_opt(lr=LR):
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))


def _steps_data(rng, n):
    return [_batch(rng) for _ in range(n)]


def _assert_stepped_close(got, ref, grad_mask, steps, atol=ADAM_ATOL):
    """The Adam rule of the module docstring, leaf by leaf: within `atol`
    where `grad_mask` holds; elsewhere each side moved at most steps * lr
    from their common start."""
    for key, r in _leaves(ref).items():
        err = np.abs(_leaves(got)[key].detach().numpy() - r.numpy())
        m = grad_mask[key]
        assert err[m].max(initial=0.0) <= atol, key
        assert err[~m].max(initial=0.0) <= 2 * steps * LR * (1 + 1e-6), key


def _grad_mask(grads_per_step):
    """Entries whose |g| exceeds 1e-3 of the leaf's max |g| at every step."""
    out = {}
    for grads in grads_per_step:
        for key, g in _leaves(grads).items():
            a = np.abs(g.numpy())
            m = a > 1e-3 * a.max()
            out[key] = m & out.get(key, m)
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jstate):
    """JAX's state after its steps, carried over with train_state_from_jax."""
    adam = jstate.opt_state[1][0]  # chain(clip, adam): the clip holds no state
    return checkpoint.train_state_from_jax(
        _np_tree(jstate.params), _np_tree(adam.mu), _np_tree(adam.nu),
        int(adam.count), int(jstate.step), _np_tree(jstate.ema_params), lr=LR,
        device="cpu",
    )


def _jax_step():
    return jax.jit(jtrain.make_train_step(_jax_opt(), STEM_MODE_4, jnp.float32,
                                          0.999))


def _jax_grad(jstate, mix, tgt):
    return _torch(jax.grad(jtrain.separation_loss)(
        jstate.params, jnp.asarray(mix), jnp.asarray(tgt), STEM_MODE_4,
        jnp.float32))


TRAJECTORY_ATOL = LR * 0.1  # 3 free-running steps (see the test)


def test_train_steps_with_ema_match_jax(rng):
    """3 steps of make_train_step (clip 1.0, Adam 1e-3, EMA 0.999) against
    JAX's make_train_step with optax.chain(clip_by_global_norm(1.0),
    adam(1e-3)). Each step is held twice: from JAX's state before it
    (carried over, so only that step's rounding differs: ADAM_ATOL), and
    as a free-running run of the port from the same init. Entries whose
    first update rounded differently move the later gradients, so the
    free run is held to TRAJECTORY_ATOL after 3 steps (0.058 lr measured)
    and its losses to LOSS_RTOL."""
    jp = _jax_stacked()
    jstate = jtrain.init_train_state(jax.tree.map(jnp.asarray, jp), _jax_opt(),
                                     ema=True)
    jstep, step = _jax_step(), train.make_train_step(STEM_MODE_4, torch.float32)
    free = train.init_train_state(_torch(jp), LR, ema=True)
    grads = []
    for mix, tgt in _steps_data(rng, 3):
        synced = _port_state(jstate)
        grads.append(_jax_grad(jstate, mix, tgt))
        jstate, jloss = jstep(jstate, jnp.asarray(mix), jnp.asarray(tgt))
        synced, loss = step(synced, torch.from_numpy(mix), torch.from_numpy(tgt))
        free, free_loss = step(free, torch.from_numpy(mix), torch.from_numpy(tgt))
        np.testing.assert_allclose([float(loss), float(free_loss)],
                                   [float(jloss)] * 2, rtol=LOSS_RTOL)
        assert synced.step == free.step == int(jstate.step)
        mask = _grad_mask(grads[-1:])
        _assert_stepped_close(synced.params, _torch(jstate.params), mask, 1)
        _assert_stepped_close(synced.ema_params, _torch(jstate.ema_params), mask, 1)
    mask = _grad_mask(grads)
    _assert_stepped_close(free.params, _torch(jstate.params), mask, 3,
                          TRAJECTORY_ATOL)
    _assert_stepped_close(free.ema_params, _torch(jstate.ema_params), mask, 3,
                          TRAJECTORY_ATOL)


def test_train_state_from_jax_then_step(rng):
    """2 JAX steps, the state carried over with train_state_from_jax (Adam
    moments permuted like the weights; count and step kept), then one more
    step in each package."""
    data = _steps_data(rng, 3)
    jstate = jtrain.init_train_state(jax.tree.map(jnp.asarray, _jax_stacked()),
                                     _jax_opt(), ema=True)
    jstep = _jax_step()
    for mix, tgt in data[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(mix), jnp.asarray(tgt))
    state = _port_state(jstate)
    assert state.step == 2
    adam = jstate.opt_state[1][0]
    moments = checkpoint.stacked_from_jax(_np_tree(adam.mu))
    leaf = train.param_leaves(state.params)[0]
    assert torch.equal(state.optimizer.state[leaf]["exp_avg"],
                       train.param_leaves(moments)[0])
    assert float(state.optimizer.state[leaf]["step"]) == 2.0
    mix, tgt = data[2]
    mask = _grad_mask([_jax_grad(jstate, mix, tgt)])
    jstate, jloss = jstep(jstate, jnp.asarray(mix), jnp.asarray(tgt))
    step = train.make_train_step(STEM_MODE_4, torch.float32)
    state, loss = step(state, torch.from_numpy(mix), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_stepped_close(state.params, _torch(jstate.params), mask, 1)
    _assert_stepped_close(state.ema_params, _torch(jstate.ema_params), mask, 1)


def _torch_run(state, data):
    step = train.make_train_step(STEM_MODE_4, torch.float32)
    for mix, tgt in data:
        state, _ = step(state, torch.from_numpy(mix), torch.from_numpy(tgt))
    return state


def _fresh_state(seed, ema=True):
    nets = [model.init_params(torch.Generator().manual_seed(seed + i))
            for i in range(2)]
    return train.init_train_state(weights.stack_params(nets), LR, ema=ema)


def _assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in ((a.params, b.params), (a.ema_params, b.ema_params)):
        for key, v in _leaves(x).items():
            assert torch.equal(v, _leaves(y)[key]), key
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_checkpoint_round_trip_and_exact_resume(rng, tmp_path):
    """save / restore into a fresh state of other params, and a resumed run
    equal bit for bit to an uninterrupted one (params, EMA, Adam state)."""
    data = _steps_data(rng, 4)
    straight = _torch_run(_fresh_state(0), data)
    first = _torch_run(_fresh_state(0), data[:2])
    checkpoint.save(tmp_path / "ckpt" / "step_2", first)
    checkpoint.save(tmp_path / "ckpt" / "step_2", first)  # overwrites
    checkpoint.save(tmp_path / "ckpt" / "step_10", _fresh_state(5))
    assert checkpoint.latest_step_dir(tmp_path / "ckpt").endswith("step_10")
    assert checkpoint.latest_step_dir(tmp_path / "none") is None
    resumed = checkpoint.restore(tmp_path / "ckpt" / "step_2", _fresh_state(3))
    _assert_states_equal(resumed, first)
    resumed = _torch_run(resumed, data[2:])
    _assert_states_equal(resumed, straight)


def _write_corpus(root, rng, n_tracks=2, n=70000):
    for k in range(n_tracks):
        d = root / f"track{k}"
        d.mkdir(parents=True)
        t = np.arange(n) / 44100.0
        vocals = (0.3 * np.sin(2 * np.pi * (300 + 100 * k) * t))[None].repeat(2, 0)
        acc = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
        audio.write_wav(d / "vocals.wav", vocals.astype(np.float32))
        audio.write_wav(d / "accompaniment.wav", acc)
        audio.write_wav(d / "mixture.wav", (vocals + acc).astype(np.float32))
    return root


def test_evaluate_si_sdr_matches_jax(tmp_path, rng):
    """Held-out SI-SDR through the separation graph (the kernels' plain
    versions here) within 0.01 dB of the JAX package's."""
    root = _write_corpus(tmp_path, rng)
    jp = _jax_stacked()
    ref = jtrain.evaluate_si_sdr(jp, jds.StemDataset(root, STEMS), JCFG,
                                 seconds=1.0)
    kernels.reset_launch_counts()
    got = train.evaluate_si_sdr(train.trainable(_torch(jp)),
                                ds.StemDataset(root, STEMS), CFG, seconds=1.0)
    assert set(got) == set(ref) == {"vocals", "accompaniment", "mean"}
    for k in ref:
        assert abs(got[k] - ref[k]) <= SI_SDR_DB, (k, got[k], ref[k])
    assert not any(kernels.launch_counts().values())  # CPU: plain versions


def test_train_example_resumes_and_exports(tmp_path, rng, capsys):
    """The training entry point on the CPU: 2 steps with a checkpoint, a
    second run resumes from it and takes the third, then exports blobs."""
    _write_corpus(tmp_path / "data" / "train", rng)
    _write_corpus(tmp_path / "data" / "test", rng, n_tracks=1)
    common = ["--data", str(tmp_path / "data"), "--batch", "1", "--bin-limit",
              "512", "--time-step", "64", "--fp32", "--device", "cpu",
              "--ckpt", str(tmp_path / "ckpt"), "--eval-seconds", "1"]
    assert train_example.main([*common, "--steps", "2"]) == 0
    assert os.path.isdir(tmp_path / "ckpt" / "step_2")
    assert train_example.main([*common, "--steps", "3", "--export",
                               str(tmp_path / "blobs")]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "(step 2)" in out
    assert "eval @ step 3" in out
    assert checkpoint.latest_step_dir(tmp_path / "ckpt").endswith("step_3")
    for name in STEMS:
        assert (tmp_path / "blobs" / f"{name}.dat").stat().st_size == 39_290_900


@pytest.mark.parametrize("entry", [train_example, train_and_deploy])
def test_examples_refuse_missing_cuda(tmp_path, monkeypatch, entry):
    """The default --device cuda with no card exits; no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", str(tmp_path)] if entry is train_example else [
        "--out", str(tmp_path)]
    with pytest.raises(SystemExit, match="no CUDA device"):
        entry.main(argv)


def test_train_and_deploy_improves_on_cpu(tmp_path):
    """The train-and-deploy loop on the CPU, cut to 12 steps: SI-SDR rises
    and the blob round trip leaves the separation unchanged."""
    log = train_and_deploy.run(12, 4, str(tmp_path), torch.device("cpu"))
    assert log["si_sdr_trained"]["mean"] > log["si_sdr_init"]["mean"]
    assert log["deploy_roundtrip_max_err"] <= train_and_deploy.ROUNDTRIP_MAX_ERR
