"""The sharded train step and sharded checkpoints, on gloo ranks.

core/train.py's shard_train_state / make_sharded_train_step and
core/checkpoint.py on a sharded state, against the JAX package's
make_sharded_train_step on a sub-mesh of the same (stem, data) shape and
against the port's one-device step. 4 stems of random fp32 blob nets, B = 2
tiles of 64 x 512 with magnitudes large enough that the clip to global
norm 1 is active, Adam (lr 1e-3) and an EMA: one step with an `active`
mask (held against both) and a second without (held against the
one-device step). Tolerances (tests/test_sharding.py's): the loss to rtol
1e-5, params and EMA to atol 1e-6.

Resume across world sizes is held bit for bit: a world-2 run's checkpoint
restored at world 1 equals the world-2 state (gathered in memory) and steps
on as that state does; a world-1 checkpoint restored at world 2 steps on as
the world-1 state sharded in memory does. The ranks import torch and the
port only (the spawn harness is tests/test_torch_parallel.py's).
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest
import torch

from test_torch_parallel import assert_replicated, blob, digest, spawn_and_refs

SEED = 5
LR = 1e-3
EMA = 0.9
SCALE = 400.0  # magnitudes at which the global grad norm is about 3
ACTIVE = np.array([[1, 1], [1, 0], [0, 1], [1, 1]], np.float32)
MESHES = (4, 2)  # stem groups at world 4: (4, 1) and (2, 2)


def train_inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    mags = lambda *shape: (SCALE * np.abs(rng.standard_normal(shape))).astype(np.float32)
    return {
        "net_seeds": [int(s) for s in rng.integers(0, 2**31, 4)],
        "mix": mags(2, 64, 512, 2),
        "targets": mags(4, 2, 64, 512, 2),
        "resume_mix": mags(4, 1, 64, 512, 2),  # four steps of 2 stems, B = 1
        "resume_targets": mags(4, 2, 1, 64, 512, 2),
    }


def torch_stacked(inp: dict, n: int = 4):
    from spleeterrt_tpu_torch.core import weights

    return weights.stack_params([weights.blob_to_params(blob(s))
                                 for s in inp["net_seeds"][:n]])


def as_numpy(params) -> dict:
    return {f"{ln}/{fn}": v.detach().numpy().copy()
            for ln, ly in params.items() for fn, v in ly.items()}


def two_steps(state, step, inp, gather=lambda p: p) -> dict:
    """The active-masked step, then the plain one: each one's loss, and the
    params and EMA (through `gather`) after each, by leaf."""
    mix, tgt = torch.from_numpy(inp["mix"]), torch.from_numpy(inp["targets"])
    out = {}
    for k, active in ((1, torch.from_numpy(ACTIVE)), (2, None)):
        state, loss = step(state, mix, tgt, active)
        out[f"loss{k}"] = float(loss)
        for name, p in (("params", state.params), ("ema", state.ema_params)):
            for key, v in as_numpy(gather(p)).items():
                out[f"{name}{k}/{key}"] = v
    out["step"] = state.step
    return out


def one_device_run(inp: dict) -> dict:
    """The port's one-device step, twice (`two_steps`)."""
    from spleeterrt_tpu_torch.config import STEM_MODE_4
    from spleeterrt_tpu_torch.core import train

    state = train.init_train_state(torch_stacked(inp), LR, ema=True)
    return two_steps(state, train.make_train_step(STEM_MODE_4, torch.float32, EMA),
                     inp)


# ---------------------------------------------------------------------------
# Rank-side cases
# ---------------------------------------------------------------------------


def step_cases(rank: int, seed: int) -> dict:
    """`two_steps` sharded on (4, 1) and on (2, 2), every stem group's
    params and EMA gathered after each step."""
    from spleeterrt_tpu_torch.config import STEM_MODE_4
    from spleeterrt_tpu_torch.core import train
    from spleeterrt_tpu_torch.parallel import mesh as pmesh

    inp = train_inputs(seed)
    out = {}
    for groups in MESHES:
        mesh = pmesh.make_mesh(groups)
        state = train.shard_train_state(
            train.init_train_state(torch_stacked(inp), LR, ema=True), mesh, 4)
        step = train.make_sharded_train_step(mesh, STEM_MODE_4, torch.float32, EMA)
        run = two_steps(state, step, inp, lambda p: pmesh.gather_params(p, mesh))
        out.update({f"{groups}:{k}": v for k, v in run.items()})
    return out if rank == 0 else digest(out)


def _run(state, step, inp, steps):
    for k in steps:
        state, _ = step(state, torch.from_numpy(inp["resume_mix"][k]),
                        torch.from_numpy(inp["resume_targets"][k]))
    return state


def _whole(state, mesh) -> dict:
    """A state's params, Adam moments, EMA and step, every stem group's
    slice gathered (numpy), or the state's own if it is not sharded."""
    from spleeterrt_tpu_torch.core import train
    from spleeterrt_tpu_torch.parallel.distributed import all_gather_cat

    whole = ((lambda t: t.detach()) if mesh is None else
             (lambda t: all_gather_cat(t.detach(), mesh.get_group("stem"))))
    out = {"step": state.step}
    for i, leaf in enumerate(train.param_leaves(state.params)):
        moments = state.optimizer.state[leaf]
        out[f"p{i}"] = whole(leaf).numpy().copy()
        out[f"m{i}"] = whole(moments["exp_avg"]).numpy().copy()
        out[f"v{i}"] = whole(moments["exp_avg_sq"]).numpy().copy()
        out[f"c{i}"] = float(moments["step"])
    for i, leaf in enumerate(train.param_leaves(state.ema_params)):
        out[f"e{i}"] = whole(leaf).numpy().copy()
    return out


def resume_cases(rank: int, seed: int, root: str) -> dict:
    """World 2, mesh (2, 1), 2 stems: (a) 2 sharded steps, saved, and the
    state gathered in memory; (b) 2 one-device steps taken on each rank
    alone and saved by rank 0 (a world-1 checkpoint), restored into sharded
    templates and stepped twice, beside that state sharded in memory and
    stepped twice."""
    import os

    import torch.distributed as dist

    from spleeterrt_tpu_torch.config import STEM_MODE_4
    from spleeterrt_tpu_torch.core import checkpoint, train
    from spleeterrt_tpu_torch.parallel import mesh as pmesh

    inp = train_inputs(seed)
    mesh = pmesh.make_mesh(2)
    fresh = lambda: train.init_train_state(torch_stacked(inp, 2), LR, ema=True)
    template = lambda: train.shard_train_state(
        train.init_train_state(_other(inp), LR, ema=True), mesh, 2)
    one = train.make_train_step(STEM_MODE_4, torch.float32, EMA)
    sharded = train.make_sharded_train_step(mesh, STEM_MODE_4, torch.float32, EMA)

    state = _run(train.shard_train_state(fresh(), mesh, 2), sharded, inp, (0, 1))
    checkpoint.save(os.path.join(root, "w2", "step_2"), state)
    saved = _whole(state, mesh)

    world1 = _run(fresh(), one, inp, (0, 1))  # every rank, alone
    checkpoint.save(os.path.join(root, "w1", "step_2"), world1)  # rank 0 writes
    dist.barrier()
    restored = checkpoint.restore(os.path.join(root, "w1", "step_2"), template())
    from_ckpt = _whole(_run(restored, sharded, inp, (2, 3)), mesh)
    in_memory = train.shard_train_state(world1, mesh, 2)
    from_memory = _whole(_run(in_memory, sharded, inp, (2, 3)), mesh)
    out = {"saved": saved, "from_ckpt": from_ckpt, "from_memory": from_memory}
    return out if rank == 0 else {k: digest(v) for k, v in out.items()}


def _other(inp: dict):
    """Nets of other seeds: a template whose values a restore overwrites."""
    from spleeterrt_tpu_torch.core import weights

    return weights.stack_params([weights.blob_to_params(blob(s + 1))
                                 for s in inp["net_seeds"][:2]])


def example_cases(rank: int, root: str) -> dict:
    """examples/train.py at world 2 (mesh (2, 1)): 2 steps with a
    checkpoint, a resumed third with an export; and train_toy with one."""
    from spleeterrt_tpu_torch.core import checkpoint
    from spleeterrt_tpu_torch.examples import train as train_example
    from spleeterrt_tpu_torch.examples import train_toy

    common = ["--data", f"{root}/data", "--batch", "1", "--bin-limit", "512",
              "--time-step", "64", "--fp32", "--device", "cpu", "--ckpt",
              f"{root}/ckpt", "--eval-seconds", "1"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        train_example.main([*common, "--steps", "2"])
        train_example.main([*common, "--steps", "3", "--export", f"{root}/blobs"])
        train_toy.main(["--steps", "2", "--batch", "2", "--device", "cpu",
                        "--ckpt", f"{root}/toy"])
    return {"stdout": text.getvalue(),
            "latest": checkpoint.latest_step_dir(f"{root}/ckpt")}


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


def jax_step_refs(inp: dict) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from spleeterrt_tpu.core import train as jtrain
    from spleeterrt_tpu.core import weights as jweights
    from spleeterrt_tpu.parallel import mesh as jmesh

    stacked = jweights.stack_params([jweights.blob_to_params(blob(s))
                                     for s in inp["net_seeds"]])
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    refs = {}
    for groups in MESHES:
        mesh = jmesh.make_mesh(jax.devices()[:4], groups)
        state = jtrain.shard_train_state(
            jtrain.init_train_state(stacked, opt, ema=True), mesh, 4)
        step = jtrain.make_sharded_train_step(mesh, opt, compute_dtype=jnp.float32,
                                              ema_decay=EMA)
        state, loss = step(state, inp["mix"], inp["targets"], jnp.asarray(ACTIVE))
        refs[groups] = {"loss1": float(loss)}
        for name, p in (("params", state.params), ("ema", state.ema_params)):
            for key, v in _jax_leaves(p).items():
                refs[groups][f"{name}1/{key}"] = v
    return refs


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """(rank 0's results, the JAX references, the one-device run)."""
    inp = train_inputs(SEED)
    per_rank, (refs, mine) = spawn_and_refs(
        4, step_cases, (SEED,), tmp_path_factory.mktemp("step"),
        lambda: (jax_step_refs(inp), one_device_run(inp)))
    return assert_replicated(per_rank), refs, mine


def _jax_leaves(tree) -> dict:
    import jax

    from spleeterrt_tpu_torch.core import checkpoint

    return as_numpy(checkpoint.stacked_from_jax(jax.tree.map(np.asarray, tree)))


@pytest.mark.parametrize("groups", MESHES)
def test_sharded_step_matches_jax_and_one_device(stepped, groups):
    """The loss, params and EMA after each step, on (4, 1) and (2, 2):
    against the port's one-device step, and after the active-masked step
    against JAX's sharded step."""
    got, refs, mine = stepped
    assert got[f"{groups}:step"] == mine["step"] == 2
    mine = {k: v for k, v in mine.items() if k != "step"}
    for key, ref in mine.items():
        for want, source in ((ref, "one device"), (refs[groups].get(key), "JAX")):
            if want is None:
                continue
            err = np.abs(np.asarray(got[f"{groups}:{key}"]) - want).max()
            bound = 1e-5 * abs(want) if key.startswith("loss") else 1e-6
            assert err <= bound, (key, source, err)
    assert len(refs[groups]) == len(mine) // 2  # every step-1 entry


def test_clip_is_active(stepped):
    """The inputs put the global gradient norm above the clip's 1."""
    from spleeterrt_tpu_torch.config import STEM_MODE_4
    from spleeterrt_tpu_torch.core import train

    inp = train_inputs(SEED)
    p = train.trainable(torch_stacked(inp))
    train.separation_loss(p, torch.from_numpy(inp["mix"]),
                          torch.from_numpy(inp["targets"]), STEM_MODE_4,
                          torch.float32, torch.from_numpy(ACTIVE)).backward()
    norms = torch.stack(torch._foreach_norm([x.grad for x in train.param_leaves(p)]))
    assert float(torch.linalg.vector_norm(norms)) > 1.5


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """(rank 0's results of the world-2 spawn, the checkpoint root)."""
    root = tmp_path_factory.mktemp("resume")
    per_rank, _ = spawn_and_refs(2, resume_cases, (SEED, str(root)), root)
    return per_rank[0], root


def test_world2_checkpoint_resumes_at_world1(resumed):
    """Restored at world 1, the world-2 checkpoint is the world-2 state bit
    for bit (params, Adam moments and counts, EMA, step), and two
    one-device steps from it equal two from that state in memory."""
    from spleeterrt_tpu_torch.config import STEM_MODE_4
    from spleeterrt_tpu_torch.core import checkpoint, train

    got, root = resumed
    inp = train_inputs(SEED)
    restored = checkpoint.restore(
        root / "w2" / "step_2",
        train.init_train_state(_other(inp), LR, ema=True))
    whole = _whole(restored, None)
    assert whole.keys() == got["saved"].keys()
    for key, v in got["saved"].items():
        assert np.array_equal(whole[key], v), key
    one = train.make_train_step(STEM_MODE_4, torch.float32, EMA)
    a = _whole(_run(restored, one, inp, (2, 3)), None)
    b = _whole(_run(_state_from(got["saved"]), one, inp, (2, 3)), None)
    for key in a:
        assert np.array_equal(a[key], b[key]), key


def _state_from(whole: dict):
    """A one-device state holding `_whole`'s arrays."""
    from spleeterrt_tpu_torch.core import train

    state = train.init_train_state(_other(train_inputs(SEED)), LR, ema=True)
    with torch.no_grad():
        for i, leaf in enumerate(train.param_leaves(state.params)):
            leaf.copy_(torch.from_numpy(whole[f"p{i}"]))
            state.optimizer.state[leaf] = {
                "step": torch.tensor(whole[f"c{i}"]),
                "exp_avg": torch.from_numpy(whole[f"m{i}"]).clone(),
                "exp_avg_sq": torch.from_numpy(whole[f"v{i}"]).clone()}
        for i, leaf in enumerate(train.param_leaves(state.ema_params)):
            leaf.copy_(torch.from_numpy(whole[f"e{i}"]))
    state.step = whole["step"]
    return state


def test_world1_checkpoint_resumes_at_world2(resumed):
    """The world-1 checkpoint restored into world-2 shards and stepped twice
    equals the same world-1 state sharded in memory and stepped twice."""
    got, _ = resumed
    assert got["from_ckpt"]["step"] == 4
    for key, v in got["from_memory"].items():
        assert np.array_equal(got["from_ckpt"][key], v), key


def _write_corpus(root, n_tracks=2, n=70000):
    from spleeterrt_tpu_torch.io import audio

    rng = np.random.default_rng(SEED)
    t = np.arange(n) / 44100.0
    for k in range(n_tracks):
        d = root / f"track{k}"
        d.mkdir(parents=True)
        vocals = np.repeat((0.3 * np.sin(2 * np.pi * (300 + 100 * k) * t))[None], 2, 0)
        acc = 0.1 * rng.standard_normal((2, n))
        for name, x in (("vocals", vocals), ("accompaniment", acc),
                        ("mixture", vocals + acc)):
            audio.write_wav(d / f"{name}.wav", x.astype(np.float32))


def test_train_examples_at_world_two(tmp_path):
    """examples/train.py under two ranks: a sharded run on a (2, 1) mesh
    checkpoints at step 2, a second run resumes from it (at any world
    size the format is one) and exports the gathered nets; train_toy
    checkpoints and exports its blob."""
    _write_corpus(tmp_path / "data" / "train")
    _write_corpus(tmp_path / "data" / "test", n_tracks=1)
    per_rank, _ = spawn_and_refs(2, example_cases, (str(tmp_path),), tmp_path)
    out = per_rank[0]["stdout"]
    assert "mesh {'stem': 2, 'data': 1}" in out
    assert "resumed from" in out and "(step 2)" in out and "eval @ step 3" in out
    assert per_rank[1]["stdout"] == ""  # rank 1 prints nothing
    assert per_rank[0]["latest"].endswith("step_3")
    for name in ("vocals", "accompaniment"):
        assert (tmp_path / "blobs" / f"{name}.dat").stat().st_size == 39_290_900
    assert (tmp_path / "toy" / "step_2").is_dir()
    assert (tmp_path / "toy" / "tone.dat").stat().st_size == 39_290_900


def test_train_toy_at_world_one(tmp_path, capsys):
    """A plain start of train_toy is world 1: a (1, 1) mesh, in-process."""
    from spleeterrt_tpu_torch.examples import train_toy

    assert train_toy.main(["--steps", "2", "--batch", "1", "--device", "cpu",
                           "--ckpt", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "training on 1 rank(s), mesh {'stem': 1, 'data': 1}" in out
    assert (tmp_path / "step_2").is_dir() and (tmp_path / "tone.dat").is_file()
    assert not torch.distributed.is_initialized()
