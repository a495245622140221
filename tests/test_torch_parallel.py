"""spleeterrt_tpu_torch.parallel against the JAX package's mesh, on gloo ranks.

Gloo process groups of spawned CPU ranks play the part of the JAX
package's 8-device virtual CPU mesh (tests/conftest.py): every rank builds
the same inputs from a seed with numpy and calls the port's entry point on
a (stem, data) mesh of the same shape as the JAX sub-mesh the parent runs
its counterpart on. Every rank must return the same result (the replicated
out_specs); rank 0's is held against the JAX package's, at the tolerances
of tests/test_sharding.py:

- masks 2e-5; the 4-stem graph 2e-4; the batch graphs 2e-5; the 2- and
  3-stem single-track graphs 2e-4; stream steps 1e-5 and the sharded scan
  2e-5; the time-sharded graph 5e-5.

The ranks import torch and the port only: jax and the JAX package are
imported inside the parent-side functions. Each group has a 60 s timeout
and each spawn a deadline, after which its ranks are killed and the test
fails. One spawn of 4 ranks serves the separation cases and one of 2 ranks
the streaming ones (module-scoped fixtures; the JAX references run in the
parent while the ranks work).
"""

from __future__ import annotations

import datetime
import hashlib
import queue
import time
import traceback

import numpy as np
import pytest
import torch

SEED = 11
PG_TIMEOUT_S = 60
SPAWN_DEADLINE_S = 240
BIN_LIMIT, TIME_STEP = 512, 64  # tests/test_sharding.py's sizes
TIMESHARD_N = 150000  # at 4 ranks: pads to 4 x 65536, the last rank past n_comp


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, world, store_path, case, args, out):
    try:
        import torch.distributed as dist

        from spleeterrt_tpu_torch.parallel import distributed

        torch.set_num_threads(max(1, 4 // world))
        distributed.initialize(
            "cpu", world_size=world, rank=rank,
            store=dist.FileStore(store_path, world),
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            result = case(rank, *args)
        finally:
            distributed.shutdown()
        out.put((rank, None, result))
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, traceback.format_exc(), None))


class Ranks:
    """`world` spawned gloo ranks running `case(rank, *args)`; `results()`
    waits for every rank's return value (rank order), failing the test on
    a rank's error or the deadline, and kills what is left."""

    def __init__(self, world, case, args, tmp_path):
        ctx = torch.multiprocessing.get_context("spawn")
        self.out = ctx.Queue()
        store = str(tmp_path / f"store_{case.__name__}")
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(r, world, store, case, args, self.out))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + SPAWN_DEADLINE_S

    def kill(self):
        for p in self.procs:
            p.kill()
            p.join(timeout=10)

    def results(self):
        got = {}
        try:
            while len(got) < len(self.procs):
                left = self.deadline - time.monotonic()
                try:
                    rank, error, result = self.out.get(timeout=max(left, 0.1))
                except queue.Empty:
                    pytest.fail(f"ranks {sorted(set(range(len(self.procs))) - set(got))} "
                                f"gave no result in {SPAWN_DEADLINE_S} s")
                if error is not None:
                    pytest.fail(f"rank {rank} failed:\n{error}")
                got[rank] = result
        finally:
            for p in self.procs:
                p.join(timeout=10)
            self.kill()
        return [got[r] for r in range(len(self.procs))]


def spawn_and_refs(world, case, args, tmp_path, refs=lambda: None):
    """(every rank's `case(rank, *args)`, refs()): the parent computes the
    references while the ranks run."""
    ranks = Ranks(world, case, args, tmp_path)
    try:
        refs = refs()
    except BaseException:
        ranks.kill()
        raise
    return ranks.results(), refs


def digest(results: dict) -> dict:
    """Each array's bytes hashed: what a rank other than 0 returns."""
    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            if isinstance(v, np.ndarray) else v for k, v in results.items()}


def assert_replicated(per_rank: list[dict]) -> dict:
    """Every rank returned rank 0's arrays bit for bit; rank 0's results."""
    full = per_rank[0]
    for r, other in enumerate(per_rank[1:], start=1):
        assert other == digest(full), f"rank {r} differs from rank 0"
    return full


# ---------------------------------------------------------------------------
# Inputs: numpy only, from the seed, the same in every rank and the parent
# ---------------------------------------------------------------------------


def inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    audio = lambda *shape: (rng.standard_normal(shape) * 0.3).astype(np.float32)
    return {
        "net_seeds": [int(s) for s in rng.integers(0, 2**31, 7)],
        "mask_audio": audio(2, 3 * 4096),
        "audio": audio(2, 2 * 4096),
        "tracks": audio(8, 2, 2 * 4096),
        "long": audio(2, TIMESHARD_N),
        "stream_blocks": audio(2, 4, 2, TIME_STEP * 1024),
        "stream_audio": audio(2, 3 * TIME_STEP * 1024),
    }


def blob(seed: int, scale: float = 0.02) -> np.ndarray:
    """A random fp32 blob (core/weights.py::random_blob) as floats."""
    from spleeterrt_tpu_torch.core import weights

    raw = weights.random_blob(np.random.default_rng(seed), scale)
    return np.frombuffer(raw, np.float32)


def torch_nets(inp: dict):
    """(stacked 5 nets, 2-stem-pass net, 4-stem-family net), port layout."""
    from spleeterrt_tpu_torch.core import weights

    nets = [weights.blob_to_params(blob(s)) for s in inp["net_seeds"][:5]]
    return (weights.stack_params(nets),
            weights.blob_to_params(blob(inp["net_seeds"][5], 0.015)),
            weights.blob_to_params(blob(inp["net_seeds"][6])))


def jax_nets(inp: dict):
    from spleeterrt_tpu.core import weights as jweights

    nets = [jweights.blob_to_params(blob(s)) for s in inp["net_seeds"][:5]]
    return (jweights.stack_params(nets),
            jweights.blob_to_params(blob(inp["net_seeds"][5], 0.015)),
            jweights.blob_to_params(blob(inp["net_seeds"][6])))


def torch_cfg():
    from spleeterrt_tpu_torch.config import SeparatorConfig

    return SeparatorConfig(bin_limit=BIN_LIMIT, time_step=TIME_STEP,
                           num_stems=4, compute_dtype=torch.float32)


def jax_cfg():
    import jax.numpy as jnp

    from spleeterrt_tpu.config import SeparatorConfig as JConfig

    return JConfig(bin_limit=BIN_LIMIT, time_step=TIME_STEP, num_stems=4,
                   compute_dtype=jnp.float32)


def first4(stacked):
    return {ln: {fn: v[:4] for fn, v in ly.items()} for ln, ly in stacked.items()}


def padded_tracks(x):
    from spleeterrt_tpu_torch.core import transform

    return transform.pad_offline(torch.from_numpy(x), torch_cfg().transform).contiguous()


# ---------------------------------------------------------------------------
# Rank-side cases
# ---------------------------------------------------------------------------


def separation_cases(rank: int, seed: int) -> dict:
    """Every separation entry point at 4 ranks, on (4, 1), (2, 2) and (1, 4)."""
    from spleeterrt_tpu_torch.core import transform
    from spleeterrt_tpu_torch.parallel import mesh as pmesh
    from spleeterrt_tpu_torch.parallel import timeshard

    inp = inputs(seed)
    cfg = torch_cfg()
    stacked5, p2, p4 = torch_nets(inp)
    stacked = first4(stacked5)
    m41, m22, m14 = (pmesh.make_mesh(s) for s in (4, 2, 1))
    mix = padded_tracks(inp["mask_audio"])
    spec = transform.stft(mix, cfg.transform, mix.shape[-1])
    audio = padded_tracks(inp["audio"])
    tracks = padded_tracks(inp["tracks"])
    out = {
        "masks_41": pmesh.compute_masks_sharded(stacked, spec, cfg, m41),
        "masks_22": pmesh.compute_masks_sharded(stacked, spec, cfg, m22),
        "masks5_22": pmesh.compute_masks_sharded(stacked5, spec, cfg, m22),
        "sep4_22": pmesh.separate_4stem_sharded(stacked, audio, cfg, m22),
        "batch_8": pmesh.separate_batch_sharded(stacked, tracks, cfg, m14),
        "batch_6": pmesh.separate_batch_sharded(stacked, tracks[:6], cfg, m14),
        "sep2": pmesh.separate_2stem_sharded(p2, audio, cfg, m14),
        "batch2": pmesh.separate_2stem_batch_sharded(p2, tracks[:4], cfg, m14),
        "sep3": pmesh.separate_3stem_sharded(p4, p2, audio, cfg, m22),
        "batch3": pmesh.separate_3stem_batch_sharded(p4, p2, tracks[:4], cfg, m14),
        "timeshard": timeshard.separate_4stem_timesharded_padded(
            stacked, torch.from_numpy(inp["long"]), cfg, m14),
    }
    out = {k: v.numpy() for k, v in out.items()}
    for name, call in (
        ("make_mesh_3", lambda: pmesh.make_mesh(3)),
        ("batch_2nets", lambda: pmesh.make_batch_fn(cfg, m14, 2)),
    ):
        try:
            call()
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)
    return out if rank == 0 else digest(out)


def stream_cases(rank: int, seed: int) -> dict:
    """The streaming entry points at 2 ranks, on (2, 1)."""
    from spleeterrt_tpu_torch.parallel import mesh as pmesh
    from spleeterrt_tpu_torch.runtime import stream

    inp = inputs(seed)
    cfg = torch_cfg()
    stacked = first4(torch_nets(inp)[0])
    m21 = pmesh.make_mesh(2)
    step, n = pmesh.make_stream_fn(cfg, m21, 4)
    blocks = torch.from_numpy(inp["stream_blocks"])
    state = stream.init_state_streams(cfg, 4, blocks.shape[1] // n)
    outs = []
    for b in blocks:
        state, o = step(stacked, state, b)
        outs.append(o)
    audio = torch.from_numpy(inp["stream_audio"])
    out = {
        "n_ranks": n,
        "stream_steps": torch.stack(outs).numpy(),
        "scan": pmesh.stream_scan_sharded(stacked, audio, cfg, m21, 4).numpy(),
    }
    try:
        pmesh.stream_scan_sharded(stacked, audio, cfg, m21, 4,
                                  out_band=(0.25, 0.0, 0.25))
        out["out_band_3"] = "no error"
    except ValueError as e:
        out["out_band_3"] = str(e)
    return out if rank == 0 else digest(out)


# ---------------------------------------------------------------------------
# Parent side: the JAX package's counterparts on sub-meshes
# ---------------------------------------------------------------------------


def jax_separation_refs(inp: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from spleeterrt_tpu.core import separate as jseparate
    from spleeterrt_tpu.core import transform as jtransform
    from spleeterrt_tpu.parallel import mesh as jmesh
    from spleeterrt_tpu.parallel import timeshard as jtimeshard

    cfg = jax_cfg()
    stacked5, p2, p4 = jax_nets(inp)
    stacked = first4(stacked5)
    devs = jax.devices()[:4]
    m41, m22, m14 = (jmesh.make_mesh(devs, s) for s in (4, 2, 1))
    pad = lambda x: jtransform.pad_offline(jnp.asarray(x), cfg.transform)
    mix = pad(inp["mask_audio"])
    spec = jtransform.stft(mix, cfg.transform, mix.shape[-1])
    audio = pad(inp["audio"])
    tracks = jax.vmap(pad)(inp["tracks"])
    masks = lambda p, m: jmesh.compute_masks_sharded(
        jmesh.shard_params(p, m, stem_sharded=True), spec, cfg, m)
    refs = {
        "masks_41": masks(stacked, m41),
        "masks_22": masks(stacked, m22),
        # What the GSPMD branch of 5 nets over 2 stem groups computes: on
        # this jax it raises (its sharding constraint needs dim 0 to divide).
        "masks5_22": jseparate.compute_masks_multi(stacked5, spec, cfg, 1),
        "sep4_22": jmesh.separate_4stem_sharded(
            jmesh.shard_params(stacked, m22, stem_sharded=True), audio, cfg, m22),
        "batch_8": jmesh.separate_batch_sharded(stacked, tracks, cfg, m14),
        "batch_6": jmesh.separate_batch_sharded(stacked, tracks[:6], cfg, m14),
        "sep2": jmesh.separate_2stem_sharded(p2, audio, cfg, m14),
        "batch2": jmesh.separate_2stem_batch_sharded(p2, tracks[:4], cfg, m14),
        "sep3": jmesh.separate_3stem_sharded(p4, p2, audio, cfg, m22),
        "batch3": jmesh.separate_3stem_batch_sharded(p4, p2, tracks[:4], cfg, m14),
        "timeshard": jtimeshard.separate_4stem_timesharded_padded(
            stacked, jnp.asarray(inp["long"]), cfg, m14),
    }
    return {k: np.asarray(v) for k, v in refs.items()}


def jax_stream_refs(inp: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from spleeterrt_tpu.parallel import mesh as jmesh
    from spleeterrt_tpu.runtime import stream as jstream

    cfg = jax_cfg()
    stacked = first4(jax_nets(inp)[0])
    m21 = jmesh.make_mesh(jax.devices()[:2], 2)
    step, _ = jmesh.make_stream_fn(cfg, m21, 4)
    blocks = inp["stream_blocks"]
    state = jstream.init_state_streams(cfg, 4, blocks.shape[1])
    outs = []
    for b in blocks:
        state, o = step(stacked, state, jnp.asarray(b))
        outs.append(np.asarray(o))
    return {
        "stream_steps": np.stack(outs),
        "scan": np.asarray(jmesh.stream_scan_sharded(
            stacked, jnp.asarray(inp["stream_audio"]), cfg, m21, 4)),
    }


@pytest.fixture(scope="module")
def separation(tmp_path_factory):
    """(rank 0's results, the JAX references, the inputs)."""
    per_rank, refs = spawn_and_refs(
        4, separation_cases, (SEED,), tmp_path_factory.mktemp("sep"),
        lambda: jax_separation_refs(inputs(SEED)))
    return assert_replicated(per_rank), refs, inputs(SEED)


@pytest.fixture(scope="module")
def streaming(tmp_path_factory):
    per_rank, refs = spawn_and_refs(
        2, stream_cases, (SEED,), tmp_path_factory.mktemp("stream"),
        lambda: jax_stream_refs(inputs(SEED)))
    return assert_replicated(per_rank), refs


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["masks_41", "masks_22"])
def test_compute_masks_sharded(separation, case):
    """Stems over "stem", tiles over "data" (the (2, 2) case pads one tile
    to two): JAX's shard_map masks and the port's unsharded masks."""
    from spleeterrt_tpu_torch.config import STEM_MODE_4
    from spleeterrt_tpu_torch.core import separate, transform

    got, refs, inp = separation
    np.testing.assert_allclose(got[case], refs[case], atol=2e-5)
    mix = padded_tracks(inp["mask_audio"])
    spec = transform.stft(mix, torch_cfg().transform, mix.shape[-1])
    mine = separate.compute_masks_multi(first4(torch_nets(inp)[0]), spec,
                                        torch_cfg(), STEM_MODE_4).numpy()
    np.testing.assert_allclose(got[case], mine, atol=2e-5)


def test_uneven_stems_keep_the_kernels_route(separation):
    """5 stems over 2 stem groups: the groups hold 3 and 2 nets, the second
    padded for the gather. JAX's counterpart is its GSPMD branch with the
    kernels off, which raises on this jax (its sharding constraint needs
    the 5 stems to divide the 2 groups); it would compute the unsharded
    compute_masks_multi, which the masks are held against."""
    got, refs, _ = separation
    assert got["masks5_22"].shape[0] == 5
    np.testing.assert_allclose(got["masks5_22"], refs["masks5_22"], atol=2e-5)


def test_separate_4stem_sharded(separation):
    got, refs, _ = separation
    np.testing.assert_allclose(got["sep4_22"], refs["sep4_22"], atol=2e-4)


@pytest.mark.parametrize("case", ["batch_8", "batch_6"])
def test_separate_batch_sharded(separation, case):
    """8 tracks over 4 ranks, and 6 (padded to 8 and cropped)."""
    got, refs, _ = separation
    assert got[case].shape[0] == int(case[-1])
    np.testing.assert_allclose(got[case], refs[case], atol=2e-5)


@pytest.mark.parametrize("case,atol", [("sep2", 2e-4), ("batch2", 2e-5),
                                       ("sep3", 2e-4), ("batch3", 2e-5)])
def test_single_net_graphs_sharded(separation, case, atol):
    """The 2- and 3-stem graphs, single-track (tiles over every rank) and
    batched (tracks over every rank); 2 stems conserve the input."""
    got, refs, _ = separation
    np.testing.assert_allclose(got[case], refs[case], atol=atol)
    if case == "batch2":
        tracks = padded_tracks(separation[2]["tracks"][:4]).numpy()
        n = tracks.shape[-1]
        np.testing.assert_allclose(got[case][:, 0, :, :n] + got[case][:, 1, :, :n],
                                   tracks, atol=1e-5)


def test_timesharded_matches_jax_and_unsharded(separation):
    """n = 150000 at 4 ranks: the last rank lies wholly past the computed
    frames (n_comp = 0 there) and must give zeros; the stems match JAX's
    time-sharded graph and the port's unsharded `separate`."""
    from spleeterrt_tpu_torch.core import separate, transform
    from spleeterrt_tpu_torch.parallel import timeshard

    got, refs, inp = separation
    cfg = torch_cfg()
    _, final_size = transform.offline_pad_sizes(TIMESHARD_N, cfg.transform)
    chunk_frames = timeshard.padded_length(final_size, cfg, 4) // 4 // 1024
    n_comp = transform.num_computed_frames(final_size, cfg.transform)
    assert 2 * chunk_frames < n_comp <= 3 * chunk_frames  # rank 3 computes none
    np.testing.assert_allclose(got["timeshard"], refs["timeshard"], atol=5e-5)
    mine = separate.separate(inp["long"], stacked_params=first4(torch_nets(inp)[0]),
                             cfg=cfg, device="cpu")
    for i, name in enumerate(cfg.stem_names):
        np.testing.assert_allclose(got["timeshard"][i], mine[name].numpy(),
                                   atol=5e-5, err_msg=name)


def test_mesh_and_batch_refusals(separation):
    """make_mesh on a world its stem groups do not divide, and make_batch_fn
    on 2 stacked nets, raise ValueError on every rank."""
    got = separation[0]
    assert "not divisible" in got["make_mesh_3"]
    assert "2-stem" in got["batch_2nets"]


def test_stream_steps_sharded(streaming):
    """4 streams over 2 ranks, two chained blocks, each rank holding its 2
    streams' state: the out blocks of JAX's make_stream_fn."""
    got, refs = streaming
    assert got["n_ranks"] == 2
    np.testing.assert_allclose(got["stream_steps"], refs["stream_steps"], atol=1e-5)


def test_stream_scan_sharded(streaming):
    """Stems over 2 stem groups, each scanning the whole signal; and a
    mismatched out_band raises (the JAX package does not check it)."""
    got, refs = streaming
    np.testing.assert_allclose(got["scan"], refs["scan"], atol=2e-5)
    assert "out_band has 3 weights" in got["out_band_3"]


def test_world_one_group_in_process():
    """At world 1 the group comes up in-process (gloo on the CPU) and the
    mesh is (1, 1); a CUDA rank without a card raises, and a second
    bring-up that disagrees on the world raises."""
    from spleeterrt_tpu_torch.parallel import distributed

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize("cuda")
    with distributed.process_group("cpu") as dev:
        assert dev == torch.device("cpu")
        assert distributed.is_coordinator()
        mesh = distributed.global_mesh(1)
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("stem", "data")
        with pytest.raises(RuntimeError, match="disagrees"):
            distributed.initialize("cpu", world_size=2, rank=1)
    assert not torch.distributed.is_initialized()
