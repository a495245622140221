"""The port's HTTP service over ranks (runtime/server.py under a process
group), on two spawned gloo ranks on the CPU.

Rank 0 serves on port 0 in a thread and the other rank waits in
`serve_rank_loop`; the test posts to rank 0. A 4-stem server at bin_limit
512, time_step 64, fp32, with nets from seeded blobs: /separate_batch with
three tracks of unequal length (one mono) goes through
`parallel.mesh.separate_batch_sharded` on both ranks and must be within
1e-5 of the single-process service (`mesh=None`) and within 2e-4 of the
JAX package's service on the same body (tests/test_torch_server.py's
reference). A body refused with 400 must start no collective, and the
next request must still be answered; /separate runs on rank 0 alone; the
stop op code must end rank 1's loop, which counts the batches it ran.

The ranks import torch and the port only (the spawn harness is
tests/test_torch_parallel.py's, with its group timeout and deadline);
jax and the JAX package are imported in the parent's test body.
"""

from __future__ import annotations

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from spleeterrt_tpu_torch.io import audio
from test_torch_parallel import SPAWN_DEADLINE_S, Ranks, blob

SEED = 23
WORLD = 2
KW = dict(bin_limit=512, time_step=64, num_stems=4)


def _net_seeds():
    return [SEED + 100 + i for i in range(4)]


def torch_service(mesh=None):
    from spleeterrt_tpu_torch.config import SeparatorConfig
    from spleeterrt_tpu_torch.core import weights
    from spleeterrt_tpu_torch.runtime import server

    stacked = weights.stack_params(
        [weights.blob_to_params(blob(s)) for s in _net_seeds()])
    return server.SeparationService(
        SeparatorConfig(compute_dtype=torch.float32, **KW),
        {"stacked_params": stacked}, device="cpu", mesh=mesh)


def serve_case(rank: int, ctl, ports) -> dict:
    """Rank 0: serve until the parent says stop, then stop the ranks; the
    other rank: the receive loop, returning how many batches it ran."""
    from spleeterrt_tpu_torch.parallel import mesh as pmesh
    from spleeterrt_tpu_torch.runtime import server

    service = torch_service(pmesh.make_mesh(1))
    if rank:
        return {"batches": server.serve_rank_loop(service)}
    srv = server.make_server("127.0.0.1", 0, service)
    thread = threading.Thread(target=server.serve, args=(srv, service),
                              daemon=True)
    thread.start()
    ports.put(srv.server_address[1])
    try:
        ctl.get(timeout=SPAWN_DEADLINE_S)
    finally:
        srv.shutdown()
        thread.join(timeout=60)
        srv.server_close()
    return {"stopped": not thread.is_alive()}


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=SPAWN_DEADLINE_S) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _jax_reference(body: bytes) -> dict:
    import jax.numpy as jnp

    from spleeterrt_tpu.config import SeparatorConfig as JConfig
    from spleeterrt_tpu.core import weights as jweights
    from spleeterrt_tpu.runtime import server as jserver

    stacked = jweights.stack_params(
        [jweights.blob_to_params(blob(s)) for s in _net_seeds()])
    return jserver.SeparationService(
        JConfig(compute_dtype=jnp.float32, **KW),
        {"stacked_params": stacked}).separate_batch(body)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One spawn of the two ranks: the parent's requests, the references
    and each rank's return value."""
    rng = np.random.default_rng(SEED)
    tracks = {"a": rng.standard_normal((2, 9000)), "b": rng.standard_normal((2, 12000)),
              "c": rng.standard_normal(10000)}
    body = _npz(**{k: (0.3 * v).astype(np.float32) for k, v in tracks.items()})
    wav = io.BytesIO()
    audio.write_wav(wav, (0.3 * tracks["b"][:, :6000]).astype(np.float32))

    ctx = torch.multiprocessing.get_context("spawn")
    ctl, ports = ctx.Queue(), ctx.Queue()
    ranks = Ranks(WORLD, serve_case, (ctl, ports), tmp_path_factory.mktemp("ranks"))
    try:
        # The references run while the ranks start.
        got = {"solo": torch_service().separate_batch(body),
               "jax": _jax_reference(body)}
        base = f"http://127.0.0.1:{ports.get(timeout=SPAWN_DEADLINE_S)}"
        with urllib.request.urlopen(f"{base}/healthz") as r:
            got["health"] = json.loads(r.read())
        got["first"] = _post(f"{base}/separate_batch", body)
        got["refused"] = _post(f"{base}/separate_batch",
                               _npz(a=np.zeros((3, 100), np.float32)))
        got["second"] = _post(f"{base}/separate_batch", body)
        got["single"] = _post(f"{base}/separate?format=npz", wav.getvalue())
    except BaseException:
        ranks.kill()
        raise
    finally:
        ctl.put("stop")
    got["ranks"] = ranks.results()
    got["lengths"] = {k: v.shape[-1] for k, v in tracks.items()}
    return got


def test_healthz_counts_the_ranks(served):
    assert served["health"] == {"status": "ok", "devices": WORLD}


def test_ranked_batch_matches_single_process_and_jax(served):
    code, data = served["first"]
    assert code == 200, data
    out = np.load(io.BytesIO(data))
    ref, solo = served["jax"], served["solo"]
    assert set(out.files) == set(solo) == set(ref) == {
        f"{t}/{s}" for t in served["lengths"]
        for s in ("vocals", "drums", "bass", "accompaniment")}
    for key in ref:
        assert out[key].shape == (2, served["lengths"][key[0]])
        np.testing.assert_allclose(out[key], solo[key], atol=1e-5, err_msg=key)
        np.testing.assert_allclose(out[key], ref[key], atol=2e-4, err_msg=key)


def test_refused_request_starts_no_collective(served):
    """The 400 is answered on rank 0 alone; the next batch is answered, the
    same bit for bit, and rank 1 counts only the two good batches."""
    assert served["refused"][0] == 400, served["refused"]
    code, data = served["second"]
    assert code == 200, data
    first, second = (np.load(io.BytesIO(served[k][1])) for k in ("first", "second"))
    for key in first.files:
        np.testing.assert_array_equal(second[key], first[key])
    assert served["ranks"][1] == {"batches": 2}


def test_separate_runs_on_rank_zero(served):
    code, data = served["single"]
    assert code == 200, data
    out = np.load(io.BytesIO(data))
    assert {k: out[k].shape for k in out.files} == {
        s: (2, 6000) for s in ("vocals", "drums", "bass", "accompaniment")}


def test_stop_ends_the_rank_loop(served):
    """Rank 0's serve() ended and sent the stop op code; rank 1's loop
    returned on it (a rank still waiting would have missed the deadline)."""
    assert served["ranks"] == [{"stopped": True}, {"batches": 2}]
