"""The HTTP service of spleeterrt_tpu_torch (`runtime/server.py`) against
the JAX package's, on the CPU: the counterparts of tests/test_cli.py's two
server tests, with the stems compared to JAX's `SeparationService` on the
same body to 2e-4, and the rule that the server never serves on the CPU
unless asked.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spleeterrt_tpu.config import SeparatorConfig as JSeparatorConfig
from spleeterrt_tpu.core import model as jmodel
from spleeterrt_tpu.core import weights as jweights
from spleeterrt_tpu.runtime import server as jserver
from spleeterrt_tpu_torch import kernels
from spleeterrt_tpu_torch.config import SeparatorConfig
from spleeterrt_tpu_torch.core import separate, weights
from spleeterrt_tpu_torch.io import audio
from spleeterrt_tpu_torch.runtime import server

torch.set_num_threads(2)


def _jax_nets(n):
    return [jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(i)))
            for i in range(n)]


@pytest.fixture
def serve():
    """serve(service) -> its base URL; every server is shut down after."""
    servers = []

    def start(service):
        srv = server.make_server("127.0.0.1", 0, service)
        servers.append(srv)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return f"http://127.0.0.1:{srv.server_address[1]}"

    yield start
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def test_http_server_separates(tmp_path, rng, serve):
    """A 2-stem server on the CPU: /healthz, /separate as npz and wav8ch
    against JAX's service on the same WAV, and the 400/404/413 contract."""
    kw = dict(bin_limit=512, time_step=64, num_stems=2)
    jp = _jax_nets(1)[0]
    jservice = jserver.SeparationService(
        JSeparatorConfig(compute_dtype=jnp.float32, **kw), {"params": jp})
    service = server.SeparationService(
        SeparatorConfig(compute_dtype=torch.float32, **kw),
        {"params": weights.params_from_jax(jp)}, device="cpu")
    base = serve(service)
    with urllib.request.urlopen(f"{base}/healthz") as r:
        assert json.loads(r.read()) == {"status": "ok", "devices": 1}

    x = (rng.standard_normal((2, 12000)) * 0.3).astype(np.float32)
    path = tmp_path / "in.wav"
    audio.write_wav(path, x, 44100)
    body = path.read_bytes()
    ref = jservice.separate_wav(body)
    kernels.reset_launch_counts()
    code, _, data = _post(f"{base}/separate?format=npz", body)
    assert code == 200
    assert not any(kernels.launch_counts().values())
    out = np.load(io.BytesIO(data))
    assert set(out.files) == set(ref) == {"vocals", "accompaniment"}
    for stem in ref:
        np.testing.assert_allclose(out[stem], ref[stem], atol=2e-4)
    np.testing.assert_allclose(out["vocals"] + out["accompaniment"], x, atol=1e-5)

    code, headers, data = _post(f"{base}/separate", body)  # wav8ch
    assert code == 200 and headers["X-Stem-Order"] == "vocals,accompaniment"
    wav = audio.read_wav(data)
    assert wav.samples.shape == (4, 12000)
    np.testing.assert_array_equal(
        wav.samples, np.concatenate([out["vocals"], out["accompaniment"]]))

    assert _post(f"{base}/separate", b"not a wav at all")[0] == 400
    assert _post(f"{base}/separate?stems=x", body)[0] == 400
    assert _post(f"{base}/separate?stems=4", body)[0] == 400  # a 2-stem server
    assert _post(f"{base}/separate_batch", b"PK\x03\x04junk")[0] == 400
    assert _post(f"{base}/separate?format=mp3", body)[0] == 400
    assert _post(f"{base}/nowhere", body)[0] == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{base}/nowhere")
    assert e.value.code == 404
    service.max_body_bytes = 1024
    assert _post(f"{base}/separate", b"\0" * 2048)[0] == 413


def test_http_server_batch(rng, serve):
    """A 4-stem server on the CPU: /separate_batch with tracks of three
    lengths (one mono) runs one batch, each track cropped back, against
    JAX's service on the same NPZ body and the port's single-track graph."""
    kw = dict(bin_limit=512, time_step=64, num_stems=4)
    jps = _jax_nets(4)
    jservice = jserver.SeparationService(
        JSeparatorConfig(compute_dtype=jnp.float32, **kw),
        {"stacked_params": jweights.stack_params(jps)})
    stacked = weights.stack_params([weights.params_from_jax(p) for p in jps])
    cfg = SeparatorConfig(compute_dtype=torch.float32, **kw)
    base = serve(server.SeparationService(cfg, {"stacked_params": stacked},
                                          device="cpu"))
    tracks = {"a": rng.standard_normal((2, 9000)), "b": rng.standard_normal((2, 12000)),
              "c": rng.standard_normal(10000)}
    buf = io.BytesIO()
    np.savez(buf, **{k: (0.3 * v).astype(np.float32) for k, v in tracks.items()})
    body = buf.getvalue()
    code, _, data = _post(f"{base}/separate_batch", body)
    assert code == 200
    out = np.load(io.BytesIO(data))
    ref = jservice.separate_batch(body)
    assert set(out.files) == set(ref) == {
        f"{t}/{s}" for t in tracks for s in cfg.stem_names}
    for key in ref:
        assert out[key].shape == (2, tracks[key[0]].shape[-1])
        np.testing.assert_allclose(out[key], ref[key], atol=2e-4, err_msg=key)
    solo = separate.separate((0.3 * tracks["b"]).astype(np.float32),
                             stacked_params=stacked, cfg=cfg, device="cpu")
    for stem in cfg.stem_names:
        np.testing.assert_allclose(out[f"b/{stem}"], solo[stem].numpy(), atol=1e-5)
    bad = io.BytesIO()
    np.savez(bad, a=np.zeros((3, 100), np.float32))
    assert _post(f"{base}/separate_batch", bad.getvalue())[0] == 400


def test_server_refuses_missing_cuda(monkeypatch):
    """--device cuda (the default) without a card exits before serving."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        server.main(["--random-weights", "--port", "0"])
