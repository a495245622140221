"""The port's stage timer, profiler scope and PNG dumper
(spleeterrt_tpu_torch/utils/timing.py) against the JAX package's
spleeterrt_tpu/utils/timing.py, on the CPU."""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spleeterrt_tpu.utils import timing as jtiming
from spleeterrt_tpu_torch.utils import timing


def _run_stages(mod, x, capsys):
    t = mod.StageTimer()
    with t.stage("load"):
        pass
    with t.stage("compute", sync=x):
        pass
    with t.stage("load"):
        pass
    return t.report(), capsys.readouterr().out


def test_stage_timer_matches_jax(capsys):
    """Same stages, same accumulation, same printf lines on CPU tensors (a
    tree of them as `sync` too)."""
    got, out = _run_stages(timing, {"a": torch.ones(8), "b": [torch.zeros(2)]},
                           capsys)
    ref, jout = _run_stages(jtiming, jnp.ones((8, 8)), capsys)
    assert list(got) == list(ref) == ["load", "compute"]
    assert all(v >= 0.0 for v in got.values())
    line = re.compile(r"^(\w+) takes \d+\.\d{6} sec$")
    names = [line.match(s).group(1) for s in out.splitlines()]
    jnames = [line.match(s).group(1) for s in jout.splitlines()]
    assert names == jnames == ["load", "compute", "load"]
    quiet = timing.StageTimer(verbose=False)
    with quiet.stage("x", sync=torch.ones(2)):
        pass
    assert capsys.readouterr().out == ""
    assert set(quiet.report()) == {"x"}


def test_stage_timer_syncs_only_cuda(monkeypatch):
    """A CPU tensor (or a tree of them, or any other object) waits for no
    device."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))
    t = timing.StageTimer(verbose=False)
    for sync in (None, torch.ones(3), [torch.ones(1), {"k": torch.ones(1)}], 3.0):
        with t.stage("s", sync=sync):
            pass
    assert calls == []


@pytest.mark.parametrize("dtype", [np.float64, np.uint8])
def test_write_gray_png_byte_identical(tmp_path, rng, dtype):
    img = (np.abs(rng.standard_normal((33, 70))) * 90).astype(dtype)
    timing.write_gray_png(str(tmp_path / "a.png"), img)
    jtiming.write_gray_png(str(tmp_path / "b.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert data == (tmp_path / "b.png").read_bytes()
    timing.write_gray_png(str(tmp_path / "c.png"), torch.from_numpy(img))
    assert (tmp_path / "c.png").read_bytes() == data


def test_dump_spectrogram_pngs_matches_jax(tmp_path, rng):
    mag = np.abs(rng.standard_normal((2, 64, 128))).astype(np.float32)
    paths = timing.dump_spectrogram_pngs(torch.from_numpy(mag),
                                         str(tmp_path / "spec"))
    jpaths = jtiming.dump_spectrogram_pngs(mag, str(tmp_path / "jspec"))
    assert len(paths) == len(jpaths) == 2
    for p, jp in zip(paths, jpaths):
        assert open(p, "rb").read() == open(jp, "rb").read()
    bf = timing.dump_spectrogram_pngs(torch.from_numpy(mag).bfloat16(),
                                      str(tmp_path / "bf16"))
    assert all(open(p, "rb").read()[:8] == b"\x89PNG\r\n\x1a\n" for p in bf)


def test_profiler_trace_writes_a_trace(tmp_path):
    with timing.profiler_trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / timing.TRACE_FILE).read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with timing.profiler_trace(None):
        torch.ones(4).sum()
    assert [p.name for p in tmp_path.iterdir()] == ["prof"]
