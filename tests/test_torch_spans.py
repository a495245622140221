"""The port's in-memory spans (spleeterrt_tpu_torch/utils/timing.py) on the
CPU: off by default and free when off, the layers' spans of an offline
call and of the HTTP service, their nesting and self-times, the cap, the
stage timer's span, and the clock they share with torch.profiler."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from spleeterrt_tpu_torch.config import SeparatorConfig
from spleeterrt_tpu_torch.core import model, separate, weights
from spleeterrt_tpu_torch.io import audio
from spleeterrt_tpu_torch.kernels import KERNELS, pallas_fft
from spleeterrt_tpu_torch.runtime import server
from spleeterrt_tpu_torch.utils import timing

torch.set_num_threads(2)

LAYERS = ("service.", "graph.", "model.", "kernels.")


@pytest.fixture(autouse=True)
def fresh_recorder():
    timing.set_tracing(False)
    timing.take_spans()
    yield
    timing.set_tracing(False)
    timing.take_spans()


def _nets(n):
    gen = torch.Generator().manual_seed(0)
    return [model.init_params(gen) for _ in range(n)]


def _cfg(stems):
    return SeparatorConfig(bin_limit=512, time_step=64, num_stems=stems,
                           compute_dtype=torch.float32)


def _nets_kwargs(stems):
    ps = _nets(stems)
    return {"params": ps[0]} if stems == 2 else {"stacked_params": weights.stack_params(ps)}


def _self_ns(spans):
    """{span_id: its duration less its direct children's}."""
    out = {s.span_id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent_id in out:
            out[s.parent_id] -= s.end_ns - s.start_ns
    return out


def _check_nesting(spans):
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent_id is not None:
            p = by_id[s.parent_id]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p, s)
            assert p.thread_id == s.thread_id and p.request_id == s.request_id


def test_tracing_is_off_by_default_and_an_off_span_is_free(monkeypatch):
    """Off: span() is one shared no-op context that never reads the clock,
    and nothing is recorded."""
    assert not timing.tracing()

    def no_clock():
        raise AssertionError("an off span read the clock")

    monkeypatch.setattr(time, "time_ns", no_clock)
    first = timing.span("graph.separate", stems=4)
    assert timing.span("kernels.enc1") is first
    assert timing.request(7) is first
    with first as sp:
        sp.note(route="packed")
    with timing.StageTimer(verbose=False).stage("load"):
        pass
    pallas_fft.irfft4096(torch.zeros(3, 2049, dtype=torch.complex64))  # traced()
    monkeypatch.undo()
    assert timing.take_spans() == [] and timing.dropped() == 0


@pytest.mark.parametrize("stems", [2, 4])
def test_offline_call_spans_nest_under_one_graph_root(stems):
    """A CPU `separate.separate` call opens the documented spans, each inside
    its parent, under one `graph.separate` root."""
    timing.set_tracing(True)
    separate.separate(torch.randn(2, 20000) * 0.1, cfg=_cfg(stems),
                      device="cpu", **_nets_kwargs(stems))
    spans = timing.take_spans()
    roots = [s for s in spans if s.parent_id is None]
    assert [r.name for r in roots] == ["graph.separate"]
    assert roots[0].attrs == {"stems": stems, "samples": 20000, "graph": "eager"}
    _check_nesting(spans)
    names = [s.name for s in spans]
    want = ["graph.pad", "kernels.stft4096", "kernels.enc1", "kernels.enc_s2",
            "kernels.enc_s2", "kernels.enc_s2", "model.mid_trunk",
            "kernels.up4", "kernels.up5", "kernels.head", "model.unet",
            "kernels.masked_istft4096"]
    want += ["graph.residual"] if stems == 2 else []
    assert names == want + ["graph.crop", "graph.separate"]
    unet = next(s for s in spans if s.name == "model.unet")
    assert unet.attrs == {"route": "packed"}
    assert all(s.name.startswith(LAYERS) for s in spans)
    assert {n.removeprefix("kernels.") for n in names if n.startswith("kernels.")} <= set(KERNELS)


def test_layer_self_times_partition_the_root():
    """The graph spans' self-time, the model spans' self-time and the kernel
    spans' time sum to the root's duration."""
    timing.set_tracing(True)
    separate.separate(torch.randn(2, 20000) * 0.1, cfg=_cfg(4), device="cpu",
                      **_nets_kwargs(4))
    spans = timing.take_spans()
    own = _self_ns(spans)
    by_layer = dict.fromkeys(("graph.", "model.", "kernels."), 0)
    for s in spans:
        by_layer[s.name[: s.name.index(".") + 1]] += own[s.span_id]
    root = next(s for s in spans if s.parent_id is None)
    assert all(v > 0 for v in by_layer.values())
    assert abs(sum(by_layer.values()) - (root.end_ns - root.start_ns)) <= 1000


def test_concurrent_requests_each_get_a_service_tree(tmp_path):
    """Two requests at once to a CPU service: two request ids, each with its
    whole tree of service spans around its own separation, and the lock
    held by one at a time."""
    service = server.SeparationService(_cfg(2), _nets_kwargs(2), device="cpu")
    srv = server.make_server("127.0.0.1", 0, service)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    buf = tmp_path / "in.wav"
    audio.write_wav(buf, (np.random.default_rng(1).standard_normal((2, 12000))
                          * 0.3).astype(np.float32), 44100)
    body = buf.read_bytes()
    url = f"http://127.0.0.1:{srv.server_address[1]}/separate"
    statuses = []

    def post():
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            r.read()
            statuses.append(r.status)

    timing.set_tracing(True)
    try:
        clients = [threading.Thread(target=post) for _ in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(120)
        assert not any(c.is_alive() for c in clients)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)
    assert statuses == [200, 200]
    spans = timing.take_spans()
    _check_nesting(spans)
    ids = {s.request_id for s in spans}
    assert len(ids) == 2 and None not in ids
    tree = ["service.read_body", "service.parse", "service.lock_wait",
            "graph.separate", "service.to_host", "service.locked",
            "service.encode", "service.write", "service.request"]
    held = []
    for rid in ids:
        mine = [s for s in spans if s.request_id == rid]
        names = [s.name for s in mine]
        assert [n for n in names if n in tree] == tree
        root = next(s for s in mine if s.name == "service.request")
        assert root.parent_id is None
        wait = next(s for s in mine if s.name == "service.lock_wait")
        assert wait.attrs["waiting"] in (1, 2)
        locked = next(s for s in mine if s.name == "service.locked")
        held.append((locked.start_ns, locked.end_ns))
    (a0, a1), (b0, b1) = sorted(held)
    assert a1 <= b0


def test_the_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(timing, "SPAN_CAP", 3)
    timing.set_tracing(True)
    for i in range(5):
        with timing.span(f"graph.s{i}"):
            pass
    assert timing.dropped() == 2
    assert [s.name for s in timing.take_spans()] == ["graph.s0", "graph.s1", "graph.s2"]
    assert timing.dropped() == 0


def test_stage_timer_records_its_span(capsys):
    timing.set_tracing(True)
    t = timing.StageTimer()
    with timing.span("graph.outer"):
        with t.stage("compute", sync=torch.ones(2)):
            time.sleep(0.002)
    outer, stage = sorted(timing.take_spans(), key=lambda s: s.start_ns)
    assert stage.name == "compute" and stage.parent_id == outer.span_id
    assert stage.end_ns - stage.start_ns >= t.report()["compute"] * 1e9
    assert capsys.readouterr().out.startswith("compute takes ")


def test_spans_share_the_profiler_clock():
    """Under torch.profiler (CPU activity) with tracing on, an op run inside
    a span padded by 20 ms sleeps has its profiler event inside the span.
    The profiler alone records no span."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.span("graph.probe") is timing.span("graph.other")
    timing.set_tracing(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span("graph.probe"):
            time.sleep(0.02)
            a @ a
            time.sleep(0.02)
    (s,) = timing.take_spans()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert s.start_ns + 10_000_000 < e.start_ns()
        assert e.start_ns() + e.duration_ns() < s.end_ns - 10_000_000


def test_profiler_trace_appends_the_spans(tmp_path):
    """`profiler_trace` turns tracing on and writes the port's spans as
    complete events on their own track, around the ops they ran."""
    a = torch.ones(64, 64)
    with timing.profiler_trace(str(tmp_path)):
        assert timing.tracing()
        with timing.span("graph.probe", stems=2):
            time.sleep(0.01)
            a @ a
            time.sleep(0.01)
    assert not timing.tracing()
    trace = json.loads((tmp_path / timing.TRACE_FILE).read_text())
    events = trace["traceEvents"]
    (s,) = [e for e in events if e.get("cat") == "span"]
    assert s["ph"] == "X" and s["pid"] == timing.SPAN_PID and s["name"] == "graph.probe"
    assert s["args"]["stems"] == 2
    mm = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    assert mm
    for e in mm:
        assert s["ts"] < e["ts"] and e["ts"] + e["dur"] < s["ts"] + s["dur"]


def test_cli_profile_writes_the_call_spans(tmp_path):
    """`--profile DIR` writes the offline call's spans into DIR/trace.json
    beside the profiler's own events, and leaves tracing off after."""
    from spleeterrt_tpu_torch import cli

    song = tmp_path / "song.wav"
    audio.write_wav(song, (np.random.default_rng(2).standard_normal((2, 9000))
                           * 0.3).astype(np.float32))
    assert cli.main([str(song), "--stems", "2", "--time-step", "64",
                     "--bin-limit", "512", "--random-weights", "--fp32",
                     "--device", "cpu", "--output-dir", str(tmp_path / "out"),
                     "--profile", str(tmp_path / "prof")]) == 0
    assert not timing.tracing()
    events = json.loads((tmp_path / "prof" / timing.TRACE_FILE).read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in spans if e["name"] == "graph.separate"] == ["graph.separate"]
    assert {"kernels.stft4096", "model.unet", "graph.residual"} <= {e["name"] for e in spans}
    assert any(e.get("cat") != "span" and e.get("ph") == "X" for e in events)
