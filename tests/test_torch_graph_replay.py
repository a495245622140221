"""A repeated offline call replayed as one captured graph
(spleeterrt_tpu_torch/core/replay.py, `separate.separate`), on the CPU:
the per-device constants built once, the replay policy driven by a stub
capturer that keeps a CUDA graph's contract (one input buffer it reads,
output buffers it overwrites), and the calls that never enter the policy.
tests/test_torch_cuda.py holds the CUDA graph itself on a card."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from spleeterrt_tpu_torch.config import RoformerConfig, SeparatorConfig, TransformConfig
from spleeterrt_tpu_torch.core import model, replay, roformer, separate, transform, weights
from spleeterrt_tpu_torch.runtime import stream
from spleeterrt_tpu_torch.utils import timing

torch.set_num_threads(2)

CFG2 = SeparatorConfig(bin_limit=512, time_step=64, num_stems=2,
                       compute_dtype=torch.float32)
CFG4 = SeparatorConfig(bin_limit=512, time_step=64, num_stems=4,
                       compute_dtype=torch.float32)
N = 20000


def _nets(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if cfg.num_stems == 2:
        return {"params": model.init_params(gen)}
    return {"stacked_params": weights.stack_params(
        [model.init_params(gen) for _ in range(cfg.num_stems)])}


def _track(seed, n=N):
    return torch.randn(2, n, generator=torch.Generator().manual_seed(seed)) * 0.1


def _by_hand(track, cfg, nets):
    """The graph `separate` runs, composed from its parts: pad, the stem
    graph, crop."""
    n = track.shape[-1]
    preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
    padded = transform.pad_offline(track, cfg.transform).contiguous()
    if cfg.num_stems == 2:
        stems = separate.separate_2stem(nets["params"], padded, cfg)
    else:
        stems = separate.separate_4stem(nets["stacked_params"], padded, cfg)
    return stems[..., preshift : preshift + n]


def _tensors(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _cloned(out):
    copies = tuple(t.clone() for t in _tensors(out))
    return copies if isinstance(out, tuple) else copies[0]


def stub_capture(front, static_in):
    """A CUDA graph's contract on the CPU: the outputs live in buffers the
    'graph' owns, and every replay reads the input buffer and overwrites
    those outputs."""
    out = _cloned(front(static_in))

    def rerun():
        for mine, new in zip(_tensors(out), _tensors(front(static_in))):
            mine.copy_(new)

    return replay.Captured(rerun, out)


def silent_capture(front, static_in):
    """A graph whose replay runs no Python, so records no span: it keeps
    the outputs of the call it captured."""
    return replay.Captured(lambda: None, _cloned(front(static_in)))


def failing_capture(front, static_in):
    raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture(autouse=True)
def fresh_counts():
    replay.reset_counts()
    yield
    replay.reset_counts()


# ---------------------------------------------------------------------------
# Per-device constants
# ---------------------------------------------------------------------------

def _hann(n):
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * (i + 0.5) / n))).astype(np.float32)


CONSTANTS = {
    "analysis window": (lambda: transform.analysis_window(4096, device="cpu"),
                        lambda: _hann(4096)),
    "synthesis window": (
        lambda: transform.synthesis_window(TransformConfig(), device="cpu"),
        lambda: _hann(4096) * np.float32(TransformConfig().synthesis_gain)),
    "out-of-band weights": (
        lambda: transform.out_band_tensor((0.25, 0.0, 0.25, 0.25), "cpu"),
        lambda: np.array([0.25, 0.0, 0.25, 0.25], np.float32)),
    "streaming windows": (
        lambda: stream.window_tensors(1.0, torch.device("cpu"))[1],
        lambda: stream.asymmetric_windows(1.0)[1].astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_constants_are_built_once_and_equal_their_formulas(name):
    make, formula = CONSTANTS[name]
    first = make()
    assert make() is first
    assert first.dtype == torch.float32
    np.testing.assert_array_equal(first.numpy(), formula())


def test_a_constant_first_built_in_inference_mode_serves_autograd():
    with torch.inference_mode():
        w = transform.analysis_window(4097)
    assert not w.is_inference()
    x = torch.ones(4097, requires_grad=True)
    (x * w).sum().backward()
    assert torch.equal(x.grad, w)


# ---------------------------------------------------------------------------
# The policy, with a stub capturer
# ---------------------------------------------------------------------------

def _front(w):
    return lambda x: (x * w).sum(0, keepdim=True) + w


def _copy_out(y, x):
    """A back that copies the graph's output out of its memory."""
    return y.clone()


def _loader(x):
    """`load` of a call on `x`: into the graph's input, or a new one."""
    def load(buf):
        if buf is None:
            return x.clone()
        return buf.copy_(x)
    return load


def _run(graphs, x, w, fixed="cfg"):
    key = replay.call_key(x.device, [w], (fixed, x.shape))
    return graphs.run(key, [w], _front(w), _copy_out, lambda: x, _loader(x))


def test_eager_first_capture_second_replay_after():
    graphs = replay.CallGraphs(stub_capture)
    w = torch.arange(5.0)
    xs = [torch.randn(3, 5, generator=torch.Generator().manual_seed(i)) for i in range(4)]
    modes = []
    for x in xs:
        mode, y = _run(graphs, x, w)
        modes.append(mode)
        assert torch.equal(y, _front(w)(x))
    assert modes == ["eager", "capture", "replay", "replay"]
    assert len(graphs._graphs) == 1


def _key_pair(change):
    """Two calls' keys that differ only in `change`."""
    dev, w = torch.device("cpu"), torch.zeros(7)
    d, v, fixed = dev, w, (CFG2, model.route_switches(), 65536)
    if change == "graph size":
        fixed = (CFG2, model.route_switches(), 131072)
    elif change == "device":
        d = torch.device("meta")
    elif change == "weight tensor":
        v = torch.zeros(7)  # same shape and values, another tensor
    elif change == "config":
        fixed = (CFG4, model.route_switches(), 65536)
    elif change == "route switch":
        fixed = (CFG2, (False, *model.route_switches()[1:]), 65536)
    return (replay.call_key(dev, [w], (CFG2, model.route_switches(), 65536)),
            replay.call_key(d, [v], fixed))


@pytest.mark.parametrize("change", ["graph size", "device", "weight tensor", "config",
                                    "route switch", "nothing"])
def test_what_changes_the_key(change):
    a, b = _key_pair(change)
    assert (a == b) == (change == "nothing")


def test_other_weights_of_the_same_shapes_never_replay_a_graph():
    graphs = replay.CallGraphs(stub_capture)
    w, v, x = torch.ones(5), torch.full((5,), 2.0), torch.ones(3, 5)
    assert [_run(graphs, x, w)[0] for _ in range(3)] == ["eager", "capture", "replay"]
    mode, y = _run(graphs, x, v)
    assert mode == "eager" and torch.equal(y, _front(v)(x))


def test_the_least_recently_used_graph_goes_first():
    graphs = replay.CallGraphs(stub_capture, max_graphs=2)
    xs = {n: torch.ones(3, n) for n in (5, 6, 7)}
    ws = {n: torch.ones(n) for n in xs}
    run = lambda n: _run(graphs, xs[n], ws[n])[0]
    assert [run(5), run(5), run(6), run(6)] == ["eager", "capture", "eager", "capture"]
    assert run(5) == "replay"  # 6 is now the least recently used
    assert [run(7), run(7)] == ["eager", "capture"]
    assert len(graphs._graphs) == 2
    assert run(5) == "replay"
    # 6's graph went, and its key stays eager: a key captures once at most.
    assert [run(6), run(6), run(6)] == ["eager", "eager", "eager"]
    assert len(graphs._graphs) == 2


def test_a_capture_that_raises_leaves_its_key_eager():
    graphs = replay.CallGraphs(failing_capture)
    w, x = torch.arange(5.0), torch.ones(3, 5)
    modes = []
    for _ in range(4):
        mode, y = _run(graphs, x, w)
        modes.append(mode)
        assert torch.equal(y, _front(w)(x))
    assert modes == ["eager", "fallback", "eager", "eager"]
    assert len(graphs._graphs) == 0


def test_replayed_answers_are_copies_a_later_replay_leaves_alone():
    graphs = replay.CallGraphs(stub_capture)
    w = torch.arange(5.0)
    xs = [torch.randn(3, 5, generator=torch.Generator().manual_seed(i)) for i in range(5)]
    kept = [_run(graphs, x, w) for x in xs]
    assert [m for m, _ in kept] == ["eager", "capture", "replay", "replay", "replay"]
    for x, (_, y) in zip(xs, kept):
        assert torch.equal(y, _front(w)(x))


def test_freed_weights_start_their_key_over():
    """A key whose weights were freed is dropped: new weights on the same
    addresses (the caching allocator hands them out again) start eager."""
    graphs = replay.CallGraphs(stub_capture)
    x, w = torch.ones(3, 5), torch.arange(5.0)
    key = replay.call_key(x.device, [w], "cfg")
    front = lambda t: t * 2.0
    run = lambda weights: graphs.run(key, weights, front, _copy_out, lambda: x,
                                     _loader(x))[0]
    assert [run([w]) for _ in range(2)] == ["eager", "capture"]
    del w
    v = torch.arange(5.0)
    assert run([v]) == "eager"
    assert len(graphs._graphs) == 0


# ---------------------------------------------------------------------------
# `separate` and the policy
# ---------------------------------------------------------------------------

class Spy(replay.CallGraphs):
    def __init__(self):
        super().__init__(failing_capture)
        self.calls = 0

    def run(self, *args):
        self.calls += 1
        return super().run(*args)


@pytest.mark.parametrize("cfg", [CFG2, CFG4], ids=["2 stems", "4 stems"])
def test_cpu_calls_never_enter_the_policy(monkeypatch, cfg):
    spy = Spy()
    monkeypatch.setattr(replay, "GRAPHS", spy)
    nets, track = _nets(cfg), _track(1)
    want = _by_hand(track, cfg, nets)
    for _ in range(3):
        got = separate.separate(track, cfg=cfg, device="cpu", **nets)
        assert list(got) == list(cfg.stem_names)
        for stem, y in zip(cfg.stem_names, want):
            assert torch.equal(got[stem], y)
    assert spy.calls == 0
    assert replay.counts() == {"eager": 3, "capture": 0, "replay": 0, "fallback": 0}


def test_roformer_calls_never_enter_the_policy(monkeypatch):
    cfg = RoformerConfig(
        dim=32, depth=1, heads=2, dim_head=16,
        freqs_per_bands=(2,) * 8 + (4,) * 4 + (8,) * 4 + (16,) * 2 + (33,),
        n_fft=256, hop=64, win=256, chunk=22050, batch=2,
        compute_dtype=torch.float32)
    spy = Spy()
    monkeypatch.setattr(replay, "GRAPHS", spy)
    monkeypatch.setattr(separate, "_replayable", lambda *a: True)
    params = roformer.init_params(cfg, torch.Generator().manual_seed(0))
    track = _track(2, 22050)
    start = roformer.border(22050, cfg)
    want = roformer.separate_roformer(track, params, cfg)[..., start : start + 22050]
    for _ in range(2):
        got = separate.separate(track, params=params, cfg=cfg, device="cpu")
        assert torch.equal(got["vocals"], want[0])
    assert spy.calls == 0 and replay.counts()["eager"] == 2


@pytest.mark.parametrize("cfg", [CFG2, CFG4], ids=["2 stems", "4 stems"])
def test_separate_replays_a_repeated_call(monkeypatch, cfg):
    """With the policy open to CPU tensors and the stub capturer: three
    tracks of one length run eager, capture, replay; each answer equals
    its track's eager answer bit for bit, and stays so after later
    replays; the dict has the eager call's keys, shapes and dtype."""
    monkeypatch.setattr(replay, "GRAPHS", replay.CallGraphs(stub_capture))
    monkeypatch.setattr(separate, "_replayable", lambda *a: True)
    nets = _nets(cfg)
    tracks = [_track(10 + i) for i in range(4)]
    kept = [separate.separate(t, cfg=cfg, device="cpu", **nets) for t in tracks]
    assert replay.counts() == {"eager": 1, "capture": 1, "replay": 2, "fallback": 0}
    for track, got in zip(tracks, kept):
        want = _by_hand(track, cfg, nets)
        assert list(got) == list(cfg.stem_names)
        for stem, y in zip(cfg.stem_names, want):
            assert got[stem].shape == (2, N) and got[stem].dtype == torch.float32
            assert torch.equal(got[stem], y)
    # Another configuration of the same nets and length is a new key.
    other = SeparatorConfig(bin_limit=576, time_step=64, num_stems=cfg.num_stems,
                            compute_dtype=torch.float32)
    separate.separate(tracks[0], cfg=other, device="cpu", **nets)
    assert replay.counts()["eager"] == 2


@pytest.mark.parametrize("cfg", [CFG2, CFG4], ids=["2 stems", "4 stems"])
def test_lengths_of_one_tile_count_share_a_graph(monkeypatch, cfg):
    """Every length of one tile count replays one graph, run at the longest
    padded length of that count: after the longest track, shorter ones
    (the graph's input cleared past each) give their own padded length's
    stems bit for bit; a track one tile longer is a key of its own."""
    monkeypatch.setattr(replay, "GRAPHS", replay.CallGraphs(stub_capture))
    monkeypatch.setattr(separate, "_replayable", lambda *a: True)
    nets = _nets(cfg)
    longest = 4096 * 14  # the longest track of one 64-frame tile
    assert separate._graph_size(1, cfg) == separate._graph_size(longest, cfg) == 65536
    assert separate._graph_size(longest + 1, cfg) == 2 * 65536
    modes = []
    for i, n in enumerate([30000, longest, N, 1, longest + 1]):
        before = replay.counts()
        track = _track(20 + i, n)
        got = separate.separate(track, cfg=cfg, device="cpu", **nets)
        modes.append(next(m for m, c in replay.counts().items() if c != before[m]))
        for stem, y in zip(cfg.stem_names, _by_hand(track, cfg, nets)):
            assert got[stem].shape == (2, n)
            assert torch.equal(got[stem], y), (n, stem)
    assert modes == ["eager", "capture", "replay", "replay", "eager"]


def test_a_replayed_call_records_only_its_replay_span(monkeypatch):
    monkeypatch.setattr(replay, "GRAPHS", replay.CallGraphs(silent_capture))
    monkeypatch.setattr(separate, "_replayable", lambda *a: True)
    nets, track = _nets(CFG2), _track(3)
    timing.set_tracing(True)
    try:
        roots = []
        for _ in range(3):
            timing.take_spans()
            separate.separate(track, cfg=CFG2, device="cpu", **nets)
            spans = timing.take_spans()
            roots.append(next(s for s in spans if s.name == "graph.separate"))
    finally:
        timing.set_tracing(False)
    assert [r.attrs["graph"] for r in roots] == ["eager", "capture", "replay"]
    # What follows the graph (2 stems: the crop, the residual) still runs
    # and records its spans.
    assert [s.name for s in spans] == ["graph.replay", "graph.residual", "graph.crop",
                                       "graph.separate"]
    by_id = {s.span_id: s for s in spans}
    assert [by_id[s.parent_id].name for s in spans[:-1]] == [
        "graph.separate", "graph.crop", "graph.separate"]


def test_calls_autograd_would_record_stay_eager():
    """Only where grad mode is on and an input or a weight requires grad
    (the rule of the kernels' `check_no_grad`); a CPU call never replays."""
    nets, audio = _nets(CFG2), _track(4)
    w = separate._weights((nets["params"],))
    assert not separate._replayable(audio, w)
    assert not separate._autograd_records(audio, w)
    w[0].requires_grad_()
    assert separate._autograd_records(audio, w)
    with torch.no_grad():
        assert not separate._autograd_records(audio, w)


def test_the_2stem_graph_stays_differentiable():
    """The 2-stem residual, written into the stems' tensor, still carries
    gradients where autograd records the call: the plain transform (FFT
    2048) and the canonical U-Net, the route autograd differentiates."""
    cfg = SeparatorConfig(transform=TransformConfig(fft_size=2048), bin_limit=512,
                          time_step=64, num_stems=2, compute_dtype=torch.float32)
    unet = functools.partial(model.multi_stem_masks, pallas_head=False,
                             pallas_encoder=False)
    nets, audio = _nets(cfg), _track(5)
    padded = transform.pad_offline(audio, cfg.transform)
    with torch.no_grad():
        ref = separate.separate_2stem(nets["params"], padded, cfg, unet)
    w = nets["params"]["down1"]["w"].requires_grad_()
    stems = separate.separate_2stem(nets["params"], padded, cfg, unet)
    assert stems.requires_grad and torch.equal(stems.detach(), ref)
    stems[1].sum().backward()
    assert torch.isfinite(w.grad).all() and w.grad.abs().sum() > 0
