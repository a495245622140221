"""Tracing / profiling utilities.

The reference's observability is wall/CPU-clock printf timing
(Executable/main.c:21-52, :772-965) and a disabled PNG spectrogram dumper
(VST/Source/Spleeter4Stems.c:218-256). The reference package's
spleeterrt_tpu/utils/timing.py, kept as the port's own copy: stage timers
that wait for the card before they read the clock, a `torch.profiler`
trace scope, and spectrogram dumps to PNG in pure NumPy.

Beside them, the port's in-memory spans: `span(name, **attrs)` around each
layer's work, named by its layer (`service.`, `graph.`, `model.`,
`kernels.`). A span records its name, its start and end on the wall clock
(`time.time_ns`, the clock of `torch.profiler`'s events, so that spans
line up with the device trace), its thread and its attributes;
`request(id)` opens a root that carries a request id. `take_spans()`
hands the records over as `Span`s and clears them: there each gets an id,
its parent (the innermost span of the same take that encloses it on the
same thread, which is the span open when it began) and the request id of
its root. Spans record while tracing is on (`set_tracing(True)`);
otherwise `span()` returns one shared no-op context that reads no clock and
takes no lock. At most SPAN_CAP records are kept between two takes, and
`dropped()` counts the rest. `profiler_trace` turns tracing on and writes
the spans beside the profiler's events.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# In-memory spans
# ---------------------------------------------------------------------------

SPAN_CAP = 1 << 20  # records kept between two take_spans()


class Span(NamedTuple):
    """One finished span."""

    name: str
    start_ns: int  # time.time_ns() at entry
    end_ns: int  # time.time_ns() at exit
    span_id: int
    parent_id: int | None  # the span open on this thread at entry
    request_id: int | None  # the root's, inherited from the parent
    thread_id: int  # threading.get_native_id()
    attrs: dict | None


_on = False
# (name, start_ns, end_ns, thread_id, request_id, attrs) of each finished
# span, in the order they ended; the rest of a Span is worked out in
# take_spans(), off the path a traced call takes.
_records: list[tuple] = []
_dropped = 0
_dropped_lock = threading.Lock()
_span_ids = itertools.count(1)


class _Thread(threading.local):
    """The thread's native id, read once a thread: it is a system call."""

    def __init__(self):
        self.id = threading.get_native_id()


_thread = _Thread()


def set_tracing(on: bool) -> None:
    """Record spans from now on (True) or stop (False, the default)."""
    global _on
    _on = bool(on)


def tracing() -> bool:
    """Whether `span()` records now."""
    return _on


def _keep(fields: tuple) -> None:
    global _dropped
    # list.append is atomic: no lock on the path every span takes; at the
    # cap, threads that race may each keep one more.
    if len(_records) < SPAN_CAP:
        _records.append(fields)
    else:
        with _dropped_lock:
            _dropped += 1


def take_spans() -> list[Span]:
    """The spans finished since the last take, in the order they ended;
    clears them and the count of dropped ones. A span that ends during the
    take lands in this take or the next; one whose parent is still open
    has no parent."""
    global _dropped
    out = _records[:]
    del _records[: len(out)]
    with _dropped_lock:
        _dropped = 0
    ids = [next(_span_ids) for _ in out]
    parent, request = [None] * len(out), [r[4] for r in out]
    # Per thread, by start (an enclosing span first: it ends later, or at
    # the same time and after its child), the enclosing spans on a stack.
    order = sorted(range(len(out)),
                   key=lambda i: (out[i][3], out[i][1], -out[i][2], -i))
    stack: list[int] = []
    for i in order:
        name, start, end, thread, rid, _ = out[i]
        while stack and not (out[stack[-1]][3] == thread
                             and start >= out[stack[-1]][1]
                             and end <= out[stack[-1]][2]):
            stack.pop()
        if stack and rid is None:
            parent[i] = ids[stack[-1]]
            request[i] = request[stack[-1]]
        stack.append(i)
    return [Span(r[0], r[1], r[2], ids[i], parent[i], request[i], r[3], r[5])
            for i, r in enumerate(out)]


def dropped() -> int:
    """Spans finished since the last take but not kept (beyond SPAN_CAP)."""
    return _dropped


class _NoSpan:
    """The context `span()` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs) -> None:
        pass


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "attrs", "request_id", "start_ns")

    def __init__(self, name: str, attrs: dict, request_id=None):
        self.name, self.attrs, self.request_id = name, attrs, request_id

    def __enter__(self):
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        _keep((self.name, self.start_ns, time.time_ns(), _thread.id,
               self.request_id, self.attrs or None))
        return False

    def note(self, **attrs) -> None:
        """Add attributes to the span while it is open."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """`with span("graph.pad"):` records the body as one span (see the
    module's docstring); `note(**attrs)` on the context adds attributes."""
    if not _on:
        return _NO_SPAN
    return _OpenSpan(name, attrs)


def request(request_id: int):
    """A root span `service.request` that carries `request_id`, whatever
    is open on this thread; the spans inside it inherit the id."""
    if not _on:
        return _NO_SPAN
    return _OpenSpan("service.request", {}, request_id)


def traced(name: str):
    """Decorator: every call of the function is one span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            start = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                _keep((name, start, time.time_ns(), _thread.id, None, None))

        return call

    return wrap


def _cuda_devices(tree) -> set[torch.device]:
    """The CUDA devices of the tensors in a tree of tensors (dicts, lists,
    tuples)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return set()
    return set().union(*map(_cuda_devices, tree))


def _host(x) -> np.ndarray:
    """An array, or a tensor on the host (bf16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


@dataclass
class StageTimer:
    """Named stage wall-clock timing with device sync, printf-style report."""

    stages: dict[str, float] = field(default_factory=dict)
    verbose: bool = True

    @contextlib.contextmanager
    def stage(self, name: str, sync: object = None):
        """Time the body; where `sync` is a CUDA tensor or a tree of them,
        wait for each of their devices before reading the clock, so the
        stage holds the work it queued there."""
        devices = _cuda_devices(sync)
        with span(name):
            t0 = time.perf_counter()
            yield
            for dev in devices:
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        if self.verbose:
            print(f"{name} takes {dt:.6f} sec")

    def report(self) -> dict[str, float]:
        return dict(self.stages)


TRACE_FILE = "trace.json"
# The chrome trace's process of the port's spans, a track of its own beside
# the profiler's CPU process and its devices.
SPAN_PID = 1 << 30


def span_events(spans: list[Span], base_ns: int = 0) -> list[dict]:
    """Spans as chrome-trace complete events ("X", microseconds from
    `base_ns`) on the SPAN_PID track, one thread row per host thread."""
    events = [{"ph": "M", "name": "process_name", "pid": SPAN_PID, "tid": 0,
               "args": {"name": "spleeterrt_tpu_torch spans"}}]
    for s in spans:
        args = {"span_id": s.span_id, "parent_id": s.parent_id,
                "request_id": s.request_id, **(s.attrs or {})}
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": SPAN_PID,
            "tid": s.thread_id, "ts": (s.start_ns - base_ns) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": args,
        })
    return events


@contextlib.contextmanager
def profiler_trace(log_dir: str | os.PathLike | None):
    """Scoped torch.profiler trace written as a chrome trace to
    `log_dir`/trace.json: CPU activity always, CUDA activity where a card
    is present, and the port's spans of the scope (tracing is on inside
    it) on a track of their own, aligned by the trace's base time; a no-op
    when log_dir is None."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was_on = _on
    set_tracing(True)
    try:
        t0 = time.time_ns()
        with torch.profiler.profile(activities=acts) as prof:
            yield
    finally:
        set_tracing(was_on)
    spans = [s for s in take_spans() if s.start_ns >= t0]
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(
        span_events(spans, int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)


def write_gray_png(path: str, img) -> None:
    """Minimal 8-bit grayscale PNG writer (no deps); `img` is an array or a
    tensor of shape (h, w)."""
    img = _host(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def dump_spectrogram_pngs(x, folder: str, lin_gain: float = 10.0) -> list[str]:
    """Per-channel magnitude/mask plane dumps, the debug instrument of
    `writeNChannelsImg2Folder` (VST/Source/Spleeter4Stems.c:220-256); `x`
    is an array or a tensor of shape (channels, h, w)."""
    os.makedirs(folder, exist_ok=True)
    x = _host(x)
    paths = []
    for s in range(x.shape[0]):
        img = np.abs(x[s]) * lin_gain
        p = f"{folder}/{s}.png"
        write_gray_png(p, img)
        paths.append(p)
    return paths
