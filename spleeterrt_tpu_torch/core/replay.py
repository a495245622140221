"""A repeated offline call replayed as one captured CUDA graph.

An offline Spleeter call on the card (core/separate.py::separate) is some
forty launches: K1, the packed U-Net's kernels with the mid trunk's cuDNN
convolutions between them, K7, the crop and the residual. Enqueued one by
one from Python they cost the host about as long as the card takes to run
them. Calls that repeat a key (the same tile count, configuration and
weights) make the same launches on the same addresses, so the key's
second call captures them into one `torch.cuda.CUDAGraph` and every later
call replays it.

A call is split in two: a `front` that the graph holds (K1 and the nets;
for 2 stems K7 too) and a `back` that runs after each replay and writes
the caller's stems into memory of its own (K7, or 2 stems' vocals and
residual). The graph's memory is overwritten by the next replay; the
stems are not, and are written once, not copied out of the graph. The
graph reads one input buffer, the padded audio at the longest length of
the key's tile count (separate.py, `_graph_size`): a replay writes the
call's audio into it (`load`), launches the graph, and runs the back.

The key (`call_key`) is everything that fixes the launches and their
addresses: the configuration and the graph input's shape (`fixed`), the
device, the address, shape and dtype of every weight tensor, and cuDNN's
and TF32's flags. A graph reads its weights where they were at capture,
so weights changed in place (an optimiser step) are seen by the next
replay. A key holds weak references to its weights' storages: once they
are freed, new weights that land on the same addresses start over from an
eager call.

`CallGraphs.run` is the policy. A key's first call runs eager; its second
captures the front (a warm-up on a side stream, then `torch.cuda.graph`
with `capture_error_mode="thread_local"`, so that work on other threads
does not break the capture) and replays it; later calls replay. A key
captures once at most: a capture that raises, or a graph that is evicted,
leaves its key eager for good, so a mix of more keys than MAX_GRAPHS never
captures over and over. At most MAX_GRAPHS graphs are kept, least
recently used out first, in one memory pool a device: graphs share their
scratch memory, so a replay and its back are enqueued under one lock, and
replays run on the device's default stream (`separate` sends calls from
other streams down the eager path).

`counts()` gives this process's calls by mode: `eager`, `capture` (calls
that captured, then replayed), `replay`, and `fallback` (calls whose
capture raised and that then ran eager).
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from spleeterrt_tpu_torch.utils.timing import span

# Graphs kept, least recently used out first: the uploads of the
# benchmark's http-clips traffic (five clip lengths, five tile counts) all
# fit; eight 300 s 4-stem graphs hold about 9 GB of outputs and inputs.
MAX_GRAPHS = 8
MAX_KEYS = 64  # keys remembered as seen once, or as eager for good

MODES = ("eager", "capture", "replay", "fallback")
_counts = dict.fromkeys(MODES, 0)


def count(mode: str) -> None:
    _counts[mode] += 1


def counts() -> dict[str, int]:
    return dict(_counts)


def reset_counts() -> None:
    for mode in _counts:
        _counts[mode] = 0


def call_key(device: torch.device, weights: list[torch.Tensor], fixed) -> tuple:
    """The key of a call on `device` with `weights`; `fixed` (hashable)
    holds the caller's configuration, switches and the graph input's
    shape."""
    cudnn = torch.backends.cudnn
    return (fixed, device,
            tuple([(t.data_ptr(), t.shape, t.dtype) for t in weights]),
            (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
             cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))


class Captured(NamedTuple):
    """What a capturer returns: `replay()` reruns the captured front,
    which reads its input buffer and writes `out` (tensors in memory the
    graph owns)."""

    replay: Callable[[], None]
    out: object


_side_streams: dict[torch.device, torch.cuda.Stream] = {}
_pools: dict[torch.device, tuple] = {}


def capture_cuda(front: Callable, static_in: torch.Tensor) -> Captured:
    """`front(static_in)` captured as a CUDA graph in its device's pool."""
    dev = static_in.device
    if dev not in _side_streams:
        _side_streams[dev] = torch.cuda.Stream(dev)
    side = _side_streams[dev]
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        front(static_in)  # warm-up: lazy initialisation happens off the graph
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev):
        if dev not in _pools:
            _pools[dev] = torch.cuda.graph_pool_handle()
        # torch.cuda.graph synchronises the device before it captures, so
        # no replay of a graph this capture evicts is still running.
        with torch.cuda.graph(graph, pool=_pools[dev], stream=side,
                              capture_error_mode="thread_local"):
            out = front(static_in)
    return Captured(graph.replay, out)


class _Entry(NamedTuple):
    """What a key keeps: its weights' storages, weakly, and its graph (None
    while seen once, or once the key is eager for good)."""

    storages: tuple
    graph: tuple | None  # (static input, Captured)
    eager: bool = False  # for good: its capture raised or its graph went


def _storage_refs(weights: list[torch.Tensor]) -> tuple:
    found = {}
    for t in weights:
        s = t.untyped_storage()
        found.setdefault(id(s), s)
    return tuple(weakref.ref(s) for s in found.values())


class CallGraphs:
    """The policy of the module's docstring over one process's calls;
    `capture` (default `capture_cuda`) turns a front and its input buffer
    into a `Captured`."""

    def __init__(self, capture=capture_cuda, max_graphs: int = MAX_GRAPHS):
        self._capture = capture
        self._max_graphs = max_graphs
        self._graphs: OrderedDict = OrderedDict()  # key -> _Entry with a graph
        self._keys: OrderedDict = OrderedDict()  # key -> _Entry without one
        self._lock = threading.Lock()

    def run(self, key, weights: list[torch.Tensor], front: Callable,
            back: Callable, eager_in: Callable, load: Callable) -> tuple[str, object]:
        """(mode, `back(front(x), x)`) for a call of `key`: `front` runs
        eager on `x = eager_in()`, or is captured or replayed as the
        module's docstring says on a graph's own input `x`, which
        `load(x)` fills with the call's (`load(None)` makes a new one);
        `back` reads front's outputs and writes new memory, which no later
        replay overwrites."""
        with self._lock:
            entry = self._live(self._graphs, key)
            if entry is not None:
                self._graphs.move_to_end(key)
                return "replay", back(_replay(entry.graph, load), entry.graph[0])
            entry = self._live(self._keys, key)
            if entry is None:
                self._remember(key, _Entry(_storage_refs(weights), None))
                mode = "eager"
            elif entry.eager:
                self._keys.move_to_end(key)
                mode = "eager"
            else:
                del self._keys[key]
                static_in = load(None)
                try:
                    captured = self._capture(front, static_in)
                except Exception:
                    self._remember(key, entry._replace(eager=True))
                    mode = "fallback"
                else:
                    graph = (static_in, captured)
                    self._keep(key, entry._replace(graph=graph))
                    return "capture", back(_replay(graph, load), static_in)
        x = eager_in()
        return mode, back(front(x), x)

    def _remember(self, key, entry: _Entry) -> None:
        """A key without a graph, put last; past MAX_KEYS the least
        recently used one is forgotten."""
        self._keys[key] = entry
        self._keys.move_to_end(key)
        if len(self._keys) > MAX_KEYS:
            self._keys.popitem(last=False)

    def _keep(self, key, entry: _Entry) -> None:
        """A key's new graph; past the bound the least recently used graph
        goes and its key stays eager (it captured once)."""
        self._graphs[key] = entry
        if len(self._graphs) > self._max_graphs:
            old_key, old = self._graphs.popitem(last=False)
            self._remember(old_key, old._replace(graph=None, eager=True))

    @staticmethod
    def _live(table: OrderedDict, key):
        """The entry of `key` if its weights are all alive; a dead one goes
        (after its last replay, whose memory the pool hands on)."""
        entry = table.get(key)
        if entry is not None and any(r() is None for r in entry.storages):
            del table[key]
            if entry.graph is not None and entry.graph[0].is_cuda:
                torch.cuda.synchronize(entry.graph[0].device)
            return None
        return entry


def _replay(graph: tuple, load: Callable):
    """Load the call into the graph's input and launch it -> its outputs."""
    static_in, captured = graph
    with span("graph.replay"):
        load(static_in)
        captured.replay()
    return captured.out


GRAPHS = CallGraphs()
