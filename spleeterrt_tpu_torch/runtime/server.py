"""Minimal separation service: an HTTP control plane over the port's graphs.

The port of spleeterrt_tpu/runtime/server.py, with the same contract: POST
audio, receive separated stems. Compute runs through the same graphs as
the CLI, on one device (`--device`, default `cuda`; a missing card is an
error, never a silent switch to the CPU); the host side only decodes and
encodes audio.

Endpoints:
- GET  /healthz            -> {"status": "ok", "devices": N}, N the
                              devices of the service's device type, or
                              the ranks' cards under torchrun
- POST /separate           -> WAV body in; multichannel WAV out
                              (stem-major channel pairs, fs 44100, the
                              order in the X-Stem-Order header)
  Query params: stems (the server's stem count, default), format
                (wav8ch | npz)
- POST /separate_batch     -> NPZ body of float32 tracks (each (2, n) or
                              (n,) at 44.1 kHz) in; NPZ of "{track}/{stem}"
                              arrays out. The tracks are zero-padded to the
                              longest and run as one batch through
                              `separate_nstem_batch` (one K1, one U-Net
                              pass, one K7 at hop 1024), then cropped back
                              to their lengths. 4- and 5-stem servers only.

Over ranks: started by torchrun (`torchrun --nproc-per-node N -m
spleeterrt_tpu_torch.runtime.server ...`), every rank brings up the
process group (parallel/distributed.py), binds its card and builds the same
service with the same weights; rank 0 alone binds the HTTP port. For each
/separate_batch, rank 0 broadcasts a header (an op code and the padded
batch's shape), then the padded tracks, and every rank runs
`parallel.mesh.separate_batch_sharded` on its share of the tracks (the
reference package's `separate_batch_sharded` dispatch over its local
devices); rank 0 crops the result and answers. The other ranks wait in
`serve_rank_loop`; when rank 0 stops serving it broadcasts the stop op
code and every rank leaves the group. /separate stays on rank 0. A request
refused with 400 starts no collective, and the lock orders dispatches, so
every rank sees the collectives in the same order.

Spans (utils/timing.py; recorded while tracing is on): each POST is a root `service.request` carrying a request id,
from the handler's entry to the last byte written, around
`service.read_body`; `service.parse` (WAV read, resample, mono -> stereo;
the NPZ tracks and their padding for /separate_batch);
`service.lock_wait` (attribute `waiting`: the requests at the lock,
this one among them) and `service.locked`, which holds `graph.separate`
(`graph.separate_batch`) and `service.to_host`, the stems' copy to host
arrays; then `service.encode` (the WAV or NPZ answer) and
`service.write`.

Failure contract: malformed input (bad codec bytes, bad params, wrong
shapes) -> 400; oversized body -> 413; unknown path -> 404; internal
faults -> 500 with a generic message (the trace goes to the server's log,
not the client).

Run: python -m spleeterrt_tpu_torch.runtime.server --port 8080 --random-weights
(add --device cpu to serve from the kernels' plain versions on the CPU);
under torchrun as above to spread /separate_batch over N cards.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import struct
import threading
import traceback
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse
from zlib import error as _zlib_error

import numpy as np
import torch

from spleeterrt_tpu_torch.core import separate, transform
from spleeterrt_tpu_torch.io import audio as audio_io, resample
from spleeterrt_tpu_torch.parallel import distributed
from spleeterrt_tpu_torch.parallel import mesh as pmesh
from spleeterrt_tpu_torch.utils.timing import request, span, tracing

# Errors attributable to the request body or params (-> HTTP 400): the
# reference package's, plus a batch body that is not a zip archive, which
# it answers with 500. Everything else is an internal fault (-> HTTP 500).
CLIENT_ERRORS = (ValueError, KeyError, EOFError, struct.error, _zlib_error,
                 zipfile.BadZipFile)


# The ranked /separate_batch's op codes, the first word of the header rank
# 0 broadcasts: [op, B, 2, n] for a batch of B padded (2, n) tracks.
OP_STOP, OP_BATCH = 0, 1


def device_count(device: torch.device) -> int:
    """Devices of `device`'s type on this host."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1


class SeparationService:
    """Holds the nets, the config and the device; separation is serialised
    by a lock, because the kernels' launch-count registry and the device's
    one stream are shared by every request, and so that every rank sees
    the ranked batches' collectives in one order.

    `mesh`, a (stem, data) mesh over every rank of the process group
    (`parallel.mesh.make_mesh(1)`), makes /separate_batch a collective
    over the ranks; without it the service runs on its one device."""

    def __init__(self, cfg, weight_kwargs: dict, max_body_bytes: int = 1 << 28,
                 device: torch.device | str = "cuda", mesh=None):
        self.cfg = cfg
        self.weight_kwargs = weight_kwargs
        self.max_body_bytes = max_body_bytes
        self.device = torch.device(device)
        self.mesh = mesh
        self._lock = threading.Lock()
        self._at_lock = 0  # traced requests waiting for or holding the lock
        self._count_lock = threading.Lock()

    def devices(self) -> int:
        """/healthz's device count: the ranks' cards, or this host's
        devices of the service's type."""
        if self.mesh is not None:
            return self.mesh.size()
        return device_count(self.device)

    @contextlib.contextmanager
    def _locked(self):
        """Hold the service's lock over the body. Traced, the wait is the
        span `service.lock_wait` (attribute `waiting`: the traced requests
        waiting for or holding the lock at entry, this one among them), the
        hold `service.locked`."""
        if not tracing():
            with self._lock:
                yield
            return
        with self._count_lock:
            self._at_lock += 1
            waiting = self._at_lock
        try:
            with span("service.lock_wait", waiting=waiting):
                self._lock.acquire()
            try:
                with span("service.locked"):
                    yield
            finally:
                self._lock.release()
        finally:
            with self._count_lock:
                self._at_lock -= 1

    def separate_wav(self, wav_bytes: bytes, num_stems: int | None = None):
        """One WAV -> {stem: (2, n) float32} through `separate.separate`."""
        cfg = self.cfg
        if num_stems and num_stems != cfg.num_stems:
            raise ValueError(f"this server separates into {cfg.num_stems} "
                             f"stems, not {num_stems}")
        with span("service.parse"):
            data = audio_io.read_wav(wav_bytes)
            x = data.samples
            if data.sample_rate != 44100:
                x = resample.resample(x, data.sample_rate, 44100)
            if x.shape[0] == 1:
                x = np.repeat(x, 2, axis=0)
        with self._locked():
            stems = separate.separate(x[:2], cfg=cfg, device=self.device,
                                      **self.weight_kwargs)
            with span("service.to_host"):
                return {k: v.cpu().numpy() for k, v in stems.items()}

    def _stacked(self):
        stacked = self.weight_kwargs.get("stacked_params")
        if stacked is None:
            raise ValueError(
                f"batch endpoint requires a 4/5-stem server (got "
                f"{self.cfg.num_stems}-stem weights)"
            )
        return stacked

    def _batch(self, padded: torch.Tensor) -> torch.Tensor:
        """(B, S, 2, out_len) stems of the padded tracks: one batch dispatch
        on this device, or under a mesh the sharded batch over every rank,
        after the header and the tracks went out to the other ranks."""
        stacked, cfg = self._stacked(), self.cfg
        if self.mesh is None:
            out_band = (separate.OUT_BAND_4 if cfg.num_stems == 4
                        else separate.OUT_BAND_5)
            return separate.separate_nstem_batch(stacked, padded, cfg, out_band)
        header = torch.tensor([OP_BATCH, *padded.shape], dtype=torch.int64,
                              device=self.device)
        distributed.broadcast_(header, 0)
        distributed.broadcast_(padded, 0)
        return pmesh.separate_batch_sharded(stacked, padded, cfg, self.mesh)

    def separate_batch(self, npz_bytes: bytes) -> dict[str, np.ndarray]:
        """All tracks of an NPZ body as one batch -> {"{track}/{stem}": (2,
        n_track) float32}. Only the stacked N-stem graphs (4/5 stems) have
        a batch endpoint, as in the reference package. The body is checked
        before any collective starts."""
        self._stacked()
        with span("service.parse"):
            tracks = _npz_tracks(npz_bytes)
            lengths = {k: v.shape[-1] for k, v in tracks.items()}
            n_max = max(lengths.values())
            batch = np.stack([np.pad(v, ((0, 0), (0, n_max - v.shape[-1])))
                              for v in tracks.values()])
        cfg = self.cfg
        preshift, _ = transform.offline_pad_sizes(n_max, cfg.transform)
        with self._locked():
            padded = transform.pad_offline(
                torch.from_numpy(batch).to(self.device), cfg.transform
            ).contiguous()
            out = self._batch(padded)
            with span("service.to_host"):
                return {
                    f"{name}/{stem}": out[i, s, :, preshift : preshift + lengths[name]]
                    .cpu().numpy()
                    for i, name in enumerate(tracks)
                    for s, stem in enumerate(cfg.stem_names)
                }

    def stop_ranks(self) -> None:
        """Rank 0: send the other ranks the stop op code (a no-op without a
        mesh)."""
        if self.mesh is None:
            return
        with self._lock:
            distributed.broadcast_(torch.tensor(
                [OP_STOP, 0, 0, 0], dtype=torch.int64, device=self.device), 0)


def _npz_tracks(npz_bytes: bytes) -> dict[str, np.ndarray]:
    """The tracks of an NPZ body, each (2, n) float32 ((n,) and (1, n)
    doubled to stereo); ValueError for no track or another shape."""
    with np.load(io.BytesIO(npz_bytes), allow_pickle=False) as z:
        names = list(z.files)
        if not names:
            raise ValueError("empty NPZ: no tracks")
        tracks = {}
        for name in names:
            x = np.asarray(z[name], np.float32)
            if x.ndim == 1:
                x = np.stack([x, x])
            if x.ndim != 2 or x.shape[0] not in (1, 2):
                raise ValueError(
                    f"track {name!r}: expected (2, n) or (n,), got {x.shape}"
                )
            if x.shape[0] == 1:
                x = np.repeat(x, 2, axis=0)
            tracks[name] = x
    return tracks


def serve_rank_loop(service: SeparationService) -> int:
    """A rank other than 0: run each batch rank 0 broadcasts through
    `parallel.mesh.separate_batch_sharded` with the service's nets, until
    the stop op code; returns the number of batches run."""
    stacked, dev = service._stacked(), service.device
    batches = 0
    while True:
        header = torch.empty(4, dtype=torch.int64, device=dev)
        distributed.broadcast_(header, 0)
        op, *shape = header.tolist()
        if op == OP_STOP:
            return batches
        if op != OP_BATCH:
            raise RuntimeError(f"unknown op code {op} from rank 0")
        tracks = torch.empty(shape, dtype=torch.float32, device=dev)
        distributed.broadcast_(tracks, 0)
        pmesh.separate_batch_sharded(stacked, tracks, service.cfg, service.mesh)
        batches += 1


def serve(srv, service: SeparationService) -> None:
    """Rank 0 (or the one process): serve until `serve_forever` ends (by
    `srv.shutdown()` or an interrupt), then stop the other ranks."""
    try:
        srv.serve_forever()
    finally:
        service.stop_ranks()


def _make_handler(service: SeparationService):
    request_ids = itertools.count(1)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet test runs
            pass

        def _send(self, code: int, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for key, value in headers:
                self.send_header(key, value)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _answer(self, encode, ctype: str, headers=()):
            """200 with the body `encode()` makes."""
            with span("service.encode"):
                body = encode()
            with span("service.write"):
                self._send(200, body, ctype, headers)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                body = json.dumps({"status": "ok",
                                   "devices": service.devices()})
                self._send(200, body.encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def _read_body(self) -> bytes | None:
            length = int(self.headers.get("Content-Length", 0))
            if length > service.max_body_bytes:
                self._send(
                    413,
                    f"body {length} B exceeds cap {service.max_body_bytes} B".encode(),
                    "text/plain",
                )
                return None
            return self.rfile.read(length)

        def _run(self, fn, *args):
            """fn(*args), or None after answering 400 (the client's error)
            or 500 (ours: the trace goes to the log)."""
            try:
                return fn(*args)
            except CLIENT_ERRORS as e:
                self._send(400, str(e).encode(), "text/plain")
            except Exception:
                traceback.print_exc()
                self._send(500, b"internal separation error", "text/plain")
            return None

        def do_POST(self):
            with request(next(request_ids)):
                self._post()

        def _post(self):
            # The body is read before any answer but 413, so that a client
            # still sending it sees the answer and not a reset connection.
            with span("service.read_body"):
                body = self._read_body()
            if body is None:
                return
            parsed = urlparse(self.path)
            if parsed.path == "/separate_batch":
                out = self._run(service.separate_batch, body)
                if out is not None:
                    self._answer(lambda: _npz(out), "application/octet-stream")
                return
            if parsed.path != "/separate":
                self._send(404, b"not found", "text/plain")
                return
            q = parse_qs(parsed.query)
            try:
                stems_n = int(q.get("stems", [0])[0]) or None
            except ValueError:
                self._send(400, b"stems must be an integer", "text/plain")
                return
            fmt = q.get("format", ["wav8ch"])[0]
            if fmt not in ("wav8ch", "npz"):
                self._send(400, b"format must be wav8ch or npz", "text/plain")
                return
            stems = self._run(service.separate_wav, body, stems_n)
            if stems is None:
                return
            if fmt == "npz":
                self._answer(lambda: _npz(stems), "application/octet-stream")
                return
            self._answer(lambda: _wav(np.concatenate(list(stems.values()))),
                         "audio/wav", [("X-Stem-Order", ",".join(stems))])

    return Handler


def _npz(arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _wav(samples: np.ndarray) -> bytes:
    """(channels, n) float32 -> the bytes `audio_io.write_wav` writes."""
    buf = io.BytesIO()
    audio_io.write_wav(buf, samples, 44100)
    return buf.getvalue()


def make_server(host: str, port: int, service: SeparationService):
    return ThreadingHTTPServer((host, port), _make_handler(service))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="spleeterrt-tpu-torch-server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--stems", type=int, default=4, choices=(2, 3, 4, 5))
    ap.add_argument("--time-step", type=int, default=256)
    ap.add_argument("--bin-limit", type=int, default=1536)
    ap.add_argument("--weights", default=None,
                    help="weights source, by the CLI's rules (cli.load_weights)")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to separate on (default cuda)")
    ap.add_argument(
        "--max-body-mb", type=int, default=256,
        help="reject request bodies larger than this (HTTP 413)",
    )
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from spleeterrt_tpu_torch import cli
    from spleeterrt_tpu_torch.config import SeparatorConfig

    cfg = SeparatorConfig(
        bin_limit=args.bin_limit // 64 * 64,
        time_step=max(64, args.time_step // 64 * 64),
        num_stems=args.stems,
        compute_dtype=torch.bfloat16,
    )
    device = cli.open_device(args.device)
    ranked = distributed.launched()
    if ranked:
        device = distributed.initialize(device.type)
    try:
        weight_kwargs = cli.load_weights(args.weights, args.random_weights,
                                         args.seed, cfg, device)
        service = SeparationService(
            cfg, weight_kwargs, max_body_bytes=args.max_body_mb << 20,
            device=device, mesh=pmesh.make_mesh(1) if ranked else None)
        if not distributed.is_coordinator():
            serve_rank_loop(service)
            return 0
        srv = make_server(args.host, args.port, service)
        print(f"serving on http://{args.host}:{srv.server_address[1]} ({device}"
              + (f", {service.devices()} ranks" if ranked else "") + ")")
        serve(srv, service)
    finally:
        if ranked:
            distributed.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
