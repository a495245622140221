"""Minimal separation service: an HTTP control plane over the port's graphs.

The port of spleeterrt_tpu/runtime/server.py, with the same contract: POST
audio, receive separated stems. Compute runs through the same graphs as
the CLI, on one device (`--device`, default `cuda`; a missing card is an
error, never a silent switch to the CPU); the host side only decodes and
encodes audio.

Endpoints:
- GET  /healthz            -> {"status": "ok", "devices": N}, N the
                              devices of the service's device type
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

Failure contract: malformed input (bad codec bytes, bad params, wrong
shapes) -> 400; oversized body -> 413; unknown path -> 404; internal
faults -> 500 with a generic message (the trace goes to the server's log,
not the client).

Run: python -m spleeterrt_tpu_torch.runtime.server --port 8080 --random-weights
(add --device cpu to serve from the kernels' plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import io
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

# Errors attributable to the request body or params (-> HTTP 400): the
# reference package's, plus a batch body that is not a zip archive, which
# it answers with 500. Everything else is an internal fault (-> HTTP 500).
CLIENT_ERRORS = (ValueError, KeyError, EOFError, struct.error, _zlib_error,
                 zipfile.BadZipFile)


def device_count(device: torch.device) -> int:
    """Devices of `device`'s type on this host."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1


class SeparationService:
    """Holds the nets, the config and the device; separation is serialised
    by a lock, because the kernels' launch-count registry and the device's
    one stream are shared by every request."""

    def __init__(self, cfg, weight_kwargs: dict, max_body_bytes: int = 1 << 28,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.weight_kwargs = weight_kwargs
        self.max_body_bytes = max_body_bytes
        self.device = torch.device(device)
        self._lock = threading.Lock()

    def separate_wav(self, wav_bytes: bytes, num_stems: int | None = None):
        """One WAV -> {stem: (2, n) float32} through `separate.separate`."""
        cfg = self.cfg
        if num_stems and num_stems != cfg.num_stems:
            raise ValueError(f"this server separates into {cfg.num_stems} "
                             f"stems, not {num_stems}")
        data = audio_io.read_wav(wav_bytes)
        x = data.samples
        if data.sample_rate != 44100:
            x = resample.resample(x, data.sample_rate, 44100)
        if x.shape[0] == 1:
            x = np.repeat(x, 2, axis=0)
        with self._lock:
            stems = separate.separate(x[:2], cfg=cfg, device=self.device,
                                      **self.weight_kwargs)
            return {k: v.cpu().numpy() for k, v in stems.items()}

    def separate_batch(self, npz_bytes: bytes) -> dict[str, np.ndarray]:
        """All tracks of an NPZ body as one batch -> {"{track}/{stem}": (2,
        n_track) float32}. Only the stacked N-stem graphs (4/5 stems) have
        a batch endpoint, as in the reference package."""
        stacked = self.weight_kwargs.get("stacked_params")
        if stacked is None:
            raise ValueError(
                f"batch endpoint requires a 4/5-stem server (got "
                f"{self.cfg.num_stems}-stem weights)"
            )
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
        lengths = {k: v.shape[-1] for k, v in tracks.items()}
        n_max = max(lengths.values())
        batch = np.stack(
            [np.pad(v, ((0, 0), (0, n_max - v.shape[-1]))) for v in tracks.values()]
        )
        cfg = self.cfg
        preshift, _ = transform.offline_pad_sizes(n_max, cfg.transform)
        out_band = separate.OUT_BAND_4 if cfg.num_stems == 4 else separate.OUT_BAND_5
        with self._lock:
            padded = transform.pad_offline(
                torch.from_numpy(batch).to(self.device), cfg.transform
            ).contiguous()
            out = separate.separate_nstem_batch(stacked, padded, cfg, out_band)
            result = {
                f"{name}/{stem}": out[i, s, :, preshift : preshift + lengths[name]]
                .cpu().numpy()
                for i, name in enumerate(tracks)
                for s, stem in enumerate(cfg.stem_names)
            }
        return result


def _make_handler(service: SeparationService):
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

        def do_GET(self):
            if self.path.startswith("/healthz"):
                body = json.dumps({"status": "ok",
                                   "devices": device_count(service.device)})
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
            # The body is read before any answer but 413, so that a client
            # still sending it sees the answer and not a reset connection.
            body = self._read_body()
            if body is None:
                return
            parsed = urlparse(self.path)
            if parsed.path == "/separate_batch":
                out = self._run(service.separate_batch, body)
                if out is not None:
                    self._send(200, _npz(out), "application/octet-stream")
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
                self._send(200, _npz(stems), "application/octet-stream")
                return
            self._send(200, _wav(np.concatenate(list(stems.values()))), "audio/wav",
                       [("X-Stem-Order", ",".join(stems))])

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
    weight_kwargs = cli.load_weights(args.weights, args.random_weights,
                                     args.seed, cfg, device)
    service = SeparationService(cfg, weight_kwargs,
                                max_body_bytes=args.max_body_mb << 20,
                                device=device)
    srv = make_server(args.host, args.port, service)
    print(f"serving on http://{args.host}:{srv.server_address[1]} ({device})")
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
