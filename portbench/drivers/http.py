"""Clips over HTTP, an open loop: `POST /separate?format=wav8ch` to the
program's `runtime/server.py` (`make_server` on 127.0.0.1, port 0, served
from a thread of this process and stopped before the run ends), sent by
`portbench/loadgen.py` in a child process on a schedule fixed before the
window.

The bodies are 16-bit stereo WAV clips made from the seed, `clips_per_length`
of each length in `clip_seconds`; only those shapes are warmed up.
Arrivals are Poisson at `rate` requests a second (above the rate the
service answers, so the audio answered a second is the service's rate)
and the lengths come in equal numbers; the path of arrivals and the order of lengths are drawn
from `arrival_seed` alone, so that every seed offers the same work, and
the run's seed draws the audio and the weights. The window runs from "go"
to the last byte of the last answer, by the generator's monotonic clock;
handing the kept answers back to this process is not in it. Parameters
also: `check_samples` (answers
kept: the first 30 s one and others drawn from the seed), `trace_seconds`.
"""

from __future__ import annotations

import http.client
import itertools
import multiprocessing
import random
import struct
import sys
import threading
import time

import numpy as np
import torch

from portbench import inputs, loadgen
from portbench.drivers import (
    CHECKS, NOT_FINITE, SAMPLE_RATE, Window, merge_worst, require_spleeter, stem_errors,
)
from portbench.families.spleeter import make_weights, net_kwargs, net_list, program_config

JOIN_TIMEOUT_S = 600.0
SMALL = {"clip_seconds": [2, 3], "clips_per_length": 1, "rate": 2.0, "check_samples": 2}


def wav16(samples: np.ndarray) -> bytes:
    """(channels, n) int16 -> a 16-bit PCM WAV file at 44.1 kHz."""
    c, _ = samples.shape
    data = np.ascontiguousarray(samples.T).astype("<i2").tobytes()
    return struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE",
                       b"fmt ", 16, 1, c, SAMPLE_RATE, SAMPLE_RATE * 2 * c, 2 * c,
                       16, b"data", len(data)) + data


def parse_wav_f32(body: bytes) -> np.ndarray:
    """A 32-bit float WAV -> (channels, n) float32; ValueError otherwise."""
    if body[:4] != b"RIFF" or body[8:12] != b"WAVE":
        raise ValueError("not a WAV body")
    pos, fmt = 12, None
    while pos + 8 <= len(body):
        cid, size = struct.unpack_from("<4sI", body, pos)
        payload = body[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", payload)
        elif cid == b"data":
            if fmt is None or fmt[0] != 3 or fmt[5] != 32:
                raise ValueError(f"not 32-bit float: {fmt}")
            x = np.frombuffer(payload, "<f4")
            return x[: x.size // fmt[1] * fmt[1]].reshape(-1, fmt[1]).T
        pos += 8 + size + size % 2
    raise ValueError("no data chunk")


class Driver:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cfg, self.p, self.dev, self.seed = cell.config, cell.params, device, seed
        self.audio_per_unit = None
        self.server = None

    def setup(self) -> None:
        require_spleeter(self.cfg, "http")
        from spleeterrt_tpu_torch.runtime import server

        gen = torch.Generator(self.dev).manual_seed(self.seed)
        self.nets = make_weights(self.cfg, gen, self.dev)
        self.clips, self.bodies, self.lengths = [], [], []
        for sec, _ in itertools.product(self.p["clip_seconds"],
                                        range(self.p["clips_per_length"])):
            x = inputs.tones_plus_noise(1, round(sec * SAMPLE_RATE), gen, self.dev)[0]
            pcm = torch.round(x.clamp(-1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
            self.bodies.append(wav16(pcm))
            self.clips.append(torch.from_numpy(pcm.astype(np.float32) / 32768.0))
            self.lengths.append(sec)
        self.service = _timed_service(server.SeparationService)(
            program_config(self.cfg), net_kwargs(self.cfg, self.nets),
            device=self.dev)
        self.server = server.make_server("127.0.0.1", 0, self.service)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.port = self.server.server_address[1]
        t0 = time.perf_counter()
        for sec in self.p["clip_seconds"]:
            c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
            c.request("POST", "/separate?format=wav8ch",
                      body=self.bodies[self.lengths.index(sec)])
            r = c.getresponse()
            r.read()
            c.close()
            if r.status != 200:
                raise RuntimeError(f"warm-up request of {sec} s answered {r.status}")
        self.setup_note = (f"{len(self.p['clip_seconds'])} warm-up requests "
                           f"{time.perf_counter() - t0:.3f} s")

    def schedule(self, seconds: float) -> list[tuple[float, int]]:
        """(due, body) of every request due in [0, seconds): one Poisson
        path and one order of lengths, both from `arrival_seed` alone, so
        that every seed offers the same work; the seed draws the audio."""
        arrivals = random.Random(self.p["arrival_seed"])
        dues, t = [], arrivals.expovariate(self.p["rate"])
        while t < seconds:
            dues.append(t)
            t += arrivals.expovariate(self.p["rate"])
        order = [j % len(self.bodies) for j in range(len(dues))]
        arrivals.shuffle(order)
        return list(zip(dues, order))

    def window(self, seconds: float, spans, keep: bool) -> Window:
        sched = self.schedule(seconds)
        kept: set[int] = set()
        if keep and sched:
            longest = max(self.lengths)
            first = next((j for j, (_, b) in enumerate(sched)
                          if self.lengths[b] == longest), 0)
            rest = [j for j in range(len(sched)) if j != first]
            draw = random.Random(self.seed + 1)
            kept = {first, *draw.sample(rest, min(len(rest), self.p["check_samples"] - 1))}
        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=loadgen.run,
                           args=(child, self.port, sched, self.bodies, kept))
        self.service.spans = spans
        proc.start()
        try:
            parent.recv()
            t0 = time.perf_counter()
            parent.send("go")
            results, answers, last_byte = parent.recv()
            window_s = last_byte - t0
        finally:
            proc.join(JOIN_TIMEOUT_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
        lat = [r[2] for r in results]
        late = sorted(r[1] for r in results)
        failed = sum(r[3] != 200 for r in results)
        audio_s = sum(self.lengths[sched[j][1]] for j, r in enumerate(results)
                      if r[3] == 200)
        if late:
            q = sorted(lat)
            pick = lambda f: q[min(len(q) - 1, int(f * len(q)))] * 1e3
            print(f"[loadgen] {len(results)} requests at {self.p['rate']}/s: "
                  f"sent late by median {late[len(late) // 2] * 1e3:.3f} ms, "
                  f"max {late[-1] * 1e3:.3f} ms; {failed} failed; latency ms "
                  f"p50 {pick(0.5):.3f} p90 {pick(0.9):.3f} p95 {pick(0.95):.3f} "
                  f"p99 {pick(0.99):.3f} max {q[-1] * 1e3:.3f} "
                  f"mean {sum(q) / len(q) * 1e3:.3f}; answered/s "
                  f"{(len(results) - failed) / window_s:.4f} audio/s {audio_s / window_s:.4f} "
                  f"window_s {window_s:.3f}",
                  file=sys.stderr, flush=True)
        samples = [(j, *answers[j], sched[j][1]) for j in sorted(answers)]
        return Window(window_s, lat, len(sched), failed, samples,
                      len(sched) - failed, audio_s)

    def unit_shapes(self):
        return None

    def release(self) -> None:
        if self.server is None:
            return
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()
        self.service = self.server = None

    def check(self, samples) -> dict[str, float]:
        from portbench import reference
        from portbench.reference import offline

        nets = net_list(self.nets)
        names = ",".join(self.cfg["stem_names"])
        refs, worst = {}, {}
        with reference.fp32_exact(), torch.no_grad():
            for _, order, body, b in samples:
                try:
                    got = parse_wav_f32(body)
                except ValueError:
                    got = None
                if order != names or got is None or got.shape[0] != 2 * len(nets):
                    worst = merge_worst(worst, dict.fromkeys(CHECKS, NOT_FINITE))
                    continue
                if b not in refs:
                    refs[b] = [offline.separate(self.clips[b].to(self.dev), nets,
                                                self.cfg, p) for p in ("fp32", "fp8")]
                y = torch.from_numpy(got.copy()).to(self.dev).view(len(nets), 2, -1)
                worst = merge_worst(worst, stem_errors(y, *refs[b]))
        return worst

    def use_reference(self, precision: str) -> None:
        from portbench import reference
        from portbench.reference import offline

        nets = net_list(self.nets)
        by_body = {body: i for i, body in enumerate(self.bodies)}

        def run(wav_bytes):
            with reference.fp32_exact(), torch.no_grad():
                stems = offline.separate(self.clips[by_body[wav_bytes]].to(self.dev),
                                         nets, self.cfg, precision)
            return dict(zip(self.cfg["stem_names"], stems.cpu().numpy()))

        self.service.replacement = run


def _timed_service(base):
    """The program's SeparationService with the server-side span of each
    `separate_wav` (lock wait, WAV parse, separation, copy to the host)."""

    class TimedService(base):
        spans = None
        replacement = None

        def separate_wav(self, wav_bytes, num_stems=None):
            s0 = time.time_ns()
            try:
                if self.replacement is not None:
                    return self.replacement(wav_bytes)
                return super().separate_wav(wav_bytes, num_stems)
            finally:
                if self.spans is not None:
                    self.spans.add("service.separate_wav", s0, time.time_ns())

    return TimedService
