"""Polyphase windowed-sinc sample-rate conversion.

Capability parity with the reference's trimmed libsamplerate sinc converter:
the reference reconstructs libsamplerate's medium-quality table (22,436
coefficient half-length, index_inc 491 -- the "121 dB SNR / 90% bandwidth"
grade; Executable/libsamplerate/src_sinc.c:142-144, Executable/main.c:133-208).
That filter is a quality spec, not a bit spec: here a Kaiser-windowed sinc
(64 zero crossings per side, beta 12.2) measures >=123 dB stop-band
attenuation beyond 110% of cutoff and <1e-4 dB passband ripple over 90% of
the band (tests/test_io.py pins both), and the conversion ratio is kept
EXACT -- Fraction(sr_out, sr_in) with no denominator cap -- so non-round
rates (e.g. 44,056 Hz NTSC audio) convert without cumulative pitch drift.
Vectorized in NumPy on the host (decode-side work; the device pipeline
starts at the STFT).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

ZEROS_PER_SIDE = 64
KAISER_BETA = 12.2


def kaiser_sinc_filter(p: int, q: int, zeros_per_side: int = ZEROS_PER_SIDE,
                       beta: float = KAISER_BETA) -> np.ndarray:
    """Lowpass for p/q resampling at the upsampled rate; unity passband gain
    after polyphase decomposition (gain p folded in)."""
    cutoff = 0.5 / max(p, q)  # cycles/sample at rate sr_in * p
    half = zeros_per_side * max(p, q)
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = 2 * cutoff * np.sinc(2 * cutoff * n)
    h *= np.kaiser(2 * half + 1, beta)
    # Sum(h) = p => unity passband gain through the zero-stuffed stream.
    return h * (p / np.sum(h))


def resample(x: np.ndarray, sr_in: int, sr_out: int,
             chunk_elems: int = 4_000_000) -> np.ndarray:
    """Resample (..., n) along the last axis from sr_in to sr_out.

    Exact rational polyphase: with p/q = sr_out/sr_in in lowest terms,
    y[m] = sum_j h[(m*q + half) mod p + j*p] * x[(m*q + half)//p - j].
    Matches `src_simple`'s one-shot semantics (Executable/main.c:210-229):
    output length = ceil(n * sr_out / sr_in). Output samples are processed
    in chunks of ~chunk_elems gathered elements to bound memory, so p may
    be arbitrarily large (no ratio approximation ever happens).
    """
    if sr_in == sr_out:
        return np.asarray(x, dtype=np.float32)
    frac = Fraction(sr_out, sr_in)
    p, q = frac.numerator, frac.denominator
    h = kaiser_sinc_filter(p, q)
    half = (h.size - 1) // 2  # filter delay in upsampled samples

    x = np.asarray(x, dtype=np.float64)
    batch_shape = x.shape[:-1]
    n = x.shape[-1]
    xf = x.reshape(-1, n)
    n_out = -(-n * p // q)  # ceil(n * sr_out / sr_in), exactly

    # h[l + j*p] = phases[j, l]: tap j of polyphase branch l.
    taps_per_phase = -(-h.size // p)
    h_pad = np.zeros(taps_per_phase * p)
    h_pad[: h.size] = h
    phases = h_pad.reshape(taps_per_phase, p)

    out = np.empty((xf.shape[0], n_out))
    j = np.arange(taps_per_phase)[:, None]
    chunk = max(1, chunk_elems // taps_per_phase)
    for s in range(0, n_out, chunk):
        m = np.arange(s, min(s + chunk, n_out), dtype=np.int64)
        u = m * q + half  # j=0 tap position in the zero-stuffed stream
        base = u // p  # input index hit by tap j=0
        idx = base[None, :] - j  # (J, M)
        valid = (idx >= 0) & (idx < n)
        w = phases[:, u % p] * valid  # per-output tap weights, edge-masked
        out[:, s : s + m.size] = np.einsum(
            "bjm,jm->bm", xf[:, np.clip(idx, 0, n - 1)], w
        )
    return out.reshape(*batch_shape, n_out).astype(np.float32)
