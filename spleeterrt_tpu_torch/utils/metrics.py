"""Separation quality metrics (SNR / SDR / SI-SDR).

The acceptance criterion in BASELINE.md is that separated stems match the
reference implementation within an SNR/SDR bound on identical input; the
reference itself only claims ~1e-4 MSE against the TensorFlow model
(README.MD). These are the standard measures used for that comparison.
"""

from __future__ import annotations

import numpy as np


def mse(est: np.ndarray, ref: np.ndarray) -> float:
    est, ref = np.asarray(est, np.float64), np.asarray(ref, np.float64)
    return float(np.mean((est - ref) ** 2))


def snr_db(est: np.ndarray, ref: np.ndarray, eps: float = 1e-12) -> float:
    """Signal-to-noise of `est` against ground truth `ref`, in dB."""
    est, ref = np.asarray(est, np.float64), np.asarray(ref, np.float64)
    num = np.sum(ref**2)
    den = np.sum((est - ref) ** 2)
    return float(10.0 * np.log10((num + eps) / (den + eps)))


def si_sdr_db(est: np.ndarray, ref: np.ndarray, eps: float = 1e-12) -> float:
    """Scale-invariant SDR (Le Roux et al. 2019): projection onto ref."""
    est = np.asarray(est, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    alpha = np.dot(est, ref) / (np.dot(ref, ref) + eps)
    target = alpha * ref
    noise = est - target
    return float(
        10.0 * np.log10((np.sum(target**2) + eps) / (np.sum(noise**2) + eps))
    )


def stem_report(
    est: dict[str, np.ndarray], ref: dict[str, np.ndarray]
) -> dict[str, dict[str, float]]:
    """Per-stem {snr_db, si_sdr_db, mse} between two separations."""
    out = {}
    for name in ref:
        out[name] = {
            "snr_db": snr_db(est[name], ref[name]),
            "si_sdr_db": si_sdr_db(est[name], ref[name]),
            "mse": mse(est[name], ref[name]),
        }
    return out
