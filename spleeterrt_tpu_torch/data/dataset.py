"""Training data pipeline: stem datasets -> spectrogram-magnitude batches.

The reference ships no training (fixed weights only); this pipeline feeds
core/train.py, as the reference package's (spleeterrt_tpu/data/dataset.py)
feeds its trainer. Layout follows the musdb convention the upstream
Spleeter models were trained on: one directory per track holding
`mixture.wav` plus one WAV or FLAC file per stem. Decode and resample run
on the host (NumPy, io/); the crops go to the device from pinned host
memory, and the STFT magnitudes (torch.fft, the canonical transform) are
taken there, batched over the random crops.

Crops are drawn with the reference package's `np.random.default_rng`
calls in its order, so both packages cut the same crops from one seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from spleeterrt_tpu_torch.config import SeparatorConfig, require_spleeter
from spleeterrt_tpu_torch.core import transform
from spleeterrt_tpu_torch.io import audio as audio_io, resample


@dataclass
class Track:
    mixture: np.ndarray  # (2, n) float32 at 44.1 kHz
    stems: dict[str, np.ndarray]


def _to_stereo(x: np.ndarray) -> np.ndarray:
    if x.shape[0] == 1:
        x = np.repeat(x, 2, axis=0)
    return np.ascontiguousarray(x[:2], dtype=np.float32)


def _decode(path: str, sample_rate: int) -> np.ndarray:
    """A whole file -> (2, n) float32 at `sample_rate`."""
    data = audio_io.load_audio(path)
    x = data.samples
    if data.sample_rate != sample_rate:
        x = resample.resample(x, data.sample_rate, sample_rate)
    return _to_stereo(x)


def load_track(
    track_dir: str | os.PathLike, stem_names: tuple[str, ...],
    sample_rate: int = 44100,
) -> Track:
    """Read mixture.wav + <stem>.wav files, resampling to `sample_rate`; a
    missing mixture is the sum of the stems."""
    read = lambda name: _decode(os.path.join(track_dir, f"{name}.wav"), sample_rate)
    stems = {s: read(s) for s in stem_names}
    if os.path.exists(os.path.join(track_dir, "mixture.wav")):
        mixture = read("mixture")
    else:
        n = min(x.shape[1] for x in stems.values())
        mixture = np.sum([x[:, :n] for x in stems.values()], axis=0)
    return Track(mixture=mixture, stems=stems)


class _DecodedCache:
    """Bounded LRU of fully-decoded tracks (the fallback for files the
    seeked WAV reader can't stream: FLAC, or a sample-rate mismatch that
    needs whole-signal resampling)."""

    def __init__(self, max_tracks: int):
        self.max_tracks = max_tracks
        self._items: dict[str, np.ndarray] = {}

    def get(self, path: str, loader) -> np.ndarray:
        if path in self._items:
            self._items[path] = self._items.pop(path)  # refresh LRU order
            return self._items[path]
        x = loader()
        self._items[path] = x
        while len(self._items) > self.max_tracks:
            self._items.pop(next(iter(self._items)))
        return x


class _StemFile:
    """One stem file: streaming (seeked WAV) or cached-decode access."""

    def __init__(self, path: str, sample_rate: int, cache: _DecodedCache):
        self.path = path
        self._cache = cache
        self._rate = sample_rate
        self.reader = None
        if path.lower().endswith(".wav"):
            try:
                r = audio_io.WavReader(path)
                if r.sample_rate == sample_rate:
                    self.reader = r
            except ValueError:
                pass
        if self.reader is None:
            self.n_frames = self._decode().shape[1]
        else:
            self.n_frames = self.reader.n_frames
        self.streaming = self.reader is not None

    def _decode(self) -> np.ndarray:
        return self._cache.get(self.path, lambda: _decode(self.path, self._rate))

    def read(self, start: int, count: int) -> np.ndarray:
        """(2, count) float32, zero-padded past either end."""
        if self.reader is not None:
            return _to_stereo(self.reader.read(start, count))
        x = self._decode()
        out = np.zeros((2, count), np.float32)
        lo = max(0, min(start, x.shape[1]))
        hi = max(0, min(start + count, x.shape[1]))
        out[:, lo - start : hi - start] = x[:, lo:hi]
        return out


class TrackHandle:
    """Lazy per-track access: stem files opened header-only; crops read
    O(crop) bytes. A missing mixture.wav is synthesized as the stem sum at
    read time (same contract as `load_track`)."""

    def __init__(
        self, track_dir: str, stem_names: tuple[str, ...],
        sample_rate: int, cache: _DecodedCache,
    ):
        self.stem_names = stem_names

        def find(stem):
            for ext in (".wav", ".flac"):
                p = os.path.join(track_dir, stem + ext)
                if os.path.exists(p):
                    return p
            return os.path.join(track_dir, stem + ".wav")  # let it raise

        self.files = {
            s: _StemFile(find(s), sample_rate, cache) for s in stem_names
        }
        mix_path = os.path.join(track_dir, "mixture.wav")
        self.mix_file = (
            _StemFile(mix_path, sample_rate, cache)
            if os.path.exists(mix_path)
            else None
        )
        self.n_frames = min(f.n_frames for f in self.files.values())
        if self.mix_file is not None:
            self.n_frames = min(self.n_frames, self.mix_file.n_frames)

    @property
    def streaming(self) -> bool:
        files = list(self.files.values())
        if self.mix_file is not None:
            files.append(self.mix_file)
        return all(f.streaming for f in files)

    def read_crop(self, start: int, count: int):
        """-> (mix (2, L), stems (S, 2, L)) float32."""
        stems = np.stack(
            [self.files[s].read(start, count) for s in self.stem_names]
        )
        if self.mix_file is not None:
            mix = self.mix_file.read(start, count)
        else:
            mix = stems.sum(0)
        return mix, stems

    @property
    def mixture(self) -> np.ndarray:
        """Full mixture (decoded on demand; for eval/tests, not the hot path)."""
        return self.read_crop(0, self.n_frames)[0]


class StemDataset:
    """Directory of track dirs -> random (mixture, stems) crops.

    Streaming: construction opens WAV headers only; each `sample_crop` reads
    O(crop_len) bytes from disk. RAM stays bounded by `cache_tracks` fully
    decoded tracks regardless of corpus size (only non-streamable files --
    FLAC or rate-mismatched WAV -- ever enter that cache).
    """

    def __init__(
        self, root: str | os.PathLike, stem_names: tuple[str, ...],
        sample_rate: int = 44100, cache_tracks: int = 2,
    ):
        self.stem_names = stem_names
        self.sample_rate = sample_rate
        self._cache = _DecodedCache(max(1, cache_tracks) * len(stem_names) + 1)
        self.tracks: list[TrackHandle] = []
        for name in sorted(os.listdir(root)):
            d = os.path.join(root, name)
            if os.path.isdir(d):
                self.tracks.append(
                    TrackHandle(d, stem_names, sample_rate, self._cache)
                )
        if not self.tracks:
            raise ValueError(f"no track directories under {root}")

    def sample_crop(
        self, rng: np.random.Generator, crop_len: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Random track + random crop -> (mix (2, L), stems (S, 2, L))."""
        tr = self.tracks[rng.integers(len(self.tracks))]
        start = int(rng.integers(max(1, tr.n_frames - crop_len + 1)))
        return tr.read_crop(start, crop_len)


def crop_samples(cfg: SeparatorConfig) -> int:
    """Audio samples per training crop: one spectrogram tile plus the
    analysis frame tail."""
    return cfg.time_step * cfg.transform.hop + (
        cfg.transform.fft_size - cfg.transform.hop
    )


def to_magnitudes(
    mix: torch.Tensor,  # (B, 2, L)
    stems: torch.Tensor,  # (B, S, 2, L)
    cfg: SeparatorConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Crops -> (mix_mag (B,T,F,2), target_mags (S,B,T,F,2)) on the crops'
    device, normalized by fft_size into O(1) for stable from-scratch
    optimization. The canonical STFT (torch.fft), as the reference package
    takes it in plain XLA."""
    t, bl = cfg.time_step, cfg.bin_limit
    n = mix.shape[-1]
    scale = 1.0 / cfg.transform.fft_size

    def mags(x):  # (..., 2, L) -> (..., T, F, 2)
        spec = transform.stft(x, cfg.transform, n)
        return torch.movedim(spec[..., :t, :bl].abs() * scale, -3, -1)

    return mags(mix), mags(stems.transpose(0, 1))


SILENCE_RMS = 1e-5  # below ~-100 dBFS a stem crop counts as silent


def stem_activity(stems: np.ndarray) -> np.ndarray:
    """(B, S, 2, L) time-domain stems -> (S, B) float32 1.0/0.0 activity.

    Silent-stem crops carry no separation signal (an all-zero target teaches
    the mask to collapse); the loss downweights them via this mask."""
    rms = np.sqrt(np.mean(np.square(stems), axis=(2, 3)))  # (B, S)
    return (rms > SILENCE_RMS).astype(np.float32).T


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to a card from pinned memory, without
    waiting for the copy."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def batches(
    dataset: StemDataset,
    cfg: SeparatorConfig,
    batch_size: int,
    seed: int = 0,
    steps: int | None = None,
    device: torch.device | str = "cuda",
):
    """Infinite (or `steps`-bounded) iterator of batches on `device`:
    (mix_mag (B,T,F,2), target_mags (S,B,T,F,2), active (S,B))."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    require_spleeter(cfg, "training's data loop")
    crop = crop_samples(cfg)
    i = 0
    while steps is None or i < steps:
        mixes, stems = zip(
            *(dataset.sample_crop(rng, crop) for _ in range(batch_size))
        )
        stems = np.stack(stems)
        mix_mag, tgt = to_magnitudes(
            _to_device(np.stack(mixes), device), _to_device(stems, device), cfg
        )
        yield mix_mag, tgt, _to_device(stem_activity(stems), device)
        i += 1
