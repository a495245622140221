"""Configuration objects for the separation pipeline.

The reference hard-codes the transform constants at compile time
(Executable/stftFix.h:14-18: FFTSIZE=4096, LAP=4, HOPSIZE=1024,
HALFWNDLEN=2049) and passes (timeStep, analyseBinLimit, stems) on the CLI
(Executable/main.c:704-748). Here both live in frozen dataclasses; the
U-Net compute dtype is a torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """STFT/iSTFT constants.

    Defaults mirror the reference (Executable/stftFix.h:14-18):
    4096-point FFT, 4x overlap (hop 1024), 2049 usable bins.
    """

    fft_size: int = 4096
    overlap: int = 4  # LAP: analysis windows overlapping each output sample

    @property
    def hop(self) -> int:
        return self.fft_size // self.overlap

    @property
    def num_bins(self) -> int:
        # HALFWNDLEN
        return self.fft_size // 2 + 1

    @property
    def synthesis_gain(self) -> float:
        """Scale of the synthesis (post) window that gives a mask-of-ones
        round trip unity gain: sum_k hann^2(n - k*hop) = 3/2 for LAP=4, so
        the synthesis window is hann * 2/3 (Executable/stftFix.c:64-75,
        :302-312)."""
        if self.overlap == 4:
            return 2.0 / 3.0
        if self.overlap == 2:
            # sqrt-Hann pair; sum of hann over 2x overlap = 1
            return 1.0
        raise ValueError(f"unsupported overlap {self.overlap}")


STEM_MODE_2 = 0  # leakyReLU(0.2) encoder / ReLU decoder (reference stemMode=0)
STEM_MODE_4 = 1  # ELU everywhere (reference stemMode=1)

# Canonical stem orderings. The 4-stem RT engine runs nets in the order
# drum, bass, accompaniment, vocal (VST/Source/PluginProcessor.cpp:50-86).
STEMS_4 = ("drums", "bass", "accompaniment", "vocals")
STEMS_2 = ("vocals", "accompaniment")
STEMS_3 = ("drums", "vocals", "accompaniment")
# 5-stem family (Spleeter upstream's 5stems model; beyond the reference).
STEMS_5 = ("vocals", "drums", "bass", "piano", "other")


@dataclasses.dataclass(frozen=True)
class SeparatorConfig:
    """Full separation pipeline configuration.

    Mirrors the reference CLI surface
    (`SpleeterRT spawnNthreads timeStep analyseBinLimit stems audioFile`,
    Executable/main.c:704-748).
    """

    transform: TransformConfig = TransformConfig()
    # Frequency band the U-Net sees (analyseBinLimit). Reference clamps to
    # [512, 2048] (Executable/main.c:733-748); VST uses 1536.
    bin_limit: int = 1024
    # Spectrogram tile height in frames (timeStep); reference clamps >= 64.
    time_step: int = 512
    # 2, 3, 4 or 5 output stems (reference: 2/3 offline, 4 in the VST
    # engine; 5 mirrors upstream Spleeter's 5stems model).
    num_stems: int = 2
    # Gain applied to bins >= bin_limit in the offline path
    # (unaffectedWeight, Executable/main.c:773).
    unaffected_weight: float = 0.1
    # Compute dtype of the U-Net; fp32 is kept for parity testing against
    # the scalar C semantics.
    compute_dtype: torch.dtype = torch.bfloat16
    # Activation of the final mask: the reference exe uses a 1025-entry
    # piecewise-linear sigmoid LUT (Executable/spleeter.c:30-42), the VST the
    # exact sigmoid (VST/Source/spleeter.c). "exact" is the default here.
    sigmoid: Literal["exact", "lut"] = "exact"

    def __post_init__(self):
        if self.num_stems not in (2, 3, 4, 5):
            raise ValueError("num_stems must be 2, 3, 4 or 5")
        if self.bin_limit % 64 or self.time_step % 64:
            # The U-Net halves (time, bins) six times.
            raise ValueError("bin_limit and time_step must be divisible by 64")
        if not (512 <= self.bin_limit <= 2048):
            raise ValueError("bin_limit must be in [512, 2048]")
        if self.time_step < 64:
            raise ValueError("time_step must be >= 64")

    @property
    def stem_names(self) -> tuple[str, ...]:
        return {2: STEMS_2, 3: STEMS_3, 4: STEMS_4, 5: STEMS_5}[self.num_stems]
