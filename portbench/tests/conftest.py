"""Shared helpers of the benchmark's CPU tests: cells cut to a size the CPU
runs in seconds (64-frame, 512-bin tiles, a few seconds of audio, two
streams), with every width of the nets as published."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SMALL = {
    "offline": {"track_seconds": 3, "tracks": 2, "warmup_calls": 1, "check_samples": 2},
    "stream": {"streams": 2, "pool_blocks": 3, "warmup_steps": 6, "check_samples": 1,
               "check_streams": 2},
    "http": {"clip_seconds": [2, 3], "clips_per_length": 1, "rate": 2.0,
             "check_samples": 2},
}


def small(name: str):
    from portbench import spec

    cell = spec.cell(name)
    return dataclasses.replace(
        cell, config=dict(cell.config, bin_limit=512, time_step=64),
        params={**cell.params, **SMALL[cell.driver]})


@pytest.fixture
def small_cell():
    return small
