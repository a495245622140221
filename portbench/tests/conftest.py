"""Shared helpers of the benchmark's CPU tests: cells cut to a size the CPU
runs in seconds, by the configuration's family (`small_config`; Spleeter:
64-frame, 512-bin tiles, every width of the nets as published) and by the
driver (`SMALL`: a few seconds of audio, two streams)."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def small(name: str):
    from portbench import spec

    cell = spec.cell(name)
    return dataclasses.replace(
        cell, config=spec.family(cell.config).small_config(cell.config),
        params={**cell.params, **spec.driver(cell.driver).SMALL})


@pytest.fixture
def small_cell():
    return small
