"""The family layer changed nothing an existing cell draws or reads. At the
CPU tests' size and one seed, each cell's driver draws the same weights and
audio, bit for bit, and its check reads the same numbers on the same
answers as the harness did before it (values recorded by that harness,
which called Spleeter's helpers directly)."""

from __future__ import annotations

import hashlib
import math

import pytest
import torch

from conftest import small
from portbench import spec
from portbench.trace import Spans

SEED = 4100000021
# cell: (weights, audio, {number compared: reading}).
RECORDED = {
    "vst4-track300": (
        "81206f2d3d01d014e9ccf04d88c2c350b38eb8afdf6997b6253d489af8b8b4a4",
        "b798b331956b9752395e142321375eff91fdba6ba7053eeb287bcd50461aec9e",
        {"rel_l2_fp8": 0.08935754151391133, "peak_fp8": 0.16045073256191147}),
    "exe2-track300": (
        "6e1301205a7454e684c434ea6430cc519f6175bf6562b7fea3080b9050c81118",
        "619ac6ac542ef2adab0ed0f434b6685c86102c18b124343da2565b4d55f6f46c",
        {"rel_l2_fp8": 0.07125761746375141, "peak_fp8": 0.09594446609831159}),
    "vst4-stream64": (
        "81206f2d3d01d014e9ccf04d88c2c350b38eb8afdf6997b6253d489af8b8b4a4",
        "7915de3edb902cc7682c17e89305ac0d187a9621b687d1bf89044d0dc26c9270",
        {"rel_l2_fp8": 0.13237660417627656, "peak_fp8": 0.19623584325624208}),
    "vst4-http-clips": (
        "81206f2d3d01d014e9ccf04d88c2c350b38eb8afdf6997b6253d489af8b8b4a4",
        "4709d61deddfa55dc09385515dfa2adc566635198446e3fd2c67d3274859df59",
        {"rel_l2_fp8": 0.09052572247173443, "peak_fp8": 0.10413184511149383}),
}
# The CPU's convolutions sum in an order that follows its thread count (3
# threads against 8 moved the readings in the seventh digit), so readings
# compare to 1e-5 of their value; the draws compare exactly.
READING_RTOL = 1e-5


def digest(obj) -> str:
    h = hashlib.sha256()

    def walk(o, path):
        if isinstance(o, dict):
            for k, v in o.items():
                walk(v, f"{path}/{k}")
        elif isinstance(o, (list, tuple)):
            for i, v in enumerate(o):
                walk(v, f"{path}/{i}")
        elif isinstance(o, torch.Tensor):
            t = o.detach().cpu().contiguous()
            h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.numpy().tobytes())
        else:
            h.update(path.encode())
            h.update(o)

    walk(obj, "")
    return h.hexdigest()


@pytest.mark.parametrize("name", list(RECORDED))
def test_a_cell_draws_and_reads_what_it_did(name):
    cell = small(name)
    d = spec.driver(cell.driver).Driver(cell, SEED, torch.device("cpu"))
    d.setup()
    if cell.driver == "offline":
        weights, audio = d.weights, d.tracks
        samples = [d.call(k) for k in range(d.tracks.shape[0])]
    elif cell.driver == "stream":
        weights, audio = d.nets, d.pool
        samples = [d.call(i) for i in range(2)]
    else:
        weights, audio = d.nets, [d.bodies, d.clips]
        try:
            samples = d.window(2.0, Spans(), keep=True).samples
        finally:
            d.release()
    d.release()
    want_w, want_a, want_r = RECORDED[name]
    assert (digest(weights), digest(audio)) == (want_w, want_a)
    got = d.check(samples)
    assert set(got) == set(want_r)
    for k, v in want_r.items():
        assert math.isclose(got[k], v, rel_tol=READING_RTOL), (k, got[k], v)
