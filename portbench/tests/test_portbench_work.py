"""The yardstick's arithmetic against counts made by hand."""

from __future__ import annotations

import pytest
import torch

from portbench import spec, work
from portbench.drivers import offline, stream
from portbench.families import spleeter


def test_unet_flops_by_hand():
    cfg = spec.config("spleeter-4stems-vst")
    t, f = 64, 128
    enc = [(2, 16), (16, 32), (32, 64), (64, 128), (128, 256), (256, 512)]
    dec = [(512, 256), (512, 128), (256, 64), (128, 32), (64, 16), (32, 1)]
    want = 0
    for k, (cin, cout) in enumerate(enc, start=1):
        want += 2 * (t >> k) * (f >> k) * 25 * cin * cout
    for k, (cin, cout) in enumerate(dec):
        want += 2 * (t >> (6 - k)) * (f >> (6 - k)) * 25 * cin * cout
    want += 2 * t * f * 2 * 16
    assert spleeter.unet_flops_per_image(cfg, t, f) == want


def test_rfft_flops():
    assert work.rfft_flops(4096) == 2.5 * 4096 * 12


def _shapes(name):
    cell = spec.cell(name)
    mod = offline if cell.driver == "offline" else stream
    return mod.Driver(cell, 1, torch.device("cpu")).unit_shapes()


def test_offline_shapes_of_a_300s_track():
    sh = _shapes("vst4-track300")
    # 300 s = 13,230,000 samples, padded to 4096 * 3230 + 8192.
    assert sh["data_size"] == 4096 * 3230 + 8192
    assert sh["istft_frames"] == (4096 * 3230 + 8192) // 1024 == 12928
    assert sh["tiles"] == 51 and sh["images"] == 204 and sh["n_req"] == 51 * 256
    assert sh["n_comp"] == 12925
    assert _shapes("exe2-track300")["images"] == 26


def test_stage_bounds_by_hand():
    stages = spec.stages()
    sh = _shapes("vst4-track300")
    # K1: 2 rows of the padded track read, window, spectrum and tiles
    # written; compared with its bytes over 3.35 TB/s.
    nbytes = (2 * sh["data_size"] * 4 + 4096 * 4
              + 2 * sh["n_req"] * (2049 * 8 + 1536 * 4))
    assert work.stage_bound_s(stages["k1_stft"], sh) == pytest.approx(nbytes / 3.35e12)
    # K3: enc4 alone is 204 images of 16 x 96 output pixels, 128 x 64 x 25 MACs.
    k3 = stages["k3_enc"]
    enc4 = dict(k3, each=[{"c": 64, "k": 3}])
    ops = 204 * 16 * 96 * 128 * 64 * 25 * 2
    nb = work.evaluate(k3["bytes"], {**sh, "c": 64, "k": 3})
    assert work.stage_bound_s(enc4, sh) == pytest.approx(max(ops / 989e12, nb / 3.35e12))
    # The stream's unit runs K8 and no K7; the offline unit the reverse.
    st = _shapes("vst4-stream64")
    assert work.stage_bound_s(stages["k7_istft"], st) is None
    assert work.stage_bound_s(stages["k8_irfft"], sh) is None
    assert st["irfft_frames"] == 64 * 4 * 2 * 256


def test_unit_flops_of_the_cells():
    cfg = spec.config("spleeter-4stems-vst")
    sh = _shapes("vst4-track300")
    want = 204 * spleeter.unet_flops_per_image(cfg, 256, 1536) + (
        2 * 12925 + 4 * 2 * 12928) * work.rfft_flops(4096)
    assert spleeter.unit_flops(cfg, sh) == want
    assert 1.8e12 < want < 1.95e12


@pytest.mark.parametrize("expr", ["__import__('os')", "a.b", "[1, 2]", "f(1)",
                                  "1 if 1 else 2"])
def test_formulas_run_arithmetic_only(expr):
    with pytest.raises(ValueError):
        work.evaluate(expr, {"a": 1})


def test_formula_missing_variable_is_a_name_error():
    with pytest.raises(NameError):
        work.evaluate("irfft_frames * 2", {"T": 1})
    assert work.evaluate("T // 2 ** k + -1", {"T": 64, "k": 2}) == 15
