"""The plain reference against the program's CPU path (its kernels' plain
versions) at small sizes and float32: the offline 4- and 2-stem graphs and
the streaming engine's carry. Agreement here says the reference computes
what the program computes; on the card the same reference judges the bf16
path."""

from __future__ import annotations

import pytest
import torch

from portbench import inputs
from portbench.families import spleeter
from portbench.reference import offline, stream as ref_stream

from conftest import small


def _fp32(cfg: dict) -> dict:
    return dict(cfg, compute_dtype="float32")


def _program_offline(cfg, nets, audio):
    from spleeterrt_tpu_torch.core import separate

    stems = separate.separate(audio, cfg=spleeter.program_config(cfg), device="cpu",
                              **spleeter.net_kwargs(cfg, nets))
    return torch.stack([stems[s] for s in cfg["stem_names"]])


@pytest.mark.parametrize("cell", ["vst4-track300", "exe2-track300"])
def test_offline_matches_program(cell):
    cfg = _fp32(small(cell).config)
    gen = torch.Generator().manual_seed(7)
    nets = spleeter.make_nets(cfg, cfg["nets"], gen, "cpu")
    audio = inputs.tones_plus_noise(1, 2 * 44100 + 123, gen, "cpu")[0]
    got = offline.separate(audio, spleeter.net_list(nets), cfg)
    want = _program_offline(cfg, nets, audio)
    assert got.shape == want.shape == (len(cfg["stem_names"]), 2, audio.shape[-1])
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-4, err


def test_two_stem_residual_conserves_the_input():
    cfg = small("exe2-track300").config
    gen = torch.Generator().manual_seed(3)
    nets = spleeter.make_nets(cfg, 1, gen, "cpu")
    audio = inputs.tones_plus_noise(1, 44100, gen, "cpu")[0]
    vocals, acc = offline.separate(audio, spleeter.net_list(nets), cfg)
    assert (vocals + acc - audio).abs().max() < 1e-5


def test_stream_matches_program_block_by_block():
    from spleeterrt_tpu_torch.runtime import stream

    cfg = _fp32(small("vst4-stream64").config)
    gen = torch.Generator().manual_seed(5)
    nets = spleeter.make_nets(cfg, cfg["nets"], gen, "cpu")
    t = cfg["time_step"]
    blocks = inputs.tones_plus_noise(7, t * 1024, gen, "cpu")
    pcfg = spleeter.program_config(cfg)
    state = stream.init_state_streams(pcfg, 4, 1, "cpu")
    want = []
    for b in blocks:
        state, out = stream.block_step_streams(nets, state, b[None], pcfg, 4,
                                               tuple(cfg["out_band"]))
        want.append(out[0])
    got = ref_stream.run(list(blocks), spleeter.net_list(nets), cfg)
    for n, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs().max() / max(w.abs().max(), 1e-3)
        assert err < 1e-4, (n, err)


def test_stream_output_at_restarts_from_silence():
    """A block's output, recomputed from silence LEAD blocks back, is the
    output of the whole stream: the carry reaches no further."""
    cfg = small("vst4-stream64").config
    gen = torch.Generator().manual_seed(9)
    nets = spleeter.net_list(spleeter.make_nets(cfg, 4, gen, "cpu"))
    blocks = inputs.tones_plus_noise(ref_stream.LEAD + 4, cfg["time_step"] * 1024,
                                     gen, "cpu")
    whole = ref_stream.run(list(blocks), nets, cfg)
    n = len(blocks) - 1
    again = ref_stream.output_at(lambda i: blocks[i], n, nets, cfg)
    assert torch.allclose(again, whole[n], rtol=0, atol=1e-6)


def test_fp8_control_rounds_to_eight_bits():
    from portbench.reference.unet import round_fp8

    x = torch.linspace(-3, 3, 1001)
    y = round_fp8(x)
    assert len(torch.unique(y)) < 256
    assert (y - x).abs().max() / x.abs().max() < 2 ** -3


def test_weights_follow_the_ladder_and_the_seed():
    cfg = small("vst4-track300").config
    a = spleeter.make_nets(cfg, 4, torch.Generator().manual_seed(1), "cpu")
    b = spleeter.make_nets(cfg, 4, torch.Generator().manual_seed(1), "cpu")
    c = spleeter.make_nets(cfg, 4, torch.Generator().manual_seed(2), "cpu")
    assert a["down1"]["w"].shape == (4, 16, 2, 5, 5)
    assert a["up1"]["w"].shape == (4, 512, 256, 5, 5)
    assert a["up7"]["w"].shape == (4, 2, 1, 4, 4)
    assert "bn_scale" not in a["down6"] and "bn_scale" in a["up6"]
    assert a["up1"]["b"].shape == (4, 256)
    assert all(t.is_contiguous() for ly in a.values() for t in ly.values())
    assert torch.equal(a["up3"]["w"], b["up3"]["w"])
    assert not torch.equal(a["up3"]["w"], c["up3"]["w"])
    std = a["down5"]["w"].std().item()
    assert abs(std - (2.0 / (25 * 128)) ** 0.5) < 0.01 * std + 1e-4

