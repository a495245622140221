"""BS-RoFormer in the port (`core/roformer.py`, `separate.separate` with a
`RoformerConfig`) against the plain float32 reference
(`tests/roformer_reference.py`), at a small size on the CPU: dim 64, 2
blocks of 2 heads x 32, a band list cut for a 256-point STFT, 0.5 s
chunks."""

from __future__ import annotations

import dataclasses

import pytest
import torch

import roformer_reference as ref
from portbench.reference import roformer as bench_ref
from spleeterrt_tpu_torch import cli
from spleeterrt_tpu_torch.config import ROFORMER_BANDS, RoformerConfig, SeparatorConfig
from spleeterrt_tpu_torch.core import checkpoint, roformer, separate, train
from spleeterrt_tpu_torch.data import dataset
from spleeterrt_tpu_torch.parallel import mesh
from spleeterrt_tpu_torch.runtime import server, stream
from spleeterrt_tpu_torch.utils import timing

SMALL = RoformerConfig(
    dim=64, depth=2, heads=2, dim_head=32,
    freqs_per_bands=(2,) * 8 + (4,) * 4 + (8,) * 4 + (16,) * 2 + (33,),
    n_fft=256, hop=64, win=256, chunk=22050, batch=3, compute_dtype=torch.float32,
)
BF16 = dataclasses.replace(SMALL, compute_dtype=torch.bfloat16)
N = 44100  # 1 s: five chunks of 0.5 s at overlap 2


def _params(seed: int):
    return roformer.init_params(SMALL, torch.Generator().manual_seed(seed))


def _track(seed: int) -> torch.Tensor:
    return torch.randn(2, N, generator=torch.Generator().manual_seed(1000 + seed))


def _port(track, params, cfg):
    start = roformer.border(track.shape[-1], cfg)
    return roformer.separate_roformer(track, params, cfg)[..., start : start + track.shape[-1]]


@pytest.fixture(scope="module")
def case():
    params, track = _params(0), _track(0)
    return params, track, ref.separate(track, params, SMALL)["vocals"]


def _rel(y, r) -> float:
    return float((y - r).norm() / r.norm())


def test_fp32_path_matches_the_reference(case):
    params, track, want = case
    got = _port(track, params, SMALL)
    assert roformer.num_chunks(N, SMALL) == 5 and got.shape == (1, 2, N)
    # Float32 throughout: only the order of sums differs (equal-width bands
    # as one batched product, the fused softmax, gains folded into the
    # weights); two blocks of it move the stems ~5e-7 relative.
    assert _rel(got[0], want) < 1e-5


def test_bf16_path_sits_inside_what_the_float8_control_exceeds(case):
    params, track, want = case
    got = _port(track, params, BF16)[0]
    control = bench_ref.separate(track, params, SMALL, "fp8")["vocals"]
    # bf16 linears and attention sit at ~0.1 of the float8 control's error
    # (8 bits of mantissa against 4); the benchmark's limit is 0.4 of it.
    bound = 0.4 * _rel(control, want)
    assert _rel(got, want) < bound < _rel(control, want)
    assert _rel(got, want) > 1e-4  # the bf16 path is not the fp32 one


def test_rotary_scores_depend_on_the_offset_only_and_keep_norms():
    table = roformer.rotary(40, SMALL, "cpu")  # (40, 16) complex
    gen = torch.Generator().manual_seed(3)
    q = torch.view_as_complex(torch.randn(16, 2, generator=gen))
    k = torch.view_as_complex(torch.randn(16, 2, generator=gen))
    score = lambda i, j: torch.sum(q * table[i] * torch.conj(k * table[j])).real
    for i, j, s in ((3, 1, 10), (0, 7, 25), (12, 12, 20)):
        assert torch.allclose(score(i, j), score(i + s, j + s), atol=1e-4)
    assert not torch.allclose(score(3, 1), score(3, 2), atol=1e-3)
    assert torch.allclose((q * table).abs(), q.abs().expand(40, 16), atol=1e-5)
    # The port's rotation is the reference's interleaved-pair rotate_half.
    x = torch.randn(40, 32, generator=gen)
    pos = torch.arange(40, dtype=torch.float32)
    want = ref.rotate(x, pos, SMALL.rope_theta)
    got = torch.view_as_real(torch.view_as_complex(x.view(40, 16, 2)) * table).view(40, 32)
    assert torch.allclose(got, want, atol=1e-5)


def test_the_published_band_split():
    cfg = RoformerConfig()
    assert cfg.freqs_per_bands == ROFORMER_BANDS
    assert len(cfg.freqs_per_bands) == 62 and sum(cfg.freqs_per_bands) == 1025
    groups = roformer.band_groups(cfg)
    assert [g[2] for g in groups] == [8, 16, 48, 96, 192, 512, 516]
    assert sum(n for _, n, _, _ in groups) == 62
    first, n, d_in, off = groups[-1]
    assert off + n * d_in == 4 * 1025 and first + n == 62
    assert cfg.chunk // cfg.hop + 1 == 801 and cfg.step == 176400
    assert roformer.num_chunks(300 * 44100, cfg) == 76
    shapes = roformer.param_shapes(cfg)
    assert shapes["layers.11.band.attn.w_qkv"] == (1536, 512)
    assert shapes["layers.0.time.ff.w1"] == (2048, 512)
    assert shapes["mask.0.61.w2"] == (1032, 2048)


def test_identity_masks_give_back_the_input(monkeypatch):
    def ones(w, x, cfg):
        b, t, _, _ = x.shape
        m = torch.zeros((len(cfg.stems), b * t, 4 * sum(cfg.freqs_per_bands)))
        m[..., 0::2] = 1.0
        return m

    monkeypatch.setattr(roformer, "masks", ones)
    track = _track(1)
    for n in (N, 9000):  # padded and cut into chunks; shorter than two borders
        got = _port(track[:, :n], _params(1), SMALL)[0]
        assert torch.allclose(got, track[:, :n], atol=1e-5, rtol=0)


def test_separate_returns_vocals_and_the_residual(case):
    params, track, want = case
    stems = separate.separate(track, params=params, cfg=SMALL, device="cpu")
    assert list(stems) == ["vocals", "instrumental"] == list(SMALL.stem_names)
    assert stems["vocals"].shape == stems["instrumental"].shape == (2, N)
    assert torch.allclose(stems["vocals"] + stems["instrumental"], track, atol=1e-6)
    assert _rel(stems["vocals"], want) < 1e-5
    mono = separate.separate(track[0].numpy(), params=params, cfg=SMALL, device="cpu")
    assert mono["vocals"].shape == (2, N)


def test_spans_under_tracing(case):
    params, track, _ = case
    timing.set_tracing(True)
    timing.take_spans()
    try:
        separate.separate(track, params=params, cfg=SMALL, device="cpu")
        spans = timing.take_spans()
    finally:
        timing.set_tracing(False)
    names = [s.name for s in spans]
    by_id = {s.span_id: s for s in spans}
    root = next(s for s in spans if s.name == "graph.separate")
    assert root.attrs == {"arch": "bs-roformer", "stems": 2, "samples": N}
    model = next(s for s in spans if s.name == "model.roformer")
    assert model.attrs == {"chunks": 5, "batch": 3, "sdpa_backend": "cpu"}
    assert by_id[model.parent_id].name == "graph.separate"
    batches = 2  # five chunks, three at a time
    assert names.count("roformer.stft") == names.count("roformer.istft") == batches
    assert names.count("roformer.band_split") == names.count("roformer.mask") == batches
    assert names.count("roformer.time_attn") == names.count("roformer.band_attn") == 2 * batches
    assert names.count("roformer.ff") == 4 * batches
    assert names.count("roformer.overlap_add") == 1
    inside = {"roformer.stft", "roformer.band_split", "roformer.time_attn",
              "roformer.band_attn", "roformer.ff", "roformer.mask", "roformer.istft",
              "roformer.overlap_add"}
    assert all(by_id[s.parent_id].name == "model.roformer" for s in spans if s.name in inside)
    assert {"graph.pad", "graph.crop", "graph.residual"} <= set(names)


def test_the_two_reference_copies_agree():
    params, track = _params(2), _track(2)[:, :30000]
    a = ref.separate(track, params, SMALL)
    b = bench_ref.separate(track, params, SMALL, "fp32")
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = bench_ref.separate(track, params, SMALL, "fp8")
    assert not torch.allclose(a["vocals"], c["vocals"], atol=1e-3)


def test_weights_round_trip_through_a_checkpoint(tmp_path):
    params = _params(3)
    path = tmp_path / "bs_roformer.pt"
    checkpoint.save_params(path, params)
    back = checkpoint.load_roformer_params(path, SMALL)
    assert list(back) == list(params) and all(torch.equal(back[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="band_split.0.w is"):
        checkpoint.load_roformer_params(path, dataclasses.replace(SMALL, dim=32))
    with pytest.raises(ValueError, match="missing"):
        checkpoint.load_roformer_params(path, dataclasses.replace(SMALL, depth=3))
    args = cli.build_parser().parse_args(["x.wav", "--arch", "bs-roformer"])
    assert args.arch == "bs-roformer"
    assert cli.build_parser().parse_args(["x.wav"]).arch == "spleeter"
    loaded = cli.load_roformer(str(path), False, 0, SMALL, "cpu")["params"]
    assert all(torch.equal(loaded[k], params[k]) for k in params)


def test_spleeter_only_paths_refuse_a_roformer_config():
    cfg = SMALL
    calls = {
        "streaming engine": lambda: stream.init_state(cfg, 4),
        "server": lambda: server.SeparationService(cfg, {}, device="cpu"),
        "evaluation": lambda: train.evaluate_si_sdr({}, None, cfg),
        "data loop": lambda: next(dataset.batches([], cfg, 2)),
        "mesh": lambda: mesh.make_batch2_fn(cfg, None),
    }
    for what, call in calls.items():
        with pytest.raises(ValueError, match="Spleeter's U-Net only"):
            call()
    stream.init_state(SeparatorConfig(), 4)  # Spleeter's still runs


def test_config_checks():
    with pytest.raises(ValueError, match="1025"):
        RoformerConfig(freqs_per_bands=(2,) * 62)
    with pytest.raises(ValueError, match="num_overlap"):
        RoformerConfig(num_overlap=1)
    assert RoformerConfig().stem_names == ("vocals", "instrumental")
