"""The bf16 SNR margin on chip_smoke.py's seed-1 content, port beside JAX.

    python tests/bf16_snr_margin.py [--seconds 30] [--seed 1]

With chip_smoke.py's random nets (the CLI's --random-weights, seed 0) and
its synthetic signal from `--seed`, each offline graph runs in bfloat16
and in float32 on the CPU, in the port (spleeterrt_tpu_torch: every
kernel wrapper's plain version) and in the JAX package (its CPU routing),
on the same audio and weights. Prints each stem's SNR of bf16 against
fp32 in each package and the port's margin below JAX's: the 4-stem graph
at the VST config (bin_limit 1536, time_step 256) and the 2- and 3-stem
graphs at the exe config (1024, 512). A script, not a test: the full
widths take minutes on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from spleeterrt_tpu.config import SeparatorConfig as JConfig  # noqa: E402
from spleeterrt_tpu.core import separate as jseparate  # noqa: E402
from spleeterrt_tpu.core import weights as jweights  # noqa: E402
from spleeterrt_tpu_torch import cli  # noqa: E402
from spleeterrt_tpu_torch.config import SeparatorConfig  # noqa: E402
from spleeterrt_tpu_torch.core import separate, weights  # noqa: E402
from spleeterrt_tpu_torch.utils.metrics import snr_db  # noqa: E402

SR = 44100
WEIGHT_SEED = 0  # chip_smoke.py's SEED: the nets of every phase
CONFIGS = {4: (1536, 256), 2: (1024, 512), 3: (1024, 512)}


def synthetic_audio(seconds: float, seed: int) -> np.ndarray:
    """chip_smoke.py's signal: a few tones per channel plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = np.zeros((2, t.size))
    for ch in range(2):
        for f0 in rng.uniform(60.0, 4000.0, 6):
            x[ch] += 0.08 * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
    x += 0.05 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def nets(n_stems: int):
    """(port kwargs, JAX kwargs) of separate() for chip_smoke's nets."""
    cfg = SeparatorConfig(num_stems=n_stems)
    kw = cli.load_weights(None, True, WEIGHT_SEED, cfg, "cpu")
    jkw = {}
    for name, p in kw.items():
        if name == "stacked_params":
            jkw[name] = jweights.stack_params(
                [weights.params_to_jax({ln: {fn: v[s] for fn, v in ly.items()}
                                        for ln, ly in p.items()})
                 for s in range(n_stems)])
        else:
            jkw[name] = weights.params_to_jax(p)
    return kw, jkw


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--stems", type=int, nargs="+", default=[4, 2, 3])
    args = ap.parse_args()
    x = synthetic_audio(args.seconds, args.seed)
    print(f"content: synthetic_audio({args.seconds} s, seed {args.seed}); "
          f"nets: --random-weights seed {WEIGHT_SEED}; torch {torch.__version__}, "
          f"jax {jax.__version__}, CPU")
    worst = float("inf")
    for n in args.stems:
        bins, step = CONFIGS[n]
        kw, jkw = nets(n)
        out = {}
        for label, tdt, jdt in (("bf16", torch.bfloat16, jnp.bfloat16),
                                ("fp32", torch.float32, jnp.float32)):
            t0 = time.perf_counter()
            cfg = SeparatorConfig(bin_limit=bins, time_step=step, num_stems=n,
                                  compute_dtype=tdt)
            out[("port", label)] = {k: v.numpy() for k, v in separate.separate(
                x, cfg=cfg, device="cpu", **kw).items()}
            jcfg = JConfig(bin_limit=bins, time_step=step, num_stems=n,
                           compute_dtype=jdt)
            out[("jax", label)] = {k: np.asarray(v) for k, v in jseparate.separate(
                x, cfg=jcfg, **jkw).items()}
            print(f"  {n} stems {label}: {time.perf_counter() - t0:.1f} s")
        for stem in out[("port", "fp32")]:
            port = snr_db(out[("port", "bf16")][stem], out[("port", "fp32")][stem])
            ref = snr_db(out[("jax", "bf16")][stem], out[("jax", "fp32")][stem])
            worst = min(worst, port - ref)
            print(f"{n} stems (bin_limit {bins}, time_step {step}) {stem}: "
                  f"bf16 vs fp32 port {port:.2f} dB, JAX {ref:.2f} dB, "
                  f"port - JAX {port - ref:+.2f} dB")
    print(f"largest shortfall of the port below JAX: {max(0.0, -worst):.2f} dB "
          f"(a fault above 0.5 dB)")


if __name__ == "__main__":
    main()
