"""Model families: what the benchmark knows of one architecture.

A configuration names its family with a `family` key (`spleeter` where
absent); `spec.family(cfg)` loads `families/<family>.py` by its path. A
family module provides:

- `make_weights(cfg, gen, device)`: the weights, drawn from the seed's
  generator on the device (the drivers draw the audio after them, from the
  same generator);
- `program(cfg, weights, device)` -> `call(track)`: the program's normal
  offline entry point, `(2, n)` float32 on the device in, `{stem: (2, n)}`
  out, one entry a name of the configuration's `stem_names`;
- `reference(track, weights, cfg, precision)` -> `(stems, 2, n)` float32 in
  `stem_names` order: the plain reference, imports nothing of the program;
  `precision` is `"fp32"`, or `"fp8"` for the control (every matrix
  product's or convolution's operands rounded to float8 e4m3). The drivers
  call it with TF32 off and without autograd;
- `unit_shapes(cfg, n_samples)`: the shape variables of one offline call of
  `n_samples` samples, which the stage formulas and `unit_flops` read;
- `unit_flops(cfg, shapes)`: the useful operations of one unit;
- `FAULTS`: `{driver: {fault: factory}}`, each factory returning a context
  manager that plants the fault in the program (`portbench.control`);
- `small_config(cfg)`: the configuration as the CPU tests run it.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(owner, name: str, make):
    """`owner.name` (a module's function, as the program calls it) replaced
    by `make(original)` inside the block."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)
