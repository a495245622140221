"""The yardstick's arithmetic: the card's peaks, the operations of a real
FFT, and the stage files' formulas. A unit's useful operations are its
model family's (`families/<family>.py::unit_flops`).

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the full 700 W limit.
2.5 N log2 N for a real FFT of N points, the count of a true FFT. The
per-kernel bytes and operations of the stage files restate
`chip_smoke.py::kernel_work` (each input read once, each output written
once).
"""

from __future__ import annotations

import ast
import math
import operator

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
MFU_PEAK_OPS_PER_S = PEAK_OPS_PER_S["bfloat16"]


def rfft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


# The formulas of a stage file: numbers, names of shape variables, + - * /
# // ** and parentheses. Nothing else runs.
_BINOPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Pow: operator.pow,
}


def evaluate(expr: str, names: dict) -> float:
    """The value of a stage formula over the unit's shape variables;
    NameError for a variable the unit does not have."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.Name):
            if node.id not in names:
                raise NameError(node.id)
            return names[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
            return _BINOPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            return -ev(node.operand)
        raise ValueError(f"not allowed in a stage formula: {ast.dump(node)}")

    return float(ev(ast.parse(expr, mode="eval")))


def stage_bound_s(stage: dict, shapes: dict) -> float | None:
    """The least time one unit's work of `stage` could take on the card:
    max(bytes / HBM bandwidth, operations / the peak of its dtype), bytes
    and operations summed over the stage's launches (`each`, one binding of
    extra variables a launch); None where the unit lacks a variable of the
    formulas (its graph runs no such work)."""
    nbytes = ops = 0.0
    try:
        for binding in stage.get("each", [{}]):
            names = {**shapes, **binding}
            nbytes += evaluate(stage["bytes"], names)
            ops += evaluate(stage["ops"], names)
    except NameError:
        return None
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[stage["dtype"]])
