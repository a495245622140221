"""chip_smoke.py, the port's on-card check, held whole on the CPU.

The script runs only on a CUDA card, so nothing else in the CPU tests
imports it: these tests read its source and import it to catch what a
deletion leaves behind (a function nothing calls, a name nothing defines)
and a hand kernel the final report would not list.
"""

from __future__ import annotations

import ast
import builtins
import importlib
import pathlib
import symtable
import sys

import pytest
import torch

from spleeterrt_tpu_torch import kernels

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "chip_smoke.py"


@pytest.fixture(scope="module")
def smoke():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return importlib.import_module("chip_smoke")


def _top_level_functions(tree: ast.Module) -> dict[str, ast.AST]:
    return {node.name: node for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}


def test_every_function_is_reachable_from_main():
    """An AST walk from main over the names each top-level function loads
    reaches every top-level function."""
    funcs = _top_level_functions(ast.parse(SCRIPT.read_text()))
    calls = {name: {n.id for n in ast.walk(node)
                    if isinstance(n, ast.Name) and n.id in funcs}
             for name, node in funcs.items()}
    reached, todo = set(), ["main"]
    while todo:
        name = todo.pop()
        if name not in reached:
            reached.add(name)
            todo.extend(calls[name])
    assert sorted(set(funcs) - reached) == []


def test_every_global_name_resolves(smoke):
    """Every name a function (or a lambda, comprehension or function nested
    in one) reads from the module's scope is a module global or a builtin."""
    top = symtable.symtable(SCRIPT.read_text(), str(SCRIPT), "exec")
    missing = []

    def visit(table):
        for child in table.get_children():
            for sym in child.get_symbols():
                name = sym.get_name()
                if (sym.is_global() and sym.is_referenced()
                        and not hasattr(smoke, name) and not hasattr(builtins, name)):
                    missing.append(f"{child.get_name()}: {name}")
            visit(child)

    visit(top)
    assert missing == []


def test_the_kernel_report_names_every_registered_kernel(smoke):
    names = [name for name, _, _ in smoke.KERNEL_TABLE]
    assert len(names) == len(set(names))
    assert set(names) == set(kernels.KERNELS)


def test_main_fails_without_a_cuda_device(smoke, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; main would run the smoke")
    assert smoke.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
