"""Nothing a run loads is JAX or the JAX package, and the reference loads
nothing of the program. Top-level names are compared whole:
`spleeterrt_tpu_torch` begins with `spleeterrt_tpu` and is the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "spleeterrt_tpu"}


def _top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
    return names


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "spleeterrt_tpu_torch_fake", sys)
    assert "spleeterrt_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spleeterrt_tpu.core", sys)
    assert run.forbidden_modules() == ["spleeterrt_tpu"]


def test_no_source_of_the_benchmark_imports_jax():
    for path in spec.HERE.rglob("*.py"):
        assert not _top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        names = _top_level_imports(path)
        assert names <= {"__future__", "contextlib", "math", "torch", "portbench"}, path


def test_a_run_loads_no_jax():
    """A whole small run on the CPU in a fresh process, then sys.modules."""
    code = (
        "import sys, time, torch; sys.path.insert(0, 'portbench/tests');"
        "from conftest import small; from portbench import run;"
        "out = run.measure(small('vst4-track300'), 5, 0.2, False,"
        " torch.device('cpu'), time.perf_counter());"
        "import json; print(json.dumps([out['correct'], run.forbidden_modules(),"
        " sorted(m for m in sys.modules if m.startswith('portbench.reference'))]))"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, found, _ = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and found == []


def test_the_reference_alone_loads_no_program():
    code = ("import sys; import portbench.reference.offline, "
            "portbench.reference.stream; import json; "
            "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    mods = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not mods & (FORBIDDEN | {"spleeterrt_tpu_torch"})


def test_without_a_card_a_run_prints_no_result():
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "vst4-track300",
         "--seed", "1", "--seconds", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
