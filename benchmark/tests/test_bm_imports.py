"""What a run may load: nothing whose top-level name (the part before the
first dot, compared whole) is jax, jaxlib, flax, splashsurf_tpu or bench;
and the reference nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "splashsurf_tpu", "bench"}


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        for mod in imported(f):
            assert mod.split(".")[0] not in FORBIDDEN, (f, mod)


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        for mod in imported(f):
            assert mod.split(".")[0] not in FORBIDDEN | {"splashsurf_tpu_torch", "harness"}, \
                (f, mod)


def test_a_run_loads_no_forbidden_module():
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH)!r}, {str(BENCH / 'tests')!r}]\n"
        "from bm_small import program, small_run\n"
        "from harness import runner\n"
        "out = small_run('dam_break_13m.host_flow', program, seconds=0.5)\n"
        "print(json.dumps([out['result']['correct'], runner.forbidden_modules(),\n"
        "                  sorted({m.split('.')[0] for m in sys.modules})]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=BENCH.parent)
    assert proc.returncode == 0, proc.stderr[-3000:]
    correct, found, tops = json.loads(proc.stdout.strip().splitlines()[-1])
    assert correct and found == []
    assert "splashsurf_tpu_torch" in tops and not FORBIDDEN & set(tops)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dam_break_13m.host_flow",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=BENCH.parent)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
