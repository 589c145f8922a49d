"""The import guard: nothing the benchmark runs loads JAX or the JAX package
gpc_tpu (top-level names compared whole), and the plain reference imports
nothing of the program."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from harness import guard
from conftest import BENCH, ROOT


def test_names_are_compared_by_their_whole_top_level_name():
    assert guard.forbidden_loaded(["gpc_tpu_torch", "gpc_tpu_torch.models.gp", "jaxtyping",
                                   "numpy"]) == []
    assert guard.forbidden_loaded(["gpc_tpu.models", "jaxlib.xla_client", "flax", "jax"]) == [
        "flax", "gpc_tpu", "jax", "jaxlib"]


def test_the_reference_imports_neither_the_program_nor_jax():
    assert guard.reference_violations(BENCH / "reference") == []
    names = set().union(*(guard.imported_names(p) for p in (BENCH / "reference").glob("*.py")))
    assert {"numpy", "torch"} <= names


def test_the_guard_finds_a_reference_that_imports_the_program(tmp_path):
    (tmp_path / "ok.py").write_text("import numpy as np\nfrom . import sibling\n")
    (tmp_path / "bad.py").write_text("import torch\nfrom gpc_tpu_torch.models import gp\n"
                                     "def f():\n    import jax.numpy as jnp\n")
    assert guard.reference_violations(tmp_path) == ["bad.py: gpc_tpu_torch", "bad.py: jax"]


SMALL_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
import run
from harness import guard, spec
from conftest import SMALL
for wl in ("ftc-rbf-16k-dense.train", "ftc-rbf-16k.serve"):
    res = run.measure(spec.load_cell(run.ROOT, wl, SMALL), 7, 0.3, False, "cpu")
    assert res["correct"], res
print(json.dumps({{"forbidden": guard.forbidden_loaded(),
                  "program": "gpc_tpu_torch" in sys.modules,
                  "faults": guard.check(run.HERE / "reference")}}))
"""


def test_a_run_loads_the_program_and_no_jax():
    env = dict(os.environ, PYTHONPATH=str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c",
                          SMALL_RUN.format(root=str(ROOT), bench=str(BENCH))],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "program": True, "faults": []}


@pytest.mark.parametrize("name", sorted(guard.FORBIDDEN))
def test_a_result_is_refused_where_a_forbidden_module_is_loaded(name, capsys, monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.report({"correct": True, "checks": {}}) == 3
    got = capsys.readouterr()
    assert got.out == "" and f"import guard: loaded module {name}" in got.err


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "ftc-rbf-16k-dense.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_directory_with_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "dtc-rbf-16k.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
