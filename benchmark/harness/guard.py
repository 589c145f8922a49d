"""The import guard: the benchmark measures the PyTorch and CUDA port, and
nothing it runs may load JAX or the JAX package that the port was made
from.  Module names are compared by their top-level name (the part before
the first dot), whole: the port's name `gpc_tpu_torch` begins with the JAX
package's `gpc_tpu` and is not that package."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gpc_tpu"})
PROGRAM = "gpc_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among `modules` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)


def imported_names(path: Path) -> set[str]:
    """Top-level names of every module that the Python source `path` imports
    (absolute imports; a relative import stays inside its package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top_level(node.module))
    return out


def reference_violations(ref_dir: Path) -> list[str]:
    """'file: name' for each import of the program, JAX or the JAX package
    in the plain reference's sources."""
    bad = FORBIDDEN | {PROGRAM}
    return [f"{p.name}: {name}" for p in sorted(Path(ref_dir).glob("*.py"))
            for name in sorted(imported_names(p) & bad)]


def check(ref_dir: Path) -> list[str]:
    """Every fault the guard finds, as lines to print; empty when clean."""
    faults = [f"loaded module {m}" for m in forbidden_loaded()]
    faults += [f"reference imports {v}" for v in reference_violations(ref_dir)]
    return faults
