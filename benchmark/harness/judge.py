"""What a run hands back for judging, and the comparisons that decide
`correct`.  Each number compared has a limit of its own, in the cell's
limits file; a number passes when it is finite and at most its limit."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Outcome:
    run: object                     # spec.Run
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)     # name → number compared


def judge(outcome: Outcome, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number within its limit,
    every one that the limits name present, and no attempt failed."""
    table = {}
    ok = outcome.failed == 0 and outcome.attempted > 0
    for name, limit in limits.items():
        value = outcome.checks.get(name, math.inf)
        table[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, table


def leaf_gap(g: np.ndarray, g_ref: np.ndarray, leaves) -> float:
    """The worst leaf's gap between the program's and the reference's
    gradient norms, over the larger of that leaf's reference norm and the
    median leaf's (some gradients are all but zero)."""
    norms = [(float(np.linalg.norm(g[s])), float(np.linalg.norm(g_ref[s]))) for _, s in leaves]
    med = float(np.median([r for _, r in norms]))
    return max(abs(a - r) / max(r, med) if max(r, med) > 0 else abs(a - r) for a, r in norms)


def answer_gap(got: np.ndarray, want: np.ndarray, scale: float) -> float:
    """max |got − want| over `scale`; inf for a missing or misshapen answer."""
    if got is None:
        return math.inf
    got = np.asarray(got)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.abs(got - want).max()) / scale
