"""Evidence-engine selection: the one resolution point for GPC_TPU_EVIDENCE.

The same variable and values as gpc_tpu/ops/evidence_mode.py, so the two
CLIs take the same settings:

  dense      jitchol escalation (linalg.py): the parity route and default;
  lazy       Gram blocks materialised inside the left-looking blocked
             factorization (ops/lazy_evidence.py), differentiable; needs N
             to split into `evidence_base()` blocks;
  panel      the panel kernel K3 (ops/panel_engine.py), differentiable;
  iterative  matrix-free CG + SLQ (ops/iterative.py): O(N·block) memory,
             a stochastic logdet; no split requirement, opt-in only.

gpc_tpu's unset-flag default turns to `lazy` past N = 8192 on a TPU because
the TPU compile helper crashes on the dense N-wide solve there; the port
has no such limit and keeps `dense` as its default at every size.
"""

from __future__ import annotations

import os
import warnings

from gpc_tpu_torch.ops.chol_blocked import BASE

MODES = ("dense", "lazy", "iterative", "panel")


def evidence_base() -> int:
    """The lazy engine's leaf block: GPC_TPU_EVIDENCE_BASE, else
    ops.chol_blocked.BASE.  The model's shape guard and the engine read it
    here, so they agree for every base."""
    return int(os.environ.get("GPC_TPU_EVIDENCE_BASE", BASE))


def evidence_splits(n: int) -> bool:
    """Whether the lazy engine takes size n: n splits into base blocks and
    is more than two of them."""
    b = evidence_base()
    return n % b == 0 and n > 2 * b


def evidence_mode() -> str:
    """GPC_TPU_EVIDENCE = dense | lazy | panel | iterative, validated."""
    v = os.environ.get("GPC_TPU_EVIDENCE", "dense").lower()
    if v not in MODES:
        raise ValueError(
            f"GPC_TPU_EVIDENCE={v!r} (want dense|lazy|panel|iterative)")
    return v


def select_evidence_mode(n: int) -> str:
    """The evidence engine for n data points (models/gp.py FTC and
    models/gplvm.py).  `lazy` on a size that does not split warns and falls
    back to `dense`, as in gpc_tpu; `iterative` and `panel` take any n."""
    mode = evidence_mode()
    if mode == "lazy" and not evidence_splits(n):
        warnings.warn(
            f"GPC_TPU_EVIDENCE={mode} needs n_data to split into "
            f"{evidence_base()} blocks (got N={n}); falling back to dense")
        return "dense"
    return mode
