"""Evidence-engine selection: the one resolution point for GPC_TPU_EVIDENCE.

The same variable and values as gpc_tpu/ops/evidence_mode.py, so the two
CLIs take the same settings:

  dense      jitchol escalation (linalg.py): the parity route and default;
  panel      the panel kernel K3 (ops/panel_engine.py): forward evidence;
  lazy       not ported yet (ROADMAP.md, queue 1 item 6);
  iterative  not ported yet (ROADMAP.md, queue 1 item 6).

gpc_tpu's unset-flag default turns to `lazy` past N = 8192 on a TPU because
the TPU compile helper crashes on the dense N-wide solve there; the port
has no such limit and keeps `dense` as its default at every size.
"""

from __future__ import annotations

import os

MODES = ("dense", "lazy", "iterative", "panel")


def evidence_mode() -> str:
    """GPC_TPU_EVIDENCE = dense | lazy | panel | iterative, validated."""
    v = os.environ.get("GPC_TPU_EVIDENCE", "dense").lower()
    if v not in MODES:
        raise ValueError(
            f"GPC_TPU_EVIDENCE={v!r} (want dense|lazy|panel|iterative)")
    return v


def select_evidence_mode() -> str:
    """The FTC evidence engine, `dense` or `panel`; the engines not ported
    yet raise NotImplementedError."""
    mode = evidence_mode()
    if mode in ("lazy", "iterative"):
        raise NotImplementedError(
            f"GPC_TPU_EVIDENCE={mode}: the {mode} evidence engine is not "
            f"ported to gpc_tpu_torch yet (ROADMAP.md, queue 1 item 6); "
            f"use dense or panel")
    return mode
