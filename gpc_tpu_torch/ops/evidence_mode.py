"""The FTC evidence engine: GPC_TPU_EVIDENCE resolved and run in one place.

The same variable and values as gpc_tpu/ops/evidence_mode.py, so the two
CLIs take the same settings:

  dense      jitchol escalation (linalg.evidence_terms): the parity route
             and default;
  lazy       Gram blocks materialised inside the left-looking blocked
             factorization (ops/lazy_evidence.py), differentiable; needs N
             to split into `evidence_base()` blocks;
  panel      the panel kernel K3 (ops/panel_engine.py), differentiable, for
             cmpnd(rbf[, bias][, white]) with noise;
  iterative  matrix-free CG + SLQ (ops/iterative.py): O(N·block) memory,
             a stochastic logdet; no split requirement, opt-in only.

`resolve_engine` holds every fallback, each with gpc_tpu's warning: `lazy`
on an N that does not split runs `dense`; `panel` with a kernel outside its
family runs what `lazy` would (the lazy engine when N splits, else dense);
`panel` with a noiseless kernel runs `dense`.  `kern_evidence` runs the
engine it names; both models take their FTC evidence from it alone (the
GP-LVM also reads resolve_engine's answer for its dynamics term), and no
engine calls another.

gpc_tpu's unset-flag default turns to `lazy` past N = 8192 on a TPU because
the TPU compile helper crashes on the dense N-wide solve there; the port
has no such limit and keeps `dense` as its default at every size.
"""

from __future__ import annotations

import os
import warnings

from gpc_tpu_torch import linalg
from gpc_tpu_torch.ops.iterative import kern_evidence_iterative
from gpc_tpu_torch.ops.lazy_evidence import kern_evidence_lazy
from gpc_tpu_torch.ops.panel_engine import kern_evidence_panel, panel_noiseless, panel_split

MODES = ("dense", "lazy", "iterative", "panel")
BASE = 256  # the lazy engine's default leaf block


def evidence_base() -> int:
    """The lazy engine's leaf block: GPC_TPU_EVIDENCE_BASE, else BASE."""
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


def resolve_engine(kern, n: int) -> str:
    """The engine that runs the evidence of `kern` over n data points under
    GPC_TPU_EVIDENCE, after the fallbacks of the module docstring, each
    with its warning."""
    mode = evidence_mode()
    if mode == "panel":
        info = panel_split(kern)
        if info is None:
            warnings.warn(f"GPC_TPU_EVIDENCE=panel serves cmpnd(rbf[, bias][, "
                          f"white]) only (got "
                          f"{getattr(kern, 'kind', type(kern).__name__)}); "
                          f"falling back to the lazy engine")
            # what lazy runs at this N, under this warning alone (as gpc_tpu)
            return "lazy" if evidence_splits(n) else "dense"
        if panel_noiseless(info):
            # pad rows would factor as 0·I and log 0 enters the correction;
            # the dense jitchol escalation is the engine for it
            warnings.warn("GPC_TPU_EVIDENCE=panel needs a white/noise ridge "
                          "(got a noiseless kernel); falling back to the dense "
                          "jitchol engine")
            return "dense"
    if mode == "lazy" and not evidence_splits(n):
        warnings.warn(
            f"GPC_TPU_EVIDENCE={mode} needs n_data to split into "
            f"{evidence_base()} blocks (got N={n}); falling back to dense")
        return "dense"
    return mode


def kern_evidence(kern, p, X, m, engine: str | None = None):
    """(logdet K, Σⱼ mⱼᵀK⁻¹mⱼ) for K = kern(X) from `engine`, by default
    resolve_engine(kern, N)'s answer (a caller that needs the answer too
    resolves first and passes it)."""
    engine = engine or resolve_engine(kern, X.shape[0])
    if engine == "lazy":
        return kern_evidence_lazy(kern, p, X, m, evidence_base())
    if engine == "panel":
        return kern_evidence_panel(kern, p, X, m)
    if engine == "iterative":
        return kern_evidence_iterative(kern, p, X, m)
    logdet, quad, _L = linalg.evidence_terms(kern.gram(p, X), m)
    return logdet, quad
