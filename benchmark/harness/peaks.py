"""The table of peaks and the roofline bound (copied from chip_smoke.py's
HBM_BPS, PEAK and bound, so that later changes to the program cannot move
the yardstick).

The H100 SXM's published peaks at 700 W (NVIDIA data sheet, dense rates
without sparsity): HBM bytes/s and operations/s by type.  A bound is the
larger of the bytes moved (each input read once, each output written once)
over HBM_BPS and the operations over their peak, types that run on
different units summed."""

from __future__ import annotations

HBM_BPS = 3.35e12
PEAK = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
# `mfu.*` divides by the card's dense bf16 rate: the highest dense rate a
# GP run could use, so the share cannot pass 100 %.
MFU_PEAK = PEAK["bf16"]


def bound_s(nbytes: float, ops: dict) -> tuple[float, str]:
    """(seconds, 'bytes' or 'operations') for `nbytes` moved and `ops`
    {type: count}."""
    t_bytes = nbytes / HBM_BPS
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_bound_s(n: int, q: int, d: int, b: int = 128, diag: bool = True) -> float:
    """K3's panel evidence (chip_smoke.k3_bound): X, m in; T (bf16), v, G,
    logdet out.  bf16: the Schur corrections (n³/3) and the panel solves
    (n²·b); f32: the lower Gram (n²/2 entries at 2q + 6), the leaves
    (n/b · 2b³/3) and the forward solve (d·n²).  Mode `full+diag`, the
    training mode, also writes bf16(L_jj⁻¹) into T's diagonal blocks: n·b
    bf16 entries, and the leaves' inverses are inside their 2b³/3."""
    nbytes = 4 * (n * q + n * d) + 2 * n * n + 4 * (d * n + d * d + 1)
    if diag:
        nbytes += 2 * n * b
    return bound_s(nbytes, {"bf16": n ** 3 / 3 + n * n * b,
                            "f32": n * n / 2 * (2 * q + 6) + (n // b) * 2 * b ** 3 / 3
                            + d * n * n})[0]
