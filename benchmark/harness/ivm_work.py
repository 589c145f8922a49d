"""Model FLOPs and bytes of the IVM, fixed from a configuration's shapes
alone (N points, q inputs, D outputs, active set d; one covariance
structure, as Gaussian noise has), so that a later change to the program
cannot move them.  They count the model's work, the same whatever
implements it, in float32 (4 bytes an entry).

A selection pass is d steps.  At step k (k = 0 … d − 1), with k rows of M
filled:

  bytes   the k filled rows of M read once (4kN; rows beyond k hold zeros
          and do not count, whatever reads them), the kernel column's
          inputs X (4Nq), the N-wide vectors μ, ς, ν and g each read and
          written once (2 · 4 · 4ND) and y read (4ND), one row of M written
          (4N) and one row of L, its k + 1 entries (4(k + 1));
  FLOPs   the product Mᵀa over the filled rows (2kN), the kernel column
          (flops.gram(N, 1, q)) and STEP_ENTRY operations a point and
          output for the rest: the entropy score (ς/σ², log1p, ½: 3),
          s = k − Mᵀa (1), the row √ν·s (1), ς − ν·s² (3), μ + g·s (2),
          ν = 1/(σ² + ς) (2) and g = (y − bias − μ)·ν (3).

Summed, a pass reads 2d²N bytes of M less 2dN, about 2.1 GB at N = 4096,
d = 512.  An SCG evaluation of a kernel round is an FTC evaluation at
N = d (flops.ftc_evaluation); one of a noise round costs NOISE_ENTRY
operations a point and output: the forward's ς + σ², log, y − μ − bias,
its square, the quotient and the sum (8), the gradient's r/var and its
sum, 1/var, r²/var², their difference and its sum (8)."""

from __future__ import annotations

from harness import flops, peaks

STEP_ENTRY = 15
NOISE_ENTRY = 16
F32 = 4


def pass_bytes(n: int, d: int, q: int, D: int) -> float:
    filled = n * d * (d - 1) / 2.0                  # Σ_k kN
    per_step = n * q + 9 * n * D + n                # X; μ, ς, ν, g in and out, y; a row of M
    l_rows = d * (d + 1) / 2.0                      # Σ_k (k + 1)
    return F32 * (filled + d * per_step + l_rows)


def pass_flops(n: int, d: int, q: int, D: int) -> float:
    return 2.0 * n * d * (d - 1) / 2.0 + d * (flops.gram(n, 1, q) + STEP_ENTRY * n * D)


def pass_least_s(cfg: dict) -> float:
    """The least time of one pass on the card: its bytes over HBM's rate or
    its FLOPs over the float32 peak, the larger."""
    n, d, q, D = cfg["N"], cfg["d"], cfg["q"], cfg["D"]
    return peaks.bound_s(pass_bytes(n, d, q, D), {"f32": pass_flops(n, d, q, D)})[0]


def kern_eval_flops(cfg: dict) -> float:
    return flops.ftc_evaluation(cfg["d"], cfg["q"], cfg["D"])


def noise_eval_flops(cfg: dict) -> float:
    return float(NOISE_ENTRY * cfg["N"] * cfg["D"])


def segment_flops(cfg: dict, passes: int, kern_evals: int, noise_evals: int) -> float:
    """FLOPs of a segment of `passes` selection passes and the given
    numbers of kernel-round and noise-round evaluations."""
    n, d, q, D = cfg["N"], cfg["d"], cfg["q"], cfg["D"]
    return (passes * pass_flops(n, d, q, D) + kern_evals * kern_eval_flops(cfg)
            + noise_evals * noise_eval_flops(cfg))
