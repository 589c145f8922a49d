"""Model FLOPs and bytes, fixed from a configuration's shapes alone: the
same whatever implements the work, so that a later change to the program
cannot move them.  A Gram entry of the distance family costs 2q + 6
(a q-dot, the distance, the scaled exponent, the variance), as K1's bound
counts it (chip_smoke.k1_bound)."""

from __future__ import annotations

GRAM_ENTRY = 6      # the distance family's cost of a Gram entry beyond its q-dot


def gram(n: float, m: float, q: int) -> float:
    return n * m * (2 * q + GRAM_ENTRY)


def ftc_forward(n: int, q: int, d: int) -> float:
    """The FTC evidence (utils/profiling.evidence_flops): the Gram 2N²q,
    the Cholesky N³/3 and the solves 2N²D."""
    return 2.0 * n * n * q + n ** 3 / 3.0 + 2.0 * n * n * d


def ftc_gradient(n: int, q: int, d: int) -> float:
    """θ̄ of the FTC evidence: the K⁻¹ that the trace term needs, 2N³/3 (a
    triangular inverse and its product), the Gram's gradient (the Gram
    entries again and their contraction with K̄, N²(2q + 6)) and the
    outer product αα^T of the quadratic term, N²D."""
    return 2.0 * n ** 3 / 3.0 + gram(n, n, q) + 1.0 * n * n * d


def ftc_evaluation(n: int, q: int, d: int) -> float:
    return ftc_forward(n, q, d) + ftc_gradient(n, q, d)


def dtc_forward(n: int, m: int, q: int, d: int) -> float:
    """The DTC evidence: K_uf and K_uu, the M-Cholesky of K_uu, the M × N
    solve V = L_uu⁻¹K_uf (M²N), V·V^T (2M²N), the second M-Cholesky, and
    the data's products V·m and its solve (2MND + M²D)."""
    return (gram(m, n, q) + gram(m, m, q) + 2 * m ** 3 / 3.0 + 1.0 * m * m * n
            + 2.0 * m * m * n + 2.0 * m * n * d + 1.0 * m * m * d)


def dtc_gradient(n: int, m: int, q: int, d: int) -> float:
    """θ̄ and X̄_u of the DTC evidence: each product's reverse is two products
    of its size (V·V^T: 4M²N; the solve: its transpose solve M²N and the
    factor's cotangent 2M²N), the two Cholesky backwards (2M³ each) and the
    Gram's gradient in X_u and θ (twice its entries' cost)."""
    return (4.0 * m * m * n + 3.0 * m * m * n + 4.0 * m ** 3
            + 2 * gram(m, n, q) + 2 * gram(m, m, q) + 4.0 * m * n * d)


def dtc_evaluation(n: int, m: int, q: int, d: int) -> float:
    return dtc_forward(n, m, q, d) + dtc_gradient(n, m, q, d)


def evaluation(cfg: dict) -> float:
    """FLOPs of one value_and_grad evaluation of the configuration."""
    n, q, d = cfg["N"], cfg["q"], cfg["D"]
    if cfg["approx"] == "ftc":
        return ftc_evaluation(n, q, d)
    return dtc_evaluation(n, cfg["M"], q, d)


def request(cfg: dict, t: int) -> float:
    """FLOPs of a prediction for t rows: the cross-Gram, the mean's product
    and the variance's triangular solve (N²T for FTC: a solve, not the
    explicit inverse's 2N²T, so a solve-based server is not penalised; two
    M-solves for DTC) with its row sums."""
    n, q, d = cfg["N"], cfg["q"], cfg["D"]
    if cfg["approx"] == "ftc":
        return gram(n, t, q) + 2.0 * n * t * d + 1.0 * n * n * t + 2.0 * n * t
    m = cfg["M"]
    return gram(m, t, q) + 2.0 * m * t * d + 2.0 * m * m * t + 4.0 * m * t


def request_bytes(cfg: dict, t: int) -> float:
    """Bytes a prediction for t rows must move at least, in float32: the
    posterior state read once (FTC: X, α and the triangle of the factor,
    N²/2; DTC: X_u, u and the two M-triangles) and the t inputs and 2t
    outputs."""
    n, q, d = cfg["N"], cfg["q"], cfg["D"]
    if cfg["approx"] == "ftc":
        state = n * q + n * d + n * n / 2.0
    else:
        m = cfg["M"]
        state = m * q + m * d + m * m
    return 4.0 * (state + t * q + 2 * t * d)
