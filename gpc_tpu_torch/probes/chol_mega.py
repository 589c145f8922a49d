"""K7: the whole rbf evidence in one persistent launch (a Hopper probe).

Replaces tools/chol_mega_v2.py::evidence_mega_rbf, the superseded TPU
whole-evidence program: (logdet K, Σ_d m_dᵀK⁻¹m_d) for K = rbf-Gram(X) +
noise·I with gpc_tpu's v2 schedule and bf16 policy (design, modes and bounds
in csrc/chol_mega.cu).  No model path reaches it; it measures one
cooperative launch against K3's host loop of per-panel launches
(ops/chol_panel.panel_state_rbf) on the same inputs:

    python -m gpc_tpu_torch.probes.chol_mega [--n 16384] [--q 8] [--reps 3]

prints the card, then ms for each mode and for K3, and the evidence against
the dense f32 one.  Needs CUDA.

The rbf is gpc_tpu's pre-scaled form: Xs = X·√(γ/2), K_rc = var·exp(−max(
‖xs_r‖² + ‖xs_c‖² − 2 xs_r·xs_c, 0)).  N must be a multiple of b with
nb = N/b ≥ 3 (chol_mega_v2.py:209); the kernel takes b = 128, the leaf width.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from gpc_tpu_torch.ops import cuda_lib
from gpc_tpu_torch.ops.chol_panel import LEAF
from gpc_tpu_torch.probes import bf16 as _bf16

MODES = ("full", "noleaf", "nodot", "nodma", "nogram")


def _check(X, m, b, mode):
    N = X.shape[0]
    if mode not in MODES:
        raise ValueError(f"evidence_mega_rbf: mode {mode!r} (want one of {MODES})")
    if b % LEAF or N % b or N // b < 3 or m.shape[0] != N:
        raise ValueError(f"evidence_mega_rbf: want N = nb·b with b a multiple of {LEAF} "
                         f"and nb >= 3 (got X {tuple(X.shape)}, m {tuple(m.shape)}, b={b})")


def _scaled(X, inv_width):
    Xs = (X.float() * math.sqrt(0.5 * float(inv_width))).contiguous()
    return Xs, (Xs * Xs).sum(dim=1)


def evidence_mega_rbf_plain(X, m, inv_width, variance, noise, b: int = LEAF,
                            mode: str = "full"):
    """The plain version, float32 with the kernel's bf16 policy emulated
    (bf16-rounded GEMM inputs, float32 products and sums, as
    ops/evidence_fast._mmp): column by column, the diagonal block and w_j
    corrected by the bf16 factor, the leaf (Cholesky and its triangular
    inverse; the stand-in under "noleaf"), v_j = M_jj w_j in float32, and
    the rows below as L_ij = bf16(bf16(A_ij) bf16(M_jj)ᵀ).  Returns float32
    (logdet, quad)."""
    _check(X, m, b, mode)
    N = X.shape[0]
    nb = N // b
    Xs, n2 = _scaled(X, inv_width)
    var, nz = float(variance), float(noise)
    m32 = m.float()

    def gram(r0, r1, c0, c1):
        d2 = torch.clamp(n2[r0:r1, None] + n2[None, c0:c1] - 2.0 * (Xs[r0:r1] @ Xs[c0:c1].T),
                         min=0.0)
        return var * d2 if mode == "nogram" else var * torch.exp(-d2)

    L = torch.zeros((N, N), dtype=torch.float32, device=X.device)   # bf16 values
    v = torch.zeros_like(m32)
    eye = torch.eye(b, dtype=torch.float32, device=X.device)
    ld = torch.zeros((), dtype=torch.float64, device=X.device)
    for j in range(nb):
        jb, je = j * b, (j + 1) * b
        A = gram(jb, je, jb, je) + nz * eye
        w = m32[jb:je]
        Lj = L[jb:je, :jb]
        if j:
            A = A - Lj @ Lj.T
            w = w - Lj @ _bf16(v[:jb])
        if mode == "noleaf":
            dcol = A.abs().amax(dim=1) + 1.0
            M = torch.diag(1.0 / dcol)
            ld = ld + 2.0 * torch.log(dcol.double()).sum()
        else:
            Lc = torch.linalg.cholesky_ex(A)[0]
            M = torch.linalg.solve_triangular(Lc, eye, upper=False)
            ld = ld + 2.0 * torch.log(torch.diagonal(Lc).double()).sum()
        v[jb:je] = M @ w
        if je < N:
            R = gram(je, N, jb, je)
            if j and mode != "nodot":
                src = Lj.repeat(nb - 1 - j, 1) if mode == "nodma" else L[je:, :jb]
                R = R - src @ Lj.T
            L[je:, jb:je] = _bf16(_bf16(R) @ _bf16(M).T)
    return ld.float(), (v.double() ** 2).sum().float()


def evidence_mega_rbf(X, m, inv_width, variance, noise, b: int = LEAF,
                      mode: str = "full"):
    """K7: (logdet, quad) as 0-dim float32 tensors.  CPU: the plain version.
    CUDA: X (N, q) and m (N, D) float32, b = 128, ONE cooperative launch
    (csrc/chol_mega.cu); the packed Lᵀ slots (nb(nb+1)/2 of b×b bf16, 270 MB
    at N = 16384) are scratch, as in gpc_tpu."""
    _check(X, m, b, mode)
    if X.device.type == "cpu":
        return evidence_mega_rbf_plain(X, m, inv_width, variance, noise, b, mode)
    cuda_lib.require_cuda("evidence_mega_rbf", X, m)
    if b != LEAF:
        raise ValueError(f"evidence_mega_rbf: the kernel takes b = {LEAF} (got {b})")
    N, q = X.shape
    D = m.shape[1]
    nb = N // b
    grid = cuda_lib.library().gpc_mega_grid(nb)
    if grid < 2:
        raise RuntimeError("evidence_mega_rbf: fewer than two blocks are co-resident")
    dev = X.device
    Xs, n2 = _scaled(X, inv_width)
    T = torch.empty((nb * (nb + 1) // 2, b, b), dtype=torch.bfloat16, device=dev)
    Dbuf = torch.empty((nb, b, b), dtype=torch.float32, device=dev)
    w = torch.empty((N, D), dtype=torch.float32, device=dev)
    Mdb = torch.empty((b, b), dtype=torch.bfloat16, device=dev)
    ldj = torch.empty(nb, dtype=torch.float64, device=dev)
    scratch = torch.empty((grid, b, b), dtype=torch.bfloat16, device=dev)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    cuda_lib.launch("evidence_mega_rbf", "gpc_evidence_mega", Xs.data_ptr(),
                    n2.data_ptr(), m.data_ptr(), float(variance), float(noise), N, q,
                    D, MODES.index(mode), grid, T.data_ptr(), Dbuf.data_ptr(),
                    w.data_ptr(), Mdb.data_ptr(), ldj.data_ptr(), scratch.data_ptr(),
                    bar.data_ptr(), out.data_ptr(), cuda_lib.stream_of(X))
    return out[0], out[1]


def probe_args(n: int, q: int, dev):
    """The panel phase's inputs (chip_smoke.panel_args): X ~ N(0, 1)^(n×q),
    m and a column of ones, from numpy's default_rng(0); γ = var = 1,
    noise 0.1."""
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((n, q)), dtype=torch.float32, device=dev)
    m = torch.tensor(rng.standard_normal((n, 1)), dtype=torch.float32, device=dev)
    return X, torch.cat([m, torch.ones_like(m)], dim=1).contiguous(), 1.0, 1.0, 0.1


def main(argv=None):
    from gpc_tpu_torch.ops.chol_panel import panel_state_rbf, panel_state_rbf_plain
    from gpc_tpu_torch.probes import cuda_ms, require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--q", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    print(require_card(), flush=True)
    args = probe_args(a.n, a.q, torch.device("cuda"))
    ld_p, G_p, _, _ = panel_state_rbf_plain(*args)
    quad_p = float(torch.trace(G_p))
    ld, quad = evidence_mega_rbf(*args)
    print(f"K7 N={a.n} q={a.q}: logdet {float(ld)} quad {float(quad)}; dense f32 "
          f"{float(ld_p)} {quad_p} (rel {abs(float(ld) - float(ld_p)) / abs(float(ld_p))}, "
          f"{abs(float(quad) - quad_p) / abs(quad_p)})", flush=True)
    for mode in MODES:
        ms = cuda_ms(lambda: evidence_mega_rbf(*args, mode=mode), a.reps)
        print(f"K7 mode {mode}: {ms} ms", flush=True)
    ms = cuda_ms(lambda: panel_state_rbf(*args), a.reps)
    print(f"K3 panel_state_rbf, same inputs: {ms} ms", flush=True)


if __name__ == "__main__":
    main()
