"""K2 + K3: the panel Cholesky evidence kernel and its diagonal leaf.

Replaces gpc_tpu/ops/chol_panel.py::panel_state_rbf (the `_panel_kernel`
Pallas program, modes "full" and "full+diag") and its leaf
`_factor_diag_fast`.  K5 (`chol_inv_block`, the leaf of
ops/evidence_fast.py's leafinv="pallas") runs on the same leaf routine and
lives in ops/chol_pallas.py, gpc_tpu's module for it; it is re-exported
here.  The CUDA sources are `csrc/chol_panel.cu` and `csrc/chol_tiles.cuh`
(design and bounds noted there).  K3 is a host loop
over 128-wide column panels, three steps per panel (Gram fill minus the
split-K bf16 Schur correction; the K2 leaf with the forward-solve step; the
panel solve with the RHS update), then one launch for G = v·vᵀ and the
logdet sum.

`panel_state_rbf` returns `(logdet, G, v, T)` with gpc_tpu's meaning for
K = rbf-Gram(X) + noise·I, rows/cols ≥ n_valid masked out of the Gram:
  logdet  log|K| (pad rows contribute (N − n_valid)·log noise),
  G       (D, D) = v·vᵀ, G[i, j] = mᵢᵀK⁻¹mⱼ,
  v       (D, N) = L⁻¹m, row-stored,
  T       (N, N) bf16: L below its 128-wide diagonal blocks.  The kernel
          never forms L_jj, so in mode "full" the diagonal blocks hold
          zeros; mode "full+diag" (the training forward) stores bf16(L_jj⁻¹)
          there, lower triangle, for the backward (ops/panel_engine.py).
          Above the diagonal blocks T is zero.  The plain version fills T
          to the same contract.
The inputs are NOT pre-scaled: the rbf map takes γ as rbf's inverseWidth.
"""

from __future__ import annotations

import torch

from gpc_tpu_torch.ops import cuda_lib
from gpc_tpu_torch.ops.chol_pallas import chol_inv_block, chol_inv_block_plain  # noqa: F401
from gpc_tpu_torch.ops.chol_pallas import launch_blocked
from gpc_tpu_torch.ops.gram import dist_gram_plain

LEAF = 128   # the leaf width; the CUDA panel width b is LEAF


def factor_diag_plain(A: torch.Tensor):
    """(L⁻¹, log|A|) of PD blocks A (..., b, b): Cholesky, then its
    triangular inverse and 2·Σ log diag L."""
    L = torch.linalg.cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(A)
    M = torch.linalg.solve_triangular(L, eye, upper=False)
    ld = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
    return M, ld


def factor_diag(A: torch.Tensor):
    """(L⁻¹, log|A|) of a batch of PD blocks A (B, b, b), b a multiple of 128.
    CPU: the plain version.  CUDA: K2, the blocked factorization with its
    inverse (ops/chol_pallas.launch_blocked) on all B blocks at once: one
    128-leaf launch when b = 128."""
    if A.device.type == "cpu":
        return factor_diag_plain(A)
    cuda_lib.require_cuda("factor_diag", A)
    if A.dim() != 3 or A.shape[1] != A.shape[2] or A.shape[1] % LEAF:
        raise ValueError(f"factor_diag: want (B, b, b) with b % {LEAF} == 0, "
                         f"got {tuple(A.shape)}")
    batch, b, _ = A.shape
    M = torch.empty_like(A)
    Lw = torch.empty_like(A)
    ld = torch.empty(batch, dtype=torch.float32, device=A.device)
    launch_blocked("factor_diag", A, b, batch, True, Lw, M, ld)
    return M, ld


MODES = ("full", "full+diag")


def diag_blocks(T: torch.Tensor, b: int = LEAF) -> torch.Tensor:
    """The (N/b, b, b) diagonal blocks of an (N, N) matrix; a view of a
    contiguous T, so writes to it land in T."""
    nb = T.shape[0] // b
    return torch.diagonal(T.reshape(nb, b, nb, b), dim1=0, dim2=2).permute(2, 0, 1)


def panel_state_rbf_plain(X, m, inv_width, variance, noise, n_valid: int = 0,
                          mode: str = "full"):
    """The plain version: masked rbf Gram + noise·I in X's dtype, Cholesky,
    v = L⁻¹m row-stored, G = v·vᵀ, the logdet and T to the kernel's
    contract (module docstring); a ragged N ends in a narrower block."""
    if mode not in MODES:
        raise ValueError(f"panel_state_rbf: mode {mode!r} (want one of {MODES})")
    N = X.shape[0]
    nv = n_valid or N
    params = torch.stack([torch.as_tensor(p, dtype=X.dtype, device=X.device)
                          for p in (inv_width, variance)])
    K = dist_gram_plain("rbf", params, X, X)
    if nv < N:
        valid = torch.arange(N, device=X.device) < nv
        K = torch.where(valid[:, None] & valid[None, :], K, 0.0)
    K = K + noise * torch.eye(N, dtype=K.dtype, device=K.device)
    L = torch.linalg.cholesky(K)
    del K
    v = torch.linalg.solve_triangular(L, m.to(L.dtype), upper=False).T
    ld = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    T = L.to(torch.bfloat16)
    for j0 in range(0, N, LEAF):
        blk = slice(j0, min(j0 + LEAF, N))
        if mode == "full+diag":
            Ljj = L[blk, blk]
            eye = torch.eye(Ljj.shape[0], dtype=L.dtype, device=L.device)
            T[blk, blk] = torch.linalg.solve_triangular(Ljj, eye, upper=False)
        else:
            T[blk, blk] = 0
    return ld, v @ v.T, v.contiguous(), T


def panel_state_rbf(X, m, inv_width, variance, noise, b: int = LEAF,
                    n_valid: int = 0, mode: str = "full"):
    """Panel evidence state (logdet, G, v, T), module docstring.  CPU: the
    plain version.  CUDA: X (N, q) and m (N, D) float32 with N % 128 == 0,
    b = 128, through the K3 launches; mode "full+diag" also has each leaf
    store bf16(L_jj⁻¹) into T's diagonal block."""
    if mode not in MODES:
        raise ValueError(f"panel_state_rbf: mode {mode!r} (want one of {MODES})")
    if X.device.type == "cpu":
        return panel_state_rbf_plain(X, m, inv_width, variance, noise, n_valid, mode)
    cuda_lib.require_cuda("panel_state_rbf", X, m)
    N, q = X.shape
    D = m.shape[1]
    nv = n_valid or N
    if b != LEAF or N % LEAF or m.shape[0] != N or not 0 < nv <= N:
        raise ValueError(f"panel_state_rbf: need b={LEAF}, N % {LEAF} == 0, "
                         f"0 < n_valid <= N (got b={b}, X {tuple(X.shape)}, "
                         f"m {tuple(m.shape)}, n_valid={n_valid})")
    diag = mode == "full+diag"
    nb = N // LEAF
    gamma, var, nz = float(inv_width), float(variance), float(noise)
    dev = X.device
    T = torch.zeros((N, N), dtype=torch.bfloat16, device=dev)
    acc = torch.empty((N, LEAF), dtype=torch.float32, device=dev)
    part = torch.empty((2 * N, LEAF), dtype=torch.float32, device=dev)  # split-K
    Md = torch.empty((LEAF, LEAF), dtype=torch.float32, device=dev)
    ldj = torch.empty(nb, dtype=torch.float64, device=dev)
    v = m.T.contiguous()
    G = torch.empty((D, D), dtype=torch.float32, device=dev)
    ld = torch.empty((), dtype=torch.float32, device=dev)
    s = cuda_lib.stream_of(X)
    for j in range(nb):
        jb = j * LEAF
        cuda_lib.launch("panel_fill", "gpc_panel_fill", X.data_ptr(), q,
                        T.data_ptr(), N, jb, nv, gamma, var, part.data_ptr(),
                        part.shape[0], acc.data_ptr(), s)
        cuda_lib.launch("panel_leaf_diag" if diag else "factor_diag",
                        "gpc_panel_leaf", acc.data_ptr(), nz, Md.data_ptr(),
                        v.data_ptr(), D, N, jb, ldj[j:].data_ptr(),
                        T.data_ptr() if diag else None, s)
        if j + 1 < nb:   # the last panel has no rows below it
            cuda_lib.launch("panel_solve", "gpc_panel_solve", acc.data_ptr(),
                            Md.data_ptr(), T.data_ptr(), v.data_ptr(), D, N,
                            jb, s)
    cuda_lib.launch("panel_state_rbf", "gpc_panel_finish", v.data_ptr(), D, N,
                    ldj.data_ptr(), nb, G.data_ptr(), ld.data_ptr(), s)
    return ld, G, v, T
