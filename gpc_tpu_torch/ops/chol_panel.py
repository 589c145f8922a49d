"""K2 + K3: the panel Cholesky evidence kernel and its diagonal leaf.

Replaces gpc_tpu/ops/chol_panel.py::panel_state_rbf (the `_panel_kernel`
Pallas program, modes "full" and "full+diag") and its leaf
`_factor_diag_fast`.  K5 (`chol_inv_block`, the leaf of
ops/evidence_fast.py's leafinv="pallas") runs on the same leaf routine and
lives in ops/chol_pallas.py, gpc_tpu's module for it; it is re-exported
here.  The CUDA sources are `csrc/chol_panel.cu` and `csrc/chol_tiles.cuh`
(design and bounds noted there).

K3 is a plan of launches over 128-wide column panels (`panel_plan`, plain
Python like chol_pallas.chol_plan) that one C entry walks on two streams
of its own, forked from and joined to the caller's: per panel the Gram
fill of the diagonal block minus its split-K Schur correction, the K2 leaf
with the forward-solve step and the panel solve with the RHS update on a
high-priority stream, while the fill of the rows below runs beside the
leaf on a low-priority one; one last launch forms G = v·vᵀ and the logdet
sum.  The correction is a wgmma kernel fed by TMA; it re-streams
T[jb:N, :jb] for every panel, so it is bound by bytes (11.45 GB, 3.42 ms
at N = 16384), and the chain of leaves is hidden under it.  A call makes
one ctypes call whatever N is.

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

import collections
import ctypes

import numpy as np
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


# panel_plan: step kinds (csrc/chol_panel.cu's PanelStepKind), streams, events
FILL, LEAF_STEP, SOLVE, FINISH, FORK, JOIN = range(6)
CALLER, CHAIN, BELOW = range(3)   # the caller's stream; the leaf chain's at the highest
                                  # priority; the fills below at the lowest
FORKED, DIAG_READY, BELOW_DONE, DONE = range(4)
CORR_BK = 64                  # the correction's k chunk (csrc's CW_BK)
UNIT_COST = 2                 # a unit's pipeline fill and partials store, in chunk-times
PART_COST = 0.04              # a split's reduction, in chunk-times per 128-row tile

PanelStep = collections.namedtuple(
    "PanelStep", "kind stream j row0 row1 splits grid buf wait record")


def corr_split(tiles: int, kc: int, grid: int):
    """(splits, grid) of one correction launch: `tiles` 128-row tiles, kc
    k chunks, at most `grid` blocks.  Minimises the critical block's work,
    waves·(⌈kc/splits⌉ + UNIT_COST) chunk-times, plus PART_COST per tile and
    split for the partials the reduction reads; each split gets at least
    one chunk."""
    best = None
    for s in range(1, min(kc, grid) + 1):
        units = tiles * s
        cost = -(-units // grid) * (-(-kc // s) + UNIT_COST) + PART_COST * s * tiles
        if best is None or cost < best[0]:
            best = (cost, s, min(units, grid))
    return best[1], best[2]


def panel_plan(N: int, sms: int = 132):
    """K3's launches in host order, as PanelSteps (kind, stream, panel j,
    rows [row0, row1), splits and grid of the correction, the partials
    buffer it writes, the event waited on before and recorded after, -1 for
    none).  FORK records FORKED on the
    caller's stream.  Per panel j, on CHAIN: the fill of the diagonal
    block's rows (records DIAG_READY), the leaf, and unless j is the last
    panel the solve, which waits BELOW_DONE; on BELOW, unless j is the last
    panel, the fill of the rows below (waits DIAG_READY, so it runs beside
    the leaf, on at most sms − 1 blocks so that the leaf finds an SM;
    records BELOW_DONE).  The diagonal fill thus runs alone, after the
    solve before it.  FINISH on CHAIN records DONE, and JOIN waits for it
    on the caller's stream.  A fill at jb = 0 has no correction (splits 0);
    the diagonal fills write their partials to buffer 0, the fills below
    to buffer 1."""
    nb = N // LEAF
    steps = [PanelStep(FORK, CALLER, 0, 0, 0, 0, 0, 0, -1, FORKED)]
    for j in range(nb):
        jb = j * LEAF
        kc = jb // CORR_BK
        split = corr_split(1, kc, sms) if kc else (0, 0)
        steps.append(PanelStep(FILL, CHAIN, j, jb, jb + LEAF, *split, 0,
                               FORKED if j == 0 else -1, DIAG_READY))
        if j + 1 < nb:
            split = corr_split(nb - j - 1, kc, sms - 1) if kc else (0, 0)
            steps.append(PanelStep(FILL, BELOW, j, jb + LEAF, N, *split, 1, DIAG_READY,
                                   BELOW_DONE))
        steps.append(PanelStep(LEAF_STEP, CHAIN, j, jb, jb + LEAF, 0, 0, 0, -1, -1))
        if j + 1 < nb:
            steps.append(PanelStep(SOLVE, CHAIN, j, jb + LEAF, N, 0, 0, 0, BELOW_DONE, -1))
    steps.append(PanelStep(FINISH, CHAIN, nb, 0, N, 0, 0, 0, -1, DONE))
    steps.append(PanelStep(JOIN, CALLER, nb, 0, 0, 0, 0, 0, DONE, -1))
    return steps


def part_floats(steps):
    """Floats of the split partials the plan's largest correction writes
    into each buffer (at least 1)."""
    sizes = ([1], [1])
    for st in steps:
        if st.kind == FILL:
            sizes[st.buf].append(st.splits * (st.row1 - st.row0) * LEAF)
    return max(sizes[0]), max(sizes[1])


# the launches gpc_panel_state counts, by kernel, in its order (csrc's
# PanelCount), under LAUNCHES' names; None: the leaf's, which is
# factor_diag, or panel_leaf_diag in mode "full+diag"
K3_COUNTS = ("panel_corr", "panel_fill", "panel_fill_below", None, "panel_solve",
             "panel_finish")

_PANEL_PLANS: dict = {}


def _packed_panel_plan(N: int, sms: int):
    """(host int32 rows for the C walker, the partials' floats), built once
    per (N, sms)."""
    key = (N, sms)
    if key not in _PANEL_PLANS:
        steps = panel_plan(N, sms)
        _PANEL_PLANS[key] = (np.ascontiguousarray(steps, dtype=np.int32), part_floats(steps))
    return _PANEL_PLANS[key]


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def panel_corr_plain(T, jb: int, row0: int, row1: int, splits: int):
    """The correction's partials in float32: part[s] = T[row0:row1, ks]
    T[jb:jb+128, ks]ᵀ over split s's chunks ks of [0, jb)."""
    kc = jb // CORR_BK
    A, B = T[row0:row1].float(), T[jb:jb + LEAF].float()
    out = []
    for s in range(splits):
        k0, k1 = s * kc // splits * CORR_BK, (s + 1) * kc // splits * CORR_BK
        out.append(A[:, k0:k1] @ B[:, k0:k1].T)
    return torch.stack(out)


def panel_corr(T, jb: int, row0: int, row1: int, splits: int, grid: int = 0):
    """One launch of K3's correction kernel alone: the (splits, row1 − row0,
    128) float32 partials of T[row0:row1, :jb] T[jb:jb+128, :jb]ᵀ, split as
    panel_corr_plain, on `grid` blocks (0: one per unit, at most the SMs).
    CPU: the plain version."""
    if T.device.type == "cpu":
        return panel_corr_plain(T, jb, row0, row1, splits)
    N = T.shape[0]
    kc = jb // CORR_BK
    if (T.dtype != torch.bfloat16 or not T.is_contiguous() or T.shape != (N, N) or N % LEAF
            or jb % LEAF or not 0 < jb < N or row0 % LEAF or (row1 - row0) % LEAF
            or not 0 <= row0 < row1 <= N or not 0 < splits <= kc):
        raise ValueError(f"panel_corr: want T (N, N) bf16 contiguous, N % 128 == 0, "
                         f"0 < jb < N, 128-aligned rows, 0 < splits <= jb / 64 (got T "
                         f"{tuple(T.shape)} {T.dtype}, jb={jb}, rows [{row0}, {row1}), "
                         f"splits={splits})")
    units = (row1 - row0) // LEAF * splits
    grid = min(grid or units, units, _sm_count(T.device))
    part = torch.empty((splits, row1 - row0, LEAF), dtype=torch.float32, device=T.device)
    cuda_lib.launch("panel_corr", "gpc_panel_corr", T.data_ptr(), N, row0, row1, jb, splits,
                    grid, part.data_ptr(), cuda_lib.stream_of(T))
    return part


def panel_state_rbf(X, m, inv_width, variance, noise, b: int = LEAF,
                    n_valid: int = 0, mode: str = "full"):
    """Panel evidence state (logdet, G, v, T), module docstring.  CPU: the
    plain version.  CUDA: X (N, q) and m (N, D) float32 with N % 128 == 0,
    b = 128: one walk of panel_plan(N) in C; mode "full+diag" also has each
    leaf store bf16(L_jj⁻¹) into T's diagonal block.  LAUNCHES gains the
    launches the walk counted, by kernel (K3_COUNTS)."""
    if mode not in MODES:
        raise ValueError(f"panel_state_rbf: mode {mode!r} (want one of {MODES})")
    if X.device.type == "cpu":
        return panel_state_rbf_plain(X, m, inv_width, variance, noise, n_valid, mode)
    cuda_lib.require_cuda("panel_state_rbf", X, m)
    N, q = X.shape
    D = m.shape[1]
    nv = n_valid or N
    if b != LEAF or N % LEAF or m.shape[0] != N or not 0 < nv <= N or D < 1:
        raise ValueError(f"panel_state_rbf: need b={LEAF}, N % {LEAF} == 0, "
                         f"0 < n_valid <= N, D >= 1 (got b={b}, "
                         f"X {tuple(X.shape)}, m {tuple(m.shape)}, n_valid={n_valid})")
    diag = mode == "full+diag"
    dev = X.device
    rows, (n_diag, n_below) = _packed_panel_plan(N, _sm_count(dev))
    T = torch.zeros((N, N), dtype=torch.bfloat16, device=dev)
    acc = torch.empty((N, LEAF), dtype=torch.float32, device=dev)
    part = torch.empty(n_diag + n_below, dtype=torch.float32, device=dev)
    Md = torch.empty((LEAF, LEAF), dtype=torch.float32, device=dev)
    ldj = torch.empty(N // LEAF, dtype=torch.float64, device=dev)
    v = m.T.clone(memory_format=torch.contiguous_format)   # a copy even at D = 1: m stays
    G = torch.empty((D, D), dtype=torch.float32, device=dev)
    ld = torch.empty((), dtype=torch.float32, device=dev)
    XT = X.T.contiguous()   # the Gram fill reads the panel's columns as float4
    counts = (ctypes.c_int * len(K3_COUNTS))()
    cuda_lib.launch("panel_state_rbf", "gpc_panel_state", X.data_ptr(), XT.data_ptr(), q,
                    v.data_ptr(), D, N,
                    nv, float(inv_width), float(variance), float(noise), T.data_ptr(),
                    acc.data_ptr(), part.data_ptr(), part[n_diag:].data_ptr(), Md.data_ptr(),
                    ldj.data_ptr(),
                    G.data_ptr(), ld.data_ptr(), int(diag), rows.ctypes.data, rows.shape[0],
                    cuda_lib.stream_of(X), counts)
    leaf = "panel_leaf_diag" if diag else "factor_diag"
    cuda_lib.LAUNCHES.update({name or leaf: n for name, n in zip(K3_COUNTS, counts) if n})
    return ld, G, v, T
