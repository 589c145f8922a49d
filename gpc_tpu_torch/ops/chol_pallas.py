"""K5 and K6: one PD block's Cholesky factor, and its inverse, in one kernel.

Counterpart of gpc_tpu/ops/chol_pallas.py:

  chol_block      K6, replaces `chol_block` (`_chol_kernel`, the masked
                  column sweep): L of one block.  No model path of gpc_tpu
                  calls it (its blocked Cholesky keeps XLA's for the base
                  case); it is a standalone op here too.
  chol_inv_block  K5, replaces `chol_inv_block`: (L, L⁻¹) of one block, both
                  of gpc_tpu's branches (the fused blocked kernel for n a
                  multiple of 128, the masked sweep with a forward-substitution
                  inverse for any other n); the leaf of
                  ops/evidence_fast.py's default Policy.
                  `chol_inv_block_fused` is the same call under the name
                  of gpc_tpu's fused kernel (n a multiple of 128).

Both run the blocked factorization of csrc/chol_panel.cu
(`gpc_chol_blocked`), float32, any n with 0 < n ≤ 1024: a ragged n is padded
on the card to the next multiple of 128 with the identity, which leaves the
factor exact, and the results are then the n×n corners (views) of the
padded outputs.  The factorization is a plan of launches (`chol_plan`): per
128-panel the 128-leaf on one block, the panel solve on one block per tile
below it and the trailing update on one block per lower tile; K5 adds the
diagonals of the block inverse.  `launch_blocked` runs a plan; K2
(ops/chol_panel.factor_diag) uses it for its batches.  The limit is
gpc_tpu's (one VMEM-resident block, "n ≤ ~1024") and is enforced: a wider
block raises ValueError.  A CPU tensor takes the plain version
(torch.linalg), at any n and in its own dtype.  Neither kernel has a
backward (gpc_tpu's have none either): on the card an input that needs a
gradient raises instead of losing it.  LAUNCHES counts calls (one per K5 or
K6 call); `plan_kernels` gives the kernel launches a call makes.
"""

from __future__ import annotations

import numpy as np
import torch

from gpc_tpu_torch.ops import cuda_lib

CHOL_MAX = 1024   # the widest block K5 and K6 take (gpc_tpu's VMEM bound)
_PAD = 128        # the leaf width: the kernels pad n to a multiple of it


def chol_block_plain(A: torch.Tensor) -> torch.Tensor:
    """L of one PD block A (n, n): torch.linalg.cholesky."""
    return torch.linalg.cholesky(A)


def chol_inv_block_plain(A: torch.Tensor):
    """(L, L⁻¹) of one PD block A (n, n), any n: Cholesky, then the
    triangular solve against the identity."""
    L = torch.linalg.cholesky(A)
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


LEAF_STEP, SOLVE_STEP, UPDATE_STEP, INV_STEP = range(4)   # csrc's StepKind


def chol_plan(nbl: int, inverse: bool):
    """The launches of the blocked factorization of an (nbl·128)² block, in
    stream order: (kind, p, tiles), tiles the (i, j) 128-tiles the step's
    blocks own (one block each).  Per panel p: the leaf of (p, p); the panel
    solve of the tiles (i, p) below it; the trailing update of the lower
    tiles (i, j), p < j ≤ i.  With `inverse`, then per diagonal d = 1 …
    nbl − 1 the tiles (j + d, j) of the block inverse."""
    steps = []
    for p in range(nbl):
        steps.append((LEAF_STEP, p, [(p, p)]))
        if p + 1 < nbl:
            steps.append((SOLVE_STEP, p, [(i, p) for i in range(p + 1, nbl)]))
            steps.append((UPDATE_STEP, p, [(i, j) for j in range(p + 1, nbl)
                                           for i in range(j, nbl)]))
    if inverse:
        for d in range(1, nbl):
            steps.append((INV_STEP, d, [(j + d, j) for j in range(nbl - d)]))
    return steps


def plan_kernels(n: int, inverse: bool) -> int:
    """Kernel launches of one call at size n: the plan's steps, and the
    padding copy when n is ragged (an input that does not start 16-byte
    aligned adds the same copy)."""
    npad = -(-n // _PAD) * _PAD
    return len(chol_plan(npad // _PAD, inverse)) + (npad != n)


_PLANS: dict = {}


def _packed_plan(nbl: int, inverse: bool, device):
    """(steps, tiles): the plan as host int32 rows (kind, p, first tile,
    tiles) for the C loop, and its tiles as a device int32 (T, 2) tensor,
    built once per (nbl, inverse, device)."""
    key = (nbl, inverse, str(device))
    if key not in _PLANS:
        rows, tiles = [], []
        for kind, p, ts in chol_plan(nbl, inverse):
            rows.append((kind, p, len(tiles), len(ts)))
            tiles.extend(ts)
        _PLANS[key] = (np.ascontiguousarray(rows, dtype=np.int32),
                       torch.tensor(tiles, dtype=torch.int32, device=device))
    return _PLANS[key]


def launch_blocked(count_as: str, A: torch.Tensor, n: int, batch: int, inverse: bool,
                   L: torch.Tensor, M: torch.Tensor, ld=None):
    """Run the blocked factorization of A (batch blocks of n × n, float32,
    contiguous, on the card) into L and M (batch blocks of npad × npad);
    with `ld` (batch floats) also each block's logdet."""
    npad = L.shape[-1]
    steps, tiles = _packed_plan(npad // _PAD, inverse, A.device)
    # the kernels read 16-byte rows: a ragged n, or an input that does not
    # start 16-byte aligned, is first copied into the workspace
    copy = npad != n or A.data_ptr() % 16 != 0
    work = (torch.empty((batch, npad, npad), dtype=torch.float32, device=A.device)
            if npad > _PAD or copy else None)
    ldw = (torch.empty(batch, dtype=torch.float64, device=A.device)
           if ld is not None else None)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    cuda_lib.launch(count_as, "gpc_chol_blocked", A.data_ptr(), n, int(copy), npad, batch,
                    ptr(work), L.data_ptr(), M.data_ptr(), ptr(ldw), ptr(ld),
                    steps.ctypes.data, steps.shape[0], tiles.data_ptr(), int(inverse),
                    cuda_lib.stream_of(A))


def _launch(name: str, A: torch.Tensor, inverse: bool):
    if torch.is_grad_enabled() and A.requires_grad:
        raise RuntimeError(f"{name} (K{5 if inverse else 6}) is forward only; on "
                           "the card differentiate through torch.linalg.cholesky "
                           "(evidence_fast.Policy(leafinv=False))")
    cuda_lib.require_cuda(name, A)
    n = A.shape[0]
    if A.dim() != 2 or A.shape[1] != n or not 0 < n <= CHOL_MAX:
        raise ValueError(f"{name}: want one (n, n) block with 0 < n <= {CHOL_MAX}, "
                         f"got {tuple(A.shape)}")
    npad = -(-n // _PAD) * _PAD
    L = torch.empty((npad, npad), dtype=torch.float32, device=A.device)
    M = torch.empty_like(L)
    launch_blocked(name, A, n, 1, inverse, L, M)
    if npad == n:
        return L, M
    return L[:n, :n], M[:n, :n]


def chol_block(A: torch.Tensor) -> torch.Tensor:
    """K6: the lower Cholesky factor of one PD block A (n, n), zeros above
    the diagonal.  CPU: the plain version.  CUDA: float32, 0 < n ≤ 1024."""
    if A.device.type == "cpu":
        return chol_block_plain(A)
    return _launch("chol_block", A, inverse=False)[0]


def chol_inv_block(A: torch.Tensor):
    """K5: (L, L⁻¹) of one PD block A (n, n), both lower with zeros above.
    CPU: the plain version.  CUDA: float32, 0 < n ≤ 1024."""
    if A.device.type == "cpu":
        return chol_inv_block_plain(A)
    return _launch("chol_inv_block", A, inverse=True)


def chol_inv_block_fused(A: torch.Tensor):
    """K5 under the name of gpc_tpu's fused kernel (n a multiple of 128,
    gpc_tpu/ops/chol_pallas.py:204): the same launch plan as
    `chol_inv_block`, which takes both of gpc_tpu's branches.  It is here
    for parity of names only: the port's own paths call `chol_inv_block`."""
    if A.shape[0] % _PAD:
        raise ValueError(f"chol_inv_block_fused: n = {A.shape[0]} is not a multiple of {_PAD}")
    return chol_inv_block(A)
