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

Both run K2's blocked routine keeping L (csrc/chol_panel.cu), one block of
1024 threads, float32, any n with 0 < n ≤ 1024: a ragged n is padded inside
the kernel to the next multiple of 128 with the identity, which leaves the
factor exact, and the results are then the n×n corners (views) of the
padded outputs.  The limit is gpc_tpu's (one VMEM-resident block, "n ≤ ~1024")
and is enforced: a wider block raises ValueError.  A CPU tensor takes the
plain version (torch.linalg), at any n and in its own dtype.  Neither kernel
has a backward (gpc_tpu's have none either): on the card an input that needs
a gradient raises instead of losing it.
"""

from __future__ import annotations

import torch

from gpc_tpu_torch.ops import cuda_lib

CHOL_MAX = 1024   # the widest block K5 and K6 take (gpc_tpu's VMEM bound)
_PAD = 128        # the kernels pad n to a multiple of K2's leaf width


def chol_block_plain(A: torch.Tensor) -> torch.Tensor:
    """L of one PD block A (n, n): torch.linalg.cholesky."""
    return torch.linalg.cholesky(A)


def chol_inv_block_plain(A: torch.Tensor):
    """(L, L⁻¹) of one PD block A (n, n), any n: Cholesky, then the
    triangular solve against the identity."""
    L = torch.linalg.cholesky(A)
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def _launch(name: str, A: torch.Tensor, inverse: bool):
    if torch.is_grad_enabled() and A.requires_grad:
        raise RuntimeError(f"{name} (K{5 if inverse else 6}) is forward only; on "
                           "the card differentiate through torch.linalg.cholesky "
                           "(evidence_fast.Policy(leafinv=False or 'xla'))")
    cuda_lib.require_cuda(name, A)
    n = A.shape[0]
    if A.dim() != 2 or A.shape[1] != n or not 0 < n <= CHOL_MAX:
        raise ValueError(f"{name}: want one (n, n) block with 0 < n <= {CHOL_MAX}, "
                         f"got {tuple(A.shape)}")
    npad = -(-n // _PAD) * _PAD
    work = torch.empty((npad, npad), dtype=torch.float32, device=A.device)
    M = torch.empty_like(work)
    # K6 leaves L's blocks above the diagonal unwritten: they start at zero
    L = torch.empty_like(work) if inverse else torch.zeros_like(work)
    cuda_lib.launch(name, "gpc_chol_block", A.data_ptr(), n, npad, work.data_ptr(),
                    L.data_ptr(), M.data_ptr(), int(inverse), cuda_lib.stream_of(A))
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
