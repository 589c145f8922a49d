"""K1: distance-family cross-covariance (the fused Gram tile kernel).

Replaces gpc_tpu/ops/gram_pallas.py::dist_gram.  `dist_gram` launches the
CUDA kernel of `csrc/gram.cu` for a CUDA tensor and takes `dist_gram_plain`
(dist2 + map, the same math) for a CPU tensor.  The kernel is bound by its
n·m·4-byte output on the H100; its design note is in the source.

params follow gpc_tpu.kernels: rbf/exp → [inverseWidth, variance],
ratquad → [alpha, lengthScale, variance], matern32/52 → [lengthScale,
variance].
"""

from __future__ import annotations

import torch

from gpc_tpu_torch.linalg import dist2
from gpc_tpu_torch.ops import cuda_lib

FAMILIES = ("rbf", "exp", "ratquad", "matern32", "matern52")


def _map(family, d2, p0, p1, p2):
    if family == "rbf":
        return p1 * torch.exp(-0.5 * p0 * d2)
    if family == "exp":
        return p1 * torch.exp(-p0 * torch.sqrt(d2 + 1e-30))
    if family == "ratquad":
        return p2 * torch.pow(1.0 + d2 * (0.5 / (p1 * p1 * p0)), -p0)
    if family == "matern32":
        u = torch.sqrt(d2 * (3.0 / (p0 * p0)) + 1e-30)
        return p1 * (1.0 + u) * torch.exp(-u)
    if family == "matern52":
        n2 = d2 * (5.0 / (p0 * p0))
        u = torch.sqrt(n2 + 1e-30)
        return p1 * (1.0 + u + n2 / 3.0) * torch.exp(-u)
    raise ValueError(f"unknown distance family {family!r}")


def _padded_params(params, dtype, device):
    p = torch.zeros(3, dtype=dtype, device=device)
    params = torch.as_tensor(params, dtype=dtype, device=device).reshape(-1)
    p[:params.shape[0]] = params
    return p


def dist_gram_plain(family: str, params, X1: torch.Tensor, X2: torch.Tensor):
    """The plain PyTorch version: dist2 then the map, in X1's dtype."""
    p = _padded_params(params, X1.dtype, X1.device)
    return _map(family, dist2(X1, X2), p[0], p[1], p[2])


def dist_gram(family: str, params, X1: torch.Tensor, X2: torch.Tensor):
    """(n, m) cross-covariance of a distance-family kernel.  CPU tensors take
    the plain version under native autograd; CUDA tensors (float32,
    contiguous) launch K1 through `_DistGram`, whose backward gives the
    gradient in params, X1 and X2."""
    if family not in FAMILIES:
        raise ValueError(f"unknown distance family {family!r}")
    if X1.device.type == "cpu":
        return dist_gram_plain(family, params, X1, X2)
    params = torch.as_tensor(params, dtype=X1.dtype, device=X1.device).reshape(-1)
    return _DistGram.apply(family, params, X1, X2)


def recompute_vjp(fn, tensors, needs, cotangent):
    """The vector-Jacobian product of fn(*tensors) with `cotangent`, for
    the tensors whose `needs` flag is set (None for the others), by
    recomputing fn under autograd on detached copies."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip(tensors, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    if not wanted:
        return [None] * len(inputs)
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(fn(*inputs), wanted, cotangent))
    return [next(grads) if t.requires_grad else None for t in inputs]


class _DistGram(torch.autograd.Function):
    """K1 forward; the backward recomputes the plain map under autograd from
    the saved inputs (gpc_tpu takes this gradient from XLA outside the
    Pallas kernel, so it has no backward kernel).  When X1 is X2 the two
    cotangents add up in autograd's accumulation."""

    @staticmethod
    def forward(ctx, family, params, X1, X2):
        ctx.family = family
        ctx.save_for_backward(params, X1, X2)
        return dist_gram_kernel(family, params, X1, X2)

    @staticmethod
    def backward(ctx, Kbar):
        return (None, *recompute_vjp(lambda *a: dist_gram_plain(ctx.family, *a),
                                     ctx.saved_tensors, ctx.needs_input_grad[1:], Kbar))


def dist_gram_kernel(family: str, params, X1: torch.Tensor, X2: torch.Tensor):
    """K1 itself on CUDA tensors (float32, contiguous), no autograd."""
    cuda_lib.require_cuda("dist_gram", X1, X2)
    if X1.dim() != 2 or X2.dim() != 2 or X1.shape[1] != X2.shape[1]:
        raise ValueError(f"dist_gram: shapes {tuple(X1.shape)}, {tuple(X2.shape)}")
    n, q = X1.shape
    m = X2.shape[0]
    p = [float(v) for v in torch.as_tensor(params).reshape(-1).tolist()]
    p += [0.0] * (3 - len(p))
    out = torch.empty((n, m), dtype=torch.float32, device=X1.device)
    cuda_lib.launch("dist_gram", "gpc_dist_gram", X1.data_ptr(), X2.data_ptr(),
                    n, m, q, FAMILIES.index(family), p[0], p[1], p[2],
                    out.data_ptr(), cuda_lib.stream_of(X1))
    return out
