"""K1 and K4: the fused Gram tile kernels of the two kernel families.

K1 replaces gpc_tpu/ops/gram_pallas.py::dist_gram (the distance family:
rbf, exp, ratquad, matern32/52), K4 replaces its inner_gram (the
inner-product family: lin, poly, mlp).  `dist_gram` / `inner_gram` launch
the CUDA kernel of `csrc/gram.cu` for a CUDA tensor and take the plain
version (the same math: dist2 or X1·X2ᵀ, then the map) for a CPU tensor.
Both kernels are bound by their n·m·4-byte output on the H100; the design
note is in the source.  Each also takes a leading batch axis, (P, n, q) ×
(P, m, q) → (P, n, m), in one launch over the grid's z axis (PITC's block
Grams; counted as "dist_gram_batched" / "inner_gram_batched").  They read their parameters from the device
(`kernel_params`), so a launch never syncs the host and can be captured in
a CUDA graph.  Their autograd wrappers launch the kernel forward and
recompute the plain map under autograd in the backward.

params follow gpc_tpu.kernels: rbf/exp → [inverseWidth, variance],
ratquad → [alpha, lengthScale, variance], matern32/52 → [lengthScale,
variance]; lin → [variance]; poly/mlp → [weightVariance, biasVariance,
variance], poly's degree a separate float.

The maps keep gpc_tpu/kernels.py's guards, not the Pallas tiles': the sqrt
of exp and matern adds finfo(dtype).tiny, and mlp clamps its arcsin
argument to ±(1 − epsneg(dtype)), so that arcsin′ stays finite where the
argument rounds to 1 (the Pallas tile clips to ±1).
"""

from __future__ import annotations

import torch

from gpc_tpu_torch.linalg import dist2
from gpc_tpu_torch.ops import cuda_lib

FAMILIES = ("rbf", "exp", "ratquad", "matern32", "matern52")
INNER_FAMILIES = ("lin", "poly", "mlp")


def _map(family, d2, p0, p1, p2):
    tiny = torch.finfo(d2.dtype).tiny
    if family == "rbf":
        return p1 * torch.exp(-0.5 * p0 * d2)
    if family == "exp":
        return p1 * torch.exp(-p0 * torch.sqrt(d2 + tiny))
    if family == "ratquad":
        return p2 * torch.pow(1.0 + d2 * (0.5 / (p1 * p1 * p0)), -p0)
    if family == "matern32":
        u = torch.sqrt(d2 * (3.0 / (p0 * p0)) + tiny)
        return p1 * (1.0 + u) * torch.exp(-u)
    if family == "matern52":
        n2 = d2 * (5.0 / (p0 * p0))
        u = torch.sqrt(n2 + tiny)
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


def kernel_params(params, X1: torch.Tensor) -> torch.Tensor:
    """The parameters a Gram kernel reads: float32 on X1's device, padded
    with zeros to 3 in gpc_tpu.kernels' order.  Built on the device from
    the device tensor the model passes (`_padded_params`; a contiguous
    float32 vector of three is used as it is), never read back to the host,
    so a launch does not wait for the device."""
    p = torch.as_tensor(params, dtype=torch.float32, device=X1.device).reshape(-1)
    return p.contiguous() if p.shape[0] == 3 else _padded_params(p, torch.float32, X1.device)


def _kernel_args(name, params, X1, X2):
    """Checks of a Gram kernel's inputs, 2-D or with one leading batch axis;
    (the batch count or None, n, m, q, the padded parameters on the device,
    the output)."""
    cuda_lib.require_cuda(name, X1, X2)
    if (X1.dim() not in (2, 3) or X2.dim() != X1.dim() or X1.shape[-1] != X2.shape[-1]
            or X1.shape[:-2] != X2.shape[:-2]):
        raise ValueError(f"{name}: shapes {tuple(X1.shape)}, {tuple(X2.shape)}")
    batch = X1.shape[0] if X1.dim() == 3 else None
    n, q = X1.shape[-2:]
    m = X2.shape[-2]
    out = torch.empty((*X1.shape[:-2], n, m), dtype=torch.float32, device=X1.device)
    return batch, n, m, q, kernel_params(params, X1), out


def _launch(name, batch, X1, X2, n, m, q, *rest):
    """One launch of a Gram entry point, 2-D or batched."""
    head = (X1.data_ptr(), X2.data_ptr(), n, m, q)
    if batch is None:
        cuda_lib.launch(name, f"gpc_{name}", *head, *rest)
    else:
        cuda_lib.launch(f"{name}_batched", f"gpc_{name}_batched", batch, *head, *rest)


def dist_gram_kernel(family: str, params, X1: torch.Tensor, X2: torch.Tensor):
    """K1 itself on CUDA tensors (float32, contiguous), no autograd; 2-D or
    with one leading batch axis."""
    batch, n, m, q, p, out = _kernel_args("dist_gram", params, X1, X2)
    _launch("dist_gram", batch, X1, X2, n, m, q, FAMILIES.index(family), p.data_ptr(),
            out.data_ptr(), cuda_lib.stream_of(X1))
    return out


def inner_gram_plain(family: str, params, X1: torch.Tensor, X2: torch.Tensor,
                     degree: float = 2.0):
    """The plain PyTorch version of K4 (gram_pallas._inner_fallback's math
    with gpc_tpu/kernels.py's mlp clamp), in X1's dtype."""
    p = _padded_params(params, X1.dtype, X1.device)
    cross = X1 @ X2.mT
    if family == "lin":
        return p[0] * cross
    if family == "poly":
        return p[2] * torch.pow(p[0] * cross + p[1], degree)
    if family != "mlp":
        raise ValueError(f"unknown inner-product family {family!r}")
    numer = p[0] * cross + p[1]
    d1 = p[0] * torch.sum(X1 * X1, dim=-1) + p[1] + 1.0
    d2 = p[0] * torch.sum(X2 * X2, dim=-1) + p[1] + 1.0
    arg = numer / torch.sqrt(d1[..., :, None] * d2[..., None, :])
    lim = 1.0 - torch.finfo(arg.dtype).eps / 2      # 1 − epsneg
    return p[2] * torch.asin(torch.clamp(arg, -lim, lim))


def inner_gram(family: str, params, X1: torch.Tensor, X2: torch.Tensor,
               degree: float = 2.0):
    """(n, m) cross-covariance of an inner-product-family kernel.  CPU
    tensors take the plain version under native autograd; CUDA tensors
    (float32, contiguous) launch K4 through `_InnerGram`."""
    if family not in INNER_FAMILIES:
        raise ValueError(f"unknown inner-product family {family!r}")
    if X1.device.type == "cpu":
        return inner_gram_plain(family, params, X1, X2, degree)
    params = torch.as_tensor(params, dtype=X1.dtype, device=X1.device).reshape(-1)
    return _InnerGram.apply(family, float(degree), params, X1, X2)


class _InnerGram(torch.autograd.Function):
    """K4 forward; the backward recomputes the plain map under autograd, as
    `_DistGram` does (gpc_tpu takes this gradient from XLA)."""

    @staticmethod
    def forward(ctx, family, degree, params, X1, X2):
        ctx.family, ctx.degree = family, degree
        ctx.save_for_backward(params, X1, X2)
        return inner_gram_kernel(family, params, X1, X2, degree)

    @staticmethod
    def backward(ctx, Kbar):
        fn = lambda p, X1, X2: inner_gram_plain(ctx.family, p, X1, X2, ctx.degree)
        return (None, None, *recompute_vjp(fn, ctx.saved_tensors,
                                           ctx.needs_input_grad[2:], Kbar))


def whole_degree(degree: float) -> int:
    """poly's degree as the kernel's multiply count when it is a whole
    number 0 … 16, else −1 (the kernel then calls powf)."""
    return int(degree) if float(degree).is_integer() and 0 <= degree <= 16 else -1


def inner_gram_kernel(family: str, params, X1: torch.Tensor, X2: torch.Tensor,
                      degree: float = 2.0):
    """K4 itself on CUDA tensors (float32, contiguous), no autograd; 2-D or
    with one leading batch axis; degree is a Python number."""
    batch, n, m, q, p, out = _kernel_args("inner_gram", params, X1, X2)
    _launch("inner_gram", batch, X1, X2, n, m, q, INNER_FAMILIES.index(family),
            p.data_ptr(), float(degree), whole_degree(degree), out.data_ptr(),
            cuda_lib.stream_of(X1))
    return out
