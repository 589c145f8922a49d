"""The flat evidence schedule of gpc_tpu_torch (ops/evidence_fast.evidence_flat)
against gpc_tpu's, on the CPU.

Same numpy inputs through both packages, float64 unless said:

  * rbf + noise·I through each package's `rbf_block_fn`, leafinv False,
    "xla" and "pallas", at (n, base) = (768, 256) and (1024, 512): within
    1e-10 relative of gpc_tpu and of the dense float64 evidence.  gpc_tpu's
    "pallas" leaves run its Pallas kernel in interpret mode, whose float64
    factor is itself ~1e-7 relative from LAPACK's (the evidence drifts 1e-8
    in logdet and 1.3e-7 in quad), so there the port is held to gpc_tpu
    within 1e-6 and to the dense evidence within 1e-10 (K5's plain version
    is Cholesky and a triangular solve);
  * the bf16 policy and panelhalf in float32: within gpc_tpu's 1e-2 of the
    float64 evidence (its bench gate), and within 1e-4 of gpc_tpu's own bf16
    value (both round the inputs of every product to bf16 and sum in
    float32, in other orders: 5e-6 to 1.1e-5 measured);
  * the general-kernel thunk kern_block_fn on cmpnd(matern32, white);
  * the gradient in X and (inverseWidth, variance, noise) against jax.grad
    of gpc_tpu's, within 1e-8 relative L2, for leafinv False and "xla";
  * the two storage routes (finished columns written in place without a
    gradient, kept as panels with one) give the same value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpc_tpu import kernels as GK
from gpc_tpu.ops import evidence_fast as JEF
from gpc_tpu.ops import lazy_evidence as JLE
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch.ops import evidence_fast as TEF
from gpc_tpu_torch.ops import lazy_evidence as TLE


def _rbf_data(n, q, d, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, q)).astype(dtype), rng.standard_normal((n, d)).astype(dtype)


def _dense(X, m, iw, noise):
    X = np.asarray(X, np.float64)
    n2 = (X * X).sum(1)
    d2 = np.maximum(n2[:, None] + n2[None, :] - 2.0 * X @ X.T, 0.0)
    K = np.exp(-0.5 * iw * d2) + noise * np.eye(X.shape[0])
    L = np.linalg.cholesky(K)
    v = np.linalg.solve(L, np.asarray(m, np.float64))
    return 2.0 * np.log(np.diag(L)).sum(), float((v * v).sum())


def _jax_flat(X, m, pol, hyp=(1.0, 1.0, 0.1)):
    dt = jnp.asarray(X).dtype
    kfn = JLE.rbf_block_fn(jnp.asarray(X), *(jnp.asarray(h, dt) for h in hyp))
    ld, quad = JEF.evidence_flat(kfn, X.shape[0], jnp.asarray(m), pol)
    return float(ld), float(quad)


def _torch_flat(X, m, pol, hyp=(1.0, 1.0, 0.1)):
    kfn = TLE.rbf_block_fn(torch.as_tensor(X), *hyp)
    ld, quad = TEF.evidence_flat(kfn, X.shape[0], torch.as_tensor(m), pol)
    return float(ld), float(quad)


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("leafinv", [False, "xla", "pallas"])
@pytest.mark.parametrize("n,b", [(768, 256), (1024, 512)])
def test_flat_f64_matches_gpc_tpu(n, b, leafinv):
    X, m = _rbf_data(n, 4, 2, 0)
    ld, quad = _torch_flat(X, m, TEF.Policy(b, False, leafinv, True))
    jld, jq = _jax_flat(X, m, JEF.Policy(b, False, leafinv, True))
    wld, wq = _dense(X, m, 1.0, 0.1)
    tol = 1e-6 if leafinv == "pallas" else 1e-10
    assert _rel(ld, jld) < tol and _rel(quad, jq) < tol, (ld, jld, quad, jq)
    assert _rel(ld, wld) < 1e-10 and _rel(quad, wq) < 1e-10, (ld, wld, quad, wq)


@pytest.mark.parametrize("panelhalf", [False, True])
def test_flat_bf16_drift(panelhalf):
    X, m = _rbf_data(1024, 4, 2, 1, np.float32)
    ld, quad = _torch_flat(X, m, TEF.Policy(256, True, False, True, panelhalf=panelhalf))
    jld, jq = _jax_flat(X, m, JEF.Policy(256, True, False, True, panelhalf=panelhalf))
    wld, wq = _dense(X, m, 1.0, 0.1)
    assert _rel(ld, wld) < 1e-2 and _rel(quad, wq) < 1e-2, (ld, wld, quad, wq)
    assert _rel(ld, jld) < 1e-4 and _rel(quad, jq) < 1e-4, (ld, jld, quad, jq)


def test_flat_general_kernel_thunk():
    n, q = 768, 3
    X, m = _rbf_data(n, q, 1, 2)
    jk = GK.Cmpnd(input_dim=q, components=(GK.Matern32(input_dim=q), GK.White(input_dim=q)))
    tk = TK.Cmpnd(input_dim=q, components=(TK.Matern32(input_dim=q), TK.White(input_dim=q)))
    p = jk.default_params()
    jld, jq = JEF.evidence_flat(JLE.kern_block_fn(jk, jnp.asarray(p), jnp.asarray(X)), n,
                                jnp.asarray(m), JEF.Policy(256, False, "xla", True))
    ld, quad = TEF.evidence_flat(TLE.kern_block_fn(tk, torch.as_tensor(p), torch.as_tensor(X)),
                                 n, torch.as_tensor(m), TEF.Policy(256, False, "xla", True))
    assert _rel(float(ld), float(jld)) < 1e-10 and _rel(float(quad), float(jq)) < 1e-10


@pytest.mark.parametrize("leafinv", [False, "xla"])
def test_flat_gradient_matches_jax_grad(leafinv):
    n = 768
    X, m = _rbf_data(n, 3, 1, 3)
    hyp = np.array([0.8, 1.3, 0.1])

    def jobj(X, h):
        kfn = JLE.rbf_block_fn(X, h[0], h[1], h[2])
        ld, quad = JEF.evidence_flat(kfn, n, jnp.asarray(m), JEF.Policy(256, False, leafinv, True))
        return ld + quad

    jgX, jgh = jax.grad(jobj, argnums=(0, 1))(jnp.asarray(X), jnp.asarray(hyp))
    Xt = torch.as_tensor(X).requires_grad_(True)
    ht = torch.as_tensor(hyp).requires_grad_(True)
    ld, quad = TEF.evidence_flat(TLE.rbf_block_fn(Xt, ht[0], ht[1], ht[2]), n, torch.as_tensor(m),
                                 TEF.Policy(256, False, leafinv, True))
    gX, gh = torch.autograd.grad(ld + quad, (Xt, ht))
    for got, want in ((gX, jgX), (gh, jgh)):
        got, want = got.numpy(), np.asarray(want)
        assert np.linalg.norm(got - want) < 1e-8 * np.linalg.norm(want)


def test_flat_storage_routes_agree():
    """Without a gradient the columns land in one buffer; with one they are
    kept as panels.  Both routes compute the same numbers."""
    n = 1024
    X, m = _rbf_data(n, 4, 2, 4)
    pol = TEF.Policy(256, False, "xla", True)
    with torch.no_grad():
        ld0, q0 = _torch_flat(X, m, pol)
    mt = torch.as_tensor(m).requires_grad_(True)
    ld, quad = TEF.evidence_flat(TLE.rbf_block_fn(torch.as_tensor(X), 1.0, 1.0, 0.1), n, mt, pol)
    assert quad.requires_grad
    assert _rel(float(ld), ld0) < 1e-13 and _rel(float(quad), q0) < 1e-13


def test_flat_rejects_bad_geometry():
    X, m = _rbf_data(640, 2, 1, 5)
    kfn = TLE.rbf_block_fn(torch.as_tensor(X), 1.0, 1.0, 0.1)
    for n, b in ((640, 256), (256, 256)):
        with pytest.raises(ValueError):
            TEF.evidence_flat(kfn, n, torch.as_tensor(m[:n]), TEF.Policy(b, False, False, True))
