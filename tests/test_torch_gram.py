"""K1 and K4 (gpc_tpu_torch/ops/gram.py) against gpc_tpu's fused Gram tiles.

The port's plain versions run on the CPU; the Pallas tile kernels run in
interpret mode.  Both compute in float32 from the same numpy inputs, so
they differ only in summation order: rtol/atol 2e-5 for K1 and 2e-4 for K4
(the power and arcsin maps), as tests/test_gram_pallas.py holds the Pallas
kernels to gpc_tpu's kernels.  The CUDA kernels are compared with the plain
versions on the card in tests/test_torch_cuda.py; their autograd wrappers
run here with the launch swapped for the plain version.  The kernels' launch
path runs here too, with the CUDA checks and the launch recorded: it must
hand the kernel a device pointer to gpc_tpu's parameters padded to 3 and
read no tensor back to the host.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gpc_tpu import kernels as GK
from gpc_tpu.ops.gram_pallas import dist_gram as jax_dist_gram
from gpc_tpu.ops.gram_pallas import inner_gram as jax_inner_gram
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch import linalg as TL
from gpc_tpu_torch.ops import gram as TG

PARAMS = {"rbf": [0.7, 1.3], "exp": [0.7, 1.3], "ratquad": [1.5, 0.8, 1.3],
          "matern32": [0.9, 1.3], "matern52": [0.9, 1.3]}
INNER = {"lin": [1.3], "poly": [0.7, 0.4, 1.3], "mlp": [10.0, 10.0, 1.3]}


@pytest.mark.parametrize("family", TG.FAMILIES)
def test_plain_matches_pallas_interpret(family):
    rng = np.random.default_rng(11)
    X1 = rng.standard_normal((256, 4)).astype(np.float32)
    X2 = rng.standard_normal((256, 4)).astype(np.float32)
    p = np.asarray(PARAMS[family], np.float32)
    want = np.asarray(jax_dist_gram(family, jnp.asarray(p), jnp.asarray(X1),
                                    jnp.asarray(X2), tile=128, interpret=True))
    got = TG.dist_gram(family, torch.from_numpy(p), torch.from_numpy(X1),
                       torch.from_numpy(X2))
    assert got.dtype == torch.float32 and got.shape == (256, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ragged_rbf_matches_kernels_compute():
    """Ragged 100×70 in float64: the port's Rbf.compute (K1's plain version
    on the CPU) against gpc_tpu's Rbf.compute."""
    rng = np.random.default_rng(12)
    X1 = rng.standard_normal((100, 3))
    X2 = rng.standard_normal((70, 3))
    p = np.array([0.8, 1.7])
    want = np.asarray(GK.Rbf(input_dim=3).compute(jnp.asarray(p), jnp.asarray(X1),
                                                  jnp.asarray(X2)))
    got = TK.Rbf(input_dim=3).compute(torch.from_numpy(p), torch.from_numpy(X1),
                                      torch.from_numpy(X2))
    assert got.shape == (100, 70)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_unknown_family_raises():
    X = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="unknown distance family"):
        TG.dist_gram("lin", [1.0], X, X)


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """`_DistGram` with its CUDA launch swapped for the plain version, so
    the autograd wrapper that the card uses runs here."""
    monkeypatch.setattr(TG, "dist_gram_kernel",
                        lambda family, p, X1, X2: TG.dist_gram_plain(family, p, X1, X2))


@pytest.mark.parametrize("same", [False, True])
def test_kernel_autograd_wrapper_matches_native(kernel_on_cpu, same):
    """K1's backward (the plain map recomputed under autograd) gives the
    gradient in params, X1 and X2 that native autograd of the plain
    version gives; with X1 is X2 both cotangents add up."""
    rng = np.random.default_rng(14)
    p0, X10, X20 = np.array([0.8, 1.7]), rng.standard_normal((40, 3)), rng.standard_normal((25, 3))
    W = torch.from_numpy(rng.standard_normal((40, 40 if same else 25)))

    def grads(fn):
        p, X1, X2 = (torch.tensor(a, requires_grad=True) for a in (p0, X10, X20))
        K = fn("rbf", p, X1, X1 if same else X2)
        out = torch.autograd.grad((K * W).sum(), (p, X1) if same else (p, X1, X2))
        return K.detach(), out

    K_w, g_w = grads(lambda *a: TG._DistGram.apply(*a))
    K_n, g_n = grads(TG.dist_gram_plain)
    assert torch.equal(K_w, K_n)
    for a, b in zip(g_w, g_n):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14)


def test_gram_writes_its_diagonal_out_of_place():
    """Kern.gram must not write into compute's output: an op that saves its
    output for backward (exp here, as an autograd.Function may) would
    raise at backward after an in-place diagonal write."""
    class ExpKern(TK.Rbf):
        def compute(self, p, X1, X2):
            return torch.exp(-p[0] * TL.dist2(X1, X2))

    X = torch.from_numpy(np.random.default_rng(15).standard_normal((12, 2)))
    p = torch.tensor([0.7, 1.3], dtype=torch.float64, requires_grad=True)
    K = ExpKern(input_dim=2).gram(p, X)
    (g,) = torch.autograd.grad(K.sum(), p)
    assert torch.equal(torch.diagonal(K), torch.full((12,), 1.3, dtype=torch.float64))
    want = -(TL.dist2(X, X) * torch.exp(-0.7 * TL.dist2(X, X))).fill_diagonal_(0).sum()
    torch.testing.assert_close(g, torch.stack([want, torch.tensor(12.0, dtype=torch.float64)]))


@pytest.mark.parametrize("family", TG.INNER_FAMILIES)
def test_inner_plain_matches_pallas_interpret(family):
    """K4's plain version against gpc_tpu's inner_gram tile in interpret
    mode, float32 256×256 (poly at degree 3)."""
    rng = np.random.default_rng(21)
    X1 = rng.standard_normal((256, 4)).astype(np.float32)
    X2 = rng.standard_normal((256, 4)).astype(np.float32)
    p = np.asarray(INNER[family], np.float32)
    want = np.asarray(jax_inner_gram(family, jnp.asarray(p), jnp.asarray(X1),
                                     jnp.asarray(X2), degree=3.0, tile=128,
                                     interpret=True))
    got = TG.inner_gram(family, torch.from_numpy(p), torch.from_numpy(X1),
                        torch.from_numpy(X2), 3.0)
    assert got.dtype == torch.float32 and got.shape == (256, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="unknown inner-product family"):
        TG.inner_gram("rbf", p, torch.from_numpy(X1), torch.from_numpy(X2))


@pytest.mark.parametrize("family", TG.INNER_FAMILIES)
@pytest.mark.parametrize("same", [False, True])
def test_inner_autograd_wrapper_matches_native(monkeypatch, family, same):
    """`_InnerGram` with its CUDA launch swapped for the plain version: its
    backward (the plain map recomputed under autograd) gives the gradient
    in params, X1 and X2 that native autograd of the plain version gives."""
    monkeypatch.setattr(TG, "inner_gram_kernel", TG.inner_gram_plain)
    rng = np.random.default_rng(22)
    p0 = np.asarray(INNER[family])
    X10, X20 = rng.standard_normal((40, 3)), rng.standard_normal((25, 3))
    W = torch.from_numpy(rng.standard_normal((40, 40 if same else 25)))

    def grads(fn):
        p, X1, X2 = (torch.tensor(a, requires_grad=True) for a in (p0, X10, X20))
        K = fn(p, X1, X1 if same else X2)
        out = torch.autograd.grad((K * W).sum(), (p, X1) if same else (p, X1, X2))
        return K.detach(), out

    K_w, g_w = grads(lambda p, X1, X2: TG._InnerGram.apply(family, 3.0, p, X1, X2))
    K_n, g_n = grads(lambda p, X1, X2: TG.inner_gram_plain(family, p, X1, X2, 3.0))
    assert torch.equal(K_w, K_n)
    for a, b in zip(g_w, g_n):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14)


GK_CLASS = {"rbf": GK.Rbf, "exp": GK.Exp, "ratquad": GK.RatQuad, "matern32": GK.Matern32,
            "matern52": GK.Matern52, "lin": GK.Lin, "poly": GK.Poly, "mlp": GK.Mlp}
HOST_READS = ("tolist", "item", "__float__", "__int__", "__bool__", "cpu", "numpy")


def _host_read(*args, **kwargs):
    raise AssertionError("a Gram launch read a tensor back to the host")


@pytest.mark.parametrize("family", TG.FAMILIES + TG.INNER_FAMILIES)
def test_kernel_launch_takes_device_parameters(monkeypatch, family):
    """K1/K4's launch path (dist_gram_kernel / inner_gram_kernel) on CPU
    stand-ins: the kernel gets a pointer to the float32 parameters padded
    with zeros to 3, in gpc_tpu's order (gpc_tpu's own kernel at those
    parameters equals the plain map of the packed vector), and no
    Tensor.tolist / item / float / int / bool / cpu / numpy is called."""
    inner = family in TG.INNER_FAMILIES
    params = np.asarray({**PARAMS, **INNER}[family], np.float32)
    rng = np.random.default_rng(31)
    X1 = torch.from_numpy(rng.standard_normal((30, 3)).astype(np.float32))
    X2 = torch.from_numpy(rng.standard_normal((20, 3)).astype(np.float32))
    p = torch.from_numpy(params)
    launched, packed = [], []
    pack = TG.kernel_params
    monkeypatch.setattr(TG.cuda_lib, "require_cuda", lambda *a: None)
    monkeypatch.setattr(TG.cuda_lib, "launch", lambda *a: launched.append(a))
    monkeypatch.setattr(TG.cuda_lib, "stream_of", lambda t: 0)
    monkeypatch.setattr(TG, "kernel_params", lambda *a: packed.append(pack(*a)) or packed[-1])
    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, _host_read)
        if inner:
            out = TG.inner_gram_kernel(family, p, X1, X2, 3.0)
        else:
            out = TG.dist_gram_kernel(family, p, X1, X2)
    (args,) = launched
    assert args[:2] == (("inner_gram", "gpc_inner_gram") if inner else ("dist_gram", "gpc_dist_gram"))
    (dev_params,) = packed
    assert args[2:8] == (X1.data_ptr(), X2.data_ptr(), 30, 20, 3,
                         (TG.INNER_FAMILIES if inner else TG.FAMILIES).index(family))
    assert args[8] == dev_params.data_ptr()
    if inner:
        assert args[9:11] == (3.0, 3)   # poly's whole degree goes as a multiply count
    assert args[-2] == out.data_ptr() and out.shape == (30, 20)
    assert dev_params.dtype == torch.float32 and dev_params.device == X1.device
    want = np.zeros(3, np.float32)
    want[:params.size] = params
    assert torch.equal(dev_params, torch.from_numpy(want))
    gk = GK_CLASS[family](input_dim=3, **({"degree": 3.0} if family == "poly" else {}))
    ref = np.asarray(gk.compute(jnp.asarray(params), jnp.asarray(X1.numpy()),
                                jnp.asarray(X2.numpy())))
    plain = (TG.inner_gram_plain(family, dev_params, X1, X2, 3.0) if inner
             else TG.dist_gram_plain(family, dev_params, X1, X2))
    np.testing.assert_allclose(plain.numpy(), ref, rtol=2e-4, atol=2e-5)


def test_whole_degree():
    assert [TG.whole_degree(d) for d in (0.0, 2.0, 3, 16.0)] == [0, 2, 3, 16]
    assert [TG.whole_degree(d) for d in (2.5, -1.0, 17.0)] == [-1, -1, -1]
