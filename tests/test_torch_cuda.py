"""The CUDA kernels of gpc_tpu_torch against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports neither jax nor gpc_tpu, so it runs where only PyTorch and
the CUDA toolkit are installed; tests/conftest.py imports jax, so on such a
machine run it as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: K1, K2, K4 and K5 compute in float32 like their plain
versions and differ in summation order (rtol 1e-5; the batched K1/K4 equal
their 2-D launches bit for bit; 1e-4 on the leaf logdet,
on K1's and K4's gradients, of the output's scale for K4's power and
arcsin maps and for every map at the ragged widths (q up to 130); 1e-3 on ‖ML − I‖ and of max|L| for K5); K3 and the slice carry
the bf16 L buffer of the panel kernel (2e-3, gpc_tpu's own bound; 2e-2 of
their max on T's diagonal blocks; 8e-2 relative L2 on panel gradients) or
float32 against the CPU's float64 (1e-4 on predictions, 2e-3 on the
evidence, 1e-3 relative L2 on dense, lazy and sparse gradients, 1e-4 on
the sparse evidence).  K3's correction
kernel alone is held to the float32 product of its bf16 operands within
1e-4 of Σ|a||b| (the tensor cores' truncating f32 sums over 256 k), and
K3's outputs are bit-reproducible.  The lazy engine's
leaves under K5 are held to its Cholesky leaves at 2e-4
(tests/test_lazy_evidence.py:185-187).  K6 is held to K5's bounds.  The
probes: K7 to its plain version (the same bf16 policy) at 2e-4 and to the
dense float32 evidence at 2e-3; K8a's (8, 128) corners to their plain
versions within 1e-5 of the largest entry (bf16 products summed in float32
in another order), 5e-5 where they hold sums of float32 leaves (also at
B = 128, 384 and 512 on an rbf Gram block, with the last leaf's L and L⁻¹
held to 5e-5 of their largest entries, RC = 128 at one dot and none, KC =
128 split to one 64-k box a block, each leaf part at 0 and 1 repetitions,
and the leaf parts on Gram blocks); K8b's and
K8c's sums of bf16 products within 1e-4 of the largest entry (the three
forms on the same data within 1e-4 of c0's largest entry), K8d's exp and
Gram tiles within 1e-5 (the Gram tile also at B = 64 and 1024 and at one
rep), its matvec chain within 1e-4, and its staged store bit for bit (also
below and across its ring of 4 stages and its 64 slots, n = 1, 3, 65, at
B = 512 and 1024).  The IVM: K1/K4 at the selection column (m = 1) within rtol
1e-5; a selection pass (N = 1024, d = 128) makes no host sync; the pass
replayed from its CUDA graph equals the eager pass bit for bit; the card's
float32 pass replayed through the CPU float64 step within
chip_smoke.py's IVM_GAP_TOL and IVM_STATE_TOL; IvmServer within 1e-4 of
IVM.predict.  The GP-LVM: its objective and θ̄ on the card (K1; K5 leaves
for the lazy objective alone) against the CPU float64 route (1e-4, 1e-3);
the iterative engine's blockwise MVM within 1e-5 of the plain product; the
masked engine with K1 against itself with the plain Gram (1e-4 on its
values, 1e-3 on θ̄).  Interop and the distributed layer: fgp on the card
(objective within 1e-4 of the CPU float64 route, query within 1e-4 of
GP.predict), .mat round trips (1e-6), learn -f 1 against -f 0 (the same
output), the native SVM-light reader on the card's machine, and
make_dist_objective on NCCL at world size 1 against the single-process
model (1e-5 on the value, 1e-4 relative L2 on θ̄).  The rest of the
distributed layer at world size 1 on NCCL: chol_distributed against
torch.linalg.cholesky (1e-5 of max|L|) and evidence_distributed's values and
cotangents against the dense route (1e-5; 1e-4 relative L2); dist_ftc,
dist_gplvm (plain and GPDM) against the single process (1e-5 / 1e-4, the
posterior within 1e-4 of GP.predict); dist_iterative against the
single-process engine on its probes (1e-5); dist_ivm's order against the
single process's graph (where a pick differs, within IVM_GAP_TOL of the
f64 step maximum); dist_sparse2d on mesh_2d(1, 1) against the CPU float64
route (1e-4 on the value, 1e-3 relative L2 on θ̄ at N = 1000, M = 64); and
`python -m gpc_tpu_torch.parallel.scaling_bench --worlds 1`'s line.  The dense
evidence's closed-form backward (explicit float32 A⁻¹) against its float64
form on the card, within 1e-3 (κ(A) < 1e3, so κ·2⁻²⁴ ≈ 5e-5).  GPServer's
product over L⁻¹'s lower triangle at N = 4096 against the CPU float64
posterior at the slice's 1e-4.
"""

import numpy as np
import pytest
import torch

from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch.models.gp import GP
from gpc_tpu_torch.ops import chol_pallas as TCPL
from gpc_tpu_torch.ops import chol_panel as TCP
from gpc_tpu_torch.ops import evidence_fast as TEF
from gpc_tpu_torch.ops import gram as TG
from gpc_tpu_torch.ops import lazy_evidence as TLE
from gpc_tpu_torch.ops.cuda_lib import LAUNCHES
from gpc_tpu_torch.models import ivm as TI
from gpc_tpu_torch.noise import GaussianNoise, NcnmNoise, OrderedNoise, ProbitNoise
from gpc_tpu_torch.serving import GPServer, IvmServer
from gpc_tpu_torch.utils.refrng import RefRng

pytestmark = pytest.mark.cuda

PARAMS = {"rbf": [0.7, 1.3], "exp": [0.7, 1.3], "ratquad": [1.5, 0.8, 1.3],
          "matern32": [0.9, 1.3], "matern52": [0.9, 1.3]}
INNER = {"lin": [1.3], "poly": [0.7, 0.4, 1.3], "mlp": [10.0, 10.0, 1.3]}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _randn(rng, shape, dev):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)


@pytest.mark.parametrize("family", TG.FAMILIES)
def test_dist_gram_kernel_matches_plain(dev, family):
    """Ragged shapes exercise the masked tile edge."""
    rng = np.random.default_rng(13)
    X1, X2 = _randn(rng, (300, 5), dev), _randn(rng, (211, 5), dev)
    before = LAUNCHES["dist_gram"]
    got = TG.dist_gram(family, PARAMS[family], X1, X2)
    assert LAUNCHES["dist_gram"] == before + 1
    want = TG.dist_gram_plain(family, PARAMS[family], X1, X2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1.3e-6)


@pytest.mark.parametrize("m", [1, 3, 63, 65, 777])
@pytest.mark.parametrize("q", [1, 3, 8, 17, 40, 130])
def test_gram_kernels_at_ragged_widths(dev, m, q):
    """K1 and K4 at ragged column counts (rows that start misaligned when m
    % 4 != 0, the stripe's ragged edge) and input widths (q exactly; above
    96 the stripe is staged in chunks), n = 130: every family against its
    plain version, one launch each."""
    rng = np.random.default_rng(100 * m + q)
    X1, X2 = _randn(rng, (130, q), dev) / q ** 0.5, _randn(rng, (m, q), dev) / q ** 0.5
    for family, p in {**PARAMS, **INNER}.items():
        inner = family in INNER
        name = "inner_gram" if inner else "dist_gram"
        before = LAUNCHES[name]
        if inner:
            got = TG.inner_gram(family, p, X1, X2, 3.0)
            want = TG.inner_gram_plain(family, p, X1, X2, 3.0)
        else:
            got = TG.dist_gram(family, p, X1, X2)
            want = TG.dist_gram_plain(family, p, X1, X2)
        assert LAUNCHES[name] == before + 1
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("family", ["rbf", "matern52", "poly", "mlp"])
def test_gram_launch_captures_in_a_cuda_graph(dev, family):
    """A K1/K4 launch inside torch.cuda.graph capture (which fails on any
    host read of the parameters): replayed after the parameters changed on
    the device, the graph's output is the new parameters' Gram."""
    rng = np.random.default_rng(41)
    X1, X2 = _randn(rng, (300, 5), dev), _randn(rng, (211, 5), dev)
    inner = family in INNER
    p = torch.tensor({**PARAMS, **INNER}[family], dtype=torch.float32, device=dev)
    run = ((lambda: TG.inner_gram_kernel(family, p, X1, X2, 3.0)) if inner
           else (lambda: TG.dist_gram_kernel(family, p, X1, X2)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()                              # warm up (and build) outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    p.mul_(0.8)
    graph.replay()
    torch.cuda.synchronize()
    want = (TG.inner_gram_plain(family, p, X1, X2, 3.0) if inner
            else TG.dist_gram_plain(family, p, X1, X2))
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    X = torch.zeros((8, 2), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        TG.dist_gram("rbf", [1.0, 1.0], X, X)
    with pytest.raises(ValueError, match="b % 128"):
        TCP.factor_diag(torch.eye(100, device=dev)[None])
    with pytest.raises(ValueError, match="N % 128"):
        Xf = torch.zeros((200, 2), device=dev)
        TCP.panel_state_rbf(Xf, Xf[:, :1].contiguous(), 1.0, 1.0, 0.1)


@pytest.mark.parametrize("b", [128, 256, 512])
def test_factor_diag_kernel_matches_plain(dev, b):
    rng = np.random.default_rng(b)
    Z = _randn(rng, (4, b, b), dev)
    A = Z @ Z.mT / b + 0.5 * torch.eye(b, device=dev)
    M, ld = TCP.factor_diag(A)
    _, ld_want = TCP.factor_diag_plain(A)
    torch.testing.assert_close(ld, ld_want, rtol=1e-4, atol=0.0)
    L = torch.linalg.cholesky(A)
    assert float((M @ L - torch.eye(b, device=dev)).abs().max()) < 1e-3


@pytest.mark.parametrize("N,n_valid", [(1024, 1000), (2048, 2048)])
def test_panel_state_kernel_matches_plain(dev, N, n_valid):
    rng = np.random.default_rng(5)
    X, m = _randn(rng, (N, 8), dev), _randn(rng, (N, 2), dev)
    ld, G, v, T = TCP.panel_state_rbf(X, m, 1.0, 1.0, 0.1, n_valid=n_valid)
    ld_want, G_want, _, T_want = TCP.panel_state_rbf_plain(X, m, 1.0, 1.0, 0.1,
                                                           n_valid=n_valid)
    assert abs(float(ld) - float(ld_want)) <= 2e-3 * abs(float(ld_want))
    g, g_want = torch.diagonal(G), torch.diagonal(G_want)
    assert bool(((g - g_want).abs() <= 2e-3 * g_want.abs()).all())
    assert bool(torch.isfinite(v).all())
    # below the diagonal blocks T holds the bf16 factor
    below = torch.ones(N // 128, N // 128, device=dev).tril(-1).repeat_interleave(
        128, 0).repeat_interleave(128, 1).bool()
    diff = (T.float() - T_want.float())[below].abs().max()
    assert float(diff) < 2e-2 * float(T_want.float().abs().max())


CORR_SIZES = [128, 256, 384, 4096, 16384]


@pytest.mark.parametrize("N", CORR_SIZES)
@pytest.mark.parametrize("which", ["first", "middle", "last"])
@pytest.mark.parametrize("split", ["one", "max"])
def test_panel_corr_kernel_matches_float32_product(dev, N, which, split):
    """K3's wgmma/TMA correction alone, on the diagonal block's rows and on
    the rows below, against the float32 product of the same bf16 operands
    per split: within 1e-4 of Σ|a||b| (the tensor cores truncate their f32
    sums, ≤ 1 ulp an add over the 256 k between register-sum flushes).
    Split "one" runs on 7 blocks (each walks several units), "max" on one
    block per unit up to the SMs.  At N = 128 the plan has no correction."""
    nb = N // 128
    if nb == 1:
        assert all(st.splits == 0 for st in TCP.panel_plan(N) if st.kind == TCP.FILL)
        return
    j = {"first": 1, "middle": max(1, nb // 2), "last": nb - 1}[which]
    jb = 128 * j
    kc = jb // TCP.CORR_BK
    rng = np.random.default_rng(N + j)
    T = _randn(rng, (N, N), dev).to(torch.bfloat16)
    before = LAUNCHES["panel_corr"]
    ranges = [(jb, jb + 128)] + ([(jb + 128, N)] if jb + 128 < N else [])
    for row0, row1 in ranges:
        splits, grid = (1, 7) if split == "one" else (kc, 0)
        got = TCP.panel_corr(T, jb, row0, row1, splits, grid)
        want = TCP.panel_corr_plain(T, jb, row0, row1, splits)
        bound = TCP.panel_corr_plain(T.abs(), jb, row0, row1, splits)
        assert got.shape == want.shape == (splits, row1 - row0, 128)
        assert bool(((got - want).abs() <= 1e-4 * bound + 1e-30).all())
    torch.cuda.synchronize()
    assert LAUNCHES["panel_corr"] == before + len(ranges)


@pytest.mark.parametrize("N,n_valid,D", [(128, 100, 1), (256, 200, 3), (384, 383, 2),
                                         (4096, 4000, 1), (4096, 3000, 3)])
def test_panel_state_kernel_at_ragged_n_valid_and_widths(dev, N, n_valid, D):
    """K3 against the plain version with n_valid < N and D = 1, 2, 3
    (gpc_tpu's 2e-3 panel bound on the logdet and diag(G)).  The pad rows of
    m are zero, as the panel engine pads them (ops/panel_engine.py): a pad
    row's m²/noise would otherwise dominate G and carry bf16(v)'s rounding."""
    rng = np.random.default_rng(N + D)
    X, m = _randn(rng, (N, 8), dev), _randn(rng, (N, D), dev)
    m[n_valid:] = 0.0
    ld, G, v, _ = TCP.panel_state_rbf(X, m, 1.0, 1.0, 0.1, n_valid=n_valid)
    ld_want, G_want, _, _ = TCP.panel_state_rbf_plain(X, m, 1.0, 1.0, 0.1, n_valid=n_valid)
    assert G.shape == (D, D) and v.shape == (D, N)
    assert abs(float(ld) - float(ld_want)) <= 2e-3 * abs(float(ld_want))
    g, g_want = torch.diagonal(G), torch.diagonal(G_want)
    assert bool(((g - g_want).abs() <= 2e-3 * g_want.abs()).all())


@pytest.mark.parametrize("N,n_valid,D", [(384, 300, 193), (1024, 1000, 400)])
def test_panel_state_wide_rhs_matches_narrow_calls(dev, N, n_valid, D):
    """v_j's rows pass through the leaf's and the solve's shared memory 192
    at a time, and each row of v is computed on its own: a K3 call with D
    above 192 gives bit for bit the logdet, T, v and G of calls on groups of
    at most 100 of its columns, and its logdet holds gpc_tpu's 2e-3 panel
    bound against the plain version."""
    rng = np.random.default_rng(N + D)
    X, m = _randn(rng, (N, 8), dev), _randn(rng, (N, D), dev)
    m[n_valid:] = 0.0
    ld, G, v, T = TCP.panel_state_rbf(X, m, 1.0, 1.0, 0.1, n_valid=n_valid)
    assert G.shape == (D, D) and v.shape == (D, N)
    for d0 in range(0, D, 100):
        cols = slice(d0, min(d0 + 100, D))
        ld_n, G_n, v_n, T_n = TCP.panel_state_rbf(X, m[:, cols].contiguous(), 1.0, 1.0, 0.1,
                                                  n_valid=n_valid)
        assert torch.equal(ld_n, ld) and torch.equal(T_n, T)
        assert torch.equal(v_n, v[cols]) and torch.equal(G_n, G[cols, cols])
    ld_want = TCP.panel_state_rbf_plain(X, m[:, :1], 1.0, 1.0, 0.1, n_valid=n_valid)[0]
    assert abs(float(ld) - float(ld_want)) <= 2e-3 * abs(float(ld_want))


@pytest.mark.parametrize("mode", TCP.MODES)
def test_panel_state_is_bit_reproducible_across_t_allocations(dev, mode):
    """Two K3 calls, the second with T at another address (the tensor map
    is encoded per call), give bit-identical (logdet, G, v, T); modes
    "full" and "full+diag" agree bit for bit outside T's diagonal blocks."""
    N = 4096
    rng = np.random.default_rng(21)
    X, m = _randn(rng, (N, 8), dev), _randn(rng, (N, 2), dev)
    first = TCP.panel_state_rbf(X, m, 1.0, 1.0, 0.1, n_valid=4000, mode=mode)
    hold = torch.empty((N, N), dtype=torch.bfloat16, device=dev)   # T's old slot is taken
    second = TCP.panel_state_rbf(X, m, 1.0, 1.0, 0.1, n_valid=4000, mode=mode)
    assert first[3].data_ptr() != second[3].data_ptr()
    del hold
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    other = TCP.panel_state_rbf(X, m, 1.0, 1.0, 0.1, n_valid=4000,
                                mode="full" if mode == "full+diag" else "full+diag")
    for a, b in zip(first[:3], other[:3]):
        assert torch.equal(a, b)
    Ta, Tb = first[3].clone(), other[3].clone()
    TCP.diag_blocks(Ta).zero_()
    TCP.diag_blocks(Tb).zero_()
    assert torch.equal(Ta, Tb)


@pytest.mark.parametrize("N", [256, 4096])
def test_panel_state_makes_one_library_call(dev, monkeypatch, N):
    """A K3 call is one ctypes call whatever N is; LAUNCHES gains the
    launches the C walker counted: a diagonal fill and a leaf a panel, a
    fill below and a solve for every panel but the last, a correction in
    every fill but panel 0's, one finish."""
    from gpc_tpu_torch.ops import cuda_lib
    calls = []
    real = cuda_lib.launch
    monkeypatch.setattr(cuda_lib, "launch", lambda *a: (calls.append(a[1]), real(*a)))
    rng = np.random.default_rng(22)
    X, m = _randn(rng, (N, 8), dev), _randn(rng, (N, 1), dev)
    before = dict(LAUNCHES)
    TCP.panel_state_rbf(X, m, 1.0, 1.0, 0.1)
    assert calls == ["gpc_panel_state"]
    nb = N // 128
    want = {"panel_fill": nb, "factor_diag": nb, "panel_fill_below": nb - 1,
            "panel_solve": nb - 1, "panel_corr": 2 * nb - 3, "panel_finish": 1,
            "panel_state_rbf": 1}
    assert {k: LAUNCHES[k] - before.get(k, 0) for k in want} == want


@pytest.mark.parametrize("evidence", ["dense", "panel"])
def test_slice_on_card_matches_cpu_float64(dev, monkeypatch, evidence):
    rng = np.random.default_rng(6)
    # spread inputs: at the default inverseWidth, unit-normal q=3 data put K
    # past the bf16 factor's conditioning edge (gpc_tpu's own panel kernel
    # drifts 0.56% there too)
    X = 3.0 * rng.standard_normal((600, 3))
    y = np.sin(X[:, :1]) + 0.05 * rng.standard_normal((600, 1))
    kern = TK.Cmpnd(input_dim=3, components=(
        TK.Rbf(input_dim=3), TK.Bias(input_dim=3), TK.White(input_dim=3)))
    cpu = GP(kern, X, y, device="cpu")
    card = GP(kern, X, y, device=dev)
    ref = cpu.log_likelihood()
    monkeypatch.setenv("GPC_TPU_EVIDENCE", evidence)
    assert abs(card.log_likelihood() - ref) <= 2e-3 * abs(ref)
    Xt = 3.0 * rng.standard_normal((300, 3))
    mu, var = GPServer(card, chunk=128).predict(Xt)
    want_mu, want_var = cpu.predict(Xt)
    assert np.abs(mu - want_mu).max() <= 1e-4 * np.abs(want_mu).max()
    assert np.abs(var - want_var).max() <= 1e-4 * np.abs(want_var).max()
    assert (var >= 0).all()


def test_ftc_server_triangular_product_matches_cpu_float64(dev):
    """GPServer's explicit-inverse posterior at N = 4096 in float32 (its
    product over L⁻¹'s lower triangle, linalg.tri_apply) at buckets 1, 128
    and 4096 against the CPU float64 posterior, within the slice's 1e-4;
    one serve.tri_apply a chunk."""
    from gpc_tpu_torch.utils.profiling import COUNTS

    rng = np.random.default_rng(23)
    X = 3.0 * rng.standard_normal((4096, 3))
    y = np.sin(X[:, :1]) + 0.05 * rng.standard_normal((4096, 1))
    kern = TK.Cmpnd(input_dim=3, components=(
        TK.Rbf(input_dim=3), TK.Bias(input_dim=3), TK.White(input_dim=3)))
    cpu = GP(kern, X, y, device="cpu")
    srv = GPServer(GP(kern, X, y, device=dev), chunk=4096)
    assert srv.explicit_inverse
    for rows in (1, 128, 4096):
        Xt = 3.0 * rng.standard_normal((rows, 3))
        before = COUNTS["serve.tri_apply"]
        mu, var = srv.predict(Xt)
        assert COUNTS["serve.tri_apply"] == before + 1
        want_mu, want_var = cpu.predict(Xt)
        assert np.abs(mu - want_mu).max() <= 1e-4 * np.abs(want_mu).max()
        assert np.abs(var - want_var).max() <= 1e-4 * np.abs(want_var).max()
        assert (var >= 0).all()


@pytest.mark.parametrize("same", [False, True])
def test_dist_gram_gradient_matches_plain(dev, same):
    """K1's autograd wrapper: the gradient in params, X1 and X2 that native
    autograd of the plain version gives (both float32)."""
    rng = np.random.default_rng(16)
    p0, X10, X20 = np.array([0.7, 1.3]), rng.standard_normal((300, 5)), rng.standard_normal((211, 5))
    W = _randn(rng, (300, 300 if same else 211), dev)

    def grads(fn):
        p, X1, X2 = (torch.tensor(a, dtype=torch.float32, device=dev, requires_grad=True)
                     for a in (p0, X10, X20))
        K = fn("rbf", p, X1, X1 if same else X2)
        return torch.autograd.grad((K * W).sum(), (p, X1) if same else (p, X1, X2))

    before = LAUNCHES["dist_gram"]
    got = grads(TG.dist_gram)
    assert LAUNCHES["dist_gram"] == before + 1
    want = grads(TG.dist_gram_plain)
    for a, b in zip(got, want):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_panel_diag_mode_matches_plain(dev):
    """K3 mode "full+diag": bf16(L_jj⁻¹) in T's diagonal blocks within the
    bf16 bound of the plain version's; logdet, G, v and T below the blocks
    equal to mode "full"'s, bit for bit."""
    N, n_valid = 1024, 1000
    rng = np.random.default_rng(17)
    X, m = _randn(rng, (N, 8), dev), _randn(rng, (N, 2), dev)
    full = TCP.panel_state_rbf(X, m, 1.0, 1.0, 0.1, n_valid=n_valid)
    before = LAUNCHES["panel_leaf_diag"]
    diag = TCP.panel_state_rbf(X, m, 1.0, 1.0, 0.1, n_valid=n_valid, mode="full+diag")
    assert LAUNCHES["panel_leaf_diag"] == before + N // 128
    for a, b in zip(full[:3], diag[:3]):
        assert torch.equal(a, b)
    got = TCP.diag_blocks(diag[3]).float()
    assert torch.equal(TCP.diag_blocks(full[3]).float(), torch.zeros_like(got))
    _, _, _, T_plain = TCP.panel_state_rbf_plain(X, m, 1.0, 1.0, 0.1, n_valid=n_valid,
                                                 mode="full+diag")
    want = TCP.diag_blocks(T_plain).float()
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())
    assert torch.equal(got.triu(1), torch.zeros_like(got))
    T_rest = diag[3].clone()
    TCP.diag_blocks(T_rest).zero_()
    assert torch.equal(T_rest, full[3])


def _train_data(N=600):
    rng = np.random.default_rng(6)
    X = 3.0 * rng.standard_normal((N, 3))     # inside the bf16 factor's domain
    y = np.sin(X[:, :1]) + 0.05 * rng.standard_normal((N, 1))
    kern = TK.Cmpnd(input_dim=3, components=(
        TK.Rbf(input_dim=3), TK.Bias(input_dim=3), TK.White(input_dim=3)))
    return kern, X, y


@pytest.mark.parametrize("evidence,tol", [("dense", 1e-3), ("panel", 8e-2)])
def test_gradient_on_card_matches_cpu_float64(dev, monkeypatch, evidence, tol):
    """θ̄ through K1 (and K3 "full+diag" under panel) on the card against
    the CPU float64 dense route, in relative L2: f32 for dense, the
    bf16-factor bound of tests/test_panel_engine.py for panel."""
    kern, X, y = _train_data()
    cpu = GP(kern, X, y, device="cpu")
    f_ref, g_ref = cpu.value_and_grad_fn()(cpu.theta)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", evidence)
    card = GP(kern, X, y, device=dev)
    launches = dict(LAUNCHES)
    f, g = card.value_and_grad_fn()(card.theta)
    assert LAUNCHES["dist_gram"] > launches.get("dist_gram", 0)
    if evidence == "panel":
        assert LAUNCHES["panel_leaf_diag"] > launches.get("panel_leaf_diag", 0)
    assert abs(f - f_ref) <= 2e-3 * abs(f_ref)
    assert np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref) < tol
    assert np.abs(g).min() > 0


@pytest.mark.parametrize("evidence", ["dense", "panel"])
def test_optimise_on_card(dev, monkeypatch, evidence):
    """Three SCG iterations on the card from the default hyperparameters,
    on data where the CPU float64 route accepts each step: the objective
    never rises, and it falls under dense."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((800, 8))
    y = np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((800, 1))
    kern = TK.Cmpnd(input_dim=8, components=(
        TK.Rbf(input_dim=8), TK.Bias(input_dim=8), TK.White(input_dim=8)))
    monkeypatch.setenv("GPC_TPU_EVIDENCE", evidence)
    model = GP(kern, X, y, device=dev)
    f0 = -model.log_likelihood()
    res = model.optimise(iters=3)
    assert res.iters == 3 and np.isfinite(res.obj) and res.obj <= f0
    assert model.theta.dtype == np.float64
    if evidence == "dense":
        assert res.obj < f0
    assert abs(-model.log_likelihood() - res.obj) <= 1e-5 * abs(res.obj)


@pytest.mark.parametrize("family", TG.INNER_FAMILIES)
def test_inner_gram_kernel_matches_plain(dev, family):
    """K4 at ragged shapes (the masked tile edge), poly at degree 3."""
    rng = np.random.default_rng(23)
    X1, X2 = _randn(rng, (300, 5), dev), _randn(rng, (211, 5), dev)
    before = LAUNCHES["inner_gram"]
    got = TG.inner_gram(family, INNER[family], X1, X2, 3.0)
    assert LAUNCHES["inner_gram"] == before + 1
    want = TG.inner_gram_plain(family, INNER[family], X1, X2, 3.0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("family", TG.INNER_FAMILIES)
def test_inner_gram_gradient_matches_plain(dev, family):
    rng = np.random.default_rng(24)
    p0, X10 = np.asarray(INNER[family]), rng.standard_normal((300, 5))
    W = _randn(rng, (300, 300), dev)

    def grads(fn):
        p, X = (torch.tensor(a, dtype=torch.float32, device=dev, requires_grad=True)
                for a in (p0, X10))
        return torch.autograd.grad((fn(family, p, X, X, 3.0) * W).sum(), (p, X))

    got = grads(TG.inner_gram)
    want = grads(TG.inner_gram_plain)
    for a, b in zip(got, want):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def _check_chol_inv(A):
    """K5 on A against its plain version: ‖ML − I‖ and L within 1e-3 of the
    largest entry, both lower triangular; one launch."""
    n = A.shape[0]
    before = LAUNCHES["chol_inv_block"]
    L, M = TCP.chol_inv_block(A)
    assert LAUNCHES["chol_inv_block"] == before + 1
    L_want, _ = TCP.chol_inv_block_plain(A)
    assert float((M @ L - torch.eye(n, device=A.device)).abs().max()) < 1e-3
    assert float((L - L_want).abs().max()) < 1e-3 * float(L_want.abs().max())
    assert not bool(L.triu(1).any()) and not bool(M.triu(1).any())


@pytest.mark.parametrize("n", [128, 256, 512, 1024])
def test_chol_inv_block_kernel_matches_plain(dev, n):
    """At n and at the ragged n − 8, which K5 pads to n inside the kernel;
    beyond 1024 it raises."""
    rng = np.random.default_rng(n + 1)
    Z = _randn(rng, (n, n), dev)
    A = Z @ Z.T / n + 0.5 * torch.eye(n, device=dev)
    _check_chol_inv(A)
    _check_chol_inv(A[:n - 8, :n - 8].contiguous())
    with pytest.raises(ValueError, match="n <= 1024"):
        TCP.chol_inv_block(torch.eye(1152, device=dev))
    with pytest.raises(RuntimeError, match="forward only"):
        TCP.chol_inv_block(A.clone().requires_grad_(True))


@pytest.mark.parametrize("n", [1, 2, 96, 127, 128, 129, 157, 192, 255, 257, 1000, 1024])
def test_chol_block_and_ragged_chol_inv_block_match_plain(dev, n):
    """K6 (L alone) and K5 at ragged and whole sizes: L within 1e-3 of the
    plain version's largest entry, zeros above the diagonal, ‖ML − I‖ ≤ 1e-3."""
    rng = np.random.default_rng(n + 7)
    Z = _randn(rng, (n, n), dev)
    A = Z @ Z.T / n + 0.5 * torch.eye(n, device=dev)
    _check_chol_inv(A)
    before = LAUNCHES["chol_block"]
    L = TCPL.chol_block(A)
    assert LAUNCHES["chol_block"] == before + 1
    L_want = TCPL.chol_block_plain(A)
    assert float((L - L_want).abs().max()) < 1e-3 * float(L_want.abs().max())
    assert not bool(L.triu(1).any())
    with pytest.raises(ValueError, match="n <= 1024"):
        TCPL.chol_block(torch.eye(1152, device=dev))


@pytest.mark.parametrize("n", [128, 256])
def test_chol_kernels_take_an_unaligned_input(dev, n):
    """A contiguous input that does not start 16-byte aligned (the kernels
    read 16-byte rows) is copied first: K5, K6 and K2 (two batch entries)
    against their plain versions."""
    rng = np.random.default_rng(n + 3)
    Z = _randn(rng, (2, n, n), dev)
    A = Z @ Z.mT / n + 0.5 * torch.eye(n, device=dev)
    buf = torch.empty(2 * n * n + 1, device=dev)
    Au = buf[1:].view(2, n, n)
    Au.copy_(A)
    assert Au.is_contiguous() and Au.data_ptr() % 16 != 0
    _check_chol_inv(Au[0])
    L = TCPL.chol_block(Au[0])
    assert float((L - TCPL.chol_block_plain(A[0])).abs().max()) < 1e-3 * float(L.abs().max())
    M, ld = TCP.factor_diag(Au)
    _, ld_want = TCP.factor_diag_plain(A)
    torch.testing.assert_close(ld, ld_want, rtol=1e-4, atol=0.0)
    assert float((M @ torch.linalg.cholesky(A) - torch.eye(n, device=dev)).abs().max()) < 1e-3


def test_evidence_mega_kernel_matches_plain(dev):
    """K7 at N = 2048, q = 8 in one launch against its plain version (the
    same bf16 policy; 2e-4 relative, as against gpc_tpu's), and within 2e-3
    of the dense float32 evidence; every mode launches and returns."""
    from gpc_tpu_torch.probes import chol_mega as TCM
    args = TCM.probe_args(2048, 8, dev)
    before = LAUNCHES["evidence_mega_rbf"]
    ld, quad = TCM.evidence_mega_rbf(*args)
    assert LAUNCHES["evidence_mega_rbf"] == before + 1
    ld_p, quad_p = TCM.evidence_mega_rbf_plain(*args)
    assert abs(float(ld) - float(ld_p)) <= 2e-4 * abs(float(ld_p))
    assert abs(float(quad) - float(quad_p)) <= 2e-4 * abs(float(quad_p))
    ld_d, G_d, _, _ = TCP.panel_state_rbf_plain(*args)
    assert abs(float(ld) - float(ld_d)) <= 2e-3 * abs(float(ld_d))
    assert abs(float(quad) - float(torch.trace(G_d))) <= 2e-3 * float(torch.trace(G_d))
    for mode in TCM.MODES[1:]:
        out = TCM.evidence_mega_rbf(*args, mode=mode)
        assert all(o.shape == () for o in out)
    noleaf = TCM.evidence_mega_rbf(*args, mode="noleaf")
    noleaf_p = TCM.evidence_mega_rbf_plain(*args, mode="noleaf")
    for a, b in zip(noleaf, noleaf_p):
        assert abs(float(a) - float(b)) <= 2e-4 * abs(float(b))


@pytest.mark.parametrize("n,dense_rel", [(384, None), (2048, 2e-3), (4096, 2e-3)])
def test_evidence_mega_dataflow_matches_plain_and_repeats(dev, n, dense_rel):
    """K7's dataflow grid at nb = 3 (fewer tiles than blocks), 16 and 32:
    logdet and quad within 2e-4 of the plain version (the same bf16 policy),
    every mode launching once a call, and two `full` calls equal bit for
    bit (the ranges of a tile's correction are summed in a fixed order).
    Against the dense float32 evidence: within 2e-3 (gpc_tpu's panel
    bound), and never farther than the plain version is plus 2e-4.  At N =
    384 the bf16 policy itself sits 2.27e-3 from the dense logdet (-21.80,
    whose terms of both signs cancel; the absolute gap 0.050 is that of
    larger N), so there the second bound alone holds the logdet."""
    from gpc_tpu_torch.probes import chol_mega as TCM
    args = TCM.probe_args(n, 8, dev)
    ld, quad = TCM.evidence_mega_rbf(*args)
    ld2, quad2 = TCM.evidence_mega_rbf(*args)
    assert torch.equal(ld, ld2) and torch.equal(quad, quad2)
    ld_p, quad_p = TCM.evidence_mega_rbf_plain(*args)
    assert abs(float(ld) - float(ld_p)) <= 2e-4 * abs(float(ld_p))
    assert abs(float(quad) - float(quad_p)) <= 2e-4 * abs(float(quad_p))
    ld_d, G_d, _, _ = TCP.panel_state_rbf_plain(*args)
    quad_d = float(torch.trace(G_d))
    for got, plain, dense in ((float(ld), float(ld_p), float(ld_d)),
                              (float(quad), float(quad_p), quad_d)):
        assert abs(got - dense) <= abs(plain - dense) + 2e-4 * abs(plain)
    if dense_rel is not None:
        assert abs(float(ld) - float(ld_d)) <= dense_rel * abs(float(ld_d))
    assert abs(float(quad) - quad_d) <= 2e-3 * quad_d
    for mode in TCM.MODES[1:]:
        before = LAUNCHES["evidence_mega_rbf"]
        out = TCM.evidence_mega_rbf(*args, mode=mode)
        torch.cuda.synchronize()
        assert LAUNCHES["evidence_mega_rbf"] == before + 1
        assert all(o.shape == () for o in out)
        if mode == "noleaf":
            want = TCM.evidence_mega_rbf_plain(*args, mode=mode)
            for a, b in zip(out, want):
                assert abs(float(a) - float(b)) <= 2e-4 * abs(float(b))


def _probe_inputs(dev):
    from gpc_tpu_torch.probes import overlap as TOV
    return TOV, TOV.probe_inputs(dev, rc=512, kc=512, b=256, n_bufs=3, seed=2)


def _probe_close(got, want, tol):
    assert got.shape == want.shape == (8, 128)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.parametrize("n_dots,n_leaves,interleave,indep,overwrite",
                         [(3, 0, False, False, False), (0, 2, False, False, False),
                          (4, 2, True, False, False), (4, 2, False, True, False),
                          (4, 1, False, False, True)])
def test_overlap_probe_kernel_matches_plain(dev, n_dots, n_leaves, interleave, indep,
                                            overwrite):
    TOV, inp = _probe_inputs(dev)
    args = (inp["slab"], inp["vrow"], inp["aleaf"], n_dots, n_leaves, interleave, indep,
            overwrite)
    before = LAUNCHES["overlap_probe"]
    got = TOV.overlap_probe(*args)
    assert LAUNCHES["overlap_probe"] == before + 1
    _probe_close(got, TOV.overlap_probe_plain(*args), 5e-5)


@pytest.mark.parametrize("with_dots", [False, True])
def test_dma_probe_kernel_matches_plain(dev, with_dots):
    TOV, inp = _probe_inputs(dev)
    before = LAUNCHES["dma_probe"]
    got = TOV.dma_probe(inp["hbm"], inp["vrow"], 5, with_dots)
    assert LAUNCHES["dma_probe"] == before + 1
    _probe_close(got, TOV.dma_probe_plain(inp["hbm"], inp["vrow"], 5, with_dots), 1e-5)


@pytest.mark.parametrize("kind", ["sweep128", "fsweep128", "gemm512", "gemm128", "fdiag",
                                  "ffdiag"])
def test_leaf_parts_probe_kernel_matches_plain(dev, kind):
    TOV, inp = _probe_inputs(dev)
    before = LAUNCHES["leaf_parts_probe"]
    got = TOV.leaf_parts_probe(kind, 3, inp["a512"], inp["a128"])
    assert LAUNCHES["leaf_parts_probe"] == before + 1
    _probe_close(got, TOV.leaf_parts_probe_plain(kind, 3, inp["a512"], inp["a128"]), 5e-5)


@pytest.mark.parametrize("b", [128, 384, 512])
def test_overlap_probe_leaf_at_each_block_count(dev, b):
    """The in-block (L, L⁻¹) at 1, 3 and 4 diagonal blocks of 128, on an
    rbf Gram block (its logdet moves far past the limit when a panel solve,
    a trailing update or the noise 1e-3 l is missing): two leaves alone,
    then beside three dots and after them, against the plain version; the
    last leaf's L and L⁻¹, read back from the workspace, against those of
    gleaf + 1e-3 I."""
    from gpc_tpu_torch.probes import overlap as TOV
    inp = TOV.probe_inputs(dev, rc=256, kc=256, b=b, n_bufs=2, seed=3)
    g = inp["gleaf"]
    lw = torch.full((3, b, b), float("nan"), dtype=torch.float32, device=dev)
    for n_dots, interleave in ((0, False), (3, True), (3, False)):
        args = (inp["slab"], inp["vrow"], g, n_dots, 2, interleave)
        _probe_close(TOV.overlap_probe(*args, _lw=lw), TOV.overlap_probe_plain(*args), 5e-5)
        L, M = TCPL.chol_inv_block_plain(g + 1e-3 * torch.eye(b, device=dev))
        for got, want in ((lw[1], L), (lw[2], M)):
            assert float((got - want).abs().max()) <= 5e-5 * float(want.abs().max())


@pytest.mark.parametrize("n_dots", [0, 1])
@pytest.mark.parametrize("indep,overwrite", [(True, False), (False, True), (True, True)])
def test_overlap_probe_one_row_tile(dev, n_dots, indep, overwrite):
    """RC = 128 (one row of tiles) at 1 dot and at 0 dots: under indep the
    second accumulator gets no dot."""
    from gpc_tpu_torch.probes import overlap as TOV
    inp = TOV.probe_inputs(dev, rc=128, kc=256, b=256, n_bufs=2, seed=4)
    args = (inp["slab"], inp["vrow"], inp["aleaf"], n_dots, 0, False, indep, overwrite)
    _probe_close(TOV.overlap_probe(*args), TOV.overlap_probe_plain(*args), 5e-5)


def test_overlap_probe_split_leaves_one_box_a_block(dev):
    """KC = 128 split over two blocks: each holds one 64-k box of every
    dot; the split and the unsplit kernel agree with the plain version."""
    from gpc_tpu_torch.probes import overlap as TOV
    inp = TOV.probe_inputs(dev, rc=256, kc=128, b=256, n_bufs=2, seed=5)
    plan = TOV.overlap_plan(256, 128, 256, 5, 0, False, False, TOV._grid())
    assert plan.ksplit == 2 and plan.kc // plan.ksplit == 64
    for indep in (False, True):
        args = (inp["slab"], inp["vrow"], inp["aleaf"], 5, 0, False, indep)
        want = TOV.overlap_probe_plain(*args)
        for ksplit in (None, 1, 2):
            _probe_close(TOV.overlap_probe(*args, _ksplit=ksplit), want, 5e-5)


@pytest.mark.parametrize("kind", ["sweep128", "fsweep128", "gemm512", "gemm128", "fdiag",
                                  "ffdiag"])
@pytest.mark.parametrize("n", [0, 1])
def test_leaf_parts_probe_zero_and_one_repetition(dev, kind, n):
    TOV, inp = _probe_inputs(dev)
    got = TOV.leaf_parts_probe(kind, n, inp["a512"], inp["a128"])
    _probe_close(got, TOV.leaf_parts_probe_plain(kind, n, inp["a512"], inp["a128"]), 5e-5)


@pytest.mark.parametrize("kind", ["sweep128", "fsweep128", "fdiag", "ffdiag"])
def test_leaf_parts_probe_on_a_gram_block(dev, kind):
    """The leaf parts on rbf Gram blocks (g512, g128), whose L⁻¹ has large
    off-diagonal entries: a wrong step of the factor moves the column sums
    by far more than the limit."""
    TOV, inp = _probe_inputs(dev)
    got = TOV.leaf_parts_probe(kind, 3, inp["g512"], inp["g128"])
    _probe_close(got, TOV.leaf_parts_probe_plain(kind, 3, inp["g512"], inp["g128"]), 5e-5)


def _mlp_data(N, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, 3))
    y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    kern = TK.Cmpnd(input_dim=3, components=(
        TK.Mlp(input_dim=3), TK.Bias(input_dim=3), TK.White(input_dim=3)))
    return kern, X, y


@pytest.mark.parametrize("evidence,N", [("dense", 500), ("lazy", 1024), ("panel", 1024)])
def test_mlp_value_and_grad_on_card_matches_cpu_float64(dev, monkeypatch, evidence, N):
    """cmpnd(mlp, bias, white): the objective and θ̄ on the card (K4 and
    its recompute backward; under lazy the left-looking engine, which panel
    falls back to) against the CPU float64 dense route."""
    kern, X, y = _mlp_data(N)
    cpu = GP(kern, X, y, device="cpu")
    f_ref, g_ref = cpu.value_and_grad_fn()(cpu.theta)
    monkeypatch.setenv("GPC_TPU_EVIDENCE", evidence)
    card = GP(kern, X, y, device=dev)
    before = LAUNCHES["inner_gram"]
    if evidence == "panel":
        with pytest.warns(UserWarning, match="lazy engine"):
            f, g = card.value_and_grad_fn()(card.theta)
    else:
        f, g = card.value_and_grad_fn()(card.theta)
    assert LAUNCHES["inner_gram"] > before
    assert abs(f - f_ref) <= 2e-3 * abs(f_ref)
    assert np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref) < 1e-3
    assert np.abs(g).min() > 0


def test_evidence_left_fast_k5_leaves_match_cholesky_leaves(dev):
    """The lazy sweep with the default Policy (K5 leaves) against
    leafinv=False, float32 at N = 2048, cmpnd(mlp, bias, white)."""
    kern, X, _ = _mlp_data(2048)
    p = torch.tensor(kern.default_params(), dtype=torch.float32, device=dev)
    Xd = torch.tensor(X, dtype=torch.float32, device=dev)
    m = _randn(np.random.default_rng(9), (2048, 2), dev)
    kfn = TLE.kern_block_fn(kern, p, Xd)
    before = LAUNCHES["chol_inv_block"]
    ld, quad = TEF.evidence_left_fast(kfn, 2048, m)
    assert LAUNCHES["chol_inv_block"] == before + 2048 // 256
    ld0, quad0 = TEF.evidence_left_fast(kfn, 2048, m, TEF.Policy(leafinv=False))
    assert abs(float(ld) - float(ld0)) < 2e-4 * abs(float(ld0))
    assert abs(float(quad) - float(quad0)) < 2e-4 * abs(float(quad0))


def test_evidence_left_fast_ragged_k5_leaves_match_cholesky_leaves(dev):
    """N = 625 halves to leaves of 156 and 157: four ragged K5 launches,
    float32, against leafinv=False at 2e-4."""
    kern, X, _ = _mlp_data(625)
    p = torch.tensor(kern.default_params(), dtype=torch.float32, device=dev)
    kfn = TLE.kern_block_fn(kern, p, torch.tensor(X, dtype=torch.float32, device=dev))
    m = _randn(np.random.default_rng(10), (625, 2), dev)
    before = LAUNCHES["chol_inv_block"]
    ld, quad = TEF.evidence_left_fast(kfn, 625, m)
    assert LAUNCHES["chol_inv_block"] == before + 4
    ld0, quad0 = TEF.evidence_left_fast(kfn, 625, m, TEF.Policy(leafinv=False))
    assert abs(float(ld) - float(ld0)) < 2e-4 * abs(float(ld0))
    assert abs(float(quad) - float(quad0)) < 2e-4 * abs(float(quad0))


ZOO = [["-k", "mlp"], ["-k", "poly", "-d", "3"], ["-k", "lin", "-i", "1"], ["-k", "exp"],
       ["-k", "ratquad", "-@", "2"], ["-k", "matern52"]]


@pytest.mark.parametrize("flags", ZOO, ids=lambda f: "".join(f))
def test_learn_kernel_zoo_on_card(dev, tmp_path, capsys, flags):
    """gp learn -# 3 with each leaf type on the card (the CLI's default
    device): a finite objective, and the model file reads back on the card
    and on the CPU with −(final objective) as its log-likelihood (float32
    on the card: 1e-4)."""
    from gpc_tpu_torch.cli import gp as port_cli
    from gpc_tpu_torch.io.svml import write_svml
    rng = np.random.default_rng(25)
    X = 0.5 * rng.standard_normal((300, 2))
    data, model = str(tmp_path / "d.svml"), str(tmp_path / "m")
    write_svml(data, X, np.sin(X[:, :1]) + 0.2 * rng.standard_normal((300, 1)))
    port_cli.main(["learn", "-#", "3"] + flags + [data, model])
    out = capsys.readouterr().out
    final = float(out.split("Final objective:")[1].split()[0])
    assert np.isfinite(final)
    for device in ([], ["--device", "cpu"]):
        port_cli.main(device + ["log-likelihood", data, model])
        ll = float(capsys.readouterr().out.split(":")[-1])
        assert abs(ll + final) <= 1e-4 * abs(final)


def _rel_close(got, want, tol):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


# (K, B, reps): small, the TPU probes', and the edges of the wgmma tiling (one
# slice of 256 at B = 128, three slices at B = 384, no product and one product)
DOT_SHAPES = [(512, 256, 5), (8192, 512, 1024), (256, 128, 0), (256, 128, 1), (768, 128, 1),
              (768, 384, 3)]


@pytest.mark.parametrize("k,b,reps", DOT_SHAPES)
@pytest.mark.parametrize("form", ["c0", "std", "dotT"])
def test_dotform_kernel_matches_plain(dev, form, k, b, reps):
    """K8b: Σ of reps bf16 products in float32, within 1e-4 of the largest
    entry (1024 sums of entries near 9e4 at the full shape)."""
    from gpc_tpu_torch.probes import dotform as TDF
    A, Bv = TDF.probe_inputs(dev, k=k, b=b, seed=11)[form]
    before = LAUNCHES["dotform_probe"]
    got = TDF.dotform_probe(A, Bv, form, reps)
    assert LAUNCHES["dotform_probe"] == before + 1
    _rel_close(got, TDF.dotform_probe_plain(A, Bv, form, reps), 1e-4)


@pytest.mark.parametrize("k,b,reps", DOT_SHAPES)
@pytest.mark.parametrize("pattern", ["hoisted", "read_each", "reshape_each", "dynslot"])
def test_refread_kernel_matches_plain(dev, pattern, k, b, reps):
    """K8c: the c0 product under each read pattern, 1e-4 of the largest
    entry; dynslot alternates its two slots."""
    from gpc_tpu_torch.probes import refread as TRR
    a, Bv = TRR.probe_inputs(dev, k=k, b=b, seed=12)
    before = LAUNCHES["refread_probe"]
    got = TRR.refread_probe(a[pattern], Bv, pattern, reps)
    assert LAUNCHES["refread_probe"] == before + 1
    _rel_close(got, TRR.refread_probe_plain(a[pattern], Bv, pattern, reps), 1e-4)


@pytest.mark.parametrize("k,b", [(256, 128), (768, 384), (8192, 512)])
def test_dot_forms_agree_on_the_same_data(dev, k, b):
    """K8b: c0 on (A, Bv), std on (Aᵀ, Bv) and dotT on (Aᵀ, Bvᵀ) compute
    the same sum through three operand layouts (MN-major and K-major A and
    B): each within 1e-4 of c0's largest entry."""
    from gpc_tpu_torch.probes import dotform as TDF
    A, Bv = TDF.probe_inputs(dev, k=k, b=b, seed=14)["c0"]
    At, Bvt = A.T.contiguous(), Bv.T.contiguous()
    c0 = TDF.dotform_probe(A, Bv, "c0", 3)
    _rel_close(TDF.dotform_probe(At, Bv, "std", 3), c0, 1e-4)
    _rel_close(TDF.dotform_probe(At, Bvt, "dotT", 3), c0, 1e-4)
    _rel_close(c0, TDF.dotform_probe_plain(A, Bv, "c0", 3), 1e-4)


@pytest.mark.parametrize("form", ["c0", "std", "dotT"])
def test_dot_form_one_slice_at_b128(dev, form):
    """One block, one 128 x 128 tile, one slice of 256 k, one product: a
    wrong MN-major descriptor (c0's A and B, std's B) shows as a permuted
    tile.  Every row and column of both operands carries its own scale, so
    no permutation of the tile agrees with the plain version."""
    from gpc_tpu_torch.probes import dotform as TDF
    k, b = 256, 128
    assert TDF.dot_plan(k, b).blocks == 1
    A, Bv = TDF.probe_inputs("cpu", k=k, b=b, seed=15)[form]

    def scaled(t):
        rows, cols = (torch.linspace(0.25, 4.0, n) for n in t.shape)
        return (t.float() * rows[:, None] * cols[None, :]).to(torch.bfloat16)
    A, Bv = scaled(A), scaled(Bv)
    got = TDF.dotform_probe(A.to(dev), Bv.to(dev), form, 1).cpu()
    _rel_close(got, TDF.dotform_probe_plain(A, Bv, form, 1), 1e-4)


@pytest.mark.parametrize("b,reps", [(128, 8), (512, 2048)])
@pytest.mark.parametrize("name", ["exp", "gram", "matvec"])
def test_vpu_kernels_match_plain(dev, name, b, reps):
    """K8d's exp tile and Gram tile within 1e-5 of the largest entry, the
    matvec chain (reps / 2 steps, as the TPU probe) within 1e-4: float32 in
    another order, drifting over the chain."""
    from gpc_tpu_torch.probes import vpu as TVPU
    inp = TVPU.probe_inputs(dev, b=b, seed=13)
    fn, plain, args, n, tol = {
        "exp": (TVPU.vpu_exp, TVPU.vpu_exp_plain, (inp["A"],), reps, 1e-5),
        "gram": (TVPU.vpu_gram_tile, TVPU.vpu_gram_tile_plain, (inp["X"], inp["n2"]), reps, 1e-5),
        "matvec": (TVPU.vpu_matvec, TVPU.vpu_matvec_plain, (inp["A"], inp["v"]), reps // 2,
                   1e-4)}[name]
    before = LAUNCHES[fn.__name__]
    got = fn(*args, n)
    assert LAUNCHES[fn.__name__] == before + 1
    _rel_close(got, plain(*args, n), tol)


@pytest.mark.parametrize("b", [64, 128, 512, 1024])
@pytest.mark.parametrize("cluster", [8, 16])
def test_vpu_matvec_cluster_matches_plain(dev, b, cluster):
    """K8d's matvec on a cluster of 8 and of 16 blocks (16 where the card
    runs it), A in registers (B = 64, 128, 512 at 16), in shared memory (512
    at 8) or streamed from L2 (1024): the TPU probe's 1024 steps within 1e-4
    of the plain chain's largest entry (float32 in another order over the
    chain), one launch; no step returns v."""
    from gpc_tpu_torch.probes import vpu as TVPU
    if cluster > TVPU.matvec_cluster(b):
        pytest.skip(f"the card runs no cluster of {cluster} matvec blocks at B = {b}")
    inp = TVPU.probe_inputs(dev, b=b, seed=15)
    before = LAUNCHES["vpu_matvec"]
    got = TVPU.vpu_matvec(inp["A"], inp["v"], 1024, _cluster=cluster)
    assert LAUNCHES["vpu_matvec"] == before + 1
    _rel_close(got, TVPU.vpu_matvec_plain(inp["A"], inp["v"], 1024), 1e-4)
    assert torch.equal(TVPU.vpu_matvec(inp["A"], inp["v"], 0, _cluster=cluster), inp["v"])


@pytest.mark.parametrize("b,n", [(128, 4), (512, 1024)])
@pytest.mark.parametrize("mode", ["bulk", "direct"])
def test_vpu_stage_store_kernel_matches_plain(dev, mode, b, n):
    """K8d's staged store: the written slots of big equal the plain
    version's bit for bit, and o = n."""
    from gpc_tpu_torch.probes import vpu as TVPU
    A = TVPU.probe_inputs(dev, b=b, seed=14)["A"]
    before = LAUNCHES["vpu_stage_store"]
    big, o = TVPU.vpu_stage_store(A, n, mode)
    assert LAUNCHES["vpu_stage_store"] == before + 1
    big_p, o_p = TVPU.vpu_stage_store_plain(A, n)
    w = TVPU.written_slots(n)
    assert torch.equal(big[:w], big_p[:w]) and torch.equal(o, o_p)


@pytest.mark.parametrize("b,reps", [(64, 1), (64, 2048), (1024, 1), (1024, 64)])
def test_vpu_gram_tile_edges_match_plain(dev, b, reps):
    """K8d's Gram tile on the tensor cores at the narrowest width (one block
    row), the widest card test (B = 1024) and one rep (no acc[0, 0] chain
    before it): within 1e-5 of the plain tile's largest entry, one launch."""
    from gpc_tpu_torch.probes import vpu as TVPU
    inp = TVPU.probe_inputs(dev, b=b, seed=16)
    before = LAUNCHES["vpu_gram_tile"]
    got = TVPU.vpu_gram_tile(inp["X"], inp["n2"], reps)
    assert LAUNCHES["vpu_gram_tile"] == before + 1
    _rel_close(got, TVPU.vpu_gram_tile_plain(inp["X"], inp["n2"], reps), 1e-5)


@pytest.mark.parametrize("b", [512, 1024])
@pytest.mark.parametrize("n", [1, 3, 65])
@pytest.mark.parametrize("mode", ["bulk", "direct"])
def test_vpu_stage_store_ring_edges_match_plain(dev, mode, n, b):
    """K8d's staged store below the ring's 4 stages (n = 1, 3), at a count
    no multiple of them that wraps the 64 slots (n = 65: slot 0 is written
    twice, last by it = 64), at B = 512 and 1024 (8 and 2 iteration
    classes): the written slots and o equal the plain version's bit for bit,
    one launch."""
    from gpc_tpu_torch.probes import vpu as TVPU
    A = TVPU.probe_inputs(dev, b=b, seed=17)["A"] * 1e-6   # small, so 1e-9 it shows
    before = LAUNCHES["vpu_stage_store"]
    big, o = TVPU.vpu_stage_store(A, n, mode)
    assert LAUNCHES["vpu_stage_store"] == before + 1
    big_p, o_p = TVPU.vpu_stage_store_plain(A, n)
    w = TVPU.written_slots(n)
    assert torch.equal(big[:w], big_p[:w]) and torch.equal(o, o_p)
    if n == 65:
        assert not torch.equal(big_p[0], big_p[1])   # slot 0 holds it = 64, not it = 0


def test_vpu_store_plan_reads_the_kernels_layout(dev):
    """store_plan's chunk, warps a block and most iteration classes are the
    kernel's own (gpc_vpu_store_layout), which the wrapper checks once."""
    import ctypes

    from gpc_tpu_torch.ops import cuda_lib
    from gpc_tpu_torch.probes import vpu as TVPU
    layout = (ctypes.c_int * 3)()
    assert cuda_lib.library().gpc_vpu_store_layout(layout) == 0
    assert tuple(layout) == (TVPU.STORE_CHUNK, TVPU.STORE_WARPS, TVPU.STORE_MAX_CLASSES)


def test_probe_wrappers_reject_what_the_kernels_do_not_take(dev):
    from gpc_tpu_torch.probes import dotform as TDF
    from gpc_tpu_torch.probes import refread as TRR
    from gpc_tpu_torch.probes import vpu as TVPU
    A = torch.zeros((512, 256), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        TDF.dotform_probe(A.float(), A.float(), "c0", 2)
    with pytest.raises(ValueError, match="contiguous"):
        TDF.dotform_probe(A.T.contiguous().T, A, "c0", 2)
    with pytest.raises(ValueError, match="reshape_each wants"):
        TRR.refread_probe(A, A, "reshape_each", 2)
    with pytest.raises(ValueError, match="power of two"):
        TVPU.vpu_matvec(torch.zeros((96, 96), device=dev), torch.zeros((96, 1), device=dev), 2)
    with pytest.raises(ValueError, match="contiguous"):
        TVPU.vpu_stage_store(torch.zeros((256, 256), device=dev).T, 2)


SPARSE = ("dtc", "dtcvar", "fitc", "pitc")


def _sparse_pair(dev, approx, lead="rbf", N=600, M=64, pitc_block=100):
    rng = np.random.default_rng(18)
    X = rng.standard_normal((N, 3))
    y = np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((N, 1))
    kern = TK.Cmpnd(input_dim=3, components=(
        {"rbf": TK.Rbf, "mlp": TK.Mlp}[lead](input_dim=3), TK.Bias(input_dim=3),
        TK.White(input_dim=3)))
    kw = dict(approx=approx, num_active=M, seed=1,
              pitc_block=pitc_block if approx == "pitc" else 0)
    return GP(kern, X, y, device="cpu", **kw), GP(kern, X, y, device=dev, **kw), rng


@pytest.mark.parametrize("lead", ["rbf", "mlp"])
@pytest.mark.parametrize("approx", SPARSE)
def test_sparse_on_card_matches_cpu_float64(dev, approx, lead):
    """The sparse evidence (1e-4 relative) and its gradient in θ, X_u and β
    (1e-3 relative L2) in float32 on the card against the CPU's float64,
    PITC in blocks of 70 with a ragged last block of 40; every Gram a kernel
    launch: K_uu, K_uf and PITC's block Grams in one batched launch."""
    cpu, card, _ = _sparse_pair(dev, approx, lead, pitc_block=70)
    name = "inner_gram" if lead == "mlp" else "dist_gram"
    before = dict(LAUNCHES)
    got = card.log_likelihood()
    ref = cpu.log_likelihood()
    assert abs(got - ref) <= 1e-4 * abs(ref)
    assert LAUNCHES[name] - before.get(name, 0) == 2
    if approx == "pitc":
        assert LAUNCHES[f"{name}_batched"] - before.get(f"{name}_batched", 0) == 1
    f, g = card.value_and_grad_fn()(card.theta)
    f_ref, g_ref = cpu.value_and_grad_fn()(cpu.theta)
    assert np.isfinite(g).all() and abs(f - f_ref) <= 1e-4 * abs(f_ref)
    assert np.linalg.norm(g - g_ref) <= 1e-3 * np.linalg.norm(g_ref)


@pytest.mark.parametrize("approx", SPARSE)
def test_sparse_server_on_card_matches_predict(dev, approx):
    """A sparse GPServer on the card (no explicit inverse) against
    GP.predict on the card (1e-5 of the largest) and the CPU's float64
    (1e-4), at request sizes that leave ragged chunks."""
    cpu, card, rng = _sparse_pair(dev, approx)
    srv = GPServer(card, chunk=128)
    assert not srv.explicit_inverse
    Xt = rng.standard_normal((300, 3))
    before = LAUNCHES["dist_gram"]
    mu, var = srv.predict(Xt)
    assert LAUNCHES["dist_gram"] == before + 3        # one K_u* a chunk
    for got, want in zip((mu, var), card.predict(Xt)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    for got, want in zip((mu, var), cpu.predict(Xt)):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert (var >= 0).all()


@pytest.mark.parametrize("M,N", [(1024, 16384), (1000, 16384), (1023, 4097)])
def test_gram_kernels_at_cross_gram_shapes(dev, M, N):
    """K1 and K4 at the sparse path's cross-Gram shapes K_uf (M × N) and
    ragged M, q = 8, against their plain versions."""
    rng = np.random.default_rng(M + N)
    Xu, X = _randn(rng, (M, 8), dev), _randn(rng, (N, 8), dev)
    for family, p in (("rbf", PARAMS["rbf"]), ("mlp", INNER["mlp"])):
        if family == "mlp":
            got, want = TG.inner_gram(family, p, Xu, X), TG.inner_gram_plain(family, p, Xu, X)
            tol = 1e-4 * float(want.abs().max())
        else:
            got, want = TG.dist_gram(family, p, Xu, X), TG.dist_gram_plain(family, p, Xu, X)
            tol = 1.3e-6
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("P", [1, 3, 16])
@pytest.mark.parametrize("family", ["rbf", "matern32", "lin", "mlp"])
def test_batched_gram_equals_2d_launches(dev, family, P):
    """The batched K1/K4 (one launch over the grid's z axis) on P blocks of
    a ragged width (B = 101: misaligned rows, a ragged stripe) equals P
    separate 2-D launches bit for bit, and its plain version within the 2-D
    kernels' tolerance."""
    rng = np.random.default_rng(19 + P)
    Xb = _randn(rng, (P, 101, 8), dev)
    inner = family in INNER
    p = (INNER if inner else PARAMS)[family]
    name = "inner_gram" if inner else "dist_gram"
    kernel = TG.inner_gram_kernel if inner else TG.dist_gram_kernel
    plain = TG.inner_gram_plain if inner else TG.dist_gram_plain
    before = LAUNCHES[f"{name}_batched"]
    got = kernel(family, p, Xb, Xb)
    assert LAUNCHES[f"{name}_batched"] == before + 1 and got.shape == (P, 101, 101)
    for b in range(P):
        assert torch.equal(got[b], kernel(family, p, Xb[b].contiguous(), Xb[b].contiguous()))
    want = plain(family, p, Xb, Xb)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


# --- the IVM -----------------------------------------------------------------

IVM_GAP_TOL, IVM_STATE_TOL = 1e-2, 1e-4      # chip_smoke.py's limits (their reasons there)


@pytest.mark.parametrize("family", ["rbf", "matern32", "lin", "poly", "mlp"])
@pytest.mark.parametrize("n,q", [(4096, 2), (1000, 8)])
def test_gram_kernels_at_the_selection_column(dev, family, n, q):
    """K1/K4 at m = 1: the IVM's kernel column k(X, x_index)."""
    rng = np.random.default_rng(n + q)
    X = _randn(rng, (n, q), dev)
    xi = X[5:6].contiguous()
    if family in TG.FAMILIES:
        got, want = (TG.dist_gram(family, PARAMS[family], X, xi),
                     TG.dist_gram_plain(family, PARAMS[family], X, xi))
    else:
        got, want = (TG.inner_gram(family, INNER[family], X, xi),
                     TG.inner_gram_plain(family, INNER[family], X, xi))
    assert got.shape == (n, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def _ivm(dev, kind="probit", lead="rbf", N=1024, d=128, selection=TI.ENTROPY, D=1):
    """An IVM on [0, 1]² data: D outputs (D > 1 gives ncnm and probit one
    covariance structure an output)."""
    rng = np.random.default_rng(3)
    X = rng.uniform(0.0, 1.0, (N, 2))
    y = np.where(X.sum(axis=1, keepdims=True) > 1.0, 1.0, -1.0)
    y = np.hstack([y, -y] * D)[:, :D]
    noise = {"probit": ProbitNoise, "ncnm": NcnmNoise, "gaussian": GaussianNoise,
             "ordered": OrderedNoise}[kind](D)
    if kind == "ncnm":
        y[rng.uniform(size=(N, D)) < 0.8] = 0.0
    if kind == "gaussian":
        y = np.sin(4.0 * X[:, :1]) + np.arange(D)
    if kind == "ordered":
        y = np.digitize(X[:, :1] + X[:, 1:], [0.7, 1.3]).astype(float)
    first = {"rbf": TK.Rbf, "lin": TK.Lin}[lead](input_dim=2)
    kern = TK.Cmpnd(input_dim=2, components=(first, TK.Bias(input_dim=2), TK.White(input_dim=2)))
    return TI.IVM(kern, noise, X, y, num_active=d, selection=selection, seed=1, device=dev)


def test_ivm_runs_on_the_card_by_default(dev):
    model = _ivm(None, N=300, d=20)
    st = model.init_and_select()
    assert model.device.type == "cuda" and st.mu.is_cuda


def test_ivm_selection_pass_does_not_sync(dev):
    """A pass after the one that captured the step, under
    set_sync_debug_mode("error"): no step (nor the reset, whose draws go
    through pinned memory) syncs the host.  K1 runs once a step."""
    model = _ivm(dev, selection=TI.RENTROPY)
    model.init_and_select()
    torch.cuda.synchronize()
    before = LAUNCHES["dist_gram"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = model.init_and_select()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert LAUNCHES["dist_gram"] == before + 128
    assert len(set(st.active_idx.cpu().tolist())) == 128


@pytest.mark.parametrize("kind,lead,selection,D", [
    ("probit", "rbf", TI.ENTROPY, 1), ("ncnm", "rbf", TI.ENTROPY, 1),
    ("gaussian", "lin", TI.ENTROPY, 1), ("ordered", "rbf", TI.ENTROPY, 1),
    ("ncnm", "rbf", TI.ENTROPY, 2), ("gaussian", "rbf", TI.ENTROPY, 2),
    ("probit", "rbf", TI.RANDOM, 1), ("probit", "lin", TI.RENTROPY, 2)])
def test_ivm_graph_pass_equals_eager_pass(dev, kind, lead, selection, D):
    """The pass replayed from the CUDA graph and the same steps run
    eagerly on the card give the same state bit for bit, for each noise
    model, one or two outputs (two covariance structures for ncnm and
    probit) and each selection criterion."""
    model = _ivm(dev, kind, lead, selection=selection, D=D)
    st = model.init_and_select()
    # the draws of the model's first pass: its MT19937 seeded with 1
    rng, used = RefRng(1), np.zeros(128)
    n_draws = {TI.RANDOM: 128, TI.RENTROPY: 1}.get(selection, 0)
    used[:n_draws] = [rng.rand() for _ in range(n_draws)]
    sel = TI.Selector(model.spec, model.Xd, model.yd)
    sel.reset(model.kern_params, model.noise_params, used)
    with torch.no_grad():
        for _ in range(128):
            TI.step(model.spec, sel.c)
    for name, key in (("active_idx", "idx"), ("m_site", "m_site"), ("beta_site", "beta_site"),
                      ("mu", "mu"), ("varsigma", "vs"), ("nu", "nu"), ("g", "g")):
        assert torch.equal(getattr(st, name), sel.c[key]), name


@pytest.mark.parametrize("kind", ["probit", "gaussian"])
def test_ivm_card_pass_matches_cpu_replay(dev, kind):
    """The card's float32 order through the CPU float64 step: each pick's
    f64 score within IVM_GAP_TOL of the step's maximum, the moments and
    sites within IVM_STATE_TOL of each field's largest entry."""
    model = _ivm(dev, kind)
    st = model.init_and_select()
    ref, gaps = TI.replay(model.spec, model.kern_params, model.noise_params,
                          torch.as_tensor(model.X), torch.as_tensor(model.y),
                          st.active_idx.cpu().numpy())
    assert gaps.max() <= IVM_GAP_TOL
    for name in ("mu", "varsigma", "m_site", "beta_site"):
        a, b = getattr(st, name).double().cpu(), getattr(ref, name)
        assert float((a - b).abs().max() / b.abs().max()) <= IVM_STATE_TOL, name


@pytest.mark.parametrize("kind", ["probit", "gaussian"])
def test_ivm_server_on_card_matches_predict(dev, kind):
    model = _ivm(dev, kind)
    model.init_and_select()
    server = IvmServer(model, chunk=512)
    rng = np.random.default_rng(9)
    for T in (37, 512, 1000):
        Xt = rng.uniform(0.0, 1.0, (T, 2))
        mu, var = server.predict(Xt)
        want_mu, want_var = model.predict(Xt)
        assert np.abs(mu - want_mu).max() <= 1e-4 * np.abs(want_mu).max()
        assert np.abs(var - want_var).max() <= 1e-4 * np.abs(want_var).max()


def test_ivm_capture_failure_raises(dev, monkeypatch):
    """A step that cannot be captured raises; the card never falls back to
    the eager loop."""
    model = _ivm(dev, N=300, d=20)
    real = TI.step

    def syncing_step(spec, c):
        real(spec, c)
        float(c["mu"].sum())            # a host read: not allowed while capturing
    monkeypatch.setattr(TI, "step", syncing_step)
    with pytest.raises(RuntimeError, match="did not capture in a CUDA graph"):
        model.init_and_select()


def _gplvm_data(N, seed=0):
    """bench.py's GP-LVM data at N rows: tanh(Z·W) + 0.1ε, D = 4, q = 2."""
    rng = np.random.default_rng(seed)
    Z, W = rng.standard_normal((N, 2)), rng.standard_normal((2, 4))
    return np.tanh(Z @ W) + 0.1 * rng.standard_normal((N, 4))


def _gplvm(Y, device, **kw):
    from gpc_tpu_torch.models.gplvm import GPLVM
    kern = TK.Cmpnd(input_dim=2, components=(
        TK.Rbf(input_dim=2), TK.Bias(input_dim=2), TK.White(input_dim=2)))
    return GPLVM(kern, Y, latent_dim=2, device=device, **kw)


@pytest.mark.parametrize("evidence", ["dense", "lazy"])
def test_gplvm_on_card_matches_cpu_float64(dev, monkeypatch, evidence):
    """The GP-LVM objective and θ̄ at N = 512 on the card (K1 and its X̄
    VJP; under lazy at base 128 the left-looking sweep, and for the
    objective alone K5 leaves) against the CPU float64 route: 1e-4 on the
    objective, 1e-3 relative L2 on θ̄."""
    monkeypatch.setenv("GPC_TPU_EVIDENCE", evidence)
    monkeypatch.setenv("GPC_TPU_EVIDENCE_BASE", "128")
    Y = _gplvm_data(512)
    cpu = _gplvm(Y, "cpu")
    f_ref, g_ref = cpu.value_and_grad_fn()(cpu.theta)
    card = _gplvm(Y, dev)
    before = dict(LAUNCHES)
    f, g = card.value_and_grad_fn()(card.theta)
    ll = card.log_likelihood()
    assert LAUNCHES["dist_gram"] > before.get("dist_gram", 0)
    if evidence == "lazy":
        assert LAUNCHES["chol_inv_block"] == before.get("chol_inv_block", 0) + 512 // 128
    assert abs(f - f_ref) <= 1e-4 * abs(f_ref) and abs(ll + f_ref) <= 1e-4 * abs(f_ref)
    assert np.linalg.norm(g - g_ref) / np.linalg.norm(g_ref) < 1e-3


def test_iterative_mvm_on_card_matches_plain(dev):
    """kernel_mvm over 512-row blocks of N = 2048: one K1 launch a block,
    within 1e-5 of the largest entry of the dense plain product."""
    from gpc_tpu_torch.ops import iterative as TIT
    rng = np.random.default_rng(4)
    kern = TK.Cmpnd(input_dim=2, components=(
        TK.Rbf(input_dim=2), TK.Bias(input_dim=2), TK.White(input_dim=2)))
    p = torch.tensor([0.8, 1.2, 0.3, 0.5], device=dev)
    X, V = _randn(rng, (2048, 2), dev), _randn(rng, (2048, 5), dev)
    before = LAUNCHES["dist_gram"]
    got = TIT.kernel_mvm(kern, p, X, V, block=512)
    assert LAUNCHES["dist_gram"] == before + 4
    K = TG.dist_gram_plain("rbf", p[:2], X, X) + p[2]
    want = K @ V + p[3] * V
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_masked_engine_on_card_equals_plain_k1(dev, monkeypatch):
    """The masked iterative evidence (breaks at 0, 700, 1500) and its θ̄ on
    the card, K1 against the same engine with the plain Gram, N = 2048 on
    spread latents with a unit white variance (CG settles well inside its
    256 iterations): 1e-4 on (logdet, quad), 1e-3 relative L2 on (p̄, X̄)."""
    from gpc_tpu_torch.ops import iterative as TIT
    rng = np.random.default_rng(6)
    kern = TK.Cmpnd(input_dim=2, components=(
        TK.Rbf(input_dim=2), TK.Bias(input_dim=2), TK.White(input_dim=2)))
    X0 = 3.0 * _randn(rng, (2048, 2), dev)
    m = _randn(rng, (2048, 2), dev)
    mask = torch.ones(2048, device=dev)
    mask[[0, 700, 1500]] = 0.0
    m = m * mask[:, None]
    cfg = TIT.IterConfig(block=512, cg_iters=256)

    def run():
        p = torch.tensor([1.0, 1.0, 0.2, 1.0], device=dev, requires_grad=True)
        X = X0.clone().requires_grad_(True)
        ld, quad = TIT.kern_evidence_iterative_masked(kern, p, X, m, mask, cfg)
        grads = torch.autograd.grad(ld + quad, (p, X))
        return torch.stack([ld, quad]).detach(), [g.cpu().numpy() for g in grads]

    before = LAUNCHES["dist_gram"]
    vals, grads = run()
    assert LAUNCHES["dist_gram"] > before
    monkeypatch.setattr(TK, "dist_gram", TG.dist_gram_plain)
    before = LAUNCHES["dist_gram"]
    vals_p, grads_p = run()
    assert LAUNCHES["dist_gram"] == before
    assert float(((vals - vals_p).abs() / vals_p.abs()).max()) < 1e-4
    for a, b in zip(grads, grads_p):
        assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3


# ---------------------------------------------------------------- interop --


def _interop_data(n=512, q=3, seed=12):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, q))
    return X, np.sin(X.sum(axis=1, keepdims=True)) + 0.1 * rng.standard_normal((n, 1))


def _cmpnd(q):
    return TK.Cmpnd(input_dim=q, components=(TK.Rbf(input_dim=q), TK.Bias(input_dim=q),
                                             TK.White(input_dim=q)))


def test_fgp_on_card(dev):
    """fgp on the card: K1 runs, the objective within 1e-4 of the CPU
    float64 route's, the query within 1e-4 of GP.predict."""
    import importlib
    F = importlib.import_module("gpc_tpu_torch.interop.fgp")
    X, y = _interop_data()
    F.clear()
    before = LAUNCHES["dist_gram"]
    obj = F.train("rBw", X, y, iters=3)
    assert LAUNCHES["dist_gram"] > before and F._state["model"].device.type == "cuda"
    F.clear()
    obj_cpu = F.train("rBw", X, y, iters=3, device="cpu")
    assert abs(obj - obj_cpu) / abs(obj_cpu) < 1e-4
    F.train("rBw", X, y, iters=3)
    mu, var = F.query(X[:100], want_variance=True)
    want_mu, want_var = F._state["model"].predict(X[:100])
    for got, want in ((mu, want_mu), (var, want_var)):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    F.clear()


@pytest.mark.parametrize("approx", ["ftc", "dtc"])
def test_mat_round_trip_on_card(dev, tmp_path, approx):
    """write_gp_mat → read_gp_mat on the card: the same log-likelihood
    within 1e-6."""
    from gpc_tpu_torch.io import mat_io
    X, y = _interop_data()
    kw = dict(num_active=64, seed=0) if approx == "dtc" else {}
    model = GP(_cmpnd(3), X, y, approx=approx, device=dev, **kw)
    mat_io.write_gp_mat(tmp_path / "m.mat", model, X=X, y=y)
    back = mat_io.read_gp_mat(tmp_path / "m.mat")
    assert back.device.type == "cuda"
    ll, ll_back = model.log_likelihood(), back.log_likelihood()
    assert abs(ll_back - ll) <= 1e-6 * abs(ll)


def test_format_1_learn_on_card(dev, tmp_path, monkeypatch, capsys):
    """gp learn -f 1 on the card prints what -f 0 prints on the same data."""
    import scipy.io as sio

    from gpc_tpu_torch.cli import gp as port_gp
    from gpc_tpu_torch.io.svml import write_svml
    monkeypatch.chdir(tmp_path)
    X, y = _interop_data()
    sio.savemat("d.mat", {"X": X, "y": y})
    write_svml("d.svml", X, y)
    outs = []
    for argv in (["-f", "1", "d.mat", "m1"], ["d.svml", "m0"]):
        port_gp.main(["-s", "1", "learn", "-#", "3"] + argv)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "Final objective" in outs[0]


def test_native_svml_reader_on_card_machine(tmp_path):
    """The card's machine builds the native reader: read_svml takes it."""
    from gpc_tpu_torch.io import svml
    from gpc_tpu_torch.native import svml_native
    X, y = _interop_data(n=200)
    svml.write_svml(tmp_path / "d.svml", X, y)
    native = svml_native.read(tmp_path / "d.svml")
    assert native is not None
    for a, b in zip(native, svml.read_svml_py(tmp_path / "d.svml")):
        np.testing.assert_array_equal(a, b)
    before = dict(svml.READS)
    svml.read_svml(tmp_path / "d.svml")
    assert svml.READS["native"] == before.get("native", 0) + 1
    assert svml.READS["python"] == before.get("python", 0)


@pytest.mark.parametrize("approx", ["ftc", "dtc", "dtcvar", "fitc"])
def test_dist_objective_world_size_1_on_card(dev, tmp_path, approx):
    """make_dist_objective on NCCL at world size 1 against the single-process
    model on the card: the value within 1e-5, θ̄ within 1e-4 relative L2
    (both float32, summed in other orders); K1 runs."""
    import torch.distributed as dist

    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel.dist_gp import make_dist_objective
    from gpc_tpu_torch.parallel.mesh import data_mesh, shard_rows
    X, y = _interop_data(n=1000)
    kw = dict(num_active=64, seed=0) if approx != "ftc" else {}
    model = GP(_cmpnd(3), X, y, approx=approx, device=dev, **kw)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        mesh = data_mesh()
        nlml = make_dist_objective(model.spec, mesh, model.bias, model.fixed_scales, 1000)
        Xl, yl, ml = (shard_rows(mesh, a) for a in (X, y, np.ones(1000)))
        before = LAUNCHES["dist_gram"]
        f, g = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device)(model.theta)
        assert LAUNCHES["dist_gram"] > before
    finally:
        dist.destroy_process_group()
    f0, g0 = model.value_and_grad_fn()(model.theta)
    assert abs(f - f0) <= 1e-5 * abs(f0)
    assert np.linalg.norm(g - g0) <= 1e-4 * np.linalg.norm(g0)


@pytest.fixture
def nccl_world_one(dev, tmp_path):
    """A world-size-1 NCCL group (file store under tmp_path); its mesh."""
    import torch.distributed as dist

    from gpc_tpu_torch.parallel.mesh import data_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        yield data_mesh()
    finally:
        dist.destroy_process_group()


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def test_chol_distributed_world_size_1_on_card(nccl_world_one):
    """chol_distributed and evidence_distributed's (logdet, quad) and their
    cotangents against the dense float32 route on the card."""
    from gpc_tpu_torch.parallel.chol_distributed import chol_distributed, evidence_distributed
    mesh = nccl_world_one
    rng = np.random.default_rng(3)
    A = rng.standard_normal((512, 512))
    K = torch.tensor(A @ A.T / 512 + np.eye(512), dtype=torch.float32, device=mesh.device)
    m = torch.tensor(rng.standard_normal((512, 2)), dtype=torch.float32, device=mesh.device)
    L0 = torch.linalg.cholesky(K)
    L = chol_distributed(mesh, K)
    assert float((L - L0).abs().max()) <= 1e-5 * float(L0.abs().max())
    Kr, mr = K.clone().requires_grad_(True), m.clone().requires_grad_(True)
    ld, quad = evidence_distributed(mesh, Kr, mr)
    Kbar, mbar = torch.autograd.grad(3.0 * ld + 0.5 * quad, (Kr, mr))
    ld, quad = ld.detach(), quad.detach()
    alpha = torch.cholesky_solve(m, L0)
    assert abs(float(ld) - float(torch.logdet(K))) <= 1e-5 * abs(float(torch.logdet(K)))
    assert abs(float(quad) - float(torch.sum(m * alpha))) <= 1e-5 * float(torch.sum(m * alpha))
    want = 3.0 * torch.cholesky_inverse(L0) - 0.5 * alpha @ alpha.T
    assert _rel_l2(Kbar.cpu(), want.cpu()) <= 1e-4
    assert _rel_l2(mbar.cpu(), alpha.cpu()) <= 1e-4


def test_dist_ftc_world_size_1_on_card(nccl_world_one):
    """make_dist_ftc_value_and_grad against the single-process model (value
    1e-5, θ̄ 1e-4 relative L2; K1 runs) and the posterior against
    GP.predict (1e-4 of each output's largest entry)."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel.dist_ftc import (make_dist_ftc_posterior,
                                                 make_dist_ftc_value_and_grad)
    from gpc_tpu_torch.parallel.mesh import shard_rows
    mesh = nccl_world_one
    X, y = _interop_data(n=1000)
    model = GP(_cmpnd(3), X, y, device=mesh.device)
    Xl, yl, ml = (shard_rows(mesh, a) for a in (X, y, np.ones(1000)))
    nlml = make_dist_ftc_value_and_grad(model.spec, mesh, model.bias, model.fixed_scales, 1000)
    before = LAUNCHES["dist_gram"]
    f, g = numpy_value_and_grad(lambda t: nlml(t, Xl, yl, ml), mesh.device)(model.theta)
    assert LAUNCHES["dist_gram"] > before
    f0, g0 = model.value_and_grad_fn()(model.theta)
    assert abs(f - f0) <= 1e-5 * abs(f0) and _rel_l2(g, g0) <= 1e-4
    Xt = np.random.default_rng(4).standard_normal((300, 3))
    post = make_dist_ftc_posterior(model.spec, mesh, model.bias, model.fixed_scales, 1000)
    mu, var = post(as_tensor(model.theta, mesh.device), Xl, yl, ml, as_tensor(Xt, mesh.device))
    for a, b in zip((mu, var), model.predict(Xt)):
        assert np.abs(a.cpu().numpy() - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.parametrize("dynamics", [False, True])
def test_dist_gplvm_world_size_1_on_card(nccl_world_one, dynamics):
    """make_dist_gplvm_value_and_grad (plain; GPDM with breaks) against the
    single-process dense GPLVM on the card (value 1e-5, θ̄ 1e-4)."""
    from gpc_tpu_torch.models.gplvm import GPLVM
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel.dist_gplvm import make_dist_gplvm_value_and_grad
    from gpc_tpu_torch.parallel.mesh import shard_rows
    mesh = nccl_world_one
    Y = np.random.default_rng(5).standard_normal((512, 4))
    kw = dict(dyn_kern=_cmpnd(2), dyn_breaks=(0, 200)) if dynamics else {}
    model = GPLVM(_cmpnd(2), Y, latent_dim=2, device=mesh.device, **kw)
    nlml = make_dist_gplvm_value_and_grad(model.spec, mesh, model.noise_bias,
                                          model.fixed_scales, model.dyn_params_fixed)
    yl = shard_rows(mesh, Y)
    f, g = numpy_value_and_grad(lambda t: nlml(t, yl), mesh.device)(model.theta)
    f0, g0 = model.value_and_grad_fn()(model.theta)
    assert abs(f - f0) <= 1e-5 * abs(f0) and _rel_l2(g, g0) <= 1e-4


def test_dist_iterative_world_size_1_on_card(nccl_world_one):
    """make_dist_iterative_evidence on the single-process engine's probes
    against kern_evidence_iterative (1e-5); K1 runs a row block."""
    from gpc_tpu_torch.ops import iterative as TI
    from gpc_tpu_torch.parallel.dist_iterative import make_dist_iterative_evidence
    from gpc_tpu_torch.parallel.mesh import shard_rows
    mesh = nccl_world_one
    X, y = _interop_data(n=1024)
    kern = _cmpnd(3)
    p = torch.tensor([1.0, 1.0, 0.1, 0.05], device=mesh.device)
    cfg = TI.IterConfig(block=256, probes=8, lanczos_iters=16, cg_iters=64, trace_probes=8)
    m = torch.tensor(y, dtype=torch.float32, device=mesh.device)
    with torch.no_grad():
        ld0, quad0 = TI.kern_evidence_iterative(kern, p, shard_rows(mesh, X), m, cfg)
        before = LAUNCHES["dist_gram"]
        ld, quad = make_dist_iterative_evidence(kern, mesh, cfg)(
            p, shard_rows(mesh, X), m, shard_rows(mesh, np.ones(1024)))
    assert LAUNCHES["dist_gram"] > before
    assert abs(float(ld) - float(ld0)) <= 1e-5 * abs(float(ld0))
    assert abs(float(quad) - float(quad0)) <= 1e-5 * abs(float(quad0))


def test_dist_ivm_world_size_1_on_card(nccl_world_one):
    """make_select_points_dist's order against the single process's graph;
    a pick that differs must lie within IVM_GAP_TOL of its step's f64
    maximum (the CPU float64 replay)."""
    from gpc_tpu_torch.models.ivm import IVM, replay
    from gpc_tpu_torch.noise import GaussianNoise
    from gpc_tpu_torch.parallel.dist_ivm import make_select_points_dist
    from gpc_tpu_torch.parallel.mesh import shard_rows
    mesh = nccl_world_one
    X, y = _interop_data(n=512, q=2)
    model = IVM(_cmpnd(2), GaussianNoise(output_dim=1), X, y, num_active=64,
                device=mesh.device)
    order0 = model.init_and_select().active_idx.cpu().numpy()
    st = make_select_points_dist(model.spec, mesh)(
        model.kern_params, model.noise_params,
        *(shard_rows(mesh, a) for a in (X, y, np.ones(512))), np.zeros(64))
    order = st.active_idx.cpu().numpy()
    assert len(set(order.tolist())) == 64
    if not np.array_equal(order, order0):
        _, gaps = replay(model.spec, model.kern_params, model.noise_params,
                         torch.as_tensor(X), torch.as_tensor(y), order)
        assert gaps.max() <= IVM_GAP_TOL


@pytest.mark.parametrize("approx", ["dtc", "dtcvar", "fitc"])
def test_dist_sparse2d_mesh_2d_1x1_on_card(nccl_world_one, approx):
    """make_dist2d_objective on mesh_2d(1, 1) (gpc_tpu's non-whitened
    forms) against the CPU float64 route at N = 1000, M = 64 (value 1e-4, θ̄
    1e-3 relative L2); K1 runs."""
    from gpc_tpu_torch.optim import numpy_value_and_grad
    from gpc_tpu_torch.parallel.dist_sparse2d import make_dist2d_objective, shard_data_2d
    from gpc_tpu_torch.parallel.mesh import mesh_2d
    m2 = mesh_2d(1, 1)
    assert (m2.mp.size, m2.dp.size, m2.device) == (1, 1, nccl_world_one.device)
    X, y = _interop_data(n=1000)
    card = GP(_cmpnd(3), X, y, approx=approx, num_active=64, seed=0, device=m2.device)
    cpu = GP(_cmpnd(3), X, y, approx=approx, num_active=64, seed=0, device="cpu")
    nlml = make_dist2d_objective(card.spec, m2, card.bias, card.fixed_scales, 1000)
    args = [shard_data_2d(m2, a) for a in (X, y, np.ones(1000))]
    before = LAUNCHES["dist_gram"]
    f, g = numpy_value_and_grad(lambda t: nlml(t, *args), m2.device)(card.theta)
    assert LAUNCHES["dist_gram"] > before
    f0, g0 = cpu.value_and_grad_fn()(cpu.theta)
    assert abs(f - f0) <= 1e-4 * abs(f0) and _rel_l2(g, g0) <= 1e-3


def test_scaling_bench_main_world_size_1_on_card(dev, tmp_path):
    """`python -m gpc_tpu_torch.parallel.scaling_bench 256 32 --worlds 1`
    on NCCL prints gpc_tpu's one line for the world."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "gpc_tpu_torch.parallel.scaling_bench", "256",
                          "32", "--worlds", "1"], cwd=tmp_path, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=repo), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert (line["devices"], line["n"], line["efficiency"]) == (1, 256, 1.0) and line["t_ms"] > 0



def _bench_rbf(dev, n=2048, q=8, seed=0):
    rng = np.random.default_rng(seed)
    return _randn(rng, (n, q), dev), _randn(rng, (n, 1), dev)


def test_dense_evidence_backward_on_card(dev):
    """evidence_terms' closed-form backward on the card, N = 4096, float32,
    an rbf + 0.1·I Gram (κ ≈ 8e2, asserted below 1e3): Ā and m̄ of
    3·logdet + 0.5·quad against the float64 closed form 3·A⁻¹ − 0.5·ααᵀ,
    α = A⁻¹m, on the card, within 1e-3 in relative L2 and of the largest
    entry — a float32 factor and explicit inverse err by about κ·2⁻²⁴ ≈ 5e-5
    relative, while a lost term or block errs by order 1; Ā exactly
    symmetric; one `evidence.inverse_vjp`."""
    from gpc_tpu_torch import linalg as TLA
    from gpc_tpu_torch.utils import profiling
    n = 4096
    X, m = _bench_rbf(dev, n=n)
    A = TG.dist_gram("rbf", torch.tensor([1.0, 1.0], device=dev), X, X) \
        + 0.1 * torch.eye(n, device=dev)
    A64, m64 = A.double(), m.double()
    ev = torch.linalg.eigvalsh(A64)
    assert float(ev[-1] / ev[0]) < 1e3
    Ainv = torch.cholesky_inverse(torch.linalg.cholesky(A64))
    alpha = Ainv @ m64
    want = (3.0 * Ainv - 0.5 * alpha @ alpha.T, alpha)
    At, mt = A.clone().requires_grad_(True), m.clone().requires_grad_(True)
    before = profiling.counts().get("evidence.inverse_vjp", 0)
    ld, quad, _ = TLA.evidence_terms(At, mt)
    got = torch.autograd.grad(3.0 * ld + 0.5 * quad, (At, mt))
    assert profiling.counts()["evidence.inverse_vjp"] == before + 1
    assert torch.equal(got[0], got[0].T)
    for g, w in zip(got, want):
        err = g.double() - w
        assert float(torch.linalg.norm(err)) <= 1e-3 * float(torch.linalg.norm(w))
        assert float(err.abs().max()) <= 1e-3 * float(w.abs().max())


def test_profiling_times_the_card(dev, monkeypatch):
    """utils.profiling on the card: measure_rtt() fetches from the card
    unless asked for the CPU; time_fn times CUDA output with CUDA events
    (no round trip measured) and CPU output on the host clock, less the
    CPU's round trip."""
    from gpc_tpu_torch.utils import profiling as TPR
    seen, ones = [], torch.ones
    monkeypatch.setattr(torch, "ones", lambda *a, **k: seen.append(
        torch.device(k["device"]).type) or ones(*a, **k))
    assert TPR.measure_rtt(samples=2) > 0.0 and seen == ["cuda"]
    seen.clear()
    assert TPR.time_fn(lambda a: a * 2.0, torch.arange(4.0, device=dev), reps=2) > 0.0
    assert seen == []
    assert TPR.time_fn(lambda a: a * 2.0, torch.arange(4.0), reps=2) >= 0.0
    assert seen == ["cpu"]
