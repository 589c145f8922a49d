"""Informative Vector Machine — greedy active-set GP classification.

Counterpart of gpc_tpu/models/ivm.py (reference CIvm.{h,cpp}: Lawrence,
Seeger and Herbrich's ADF selection).  The greedy selection is sequential, d
rank-1 updates (CIvm.cpp:248-365); gpc_tpu runs it as one `lax.scan` over
zero-padded buffers, and so does the port, as d calls of one step function
over the same buffers:

  per step (CIvm::addPoint):
    entropy scores  Δᵢ = −½·log(1 − ςᵢ·νᵢ + 1e-300)   (CIvm.cpp:413-431)
    site update     β = ν/(1−ν·ς), m = μ + g/ν          (CNoise.cpp:40-63)
    rank-1 update   s = k_new − Mᵀa;  M ← [M; s·√ν];  L ← [L 0; aᵀ 1/√ν]
                    ς ← ς − s²·ν;  μ ← μ + g·s           (CIvm.cpp:302-365)
    refresh ν/g for all N points                          (CIvm.cpp:490-494)

The picked point's own variance takes the equal form ς/(1 + ς·β̃) in place
of ς − s²·ν (β̃ its site precision before any clamp; s = ς there): in
float32 the subtraction cancels to σ²'s size at the CLI's default Gaussian
σ² of 1e-6 and leaves active points with ς + σ² < 0, where the Gaussian
noise model's log likelihood is NaN.

The step is a function of device tensors only: the picked index and the
step counter k stay on the device (`index_select`, `index_copy_`,
`index_add`), the random pick's rank among the inactive points is a device
`cumsum`/`argmax`, and nothing is read back to the host.  On the card one
step is captured in a CUDA graph the first time a pass runs and replayed d
times a pass, with k in device memory; a step that fails to capture raises
(there is no eager fallback on the card).  The CPU runs the same step
eagerly.  M is (C, d, N) and L (C, d, d), as in gpc_tpu, and the product
Mᵀa runs over all d rows every step: the sums keep gpc_tpu's order and the
shapes stay static for the graph.  The kernel column k(X, x_index) is a K1
(distance family) or K4 (lin, poly, mlp) launch.

Hyperparameters train on the ACTIVE-SET marginal likelihood
L = −½Σⱼ[logdet(K+B⁻¹) + mᵀ(K+B⁻¹)⁻¹m] + priors (CIvm.cpp:521-540), by
autograd and SCG (float64 on the host), alternating with noise-parameter
rounds (CIvm::optimise, CIvm.cpp:685-736).

Spans and counters (utils/profiling): `gpc.ivm.select` around each
selection pass, closed by the pass's one blocking read of its order
(`host_read("ivm_order")`), so the pass's device work lies inside it;
`gpc.ivm.kern_round` and `gpc.ivm.noise_round` around each SCG round, whose
evaluations open the `gpc.eval.*` spans of optim.numpy_value_and_grad;
`ivm.steps` counts the selection steps, d a pass, on the host.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, linalg, resolve_device
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch import transforms as tr
from gpc_tpu_torch.kernels import Kern
from gpc_tpu_torch.noise import Noise
from gpc_tpu_torch.ops import cuda_lib
from gpc_tpu_torch.optim import check_gradients, numpy_value_and_grad, scg
from gpc_tpu_torch.utils import checkpoint as ckpt_mod
from gpc_tpu_torch.utils.profiling import COUNTS, host_read, span
from gpc_tpu_torch.utils.refrng import RefRng

ENTROPY, RENTROPY, RANDOM = "entropy", "rentropy", "random"


@dataclasses.dataclass(frozen=True)
class IvmSpec:
    kern: Kern
    noise: Noise
    n_data: int
    input_dim: int
    output_dim: int
    num_active: int
    selection: str = ENTROPY

    @property
    def n_struct(self) -> int:
        """numCovStruct: 1 for spherical noise else outputDim (CIvm.cpp:166-170)."""
        return 1 if self.noise.spherical else self.output_dim


class IvmState(NamedTuple):
    active_idx: torch.Tensor   # (d,) int64 — selection order
    active_mask: torch.Tensor  # (N,) bool
    m_site: torch.Tensor       # (d, D) site means
    beta_site: torch.Tensor    # (d, D) site precisions
    mu: torch.Tensor           # (N, D) ADF posterior means
    varsigma: torch.Tensor     # (N, D) ADF posterior variances
    nu: torch.Tensor           # (N, D)
    g: torch.Tensor            # (N, D)


def _copy_in(dst: torch.Tensor, src):
    """Copy numpy or a tensor into a device buffer without a host sync: a
    host array goes through pinned memory as an asynchronous copy."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.array(src, dtype=np.float64).reshape(dst.shape))
        if dst.device.type == "cuda":
            src = src.to(dst.dtype).pin_memory()
    dst.copy_(src.reshape(dst.shape), non_blocking=True)


def entropy_scores(spec: IvmSpec, c: dict) -> torch.Tensor:
    """The entropy change of adding each point (CIvm.cpp:413-431), −inf on
    the active points."""
    vs, nu = c["vs"], c["nu"]
    if spec.noise.spherical:
        delta = -0.5 * torch.log(1.0 - vs[:, 0] * nu[:, 0] + 1e-300) * spec.output_dim
    else:
        delta = torch.sum(-0.5 * torch.log(1.0 - vs * nu + 1e-300), dim=1)
    return delta.masked_fill(c["mask"], float("-inf"))


def pick_index(spec: IvmSpec, c: dict) -> torch.Tensor:
    """The step's data index as a (1,) device tensor.  Entropy: the first
    maximum of the scores (a NaN score counts as the maximum, as in
    gpc_tpu).  Random: index ⌊r·|inactive|⌋ of the ascending inactive list
    (CIvm.cpp:405-407), clamped as in gpc_tpu since a float32 draw near 1
    rounds to 1.0; rentropy takes the random pick at k = 0 only."""
    ent_index = torch.argmax(entropy_scores(spec, c)).view(1)
    if spec.selection == ENTROPY:
        return ent_index
    k = c["k"]
    mask = c["mask"]
    r = c["rand"].index_select(0, k)
    n_inactive = spec.n_data - k
    target = torch.minimum(torch.floor(r * n_inactive), n_inactive - 1).to(torch.int64)
    rank = torch.cumsum(~mask, dim=0) - 1           # rank among the inactive points
    rand_index = torch.argmax(((rank == target) & ~mask).to(torch.uint8)).view(1)
    if spec.selection == RANDOM:
        return rand_index
    return torch.where(k == 0, rand_index, ent_index)


def add_point(spec: IvmSpec, c: dict, index: torch.Tensor):
    """CIvm::addPoint for the (1,) device index at step c["k"]: the site
    update (beta clamp for non-log-concave noise, CIvm.cpp:283-298), the
    kernel column with white on its own diagonal (CIvm.cpp:305-311), the
    rank-1 updates per covariance structure (CIvm.cpp:319-349), the moments
    (CIvm.cpp:336-365) and ν/g for all points (CIvm.cpp:490-494), all in
    place on the carry's buffers; k advances by one."""
    noise, k = spec.noise, c["k"]
    np_, X, y = c["np"], c["X"], c["y"]
    mu, vs, nu, g = c["mu"], c["vs"], c["nu"], c["g"]
    rows = [t.index_select(0, index) for t in (mu, vs, y, nu, g)]
    m_i, beta_i = noise.update_sites(np_, *rows)
    beta_own = beta_i               # before the clamp: the point's own ς takes it
    if not noise.log_concave:
        beta_i = torch.where(beta_i < 0, 1e-6, beta_i)
    vs_i, nu_i, g_i = rows[1], rows[3], rows[4]

    k_col = spec.kern.compute(c["kp"], X, X.index_select(0, index))[:, 0]
    k_col = k_col.index_add(0, index, c["white"])

    M, L, cmap = c["M"], c["L"], c["cmap"]
    a = M.index_select(2, index)[:, :, 0]                       # (C, d)
    s = k_col[None, :] - torch.einsum("cdn,cd->cn", M, a)       # (C, N)
    sqrt_nu = torch.sqrt(nu_i[0].index_select(0, cmap[:spec.n_struct]))   # (C,)
    M.index_copy_(1, k, (s * sqrt_nu[:, None])[:, None, :])
    L.index_copy_(1, k, a.index_copy(1, k, (1.0 / sqrt_nu)[:, None])[:, None, :])

    s_out = s.index_select(0, cmap).T                           # (N, D)
    nu_out = nu_i[0].index_select(0, cmap)                      # (D,)
    vs.sub_((s_out ** 2) * nu_out[None, :])
    vs.index_copy_(0, index, vs_i / (1.0 + vs_i * beta_own.index_select(1, cmap)))
    mu.add_(g_i * s_out)

    c["mask"].index_fill_(0, index, True)
    c["idx"].index_copy_(0, k, index)
    c["m_site"].index_copy_(0, k, m_i)
    c["beta_site"].index_copy_(0, k, beta_i)
    nu_new, g_new = noise.nu_g(np_, mu, vs, y)
    nu.copy_(nu_new)
    g.copy_(g_new)
    k.add_(1)


def step(spec: IvmSpec, c: dict):
    """One selection step: pick, then add the point."""
    add_point(spec, c, pick_index(spec, c))


class Selector:
    """The buffers of a selection pass over fixed data X, y (device tensors
    in the working dtype), reusable pass after pass: `run` copies the
    parameters and draws in, resets the state and takes d steps.  On the
    card the step is captured once in a CUDA graph (after one eager
    warm-up step) and replayed d times a pass; the Gram launches counted
    at capture are taken out of `cuda_lib.LAUNCHES` and each replay adds
    them back, so the counts are the kernels the card ran."""

    def __init__(self, spec: IvmSpec, X: torch.Tensor, y: torch.Tensor):
        self.spec = spec
        N, D, d, C = spec.n_data, spec.output_dim, spec.num_active, spec.n_struct
        dev, dt = X.device, X.dtype
        z = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)   # noqa: E731
        cmap = (torch.zeros(D, dtype=torch.int64, device=dev) if C == 1
                else torch.arange(D, device=dev))
        self.c = dict(X=X, y=y, kp=z(spec.kern.n_params), np=z(spec.noise.n_params),
                      rand=z(d), white=z(1), cmap=cmap,
                      k=torch.zeros(1, dtype=torch.int64, device=dev),
                      M=z(C, d, N), L=z(C, d, d), mu=z(N, D), vs=z(N, D), nu=z(N, D),
                      g=z(N, D), m_site=z(d, D), beta_site=z(d, D),
                      mask=torch.zeros(N, dtype=torch.bool, device=dev),
                      idx=torch.zeros(d, dtype=torch.int64, device=dev))
        self.graph = None
        self.step_launches = collections.Counter()

    def reset(self, kern_params, noise_params, rand_vals):
        """Parameters and draws in; the state at step 0 (gpc_tpu's init)."""
        c, spec = self.c, self.spec
        _copy_in(c["kp"], kern_params)
        _copy_in(c["np"], noise_params)
        _copy_in(c["rand"], rand_vals)
        with torch.no_grad():
            c["white"].copy_(spec.kern.white(c["kp"]).reshape(1))
            diagK = spec.kern.diag(c["kp"], c["X"])
            c["mu"].zero_()
            c["vs"].copy_(diagK[:, None].expand_as(c["vs"]))
            nu0, g0 = spec.noise.nu_g(c["np"], c["mu"], c["vs"], c["y"])
            c["nu"].copy_(nu0)
            c["g"].copy_(g0)
        for name in ("M", "L", "m_site", "beta_site", "mask", "idx", "k"):
            c[name].zero_()

    def _capture(self):
        """Warm up on a side stream, reset, capture one step."""
        saved = {n: self.c[n].clone() for n in ("kp", "np", "rand")}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.no_grad():
            step(self.spec, self.c)
        torch.cuda.current_stream().wait_stream(side)
        self.reset(saved["kp"], saved["np"], saved["rand"])
        before = collections.Counter(cuda_lib.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph), torch.no_grad():
                step(self.spec, self.c)
        except RuntimeError as e:
            raise RuntimeError("the IVM selection step did not capture in a CUDA "
                               f"graph: {e}") from e
        after = collections.Counter(cuda_lib.LAUNCHES)
        self.step_launches = after - before
        cuda_lib.LAUNCHES.subtract(self.step_launches)
        self.graph = graph

    def run(self, kern_params, noise_params, rand_vals) -> IvmState:
        """One pass: d steps from the reset state; the state is returned as
        copies, so the next pass does not overwrite it."""
        self.reset(kern_params, noise_params, rand_vals)
        c, d = self.c, self.spec.num_active
        if c["X"].device.type == "cuda":
            if self.graph is None:
                self._capture()
            for _ in range(d):
                self.graph.replay()
            for name, n in self.step_launches.items():
                cuda_lib.LAUNCHES[name] += n * d
        else:
            with torch.no_grad():
                for _ in range(d):
                    step(self.spec, c)
        return IvmState(active_idx=c["idx"].clone(), active_mask=c["mask"].clone(),
                        m_site=c["m_site"].clone(), beta_site=c["beta_site"].clone(),
                        mu=c["mu"].clone(), varsigma=c["vs"].clone(),
                        nu=c["nu"].clone(), g=c["g"].clone())


def select_points(spec: IvmSpec, kern_params, noise_params, X, y, rand_vals) -> IvmState:
    """Greedy active-set selection (CIvm::selectPoints) on X's device.

    `rand_vals` is a (d,) array of U[0,1) draws, one slot per step; step k
    reads rand_vals[k] only on a random pick (RANDOM always, RENTROPY at k
    = 0), as the reference draws from its MT19937 then (CIvm.cpp:402-411),
    so slots filled from utils.refrng.RefRng reproduce its order."""
    return Selector(spec, X, y).run(kern_params, noise_params, rand_vals)


def replay(spec: IvmSpec, kern_params, noise_params, X, y, order):
    """A check of a pass computed elsewhere (the card's float32 pass, on
    this route in float64): the state after adding the points of `order` in
    turn, and at each step the gap between the largest entropy score and
    the score of the point that `order` adds, relative to the largest (0
    where it is the maximum)."""
    sel = Selector(spec, X, y)
    sel.reset(kern_params, noise_params, np.zeros(spec.num_active))
    gaps = []
    with torch.no_grad():
        for i in np.asarray(order, dtype=np.int64):
            delta = entropy_scores(spec, sel.c)
            top = delta.max()
            gaps.append(float((top - delta[int(i)]) / torch.abs(top)))
            add_point(spec, sel.c, torch.tensor([int(i)], device=X.device))
    c = sel.c
    return IvmState(active_idx=c["idx"], active_mask=c["mask"], m_site=c["m_site"],
                    beta_site=c["beta_site"], mu=c["mu"], varsigma=c["vs"], nu=c["nu"],
                    g=c["g"]), np.array(gaps)


def select_point_remove(spec: IvmSpec, state: IvmState, r=None):
    """An active point to remove (CIvm::selectPointRemove, CIvm.cpp:432-489):
    the removal entropy change per active slot k holding data index i,
        Δₖ = −½ Σ_j log(1 − ς_ij·β_kj + 1e-300)
    (spherical noise: j = 0, times D); entropy/rentropy take argmax Δ,
    random the slot ⌊r·d⌋ of the caller's U[0,1) draw r.  The reference's
    version is dead code with two indexing bugs (CIvm.cpp:459, 478); this is
    the documented intent, as in gpc_tpu.  Returns (slot, data index, Δ)."""
    d = spec.num_active
    vs_active = state.varsigma[state.active_idx]
    if spec.noise.spherical:
        delta = -0.5 * torch.log(
            1.0 - vs_active[:, 0] * state.beta_site[:, 0] + 1e-300) * spec.output_dim
    else:
        delta = torch.sum(-0.5 * torch.log(1.0 - vs_active * state.beta_site + 1e-300), dim=1)
    if spec.selection == RANDOM:
        if r is None:
            raise ValueError("random removal needs a U[0,1) draw")
        slot = torch.clamp(torch.floor(torch.as_tensor(r, dtype=delta.dtype) * d),
                           max=d - 1).to(torch.int64)
    else:
        slot = torch.argmax(delta)
    return slot, state.active_idx[slot], delta[slot]


def active_log_likelihood(spec: IvmSpec, kern_params, X_active, m_site, beta_site):
    """Active-set marginal likelihood (CIvm::logLikelihood, CIvm.cpp:521-540)."""
    kp = kern_params
    K = spec.kern.gram(kp, X_active)
    L = torch.zeros((), dtype=K.dtype, device=K.device)
    for j in range(1 if spec.noise.spherical else spec.output_dim):
        Lc, _ = linalg.jitchol(K + torch.diag(1.0 / beta_site[:, j]))
        logdet = linalg.chol_logdet(Lc)
        if spec.noise.spherical:
            quad = linalg.quad_form(Lc, m_site)          # all columns share K+B⁻¹
            L = L - 0.5 * (spec.output_dim * logdet + quad)
        else:
            quad = linalg.quad_form(Lc, m_site[:, j:j + 1])
            L = L - 0.5 * (logdet + quad)
    return L + priors_mod.total_log_prob(spec.kern.priors_global, kp)


def posterior(spec: IvmSpec, kern_params, X_active, m_site, beta_site, Xtest):
    """Predictive moments from the active set (CIvm::posteriorMeanVar,
    CIvm.cpp:126-163): (mu, varsigma), each (T, D)."""
    kp = kern_params
    K = spec.kern.gram(kp, X_active)
    kX = spec.kern.compute(kp, X_active, Xtest)      # (d, T)
    kdiag = spec.kern.diag(kp, Xtest)
    mus, vss = [], []
    for j in range(1 if spec.noise.spherical else spec.output_dim):
        Lc, _ = linalg.jitchol(K + torch.diag(1.0 / beta_site[:, j]))
        v = linalg.tri_solve(Lc, kX)
        vs = torch.clamp(kdiag - torch.sum(v * v, dim=0), min=0.0)
        # Kb⁻¹kX = Lc⁻ᵀv reuses the variance solve
        w = linalg.tri_solve(Lc, v, trans=True)
        if spec.noise.spherical:
            return w.T @ m_site, vs[:, None].repeat(1, spec.output_dim)
        mus.append(w.T @ m_site[:, j])
        vss.append(vs)
    return torch.stack(mus, dim=1), torch.stack(vss, dim=1)


def restored_state(model, active, m_site, beta_site) -> IvmState:
    """The state of a stored model (CIvm::readParamsFromStream): the active
    set and its sites on the model's device; the per-point moments, which a
    file does not hold, are zeros."""
    N, D = model.spec.n_data, model.spec.output_dim
    zeros = torch.zeros((N, D), dtype=model.Xd.dtype, device=model.device)
    idx = torch.as_tensor(np.asarray(active, dtype=np.int64), device=model.device)
    mask = torch.zeros(N, dtype=torch.bool, device=model.device)
    mask[idx] = True
    return IvmState(active_idx=idx, active_mask=mask, m_site=model._t(m_site),
                    beta_site=model._t(beta_site), mu=zeros, varsigma=zeros.clone(),
                    nu=zeros.clone(), g=zeros.clone())


# ---------------------------------------------------------------------------

class IVM:
    """CIvm-equivalent model: data, parameters (float64 numpy, as gpc_tpu
    keeps them) and the active set.  The data move to `device` once in its
    working dtype (float32 on CUDA, float64 on the CPU); `device=None`
    means the card and raises without one."""

    def __init__(self, kern: Kern, noise: Noise, X, y, num_active: int,
                 selection: str = ENTROPY, seed: Optional[int] = None,
                 kern_params=None, noise_params=None, device=None):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.X, self.y = X, y
        N, q = X.shape
        if num_active > N:
            raise ValueError("Number of active points has to be less than number of data.")
        self.spec = IvmSpec(kern=kern, noise=noise, n_data=N, input_dim=q,
                            output_dim=y.shape[1], num_active=num_active,
                            selection=selection)
        self.kern_params = np.array(kern_params if kern_params is not None
                                    else kern.default_params(), dtype=np.float64)
        self.noise_params = np.array(noise_params if noise_params is not None
                                     else noise.default_params(y), dtype=np.float64)
        # the reference draws random/rentropy picks from ONE MT19937 seeded
        # by the CLI's -s (CIvm.cpp:402-411)
        self.ref_rng = RefRng(seed if seed is not None else 0)
        self.device = resolve_device(device)
        self.Xd = as_tensor(X, self.device)
        self.yd = as_tensor(y, self.device)
        self.state: Optional[IvmState] = None
        self._selector: Optional[Selector] = None
        self._order = None      # (state, its order on the host), see active_order

    def _t(self, a):
        return as_tensor(np.asarray(a, dtype=np.float64), self.device)

    def init_and_select(self) -> IvmState:
        """A selection pass, drawing exactly the uniforms the reference
        consumes: d for random, one (step 0) for rentropy, none for entropy.
        Span `gpc.ivm.select`, closed by the pass's read of its order."""
        d = self.spec.num_active
        with span("gpc.ivm.select"):
            rv = np.zeros(d)
            if self.spec.selection == RANDOM:
                rv[:] = [self.ref_rng.rand() for _ in range(d)]
            elif self.spec.selection == RENTROPY:
                rv[0] = self.ref_rng.rand()
            if self._selector is None:
                self._selector = Selector(self.spec, self.Xd, self.yd)
            self.state = self._selector.run(self.kern_params, self.noise_params, rv)
            COUNTS["ivm.steps"] += d
            with host_read("ivm_order"):
                self._order = (self.state, self.state.active_idx.cpu().numpy())
        return self.state

    def active_order(self) -> np.ndarray:
        """The active set's data indices on the host: the read that closed
        the pass, or one read of a state set otherwise (a model file's)."""
        if self._order is None or self._order[0] is not self.state:
            self._order = (self.state, self.state.active_idx.cpu().numpy())
        return self._order[1]

    def active_X(self) -> np.ndarray:
        return self.X[self.active_order()]

    def log_likelihood(self) -> float:
        st = self.state
        return float(active_log_likelihood(self.spec, self._t(self.kern_params),
                                           self._t(self.active_X()), st.m_site,
                                           st.beta_site))

    def _kern_vag(self, Xa, m_site, beta_site):
        """−active_log_likelihood over the unconstrained kernel parameters."""
        codes = self.spec.kern.transform_codes()
        return numpy_value_and_grad(lambda a: -active_log_likelihood(
            self.spec, tr.apply_atox(codes, a), Xa, m_site, beta_site), self.device)

    def _noise_vag(self, mu, varsigma):
        """−noise.log_likelihood over the unconstrained noise parameters."""
        ncodes = self.spec.noise.transform_codes()
        return numpy_value_and_grad(lambda a: -self.spec.noise.log_likelihood(
            tr.apply_atox(ncodes, a), mu, varsigma, self.yd), self.device)

    def optimise(self, ext_iters: int = 15, kern_iters: int = 100,
                 noise_iters: int = 100, verbose: int = 0,
                 ckpt_path: str = None, resume: bool = False):
        """Alternating reselect/SCG rounds (CIvm::optimise, CIvm.cpp:685-736).
        At verbose > 2 with < 40 kernel parameters a finite-difference
        gradient check runs before each kernel round.  ckpt_path writes a
        checkpoint at each phase boundary (kernel θ, noise θ, the MT19937
        state, the phase) in gpc_tpu's keys; resume=True replays the
        remaining trajectory from it.  Returns the rounds it ran, in order,
        as (kind, ScgResult), kind "kern" or "noise"; each round is a span
        `gpc.ivm.kern_round` or `gpc.ivm.noise_round`."""
        codes = self.spec.kern.transform_codes()
        ncodes = self.spec.noise.transform_codes()
        start_phase = 0
        if resume and ckpt_path and os.path.exists(ckpt_path):
            step_, kp, extra, _ = ckpt_mod.load(ckpt_path)
            self.kern_params = np.asarray(kp, dtype=np.float64)
            self.noise_params = np.asarray(extra["noise_params"], dtype=np.float64)
            self.ref_rng.set_state(extra["rng_mt"], int(extra["rng_mti"]),
                                   float(extra["rng_stored"]))
            start_phase = step_

        def save(phase):
            if not ckpt_path:
                return
            mt, mti, stored = self.ref_rng.get_state()
            ckpt_mod.save(ckpt_path, phase, self.kern_params,
                          extra=dict(noise_params=self.noise_params, rng_mt=mt,
                                     rng_mti=np.asarray(mti), rng_stored=np.asarray(stored)))

        def to_x(cds, a):
            return tr.apply_atox(cds, torch.as_tensor(np.asarray(a, dtype=np.float64))).numpy()

        def to_a(cds, x):
            return tr.apply_xtoa(cds, torch.as_tensor(x)).numpy()

        rounds = []
        phase = 0
        for _ in range(max(ext_iters, 0)):
            if phase >= start_phase and kern_iters > 0:
                st = self.init_and_select()
                with span("gpc.ivm.kern_round"):
                    vag = self._kern_vag(self._t(self.active_X()), st.m_site, st.beta_site)
                    a0 = to_a(codes, self.kern_params)
                    if verbose > 2 and a0.size < 40:
                        check_gradients(vag, a0)
                    res = scg(vag, a0, max_iters=kern_iters)
                self.kern_params = to_x(codes, res.x)
                rounds.append(("kern", res))
                save(phase + 1)
            phase += 1
            if phase >= start_phase and noise_iters > 0:
                st = self.init_and_select()
                with span("gpc.ivm.noise_round"):
                    vag = self._noise_vag(st.mu, st.varsigma)
                    res = scg(vag, to_a(ncodes, self.noise_params), max_iters=noise_iters)
                self.noise_params = to_x(ncodes, res.x)
                rounds.append(("noise", res))
                save(phase + 1)
            phase += 1
        self.init_and_select()
        return rounds

    def predict(self, Xtest):
        """(mu, varsigma) as numpy arrays, each (T, D)."""
        st = self.state
        mu, vs = posterior(self.spec, self._t(self.kern_params), self._t(self.active_X()),
                           st.m_site, st.beta_site, self._t(Xtest))
        return mu.cpu().numpy(), vs.cpu().numpy()

    def out(self, Xtest):
        """Predicted outputs through the noise model (CIvm::out), numpy."""
        mu, vs = self.predict(Xtest)
        return self.noise_apply("out", mu, vs)

    def noise_apply(self, method: str, *arrays):
        """A noise-model method at the current noise parameters on numpy
        arrays, computed on the model's device; numpy out."""
        out = getattr(self.spec.noise, method)(self._t(self.noise_params),
                                               *(self._t(a) for a in arrays))
        return out.detach().cpu().numpy()

    def display(self):
        lines = ["IVM Model:",
                 f"  Active set size: {self.spec.num_active}",
                 f"  Data size: {self.spec.n_data}",
                 f"  Selection criterion: {self.spec.selection}"]
        for name, val in zip(self.spec.kern.display_names(), self.kern_params):
            lines.append(f"  {name}: {val}")
        for i, val in enumerate(self.noise_params):
            lines.append(f"  noise param {i}: {val}")
        return "\n".join(lines)
