"""The IVM's greedy active-set selection with the data rows sharded
(counterpart of gpc_tpu/parallel/dist_ivm.py).

Every O(N) quantity (the X / y rows, the ADF moments μ, ς, ν, g, the
(C, d, N) store M, the active mask) is row-sharded; the O(d) site state
(m̃, β̃ and the order) is replicated.  One step, two collectives:

  1. all_gather of each rank's (max entropy score, its global index, its
     count of inactive points);
  2. the pick: entropy takes the first rank holding the largest score and
     that rank's first maximum, which is torch.argmax over all rows; a
     random pick finds the rank whose inactive points hold rank ⌊r·n⌋ of
     the globally index-ordered inactive list (CIvm.cpp:405-407);
  3. one all_reduce of one buffer, written by the owning rank and zero
     elsewhere: the index and the picked row's x, y, μ, ς, ν, g and M
     column (gpc_tpu's seven owner-masked psums, packed);
  4. the site update, the kernel column of this rank's rows (a K1/K4
     launch), the rank-1 updates of M, ς, μ and the refresh of ν, g, all
     local, in the single-process order (models/ivm.add_point), the
     picked row's own ς in add_point's form ς/(1 + ς·β̃).

The scores are models/ivm.entropy_scores', so the order can equal the
single-process order bit for bit.  The step runs eagerly: the collectives
do not capture in the single process's CUDA graph.  The index travels in the
float buffer, exact below 2^24 rows in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from gpc_tpu_torch.models.ivm import (RANDOM, RENTROPY, IvmSpec, IvmState,
                                      entropy_scores)
from gpc_tpu_torch.parallel.mesh import Mesh, all_reduce_sum, gather_rows


def make_select_points_dist(spec: IvmSpec, mesh: Mesh):
    """select(kern_params, noise_params, X, y, valid, rand_vals) → IvmState:
    X / y / valid this rank's row blocks on the mesh's device (pad with
    valid = 0 rows so the rows split evenly; padding rows are never
    picked), rand_vals the (d,) U[0,1) draws of models/ivm.select_points.
    The order and the sites come back replicated, the moments and the
    active mask as this rank's rows."""
    D, d, C = spec.output_dim, spec.num_active, spec.n_struct
    kern, noise = spec.kern, spec.noise

    @torch.no_grad()
    def select(kern_params, noise_params, X_l, y_l, valid_l, rand_vals):
        dev, dt = X_l.device, X_l.dtype
        if dt == torch.float32 and X_l.shape[0] * mesh.size >= 1 << 24:
            raise ValueError("make_select_points_dist: 2^24 rows or more in float32")
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)   # noqa: E731
        kp, np_, rand = as_t(kern_params), as_t(noise_params), as_t(rand_vals)
        B = X_l.shape[0]
        offset = mesh.rank * B
        valid = valid_l > 0
        cmap = (torch.zeros(D, dtype=torch.int64, device=dev) if C == 1
                else torch.arange(D, device=dev))
        white = kern.white(kp)
        mu = torch.zeros((B, D), dtype=dt, device=dev)
        vs = kern.diag(kp, X_l)[:, None].expand(B, D).clone()
        nu, g = noise.nu_g(np_, mu, vs, y_l)
        M = torch.zeros((C, d, B), dtype=dt, device=dev)
        m_site = torch.zeros((d, D), dtype=dt, device=dev)
        beta_site = torch.zeros((d, D), dtype=dt, device=dev)
        mask = torch.zeros(B, dtype=torch.bool, device=dev)
        idx = torch.zeros(d, dtype=torch.int64, device=dev)
        widths = [1, X_l.shape[1], D, D, D, D, D, C * d]

        for k in range(d):
            dead = mask | ~valid
            delta = entropy_scores(spec, dict(vs=vs, nu=nu, mask=dead))
            loc_arg = torch.argmax(delta)
            stats = gather_rows(mesh, torch.stack([
                delta[loc_arg], (loc_arg + offset).to(dt), torch.sum(~dead).to(dt)])[None, :])
            if spec.selection == RANDOM or (spec.selection == RENTROPY and k == 0):
                counts = stats[:, 2].to(torch.int64)
                n_inactive = torch.sum(counts)
                target = torch.minimum(torch.floor(rand[k] * n_inactive),
                                       n_inactive - 1).to(torch.int64)
                before = torch.cumsum(counts, 0) - counts     # inactive points on lower ranks
                owner = torch.sum(before <= target) - 1
                rank_l = torch.cumsum(~dead, dim=0) - 1 + before[mesh.rank]
                li = torch.argmax(((rank_l == target) & ~dead).to(torch.uint8))
            else:
                owner = torch.argmax(stats[:, 0])
                li = stats[owner, 1].to(torch.int64) - offset
            own = owner == mesh.rank
            li = torch.clamp(li, 0, B - 1)
            row = torch.cat([(li + offset).to(dt)[None], X_l[li], y_l[li], mu[li], vs[li],
                             nu[li], g[li], M[:, :, li].reshape(-1)])
            row = all_reduce_sum(mesh, torch.where(own, row, torch.zeros_like(row)))
            index_f, x_i, y_i, mu_i, vs_i, nu_i, g_i, a = torch.split(row, widths)
            index = index_f.to(torch.int64)

            m_i, beta_i = noise.update_sites(np_, mu_i[None], vs_i[None], y_i[None],
                                             nu_i[None], g_i[None])
            beta_own = beta_i
            if not noise.log_concave:
                beta_i = torch.where(beta_i < 0, 1e-6, beta_i)
            mine = own & (torch.arange(B, device=dev) == li)
            k_col = kern.compute(kp, X_l, x_i[None, :])[:, 0] + white * mine
            a = a.reshape(C, d)
            s = k_col[None, :] - torch.einsum("cdn,cd->cn", M, a)
            sqrt_nu = torch.sqrt(nu_i.index_select(0, cmap[:C]))
            M[:, k, :] = s * sqrt_nu[:, None]
            s_out = s.index_select(0, cmap).T
            vs = vs - (s_out ** 2) * nu_i.index_select(0, cmap)[None, :]
            own_vs = vs_i / (1.0 + vs_i * beta_own[0].index_select(0, cmap))
            vs = torch.where(mine[:, None], own_vs[None, :], vs)
            mu = mu + g_i[None, :] * s_out
            mask = mask | mine
            idx[k] = index[0]
            m_site[k] = m_i[0]
            beta_site[k] = beta_i[0]
            nu, g = noise.nu_g(np_, mu, vs, y_l)
        return IvmState(active_idx=idx, active_mask=mask, m_site=m_site, beta_site=beta_site,
                        mu=mu, varsigma=vs, nu=nu, g=g)

    return select


def dryrun(mesh: Mesh, n_devices: int) -> None:
    """The distributed IVM selection on tiny shapes (N = 8 a rank, d = 12,
    probit noise, entropy) against the single process's on `mesh`: the same
    order, and the sites within float32 reduction noise.  Raises on a
    mismatch."""
    from gpc_tpu_torch import as_tensor
    from gpc_tpu_torch import kernels as K
    from gpc_tpu_torch.models.ivm import ENTROPY, select_points
    from gpc_tpu_torch.noise import ProbitNoise
    from gpc_tpu_torch.parallel.mesh import shard_rows

    N, q, d = 8 * n_devices, 2, 12
    rng = np.random.default_rng(7)
    X = rng.standard_normal((N, q))
    y = np.sign(rng.standard_normal((N, 1)))
    kern = K.Cmpnd(input_dim=q, components=(
        K.Rbf(input_dim=q), K.Bias(input_dim=q), K.White(input_dim=q)))
    noise = ProbitNoise(output_dim=1)
    spec = IvmSpec(kern=kern, noise=noise, n_data=N, input_dim=q, output_dim=1,
                   num_active=d, selection=ENTROPY)
    kp, npar, rv = kern.default_params(), noise.default_params(y), np.zeros(d)
    st = make_select_points_dist(spec, mesh)(
        kp, npar, shard_rows(mesh, X), shard_rows(mesh, y), shard_rows(mesh, np.ones(N)), rv)
    dev = mesh.device
    ref = select_points(spec, as_tensor(kp, dev), as_tensor(npar, dev), as_tensor(X, dev),
                        as_tensor(y, dev), as_tensor(rv, dev))
    got, want = st.active_idx.cpu().numpy(), ref.active_idx.cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"dist_ivm dryrun: order {got}, single process {want}")
    np.testing.assert_allclose(st.m_site.cpu().numpy(), ref.m_site.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    if mesh.rank == 0:
        print(f"dryrun_multichip({n_devices}): OK — distributed IVM selection "
              f"order ≡ single-chip ({d} points over {N} rows)")
