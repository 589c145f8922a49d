"""K7: the whole rbf evidence in one persistent launch (a Hopper probe).

Replaces tools/chol_mega_v2.py::evidence_mega_rbf, the superseded TPU
whole-evidence program: (logdet K, Σ_d m_dᵀK⁻¹m_d) for K = rbf-Gram(X) +
noise·I with gpc_tpu's v2 bf16 policy (design, modes and bounds in
csrc/chol_mega.cu: a dataflow grid, block 0 running the leaf chain on
leaf128 and the other blocks walking `mega_plan`'s list of tile
corrections on wgmma fed by TMA).  No model path reaches it; it measures one
cooperative launch against K3's host loop of per-panel launches
(ops/chol_panel.panel_state_rbf) on the same inputs:

    python -m gpc_tpu_torch.probes.chol_mega [--n 16384] [--q 8] [--reps 3]

prints the card, the evidence against the dense f32 one, ms for each mode
and for K3, and one traced call's span, leaf chain and mean leaf
(`trace_summary`).  Needs CUDA.

The rbf is gpc_tpu's pre-scaled form: Xs = X·√(γ/2), K_rc = var·exp(−max(
‖xs_r‖² + ‖xs_c‖² − 2 xs_r·xs_c, 0)).  N must be a multiple of b with
nb = N/b ≥ 3 (chol_mega_v2.py:209); the kernel takes b = 128, the leaf width.
"""

from __future__ import annotations

import argparse
import functools
import heapq
import math

import numpy as np
import torch

from gpc_tpu_torch.ops import cuda_lib
from gpc_tpu_torch.ops.chol_panel import LEAF
from gpc_tpu_torch.probes import bf16 as _bf16

MODES = ("full", "noleaf", "nodot", "nodma", "nogram")

# mega_plan's items: (kind, i, j, k0, k1); a leaf is (LEAF_ITEM, j, j, 0, 0)
LEAF_ITEM, RANGE_ITEM = 0, 1
RANGE_COLS = 16   # columns of a tile's correction a range item covers
# The schedule model that orders the list, in µs on one block of the H100
# (PERF.md: a leaf128 leaf ≈ 37-40 µs; a 128-column of a wgmma correction,
# 4.2 MFLOP and 64 KB of operands, ≈ 1-2 µs): a leaf, a tile's epilogue, a
# column of correction and an item's own cost (ticket, waits, running sum).
_MODEL_LEAF, _MODEL_EPILOGUE, _MODEL_COLUMN, _MODEL_ITEM = 40.0, 8.0, 1.5, 2.0


def _check(X, m, b, mode):
    N = X.shape[0]
    if mode not in MODES:
        raise ValueError(f"evidence_mega_rbf: mode {mode!r} (want one of {MODES})")
    if b % LEAF or N % b or N // b < 3 or m.shape[0] != N:
        raise ValueError(f"evidence_mega_rbf: want N = nb·b with b a multiple of {LEAF} "
                         f"and nb >= 3 (got X {tuple(X.shape)}, m {tuple(m.shape)}, b={b})")


def _scaled(X, inv_width):
    Xs = (X.float() * math.sqrt(0.5 * float(inv_width))).contiguous()
    return Xs, (Xs * Xs).sum(dim=1)


def mega_ranges(j: int):
    """The [k0, k1) column ranges of tile (i, j)'s correction: RANGE_COLS
    wide from 0, the last one the rest; [(0, 0)] for j = 0 (no
    correction, the epilogue alone)."""
    if j == 0:
        return [(0, 0)]
    cut = list(range(0, j, RANGE_COLS)) + [j]
    return list(zip(cut[:-1], cut[1:]))


def mega_deps(items):
    """What each item of a list waits for, as indices into it (the kernel's
    waits): a range (i, j, k0, k1) on the last items of tiles (i, k1 − 1) and
    (j, k1 − 1) and on the range of (i, j) that ends at k0; a last range
    (k1 = j) also on leaf j; leaf j on the last item of tile (j, j − 1)."""
    pos = {}
    for x, (kind, i, j, k0, k1) in enumerate(items):
        pos[("leaf", j) if kind == LEAF_ITEM else ("end", i, j, k1)] = x
    last = lambda i, j: pos[("end", i, j, j)]   # noqa: E731
    deps = []
    for kind, i, j, k0, k1 in items:
        if kind == LEAF_ITEM:
            deps.append([last(j, j - 1)] if j else [])
            continue
        d = [last(i, k1 - 1), last(j, k1 - 1)] if k1 else []
        if k0:
            d.append(pos[("end", i, j, k0)])
        if k1 == j:
            d.append(pos[("leaf", j)])
        deps.append(d)
    return deps


@functools.lru_cache(maxsize=8)
def mega_plan(nb: int, grid: int) -> np.ndarray:
    """K7's work list for nb columns on `grid` co-resident blocks: (n, 5)
    int32 rows (kind, i, j, k0, k1), every leaf and every range of every
    tile's correction (`mega_ranges`) once, each after all it waits for
    (`mega_deps`).  Block 0 runs the leaves in order; the other grid − 1
    blocks take the ranges in list order by an atomic ticket.  The order is
    a list schedule of that machine under a time model (_MODEL_*): the
    earliest free block takes, of the items whose waits are over, the one
    of the lowest column j, then row i, then k0 — so tile (j+1, j) goes
    first in its column and a correction runs as soon as the columns it
    covers are done, leaving its tile's last range alone for the column's
    turn.  A last range counts as ready when it would end as its leaf
    does.  Read-only; cached."""
    if nb < 3 or grid < 2:
        raise ValueError(f"mega_plan: want nb >= 3 columns and two blocks; got nb = {nb}, "
                         f"grid = {grid}")
    items = [(RANGE_ITEM, i, j, k0, k1) for j in range(nb) for i in range(j + 1, nb)
             for k0, k1 in mega_ranges(j)] + [(LEAF_ITEM, j, j, 0, 0) for j in range(nb)]
    deps = mega_deps(items)
    users = [[] for _ in items]
    for x, d in enumerate(deps):
        for y in d:
            users[y].append(x)
    missing = [len(d) for d in deps]
    start, done = [0.0] * len(items), [0.0] * len(items)
    leaf_id = {j: x for x, (kind, _, j, _, _) in enumerate(items) if kind == LEAF_ITEM}
    pending, ready = [], []   # (ready time, x), ((j, i, k0), x)
    leaf_free = 0.0

    def cost(x):
        return _MODEL_ITEM + _MODEL_COLUMN * (items[x][4] - items[x][3])

    def release(x):
        nonlocal leaf_free
        kind, _, j, _, k1 = items[x]
        if kind == LEAF_ITEM:
            start[x] = max([leaf_free] + [done[y] for y in deps[x]])
            done[x] = leaf_free = start[x] + _MODEL_LEAF
            for u in users[x]:
                wake(u)
            return
        t = max([done[y] for y in deps[x] if items[y][0] != LEAF_ITEM], default=0.0)
        if k1 == j:
            t = max(t, done[leaf_id[j]] - cost(x))
        heapq.heappush(pending, (t, x))

    def wake(x):
        missing[x] -= 1
        if missing[x] == 0:
            release(x)

    for x in range(len(items)):
        if missing[x] == 0:
            release(x)
    blocks = [0.0] * (grid - 1)
    left = len(items) - nb
    while left:
        t = heapq.heappop(blocks)
        while pending and pending[0][0] <= t:
            x = heapq.heappop(pending)[1]
            heapq.heappush(ready, ((items[x][2], items[x][1], items[x][3]), x))
        if not ready:
            heapq.heappush(blocks, pending[0][0])
            continue
        x = heapq.heappop(ready)[1]
        _, _, j, _, k1 = items[x]
        start[x] = t
        done[x] = t + cost(x)
        if k1 == j:
            done[x] = max(done[x], done[leaf_id[j]]) + _MODEL_EPILOGUE
        left -= 1
        heapq.heappush(blocks, done[x])
        for u in users[x]:
            wake(u)
    order = sorted(range(len(items)), key=lambda x: (start[x], x))
    plan = np.array([items[x] for x in order], dtype=np.int32)
    plan.setflags(write=False)
    return plan


def evidence_mega_rbf_plain(X, m, inv_width, variance, noise, b: int = LEAF,
                            mode: str = "full"):
    """The plain version, float32 with the kernel's bf16 policy emulated
    (bf16-rounded GEMM inputs, float32 products and sums, as
    ops/evidence_fast._mmp): column by column, the diagonal block and w_j
    corrected by the bf16 factor, the leaf (Cholesky and its triangular
    inverse; the stand-in under "noleaf"), v_j = M_jj w_j in float32, and
    the rows below as L_ij = bf16(bf16(A_ij) bf16(M_jj)ᵀ).  Returns float32
    (logdet, quad)."""
    _check(X, m, b, mode)
    N = X.shape[0]
    nb = N // b
    Xs, n2 = _scaled(X, inv_width)
    var, nz = float(variance), float(noise)
    m32 = m.float()

    def gram(r0, r1, c0, c1):
        d2 = torch.clamp(n2[r0:r1, None] + n2[None, c0:c1] - 2.0 * (Xs[r0:r1] @ Xs[c0:c1].T),
                         min=0.0)
        return var * d2 if mode == "nogram" else var * torch.exp(-d2)

    L = torch.zeros((N, N), dtype=torch.float32, device=X.device)   # bf16 values
    v = torch.zeros_like(m32)
    eye = torch.eye(b, dtype=torch.float32, device=X.device)
    ld = torch.zeros((), dtype=torch.float64, device=X.device)
    for j in range(nb):
        jb, je = j * b, (j + 1) * b
        A = gram(jb, je, jb, je) + nz * eye
        w = m32[jb:je]
        Lj = L[jb:je, :jb]
        if j:
            A = A - Lj @ Lj.T
            w = w - Lj @ _bf16(v[:jb])
        if mode == "noleaf":
            dcol = A.abs().amax(dim=1) + 1.0
            M = torch.diag(1.0 / dcol)
            ld = ld + 2.0 * torch.log(dcol.double()).sum()
        else:
            Lc = torch.linalg.cholesky_ex(A)[0]
            M = torch.linalg.solve_triangular(Lc, eye, upper=False)
            ld = ld + 2.0 * torch.log(torch.diagonal(Lc).double()).sum()
        v[jb:je] = M @ w
        if je < N:
            R = gram(je, N, jb, je)
            if j and mode != "nodot":
                src = Lj.repeat(nb - 1 - j, 1) if mode == "nodma" else L[je:, :jb]
                R = R - src @ Lj.T
            L[je:, jb:je] = _bf16(_bf16(R) @ _bf16(M).T)
    return ld.float(), (v.double() ** 2).sum().float()


def _row_items(nb: int, grid: int, dev) -> torch.Tensor:
    """mega_plan's ranges as the kernel reads them, (n, 4) int32 (i, j, k0,
    k1) on the card, uploaded once per (nb, grid, device)."""
    key = (nb, grid, str(dev))
    if key not in _ROW_ITEMS:
        plan = mega_plan(nb, grid)
        rows = np.ascontiguousarray(plan[plan[:, 0] == RANGE_ITEM, 1:])
        _ROW_ITEMS[key] = torch.from_numpy(rows).to(dev)
    return _ROW_ITEMS[key]


_ROW_ITEMS: dict = {}


def evidence_mega_rbf(X, m, inv_width, variance, noise, b: int = LEAF,
                      mode: str = "full", *, _trace=None):
    """K7: (logdet, quad) as 0-dim float32 tensors.  CPU: the plain version.
    CUDA: X (N, q) and m (N, D) float32, b = 128, ONE cooperative launch
    (csrc/chol_mega.cu) that walks mega_plan(nb, grid); the packed Lᵀ slots
    (nb(nb+1)/2 of b×b bf16, 270 MB at N = 16384) and the tiles' float32
    running sums (541 MB) are scratch.  `_trace`, an int64 tensor of
    (row items + nb, 4) on the card, receives %globaltimer stamps (ns):
    per row item (list order) taken, waits over (a last item: leaf j seen),
    correction summed, done; per leaf its wait, start, factor done,
    released (`trace_summary` reads them)."""
    _check(X, m, b, mode)
    if X.device.type == "cpu":
        return evidence_mega_rbf_plain(X, m, inv_width, variance, noise, b, mode)
    cuda_lib.require_cuda("evidence_mega_rbf", X, m)
    if b != LEAF:
        raise ValueError(f"evidence_mega_rbf: the kernel takes b = {LEAF} (got {b})")
    N, q = X.shape
    D = m.shape[1]
    nb = N // b
    grid = cuda_lib.library().gpc_mega_grid()
    if grid < 2:
        raise RuntimeError("evidence_mega_rbf: fewer than two blocks are co-resident")
    dev = X.device
    items = _row_items(nb, grid, dev)
    Xs, n2 = _scaled(X, inv_width)
    slots = nb * (nb + 1) // 2
    T = torch.empty((slots, b, b), dtype=torch.bfloat16, device=dev)
    part = torch.empty((slots, b, b), dtype=torch.float32, device=dev)
    Dbuf = torch.empty((nb, b, b), dtype=torch.float32, device=dev)
    w = torch.empty((N, D), dtype=torch.float32, device=dev)
    Mb = torch.empty((nb, b, b), dtype=torch.bfloat16, device=dev)
    Mf = torch.empty((b, b), dtype=torch.float32, device=dev)
    scratch = torch.empty((grid, b, b), dtype=torch.bfloat16, device=dev)
    sync = torch.zeros(3 + nb + slots, dtype=torch.int32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    cuda_lib.launch("evidence_mega_rbf", "gpc_evidence_mega", Xs.data_ptr(),
                    n2.data_ptr(), m.data_ptr(), float(variance), float(noise), N, q,
                    D, MODES.index(mode), grid, items.data_ptr(), items.shape[0],
                    T.data_ptr(), part.data_ptr(), Dbuf.data_ptr(), w.data_ptr(),
                    Mb.data_ptr(), Mf.data_ptr(), scratch.data_ptr(), sync.data_ptr(),
                    out.data_ptr(), 0 if _trace is None else _trace.data_ptr(),
                    cuda_lib.stream_of(X))
    return out[0], out[1]


def trace_summary(X, m, inv_width, variance, noise, mode: str = "full") -> dict:
    """One traced call of K7 (`_trace`) read back as µs: the call's span
    from the first stamp to the last, the leaf chain (Σ over leaves of
    wait over → released, the leaf block's own time), the mean leaf128
    (start → factor done), and for tile (j+1, j), whose epilogue sits
    between leaf j and leaf j+1, the mean time from leaf j released to
    leaf j+1 started."""
    nb = X.shape[0] // LEAF
    grid = cuda_lib.library().gpc_mega_grid()
    n_rows = int((mega_plan(nb, grid)[:, 0] == RANGE_ITEM).sum())
    tr = torch.zeros((n_rows + nb, 4), dtype=torch.int64, device=X.device)
    evidence_mega_rbf(X, m, inv_width, variance, noise, mode=mode, _trace=tr)
    t = tr.cpu().numpy().astype(np.float64)
    t = (t - t[t > 0].min()) / 1e3
    L = t[n_rows:]
    return dict(span_us=float(t.max()), chain_us=float((L[:, 3] - L[:, 1]).sum()),
                leaf128_us=float((L[:, 2] - L[:, 1]).mean()),
                between_leaves_us=float((L[1:, 1] - L[:-1, 3]).mean()))


def probe_args(n: int, q: int, dev):
    """The panel phase's inputs (chip_smoke.panel_args): X ~ N(0, 1)^(n×q),
    m and a column of ones, from numpy's default_rng(0); γ = var = 1,
    noise 0.1."""
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.standard_normal((n, q)), dtype=torch.float32, device=dev)
    m = torch.tensor(rng.standard_normal((n, 1)), dtype=torch.float32, device=dev)
    return X, torch.cat([m, torch.ones_like(m)], dim=1).contiguous(), 1.0, 1.0, 0.1


def main(argv=None):
    from gpc_tpu_torch.ops.chol_panel import panel_state_rbf, panel_state_rbf_plain
    from gpc_tpu_torch.probes import cuda_ms, require_card
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--q", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    print(require_card(), flush=True)
    args = probe_args(a.n, a.q, torch.device("cuda"))
    ld_p, G_p, _, _ = panel_state_rbf_plain(*args)
    quad_p = float(torch.trace(G_p))
    ld, quad = evidence_mega_rbf(*args)
    print(f"K7 N={a.n} q={a.q}: logdet {float(ld)} quad {float(quad)}; dense f32 "
          f"{float(ld_p)} {quad_p} (rel {abs(float(ld) - float(ld_p)) / abs(float(ld_p))}, "
          f"{abs(float(quad) - quad_p) / abs(quad_p)})", flush=True)
    for mode in MODES:
        ms = cuda_ms(lambda: evidence_mega_rbf(*args, mode=mode), a.reps)
        print(f"K7 mode {mode}: {ms} ms", flush=True)
    ms = cuda_ms(lambda: panel_state_rbf(*args), a.reps)
    print(f"K3 panel_state_rbf, same inputs: {ms} ms", flush=True)
    print(f"K7 traced call (us): {trace_summary(*args)}", flush=True)


if __name__ == "__main__":
    main()
