"""K3's launch plan (gpc_tpu_torch/ops/chol_panel.py::panel_plan), walked
symbolically on the CPU.

Each step's reads and writes are modelled here from what its kernels do
(csrc/chol_panel.cu), on 128-row blocks of acc, 128 x 128 tiles of T,
128-column blocks of v, and Md, the partials, ldj, G.  Host order is the
sequential algorithm; a step may run only after every earlier step it
conflicts with (read after write, write after read, write after write).
On the card two steps are ordered only by stream order and by an event
wait on the latest record of that event before the wait, so the test
builds that happens-before relation and checks every conflict against it.
"""

import pytest

from gpc_tpu_torch.ops import chol_panel as TCP

SIZES = [128, 256, 384, 1024, 16384]


def _accesses(st, nb):
    """(reads, writes) of one step, as sets of region keys."""
    j = st.j
    r0, r1 = st.row0 // 128, st.row1 // 128
    if st.kind in (TCP.FORK, TCP.JOIN):
        return set(), set()
    if st.kind == TCP.FILL:
        reads = {("T", r, k) for r in range(r0, r1) for k in range(j)}
        reads |= {("T", j, k) for k in range(j)}
        acc = {("acc", r - j) for r in range(r0, r1)}
        # the partials, one buffer for the diagonal fills and one for the fills
        # below, are written and read back inside the step
        part = {("part", st.buf)} if st.splits else set()
        return reads, acc | part
    if st.kind == TCP.LEAF_STEP:
        return ({("acc", 0), ("v", j)},
                {("Md",), ("v", j), ("ldj", j), ("T", j, j)})
    if st.kind == TCP.SOLVE:
        reads = {("acc", r - j) for r in range(r0, r1)} | {("Md",), ("v", j)}
        reads |= {("v", r) for r in range(r0, r1)}
        return reads, {("T", r, j) for r in range(r0, r1)} | {("v", r) for r in range(r0, r1)}
    assert st.kind == TCP.FINISH
    return {("v", r) for r in range(nb)} | {("ldj", j) for j in range(nb)}, {("G",)}


def _happens_before(steps):
    """anc[i]: bitmask of the steps that complete before step i starts."""
    anc, last_on, last_record = [], {}, {}
    for i, st in enumerate(steps):
        a = 0
        if st.stream in last_on:
            p = last_on[st.stream]
            a |= anc[p] | (1 << p)
        if st.wait >= 0:
            p = last_record[st.wait]    # a wait with no record before it is a fault
            a |= anc[p] | (1 << p)
        anc.append(a)
        last_on[st.stream] = i
        if st.record >= 0:
            last_record[st.record] = i
    return anc


@pytest.mark.parametrize("N", SIZES)
def test_panel_plan_orders_every_conflict(N):
    steps = TCP.panel_plan(N)
    nb = N // 128
    anc = _happens_before(steps)
    writer, readers = {}, {}
    written = {("T", r, k) for r in range(nb) for k in range(r)} | {("v", r) for r in range(nb)}
    t_writes = {}
    for i, st in enumerate(steps):
        reads, writes = _accesses(st, nb)
        for key in reads:
            if key in writer:
                w = writer[key]
                assert anc[i] >> w & 1, f"N={N}: step {i} {st} reads {key} before step {w} wrote it"
            else:
                # T starts as zeros (read before any write only above the panel) and v as m
                assert key[0] in ("T", "v"), f"N={N}: step {i} {st} reads unwritten {key}"
            readers.setdefault(key, set()).add(i)
        for key in writes:
            for p in readers.get(key, set()) - {i}:
                assert anc[i] >> p & 1, f"N={N}: step {i} {st} overwrites {key} read by step {p}"
            if key in writer and writer[key] != i:
                assert anc[i] >> writer[key] & 1, f"N={N}: step {i} {st} races on {key}"
            writer[key], readers[key] = i, set()
            if key[0] == "T":
                t_writes[key] = t_writes.get(key, 0) + 1
    # every T tile on and below the diagonal is written exactly once; none above
    assert t_writes == {("T", r, k): 1 for r in range(nb) for k in range(r + 1)}
    # every read of T below the diagonal found its writer (the initial zeros are never read)
    assert written <= set(writer)


@pytest.mark.parametrize("N", SIZES)
def test_panel_plan_forks_from_and_joins_the_callers_stream(N):
    steps = TCP.panel_plan(N)
    anc = _happens_before(steps)
    first, last = steps[0], steps[-1]
    assert first.kind == TCP.FORK and first.stream == TCP.CALLER
    assert last.kind == TCP.JOIN and last.stream == TCP.CALLER
    assert [st.stream for st in steps[1:-1]].count(TCP.CALLER) == 0
    # every launch comes after everything the caller enqueued before the call,
    # and the caller's later work after every launch
    for i in range(1, len(steps)):
        assert anc[i] & 1
        assert anc[-1] >> i - 1 & 1
    # each wait refers to an event recorded earlier, on another stream
    for i, st in enumerate(steps):
        if st.wait >= 0:
            rec = max(p for p in range(i) if steps[p].record == st.wait)
            assert steps[rec].stream != st.stream


@pytest.mark.parametrize("N", SIZES)
def test_panel_plan_steps_and_splits(N):
    """One fill of each block's rows and one leaf a panel, a solve for every
    panel but the last, the leaves on the side stream; a correction in
    every fill but panel 0's, its splits at least one 64-wide k chunk each,
    the fill of the rows below on one SM fewer than 132 and into partials
    buffer 1, the diagonal fill's buffer 0."""
    sms = 132
    steps = TCP.panel_plan(N, sms)
    nb = N // 128
    kinds = [st.kind for st in steps]
    assert kinds.count(TCP.LEAF_STEP) == nb and kinds.count(TCP.SOLVE) == nb - 1
    assert kinds.count(TCP.FINISH) == 1
    # the leaves, solves and diagonal fills on the chain stream, the fills below beside them
    for st in steps:
        if st.kind in (TCP.LEAF_STEP, TCP.SOLVE, TCP.FINISH):
            assert st.stream == TCP.CHAIN
        elif st.kind == TCP.FILL:
            below = st.row0 != st.j * 128
            assert st.stream == (TCP.BELOW if below else TCP.CHAIN) and st.buf == below
    for st in steps:
        if st.kind != TCP.FILL:
            continue
        kc = st.j * 128 // TCP.CORR_BK
        tiles = (st.row1 - st.row0) // 128
        below = st.row0 != st.j * 128
        if kc == 0:
            assert st.splits == 0
            continue
        assert 1 <= st.splits <= kc
        assert 1 <= st.grid <= min(tiles * st.splits, sms - below)
        assert st.splits * (st.row1 - st.row0) * 128 <= TCP.part_floats(steps)[below]
    fills = [st for st in steps if st.kind == TCP.FILL]
    assert sum(not st.buf for st in fills) == nb and sum(st.buf for st in fills) == nb - 1
    assert sum(st.splits > 0 for st in fills) == max(0, 2 * nb - 3)


@pytest.mark.parametrize("tiles,kc,grid", [(1, 254, 132), (126, 2, 131), (63, 128, 131),
                                           (254, 256, 131), (7, 240, 131)])
def test_corr_split_fills_the_grid_without_empty_splits(tiles, kc, grid):
    splits, g = TCP.corr_split(tiles, kc, grid)
    assert 1 <= splits <= kc and g == min(tiles * splits, grid)
