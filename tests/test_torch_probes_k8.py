"""The K8b, K8c and K8d probes' plain versions (gpc_tpu_torch/probes/
dotform.py, refread.py, vpu.py) against the TPU probes of tools/, on the CPU.

tools/tpu_{dotform,refread,vpu}_probe.py are loaded from their paths (they
are not a package), with their module constants cut by monkeypatch, and
their Pallas kernels run in TPU interpret mode, scratch memory zero on
entry.  The dotform and vpu probes build their pallas_calls inside main();
the tests build the same calls around the modules' kernel functions, with
the same specs.  Those three modules point JAX's persistent compilation
cache at ~/.cache when imported; the loader undoes that (and gives them a
temporary home meanwhile), so later tests in the worker write no cache.

Tolerances: 1e-5 of the largest entry for the dots (bf16 products summed in
float32 in another order), exp, the Gram tile and the matvec chain (float32
in another order); the store is exact (bf16 of the same unfused float32
sum) in the slots it writes, and o is exact.  The Gram kernel's own
rounding (gram_dot_model) is held to float64 within the same 1e-5, and
half of it on the diagonal; the store's split among warps (store_plan) is
checked for copying every chunk of every iteration once, into its slot,
each slot last by its largest iteration.  The CUDA kernels are held
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).  K8b/K8c's slice plan (dotform.dot_plan), which the kernel
reads as its blockIdx split, is checked here for covering every output
tile and every k once at the card tests' shapes.
"""

import importlib.util
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gpc_tpu_torch.probes import dotform as TDF
from gpc_tpu_torch.probes import refread as TRR
from gpc_tpu_torch.probes import vpu as TVPU

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
              "jax_persistent_cache_min_entry_size_bytes")


def _load(name, home):
    """tools/<name>.py as a module, with JAX's cache settings as they were
    before and HOME pointing at `home` while it is imported."""
    saved = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    old_home = os.environ.get("HOME")
    os.environ["HOME"] = str(home)
    try:
        spec = importlib.util.spec_from_file_location(f"_tools_{name}", TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if old_home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = old_home
    return mod


@pytest.fixture(scope="module")
def tools(tmp_path_factory):
    home = tmp_path_factory.mktemp("home")
    return {n: _load(n, home) for n in ("tpu_dotform_probe", "tpu_refread_probe",
                                        "tpu_vpu_probe")}


def _interpret():
    return pltpu.force_tpu_interpret_mode(pltpu.InterpretParams(uninitialized_memory="zero"))


def _jx(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16
                       else jnp.float32)


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def _vmem(n):
    return [pl.BlockSpec(memory_space=pltpu.VMEM)] * n


def _out(b, dtype=jnp.float32):
    return jax.ShapeDtypeStruct((b, b), dtype)


def test_loading_the_tools_leaves_jax_cache_config_as_it_was(tools, tmp_path):
    before = {k: getattr(jax.config, k) for k in CACHE_KEYS}
    _load("tpu_vpu_probe", tmp_path)
    assert {k: getattr(jax.config, k) for k in CACHE_KEYS} == before
    assert (tmp_path / ".cache" / "gpc_tpu" / "xla").is_dir()   # the import wrote there


@pytest.mark.parametrize("form", TDF.FORMS)
def test_dotform_plain_matches_tpu_interpret(tools, monkeypatch, form):
    jd = tools["tpu_dotform_probe"]
    k, b, reps = 256, 128, 5
    for name, val in (("K", k), ("B", b), ("REPS", reps)):
        monkeypatch.setattr(jd, name, val)
    A, Bv = TDF.probe_inputs("cpu", k=k, b=b, seed=1)[form]
    with _interpret():
        want = pl.pallas_call(
            jd.make_kernel(form), out_shape=_out(b), in_specs=_vmem(2), out_specs=_vmem(1)[0],
            compiler_params=pltpu.CompilerParams(vmem_limit_bytes=64 * 1024 * 1024),
        )(_jx(A), _jx(Bv))
    got = TDF.dotform_probe(A, Bv, form, reps)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)


@pytest.mark.parametrize("pattern", TDF.PATTERNS)
def test_refread_plain_matches_tpu_interpret(tools, monkeypatch, pattern):
    """K = 512, B = 128: four blocks of A, five dots (dynslot reads slot 0
    three times and slot 1 twice)."""
    jr = tools["tpu_refread_probe"]
    k, b, reps = 512, 128, 5
    for name, val in (("K", k), ("B", b), ("NBLK", k // b), ("REPS", reps)):
        monkeypatch.setattr(jr, name, val)
    kern = {"hoisted": jr.kern_hoisted, "read_each": jr.kern_read_each,
            "reshape_each": jr.kern_reshape_each, "dynslot": jr.kern_dynslot_each}[pattern]
    a, Bv = TRR.probe_inputs("cpu", k=k, b=b, seed=2)
    with _interpret():
        want = pl.pallas_call(
            kern, out_shape=_out(b), in_specs=_vmem(2), out_specs=_vmem(1)[0],
            compiler_params=pltpu.CompilerParams(vmem_limit_bytes=96 * 1024 * 1024),
        )(_jx(a[pattern]), _jx(Bv))
    got = TRR.refread_probe(a[pattern], Bv, pattern, reps)
    _close(got, want, 1e-5)


@pytest.fixture
def vpu_small(tools, monkeypatch):
    """The vpu probe at B = 128, REPS = 8 (the matvec and the store run 4
    iterations), in interpret mode; the same numpy inputs for both sides."""
    jv = tools["tpu_vpu_probe"]
    monkeypatch.setattr(jv, "B", 128)
    monkeypatch.setattr(jv, "REPS", 8)
    with _interpret():
        yield jv, TVPU.probe_inputs("cpu", b=128, seed=3)


@pytest.mark.parametrize("name", ["exp", "gram", "matvec"])
def test_vpu_plain_matches_tpu_interpret(vpu_small, name):
    jv, inp = vpu_small
    b, reps = jv.B, jv.REPS
    A, X, n2, v = inp["A"], inp["X"], inp["n2"], inp["v"]
    vm = _vmem(1)[0]
    if name == "exp":
        call = pl.pallas_call(jv.kern_exp, out_shape=_out(b), in_specs=_vmem(1), out_specs=vm)
        args, got = (A,), TVPU.vpu_exp(A, reps)
    elif name == "gram":
        call = pl.pallas_call(jv.kern_gramtile, out_shape=_out(b), in_specs=_vmem(3),
                              out_specs=vm)
        args, got = (X, n2, n2.reshape(1, b)), TVPU.vpu_gram_tile(X, n2, reps)
    else:
        call = pl.pallas_call(jv.kern_matvec, out_shape=jax.ShapeDtypeStruct((b, 1), jnp.float32),
                              in_specs=_vmem(2), out_specs=vm)
        args, got = (A, v), TVPU.vpu_matvec(A, v, reps // 2)
    _close(got, call(*(_jx(x) for x in args)), 1e-5)


@pytest.mark.parametrize("mode", TVPU.MODES)
def test_vpu_stage_store_plain_matches_tpu_interpret(vpu_small, mode):
    jv, inp = vpu_small
    b, n = jv.B, jv.REPS // 2
    call = pl.pallas_call(
        jv.kern_store_dma,
        out_shape=(jax.ShapeDtypeStruct((TVPU.SLOTS, b, b), jnp.bfloat16), _out(b)),
        in_specs=_vmem(1),
        out_specs=(pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pltpu.VMEM)),
        scratch_shapes=[pltpu.VMEM((2, b, b), jnp.bfloat16), pltpu.SemaphoreType.DMA((2,))])
    big_j, o_j = call(_jx(inp["A"]))
    big, o = TVPU.vpu_stage_store(inp["A"], n, mode)
    w = TVPU.written_slots(n)
    assert big.dtype == torch.bfloat16 and w == n
    np.testing.assert_array_equal(big[:w].float().numpy(),
                                  np.asarray(big_j[:w], np.float32))
    np.testing.assert_array_equal(o.numpy(), np.asarray(o_j))
    assert not bool(big[w:].any())


def test_vpu_stage_store_plain_wraps_round_the_slots():
    """More iterations than slots: slot s holds the last it with it mod 64
    = s, as a loop over every iteration leaves it."""
    A = TVPU.probe_inputs("cpu", b=128, seed=4)["A"] * 1e-6   # small, so 1e-9 it shows
    n = 150
    big, o = TVPU.vpu_stage_store(A, n)
    want = torch.zeros_like(big)
    for it in range(n):
        want[it % TVPU.SLOTS] = (A + torch.tensor(float(it)) * torch.tensor(1e-9)).to(
            torch.bfloat16)
    assert torch.equal(big, want) and bool((o == n).all())
    assert not torch.equal(big[0], big[1])


LOG2E = np.float32(1.4426950408889634)


def tf32_split(x):
    """(hi, lo) of float32 x as csrc/probes_vpu.cu's Gram kernel splits X: hi
    = x rounded to tf32 (10 mantissa bits, ties away from zero: cvt.rna), lo
    = the rest, so rounded; both with the low 13 mantissa bits zero."""
    def rna(v):
        u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
        return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    hi = rna(x)
    return hi, rna(np.asarray(x, np.float32) - hi)


def gram_dot_model(X, n2, c=0.0, passes=4):
    """One rep of the Gram kernel as it rounds, in numpy: XXᵀ as the tf32
    passes lo·lo, lo·hi, hi·lo, hi·hi (the last `passes` of them), each
    pass's 8 products summed exactly and rounded to float32 once (the tensor
    cores' own rounding of a pass is not modelled); then 2^min(2 L g − ((L
    n2ᵢ + L·1e-9 c) + L n2ⱼ), 0) in float32, L = log₂e, the power exact."""
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32).astype(np.float64)  # noqa: E731
    hi, lo = (np.asarray(v, np.float64) for v in tf32_split(X))
    g = np.zeros((X.shape[0], X.shape[0]))
    for a, b in ((lo, lo), (lo, hi), (hi, lo), (hi, hi))[4 - passes:]:
        g = f32(g + a @ b.T)
    n2s = f32(np.asarray(n2, np.float64) * np.float64(LOG2E))
    cl = f32(np.float32(c) * np.float32(1e-9 * LOG2E))
    s = f32(f32(n2s + cl) + n2s.T)
    arg = np.minimum(f32(g * np.float64(np.float32(2 * LOG2E)) - s), 0.0)
    return np.exp2(arg).astype(np.float32)


def test_tf32_split_keeps_ten_mantissa_bits_and_the_rest():
    """hi and lo carry no bits below tf32's 10-bit mantissa, hi is x
    rounded to nearest (ties away), and hi + lo is x within 2⁻²¹ of |x|."""
    x = TVPU.probe_inputs("cpu", b=512, seed=0)["X"].numpy()
    hi, lo = tf32_split(x)
    for h in (hi, lo):
        assert h.dtype == np.float32 and not (h.view(np.uint32) & 0x1FFF).any()
    r = x.astype(np.float64) - hi
    assert (np.abs(r) <= np.abs(x) * 2.0 ** -11).all()
    assert (np.abs(r - lo) <= np.abs(x) * 2.0 ** -21).all()


@pytest.mark.parametrize("seed", [0, 13])
def test_gram_dot_model_within_budget_of_float64(seed):
    """The Gram kernel's rounding (gram_dot_model: X split into tf32 halves,
    four passes, the base-2 exp on a prescaled argument) against the tile in
    float64 at the TPU probe's B = 512: within the card tests' 1e-5 of the
    largest entry everywhere, and within half of it on the diagonal, where
    d2 = 2 n2ᵢ − 2 gᵢᵢ cancels to 0 and the split's error shows undamped.
    Without the lo·lo pass, whose products are all positive there, the
    diagonal sits at 5.7e-6 (seed 0) and 7.4e-6 (seed 13): more than half."""
    inp = TVPU.probe_inputs("cpu", b=512, seed=seed)
    X, n2 = inp["X"].numpy(), inp["n2"].numpy()
    Xd, n2d = X.astype(np.float64), n2.astype(np.float64)
    want = np.exp(-np.maximum(n2d + n2d.T - 2.0 * Xd @ Xd.T + 1e-9, 0.0))
    assert np.abs(np.diag(want) - 1.0).max() < 1e-5   # the diagonal is where d2 cancels
    diag = {}
    for passes in (4, 3):
        got = gram_dot_model(X, n2, c=1.0, passes=passes)
        assert got.dtype == np.float32 and got.shape == (512, 512)
        err = np.abs(got - want)
        assert err.max() <= 1e-5 * np.abs(want).max()
        diag[passes] = np.diag(err).max()
    assert diag[4] <= 0.5e-5 < diag[3]


def test_gram_four_passes_keep_a_margin_at_the_widest_card_width():
    """At B = 1024, the card tests' widest Gram tile, over seeds 0-3, 13
    and 16: four passes stay within 0.6 of the 1e-5 budget of float64
    everywhere, while three reach 0.9 of it at one seed (9.4e-6 at seed
    3): why the kernel runs the lo·lo pass (G_PASSES = 4)."""
    worst = {3: 0.0, 4: 0.0}
    for seed in (0, 1, 2, 3, 13, 16):
        inp = TVPU.probe_inputs("cpu", b=1024, seed=seed)
        X, n2 = inp["X"].numpy(), inp["n2"].numpy()
        Xd, n2d = X.astype(np.float64), n2.astype(np.float64)
        want = np.exp(-np.maximum(n2d + n2d.T - 2.0 * Xd @ Xd.T + 1e-9, 0.0))
        for passes in worst:
            err = np.abs(gram_dot_model(X, n2, c=1.0, passes=passes) - want).max()
            worst[passes] = max(worst[passes], err / np.abs(want).max())
    assert worst[4] <= 0.6e-5 and worst[3] >= 0.9e-5 and worst[3] <= 1e-5


def plan_copies(plan, warp, n_iters):
    """[(it, slot, chunk)] of warp `warp`'s copies in its order, as
    csrc/probes_vpu.cu's store_kernel reads its warp index: chunk =
    warp mod chunks, class = warp div chunks, it = class, class + classes,
    ... below n_iters."""
    chunk, cls = warp % plan.chunks, warp // plan.chunks
    return [(it, it % TVPU.SLOTS, chunk) for it in range(cls, n_iters, plan.classes)]


STORE_SHAPES = [(128, 132), (256, 132), (384, 132), (512, 132), (768, 132), (1024, 132),
                (512, 114), (512, 8)]


@pytest.mark.parametrize("b,sms", STORE_SHAPES)
@pytest.mark.parametrize("n", [1, 3, 65, 1024])
def test_store_plan_copies_each_band_once_into_its_slot_in_order(b, sms, n):
    """store_plan's warps, read as the kernel reads its warp index: every
    iteration's tile is copied chunk by chunk exactly once, into slot it
    mod 64; each (slot, chunk) has one writing warp, which writes it in
    increasing it, so its last writer is its largest it; a slot's copies
    lie at least 8 of the warp's copies apart (the kernel's wait_group 7);
    the blocks fit one wave of `sms`."""
    plan = TVPU.store_plan(b, sms)
    assert plan.chunks * TVPU.STORE_CHUNK == b * b and 64 % plan.classes == 0
    assert plan.warps % TVPU.STORE_WARPS == 0 and plan.blocks * TVPU.STORE_WARPS == plan.warps
    assert plan.blocks <= max(sms, plan.chunks // TVPU.STORE_WARPS)
    seen = np.zeros((n, plan.chunks), int)
    writer, last = {}, {}
    for w in range(plan.warps):
        copies = plan_copies(plan, w, n)
        its = [it for it, _, _ in copies]
        assert its == sorted(its)
        for k, (it, slot, chunk) in enumerate(copies):
            assert slot == it % TVPU.SLOTS
            seen[it, chunk] += 1
            assert writer.setdefault((slot, chunk), w) == w
            last[slot, chunk] = it
            earlier = [j for j, (_, s2, _) in enumerate(copies[:k]) if s2 == slot]
            assert not earlier or k - earlier[-1] >= 8
    assert (seen == 1).all()
    for (slot, chunk), it in last.items():
        assert it == max(i for i in range(n) if i % TVPU.SLOTS == slot)
    assert {s for s, _ in last} == set(range(TVPU.written_slots(n)))


def test_store_plan_fills_the_card_at_the_probe_width():
    """B = 512 on 132 SMs: 64 chunks x 8 classes = 512 warps, 128 blocks;
    B = 1024: 256 chunks x 2 classes, 128 blocks."""
    assert TVPU.store_plan(512, 132) == TVPU.StorePlan(64, 8)
    assert TVPU.store_plan(512, 132).blocks == 128
    assert TVPU.store_plan(1024, 132) == TVPU.StorePlan(256, 2)


@pytest.mark.parametrize("b,sms", [(192, 132), (0, 132), (2048, 132), (512, 0)])
def test_store_plan_rejects_what_the_kernel_cannot_split(b, sms):
    with pytest.raises(ValueError, match="store_plan"):
        TVPU.store_plan(b, sms)


# the card tests' shapes (tests/test_torch_cuda.py DOT_SHAPES and the layout
# tests) and the TPU probes'
PLAN_SHAPES = [(256, 128), (512, 256), (768, 128), (768, 384), (8192, 512)]


@pytest.mark.parametrize("k,b", PLAN_SHAPES)
def test_dot_plan_covers_each_tile_and_k_once(k, b):
    """dot_plan's blocks, read as the kernel reads blockIdx.x, cover every
    128 x 128 output tile and every 64-k chunk of its contraction exactly
    once; the streamed patterns read A once for each column tile."""
    plan = TDF.dot_plan(k, b)
    seen = np.zeros((b // 128, b // 128, k // 64), int)
    for i in range(plan.blocks):
        r0, s0, k0, k1 = plan.block(i)
        assert r0 % 128 == 0 and s0 % 128 == 0 and k0 % 64 == 0 and k1 - k0 == plan.ks
        seen[r0 // 128, s0 // 128, k0 // 64:k1 // 64] += 1
    assert (seen == 1).all()
    assert plan.streamed_bytes == (b // 128) * k * b * 2


@pytest.mark.parametrize("k,b", [(200, 128), (0, 128), (512, 200), (256, 0)])
def test_dot_plan_rejects_what_the_kernel_cannot_split(k, b):
    with pytest.raises(ValueError, match="dot_plan"):
        TDF.dot_plan(k, b)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call,match", [
    (lambda: TDF.dotform_probe(_meta((256, 128), torch.bfloat16),
                               _meta((128, 256), torch.bfloat16), "c0", 2), "form c0 wants"),
    (lambda: TDF.dotform_probe(_meta((200, 128), torch.bfloat16),
                               _meta((200, 128), torch.bfloat16), "c0", 2), "multiple of 256"),
    (lambda: TDF.dotform_probe(_meta((256, 128)), _meta((256, 128)), "c0", 2), "bfloat16"),
    (lambda: TDF.dotform_probe(_meta((256, 128), torch.bfloat16),
                               _meta((256, 128), torch.bfloat16), "cT", 2), "form"),
    (lambda: TDF.dotform_probe(_meta((256, 128), torch.bfloat16),
                               _meta((256, 128), torch.bfloat16), "c0", 2), "needs CUDA"),
    (lambda: TRR.refread_probe(_meta((256, 128), torch.bfloat16),
                               _meta((256, 128), torch.bfloat16), "dynslot", 2), "dynslot wants"),
    (lambda: TRR.refread_probe(_meta((2, 256, 128), torch.bfloat16),
                               _meta((256, 128), torch.bfloat16), "reshape", 2), "pattern"),
    (lambda: TVPU.vpu_exp(_meta((128, 64)), 2), "A \\(B, B\\)"),
    (lambda: TVPU.vpu_exp(_meta((128, 128), torch.float64), 2), "float32"),
    (lambda: TVPU.vpu_gram_tile(_meta((128, 4)), _meta((128, 1)), 2), "X \\(B, 8\\)"),
    (lambda: TVPU.vpu_gram_tile(_meta((96, 8)), _meta((96, 1)), 2), "multiple of 64"),
    (lambda: TVPU.vpu_matvec(_meta((96, 96)), _meta((96, 1)), 2), "power of two"),
    (lambda: TVPU.vpu_matvec(_meta((128, 128)), _meta((128,)), 2), "v \\(B, 1\\)"),
    (lambda: TVPU.vpu_stage_store(_meta((192, 192)), 2), "multiple of 128"),
    (lambda: TVPU.vpu_stage_store(_meta((128, 128), torch.bfloat16), 2), "float32"),
    (lambda: TVPU.vpu_stage_store(_meta((128, 128)), 2, "tma"), "mode"),
    (lambda: TVPU.vpu_stage_store(_meta((128, 128)), 2), "needs CUDA"),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, match):
    """Off the CPU a wrapper checks its inputs before it builds or launches
    anything (the meta device has no data): shapes, then the dtype, then
    the device."""
    with pytest.raises(ValueError, match=match):
        call()
