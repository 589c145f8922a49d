"""The one seam of the FTC evidence, ops/evidence_mode.kern_evidence, on the
CPU, against gpc_tpu's own models under the same variables.

Over model ∈ {gp, gplvm}, GPC_TPU_EVIDENCE ∈ {unset, dense, lazy, panel},
kernel ∈ {cmpnd(rbf, bias, white), cmpnd(mlp, bias, white), rbf alone
(noiseless)} and N ∈ {64, which splits under GPC_TPU_EVIDENCE_BASE = 16,
70, which does not}, each case asserts

  * which engine ran (a spy on each engine the dispatcher calls);
  * the fallback warning, word for word, or none;
  * the objective and its gradient in θ against gpc_tpu's model: float64,
    the value to 1e-10 relative and the gradient to 1e-8 under dense and
    lazy; under panel, gpc_tpu's panel engine takes float32 (interpret
    mode here), so the bounds are those of the panel tests: for the GP
    tests/test_torch_train.py's test_panel_gradients_match (2e-2 on the
    value and on the kernel's θ̄ elementwise), for the GP-LVM
    tests/test_torch_gplvm.py's test_panel_matches_within_panel_bounds
    (2e-3 on the value, 8e-2 relative L2 on θ̄).

And the six TPU tuning switches that the port no longer reads: each, set to
its old non-default value in a fresh interpreter (they were read at
import), leaves the dense and lazy log-likelihoods bit for bit as they are
with the variable unset.
"""

import itertools
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpc_tpu import kernels as GK
from gpc_tpu.models import gp as JGPM
from gpc_tpu.models import gplvm as JGL
from gpc_tpu.ops import evidence_mode as JEM
from gpc_tpu_torch import linalg as TL
from gpc_tpu_torch.interop.from_jax import from_jax, gplvm_from_jax
from gpc_tpu_torch.ops import evidence_mode as TEM

Q = 2
SPLITS, RAGGED = 64, 70
KERNS = {
    # kernel parameters (untransformed): spread enough for the panel engine's
    # float32 bf16 factor, and rbf alone (no noise) well inside PD
    "rbf-bias-white": ((GK.Rbf, GK.Bias, GK.White), [2.0, 1.2, 0.25, 0.2]),
    "mlp-bias-white": ((GK.Mlp, GK.Bias, GK.White), [10.0, 10.0, 1.3, 0.25, 0.2]),
    "rbf": ((GK.Rbf,), [8.0, 1.0]),
}
WARN_LAZY = ("GPC_TPU_EVIDENCE=lazy needs n_data to split into 16 blocks (got N={n}); "
             "falling back to dense")
WARN_FAMILY = ("GPC_TPU_EVIDENCE=panel serves cmpnd(rbf[, bias][, white]) only (got cmpnd); "
               "falling back to the lazy engine")
WARN_NOISELESS = ("GPC_TPU_EVIDENCE=panel needs a white/noise ridge (got a noiseless "
                  "kernel); falling back to the dense jitchol engine")


def _jax_kern(kind):
    parts, _ = KERNS[kind]
    if len(parts) == 1:
        return parts[0](input_dim=Q)
    return GK.Cmpnd(input_dim=Q, components=tuple(c(input_dim=Q) for c in parts))


def expected(mode, kind, n):
    """(the engine that runs, its warning or None)."""
    if mode in (None, "dense"):
        return "dense", None
    if mode == "lazy":
        return ("lazy", None) if n == SPLITS else ("dense", WARN_LAZY.format(n=n))
    if kind == "mlp-bias-white":
        return ("lazy" if n == SPLITS else "dense"), WARN_FAMILY
    if kind == "rbf":
        return "dense", WARN_NOISELESS
    return "panel", None


def _cast(f32):
    return lambda a: jnp.asarray(np.asarray(a), jnp.float32 if f32 else jnp.float64)


def _gp(kind, n):
    """(port model, gpc_tpu's value_and_grad(f32), kernel parameter count)."""
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, Q))
    y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, 1))
    jk = _jax_kern(kind)
    jm = JGPM.GP(jk, X, y)
    jm.theta = jnp.asarray(jm.spec.pack(np.array(KERNS[kind][1])))
    pm = from_jax(jk, np.asarray(jm.theta), X, y, jm.bias, jm.fixed_scales, device="cpu")

    def jax_vag(f32):
        c = _cast(f32)
        obj = JGPM.make_objective(jm.spec, c(jm.X), c(jm.y), c(jm.bias), c(jm.fixed_scales))
        return jax.jit(jax.value_and_grad(obj))(c(jm.theta))

    return pm, jax_vag, jk.n_params


def _gplvm(kind, n):
    """As _gp for a GP-LVM on random 3-D data, its PCA latents ×3."""
    y = np.random.default_rng(n + 1).standard_normal((n, 3))
    jk = _jax_kern(kind)
    jm = JGL.GPLVM(jk, y, latent_dim=Q)
    _kp, _dp, Xvals, _s = jm.spec.unpack(jm.theta)
    jm.theta = jnp.asarray(jm.spec.pack(np.array(KERNS[kind][1]), 3.0 * np.asarray(Xvals)))
    pm = gplvm_from_jax(jm, device="cpu")

    def jax_vag(f32):
        c = _cast(f32)
        return jax.jit(jax.value_and_grad(lambda th: -JGL.log_likelihood(
            jm.spec, th, c(jm.y), c(jm.noise_bias), c(jm.fixed_scales))))(c(jm.theta))

    return pm, jax_vag, jk.n_params


def _spy(monkeypatch, ran):
    """Record in `ran` each engine that the dispatcher calls."""
    for name, engine in (("kern_evidence_lazy", "lazy"), ("kern_evidence_panel", "panel"),
                         ("kern_evidence_iterative", "iterative")):
        real = getattr(TEM, name)
        monkeypatch.setattr(TEM, name, lambda *a, _r=real, _e=engine, **k:
                            ran.append(_e) or _r(*a, **k))
    real = TL.evidence_terms
    monkeypatch.setattr(TL, "evidence_terms", lambda *a, **k: ran.append("dense") or real(*a, **k))


# gpc_tpu's panel engine runs in Pallas interpret mode here, about 10 s a
# call: the panel engine itself is held at N = 64 only (it pads 64 and 70
# alike, and tests/test_torch_gp_serving.py's
# test_panel_engine_matches_jax_interpret holds its padding at N = 1000)
CASES = [c for c in itertools.product(["gp", "gplvm"], [None, "dense", "lazy", "panel"],
                                      list(KERNS), [SPLITS, RAGGED])
         if expected(c[1], c[2], c[3])[0] != "panel" or c[3] == SPLITS]
_JAX = {}     # gpc_tpu's value_and_grad by (model, kernel, N, the engine it resolves)


@pytest.mark.parametrize("model,mode,kind,n", CASES)
def test_kern_evidence_dispatch(model, mode, kind, n, monkeypatch):
    monkeypatch.setenv("GPC_TPU_EVIDENCE_BASE", "16")
    if mode is None:
        monkeypatch.delenv("GPC_TPU_EVIDENCE", raising=False)
    else:
        monkeypatch.setenv("GPC_TPU_EVIDENCE", mode)
    engine, warning = expected(mode, kind, n)
    pm, jax_vag, nk = (_gp if model == "gp" else _gplvm)(kind, n)
    ran = []
    _spy(monkeypatch, ran)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        f, g = pm.value_and_grad_fn()(pm.theta)
    said = [str(w.message) for w in caught if str(w.message).startswith("GPC_TPU_EVIDENCE")]
    assert ran == [engine]
    assert said == ([] if warning is None else [warning])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # gpc_tpu's own fallback warnings
        key = (model, kind, n, JEM.select_evidence_mode(n))
        if key not in _JAX:
            _JAX[key] = jax_vag(engine == "panel")
    f_j, g_j = _JAX[key]
    g, g_j = np.asarray(g), np.asarray(g_j, np.float64)
    assert np.isfinite(f) and np.isfinite(g).all()
    if engine == "panel" and model == "gp":
        np.testing.assert_allclose(f, float(f_j), rtol=2e-2)
        np.testing.assert_allclose(g[:nk], g_j[:nk], rtol=2e-2, atol=2e-2)
    elif engine == "panel":
        np.testing.assert_allclose(f, float(f_j), rtol=2e-3)
        assert np.linalg.norm(g - g_j) / np.linalg.norm(g_j) < 8e-2
    else:
        np.testing.assert_allclose(f, float(f_j), rtol=1e-10)
        np.testing.assert_allclose(g, g_j, rtol=1e-8, atol=1e-8 * np.abs(g_j).max())


RETIRED = {"GPC_TPU_FAST_JITCHOL": "1", "GPC_TPU_BF16_CHOL": "1", "GPC_TPU_PALLAS_BASE": "1",
           "GPC_TPU_BF16_EVIDENCE": "1", "GPC_TPU_EVIDENCE_PRESTACK": "1",
           "GPC_TPU_BIAS_SPLIT": "0"}

# the dense and lazy log-likelihoods of a cmpnd(rbf, bias, white) GP at N = 64
# (lazy at base 16, where the rank-1 bias split applies), as float.hex
LOGLIKS = """
import json, os
import numpy as np
from gpc_tpu_torch import kernels as TK
from gpc_tpu_torch.models.gp import GP
rng = np.random.default_rng(0)
X = rng.standard_normal((64, 2))
y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((64, 1))
kern = TK.Cmpnd(input_dim=2, components=(TK.Rbf(input_dim=2), TK.Bias(input_dim=2),
                                         TK.White(input_dim=2)))
model = GP(kern, X, y, device="cpu")
out = {}
for engine in ("dense", "lazy"):
    os.environ["GPC_TPU_EVIDENCE"] = engine
    out[engine] = float(model.log_likelihood()).hex()
print(json.dumps(out))
"""


def _start(env):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    full = {k: v for k, v in os.environ.items() if k not in RETIRED}
    full.update(GPC_TPU_EVIDENCE_BASE="16", PYTHONPATH=repo, OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1", **env)
    return subprocess.Popen([sys.executable, "-c", LOGLIKS], env=full, cwd=repo,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def logliks():
    """{variable or None (all unset): the log-likelihoods}, each from its
    own interpreter, the seven run side by side."""
    procs = {name: _start({} if name is None else {name: RETIRED[name]})
             for name in [None, *sorted(RETIRED)]}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("name", sorted(RETIRED))
def test_retired_switches_change_nothing(name, logliks):
    assert logliks[name] == logliks[None]
