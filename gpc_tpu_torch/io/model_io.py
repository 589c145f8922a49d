"""Reference-compatible text model files (version=0.2 `field=value` streams).

Counterpart of gpc_tpu/io/model_io.py for GP and IVM models: the stream
Reader and Writer, prior blocks, kernels of every kind (poly's degree
field, cmpnd and tensor), the noise blocks of every type (ncnm's
gammaSplit, ordered's numCategories), read_gp/write_gp with the sparse
blocks (β as an N × D matrix, fixInducing and the inducing inputs) and the
noise type a GP file carries, read_ivm/write_ivm with the active set
and the sites, and read_gplvm/write_gplvm with the latent kernel, the
dynamics kernel, the scale-noise block and the Y/X data block.  Files are
byte-compatible with gpc_tpu's: each package loads what the other writes.
"""

from __future__ import annotations

import io as _io

import numpy as np

from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch import noise as NZ
from gpc_tpu_torch import priors as priors_mod
from gpc_tpu_torch.models.gp import GP
from gpc_tpu_torch.models.ivm import IVM, restored_state

VERSION = 0.2
APPROX_CODE = {"ftc": 0, "dtc": 1, "fitc": 2, "pitc": 3, "dtcvar": 4}
APPROX_NAME = {v: k for k, v in APPROX_CODE.items()}


def _parse_float(s: str) -> float:
    """float() plus C99 hexfloat, which reference-written version lines use
    once a scientific matrix has been streamed (CNdlInterfaces.h:27-31)."""
    try:
        return float(s)
    except ValueError:
        return float.fromhex(s)


class Reader:
    def __init__(self, text: str):
        # comment lines are skipped wherever they appear (ndlstrutil.h:17-18)
        self.lines = [ln.rstrip("\r") for ln in text.splitlines()
                      if ln.strip() and not ln.lstrip().startswith("#")]
        self.pos = 0

    def line(self) -> str:
        if self.pos >= len(self.lines):
            raise ValueError("Unexpected end of stream")
        ln = self.lines[self.pos]
        self.pos += 1
        return ln

    def field(self, name: str) -> str:
        key, _, val = self.line().partition("=")
        if key != name:
            raise ValueError(f"Stream format error: expected field {name}, got {key}")
        return val

    def int_(self, name): return int(_parse_float(self.field(name)))
    def float_(self, name): return _parse_float(self.field(name))
    def bool_(self, name): return self.int_(name) != 0

    def version(self):
        v = self.float_("version")
        if v < VERSION:
            raise ValueError(f"Stream version {v} below minimum {VERSION}")
        return v

    def matrix(self) -> np.ndarray:
        self.version()
        if self.field("baseType") != "matrix":
            raise ValueError("Unexpected base type (wanted matrix)")
        if self.field("type") != "doubleMatrix":
            raise ValueError("Unexpected matrix type")
        rows = self.int_("numRows")
        cols = self.int_("numCols")
        out = np.zeros((rows, cols))
        for i in range(rows):
            toks = self.line().split()
            if len(toks) != cols:
                raise ValueError(f"Incorrect number of columns in row {i}")
            out[i] = [_parse_float(t) for t in toks]
        return out


class Writer:
    def __init__(self):
        self.buf = _io.StringIO()

    def field(self, name, val):
        if isinstance(val, bool):
            val = int(val)
        if isinstance(val, float):
            val = f"{val:.17e}"
        self.buf.write(f"{name}={val}\n")

    def version(self):
        self.buf.write(f"version={VERSION:.6f}\n")

    def matrix(self, M: np.ndarray):
        M = np.atleast_2d(np.asarray(M, dtype=np.float64))
        self.version()
        self.field("baseType", "matrix")
        self.field("type", "doubleMatrix")
        self.field("numRows", M.shape[0])
        self.field("numCols", M.shape[1])
        for i in range(M.shape[0]):
            self.buf.write(" ".join(f"{v:.17e}" for v in M[i]) + "\n")

    def text(self) -> str:
        return self.buf.getvalue()


# ---------------------------------------------------------------------------
# priors (CRegularisable::writePriorsToStream, CDist.h:281-303)
# ---------------------------------------------------------------------------

_PRIOR_NPARAMS = {"gaussian": 1, "gamma": 2, "wang": 1}


def _write_prior(w: Writer, prior):
    w.field("priorIndex", prior.index)
    w.version()
    w.field("baseType", "dist")
    w.field("type", prior.kind)
    w.field("numParams", _PRIOR_NPARAMS[prior.kind])
    w.matrix(np.asarray(prior.hyp).reshape(1, -1))


def _read_prior(r: Reader):
    idx = int(float(r.field("priorIndex")))
    r.version()
    r.field("baseType")
    kind = r.field("type")
    n = r.int_("numParams")
    hyp = r.matrix().reshape(-1)
    if len(hyp) != n:
        raise ValueError("prior numParams mismatch")
    return priors_mod.Prior(kind, tuple(float(h) for h in hyp), idx)


# ---------------------------------------------------------------------------
# kernels (CKern.cpp:15-46; CComponentKern.cpp:113-137; CPolyKern:2668-2684;
# whitefixed CKern.cpp:773-793)
# ---------------------------------------------------------------------------

def write_kern(w: Writer, kern: KM.Kern, params: np.ndarray):
    params = np.asarray(params)
    w.version()
    w.field("baseType", "kern")
    w.field("type", kern.kind)
    w.field("inputDim", kern.input_dim)
    w.field("numParams", kern.n_params)
    if kern.kind in ("cmpnd", "tensor"):
        w.field("numKerns", len(kern.components))
        off = kern.offsets()
        for i, c in enumerate(kern.components):
            write_kern(w, c, params[off[i]:off[i + 1]])
        return
    if kern.kind == "whitefixed":
        w.field("variance", float(kern.fixed_variance))
        return
    if kern.kind in ("poly", "polyard"):
        deg = kern.degree
        w.field("degree", int(deg) if deg == int(deg) else deg)
    w.matrix(params.reshape(1, -1))
    w.field("numPriors", len(kern.priors))
    for pr in kern.priors:
        _write_prior(w, pr)


def read_kern(r: Reader):
    """Returns (kern, params)."""
    r.version()
    r.field("baseType")
    kind = r.field("type")
    input_dim = r.int_("inputDim")
    n_params = r.int_("numParams")
    if kind in ("cmpnd", "tensor"):
        num_kerns = r.int_("numKerns")
        children, child_params = [], []
        for _ in range(num_kerns):
            c, cp = read_kern(r)
            children.append(c)
            child_params.append(cp)
        kern = KM.make_kern(kind, input_dim, components=tuple(children))
        params = np.concatenate(child_params) if child_params else np.zeros(0)
        return kern, params
    if kind == "whitefixed":
        var = r.float_("variance")
        return KM.WhiteFixed(input_dim=input_dim, fixed_variance=var), np.zeros(0)
    kwargs = {}
    if kind in ("poly", "polyard"):
        kwargs["degree"] = r.float_("degree")
    params = r.matrix().reshape(-1)
    if len(params) != n_params:
        raise ValueError("Listed number of parameters does not match computed number of parameters.")
    num_priors = r.int_("numPriors")
    priors = tuple(_read_prior(r) for _ in range(num_priors))
    return KM.make_kern(kind, input_dim, **kwargs).with_priors(priors), params


# ---------------------------------------------------------------------------
# noise models (CNoise.cpp:275-286; factory CNoise.cpp:1813-1832)
# ---------------------------------------------------------------------------

def write_noise(w: Writer, noise_type: str, params: np.ndarray, output_dim: int,
                n_data: int = 1, extra=None):
    """Base format CNoise.cpp:275-286; ncnm adds numData and gammaSplit
    (CNoise.cpp:1376-1387), ordered numData and numCategories
    (CNoise.cpp:1770-1781)."""
    extra = extra or {}
    w.version()
    w.field("baseType", "noise")
    w.field("type", noise_type)
    if noise_type in ("ncnm", "ordered"):
        w.field("numData", n_data)
    w.field("outputDim", output_dim)
    w.field("numParams", len(np.atleast_1d(params)))
    if noise_type == "ncnm":
        w.field("gammaSplit", int(extra.get("gammaSplit", 0)))
    if noise_type == "ordered":
        w.field("numCategories", int(extra.get("numCategories", 3)))
    w.matrix(np.asarray(params).reshape(1, -1))


def read_noise(r: Reader):
    """Returns (noise_type, params, output_dim, extra)."""
    r.version()
    r.field("baseType")
    ntype = r.field("type")
    extra = {}
    if ntype in ("ncnm", "ordered"):
        extra["numData"] = r.int_("numData")
    output_dim = r.int_("outputDim")
    n = r.int_("numParams")
    if ntype == "ncnm":
        extra["gammaSplit"] = r.int_("gammaSplit")
    if ntype == "ordered":
        extra["numCategories"] = r.int_("numCategories")
    params = r.matrix().reshape(-1)
    if len(params) != n:
        raise ValueError("noise numParams mismatch")
    return ntype, params, output_dim, extra


def noise_extra(noise) -> dict:
    """The extra fields of a noise model's block."""
    if noise.kind == "ncnm":
        return {"gammaSplit": int(noise.split_gamma)}
    if noise.kind == "ordered":
        return {"numCategories": noise.num_categories}
    return {}


def make_noise_from_stream(ntype, output_dim, extra):
    """The noise model of a stream's type and extra fields."""
    kwargs = {}
    if ntype == "ncnm":
        kwargs["split_gamma"] = bool(extra.get("gammaSplit", 0))
    if ntype == "ordered":
        kwargs["num_categories"] = int(extra.get("numCategories", 3))
    return NZ.make_noise(ntype, output_dim, **kwargs)


# ---------------------------------------------------------------------------
# GP model files (CGp.cpp:1655-1682 write, 1606-1653 read)
# ---------------------------------------------------------------------------

class DataDimensionError(ValueError):
    """Re-attached data doesn't match the stored model's inputDim."""


def write_gp(path, model, comment: str = ""):
    """model: gpc_tpu_torch.models.gp.GP"""
    spec = model.spec
    w = Writer()
    if comment:
        w.buf.write(f"# {comment}\n")
    w.version()
    w.field("baseType", "dataModel")
    w.field("type", "gp")
    w.field("numData", spec.n_data)
    w.field("outputDim", spec.output_dim)
    w.field("inputDim", spec.input_dim)
    w.field("sparseApproximation", APPROX_CODE[spec.approx])
    w.field("numActive", spec.num_active)
    if spec.sparse:
        w.matrix(np.full((spec.n_data, spec.output_dim), model.beta()))
    w.field("learnScale", spec.learn_scales)
    w.field("learnBias", False)
    w.matrix(np.asarray(model.scales()).reshape(1, -1))
    w.matrix(np.asarray(model.bias).reshape(1, -1))
    write_kern(w, spec.kern, model.kern_params())
    noise_params = getattr(model, "noise_params", None)
    if noise_params is None:
        noise_params = np.concatenate([np.zeros(spec.output_dim), [1e-6]])
    # ncnm/ordered blocks carry numData and their extra fields: write back
    # what read_gp kept, never write_noise's defaults
    write_noise(w, getattr(model, "noise_type", "gaussian"), noise_params, spec.output_dim,
                n_data=spec.n_data, extra=getattr(model, "noise_extra", None))
    if spec.sparse:
        w.field("fixInducing", spec.inducing_fixed)
        w.matrix(np.asarray(model.inducing()))
    with open(path, "w") as f:
        f.write(w.text())


def read_gp(path, X=None, y=None, device=None):
    """Load a gp model file, re-attaching data if given (gp.cpp:620-622).
    Returns a GP with the stored parameters, bias and scales on `device`
    (None: the card, and an error without one; "cpu" for the CPU)."""
    with open(path) as f:
        r = Reader(f.read())
    r.version()
    if r.field("baseType") != "dataModel" or r.field("type") != "gp":
        raise ValueError("not a gp model file")
    n_data = r.int_("numData")
    output_dim = r.int_("outputDim")
    input_dim = r.int_("inputDim")
    approx = APPROX_NAME[r.int_("sparseApproximation")]
    num_active = r.int_("numActive")
    beta = float(r.matrix()[0, 0]) if approx != "ftc" else None
    learn_scale = r.bool_("learnScale")
    r.bool_("learnBias")
    scales = r.matrix().reshape(-1)
    bias = r.matrix().reshape(-1)
    kern, kern_params = read_kern(r)
    noise_type, noise_params, _, extra = read_noise(r)
    X_u = None
    inducing_fixed = False
    if approx != "ftc":
        inducing_fixed = r.bool_("fixInducing")
        X_u = r.matrix()

    if X is not None and np.asarray(X).shape[1] != input_dim:
        raise DataDimensionError(
            f"model expects inputDim={input_dim}, data has {np.asarray(X).shape[1]}")
    if X is None:
        X = np.zeros((n_data, input_dim))
    if y is None:
        y = np.zeros((n_data, output_dim))
    model = GP(kern, X, y, approx=approx, num_active=num_active,
               learn_scales=learn_scale, centre=False, inducing_fixed=inducing_fixed,
               device=device)
    model.bias = bias
    model.fixed_scales = scales
    model.noise_type = noise_type
    model.noise_params = noise_params
    model.noise_extra = extra
    if inducing_fixed:
        model.X_u_fixed = X_u
    model.theta = model.spec.pack(kern_params, X_u=None if inducing_fixed else X_u,
                                  scales=scales if learn_scale else None, beta=beta)
    return model


# ---------------------------------------------------------------------------
# IVM model files (CIvm::writeParamsToStream CIvm.cpp:773-790, read 791-860)
# ---------------------------------------------------------------------------

def write_ivm(path, model, comment: str = ""):
    """model: gpc_tpu_torch.models.ivm.IVM"""
    spec = model.spec
    st = model.state
    w = Writer()
    if comment:
        w.buf.write(f"# {comment}\n")
    w.version()
    # CIvm extends CMapModel, whose base type is "mapModel" (CDataModel.h:118)
    w.field("baseType", "mapModel")
    w.field("type", "ivm")
    w.field("numData", spec.n_data)
    w.field("outputDim", spec.output_dim)
    w.field("inputDim", spec.input_dim)
    w.field("numActive", spec.num_active)
    write_kern(w, spec.kern, model.kern_params)
    write_noise(w, spec.noise.kind, model.noise_params, spec.output_dim,
                n_data=spec.n_data, extra=noise_extra(spec.noise))
    order = st.active_idx.cpu().numpy()
    w.field("activeSet", " ".join(str(int(i)) for i in order))
    w.matrix(model.y[order])
    w.matrix(model.X[order])
    w.matrix(st.m_site.cpu().numpy())
    w.matrix(st.beta_site.cpu().numpy())
    with open(path, "w") as f:
        f.write(w.text())


def read_ivm(path, X=None, y=None, device=None):
    """Load an ivm model file: an IVM with its kernel and noise parameters
    and the stored active set and sites, on `device` (None: the card).
    Without X or y, the stored active rows are placed in zero data."""
    with open(path) as f:
        r = Reader(f.read())
    r.version()
    # gpc_tpu's earliest files wrote "dataModel"; the reference writes "mapModel"
    if r.field("baseType") not in ("mapModel", "dataModel") or r.field("type") != "ivm":
        raise ValueError("not an ivm model file")
    n_data = r.int_("numData")
    output_dim = r.int_("outputDim")
    input_dim = r.int_("inputDim")
    num_active = r.int_("numActive")
    kern, kern_params = read_kern(r)
    ntype, nparams, nod, nextra = read_noise(r)
    noise = make_noise_from_stream(ntype, nod, nextra)
    active = np.array([int(t) for t in r.field("activeSet").split()], dtype=np.int64)
    activeY = r.matrix()
    activeX = r.matrix()
    m_site = r.matrix()
    beta_site = r.matrix()
    if X is not None and np.asarray(X).shape[1] != input_dim:
        raise DataDimensionError(
            f"model expects inputDim={input_dim}, data has {np.asarray(X).shape[1]}")
    if X is None:
        X = np.zeros((n_data, input_dim))
        X[active] = activeX
    if y is None:
        y = np.zeros((n_data, output_dim))
        y[active] = activeY
    model = IVM(kern, noise, X, y, num_active=num_active, kern_params=kern_params,
                noise_params=nparams, device=device)
    model.state = restored_state(model, active, m_site, beta_site)
    return model


# ---------------------------------------------------------------------------
# GP-LVM model files (CGplvm::writeParamsToStream, CGplvm.cpp)
# ---------------------------------------------------------------------------

def write_gplvm(path, model, labels=None, comment: str = ""):
    """model: gpc_tpu_torch.models.gplvm.GPLVM.  The format header, the
    kernel, the dynamics kernel (if any), the scale noise and the Y/X data
    block, as gpc_tpu writes them: `dynamicsLearnt` carries whether the
    model has dynamics, and a row without labels ends in a space."""
    spec = model.spec
    w = Writer()
    if comment:
        w.buf.write(f"# {comment}\n")
    w.version()
    w.field("baseType", "dataModel")
    w.field("type", "gplvm")
    w.field("numData", spec.n_data)
    w.field("outputDim", spec.data_dim)
    w.field("inputDim", spec.latent_dim)
    w.field("latentRegularised", spec.latent_regularised)
    w.field("backConstrained", spec.back_constrained)
    w.field("dynamicsLearnt", spec.has_dynamics)
    write_kern(w, spec.kern, model.kern_params())
    if spec.has_dynamics:
        write_kern(w, spec.dyn_kern, model.dyn_kern_params())
    # scale noise: params [bias×D, scale×D] (CScaleNoise::getParams)
    write_noise(w, "scale", np.concatenate([model.noise_bias, model.scales()]),
                spec.data_dim)
    header = f"Y:{spec.data_dim},X:{spec.latent_dim}"
    if labels is not None:
        header += ",labels:1"
    w.buf.write(header + "\n")
    X = model.latent_X()
    y = np.asarray(model.y)
    for i in range(spec.n_data):
        row = " ".join(f"{v:.17e}" for v in y[i]) + " " + " ".join(f"{v:.17e}" for v in X[i])
        if labels is not None:
            row += f" {int(labels[i])}"
        w.buf.write(row + " \n" if labels is None else row + "\n")
    with open(path, "w") as f:
        f.write(w.text())


def read_gplvm(path, device=None):
    """Load a gplvm model file: (GPLVM on `device` (None: the card), labels
    or None).  The stored latents become free parameters: the reference
    does not serialize back-constraint information either."""
    from gpc_tpu_torch.models.gplvm import GPLVM

    with open(path) as f:
        r = Reader(f.read())
    r.version()
    if r.field("baseType") != "dataModel" or r.field("type") != "gplvm":
        raise ValueError("not a gplvm model file")
    n_data = r.int_("numData")
    data_dim = r.int_("outputDim")
    latent_dim = r.int_("inputDim")
    latent_reg = r.bool_("latentRegularised")
    r.bool_("backConstrained")
    dyn = r.bool_("dynamicsLearnt")
    kern, kern_params = read_kern(r)
    dyn_kern, dyn_params = read_kern(r) if dyn else (None, None)
    _ntype, nparams, _, _ = read_noise(r)
    has_labels = "labels:1" in r.line()
    Y = np.zeros((n_data, data_dim))
    X = np.zeros((n_data, latent_dim))
    labels = [] if has_labels else None
    for i in range(n_data):
        toks = r.line().split()
        Y[i] = [float(t) for t in toks[:data_dim]]
        X[i] = [float(t) for t in toks[data_dim:data_dim + latent_dim]]
        if has_labels:
            labels.append(int(float(toks[data_dim + latent_dim])))
    # init="rand" skips PCA: theta, with the stored latents, is set below
    model = GPLVM(kern, Y, latent_dim=latent_dim, dyn_kern=dyn_kern,
                  dyn_kern_params=dyn_params, centre=False,
                  latent_regularised=latent_reg, init="rand", device=device)
    model.noise_bias = nparams[:data_dim]
    model.fixed_scales = nparams[data_dim:]
    model.theta = model.spec.pack(
        kern_params, X, dyn_params=dyn_params if (dyn and model.spec.dyn_kern_learnt) else None)
    return model, (np.asarray(labels) if has_labels else None)
