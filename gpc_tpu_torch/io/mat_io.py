"""MATLAB .mat model-file interop (counterpart of gpc_tpu/io/mat_io.py).

A GP model saves as the four variables GPmat and testGp.cpp use: `gpInfo`
(the CGp struct, CGp.cpp:1436-1485), `kern`, `noise` and the unconstrained
optimiser vector `params`, plus the data `X` and `y` when given, in the
layout gpc_tpu writes, so either package (or MATLAB GPmat) reads the
other's files:

  leaf kern   : type, inputDimension, nParams, isStationary, transforms
                (struct array of 1-based index + transform type), one named
                field per parameter (inputScales for ARD), degree (poly),
                index (position inside a compound).
  cmpnd/tensor: type, inputDimension, nParams, comp (1×k cell of
                children), whiteVariance.
  noise       : type, numProcess, numData, nParams, spherical, logconcave,
                missing, params, bias, sigma2 (gaussian, probit),
                gammaSplit (ncnm), numCategories (ordered).
  gpInfo      : type='gp', approx, learnScales, d, q, N, k, fixInducing,
                pitcBlock, scale, bias, and for a sparse model X_u, beta,
                betaTransform.

scipy.io is imported where a file is read or written.  `read_gp_mat` builds
the port's GP through its constructor, on `device` (None: the card), and
sets θ, the bias, the scales and the fixed inducing inputs as
interop/from_jax.py does.  Data-file .mat reading (`-f 1`) lives in
cli/common.load_data.
"""

from __future__ import annotations

import numpy as np
import torch

from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch import noise as NZ

# gpc_tpu's table of GPmat transform names by code (gpc_tpu/io/mat_io.py:35)
_TRANSFORM_NAMES = {0: "none", 1: "exp", 2: "negLogLogit", 3: "sigmoid", 4: "linear"}


def _transforms_struct(kern):
    """GPmat's `transforms` field: a struct array of (index, type) for every
    parameter with a non-linear transform, 1-based indices."""
    entries = [(i + 1, _TRANSFORM_NAMES[int(c)])
               for i, c in enumerate(np.asarray(kern.transform_codes())) if int(c) != 0]
    arr = np.zeros((1, len(entries)), dtype=[("index", object), ("type", object)])
    for j, (idx, name) in enumerate(entries):
        arr[0, j] = (float(idx), name)
    return arr


def _named_count(names):
    """The leading parameters with names of their own; ARD's input scales
    after them collapse into one `inputScales` vector."""
    return len([n for n in names if not n.startswith("inputScale")])


def kern_to_struct(kern: KM.Kern, params, index=None) -> dict:
    """The GPmat struct of `kern` at constrained `params`."""
    params = np.asarray(params, dtype=np.float64)
    if kern.kind in ("cmpnd", "tensor"):
        off = kern.offsets()
        comp = np.empty((1, len(kern.components)), dtype=object)
        for i, child in enumerate(kern.components):
            comp[0, i] = kern_to_struct(child, params[off[i]:off[i + 1]], index=i + 1)
        return {"type": kern.kind,
                "inputDimension": float(kern.input_dim),
                "nParams": float(kern.n_params),
                "comp": comp,
                "whiteVariance": float(kern.white(torch.as_tensor(params)))}
    s = {"type": kern.kind,
         "inputDimension": float(kern.input_dim),
         "nParams": float(kern.n_params),
         "isStationary": float(kern.stationary),
         "transforms": _transforms_struct(kern)}
    if kern.kind == "whitefixed":
        s["variance"] = float(kern.fixed_variance)
        return s
    names = kern.param_names()
    n_named = _named_count(names)
    for i, name in enumerate(names[:n_named]):
        s[name] = float(params[i])
    if n_named < len(names):
        s["inputScales"] = params[n_named:].reshape(1, -1)
    if kern.kind in ("poly", "polyard"):
        s["degree"] = float(kern.degree)
    if index is not None:
        s["index"] = float(index)
    return s


def _field(s, name, default=None):
    if s.dtype.names and name in s.dtype.names:
        return s[name][0, 0] if s.ndim == 2 else s[name]
    if default is not None:
        return default
    raise KeyError(name)


def _scalar(s, name, default=None) -> float:
    v = _field(s, name, default)
    if isinstance(v, (int, float)):
        return float(v)
    return float(np.asarray(v).ravel()[0])


def _string(s, name) -> str:
    return str(np.asarray(_field(s, name)).ravel()[0])


def kern_from_struct(s):
    """(kern, constrained params) of a GPmat kern struct (loadmat with
    squeeze_me=False)."""
    kind = _string(s, "type")
    input_dim = int(_scalar(s, "inputDimension"))
    if kind in ("cmpnd", "tensor"):
        comp = _field(s, "comp")
        children, child_params = [], []
        for i in range(comp.shape[-1]):
            c, cp = kern_from_struct(comp[0, i] if comp.ndim == 2 else comp[i])
            children.append(c)
            child_params.append(cp)
        kern = KM.make_kern(kind, input_dim, components=tuple(children))
        return kern, (np.concatenate(child_params) if child_params else np.zeros(0))
    if kind == "whitefixed":
        return (KM.WhiteFixed(input_dim=input_dim, fixed_variance=_scalar(s, "variance")),
                np.zeros(0))
    kwargs = {}
    if kind in ("poly", "polyard"):
        kwargs["degree"] = _scalar(s, "degree")
    kern = KM.make_kern(kind, input_dim, **kwargs)
    names = kern.param_names()
    n_named = _named_count(names)
    vals = [_scalar(s, n) for n in names[:n_named]]
    if n_named < len(names):
        vals.extend(np.asarray(_field(s, "inputScales")).ravel().tolist())
    return kern, np.asarray(vals, dtype=np.float64)


def noise_to_struct(noise_type: str, params, output_dim: int, n_data: int,
                    extra=None) -> dict:
    """The GPmat struct of a noise model (CNoise.cpp's field set)."""
    params = np.asarray(params, dtype=np.float64)
    nz = NZ.make_noise(noise_type, output_dim, **(extra or {}))
    s = {"type": noise_type,
         "numProcess": float(output_dim),
         "numData": float(n_data),
         "nParams": float(nz.n_params),
         "spherical": float(nz.spherical),
         "logconcave": float(nz.log_concave),
         "missing": float(nz.missing),
         "params": params.reshape(1, -1)}
    if noise_type in ("gaussian", "probit", "ncnm", "ordered", "scale"):
        s["bias"] = params[:output_dim].reshape(1, -1)
    if noise_type == "gaussian":
        s["sigma2"] = float(params[-1])
    elif noise_type == "probit":
        # probit's parameters are its biases; sigma2 is the fixed member the
        # reference writes apart (CNoise.cpp:181-189)
        s["sigma2"] = float(nz.sigma2_fixed)
    if noise_type == "ncnm":
        s["gammaSplit"] = float((extra or {}).get("split_gamma", 0))
    if noise_type == "ordered":
        s["numCategories"] = float((extra or {}).get("num_categories", 2))
    return s


def noise_from_struct(s):
    """(noise_type, params, extra) of a noise struct.  GPmat's own structs
    carry named fields (bias, sigma2) instead of the `params` vector this
    writer adds; a gaussian or probit struct without `params` is rebuilt
    from them."""
    ntype = _string(s, "type")
    try:
        params = np.asarray(_field(s, "params")).ravel().astype(np.float64)
    except KeyError:
        bias = np.asarray(_field(s, "bias")).ravel().astype(np.float64)
        if ntype == "gaussian":
            params = np.concatenate([bias, [float(_scalar(s, "sigma2"))]])
        elif ntype == "probit":
            params = bias
        else:
            raise ValueError(f"noise struct for {ntype!r} has no params vector and no "
                             f"known named-field reconstruction")
    extra = {}
    if ntype == "ncnm":
        extra["split_gamma"] = bool(int(_scalar(s, "gammaSplit", 0.0)))
    if ntype == "ordered":
        extra["num_categories"] = int(_scalar(s, "numCategories", 2.0))
    return ntype, params, extra


def write_gp_mat(path, model, X=None, y=None):
    """Save a GP model as gpInfo/kern/noise/params (and X, y when given)."""
    import scipy.io as sio

    spec = model.spec
    gp_info = {"type": "gp",
               "approx": spec.approx,
               "learnScales": float(spec.learn_scales),
               "d": float(spec.output_dim),
               "q": float(spec.input_dim),
               "N": float(spec.n_data),
               "k": float(spec.num_active),
               "fixInducing": float(spec.inducing_fixed),
               "pitcBlock": float(spec.pitc_block),
               "scale": np.asarray(model.scales(), dtype=np.float64).reshape(1, -1),
               "bias": np.asarray(model.bias, dtype=np.float64).reshape(1, -1)}
    if spec.sparse:
        gp_info["X_u"] = np.asarray(model.inducing(), dtype=np.float64)
        gp_info["beta"] = np.asarray([[float(model.beta())]])
        gp_info["betaTransform"] = "exp"
    noise_params = getattr(model, "noise_params", None)
    if noise_params is None:
        noise_params = np.concatenate([np.zeros(spec.output_dim), [1e-6]])
    data = {"gpInfo": gp_info,
            "kern": kern_to_struct(spec.kern, model.kern_params()),
            "noise": noise_to_struct(getattr(model, "noise_type", "gaussian"), noise_params,
                                     spec.output_dim, spec.n_data,
                                     getattr(model, "noise_extra", None)),
            "params": np.asarray(model.theta, dtype=np.float64).reshape(1, -1)}
    if X is not None:
        data["X"] = np.asarray(X, dtype=np.float64)
    if y is not None:
        data["y"] = np.asarray(y, dtype=np.float64)
    sio.savemat(path, data)


def read_gp_mat(path, X=None, y=None, device=None):
    """A port GP from a file write_gp_mat (or gpc_tpu's, or GPmat) wrote, on
    `device` (None: the card; "cpu" for the CPU).  X and y default to the
    file's; a file without data needs them given."""
    import scipy.io as sio

    from gpc_tpu_torch.models.gp import GP

    d = sio.loadmat(path, squeeze_me=False)
    gi = d["gpInfo"]
    kern, _ = kern_from_struct(d["kern"])
    ntype, nparams, nextra = noise_from_struct(d["noise"])
    inducing_fixed = bool(int(_scalar(gi, "fixInducing", 0.0)))
    Xd = X if X is not None else d.get("X")
    yd = y if y is not None else d.get("y")
    if Xd is None or yd is None:
        # a .mat model may come without data; refuse rather than build the
        # objective on zeros
        raise ValueError("read_gp_mat: the .mat file carries no X/y — pass X= and y=")
    model = GP(kern, np.asarray(Xd), np.asarray(yd), approx=_string(gi, "approx"),
               num_active=int(_scalar(gi, "k")),
               learn_scales=bool(int(_scalar(gi, "learnScales"))), centre=False,
               inducing_fixed=inducing_fixed, pitc_block=int(_scalar(gi, "pitcBlock", 0.0)),
               device=device)
    theta = np.asarray(d["params"], dtype=np.float64).ravel()
    if theta.shape[0] != model.spec.n_params():
        raise ValueError(f"read_gp_mat: params has {theta.shape[0]} entries, the model "
                         f"{model.spec.n_params()}")
    model.theta = theta
    model.bias = np.asarray(_field(gi, "bias"), dtype=np.float64).ravel()
    model.fixed_scales = np.asarray(_field(gi, "scale"), dtype=np.float64).ravel()
    if inducing_fixed:
        model.X_u_fixed = np.asarray(_field(gi, "X_u"), dtype=np.float64)
    model.noise_type = ntype
    model.noise_params = nparams
    model.noise_extra = nextra
    return model
