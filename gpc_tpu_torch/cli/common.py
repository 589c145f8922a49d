"""Shared CLI machinery (counterpart of gpc_tpu/cli/common.py, the parts the
ported gp and ivm commands use): the argument cursor with `-v` verbosity,
`-s` seed and `--device cpu|cuda` (default: the card), data loading
(SVM-light, or under -f 1 a MATLAB .mat file), the kernel-spec grammar of
`learn` (gp.cpp:150-250) with ivm's default kernel and variance priors and
gplvm's usage axis (the latent kernel, -c back constraints, -D dynamics),
and unheaded matrix output."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from gpc_tpu_torch import kernels as KM
from gpc_tpu_torch.io.svml import read_svml


class ExitError(SystemExit):
    def __init__(self, msg):
        super().__init__(f"Error: {msg}")


class CommandLine:
    def __init__(self, argv):
        self.argv = list(argv)
        self.pos = 0
        self.verbosity = 2
        self.seed = int(time.time())
        self.file_format = 0
        self.device = "cuda"

    def current(self):
        if self.pos >= len(self.argv):
            raise ExitError("There are not enough input parameters.")
        return self.argv[self.pos]

    def advance(self):
        self.pos += 1

    def next_value(self):
        self.advance()
        return self.current()

    def has_more(self):
        return self.pos < len(self.argv)

    def is_flag(self):
        return self.has_more() and self.current().startswith("-")

    def get_bool(self):
        v = self.next_value()
        if v in ("1", "true", "True"):
            return True
        if v in ("0", "false", "False"):
            return False
        raise ExitError(f"Current argument {v} is not boolean.")

    def get_int(self):
        return int(self.next_value())

    def get_double(self):
        return float(self.next_value())

    def get_string(self):
        return self.next_value()

    def eat_global_flags(self):
        """Consume leading -v/-s/--device flags before the command word."""
        while self.is_flag():
            if self.current() in ("-v", "--verbosity"):
                self.verbosity = self.get_int()
            elif self.current() in ("-s", "--seed"):
                self.seed = self.get_int()
            elif self.current() == "--device":
                self.device = self.get_string()
                if self.device not in ("cpu", "cuda"):
                    raise ExitError(f"Unknown device {self.device} (want cpu or cuda).")
            else:
                break
            self.advance()


class KernelSpecParser:
    """Accumulates -k/-g/-@/-d/-w/-b/-v/-i kernel specs (gp.cpp:150-250) for
    every leaf type of the gp CLI, with gpc_tpu's checks and messages;
    `build` assembles the compound kernel and appends bias + white
    (gp.cpp:346-349).  -i 1 selects the ARD form (linard, polyard, rbfard,
    mlpard); exp, ratquad and the materns have none.  Each leaf carries a
    usage, "fwd" (the model's kernel), "back" (gplvm -c) or "dyn" (gplvm
    -D); `build` assembles one usage, and takes bias and white leaves under
    the other two."""

    def __init__(self):
        self.types = []
        self.usage = []            # 'fwd' | 'back' | 'dyn'
        self.ratquad_alphas = []
        self.inv_widths = []
        self.weight_vars = []
        self.bias_vars = []
        self.variances = []
        self.degrees = []
        self.select_inputs = []

    def _check_last(self, what, allowed):
        if not self.types:
            raise ExitError(f"{what} specification must come after covariance "
                            f"function type is specified.")
        if allowed is not None and self.types[-1] not in allowed:
            raise ExitError(f"{what} parameter not valid for {self.types[-1]} "
                            f"covariance function.")

    def add_type(self, kern_type: str, usage: str = "fwd"):
        """Append a leaf of `usage` with unset (-1.0) per-kernel parameters."""
        self.types.append(kern_type)
        self.usage.append(usage)
        for lst in (self.ratquad_alphas, self.inv_widths, self.weight_vars,
                    self.bias_vars, self.variances, self.degrees):
            lst.append(-1.0)
        self.select_inputs.append(False)

    def handle(self, cl: CommandLine, usage: str = "fwd") -> bool:
        """Try to consume the current flag; returns True if consumed.  A -k
        leaf takes `usage`."""
        arg = cl.current()
        if arg in ("-k", "--kernel"):
            self.add_type(cl.get_string(), usage)
        elif arg in ("-g", "--gamma"):
            self._check_last("Inverse width", ("rbf", "exp", "ratquad"))
            self.inv_widths[-1] = 2 * cl.get_double()   # stores 2γ (gp.cpp:168)
        elif arg in ("-@", "--alpha"):
            self._check_last("Alpha", ("ratquad",))
            self.ratquad_alphas[-1] = cl.get_double()
        elif arg in ("-d", "--degree"):
            self._check_last("Polynomial degree", ("poly",))
            self.degrees[-1] = cl.get_double()
        elif arg in ("-w", "--weight"):
            self._check_last("`Weight variance'", ("poly", "mlp"))
            self.weight_vars[-1] = cl.get_double()
        elif arg in ("-b", "--bias"):
            self._check_last("`Bias variance'", ("poly", "mlp"))
            self.bias_vars[-1] = cl.get_double()
        elif arg in ("-v", "--variance"):
            self._check_last("Variance", None)
            self.variances[-1] = cl.get_double()
        elif arg in ("-i", "--input-select"):
            self._check_last("Input selection flag", None)
            self.select_inputs[-1] = cl.get_bool()
        else:
            return False
        cl.advance()
        return True

    def _leaf(self, i: int, input_dim: int, usage: str):
        """(kernel, constrained params) of the i-th spec, built for `usage`."""
        t, sel = self.types[i], self.select_inputs[i]
        wbv = (self.weight_vars[i], self.bias_vars[i], self.variances[i])
        if t == "lin":
            k = KM.Linard(input_dim=input_dim) if sel else KM.Lin(input_dim=input_dim)
            p = k.default_params()
            if self.variances[i] != -1.0:
                p[0] = self.variances[i]
            return k, p
        if t in ("poly", "mlp"):
            if t == "poly":
                deg = self.degrees[i] if self.degrees[i] != -1.0 else 2.0
                k = (KM.Polyard(input_dim=input_dim, degree=deg) if sel
                     else KM.Poly(input_dim=input_dim, degree=deg))
            else:
                k = KM.Mlpard(input_dim=input_dim) if sel else KM.Mlp(input_dim=input_dim)
            p = k.default_params()
            for j, v in enumerate(wbv):
                if v != -1.0:
                    p[j] = v
            return k, p
        if t == "rbf":
            k = KM.Rbfard(input_dim=input_dim) if sel else KM.Rbf(input_dim=input_dim)
            p = k.default_params()
            if self.inv_widths[i] != -1.0:
                p[0] = self.inv_widths[i]
            if self.variances[i] != -1.0:
                p[1] = self.variances[i]
            return k, p
        if t == "exp":
            if sel:
                raise ExitError("Exponential covariance function not available "
                                "with input selection yet.")
            k = KM.Exp(input_dim=input_dim)
            p = k.default_params()
            if self.inv_widths[i] != -1.0:
                p[0] = self.inv_widths[i]
            if self.variances[i] != -1.0:
                p[1] = self.variances[i]
            return k, p
        if t == "ratquad":
            if sel:
                raise ExitError("Rational quadratic covariance function not "
                                "available with input selection yet.")
            k = KM.RatQuad(input_dim=input_dim)
            p = k.default_params()
            if self.ratquad_alphas[i] != -1.0:
                p[0] = self.ratquad_alphas[i]
            if self.inv_widths[i] != -1.0:
                p[1] = 1.0 / np.sqrt(self.inv_widths[i])   # gp.cpp:296
            if self.variances[i] != -1.0:
                p[2] = self.variances[i]
            return k, p
        if t in ("matern32", "matern52"):
            # beyond the reference CLI grammar, as in gpc_tpu
            if sel:
                raise ExitError(f"{t} covariance function not available with "
                                f"input selection yet.")
            k = (KM.Matern32(input_dim=input_dim) if t == "matern32"
                 else KM.Matern52(input_dim=input_dim))
            p = k.default_params()
            if self.variances[i] != -1.0:
                p[1] = self.variances[i]
            return k, p
        if t in ("bias", "white") and usage != "fwd":
            k = KM.Bias(input_dim=input_dim) if t == "bias" else KM.White(input_dim=input_dim)
            p = k.default_params()
            if self.variances[i] != -1.0:
                p[0] = self.variances[i]
            return k, p
        raise ExitError(f"Unknown covariance function type: {t}")

    # per-kind index of the variance parameter, for NCNM's gamma priors
    # (ivm.cpp:516-616; ratquad's index 1, its lengthScale, replicates the
    # reference literally)
    _VAR_PRIOR_INDEX = {"lin": 0, "linard": 0, "poly": 2, "polyard": 2,
                        "rbf": 1, "rbfard": 1, "ratquad": 1, "mlp": 2,
                        "mlpard": 2, "bias": 0, "white": 0}

    def build(self, input_dim: int, default_type="rbf", add_bias_white=True,
              variance_prior=None, usage: str = "fwd"):
        """(cmpnd kernel, constrained params) (gp.cpp:240-349): the leaves of
        `usage` as given (`default_type` at its defaults when none: rbf for
        gp and gplvm, lin for ivm, None for none), then bias and white at
        their defaults.  `variance_prior`, a
        Prior, attaches to each component's variance (the NCNM regularizer,
        ivm.cpp:422-425, 516-616)."""
        def with_prior(k, kind):
            if variance_prior is None or kind not in self._VAR_PRIOR_INDEX:
                return k
            return k.with_priors([dataclasses.replace(
                variance_prior, index=self._VAR_PRIOR_INDEX[kind])])

        leaves = []
        for i, t in enumerate(self.types):
            if self.usage[i] != usage:
                continue
            k, p = self._leaf(i, input_dim, usage)
            leaves.append((k if t == "exp" else with_prior(k, t), p))
        if not leaves and default_type is not None:
            k = KM.make_kern(default_type, input_dim)
            leaves.append((with_prior(k, default_type), k.default_params()))
        if add_bias_white:
            for k in (KM.Bias(input_dim=input_dim), KM.White(input_dim=input_dim)):
                leaves.append((with_prior(k, k.kind), k.default_params()))
        kern = KM.Cmpnd(input_dim=input_dim, components=tuple(k for k, _ in leaves))
        return kern, np.concatenate([p for _, p in leaves]) if leaves else np.zeros(0)


def load_data(path, file_format: int = 0):
    """CClctrl::readData (CClctrl.cpp:173-199): format 0 is SVM-light,
    format 1 a MATLAB .mat file with variables X and y (read with
    scipy.io, so GPmat's data files load; a vector y becomes (N, 1))."""
    if file_format == 0:
        return read_svml(path)
    if file_format == 1:
        import scipy.io
        try:
            mat = scipy.io.loadmat(path)
        except Exception as e:  # noqa: BLE001 - any unreadable file is the CLI's error
            raise ExitError(f"Unable to read MATLAB file {path}: {e}")
        missing = [k for k in ("X", "y") if k not in mat]
        if missing:
            raise ExitError(f"MATLAB file {path} lacks variable(s): " + ", ".join(missing))
        X = np.atleast_2d(np.asarray(mat["X"], dtype=np.float64))
        y = np.asarray(mat["y"], dtype=np.float64)
        # a vector y (1-D in the writer, which loadmat returns as one row)
        # is one target a row
        if y.ndim == 1 or (y.shape[0] == 1 and y.shape[1] == X.shape[0] > 1):
            y = y.reshape(-1, 1)
        # loadmat's arrays are column-major; row-major ones compute as
        # format 0's do, bit for bit
        return np.ascontiguousarray(X), np.ascontiguousarray(y)
    raise ExitError("Unrecognised file format number.")


def write_unheaded(path, M, comment=None):
    """CMatrix::toUnheadedFile equivalent: rows of 17-digit scientific
    values, after a `# comment` line when one is given."""
    M = np.atleast_2d(np.asarray(M))
    with open(path, "w") as f:
        if comment:
            f.write(f"# {comment}\n")
        for row in M:
            f.write(" ".join(f"{v:.17e}" for v in row) + "\n")
