"""Shared CLI machinery (counterpart of gpc_tpu/cli/common.py, the parts the
ported gp commands use): the argument cursor with `-v` verbosity, `-s` seed
and `--device cpu|cuda` (default: the card), SVM-light data loading, the
kernel-spec grammar of `learn` (gp.cpp:150-250) for the ported kernels, and
unheaded matrix output."""

from __future__ import annotations

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


def not_ported(what: str, item: str):
    return ExitError(f"{what} is not yet ported to gpc_tpu_torch "
                     f"(ROADMAP.md, {item})")


class KernelSpecParser:
    """Accumulates -k/-g/-v/-i kernel specs (gp.cpp:150-250) for the ported
    kernel, rbf; `build` appends bias + white (gp.cpp:346-349).  The other
    kernel types and flags are recognised and refused as not yet ported."""

    PORTED = ("rbf",)
    KNOWN = ("lin", "poly", "rbf", "exp", "ratquad", "mlp", "matern32", "matern52")
    UNPORTED_FLAGS = {"-@": "Alpha", "--alpha": "Alpha",
                      "-d": "Polynomial degree", "--degree": "Polynomial degree",
                      "-w": "`Weight variance'", "--weight": "`Weight variance'",
                      "-b": "`Bias variance'", "--bias": "`Bias variance'"}

    def __init__(self):
        self.types = []
        self.inv_widths = []
        self.variances = []

    def _check_last(self, what):
        if not self.types:
            raise ExitError(f"{what} specification must come after covariance "
                            f"function type is specified.")

    def handle(self, cl: CommandLine) -> bool:
        """Try to consume the current flag; returns True if consumed."""
        arg = cl.current()
        if arg in ("-k", "--kernel"):
            kind = cl.get_string()
            if kind not in self.KNOWN:
                raise ExitError(f"Unknown covariance function type: {kind}")
            if kind not in self.PORTED:
                raise not_ported(f"covariance function {kind}", "queue 1 item 2")
            self.types.append(kind)
            self.inv_widths.append(-1.0)
            self.variances.append(-1.0)
        elif arg in ("-g", "--gamma"):
            self._check_last("Inverse width")
            self.inv_widths[-1] = 2 * cl.get_double()   # stores 2γ (gp.cpp:168)
        elif arg in ("-v", "--variance"):
            self._check_last("Variance")
            self.variances[-1] = cl.get_double()
        elif arg in ("-i", "--input-select"):
            self._check_last("Input selection flag")
            if cl.get_bool():
                raise not_ported("input selection (-i 1, rbfard)", "queue 1 item 2")
        elif arg in self.UNPORTED_FLAGS:
            raise not_ported(f"{self.UNPORTED_FLAGS[arg]} ({arg}, for the "
                             f"ratquad/poly/mlp kernels)", "queue 1 item 2")
        else:
            return False
        cl.advance()
        return True

    def build(self, input_dim: int):
        """(cmpnd kernel, constrained params): the rbf leaves as given (the
        default rbf when none), then bias and white at their defaults."""
        comps, params = [], []
        for inv_width, variance in zip(self.inv_widths, self.variances):
            k = KM.Rbf(input_dim=input_dim)
            p = k.default_params()
            if inv_width != -1.0:
                p[0] = inv_width
            if variance != -1.0:
                p[1] = variance
            comps.append(k)
            params.append(p)
        if not comps:
            k = KM.Rbf(input_dim=input_dim)
            comps.append(k)
            params.append(k.default_params())
        for k in (KM.Bias(input_dim=input_dim), KM.White(input_dim=input_dim)):
            comps.append(k)
            params.append(k.default_params())
        return KM.Cmpnd(input_dim=input_dim, components=tuple(comps)), np.concatenate(params)


def load_data(path, file_format: int = 0):
    """CClctrl::readData (CClctrl.cpp:173-199): format 0 is SVM-light."""
    if file_format == 0:
        return read_svml(path)
    if file_format == 1:
        raise not_ported("file format 1 (MATLAB .mat)", "queue 1 item 11")
    raise ExitError("Unrecognised file format number.")


def write_unheaded(path, M):
    """CMatrix::toUnheadedFile equivalent: rows of 17-digit scientific values."""
    M = np.atleast_2d(np.asarray(M))
    with open(path, "w") as f:
        for row in M:
            f.write(" ".join(f"{v:.17e}" for v in row) + "\n")
