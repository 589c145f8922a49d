"""Shared CLI machinery (counterpart of gpc_tpu/cli/common.py, the parts the
ported gp commands use): the argument cursor with `-v` verbosity and `-s`
seed, and unheaded matrix output."""

from __future__ import annotations

import time

import numpy as np


class ExitError(SystemExit):
    def __init__(self, msg):
        super().__init__(f"Error: {msg}")


class CommandLine:
    def __init__(self, argv):
        self.argv = list(argv)
        self.pos = 0
        self.verbosity = 2
        self.seed = int(time.time())

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

    def get_int(self):
        return int(self.next_value())

    def eat_global_flags(self):
        """Consume leading -v/-s flags before the command word (CClctrl)."""
        while self.is_flag():
            if self.current() in ("-v", "--verbosity"):
                self.verbosity = self.get_int()
                self.advance()
            elif self.current() in ("-s", "--seed"):
                self.seed = self.get_int()
                self.advance()
            else:
                break


def write_unheaded(path, M):
    """CMatrix::toUnheadedFile equivalent: rows of 17-digit scientific values."""
    M = np.atleast_2d(np.asarray(M))
    with open(path, "w") as f:
        for row in M:
            f.write(" ".join(f"{v:.17e}" for v in row) + "\n")
