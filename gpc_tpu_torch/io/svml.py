"""SVM-light data file reader/writer.

Counterpart of gpc_tpu/io/svml.py: `label idx:val idx:val ...` per line,
1-based feature indices, `#` anywhere starts a comment, CR tolerated;
feature count = max index seen, absent features 0.  `read_svml` takes the
native reader (native/svml_reader.cpp, built with g++ at first use) and,
where that cannot be built, the pure-Python `read_svml_py`, as gpc_tpu does.
`READS` counts the runs of each ("native" or "python"), so a caller can
tell which one read its file.
"""

from __future__ import annotations

import collections

import numpy as np

READS: collections.Counter = collections.Counter()


def read_svml(path):
    """Returns (X, y): X (N, maxdim) float64, y (N, 1) float64."""
    from gpc_tpu_torch.native import svml_native
    out = svml_native.read(path)
    if out is not None:
        READS["native"] += 1
        return out
    READS["python"] += 1
    return read_svml_py(path)


def clean_line(line: str) -> str:
    """A line's content: the text before its first `#`, whitespace (CR
    included) trimmed.  The sharded loader (parallel/multihost.py) cleans
    with this too, so the two cannot differ on a line such as `2:3#c`."""
    return line.split("#", 1)[0].strip()


def parse_lines(lines, input_dim: int):
    """(X, y) of cleaned, non-empty lines at a known feature count."""
    X = np.zeros((len(lines), input_dim), dtype=np.float64)
    y = np.zeros((len(lines), 1), dtype=np.float64)
    for r, line in enumerate(lines):
        toks = line.split()
        y[r, 0] = float(toks[0])
        for t in toks[1:]:
            i, v = t.split(":")
            X[r, int(i) - 1] = float(v)
    return X, y


def read_svml_py(path):
    """The pure-Python reader: (X, y) as read_svml gives them."""
    lines = []
    max_idx = 0
    with open(path, "r") as f:
        for line in f:
            line = clean_line(line)
            if not line:
                continue
            lines.append(line)
            for t in line.split()[1:]:
                max_idx = max(max_idx, int(t.split(":")[0]))
    return parse_lines(lines, max_idx)


def write_svml(path, X, y):
    X = np.asarray(X)
    y = np.asarray(y).reshape(-1)
    with open(path, "w") as f:
        for r in range(X.shape[0]):
            feats = " ".join(f"{j + 1}:{X[r, j]:.17g}" for j in range(X.shape[1])
                             if X[r, j] != 0.0)
            f.write(f"{y[r]:.17g} {feats}\n".rstrip() + "\n")
