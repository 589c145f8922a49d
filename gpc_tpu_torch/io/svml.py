"""SVM-light data file reader/writer (the pure-Python reader).

Counterpart of gpc_tpu/io/svml.py::read_svml_py / write_svml: `label
idx:val idx:val ...` per line, 1-based feature indices, `#` starts a
comment, CR tolerated; feature count = max index seen, absent features 0.
The native reader comes later.
"""

from __future__ import annotations

import numpy as np


def read_svml(path):
    """Returns (X, y): X (N, maxdim) float64, y (N, 1) float64."""
    labels = []
    rows = []
    max_idx = 0
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip().rstrip("\r")
            if not line:
                continue
            toks = line.split()
            labels.append(float(toks[0]))
            feats = []
            for t in toks[1:]:
                i, v = t.split(":")
                i = int(i)
                max_idx = max(max_idx, i)
                feats.append((i, float(v)))
            rows.append(feats)
    N = len(labels)
    X = np.zeros((N, max_idx), dtype=np.float64)
    for r, feats in enumerate(rows):
        for i, v in feats:
            X[r, i - 1] = v
    y = np.asarray(labels, dtype=np.float64).reshape(N, 1)
    return X, y


def write_svml(path, X, y):
    X = np.asarray(X)
    y = np.asarray(y).reshape(-1)
    with open(path, "w") as f:
        for r in range(X.shape[0]):
            feats = " ".join(f"{j + 1}:{X[r, j]:.17g}" for j in range(X.shape[1])
                             if X[r, j] != 0.0)
            f.write(f"{y[r]:.17g} {feats}\n".rstrip() + "\n")
