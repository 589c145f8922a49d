"""Auxiliary mapping models: linear and one-hidden-layer MLP regression.

Counterpart of gpc_tpu/models/mltools.py (the reference's CMltools,
CMltools.h:34-209): CLinearMapping (y = Wᵀx + b) and CMlpMapping
(y = W2ᵀtanh(W1ᵀx + b1) + b2), both with a fixed Gaussian output variance
(= 1) and the reference's likelihood
L = −½[Σᵢ‖f(xᵢ)−yᵢ‖²/σ² + N·(log 2π + log σ²)] — log 2π times N, not N·D
(CMltools.cpp:229-246), a quirk kept for parity.  The parameter layouts are
getOptParams' (CMltools.cpp:88-147): [W1 col-major][b1][W2 col-major][b2];
linear: [W col-major][b].  The initial weights are gpc_tpu's:
np.random.RandomState(seed) normals scaled by 1/√(fan-in + 1).  Trained by
the port's SCG on the gradient autograd takes.  θ stays float64 numpy on
the host; the data live on `device` (None: the card, an error without one;
"cpu" for the CPU) in its working dtype, as in models/gp.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gpc_tpu_torch import as_tensor, ndlutil, resolve_device
from gpc_tpu_torch.optim import numpy_value_and_grad
from gpc_tpu_torch.optim.scg import scg


class _Base:
    """θ (float64 numpy), the objective nlml(θ tensor) and what uses it."""

    def __init__(self, X, y, device):
        self.X = np.asarray(X, np.float64)
        self.y = np.asarray(y, np.float64)
        self.input_dim, self.output_dim = self.X.shape[1], self.y.shape[1]
        self.variance = 1.0
        self.device = resolve_device(device)
        self._Xt = as_tensor(self.X, self.device)
        self._yt = as_tensor(self.y, self.device)

    def _forward(self, theta, Xin):
        raise NotImplementedError

    def _objective(self, theta):
        resid = self._forward(theta, self._Xt) - self._yt
        L = torch.sum(resid * resid) / self.variance
        L = L + self.X.shape[0] * (ndlutil.LOGTWOPI + np.log(self.variance))
        return 0.5 * L

    def log_likelihood(self) -> float:
        with torch.no_grad():
            return -float(self._objective(as_tensor(self.theta, self.device)))

    def out(self, Xin) -> np.ndarray:
        with torch.no_grad():
            f = self._forward(as_tensor(self.theta, self.device),
                              as_tensor(np.asarray(Xin, np.float64), self.device))
        return f.cpu().numpy().astype(np.float64)

    def optimise(self, iters: int = 1000):
        res = scg(numpy_value_and_grad(self._objective, self.device), self.theta,
                  max_iters=iters)
        self.theta = np.asarray(res.x, dtype=np.float64)
        return res

    def point_log_likelihood(self, y_out, Xin) -> np.ndarray:
        """Per-point Gaussian log density (CMltools.cpp:275-281)."""
        d2 = np.sum((self.out(Xin) - np.asarray(y_out)) ** 2, axis=1)
        return -0.5 * (d2 / self.variance + ndlutil.LOGTWOPI + np.log(self.variance))


class LinearMapping(_Base):
    """y = Wᵀx + b (CLinearMapping)."""

    def __init__(self, X, y, seed: Optional[int] = None, device=None):
        super().__init__(X, y, device)
        rng = np.random.RandomState(seed if seed is not None else 0)
        scale = np.sqrt(1.0 / (self.input_dim + 1))
        W = rng.randn(self.input_dim, self.output_dim) * scale
        b = rng.randn(1, self.output_dim) * scale
        self.theta = self.pack(W, b)

    def pack(self, W, b) -> np.ndarray:
        """[W col-major][b] (CLinearMapping::getOptParams)."""
        return np.concatenate([np.asarray(W).T.ravel(), np.asarray(b).ravel()])

    def unpack(self, theta):
        nw = self.input_dim * self.output_dim
        W = theta[:nw].reshape(self.output_dim, self.input_dim).T
        b = theta[nw:nw + self.output_dim][None, :]
        return W, b

    def _forward(self, theta, Xin):
        W, b = self.unpack(theta)
        return Xin @ W + b


class MlpMapping(_Base):
    """y = W2ᵀ·tanh(W1ᵀx + b1) + b2 (CMlpMapping)."""

    def __init__(self, X, y, hidden_dim: int, seed: Optional[int] = None, device=None):
        super().__init__(X, y, device)
        self.hidden_dim = hidden_dim
        rng = np.random.RandomState(seed if seed is not None else 0)
        s1 = np.sqrt(1.0 / (self.input_dim + 1))
        s2 = np.sqrt(1.0 / (hidden_dim + 1))
        W1 = rng.randn(self.input_dim, hidden_dim) * s1
        b1 = rng.randn(1, hidden_dim) * s1
        W2 = rng.randn(hidden_dim, self.output_dim) * s2
        b2 = rng.randn(1, self.output_dim) * s2
        self.theta = self.pack(W1, b1, W2, b2)

    def pack(self, W1, b1, W2, b2) -> np.ndarray:
        """[W1 col-major][b1][W2 col-major][b2] (CMlpMapping::getOptParams)."""
        return np.concatenate([np.asarray(W1).T.ravel(), np.asarray(b1).ravel(),
                               np.asarray(W2).T.ravel(), np.asarray(b2).ravel()])

    def unpack(self, theta):
        q, h, D = self.input_dim, self.hidden_dim, self.output_dim
        i = 0
        W1 = theta[i:i + q * h].reshape(h, q).T
        i += q * h
        b1 = theta[i:i + h][None, :]
        i += h
        W2 = theta[i:i + h * D].reshape(D, h).T
        i += h * D
        b2 = theta[i:i + D][None, :]
        return W1, b1, W2, b2

    def _forward(self, theta, Xin):
        W1, b1, W2, b2 = self.unpack(theta)
        return torch.tanh(Xin @ W1 + b1) @ W2 + b2
