"""Reference-compatible random number generation (MT19937 + Box-Muller).

The reference seeds a Mersenne Twister from the CLI `-s` flag
(ndlutil.cpp:266-281 init_genrand; CClctrl.cpp:8-10) and consumes it through
`ndlutil::rand()` = genrand_real3 (ndlutil.cpp:168-171), `ndlutil::randn()`
(polar Box-Muller with one stored deviate, ndlutil.cpp:172-196) and
`ndlutil::randpermTrunc` (draw-and-erase selection without replacement,
ndlutil.cpp:199-220).  Inducing-point initialization (CGp.cpp:273-284), random
latent inits and the IVM RANDOM criterion all consume this stream, so matching
the learned-model trajectory of the reference binaries bit-for-bit requires
reproducing the exact stream — `torch.randperm` cannot.  This module implements
the standard MT19937 algorithm (Matsumoto & Nishimura 2002, public domain) and
the reference's consumption conventions on top of it.

Only used for seed-compatible initialization; all device-side randomness in
performance paths stays with torch's generators.

A copy of gpc_tpu/utils/refrng.py (pure Python), so that the port picks the
same inducing inputs for the same seed.
"""

from __future__ import annotations

import math
from typing import List

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


class RefRng:
    """MT19937 stream with the reference's init_genrand seeding."""

    def __init__(self, seed: int):
        self.mt = [0] * _N
        self.mti = _N
        self._stored_randn = None
        seed &= _MASK32
        self.mt[0] = seed
        for i in range(1, _N):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i) & _MASK32

    def genrand_int32(self) -> int:
        mt = self.mt
        if self.mti >= _N:
            mag01 = (0, _MATRIX_A)
            for kk in range(_N - _M):
                y = (mt[kk] & _UPPER_MASK) | (mt[kk + 1] & _LOWER_MASK)
                mt[kk] = mt[kk + _M] ^ (y >> 1) ^ mag01[y & 1]
            for kk in range(_N - _M, _N - 1):
                y = (mt[kk] & _UPPER_MASK) | (mt[kk + 1] & _LOWER_MASK)
                mt[kk] = mt[kk + (_M - _N)] ^ (y >> 1) ^ mag01[y & 1]
            y = (mt[_N - 1] & _UPPER_MASK) | (mt[0] & _LOWER_MASK)
            mt[_N - 1] = mt[_M - 1] ^ (y >> 1) ^ mag01[y & 1]
            self.mti = 0
        y = mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _MASK32

    # -- reference consumption conventions ---------------------------------
    def rand(self) -> float:
        """genrand_real3: uniform on (0,1) (ndlutil.cpp:168-171)."""
        return (self.genrand_int32() + 0.5) * (1.0 / 4294967296.0)

    def _real1(self) -> float:
        """genrand_real1: uniform on [0,1]."""
        return self.genrand_int32() * (1.0 / 4294967295.0)

    def randn(self) -> float:
        """Polar Box-Muller with one stored deviate (ndlutil.cpp:172-196)."""
        if self._stored_randn is not None:
            v = self._stored_randn
            self._stored_randn = None
            return v
        while True:
            x1 = 2.0 * self._real1() - 1.0
            x2 = 2.0 * self._real1() - 1.0
            w = x1 * x1 + x2 * x2
            if w < 1.0:
                break
        w = math.sqrt(-2.0 * math.log(w) / w)
        self._stored_randn = x1 * w
        return x2 * w

    def get_state(self):
        """Serializable full generator state (mt vector, cursor, Box-Muller
        spare) — checkpoint/resume must capture it so a resumed run consumes
        the IDENTICAL stream the uninterrupted run would have (the reference
        has one process-global MT19937; models/ivm.py checkpoints this)."""
        import numpy as np
        stored = (float("nan") if self._stored_randn is None
                  else float(self._stored_randn))
        return (np.asarray(self.mt, dtype=np.uint64), int(self.mti), stored)

    def set_state(self, mt, mti: int, stored_randn: float):
        import math as _math
        self.mt = [int(v) for v in mt]
        self.mti = int(mti)
        self._stored_randn = (None if _math.isnan(stored_randn)
                              else float(stored_randn))

    def randperm_trunc(self, max_val: int, length: int) -> List[int]:
        """First `length` entries of a random permutation of range(max_val),
        by the reference's draw-and-erase scheme (ndlutil.cpp:199-215)."""
        indices = list(range(max_val))
        perm = []
        for _ in range(length):
            ind = int(self.rand() * len(indices))
            perm.append(indices.pop(ind))
        return perm

    def randperm(self, max_val: int) -> List[int]:
        return self.randperm_trunc(max_val, max_val)
