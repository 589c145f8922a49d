"""Numerical constants shared with gpc_tpu/ndlutil.py (the slice's subset;
the erfcx log-Gaussian-CDF family comes with the IVM)."""

import math

LOGTWOPI = math.log(2.0 * math.pi)
HALFLOGTWOPI = 0.5 * LOGTWOPI
GRADCHANGE = 1e-6     # checkgrad's central-difference step (ndlutil.h)
