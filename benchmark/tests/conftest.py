"""The benchmark's tests run on the CPU at small sizes: the harness's
folder and the checkout's root go on sys.path, as run.py puts them."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The cells at sizes a CPU test holds: the shapes cut, the kinds and the
# limits as committed.
SMALL = {"config": {"N": 256, "M": 16, "chunk": 64},
         "traffic": {"iterations": 6, "rows_max": 64, "pool_rows": 512, "rate": 40.0,
                     "sample": 8, "trace_seconds": 0.3}}
# The precision control's rounding grows with the sizes: at SMALL, TF32's
# error in DTC's posterior reads just under the limits, so its tests run
# at four times the rows.
CONTROL = {"config": {"N": 1024, "M": 64, "chunk": 256},
           "traffic": dict(SMALL["traffic"], rows_max=256, pool_rows=1024, sample=16)}
# An `ivm` cell at the size of tests/test_torch_ivm_reference.py: N above the
# active set's d, rounds of 6 and 3 SCG iterations; its control too.
IVM_SMALL = {"config": {"N": 128, "d": 16},
             "traffic": {"kern_iters": 6, "noise_iters": 3, "sample": 2}}


@pytest.fixture
def card():
    """Skips a test that needs a CUDA device where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the port on the card)")
