"""gpc_tpu_torch — the PyTorch / CUDA port of gpc_tpu for NVIDIA Hopper.

The JAX package `gpc_tpu` is the reference; this package keeps its module
names, parameter layouts and model-file format, and replaces every Pallas
kernel on its path with a CUDA C++ kernel written for sm_90a
(`gpc_tpu_torch/csrc/`, built with nvcc at first use and bound with ctypes).

Numbers follow the reference's split: float32 on the card, float64 on the
CPU (as gpc_tpu runs f32 on the TPU and x64 on the CPU).  Public entry
points take and return numpy arrays.
"""

__version__ = "0.1.0"

import torch

# Single-pass reduced-precision GEMMs (TF32 keeps ~3 decimal digits) break
# positive-definiteness in Cholesky-heavy GP algebra; the counterpart of
# gpc_tpu's default HIGH matmul precision (gpc_tpu/__init__.py:22-30).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The card when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def work_dtype(device) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def as_tensor(x, device) -> torch.Tensor:
    """numpy (or tensor) → tensor on `device` in its working dtype."""
    return torch.as_tensor(x).to(device=device, dtype=work_dtype(device))
