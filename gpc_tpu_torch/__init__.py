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
# gpc_tpu's GPC_TPU_MATMUL_PRECISION is not ported: it counts the TPU's bf16
# matrix-unit passes, and torch's same-named "high" means TF32, less precise
# than the TPU's three-pass bf16, so full float32 is fixed.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class NoDeviceError(RuntimeError):
    """The card was asked for (or defaulted to) and there is none."""


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the card.  The port's entry
    points run on the card unless the caller asks for the CPU, so with no
    card this raises rather than falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError("gpc_tpu_torch runs on a CUDA device by default and "
                            "none is available; pass device=\"cpu\" (CLI: "
                            "--device cpu) to run on the CPU")
    return dev


def work_dtype(device) -> torch.dtype:
    """float32 on CUDA, float64 on the CPU."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def as_tensor(x, device) -> torch.Tensor:
    """numpy (or tensor) → contiguous tensor on `device` in its working
    dtype (the kernels take row-major operands; loadmat's arrays, say, are
    column-major)."""
    return torch.as_tensor(x).to(device=device, dtype=work_dtype(device)).contiguous()
