"""Global configuration for sparsematrix_tpu_torch.

Twin of ``sparsematrix_tpu/config.py`` without its pallas/jnp knob: which
path runs is decided by the device a tensor lies on (a CPU tensor takes
the plain PyTorch version, a CUDA tensor the hand-written kernel), never
by a switch.

TF32 is turned off for matrix products and convolutions: the reference
computes fp32 at ``Precision.HIGHEST`` (``kernels/spmm_pallas.py:53-61``),
and TF32 would keep only about three decimal digits.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# entry points and container constructors run on the card unless the
# caller asks for the CPU
DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` or the default device; raises when it names CUDA and no
    card is present (the code never moves to the CPU by itself)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
