"""Device and dtype policy for the port.

* Real tensors are float32, spectra complex64 (the reference and the
  JAX package both run single precision).
* TF32 is OFF for matmuls and cuDNN: the likelihood contractions must
  keep full float32 accuracy so that the port agrees with the JAX
  package (which runs them at f32-class precision) and with the CPU
  plain versions.  Set once, at import of this module, which every
  module that touches a device imports.
"""

from __future__ import annotations

import torch

REAL = torch.float32
COMPLEX = torch.complex64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The first CUDA device when one is visible, else the CPU."""
    return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")


def as_device(device) -> torch.device:
    if device is None or device == "auto":
        return default_device()
    return torch.device(device)


def is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A seeded generator living on ``device`` (random tensors drawn
    with it are created there directly)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
