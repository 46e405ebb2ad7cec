"""Device and dtype policy for the port.

* Real tensors are float32, spectra complex64 (the reference and the
  JAX package both run single precision).
* TF32 is OFF for matmuls and cuDNN: the likelihood contractions of
  the plain versions must keep full float32 accuracy so that the port
  agrees with the JAX package (which runs them at f32-class precision)
  and with the kernels.  Set once, at import of this module, which
  every module that touches a device imports.
* The device is the card unless the caller asks for the CPU; no entry
  point falls back to the CPU when no card is visible.
"""

from __future__ import annotations

import torch

REAL = torch.float32
COMPLEX = torch.complex64

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def as_device(device) -> torch.device:
    """``None`` or ``"auto"`` -> the first CUDA device; any other value
    as it is.  A CUDA device with no card visible raises rather than
    falling back to the CPU."""
    dev = torch.device("cuda:0" if device in (None, "auto") else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass device=\"cpu\" "
                           "(--device cpu on the command line) to run on the CPU")
    return dev


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
