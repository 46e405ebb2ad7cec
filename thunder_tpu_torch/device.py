"""Device and dtype policy for the port.

* Real tensors are float32, spectra complex64 (the reference and the
  JAX package both run single precision), with one exception.
* The balance loop of the gridding reconstruction (its W, T and FFT
  pair) runs in float64 / complex128 (``BALANCE_REAL``,
  ``BALANCE_COMPLEX``) and hands W back as float32; the JAX package's
  loop is float32.  Its stop reads max ||C| - 1| over every cell inside
  the radius, and where the round's insertion leaves cells empty |C|
  there is the FFT's rounding in float32, so the count at which a
  float32 loop stops, and the map, followed rounding.  A float32 loop
  run for the count the float64 loop stops at gives the float64 loop's
  run: the precision of the update does not matter, the stop's reading
  of empty cells does.
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
BALANCE_REAL = torch.float64
BALANCE_COMPLEX = torch.complex128

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


def draw(gen, kind: str, shape, device=None, high: int | None = None) -> torch.Tensor:
    """One random tensor of ``shape`` from ``gen``: "randn", "rand"
    (float32), "randint" (int64 in [0, high)) or "exponential" (float32,
    rate 1).  ``gen`` is a torch.Generator, or an object with
    ``draw(kind, shape, high)`` that draws for a rank's rows
    (particle.RowDraws)."""
    shape = tuple(shape)
    if not isinstance(gen, torch.Generator):
        return gen.draw(kind, shape, high)
    if kind == "randn":
        return torch.randn(shape, generator=gen, device=device, dtype=REAL)
    if kind == "rand":
        return torch.rand(shape, generator=gen, device=device, dtype=REAL)
    if kind == "randint":
        return torch.randint(0, high, shape, generator=gen, device=device)
    if kind == "exponential":
        return torch.empty(shape, dtype=REAL, device=device).exponential_(1, generator=gen)
    raise ValueError(f"no draw of kind {kind!r}")


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A seeded generator living on ``device`` (random tensors drawn
    with it are created there directly)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
