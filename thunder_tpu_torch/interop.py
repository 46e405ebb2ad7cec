"""Carry state from a thunder_tpu Optimiser into the port's.

:func:`snapshot` reads a JAX optimiser's state as numpy arrays (it only
calls ``np.asarray`` on its fields, so this module never imports jax);
:func:`restore` writes such a snapshot into a port Optimiser built on
the same images and configuration.  Tests use the pair to start both
packages from identical state; the ``.thu`` checkpoint stays the
on-disk format both read and write.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from thunder_tpu_torch import particle as pt

PAR_FIELDS = pt.ParticleState._fields


def snapshot(opt) -> dict:
    """Numpy copy of a (JAX or port) Optimiser's state:
    refs (2, K, N, N, N), every ParticleState field (2, L, ...), cls,
    sigma, offset, the image spectra and the ModelState fields."""
    f = lambda a: np.array(a.cpu() if torch.is_tensor(a) else a)
    s = opt.state
    snap = {"refs": f(s.refs), "cls": f(s.cls), "sigma": f(s.sigma),
            "offset": f(opt.offset), "ft_masked": f(opt.data.ft_masked),
            "ft_ori": f(opt.data.ft_ori)}
    for name in PAR_FIELDS:
        snap[f"par_{name}"] = f(getattr(s.par, name))
    snap["model"] = {fl.name: (np.array(getattr(opt.model, fl.name))
                               if fl.name == "fsc" else getattr(opt.model, fl.name))
                     for fl in dataclasses.fields(opt.model)}
    return snap


def restore(opt, snap: dict) -> None:
    """Load a snapshot into a port Optimiser (same images, same L),
    image spectra included (they carry the norm correction)."""
    dev = opt.device
    t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    s = opt.state
    opt.set_refs(t(snap["refs"], torch.float32).contiguous())
    s.cls = t(snap["cls"], torch.int64)
    s.sigma = t(snap["sigma"], torch.float32).contiguous()
    opt.offset = t(snap["offset"], torch.float32)
    s.par = pt.ParticleState(*[t(snap[f"par_{n}"], torch.float32)
                               for n in PAR_FIELDS])
    opt.data = opt.data._replace(
        ft_masked=t(snap["ft_masked"], torch.complex64).contiguous(),
        ft_ori=t(snap["ft_ori"], torch.complex64).contiguous())
    for name, val in snap["model"].items():
        setattr(opt.model, name, np.array(val) if name == "fsc" else val)

