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
    sigma, offset, the image spectra and the ModelState fields.  Host-
    resident originals (either package's HostFt) give their stored
    spectra and ``ft_ori_scale``, their per-image scale."""
    f = lambda a: np.array(a.cpu() if torch.is_tensor(a) else a)
    s = opt.state
    ft_ori = opt.data.ft_ori
    snap = {"refs": f(s.refs), "cls": f(s.cls), "sigma": f(s.sigma),
            "offset": f(opt.offset), "ft_masked": f(opt.data.ft_masked)}
    if hasattr(ft_ori, "scale"):
        snap["ft_ori"], snap["ft_ori_scale"] = f(ft_ori.data), f(ft_ori.scale)
    else:
        snap["ft_ori"] = f(ft_ori)
    for name in PAR_FIELDS:
        snap[f"par_{name}"] = f(getattr(s.par, name))
    snap["model"] = {fl.name: (np.array(getattr(opt.model, fl.name))
                               if fl.name == "fsc" else getattr(opt.model, fl.name))
                     for fl in dataclasses.fields(opt.model)}
    return snap


def restore(opt, snap: dict) -> None:
    """Load a snapshot into a port Optimiser (same images, same L),
    image spectra included (they carry the norm correction): into the
    port's HostFt as they were stored, with their scale, where it has
    one; the spectra times their scale where it has none.  Every tensor
    is a copy: the optimiser updates its stacks in place, and the
    snapshot stays as it was."""
    dev = opt.device
    t = lambda a, dt=None: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    s = opt.state
    opt.set_refs(t(snap["refs"], torch.float32).contiguous())
    s.cls = t(snap["cls"], torch.int64)
    s.sigma = t(snap["sigma"], torch.float32).contiguous()
    opt.offset = t(snap["offset"], torch.float32)
    s.par = pt.ParticleState(*[t(snap[f"par_{n}"], torch.float32)
                               for n in PAR_FIELDS])
    opt.data = opt.data._replace(
        ft_masked=t(snap["ft_masked"], torch.complex64).contiguous())
    ori = np.asarray(snap["ft_ori"], np.complex64)
    scale = snap.get("ft_ori_scale")
    if hasattr(opt.data.ft_ori, "scale"):
        opt.data.ft_ori.data.copy_(torch.as_tensor(ori))
        opt.data.ft_ori.scale.copy_(t(np.ones(ori.shape[:2], np.float32) if scale is None
                                      else scale, torch.float32))
    else:
        if scale is not None:
            ori = ori * np.asarray(scale, np.float32)[:, :, None, None]
        opt.data = opt.data._replace(ft_ori=t(ori, torch.complex64).contiguous())
    for name, val in snap["model"].items():
        setattr(opt.model, name, np.array(val) if name == "fsc" else val)

