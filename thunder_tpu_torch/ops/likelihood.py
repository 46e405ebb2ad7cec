"""The likelihood as matmuls plus a streaming log-sum-exp epilogue —
and the host of kernel HK2 (``likelihood_block``).

Reference semantics (Optimiser.cpp:9187): with s = sigRcp,

    dvp[l,r,t] = A[l] + B[l,r] + C[l,r,t]
    A[l]       = sum_p s |dat|^2
    B[l,r]     = sum_p (s ctf^2)[l,p] |pri[r,p]|^2
    C[l,r,t]   = -2 Re sum_p (s ctf dat conj(tra_t))[l,p] conj(pri[r,p])

B and C are float32 ``torch.matmul`` products (TF32 off, see
device.py), exactly where the JAX package leaves them to XLA einsums
(thunder_tpu/ops/likelihood.py:73-78, :92-96).  The epilogue — block
max, baseline rescale, exp and the rotation / translation marginals —
is HK2.
"""

from __future__ import annotations

import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import REAL


def split_ri(z: torch.Tensor) -> torch.Tensor:
    """(..., p) complex -> (..., 2p) float32 [re | im]."""
    return torch.cat([z.real, z.imag], dim=-1).to(REAL)


def modulate(dat_w: torch.Tensor, tra: torch.Tensor) -> torch.Tensor:
    """X = dat_w * conj(tra) as [re | im]: dat_w (L, P) complex with tra
    (T, P) shared or (L, T, P) per image -> (L, T, 2P) float32."""
    return split_ri(dat_w[:, None, :] * tra.conj())


def block_terms(x_ri: torch.Tensor, sctf2: torch.Tensor, pri: torch.Tensor):
    """B (L, R) and C (L, R, T) for a rotation block shared by all
    images: x_ri (L, T, 2P) from :func:`modulate`, sctf2 (L, P), pri
    (R, P) complex.  C is a strided view of the (L, T, R) product."""
    n_l, n_t, n_q = x_ri.shape
    b = sctf2 @ (pri.abs() ** 2).T
    c = -2.0 * (x_ri.reshape(-1, n_q) @ split_ri(pri).T)        # (L*T, R)
    return b, c.reshape(n_l, n_t, -1).permute(0, 2, 1)


def local_terms(x_ri: torch.Tensor, sctf2: torch.Tensor, pri: torch.Tensor):
    """B (L, R) and C (L, R, T) over each image's own support: x_ri
    (L, T, 2P), pri (L, R, P) complex (batched matmuls over L)."""
    b = torch.bmm(pri.abs() ** 2, sctf2[..., None])[..., 0]
    c = -2.0 * torch.bmm(x_ri, split_ri(pri).transpose(1, 2))   # (L, T, R)
    return b, c.permute(0, 2, 1)


def log_dvp_block(dat_w, sctf2, pri, tra, a_term) -> torch.Tensor:
    """Full (L, R, T) log-likelihood of a shared rotation block."""
    b, c = block_terms(modulate(dat_w, tra[None]), sctf2, pri)
    return a_term[:, None, None] + b[:, :, None] + c


def log_dvp_local(dat_w, sctf2, pri, tra, a_term) -> torch.Tensor:
    """Full (L, R, T) log-likelihood over per-image supports."""
    b, c = local_terms(modulate(dat_w, tra), sctf2, pri)
    return a_term[:, None, None] + b[:, :, None] + c


# -- HK2 ----------------------------------------------------------------

def _rescale(acc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    s = scale.reshape(scale.shape + (1,) * (acc.ndim - 1))
    return torch.where(s == 0, torch.zeros_like(acc), acc * s)


def likelihood_block_plain(a, b, c, w_r, w_t, base, acc_c, acc_r, acc_t,
                           col0: int = 0) -> None:
    """Plain version of HK2; updates base, acc_c, acc_r, acc_t in place
    (see :func:`likelihood_block`)."""
    n_r = b.shape[1]
    dvp = a[:, None, None] + b[:, :, None] + c
    new_base = torch.maximum(base, torch.amax(dvp, dim=(1, 2)))
    scale = torch.where(torch.isfinite(base), torch.exp(base - new_base),
                        torch.zeros_like(base))
    w = torch.exp(dvp - new_base[:, None, None])
    u_r = torch.einsum("lrt,lt->lr", w, w_t)
    u_t = torch.einsum("lrt,lr->lt", w, w_r)
    acc_r[:, :col0] = _rescale(acc_r[:, :col0], scale)
    acc_r[:, col0:col0 + n_r] = _rescale(acc_r[:, col0:col0 + n_r], scale) + u_r
    acc_t.copy_(_rescale(acc_t, scale) + u_t)
    acc_c.copy_(_rescale(acc_c, scale) + torch.sum(w, dim=(1, 2)))
    base.copy_(new_base)


def likelihood_block(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     w_r: torch.Tensor, w_t: torch.Tensor, base: torch.Tensor,
                     acc_c: torch.Tensor, acc_r: torch.Tensor,
                     acc_t: torch.Tensor, col0: int = 0) -> None:
    """Streaming log-sum-exp over one (R x T) pose block per image, in
    place:

      dvp = a[l] + b[l, r] + c[l, r, t];  new = max(base, max dvp)
      scale = exp(base - new) (0 where base is -inf);  w = exp(dvp - new)
      acc_c[l]              = acc_c * scale + sum_{r,t} w
      acc_r[l, col0 + r]    = acc_r * scale + sum_t w w_t[l, t]
      acc_r[l, :col0]      *= scale
      acc_t[l, t]           = acc_t * scale + sum_r w w_r[l, r]
      base[l]               = new

    a (L,); b (L, R), c (L, R, T), w_r (L, R), w_t (L, T) with any
    strides (stride 0 shares a row); base, acc_c (L,) and acc_t (L, T)
    contiguous; acc_r (L, >= col0 + R) with unit column stride, zero in
    the columns of blocks not seen yet.  Where base is -inf the
    accumulators' old contents are ignored.  CPU
    tensors take :func:`likelihood_block_plain`; CUDA tensors launch
    csrc/likelihood_block.cu (one CTA per image, the block in shared
    memory)."""
    if not c.is_cuda:
        likelihood_block_plain(a, b, c, w_r, w_t, base, acc_c, acc_r, acc_t,
                               col0)
        return
    n_l, n_r, n_t = c.shape
    for name, t in (("a", a), ("b", b), ("c", c), ("w_r", w_r), ("w_t", w_t),
                    ("base", base), ("acc_c", acc_c), ("acc_r", acc_r),
                    ("acc_t", acc_t)):
        _native.require(t.dtype == REAL and t.is_cuda,
                        f"likelihood_block: {name} must be float32 on the card")
    _native.require(b.shape == (n_l, n_r) and w_r.shape == (n_l, n_r)
                    and w_t.shape == (n_l, n_t),
                    "likelihood_block: inconsistent shapes")
    _native.require(base.is_contiguous() and acc_c.is_contiguous()
                    and acc_t.is_contiguous() and acc_t.shape == (n_l, n_t)
                    and a.is_contiguous(),
                    "likelihood_block: a, base, acc_c, acc_t must be contiguous")
    _native.require(acc_r.stride(1) == 1 and acc_r.shape[1] >= col0 + n_r,
                    "likelihood_block: acc_r rows must be unit-stride")
    _native.require(4 * (n_r * n_t + 32) <= 227 * 1024,
                    "likelihood_block: R*T block exceeds shared memory")
    if n_l == 0:
        return
    lib = _native.library()
    likelihood_block.launches += 1
    _native.check(lib.thunder_likelihood_block(
        a.data_ptr(), b.data_ptr(), b.stride(0), b.stride(1),
        c.data_ptr(), c.stride(0), c.stride(1), c.stride(2),
        w_r.data_ptr(), w_r.stride(0), w_r.stride(1),
        w_t.data_ptr(), w_t.stride(0), w_t.stride(1),
        n_l, n_r, n_t, base.data_ptr(), acc_c.data_ptr(), acc_r.data_ptr(),
        acc_r.stride(0), int(col0), acc_t.data_ptr(),
        _native.stream_ptr(c)), "likelihood_block")


likelihood_block.launches = 0


def local_marginals(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    w_r: torch.Tensor, w_t: torch.Tensor):
    """u_r (L, R) and u_t (L, T) of one phase: per-image max over the
    support, exp, and the prior-weighted marginals (optimiser._phase_body
    lines 498-502)."""
    n_l, n_r, n_t = c.shape
    dev = c.device
    base = torch.full((n_l,), float("-inf"), dtype=REAL, device=dev)
    acc_c = torch.empty((n_l,), dtype=REAL, device=dev)
    u_r = torch.empty((n_l, n_r), dtype=REAL, device=dev)
    u_t = torch.empty((n_l, n_t), dtype=REAL, device=dev)
    likelihood_block(a, b, c, w_r, w_t, base, acc_c, u_r, u_t)
    return u_r, u_t
