"""The likelihood of a pose block and its streaming log-sum-exp — the
host of kernel HK2 (``likelihood_block``).

Reference semantics (Optimiser.cpp:9187): with s = sigRcp,

    dvp[l,r,t] = A[l] + B[l,r] + C[l,r,t]
    A[l]       = sum_p s |dat|^2
    B[l,r]     = sum_p (s ctf^2)[l,p] |pri[r,p]|^2
    C[l,r,t]   = -2 Re sum_p (s ctf dat conj(tra_t))[l,p] conj(pri[r,p])

CTF search adds a defocus axis: dvp[l,d,r,t] with the CTF of each
defocus factor inside B and C (HK8, ``likelihood_local_ctf``).

On the card HK2 computes B, C and the epilogue (block max, baseline
rescale, exp, the rotation / translation marginals) in one kernel, all
classes of a rotation block in one launch.  Its plain version, the CPU
path, forms B and C as float32 ``torch.matmul`` products (TF32 off, see
device.py), where the JAX package leaves them to XLA einsums
(thunder_tpu/ops/likelihood.py:73-78, :92-96), then the epilogue.
"""

from __future__ import annotations

import ctypes

import torch

from thunder_tpu_torch import _native
from thunder_tpu_torch.device import COMPLEX, REAL
from thunder_tpu_torch.physics.ctf import (CtfParams, ctf_constants,
                                           ctf_packed_scaled)


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


def lse_block(a, b, c, w_r, w_t, base, acc_c, acc_r, acc_t, col0: int = 0) -> None:
    """The streaming log-sum-exp epilogue of one class, in place, from
    B (L, R) and C (L, R, T) (see :func:`likelihood_block`)."""
    n_r = b.shape[1]
    dvp = a[:, None, None] + b[:, :, None] + c
    new_base = torch.maximum(base, torch.amax(dvp, dim=(1, 2)))
    scale = torch.where(torch.isfinite(base), torch.exp(base - new_base),
                        torch.zeros_like(base))
    w = torch.exp(dvp - new_base[:, None, None])
    u_r = torch.einsum("lrt,lt->lr", w, w_t)
    u_t = torch.einsum("lrt,lr->lt", w, w_r)
    acc_r[:, :col0] = _rescale(acc_r[:, :col0], scale)
    acc_r[:, col0:col0 + n_r] = u_r
    acc_t.copy_(_rescale(acc_t, scale) + u_t)
    acc_c.copy_(_rescale(acc_c, scale) + torch.sum(w, dim=(1, 2)))
    base.copy_(new_base)


def likelihood_block_plain(dat_w, sctf2, a, pri, tra, w_r, w_t, base, acc_c,
                           acc_r, acc_t, col0: int = 0) -> None:
    """Plain version of HK2, in place (see :func:`likelihood_block`): per
    class, B and C as float32 matmuls (:func:`block_terms` where the
    class's rotation block is shared by all images, else
    :func:`local_terms`), then :func:`lse_block`."""
    x_ri = modulate(dat_w, tra)
    shared = pri.shape[1] == 1 or pri.stride(1) == 0
    for k in range(pri.shape[0]):
        b, c = (block_terms(x_ri, sctf2, pri[k, 0]) if shared
                else local_terms(x_ri, sctf2, pri[k]))
        lse_block(a, b, c, w_r, w_t, base[k], acc_c[k], acc_r[k], acc_t[k], col0)


LK_QC = _native.csrc_constant("likelihood_block.cu", "QC")       # pixels per staged chunk
LK_THREADS = _native.csrc_constant("likelihood_block.cu", "MAX_THREADS")
LK_TILES = ((1, 1), (2, 2), (2, 4), (4, 4), (4, 8), (8, 8))


def likelihood_plan(n_r: int, n_t: int) -> dict:
    """Launch plan of HK2 for an (R x T) block: the smallest register
    tile (TM translations x TN rotations) whose tiles, one a thread,
    cover the block in a CTA of at most LK_THREADS threads; where even 8
    x 8 tiles do not, the CTA takes the rotations in ``n_sub``
    sub-blocks of ``rb`` (``n_rt`` TN) rotations.  Also the thread count
    and the shared-memory bytes (B, a reduction scratch, two staging
    buffers of LK_QC pixels that the epilogue's partial sums then
    reuse).  Raises for more than LK_THREADS tiles of 8 translations."""
    for tm, tn in LK_TILES:
        n_tt, n_rt = -(-n_t // tm), -(-n_r // tn)
        if n_tt * n_rt <= LK_THREADS:
            break
    else:
        if n_tt > LK_THREADS:
            raise ValueError(f"likelihood_block: {n_t} translations exceed "
                             f"{LK_THREADS} tiles of 8")
        n_sub = -(-n_rt // (LK_THREADS // n_tt))
        n_rt = -(-n_rt // n_sub)
    rp, tp = n_rt * tn, n_tt * tm
    stage = 2 * 8 * (LK_QC * (rp + tp) + LK_QC + LK_QC // 2)
    partial = 4 * (n_tt * rp + n_rt * tp)
    return dict(tm=tm, tn=tn, n_tt=n_tt, n_rt=n_rt, rb=rp, n_sub=-(-n_r // rp),
                threads=-(-n_tt * n_rt // 32) * 32,
                smem=4 * (-(-rp // 4) * 4 + 32) + max(stage, partial))


class _LkArgs(ctypes.Structure):
    """csrc/likelihood_block.cu's LkArgs."""
    _fields_ = [
        ("dat_w", ctypes.c_void_p), ("dw_sl", ctypes.c_longlong),
        ("sctf2", ctypes.c_void_p), ("s2_sl", ctypes.c_longlong),
        ("a", ctypes.c_void_p),
        ("pri", ctypes.c_void_p), ("pri_sk", ctypes.c_longlong),
        ("pri_sl", ctypes.c_longlong), ("pri_sr", ctypes.c_longlong),
        ("tra", ctypes.c_void_p), ("tra_sl", ctypes.c_longlong),
        ("tra_st", ctypes.c_longlong),
        ("w_r", ctypes.c_void_p), ("wr_sl", ctypes.c_longlong),
        ("wr_sr", ctypes.c_longlong),
        ("w_t", ctypes.c_void_p), ("wt_sl", ctypes.c_longlong),
        ("wt_st", ctypes.c_longlong),
        ("base", ctypes.c_void_p), ("acc_c", ctypes.c_void_p),
        ("st_sk", ctypes.c_longlong), ("st_sl", ctypes.c_longlong),
        ("acc_r", ctypes.c_void_p), ("accr_sk", ctypes.c_longlong),
        ("accr_sl", ctypes.c_longlong),
        ("acc_t", ctypes.c_void_p), ("acct_sk", ctypes.c_longlong),
        ("acct_sl", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in ("L", "K", "R", "T", "P", "col0", "n_tt",
                                    "n_rt")]


def likelihood_block(dat_w: torch.Tensor, sctf2: torch.Tensor, a: torch.Tensor,
                     pri: torch.Tensor, tra: torch.Tensor, w_r: torch.Tensor,
                     w_t: torch.Tensor, base: torch.Tensor, acc_c: torch.Tensor,
                     acc_r: torch.Tensor, acc_t: torch.Tensor,
                     col0: int = 0) -> None:
    """Streaming log-sum-exp over one (R x T) pose block per image and
    class, likelihood included, in place:

      B[k,l,r]   = sum_p sctf2[l,p] |pri[k,l,r,p]|^2
      C[k,l,r,t] = -2 Re sum_p dat_w[l,p] conj(tra[l,t,p]) conj(pri[k,l,r,p])
      dvp = a[l] + B + C;  new = max(base[k,l], max dvp)
      scale = exp(base - new) (0 where base is -inf);  w = exp(dvp - new)
      acc_c[k,l]           = acc_c * scale + sum_{r,t} w
      acc_r[k,l,col0 + r]  = sum_t w w_t[l,t]
      acc_r[k,l,:col0]    *= scale
      acc_t[k,l,t]         = acc_t * scale + sum_r w w_r[l,r]
      base[k,l]            = new

    dat_w (L, P) complex64 and sctf2 (L, P) with unit pixel stride; a
    (L,); pri (K, L, R, P) complex64 (image stride 0: one rotation block
    per class shared by all images); tra (L, T, P) complex64 (image
    stride 0: shared translations); w_r (L, R) and w_t (L, T) with any
    strides; base and acc_c (K, L) with equal strides, acc_r (K, L,
    >= col0 + R) with unit column stride, acc_t (K, L, T).  Where base is -inf the
    accumulators' old contents are ignored.  CPU tensors take
    :func:`likelihood_block_plain`; CUDA tensors launch
    csrc/likelihood_block.cu, one launch for all K classes."""
    if not dat_w.is_cuda:
        likelihood_block_plain(dat_w, sctf2, a, pri, tra, w_r, w_t, base,
                               acc_c, acc_r, acc_t, col0)
        return
    n_k, n_l, n_r, n_p = pri.shape
    n_t = tra.shape[1]
    for name, x, dt in (("dat_w", dat_w, COMPLEX), ("sctf2", sctf2, REAL),
                        ("a", a, REAL), ("pri", pri, COMPLEX), ("tra", tra, COMPLEX),
                        ("w_r", w_r, REAL), ("w_t", w_t, REAL), ("base", base, REAL),
                        ("acc_c", acc_c, REAL), ("acc_r", acc_r, REAL),
                        ("acc_t", acc_t, REAL)):
        _native.require(x.dtype == dt and x.is_cuda,
                        f"likelihood_block: {name} must be {dt} on the card")
    _native.require(dat_w.shape == (n_l, n_p) and sctf2.shape == (n_l, n_p)
                    and a.shape == (n_l,) and tra.shape == (n_l, n_t, n_p)
                    and w_r.shape == (n_l, n_r) and w_t.shape == (n_l, n_t)
                    and base.shape == (n_k, n_l) and acc_c.shape == (n_k, n_l)
                    and acc_t.shape == (n_k, n_l, n_t)
                    and acc_r.shape[:2] == (n_k, n_l) and acc_r.shape[2] >= col0 + n_r,
                    "likelihood_block: inconsistent shapes")
    _native.require(dat_w.stride(1) == 1 and sctf2.stride(1) == 1 and pri.stride(3) == 1
                    and tra.stride(2) == 1 and acc_r.stride(2) == 1
                    and acc_t.stride(2) == 1 and a.stride(0) == 1
                    and base.stride() == acc_c.stride(),
                    "likelihood_block: pixel, column and accumulator strides")
    if n_l == 0 or n_k == 0:
        return
    plan = likelihood_plan(n_r, n_t)
    args = _LkArgs(
        dat_w.data_ptr(), dat_w.stride(0), sctf2.data_ptr(), sctf2.stride(0),
        a.data_ptr(), pri.data_ptr(), pri.stride(0), pri.stride(1), pri.stride(2),
        tra.data_ptr(), tra.stride(0), tra.stride(1),
        w_r.data_ptr(), w_r.stride(0), w_r.stride(1),
        w_t.data_ptr(), w_t.stride(0), w_t.stride(1),
        base.data_ptr(), acc_c.data_ptr(), base.stride(0), base.stride(1),
        acc_r.data_ptr(), acc_r.stride(0), acc_r.stride(1),
        acc_t.data_ptr(), acc_t.stride(0), acc_t.stride(1),
        n_l, n_k, n_r, n_t, n_p, int(col0), plan["n_tt"], plan["n_rt"])
    lib = _native.library()
    likelihood_block.launches += 1
    _native.check(lib.thunder_likelihood_block(
        ctypes.addressof(args), plan["tm"], plan["tn"], plan["threads"],
        plan["smem"], _native.stream_ptr(dat_w)), "likelihood_block")


likelihood_block.launches = 0


def local_marginals(dat_w, sctf2, a, pri, tra, w_r, w_t):
    """u_r (L, R) and u_t (L, T) of one phase over per-image supports
    pri (L, R, P) and tra (L, T, P): per-image max, exp and the
    prior-weighted marginals (optimiser._phase_body lines 487-502), one
    HK2 launch."""
    n_l, n_r = pri.shape[:2]
    n_t = tra.shape[1]
    dev = dat_w.device
    base = torch.full((1, n_l), float("-inf"), dtype=REAL, device=dev)
    acc_c = torch.empty((1, n_l), dtype=REAL, device=dev)
    u_r = torch.empty((1, n_l, n_r), dtype=REAL, device=dev)
    u_t = torch.empty((1, n_l, n_t), dtype=REAL, device=dev)
    likelihood_block(dat_w, sctf2, a, pri[None], tra, w_r, w_t, base, acc_c, u_r, u_t)
    return u_r[0], u_t[0]


# -- HK8 ----------------------------------------------------------------

def log_dvp_local_ctf(dat_s, s_pack, ctf_d, pri, tra, a_term) -> torch.Tensor:
    """Local search with defocus refinement (thunder_tpu
    ops/likelihood.py log_dvp_local_ctf): dat_s (L, P) complex = sigRcp
    dat, s_pack (L, P) = sigRcp, ctf_d (L, D, P) the CTF of each defocus
    support point, pri (L, R, P), tra (L, T, P) -> dvp (L, D, R, T)."""
    b = torch.einsum("lp,ldp,lrp->ldr", s_pack, ctf_d ** 2, pri.abs() ** 2)
    x = dat_s[:, None, :] * tra.conj()                          # (L, T, P)
    xc = x[:, None, :, :] * ctf_d[:, :, None, :]                # (L, D, T, P)
    c = -2.0 * torch.einsum("ldtq,lrq->ldrt", split_ri(xc), split_ri(pri))
    return a_term[:, None, None, None] + b[..., None] + c


def ctf_marginals(dvp: torch.Tensor, w_r, w_t, w_d):
    """Per-image max, exp and the three marginals of dvp (L, D, R, T),
    each weighted by the other two axes' priors
    (optimiser._phase_body_ctf): u_r (L, R), u_t (L, T), u_d (L, D)."""
    w = torch.exp(dvp - torch.amax(dvp, dim=(1, 2, 3), keepdim=True))
    return (torch.einsum("ldrt,lt,ld->lr", w, w_t, w_d),
            torch.einsum("ldrt,lr,ld->lt", w, w_r, w_d),
            torch.einsum("ldrt,lr,lt->ld", w, w_r, w_t))


def likelihood_local_ctf_plain(dat_s, s_pack, ctf: CtfParams, d, i_col, i_row,
                               size: int, pixel_size: float, pri, tra, a_term,
                               w_r, w_t, w_d):
    """Plain version of HK8 (see :func:`likelihood_local_ctf`):
    ctf_packed_scaled, log_dvp_local_ctf, ctf_marginals."""
    ctf_d = ctf_packed_scaled(ctf, i_col, i_row, size, pixel_size, d)
    return ctf_marginals(log_dvp_local_ctf(dat_s, s_pack, ctf_d, pri, tra, a_term),
                         w_r, w_t, w_d)


LC_PC, LC_TR, LC_TT, LC_TD = (_native.csrc_constant("likelihood_local_ctf.cu", n)
                              for n in ("PC", "TR", "TT", "TD"))


def likelihood_ctf_plan(n_d: int, n_r: int, n_t: int) -> dict:
    """Launch plan of HK8 for a (D x R x T) block an image: the register
    tiles a block walks (``items``: rotation pairs x translation tiles x
    defocus tiles), the threads (the multiple of 32 up to 256 that
    leaves the fewest idle threads in the last pass over the items, the
    larger on a tie) and the shared-memory bytes (the staged pixels, the
    image's dvp block, B, the row sums and a reduction scratch).  Raises
    where the block does not fit Hopper's shared memory."""
    up = lambda n, m: -(-n // m) * m
    d3, t3, r2 = up(n_d, LC_TD), up(n_t, LC_TT), up(n_r, LC_TR)
    items = (d3 // LC_TD) * (t3 // LC_TT) * (r2 // LC_TR)
    threads = min(range(256, 32, -32), key=lambda n: up(items, n))
    smem = 4 * (2 * LC_PC * r2 + 2 * t3 * LC_PC + d3 * LC_PC + LC_PC
                + d3 * t3 * r2 + d3 * r2 + d3 * t3 + 32)
    if smem > _native.SMEM_MAX:
        raise ValueError(f"likelihood_local_ctf: a {n_d} x {n_r} x {n_t} block "
                         f"takes {smem} bytes of shared memory")
    return dict(items=items, threads=threads, smem=smem)


class _LcArgs(ctypes.Structure):
    """csrc/likelihood_local_ctf.cu's LcArgs."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "dat_s", "s_pack", "ctfk", "f2", "ang", "dfac", "pri", "tra", "a",
        "w_r", "w_t", "w_d", "u_r", "u_t", "u_d")] + [
        (n, ctypes.c_int) for n in ("L", "D", "R", "T", "P")]


def likelihood_local_ctf(dat_s: torch.Tensor, s_pack: torch.Tensor,
                         ctf: CtfParams, d: torch.Tensor, i_col: torch.Tensor,
                         i_row: torch.Tensor, size: int, pixel_size: float,
                         pri: torch.Tensor, tra: torch.Tensor,
                         a_term: torch.Tensor, w_r: torch.Tensor,
                         w_t: torch.Tensor, w_d: torch.Tensor):
    """The marginals of one CTF-search phase over per-image supports:

      ctf[l,d,p]   = CTF of image l with its defocus scaled by d[l,d]
      B[l,d,r]     = sum_p s_pack[l,p] ctf[l,d,p]^2 |pri[l,r,p]|^2
      C[l,d,r,t]   = -2 Re sum_p ctf[l,d,p] dat_s[l,p] conj(tra[l,t,p])
                     conj(pri[l,r,p])
      dvp = a_term[l] + B + C;  w = exp(dvp - max_{d,r,t} dvp)
      u_r[l,r] = sum_{d,t} w w_t[l,t] w_d[l,d]   (u_t, u_d alike)

    dat_s (L, P) complex64; s_pack (L, P); ctf fields (L,); d (L, D);
    pixels (P,); pri (L, R, P) and tra (L, T, P) complex64; a_term (L,);
    priors w_r (L, R), w_t (L, T), w_d (L, D).  Returns (u_r, u_t, u_d);
    the (L, D, R, T) tensor is never formed on the card.  CPU tensors
    take :func:`likelihood_local_ctf_plain`; CUDA tensors launch
    csrc/likelihood_local_ctf.cu, one launch."""
    if not dat_s.is_cuda:
        return likelihood_local_ctf_plain(dat_s, s_pack, ctf, d, i_col, i_row,
                                          size, pixel_size, pri, tra, a_term,
                                          w_r, w_t, w_d)
    n_l, n_r, n_p = pri.shape
    n_t, n_d = tra.shape[1], d.shape[1]
    for name, x, dt in (("dat_s", dat_s, COMPLEX), ("s_pack", s_pack, REAL),
                        ("d", d, REAL), ("pri", pri, COMPLEX), ("tra", tra, COMPLEX),
                        ("a_term", a_term, REAL), ("w_r", w_r, REAL),
                        ("w_t", w_t, REAL), ("w_d", w_d, REAL)):
        _native.require(x.dtype == dt and x.is_cuda,
                        f"likelihood_local_ctf: {name} must be {dt} on the card")
    _native.require(dat_s.shape == (n_l, n_p) and s_pack.shape == (n_l, n_p)
                    and tra.shape == (n_l, n_t, n_p) and a_term.shape == (n_l,)
                    and w_r.shape == (n_l, n_r) and w_t.shape == (n_l, n_t)
                    and w_d.shape == (n_l, n_d) and i_col.shape == (n_p,)
                    and i_row.shape == (n_p,)
                    and all(f.shape == (n_l,) for f in ctf),
                    "likelihood_local_ctf: inconsistent shapes")
    plan = likelihood_ctf_plan(n_d, n_r, n_t)
    dev = dat_s.device
    u_r = torch.empty((n_l, n_r), dtype=REAL, device=dev)
    u_t = torch.empty((n_l, n_t), dtype=REAL, device=dev)
    u_d = torch.empty((n_l, n_d), dtype=REAL, device=dev)
    if n_l == 0:
        return u_r, u_t, u_d
    fcol, frow = i_col.to(REAL), i_row.to(REAL)
    fx, fy = fcol / (pixel_size * size), frow / (pixel_size * size)
    f2 = (fx * fx + fy * fy).contiguous()
    ang = torch.atan2(frow, fcol).contiguous()
    ctfk = ctf_constants(ctf)
    keep = [t.contiguous() for t in (dat_s, s_pack, ctfk, f2, ang, d, pri, tra,
                                     a_term, w_r, w_t, w_d)]
    args = _LcArgs(*[t.data_ptr() for t in keep], u_r.data_ptr(), u_t.data_ptr(),
                   u_d.data_ptr(), n_l, n_d, n_r, n_t, n_p)
    lib = _native.library()
    likelihood_local_ctf.launches += 1
    _native.check(lib.thunder_likelihood_local_ctf(
        ctypes.addressof(args), plan["threads"], plan["smem"],
        _native.stream_ptr(dat_s)), "likelihood_local_ctf")
    return u_r, u_t, u_d


likelihood_local_ctf.launches = 0
