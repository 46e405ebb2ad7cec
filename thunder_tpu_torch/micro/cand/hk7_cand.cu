// The first design of symmetrize_ft.cu, kept as a candidate: micro/hk_candidates.py
// (--kernels hk7,hk8) times it beside the kernel in csrc/.  Not part of the
// kernel library.
//
// HK7 symmetrize_ft: point-group symmetrisation of the insertion grids.
//
// Replaces (thunder_tpu): recon/reconstructor.py symmetrize_ft, a
// lax.scan over the group's elements of a whole-grid trilinear gather,
// applied to F and, in a second call, to T of every class.
//
//   out(f) = grid(f) + sum over the mates s >= 1 of
//            [ |f| < max_radius_pad ] * trilinear(grid, R_s f)
//
// for F (complex64) and T (float32) of every grid g (hemisphere x
// class) in ONE launch: one thread a cell, a loop over the mates in the
// thread, and the eight tap weights and indices of a mate formed once
// and used for F and for T.  Coordinates are centered (index = k + big /
// 2), formed without FMA contraction and in the plain version's order,
// and every tap index is clipped to [0, big - 1], as
// _gather_trilinear_3d clips it; the taps are blended in its order.
// Cells outside the band keep their own value (the identity's term).
//
// What bounds it on Hopper: bytes.  Each grid is read once and written
// once by the identity's term; the mates' taps are re-reads of the same
// grid that the L2 cache serves while a grid's (F, T) pair stays near its
// 50 MB (152^3: 42 MB a pair; 320^3: 393 MB a pair, where the taps of a
// quarter turn, whose neighbouring threads read neighbouring rows and not
// neighbouring cells, go to device memory).  A thread block takes an
// 8 x 8 x 8 brick of cells, so that the taps of a rotated brick fall into
// one brick-sized neighbourhood whichever axis the mate turns about.

#include <cuda_runtime.h>

namespace {

constexpr int BRICK = 8;

__global__ void symmetrize_ft_kernel(
    const float2* __restrict__ f_in, const float* __restrict__ t_in,
    float2* __restrict__ f_out, float* __restrict__ t_out,
    const float* __restrict__ mats, int n_mates, int big, float r2max) {
  int nb = (big + BRICK - 1) / BRICK;
  int b = blockIdx.x;
  int bx = b % nb, by = (b / nb) % nb, bz = b / (nb * nb);
  int t = threadIdx.x;
  int ix = bx * BRICK + t % BRICK;
  int iy = by * BRICK + (t / BRICK) % BRICK;
  int iz = bz * BRICK + t / (BRICK * BRICK);
  if (ix >= big || iy >= big || iz >= big) return;
  long long cells = (long long)big * big * big;
  long long base = (long long)blockIdx.y * cells;
  long long cell = ((long long)iz * big + iy) * big + ix;
  const float2* F = f_in + base;
  const float* T = t_in + base;
  float2 f = F[cell];
  float tt = T[cell];
  int c = big / 2;
  float kx = (float)(ix - c), ky = (float)(iy - c), kz = (float)(iz - c);
  if (kx * kx + ky * ky + kz * kz < r2max) {
    for (int s = 1; s <= n_mates; ++s) {
      const float* R = mats + 9 * s;
      float x = __fadd_rn(__fadd_rn(__fmul_rn(R[0], kx), __fmul_rn(R[1], ky)),
                          __fmul_rn(R[2], kz));
      float y = __fadd_rn(__fadd_rn(__fmul_rn(R[3], kx), __fmul_rn(R[4], ky)),
                          __fmul_rn(R[5], kz));
      float z = __fadd_rn(__fadd_rn(__fmul_rn(R[6], kx), __fmul_rn(R[7], ky)),
                          __fmul_rn(R[8], kz));
      float flx = floorf(x), fly = floorf(y), flz = floorf(z);
      float wx = x - flx, wy = y - fly, wz = z - flz;
      int jx = (int)flx + c, jy = (int)fly + c, jz = (int)flz + c;
      int x0 = min(max(jx, 0), big - 1), x1 = min(max(jx + 1, 0), big - 1);
      int y0 = min(max(jy, 0), big - 1), y1 = min(max(jy + 1, 0), big - 1);
      int z0 = min(max(jz, 0), big - 1), z1 = min(max(jz + 1, 0), big - 1);
      long long r00 = ((long long)z0 * big + y0) * big, r01 = ((long long)z0 * big + y1) * big;
      long long r10 = ((long long)z1 * big + y0) * big, r11 = ((long long)z1 * big + y1) * big;
      long long idx[8] = {r00 + x0, r00 + x1, r01 + x0, r01 + x1,
                          r10 + x0, r10 + x1, r11 + x0, r11 + x1};
      float2 fv[8];
      float tv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        fv[i] = __ldg(F + idx[i]);
        tv[i] = __ldg(T + idx[i]);
      }
      float w[8] = {(1.f - wz) * (1.f - wy) * (1.f - wx), (1.f - wz) * (1.f - wy) * wx,
                    (1.f - wz) * wy * (1.f - wx),         (1.f - wz) * wy * wx,
                    wz * (1.f - wy) * (1.f - wx),         wz * (1.f - wy) * wx,
                    wz * wy * (1.f - wx),                 wz * wy * wx};
      float gr = fv[0].x * w[0], gi = fv[0].y * w[0], gt = tv[0] * w[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) {
        gr += fv[i].x * w[i];
        gi += fv[i].y * w[i];
        gt += tv[i] * w[i];
      }
      f.x += gr;
      f.y += gi;
      tt += gt;
    }
  }
  f_out[base + cell] = f;
  t_out[base + cell] = tt;
}

}  // namespace

// f_in / f_out: (G, big, big, big) complex64; t_in / t_out: (G, big, big,
// big) float32; mats: (1 + n_mates, 3, 3) float32, the identity first
extern "C" int cand_symmetrize_ft_first(
    const void* f_in, const void* t_in, void* f_out, void* t_out,
    const void* mats, int n_mates, int n_grids, int big, float max_radius_pad,
    void* stream) {
  if (n_grids > 0 && big > 0) {
    int nb = (big + BRICK - 1) / BRICK;
    dim3 grid((unsigned)(nb * nb * nb), (unsigned)n_grids);
    symmetrize_ft_kernel<<<grid, BRICK * BRICK * BRICK, 0, (cudaStream_t)stream>>>(
        (const float2*)f_in, (const float*)t_in, (float2*)f_out, (float*)t_out,
        (const float*)mats, n_mates, big, max_radius_pad * max_radius_pad);
  }
  return (int)cudaGetLastError();
}
