// HK9 insert_trilinear_slab: trilinear atomicAdd insertion of formed
// slices into one z-slab of the (F, T) grids, with the point group's
// mates applied pose-side.
//
// Replaces (thunder_tpu): recon/sharded.py:300 insert_sweep_3d_sharded,
// the shear-sweep inserter that accumulates F / T directly as z-slabs
// over the mesh's data axis.  Held to trilinear insertion (HK3's
// semantics, ops/insert.py insert_trilinear), not to the sweep, whose
// height hat is not trilinear (thunder_tpu/config.py:55-59).
//
// Inputs: the dense window's formed values of B slices (vals (B, nk^2)
// complex, c2w (B, nk^2), weights already in; nk = 2 r_u - 1), each
// slice's rotation R (row-major 3x3) and class, and the group's n_sym
// mates M (the identity first).  One thread per (slice s, pixel p): the
// sample sits at pos = R . (pf vc, pf vr, 0); |pos| >= max_radius_pad
// and all-zero values return at once.  For each mate it takes M pos and
// adds the 8 trilinear taps (indices clipped to [0, big-1]) whose z lies
// in the slab [z0, z0 + bz); a mate other than the identity adds only
// taps inside the radius, HK7's cut, so that for signed-permutation
// groups the slabs equal HK3 then HK7 up to float order.  A mate whose
// two z planes both miss the slab is skipped before any tap.
//
// What bounds it on Hopper: as HK3, the rate at which L2 retires atomic
// operations (~90 G a second whatever their width).  The taps go into a
// scratch slab of interleaved (re, im, T, 0) cells, one 16-byte float4
// atomicAdd a tap (HK3's design: 8 operations a sample where separate
// F.re, F.im and T took 24), and a second pass adds it into F and T.
// Summation order differs from run to run.

#include <cuda_runtime.h>

namespace {

__global__ void insert_slab_kernel(
    const float2* __restrict__ vals, const float* __restrict__ c2w,
    const float* __restrict__ rot, const int* __restrict__ cls, int r_u, int pf,
    float max_radius_pad, const float* __restrict__ mats, int n_sym,
    float4* __restrict__ G, int big, int z0, int bz, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nk = 2 * r_u - 1;
  const int rr = r_u - 1;
  const int npx = nk * nk;
  long long s = idx / npx;
  int p = (int)(idx - s * npx);
  float2 v = vals[idx];
  float cw = c2w[idx];
  if (v.x == 0.f && v.y == 0.f && cw == 0.f) return;
  int vr = p / nk - rr;
  int vc = p % nk - rr;
  const float* R = rot + s * 9;
  float gx = (float)(vc * pf), gy = (float)(vr * pf);
  float px = R[0] * gx + R[1] * gy;
  float py = R[3] * gx + R[4] * gy;
  float pz = R[6] * gx + R[7] * gy;
  float r2 = max_radius_pad * max_radius_pad;
  if (px * px + py * py + pz * pz >= r2) return;
  const int cb = big / 2;
  float4* slab = G + (long long)cls[s] * bz * big * big;
  for (int m = 0; m < n_sym; ++m) {
    const float* M = mats + m * 9;
    float x = M[0] * px + M[1] * py + M[2] * pz;
    float y = M[3] * px + M[4] * py + M[5] * pz;
    float z = M[6] * px + M[7] * py + M[8] * pz;
    float flz = floorf(z);
    int iz = (int)flz + cb;
    int za = min(max(iz, 0), big - 1), zb = min(max(iz + 1, 0), big - 1);
    bool ina = za >= z0 && za < z0 + bz, inb = zb >= z0 && zb < z0 + bz;
    if (!ina && !inb) continue;
    float flx = floorf(x), fly = floorf(y);
    float wx = x - flx, wy = y - fly, wz = z - flz;
    int ix = (int)flx + cb, iy = (int)fly + cb;
    int xs[2] = {min(max(ix, 0), big - 1), min(max(ix + 1, 0), big - 1)};
    int ys[2] = {min(max(iy, 0), big - 1), min(max(iy + 1, 0), big - 1)};
    int zs[2] = {za, zb};
    bool in_z[2] = {ina, inb};
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      if (!in_z[dz]) continue;
      float wzz = dz ? wz : 1.f - wz;
      int zc = zs[dz] - cb;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        float wzy = wzz * (dy ? wy : 1.f - wy);
        int yc = ys[dy] - cb;
        float4* row = slab + ((long long)(zs[dz] - z0) * big + ys[dy]) * big;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          if (m > 0) {
            int xc = xs[dx] - cb;
            if ((float)(xc * xc + yc * yc + zc * zc) >= r2) continue;
          }
          float w = wzy * (dx ? wx : 1.f - wx);
          atomicAdd(row + xs[dx], make_float4(v.x * w, v.y * w, cw * w, 0.f));
        }
      }
    }
  }
}

// F += G.(re, im), T += G.T over the cells any tap reached
__global__ void insert_slab_split_kernel(const float4* __restrict__ G, float2* __restrict__ F,
                                         float* __restrict__ T, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 g = G[i];
  if (g.x == 0.f && g.y == 0.f && g.z == 0.f) return;
  float2 f = F[i];
  F[i] = make_float2(f.x + g.x, f.y + g.y);
  T[i] += g.z;
}

}  // namespace

// vals (B, nk^2) complex64, c2w (B, nk^2) float32, rot (B, 9), cls (B,)
// int32, mats (n_sym, 9); G: scratch (K bz big^2, 4) float32 zeroed by
// the caller; F (K, bz, big, big) complex64 and T float32 are
// accumulated into
extern "C" int thunder_insert_trilinear_slab(
    const void* vals, const void* c2w, const void* rot, const void* cls, int n_slices,
    int r_u, int pf, float max_radius_pad, const void* mats, int n_sym, void* F, void* T,
    void* G, int n_class, int big, int z0, int bz, void* stream) {
  int nk = 2 * r_u - 1;
  long long total = (long long)n_slices * nk * nk;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    insert_slab_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float2*)vals, (const float*)c2w, (const float*)rot, (const int*)cls, r_u, pf,
        max_radius_pad, (const float*)mats, n_sym, (float4*)G, big, z0, bz, total);
    long long cells = (long long)n_class * bz * big * big;
    insert_slab_split_kernel<<<(unsigned)((cells + threads - 1) / threads), threads, 0,
                               (cudaStream_t)stream>>>(
        (const float4*)G, (float2*)F, (float*)T, cells);
  }
  return (int)cudaGetLastError();
}
