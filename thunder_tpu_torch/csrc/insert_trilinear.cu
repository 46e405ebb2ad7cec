// HK3 insert_trilinear: trilinear atomicAdd Fourier insertion of
// compacted slices, with the slice values formed in the kernel.
//
// Replaces (thunder_tpu): optimiser._insert_flat3d_h over
// ops/insert.py insert_sweep_3d (the scatter-free shear sweep).  This is
// the natural Hopper form of insertion, the one the reference's own
// CUDA backend uses (gpu/src/Kernel.cu:2276-3203).
//
// One thread per (slice s, dense pixel (vc, vr) of the nk x nk window,
// nk = 2 r_u - 1).  It forms the value of optimiser.py:1441-1501
//   mask_d = [vc^2 + vr^2 < (r_u - 1)^2] * (2 at the DC, else 1)
//   val    = ft[img[s], c + vr, c + vc] * conj(tra_s) * ctf * mask_d * w[s]
//   c2w    = ctf^2 * mask_d * w[s]
// (tra_s the translation phase ramp, ctf evaluated from the image's
// per-image constants, its defocus scaled by the slice's factor dfac[s]
// where one is given: CTF search's use_d, ctf_packed_scaled), takes the position rot[s] . (pf vc, pf vr, 0),
// applies the padded-radius cut |pos| < max_radius_pad of
// insert_slices_3d, and adds the 8 trilinear taps (indices clipped to
// [0, big-1]).
//
// What bounds it on Hopper: the rate at which L2 retires atomic
// operations, ~90 G a second whatever their width (measured:
// micro/hk_candidates.py; scalar, float2 and float4 adds all ran at that
// rate).  At pf 2 neighbouring samples land two cells apart, so no two
// lanes share a cell and nothing can be merged before the atomics: the
// only lever is fewer operations a sample.  The taps therefore go into a
// scratch grid G of interleaved (re, im, T, 0) cells, one float4
// atomicAdd a tap (sm_90's 16-byte vector atomic): 8 operations a sample
// where separate F.re, F.im and T took 24.  A second pass adds G into F
// and T.  G is 16 bytes a cell (56 MB at 152^3, just past the 50 MB L2)
// and still ran 2.8 times faster than the 42 MB of separate grids; the
// arithmetic (a sincos pair, a CTF, ~110 operations a sample) hides
// behind the atomics, which is why forming each image's values once (a
// block walking an image's slices, tried beside this) gained nothing.
// Pixels outside the cut and zero-weight slices return before any memory
// traffic.  Summation order differs from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void insert_trilinear_kernel(
    const float2* __restrict__ ft, int size, const float* __restrict__ ctfk,
    const int* __restrict__ img_idx, const float* __restrict__ rot,
    const float* __restrict__ trans, const float* __restrict__ wsl,
    const float* __restrict__ dfac, int r_u, int pf, float max_radius_pad, float box_a, float tpos,
    float4* __restrict__ G, int big, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nk = 2 * r_u - 1;
  const int rr = r_u - 1;
  const int npx = nk * nk;
  long long s = idx / npx;
  int p = (int)(idx - s * npx);
  int vr = p / nk - rr;
  int vc = p % nk - rr;
  int q2 = vc * vc + vr * vr;
  if (q2 >= rr * rr) return;
  float w = wsl[s];
  if (w == 0.f) return;
  float mask_d = (q2 == 0) ? 2.f : 1.f;

  int img = img_idx[s];
  int c = size / 2;
  float2 d = ft[((long long)img * size + (c + vr)) * size + (c + vc)];

  // translation ramp: tra = exp(-i phase), conj(tra) = exp(+i phase)
  float tx = trans[2 * s], ty = trans[2 * s + 1];
  float ph = tpos * ((float)vc * tx + (float)vr * ty);
  float cp = cosf(ph), sp = sinf(ph);
  float dr = d.x * cp - d.y * sp;
  float di = d.x * sp + d.y * cp;

  // CTF at (vc, vr) from the per-image constants
  // [k1, k2, w1, w2, defocus_u, defocus_v, defocus_theta, phase_shift]
  const float* k = ctfk + (long long)img * 8;
  float fx = (float)vc / box_a;
  float fy = (float)vr / box_a;
  float f = sqrtf(fx * fx + fy * fy);
  float ang = atan2f((float)vr, (float)vc);
  float du = k[4], dv = k[5];
  float defocus = -(du + dv + (du - dv) * cosf(2.f * (ang - k[6]))) / 2.f;
  // ctf_packed squares f; ctf_packed_scaled takes fx^2 + fy^2 as it is
  float f2 = dfac ? fx * fx + fy * fy : f * f;
  float dd = dfac ? dfac[s] : 1.f;
  float chi = k[0] * defocus * dd * f2 + k[1] * (f2 * f2) - k[7];
  float ctf = -k[2] * sinf(chi) + k[3] * cosf(chi);

  float cm = ctf * mask_d;
  float vre = dr * cm * w;
  float vim = di * cm * w;
  float c2w = ctf * ctf * mask_d * w;

  const float* R = rot + s * 9;
  float gx = (float)(vc * pf), gy = (float)(vr * pf);
  float x = R[0] * gx + R[1] * gy;
  float y = R[3] * gx + R[4] * gy;
  float z = R[6] * gx + R[7] * gy;
  if (x * x + y * y + z * z >= max_radius_pad * max_radius_pad) return;

  float flx = floorf(x), fly = floorf(y), flz = floorf(z);
  float wx = x - flx, wy = y - fly, wz = z - flz;
  int cb = big / 2;
  int ix = (int)flx + cb, iy = (int)fly + cb, iz = (int)flz + cb;
  int x0 = min(max(ix, 0), big - 1), x1 = min(max(ix + 1, 0), big - 1);
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    int zi = min(max(iz + dz, 0), big - 1);
    float wzz = dz ? wz : 1.f - wz;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      int yi = min(max(iy + dy, 0), big - 1);
      float wzy = wzz * (dy ? wy : 1.f - wy);
      float4* row = G + ((long long)zi * big + yi) * big;
      float w0 = wzy * (1.f - wx), w1 = wzy * wx;
      atomicAdd(row + x0, make_float4(vre * w0, vim * w0, c2w * w0, 0.f));
      atomicAdd(row + x1, make_float4(vre * w1, vim * w1, c2w * w1, 0.f));
    }
  }
}

// F += G.(re, im), T += G.T over the cells any tap reached
__global__ void insert_split_kernel(const float4* __restrict__ G, float2* __restrict__ F,
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

// dfac: (n_slices,) float32 defocus factors, or null (all 1);
// G: scratch (big^3, 4) float32, zeroed by the caller; F (big^3)
// complex64 and T (big^3) float32 are accumulated into
extern "C" int thunder_insert_trilinear(
    const void* ft, int size, const void* ctfk, const void* img_idx,
    const void* rot, const void* trans, const void* w, const void* dfac,
    int n_slices, int r_u, int pf, float max_radius_pad, float box_a, float tpos, void* F,
    void* T, void* G, int big, void* stream) {
  int nk = 2 * r_u - 1;
  long long total = (long long)n_slices * nk * nk;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    insert_trilinear_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const float2*)ft, size, (const float*)ctfk, (const int*)img_idx,
        (const float*)rot, (const float*)trans, (const float*)w,
        (const float*)dfac, r_u, pf,
        max_radius_pad, box_a, tpos, (float4*)G, big, total);
    long long cells = (long long)big * big * big;
    insert_split_kernel<<<(unsigned)((cells + threads - 1) / threads), threads, 0,
                          (cudaStream_t)stream>>>(
        (const float4*)G, (float2*)F, (float*)T, cells);
  }
  return (int)cudaGetLastError();
}
