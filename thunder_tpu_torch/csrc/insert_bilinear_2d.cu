// HK6 insert_bilinear_2d: bilinear Fourier insertion of compacted 2D
// slices into per-class (F, T) planes, with the slice values formed in
// the kernel and each block accumulating into a private window of the
// plane in shared memory.
//
// Replaces (thunder_tpu): optimiser._insert_all_h's one_2d_sweep over
// ops/insert.py insert_sweep_2d (the scatter-free adjoint of a sheared
// resampler, built because the TPU's scatter was the 2D-classification
// bottleneck at mReco = 100).  Its math is the bilinear scatter
// insert_slices_2d after _insert_class's 2D value formation and the
// Hermitian fold; THUNDER's own CUDA backend does it as a bilinear
// atomicAdd.
//
// One thread per (slice s, dense pixel (vc, vr) of the nk x nk window,
// nk = 2 r_u - 1).  It forms the value of optimiser.py:1276-1295
//   mask_d = [vc^2 + vr^2 < (r_u - 1)^2] * (2 at the DC, else 1)
//   val    = ft[img[s], c + vr, c + vc] * conj(tra_s) * ctf * mask_d * w[s]
//   c2w    = ctf^2 * mask_d * w[s]
// takes the position rot[s] . (pf vc, pf vr) (no FMA contraction, as
// in the plain version), applies insert_slices_2d's cut
// x^2 + y^2 < max_radius_pad^2, and adds the 4 bilinear taps (indices
// clipped to [0, big-1]) to class cls[s]'s plane.  The dense window
// holds both k and -k, so the Hermitian fold of the half-space path is
// already in the sum (the DC, present once, is doubled).
//
// What bounds it on Hopper: the adds, 12 per sample.  mReco = 100
// compacted draws of ~5000 images per hemisphere land on 30 class
// planes; plain global atomicAdd would serialise on the hot low-
// frequency cells.  The wrapper sorts the slices by class and cuts each
// class's run into work items of at most `chunk` slices; a block takes
// one work item and one band of rows of the class window (the
// (2 ceil(max_radius_pad) + 3)^2 cells a tap can reach), accumulates
// in shared memory (shared atomics, 12 B a cell), and flushes each
// non-empty cell with one global atomicAdd per field.  Bands keep the
// window within the shared-memory budget at any r_u; a pixel whose
// taps miss the band skips the value formation (CTF, phase ramp).
// Summation order differs from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void insert_bilinear_2d_kernel(
    const float2* __restrict__ ft, int size, const float* __restrict__ ctfk,
    const int* __restrict__ img_idx, const int* __restrict__ work,
    const float* __restrict__ rot, const float* __restrict__ trans,
    const float* __restrict__ wsl, int r_u, int pf, float max_radius_pad,
    float box_a, float tpos, float* __restrict__ F, float* __restrict__ T,
    int big, int win_lo, int win, int band_h) {
  extern __shared__ float acc[];            // 3 fields x band_h x win
  const int cls = work[3 * blockIdx.x];
  const int s0 = work[3 * blockIdx.x + 1];
  const int s1 = work[3 * blockIdx.x + 2];
  const int row0 = blockIdx.y * band_h;     // band rows, window-local
  const int rows = min(band_h, win - row0);
  const int cells = rows * win;
  for (int j = threadIdx.x; j < 3 * cells; j += blockDim.x) acc[j] = 0.f;
  __syncthreads();

  const long long plane = (long long)big * big;
  float* Fk = F + 2 * (long long)cls * plane;
  float* Tk = T + (long long)cls * plane;
  const int nk = 2 * r_u - 1;
  const int rr = r_u - 1;
  const int npx = nk * nk;
  const long long total = (long long)(s1 - s0) * npx;
  const int cb = big / 2;
  const int c = size / 2;

  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    long long s = s0 + i / npx;
    int p = (int)(i % npx);
    int vr = p / nk - rr;
    int vc = p % nk - rr;
    int q2 = vc * vc + vr * vr;
    if (q2 >= rr * rr) continue;
    float w = wsl[s];
    if (w == 0.f) continue;

    const float* R = rot + s * 4;
    float gx = (float)(vc * pf), gy = (float)(vr * pf);
    float x = __fadd_rn(__fmul_rn(R[0], gx), __fmul_rn(R[1], gy));
    float y = __fadd_rn(__fmul_rn(R[2], gx), __fmul_rn(R[3], gy));
    if (__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)) >=
        max_radius_pad * max_radius_pad)
      continue;
    float flx = floorf(x), fly = floorf(y);
    float wx = x - flx, wy = y - fly;
    int ix = (int)flx + cb, iy = (int)fly + cb;
    int y0 = min(max(iy, 0), big - 1) - win_lo - row0;
    int y1 = min(max(iy + 1, 0), big - 1) - win_lo - row0;
    bool in0 = y0 >= 0 && y0 < rows, in1 = y1 >= 0 && y1 < rows;
    if (!in0 && !in1) continue;

    float mask_d = (q2 == 0) ? 2.f : 1.f;
    int img = img_idx[s];
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
    float f2 = f * f;
    float ang = atan2f((float)vr, (float)vc);
    float du = k[4], dv = k[5];
    float defocus = -(du + dv + (du - dv) * cosf(2.f * (ang - k[6]))) / 2.f;
    float chi = k[0] * defocus * f2 + k[1] * (f2 * f2) - k[7];
    float ctf = -k[2] * sinf(chi) + k[3] * cosf(chi);
    float cm = ctf * mask_d;
    float vre = dr * cm * w, vim = di * cm * w;
    float c2w = ctf * ctf * mask_d * w;

#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      int ly = dy ? y1 : y0;
      if (!(dy ? in1 : in0)) continue;
      float wyy = dy ? wy : 1.f - wy;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        int xi = min(max(ix + dx, 0), big - 1);
        float wt = wyy * (dx ? wx : 1.f - wx);
        // |x|, |y| < max_radius_pad: the clipped taps lie in the window
        int j = ly * win + (xi - win_lo);
        atomicAdd(acc + j, vre * wt);
        atomicAdd(acc + cells + j, vim * wt);
        atomicAdd(acc + 2 * cells + j, c2w * wt);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    float a = acc[j], b = acc[cells + j], t = acc[2 * cells + j];
    if (a == 0.f && b == 0.f && t == 0.f) continue;
    long long lin = (long long)(win_lo + row0 + j / win) * big + win_lo + j % win;
    atomicAdd(Fk + 2 * lin, a);
    atomicAdd(Fk + 2 * lin + 1, b);
    atomicAdd(Tk + lin, t);
  }
}

}  // namespace

// ft (L, size, size) complex64; ctfk (L, 8); per slice (B of them,
// sorted by class): img_idx (B,), rot (B, 2, 2), trans (B, 2), w (B,);
// work (n_work, 3) int32 = (class, first slice, end slice); F (K, big,
// big) complex64 and T (K, big, big) float32, accumulated into.  The
// window is [win_lo, win_lo + win)^2, cut into bands of band_h rows.
extern "C" int thunder_insert_bilinear_2d(
    const void* ft, int size, const void* ctfk, const void* img_idx,
    const void* work, int n_work, const void* rot, const void* trans,
    const void* w, int r_u, int pf, float max_radius_pad, float box_a,
    float tpos, void* F, void* T, int big, int win_lo, int win, int band_h,
    void* stream) {
  size_t smem = (size_t)3 * band_h * win * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        insert_bilinear_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int n_band = (win + band_h - 1) / band_h;
  if (n_work > 0) {
    dim3 grid(n_work, n_band);
    insert_bilinear_2d_kernel<<<grid, 512, smem, (cudaStream_t)stream>>>(
        (const float2*)ft, size, (const float*)ctfk, (const int*)img_idx,
        (const int*)work, (const float*)rot, (const float*)trans,
        (const float*)w, r_u, pf, max_radius_pad, box_a, tpos, (float*)F,
        (float*)T, big, win_lo, win, band_h);
  }
  return (int)cudaGetLastError();
}
