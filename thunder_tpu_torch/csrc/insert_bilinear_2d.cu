// HK6 insert_bilinear_2d: bilinear Fourier insertion of compacted 2D
// slices into per-class (F, T) planes.  Each image's values are formed
// once per pixel, its slices then only rotate, ramp and add; a block
// accumulates a run of same-class images in a shared-memory window of
// the class plane.
//
// Replaces (thunder_tpu): optimiser._insert_all_h's one_2d_sweep over
// ops/insert.py insert_sweep_2d (the scatter-free adjoint of a sheared
// resampler, built because the TPU's scatter was the 2D-classification
// bottleneck at mReco = 100).  Its math is the bilinear scatter
// insert_slices_2d after _insert_class's 2D value formation and the
// Hermitian fold; THUNDER's own CUDA backend does it as a bilinear
// atomicAdd.
//
// For slice s of image l at a dense pixel (vc, vr) of the nk x nk window
// (nk = 2 r_u - 1) with vc^2 + vr^2 < (r_u - 1)^2 (the in-disc list):
//   mask_d = 2 at the DC, else 1
//   val    = ft[l, c + vr, c + vc] * ctf_l(vc, vr) * mask_d * conj(tra_s) * w[s]
//   c2w    = ctf_l(vc, vr)^2 * mask_d * w[s]
// at rot[s] . (pf vc, pf vr) (no FMA contraction, as in the plain
// version), cut to x^2 + y^2 < max_radius_pad^2, added as 4 bilinear
// taps (indices clipped to [0, big-1]) to class cls[s]'s plane.  The
// dense window holds both k and -k, so the Hermitian fold of the
// half-space path is already in the sum (the DC, present once, doubled).
//
// What bounds it on Hopper: per sample ~50 fp32 operations and 12 shared
// atomic adds, each a compare-and-swap loop (Hopper has no native shared
// fp32 add); the atomics' latency, hidden by 32 warps a block.  The
// previous design evaluated six accurate transcendentals, a sqrt and a
// 64-bit division per sample and scanned each work item once per band.
// Here:
// * the wrapper sorts slices by (class, image); a work item is a run of
//   whole images of one class (cut at image boundaries), so all ~48
//   slices of an image go to the same window;
// * a thread owns fixed pixels of the in-disc list: per image it forms
//   ctf * data * mask_d and ctf^2 * mask_d once (the CTF depends on the
//   image and the pixel only), then loops over the image's slices;
// * the translation ramp exp(i tpos (vc tx + vr ty)) is separable: per
//   slice two 1D tables of nk sincos values in shared memory, one
//   complex product per sample;
// * the class window sits in shared memory in one band where it fits
//   (123^2 x 12 B = 181 KB at r_u 31), else in bands of rows;
// * per-sample index arithmetic is 32-bit (64-bit only for an image's
//   or a plane's base).
// The window is flushed with one global atomicAdd per non-empty cell
// and field.  Summation order differs from run to run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// (ops/insert.py reads these three from this file for its launch plan)
constexpr int BATCH = 32;    // slices whose ramp tables are staged at once
constexpr int THREADS = 1024;
constexpr int PX_MAX = 4;    // pixels a thread holds per group

// One (F re, F im, T) sample into a window cell: three shared float
// atomics (a compare-and-swap loop each on Hopper; one 64-bit CAS for
// the complex pair measured slower).
__device__ __forceinline__ void add3(float2* f, float* t, float a, float b, float c) {
  atomicAdd(&f->x, a);
  atomicAdd(&f->y, b);
  atomicAdd(t, c);
}

__global__ void __launch_bounds__(THREADS) insert_bilinear_2d_kernel(
    const float2* __restrict__ ft, int size, const float* __restrict__ ctfk,
    const int* __restrict__ img_idx, const int* __restrict__ runs,
    const int* __restrict__ work, const float* __restrict__ rot,
    const float* __restrict__ trans, const float* __restrict__ wsl,
    const int* __restrict__ px, int npx, int pxt, int r_u, int pf,
    float max_radius_pad, float box_a, float tpos, float* __restrict__ F,
    float* __restrict__ T, int big, int win_lo, int win, int band_h) {
  extern __shared__ __align__(16) float smem[];
  const int nk = 2 * r_u - 1, rr = r_u - 1;
  float2* EX = reinterpret_cast<float2*>(smem);      // BATCH x nk
  float2* EY = EX + BATCH * nk;                      // BATCH x nk
  float* SR = reinterpret_cast<float*>(EY + BATCH * nk);   // BATCH x 4
  float* SW = SR + 4 * BATCH;                        // BATCH
  float2* Fw = reinterpret_cast<float2*>(SW + BATCH);      // rows x win
  const int row0 = blockIdx.y * band_h;              // band rows, window-local
  const int rows = min(band_h, win - row0);
  const int cells = rows * win;
  float* Tw = reinterpret_cast<float*>(Fw + cells);
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int j = tid; j < cells; j += nthr) {
    Fw[j] = make_float2(0.f, 0.f);
    Tw[j] = 0.f;
  }

  const int cls = work[3 * blockIdx.x];
  const int run0 = work[3 * blockIdx.x + 1], run1 = work[3 * blockIdx.x + 2];
  const int cb = big / 2, c = size / 2;
  const float mr2 = max_radius_pad * max_radius_pad;
  const int lo = win_lo + row0;                      // first plane row of the band

  for (int g0 = 0; g0 < npx; g0 += pxt * nthr) {
    for (int run = run0; run < run1; ++run) {
      const int s0 = runs[2 * run], s1 = runs[2 * run + 1];
      const int img = img_idx[s0];
      // this image's values at the thread's pixels
      const float* k = ctfk + 8LL * img;   // [k1, k2, w1, w2, du, dv, theta, phase]
      const float2* fti = ft + (long long)img * size * size;
      int pvc[PX_MAX], pvr[PX_MAX];
      float2 pv[PX_MAX];
      float pc2[PX_MAX];
#pragma unroll
      for (int j = 0; j < PX_MAX; ++j) {
        int p = g0 + tid + j * nthr;
        pvc[j] = 0;
        pvr[j] = 0;
        pv[j] = make_float2(0.f, 0.f);
        pc2[j] = 0.f;
        if (j < pxt && p < npx) {
          int d = px[p];
          int vr = d / nk - rr, vc = d - (d / nk) * nk - rr;
          float fx = (float)vc / box_a, fy = (float)vr / box_a;
          float f = sqrtf(fx * fx + fy * fy);
          float f2 = f * f;
          float ang = atan2f((float)vr, (float)vc);
          float defocus = -(k[4] + k[5] + (k[4] - k[5]) * cosf(2.f * (ang - k[6]))) / 2.f;
          float chi = k[0] * defocus * f2 + k[1] * (f2 * f2) - k[7];
          float ctf = -k[2] * sinf(chi) + k[3] * cosf(chi);
          float cm = ctf * ((vc == 0 && vr == 0) ? 2.f : 1.f);
          float2 dv = fti[(c + vr) * size + (c + vc)];
          pvc[j] = vc;
          pvr[j] = vr;
          pv[j] = make_float2(dv.x * cm, dv.y * cm);
          pc2[j] = ctf * cm;
        }
      }
      for (int sb = s0; sb < s1; sb += BATCH) {
        const int nb = min(BATCH, s1 - sb);
        __syncthreads();   // the previous batch's tables are consumed
        for (int i = tid; i < nb * nk; i += nthr) {
          int b = i / nk, m = i - b * nk;
          float v = (float)(m - rr);
          float sx, cx, sy, cy;
          sincosf(tpos * (v * trans[2 * (sb + b)]), &sx, &cx);
          sincosf(tpos * (v * trans[2 * (sb + b) + 1]), &sy, &cy);
          EX[b * nk + m] = make_float2(cx, sx);
          EY[b * nk + m] = make_float2(cy, sy);
        }
        for (int i = tid; i < nb * 4; i += nthr) SR[i] = rot[4 * sb + i];
        for (int i = tid; i < nb; i += nthr) SW[i] = wsl[sb + i];
        __syncthreads();
        for (int b = 0; b < nb; ++b) {
          const float w = SW[b];
          if (w == 0.f) continue;
          const float R0 = SR[4 * b], R1 = SR[4 * b + 1], R2 = SR[4 * b + 2],
                      R3 = SR[4 * b + 3];
          const float2* ex = EX + b * nk + rr;
          const float2* ey = EY + b * nk + rr;
#pragma unroll
          for (int j = 0; j < PX_MAX; ++j) {
            if (j >= pxt || g0 + tid + j * nthr >= npx) continue;
            float gx = (float)(pvc[j] * pf), gy = (float)(pvr[j] * pf);
            float x = __fadd_rn(__fmul_rn(R0, gx), __fmul_rn(R1, gy));
            float y = __fadd_rn(__fmul_rn(R2, gx), __fmul_rn(R3, gy));
            if (__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)) >= mr2) continue;
            float flx = floorf(x), fly = floorf(y);
            int ix = (int)flx + cb, iy = (int)fly + cb;
            int y0 = min(max(iy, 0), big - 1) - lo;
            int y1 = min(max(iy + 1, 0), big - 1) - lo;
            bool in0 = y0 >= 0 && y0 < rows, in1 = y1 >= 0 && y1 < rows;
            if (!in0 && !in1) continue;
            // conj(tra) = exp(+i tpos (vc tx + vr ty)) = ex[vc] ey[vr]
            float2 a = ex[pvc[j]], e = ey[pvr[j]];
            float er = a.x * e.x - a.y * e.y, ei = a.x * e.y + a.y * e.x;
            float vre = (pv[j].x * er - pv[j].y * ei) * w;
            float vim = (pv[j].x * ei + pv[j].y * er) * w;
            float c2w = pc2[j] * w;
            float wx = x - flx, wy = y - fly;
            int x0 = min(max(ix, 0), big - 1) - win_lo;
            int x1 = min(max(ix + 1, 0), big - 1) - win_lo;
            // |x|, |y| < max_radius_pad: the clipped taps lie in the window
            if (in0) {
              int r = y0 * win;
              float w0 = (1.f - wy) * (1.f - wx), w1 = (1.f - wy) * wx;
              add3(Fw + r + x0, Tw + r + x0, vre * w0, vim * w0, c2w * w0);
              add3(Fw + r + x1, Tw + r + x1, vre * w1, vim * w1, c2w * w1);
            }
            if (in1) {
              int r = y1 * win;
              float w0 = wy * (1.f - wx), w1 = wy * wx;
              add3(Fw + r + x0, Tw + r + x0, vre * w0, vim * w0, c2w * w0);
              add3(Fw + r + x1, Tw + r + x1, vre * w1, vim * w1, c2w * w1);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  float* Fk = F + 2LL * cls * big * big;
  float* Tk = T + (long long)cls * big * big;
  for (int j = tid; j < cells; j += nthr) {
    float2 a = Fw[j];
    float t = Tw[j];
    if (a.x == 0.f && a.y == 0.f && t == 0.f) continue;
    int y = j / win, x = j - y * win;
    int lin = (lo + y) * big + win_lo + x;
    atomicAdd(Fk + 2 * lin, a.x);
    atomicAdd(Fk + 2 * lin + 1, a.y);
    atomicAdd(Tk + lin, t);
  }
}

}  // namespace

// ft (L, size, size) complex64; ctfk (L, 8); per slice, sorted by
// (class, image): img_idx (B,), rot (B, 2, 2), trans (B, 2), w (B,);
// runs (n_run, 2) int32 = [first, end) slice of one image; work (n_work,
// 3) int32 = (class, first run, end run); px (npx,) int32 in-disc dense
// pixels (vr + r_u - 1) nk + (vc + r_u - 1), pxt of them a thread at a
// time; F (K, big, big) complex64 and T (K, big, big) float32,
// accumulated into.  The window is [win_lo, win_lo + win)^2, cut into
// bands of band_h rows (grid.y).
extern "C" int thunder_insert_bilinear_2d(
    const void* ft, int size, const void* ctfk, const void* img_idx,
    const void* runs, const void* work, int n_work, const void* rot,
    const void* trans, const void* w, const void* px, int npx, int pxt,
    int r_u, int pf, float max_radius_pad, float box_a, float tpos, void* F,
    void* T, int big, int win_lo, int win, int band_h, int threads, int smem,
    void* stream) {
  if (pxt < 1 || pxt > PX_MAX || threads != THREADS) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        insert_bilinear_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int n_band = (win + band_h - 1) / band_h;
  if (n_work > 0) {
    insert_bilinear_2d_kernel<<<dim3(n_work, n_band), threads, smem, (cudaStream_t)stream>>>(
        (const float2*)ft, size, (const float*)ctfk, (const int*)img_idx, (const int*)runs,
        (const int*)work, (const float*)rot, (const float*)trans, (const float*)w,
        (const int*)px, npx, pxt, r_u, pf, max_radius_pad, box_a, tpos, (float*)F,
        (float*)T, big, win_lo, win, band_h);
  }
  return (int)cudaGetLastError();
}
