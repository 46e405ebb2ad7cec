// HK6 insert_bilinear_2d and HK12 insert_sweep_2d: Fourier insertion of
// compacted 2D slices into per-class (F, T) planes, as a gather: each
// plane cell forms its own sum.
//
// Replaces (thunder_tpu): HK12, the rounds' 2D insertion,
// optimiser.py:1273 one_2d_sweep over ops/insert.py:721 insert_sweep_2d
// (the scatter-free adjoint of a sheared resampler, built because the
// TPU's scatter was the 2D-classification bottleneck at mReco = 100);
// HK6, the bilinear scatter insert_slices_2d after _insert_class's 2D
// value formation and the Hermitian fold, which the insertion option
// reco_kernel="mkb" takes in 2D.
//
// HK12 is HK6 with the sweep's weight (template parameter SWEEP): with
// (h, k) = (vr, vc), or (vc, vr) where the slice's h/k swap is set,
// sample (h, k) adds to cell (x, y) with hat(y - ey1 h - ey2 k) hat(x -
// p_h h - q_y y), hat(t) = max(0, 1 - |t|), the coefficients formed on
// the host (ops/insert.py sweep_coeffs_2d).  A cell walks the h whose x
// hat reaches it (|p_h| >= pf: at most 2), for each the k whose y hat
// reaches it (|ey2| >= pf / sqrt 2), each weight formed as the plain
// version forms it, in float32 as thunder_tpu's 2D sweep.  It reaches
// sqrt 5 from a sample (|y - P_y| < 1, |x - P_x| < 1 + |q_y| <= 2) and
// drops what lies past the plane: no face gathers virtual cells.
//
// HK6:
//
// The scatter it computes: for slice s of image l at a dense pixel (vc,
// vr) of the nk x nk window (nk = 2 r_u - 1) with vc^2 + vr^2 < (r_u -
// 1)^2
//   mask_d = 2 at the DC, else 1
//   val    = ft[l, c + vr, c + vc] * ctf_l(vc, vr) * mask_d * conj(tra_s) * w[s]
//   c2w    = ctf_l(vc, vr)^2 * mask_d * w[s]
// at p = rot[s] . (pf vc, pf vr) (products and sums rounded one by one,
// as the plain version forms them), cut to |p|^2 < max_radius_pad^2,
// added as 4 bilinear taps (floor(p) + big / 2 + {0, 1} an axis, clipped
// to [0, big - 1]) to class cls[s]'s plane.  The dense window holds both
// k and -k, so the Hermitian fold of the half-space path is in the sum.
//
// The gather.  Cell k receives a tap of p exactly when floor(p_i) is k_i
// - 1 or k_i on both axes; then |R^T k - g| < sqrt 2 for g = (pf vc, pf
// vr), so its candidates lie within sqrt 2 / pf of (R^T k) / pf (at most
// 2 x 2 at pf 2).  The cell forms p with the scatter's expression and
// the tap's weight from the same floor and fraction, so each tap is
// counted by the cell it lands on; a face cell also gathers the virtual
// cells past it, the taps the scatter clips onto it.  Every 2D slice
// covers the whole disc, so nothing is culled: a cell walks every slice
// of its class, in the order the wrapper sorts them (class, then image),
// sums in registers, and adds to F and T once.  Two calls on the same
// inputs give identical bits.
//
// A first pass forms each image's ctf * data * mask_d and ctf^2 * mask_d
// once a pixel ((L, nk^2) records of 16 bytes, one load a hit, read back
// through L1 by the gather).  A block owns a TILE_X x TILE_Y tile of one
// class plane (a thread a cell; two blocks an SM, so one stages while the
// other sums) and stages BATCH slices at a time: their rotations,
// weights, images, and the separable translation ramp exp(i tpos (vc tx +
// vr ty)) as two tables of nk sincos values a slice, so a hit costs one
// complex product for the ramp.
//
// What bounds it on Hopper: operations.  A cell tests the candidates of
// every slice of its class and forms the one or two that hit, where the
// scatter formed each sample once and paid shared-memory compare-and-swap
// adds: the gather runs at about half that scatter's speed (PERF.md
// section 6) and repeats bit for bit.  The planes are read and written
// once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// (ops/insert.py reads these from this file for its launch plan)
constexpr int TILE_X = 32;   // cells a tile row
constexpr int TILE_Y = 16;   // rows a tile
constexpr int THREADS = TILE_X * TILE_Y;
constexpr int BATCH = 32;    // slices staged at once
constexpr float REACH = 1.4142136f + 1e-2f;   // sqrt 2 and a margin for rounding
constexpr float STRIP = 1.f + 1e-2f;          // the same margin on a cell's half-width
// HK12: a cell within sqrt 5 of a sample; the margin widens the
// candidate ranges (ops/insert.py SWEEP_REACH_2D, SWEEP_MARGIN)
constexpr float SWEEP_REACH = 2.2360680f + 1e-2f;
constexpr float SWEEP_MARGIN = 1e-2f;
constexpr int SWEEP_SWAP_HK = 4;

// the first pass: (Re, Im) of ft * ctf * mask_d and ctf^2 * mask_d of
// every image at every in-disc window pixel (zero elsewhere), one
// 16-byte record a pixel
__global__ void form_images_kernel(const float2* __restrict__ ft, int size,
                                   const float* __restrict__ ctfk, int r_u, float box_a,
                                   float4* __restrict__ recs, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nk = 2 * r_u - 1, rr = r_u - 1, npx = nk * nk;
  long long img = idx / npx;
  int p = (int)(idx - img * npx);
  int vr = p / nk - rr, vc = p % nk - rr;
  float2 v = make_float2(0.f, 0.f);
  float c2 = 0.f;
  if (vc * vc + vr * vr < rr * rr) {
    const float* k = ctfk + 8 * img;   // [k1, k2, w1, w2, du, dv, theta, phase]
    float fx = (float)vc / box_a, fy = (float)vr / box_a;
    float f = sqrtf(fx * fx + fy * fy);
    float f2 = f * f;
    float ang = atan2f((float)vr, (float)vc);
    float defocus = -(k[4] + k[5] + (k[4] - k[5]) * cosf(2.f * (ang - k[6]))) / 2.f;
    float chi = k[0] * defocus * f2 + k[1] * (f2 * f2) - k[7];
    float ctf = -k[2] * sinf(chi) + k[3] * cosf(chi);
    float cm = ctf * ((vc == 0 && vr == 0) ? 2.f : 1.f);
    float2 d = ft[(img * size + (size / 2 + vr)) * size + (size / 2 + vc)];
    v = make_float2(d.x * cm, d.y * cm);
    c2 = ctf * cm;
  }
  recs[idx] = make_float4(v.x, v.y, c2, 0.f);
}

__device__ __forceinline__ float axis_weight(int t, int v, float frac) {
  return t == v ? 1.f - frac : (t + 1 == v ? frac : -1.f);
}

__device__ __forceinline__ float hat1(float t) { return fmaxf(0.f, __fsub_rn(1.f, fabsf(t))); }

// HK12's candidate range of a pass index (ops/insert.py _sweep_range)
__device__ __forceinline__ void sweep_range(float centre, float coef, int rr, int& lo, int& hi) {
  const float half = __fdiv_rn(1.f, fabsf(coef));
  lo = max(-rr, (int)ceilf(__fsub_rn(__fsub_rn(centre, half), SWEEP_MARGIN)));
  hi = min(rr, (int)floorf(__fadd_rn(__fadd_rn(centre, half), SWEEP_MARGIN)));
}

// SWEEP (HK12): rot holds each slice's sweep coefficients (ey1, ey2,
// p_h, q_y) and flags its h/k swap; else (HK6) its rotation.
template <int MAXC, bool SWEEP>
__global__ void __launch_bounds__(THREADS, 2) insert_bilinear_2d_kernel(
    const float4* __restrict__ recs, const int* __restrict__ img_idx,
    const int* __restrict__ cls_start, const float* __restrict__ rot,
    const int* __restrict__ flags, const float* __restrict__ trans,
    const float* __restrict__ wsl, int r_u, int pf, float max_radius_pad, float tpos,
    float2* __restrict__ F, float* __restrict__ T, int big, int win_lo, int win, int vlo,
    int vhi) {
  extern __shared__ __align__(16) float smem[];
  const int nk = 2 * r_u - 1, rr = r_u - 1;
  float2* EX = reinterpret_cast<float2*>(smem);     // BATCH x nk
  float2* EY = EX + BATCH * nk;                     // BATCH x nk
  float* SR = reinterpret_cast<float*>(EY + BATCH * nk);   // BATCH x 4
  float* SW = SR + 4 * BATCH;                       // BATCH
  int* SI = reinterpret_cast<int*>(SW + BATCH);     // BATCH
  int* SF = SI + BATCH;                             // BATCH (HK12: its flags)

  const int n_tx = (win + TILE_X - 1) / TILE_X;
  const int tx0 = win_lo + (blockIdx.x % n_tx) * TILE_X;
  const int ty0 = win_lo + (blockIdx.x / n_tx) * TILE_Y;
  const int cls = blockIdx.y;
  const int cb = big / 2;
  const int hi = win_lo + win - 1;
  const float lim = max_radius_pad + (SWEEP ? SWEEP_REACH : REACH);
  {
    auto near = [&](int a, int b) { return (float)(a > cb ? a - cb : (b < cb ? cb - b : 0)); };
    float nx = near(tx0, min(tx0 + TILE_X - 1, hi)), ny = near(ty0, min(ty0 + TILE_Y - 1, hi));
    if (nx * nx + ny * ny >= lim * lim) return;
  }
  const int tid = threadIdx.x;
  const int ix = tx0 + (tid % TILE_X), iy = ty0 + (tid / TILE_X);
  const int kx = ix - cb, ky = iy - cb;
  const bool active = ix <= hi && iy <= hi && (float)(kx * kx + ky * ky) < lim * lim;
  // a face cell also owns the taps clipped onto it
  const int vx0 = ix == 0 ? min(vlo, 0) : ix, vx1 = ix == big - 1 ? max(vhi, big - 1) : ix;
  const int vy0 = iy == 0 ? min(vlo, 0) : iy, vy1 = iy == big - 1 ? max(vhi, big - 1) : iy;
  const float mr2 = max_radius_pad * max_radius_pad;
  const float inv_pf = 1.f / (float)pf;
  const int s_lo = cls_start[cls], s_hi = cls_start[cls + 1];
  float acc_re = 0.f, acc_im = 0.f, acc_t = 0.f;
  bool hit = false;

  for (int sb = s_lo; sb < s_hi; sb += BATCH) {
    const int nb = min(BATCH, s_hi - sb);
    __syncthreads();   // the previous batch is consumed
    for (int i = tid; i < nb * nk; i += THREADS) {
      int b = i / nk, m = i - b * nk;
      float v = (float)(m - rr);
      float sx, cx, sy, cy;
      sincosf(tpos * (v * trans[2 * (sb + b)]), &sx, &cx);
      sincosf(tpos * (v * trans[2 * (sb + b) + 1]), &sy, &cy);
      EX[b * nk + m] = make_float2(cx, sx);
      EY[b * nk + m] = make_float2(cy, sy);
    }
    for (int i = tid; i < nb * 4; i += THREADS) SR[i] = rot[4 * sb + i];
    for (int i = tid; i < nb; i += THREADS) {
      SW[i] = wsl[sb + i];
      SI[i] = img_idx[sb + i];
      if (SWEEP) SF[i] = flags[sb + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int b = 0; b < nb; ++b) {
      const float w = SW[b];
      if (w == 0.f) continue;
      const float R0 = SR[4 * b], R1 = SR[4 * b + 1], R2 = SR[4 * b + 2], R3 = SR[4 * b + 3];
      const long long img = SI[b];
      const float2* ex = EX + b * nk + rr;
      const float2* ey = EY + b * nk + rr;
      if (SWEEP) {
        // the sweep's samples of the cell: h from the x pass, then k from
        // the y pass, each weight formed as the plain version forms it
        // (ops/insert.py _sweep_taps); nothing lies past a face
        const float ey1 = R0, ey2 = R1, p_h = R2, q_y = R3;
        const bool shk = (SF[b] & SWEEP_SWAP_HK) != 0;
        const float fx = (float)(ix - cb), fy = (float)(iy - cb);
        int h0, h1;
        sweep_range(__fdiv_rn(__fsub_rn(fx, __fmul_rn(q_y, fy)), p_h), p_h, rr, h0, h1);
        for (int h = h0; h <= h1; ++h) {
          const float hf = (float)h;
          const float wx = hat1(__fsub_rn(fx, __fadd_rn(__fmul_rn(p_h, hf), __fmul_rn(q_y, fy))));
          if (!(wx > 0.f)) continue;
          int k0, k1;
          sweep_range(__fdiv_rn(__fsub_rn(fy, __fmul_rn(ey1, hf)), ey2), ey2, rr, k0, k1);
          for (int k = k0; k <= k1; ++k) {
            const float wy =
                hat1(__fsub_rn(fy, __fadd_rn(__fmul_rn(ey1, hf), __fmul_rn(ey2, (float)k))));
            const int vr = shk ? k : h, vc = shk ? h : k;
            if (!(wy > 0.f) || vc * vc + vr * vr >= rr * rr) continue;
            const float4 d = __ldg(recs + img * nk * nk + (vr + rr) * nk + (vc + rr));
            const float wt = __fmul_rn(wy, wx);
            const float2 a = ex[vc], e = ey[vr];
            const float er = a.x * e.x - a.y * e.y, ei = a.x * e.y + a.y * e.x;
            const float vre = (d.x * er - d.y * ei) * w;
            const float vim = (d.x * ei + d.y * er) * w;
            acc_re += vre * wt;
            acc_im += vim * wt;
            acc_t += (d.z * w) * wt;
            hit = true;
          }
        }
        continue;
      }
      for (int vy = vy0; vy <= vy1; ++vy)
        for (int vx = vx0; vx <= vx1; ++vx) {
          const float fx = (float)(vx - cb), fy = (float)(vy - cb);
          const float ax = R0 * fx + R2 * fy, ay = R1 * fx + R3 * fy;   // R^T k
          // the box of candidates within REACH of (R^T k) / pf starts at
          // (c0, r0) and is at most MAXC wide an axis; the strip test below
          // rejects what lies past its far side
          const int c0 = (int)ceilf((ax - REACH) * inv_pf);
          const int r0 = (int)ceilf((ay - REACH) * inv_pf);
          // p = R g - k at the box's corner, and its steps along vc and vr
          const float gx0 = (float)(c0 * pf), gy0 = (float)(r0 * pf), fpf = (float)pf;
          const float u0 = R0 * gx0 + R1 * gy0 - fx, v0 = R2 * gx0 + R3 * gy0 - fy;
          const float du_c = R0 * fpf, du_r = R1 * fpf, dv_c = R2 * fpf, dv_r = R3 * fpf;
          // the candidates that pass the cheap tests first (p within a
          // cell's half-width of k on both axes, a margin for rounding:
          // nearly every one is a hit), then the exact work once for each
          unsigned slots = 0;
#pragma unroll
          for (int j = 0; j < MAXC; ++j) {
            const int vr = r0 + j;
#pragma unroll
            for (int i = 0; i < MAXC; ++i) {
              const int vc = c0 + i;
              if (vc * vc + vr * vr < rr * rr &&
                  fabsf(u0 + (float)i * du_c + (float)j * du_r) < STRIP &&
                  fabsf(v0 + (float)i * dv_c + (float)j * dv_r) < STRIP)
                slots |= 1u << (j * MAXC + i);
            }
          }
          while (slots) {
            const int bit = __ffs(slots) - 1;
            slots &= slots - 1;
            const int vc = c0 + bit % MAXC, vr = r0 + bit / MAXC;
            // the load first, and no branch before its use, so the
            // position's arithmetic hides its latency
            const float4 d = __ldg(recs + img * nk * nk + (vr + rr) * nk + (vc + rr));
            // the sample's position, rounded as the scatter rounds it
            const float gx = (float)(vc * pf), gy = (float)(vr * pf);
            const float x = __fadd_rn(__fmul_rn(R0, gx), __fmul_rn(R1, gy));
            const float y = __fadd_rn(__fmul_rn(R2, gx), __fmul_rn(R3, gy));
            const float flx = floorf(x), fly = floorf(y);
            const float wx = axis_weight((int)flx + cb, vx, x - flx);
            const float wy = axis_weight((int)fly + cb, vy, y - fly);
            const bool ok = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)) < mr2 && wx >= 0.f &&
                            wy >= 0.f;
            const float wt = ok ? wy * wx : 0.f;
            // conj(tra) = exp(+i tpos (vc tx + vr ty)) = ex[vc] ey[vr]
            const float2 a = ex[vc], e = ey[vr];
            const float er = a.x * e.x - a.y * e.y, ei = a.x * e.y + a.y * e.x;
            const float vre = (d.x * er - d.y * ei) * w;
            const float vim = (d.x * ei + d.y * er) * w;
            acc_re += vre * wt;
            acc_im += vim * wt;
            acc_t += (d.z * w) * wt;
            hit = hit || ok;
          }
        }
    }
  }
  if (active && hit) {
    long long cell = ((long long)cls * big + iy) * big + ix;
    float2 f = F[cell];
    F[cell] = make_float2(f.x + acc_re, f.y + acc_im);
    T[cell] += acc_t;
  }
}

}  // namespace

// ft (L, size, size) complex64; ctfk (L, 8); per slice, sorted by
// (class, image): img_idx (B,) int32, rot (B, 2, 2), trans (B, 2), w
// (B,); cls_start (K + 1,) int32, the first sorted slice of each class;
// recs (L, nk^2, 4) float32: scratch for the images' formed values; F
// (K, big, big) complex64 and T float32,
// accumulated into.  The tiles cover the window [win_lo, win_lo +
// win)^2; vlo / vhi: the lowest and highest index a tap can take; smem:
// the staged batch's bytes (insert_2d_plan).
extern "C" int thunder_insert_bilinear_2d(
    const void* ft, int size, const void* ctfk, int n_img, const void* img_idx,
    const void* cls_start, int n_class, const void* rot, const void* trans, const void* w,
    int r_u, int pf, float max_radius_pad, float box_a, float tpos, void* F, void* T, void* recs,
    int big, int win_lo, int win, int vlo, int vhi, int threads, int smem, void* stream) {
  if (threads != THREADS) return (int)cudaErrorInvalidValue;
  if (n_class <= 0 || n_img <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = 2 * r_u - 1;
  long long total = (long long)n_img * nk * nk;
  form_images_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float2*)ft, size, (const float*)ctfk, r_u, box_a, (float4*)recs, total);
  // candidates an axis: 2 sqrt 2 / pf + 1 of them at most
  auto kernel =
      pf == 1 ? insert_bilinear_2d_kernel<3, false> : insert_bilinear_2d_kernel<2, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_t = ((win + TILE_X - 1) / TILE_X) * ((win + TILE_Y - 1) / TILE_Y);
  kernel<<<dim3(n_t, n_class), THREADS, smem, st>>>(
      (const float4*)recs, (const int*)img_idx, (const int*)cls_start,
      (const float*)rot, nullptr, (const float*)trans, (const float*)w, r_u, pf,
      max_radius_pad, tpos, (float2*)F, (float*)T, big, win_lo, win, vlo, vhi);
  return (int)cudaGetLastError();
}

// HK12.  HK6's arguments with coef (B, 4), the sorted slices' sweep
// coefficients (ey1, ey2, p_h, q_y), and flags (B,) int32 their h/k
// swaps (ops/insert.py sweep_coeffs_2d) in place of the rotations; the
// tiles cover [win_lo, win_lo + win)^2 (insert_2d_plan(sweep=True)), and
// no tap range: the sweep drops what lies past the plane.
extern "C" int thunder_insert_sweep_2d(
    const void* ft, int size, const void* ctfk, int n_img, const void* img_idx,
    const void* cls_start, int n_class, const void* coef, const void* flags, const void* trans,
    const void* w, int r_u, int pf, float max_radius_pad, float box_a, float tpos, void* F,
    void* T, void* recs, int big, int win_lo, int win, int threads, int smem, void* stream) {
  if (threads != THREADS) return (int)cudaErrorInvalidValue;
  if (n_class <= 0 || n_img <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = 2 * r_u - 1;
  long long total = (long long)n_img * nk * nk;
  form_images_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float2*)ft, size, (const float*)ctfk, r_u, box_a, (float4*)recs, total);
  auto kernel = insert_bilinear_2d_kernel<2, true>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_t = ((win + TILE_X - 1) / TILE_X) * ((win + TILE_Y - 1) / TILE_Y);
  kernel<<<dim3(n_t, n_class), THREADS, smem, st>>>(
      (const float4*)recs, (const int*)img_idx, (const int*)cls_start, (const float*)coef,
      (const int*)flags, (const float*)trans, (const float*)w, r_u, pf, max_radius_pad, tpos,
      (float2*)F, (float*)T, big, win_lo, win, 0, big - 1);
  return (int)cudaGetLastError();
}
