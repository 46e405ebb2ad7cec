// HK6 insert_bilinear_2d: Fourier insertion of compacted 2D slices into
// per-class (F, T) planes as a gather, each plane cell forming its own
// sum; HK12 insert_sweep_2d: the rounds' 2D shear sweep as a tile-owned
// scatter with order-free fixed-point sums.
//
// Replaces (thunder_tpu): HK12, the rounds' 2D insertion,
// optimiser.py:1273 one_2d_sweep over ops/insert.py:721 insert_sweep_2d
// (the scatter-free adjoint of a sheared resampler, built because the
// TPU's scatter was the 2D-classification bottleneck at mReco = 100);
// HK6, the bilinear scatter insert_slices_2d after _insert_class's 2D
// value formation and the Hermitian fold, which the insertion option
// reco_kernel="mkb" takes in 2D.
//
// HK12's map: with (h, k) = (vr, vc), or (vc, vr) where the slice's h/k
// swap is set, sample (h, k) adds to cell (x, y) with hat(y - ey1 h - ey2
// k) hat(x - p_h h - q_y y), hat(t) = max(0, 1 - |t|): 2 x 2 cells a
// sample, within sqrt 5 of it (|y - P_y| < 1, |x - P_x| < 1 + |q_y| <= 2),
// the coefficients formed on the host (ops/insert.py sweep_coeffs_2d);
// what lies past the plane is dropped.  Its design (sweep_tile_kernel
// below, sweep_fixed.cuh): a block owns a SWEEP_TILE^2 tile of one class
// plane as 128-bit sums in shared memory and walks that class's slices, a
// warp a slice: the lanes test the samples (h, k) whose taps can land in
// the tile (h from the x pass, k from the y pass, each range widened for
// rounding), and those that pass go on eight at a time, a quarter-warp
// each, a lane forming one of the sample's 2 x 2 taps: the value (the
// image's record from the first pass, the translation ramp from a table
// the warp forms for the box's columns and rows, the slice's weight) and
// the weight as the plain version forms them (ops/insert.py _sweep_taps),
// added where it lies inside the tile with 32-bit integer atomics and
// their carries.  The tile is
// written once.  The sums are fixed-point, so every rerun repeats bit for
// bit, and each sample is formed by the one to four tiles its taps reach,
// not by each of its cells and the candidates around them as the
// cell-owned gather it replaced did.  Bound by operations: the tests, the value formation
// and the shared-memory atomics of the samples (PERF.md section 6).
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

#include "sweep_fixed.cuh"

namespace {

// (ops/insert.py reads these from this file for its launch plan)
constexpr int TILE_X = 32;   // cells a tile row
constexpr int TILE_Y = 16;   // rows a tile
constexpr int THREADS = TILE_X * TILE_Y;
constexpr int BATCH = 32;    // slices staged at once
constexpr float REACH = 1.4142136f + 1e-2f;   // sqrt 2 and a margin for rounding
constexpr float STRIP = 1.f + 1e-2f;          // the same margin on a cell's half-width
// HK12: a cell within sqrt 5 of a sample, and a margin for rounding
// (ops/insert.py SWEEP_REACH_2D)
constexpr float SWEEP_REACH = 2.2360680f + 1e-2f;
constexpr int SWEEP_SWAP_HK = 4;
constexpr int SWEEP_TILE = 32;      // cells a tile edge, 32 (tile_addr; ops/insert.py reads these)
constexpr int SWEEP_THREADS = 512;
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;

// the first pass: (Re, Im) of ft * ctf * mask_d and ctf^2 * mask_d of
// every image at every in-disc window pixel (zero elsewhere), one
// 16-byte record a pixel
__device__ __forceinline__ float4 form_image(const float2* __restrict__ ft, int size,
                                             const float* __restrict__ ctfk, int r_u,
                                             float box_a, long long idx) {
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
  return make_float4(v.x, v.y, c2, 0.f);
}

__global__ void form_images_kernel(const float2* __restrict__ ft, int size,
                                   const float* __restrict__ ctfk, int r_u, float box_a,
                                   float4* __restrict__ recs, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  recs[idx] = form_image(ft, size, ctfk, r_u, box_a, idx);
}

// HK12's first pass: the records, and the maxima of |Re| + |Im| (twice)
// and of |c2| over them (sweep_fixed.cuh)
__global__ void sweep_images_kernel(const float2* __restrict__ ft, int size,
                                    const float* __restrict__ ctfk, int r_u, float box_a,
                                    float4* __restrict__ recs, long long total,
                                    unsigned* __restrict__ vmax) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (idx < total) {
    r = form_image(ft, size, ctfk, r_u, box_a, idx);
    recs[idx] = r;
  }
  const float m = fabsf(r.x) + fabsf(r.y);
  sweepfx::block_max(m, vmax);
  sweepfx::block_max(m, vmax + 1);
  sweepfx::block_max(fabsf(r.z), vmax + 2);
}

// the maximum of |w| over the slices
__global__ void weights_max_kernel(const float* __restrict__ w, int n,
                                   unsigned* __restrict__ vmax) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  sweepfx::block_max(idx < n ? fabsf(w[idx]) : 0.f, vmax + 3);
}

__device__ __forceinline__ float axis_weight(int t, int v, float frac) {
  return t == v ? 1.f - frac : (t + 1 == v ? frac : -1.f);
}

template <int MAXC>
__global__ void __launch_bounds__(THREADS, 2) insert_bilinear_2d_kernel(
    const float4* __restrict__ recs, const int* __restrict__ img_idx,
    const int* __restrict__ cls_start, const float* __restrict__ rot,
    const float* __restrict__ trans,
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

  const int n_tx = (win + TILE_X - 1) / TILE_X;
  const int tx0 = win_lo + (blockIdx.x % n_tx) * TILE_X;
  const int ty0 = win_lo + (blockIdx.x / n_tx) * TILE_Y;
  const int cls = blockIdx.y;
  const int cb = big / 2;
  const int hi = win_lo + win - 1;
  const float lim = max_radius_pad + REACH;
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

// A tile cell's word in shared memory: rows of 32, each row's columns
// rotated by 3 a row, so that the lanes of a warp, whose samples lie about
// pf cells apart in any direction, hit different banks (unrotated, steps
// along y fall in one bank)
__device__ __forceinline__ int tile_addr(int lx, int ly) {
  return ly * SWEEP_TILE + ((lx + 3 * ly) & (SWEEP_TILE - 1));
}

// HK12: see the head of this file.  Class blockIdx.y's slices are
// cls_start[k] .. cls_start[k + 1] - 1 of the sorted ones.
__global__ void __launch_bounds__(SWEEP_THREADS, 2) sweep_tile_kernel(
    const float4* __restrict__ recs, const int* __restrict__ img_idx,
    const int* __restrict__ cls_start, const float* __restrict__ coef,
    const int* __restrict__ flags, const float* __restrict__ trans,
    const float* __restrict__ wsl, int r_u, float max_radius_pad, float tpos,
    float2* __restrict__ F, float* __restrict__ T, int big, int win_lo, int win,
    const unsigned* __restrict__ vmax, double count) {
  constexpr int TS = SWEEP_TILE, CELLS = SWEEP_TILE * SWEEP_TILE;
  // the sums of Re F, Im F, T, each as four planes of CELLS words, lowest first
  constexpr int W = sweepfx::WORDS;
  extern __shared__ __align__(16) unsigned acc[];
  const int nk = 2 * r_u - 1, rr = r_u - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warp's ramp tables: exp(i tpos vc tx) by vc, exp(i tpos vr ty) by vr
  float2* EX = reinterpret_cast<float2*>(acc + 3 * W * CELLS) + warp * 2 * nk + rr;
  float2* EY = EX + nk;
  const int n_t = (win + TS - 1) / TS;
  const int tx0 = win_lo + (blockIdx.x % n_t) * TS, ty0 = win_lo + (blockIdx.x / n_t) * TS;
  const int hi = win_lo + win - 1;
  const int tx1 = min(tx0 + TS - 1, hi), ty1 = min(ty0 + TS - 1, hi);
  const int cls = blockIdx.y, cb = big / 2;
  {
    auto near = [&](int a, int b) { return (float)(a > cb ? a - cb : (b < cb ? cb - b : 0)); };
    const float nx = near(tx0, tx1), ny = near(ty0, ty1);
    const float lim = max_radius_pad + SWEEP_REACH;
    if (nx * nx + ny * ny >= lim * lim) return;
  }
  for (int i = tid; i < 3 * W * CELLS; i += SWEEP_THREADS) acc[i] = 0u;
  // the bound: |value| <= max(|Re| + |Im|) (or |c2|) max |w| times the
  // ramp's modulus (1 and a few ulps: the factor 2 covers it)
  int sx[3];   // each component's scale 2^sx
  const double wmax = (double)__uint_as_float(vmax[3]);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    sx[c] = sweepfx::scale_exp(((count * (double)__uint_as_float(vmax[c])) * wmax) * 2.0);
  const int xl = tx0 - cb, xh = tx1 - cb, yl = ty0 - cb, yh = ty1 - cb;
  __syncthreads();

  const int s_lo = cls_start[cls], s_hi = cls_start[cls + 1];
  for (int sb = s_lo + warp; sb < s_hi; sb += SWEEP_WARPS) {
    const float w = wsl[sb];
    if (w == 0.f) continue;
    const float ey1 = coef[4 * sb], ey2 = coef[4 * sb + 1];
    const float p_h = coef[4 * sb + 2], q_y = coef[4 * sb + 3];
    const bool shk = (flags[sb] & SWEEP_SWAP_HK) != 0;
    // h from the x pass: p_h h + q_y y within 1 of [xl, xh] for some y of
    // [yl, yh]; k from the y pass: ey1 h + ey2 k within 1 of [yl, yh]
    const float qa = q_y * (float)yl, qb = q_y * (float)yh;
    int h0, h1, k0, k1;
    sweepfx::pass_range((float)xl - 1.f - fmaxf(qa, qb) - sweepfx::RANGE_MARGIN,
                        (float)xh + 1.f - fminf(qa, qb) + sweepfx::RANGE_MARGIN, p_h, rr, h0, h1);
    if (h0 > h1) continue;
    const float ea = ey1 * (float)h0, eb = ey1 * (float)h1;
    sweepfx::pass_range((float)yl - 1.f - fmaxf(ea, eb) - sweepfx::RANGE_MARGIN,
                        (float)yh + 1.f - fminf(ea, eb) + sweepfx::RANGE_MARGIN, ey2, rr, k0, k1);
    if (k0 > k1) continue;
    const int c0 = shk ? h0 : k0, c1 = shk ? h1 : k1, r0 = shk ? k0 : h0, r1 = shk ? k1 : h1;
    const float tx = trans[2 * sb], ty = trans[2 * sb + 1];
    __syncwarp();   // the previous slice's tables are read
    for (int j = c0 + lane; j <= c1; j += 32) {
      const float ph = __fmul_rn(tpos, __fmul_rn((float)j, tx));
      EX[j] = make_float2(cosf(ph), sinf(ph));
    }
    for (int j = r0 + lane; j <= r1; j += 32) {
      const float ph = __fmul_rn(tpos, __fmul_rn((float)j, ty));
      EY[j] = make_float2(cosf(ph), sinf(ph));
    }
    __syncwarp();
    const float4* rec = recs + (long long)img_idx[sb] * nk * nk;
    const int nkk = k1 - k0 + 1, n_cand = (h1 - h0 + 1) * nkk;
    // (j + 1/2) / nkk lies 1/2 nkk from an integer, far past the float
    // quotient's error at these sizes: its floor is j's row
    const float inv_nkk = 1.f / (float)nkk;
    for (int base = 0; base < n_cand; base += 32) {
      // the lanes test 32 candidates; those that pass go on, eight at a
      // time, to quarters of the warp, a lane a tap (2 x 2 a sample)
      const int j = base + lane;
      const int dh = (int)(((float)j + 0.5f) * inv_nkk);
      const int h = h0 + dh, k = k0 + (j - dh * nkk);
      const int vr = shk ? k : h, vc = shk ? h : k;
      bool pass = j < n_cand && vc * vc + vr * vr < rr * rr;
      if (pass) {
        // a tap in the tile, formed as the taps are
        const float hf = (float)h;
        const float fm = floorf(__fadd_rn(__fmul_rn(ey1, hf), __fmul_rn(ey2, (float)k)));
        bool in = false;
#pragma unroll
        for (int dm = 0; dm < 2; ++dm) {
          const float mp = fm + (float)dm;
          const float fl = floorf(__fadd_rn(__fmul_rn(p_h, hf), __fmul_rn(q_y, mp)));
          in = in || (mp >= (float)yl && mp <= (float)yh && fl + 1.f >= (float)xl &&
                      fl <= (float)xh);
        }
        pass = in;
      }
      unsigned todo = __ballot_sync(0xffffffffu, pass);
      while (todo) {
        // the (lane / 4)-th sample still to do, or none
        unsigned rest = todo;
        for (int i = 0; i < (lane >> 2) && rest; ++i) rest &= rest - 1;
        const int src = rest ? __ffs(rest) - 1 : -1;
        for (int i = 0; i < 8 && todo; ++i) todo &= todo - 1;
        const int hs = __shfl_sync(0xffffffffu, h, src < 0 ? 0 : src);
        const int ks = __shfl_sync(0xffffffffu, k, src < 0 ? 0 : src);
        if (src < 0) continue;
        const int dm = (lane >> 1) & 1, dl = lane & 1;
        const float hf = (float)hs;
        const float ctr_m = __fadd_rn(__fmul_rn(ey1, hf), __fmul_rn(ey2, (float)ks));
        const float mp = floorf(ctr_m) + (float)dm;
        const float w3 = sweepfx::hat1(__fsub_rn(mp, ctr_m));
        const float ctr_l = __fadd_rn(__fmul_rn(p_h, hf), __fmul_rn(q_y, mp));
        const float lp = floorf(ctr_l) + (float)dl;
        const float wt = __fmul_rn(w3, sweepfx::hat1(__fsub_rn(lp, ctr_l)));
        if (!(wt > 0.f) || mp < (float)yl || mp > (float)yh || lp < (float)xl || lp > (float)xh)
          continue;
        const int vrs = shk ? ks : hs, vcs = shk ? hs : ks;
        const float4 d = __ldg(rec + (vrs + rr) * nk + (vcs + rr));
        // conj(tra) = exp(+i tpos (vc tx + vr ty)) = EX[vc] EY[vr]
        const float2 a = EX[vcs], e = EY[vrs];
        const float er = __fsub_rn(__fmul_rn(a.x, e.x), __fmul_rn(a.y, e.y));
        const float ei = __fadd_rn(__fmul_rn(a.x, e.y), __fmul_rn(a.y, e.x));
        const float vc3[3] = {__fmul_rn(__fsub_rn(__fmul_rn(d.x, er), __fmul_rn(d.y, ei)), w),
                              __fmul_rn(__fadd_rn(__fmul_rn(d.x, ei), __fmul_rn(d.y, er)), w),
                              __fmul_rn(d.z, w)};
        const int cell = tile_addr((int)lp - xl, (int)mp - yl);
        sweepfx::Tap q[3];
        bool nz[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) nz[c] = sweepfx::quantise(vc3[c], wt, sx[c], q[c]);
        sweepfx::fixed_add3(acc + cell, CELLS, q, nz);
      }
    }
  }
  __syncthreads();
  // the tile, once: disjoint from every other block's
  const double inv[3] = {ldexp(1.0, -sx[0]), ldexp(1.0, -sx[1]), ldexp(1.0, -sx[2])};
  for (int i = tid; i < CELLS; i += SWEEP_THREADS) {
    const int ix = tx0 + i % TS, iy = ty0 + i / TS;
    if (ix > tx1 || iy > ty1) continue;
    const unsigned* ar = acc + tile_addr(i % TS, i / TS);
    const unsigned *ai = ar + W * CELLS, *at = ai + W * CELLS;
    const bool r = sweepfx::nonzero(ar, CELLS), im = sweepfx::nonzero(ai, CELLS);
    const bool t = sweepfx::nonzero(at, CELLS);
    if (!(r || im || t)) continue;
    const long long cell = ((long long)cls * big + iy) * big + ix;
    if (r || im) {
      float2 f = F[cell];
      if (r) f.x = __fadd_rn(f.x, sweepfx::unquantise(ar, CELLS, inv[0]));
      if (im) f.y = __fadd_rn(f.y, sweepfx::unquantise(ai, CELLS, inv[1]));
      F[cell] = f;
    }
    if (t) T[cell] = __fadd_rn(T[cell], sweepfx::unquantise(at, CELLS, inv[2]));
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
  auto kernel = pf == 1 ? insert_bilinear_2d_kernel<3> : insert_bilinear_2d_kernel<2>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_t = ((win + TILE_X - 1) / TILE_X) * ((win + TILE_Y - 1) / TILE_Y);
  kernel<<<dim3(n_t, n_class), THREADS, smem, st>>>(
      (const float4*)recs, (const int*)img_idx, (const int*)cls_start,
      (const float*)rot, (const float*)trans, (const float*)w, r_u, pf,
      max_radius_pad, tpos, (float2*)F, (float*)T, big, win_lo, win, vlo, vhi);
  return (int)cudaGetLastError();
}

// HK12.  HK6's arguments with coef (B, 4), the sorted slices' sweep
// coefficients (ey1, ey2, p_h, q_y), and flags (B,) int32 their h/k
// swaps (ops/insert.py sweep_coeffs_2d) in place of the rotations; the
// tiles cover [win_lo, win_lo + win)^2 (sweep_2d_plan); smem the
// tiles' and the ramp tables' bytes; vmax (4,) uint32 scratch for the
// maxima; count, the samples the launch may add (B times the in-disc
// pixels): the fixed-point scale's bound.  recs holds the images'
// records after the call.
extern "C" int thunder_insert_sweep_2d(
    const void* ft, int size, const void* ctfk, int n_img, const void* img_idx,
    const void* cls_start, int n_class, const void* coef, const void* flags, const void* trans,
    const void* w, int n_slices, int r_u, float max_radius_pad, float box_a, float tpos, void* F,
    void* T, void* recs, int big, int win_lo, int win, int threads, int smem, void* vmax,
    double count, void* stream) {
  if (threads != SWEEP_THREADS) return (int)cudaErrorInvalidValue;
  // the tile's sums and every warp's two ramp tables
  const long long need = 3LL * sweepfx::WORDS * SWEEP_TILE * SWEEP_TILE * 4 +
                         (long long)SWEEP_WARPS * 2 * (2 * r_u - 1) * 8;
  if ((long long)smem < need) return (int)cudaErrorInvalidValue;
  if (n_class <= 0 || n_img <= 0 || n_slices <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(vmax, 0, 4 * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const int nk = 2 * r_u - 1;
  long long total = (long long)n_img * nk * nk;
  sweep_images_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float2*)ft, size, (const float*)ctfk, r_u, box_a, (float4*)recs, total,
      (unsigned*)vmax);
  weights_max_kernel<<<(unsigned)((n_slices + 255) / 256), 256, 0, st>>>((const float*)w,
                                                                       n_slices, (unsigned*)vmax);
  e = cudaFuncSetAttribute((const void*)sweep_tile_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int n_t = (win + SWEEP_TILE - 1) / SWEEP_TILE;
  sweep_tile_kernel<<<dim3(n_t * n_t, n_class), SWEEP_THREADS, smem, st>>>(
      (const float4*)recs, (const int*)img_idx, (const int*)cls_start, (const float*)coef,
      (const int*)flags, (const float*)trans, (const float*)w, r_u, max_radius_pad, tpos,
      (float2*)F, (float*)T, big, win_lo, win, (const unsigned*)vmax, count);
  return (int)cudaGetLastError();
}
