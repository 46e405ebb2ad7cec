// HK3 insert_trilinear: Fourier insertion of slices as a gather, each
// output cell forming its own sum; HK11 insert_sweep
// (one grid, and its slab form): the rounds' shear sweep as a
// brick-owned scatter with order-free fixed-point sums.
//
// Replaces (thunder_tpu): HK11, the rounds' insertion,
// optimiser.py:1400 _insert_flat3d_h / :1305 one_3d over ops/insert.py
// insert_sweep_3d (the scatter-free shear sweep), and its slab form
// recon/sharded.py:300 insert_sweep_3d_sharded (F / T as z-slabs, the
// point group's mates pose-side); HK3, the exact trilinear scatter
// ops/insert.py:76 insert_slices_3d that cli/reconstruct.py takes.  HK10
// (the MKB option) is csrc/insert_mkb.cu.
//
// HK11's map.  In the canonical axes (a, m, l) of a plane (a the axis
// most aligned with its normal, case 0 x, 1 y, 2 z; m = z, or y for case
// z; l = x, or y for case x), sample (h, k) of the dense window (h, k =
// vr, vc, or vc, vr where the plane's h/k swap is set) adds to cell (a,
// m, l) with the weight
//     hat(m' - em1 h - em2 k) hat(l' - p_h h - q_m m') hat((a - zeta) / 2) / 2,
// zeta = alpha l + beta m the plane's height at (m, l), (m', l') = (m,
// l), or (l, m) where its m/l swap is set, hat(t) = max(0, 1 - |t|):
// 2 x 2 x 4 cells a sample.  The host forms each plane's record (em1,
// em2, p_h, q_m, alpha, beta, flags) once (ops/insert.py sweep_coeffs,
// thunder_tpu's _sweep_coeffs expressions); the kernel forms each tap's
// weight from it as the plain version does (ops/insert.py _sweep_taps).
// Nothing is clipped: cells past the grid are dropped.  A tap lies within
// 1 of the sample along m', 2 along l' and 5 along a (|m - P_m| < 1, |l -
// P_l| < 1 + |q_m| <= 2, |a - P_a| < 2 + 2 |alpha| + |beta|: within sqrt
// 30 of a sample P), but only 2 |n_a| <= 2 from the plane along its
// normal (n . k = n_a (a - zeta)): bricks are culled at max_radius_pad +
// SWEEP_REACH, planes listed within the half-diagonal + SWEEP_BAND.
// thunder_tpu streams its hat fields as bf16; HK11 forms them in
// float32.  Its slab form lists the planes (slice, mate) of the point
// group's mates M pose-side, each with the record of M R formed on the
// host, adds only to the cells of its z-slab and, for a mate other than
// the identity, only inside the radius (HK7's cut, so that for
// signed-permutation groups the slabs equal HK11 then HK7).
//
// HK11's design (sweep_brick_kernel below, sweep_fixed.cuh): a block
// owns a 16 x 16 x 8 brick as 128-bit sums in shared memory and forms
// each sample whose taps can reach the brick once, adding its taps there
// with 32-bit integer atomics and their carries; the sums are fixed-point,
// so every rerun repeats bit for bit, and a sample's position is formed by the few bricks it
// reaches, not by each of its 16 cells and the candidates around them
// as the cell-owned gather it replaced did.

// The scatter it computes: sample (vc, vr) of slice s (a pixel of the
// nk x nk window, nk = 2 r_u - 1) sits at p = R_s . (pf vc, pf vr, 0),
// products and sums rounded one by one as the plain version forms them;
// |p| >= max_radius_pad drops it; q = p adds val * w to its 8 trilinear
// taps, tap index floor(q) + big / 2 + {0, 1} on each axis clipped to
// [0, big - 1], w the product of the axes' weights (1 - frac or frac).
// HK3 takes the in-disc pixels vc^2 + vr^2 < (r_u - 1)^2 of slices of
// nonzero weight.  HK3's values (optimiser.py:1441-1501):
//   mask_d = 2 at the DC, else 1
//   val    = ft[img[s], c + vr, c + vc] * conj(tra_s) * ctf * mask_d * w[s]
//   c2w    = ctf^2 * mask_d * w[s]
// (tra_s the translation phase ramp, ctf from the image's constants,
// its defocus scaled by dfac[s] where one is given); HK11's slab form
// takes them formed.
//
// The gather.  Cell k (centered) receives a tap of sample q exactly when
// floor(q_i) is k_i - 1 or k_i on every axis; then |k - q| < sqrt 3, and
// as q = Q g with Q = M R a rotation and g = (pf vc, pf vr, 0), |Q^T k -
// g| < sqrt 3: the plane's normal passes within sqrt 3 of k, and the
// candidates (vc, vr) lie within sqrt 3 / pf of (Q^T k)_xy / pf (at most
// 2 x 2 at pf 2, 4 x 4 at pf 1; REACH adds a margin for the rounding of
// Q and of q).  For each candidate the cell forms q with the scatter's
// own expression, applies its cuts, and takes the tap's weight from the
// same floor and fraction, so a tap is counted by exactly the cell it
// lands on.  A tap clipped onto a face: a face cell also gathers the
// virtual cells past it (indices below 0 or above big - 1), one after
// another; no path's grid is reached past its faces (big / 2 >=
// max_radius_pad + 6 there), tests' grids are.
//
// A block owns an 8^3 brick of one class (a thread a cell; a warp a 4 x 4
// x 2 part of it).  Bricks farther than max_radius_pad + REACH from the
// centre return at once.  The block lists, in slice order,
// the planes of its class whose normal passes within the
// brick's half-diagonal + REACH of its centre (ballot and prefix sums, no
// atomic counter), CAP at a time in shared memory, with Q and the
// slice's rotation.  A warp then takes the list 32 planes at a time,
// keeps those that pass near its part, and each lane marks those that
// pass within REACH of its cell and walks its own marks in order.  For a
// marked plane a lane tests its (at most MAXC x MAXC) candidates cheaply
// first (Q g within a cell's half-width of k on every axis, a margin for
// rounding: nearly every one that passes is a hit) and does the exact
// work only for those.  Sums stay in registers; F and T are added to
// once.  Each cell's sum is therefore formed in a fixed order: two calls
// on the same inputs give identical bits.  There is no scratch grid.
//
// HK3 forms the dense window's values in a first pass, (B, nk^2) records
// (Re, Im, c2w, 0) read back with one 16-byte load a hit (HK11 too; its
// slab form's wrapper packs the given values the same way).  Forming them at
// every hit instead (a sample is hit by ~8 cells, each recomputing a CTF
// and a sincos) ran slower at every measured shape (PERF.md section 6).
//
// What bounds the gathers on Hopper: operations, not bytes.  Every
// sample's position is formed by each of the ~8 cells it reaches and by
// the candidates around them, and every cell tests each plane listed for
// its brick.  The scatter they replaced formed a position once and paid
// L2's atomic rate instead; the gather is several times slower at every
// measured shape (PERF.md section 6) and repeats bit for bit.  Two blocks
// of 512 threads an SM (64 registers, a few spilled).

#include <cuda_runtime.h>
#include <math.h>

#include "slice_values.cuh"
#include "sweep_fixed.cuh"

namespace {

constexpr int BRICK = 8;                        // cells a brick edge
constexpr int THREADS = BRICK * BRICK * BRICK;  // a thread a cell
constexpr int CAP = 1536;                       // planes a block lists at once
constexpr int MAX_SYM = 64;                     // mates a launch takes
constexpr unsigned FULL = 0xffffffffu;
// sqrt 3 and a margin that covers float rounding of Q^T k against the
// exact q (errors ~1e-4 at |k| ~ 1000) and rotations off orthonormal by ~1e-5
constexpr float REACH = 1.7320508f + 1e-2f;
constexpr float STRIP = 1.f + 1e-2f;   // the same margin on a cell's own half-width
// HK11: a cell within sqrt 30 of a sample, within 2 of its plane along
// the normal, and a margin for rounding (ops/insert.py SWEEP_REACH_3D and
// SWEEP_BAND mirror these)
constexpr float SWEEP_REACH = 5.4772256f + 1e-2f;
constexpr float SWEEP_BAND = 2.f + 1e-2f;
constexpr int SWEEP_SWAP_HK = 4, SWEEP_SWAP_ML = 8;   // a record's flags beside the case

struct Slices {
  const float4* vals;   // (B, nk^2) of (Re val, Im val, c2w, 0)
  const float2* ft;     // HK3's first pass: the images and their constants
  const float* ctfk;
  const int* img_idx;
  const float* trans;
  const float* dfac;    // null: 1
  const float* wsl;     // slice weights; zero-weight slices are not listed (null: none)
  const float* rot;     // (B, 9) row-major
  const int* cls;       // HK11's slab form: (B,) class of each slice (null: 0)
  const float* mats;    // HK11's slab form: (n_sym, 9), the identity first
  int n_slices, n_sym, r_u, pf, size;
  float mrp, box_a, tpos;
  const float* coef;      // HK11: (n_slices n_sym, 8) sweep records of the planes
};

struct Grid {
  float2* F;            // (K, bz, big, big) of the slab [z0, z0 + bz)
  float* T;
  int big, z0, bz;
  int vlo, vhi;         // virtual index range a tap can take on each axis
};

// HK3's value of slice s at pixel (vc, vr) (in the disc), as the plain
// version forms it (slice_values.cuh)
__device__ __forceinline__ void form_value(const Slices& S, int s, int vc, int vr, float& vre,
                                           float& vim, float& c2w) {
  const SliceValues V{S.ft, S.ctfk, S.img_idx, S.trans, S.dfac, S.wsl, S.size, S.box_a, S.tpos};
  slice_value(V, s, vc, vr, vre, vim, c2w);
}

// HK3's first pass: the dense window's values of every slice, zero
// outside the disc and for zero-weight slices
__global__ void form_values_kernel(Slices S, float4* __restrict__ vals, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nk = 2 * S.r_u - 1, rr = S.r_u - 1, npx = nk * nk;
  int s = (int)(idx / npx);
  int p = (int)(idx - (long long)s * npx);
  int vr = p / nk - rr, vc = p % nk - rr;
  float re = 0.f, im = 0.f, cw = 0.f;
  if (vc * vc + vr * vr < rr * rr && S.wsl[s] != 0.f) form_value(S, s, vc, vr, re, im, cw);
  vals[idx] = make_float4(re, im, cw, 0.f);
}

// the axis' weight of a tap at floor index t (unclipped) for the
// (virtual) cell v, or -1 when neither of the sample's taps lands there
__device__ __forceinline__ float axis_weight(int t, int v, float frac) {
  return t == v ? 1.f - frac : (t + 1 == v ? frac : -1.f);
}

// Add to (re, im, t) what the plane of slice s (Q = R, r6 R's first two
// columns) gives the virtual cell (vx, vy, vz): its candidates (vc, vr),
// at most MAXC an axis, and their trilinear taps.
template <int MAXC>
__device__ __forceinline__ bool plane_into_cell(const Slices& S, const float* q, const float* r6,
                                                int s, int vx, int vy, int vz, int cb, float& re,
                                                float& im, float& t) {
  const float fx = (float)(vx - cb), fy = (float)(vy - cb), fz = (float)(vz - cb);
  const float az = q[2] * fx + q[5] * fy + q[8] * fz;
  if (fabsf(az) >= REACH) return false;
  const float ax = q[0] * fx + q[3] * fy + q[6] * fz;
  const float ay = q[1] * fx + q[4] * fy + q[7] * fz;
  const int rr = S.r_u - 1, nk = 2 * S.r_u - 1, pf = S.pf;
  const float inv_pf = 1.f / (float)pf;
  // the box of candidates within REACH of (Q^T k)_xy / pf starts at (c0,
  // r0) and is at most MAXC wide an axis; the strip tests reject what lies
  // past its far side
  const int c0 = (int)ceilf((ax - REACH) * inv_pf);
  const int r0 = (int)ceilf((ay - REACH) * inv_pf);
  const float mrp2 = S.mrp * S.mrp;
  // q = Q g - k at the box's corner, and its steps along vc and vr
  const float gx0 = (float)(c0 * pf), gy0 = (float)(r0 * pf), fpf = (float)pf;
  float e0[3], ec[3], er[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ka = a == 0 ? fx : (a == 1 ? fy : fz);
    e0[a] = q[3 * a] * gx0 + q[3 * a + 1] * gy0 - ka;
    ec[a] = q[3 * a] * fpf;
    er[a] = q[3 * a + 1] * fpf;
  }
  // the candidates that pass the cheap tests first (q within a cell's
  // half-width of k on every axis, a margin for rounding: nearly every one
  // is a hit), then the exact work once for each (one or two, rarely more)
  unsigned slots = 0;
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int vr = r0 + j;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int vc = c0 + i;
      bool ok = abs(vr) <= rr && abs(vc) <= rr &&
                fabsf(e0[0] + (float)i * ec[0] + (float)j * er[0]) < STRIP &&
                fabsf(e0[1] + (float)i * ec[1] + (float)j * er[1]) < STRIP &&
                fabsf(e0[2] + (float)i * ec[2] + (float)j * er[2]) < STRIP;
      ok = ok && vc * vc + vr * vr < rr * rr;
      if (ok) slots |= 1u << (j * MAXC + i);
    }
  }
  bool hit = false;
  while (slots) {
    const int b = __ffs(slots) - 1;
    slots &= slots - 1;
    const int vc = c0 + b % MAXC, vr = r0 + b / MAXC;
    // the load first, and no branch before its use, so the position's
    // arithmetic hides its latency
    const float4 v = __ldg(S.vals + (long long)s * nk * nk + (vr + rr) * nk + (vc + rr));
    // the sample's position, rounded as the scatter rounds it
    const float gx = (float)(vc * pf), gy = (float)(vr * pf);
    const float px = __fadd_rn(__fmul_rn(r6[0], gx), __fmul_rn(r6[1], gy));
    const float py = __fadd_rn(__fmul_rn(r6[2], gx), __fmul_rn(r6[3], gy));
    const float pz = __fadd_rn(__fmul_rn(r6[4], gx), __fmul_rn(r6[5], gy));
    const bool in = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                              __fmul_rn(pz, pz)) < mrp2;
    const float flx = floorf(px), fly = floorf(py), flz = floorf(pz);
    const float wx = axis_weight((int)flx + cb, vx, px - flx);
    const float wy = axis_weight((int)fly + cb, vy, py - fly);
    const float wz = axis_weight((int)flz + cb, vz, pz - flz);
    const bool ok = in && wx >= 0.f && wy >= 0.f && wz >= 0.f;
    const float w = ok ? (wz * wy) * wx : 0.f;
    re += v.x * w;
    im += v.y * w;
    t += v.z * w;
    hit = hit || ok;
  }
  return hit;
}

template <int MAXC>
__global__ void __launch_bounds__(THREADS, 2) insert_gather_kernel(Slices S, Grid G) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                               // 9 x CAP: Q = R, row-major
  float* sR = sQ + 9 * CAP;                       // 6 x CAP: R's first two columns
  int* sS = reinterpret_cast<int*>(sR + 6 * CAP);  // CAP: slice
  __shared__ int warp_n[THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int big = G.big, cb = big / 2;
  const int nbx = (big + BRICK - 1) / BRICK;
  const int bx = blockIdx.x % nbx, by = (blockIdx.x / nbx) % nbx, bz = blockIdx.x / (nbx * nbx);
  const int cls_k = blockIdx.y;
  const int x0 = bx * BRICK, y0 = by * BRICK, z0 = G.z0 + bz * BRICK;
  const int x1 = min(x0 + BRICK, big) - 1, y1 = min(y0 + BRICK, big) - 1;
  const int z1 = min(z0 + BRICK, G.z0 + G.bz) - 1;
  const float lim_r = S.mrp + REACH;
  {
    // the brick's nearest point to the centre (virtual cells lie farther out)
    auto near = [&](int a, int b) { return (float)(a > cb ? a - cb : (b < cb ? cb - b : 0)); };
    float nx = near(x0, x1), ny = near(y0, y1), nz = near(z0, z1);
    if (nx * nx + ny * ny + nz * nz >= lim_r * lim_r) return;
  }
  // virtual extent of an index: a face cell also owns the taps clipped onto it
  auto vlo_of = [&](int i) { return i == 0 ? min(G.vlo, 0) : i; };
  auto vhi_of = [&](int i) { return i == big - 1 ? max(G.vhi, big - 1) : i; };
  // the plane test of a box of (virtual) cells [a, b] an axis: its centre
  // and half-diagonal
  auto box = [&](int ax0, int ax1, int ay0, int ay1, int az0, int az1, float* c) {
    c[0] = 0.5f * (float)(vlo_of(ax0) + vhi_of(ax1)) - cb;
    c[1] = 0.5f * (float)(vlo_of(ay0) + vhi_of(ay1)) - cb;
    c[2] = 0.5f * (float)(vlo_of(az0) + vhi_of(az1)) - cb;
    float ex = 0.5f * (float)(vhi_of(ax1) - vlo_of(ax0));
    float ey = 0.5f * (float)(vhi_of(ay1) - vlo_of(ay0));
    float ez = 0.5f * (float)(vhi_of(az1) - vlo_of(az0));
    return sqrtf(ex * ex + ey * ey + ez * ez) + REACH;
  };
  float cbk[3], cwp[3];
  const float lim_b = box(x0, x1, y0, y1, z0, z1, cbk);
  // a warp owns a 4 x 4 x 2 part of the brick
  const int wx0 = x0 + 4 * (warp & 1), wy0 = y0 + 4 * ((warp >> 1) & 1), wz0 = z0 + 2 * (warp >> 2);
  const float lim_w = box(wx0, min(wx0 + 3, x1), wy0, min(wy0 + 3, y1), wz0, min(wz0 + 1, z1), cwp);
  const bool warp_in = wx0 <= x1 && wy0 <= y1 && wz0 <= z1;

  const int ix = wx0 + (lane & 3), iy = wy0 + ((lane >> 2) & 3), iz = wz0 + (lane >> 4);
  const int kx = ix - cb, ky = iy - cb, kz = iz - cb;
  const float kr2 = (float)(kx * kx + ky * ky + kz * kz);
  const bool active = ix <= x1 && iy <= y1 && iz <= z1 && kr2 < lim_r * lim_r;
  const int vx0 = vlo_of(ix), vx1 = vhi_of(ix), vy0 = vlo_of(iy), vy1 = vhi_of(iy);
  const int vz0 = vlo_of(iz), vz1 = vhi_of(iz);
  const bool faces = vx0 != vx1 || vy0 != vy1 || vz0 != vz1;
  const float fkx = (float)kx, fky = (float)ky, fkz = (float)kz;

  const long long n_planes = S.n_slices;
  float acc_re = 0.f, acc_im = 0.f, acc_t = 0.f;
  bool hit = false;
  long long base = 0;
  while (base < n_planes) {
    // list the next planes whose normal passes near the brick, in order
    int count = 0;
    while (base < n_planes && count + THREADS <= CAP) {
      long long i = base + tid;
      bool pass = false;
      const int s = (int)i;
      if (i < n_planes && (S.cls == nullptr || S.cls[s] == cls_k) &&
          (S.wsl == nullptr || S.wsl[s] != 0.f)) {
        const float* R = S.rot + 9LL * s;
        pass = fabsf(R[2] * cbk[0] + R[5] * cbk[1] + R[8] * cbk[2]) < lim_b;
      }
      unsigned ball = __ballot_sync(FULL, pass);
      if (lane == 0) warp_n[warp] = __popc(ball);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {
        int c = warp_n[w];
        before += w < warp ? c : 0;
        total += c;
      }
      if (pass) {
        int at = count + before + __popc(ball & ((1u << lane) - 1u));
        const float* R = S.rot + 9LL * s;
        float r[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) r[j] = R[j];
#pragma unroll
        for (int j = 0; j < 9; ++j) sQ[j * CAP + at] = r[j];
        sR[0 * CAP + at] = r[0];
        sR[1 * CAP + at] = r[1];
        sR[2 * CAP + at] = r[3];
        sR[3 * CAP + at] = r[4];
        sR[4 * CAP + at] = r[6];
        sR[5 * CAP + at] = r[7];
        sS[at] = s;
      }
      count += total;
      base += THREADS;
      __syncthreads();   // warp_n is rewritten by the next step
    }
    // 32 planes at a time: the warp keeps those that pass near its part;
    // each lane marks those that pass within REACH of its cell, then
    // walks its own marks in order
    for (int chunk = 0; warp_in && chunk < count; chunk += 32) {
      const int e = chunk + lane;
      bool near_w = false;
      if (e < count)
        near_w = fabsf(sQ[2 * CAP + e] * cwp[0] + sQ[5 * CAP + e] * cwp[1] +
                       sQ[8 * CAP + e] * cwp[2]) < lim_w;
      unsigned mine = 0;
      for (unsigned wm = __ballot_sync(FULL, near_w); wm; wm &= wm - 1) {
        const int j = __ffs(wm) - 1, ej = chunk + j;
        if (!active) continue;
        const float n0 = sQ[2 * CAP + ej], n1 = sQ[5 * CAP + ej], n2 = sQ[8 * CAP + ej];
        bool near_c = fabsf(n0 * fkx + n1 * fky + n2 * fkz) < REACH;
        if (faces)
          for (int vz = vz0; vz <= vz1; ++vz)
            for (int vy = vy0; vy <= vy1; ++vy)
              for (int vx = vx0; vx <= vx1; ++vx)
                near_c = near_c || fabsf(n0 * (float)(vx - cb) + n1 * (float)(vy - cb) +
                                         n2 * (float)(vz - cb)) < REACH;
        if (near_c) mine |= 1u << j;
      }
      while (mine) {
        const int ej = chunk + __ffs(mine) - 1;
        mine &= mine - 1;
        float q[9], r6[6];
#pragma unroll
        for (int j = 0; j < 9; ++j) q[j] = sQ[j * CAP + ej];
#pragma unroll
        for (int j = 0; j < 6; ++j) r6[j] = sR[j * CAP + ej];
        const int s = sS[ej];
        if (!faces) {
          hit |= plane_into_cell<MAXC>(S, q, r6, s, ix, iy, iz, cb, acc_re, acc_im, acc_t);
        } else {
          for (int vz = vz0; vz <= vz1; ++vz)
            for (int vy = vy0; vy <= vy1; ++vy)
              for (int vx = vx0; vx <= vx1; ++vx)
                hit |= plane_into_cell<MAXC>(S, q, r6, s, vx, vy, vz, cb, acc_re, acc_im,
                                             acc_t);
        }
      }
    }
    __syncthreads();   // the list is refilled
  }
  if (active && hit) {
    long long cell = (((long long)cls_k * G.bz + (iz - G.z0)) * big + iy) * big + ix;
    float2 f = G.F[cell];
    G.F[cell] = make_float2(f.x + acc_re, f.y + acc_im);
    G.T[cell] += acc_t;
  }
}

constexpr size_t SMEM = (size_t)(16 * CAP) * sizeof(float);

int launch_gather(const Slices& S, const Grid& G, cudaStream_t stream) {
  // candidates an axis: 2 REACH / pf + 1 of them at most (4 at pf 1, 2 at
  // pf 2 and above)
  const int maxc = max(2, (int)(2.f * REACH / (float)S.pf) + 1);
  void (*kernel)(Slices, Grid);
  switch (maxc) {
    case 2: kernel = insert_gather_kernel<2>; break;
    case 3: kernel = insert_gather_kernel<3>; break;
    case 4: kernel = insert_gather_kernel<4>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long nbx = (G.big + BRICK - 1) / BRICK, nbz = (G.bz + BRICK - 1) / BRICK;
  kernel<<<dim3((unsigned)(nbx * nbx * nbz), 1), THREADS, SMEM, stream>>>(S, G);
  return (int)cudaGetLastError();
}

// ---- HK11: the sweep as a brick-owned scatter, fixed-point sums ----

// HK11's first pass: HK3's values, and the maxima of their three
// components (sweep_fixed.cuh)
__global__ void sweep_values_kernel(Slices S, float4* __restrict__ vals, long long total,
                                    unsigned* __restrict__ vmax) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nk = 2 * S.r_u - 1, rr = S.r_u - 1, npx = nk * nk;
  float re = 0.f, im = 0.f, cw = 0.f;
  if (idx < total) {
    const int s = (int)(idx / npx);
    const int p = (int)(idx - (long long)s * npx);
    const int vr = p / nk - rr, vc = p % nk - rr;
    if (vc * vc + vr * vr < rr * rr && S.wsl[s] != 0.f) form_value(S, s, vc, vr, re, im, cw);
    vals[idx] = make_float4(re, im, cw, 0.f);
  }
  sweepfx::block_max(fabsf(re), vmax);
  sweepfx::block_max(fabsf(im), vmax + 1);
  sweepfx::block_max(fabsf(cw), vmax + 2);
}

// the maxima of given values (the slab form)
__global__ void values_max_kernel(const float4* __restrict__ vals, long long total,
                                  unsigned* __restrict__ vmax) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (idx < total) v = vals[idx];
  sweepfx::block_max(fabsf(v.x), vmax);
  sweepfx::block_max(fabsf(v.y), vmax + 1);
  sweepfx::block_max(fabsf(v.z), vmax + 2);
}

constexpr int SWEEP_BX = 16, SWEEP_BY = 16, SWEEP_BZ = 8;   // a brick's cells an axis (brick_addr)
constexpr int SWEEP_CELLS = SWEEP_BX * SWEEP_BY * SWEEP_BZ;
constexpr int SWEEP_THREADS = 512;
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;
constexpr int SWEEP_CAP = SWEEP_THREADS;                          // planes listed at once
// three 128-bit sums a cell, then six coefficients and a packed word a
// listed plane: two blocks an SM
constexpr size_t SWEEP_SMEM =
    (size_t)3 * sweepfx::WORDS * SWEEP_CELLS * 4 + (size_t)SWEEP_CAP * 7 * 4;
constexpr float SWEEP_A_REACH = 5.f + sweepfx::RANGE_MARGIN;   // |a - P_a| < 2 + 2 |alpha| + |beta|

// A brick cell's word in shared memory: 32-word rows of two y lines,
// each row's columns rotated by its y and z, so that the lanes of a warp,
// whose samples lie about pf cells apart in any direction, hit different
// banks (unrotated, steps along y or z fall in one or two banks)
__device__ __forceinline__ int brick_addr(int lx, int ly, int lz) {
  return ((ly >> 1) + 8 * lz) * 32 + ((lx + 16 * (ly & 1) + 3 * (ly >> 1) + 5 * lz) & 31);
}

// A block owns a 16 x 16 x 8 brick of class blockIdx.y's grid (or of the
// slab) as 128-bit sums in shared memory.  It lists the planes (slice,
// mate) whose normal passes within the brick's half-diagonal +
// SWEEP_BAND of its centre (ballot and prefix sums, as the gathers);
// each warp then takes a listed plane and its lanes the samples (h, k)
// of the box whose taps can land in the brick: in the plane's canonical
// axes, h from the l' pass (p_h h + q_m m' within 1 of the brick's l'
// range for some m' of its m' range), k from the m' pass (em1 h + em2 k
// within 1 of its m' range), each widened by RANGE_MARGIN.  A sample
// whose m' taps miss the brick, or whose plane lies farther than
// SWEEP_A_REACH from the brick's a range at the sample, is dropped; the
// samples that pass are taken two at a time, a half-warp each, a lane
// forming one of the sample's 2 x 2 x 4 taps as the plain version forms
// it (ops/insert.py _sweep_taps) and adding it where it lies inside the
// brick (a mate's only inside the radius).  A lane walking all 16 taps of
// its own sample left most lanes idle behind the few whose sample passed
// (slower on an H100: PERF.md section 6).  Then the brick is written once.
template <bool MATES>
__global__ void __launch_bounds__(SWEEP_THREADS, 2) sweep_brick_kernel(
    Slices S, Grid G, const unsigned* __restrict__ vmax, double count) {
  // the sums of Re F, Im F, T, each as four planes of CELLS words, lowest first
  constexpr int W = sweepfx::WORDS;
  extern __shared__ __align__(16) unsigned acc[];
  float* sC = reinterpret_cast<float*>(acc + 3 * W * SWEEP_CELLS);   // 6 x CAP coefficients
  int* sP = reinterpret_cast<int*>(sC + 6 * SWEEP_CAP);   // CAP: slice << 5 | cut << 4 | flags
  __shared__ float sMat[9 * MAX_SYM];
  __shared__ int warp_n[SWEEP_WARPS];
  constexpr int BX = SWEEP_BX, BY = SWEEP_BY, BZ = SWEEP_BZ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int big = G.big, cb = big / 2;
  const int nbx = (big + BX - 1) / BX, nby = (big + BY - 1) / BY;
  const int bx = blockIdx.x % nbx, by = (blockIdx.x / nbx) % nby, bzi = blockIdx.x / (nbx * nby);
  const int cls_k = blockIdx.y;
  const int x0 = bx * BX, y0 = by * BY, z0 = G.z0 + bzi * BZ;
  const int x1 = min(x0 + BX, big) - 1, y1 = min(y0 + BY, big) - 1;
  const int z1 = min(z0 + BZ, G.z0 + G.bz) - 1;
  {
    // no sample within SWEEP_REACH of the brick: nothing to add
    auto near = [&](int a, int b) { return (float)(a > cb ? a - cb : (b < cb ? cb - b : 0)); };
    const float nx = near(x0, x1), ny = near(y0, y1), nz = near(z0, z1);
    const float lim_r = S.mrp + SWEEP_REACH;
    if (nx * nx + ny * ny + nz * nz >= lim_r * lim_r) return;
  }
  for (int i = tid; i < 3 * W * SWEEP_CELLS; i += SWEEP_THREADS) acc[i] = 0u;
  if (MATES)
    for (int i = tid; i < 9 * S.n_sym; i += SWEEP_THREADS) sMat[i] = S.mats[i];
  // the brick in centered coordinates, its centre and half-diagonal
  const int lo[3] = {x0 - cb, y0 - cb, z0 - cb}, hi[3] = {x1 - cb, y1 - cb, z1 - cb};
  const float cx = 0.5f * (float)(lo[0] + hi[0]), cy = 0.5f * (float)(lo[1] + hi[1]),
              cz = 0.5f * (float)(lo[2] + hi[2]);
  const float ex = 0.5f * (float)(hi[0] - lo[0]), ey = 0.5f * (float)(hi[1] - lo[1]),
              ez = 0.5f * (float)(hi[2] - lo[2]);
  const float lim_b = sqrtf(ex * ex + ey * ey + ez * ez) + SWEEP_BAND;
  int sx[3];   // each component's scale 2^sx
#pragma unroll
  for (int c = 0; c < 3; ++c) sx[c] = sweepfx::scale_exp(count * (double)__uint_as_float(vmax[c]));
  const int rr = S.r_u - 1, nk = 2 * S.r_u - 1;
  const int mrp_i = rr * S.pf, mrp2 = mrp_i * mrp_i;
  __syncthreads();

  const long long n_planes = (long long)S.n_slices * S.n_sym;
  long long base = 0;
  while (base < n_planes) {
    // list the next planes whose normal passes near the brick
    int count_l = 0;
    while (base < n_planes && count_l + SWEEP_THREADS <= SWEEP_CAP) {
      const long long i = base + tid;
      bool pass = false;
      int s = 0, m = 0;
      if (i < n_planes) {
        s = (int)(i / S.n_sym);
        m = (int)(i - (long long)s * S.n_sym);
        if ((S.cls == nullptr || S.cls[s] == cls_k) && (S.wsl == nullptr || S.wsl[s] != 0.f)) {
          const float* R = S.rot + 9LL * s;
          float n0 = R[2], n1 = R[5], n2 = R[8];
          if (MATES) {
            const float* M = sMat + 9 * m;
            const float a = M[0] * n0 + M[1] * n1 + M[2] * n2;
            const float b = M[3] * n0 + M[4] * n1 + M[5] * n2;
            const float c = M[6] * n0 + M[7] * n1 + M[8] * n2;
            n0 = a, n1 = b, n2 = c;
          }
          pass = fabsf(n0 * cx + n1 * cy + n2 * cz) < lim_b;
        }
      }
      const unsigned ball = __ballot_sync(FULL, pass);
      if (lane == 0) warp_n[warp] = __popc(ball);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < SWEEP_WARPS; ++w) {
        const int c = warp_n[w];
        before += w < warp ? c : 0;
        total += c;
      }
      if (pass) {
        const int at = count_l + before + __popc(ball & ((1u << lane) - 1u));
        const float* c = S.coef + 8LL * i;
#pragma unroll
        for (int j = 0; j < 6; ++j) sC[j * SWEEP_CAP + at] = c[j];
        sP[at] = (s << 5) | ((MATES && m > 0) ? 16 : 0) | ((int)c[6] & 15);
      }
      count_l += total;
      base += SWEEP_THREADS;
      __syncthreads();   // warp_n is rewritten by the next step
    }
    for (int e = warp; e < count_l; e += SWEEP_WARPS) {
      const float em1 = sC[e], em2 = sC[SWEEP_CAP + e], p_h = sC[2 * SWEEP_CAP + e];
      const float q_m = sC[3 * SWEEP_CAP + e], alpha = sC[4 * SWEEP_CAP + e];
      const float beta = sC[5 * SWEEP_CAP + e];
      const int pk = sP[e];
      const int cs = pk & 3, s = pk >> 5;
      const bool shk = (pk & SWEEP_SWAP_HK) != 0, sml = (pk & SWEEP_SWAP_ML) != 0;
      const bool cut = (pk & 16) != 0;
      // the brick's ranges on the plane's canonical axes: a, m, l, then
      // (m', l') = (m, l), or (l, m) where the m/l swap is set
      const int ai = cs, mi = cs == 2 ? 1 : 2, li = cs == 0 ? 1 : 0;
      const float al = (float)lo[ai], ah = (float)hi[ai];
      const int mpl = sml ? lo[li] : lo[mi], mph = sml ? hi[li] : hi[mi];
      const int lpl = sml ? lo[mi] : lo[li], lph = sml ? hi[mi] : hi[li];
      const float qa = q_m * (float)mpl, qb = q_m * (float)mph;
      int h0, h1, k0, k1;
      sweepfx::pass_range((float)lpl - 1.f - fmaxf(qa, qb) - sweepfx::RANGE_MARGIN,
                          (float)lph + 1.f - fminf(qa, qb) + sweepfx::RANGE_MARGIN, p_h, rr, h0,
                          h1);
      if (h0 > h1) continue;
      const float ea = em1 * (float)h0, eb = em1 * (float)h1;
      sweepfx::pass_range((float)mpl - 1.f - fmaxf(ea, eb) - sweepfx::RANGE_MARGIN,
                          (float)mph + 1.f - fminf(ea, eb) + sweepfx::RANGE_MARGIN, em2, rr, k0,
                          k1);
      if (k0 > k1) continue;
      const int nkk = k1 - k0 + 1, n_cand = (h1 - h0 + 1) * nkk;
      const float4* vals = S.vals + (long long)s * nk * nk;
      // (j + 1/2) / nkk lies 1/2 nkk from an integer, far past the float
      // quotient's error at these sizes: its floor is j's row
      const float inv_nkk = 1.f / (float)nkk;
      for (int base = 0; base < n_cand; base += 32) {
        // the lanes test 32 candidates; those that pass go on, two at a
        // time, to the half-warps, a lane a tap (2 x 2 x 4 a sample)
        const int j = base + lane;
        const int dh = (int)(((float)j + 0.5f) * inv_nkk);
        const int h = h0 + dh, k = k0 + (j - dh * nkk);
        const int vr = shk ? k : h, vc = shk ? h : k;
        bool pass = j < n_cand && vc * vc + vr * vr < rr * rr;
        if (pass) {
          const float hf = (float)h;
          const float ctr_m = __fadd_rn(__fmul_rn(em1, hf), __fmul_rn(em2, (float)k));
          const float fm = floorf(ctr_m);
          // a tap in the brick's m' and l' ranges, formed as the taps are
          bool ml = false;
#pragma unroll
          for (int dm = 0; dm < 2; ++dm) {
            const float mp = fm + (float)dm;
            const float fl = floorf(__fadd_rn(__fmul_rn(p_h, hf), __fmul_rn(q_m, mp)));
            ml = ml || (mp >= (float)mpl && mp <= (float)mph && fl + 1.f >= (float)lpl &&
                        fl <= (float)lph);
          }
          // the plane's height at the sample: every tap lies within
          // SWEEP_A_REACH of it along a
          const float pl = p_h * hf + q_m * ctr_m;
          const float zeta0 = sml ? alpha * ctr_m + beta * pl : alpha * pl + beta * ctr_m;
          pass = ml && al <= zeta0 + SWEEP_A_REACH && ah >= zeta0 - SWEEP_A_REACH;
        }
        unsigned todo = __ballot_sync(FULL, pass);
        while (todo) {
          const int src0 = __ffs(todo) - 1;
          todo &= todo - 1;
          const int src1 = todo ? __ffs(todo) - 1 : -1;
          if (todo) todo &= todo - 1;
          const int src = lane < 16 ? src0 : src1;
          const int hs = __shfl_sync(FULL, h, src < 0 ? 0 : src);
          const int ks = __shfl_sync(FULL, k, src < 0 ? 0 : src);
          if (src < 0) continue;
          const int t = lane & 15, dm = t >> 3, dl = (t >> 2) & 1, da = (t & 3) - 1;
          const float hf = (float)hs;
          const float ctr_m = __fadd_rn(__fmul_rn(em1, hf), __fmul_rn(em2, (float)ks));
          const float mp = floorf(ctr_m) + (float)dm;
          const float w3 = sweepfx::hat1(__fsub_rn(mp, ctr_m));
          const float ctr_l = __fadd_rn(__fmul_rn(p_h, hf), __fmul_rn(q_m, mp));
          const float lp = floorf(ctr_l) + (float)dl;
          const float w32 = __fmul_rn(w3, sweepfx::hat1(__fsub_rn(lp, ctr_l)));
          const float mm = sml ? lp : mp, ll = sml ? mp : lp;
          const float zeta = __fadd_rn(__fmul_rn(alpha, ll), __fmul_rn(beta, mm));
          const float a = floorf(zeta) + (float)da;
          const float w = __fmul_rn(
              w32, __fmul_rn(sweepfx::hat1(__fmul_rn(__fsub_rn(a, zeta), 0.5f)), 0.5f));
          if (!(w > 0.f) || mp < (float)mpl || mp > (float)mph || lp < (float)lpl ||
              lp > (float)lph || a < al || a > ah)
            continue;
          const int ia = (int)a, im_ = (int)mm, il = (int)ll;
          const int kx = cs == 0 ? ia : il;
          const int ky = cs == 1 ? ia : (cs == 0 ? il : im_);
          const int kz = cs == 2 ? ia : im_;
          if (cut && kx * kx + ky * ky + kz * kz >= mrp2) continue;
          const int vrs = shk ? ks : hs, vcs = shk ? hs : ks;
          const float4 v = __ldg(vals + (vrs + rr) * nk + (vcs + rr));
          const int cell = brick_addr(kx - lo[0], ky - lo[1], kz - lo[2]);
          const float vc3[3] = {v.x, v.y, v.z};
          sweepfx::Tap q[3];
          bool nz[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) nz[c] = sweepfx::quantise(vc3[c], w, sx[c], q[c]);
          sweepfx::fixed_add3(acc + cell, SWEEP_CELLS, q, nz);
        }
      }
    }
    __syncthreads();   // the list is refilled
  }
  // the brick, once: disjoint from every other block's
  const double inv[3] = {ldexp(1.0, -sx[0]), ldexp(1.0, -sx[1]), ldexp(1.0, -sx[2])};
  for (int i = tid; i < SWEEP_CELLS; i += SWEEP_THREADS) {
    const int lx = i % BX, ly = (i / BX) % BY, lz = i / (BX * BY);
    const int ix = x0 + lx, iy = y0 + ly, iz = z0 + lz;
    if (ix > x1 || iy > y1 || iz > z1) continue;
    const unsigned* ar = acc + brick_addr(lx, ly, lz);
    const unsigned *ai = ar + W * SWEEP_CELLS, *at = ai + W * SWEEP_CELLS;
    const bool r = sweepfx::nonzero(ar, SWEEP_CELLS), im = sweepfx::nonzero(ai, SWEEP_CELLS);
    const bool t = sweepfx::nonzero(at, SWEEP_CELLS);
    if (!(r || im || t)) continue;
    const long long cell = (((long long)cls_k * G.bz + (iz - G.z0)) * big + iy) * big + ix;
    if (r || im) {
      float2 f = G.F[cell];
      if (r) f.x = __fadd_rn(f.x, sweepfx::unquantise(ar, SWEEP_CELLS, inv[0]));
      if (im) f.y = __fadd_rn(f.y, sweepfx::unquantise(ai, SWEEP_CELLS, inv[1]));
      G.F[cell] = f;
    }
    if (t) G.T[cell] = __fadd_rn(G.T[cell], sweepfx::unquantise(at, SWEEP_CELLS, inv[2]));
  }
}

template <bool MATES>
int launch_sweep(const Slices& S, const Grid& G, int n_class, const unsigned* vmax,
                 double count, cudaStream_t stream) {
  auto kernel = sweep_brick_kernel<MATES>;
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SWEEP_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long nbx = (G.big + SWEEP_BX - 1) / SWEEP_BX, nby = (G.big + SWEEP_BY - 1) / SWEEP_BY;
  const long long nbz = (G.bz + SWEEP_BZ - 1) / SWEEP_BZ;
  kernel<<<dim3((unsigned)(nbx * nby * nbz), n_class), SWEEP_THREADS, SWEEP_SMEM, stream>>>(
      S, G, vmax, count);
  return (int)cudaGetLastError();
}

}  // namespace

// HK3.  ft (L, size, size) complex64; ctfk (L, 8); per slice img_idx
// (B,) int32, rot (B, 9), trans (B, 2), w (B,), dfac (B,) or null; F
// (big^3) complex64 and T (big^3) float32 accumulated into.  vals (B,
// nk^2, 4) float32: scratch for the formed values (Re, Im, c2w, 0).  vlo /
// vhi: the lowest and highest index a tap can take.
extern "C" int thunder_insert_trilinear(
    const void* ft, int size, const void* ctfk, const void* img_idx, const void* rot,
    const void* trans, const void* w, const void* dfac, int n_slices, int r_u, int pf,
    float max_radius_pad, float box_a, float tpos, void* F, void* T, void* vals, int big,
    int vlo, int vhi, void* stream) {
  if (n_slices <= 0) return (int)cudaGetLastError();
  Slices S{(const float4*)vals, (const float2*)ft, (const float*)ctfk,
           (const int*)img_idx, (const float*)trans, (const float*)dfac, (const float*)w,
           (const float*)rot, nullptr, nullptr, n_slices, 1, r_u, pf, size,
           max_radius_pad, box_a, tpos};
  Grid G{(float2*)F, (float*)T, big, 0, big, vlo, vhi};
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = 2 * r_u - 1;
  long long total = (long long)n_slices * nk * nk;
  const int threads = 256;
  form_values_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      S, (float4*)vals, total);
  return launch_gather(S, G, st);
}

// HK11.  HK3's arguments (no tap range: the sweep clips nothing onto a
// face), coef (B, 8), the slices' sweep records (ops/insert.py
// sweep_coeffs), vmax (4,) uint32 scratch for the values' maxima, and
// count, the samples the launch may add (B times the in-disc pixels):
// the fixed-point scale's bound.  vals holds the formed values after
// the call.
extern "C" int thunder_insert_sweep(
    const void* ft, int size, const void* ctfk, const void* img_idx, const void* rot,
    const void* coef, const void* trans, const void* w, const void* dfac, int n_slices, int r_u,
    int pf, float max_radius_pad, float box_a, float tpos, void* F, void* T, void* vals, int big,
    void* vmax, double count, void* stream) {
  if (n_slices <= 0) return (int)cudaGetLastError();
  Slices S{(const float4*)vals, (const float2*)ft, (const float*)ctfk,
           (const int*)img_idx, (const float*)trans, (const float*)dfac, (const float*)w,
           (const float*)rot, nullptr, nullptr, n_slices, 1, r_u, pf, size,
           max_radius_pad, box_a, tpos, (const float*)coef};
  Grid G{(float2*)F, (float*)T, big, 0, big, 0, big - 1};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(vmax, 0, 4 * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const int nk = 2 * r_u - 1;
  long long total = (long long)n_slices * nk * nk;
  const int threads = 256;
  sweep_values_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      S, (float4*)vals, total, (unsigned*)vmax);
  return launch_sweep<false>(S, G, 1, (const unsigned*)vmax, count, st);
}

// HK11's slab form.  vals (B, nk^2, 4) float32 (Re val, Im val, c2w, 0),
// rot (B, 9), cls (B,) int32, mats (n_sym, 9) with the identity first; F
// (K, bz, big, big) complex64 and T float32 of the slab [z0, z0 + bz),
// accumulated into; coef (B n_sym, 8), the sweep records of the planes
// (slice, mate) in slice order then mate order (ops/insert.py
// sweep_planes); vmax and count as HK11's (count: B n_sym times the
// in-disc pixels).
extern "C" int thunder_insert_sweep_slab(
    const void* vals, const void* rot, const void* coef, const void* cls, int n_slices, int r_u,
    int pf, float max_radius_pad, const void* mats, int n_sym, void* F, void* T, int n_class,
    int big, int z0, int bz, void* vmax, double count, void* stream) {
  if (n_slices <= 0 || n_class <= 0) return (int)cudaGetLastError();
  if (n_sym < 1 || n_sym > MAX_SYM) return (int)cudaErrorInvalidValue;
  Slices S{(const float4*)vals, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, (const float*)rot, (const int*)cls, (const float*)mats, n_slices, n_sym,
           r_u, pf, 0, max_radius_pad, 0.f, 0.f, (const float*)coef};
  Grid G{(float2*)F, (float*)T, big, z0, bz, 0, big - 1};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(vmax, 0, 4 * sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  const int nk = 2 * r_u - 1;
  long long total = (long long)n_slices * nk * nk;
  values_max_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>((const float4*)vals, total,
                                                                      (unsigned*)vmax);
  return launch_sweep<true>(S, G, n_class, (const unsigned*)vmax, count, st);
}
