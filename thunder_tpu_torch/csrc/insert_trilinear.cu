// HK3 insert_trilinear, HK10 insert_mkb and HK11 insert_sweep (one
// grid, and its slab form): Fourier insertion of slices as a gather, each
// output cell forming its own sum.
//
// Replaces (thunder_tpu): HK11, the rounds' insertion,
// optimiser.py:1400 _insert_flat3d_h / :1305 one_3d over ops/insert.py
// insert_sweep_3d (the scatter-free shear sweep), and its slab form
// recon/sharded.py:300 insert_sweep_3d_sharded (F / T as z-slabs, the
// point group's mates pose-side); HK3, the exact trilinear scatter
// ops/insert.py:76 insert_slices_3d that cli/reconstruct.py takes; HK10,
// optimiser._insert_all_h with kernel="mkb" (the insertion option
// reco_kernel="mkb"), insert_slices_3d over _mkb_taps: the modified
// Kaiser-Bessel blob (Reconstructor.cpp:424-567).
//
// HK11 is HK3 with the sweep's weight (the template parameter WT =
// SWEEP).  In the canonical axes (a, m, l) of a plane (a the axis most
// aligned with its normal, case 0 x, 1 y, 2 z; m = z, or y for case z;
// l = x, or y for case x), sample (h, k) of the dense window (h, k =
// vr, vc, or vc, vr where the plane's h/k swap is set) adds to cell (a,
// m, l) with the weight
//     hat(m' - em1 h - em2 k) hat(l' - p_h h - q_m m') hat((a - zeta) / 2) / 2,
// zeta = alpha l + beta m the plane's height at (m, l), (m', l') = (m,
// l), or (l, m) where its m/l swap is set, hat(t) = max(0, 1 - |t|).
// The host forms each plane's record (em1, em2, p_h, q_m, alpha, beta,
// flags) once (ops/insert.py sweep_coeffs, thunder_tpu's _sweep_coeffs
// expressions); a cell forms the height hat from its own coordinates,
// then walks the h whose l' hat reaches it (|p_h| >= pf / sqrt 2: at
// most 2 at pf 2) and, for each, the k whose m' hat reaches it (|em2| >=
// 0.67 pf), each weight formed as the plain version forms it.  Nothing
// is clipped: cells past the grid are dropped, so no face gathers
// virtual cells.  The sweep reaches farther than the trilinear taps
// (|m - P_m| < 1, |l - P_l| < 1 + |q_m| <= 2, |a - P_a| < 2 + 2 |alpha| +
// |beta| <= 5: within sqrt 30 of a sample P), but only 2 |n_a| <= 2 along
// the normal (n . k = n_a (a - zeta)): bricks are culled at
// max_radius_pad + SWEEP_REACH, planes listed within the half-diagonal +
// SWEEP_BAND.  thunder_tpu streams its hat fields as bf16; HK11 forms
// them in float32.  Its slab form lists the planes (slice, mate) of the
// point group's mates M pose-side, each with the record of M R formed on
// the host, adds only to the cells of its z-slab and, for a mate other
// than the identity, only inside the radius (HK7's cut, so that for
// signed-permutation groups the slabs equal HK11 then HK7).

// HK10 is HK3 with another weight (WT = MKB): a
// sample at q adds val MKB_FT(|k - q|) = I0(alpha sqrt(1 - |k - q|^2 /
// a^2)) / I0(alpha) to each cell k of its 4^3 neighbourhood floor(q) - 1
// ... floor(q) + 2 (clipped to the grid) with |k - q| < a, a <= 2 (1.9
// in every shipped config).  So its reach is a, not sqrt 3: the planes a
// brick lists, the candidates (vc, vr) around (Q^T k)_xy / pf and the
// per-axis prefilter (a cell's half-width for trilinear taps, a for the
// blob) widen to a plus the margin, and the faces' virtual cells to two
// past the radius.  The blob's ball is (1.9 / sqrt 3)^3 ~ 1.3 times the
// trilinear reach's volume, and every hit pays an I0 (cyl_bessel_i0f);
// 1 / I0(alpha) comes from the host.  Bound by operations as HK3 is: on
// an NVIDIA H100 80GB HBM3 it takes 3.25x HK3's time on the same 6144
// slices at 152^3 (0.012 of its operations bound; PERF.md), its
// instances at 64 registers with 112-196 bytes spilled a thread.
//
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
// centre return at once.  The block lists, in slice order and mate order,
// the planes (slice, mate) of its class whose normal passes within the
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
// (Re, Im, c2w, 0) read back with one 16-byte load a hit; the slab
// form's wrapper packs the given values the same way.  Forming them at
// every hit instead (a sample is hit by ~8 cells, each recomputing a CTF
// and a sincos) ran slower at every measured shape (PERF.md section 6).
//
// What bounds it on Hopper: operations, not bytes.  Every sample's
// position is formed by each of the ~8 cells it reaches and by the
// candidates around them, and every cell tests each plane listed for its
// brick: at 8b's shape, by estimate, ~9,000 plane tests, ~3,400 passing
// planes and ~1,600 hits a cell.  The scatter it replaced formed a position once
// and paid L2's atomic rate instead; the gather is several times slower
// at every measured shape (PERF.md section 6) and repeats bit for bit.
// Two blocks of 512 threads an SM (64 registers, a few spilled).

#include <cuda_runtime.h>
#include <math.h>

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
constexpr float MARGIN = 1e-2f;        // HK10: reach and prefilter a + MARGIN
// HK11: a cell within sqrt 30 of a sample, within 2 of its plane along
// the normal; the margin widens the candidate ranges (ops/insert.py
// SWEEP_REACH_3D, SWEEP_BAND, SWEEP_MARGIN mirror these)
constexpr float SWEEP_REACH = 5.4772256f + 1e-2f;
constexpr float SWEEP_BAND = 2.f + 1e-2f;
constexpr float SWEEP_MARGIN = 1e-2f;
constexpr int SWEEP_SWAP_HK = 4, SWEEP_SWAP_ML = 8;   // a record's flags beside the case

// the weight a gather forms: trilinear taps (HK3), the MKB blob
// (HK10), thunder_tpu's shear sweep (HK11)
enum Weight : int { TRI = 0, MKB = 1, SWEEP = 2 };

struct Slices {
  const float4* vals;   // (B, nk^2) of (Re val, Im val, c2w, 0)
  const float2* ft;     // HK3's first pass: the images and their constants
  const float* ctfk;
  const int* img_idx;
  const float* trans;
  const float* dfac;    // null: 1
  const float* wsl;     // slice weights; zero-weight slices are not listed (null: none)
  const float* rot;     // (B, 9) row-major
  const int* cls;       // (B,) class of each slice (null: 0)
  const float* mats;    // (n_sym, 9), the identity first (MATES; else the identity alone)
  int n_slices, n_sym, r_u, pf, size;
  float mrp, box_a, tpos;
  float reach, strip;     // REACH and STRIP (HK10: a + MARGIN, both; HK11: SWEEP_BAND)
  int edge;               // HK10: the disc keeps its edge vc^2 + vr^2 = (r_u - 1)^2
  float mkb_a, mkb_a2, mkb_alpha, mkb_inv_i0;   // HK10's blob: a, a^2, alpha, 1 / I0(alpha)
  float reach_r;          // HK11: the radial reach SWEEP_REACH (unread by the others)
  const float* coef;      // HK11: (n_slices n_sym, 8) sweep records of the planes
};

struct Grid {
  float2* F;            // (K, bz, big, big) of the slab [z0, z0 + bz)
  float* T;
  int big, z0, bz;
  int vlo, vhi;         // virtual index range a tap can take on each axis
};

// HK3's value of slice s at pixel (vc, vr) (in the disc), as the plain
// version forms it (ops/insert.py dense_slice_values)
__device__ __forceinline__ void form_value(const Slices& S, int s, int vc, int vr, float& vre,
                                           float& vim, float& c2w) {
  int q2 = vc * vc + vr * vr;
  float mask_d = (q2 == 0) ? 2.f : 1.f;
  float w = S.wsl[s];
  int img = S.img_idx[s];
  int c = S.size / 2;
  float2 d = S.ft[((long long)img * S.size + (c + vr)) * S.size + (c + vc)];
  // translation ramp: tra = exp(-i phase), conj(tra) = exp(+i phase)
  float tx = S.trans[2 * s], ty = S.trans[2 * s + 1];
  float ph = S.tpos * ((float)vc * tx + (float)vr * ty);
  float cp = cosf(ph), sp = sinf(ph);
  float dr = d.x * cp - d.y * sp;
  float di = d.x * sp + d.y * cp;
  // CTF from the per-image constants
  // [k1, k2, w1, w2, defocus_u, defocus_v, defocus_theta, phase_shift]
  const float* k = S.ctfk + (long long)img * 8;
  float fx = (float)vc / S.box_a;
  float fy = (float)vr / S.box_a;
  float f = sqrtf(fx * fx + fy * fy);
  float ang = atan2f((float)vr, (float)vc);
  float du = k[4], dv = k[5];
  float defocus = -(du + dv + (du - dv) * cosf(2.f * (ang - k[6]))) / 2.f;
  // ctf_packed squares f; ctf_packed_scaled takes fx^2 + fy^2 as it is
  float f2 = S.dfac ? fx * fx + fy * fy : f * f;
  float dd = S.dfac ? S.dfac[s] : 1.f;
  float chi = k[0] * defocus * dd * f2 + k[1] * (f2 * f2) - k[7];
  float ctf = -k[2] * sinf(chi) + k[3] * cosf(chi);
  float cm = ctf * mask_d;
  vre = dr * cm * w;
  vim = di * cm * w;
  c2w = ctf * ctf * mask_d * w;
}

// HK3's first pass: the dense window's values of every slice, zero
// outside the disc (HK10: the disc with its edge, whose pixels the
// position's radius test keeps or drops as the scatter's does) and for
// zero-weight slices
__global__ void form_values_kernel(Slices S, float4* __restrict__ vals, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nk = 2 * S.r_u - 1, rr = S.r_u - 1, npx = nk * nk;
  int s = (int)(idx / npx);
  int p = (int)(idx - (long long)s * npx);
  int vr = p / nk - rr, vc = p % nk - rr;
  float re = 0.f, im = 0.f, cw = 0.f;
  const int q2 = vc * vc + vr * vr;
  if ((q2 < rr * rr || (S.edge && q2 == rr * rr)) && S.wsl[s] != 0.f)
    form_value(S, s, vc, vr, re, im, cw);
  vals[idx] = make_float4(re, im, cw, 0.f);
}

// the axis' weight of a tap at floor index t (unclipped) for the
// (virtual) cell v, or -1 when neither of the sample's taps lands there
__device__ __forceinline__ float axis_weight(int t, int v, float frac) {
  return t == v ? 1.f - frac : (t + 1 == v ? frac : -1.f);
}

// HK10's weight of the tap at (virtual) cell (vx, vy, vz) of a sample at
// (x, y, z): MKB_FT(|k - q|) where the cell is one of the sample's 4^3
// taps and |k - q|^2 < a^2, else -1; the expressions and their rounding
// are the plain version's (ops/insert.py _mkb_taps)
__device__ __forceinline__ float mkb_weight(const Slices& S, float x, float y, float z, int vx,
                                            int vy, int vz, int cb) {
  const int tx = (int)floorf(x) + cb, ty = (int)floorf(y) + cb, tz = (int)floorf(z) + cb;
  if (vx < tx - 1 || vx > tx + 2 || vy < ty - 1 || vy > ty + 2 || vz < tz - 1 || vz > tz + 2)
    return -1.f;
  const float dx = (float)(vx - cb) - x, dy = (float)(vy - cb) - y, dz = (float)(vz - cb) - z;
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  if (!(d2 < S.mkb_a2)) return -1.f;
  const float u = __fdiv_rn(sqrtf(fmaxf(d2, 0.f)), S.mkb_a);
  const float u2 = __fmul_rn(u, u);
  if (u2 > 1.f) return 0.f;
  return cyl_bessel_i0f(__fmul_rn(S.mkb_alpha, sqrtf(fmaxf(0.f, __fsub_rn(1.f, u2))))) *
         S.mkb_inv_i0;
}

// Add to (re, im, t) what the plane (slice s, mate m; Q = M R, r6 R's
// first two columns) gives the virtual cell (vx, vy, vz): its candidates
// (vc, vr), at most MAXC an axis; MKB: the blob's weight (HK10), else the
// trilinear taps'.
template <bool MATES, int MAXC, int WT>
__device__ __forceinline__ bool plane_into_cell(const Slices& S, const float* q, const float* r6,
                                                const float* M, int s, int vx, int vy, int vz,
                                                int cb, float& re, float& im, float& t) {
  constexpr bool BLOB = WT == MKB;
  const float reach = BLOB ? S.reach : REACH, strip = BLOB ? S.strip : STRIP;
  const float fx = (float)(vx - cb), fy = (float)(vy - cb), fz = (float)(vz - cb);
  const float az = q[2] * fx + q[5] * fy + q[8] * fz;
  if (fabsf(az) >= reach) return false;
  const float ax = q[0] * fx + q[3] * fy + q[6] * fz;
  const float ay = q[1] * fx + q[4] * fy + q[7] * fz;
  const int rr = S.r_u - 1, nk = 2 * S.r_u - 1, pf = S.pf;
  const float inv_pf = 1.f / (float)pf;
  // the box of candidates within REACH of (Q^T k)_xy / pf starts at (c0,
  // r0) and is at most MAXC wide an axis; the strip tests reject what lies
  // past its far side
  const int c0 = (int)ceilf((ax - reach) * inv_pf);
  const int r0 = (int)ceilf((ay - reach) * inv_pf);
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
                fabsf(e0[0] + (float)i * ec[0] + (float)j * er[0]) < strip &&
                fabsf(e0[1] + (float)i * ec[1] + (float)j * er[1]) < strip &&
                fabsf(e0[2] + (float)i * ec[2] + (float)j * er[2]) < strip;
      if (!MATES) ok = ok && (BLOB ? vc * vc + vr * vr <= rr * rr : vc * vc + vr * vr < rr * rr);
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
    float x = px, y = py, z = pz;
    if (MATES) {
      x = __fadd_rn(__fadd_rn(__fmul_rn(M[0], px), __fmul_rn(M[1], py)), __fmul_rn(M[2], pz));
      y = __fadd_rn(__fadd_rn(__fmul_rn(M[3], px), __fmul_rn(M[4], py)), __fmul_rn(M[5], pz));
      z = __fadd_rn(__fadd_rn(__fmul_rn(M[6], px), __fmul_rn(M[7], py)), __fmul_rn(M[8], pz));
    }
    bool ok;
    float w;
    if (BLOB) {
      const float wb = mkb_weight(S, x, y, z, vx, vy, vz, cb);
      ok = in && wb >= 0.f;
      w = ok ? wb : 0.f;
    } else {
      const float flx = floorf(x), fly = floorf(y), flz = floorf(z);
      const float wx = axis_weight((int)flx + cb, vx, x - flx);
      const float wy = axis_weight((int)fly + cb, vy, y - fly);
      const float wz = axis_weight((int)flz + cb, vz, z - flz);
      ok = in && wx >= 0.f && wy >= 0.f && wz >= 0.f;
      w = ok ? (wz * wy) * wx : 0.f;
    }
    re += v.x * w;
    im += v.y * w;
    t += v.z * w;
    hit = hit || ok;
  }
  return hit;
}

__device__ __forceinline__ float hat1(float t) { return fmaxf(0.f, __fsub_rn(1.f, fabsf(t))); }

// HK11's candidate range of a pass index: t with |x - coef t| < 1 lies
// within 1 / |coef| of centre = x / coef (ops/insert.py _sweep_range)
__device__ __forceinline__ void sweep_range(float centre, float coef, int rr, int& lo, int& hi) {
  const float half = __fdiv_rn(1.f, fabsf(coef));
  lo = max(-rr, (int)ceilf(__fsub_rn(__fsub_rn(centre, half), SWEEP_MARGIN)));
  hi = min(rr, (int)floorf(__fadd_rn(__fadd_rn(centre, half), SWEEP_MARGIN)));
}

// Add to (re, im, t) what the plane of sweep record c (em1, em2, p_h,
// q_m, alpha, beta; flags: case, swaps) of slice s gives the cell (vx,
// vy, vz): the height hat of the cell, then the samples h of the l' pass
// and, for each, the samples k of the m' pass, each weight formed as the
// plain version forms it (ops/insert.py _sweep_taps).
__device__ __forceinline__ bool sweep_into_cell(const Slices& S, const float* c, int flags,
                                                int s, int vx, int vy, int vz, int cb,
                                                float& re, float& im, float& t) {
  const float fx = (float)(vx - cb), fy = (float)(vy - cb), fz = (float)(vz - cb);
  const int cs = flags & 3;
  const float a = cs == 0 ? fx : (cs == 1 ? fy : fz);
  const float m = cs == 2 ? fy : fz;
  const float l = cs == 0 ? fy : fx;
  const float zeta = __fadd_rn(__fmul_rn(c[4], l), __fmul_rn(c[5], m));
  const float wz = __fdiv_rn(hat1(__fdiv_rn(__fsub_rn(a, zeta), 2.f)), 2.f);
  if (!(wz > 0.f)) return false;
  const bool sml = (flags & SWEEP_SWAP_ML) != 0, shk = (flags & SWEEP_SWAP_HK) != 0;
  const float mp = sml ? l : m, lp = sml ? m : l;
  const float em1 = c[0], em2 = c[1], p_h = c[2], q_m = c[3];
  const int rr = S.r_u - 1, nk = 2 * S.r_u - 1;
  const float4* vals = S.vals + (long long)s * nk * nk;
  int h0, h1;
  sweep_range(__fdiv_rn(__fsub_rn(lp, __fmul_rn(q_m, mp)), p_h), p_h, rr, h0, h1);
  bool hit = false;
  for (int h = h0; h <= h1; ++h) {
    const float hf = (float)h;
    const float w2 = hat1(__fsub_rn(lp, __fadd_rn(__fmul_rn(p_h, hf), __fmul_rn(q_m, mp))));
    if (!(w2 > 0.f)) continue;
    int k0, k1;
    sweep_range(__fdiv_rn(__fsub_rn(mp, __fmul_rn(em1, hf)), em2), em2, rr, k0, k1);
    for (int k = k0; k <= k1; ++k) {
      const float w3 = hat1(__fsub_rn(mp, __fadd_rn(__fmul_rn(em1, hf), __fmul_rn(em2, (float)k))));
      const int vr = shk ? k : h, vc = shk ? h : k;
      if (!(w3 > 0.f) || vc * vc + vr * vr >= rr * rr) continue;
      const float4 v = __ldg(vals + (vr + rr) * nk + (vc + rr));
      const float w = __fmul_rn(__fmul_rn(w3, w2), wz);
      re += v.x * w;
      im += v.y * w;
      t += v.z * w;
      hit = true;
    }
  }
  return hit;
}

template <bool MATES, int MAXC, int WT>
__global__ void __launch_bounds__(THREADS, 2) insert_gather_kernel(Slices S, Grid G) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                               // 9 x CAP: Q = M R, row-major
  float* sR = sQ + 9 * CAP;                       // 6 x CAP: R's first two columns
  int* sS = reinterpret_cast<int*>(sR + 6 * CAP);  // CAP: slice
  int* sM = sS + CAP;                             // CAP: mate
  int* sF = sM + CAP;                             // CAP: HK11's flags (sR: its coefficients)
  float* sMat = reinterpret_cast<float*>(sF + CAP);  // 9 x n_sym
  __shared__ int warp_n[THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int big = G.big, cb = big / 2;
  const int nbx = (big + BRICK - 1) / BRICK;
  const int bx = blockIdx.x % nbx, by = (blockIdx.x / nbx) % nbx, bz = blockIdx.x / (nbx * nbx);
  const int cls_k = blockIdx.y;
  const int x0 = bx * BRICK, y0 = by * BRICK, z0 = G.z0 + bz * BRICK;
  const int x1 = min(x0 + BRICK, big) - 1, y1 = min(y0 + BRICK, big) - 1;
  const int z1 = min(z0 + BRICK, G.z0 + G.bz) - 1;
  const float reach = WT == TRI ? REACH : S.reach;
  const float lim_r = S.mrp + (WT == SWEEP ? S.reach_r : reach);
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
    return sqrtf(ex * ex + ey * ey + ez * ez) + reach;
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
  const float mrp2 = S.mrp * S.mrp;
  const bool inside_r = kr2 < mrp2;   // slab form: a mate adds only inside the radius
  const int vx0 = vlo_of(ix), vx1 = vhi_of(ix), vy0 = vlo_of(iy), vy1 = vhi_of(iy);
  const int vz0 = vlo_of(iz), vz1 = vhi_of(iz);
  const bool faces = vx0 != vx1 || vy0 != vy1 || vz0 != vz1;
  const float fkx = (float)kx, fky = (float)ky, fkz = (float)kz;

  if (MATES)
    for (int i = tid; i < 9 * S.n_sym; i += THREADS) sMat[i] = S.mats[i];
  __syncthreads();

  const long long n_planes = (long long)S.n_slices * S.n_sym;
  float acc_re = 0.f, acc_im = 0.f, acc_t = 0.f;
  bool hit = false;
  long long base = 0;
  while (base < n_planes) {
    // list the next planes whose normal passes near the brick, in order
    int count = 0;
    while (base < n_planes && count + THREADS <= CAP) {
      long long i = base + tid;
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
            float a = M[0] * n0 + M[1] * n1 + M[2] * n2;
            float b = M[3] * n0 + M[4] * n1 + M[5] * n2;
            float c = M[6] * n0 + M[7] * n1 + M[8] * n2;
            n0 = a, n1 = b, n2 = c;
          }
          pass = fabsf(n0 * cbk[0] + n1 * cbk[1] + n2 * cbk[2]) < lim_b;
        }
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
        const float* M = sMat + 9 * m;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            sQ[(3 * a + b) * CAP + at] =
                MATES ? M[3 * a] * r[b] + M[3 * a + 1] * r[3 + b] + M[3 * a + 2] * r[6 + b]
                      : r[3 * a + b];
        if (WT == SWEEP) {
          const float* c = S.coef + 8LL * i;
#pragma unroll
          for (int j = 0; j < 6; ++j) sR[j * CAP + at] = c[j];
          sF[at] = (int)c[6];
        } else {
          sR[0 * CAP + at] = r[0];
          sR[1 * CAP + at] = r[1];
          sR[2 * CAP + at] = r[3];
          sR[3 * CAP + at] = r[4];
          sR[4 * CAP + at] = r[6];
          sR[5 * CAP + at] = r[7];
        }
        sS[at] = s;
        sM[at] = m;
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
        if (!active || (MATES && sM[ej] > 0 && !inside_r)) continue;
        const float n0 = sQ[2 * CAP + ej], n1 = sQ[5 * CAP + ej], n2 = sQ[8 * CAP + ej];
        bool near_c = fabsf(n0 * fkx + n1 * fky + n2 * fkz) < reach;
        if (faces)
          for (int vz = vz0; vz <= vz1; ++vz)
            for (int vy = vy0; vy <= vy1; ++vy)
              for (int vx = vx0; vx <= vx1; ++vx)
                near_c = near_c || fabsf(n0 * (float)(vx - cb) + n1 * (float)(vy - cb) +
                                         n2 * (float)(vz - cb)) < reach;
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
        const float* M = sMat + 9 * (MATES ? sM[ej] : 0);
        if (WT == SWEEP) {   // nothing is clipped onto a face: no virtual cells
          hit |= sweep_into_cell(S, r6, sF[ej], s, ix, iy, iz, cb, acc_re, acc_im, acc_t);
        } else if (!faces) {
          hit |= plane_into_cell<MATES, MAXC, WT>(S, q, r6, M, s, ix, iy, iz, cb, acc_re,
                                                        acc_im, acc_t);
        } else {
          for (int vz = vz0; vz <= vz1; ++vz)
            for (int vy = vy0; vy <= vy1; ++vy)
              for (int vx = vx0; vx <= vx1; ++vx)
                hit |= plane_into_cell<MATES, MAXC, WT>(S, q, r6, M, s, vx, vy, vz, cb,
                                                              acc_re, acc_im, acc_t);
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

constexpr size_t SMEM = (size_t)(18 * CAP + 9 * MAX_SYM) * sizeof(float);

template <bool MATES, int WT>
int launch_gather(const Slices& S, const Grid& G, int n_class, cudaStream_t stream) {
  // candidates an axis: 2 reach / pf + 1 of them at most (2 sqrt 3 / pf + 1
  // for trilinear taps: 4 at pf 1, 2 at pf 2 and above); HK11 forms its
  // own ranges
  const int maxc = max(2, (int)(2.f * (WT == MKB ? S.reach : REACH) / (float)S.pf) + 1);
  void (*kernel)(Slices, Grid);
  if (WT == SWEEP) {
    kernel = insert_gather_kernel<MATES, 2, WT>;
  } else {
    switch (maxc) {
      case 2: kernel = insert_gather_kernel<MATES, 2, WT>; break;
      case 3: kernel = insert_gather_kernel<MATES, 3, WT>; break;
      case 4: kernel = insert_gather_kernel<MATES, 4, WT>; break;
      case 5: kernel = insert_gather_kernel<MATES, 5, WT>; break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long nbx = (G.big + BRICK - 1) / BRICK, nbz = (G.bz + BRICK - 1) / BRICK;
  kernel<<<dim3((unsigned)(nbx * nbx * nbz), n_class), THREADS, SMEM, stream>>>(S, G);
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
           max_radius_pad, box_a, tpos, REACH, STRIP, 0, 0.f, 0.f, 0.f, 0.f};
  Grid G{(float2*)F, (float*)T, big, 0, big, vlo, vhi};
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = 2 * r_u - 1;
  long long total = (long long)n_slices * nk * nk;
  const int threads = 256;
  form_values_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      S, (float4*)vals, total);
  return launch_gather<false, TRI>(S, G, 1, st);
}

// HK10.  HK3's arguments, then the blob's radius a (0 < a <= 2), a^2 and
// alpha as the plain version rounds them, and 1 / I0(alpha); vlo / vhi
// the blob's tap range (two past the radius).
extern "C" int thunder_insert_mkb(
    const void* ft, int size, const void* ctfk, const void* img_idx, const void* rot,
    const void* trans, const void* w, const void* dfac, int n_slices, int r_u, int pf,
    float max_radius_pad, float box_a, float tpos, void* F, void* T, void* vals, int big,
    int vlo, int vhi, float mkb_a, float mkb_a2, float mkb_alpha, float mkb_inv_i0,
    void* stream) {
  if (n_slices <= 0) return (int)cudaGetLastError();
  if (!(mkb_a > 0.f && mkb_a <= 2.f)) return (int)cudaErrorInvalidValue;
  Slices S{(const float4*)vals, (const float2*)ft, (const float*)ctfk,
           (const int*)img_idx, (const float*)trans, (const float*)dfac, (const float*)w,
           (const float*)rot, nullptr, nullptr, n_slices, 1, r_u, pf, size,
           max_radius_pad, box_a, tpos, mkb_a + MARGIN, mkb_a + MARGIN, 1, mkb_a, mkb_a2,
           mkb_alpha, mkb_inv_i0};
  Grid G{(float2*)F, (float*)T, big, 0, big, vlo, vhi};
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = 2 * r_u - 1;
  long long total = (long long)n_slices * nk * nk;
  const int threads = 256;
  form_values_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      S, (float4*)vals, total);
  return launch_gather<false, MKB>(S, G, 1, st);
}

// HK11.  HK3's arguments (no tap range: the sweep clips nothing onto a
// face) and coef (B, 8), the slices' sweep records (ops/insert.py
// sweep_coeffs).
extern "C" int thunder_insert_sweep(
    const void* ft, int size, const void* ctfk, const void* img_idx, const void* rot,
    const void* coef, const void* trans, const void* w, const void* dfac, int n_slices, int r_u,
    int pf, float max_radius_pad, float box_a, float tpos, void* F, void* T, void* vals, int big,
    void* stream) {
  if (n_slices <= 0) return (int)cudaGetLastError();
  Slices S{(const float4*)vals, (const float2*)ft, (const float*)ctfk,
           (const int*)img_idx, (const float*)trans, (const float*)dfac, (const float*)w,
           (const float*)rot, nullptr, nullptr, n_slices, 1, r_u, pf, size,
           max_radius_pad, box_a, tpos, SWEEP_BAND, SWEEP_BAND, 0, 0.f, 0.f, 0.f, 0.f,
           SWEEP_REACH, (const float*)coef};
  Grid G{(float2*)F, (float*)T, big, 0, big, 0, big - 1};
  cudaStream_t st = (cudaStream_t)stream;
  const int nk = 2 * r_u - 1;
  long long total = (long long)n_slices * nk * nk;
  const int threads = 256;
  form_values_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      S, (float4*)vals, total);
  return launch_gather<false, SWEEP>(S, G, 1, st);
}

// HK11's slab form.  vals (B, nk^2, 4) float32 (Re val, Im val, c2w, 0),
// rot (B, 9), cls (B,) int32, mats (n_sym, 9) with the identity first; F
// (K, bz, big, big) complex64 and T float32 of the slab [z0, z0 + bz),
// accumulated into; coef (B n_sym, 8), the sweep records of the planes
// (slice, mate) in slice order then mate order (ops/insert.py
// sweep_planes).
extern "C" int thunder_insert_sweep_slab(
    const void* vals, const void* rot, const void* coef, const void* cls, int n_slices, int r_u,
    int pf, float max_radius_pad, const void* mats, int n_sym, void* F, void* T, int n_class,
    int big, int z0, int bz, void* stream) {
  if (n_slices <= 0 || n_class <= 0) return (int)cudaGetLastError();
  if (n_sym < 1 || n_sym > MAX_SYM) return (int)cudaErrorInvalidValue;
  Slices S{(const float4*)vals, nullptr, nullptr, nullptr, nullptr, nullptr,
           nullptr, (const float*)rot, (const int*)cls, (const float*)mats, n_slices, n_sym,
           r_u, pf, 0, max_radius_pad, 0.f, 0.f, SWEEP_BAND, SWEEP_BAND, 0, 0.f, 0.f, 0.f, 0.f,
           SWEEP_REACH, (const float*)coef};
  Grid G{(float2*)F, (float*)T, big, z0, bz, 0, big - 1};
  return launch_gather<true, SWEEP>(S, G, n_class, (cudaStream_t)stream);
}
