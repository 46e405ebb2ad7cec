// HK10 insert_mkb: Fourier insertion of slices with the modified
// Kaiser-Bessel blob (the insertion option reco_kernel="mkb") as a
// scatter into bricks of cells that a block owns in shared memory.
//
// Replaces (thunder_tpu): optimiser._insert_all_h with kernel="mkb",
// ops/insert.py:76 insert_slices_3d over :52 _mkb_taps (Reconstructor.cpp
// :424-567).  Sample (vc, vr) of slice s (a pixel of the nk x nk window,
// nk = 2 r_u - 1, in the disc vc^2 + vr^2 <= (r_u - 1)^2 with its edge)
// sits at p = R_s . (pf vc, pf vr, 0), products and sums rounded one by
// one as the plain version forms them; |p| >= max_radius_pad drops it.  It
// adds val w(|k - p|^2) to each cell k of its 4^3 neighbourhood floor(p)
// - 1 ... floor(p) + 2 (tap indices clipped to the grid) with |k - p|^2 <
// a^2, a <= 2 (1.9 in every shipped config): about 4/3 pi a^3 = 28.7
// taps a sample.  The values are HK3's (slice_values.cuh), formed once in
// a first pass into a (B, nk^2) scratch of (Re, Im, c2w, 0) records.
//
// The weight.  MKB_FT(r) = I0(alpha sqrt(1 - r^2 / a^2)) / I0(alpha) is a
// power series in s = 1 - r^2 / a^2 with positive coefficients, c_k =
// (alpha^2 / 4)^k / (k!)^2 / I0(alpha) (ops/insert.py mkb_constants forms
// them on the host, to degree MKB_DEG); Horner's rule in float32 gives it
// within 3.4e-7 of the float64 value on [0, 1] at alpha = 15 (torch's
// float32 I0 quotient: 1.1e-6), from d^2 alone: no square root,
// division or Bessel function a tap.  The plain versions compute the same
// series (ops/insert.py _mkb_taps).
//
// The design.  A block owns an 8 x 8 x 8 brick of cells; each of its
// eight warps keeps sums of its own for every cell of it (Re F, Im F, T in
// shared memory).  The block lists, in slice order, the planes whose
// normal passes within the brick's half-diagonal + a of its centre, and
// each warp takes an eighth of each list, in order: it queues, plane
// after plane, the samples whose position can reach the brick (for each
// row vr the range of vc whose position lies within a of the brick's box;
// faces: of its virtual cells).  A round takes 32 queued samples, a lane
// each: the lane forms the sample's position once, applies the cuts,
// loads its value once and marks which of its 64 taps land in the brick
// with d^2 < a^2 (11.1 of them on average).  The marked taps, in the
// order (sample, tap j = 16 z + 4 y + x), then go out 32 a batch, a lane
// a tap: its weight, and a plain load and store of the cell's three sums.
// Taps of one batch that meet in a cell are added one after another in
// lane order (__match_any_sync).  At the end the warps' sums are added in
// warp order and the brick to F and T once: every cell's sum forms in one
// order, the same in every call, without atomics, and no two blocks
// write one cell.  Every plane passes the bricks at the grid's centre,
// so they take the longest: the blocks are launched nearest the centre
// first (ops/insert.py mkb_bricks), and a brick's planes are shared by
// its eight warps.  (A warp a part of a brick, taking all its planes,
// ran 2.3x slower than the gather this replaces: the central parts set
// the time; a lane a sample walking its own 64 taps kept ~5 % of the
// lanes busy at each tap: 3x slower; PERF.md section 6.)
//
// What bounds it on Hopper: operations, and their latency.  A sample's
// position is formed once for each brick its blob reaches, about 2.6
// times (the gather formed it for each of its ~29 cells and the
// candidates around them), and tests its 64 taps there; each tap that
// lands costs the series' 24 multiply-adds, a few shuffles and a
// shared-memory read and write of three floats.
#include <cuda_runtime.h>
#include <math.h>

#include "slice_values.cuh"

namespace {

constexpr int MKB_THREADS = 256;
constexpr int MKB_WARPS = MKB_THREADS / 32;
constexpr int MKB_BXY = 8;              // a brick's cells in x and y
constexpr int MKB_BZ = 8;               // and in z
constexpr int MKB_CELLS = MKB_BXY * MKB_BXY * MKB_BZ;
constexpr int MKB_CAP = 512;            // planes a block lists at once
constexpr int MKB_QUEUE = 64;           // samples a warp's queue holds (a power of two)
constexpr int MKB_MIN_BLOCKS = 3;       // blocks an SM (__launch_bounds__): 80 registers
constexpr int MKB_DEG = 24;             // the weight's series, to s^MKB_DEG
constexpr float MKB_MARGIN = 5e-2f;     // on every reach: float rounding of positions
constexpr unsigned FULL = 0xffffffffu;

struct MkbArgs {
  const float4* vals;   // (B, nk^2) of (Re val, Im val, c2w, 0)
  const float* rot;     // (B, 9) row-major
  const float* wsl;     // (B,) slices of weight zero are not listed
  int n_slices, r_u, pf;
  float mrp;            // max_radius_pad
  float a, a2, inv_a2;  // the blob's radius, a^2 and 1 / a^2 as the plain version rounds them
  float coef[MKB_DEG + 1];
};

struct MkbGrid {
  float2* F;            // (big^3) complex64, centered
  float* T;
  int big;
  int vlo, vhi;         // virtual index range a tap can take on each axis
  const int* order;     // the bricks a sample can reach, a block each (ops/insert.py mkb_bricks)
};

// the weight at squared distance d2: the series in s = 1 - d2 / a^2
__device__ __forceinline__ float mkb_weight(const MkbArgs& S, float d2) {
  const float s = __fsub_rn(1.f, __fmul_rn(d2, S.inv_a2));
  float p = S.coef[MKB_DEG];
#pragma unroll
  for (int k = MKB_DEG - 1; k >= 0; --k) p = fmaf(p, s, S.coef[k]);
  return p;
}

// One axis of a sample at x: its four taps' virtual indices t0 ... t0 + 3
// (t0 = floor(x) - 1 + cb), which of them land in the brick [lo, hi] once
// clipped to the grid (bits 0-3), and their squared distances, rounded as
// the plain version rounds them.
struct Axis {
  int t0;
  unsigned in;
  float sq[4];
};

__device__ __forceinline__ Axis axis_taps(float x, int cb, int big, int lo, int hi) {
  Axis A;
  const float fl = floorf(x);
  A.t0 = (int)fl - 1 + cb;
  A.in = 0u;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int v = A.t0 + d;
    const int r = min(max(v, 0), big - 1);
    if (r >= lo && r <= hi) A.in |= 1u << d;
    const float dx = __fsub_rn((float)(v - cb), x);
    A.sq[d] = __fmul_rn(dx, dx);
  }
  return A;
}

// The taps of one axis' tap d: its squared distance, rounded as above
__device__ __forceinline__ float tap_sq(int t0, int d, int cb, float x) {
  const float dx = __fsub_rn((float)(t0 + d - cb), x);
  return __fmul_rn(dx, dx);
}

// The position of the n-th (from 0) set bit of m
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const unsigned low = m & ((1u << h) - 1u);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      m >>= h;
      pos += h;
    } else {
      m = low;
    }
  }
  return pos;
}

// The samples a warp has queued (a ring of MKB_QUEUE entries: the listed
// plane and the sample's pixel (vr + r_u - 1) nk + vc + r_u - 1 in the
// window), from head to tail.  A round takes up to 32 of
// them, a lane each: the lane forms its sample's position once, applies
// the cuts, loads its value and marks which of its 64 taps (j = 16 z + 4 y
// + x) land in the brick with d^2 < a^2.  The marked taps, in the order
// (sample, j), are then handed out 32 at a time, a lane a tap: each forms
// its weight and adds val w to the warp's sum of its cell by a plain load
// and store.  Taps of one batch that meet in a cell (samples of one plane
// lie 2 or more apart at pf >= 2, but at pf 1, across planes and where
// taps are clipped onto a face they can meet) are added one after another
// in lane order (__match_any_sync), so every cell's sum forms in the
// order of the queue and j.
__device__ __forceinline__ void queue_round(const MkbArgs& S, const MkbGrid& G, float* acc,
                                            const float* sP, const int* sS, const int2* q,
                                            int head, int n, const int* blo, const int* bhi,
                                            int bx0, int by0, int bz0, int lane) {
  constexpr int BX = MKB_BXY, BY = MKB_BXY, CELLS = MKB_CELLS;
  const int big = G.big, cb = big / 2, pf = S.pf, rr = S.r_u - 1, nk = 2 * S.r_u - 1;
  const float mrp2 = S.mrp * S.mrp;
  // this lane's sample
  float px = 0.f, py = 0.f, pz = 0.f;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned m_lo = 0u, m_hi = 0u;
  if (lane < n) {
    const int2 qe = q[(head + lane) & (MKB_QUEUE - 1)];
    const int e = qe.x, pix = qe.y, row = pix / nk;
    const int vc = pix - row * nk - rr, vr = row - rr;
    const float gx = (float)(vc * pf), gy = (float)(vr * pf);
    // the position, rounded as the scatter rounds it
    px = __fadd_rn(__fmul_rn(sP[e], gx), __fmul_rn(sP[3 * MKB_CAP + e], gy));
    py = __fadd_rn(__fmul_rn(sP[MKB_CAP + e], gx), __fmul_rn(sP[4 * MKB_CAP + e], gy));
    pz = __fadd_rn(__fmul_rn(sP[2 * MKB_CAP + e], gx), __fmul_rn(sP[5 * MKB_CAP + e], gy));
    const bool in = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                              __fmul_rn(pz, pz)) < mrp2;
    const Axis X = axis_taps(px, cb, big, blo[0], bhi[0]);
    const Axis Y = axis_taps(py, cb, big, blo[1], bhi[1]);
    const Axis Z = axis_taps(pz, cb, big, blo[2], bhi[2]);
    if (in && X.in && Y.in && Z.in) {
      v = __ldg(S.vals + (long long)sS[e] * nk * nk + pix);
#pragma unroll
      for (int dz = 0; dz < 4; ++dz)
#pragma unroll
        for (int dy = 0; dy < 4; ++dy)
#pragma unroll
          for (int dx = 0; dx < 4; ++dx) {
            const int j = 16 * dz + 4 * dy + dx;
            const bool hit = ((X.in >> dx) & (Y.in >> dy) & (Z.in >> dz) & 1u) &&
                             __fadd_rn(__fadd_rn(X.sq[dx], Y.sq[dy]), Z.sq[dz]) < S.a2;
            if (hit) {
              if (j < 32) m_lo |= 1u << j;
              else m_hi |= 1u << (j - 32);
            }
          }
    }
  }
  // the marked taps, 32 at a time, a lane a tap
  const int cnt = __popc(m_lo) + __popc(m_hi);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  for (int b = 0; b < total; b += 32) {
    const int item = b + lane;
    const bool valid = item < total;
    int l = 0;
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
      const int c = __shfl_sync(FULL, incl, l + h - 1);
      if (c <= item) l += h;
    }
    l = min(l, 31);
    const int rank = item - (__shfl_sync(FULL, incl, l) - __shfl_sync(FULL, cnt, l));
    const unsigned lo = __shfl_sync(FULL, m_lo, l), hi = __shfl_sync(FULL, m_hi, l);
    const float sx = __shfl_sync(FULL, px, l), sy = __shfl_sync(FULL, py, l);
    const float sz = __shfl_sync(FULL, pz, l);
    const int t0x = (int)floorf(sx) - 1 + cb, t0y = (int)floorf(sy) - 1 + cb;
    const int t0z = (int)floorf(sz) - 1 + cb;
    const float vx = __shfl_sync(FULL, v.x, l), vy = __shfl_sync(FULL, v.y, l);
    const float vz = __shfl_sync(FULL, v.z, l);
    int cell = -1;
    float w = 0.f;
    if (valid) {
      // the rank-th marked tap of the sample
      const int n_lo = __popc(lo);
      const int j = rank < n_lo ? nth_bit(lo, rank) : 32 + nth_bit(hi, rank - n_lo);
      const int dx = j & 3, dy = (j >> 2) & 3, dz = j >> 4;
      const float d2 = __fadd_rn(__fadd_rn(tap_sq(t0x, dx, cb, sx), tap_sq(t0y, dy, cb, sy)),
                                 tap_sq(t0z, dz, cb, sz));
      w = mkb_weight(S, d2);
      const int ix = min(max(t0x + dx, 0), big - 1) - bx0;
      const int iy = min(max(t0y + dy, 0), big - 1) - by0;
      const int iz = min(max(t0z + dz, 0), big - 1) - bz0;
      cell = (iz * BY + iy) * BX + ix;
    }
    // taps that meet in a cell: one after another, in lane order
    const unsigned vmask = __ballot_sync(FULL, valid);
    int order = 0;
    if (valid) order = __popc(__match_any_sync(vmask, cell) & ((1u << lane) - 1u));
    for (int r = 0; __any_sync(FULL, valid && order >= r); ++r) {
      if (valid && order == r) {
        float* c = acc + cell;
        c[0] = fmaf(vx, w, c[0]);
        c[CELLS] = fmaf(vy, w, c[CELLS]);
        c[2 * CELLS] = fmaf(vz, w, c[2 * CELLS]);
      }
      __syncwarp();
    }
  }
}

// The samples of one plane (listed as e; R's first two columns c0, c1)
// that can reach the brick, whose box widened by a (and its margin) is
// [elo, ehi] in centered coordinates: the rows vr and, for each, the
// range of vc whose position lies in the box, queued in (vr, vc) order;
// each time 32 or more wait, a round takes them.
__device__ __forceinline__ void queue_plane(const MkbArgs& S, const MkbGrid& G, float* acc,
                                            const float* sP, const int* sS, int2* q, int& head,
                                            int& tail, int e, const float* elo, const float* ehi,
                                            const int* blo, const int* bhi, int bx0, int by0,
                                            int bz0, int lane) {
  const int pf = S.pf, rr = S.r_u - 1, nk = 2 * S.r_u - 1;
  const float fpf = (float)pf;
  const float c0[3] = {sP[e], sP[MKB_CAP + e], sP[2 * MKB_CAP + e]};
  const float c1[3] = {sP[3 * MKB_CAP + e], sP[4 * MKB_CAP + e], sP[5 * MKB_CAP + e]};
  // the rows: vr pf = c1 . p over the box
  float mid = 0.f, half = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mid += c1[i] * 0.5f * (elo[i] + ehi[i]);
    half += fabsf(c1[i]) * 0.5f * (ehi[i] - elo[i]);
  }
  const int vr_lo = max(-rr, (int)ceilf((mid - half) / fpf));
  const int vr_hi = min(rr, (int)floorf((mid + half) / fpf));
  for (int row0 = vr_lo; row0 <= vr_hi; row0 += 32) {
    // a lane a row: its range of vc
    const int vr = row0 + lane;
    int lo = 1, hi = 0;
    if (vr <= vr_hi) {
      const int qq = rr * rr - vr * vr;
      int m = (int)sqrtf((float)qq);
      while (m * m > qq) --m;
      while ((m + 1) * (m + 1) <= qq) ++m;
      lo = -m, hi = m;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float base = fpf * (float)vr * c1[i], stp = fpf * c0[i];
        if (fabsf(stp) > 1e-6f) {
          const float inv = 1.f / stp;
          const float t0 = (elo[i] - base) * inv, t1 = (ehi[i] - base) * inv;
          lo = max(lo, (int)ceilf(fminf(t0, t1) - MKB_MARGIN));
          hi = min(hi, (int)floorf(fmaxf(t0, t1) + MKB_MARGIN));
        } else if (base < elo[i] || base > ehi[i]) {
          hi = lo - 1;
        }
      }
    }
    const int cnt = hi >= lo ? hi - lo + 1 : 0;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    for (int b = 0; b < total; b += 32) {
      // candidate b + lane: its row's lane by binary search, then queued
      const int idx = b + lane;
      int l = 0;
#pragma unroll
      for (int h = 16; h >= 1; h >>= 1) {
        const int c = __shfl_sync(FULL, incl, l + h - 1);
        if (c <= idx) l += h;
      }
      l = min(l, 31);
      const int before = __shfl_sync(FULL, incl - cnt, l);
      const int lo_l = __shfl_sync(FULL, lo, l);
      if (idx < total)
        q[(tail + lane) & (MKB_QUEUE - 1)] =
            make_int2(e, (row0 + l + rr) * nk + lo_l + idx - before + rr);
      tail += min(32, total - b);
      __syncwarp();
      if (tail - head >= 32) {
        queue_round(S, G, acc, sP, sS, q, head, 32, blo, bhi, bx0, by0, bz0, lane);
        head += 32;
        __syncwarp();
      }
    }
  }
}

__global__ void __launch_bounds__(MKB_THREADS, MKB_MIN_BLOCKS)
    mkb_brick_kernel(MkbArgs S, MkbGrid G) {
  constexpr int BX = MKB_BXY, BY = MKB_BXY, BZ = MKB_BZ, CELLS = MKB_CELLS;
  extern __shared__ __align__(16) float smem[];
  float* sums = smem;                                  // a warp: Re F, Im F, T, CELLS each
  float* sP = sums + MKB_WARPS * 3 * CELLS;            // 9 x CAP: R's columns 0, 1, 2
  int* sS = reinterpret_cast<int*>(sP + 9 * MKB_CAP);  // CAP: slice
  int2* sQ = reinterpret_cast<int2*>(sS + MKB_CAP);   // a queue a warp
  __shared__ int warp_n[MKB_WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* acc = sums + warp * 3 * CELLS;
  int2* q = sQ + warp * MKB_QUEUE;
  const int big = G.big, cb = big / 2;
  const int nbx = (big + BX - 1) / BX, nby = (big + BY - 1) / BY;
  const int brick = G.order[blockIdx.x];
  const int x0 = (brick % nbx) * BX, y0 = ((brick / nbx) % nby) * BY;
  const int z0 = (brick / (nbx * nby)) * BZ;
  const int x1 = min(x0 + BX, big) - 1, y1 = min(y0 + BY, big) - 1, z1 = min(z0 + BZ, big) - 1;
  const float reach = S.a + MKB_MARGIN;
  for (int i = tid; i < MKB_WARPS * 3 * CELLS; i += MKB_THREADS) sums[i] = 0.f;
  // the brick's virtual box (a face cell also owns the taps clipped onto
  // it) in centered coordinates, widened by the reach, its centre and the
  // half-diagonal
  const int blo[3] = {x0, y0, z0}, bhi[3] = {x1, y1, z1};
  float elo[3], ehi[3], bc[3], e2 = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float lo = (float)((blo[i] == 0 ? min(G.vlo, 0) : blo[i]) - cb);
    const float hi = (float)((bhi[i] == big - 1 ? max(G.vhi, big - 1) : bhi[i]) - cb);
    bc[i] = 0.5f * (lo + hi);
    e2 += 0.25f * (hi - lo) * (hi - lo);
    elo[i] = lo - reach, ehi[i] = hi + reach;
  }
  const float lim_b = sqrtf(e2) + reach;
  __syncthreads();

  const long long n_planes = S.n_slices;
  long long base = 0;
  while (base < n_planes) {
    // list the next planes whose normal passes near the brick, in order
    int count = 0;
    while (base < n_planes && count + MKB_THREADS <= MKB_CAP) {
      const long long i = base + tid;
      bool pass = false;
      const int s = (int)i;
      if (i < n_planes && S.wsl[s] != 0.f) {
        const float* R = S.rot + 9LL * s;
        pass = fabsf(R[2] * bc[0] + R[5] * bc[1] + R[8] * bc[2]) < lim_b;
      }
      const unsigned ball = __ballot_sync(FULL, pass);
      if (lane == 0) warp_n[warp] = __popc(ball);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < MKB_WARPS; ++w) {
        const int c = warp_n[w];
        before += w < warp ? c : 0;
        total += c;
      }
      if (pass) {
        const int at = count + before + __popc(ball & ((1u << lane) - 1u));
        const float* R = S.rot + 9LL * s;
        // column 0 (vc), column 1 (vr), column 2 (the normal)
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int r = 0; r < 3; ++r) sP[(3 * c + r) * MKB_CAP + at] = R[3 * r + c];
        sS[at] = s;
      }
      count += total;
      base += MKB_THREADS;
      __syncthreads();   // warp_n is rewritten by the next step
    }
    // the warp's share of the listed planes, in order, into its own sums
    int head = 0, tail = 0;
    const int e_end = count * (warp + 1) / MKB_WARPS;
    for (int e = count * warp / MKB_WARPS; e < e_end; ++e)
      queue_plane(S, G, acc, sP, sS, q, head, tail, e, elo, ehi, blo, bhi, x0, y0, z0, lane);
    // what its planes left queued
    if (tail > head)
      queue_round(S, G, acc, sP, sS, q, head, tail - head, blo, bhi, x0, y0, z0, lane);
    __syncthreads();   // the list is refilled
  }
  // the brick, once, the warps' sums added in warp order: disjoint from
  // every other block's
  for (int i = tid; i < CELLS; i += MKB_THREADS) {
    const int ix = x0 + i % BX, iy = y0 + (i / BX) % BY, iz = z0 + i / (BX * BY);
    if (ix > x1 || iy > y1 || iz > z1) continue;
    float re = sums[i], im = sums[CELLS + i], t = sums[2 * CELLS + i];
#pragma unroll
    for (int w = 1; w < MKB_WARPS; ++w) {
      const float* a = sums + w * 3 * CELLS;
      re = __fadd_rn(re, a[i]);
      im = __fadd_rn(im, a[CELLS + i]);
      t = __fadd_rn(t, a[2 * CELLS + i]);
    }
    if (re == 0.f && im == 0.f && t == 0.f) continue;
    const long long cell = ((long long)iz * big + iy) * big + ix;
    const float2 f = G.F[cell];
    G.F[cell] = make_float2(__fadd_rn(f.x, re), __fadd_rn(f.y, im));
    G.T[cell] = __fadd_rn(G.T[cell], t);
  }
}

// the sums, the listed planes and the queues (two ints an entry)
constexpr size_t MKB_SMEM =
    (size_t)(MKB_WARPS * 3 * MKB_CELLS + 10 * MKB_CAP + 2 * MKB_WARPS * MKB_QUEUE) * sizeof(float);

// the first pass: HK3's values over the window with its edge (the disc
// vc^2 + vr^2 <= (r_u - 1)^2), zero elsewhere and for slices of weight zero
__global__ void mkb_values_kernel(SliceValues V, int r_u, float4* __restrict__ vals,
                                  long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int nk = 2 * r_u - 1, rr = r_u - 1, npx = nk * nk;
  const int s = (int)(idx / npx);
  const int p = (int)(idx - (long long)s * npx);
  const int vr = p / nk - rr, vc = p % nk - rr;
  float re = 0.f, im = 0.f, cw = 0.f;
  if (vc * vc + vr * vr <= rr * rr && V.wsl[s] != 0.f) slice_value(V, s, vc, vr, re, im, cw);
  vals[idx] = make_float4(re, im, cw, 0.f);
}

// the first pass into vals, then the blob's arguments (coef on the host)
MkbArgs mkb_values(const SliceValues& V, const float* rot, int n_slices, int r_u, int pf,
                   float max_radius_pad, float* vals, float a, float a2, float inv_a2,
                   const float* coef, cudaStream_t st) {
  const int nk = 2 * r_u - 1;
  const long long total = (long long)n_slices * nk * nk;
  mkb_values_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(V, r_u, (float4*)vals,
                                                                      total);
  MkbArgs S{(const float4*)vals, rot, V.wsl, n_slices, r_u, pf, max_radius_pad, a, a2, inv_a2,
            {}};
  for (int k = 0; k <= MKB_DEG; ++k) S.coef[k] = coef[k];
  return S;
}

int launch_mkb(const MkbArgs& S, const MkbGrid& G, int n_bricks, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute((const void*)mkb_brick_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)MKB_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (n_bricks > 0) mkb_brick_kernel<<<(unsigned)n_bricks, MKB_THREADS, MKB_SMEM, st>>>(S, G);
  return (int)cudaGetLastError();
}

}  // namespace

// HK10.  ft (L, size, size) complex64; ctfk (L, 8); per slice img_idx
// (B,) int32, rot (B, 9), trans (B, 2), w (B,), dfac (B,) or null; F
// (big^3) complex64 and T (big^3) float32 accumulated into; vals (B,
// nk^2, 4) float32 scratch for the formed values; vlo / vhi the blob's
// tap range (two past the radius); order (n_bricks,) int32 the bricks to
// fill, a block each, in launch order (ops/insert.py mkb_bricks); the
// blob's radius a (0 < a <= 2), a^2 and 1 / a^2 as the plain version
// rounds them, and coef (MKB_DEG + 1,), on the host, the weight's series
// in 1 - d^2 / a^2 (ops/insert.py mkb_constants).
extern "C" int thunder_insert_mkb(
    const void* ft, int size, const void* ctfk, const void* img_idx, const void* rot,
    const void* trans, const void* w, const void* dfac, int n_slices, int r_u, int pf,
    float max_radius_pad, float box_a, float tpos, void* F, void* T, void* vals, int big,
    int vlo, int vhi, const void* order, int n_bricks, float mkb_a, float mkb_a2,
    float mkb_inv_a2, const void* coef, void* stream) {
  const SliceValues V{(const float2*)ft, (const float*)ctfk, (const int*)img_idx,
                      (const float*)trans, (const float*)dfac, (const float*)w, size, box_a,
                      tpos};
  if (n_slices <= 0) return (int)cudaGetLastError();
  if (!(mkb_a > 0.f && mkb_a <= 2.f)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const MkbArgs S = mkb_values(V, (const float*)rot, n_slices, r_u, pf, max_radius_pad,
                               (float*)vals, mkb_a, mkb_a2, mkb_inv_a2, (const float*)coef, st);
  const MkbGrid G{(float2*)F, (float*)T, big, vlo, vhi, (const int*)order};
  return launch_mkb(S, G, n_bricks, st);
}

// The registers and local memory (spilled bytes) a thread of HK10's
// kernel on the path takes: out[0] numRegs, out[1] localSizeBytes.
extern "C" int thunder_insert_mkb_attrs(void* out) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, (const void*)mkb_brick_kernel);
  if (e != cudaSuccess) return (int)e;
  ((int*)out)[0] = fa.numRegs;
  ((int*)out)[1] = (int)fa.localSizeBytes;
  return 0;
}
