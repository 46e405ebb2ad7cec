// Instances of HK10 insert_mkb timed in turns (micro/hk_candidates.py
// --kernels hk10): the gather HK10 was until it became the brick-owned
// scatter of csrc/insert_mkb.cu, with other weights and launch bounds, and
// that scatter's own instances.
//
//   0  the gather (HK3's cell-owned gather with the blob's weight, two
//      blocks of 512 threads an SM: 64 registers), the closed-form weight
//      (two square roots, a division and cyl_bessel_i0f a tap)
//   1  the gather, weight 1 inside the ball (no sqrt, division or I0)
//   2  the gather, __launch_bounds__(512, 1): no register cap
//   3  the gather, the weight as the series in 1 - d^2 / a^2
//   4  the scatter on the path (csrc/insert_mkb.cu: series, 8^3 bricks,
//      three blocks an SM)
//   5  the scatter, the closed-form weight
//   6  the scatter, series, 8 x 8 x 4 bricks
//   7  the scatter, weight 1 inside the ball
//   8  the scatter, series, __launch_bounds__(256, 2): two blocks an SM
//
// Instances 5-8 run namespace scatter's copy of the path's kernel with the
// weight's form, the brick's depth and the blocks an SM as parameters.
// Every instance forms the values with csrc/insert_mkb.cu's first pass.
#include "../../csrc/insert_mkb.cu"

namespace {

// the weight's form: the series (the path's), the blob's closed form
// (sqrt, division, I0), or 1 inside the ball
enum WeightForm : int { SERIES = 0, CLOSED = 1, ONE = 2 };

struct Closed {
  float alpha, inv_i0;  // the closed form's alpha and 1 / I0(alpha)
};

template <int WF>
__device__ __forceinline__ float weight(const MkbArgs& S, const Closed& K, float d2) {
  if (WF == ONE) return 1.f;
  if (WF == CLOSED) {
    const float u = __fdiv_rn(sqrtf(fmaxf(d2, 0.f)), S.a);
    const float u2 = __fmul_rn(u, u);
    if (u2 > 1.f) return 0.f;
    return cyl_bessel_i0f(__fmul_rn(K.alpha, sqrtf(fmaxf(0.f, __fsub_rn(1.f, u2))))) *
           K.inv_i0;
  }
  return mkb_weight(S, d2);
}

}  // namespace

namespace gather {

constexpr int BRICK = 8;                        // cells a brick edge
constexpr int THREADS = BRICK * BRICK * BRICK;  // a thread a cell
constexpr int CAP = 1536;                       // planes a block lists at once
constexpr unsigned FULL = 0xffffffffu;
constexpr float MARGIN = 1e-2f;                 // reach and prefilter a + MARGIN

// the gather's cell: the planes whose normal passes within a + MARGIN of
// it, each plane's candidates (vc, vr) within that reach of (Q^T k)_xy /
// pf, and the taps of those whose position lands on the cell
template <int MAXC, int WF>
__device__ __forceinline__ bool plane_into_cell(const MkbArgs& S, const Closed& K, const float* q,
                                                const float* r6, int s, int vx, int vy, int vz,
                                                int cb, float& re, float& im, float& t) {
  const float reach = S.a + MARGIN, strip = reach;
  const float fx = (float)(vx - cb), fy = (float)(vy - cb), fz = (float)(vz - cb);
  const float az = q[2] * fx + q[5] * fy + q[8] * fz;
  if (fabsf(az) >= reach) return false;
  const float ax = q[0] * fx + q[3] * fy + q[6] * fz;
  const float ay = q[1] * fx + q[4] * fy + q[7] * fz;
  const int rr = S.r_u - 1, nk = 2 * S.r_u - 1, pf = S.pf;
  const float inv_pf = 1.f / (float)pf;
  const int c0 = (int)ceilf((ax - reach) * inv_pf);
  const int r0 = (int)ceilf((ay - reach) * inv_pf);
  const float mrp2 = S.mrp * S.mrp;
  const float gx0 = (float)(c0 * pf), gy0 = (float)(r0 * pf), fpf = (float)pf;
  float e0[3], ec[3], er[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ka = a == 0 ? fx : (a == 1 ? fy : fz);
    e0[a] = q[3 * a] * gx0 + q[3 * a + 1] * gy0 - ka;
    ec[a] = q[3 * a] * fpf;
    er[a] = q[3 * a + 1] * fpf;
  }
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
      ok = ok && vc * vc + vr * vr <= rr * rr;
      if (ok) slots |= 1u << (j * MAXC + i);
    }
  }
  bool hit = false;
  while (slots) {
    const int b = __ffs(slots) - 1;
    slots &= slots - 1;
    const int vc = c0 + b % MAXC, vr = r0 + b / MAXC;
    const float4 v = __ldg(S.vals + (long long)s * nk * nk + (vr + rr) * nk + (vc + rr));
    const float gx = (float)(vc * pf), gy = (float)(vr * pf);
    const float px = __fadd_rn(__fmul_rn(r6[0], gx), __fmul_rn(r6[1], gy));
    const float py = __fadd_rn(__fmul_rn(r6[2], gx), __fmul_rn(r6[3], gy));
    const float pz = __fadd_rn(__fmul_rn(r6[4], gx), __fmul_rn(r6[5], gy));
    const bool in = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                              __fmul_rn(pz, pz)) < mrp2;
    // one of the sample's 4^3 taps, within the ball
    const int tx = (int)floorf(px) + cb, ty = (int)floorf(py) + cb, tz = (int)floorf(pz) + cb;
    bool ok = in && vx >= tx - 1 && vx <= tx + 2 && vy >= ty - 1 && vy <= ty + 2 &&
              vz >= tz - 1 && vz <= tz + 2;
    const float dx = (float)(vx - cb) - px, dy = (float)(vy - cb) - py, dz = (float)(vz - cb) - pz;
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    ok = ok && d2 < S.a2;
    const float w = ok ? weight<WF>(S, K, d2) : 0.f;
    re += v.x * w;
    im += v.y * w;
    t += v.z * w;
    hit = hit || ok;
  }
  return hit;
}

template <int MAXC, int WF, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) gather_kernel(MkbArgs S, Closed K, MkbGrid G) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                               // 9 x CAP: Q = R, row-major
  float* sR = sQ + 9 * CAP;                       // 6 x CAP: R's first two columns
  int* sS = reinterpret_cast<int*>(sR + 6 * CAP);  // CAP: slice
  __shared__ int warp_n[THREADS / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int big = G.big, cb = big / 2;
  const int nbx = (big + BRICK - 1) / BRICK;
  const int bx = blockIdx.x % nbx, by = (blockIdx.x / nbx) % nbx, bz = blockIdx.x / (nbx * nbx);
  const int x0 = bx * BRICK, y0 = by * BRICK, z0 = bz * BRICK;
  const int x1 = min(x0 + BRICK, big) - 1, y1 = min(y0 + BRICK, big) - 1;
  const int z1 = min(z0 + BRICK, big) - 1;
  const float reach = S.a + MARGIN;
  const float lim_r = S.mrp + reach;
  {
    auto near = [&](int a, int b) { return (float)(a > cb ? a - cb : (b < cb ? cb - b : 0)); };
    float nx = near(x0, x1), ny = near(y0, y1), nz = near(z0, z1);
    if (nx * nx + ny * ny + nz * nz >= lim_r * lim_r) return;
  }
  auto vlo_of = [&](int i) { return i == 0 ? min(G.vlo, 0) : i; };
  auto vhi_of = [&](int i) { return i == big - 1 ? max(G.vhi, big - 1) : i; };
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
    int count = 0;
    while (base < n_planes && count + THREADS <= CAP) {
      long long i = base + tid;
      bool pass = false;
      const int s = (int)i;
      if (i < n_planes && S.wsl[s] != 0.f) {
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
      __syncthreads();
    }
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
        if (!faces) {
          hit |= plane_into_cell<MAXC, WF>(S, K, q, r6, s, ix, iy, iz, cb, acc_re, acc_im, acc_t);
        } else {
          for (int vz = vz0; vz <= vz1; ++vz)
            for (int vy = vy0; vy <= vy1; ++vy)
              for (int vx = vx0; vx <= vx1; ++vx)
                hit |= plane_into_cell<MAXC, WF>(S, K, q, r6, s, vx, vy, vz, cb, acc_re, acc_im,
                                                 acc_t);
        }
      }
    }
    __syncthreads();
  }
  if (active && hit) {
    long long cell = ((long long)iz * big + iy) * big + ix;
    float2 f = G.F[cell];
    G.F[cell] = make_float2(f.x + acc_re, f.y + acc_im);
    G.T[cell] += acc_t;
  }
}

constexpr size_t SMEM = (size_t)(16 * CAP) * sizeof(float);

template <int WF, int MIN_BLOCKS>
const void* gather_instance(const MkbArgs& S) {
  const int maxc = max(2, (int)(2.f * (S.a + MARGIN) / (float)S.pf) + 1);
  switch (maxc) {
    case 2: return (const void*)gather_kernel<2, WF, MIN_BLOCKS>;
    case 3: return (const void*)gather_kernel<3, WF, MIN_BLOCKS>;
    case 4: return (const void*)gather_kernel<4, WF, MIN_BLOCKS>;
    case 5: return (const void*)gather_kernel<5, WF, MIN_BLOCKS>;
    default: return nullptr;
  }
}

template <int WF, int MIN_BLOCKS>
int launch(const MkbArgs& S, const Closed& K, const MkbGrid& G, cudaStream_t st) {
  const void* k = gather_instance<WF, MIN_BLOCKS>(S);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long nbx = (G.big + BRICK - 1) / BRICK;
  void* args[] = {(void*)&S, (void*)&K, (void*)&G};
  return (int)cudaLaunchKernel(k, dim3((unsigned)(nbx * nbx * nbx)), dim3(THREADS), args, SMEM,
                               st);
}

}  // namespace gather

namespace scatter {

// csrc/insert_mkb.cu's queue_round, queue_plane and mkb_brick_kernel with
// the weight's form WF, the brick's depth BZ and the blocks an SM MINB as
// parameters (the comments there)
template <int WF, int BZ>
__device__ __forceinline__ void queue_round(const MkbArgs& S, const Closed& K,
                                            const MkbGrid& G, float* acc, const float* sP,
                                            const int* sS, const int2* q,
                                            int head, int n, const int* blo, const int* bhi,
                                            int bx0, int by0, int bz0, int lane) {
  constexpr int BX = MKB_BXY, BY = MKB_BXY, CELLS = BX * BY * BZ;
  const int big = G.big, cb = big / 2, pf = S.pf, rr = S.r_u - 1, nk = 2 * S.r_u - 1;
  const float mrp2 = S.mrp * S.mrp;
  float px = 0.f, py = 0.f, pz = 0.f;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  unsigned m_lo = 0u, m_hi = 0u;
  if (lane < n) {
    const int2 qe = q[(head + lane) & (MKB_QUEUE - 1)];
    const int e = qe.x, pix = qe.y, row = pix / nk;
    const int vc = pix - row * nk - rr, vr = row - rr;
    const float gx = (float)(vc * pf), gy = (float)(vr * pf);
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
      const int n_lo = __popc(lo);
      const int j = rank < n_lo ? nth_bit(lo, rank) : 32 + nth_bit(hi, rank - n_lo);
      const int dx = j & 3, dy = (j >> 2) & 3, dz = j >> 4;
      const float d2 = __fadd_rn(__fadd_rn(tap_sq(t0x, dx, cb, sx), tap_sq(t0y, dy, cb, sy)),
                                 tap_sq(t0z, dz, cb, sz));
      w = weight<WF>(S, K, d2);
      const int ix = min(max(t0x + dx, 0), big - 1) - bx0;
      const int iy = min(max(t0y + dy, 0), big - 1) - by0;
      const int iz = min(max(t0z + dz, 0), big - 1) - bz0;
      cell = (iz * BY + iy) * BX + ix;
    }
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

template <int WF, int BZ>
__device__ __forceinline__ void queue_plane(const MkbArgs& S, const Closed& K,
                                            const MkbGrid& G, float* acc, const float* sP,
                                            const int* sS, int2* q, int& head,
                                            int& tail, int e, const float* elo, const float* ehi,
                                            const int* blo, const int* bhi, int bx0, int by0,
                                            int bz0, int lane) {
  const int pf = S.pf, rr = S.r_u - 1, nk = 2 * S.r_u - 1;
  const float fpf = (float)pf;
  const float c0[3] = {sP[e], sP[MKB_CAP + e], sP[2 * MKB_CAP + e]};
  const float c1[3] = {sP[3 * MKB_CAP + e], sP[4 * MKB_CAP + e], sP[5 * MKB_CAP + e]};
  float mid = 0.f, half = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    mid += c1[i] * 0.5f * (elo[i] + ehi[i]);
    half += fabsf(c1[i]) * 0.5f * (ehi[i] - elo[i]);
  }
  const int vr_lo = max(-rr, (int)ceilf((mid - half) / fpf));
  const int vr_hi = min(rr, (int)floorf((mid + half) / fpf));
  for (int row0 = vr_lo; row0 <= vr_hi; row0 += 32) {
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
        queue_round<WF, BZ>(S, K, G, acc, sP, sS, q, head, 32, blo, bhi, bx0, by0, bz0,
                            lane);
        head += 32;
        __syncwarp();
      }
    }
  }
}

template <int WF, int BZ, int MINB>
__global__ void __launch_bounds__(MKB_THREADS, MINB)
    brick_kernel(MkbArgs S, Closed K, MkbGrid G) {
  constexpr int BX = MKB_BXY, BY = MKB_BXY, CELLS = BX * BY * BZ;
  extern __shared__ __align__(16) float smem[];
  float* sums = smem;
  float* sP = sums + MKB_WARPS * 3 * CELLS;
  int* sS = reinterpret_cast<int*>(sP + 9 * MKB_CAP);
  int2* sQ = reinterpret_cast<int2*>(sS + MKB_CAP);
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
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int r = 0; r < 3; ++r) sP[(3 * c + r) * MKB_CAP + at] = R[3 * r + c];
        sS[at] = s;
      }
      count += total;
      base += MKB_THREADS;
      __syncthreads();
    }
    int head = 0, tail = 0;
    const int e_end = count * (warp + 1) / MKB_WARPS;
    for (int e = count * warp / MKB_WARPS; e < e_end; ++e)
      queue_plane<WF, BZ>(S, K, G, acc, sP, sS, q, head, tail, e, elo, ehi, blo, bhi, x0,
                          y0, z0, lane);
    if (tail > head)
      queue_round<WF, BZ>(S, K, G, acc, sP, sS, q, head, tail - head, blo, bhi, x0, y0, z0,
                          lane);
    __syncthreads();
  }
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

template <int WF, int BZ, int MINB>
int launch(const MkbArgs& S, const Closed& K, const MkbGrid& G, int n_bricks, cudaStream_t st) {
  auto kernel = brick_kernel<WF, BZ, MINB>;
  const size_t smem =
      (size_t)(MKB_WARPS * 3 * MKB_BXY * MKB_BXY * BZ + 10 * MKB_CAP + 2 * MKB_WARPS * MKB_QUEUE) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (n_bricks > 0) kernel<<<(unsigned)n_bricks, MKB_THREADS, smem, st>>>(S, K, G);
  return (int)cudaGetLastError();
}

}  // namespace scatter

namespace {

const void* instance(int variant, const MkbArgs& S) {
  switch (variant) {
    case 0: return gather::gather_instance<CLOSED, 2>(S);
    case 1: return gather::gather_instance<ONE, 2>(S);
    case 2: return gather::gather_instance<CLOSED, 1>(S);
    case 3: return gather::gather_instance<SERIES, 2>(S);
    case 4: return (const void*)mkb_brick_kernel;
    case 5: return (const void*)scatter::brick_kernel<CLOSED, 8, MKB_MIN_BLOCKS>;
    case 6: return (const void*)scatter::brick_kernel<SERIES, 4, MKB_MIN_BLOCKS>;
    case 7: return (const void*)scatter::brick_kernel<ONE, 8, MKB_MIN_BLOCKS>;
    case 8: return (const void*)scatter::brick_kernel<SERIES, 8, 2>;
    default: return nullptr;
  }
}

}  // namespace

// Instance ``variant`` of HK10 with thunder_insert_mkb's arguments (the
// gathers read no order), then alpha and 1 / I0(alpha) (the closed
// form's).
extern "C" int cand_insert_mkb(
    int variant, const void* ft, int size, const void* ctfk, const void* img_idx, const void* rot,
    const void* trans, const void* w, const void* dfac, int n_slices, int r_u, int pf,
    float max_radius_pad, float box_a, float tpos, void* F, void* T, void* vals, int big,
    int vlo, int vhi, const void* order, int n_bricks, float mkb_a, float mkb_a2,
    float mkb_inv_a2, const void* coef, float alpha, float inv_i0, void* stream) {
  if (n_slices <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const SliceValues V{(const float2*)ft, (const float*)ctfk, (const int*)img_idx,
                      (const float*)trans, (const float*)dfac, (const float*)w, size, box_a,
                      tpos};
  const MkbArgs S = mkb_values(V, (const float*)rot, n_slices, r_u, pf, max_radius_pad,
                               (float*)vals, mkb_a, mkb_a2, mkb_inv_a2, (const float*)coef, st);
  const Closed K{alpha, inv_i0};
  const MkbGrid G{(float2*)F, (float*)T, big, vlo, vhi, (const int*)order};
  switch (variant) {
    case 0: return gather::launch<CLOSED, 2>(S, K, G, st);
    case 1: return gather::launch<ONE, 2>(S, K, G, st);
    case 2: return gather::launch<CLOSED, 1>(S, K, G, st);
    case 3: return gather::launch<SERIES, 2>(S, K, G, st);
    case 4: return launch_mkb(S, G, n_bricks, st);
    case 5: return scatter::launch<CLOSED, 8, MKB_MIN_BLOCKS>(S, K, G, n_bricks, st);
    case 6: return scatter::launch<SERIES, 4, MKB_MIN_BLOCKS>(S, K, G, n_bricks, st);
    case 7: return scatter::launch<ONE, 8, MKB_MIN_BLOCKS>(S, K, G, n_bricks, st);
    case 8: return scatter::launch<SERIES, 8, 2>(S, K, G, n_bricks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Registers and local bytes a thread of instance ``variant`` takes at the
// given pf and a (the gather's instance depends on its candidate count):
// out[0] numRegs, out[1] localSizeBytes.
extern "C" int cand_mkb_attrs(int variant, int pf, float mkb_a, void* out) {
  MkbArgs S{};
  S.pf = pf;
  S.a = mkb_a;
  const void* k = instance(variant, S);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e != cudaSuccess) return (int)e;
  ((int*)out)[0] = fa.numRegs;
  ((int*)out)[1] = (int)fa.localSizeBytes;
  return 0;
}
