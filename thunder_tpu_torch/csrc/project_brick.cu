// HK13 project_brick: slice projection through brick windows, for the
// concentrated rotation clouds of local and CTF rounds.
//
// Replaces (thunder_tpu): ops/brick.py project_classed_brick (the
// phase loop's projection when Optimiser._table_plan engages a brick
// rung), computed from the port's centered float32 cube, or HK1's quad
// table of it, instead of a brick-packed table.
//
// out[l, r, p]: the mean rotation mrot[l] puts pixel p at the mean
// point m = mrot[l] . (pf i_col[p], pf i_row[p], 0); sgn = -1 where m.x
// < 0 folds it into kx >= 0; each axis' anchor is
// rint((sgn m + lo - (span - 1) / 2) / stride) clipped to [0, n_a - 1]
// (lo = c, n_a = nz for z and y; lo = g, n_a = nx for x; c = n / 2 of
// the cube's own size n).  A sample v = rot[l, r] . (...) has window
// offsets sgn v - (anchor stride - lo); if any leaves [0, span - 1] its
// value is 0, else the trilinear value of the window's cells (a cell
// past the cube reads 0), returned as (re, sgn im).  Coordinates and
// anchors are formed without FMA contraction, as the plain version
// (ops/brick.py project_brick_plain) forms them, and the taps blend in
// its order: for each x tap, the four (z, y) taps weighted wz wy, then
// wx.
//
// What bounds it on Hopper: by its bytes (each input read once, the
// output written once) the output; in practice the 32-byte sectors its
// taps pull from L2, as for HK1.  Design:
// * Taps.  From the quad table a sample reads, of each of its two z
//   planes, the quad of its window cell (y0, x0): one 32-byte sector
//   holding the (y0, y1) x (x0, x1) taps (HK1's taps_quad, with its rule
//   for cells below the cube).  Taps the window zeroes (past the cube,
//   past the window's last cell) are read as the quad's clipped
//   neighbours and weighted 0, as the plain version reads them.  From
//   the plain cube (tables past QUAD_TABLE_MAX_BYTES) a sample reads the
//   x pair of each of its four (z, y) rows (HK1's taps_plain).  A sample
//   outside its window reads nothing.
// * Threads.  A block is TILE pixels (a lane each) of one image times
//   SPLIT warps; the warps share the image's R rotations (warp w takes
//   r = w, w + SPLIT, ...).  The mean point, fold and anchors are formed
//   once a thread; a warp writes 32 neighbouring pixels of one rotation
//   (coalesced, HK1's (L, R, P) layout); the block's samples are one
//   image's cloud, so its windows' sectors repeat in the SM's L1.
//   Measured in turns on an NVIDIA H100 80GB HBM3 at 700 W
//   (micro/hk_candidates.py --kernels hk13, the 160 px local rounds'
//   L=256 R=125 P=488 from a 2 x 76^3 quad table): the
//   first design's loads were ~0.5 of its ~0.7 ms; quads with its walk
//   (a thread an (image, pixel), 128 pixels a block) ~0.21 ms; four
//   warps sharing the rotations ~0.15-0.17 ms, 0.69-0.76 of HK1 on the
//   same samples; two samples a thread in flight, a thread a sample, or
//   the windows staged in shared memory were slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;    // pixels a block, one a lane
constexpr int SPLIT = 4;    // warps sharing an image's rotations

// the window's weight of cells j0 and j0 + 1 for offset off (zero past
// the window), thunder_tpu's _axis_hat: max(0, 1 - |off - j|)
struct Axis {
  int i0;        // cube index of cell j0
  float w0, w1;  // weights of cells j0 and j0 + 1, 0 past the cube or window
};

__device__ __forceinline__ bool axis(float off, int span, int first, int n, Axis& a) {
  if (!(off >= 0.f && off <= (float)(span - 1))) return false;
  float j0 = floorf(off);
  int j = (int)j0;
  int i = first + j;
  float w0 = fmaxf(0.f, 1.f - fabsf(__fsub_rn(off, j0)));
  float w1 = j + 1 <= span - 1 ? fmaxf(0.f, 1.f - fabsf(__fsub_rn(off, j0 + 1.f))) : 0.f;
  a.i0 = i;
  a.w0 = (i >= 0 && i < n) ? w0 : 0.f;
  a.w1 = (i + 1 >= 0 && i + 1 < n) ? w1 : 0.f;
  return true;
}

// rint((v + lo - half) / stride) clipped to [0, n_a - 1]
__device__ __forceinline__ int anchor(float v, int lo, float half, int stride, int n_a) {
  float q = __fdiv_rn(__fsub_rn(__fadd_rn(v, (float)lo), half), (float)stride);
  return min(max((int)rintf(q), 0), n_a - 1);
}

// what a thread keeps of its (image, pixel) for all its samples
struct Frame {
  float fx, fy, sgn;
  float oz, oy, ox;               // window origins, centered
  int first_z, first_y, first_x;  // the cube's index of each window's cell 0
};

struct Sample {
  bool ok;      // inside its window on every axis
  Axis z, y, x;
};

__device__ __forceinline__ Sample locate(const float* R, const Frame& f, int span, int n) {
  float x = __fadd_rn(__fmul_rn(__ldg(R + 0), f.fx), __fmul_rn(__ldg(R + 1), f.fy));
  float y = __fadd_rn(__fmul_rn(__ldg(R + 3), f.fx), __fmul_rn(__ldg(R + 4), f.fy));
  float z = __fadd_rn(__fmul_rn(__ldg(R + 6), f.fx), __fmul_rn(__ldg(R + 7), f.fy));
  Sample s;
  s.ok = axis(__fsub_rn(z * f.sgn, f.oz), span, f.first_z, n, s.z) &&
         axis(__fsub_rn(y * f.sgn, f.oy), span, f.first_y, n, s.y) &&
         axis(__fsub_rn(x * f.sgn, f.ox), span, f.first_x, n, s.x);
  return s;
}

// a sample's taps, row k = (z0, y0), (z0, y1), (z1, y0), (z1, y1) as
// float4 (t[x0], t[x1]); indices clipped to the cube
struct Taps {
  float4 row[4];
};

template <bool QUAD>
__device__ __forceinline__ void fetch(const float2* vol, int n, const Sample& s, Taps& t) {
  int ix = s.x.i0, iy = s.y.i0;
  int y0 = min(max(iy, 0), n - 1), x0 = min(max(ix, 0), n - 1);
  int z0 = min(max(s.z.i0, 0), n - 1), z1 = min(max(s.z.i0 + 1, 0), n - 1);
  if constexpr (QUAD) {
    // cell (z, y, x) holds t[y][x], t[y][x+], t[y+][x], t[y+][x+]
    const float4* q = (const float4*)vol;
    long long c0 = 2 * (((long long)z0 * n + y0) * n + x0);
    long long c1 = 2 * (((long long)z1 * n + y0) * n + x0);
    t.row[0] = __ldg(q + c0);
    t.row[1] = __ldg(q + c0 + 1);
    t.row[2] = __ldg(q + c1);
    t.row[3] = __ldg(q + c1 + 1);
    // below the cube both taps of that axis are the first cell's
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (iy < 0 && (k & 1)) t.row[k] = t.row[k - 1];
      if (ix < 0) t.row[k] = make_float4(t.row[k].x, t.row[k].y, t.row[k].x, t.row[k].y);
    }
  } else {
    int y1 = min(max(iy + 1, 0), n - 1), x1 = min(max(ix + 1, 0), n - 1);
    int rows[4] = {(z0 * n + y0) * n, (z0 * n + y1) * n, (z1 * n + y0) * n,
                   (z1 * n + y1) * n};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 a = __ldg(vol + rows[k] + x0), b = __ldg(vol + rows[k] + x1);
      t.row[k] = make_float4(a.x, a.y, b.x, b.y);
    }
  }
}

// the plain version's order: for each x tap the four (z, y) taps
// weighted wz wy, summed, times wx
__device__ __forceinline__ float2 blend(const Taps& t, const Sample& s, float sgn) {
  float wzy[4] = {__fmul_rn(s.z.w0, s.y.w0), __fmul_rn(s.z.w0, s.y.w1),
                  __fmul_rn(s.z.w1, s.y.w0), __fmul_rn(s.z.w1, s.y.w1)};
  float re = 0.f, im = 0.f;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    float tr = 0.f, ti = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float vr = dx ? t.row[k].z : t.row[k].x, vi = dx ? t.row[k].w : t.row[k].y;
      tr = __fadd_rn(tr, __fmul_rn(vr, wzy[k]));
      ti = __fadd_rn(ti, __fmul_rn(vi, wzy[k]));
    }
    float wx = dx ? s.x.w1 : s.x.w0;
    re = __fadd_rn(re, __fmul_rn(tr, wx));
    im = __fadd_rn(im, __fmul_rn(ti, wx));
  }
  return make_float2(re, im * sgn);
}

template <bool QUAD>
__global__ void __launch_bounds__(TILE * SPLIT) project_brick_kernel(
    const float2* __restrict__ table, int n, const int* __restrict__ cls,
    const float* __restrict__ rot, const float* __restrict__ mrot, int n_rot,
    const int* __restrict__ i_col, const int* __restrict__ i_row, int n_pix, int pf,
    int span, int stride, int g, int nz, int nx, float2* __restrict__ out) {
  int tiles = (n_pix + TILE - 1) / TILE;
  int l = blockIdx.x / tiles;
  int p = (blockIdx.x % tiles) * TILE + threadIdx.x;
  if (p >= n_pix) return;
  int c = n / 2;
  Frame f;
  f.fx = (float)(i_col[p] * pf);
  f.fy = (float)(i_row[p] * pf);
  const float* M = mrot + (long long)l * 9;
  float mx = __fadd_rn(__fmul_rn(__ldg(M + 0), f.fx), __fmul_rn(__ldg(M + 1), f.fy));
  float my = __fadd_rn(__fmul_rn(__ldg(M + 3), f.fx), __fmul_rn(__ldg(M + 4), f.fy));
  float mz = __fadd_rn(__fmul_rn(__ldg(M + 6), f.fx), __fmul_rn(__ldg(M + 7), f.fy));
  f.sgn = mx < 0.f ? -1.f : 1.f;
  float half = 0.5f * (float)(span - 1);
  int az = anchor(mz * f.sgn, c, half, stride, nz);
  int ay = anchor(my * f.sgn, c, half, stride, nz);
  int ax = anchor(mx * f.sgn, g, half, stride, nx);
  f.oz = (float)(az * stride - c);
  f.oy = (float)(ay * stride - c);
  f.ox = (float)(ax * stride - g);
  f.first_z = az * stride;
  f.first_y = ay * stride;
  f.first_x = ax * stride + c - g;
  const float2* vol = table + (long long)(cls ? cls[l] : 0) * n * n * n * (QUAD ? 4 : 1);
  const float* R = rot + (long long)l * n_rot * 9;
  float2* o = out + (long long)l * n_rot * n_pix + p;
  for (int r = threadIdx.y; r < n_rot; r += SPLIT) {
    Sample s = locate(R + (long long)r * 9, f, span, n);
    float2 v = make_float2(0.f, 0.f);
    if (s.ok) {
      Taps t;
      fetch<QUAD>(vol, n, s, t);
      v = blend(t, s, f.sgn);
    }
    o[(long long)r * n_pix] = v;
  }
}

}  // namespace

// table: (K, n, n, n) complex64 (cell 1) or HK1's quad table (K, n, n,
// n, 8) float32 (cell 4: a cell's own tap is its first float2)
extern "C" int thunder_project_brick(
    const void* table, int cell, int n, const void* cls, const void* rot, const void* mrot,
    int n_img, int n_rot, const void* i_col, const void* i_row, int n_pix, int pf, int span,
    int stride, int g, int nz, int nx, void* out, void* stream) {
  if ((long long)n_img * n_rot * n_pix > 0) {
    unsigned blocks = (unsigned)((long long)n_img * ((n_pix + TILE - 1) / TILE));
    auto kernel = cell == 4 ? project_brick_kernel<true> : project_brick_kernel<false>;
    kernel<<<blocks, dim3(TILE, SPLIT), 0, (cudaStream_t)stream>>>(
        (const float2*)table, n, (const int*)cls, (const float*)rot, (const float*)mrot, n_rot,
        (const int*)i_col, (const int*)i_row, n_pix, pf, span, stride, g, nz, nx,
        (float2*)out);
  }
  return (int)cudaGetLastError();
}
