// Candidate designs of HK13 project_brick, timed by
// micro/hk_candidates.py (--kernels hk13) and chip_smoke.py's phase 5d
// before csrc/project_brick.cu was chosen.  Not part of the kernel
// library.  Every variant computes ops/brick.py project_brick_plain
// (the load-free ones excepted) from the quad table (cell 4) or the
// plain cube (cell 1), as the variant says.
//
//   variant 0: the first design: a thread an (image, pixel)
//              walks the R rotations, 128 pixels a block, one 8-byte
//              tap a cell, a tap skipped where its weight is 0
//   variant 1: variant 0 with no load: each tap's value is formed from
//              its index (the walk, the windows and the writes alone)
//   variant 2: quads (two 32-byte sectors a sample), variant 0's walk
//   variant 3: variant 2, two samples a thread in flight
//   variant 4: quads, 32 pixels x 4 warps sharing the rotations (the
//              shipped design, csrc/project_brick.cu)
//   variant 5: variant 4, two samples a thread in flight
//   variant 6: quads, 32 pixels x 8 warps
//   variant 7: quads, 32 pixels x 2 warps, two samples in flight
//   variant 8: variant 4 with no load (as variant 1)
//   variant 9: variant 4 reading the plain cube (rows' x pairs)
//   variant 10: quads, one thread a sample (HK1's thread map), the mean
//              point and anchors formed a sample
//   variant 11: shared memory: a block stages each of its pixels'
//              span^3 windows from the plain cube (8-byte cp.async,
//              zeros past the cube), then interpolates all R rotations
//              from there; 32 / 16 / 8 pixels a block for span <= 5 /
//              6-7 / 8

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Axis {
  int i0;
  float w0, w1;
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

__device__ __forceinline__ int anchor(float v, int lo, float half, int stride, int n_a) {
  float q = __fdiv_rn(__fsub_rn(__fadd_rn(v, (float)lo), half), (float)stride);
  return min(max((int)rintf(q), 0), n_a - 1);
}

struct Frame {
  float fx, fy, sgn;
  float oz, oy, ox;
  int first_z, first_y, first_x;
};

__device__ __forceinline__ Frame frame(const float* mrot, int l, const int* i_col,
                                       const int* i_row, int p, int pf, int n, int span,
                                       int stride, int g, int nz, int nx) {
  Frame f;
  int c = n / 2;
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
  return f;
}

struct Sample {
  bool ok;
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

struct Taps {
  float4 row[4];
};

template <bool QUAD, bool LOADS>
__device__ __forceinline__ void fetch(const float2* vol, int n, const Sample& s, Taps& t) {
  int ix = s.x.i0, iy = s.y.i0;
  int y0 = min(max(iy, 0), n - 1), x0 = min(max(ix, 0), n - 1);
  int z0 = min(max(s.z.i0, 0), n - 1), z1 = min(max(s.z.i0 + 1, 0), n - 1);
  if constexpr (!LOADS) {
    float a = (float)(((z0 * n + y0) * n + x0) & 1023), b = (float)(z1 & 7);
    t.row[0] = make_float4(a, b, a, b);
    t.row[1] = make_float4(b, a, b, a);
    t.row[2] = make_float4(a, a, b, b);
    t.row[3] = make_float4(b, b, a, a);
  } else if constexpr (QUAD) {
    const float4* q = (const float4*)vol;
    long long c0 = 2 * (((long long)z0 * n + y0) * n + x0);
    long long c1 = 2 * (((long long)z1 * n + y0) * n + x0);
    t.row[0] = __ldg(q + c0);
    t.row[1] = __ldg(q + c0 + 1);
    t.row[2] = __ldg(q + c1);
    t.row[3] = __ldg(q + c1 + 1);
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

struct Args {
  const float2* table;
  int cell, n;
  const int* cls;
  const float* rot;
  const float* mrot;
  int n_rot;
  const int* i_col;
  const int* i_row;
  int n_pix, pf, span, stride, g, nz, nx;
  float2* out;
};

// variants 0 and 1: the first design, one tap a cell
template <bool LOADS>
__device__ __forceinline__ float2 tap(const float2* vol, int cell, int n, int z, int y, int x,
                                      float w) {
  if (w == 0.f) return make_float2(0.f, 0.f);
  int idx = cell * ((z * n + y) * n + x);
  float2 v = LOADS ? __ldg(vol + idx) : make_float2((float)(idx & 1023), (float)(z & 7));
  return make_float2(__fmul_rn(v.x, w), __fmul_rn(v.y, w));
}

template <bool LOADS>
__global__ void first_kernel(Args a) {
  int per_img = (a.n_pix + blockDim.x - 1) / blockDim.x;
  int l = blockIdx.x / per_img;
  int p = (blockIdx.x % per_img) * blockDim.x + threadIdx.x;
  if (p >= a.n_pix) return;
  Frame f = frame(a.mrot, l, a.i_col, a.i_row, p, a.pf, a.n, a.span, a.stride, a.g, a.nz,
                  a.nx);
  int n = a.n;
  const float2* vol = a.table + (long long)(a.cls ? a.cls[l] : 0) * n * n * n * a.cell;
  const float* R = a.rot + (long long)l * a.n_rot * 9;
  float2* o = a.out + (long long)l * a.n_rot * a.n_pix + p;
  for (int r = 0; r < a.n_rot; ++r, R += 9, o += a.n_pix) {
    Sample s = locate(R, f, a.span, n);
    if (!s.ok) {
      *o = make_float2(0.f, 0.f);
      continue;
    }
    float wzy[4] = {__fmul_rn(s.z.w0, s.y.w0), __fmul_rn(s.z.w0, s.y.w1),
                    __fmul_rn(s.z.w1, s.y.w0), __fmul_rn(s.z.w1, s.y.w1)};
    int zs[4] = {s.z.i0, s.z.i0, s.z.i0 + 1, s.z.i0 + 1};
    int ys[4] = {s.y.i0, s.y.i0 + 1, s.y.i0, s.y.i0 + 1};
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      float wx = dx ? s.x.w1 : s.x.w0;
      if (wx == 0.f) continue;
      float tr = 0.f, ti = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float2 v = tap<LOADS>(vol, a.cell, n, zs[q], ys[q], s.x.i0 + dx, wzy[q]);
        tr = __fadd_rn(tr, v.x);
        ti = __fadd_rn(ti, v.y);
      }
      re = __fadd_rn(re, __fmul_rn(tr, wx));
      im = __fadd_rn(im, __fmul_rn(ti, wx));
    }
    *o = make_float2(re, im * f.sgn);
  }
}

// variants 2-9: TILE pixels x SPLIT warps a block sharing the rotations,
// UNROLL samples a thread in flight
template <bool QUAD, int TILE, int SPLIT, int UNROLL, bool LOADS>
__global__ void __launch_bounds__(TILE * SPLIT) walk_kernel(Args a) {
  int tiles = (a.n_pix + TILE - 1) / TILE;
  int l = blockIdx.x / tiles;
  int p = (blockIdx.x % tiles) * TILE + threadIdx.x;
  if (p >= a.n_pix) return;
  int n = a.n;
  Frame f = frame(a.mrot, l, a.i_col, a.i_row, p, a.pf, n, a.span, a.stride, a.g, a.nz, a.nx);
  const float2* vol = a.table + (long long)(a.cls ? a.cls[l] : 0) * n * n * n * (QUAD ? 4 : 1);
  const float* R = a.rot + (long long)l * a.n_rot * 9;
  float2* o = a.out + (long long)l * a.n_rot * a.n_pix + p;
  for (int r = threadIdx.y; r < a.n_rot; r += SPLIT * UNROLL) {
    Sample s[UNROLL];
    Taps t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      int ru = r + u * SPLIT;
      s[u].ok = false;
      if (ru < a.n_rot) s[u] = locate(R + (long long)ru * 9, f, a.span, n);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (s[u].ok) fetch<QUAD, LOADS>(vol, n, s[u], t[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      int ru = r + u * SPLIT;
      if (ru < a.n_rot)
        o[(long long)ru * a.n_pix] = s[u].ok ? blend(t[u], s[u], f.sgn) : make_float2(0.f, 0.f);
    }
  }
}

// variant 10: one thread a sample
__global__ void flat_kernel(Args a, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int p = (int)(idx % a.n_pix);
  long long lr = idx / a.n_pix;
  int r = (int)(lr % a.n_rot);
  int l = (int)(lr / a.n_rot);
  int n = a.n;
  Frame f = frame(a.mrot, l, a.i_col, a.i_row, p, a.pf, n, a.span, a.stride, a.g, a.nz, a.nx);
  const float2* vol = a.table + (long long)(a.cls ? a.cls[l] : 0) * n * n * n * 4;
  Sample s = locate(a.rot + lr * 9, f, a.span, n);
  float2 v = make_float2(0.f, 0.f);
  if (s.ok) {
    Taps t;
    fetch<true, true>(vol, n, s, t);
    v = blend(t, s, f.sgn);
  }
  a.out[idx] = v;
}

// variant 11: each pixel's window staged in shared memory
constexpr int SMEM_THREADS = 128;

__global__ void __launch_bounds__(SMEM_THREADS) smem_kernel(Args a, int tile) {
  extern __shared__ float2 win[];   // tile x span^3 cells, then the frames
  int span = a.span, n = a.n;
  int cells = span * span * span;
  Frame* frames = (Frame*)(win + (long long)tile * cells);
  int tiles = (a.n_pix + tile - 1) / tile;
  int l = blockIdx.x / tiles;
  int p0 = (blockIdx.x % tiles) * tile;
  int tid = threadIdx.x;
  if (tid < tile && p0 + tid < a.n_pix)
    frames[tid] = frame(a.mrot, l, a.i_col, a.i_row, p0 + tid, a.pf, n, span, a.stride, a.g,
                        a.nz, a.nx);
  __syncthreads();
  const float2* vol = a.table + (long long)(a.cls ? a.cls[l] : 0) * n * n * n * a.cell;
  for (int i = tid; i < tile * cells; i += SMEM_THREADS) {
    int j = i / cells, w = i % cells;
    if (p0 + j >= a.n_pix) continue;
    const Frame& f = frames[j];
    int z = f.first_z + w / (span * span), y = f.first_y + (w / span) % span,
        x = f.first_x + w % span;
    if (z >= 0 && z < n && y >= 0 && y < n && x >= 0 && x < n)
      __pipeline_memcpy_async(win + i, vol + (long long)a.cell * ((z * n + y) * n + x), 8);
    else
      win[i] = make_float2(0.f, 0.f);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const float* R0 = a.rot + (long long)l * a.n_rot * 9;
  float2* o = a.out + (long long)l * a.n_rot * a.n_pix + p0;
  for (int i = tid; i < tile * a.n_rot; i += SMEM_THREADS) {
    int j = i % tile, r = i / tile;
    if (p0 + j >= a.n_pix) continue;
    const Frame& f = frames[j];
    Sample s = locate(R0 + (long long)r * 9, f, span, n);
    float2 v = make_float2(0.f, 0.f);
    if (s.ok) {
      const float2* wj = win + (long long)j * cells;
      int jz = s.z.i0 - f.first_z, jy = s.y.i0 - f.first_y, jx = s.x.i0 - f.first_x;
      int jz1 = min(jz + 1, span - 1), jy1 = min(jy + 1, span - 1), jx1 = min(jx + 1, span - 1);
      int rows[4] = {(jz * span + jy) * span, (jz * span + jy1) * span,
                     (jz1 * span + jy) * span, (jz1 * span + jy1) * span};
      Taps t;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float2 x0 = wj[rows[k] + jx], x1 = wj[rows[k] + jx1];
        t.row[k] = make_float4(x0.x, x0.y, x1.x, x1.y);
      }
      v = blend(t, s, f.sgn);
    }
    o[(long long)r * a.n_pix + j] = v;
  }
}

template <bool QUAD, int TILE, int SPLIT, int UNROLL, bool LOADS>
int run_walk(const Args& a, int n_img, cudaStream_t st) {
  unsigned blocks = (unsigned)((long long)n_img * ((a.n_pix + TILE - 1) / TILE));
  walk_kernel<QUAD, TILE, SPLIT, UNROLL, LOADS><<<blocks, dim3(TILE, SPLIT), 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// the arguments of csrc/project_brick.cu's thunder_project_brick, after
// the variant; variants 2-8 and 10 take the quad table (cell 4), 9 and 11
// the plain cube (cell 1), 0 and 1 either
extern "C" int cand_project_brick(
    int variant, const void* table, int cell, int n, const void* cls, const void* rot,
    const void* mrot, int n_img, int n_rot, const void* i_col, const void* i_row, int n_pix,
    int pf, int span, int stride, int g, int nz, int nx, void* out, void* stream) {
  long long total = (long long)n_img * n_rot * n_pix;
  if (total <= 0) return (int)cudaGetLastError();
  bool quad_only = (variant >= 2 && variant <= 8) || variant == 10;
  if ((quad_only && cell != 4) || ((variant == 9 || variant == 11) && cell != 1))
    return (int)cudaErrorInvalidValue;
  Args a{(const float2*)table, cell, n, (const int*)cls, (const float*)rot, (const float*)mrot,
         n_rot, (const int*)i_col, (const int*)i_row, n_pix, pf, span, stride, g, nz, nx,
         (float2*)out};
  cudaStream_t st = (cudaStream_t)stream;
  unsigned first_blocks = (unsigned)((long long)n_img * ((n_pix + 127) / 128));
  switch (variant) {
    case 0: first_kernel<true><<<first_blocks, 128, 0, st>>>(a); break;
    case 1: first_kernel<false><<<first_blocks, 128, 0, st>>>(a); break;
    case 2: return run_walk<true, 128, 1, 1, true>(a, n_img, st);
    case 3: return run_walk<true, 128, 1, 2, true>(a, n_img, st);
    case 4: return run_walk<true, 32, 4, 1, true>(a, n_img, st);
    case 5: return run_walk<true, 32, 4, 2, true>(a, n_img, st);
    case 6: return run_walk<true, 32, 8, 1, true>(a, n_img, st);
    case 7: return run_walk<true, 32, 2, 2, true>(a, n_img, st);
    case 8: return run_walk<true, 32, 4, 1, false>(a, n_img, st);
    case 9: return run_walk<false, 32, 4, 1, true>(a, n_img, st);
    case 10:
      flat_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(a, total);
      break;
    case 11: {
      int tile = span <= 5 ? 32 : span <= 7 ? 16 : 8;
      size_t smem = (size_t)tile * span * span * span * sizeof(float2) + tile * sizeof(Frame);
      unsigned blocks = (unsigned)((long long)n_img * ((n_pix + tile - 1) / tile));
      smem_kernel<<<blocks, SMEM_THREADS, smem, st>>>(a, tile);
      break;
    }
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
