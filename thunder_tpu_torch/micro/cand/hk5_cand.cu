// Candidate designs of HK5 project_slices_2d, timed by
// micro/hk_candidates.py before csrc/project_slices_2d.cu was chosen.
// Not part of the kernel library.  Variants 1, 2 and 10 are the shipped
// kernel's thread map (the library keeps variant 1 for launches under
// eight million samples and variant 2 from there on).
//
//   variant 0: the first design: one thread a sample, 64-bit flat index
//              (two divisions, two remainders), four 8-byte taps, 8-byte
//              store
//   variant 1: (pixels x images) blocks, a thread walks its image's
//              rotations; plain plane, one pixel a thread (kept, small
//              launches)
//   variant 2: the same, two pixels a thread, 16-byte stores (kept,
//              large launches)
//   variant 3: quad table, one pixel a thread
//   variant 4: quad table, two pixels a thread
//   variant 5: variant 4 with one rotation a thread (no walk)
//   variant 6: plain plane, four pixels a thread (two 16-byte stores)
//   variant 7: quad table, four pixels a thread
//   variant 8: variant 2 with streaming (evict-first) stores
//   variant 9: variant 4 with streaming stores
//   variant 10: variant 1 with streaming stores

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_THREADS = 256;
// enough threads to fill the card before a thread walks rotations
constexpr long long WANT_THREADS = 132 * 1024;

// The sample of one plane at centered (x, y); all loads start before a
// weight is formed.  QUAD: plane is the quad table's (n, n, 8) floats.
template <bool QUAD>
__device__ __forceinline__ float2 sample_2d(const void* plane, int n, float x, float y) {
  float flx = floorf(x), fly = floorf(y);
  int c = n / 2;
  int ix = (int)flx + c, iy = (int)fly + c;
  int x0 = min(max(ix, 0), n - 1), y0 = min(max(iy, 0), n - 1);
  float2 t00, t01, t10, t11;
  if constexpr (QUAD) {
    // below the plane (ix < 0 or iy < 0) both taps of that axis are the
    // first cell's; past it the cell's own + taps repeat the last cell
    const float4* cell = (const float4*)plane + 2 * (y0 * n + x0);
    float4 a = __ldg(cell), b = __ldg(cell + 1);
    t00 = make_float2(a.x, a.y);
    t01 = ix < 0 ? t00 : make_float2(a.z, a.w);
    if (iy < 0) {
      t10 = t00;
      t11 = t01;
    } else {
      t10 = make_float2(b.x, b.y);
      t11 = ix < 0 ? t10 : make_float2(b.z, b.w);
    }
  } else {
    const float2* img = (const float2*)plane;
    int x1 = min(max(ix + 1, 0), n - 1), y1 = min(max(iy + 1, 0), n - 1);
    t00 = __ldg(img + y0 * n + x0);
    t01 = __ldg(img + y0 * n + x1);
    t10 = __ldg(img + y1 * n + x0);
    t11 = __ldg(img + y1 * n + x1);
  }
  // same weight products and tap order as the JAX gather
  float wx = x - flx, wy = y - fly;
  float w00 = (1.f - wy) * (1.f - wx);
  float w01 = (1.f - wy) * wx;
  float w10 = wy * (1.f - wx);
  float w11 = wy * wx;
  float re = t00.x * w00, im = t00.y * w00;
  re += t01.x * w01; im += t01.y * w01;
  re += t10.x * w10; im += t10.y * w10;
  re += t11.x * w11; im += t11.y * w11;
  return make_float2(re, im);
}

// W pixels a thread (2 or 4: 16-byte stores, W / 2 a rotation; 1: any
// pixel count).  threadIdx.x: the thread's pixel group in the block's pixel
// tile, threadIdx.y: its image in the block's image tile.
template <bool QUAD, int W, bool STREAM>
__global__ void __launch_bounds__(BLOCK_THREADS)
project_slices_2d_kernel(const void* __restrict__ table, int n, const int* __restrict__ cls,
                         const float* __restrict__ rot, long long rot_l_stride, int n_img,
                         int n_rot, int rt, const int* __restrict__ i_col,
                         const int* __restrict__ i_row, int n_pix, int pf,
                         float2* __restrict__ out) {
  const int p = (blockIdx.y * blockDim.x + threadIdx.x) * W;
  const int l = blockIdx.x * blockDim.y + threadIdx.y;
  if (l >= n_img || p >= n_pix) return;
  float fx[W], fy[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    fx[w] = (float)(__ldg(i_col + p + w) * pf);
    fy[w] = (float)(__ldg(i_row + p + w) * pf);
  }
  const int k = cls ? __ldg(cls + l) : 0;
  const char* plane = (const char*)table + (size_t)k * n * n * (QUAD ? 32 : 8);
  const int r0 = blockIdx.z * rt, r1 = min(r0 + rt, n_rot);
  const float* R = rot + l * rot_l_stride + r0 * 4;
  float2* o = out + ((long long)l * n_rot + r0) * n_pix + p;
#pragma unroll 3
  for (int r = r0; r < r1; ++r, R += 4, o += n_pix) {
    float m00 = __ldg(R), m01 = __ldg(R + 1), m10 = __ldg(R + 2), m11 = __ldg(R + 3);
    float2 v[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      float x = __fadd_rn(__fmul_rn(m00, fx[w]), __fmul_rn(m01, fy[w]));
      float y = __fadd_rn(__fmul_rn(m10, fx[w]), __fmul_rn(m11, fy[w]));
      v[w] = sample_2d<QUAD>(plane, n, x, y);
    }
    if constexpr (W == 1) {
      if constexpr (STREAM) __stcs(o, v[0]); else *o = v[0];
    } else {
#pragma unroll
      for (int w = 0; w < W; w += 2) {
        float4 pair = make_float4(v[w].x, v[w].y, v[w + 1].x, v[w + 1].y);
        if constexpr (STREAM) __stcs((float4*)(o + w), pair); else *(float4*)(o + w) = pair;
      }
    }
  }
}

template <bool QUAD, int W, bool STREAM = false>
int launch(const void* table, int n, const int* cls, const float* rot, long long rot_l_stride,
           int n_img, int n_rot, const int* i_col, const int* i_row, int n_pix, int pf,
           float2* out, cudaStream_t stream, int rt_given = 0) {
  int groups = n_pix / W;
  int bx = groups < BLOCK_THREADS ? groups : BLOCK_THREADS;
  int by = BLOCK_THREADS / bx;
  if (by > n_img) by = n_img;
  long long cells = (long long)n_img * groups;
  long long rt = cells * n_rot / WANT_THREADS;
  if (rt_given > 0) rt = rt_given;
  rt = rt < 1 ? 1 : (rt > n_rot ? n_rot : rt);
  dim3 grid((n_img + by - 1) / by, (groups + bx - 1) / bx, (unsigned)((n_rot + rt - 1) / rt));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  project_slices_2d_kernel<QUAD, W, STREAM><<<grid, dim3(bx, by), 0, stream>>>(
      table, n, cls, rot, rot_l_stride, n_img, n_rot, (int)rt, i_col, i_row, n_pix, pf, out);
  return 0;
}


__global__ void first_design_kernel(
    const float2* __restrict__ table, int n, const int* __restrict__ cls,
    const float* __restrict__ rot, long long rot_l_stride, int n_rot,
    const int* __restrict__ i_col, const int* __restrict__ i_row,
    int n_pix, int pf, float2* __restrict__ out, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int p = (int)(idx % n_pix);
  long long lr = idx / n_pix;
  int r = (int)(lr % n_rot);
  long long l = lr / n_rot;

  const float* R = rot + l * rot_l_stride + (long long)r * 4;
  float fx = (float)(i_col[p] * pf);
  float fy = (float)(i_row[p] * pf);
  float x = __fadd_rn(__fmul_rn(__ldg(R + 0), fx), __fmul_rn(__ldg(R + 1), fy));
  float y = __fadd_rn(__fmul_rn(__ldg(R + 2), fx), __fmul_rn(__ldg(R + 3), fy));

  float flx = floorf(x), fly = floorf(y);
  float wx = x - flx, wy = y - fly;
  int c = n / 2;
  int ix = (int)flx + c, iy = (int)fly + c;
  int k = cls ? cls[l] : 0;
  const float2* img = table + (long long)k * n * n;

  int x0 = min(max(ix, 0), n - 1), x1 = min(max(ix + 1, 0), n - 1);
  int y0 = min(max(iy, 0), n - 1), y1 = min(max(iy + 1, 0), n - 1);
  float2 t00 = __ldg(img + (long long)y0 * n + x0);
  float2 t01 = __ldg(img + (long long)y0 * n + x1);
  float2 t10 = __ldg(img + (long long)y1 * n + x0);
  float2 t11 = __ldg(img + (long long)y1 * n + x1);

  float w00 = (1.f - wy) * (1.f - wx);
  float w01 = (1.f - wy) * wx;
  float w10 = wy * (1.f - wx);
  float w11 = wy * wx;
  float re = t00.x * w00, im = t00.y * w00;
  re += t01.x * w01; im += t01.y * w01;
  re += t10.x * w10; im += t10.y * w10;
  re += t11.x * w11; im += t11.y * w11;
  out[idx] = make_float2(re, im);
}

}  // namespace

// table: the (K, n, n) complex64 planes for variants 0-2, their quad
// table for variants 3-5; the rest as thunder_project_slices_2d
extern "C" int cand_project_slices_2d(
    int variant, const void* table, int n, const void* cls, const void* rot,
    long long rot_l_stride, int n_img, int n_rot, const void* i_col,
    const void* i_row, int n_pix, int pf, void* out, void* stream) {
  long long total = (long long)n_img * n_rot * n_pix;
  if (total <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    first_design_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        (const float2*)table, n, (const int*)cls, (const float*)rot, rot_l_stride, n_rot,
        (const int*)i_col, (const int*)i_row, n_pix, pf, (float2*)out, total);
    return (int)cudaGetLastError();
  }
  if (variant != 1 && variant != 3 && variant != 10 &&
      n_pix % (variant == 6 || variant == 7 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  int e = 0;
#define RUN(QUAD, W, RT) RUNS(QUAD, W, RT, false)
#define RUNS(QUAD, W, RT, STREAM)                                                          \
  e = launch<QUAD, W, STREAM>(table, n, (const int*)cls, (const float*)rot, rot_l_stride, n_img,  \
                      n_rot, (const int*)i_col, (const int*)i_row, n_pix, pf, (float2*)out, \
                      st, RT)
  switch (variant) {
    case 1: RUN(false, 1, 0); break;
    case 2: RUN(false, 2, 0); break;
    case 3: RUN(true, 1, 0); break;
    case 4: RUN(true, 2, 0); break;
    case 5: RUN(true, 2, 1); break;
    case 6: RUN(false, 4, 0); break;
    case 7: RUN(true, 4, 0); break;
    case 8: RUNS(false, 2, 0, true); break;
    case 9: RUNS(true, 2, 0, true); break;
    case 10: RUNS(false, 1, 0, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RUN
#undef RUNS
  return e ? e : (int)cudaGetLastError();
}
