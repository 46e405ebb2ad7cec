// Candidate designs of HK1 project_slices, timed against each other by
// micro/hk_candidates.py.  All compute project_slices.cu's function with
// the same weight products and tap order.
//
//   flat<MODE>:    one thread a sample over the flat (l, r, p) index (the
//                  first design); MODE 1 reads (x0, x1) as one 16-byte
//                  load from a table repacked as float4 pairs, MODE 3
//                  the (y, x) quad as one 32-byte sector from a table
//                  repacked as quads.
//   slice<MODE>:   a block owns one (l, r) slice, holds its rotation in
//                  registers and walks the pixels; MODE 0 eight 8-byte
//                  loads, 1 four 16-byte paired loads, 2 eight point
//                  fetches from a 3D texture (classes stacked along z).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  float2 t[8];
};

// table cell (z, y, x) of an n^3 cube; x0 = clip(ix), x1 = clip(ix + 1)
__device__ __forceinline__ void load_plain(const float2* vol, int n, int row, int ix,
                                           float2& a, float2& b) {
  int x0 = min(max(ix, 0), n - 1), x1 = min(max(ix + 1, 0), n - 1);
  a = __ldg(vol + row + x0);
  b = __ldg(vol + row + x1);
}

// pair[x] = (t[x], t[min(x + 1, n - 1)]): one load serves both taps; below
// the cube (ix < 0) both taps are t[0]
__device__ __forceinline__ void load_pair(const float4* vol, int n, int row, int ix,
                                          float2& a, float2& b) {
  float4 v = __ldg(vol + row + min(max(ix, 0), n - 1));
  a = make_float2(v.x, v.y);
  b = ix < 0 ? a : make_float2(v.z, v.w);
}

// quad[y][x] = (t[y][x], t[y][x+], t[y+][x], t[y+][x+]), + clipped to n - 1:
// one 32-byte sector serves the four taps of a z plane
__device__ __forceinline__ void load_quad(const float4* vol, int n, int plane, int iy, int ix,
                                          float2* q) {
  const float4* c = vol + 2 * (plane + min(max(iy, 0), n - 1) * n + min(max(ix, 0), n - 1));
  float4 a = __ldg(c), b = __ldg(c + 1);
  q[0] = make_float2(a.x, a.y);
  q[1] = ix < 0 ? q[0] : make_float2(a.z, a.w);
  if (iy < 0) {
    q[2] = q[0];
    q[3] = q[1];
  } else {
    q[2] = make_float2(b.x, b.y);
    q[3] = ix < 0 ? q[2] : make_float2(b.z, b.w);
  }
}

__device__ __forceinline__ float2 blend(const Taps& q, float wx, float wy, float wz) {
  float w000 = (1.f - wz) * (1.f - wy) * (1.f - wx);
  float w001 = (1.f - wz) * (1.f - wy) * wx;
  float w010 = (1.f - wz) * wy * (1.f - wx);
  float w011 = (1.f - wz) * wy * wx;
  float w100 = wz * (1.f - wy) * (1.f - wx);
  float w101 = wz * (1.f - wy) * wx;
  float w110 = wz * wy * (1.f - wx);
  float w111 = wz * wy * wx;
  float re = q.t[0].x * w000, im = q.t[0].y * w000;
  re += q.t[1].x * w001; im += q.t[1].y * w001;
  re += q.t[2].x * w010; im += q.t[2].y * w010;
  re += q.t[3].x * w011; im += q.t[3].y * w011;
  re += q.t[4].x * w100; im += q.t[4].y * w100;
  re += q.t[5].x * w101; im += q.t[5].y * w101;
  re += q.t[6].x * w110; im += q.t[6].y * w110;
  re += q.t[7].x * w111; im += q.t[7].y * w111;
  return make_float2(re, im);
}

template <int MODE>
__device__ __forceinline__ float2 sample(const void* table, cudaTextureObject_t tex, int n,
                                         int k, float x, float y, float z) {
  float flx = floorf(x), fly = floorf(y), flz = floorf(z);
  int c = n / 2;
  int ix = (int)flx + c, iy = (int)fly + c, iz = (int)flz + c;
  int y0 = min(max(iy, 0), n - 1), y1 = min(max(iy + 1, 0), n - 1);
  int z0 = min(max(iz, 0), n - 1), z1 = min(max(iz + 1, 0), n - 1);
  Taps q;
  if constexpr (MODE == 2) {
    float x0 = (float)min(max(ix, 0), n - 1) + 0.5f, x1 = (float)min(max(ix + 1, 0), n - 1) + 0.5f;
    float fy0 = (float)y0 + 0.5f, fy1 = (float)y1 + 0.5f;
    float fz0 = (float)(k * n + z0) + 0.5f, fz1 = (float)(k * n + z1) + 0.5f;
    q.t[0] = tex3D<float2>(tex, x0, fy0, fz0);
    q.t[1] = tex3D<float2>(tex, x1, fy0, fz0);
    q.t[2] = tex3D<float2>(tex, x0, fy1, fz0);
    q.t[3] = tex3D<float2>(tex, x1, fy1, fz0);
    q.t[4] = tex3D<float2>(tex, x0, fy0, fz1);
    q.t[5] = tex3D<float2>(tex, x1, fy0, fz1);
    q.t[6] = tex3D<float2>(tex, x0, fy1, fz1);
    q.t[7] = tex3D<float2>(tex, x1, fy1, fz1);
  } else {
    int r00 = (z0 * n + y0) * n, r01 = (z0 * n + y1) * n;
    int r10 = (z1 * n + y0) * n, r11 = (z1 * n + y1) * n;
    long long base = (long long)k * n * n * n;
    if constexpr (MODE == 3) {
      const float4* vol = (const float4*)table + 2 * base;
      load_quad(vol, n, z0 * n * n, iy, ix, q.t);
      load_quad(vol, n, z1 * n * n, iy, ix, q.t + 4);
    } else if constexpr (MODE == 1) {
      const float4* vol = (const float4*)table + base;
      load_pair(vol, n, r00, ix, q.t[0], q.t[1]);
      load_pair(vol, n, r01, ix, q.t[2], q.t[3]);
      load_pair(vol, n, r10, ix, q.t[4], q.t[5]);
      load_pair(vol, n, r11, ix, q.t[6], q.t[7]);
    } else {
      const float2* vol = (const float2*)table + base;
      load_plain(vol, n, r00, ix, q.t[0], q.t[1]);
      load_plain(vol, n, r01, ix, q.t[2], q.t[3]);
      load_plain(vol, n, r10, ix, q.t[4], q.t[5]);
      load_plain(vol, n, r11, ix, q.t[6], q.t[7]);
    }
  }
  return blend(q, x - flx, y - fly, z - flz);
}

template <int MODE>
__global__ void flat_kernel(const void* __restrict__ table, int n, const int* __restrict__ cls,
                            const float* __restrict__ rot, long long rot_l_stride, int n_rot,
                            const int* __restrict__ i_col, const int* __restrict__ i_row,
                            int n_pix, int pf, float2* __restrict__ out, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int p = (int)(idx % n_pix);
  long long lr = idx / n_pix;
  int r = (int)(lr % n_rot);
  long long l = lr / n_rot;
  const float* R = rot + l * rot_l_stride + (long long)r * 9;
  float fx = (float)(i_col[p] * pf), fy = (float)(i_row[p] * pf);
  float x = __fadd_rn(__fmul_rn(__ldg(R + 0), fx), __fmul_rn(__ldg(R + 1), fy));
  float y = __fadd_rn(__fmul_rn(__ldg(R + 3), fx), __fmul_rn(__ldg(R + 4), fy));
  float z = __fadd_rn(__fmul_rn(__ldg(R + 6), fx), __fmul_rn(__ldg(R + 7), fy));
  out[idx] = sample<MODE>(table, 0, n, cls ? cls[l] : 0, x, y, z);
}

template <int MODE>
__global__ void slice_kernel(const void* __restrict__ table, cudaTextureObject_t tex, int n,
                             const int* __restrict__ cls, const float* __restrict__ rot,
                             long long rot_l_stride, int n_rot, const int* __restrict__ i_col,
                             const int* __restrict__ i_row, int n_pix, int pf,
                             float2* __restrict__ out) {
  const long long lr = blockIdx.x;
  const int r = (int)(lr % n_rot);
  const long long l = lr / n_rot;
  const float* R = rot + l * rot_l_stride + (long long)r * 9;
  const float R0 = __ldg(R), R1 = __ldg(R + 1), R3 = __ldg(R + 3), R4 = __ldg(R + 4),
              R6 = __ldg(R + 6), R7 = __ldg(R + 7);
  const int k = cls ? cls[l] : 0;
  float2* o = out + lr * n_pix;
  for (int p = threadIdx.x; p < n_pix; p += blockDim.x) {
    float fx = (float)(i_col[p] * pf), fy = (float)(i_row[p] * pf);
    float x = __fadd_rn(__fmul_rn(R0, fx), __fmul_rn(R1, fy));
    float y = __fadd_rn(__fmul_rn(R3, fx), __fmul_rn(R4, fy));
    float z = __fadd_rn(__fmul_rn(R6, fx), __fmul_rn(R7, fy));
    o[p] = sample<MODE>(table, tex, n, k, x, y, z);
  }
}

int slice_threads(int n_pix) { return min(256, max(32, (n_pix + 31) / 32 * 32)); }

}  // namespace

// variant 0 flat, 1 flat paired, 2 slice, 3 slice paired, 4 flat quad
extern "C" int cand_project_slices(int variant, const void* table, int n, const void* cls,
                                   const void* rot, long long rot_l_stride, int n_img, int n_rot,
                                   const void* i_col, const void* i_row, int n_pix, int pf,
                                   void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long total = (long long)n_img * n_rot * n_pix;
  unsigned fb = (unsigned)((total + 255) / 256), sb = (unsigned)(n_img * n_rot);
  int th = slice_threads(n_pix);
#define ARGS (const int*)cls, (const float*)rot, rot_l_stride, n_rot, (const int*)i_col, \
             (const int*)i_row, n_pix, pf, (float2*)out
  switch (variant) {
    case 0: flat_kernel<0><<<fb, 256, 0, st>>>(table, n, ARGS, total); break;
    case 1: flat_kernel<1><<<fb, 256, 0, st>>>(table, n, ARGS, total); break;
    case 2: slice_kernel<0><<<sb, th, 0, st>>>(table, 0, n, ARGS); break;
    case 3: slice_kernel<1><<<sb, th, 0, st>>>(table, 0, n, ARGS); break;
    case 4: flat_kernel<3><<<fb, 256, 0, st>>>(table, n, ARGS, total); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The texture candidate, self-contained: copies table (n_cls, n, n, n)
// complex64 into a 3D array (classes stacked along z), runs the slice
// kernel once into out, then times reps launches with CUDA events.
// ms[0] = the copy into the array, ms[1] = one launch.
extern "C" int cand_project_slices_tex(const void* table, int n, int n_cls, const void* cls,
                                       const void* rot, long long rot_l_stride, int n_img,
                                       int n_rot, const void* i_col, const void* i_row,
                                       int n_pix, int pf, void* out, int reps, float* ms,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaChannelFormatDesc desc = cudaCreateChannelDesc<float2>();
  cudaExtent ext = make_cudaExtent(n, n, (size_t)n * n_cls);
  cudaArray_t arr;
  cudaError_t e = cudaMalloc3DArray(&arr, &desc, ext);
  if (e != cudaSuccess) return (int)e;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaMemcpy3DParms cp = {};
  cp.srcPtr = make_cudaPitchedPtr((void*)table, n * sizeof(float2), n, n);
  cp.dstArray = arr;
  cp.extent = ext;
  cp.kind = cudaMemcpyDeviceToDevice;
  cudaEventRecord(a, st);
  e = cudaMemcpy3DAsync(&cp, st);
  cudaEventRecord(b, st);
  if (e != cudaSuccess) return (int)e;
  cudaResourceDesc res = {};
  res.resType = cudaResourceTypeArray;
  res.res.array.array = arr;
  cudaTextureDesc td = {};
  td.addressMode[0] = td.addressMode[1] = td.addressMode[2] = cudaAddressModeClamp;
  td.filterMode = cudaFilterModePoint;
  td.readMode = cudaReadModeElementType;
  td.normalizedCoords = 0;
  cudaTextureObject_t tex;
  e = cudaCreateTextureObject(&tex, &res, &td, nullptr);
  if (e != cudaSuccess) return (int)e;
  cudaEventSynchronize(b);
  cudaEventElapsedTime(&ms[0], a, b);
  unsigned sb = (unsigned)(n_img * n_rot);
  int th = slice_threads(n_pix);
  for (int i = 0; i < reps + 2; ++i) {
    if (i == 2) cudaEventRecord(a, st);
    slice_kernel<2><<<sb, th, 0, st>>>(nullptr, tex, n, ARGS);
  }
  cudaEventRecord(b, st);
  cudaEventSynchronize(b);
  cudaEventElapsedTime(&ms[1], a, b);
  ms[1] /= reps;
  e = cudaGetLastError();
  cudaDestroyTextureObject(tex);
  cudaFreeArray(arr);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return (int)e;
}
