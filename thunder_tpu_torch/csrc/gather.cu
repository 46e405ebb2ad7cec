// G1-G5: the gathers of the repo's Pallas TPU microbenchmarks
// (scripts/micro_pallas_gather.py, micro_mosaic_gather.py,
// micro_rowgather.py), as plain Hopper gathers.
//
//   G1 take_flat         out[i]    = t[idx[i]]
//                        (f_pallas, f_pallas2 on its flat index, case_d)
//   G2 take_along_rows   out[b, l] = tab[idx[b, l], l]            (case_a)
//   G3 take_along_lanes  out[b, l] = src[b, idx[b, l]]            (case_b)
//   G4 take_along_both   out[b, l] = tab[ridx[b, m], m],
//                        m = lidx[b, l]                           (case_c)
//   G5 take_rows         out[s, :] = tab[rows[s], :]         (case_e, fH)
//
// Every index is clamped into its axis, as the scripts jnp.clip theirs
// before the kernel (the plain versions clamp the same way).
//
// What bounds them on Hopper: memory latency and bandwidth.  The TPU
// versions had to keep the table resident in VMEM, because its gather
// paid per row outside it.  Here the tables (4 MiB, 256 KiB, 1.8 MB) sit
// in the 50 MB L2 on their own, so nothing is staged in shared memory
// (the 256 KiB table would not even fit a block's 227 KiB): one thread
// per output element reads its index and its tap through the read-only
// path (__ldg), neighbouring threads on neighbouring outputs so index
// loads and stores coalesce.  G5 moves whole 512-byte rows: one warp
// per row, 16-byte float4 loads and stores.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi - 1);
}

__global__ void take_flat_kernel(const float* __restrict__ t, long long n_t,
                                 const int* __restrict__ idx, long long n,
                                 float* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long j = __ldg(idx + i);
    j = j < 0 ? 0 : (j >= n_t ? n_t - 1 : j);
    out[i] = __ldg(t + j);
  }
}

// MODE 0 = G2, 1 = G3, 2 = G4 (three kernels)
template <int MODE>
__global__ void take_along_kernel(const float* __restrict__ tab, int n_rows,
                                  const int* __restrict__ ridx,
                                  const int* __restrict__ lidx, long long n,
                                  int width, float* __restrict__ out) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long b = i / width;
    int l = (int)(i - b * width);
    float v;
    if (MODE == 0) {          // G2: per-lane row select
      v = __ldg(tab + (long long)clampi(__ldg(ridx + i), n_rows) * width + l);
    } else if (MODE == 1) {   // G3: per-row lane shuffle, tab is (B, width)
      v = __ldg(tab + b * width + clampi(__ldg(lidx + i), width));
    } else {                  // G4: lane index, then that lane's row index
      int m = clampi(__ldg(lidx + i), width);
      int r = clampi(__ldg(ridx + b * width + m), n_rows);
      v = __ldg(tab + (long long)r * width + m);
    }
    out[i] = v;
  }
}

__global__ void take_rows_kernel(const float4* __restrict__ tab, int n_rows,
                                 int w4, const int* __restrict__ rows,
                                 long long n, float4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  long long n_warp = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long s = warp; s < n; s += n_warp) {
    int r = clampi(__ldg(rows + s), n_rows);
    const float4* src = tab + (long long)r * w4;
    float4* dst = out + s * w4;
    for (int j = lane; j < w4; j += 32) dst[j] = __ldg(src + j);
  }
}

unsigned grid_for(long long work, int per_block) {
  long long g = (work + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 132 * 64) g = 132 * 64;   // grid-stride beyond ~64 blocks an SM
  return (unsigned)g;
}

}  // namespace

extern "C" int thunder_take_flat(const void* t, long long n_t, const void* idx,
                                 long long n, void* out, void* stream) {
  if (n > 0)
    take_flat_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)t, n_t, (const int*)idx, n, (float*)out);
  return (int)cudaGetLastError();
}

// mode 0 = G2 (ridx), 1 = G3 (lidx), 2 = G4 (ridx and lidx); tab is
// (n_rows, width), the index arrays and out are (n / width, width).
extern "C" int thunder_take_along(const void* tab, int n_rows, const void* ridx,
                                  const void* lidx, long long n, int width,
                                  int mode, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  auto kernel = mode == 0 ? take_along_kernel<0>
              : mode == 1 ? take_along_kernel<1> : take_along_kernel<2>;
  kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)tab, n_rows, (const int*)ridx, (const int*)lidx, n, width,
      (float*)out);
  return (int)cudaGetLastError();
}

// tab (n_rows, width) with width % 4 == 0 and 16-byte aligned rows;
// out (n, width).
extern "C" int thunder_take_rows(const void* tab, int n_rows, int width,
                                 const void* rows, long long n, void* out,
                                 void* stream) {
  if (n > 0)
    take_rows_kernel<<<grid_for(n * 32, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float4*)tab, n_rows, width / 4, (const int*)rows, n,
        (float4*)out);
  return (int)cudaGetLastError();
}
