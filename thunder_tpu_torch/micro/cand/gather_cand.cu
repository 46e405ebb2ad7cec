// The first designs of G1 take_flat and G2-G4 take_along (csrc/gather.cu
// as it stood from its port until its redesign), and the designs measured
// beside the redesign (below the first designs), kept as candidates:
// micro/hk_candidates.py (--kernels gather) times them beside the kernels
// in csrc/.  Not part of the kernel library.
//
//   G1 take_flat         out[i]    = t[idx[i]]
//   G2 take_along_rows   out[b, l] = tab[idx[b, l], l]
//   G3 take_along_lanes  out[b, l] = src[b, idx[b, l]]
//   G4 take_along_both   out[b, l] = tab[ridx[b, m], m],  m = lidx[b, l]
//
// One thread an output element: its index, then its tap through the
// read-only path (__ldg), then the store; up to 132 x 64 blocks of 256
// threads, grid-stride beyond.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

// -- the designs measured beside the redesign -------------------------------

__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// G1's tap: 0 ld.global.nc with an evict-last L2 policy (csrc), 1 __ldg,
// 2 as 0 without allocating in L1, 3 ld.global.cg (L2 only), 4 as 2 with
// no policy
template <int LOAD>
__device__ __forceinline__ float flat_tap(const float* p, uint64_t pol) {
  float v;
  if constexpr (LOAD == 0)
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  else if constexpr (LOAD == 1)
    v = __ldg(p);
  else if constexpr (LOAD == 2)
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(v) : "l"(p), "l"(pol));
  else if constexpr (LOAD == 3)
    v = __ldcg(p);
  else
    asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// G1 on 16-byte aligned indices and output, n % 4 == 0: U vectors (4 U
// taps) a thread a step; CS: streaming hints on the indices and outputs
template <int LOAD, int U, bool CS>
__global__ void __launch_bounds__(256) flat_variant_kernel(const float* __restrict__ t,
                                                           long long n_t,
                                                           const int4* __restrict__ idx,
                                                           long long n_vec,
                                                           float4* __restrict__ out) {
  const uint64_t pol = keep_policy();
  const long long stride = (long long)gridDim.x * blockDim.x;
  auto at = [&](int j) {
    const long long k = j < 0 ? 0 : (j >= n_t ? n_t - 1 : j);
    return flat_tap<LOAD>(t + k, pol);
  };
  for (long long v0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; v0 < n_vec;
       v0 += U * stride) {
    int4 a[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = v0 + k * stride;
      a[k] = v < n_vec ? (CS ? __ldcs(idx + v) : __ldg(idx + v)) : make_int4(0, 0, 0, 0);
    }
    float4 x[U];
#pragma unroll
    for (int k = 0; k < U; ++k) x[k] = make_float4(at(a[k].x), at(a[k].y), at(a[k].z), at(a[k].w));
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = v0 + k * stride;
      if (v < n_vec) {
        if (CS)
          __stcs(out + v, x[k]);
        else
          out[v] = x[k];
      }
    }
  }
}

template <int LOAD, int U, bool CS>
int flat_variant(const float* t, long long n_t, const int* idx, long long n, float* out,
                 bool persist, cudaStream_t st) {
  auto k = flat_variant_kernel<LOAD, U, CS>;
  const long long n_vec = n / 4;
  long long g = (n_vec + 256LL * U - 1) / (256LL * U);
  if (persist) {
    int per_sm = 0, n_sm = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)k, 256, 0);
    if (g > (long long)n_sm * per_sm) g = (long long)n_sm * per_sm;
  }
  if (g < 1) g = 1;
  k<<<(unsigned)g, 256, 0, st>>>(t, n_t, (const int4*)idx, n_vec, (float4*)out);
  return (int)cudaGetLastError();
}

// G1 on clusters: the table passes through the cluster's shared memory in
// windows of csize x SLICE floats, a slice a block; a thread keeps V
// vectors' outputs in registers across the windows, reads their indices
// again in each window (from L2 after the first), and takes each tap in
// the window that holds it from the block that holds it (distributed
// shared memory).  Every loop is uniform over the cluster (cluster.sync)
constexpr int SLICE_LOG = 15;   // 2^15 floats = 128 KiB a block
template <int V>
__global__ void __launch_bounds__(1024, 1) flat_cluster_kernel(const float* __restrict__ t,
                                                              long long n_t,
                                                              const int4* __restrict__ idx,
                                                              long long n_vec,
                                                              float4* __restrict__ out) {
  extern __shared__ __align__(16) float held[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long slice = 1LL << SLICE_LOG;
  const long long window = slice * cluster.num_blocks();
  const long long n_pass = (n_t + window - 1) / window;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n_chunk = (n_vec + V * stride - 1) / (V * stride);
  for (long long ch = 0; ch < n_chunk; ++ch) {
    float4 o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long p = 0; p < n_pass; ++p) {
      const long long lo = p * window, a = lo + rank * slice;
      const long long cnt = a >= n_t ? 0 : (n_t - a < slice ? n_t - a : slice);
      for (long long c = threadIdx.x; c < cnt / 4; c += blockDim.x) {
        const unsigned s = (unsigned)__cvta_generic_to_shared(held + 4 * c);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(t + a + 4 * c));
      }
      for (long long c = 4 * (cnt / 4) + threadIdx.x; c < cnt; c += blockDim.x) held[c] = t[a + c];
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      cluster.sync();
      auto at = [&](int j, float keep) {
        const long long q = (j < 0 ? 0 : (j >= n_t ? n_t - 1 : j)) - lo;
        if (q < 0 || q >= window) return keep;
        return cluster.map_shared_rank(held, (int)(q >> SLICE_LOG))[q & (slice - 1)];
      };
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const long long v = (ch * V + k) * stride + tid;
        if (v < n_vec) {
          const int4 j = __ldg(idx + v);
          o[k] = make_float4(at(j.x, o[k].x), at(j.y, o[k].y), at(j.z, o[k].z), at(j.w, o[k].w));
        }
      }
      cluster.sync();   // the window is read before the next one is staged
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long v = (ch * V + k) * stride + tid;
      if (v < n_vec) __stcs(out + v, o[k]);
    }
  }
}

// G2 staged in strips of SW columns: block blockIdx.x % n_strips owns its
// strip, the threads take SW columns of blockDim.x / SW rows a step
template <int SW>
__global__ void rows_strip_kernel(const float* __restrict__ tab, int n_rows,
                                  const int* __restrict__ ridx, long long n_b, int width,
                                  float* __restrict__ out) {
  extern __shared__ __align__(16) float held[];
  const int n_strips = width / SW;
  const int strip = blockIdx.x % n_strips;
  const int part = blockIdx.x / n_strips, n_parts = gridDim.x / n_strips;
  for (int c = threadIdx.x; c < n_rows * (SW / 4); c += blockDim.x) {
    const int r = c / (SW / 4), q = c - r * (SW / 4);
    const unsigned s = (unsigned)__cvta_generic_to_shared(held + r * SW + 4 * q);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(tab + (long long)r * width + strip * SW + 4 * q));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int scol = threadIdx.x % SW;
  const int col = strip * SW + scol;
  const int per_step = blockDim.x / SW;
  const long long step = (long long)n_parts * per_step;
  long long b = (long long)part * per_step + threadIdx.x / SW;
  for (; b + 3 * step < n_b; b += 4 * step) {
    int j[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) j[k] = __ldcs(ridx + (b + k * step) * width + col);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      __stcs(out + (b + k * step) * width + col, held[clampi(j[k], n_rows) * SW + scol]);
  }
  for (; b < n_b; b += step)
    __stcs(out + b * width + col, held[clampi(__ldcs(ridx + b * width + col), n_rows) * SW + scol]);
}

// component m & 3 of the 4 values lane m >> 2 holds
__device__ __forceinline__ int held_i(int4 x, int m) {
  const int s = m >> 2, c = m & 3;
  const int a = __shfl_sync(0xffffffffu, x.x, s), b = __shfl_sync(0xffffffffu, x.y, s);
  const int d = __shfl_sync(0xffffffffu, x.z, s), e = __shfl_sync(0xffffffffu, x.w, s);
  return c == 0 ? a : c == 1 ? b : c == 2 ? d : e;
}

// G4 on a cluster of width / 64 blocks holding the table, 64 columns a
// block, a warp a row (ridx's row in registers, shuffled); a tap on a
// peer's columns reads its shared memory (width 64 or 128)
__global__ void __launch_bounds__(1024, 1) both_cluster_kernel(
    const float* __restrict__ tab, int n_rows, const int* __restrict__ ridx,
    const int* __restrict__ lidx, long long n_b, int width, float* __restrict__ out) {
  extern __shared__ __align__(16) float held[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  for (int c = threadIdx.x; c < n_rows * 16; c += blockDim.x) {
    const int r = c / 16, q = c - r * 16;
    const unsigned s = (unsigned)__cvta_generic_to_shared(held + r * 64 + 4 * q);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(tab + (long long)r * width + rank * 64 + 4 * q));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  cluster.sync();
  const float* part0 = cluster.map_shared_rank(held, 0);
  const float* part1 = cluster.map_shared_rank(held, width > 64 ? 1 : 0);
  const int lane = threadIdx.x & 31;
  const bool live = 4 * lane < width;
  const int w4 = width / 4;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; b < n_b;
       b += n_warps) {
    const long long at = b * w4 + lane;
    const int4 j = live ? __ldcs(reinterpret_cast<const int4*>(lidx) + at) : make_int4(0, 0, 0, 0);
    const int4 rr = live ? __ldcs(reinterpret_cast<const int4*>(ridx) + at) : make_int4(0, 0, 0, 0);
    const int m[4] = {clampi(j.x, width), clampi(j.y, width), clampi(j.z, width),
                      clampi(j.w, width)};
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = clampi(held_i(rr, m[k]), n_rows);
      v[k] = (m[k] < 64 ? part0 : part1)[r * 64 + (m[k] & 63)];
    }
    if (live) __stcs(reinterpret_cast<float4*>(out) + at, make_float4(v[0], v[1], v[2], v[3]));
  }
  cluster.sync();
}

unsigned grid_for(long long work, int per_block) {
  long long g = (work + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 132 * 64) g = 132 * 64;   // grid-stride beyond ~64 blocks an SM
  return (unsigned)g;
}

}  // namespace

extern "C" int cand_take_flat(const void* t, long long n_t, const void* idx, long long n,
                              void* out, void* stream) {
  if (n > 0)
    take_flat_kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)t, n_t, (const int*)idx, n, (float*)out);
  return (int)cudaGetLastError();
}

// mode 0 = G2 (ridx), 1 = G3 (lidx), 2 = G4 (ridx and lidx)
extern "C" int cand_take_along(const void* tab, int n_rows, const void* ridx, const void* lidx,
                               long long n, int width, int mode, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  auto kernel = mode == 0 ? take_along_kernel<0>
              : mode == 1 ? take_along_kernel<1> : take_along_kernel<2>;
  kernel<<<grid_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)tab, n_rows, (const int*)ridx, (const int*)lidx, n, width,
      (float*)out);
  return (int)cudaGetLastError();
}

// G1's vectorised variants on 16-byte aligned indices and output, n % 4 ==
// 0 (FLAT_VARIANTS in hk_candidates.py; v 0 the vector form first written
// for the redesign)
extern "C" int cand_take_flat_variant(int v, const void* t, long long n_t, const void* idx,
                                      long long n, void* out, void* stream) {
  const float* tt = (const float*)t;
  const int* ii = (const int*)idx;
  float* oo = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (v) {
    case 0: return flat_variant<0, 2, true>(tt, n_t, ii, n, oo, true, st);
    case 1: return flat_variant<1, 2, true>(tt, n_t, ii, n, oo, true, st);
    case 2: return flat_variant<2, 2, true>(tt, n_t, ii, n, oo, true, st);
    case 3: return flat_variant<3, 2, true>(tt, n_t, ii, n, oo, true, st);
    case 4: return flat_variant<0, 1, true>(tt, n_t, ii, n, oo, true, st);
    case 5: return flat_variant<0, 4, true>(tt, n_t, ii, n, oo, true, st);
    case 6: return flat_variant<0, 1, true>(tt, n_t, ii, n, oo, false, st);
    case 7: return flat_variant<1, 1, false>(tt, n_t, ii, n, oo, false, st);
    case 8: return flat_variant<4, 1, true>(tt, n_t, ii, n, oo, false, st);
    case 9: return flat_variant<0, 2, false>(tt, n_t, ii, n, oo, true, st);
    case 10: return flat_variant<2, 1, true>(tt, n_t, ii, n, oo, false, st);
    default: return flat_variant<1, 4, false>(tt, n_t, ii, n, oo, true, st);
  }
}

// G2 staged in strips of sw (8, 16, 32 or 64) columns, `threads` a block,
// rows_per_block output rows a block (width % sw == 0)
extern "C" int cand_take_rows_strip(int sw, int threads, int rows_per_block, const void* tab,
                                    int n_rows, const void* ridx, long long n, int width,
                                    void* out, void* stream) {
  const long long n_b = n / width;
  const size_t smem = (size_t)n_rows * sw * sizeof(float);
  const void* k = sw == 8 ? (const void*)rows_strip_kernel<8>
                : sw == 16 ? (const void*)rows_strip_kernel<16>
                : sw == 32 ? (const void*)rows_strip_kernel<32> : (const void*)rows_strip_kernel<64>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  long long parts = (n_b + rows_per_block - 1) / rows_per_block;
  if (parts < 1) parts = 1;
  const unsigned grid = (unsigned)(parts * (width / sw));
  const float* a = (const float*)tab;
  const int* r = (const int*)ridx;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (sw == 8) rows_strip_kernel<8><<<grid, threads, smem, st>>>(a, n_rows, r, n_b, width, o);
  else if (sw == 16) rows_strip_kernel<16><<<grid, threads, smem, st>>>(a, n_rows, r, n_b, width, o);
  else if (sw == 32) rows_strip_kernel<32><<<grid, threads, smem, st>>>(a, n_rows, r, n_b, width, o);
  else rows_strip_kernel<64><<<grid, threads, smem, st>>>(a, n_rows, r, n_b, width, o);
  return (int)cudaGetLastError();
}

// G4 on clusters holding the table (width 64 or 128, n_rows x 64 floats a block)
extern "C" int cand_take_both_cluster(const void* tab, int n_rows, const void* ridx,
                                      const void* lidx, long long n, int width, void* out,
                                      void* stream) {
  const size_t smem = (size_t)n_rows * 64 * sizeof(float);
  auto k = both_cluster_kernel;
  cudaError_t e = cudaFuncSetAttribute((const void*)k,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int csize = width / 64;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)csize);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&n_clusters, (const void*)k, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (n_clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const long long n_b = n / width;
  long long want = (n_b + 32LL * csize - 1) / (32LL * csize);
  if (want > n_clusters) want = n_clusters;
  if (want < 1) want = 1;
  cfg.gridDim = dim3((unsigned)(want * csize));
  e = cudaLaunchKernelEx(&cfg, k, (const float*)tab, n_rows, (const int*)ridx,
                         (const int*)lidx, n_b, width, (float*)out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// G1 on clusters of csize (8 or 16) blocks of 1024 threads, 8 vectors a
// thread a chunk (16-byte aligned indices and output, n % 4 == 0)
extern "C" int cand_take_flat_cluster(int csize, const void* t, long long n_t, const void* idx,
                                      long long n, void* out, void* stream) {
  auto k = flat_cluster_kernel<8>;
  const size_t smem = (size_t)sizeof(float) << SLICE_LOG;
  cudaError_t e = cudaFuncSetAttribute((const void*)k,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (csize > 8) {
    e = cudaFuncSetAttribute((const void*)k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)csize);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&n_clusters, (const void*)k, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (n_clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3((unsigned)(n_clusters * csize));
  e = cudaLaunchKernelEx(&cfg, k, (const float*)t, n_t, (const int4*)idx, n / 4, (float4*)out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int cand_flat_cluster_count(int csize) {
  auto k = flat_cluster_kernel<8>;
  const size_t smem = (size_t)sizeof(float) << SLICE_LOG;
  cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (csize > 8) cudaFuncSetAttribute((const void*)k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)csize);
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  cudaOccupancyMaxActiveClusters(&n_clusters, (const void*)k, &cfg);
  return n_clusters;
}
