// G1-G5: the gathers of the repo's Pallas TPU microbenchmarks
// (scripts/micro_pallas_gather.py, micro_mosaic_gather.py,
// micro_rowgather.py), as Hopper gathers.
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
// before the kernel (the plain versions clamp the same way).  A gather
// copies values, so every form below gives the plain version's bits.
//
// What bounds them on Hopper: bytes, and for random taps the sectors: a
// tap from L2 moves a whole 32-byte sector for its 4 bytes.
//
// G1 (take_flat_kernel): one tap a thread, its index and its tap through
// the read-only path (__ldg), up to 132 x 64 blocks of 256 threads —
// the kernel as it was first written.  The 4 MiB table of f_pallas fits
// no block's or cluster's shared memory, so every tap is a sector of L2.
// Every redesign measured in turns at f_pallas was no faster
// (micro/cand/gather_cand.cu, PERF.md): 16-byte index loads and stores
// with 4-16 taps a thread in flight, persistent grids, an evict-last L2
// policy on the taps and streaming hints on the indices and outputs, L1
// no-allocate, L2-only taps 0.0196-0.0212 ms; the table passed through
// clusters' shared memory 0.045-0.047; a tap a thread with the policy and
// the hints 0.0188-0.0191, against this one's 0.0189.  Every form moves the
// taps' 64 MiB of sectors and the 16 MiB stream through L2 at ~4.4 TB/s:
// that bounds it.
//
// G2-G4 (take_along_*), four forms; along_form in ops/gather.py chooses:
//   FORM_SCALAR   any width and offsets: one output a step, persistent grid.
//   FORM_ROW      (G3, G4) a warp a row of up to ROW_WIDTH lanes, 4 a lane:
//                 the row (G3's src, G4's ridx) is read once, coalesced,
//                 into registers, and each output takes its value from the
//                 lane that holds it (__shfl_sync); G4's table taps from L1
//                 and L2.
//   FORM_STRIP16, FORM_STRIP64  (G2) the table in shared memory: a block
//                 owns a strip of 16 or 64 columns, stages tab[:, strip]
//                 once (cp.async) and walks output rows, consecutive
//                 threads on consecutive columns (64: a warp 32 columns of a
//                 row, so its taps fall in 32 banks whatever rows they
//                 pick).  A block stages n_rows x strip x 4 bytes: 16-column
//                 strips cost least from 768 output rows (the scripts'
//                 1,024), 64-column strips stream best from 8,192 rows on.
// G4 with the whole table in a cluster's shared memory (a strip a block,
// a peer's taps through distributed shared memory) was slower than ROW's
// taps at every batch measured (1,024-131,072 rows): it is kept as a
// candidate, micro/cand/gather_cand.cu, with its times in PERF.md.
//
// G5 moves whole 512-byte rows: one warp per row, 16-byte float4 loads and
// stores; at fH's shape it reaches 0.81 of its bound and stays as it was.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int FORM_SCALAR = 0;
constexpr int FORM_ROW = 1;
constexpr int FORM_STRIP16 = 2;
constexpr int FORM_STRIP64 = 3;
constexpr int ROW_WIDTH = 128;      // the widest row a warp holds, 4 a lane
constexpr int STRIP_ROWS = 128;     // output rows a strip's block takes, at least

constexpr int THREADS = 256;

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi - 1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// component m & 3 of the 4 values lane m >> 2 holds (every lane calls it)
__device__ __forceinline__ float held_f(float4 x, int m) {
  const int s = m >> 2, c = m & 3;
  const float a = __shfl_sync(0xffffffffu, x.x, s), b = __shfl_sync(0xffffffffu, x.y, s);
  const float d = __shfl_sync(0xffffffffu, x.z, s), e = __shfl_sync(0xffffffffu, x.w, s);
  return c == 0 ? a : c == 1 ? b : c == 2 ? d : e;
}

__device__ __forceinline__ int held_i(int4 x, int m) {
  const int s = m >> 2, c = m & 3;
  const int a = __shfl_sync(0xffffffffu, x.x, s), b = __shfl_sync(0xffffffffu, x.y, s);
  const int d = __shfl_sync(0xffffffffu, x.z, s), e = __shfl_sync(0xffffffffu, x.w, s);
  return c == 0 ? a : c == 1 ? b : c == 2 ? d : e;
}

// -- G1 -------------------------------------------------------------------

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

// -- G2-G4 ----------------------------------------------------------------

// any width and offsets, one output a step.  MODE 0 = G2 (ridx), 1 = G3
// (lidx; tab is src, (B, width)), 2 = G4 (both)
template <int MODE>
__global__ void __launch_bounds__(THREADS) take_along_scalar_kernel(
    const float* __restrict__ tab, int n_rows, const int* __restrict__ ridx,
    const int* __restrict__ lidx, long long n, int width, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long b = i / width;
    float v;
    if constexpr (MODE == 0) {
      v = __ldg(tab + (long long)clampi(__ldg(ridx + i), n_rows) * width + (i - b * width));
    } else if constexpr (MODE == 1) {
      v = __ldg(tab + b * width + clampi(__ldg(lidx + i), width));
    } else {
      const int m = clampi(__ldg(lidx + i), width);
      v = __ldg(tab + (long long)clampi(__ldg(ridx + b * width + m), n_rows) * width + m);
    }
    out[i] = v;
  }
}

// MODE 1 (G3) or 2 (G4), a warp a row, width <= ROW_WIDTH and width % 4 == 0
template <int MODE>
__global__ void __launch_bounds__(THREADS, 4) take_along_row_kernel(
    const float* __restrict__ tab, int n_rows, const int* __restrict__ ridx,
    const int* __restrict__ lidx, long long n_b, int width, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const bool live = 4 * lane < width;
  const int w4 = width / 4;
  const int4* rows4 = reinterpret_cast<const int4*>(ridx);
  const float4* src4 = reinterpret_cast<const float4*>(tab);
  const int4* lidx4 = reinterpret_cast<const int4*>(lidx);
  float4* out4 = reinterpret_cast<float4*>(out);
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; b < n_b;
       b += n_warps) {
    const long long at = b * w4 + lane;
    const int4 j = live ? __ldg(lidx4 + at) : make_int4(0, 0, 0, 0);
    float4 o;
    if constexpr (MODE == 1) {
      const float4 x = live ? __ldg(src4 + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      o.x = held_f(x, clampi(j.x, width));
      o.y = held_f(x, clampi(j.y, width));
      o.z = held_f(x, clampi(j.z, width));
      o.w = held_f(x, clampi(j.w, width));
    } else {
      const int4 rr = live ? __ldg(rows4 + at) : make_int4(0, 0, 0, 0);
      const int m[4] = {clampi(j.x, width), clampi(j.y, width), clampi(j.z, width),
                        clampi(j.w, width)};
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = __ldg(tab + (long long)clampi(held_i(rr, m[k]), n_rows) * width + m[k]);
      o = make_float4(v[0], v[1], v[2], v[3]);
    }
    if (live) out4[at] = o;
  }
}

// G2 in strips of SW columns (width / SW strips): block k owns strip
// k % n_strips, stages it, and walks rows, its threads on SW columns of
// blockDim.x / SW rows a step, four steps in flight
template <int SW>
__global__ void __launch_bounds__(SW == 64 ? 1024 : THREADS, 1) take_rows_strip_kernel(
    const float* __restrict__ tab, int n_rows, const int* __restrict__ ridx, long long n_b,
    int width, float* __restrict__ out) {
  extern __shared__ __align__(16) float held[];
  const int n_strips = width / SW;
  const int strip = blockIdx.x % n_strips;
  const int part = blockIdx.x / n_strips, n_parts = gridDim.x / n_strips;
  for (int c = threadIdx.x; c < n_rows * (SW / 4); c += blockDim.x) {
    const int r = c / (SW / 4), q = c - r * (SW / 4);
    cp_async16(held + r * SW + 4 * q, tab + (long long)r * width + strip * SW + 4 * q);
  }
  cp_async_wait_all();
  __syncthreads();
  const int scol = threadIdx.x % SW;
  const int col = strip * SW + scol;
  const int per_step = blockDim.x / SW;
  const long long step = (long long)n_parts * per_step;
  long long b = (long long)part * per_step + threadIdx.x / SW;
  for (; b + 3 * step < n_b; b += 4 * step) {
    int j[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) j[k] = __ldg(ridx + (b + k * step) * width + col);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[(b + k * step) * width + col] = held[clampi(j[k], n_rows) * SW + scol];
  }
  for (; b < n_b; b += step)
    out[b * width + col] = held[clampi(__ldg(ridx + b * width + col), n_rows) * SW + scol];
}

// -- G5 -------------------------------------------------------------------

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

// -- launches ---------------------------------------------------------------

// the card's SMs, and how many blocks of a kernel an SM holds, asked once
// (the launch of a gather that takes microseconds should not wait on them)
int sm_count() {
  static int seen[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (seen[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    seen[dev] = n > 0 ? n : 1;
  }
  return seen[dev];
}

int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  struct Seen {
    const void* kernel;
    size_t smem;
    int per_sm;
  };
  static Seen seen[32];
  static int n_seen = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].kernel == kernel && seen[i].smem == smem) return seen[i].per_sm;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (per_sm < 1) per_sm = 1;
  if (n_seen < 32) seen[n_seen++] = Seen{kernel, smem, per_sm};
  return per_sm;
}

// blocks for `threads_needed` threads: no more than the card holds at once
// (the SMs times the blocks an SM holds of this kernel), at least one
unsigned persistent(const void* kernel, int threads, size_t smem, long long threads_needed) {
  long long g = (threads_needed + threads - 1) / threads;
  const long long most = (long long)sm_count() * blocks_per_sm(kernel, threads, smem);
  if (g > most) g = most;
  if (g < 1) g = 1;
  return (unsigned)g;
}

template <int MODE>
int launch_along(const float* tab, int n_rows, const int* ridx, const int* lidx, long long n,
                 int width, int form, float* out, cudaStream_t st) {
  const long long n_b = n / width;
  if (form == FORM_SCALAR) {
    auto k = take_along_scalar_kernel<MODE>;
    k<<<persistent((const void*)k, THREADS, 0, n), THREADS, 0, st>>>(tab, n_rows, ridx, lidx, n,
                                                                     width, out);
  } else if (form == FORM_ROW && MODE != 0) {
    auto k = take_along_row_kernel<MODE == 0 ? 1 : MODE>;
    k<<<persistent((const void*)k, THREADS, 0, 32 * n_b), THREADS, 0, st>>>(
        tab, n_rows, ridx, lidx, n_b, width, out);
  } else if ((form == FORM_STRIP16 || form == FORM_STRIP64) && MODE == 0) {
    const int sw = form == FORM_STRIP16 ? 16 : 64;
    const int threads = sw == 64 ? 1024 : THREADS;
    const size_t smem = (size_t)n_rows * sw * sizeof(float);
    const void* k = sw == 16 ? (const void*)take_rows_strip_kernel<16>
                             : (const void*)take_rows_strip_kernel<64>;
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    // at least STRIP_ROWS rows a block, no more blocks than the card holds
    const int n_strips = width / sw;
    long long parts = (long long)sm_count() * blocks_per_sm(k, threads, smem) / n_strips;
    const long long want = (n_b + STRIP_ROWS - 1) / STRIP_ROWS;
    if (parts > want) parts = want;
    if (parts < 1) parts = 1;
    const unsigned grid = (unsigned)(parts * n_strips);
    if (sw == 16)
      take_rows_strip_kernel<16><<<grid, threads, smem, st>>>(tab, n_rows, ridx, n_b, width, out);
    else
      take_rows_strip_kernel<64><<<grid, threads, smem, st>>>(tab, n_rows, ridx, n_b, width, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// G1.  t (n_t,), idx and out (n,), at any offsets
extern "C" int thunder_take_flat(const void* t, long long n_t, const void* idx, long long n,
                                 void* out, void* stream) {
  if (n > 0)
    take_flat_kernel<<<grid_for(n, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)t, n_t, (const int*)idx, n, (float*)out);
  return (int)cudaGetLastError();
}

// mode 0 = G2 (ridx), 1 = G3 (lidx), 2 = G4 (ridx and lidx); tab is
// (n_rows, width), the index arrays and out are (n / width, width); form
// one of FORM_* as ops/gather.py along_form chose it
extern "C" int thunder_take_along(const void* tab, int n_rows, const void* ridx,
                                  const void* lidx, long long n, int width, int mode, int form,
                                  void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const float* t = (const float*)tab;
  const int* r = (const int*)ridx;
  const int* l = (const int*)lidx;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) return launch_along<0>(t, n_rows, r, l, n, width, form, o, st);
  if (mode == 1) return launch_along<1>(t, n_rows, r, l, n, width, form, o, st);
  return launch_along<2>(t, n_rows, r, l, n, width, form, o, st);
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
