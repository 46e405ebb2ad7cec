// HK4 shell_sums: Fourier-shell reduction of C real fields.
//
// Replaces (thunder_tpu): shell_sums3 in optimiser._compare_refs (per
// z-plane one-hot bf16 matmuls), physics/spectrum.py shell_sum (a
// scatter-add, used by fsc and the true FSC), and the one-hot matmul
// shell sums of the sigma stages (optimiser._sigma_step, _max_stats_h).
//
// out[b, c, s] = sum_i [min(shell[i], n_shells) == s] * weight[i] * v[b, c, i]
// for s < n_shells (the overflow bin n_shells is dropped), with weight
// the half-space (or pixel) mask, or 1 when none is given.  Sums are
// float32.
//
// What bounds it on Hopper: one read of the fields (memory bound), if
// the adds keep out of its way.  They did not in the first design: a
// shared-memory float atomicAdd is a compare-and-swap loop on this card,
// neighbouring lanes hold neighbouring cells of one row, which lie in
// one to three shells, so a warp's 32 adds hit a few addresses and ran
// one after another, C times a cell, on one histogram for all 8 warps.
// The design here adds in registers first and keeps the histograms
// apart:
//   * a lane holds one cell; the lanes of a warp hold consecutive cells.
//     Runs of equal shell index among them are found with one shuffle
//     and a ballot, and summed by a segmented shuffle reduction that
//     stops at the longest run (warp_accumulate); only the first lane of
//     a run adds to shared memory, into a histogram that belongs to its
//     warp alone.  Loads of U iterations start before the first
//     reduction, so a thread has U x C loads in flight;
//   * centered full grids (the hemisphere FSC, the ring FRC, the
//     preprocess spectra) take the coordinate form
//     (shell_sums_grid_kernel): the shell index is rint(sqrt(k^2)) of the
//     cell's own coordinates (exact: sqrt of an integer is never within
//     float32 rounding of a half-integer at these sizes) and the
//     half-space weight is the choice of cells, kx >= 0 and the kx = -c
//     column, so neither array is read and the kx < 0 half of the fields
//     is never touched.  A block merges its warps' histograms and adds
//     each non-empty bin to device memory once (the order of those adds
//     differs from run to run).  A second loader forms Re(a conj b),
//     |a|^2 and |b|^2 from two complex spectra in the kernel, so the FSC
//     needs no stacked copy of them (thunder_fsc_sums_grid);
//   * packed rings (the sigma stage: thousands of images of ~2,000
//     pixels each, shell and weight arrays given) take the row form
//     (shell_sums_rows_kernel): a warp owns an image, or one of `chunks`
//     pieces of it when images are few.  With one piece an image the
//     warp stores its histogram (no atomics, no zero-filled output).
//     A lane loads four consecutive cells at once (16 bytes a field)
//     where the row length allows it.
// Two-stage sums without atomics were not pursued: the order of two
// equal-shell run heads inside one warp's shared add is not fixed
// either, so the result would still not be bitwise repeatable.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_C = 4;           // fields one launch carries in registers
constexpr int GRID_THREADS = 256;  // coordinate form: 8 warps, one histogram each
constexpr int GRID_UNROLL = 4;     // load steps in flight (1, 2 and 4 measured alike)
constexpr int ROWS_THREADS = 128;  // row form: 4 warps, each its own tasks
constexpr int ROWS_UNROLL = 1;     // 16-byte loads a lane has in flight a field

// Add v[c] of every lane into hist[c * n_shells + s] (s >= n_shells is
// the dropped overflow bin).  Lanes of one run (neighbours with equal s)
// are summed into the run's first lane before anything is shared.
template <int C>
__device__ __forceinline__ void warp_accumulate(float* hist, int n_shells, int s, float (&v)[C],
                                                int lane) {
  int prev = __shfl_up_sync(FULL, s, 1);
  bool head = lane == 0 || prev != s;
  unsigned heads = __ballot_sync(FULL, head);
  unsigned above = heads & (0xfffffffeu << lane);
  int run = (above ? __ffs(above) - 1 : 32) - lane;   // lanes from here to the run's end
  // dropped cells (overflow, a piece's tail, cells a lane has summed
  // into its next one) form runs nobody adds: they set no step count
  int longest = __reduce_max_sync(FULL, s < n_shells ? run : 0);
  for (int d = 1; d < longest; d <<= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float o = __shfl_down_sync(FULL, v[c], d);
      if (d < run) v[c] += o;
    }
  }
  if (head && s < n_shells) {
#pragma unroll
    for (int c = 0; c < C; ++c) atomicAdd(hist + c * n_shells + s, v[c]);
  }
}

// C real fields of one image of a (B, C, N) float32 array
template <int C>
struct FieldLoader {
  const float* v;
  long long ld_b, n;
  __device__ __forceinline__ FieldLoader image(int b) const { return {v + b * ld_b, ld_b, n}; }
  __device__ __forceinline__ void load(long long i, float (&x)[C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = __ldg(v + c * n + i);
  }
};

// Re(a conj b), |a|^2, |b|^2 of two (B, N) complex64 spectra
struct PairLoader {
  const float2 *a, *b;
  long long n;
  __device__ __forceinline__ PairLoader image(int i) const { return {a + i * n, b + i * n, n}; }
  __device__ __forceinline__ void load(long long i, float (&x)[3]) const {
    float2 p = __ldg(a + i), q = __ldg(b + i);
    x[0] = p.x * q.x + p.y * q.y;
    x[1] = p.x * p.x + p.y * p.y;
    x[2] = q.x * q.x + q.y * q.y;
  }
};

// Coordinate form.  An item is a cell the sum takes: with half != 0 the
// cells x = 0 (kx = -c) and x >= c of each row, hw = size - c + 1 a row;
// else every cell, hw = size.  Items are numbered row by row, a block
// takes per_block consecutive ones, a warp 32 consecutive ones a step.
template <int C, class Loader, int U>
__global__ void __launch_bounds__(GRID_THREADS)
shell_sums_grid_kernel(Loader all, int size, int nd, int half, unsigned hw, unsigned items,
                       unsigned per_block, int n_shells, float* __restrict__ out,
                       long long out_ld) {
  extern __shared__ float hist[];
  constexpr int WARPS = GRID_THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nb = C * n_shells;
  for (int j = tid; j < WARPS * nb; j += GRID_THREADS) hist[j] = 0.f;
  __syncthreads();
  float* mine = hist + (tid >> 5) * nb;
  const Loader ld = all.image(blockIdx.y);
  const int c0 = size / 2;
  const unsigned start = blockIdx.x * per_block;
  const unsigned end = min(start + per_block, items);
  for (unsigned base = start; base < end; base += GRID_THREADS * U) {
    float v[U][C];
    int s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      unsigned t = base + u * GRID_THREADS + tid;
      s[u] = n_shells;
#pragma unroll
      for (int c = 0; c < C; ++c) v[u][c] = 0.f;
      if (t < end) {
        unsigned row = t / hw;
        int j = (int)(t - row * hw);
        int x = half ? (j == 0 ? 0 : c0 + j - 1) : j;
        unsigned zz = row / (unsigned)size;
        int kx = x - c0, ky = (int)(row - zz * size) - c0, kz = nd == 3 ? (int)zz - c0 : 0;
        int k2 = kx * kx + ky * ky + kz * kz;
        s[u] = min((int)rintf(__fsqrt_rn((float)k2)), n_shells);
        ld.load((long long)row * size + x, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) warp_accumulate<C>(mine, n_shells, s[u], v[u], lane);
  }
  __syncthreads();
  for (int j = tid; j < nb; j += GRID_THREADS) {
    float h = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) h += hist[w * nb + j];
    if (h != 0.f) atomicAdd(out + blockIdx.y * out_ld + j, h);
  }
}

// Row form.  Task t is piece t % chunks of image t / chunks; a warp
// takes tasks in turn.  chunks == 1: the warp stores every bin of its
// image; else it adds its non-empty bins to the zero-filled output.
// A lane holds V consecutive cells (4: 16-byte loads; n, ld_b and the
// pieces' ends are then multiples of 4 and the arrays 16-byte aligned),
// U such loads in flight.  With V = 4 the lane first sums the runs among
// its own cells (MERGE), then round q of the warp's reduction takes
// cell q of every lane.
template <int C, int V, int U, bool MERGE>
__global__ void __launch_bounds__(ROWS_THREADS)
shell_sums_rows_kernel(const float* __restrict__ v, long long ld_b, long long n,
                       const int* __restrict__ shell, const float* __restrict__ weight,
                       int n_shells, int chunks, long long chunk_len, long long tasks,
                       float* __restrict__ out, long long out_ld) {
  extern __shared__ float hist[];
  constexpr int WARPS = ROWS_THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = C * n_shells;
  float* mine = hist + warp * nb;
  for (long long task = (long long)blockIdx.x * WARPS + warp; task < tasks;
       task += (long long)gridDim.x * WARPS) {
    long long b = task / chunks;
    long long lo = (task - b * chunks) * chunk_len, hi = min(n, lo + chunk_len);
    for (int j = lane; j < nb; j += 32) mine[j] = 0.f;
    __syncwarp();
    const float* vb = v + b * ld_b;
    for (long long i0 = lo; i0 < hi; i0 += 32 * V * U) {
      float x[U][V][C];
      int s[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        long long i = i0 + (u * 32 + lane) * V;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          s[u][q] = n_shells;
#pragma unroll
          for (int c = 0; c < C; ++c) x[u][q][c] = 0.f;
        }
        if (i < hi) {
          if constexpr (V == 4) {
            int4 sh = __ldg((const int4*)(shell + i));
            float4 wt = weight ? __ldg((const float4*)(weight + i))
                               : make_float4(1.f, 1.f, 1.f, 1.f);
            s[u][0] = (int)min((unsigned)sh.x, (unsigned)n_shells);
            s[u][1] = (int)min((unsigned)sh.y, (unsigned)n_shells);
            s[u][2] = (int)min((unsigned)sh.z, (unsigned)n_shells);
            s[u][3] = (int)min((unsigned)sh.w, (unsigned)n_shells);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              float4 f = __ldg((const float4*)(vb + c * n + i));
              x[u][0][c] = f.x * wt.x;
              x[u][1][c] = f.y * wt.y;
              x[u][2][c] = f.z * wt.z;
              x[u][3][c] = f.w * wt.w;
            }
          } else {
            s[u][0] = (int)min((unsigned)__ldg(shell + i), (unsigned)n_shells);
            float wt = weight ? __ldg(weight + i) : 1.f;
#pragma unroll
            for (int c = 0; c < C; ++c) x[u][0][c] = __ldg(vb + c * n + i) * wt;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if constexpr (MERGE && V > 1) {
#pragma unroll
          for (int q = 0; q + 1 < V; ++q) {
            if (s[u][q] == s[u][q + 1]) {
#pragma unroll
              for (int c = 0; c < C; ++c) x[u][q + 1][c] += x[u][q][c];
              s[u][q] = n_shells;   // summed into the next cell: nothing left to add
            }
          }
        }
#pragma unroll
        for (int q = 0; q < V; ++q) warp_accumulate<C>(mine, n_shells, s[u][q], x[u][q], lane);
      }
    }
    __syncwarp();
    float* ob = out + b * out_ld;
    for (int j = lane; j < nb; j += 32) {
      float h = mine[j];
      if (chunks == 1) ob[j] = h;
      else if (h != 0.f) atomicAdd(ob + j, h);
    }
    __syncwarp();
  }
}

int shared_ok(const void* kernel, size_t smem) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

template <int C, class Loader, int U = GRID_UNROLL>
int launch_grid(Loader all, int B, int size, int nd, int half, int n_shells, float* out,
                long long out_ld, cudaStream_t stream) {
  unsigned hw = half ? size - size / 2 + 1 : size;
  unsigned rows = nd == 3 ? (unsigned)size * size : size;
  unsigned items = rows * hw;
  // up to four blocks of 8 warps an SM, each thread U x C loads in flight
  const unsigned step = GRID_THREADS * U;
  unsigned want = (items + step - 1) / step;
  unsigned cap = (528 + B - 1) / B;
  unsigned gx = want < cap ? want : cap;
  unsigned per_block = ((items + gx - 1) / gx + 31) / 32 * 32;
  gx = (items + per_block - 1) / per_block;
  size_t smem = (size_t)(GRID_THREADS / 32) * C * n_shells * sizeof(float);
  auto kernel = shell_sums_grid_kernel<C, Loader, U>;
  if (int e = shared_ok((const void*)kernel, smem)) return e;
  kernel<<<dim3(gx, B), GRID_THREADS, smem, stream>>>(all, size, nd, half, hw, items, per_block,
                                                      n_shells, out, out_ld);
  return 0;
}

template <int C, int V, int U, bool MERGE>
int launch_rows_as(const float* v, long long ld_b, int B, long long n, const int* shell,
                   const float* weight, int n_shells, int chunks, float* out, long long out_ld,
                   cudaStream_t stream) {
  const long long step = 32 * V;
  long long chunk_len = ((n + chunks - 1) / chunks + step - 1) / step * step;
  long long tasks = (long long)B * chunks;
  const int warps = ROWS_THREADS / 32;
  long long blocks = (tasks + warps - 1) / warps;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  size_t smem = (size_t)warps * C * n_shells * sizeof(float);
  auto kernel = shell_sums_rows_kernel<C, V, U, MERGE>;
  if (int e = shared_ok((const void*)kernel, smem)) return e;
  kernel<<<(unsigned)blocks, ROWS_THREADS, smem, stream>>>(v, ld_b, n, shell, weight, n_shells,
                                                           chunks, chunk_len, tasks, out, out_ld);
  return 0;
}

// 16-byte loads where every row and array allows them
template <int C>
int launch_rows(const float* v, long long ld_b, int B, long long n, const int* shell,
                const float* weight, int n_shells, int chunks, float* out, long long out_ld,
                cudaStream_t stream) {
  bool vec = n % 4 == 0 && ld_b % 4 == 0 && (uintptr_t)v % 16 == 0 &&
             (uintptr_t)shell % 16 == 0 && (uintptr_t)weight % 16 == 0;
  // a lane's own runs first where C fields share the work of finding them
  auto fn = vec ? launch_rows_as<C, 4, ROWS_UNROLL, (C > 1)> : launch_rows_as<C, 1, 2, false>;
  return fn(v, ld_b, B, n, shell, weight, n_shells, chunks, out, out_ld, stream);
}

// launch(cg, c0) for the fields c0 .. c0 + cg - 1 of C, MAX_C a launch;
// cg arrives as a std::integral_constant, so it can be a template argument
template <class F>
int by_field_groups(int C, F launch) {
  for (int c0 = 0; c0 < C; c0 += MAX_C) {
    int e;
    switch (C - c0 < MAX_C ? C - c0 : MAX_C) {
      case 1: e = launch(std::integral_constant<int, 1>{}, c0); break;
      case 2: e = launch(std::integral_constant<int, 2>{}, c0); break;
      case 3: e = launch(std::integral_constant<int, 3>{}, c0); break;
      default: e = launch(std::integral_constant<int, 4>{}, c0); break;
    }
    if (e) return e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Row form.  v: (B, C, N) with batch stride ld_b (C * N when
// contiguous); shell (N,) int32; weight (N,) float32 or null; out: (B, C,
// n_shells), zero-filled by the caller unless chunks == 1, when every
// bin is stored.  More than MAX_C fields go MAX_C a launch.
extern "C" int thunder_shell_sums(const void* v, long long ld_b, int B, int C, long long N,
                                  const void* shell, const void* weight, int n_shells,
                                  int chunks, void* out, void* stream) {
  if (B <= 0 || C <= 0 || N <= 0 || n_shells <= 0) return (int)cudaGetLastError();
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  return by_field_groups(C, [&](auto cg, int c0) {
    return launch_rows<decltype(cg)::value>(
        (const float*)v + c0 * N, ld_b, B, N, (const int*)shell, (const float*)weight, n_shells,
        chunks, (float*)out + c0 * n_shells, (long long)C * n_shells, (cudaStream_t)stream);
  });
}

// Coordinate form.  v: (B, C, size^nd) centered full grids, nd 2 or 3,
// size^nd < 2^31; halfspace != 0 sums the cells kx >= 0 and kx = -c only;
// out: (B, C, n_shells), zero-filled by the caller.
extern "C" int thunder_shell_sums_grid(const void* v, long long ld_b, int B, int C, int size,
                                       int nd, int halfspace, int n_shells, void* out,
                                       void* stream) {
  if (B <= 0 || C <= 0 || size <= 0 || n_shells <= 0) return (int)cudaGetLastError();
  long long n = nd == 3 ? (long long)size * size * size : (long long)size * size;
  return by_field_groups(C, [&](auto cg, int c0) {
    constexpr int CG = decltype(cg)::value;
    return launch_grid<CG>(FieldLoader<CG>{(const float*)v + c0 * n, ld_b, n}, B, size, nd,
                           halfspace, n_shells, (float*)out + c0 * n_shells,
                           (long long)C * n_shells, (cudaStream_t)stream);
  });
}

// The FSC's three sums from the spectra themselves.  a, b: (B, size^nd)
// complex64 centered full grids; out: (B, 3, n_shells) of Re(a conj b),
// |a|^2, |b|^2 over the half space, zero-filled by the caller.
extern "C" int thunder_fsc_sums_grid(const void* a, const void* b, int B, int size, int nd,
                                     int n_shells, void* out, void* stream) {
  if (B <= 0 || size <= 0 || n_shells <= 0) return (int)cudaGetLastError();
  long long n = nd == 3 ? (long long)size * size * size : (long long)size * size;
  PairLoader all{(const float2*)a, (const float2*)b, n};
  if (int e = launch_grid<3>(all, B, size, nd, 1, n_shells, (float*)out, 3LL * n_shells,
                             (cudaStream_t)stream))
    return e;
  return (int)cudaGetLastError();
}
