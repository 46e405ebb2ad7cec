// Candidate designs of HK4 shell_sums, timed by micro/hk_candidates.py
// before csrc/shell_sums.cu was chosen.  Not part of the kernel library.
// The kept design's templates come from the library's own source, so
// what is timed here is what is shipped.
//
//   variant 0: the first design: a block-wide histogram, one shared
//              atomicAdd a field a cell, grid sized from N alone
//   variant 1: the same loop with a histogram for each warp (what the
//              sharing between warps costs)
//   variant 2: the row form (runs summed in registers, a histogram a
//              warp), `chunks` pieces an image, 2 loads steps in flight
//   variant 3: the row form with 16-byte loads: a lane holds four
//              consecutive cells (N a multiple of 4)
//   variant 7: variant 3 with the runs among a lane's own four cells
//              summed first
//   variant 8: variant 7 with 2 load steps in flight
//   variant 9: variant 3 with 2 load steps in flight
//   variant 4: the coordinate form, 4 load steps in flight (kept for
//              centered full grids)
//   variant 5: the coordinate form, 1 load step in flight
//   variant 6: the coordinate form, 2 load steps in flight

#include "../../csrc/shell_sums.cu"

namespace {

template <bool PER_WARP>
__global__ void first_design_kernel(const float* __restrict__ v, long long ld_b, int C,
                                    long long N, const int* __restrict__ shell,
                                    const float* __restrict__ weight, int n_shells,
                                    float* __restrict__ out) {
  extern __shared__ float hist[];
  const int nb = n_shells + 1;
  const int b = blockIdx.y;
  const int copies = PER_WARP ? blockDim.x / 32 : 1;
  for (int j = threadIdx.x; j < copies * C * nb; j += blockDim.x) hist[j] = 0.f;
  __syncthreads();
  float* mine = hist + (PER_WARP ? (threadIdx.x >> 5) * C * nb : 0);

  const float* vb = v + b * ld_b;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N; i += stride) {
    float wt = weight ? weight[i] : 1.f;
    if (wt == 0.f) continue;
    int s = min(shell[i], n_shells);
    for (int c = 0; c < C; ++c) atomicAdd(&mine[c * nb + s], vb[c * N + i] * wt);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C * nb; j += blockDim.x) {
    int c = j / nb, s = j - c * nb;
    float h = 0.f;
    for (int w = 0; w < copies; ++w) h += hist[w * C * nb + j];
    if (s < n_shells && h != 0.f) atomicAdd(out + ((long long)b * C + c) * n_shells + s, h);
  }
}

}  // namespace

// v (B, C, N) float32, C 1 or 3; shell, weight as thunder_shell_sums
// (variants 0-3); size, nd, half describe the centered grid (variants
// 4-6, N = size^nd); out (B, C, n_shells) zero-filled by the caller
extern "C" int cand_shell_sums(int variant, const void* v, long long ld_b, int B, int C,
                               long long N, const void* shell, const void* weight, int n_shells,
                               int chunks, int size, int nd, int half, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* vf = (const float*)v;
  float* of = (float*)out;
  if (C != 1 && C != 3) return (int)cudaErrorInvalidValue;
  if (variant == 0 || variant == 1) {
    const int threads = 256;
    long long want = (N + threads * 16 - 1) / (threads * 16);
    int gx = (int)(want < 1 ? 1 : (want > 1024 ? 1024 : want));
    size_t smem = (size_t)(variant ? threads / 32 : 1) * C * (n_shells + 1) * sizeof(float);
    auto kernel = variant ? first_design_kernel<true> : first_design_kernel<false>;
    kernel<<<dim3(gx, B), threads, smem, st>>>(vf, ld_b, C, N, (const int*)shell,
                                                (const float*)weight, n_shells, of);
    return (int)cudaGetLastError();
  }
  int e = 0;
  if (variant == 2 || variant == 3 || (variant >= 7 && variant <= 9)) {
    if (variant != 2 && (N % 4 || ld_b % 4)) return (int)cudaErrorInvalidValue;
#define ROWS(CC, V, U, M)                                                                    \
  e = launch_rows_as<CC, V, U, M>(vf, ld_b, B, N, (const int*)shell, (const float*)weight,  \
                                  n_shells, chunks, of, (long long)C * n_shells, st)
#define ROWS_C(V, U, M) if (C == 1) ROWS(1, V, U, M); else ROWS(3, V, U, M)
    switch (variant) {
      case 2: ROWS_C(1, 2, false); break;
      case 3: ROWS_C(4, 1, false); break;
      case 7: ROWS_C(4, 1, true); break;
      case 8: ROWS_C(4, 2, true); break;
      default: ROWS_C(4, 2, false); break;
    }
#undef ROWS_C
#undef ROWS
  } else if (variant >= 4 && variant <= 6) {
#define GRID(CC, U)                                                                          \
  e = launch_grid<CC, FieldLoader<CC>, U>(FieldLoader<CC>{vf, ld_b, N}, B, size, nd, half,  \
                                          n_shells, of, (long long)C * n_shells, st)
    if (C == 1) {
      if (variant == 4) GRID(1, 4); else if (variant == 5) GRID(1, 1); else GRID(1, 2);
    } else {
      if (variant == 4) GRID(3, 4); else if (variant == 5) GRID(3, 1); else GRID(3, 2);
    }
#undef GRID
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return e ? e : (int)cudaGetLastError();
}
