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
// What bounds it on Hopper: one read of the C fields (memory bound);
// a scatter-add straight to device memory would serialise on the few
// hot shell addresses.  Each block therefore builds a private
// C x (n_shells + 1) histogram in shared memory (shared atomics), then
// adds it with one global atomicAdd per non-empty bin.  The order of
// the global adds differs from run to run.

#include <cuda_runtime.h>

namespace {

__global__ void shell_sums_kernel(const float* __restrict__ v, long long ld_b,
                                  int C, long long N,
                                  const int* __restrict__ shell,
                                  const float* __restrict__ weight,
                                  int n_shells, float* __restrict__ out) {
  extern __shared__ float hist[];
  const int nb = n_shells + 1;
  const int b = blockIdx.y;
  for (int j = threadIdx.x; j < C * nb; j += blockDim.x) hist[j] = 0.f;
  __syncthreads();

  const float* vb = v + b * ld_b;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += stride) {
    float wt = weight ? weight[i] : 1.f;
    if (wt == 0.f) continue;
    int s = min(shell[i], n_shells);
    for (int c = 0; c < C; ++c)
      atomicAdd(&hist[c * nb + s], vb[c * N + i] * wt);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C * nb; j += blockDim.x) {
    int c = j / nb, s = j - c * nb;
    float h = hist[j];
    if (s < n_shells && h != 0.f)
      atomicAdd(out + ((long long)b * C + c) * n_shells + s, h);
  }
}

}  // namespace

// v: (B, C, N) with batch stride ld_b (C * N when contiguous); out:
// (B, C, n_shells), zero-filled by the caller.
extern "C" int thunder_shell_sums(const void* v, long long ld_b, int B, int C,
                                  long long N, const void* shell,
                                  const void* weight, int n_shells, void* out,
                                  void* stream) {
  const int threads = 256;
  long long want = (N + threads * 16 - 1) / (threads * 16);
  int gx = (int)(want < 1 ? 1 : (want > 1024 ? 1024 : want));
  size_t smem = (size_t)C * (n_shells + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shell_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0 && N > 0) {
    dim3 grid(gx, B);
    shell_sums_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const float*)v, ld_b, C, N, (const int*)shell, (const float*)weight,
        n_shells, (float*)out);
  }
  return (int)cudaGetLastError();
}
