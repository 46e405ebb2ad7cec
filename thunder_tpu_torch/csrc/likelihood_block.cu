// HK2 likelihood_block: the likelihood epilogue with a streaming
// log-sum-exp, one image per CTA.
//
// Replaces (thunder_tpu): the scan_block body of
// optimiser._global_search after its two matmuls (max, baseline
// rescale, exp, the wC / wR / wT marginals) and the max / exp /
// marginal lines of optimiser._phase_body.
//
// For image l, with the (R x T) pose block in shared memory:
//   dvp[r, t] = a[l] + B[l, r] + C[l, r, t]
//   new_base  = max(base[l], max dvp);  scale = exp(base - new_base)
//               (0 when base is -inf: the first block)
//   w         = exp(dvp - new_base)
//   acc_c[l]            = acc_c[l] * scale + sum_{r,t} w
//   acc_r[l, col0 + r]  = acc_r * scale + sum_t w[r, t] w_t[l, t]
//   acc_r[l, 0:col0]   *= scale          (earlier rotation blocks)
//   acc_t[l, t]         = acc_t * scale + sum_r w[r, t] w_r[l, r]
//   base[l]             = new_base
// B, C, w_r, w_t are read through explicit strides, so the global
// search (rotation block shared by all images, prior weights of 1:
// stride 0) and the phase loop (per-image supports and priors) use the
// same kernel.
//
// What bounds it on Hopper: reading C (L*R*T floats) once from device
// memory; the exp and the two reductions run from shared memory.  The
// matmuls producing B and C stay torch.matmul in float32; fusing them
// in so (L, R, T) never reaches device memory is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// block-wide reduction through a 32-float scratch; every thread gets
// the result
template <bool IS_MAX>
__device__ float block_reduce(float v, float* scratch) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n_warp = (blockDim.x + 31) >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = (lane < n_warp) ? scratch[lane] : (IS_MAX ? -INFINITY : 0.f);
  r = IS_MAX ? warp_max(r) : warp_sum(r);
  return r;
}

__global__ void likelihood_block_kernel(
    const float* __restrict__ a, const float* __restrict__ B, long long b_sl,
    long long b_sr, const float* __restrict__ C, long long c_sl,
    long long c_sr, long long c_st, const float* __restrict__ w_r,
    long long wr_sl, long long wr_sr, const float* __restrict__ w_t,
    long long wt_sl, long long wt_st, int R, int T, float* base,
    float* acc_c, float* acc_r, long long accr_sl, int col0, float* acc_t) {
  extern __shared__ float smem[];
  float* w = smem;                 // R * T
  float* scratch = smem + R * T;   // 32
  const long long l = blockIdx.x;
  const int n = R * T;

  float al = a[l];
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r = i / T, t = i - r * T;
    float v = al + B[l * b_sl + r * b_sr] + C[l * c_sl + r * c_sr + t * c_st];
    w[i] = v;
    m = fmaxf(m, v);
  }
  m = block_reduce<true>(m, scratch);

  float b_in = base[l];
  float nb = fmaxf(b_in, m);
  float scale = isfinite(b_in) ? expf(b_in - nb) : 0.f;

  float part = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float e = expf(w[i] - nb);
    w[i] = e;
    part += e;
  }
  __syncthreads();
  float tot = block_reduce<false>(part, scratch);

  // u_r: one thread per rotation, sum over translations
  float* row = acc_r + l * accr_sl;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += w[r * T + t] * w_t[l * wt_sl + t * wt_st];
    float* dst = row + col0 + r;
    *dst = (scale == 0.f) ? s : (*dst) * scale + s;
  }
  // earlier rotation blocks of this image's row
  if (scale != 1.f) {
    for (int j = threadIdx.x; j < col0; j += blockDim.x)
      row[j] = (scale == 0.f) ? 0.f : row[j] * scale;
  }
  // u_t: one warp per translation, lanes over rotations
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n_warp = blockDim.x >> 5;
  for (int t = warp; t < T; t += n_warp) {
    float s = 0.f;
    for (int r = lane; r < R; r += 32) s += w[r * T + t] * w_r[l * wr_sl + r * wr_sr];
    s = warp_sum(s);
    if (lane == 0) {
      float* dst = acc_t + l * T + t;
      *dst = (scale == 0.f) ? s : (*dst) * scale + s;
    }
  }
  if (threadIdx.x == 0) {
    acc_c[l] = (scale == 0.f) ? tot : acc_c[l] * scale + tot;
    base[l] = nb;
  }
}

}  // namespace

extern "C" int thunder_likelihood_block(
    const void* a, const void* B, long long b_sl, long long b_sr,
    const void* C, long long c_sl, long long c_sr, long long c_st,
    const void* w_r, long long wr_sl, long long wr_sr, const void* w_t,
    long long wt_sl, long long wt_st, int n_img, int R, int T, void* base,
    void* acc_c, void* acc_r, long long accr_sl, int col0, void* acc_t,
    void* stream) {
  size_t smem = (size_t)(R * T + 32) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        likelihood_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_img > 0) {
    likelihood_block_kernel<<<n_img, 256, smem, (cudaStream_t)stream>>>(
        (const float*)a, (const float*)B, b_sl, b_sr, (const float*)C, c_sl,
        c_sr, c_st, (const float*)w_r, wr_sl, wr_sr, (const float*)w_t, wt_sl,
        wt_st, R, T, (float*)base, (float*)acc_c, (float*)acc_r, accr_sl, col0,
        (float*)acc_t);
  }
  return (int)cudaGetLastError();
}
