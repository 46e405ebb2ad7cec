// HK2 likelihood_block: the whole likelihood of one (R x T) pose block
// per (image, class) — its two contractions and the streaming
// log-sum-exp epilogue — in one kernel, all classes in one launch.
//
// Replaces (thunder_tpu): the scan_block body of
// optimiser._global_search (the B and C einsums of ops/likelihood.py
// log_dvp_block, then max, baseline rescale, exp and the wC / wR / wT
// marginals) and the log_dvp_local / max / exp / marginal lines of
// optimiser._phase_body.
//
// For image l and class k (CTA (l, k)), with s = sigRcp folded into the
// inputs by the caller:
//   B[r]     = sum_p sctf2[l, p] |pri[k, l, r, p]|^2
//   C[r, t]  = -2 Re sum_p dat_w[l, p] conj(tra[l, t, p]) conj(pri[k, l, r, p])
//   dvp      = (a[l] + B[r]) + C[r, t]
//   new_base = max(base[k, l], max dvp);  scale = exp(base - new_base)
//              (0 when base is -inf: the first block)
//   w        = exp(dvp - new_base)
//   acc_c[k, l]           = acc_c * scale + sum_{r,t} w
//   acc_r[k, l, col0 + r] = sum_t w[r, t] w_t[l, t]   (this block's columns)
//   acc_r[k, l, 0:col0]  *= scale          (earlier rotation blocks)
//   acc_t[k, l, t]        = acc_t * scale + sum_r w[r, t] w_r[l, r]
//   base[k, l]            = new_base
// Every input is read through explicit strides; a stride of 0 shares:
// global search passes one rotation block per class for all images
// (pri image stride 0), shared translations (tra image stride 0) and
// priors of 1; the phase loop passes per-image supports (K = 1).
//
// What bounds it on Hopper: fp32 FMAs.  C is a product of depth 2P per
// image (X = dat_w conj(tra), T x 2P, against pri, R x 2P): at the 2D
// global block (R = 100, T = 151, 2P = 80) ~1.2 M FMAs per (l, k) on
// ~80 KB of inputs that sit in L2 (pri shared by the images of a class,
// tra by all).  The design keeps C and X out of device memory (the
// previous matmul + epilogue pair wrote C, 302 MB at that shape, and
// read it back uncoalesced) and replaces the per-class launches by one
// grid of (image, class).  The CTA walks p in chunks of QC complex
// pixels: cp.async stages the pri and tra chunks (transposed, p-major)
// into a double buffer, X is formed in place in shared memory, and each
// thread accumulates a TM x TN register tile of C with FFMAs (its rows
// t = tt + i n_tt and columns r = rt + j n_rt interleaved, so a warp's
// shared loads fall on neighbouring words; one tile a thread covers the
// block).  The epilogue stays in registers: dvp, the block max, exp and
// the tile's partial marginals, summed over tiles through shared
// memory.  Where even 8 x 8 tiles of MAX_THREADS threads do not cover R
// x T (R = 256 rotations with T > 64), the CTA takes the rotations in
// sub-blocks of n_rt TN, each one step of the streaming log-sum-exp
// above (col0 advancing), so a global-search block keeps its 256
// rotations.  Full fp32, no tensor cores (TF32 would not hold the
// tolerance; wgmma tiling is later work).

#include <cuda_runtime.h>
#include <math.h>

namespace {

// complex pixels per staged chunk: 20 covers the 2D search band at
// r = 5 (P = 40) in two chunks, where 16 or 24 would stage a padded third
// (ops/likelihood.py reads QC and MAX_THREADS from this file for its
// launch plan)
constexpr int QC = 20;
constexpr int MAX_THREADS = 256;

// Mirrors ops/likelihood.py _LkArgs (field order and types).
struct LkArgs {
  const float2* dat_w; long long dw_sl;
  const float* sctf2; long long s2_sl;
  const float* a;
  const float2* pri; long long pri_sk, pri_sl, pri_sr;
  const float2* tra; long long tra_sl, tra_st;
  const float* w_r; long long wr_sl, wr_sr;
  const float* w_t; long long wt_sl, wt_st;
  float* base; float* acc_c; long long st_sk, st_sl;
  float* acc_r; long long accr_sk, accr_sl;
  float* acc_t; long long acct_sk, acct_sl;
  int L, K, R, T, P, col0, n_tt, n_rt;
};

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = valid ? 8 : 0;   // 0: zero-fill
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// block-wide reduction through a 32-float scratch; every thread gets
// the result (blockDim a multiple of 32)
template <bool IS_MAX>
__device__ float block_reduce(float v, float* scratch) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n_warp = blockDim.x >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = (lane < n_warp) ? scratch[lane] : (IS_MAX ? -INFINITY : 0.f);
  r = IS_MAX ? warp_max(r) : warp_sum(r);
  return r;
}

template <int TM, int TN>
__global__ void __launch_bounds__(MAX_THREADS) likelihood_block_kernel(const LkArgs g) {
  extern __shared__ __align__(16) float smem[];
  const int l = blockIdx.x, k = blockIdx.y;
  const int T = g.T, P = g.P, n_tt = g.n_tt, n_rt = g.n_rt;
  const int Rp = n_rt * TN, Tp = n_tt * TM;   // Rp: the rotations of a sub-block
  const int tid = threadIdx.x, nthr = blockDim.x;

  // [B: Rp rounded to 4][scratch: 32][2 staging buffers, then the
  // epilogue's partial sums]
  float* Bs = smem;
  float* scratch = smem + ((Rp + 3) & ~3);
  float2* stage = reinterpret_cast<float2*>(scratch + 32);
  const int buf = QC * (Rp + Tp) + QC + QC / 2;   // float2 per buffer

  const float2* dw = g.dat_w + (long long)l * g.dw_sl;
  const float* s2 = g.sctf2 + (long long)l * g.s2_sl;
  const float2* priK = g.pri + (long long)k * g.pri_sk + (long long)l * g.pri_sl;
  const float2* traL = g.tra + (long long)l * g.tra_sl;
  const float al = g.a[l];
  const float* wt = g.w_t + l * g.wt_sl;
  float* base = g.base + k * g.st_sk + l * g.st_sl;
  float* acc_c = g.acc_c + k * g.st_sk + l * g.st_sl;
  float* row = g.acc_r + k * g.accr_sk + l * g.accr_sl;
  float* at = g.acc_t + k * g.acct_sk + l * g.acct_sl;
  const int nch = (P + QC - 1) / QC;

  // this thread's tile: rows t = tt + i n_tt, columns r = rt + j n_rt
  const bool active = tid < n_tt * n_rt;
  const int tt = active ? tid / n_rt : 0, rt = active ? tid - tt * n_rt : 0;

  // the block's rotations in sub-blocks of Rp, each a streaming step
  for (int r0 = 0; r0 < g.R; r0 += Rp) {
    const int R = min(Rp, g.R - r0), col0 = g.col0 + r0;
    const float2* priL = priK + (long long)r0 * g.pri_sr;
    const float* wr = g.w_r + l * g.wr_sl + (long long)r0 * g.wr_sr;
    __syncthreads();   // the previous sub-block's epilogue is done with smem, base and row
    for (int r = tid; r < Rp; r += nthr) Bs[r] = 0.f;

    // chunk c of pri, tra, dat_w and sctf2 into buffer b, p-major and
    // zero-filled past R, T and P
    auto stage_chunk = [&](int c, int b) {
      float2* Ps = stage + b * buf;
      float2* Xs = Ps + QC * Rp;
      float2* Dw = Xs + QC * Tp;
      float* S2 = reinterpret_cast<float*>(Dw + QC);
      const int p0 = c * QC;
      for (int i = tid; i < QC * Rp; i += nthr) {
        int r = i / QC, q = i - r * QC, p = p0 + q;
        bool ok = r < R && p < P;
        cp_async8(Ps + q * Rp + r, ok ? priL + r * g.pri_sr + p : priL, ok);
      }
      for (int i = tid; i < QC * Tp; i += nthr) {
        int t = i / QC, q = i - t * QC, p = p0 + q;
        bool ok = t < T && p < P;
        cp_async8(Xs + q * Tp + t, ok ? traL + t * g.tra_st + p : traL, ok);
      }
      if (tid < QC) {
        bool ok = p0 + tid < P;
        cp_async8(Dw + tid, ok ? dw + p0 + tid : dw, ok);
        cp_async4(S2 + tid, ok ? s2 + p0 + tid : s2, ok);
      }
    };

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    stage_chunk(0, 0);
    cp_commit();
    for (int c = 0; c < nch; ++c) {
      const int b = c & 1;
      if (c + 1 < nch) {
        stage_chunk(c + 1, b ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      float2* Ps = stage + b * buf;
      float2* Xs = Ps + QC * Rp;
      const float2* Dw = Xs + QC * Tp;
      const float* S2 = reinterpret_cast<const float*>(Dw + QC);
      // X = dat_w conj(tra), in place
      for (int q = 0; q < QC; ++q) {
        const float2 d = Dw[q];
        for (int t = tid; t < Tp; t += nthr) {
          float2 x = Xs[q * Tp + t];
          Xs[q * Tp + t] = make_float2(d.x * x.x + d.y * x.y, d.y * x.x - d.x * x.y);
        }
      }
      for (int r = tid; r < R; r += nthr) {
        float s = Bs[r];
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          float2 v = Ps[q * Rp + r];
          s += S2[q] * (v.x * v.x + v.y * v.y);
        }
        Bs[r] = s;
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          float2 xv[TM], pv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) xv[i] = Xs[q * Tp + tt + i * n_tt];
#pragma unroll
          for (int j = 0; j < TN; ++j) pv[j] = Ps[q * Rp + rt + j * n_rt];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              acc[i][j] = fmaf(xv[i].x, pv[j].x, acc[i][j]);
              acc[i][j] = fmaf(xv[i].y, pv[j].y, acc[i][j]);
            }
        }
      }
      __syncthreads();
    }

    // epilogue in registers: dvp, the block max, exp and this tile's
    // partial marginals, then one sum over the tiles of a row / column
    float lmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        int t = tt + i * n_tt, r = rt + j * n_rt;
        bool ok = active && t < T && r < R;
        acc[i][j] = ok ? (al + Bs[r]) + (-2.f * acc[i][j]) : -INFINITY;
        lmax = fmaxf(lmax, acc[i][j]);
      }
    const float m = block_reduce<true>(lmax, scratch);
    const float b_in = *base;
    const float nb = fmaxf(b_in, m);
    const float scale = isfinite(b_in) ? expf(b_in - nb) : 0.f;

    float* PR = reinterpret_cast<float*>(stage);    // n_tt x Rp partial u_r
    float* PT = PR + n_tt * Rp;                    // n_rt x Tp partial u_t
    float part = 0.f;
    if (active) {
      float wti[TM], wrj[TN], pr[TN], pt[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        int t = tt + i * n_tt;
        wti[i] = t < T ? wt[t * g.wt_st] : 0.f;
        pt[i] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        int r = rt + j * n_rt;
        wrj[j] = r < R ? wr[r * g.wr_sr] : 0.f;
        pr[j] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float e = expf(acc[i][j] - nb);   // 0 outside the block
          part += e;
          pr[j] = fmaf(e, wti[i], pr[j]);
          pt[i] = fmaf(e, wrj[j], pt[i]);
        }
#pragma unroll
      for (int j = 0; j < TN; ++j) PR[tt * Rp + rt + j * n_rt] = pr[j];
#pragma unroll
      for (int i = 0; i < TM; ++i) PT[rt * Tp + tt + i * n_tt] = pt[i];
    }
    const float tot = block_reduce<false>(part, scratch);   // its barrier publishes PR, PT

    for (int r = tid; r < R; r += nthr) {
      float s = 0.f;
      for (int u = 0; u < n_tt; ++u) s += PR[u * Rp + r];
      row[col0 + r] = s;
    }
    // earlier rotation blocks (and sub-blocks) of this image's row
    if (scale != 1.f) {
      for (int j = tid; j < col0; j += nthr) row[j] = (scale == 0.f) ? 0.f : row[j] * scale;
    }
    for (int t = tid; t < T; t += nthr) {
      float s = 0.f;
      for (int u = 0; u < n_rt; ++u) s += PT[u * Tp + t];
      at[t] = (scale == 0.f) ? s : at[t] * scale + s;
    }
    if (tid == 0) {
      *acc_c = (scale == 0.f) ? tot : (*acc_c) * scale + tot;
      *base = nb;
    }
  }
}

template <int TM, int TN>
int launch(const LkArgs& g, int threads, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(likelihood_block_kernel<TM, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  likelihood_block_kernel<TM, TN><<<dim3(g.L, g.K), threads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over a grid of (L images, K classes); the register tile
// (tm, tn), the thread count and the shared-memory bytes come from the
// wrapper's launch plan (ops/likelihood.py likelihood_plan).
extern "C" int thunder_likelihood_block(const void* args, int tm, int tn, int threads,
                                        int smem, void* stream) {
  const LkArgs& g = *static_cast<const LkArgs*>(args);
  if (threads > MAX_THREADS || threads < g.n_tt * g.n_rt) return (int)cudaErrorInvalidValue;
  if (g.L <= 0 || g.K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (tm == 1 && tn == 1) return launch<1, 1>(g, threads, smem, s);
  if (tm == 2 && tn == 2) return launch<2, 2>(g, threads, smem, s);
  if (tm == 2 && tn == 4) return launch<2, 4>(g, threads, smem, s);
  if (tm == 4 && tn == 4) return launch<4, 4>(g, threads, smem, s);
  if (tm == 4 && tn == 8) return launch<4, 8>(g, threads, smem, s);
  if (tm == 8 && tn == 8) return launch<8, 8>(g, threads, smem, s);
  return (int)cudaErrorInvalidValue;
}
