// HK8 likelihood_local_ctf: the local-search likelihood with a defocus
// axis and its three marginals, one block an image.
//
// Replaces (thunder_tpu): ops/likelihood.py log_dvp_local_ctf with
// physics/ctf.py ctf_packed_scaled and the max / exp / einsum marginals
// of optimiser._phase_body_ctf (XLA einsums over an (l, d, r, t) tensor).
//
// For image l, with s = sigRcp, x[t,p] = dat_s[p] conj(tra[t,p]) and
// ctf[d,p] the image's CTF with its defocus scaled by dfac[l,d]:
//   B[d,r]     = sum_p s[p] ctf[d,p]^2 |pri[r,p]|^2
//   C[d,r,t]   = -2 sum_p ctf[d,p] Re(x[t,p] conj(pri[r,p]))
//   dvp[d,r,t] = a + B[d,r] + C[d,r,t];  w = exp(dvp - max dvp)
//   u_r[r] = sum_{d,t} w w_t[t] w_d[d];  u_t[t] = sum_{d,r} w w_r[r] w_d[d]
//   u_d[d] = sum_{r,t} w w_r[r] w_t[t]
// The (d, r, t) block of an image lives in shared memory and never
// reaches device memory; the CTF of each defocus factor is formed here,
// PC pixels at a time, in ctf_packed_scaled's order of operations.
//
// What bounds it on Hopper: fp32 operations.  Re(x conj(pri)) does not
// depend on d, so a thread's register tile of TR rotations x TT
// translations x TD defocus factors forms it once a pixel (2 TR TT
// multiply-adds) and spends TR TT TD multiply-adds on the defocus axis:
// (2 + D) multiply-adds a (r, t, pixel) where the einsum spends 2 D.  A
// block stages PC pixels of pri (pixel-major, so that a thread's two
// rotations are one 16-byte load and a warp's loads are conflict-free),
// of x and of the CTFs, and its threads walk the tiles (item = (t tile,
// d tile, rotation pair), rotation pairs fastest, so x and ctf loads are
// broadcasts).  A simple tile: 8 shared loads feed 30 multiply-adds a
// pixel, which leaves the kernel near shared memory's rate, not the
// fp32 rate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PC = 32;   // pixels staged at a time
constexpr int TR = 2;    // rotations a tile
constexpr int TT = 3;    // translations a tile
constexpr int TD = 3;    // defocus factors a tile

struct LcArgs {
  const float2* dat_s;   // (L, P)
  const float* s_pack;   // (L, P)
  const float* ctfk;     // (L, 8): k1, k2, w1, w2, dU, dV, theta, phase shift
  const float* f2;       // (P,)  fx^2 + fy^2 of each pixel
  const float* ang;      // (P,)  atan2(row, col) of each pixel
  const float* dfac;     // (L, D)
  const float2* pri;     // (L, R, P)
  const float2* tra;     // (L, T, P)
  const float* a;        // (L,)
  const float* w_r;      // (L, R)
  const float* w_t;      // (L, T)
  const float* w_d;      // (L, D)
  float* u_r;            // (L, R)
  float* u_t;            // (L, T)
  float* u_d;            // (L, D)
  int L, D, R, T, P;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void likelihood_local_ctf_kernel(LcArgs g) {
  extern __shared__ float4 smem4[];
  const int D = g.D, R = g.R, T = g.T, P = g.P;
  const int nDT = (D + TD - 1) / TD, nTT = (T + TT - 1) / TT, nR2 = (R + TR - 1) / TR;
  const int D3 = nDT * TD, T3 = nTT * TT, R2 = nR2 * TR;
  float* pri_s = (float*)smem4;              // [PC][R2] float2
  float* x_s = pri_s + 2 * PC * R2;          // [T3][PC] float2
  float* ctf_s = x_s + 2 * T3 * PC;          // [D3][PC]
  float* s_s = ctf_s + D3 * PC;              // [PC]
  float* dvp = s_s + PC;                     // [D3][T3][R2]
  float* bsum = dvp + D3 * T3 * R2;          // [D3][R2]
  float* rows = bsum + D3 * R2;              // [D3][T3]
  float* red = rows + D3 * T3;               // [32]

  const int l = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const float2* dat = g.dat_s + (long long)l * P;
  const float* sp = g.s_pack + (long long)l * P;
  const float2* pri = g.pri + (long long)l * R * P;
  const float2* tra = g.tra + (long long)l * T * P;
  const float* k = g.ctfk + (long long)l * 8;
  const float* dfac = g.dfac + (long long)l * D;

  for (int i = tid; i < D3 * T3 * R2 + D3 * R2; i += nth) dvp[i] = 0.f;

  const int n_items = nTT * nDT * nR2;
  for (int p0 = 0; p0 < P; p0 += PC) {
    __syncthreads();
    for (int i = tid; i < PC * R2; i += nth) {
      int r = i / PC, p = i % PC;
      float2 v = make_float2(0.f, 0.f);
      if (r < R && p0 + p < P) v = pri[(long long)r * P + p0 + p];
      ((float2*)pri_s)[p * R2 + r] = v;
    }
    for (int i = tid; i < T3 * PC; i += nth) {
      int t = i / PC, p = i % PC;
      float2 v = make_float2(0.f, 0.f);
      if (t < T && p0 + p < P) {
        float2 d = dat[p0 + p], q = tra[(long long)t * P + p0 + p];
        v = make_float2(d.x * q.x + d.y * q.y, d.y * q.x - d.x * q.y);
      }
      ((float2*)x_s)[i] = v;
    }
    for (int i = tid; i < D3 * PC; i += nth) {
      int d = i / PC, p = i % PC;
      float c = 0.f;
      if (d < D && p0 + p < P) {
        float f2 = g.f2[p0 + p], du = k[4], dv = k[5];
        float defocus = -(du + dv + (du - dv) * cosf(2.f * (g.ang[p0 + p] - k[6]))) / 2.f;
        float chi = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(k[0], defocus), dfac[d]), f2),
                              __fmul_rn(__fmul_rn(k[1], f2), f2)) - k[7];
        c = -k[2] * sinf(chi) + k[3] * cosf(chi);
      }
      ctf_s[i] = c;
    }
    if (tid < PC) s_s[tid] = p0 + tid < P ? sp[p0 + tid] : 0.f;
    __syncthreads();

    for (int item = tid; item < n_items; item += nth) {
      int r2 = item % nR2, rest = item / nR2;
      int dt = rest % nDT, tt = rest / nDT;
      float acc[TR][TD][TT], accb[TR][TD];
#pragma unroll
      for (int rr = 0; rr < TR; ++rr)
#pragma unroll
        for (int kk = 0; kk < TD; ++kk) {
          accb[rr][kk] = 0.f;
#pragma unroll
          for (int j = 0; j < TT; ++j) acc[rr][kk][j] = 0.f;
        }
      const float4* prow = (const float4*)pri_s + r2;
      const float2* xrow = (const float2*)x_s + tt * TT * PC;
      const float* crow = ctf_s + dt * TD * PC;
#pragma unroll 4
      for (int p = 0; p < PC; ++p) {
        float4 pr = prow[p * nR2];
        float cs[TD], g0[TT], g1[TT];
#pragma unroll
        for (int kk = 0; kk < TD; ++kk) cs[kk] = crow[kk * PC + p];
#pragma unroll
        for (int j = 0; j < TT; ++j) {
          float2 x = xrow[j * PC + p];
          g0[j] = x.x * pr.x + x.y * pr.y;
          g1[j] = x.x * pr.z + x.y * pr.w;
        }
#pragma unroll
        for (int kk = 0; kk < TD; ++kk)
#pragma unroll
          for (int j = 0; j < TT; ++j) {
            acc[0][kk][j] += cs[kk] * g0[j];
            acc[1][kk][j] += cs[kk] * g1[j];
          }
        if (tt == 0) {
          float s = s_s[p];
          float m0 = s * (pr.x * pr.x + pr.y * pr.y), m1 = s * (pr.z * pr.z + pr.w * pr.w);
#pragma unroll
          for (int kk = 0; kk < TD; ++kk) {
            float c2 = cs[kk] * cs[kk];
            accb[0][kk] += c2 * m0;
            accb[1][kk] += c2 * m1;
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < TR; ++rr)
#pragma unroll
        for (int kk = 0; kk < TD; ++kk) {
          int d = dt * TD + kk, r = r2 * TR + rr;
          if (tt == 0) bsum[d * R2 + r] += accb[rr][kk];
#pragma unroll
          for (int j = 0; j < TT; ++j) dvp[(d * T3 + tt * TT + j) * R2 + r] += acc[rr][kk][j];
        }
    }
  }
  __syncthreads();

  // dvp = (a + B) + C over the valid (d, t, r); its maximum
  const float a = g.a[l];
  const int n_val = D * T * R;
  float m = -INFINITY;
  for (int i = tid; i < n_val; i += nth) {
    int r = i % R, t = (i / R) % T, d = i / (R * T);
    int at = (d * T3 + t) * R2 + r;
    float v = (a + bsum[d * R2 + r]) + (-2.f * dvp[at]);
    dvp[at] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  m = red[0];
  for (int i = 1; i < (nth + 31) / 32; ++i) m = fmaxf(m, red[i]);
  for (int i = tid; i < n_val; i += nth) {
    int r = i % R, t = (i / R) % T, d = i / (R * T);
    int at = (d * T3 + t) * R2 + r;
    dvp[at] = expf(dvp[at] - m);
  }
  __syncthreads();

  const float* w_r = g.w_r + (long long)l * R;
  const float* w_t = g.w_t + (long long)l * T;
  const float* w_d = g.w_d + (long long)l * D;
  for (int r = tid; r < R; r += nth) {
    float u = 0.f;
    for (int d = 0; d < D; ++d) {
      float ud = 0.f;
      for (int t = 0; t < T; ++t) ud += dvp[(d * T3 + t) * R2 + r] * w_t[t];
      u += ud * w_d[d];
    }
    g.u_r[(long long)l * R + r] = u;
  }
  // rows[d][t] = sum_r w[d][t][r] w_r[r], a warp a row
  for (int row = tid >> 5; row < D * T; row += nth >> 5) {
    int d = row / T, t = row % T;
    float u = 0.f;
    for (int r = tid & 31; r < R; r += 32) u += dvp[(d * T3 + t) * R2 + r] * w_r[r];
    u = warp_sum(u);
    if ((tid & 31) == 0) rows[d * T3 + t] = u;
  }
  __syncthreads();
  for (int t = tid; t < T; t += nth) {
    float u = 0.f;
    for (int d = 0; d < D; ++d) u += rows[d * T3 + t] * w_d[d];
    g.u_t[(long long)l * T + t] = u;
  }
  for (int d = tid; d < D; d += nth) {
    float u = 0.f;
    for (int t = 0; t < T; ++t) u += rows[d * T3 + t] * w_t[t];
    g.u_d[(long long)l * D + d] = u;
  }
}

}  // namespace

// args: an LcArgs of device pointers (every array contiguous); threads a
// multiple of 32; smem the dynamic shared memory of
// ops/likelihood.py likelihood_ctf_plan
extern "C" int thunder_likelihood_local_ctf(const void* args, int threads, int smem,
                                            void* stream) {
  const LcArgs* g = (const LcArgs*)args;
  if (g->L <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(likelihood_local_ctf_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  likelihood_local_ctf_kernel<<<(unsigned)g->L, threads, smem, (cudaStream_t)stream>>>(*g);
  return (int)cudaGetLastError();
}
