// The first design of likelihood_local_ctf.cu, kept as a candidate: micro/hk_candidates.py
// (--kernels hk7,hk8) times it beside the kernel in csrc/.  Not part of the
// kernel library.
//
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
extern "C" int cand_likelihood_local_ctf_first(const void* args, int threads, int smem,
                                            void* stream) {
  const LcArgs* g = (const LcArgs*)args;
  if (g->L <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(likelihood_local_ctf_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  likelihood_local_ctf_kernel<<<(unsigned)g->L, threads, smem, (cudaStream_t)stream>>>(*g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Candidate: C as a tensor-core product, (R x 2P) by (2P x D T), mma.sync
// m16n8k8 in TF32, with each operand split a = hi + lo (hi = tf32(a), lo =
// tf32(a - hi)) and hi.hi + hi.lo + lo.hi summed (3xTF32; `split` = 1
// takes hi.hi alone, plain TF32, so that its error can be printed).  The
// CTF is folded into the second operand as it is staged: B[(d, t)][k] =
// ctf[d, p] x_re[t, p] for k = p, ctf[d, p] x_im[t, p] for k = P_c + p.
// A block an image, 8 warps, a warp a 16-rotation m tile and every (d, t)
// column (R <= 128).  B and the epilogue as in csrc/likelihood_local_ctf.cu;
// staging is synchronous.  It spends 2 D / (2 + D) times the register
// form's products, three times over for the split.

namespace tf32cand {

constexpr int KC = 32;    // pixels a chunk: K = 64 (re, im)
constexpr int KP = 68;    // padded row of an operand in shared memory (conflict-free fragments)

struct Args {
  const float2* dat_s; const float* s_pack; const float* ctfk; const float* f2;
  const float* ang; const float* dfac; const float2* pri; const float2* tra; const float* a;
  const float* w_r; const float* w_t; const float* w_d; float* u_r; float* u_t; float* u_d;
  int L, D, R, T, P;
};

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int MAX_NT = 11;   // n tiles of 8 columns: D T <= 88

__device__ __forceinline__ void split_store(unsigned* hi, unsigned* lo, float v) {
  unsigned h = to_tf32(v);
  *hi = h;
  *lo = to_tf32(v - __uint_as_float(h));
}

__global__ void __launch_bounds__(256, 1) kernel(Args g, int split) {
  extern __shared__ float4 smem4[];
  const int D = g.D, R = g.R, T = g.T, P = g.P, DT = D * T;
  const int R16 = 128, N8 = MAX_NT * 8;
  float* ck = (float*)smem4;
  float* dfac_s = ck + 8;
  unsigned* a_hi = (unsigned*)(ck + ((8 + D + 3) & ~3));   // [R16][KP]
  unsigned* a_lo = a_hi + R16 * KP;
  unsigned* b_hi = a_lo + R16 * KP;                         // [N8][KP]
  unsigned* b_lo = b_hi + N8 * KP;
  float* x_s = (float*)(b_lo + N8 * KP);                    // [T][KC] float2
  float* ctf_s = x_s + 2 * T * KC;                          // [D][KC]
  float* sc2_s = ctf_s + D * KC;                            // [D][KC]
  float* h_s = sc2_s + D * KC;                              // [R16][KC] |pri|^2
  float* bsum = h_s + R16 * KC;                             // [D][R16]
  float* dvp = (float*)a_hi;                                // after the loop: [D][T][R16]
  float* rows = bsum + D * R16;                             // [D][T]
  float* red = rows + D * T;                                // [32]

  const int l = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, w = tid >> 5, gid = lane >> 2, tig = lane & 3;
  const float2* dat = g.dat_s + (long long)l * P;
  const float* sp = g.s_pack + (long long)l * P;
  const float2* pri = g.pri + (long long)l * R * P;
  const float2* tra = g.tra + (long long)l * T * P;
  if (tid < 8) ck[tid] = g.ctfk[(long long)l * 8 + tid];
  for (int i = tid; i < D; i += nth) dfac_s[i] = g.dfac[(long long)l * D + i];
  for (int i = tid; i < D * R16; i += nth) bsum[i] = 0.f;
  float acc[MAX_NT][4];
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  for (int p0 = 0; p0 < P; p0 += KC) {
    __syncthreads();
    for (int i = tid; i < R16 * KC; i += nth) {
      int r = i / KC, p = i % KC;
      float2 v = make_float2(0.f, 0.f);
      if (r < R && p0 + p < P) v = pri[(long long)r * P + p0 + p];
      split_store(a_hi + r * KP + p, a_lo + r * KP + p, v.x);
      split_store(a_hi + r * KP + KC + p, a_lo + r * KP + KC + p, v.y);
      h_s[i] = v.x * v.x + v.y * v.y;
    }
    for (int i = tid; i < T * KC; i += nth) {
      int t = i / KC, p = i % KC;
      float2 v = make_float2(0.f, 0.f);
      if (p0 + p < P) {
        float2 d = dat[p0 + p], q = tra[(long long)t * P + p0 + p];
        v = make_float2(d.x * q.x + d.y * q.y, d.y * q.x - d.x * q.y);
      }
      ((float2*)x_s)[i] = v;
    }
    for (int i = tid; i < D * KC; i += nth) {
      int d = i / KC, p = i % KC;
      float c = 0.f, s = 0.f;
      if (p0 + p < P) {
        float f2 = g.f2[p0 + p], du = ck[4], dv = ck[5];
        float defocus = -(du + dv + (du - dv) * cosf(2.f * (g.ang[p0 + p] - ck[6]))) / 2.f;
        float chi = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(ck[0], defocus), dfac_s[d]), f2),
                              __fmul_rn(__fmul_rn(ck[1], f2), f2)) - ck[7];
        c = -ck[2] * sinf(chi) + ck[3] * cosf(chi);
        s = sp[p0 + p];
      }
      ctf_s[i] = c;
      sc2_s[i] = s * c * c;
    }
    __syncthreads();
    for (int i = tid; i < N8 * KC; i += nth) {
      int n = i / KC, p = i % KC;
      float2 x = make_float2(0.f, 0.f);
      float c = 0.f;
      if (n < DT) {
        x = ((const float2*)x_s)[(n % T) * KC + p];
        c = ctf_s[(n / T) * KC + p];
      }
      split_store(b_hi + n * KP + p, b_lo + n * KP + p, c * x.x);
      split_store(b_hi + n * KP + KC + p, b_lo + n * KP + KC + p, c * x.y);
    }
    for (int i = tid; i < D * R; i += nth) {   // B, a (d, r) a thread
      int d = i / R, r = i % R;
      float u = 0.f;
      for (int p = 0; p < KC; ++p) u += sc2_s[d * KC + p] * h_s[r * KC + p];
      bsum[d * R16 + r] += u;
    }
    __syncthreads();
    const int m0 = w * 16;
#pragma unroll
    for (int ks = 0; ks < 2 * KC; ks += 8) {
      unsigned ah[4], al[4];
      const int ra = (m0 + gid) * KP + ks + tig, rb = (m0 + gid + 8) * KP + ks + tig;
      ah[0] = a_hi[ra]; ah[1] = a_hi[rb]; ah[2] = a_hi[ra + 4]; ah[3] = a_hi[rb + 4];
      al[0] = a_lo[ra]; al[1] = a_lo[rb]; al[2] = a_lo[ra + 4]; al[3] = a_lo[rb + 4];
#pragma unroll
      for (int j = 0; j < MAX_NT; ++j) {
        const int nb = (j * 8 + gid) * KP + ks + tig;
        unsigned bh0 = b_hi[nb], bh1 = b_hi[nb + 4];
        if (split == 3) {
          mma(acc[j], al, bh0, bh1);
          mma(acc[j], ah, b_lo[nb], b_lo[nb + 4]);
        }
        mma(acc[j], ah, bh0, bh1);
      }
    }
  }
  __syncthreads();
  // C fragments: c0 = (m0 + gid, 2 tig), c1 = (m0 + gid, 2 tig + 1), c2, c3 at row + 8
#pragma unroll
  for (int j = 0; j < MAX_NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int r = w * 16 + gid + (q >> 1) * 8, n = j * 8 + 2 * tig + (q & 1);
      if (n < DT) dvp[((n / T) * T + n % T) * R16 + r] = acc[j][q];
    }
  __syncthreads();

  const float a = g.a[l];
  const int n_val = D * T * R;
  float m = -INFINITY;
  for (int i = tid; i < n_val; i += nth) {
    int r = i % R, t = (i / R) % T, d = i / (R * T);
    int at = (d * T + t) * R16 + r;
    float v = (a + bsum[d * R16 + r]) + (-2.f * dvp[at]);
    dvp[at] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  if (lane == 0) red[w] = m;
  __syncthreads();
  m = red[0];
  for (int i = 1; i < nth / 32; ++i) m = fmaxf(m, red[i]);
  for (int i = tid; i < n_val; i += nth) {
    int r = i % R, t = (i / R) % T, d = i / (R * T);
    int at = (d * T + t) * R16 + r;
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
      for (int t = 0; t < T; ++t) ud += dvp[(d * T + t) * R16 + r] * w_t[t];
      u += ud * w_d[d];
    }
    g.u_r[(long long)l * R + r] = u;
  }
  for (int row = w; row < D * T; row += nth >> 5) {
    int d = row / T, t = row % T;
    float u = 0.f;
    for (int r = lane; r < R; r += 32) u += dvp[(d * T + t) * R16 + r] * w_r[r];
    u = warp_sum(u);
    if (lane == 0) rows[d * T + t] = u;
  }
  __syncthreads();
  for (int t = tid; t < T; t += nth) {
    float u = 0.f;
    for (int d = 0; d < D; ++d) u += rows[d * T + t] * w_d[d];
    g.u_t[(long long)l * T + t] = u;
  }
  for (int d = tid; d < D; d += nth) {
    float u = 0.f;
    for (int t = 0; t < T; ++t) u += rows[d * T + t] * w_t[t];
    g.u_d[(long long)l * D + d] = u;
  }
}

}  // namespace tf32cand

// args: a tf32cand::Args (the first design's LcArgs layout); split 3 (3xTF32) or 1
// (plain TF32); R <= 128 and D T <= 88
extern "C" int cand_likelihood_local_ctf_tf32(const void* args, int split, void* stream) {
  const tf32cand::Args* g = (const tf32cand::Args*)args;
  if (g->L <= 0) return 0;
  if (g->R > 128 || g->D * g->T > tf32cand::MAX_NT * 8) return (int)cudaErrorInvalidValue;
  const int R16 = 128, N8 = tf32cand::MAX_NT * 8, KC = tf32cand::KC, KP = tf32cand::KP;
  int loop = 2 * R16 * KP + 2 * N8 * KP + 2 * g->T * KC + 2 * g->D * KC + R16 * KC;
  int epi = g->D * g->T * R16;
  int smem = 4 * (((8 + g->D + 3) & ~3) + (loop > epi ? loop : epi) + g->D * R16 + g->D * g->T + 32);
  cudaError_t e = cudaFuncSetAttribute(tf32cand::kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  tf32cand::kernel<<<(unsigned)g->L, 256, smem, (cudaStream_t)stream>>>(*g, split);
  return (int)cudaGetLastError();
}
