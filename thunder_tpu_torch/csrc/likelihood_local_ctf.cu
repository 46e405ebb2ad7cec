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
// The (d, r, t) block of an image never reaches device memory.
//
// What bounds it on Hopper: fp32 operations.  Re(x conj(pri)) does not
// depend on d, so it is formed once a (r, t, pixel) (2 multiply-adds) and
// the defocus axis costs D more: (2 + D) where the einsum spends 2 D.
// The design keeps the fp32 units, not shared memory, busy:
//
// * Register tile.  A thread owns TR = 4 rotations x TT = 3 translations
//   x TD = 9 defocus factors (a d tile; larger D takes several tiles) for
//   the whole pixel loop, 108 sums in registers.  A pixel's loads (two
//   16-byte loads of pri, three of x, three of the CTF row, all but pri
//   warp broadcasts) feed 132 multiply-adds.
// * B on every thread.  A thread also sums B for its 4 rotations and TB
//   = 3 of its tile's defocus factors (d = tt + n_tt j), so B is spread
//   over all translation tiles (n_tt >= 3 always).
// * Pixel groups.  The block is (rotation group, translation tile, d
//   tile) warps times `groups` pixel groups; group g sums the pixels
//   g, g + groups, ... of every staged chunk.  After the loop the groups
//   add their sums into shared memory one after another, in a fixed
//   order: no atomics, so two calls give identical bits.  The (D, R, T)
//   block is then formed once for the max / exp / marginal epilogue.
// * Asynchronous staging.  cp.async copies chunk k + 1 of pri, tra and
//   the pixel terms into the second of two buffers while chunk k is
//   summed.  pri is laid out so that a thread's four rotations are two
//   16-byte words at lane-consecutive addresses (conflict-free), a pixel
//   row padded by 16 bytes.  x = dat conj(tra) and the CTF rows of the
//   chunk are formed once, in ctf_packed_scaled's order of operations.
// * One launch a call: the per-image CTF constants and the pixels'
//   geometry (f^2, angle) are formed once a round by the caller.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PC = 32;            // pixels staged a chunk
constexpr int TR = 4;             // rotations a thread
constexpr int TT = 3;             // translations a thread
constexpr int TD = 9;             // defocus factors a thread (a d tile)
constexpr int TB = 3;             // defocus factors of a tile whose B a thread sums
constexpr int CS = 12;            // floats of a (pixel, d tile) CTF row: TD, 16-byte padded
constexpr int MAX_THREADS = 384;  // 12 warps: at most 168 registers a thread

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
  int n_rg, n_tt, n_dt, groups;   // ops/likelihood.py likelihood_ctf_plan
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cp.async of `bytes` (4 or 8); zero-fills the destination where !ok
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(BYTES), "r"(ok ? BYTES : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// PCT pixels a chunk, at most THREADS threads, MIN_BLOCKS blocks an SM
template <int PCT, int THREADS, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) likelihood_local_ctf_kernel(LcArgs g) {
  extern __shared__ float4 smem4[];
  const int D = g.D, R = g.R, T = g.T, P = g.P;
  const int n_tt = g.n_tt, n_dt = g.n_dt, groups = g.groups;
  const int NT = g.n_rg * 32;                  // rotation tiles, padded to whole warps
  const int R4 = NT * TR, T3 = n_tt * TT, D9 = n_dt * TD;
  const int PRS = 2 * R4 + 4;                  // floats of a staged pri pixel row
  const int STG = PCT * PRS + PCT * T3 * 2 + 5 * PCT;
  float* ck = (float*)smem4;                   // [8] the image's CTF constants
  float* dfac_s = ck + 8;                      // [D9]
  float* work = ck + ((8 + D9 + 3) & ~3);
  float* x_s = work + 2 * STG;                 // [PCT][T3] float2
  float* ctf_s = x_s + 2 * PCT * T3;           // [PCT][n_dt][CS]
  float* sc2_s = ctf_s + PCT * n_dt * CS;      // [PCT][n_dt][CS]: s ctf^2
  // after the pixel loop, over the staging buffers:
  float* dvp = work;                           // [D9][T3][R4]
  float* bsum = dvp + D9 * T3 * R4;            // [D9][R4]
  float* rows = bsum + D9 * R4;                // [D9][T3]
  float* red = rows + D9 * T3;                 // [32]

  const int l = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, w = tid >> 5;
  const int rg = w % g.n_rg, tt = (w / g.n_rg) % n_tt, dt = (w / (g.n_rg * n_tt)) % n_dt;
  const int grp = w / (g.n_rg * n_tt * n_dt);
  const int jt = rg * 32 + lane;               // this thread's rotation tile
  const float2* dat = g.dat_s + (long long)l * P;
  const float* sp = g.s_pack + (long long)l * P;
  const float2* pri = g.pri + (long long)l * R * P;
  const float2* tra = g.tra + (long long)l * T * P;

  if (tid < 8) ck[tid] = g.ctfk[(long long)l * 8 + tid];
  for (int i = tid; i < D9; i += nth) dfac_s[i] = i < D ? g.dfac[(long long)l * D + i] : 1.f;

  auto issue = [&](int p0, float* stg) {
    float* tra_s = stg + PCT * PRS;
    float* pix = tra_s + PCT * T3 * 2;         // dat [PCT] float2, s, f2, ang [PCT]
    for (int i = tid; i < PCT * R4; i += nth) {
      int r = i / PCT, p = i - r * PCT;
      bool ok = r < R && p0 + p < P;
      float* dst = stg + p * PRS + (((r >> 1) & 1) * NT + (r >> 2)) * 4 + (r & 1) * 2;
      cp_async<8>(dst, ok ? (const void*)(pri + (long long)r * P + p0 + p) : (const void*)pri, ok);
    }
    for (int i = tid; i < T3 * PCT; i += nth) {
      int t = i / PCT, p = i - t * PCT;
      bool ok = t < T && p0 + p < P;
      cp_async<8>(tra_s + 2 * i, ok ? (const void*)(tra + (long long)t * P + p0 + p)
                                    : (const void*)tra, ok);
    }
    for (int i = tid; i < 4 * PCT; i += nth) {
      int p = i % PCT, what = i / PCT;
      bool ok = p0 + p < P;
      if (what == 0)
        cp_async<8>(pix + 2 * p, ok ? (const void*)(dat + p0 + p) : (const void*)dat, ok);
      else {
        const float* src = what == 1 ? sp : what == 2 ? g.f2 : g.ang;
        cp_async<4>(pix + (1 + what) * PCT + p, ok ? (const void*)(src + p0 + p) : (const void*)src,
                    ok);
      }
    }
    cp_async_commit();
  };

  float acc[TR][TT][TD], accb[TR][TB];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
#pragma unroll
    for (int j = 0; j < TT; ++j)
#pragma unroll
      for (int k = 0; k < TD; ++k) acc[i][j][k] = 0.f;
#pragma unroll
    for (int j = 0; j < TB; ++j) accb[i][j] = 0.f;
  }
  int kb[TB];                                  // the CS slot of each B factor (TD: a zero)
#pragma unroll
  for (int j = 0; j < TB; ++j) kb[j] = min(tt + n_tt * j, TD);

  const int n_chunks = (P + PCT - 1) / PCT;
  issue(0, work);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();                           // chunk c landed; chunk c - 1 summed by all
    float* stg = work + (c & 1) * STG;
    if (c + 1 < n_chunks) issue((c + 1) * PCT, work + ((c + 1) & 1) * STG);

    // x and the CTF rows of chunk c
    {
      const float2* tra_s = (const float2*)(stg + PCT * PRS);
      const float* pix = stg + PCT * PRS + PCT * T3 * 2;
      const float2* dat_p = (const float2*)pix;
      const float *s_p = pix + 2 * PCT, *f2_p = pix + 3 * PCT, *ang_p = pix + 4 * PCT;
      for (int i = tid; i < T3 * PCT; i += nth) {
        int t = i / PCT, p = i - t * PCT;
        float2 d = dat_p[p], q = tra_s[i];
        ((float2*)x_s)[p * T3 + t] = make_float2(d.x * q.x + d.y * q.y, d.y * q.x - d.x * q.y);
      }
      for (int i = tid; i < PCT * n_dt * CS; i += nth) {
        int p = i / (n_dt * CS), rest = i - p * (n_dt * CS);
        int tile = rest / CS, k = rest - tile * CS, d = tile * TD + k;
        float cv = 0.f;
        if (k < TD && d < D) {
          float f2 = f2_p[p], du = ck[4], dv = ck[5];
          float defocus = -(du + dv + (du - dv) * cosf(2.f * (ang_p[p] - ck[6]))) / 2.f;
          float chi = __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(ck[0], defocus), dfac_s[d]), f2),
                                __fmul_rn(__fmul_rn(ck[1], f2), f2)) - ck[7];
          cv = -ck[2] * sinf(chi) + ck[3] * cosf(chi);
        }
        ctf_s[i] = cv;
        sc2_s[i] = s_p[p] * cv * cv;
      }
    }
    __syncthreads();

    for (int p = grp; p < PCT; p += groups) {
      const float4* pr = (const float4*)(stg + p * PRS) + jt;
      float4 pa = pr[0], pb = pr[NT];
      const float2* xr = (const float2*)x_s + p * T3 + tt * TT;
      const float* cr = ctf_s + (p * n_dt + dt) * CS;
      const float* er = sc2_s + (p * n_dt + dt) * CS;
      float4 c0 = *(const float4*)cr, c1 = *(const float4*)(cr + 4);
      float cs[TD] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w, cr[8]};
      float2 xs[TT];
#pragma unroll
      for (int j = 0; j < TT; ++j) xs[j] = xr[j];
      float e[TB];
#pragma unroll
      for (int j = 0; j < TB; ++j) e[j] = er[kb[j]];
      float re[TR] = {pa.x, pa.z, pb.x, pb.z}, im[TR] = {pa.y, pa.w, pb.y, pb.w};
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float h = re[i] * re[i] + im[i] * im[i];
#pragma unroll
        for (int j = 0; j < TB; ++j) accb[i][j] += e[j] * h;
#pragma unroll
        for (int j = 0; j < TT; ++j) {
          float gg = xs[j].x * re[i] + xs[j].y * im[i];
#pragma unroll
          for (int k = 0; k < TD; ++k) acc[i][j][k] += cs[k] * gg;
        }
      }
    }
  }
  __syncthreads();

  // the pixel groups' sums, added in group order
  for (int gg = 0; gg < groups; ++gg) {
    if (grp == gg) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        int r = jt * TR + i;
#pragma unroll
        for (int j = 0; j < TT; ++j)
#pragma unroll
          for (int k = 0; k < TD; ++k) {
            float* at = dvp + ((dt * TD + k) * T3 + tt * TT + j) * R4 + r;
            *at = gg == 0 ? acc[i][j][k] : *at + acc[i][j][k];
          }
#pragma unroll
        for (int j = 0; j < TB; ++j)
          if (kb[j] < TD) {
            float* at = bsum + (dt * TD + kb[j]) * R4 + r;
            *at = gg == 0 ? accb[i][j] : *at + accb[i][j];
          }
      }
    }
    __syncthreads();
  }

  // dvp = (a + B) + C over the valid (d, t, r); its maximum
  const float a = g.a[l];
  const int n_val = D * T * R;
  float m = -INFINITY;
  for (int i = tid; i < n_val; i += nth) {
    int r = i % R, t = (i / R) % T, d = i / (R * T);
    int at = (d * T3 + t) * R4 + r;
    float v = (a + bsum[d * R4 + r]) + (-2.f * dvp[at]);
    dvp[at] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  if (lane == 0) red[w] = m;
  __syncthreads();
  m = red[0];
  for (int i = 1; i < (nth + 31) / 32; ++i) m = fmaxf(m, red[i]);
  for (int i = tid; i < n_val; i += nth) {
    int r = i % R, t = (i / R) % T, d = i / (R * T);
    int at = (d * T3 + t) * R4 + r;
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
      for (int t = 0; t < T; ++t) ud += dvp[(d * T3 + t) * R4 + r] * w_t[t];
      u += ud * w_d[d];
    }
    g.u_r[(long long)l * R + r] = u;
  }
  // rows[d][t] = sum_r w[d][t][r] w_r[r], a warp a row
  for (int row = w; row < D * T; row += nth >> 5) {
    int d = row / T, t = row % T;
    float u = 0.f;
    for (int r = lane; r < R; r += 32) u += dvp[(d * T3 + t) * R4 + r] * w_r[r];
    u = warp_sum(u);
    if (lane == 0) rows[d * T3 + t] = u;
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

// args: an LcArgs of device pointers (every array contiguous) and the
// plan of ops/likelihood.py likelihood_ctf_plan, whose threads and
// dynamic shared memory are passed here
template <int PCT, int THREADS, int MIN_BLOCKS>
int launch_likelihood_local_ctf(const void* args, int threads, int smem, void* stream) {
  const LcArgs* g = (const LcArgs*)args;
  if (g->L <= 0) return 0;
  auto kernel = likelihood_local_ctf_kernel<PCT, THREADS, MIN_BLOCKS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)g->L, threads, smem, (cudaStream_t)stream>>>(*g);
  return (int)cudaGetLastError();
}

extern "C" int thunder_likelihood_local_ctf(const void* args, int threads, int smem,
                                            void* stream) {
  return launch_likelihood_local_ctf<PC, MAX_THREADS, 1>(args, threads, smem, stream);
}
