// Candidate designs of HK3 insert_trilinear, timed against each other by
// micro/hk_candidates.py.  All compute insert_trilinear.cu's function.
//
//   dense<ATOM>:  one thread per (slice, pixel of the dense window), the
//                 first design; ATOM = 1 scalar atomics (24 a sample),
//                 2 float2 atomics on F (16), 4 one float4 atomic on an
//                 interleaved (re, im, T, 0) scratch grid (8).
//   image<ATOM, TAB>: a block walks the slices of one image; a thread
//                 owns in-disc pixels and forms ctf, ctf^2 and the data
//                 value once; TAB = ramp from two 1D sincos tables in
//                 shared memory, else one sincosf a sample.

#include <cuda_runtime.h>
#include <math.h>

#ifndef VEC_PTX
#define VEC_PTX 0   // 0: atomicAdd(float2/float4), 1 and 2: inline red.global PTX forms
#endif

namespace {

constexpr int THREADS = 256;
constexpr int PXT = 4;       // pixels a thread owns
constexpr int BATCH = 16;    // slices whose tables are staged at once

template <int ATOM>
__device__ __forceinline__ void add_cell(float* F, float* T, float4* G, int lin,
                                         float a, float b, float c) {
  if constexpr (ATOM == 4) {
#if VEC_PTX == 0
    atomicAdd(G + lin, make_float4(a, b, c, 0.f));
#elif VEC_PTX == 1
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(G + lin), "f"(a), "f"(b),
                 "f"(c), "f"(0.f) : "memory");
#else
    asm volatile("red.global.v4.f32.add [%0], {%1, %2, %3, %4};" ::"l"(G + lin), "f"(a), "f"(b),
                 "f"(c), "f"(0.f) : "memory");
#endif
  } else if constexpr (ATOM == 2) {
#if VEC_PTX == 0
    atomicAdd(reinterpret_cast<float2*>(F) + lin, make_float2(a, b));
#elif VEC_PTX == 1
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(reinterpret_cast<float2*>(F) + lin),
                 "f"(a), "f"(b) : "memory");
#else
    asm volatile("red.global.v2.f32.add [%0], {%1, %2};" ::"l"(reinterpret_cast<float2*>(F) + lin),
                 "f"(a), "f"(b) : "memory");
#endif
    atomicAdd(T + lin, c);
  } else {
    atomicAdd(F + 2LL * lin, a);
    atomicAdd(F + 2LL * lin + 1, b);
    atomicAdd(T + lin, c);
  }
}

template <int ATOM>
__device__ __forceinline__ void scatter8(float* F, float* T, float4* G, int big,
                                         float x, float y, float z, float vre,
                                         float vim, float c2w, int half = -1) {
  float flx = floorf(x), fly = floorf(y), flz = floorf(z);
  float wx = x - flx, wy = y - fly, wz = z - flz;
  int cb = big / 2;
  int ix = (int)flx + cb, iy = (int)fly + cb, iz = (int)flz + cb;
  int x0 = min(max(ix, 0), big - 1), x1 = min(max(ix + 1, 0), big - 1);
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    int zi = min(max(iz + dz, 0), big - 1);
    float wzz = dz ? wz : 1.f - wz;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      int yi = min(max(iy + dy, 0), big - 1);
      float wzy = wzz * (dy ? wy : 1.f - wy);
      int row = (zi * big + yi) * big;
      float w0 = wzy * (1.f - wx), w1 = wzy * wx;
      if (half != 1) add_cell<ATOM>(F, T, G, row + x0, vre * w0, vim * w0, c2w * w0);
      if (half != 0) add_cell<ATOM>(F, T, G, row + x1, vre * w1, vim * w1, c2w * w1);
    }
  }
}

// ctf at (vc, vr) from [k1, k2, w1, w2, defocus_u, defocus_v, theta, phase]
__device__ __forceinline__ float ctf_at(const float* k, int vc, int vr, float box_a) {
  float fx = (float)vc / box_a, fy = (float)vr / box_a;
  float f = sqrtf(fx * fx + fy * fy);
  float ang = atan2f((float)vr, (float)vc);
  float du = k[4], dv = k[5];
  float defocus = -(du + dv + (du - dv) * cosf(2.f * (ang - k[6]))) / 2.f;
  float f2 = f * f;
  float chi = k[0] * defocus * f2 + k[1] * (f2 * f2) - k[7];
  return -k[2] * sinf(chi) + k[3] * cosf(chi);
}

// LIST: px lists the npx in-disc pixels and no thread idles on the rest.
// PAIR: two neighbouring lanes share a sample, one adds its x0 taps and
// the other its x1 taps, so that one warp instruction carries both cells
// of a row (32 contiguous bytes where x0 is even).
template <int ATOM, bool LIST, bool PAIR = false>
__global__ void dense_kernel(
    const float2* __restrict__ ft, int size, const float* __restrict__ ctfk,
    const int* __restrict__ img_idx, const float* __restrict__ rot,
    const float* __restrict__ trans, const float* __restrict__ wsl, int r_u, int pf,
    float max_radius_pad, float box_a, float tpos, float* __restrict__ F,
    float* __restrict__ T, float4* __restrict__ G, int big, long long total,
    const int* __restrict__ px, int n_list) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int half = PAIR ? (int)(idx & 1) : -1;
  if constexpr (PAIR) idx >>= 1;
  if (idx >= total) return;
  const int nk = 2 * r_u - 1, rr = r_u - 1, npx = LIST ? n_list : nk * nk;
  long long s = idx / npx;
  int p = (int)(idx - s * npx);
  if constexpr (LIST) p = px[p];
  int vr = p / nk - rr, vc = p % nk - rr;
  int q2 = vc * vc + vr * vr;
  if (q2 >= rr * rr) return;
  float w = wsl[s];
  if (w == 0.f) return;
  float mask_d = (q2 == 0) ? 2.f : 1.f;
  int img = img_idx[s];
  int c = size / 2;
  float2 d = ft[((long long)img * size + (c + vr)) * size + (c + vc)];
  float ph = tpos * ((float)vc * trans[2 * s] + (float)vr * trans[2 * s + 1]);
  float cp = cosf(ph), sp = sinf(ph);
  float dr = d.x * cp - d.y * sp, di = d.x * sp + d.y * cp;
  float ctf = ctf_at(ctfk + (long long)img * 8, vc, vr, box_a);
  float cm = ctf * mask_d;
  const float* R = rot + s * 9;
  float gx = (float)(vc * pf), gy = (float)(vr * pf);
  float x = R[0] * gx + R[1] * gy, y = R[3] * gx + R[4] * gy, z = R[6] * gx + R[7] * gy;
  if (x * x + y * y + z * z >= max_radius_pad * max_radius_pad) return;
  scatter8<ATOM>(F, T, G, big, x, y, z, dr * cm * w, di * cm * w, ctf * ctf * mask_d * w, half);
}

// order (B,) int32 lists the slices sorted by image; image i owns
// order[starts[i] .. starts[i + 1]); px (npx,) int32 in-disc dense pixels
// (vr + r_u - 1) nk + (vc + r_u - 1); grid (L, ceil(npx / (PXT THREADS)))
template <int ATOM, bool TAB>
__global__ void __launch_bounds__(THREADS) image_kernel(
    const float2* __restrict__ ft, int size, const float* __restrict__ ctfk,
    const int* __restrict__ order, const int* __restrict__ starts,
    const float* __restrict__ rot,
    const float* __restrict__ trans, const float* __restrict__ wsl,
    const int* __restrict__ px, int npx, int r_u, int pf, float max_radius_pad,
    float box_a, float tpos, float* __restrict__ F, float* __restrict__ T,
    float4* __restrict__ G, int big) {
  extern __shared__ __align__(16) float smem[];
  const int nk = 2 * r_u - 1, rr = r_u - 1;
  float2* EX = reinterpret_cast<float2*>(smem);          // BATCH x nk
  float2* EY = EX + BATCH * nk;                          // BATCH x nk
  const int tid = threadIdx.x;
  const int img = blockIdx.x;
  const int s0 = starts[img], s1 = starts[img + 1];
  if (s0 >= s1) return;
  const int c = size / 2;
  const float mr2 = max_radius_pad * max_radius_pad;
  const float* k = ctfk + 8LL * img;
  const float2* fti = ft + (long long)img * size * size;

  float gx[PXT], gy[PXT], pc2[PXT];
  int pvc[PXT], pvr[PXT];
  float2 pv[PXT];
  bool on[PXT];
#pragma unroll
  for (int j = 0; j < PXT; ++j) {
    int p = (blockIdx.y * PXT + j) * THREADS + tid;
    on[j] = p < npx;
    int d = on[j] ? px[p] : 0;
    int vr = d / nk - rr, vc = d - (d / nk) * nk - rr;
    float ctf = ctf_at(k, vc, vr, box_a);
    float cm = ctf * ((vc == 0 && vr == 0) ? 2.f : 1.f);
    float2 dv = fti[(c + vr) * size + (c + vc)];
    pvc[j] = vc;
    pvr[j] = vr;
    gx[j] = (float)(vc * pf);
    gy[j] = (float)(vr * pf);
    pv[j] = make_float2(dv.x * cm, dv.y * cm);
    pc2[j] = ctf * cm;
  }

  for (int sb = s0; sb < s1; sb += BATCH) {
    const int nb = min(BATCH, s1 - sb);
    if constexpr (TAB) {
      __syncthreads();   // the previous batch's tables are consumed
      for (int i = tid; i < nb * nk; i += THREADS) {
        int b = i / nk, m = i - b * nk;
        float v = (float)(m - rr);
        float sx, cx, sy, cy;
        const int s = order[sb + b];
        sincosf(tpos * (v * trans[2 * s]), &sx, &cx);
        sincosf(tpos * (v * trans[2 * s + 1]), &sy, &cy);
        EX[b * nk + m] = make_float2(cx, sx);
        EY[b * nk + m] = make_float2(cy, sy);
      }
      __syncthreads();
    }
    for (int b = 0; b < nb; ++b) {
      const int s = __ldg(order + sb + b);
      const float w = __ldg(wsl + s);
      if (w == 0.f) continue;
      const float* R = rot + 9LL * s;
      const float R0 = __ldg(R), R1 = __ldg(R + 1), R3 = __ldg(R + 3), R4 = __ldg(R + 4),
                  R6 = __ldg(R + 6), R7 = __ldg(R + 7);
      const float tx = __ldg(trans + 2 * s), ty = __ldg(trans + 2 * s + 1);
#pragma unroll
      for (int j = 0; j < PXT; ++j) {
        if (!on[j]) continue;
        float x = __fadd_rn(__fmul_rn(R0, gx[j]), __fmul_rn(R1, gy[j]));
        float y = __fadd_rn(__fmul_rn(R3, gx[j]), __fmul_rn(R4, gy[j]));
        float z = __fadd_rn(__fmul_rn(R6, gx[j]), __fmul_rn(R7, gy[j]));
        if (__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)) >= mr2)
          continue;
        float er, ei;   // conj(tra) = exp(+i tpos (vc tx + vr ty))
        if constexpr (TAB) {
          float2 a = EX[b * nk + rr + pvc[j]], e = EY[b * nk + rr + pvr[j]];
          er = a.x * e.x - a.y * e.y;
          ei = a.x * e.y + a.y * e.x;
        } else {
          sincosf(tpos * ((float)pvc[j] * tx + (float)pvr[j] * ty), &ei, &er);
        }
        scatter8<ATOM>(F, T, G, big, x, y, z, (pv[j].x * er - pv[j].y * ei) * w,
                       (pv[j].x * ei + pv[j].y * er) * w, pc2[j] * w);
      }
    }
  }
}

__global__ void split_kernel(const float4* __restrict__ G, float2* __restrict__ F,
                             float* __restrict__ T, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 g = G[i];
  if (g.x == 0.f && g.y == 0.f && g.z == 0.f) return;
  float2 f = F[i];
  F[i] = make_float2(f.x + g.x, f.y + g.y);
  T[i] += g.z;
}

template <int ATOM, bool LIST, bool PAIR = false>
int launch_dense(const void* ft, int size, const void* ctfk, const void* img_idx,
                 const void* rot, const void* trans, const void* w, int n_slices, int r_u,
                 int pf, float mrp, float box_a, float tpos, void* F, void* T, void* G,
                 int big, const void* px, int n_list, cudaStream_t st) {
  int nk = 2 * r_u - 1;
  long long total = (long long)n_slices * (LIST ? n_list : nk * nk);
  long long threads = PAIR ? 2 * total : total;
  dense_kernel<ATOM, LIST, PAIR><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const float2*)ft, size, (const float*)ctfk, (const int*)img_idx, (const float*)rot,
      (const float*)trans, (const float*)w, r_u, pf, mrp, box_a, tpos, (float*)F, (float*)T,
      (float4*)G, big, total, (const int*)px, n_list);
  return (int)cudaGetLastError();
}

template <int ATOM, bool TAB>
int launch_image(const void* ft, int size, const void* ctfk, const void* order,
                 const void* starts, int n_img,
                 const void* rot, const void* trans, const void* w, const void* px, int npx,
                 int r_u, int pf, float mrp, float box_a, float tpos, void* F, void* T,
                 void* G, int big, cudaStream_t st) {
  int smem = TAB ? BATCH * (2 * r_u - 1) * 16 : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(image_kernel<ATOM, TAB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_img, (npx + PXT * THREADS - 1) / (PXT * THREADS));
  image_kernel<ATOM, TAB><<<grid, THREADS, smem, st>>>(
      (const float2*)ft, size, (const float*)ctfk, (const int*)order, (const int*)starts,
      (const float*)rot, (const float*)trans, (const float*)w, (const int*)px, npx, r_u, pf, mrp, box_a, tpos,
      (float*)F, (float*)T, (float4*)G, big);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0..2 dense with ATOM 1, 2, 4; 3..5 image + tables with ATOM 1, 2,
// 4; 6..7 image without tables, ATOM 2, 4; 8 dense over the in-disc list, ATOM 4; 9 dense, a lane pair a sample, ATOM 4.  idx is img_idx (dense) or order
// (image); starts and n_img serve the image variants.  G is the scratch grid of the ATOM 4 variants (zeroed
// by the caller; split into F, T here).
extern "C" int cand_insert_trilinear(
    int variant, const void* ft, int size, const void* ctfk, const void* idx,
    const void* starts, int n_img, const void* rot, const void* trans, const void* w, int n_slices,
    const void* px, int npx, int r_u, int pf, float mrp, float box_a, float tpos, void* F,
    void* T, void* G, int big, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
#define DENSE(A, L) launch_dense<A, L>(ft, size, ctfk, idx, rot, trans, w, n_slices, r_u, \
                                       pf, mrp, box_a, tpos, F, T, G, big, px, npx, st)
#define IMAGE(A, B) launch_image<A, B>(ft, size, ctfk, idx, starts, n_img, rot, trans, w, px, \
                                       npx, r_u, pf, mrp, box_a, tpos, F, T, G, big, st)
  switch (variant) {
    case 0: rc = DENSE(1, false); break;
    case 1: rc = DENSE(2, false); break;
    case 2: rc = DENSE(4, false); break;
    case 8: rc = DENSE(4, true); break;
    case 9: rc = launch_dense<4, false, true>(ft, size, ctfk, idx, rot, trans, w, n_slices, r_u,
                                              pf, mrp, box_a, tpos, F, T, G, big, px, npx, st);
      break;
    case 3: rc = IMAGE(1, true); break;
    case 4: rc = IMAGE(2, true); break;
    case 5: rc = IMAGE(4, true); break;
    case 6: rc = IMAGE(2, false); break;
    case 7: rc = IMAGE(4, false); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  if (variant == 2 || variant == 5 || variant == 7 || variant >= 8) {
    int n = big * big * big;
    split_kernel<<<(n + 255) / 256, 256, 0, st>>>((const float4*)G, (float2*)F, (float*)T, n);
    rc = (int)cudaGetLastError();
  }
  return rc;
}
