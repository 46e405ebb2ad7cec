// HK1 project_slices: trilinear central-slice gather from a centered,
// padded, grid-corrected reference spectrum.
//
// Replaces (thunder_tpu): ops/projector.py project_classed (the
// corner-row table gather of the phase loop and the sigma / norm
// stages) and project_ri / project_3d (the rotation-block gather of
// optimiser._global_search).
//
// out[l, r, p] = trilinear sample of cube cls[l] at
//                rot[l, r] . (pf * i_col[p], pf * i_row[p], 0)
// in centered coordinates (index = floor(coord) + n/2), every tap index
// clipped to [0, n-1] exactly as _gather_trilinear_3d does, the
// coordinates formed without FMA contraction (as the plain version
// forms them) and the taps blended in its order.
//
// What bounds it on Hopper: the 32-byte sectors that travel from L2 to
// the SMs.  At pf 2 neighbouring pixels of a slice lie two cells apart,
// so the 2 x 2 x 2 tap cubes of a warp's samples share almost nothing
// and a sample pulls ~5 sectors (160 bytes) for 64 useful bytes from a
// plain (z, y, x) cube of 8-byte cells; one thread a sample over such a
// cube moves those sectors at L2's rate and no faster, whether its taps
// are 8 loads or 4 paired ones, and whether a block owns a slice or not
// (measured: micro/hk_candidates.py).  The design therefore changes the
// table, not the thread map: ops/projector.py quad_taps stores in cell
// (z, y, x) the four taps (y, x), (y, x+1), (y+1, x), (y+1, x+1) of its z
// plane, 32 bytes on a 32-byte boundary, so a sample is two sector loads
// (z0, z1) whichever way the slice is tilted.  The quad table is four
// times the cube; it pays while it stays near the 50 MB L2 (measured
// faster up to 128 MiB, slower from 214 MiB), and the caller keeps the
// plain cube, read by the 8-load form below, past that (a 256 px box:
// two 176^3 classes would be 333 MiB of quads).  Rotations are
// shared by all images in global search (rot_l_stride = 0), where one
// launch of 256 slices is bound by the launch itself.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  float2 t[8];   // t[4 dz + 2 dy + dx]
};

// taps (x0, x1) of one (z, y) row of the plain cube, x clipped to the row
__device__ __forceinline__ void taps_plain(const float2* vol, int n, int row, int ix,
                                           float2& a, float2& b) {
  int x0 = min(max(ix, 0), n - 1), x1 = min(max(ix + 1, 0), n - 1);
  a = __ldg(vol + row + x0);
  b = __ldg(vol + row + x1);
}

// the four (y, x) taps of plane z from the quad table: cell (y, x) holds
// t[y][x], t[y][x+], t[y+][x], t[y+][x+] (+ clipped to n - 1); below the
// cube (ix < 0 or iy < 0) both taps of that axis are the first cell's
__device__ __forceinline__ void taps_quad(const float4* vol, int n, int plane, int iy, int ix,
                                          float2* q) {
  const float4* c = vol + 2 * (plane + min(max(iy, 0), n - 1) * n + min(max(ix, 0), n - 1));
  float4 a = __ldg(c), b = __ldg(c + 1);
  q[0] = make_float2(a.x, a.y);
  q[1] = ix < 0 ? q[0] : make_float2(a.z, a.w);
  if (iy < 0) {
    q[2] = q[0];
    q[3] = q[1];
  } else {
    q[2] = make_float2(b.x, b.y);
    q[3] = ix < 0 ? q[2] : make_float2(b.z, b.w);
  }
}

// same weight products and tap order as the JAX gather
__device__ __forceinline__ float2 blend(const Taps& q, float wx, float wy, float wz) {
  float w000 = (1.f - wz) * (1.f - wy) * (1.f - wx);
  float w001 = (1.f - wz) * (1.f - wy) * wx;
  float w010 = (1.f - wz) * wy * (1.f - wx);
  float w011 = (1.f - wz) * wy * wx;
  float w100 = wz * (1.f - wy) * (1.f - wx);
  float w101 = wz * (1.f - wy) * wx;
  float w110 = wz * wy * (1.f - wx);
  float w111 = wz * wy * wx;
  float re = q.t[0].x * w000, im = q.t[0].y * w000;
  re += q.t[1].x * w001; im += q.t[1].y * w001;
  re += q.t[2].x * w010; im += q.t[2].y * w010;
  re += q.t[3].x * w011; im += q.t[3].y * w011;
  re += q.t[4].x * w100; im += q.t[4].y * w100;
  re += q.t[5].x * w101; im += q.t[5].y * w101;
  re += q.t[6].x * w110; im += q.t[6].y * w110;
  re += q.t[7].x * w111; im += q.t[7].y * w111;
  return make_float2(re, im);
}

// The sample of cube k at centered (x, y, z).  All loads start before a
// weight is formed: the order matters, ptxas keeps the kernel in 32
// registers and weights formed first cost it the loads in flight.
template <bool QUAD>
__device__ __forceinline__ float2 sample(const void* table, int n, int k, float x, float y,
                                         float z) {
  float flx = floorf(x), fly = floorf(y), flz = floorf(z);
  int c = n / 2;
  int ix = (int)flx + c, iy = (int)fly + c, iz = (int)flz + c;
  int y0 = min(max(iy, 0), n - 1), y1 = min(max(iy + 1, 0), n - 1);
  int z0 = min(max(iz, 0), n - 1), z1 = min(max(iz + 1, 0), n - 1);
  int r00 = (z0 * n + y0) * n, r01 = (z0 * n + y1) * n;   // within a cube: n^3 < 2^31
  int r10 = (z1 * n + y0) * n, r11 = (z1 * n + y1) * n;
  long long base = (long long)k * n * n * n;
  Taps q;
  if constexpr (QUAD) {
    const float4* vol = (const float4*)table + 2 * base;
    taps_quad(vol, n, z0 * n * n, iy, ix, q.t);
    taps_quad(vol, n, z1 * n * n, iy, ix, q.t + 4);
  } else {
    const float2* vol = (const float2*)table + base;
    taps_plain(vol, n, r00, ix, q.t[0], q.t[1]);
    taps_plain(vol, n, r01, ix, q.t[2], q.t[3]);
    taps_plain(vol, n, r10, ix, q.t[4], q.t[5]);
    taps_plain(vol, n, r11, ix, q.t[6], q.t[7]);
  }
  return blend(q, x - flx, y - fly, z - flz);
}

template <bool QUAD>
__global__ void project_slices_kernel(
    const void* __restrict__ table, int n, const int* __restrict__ cls,
    const float* __restrict__ rot, long long rot_l_stride, int n_rot,
    const int* __restrict__ i_col, const int* __restrict__ i_row,
    int n_pix, int pf, float2* __restrict__ out, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int p = (int)(idx % n_pix);
  long long lr = idx / n_pix;
  int r = (int)(lr % n_rot);
  long long l = lr / n_rot;
  const float* R = rot + l * rot_l_stride + (long long)r * 9;
  float fx = (float)(i_col[p] * pf), fy = (float)(i_row[p] * pf);
  float x = __fadd_rn(__fmul_rn(__ldg(R + 0), fx), __fmul_rn(__ldg(R + 1), fy));
  float y = __fadd_rn(__fmul_rn(__ldg(R + 3), fx), __fmul_rn(__ldg(R + 4), fy));
  float z = __fadd_rn(__fmul_rn(__ldg(R + 6), fx), __fmul_rn(__ldg(R + 7), fy));
  out[idx] = sample<QUAD>(table, n, cls ? cls[l] : 0, x, y, z);
}

}  // namespace

// table: (K, n, n, n) complex64, or with quad != 0 the (K, n, n, n, 8)
// float32 quad table of ops/projector.py quad_taps
extern "C" int thunder_project_slices(
    const void* table, int quad, int n, const void* cls, const void* rot,
    long long rot_l_stride, int n_img, int n_rot, const void* i_col,
    const void* i_row, int n_pix, int pf, void* out, void* stream) {
  long long total = (long long)n_img * n_rot * n_pix;
  if (total > 0) {
    const int threads = 256;
    unsigned blocks = (unsigned)((total + threads - 1) / threads);
    auto kernel = quad ? project_slices_kernel<true> : project_slices_kernel<false>;
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        table, n, (const int*)cls, (const float*)rot, rot_l_stride, n_rot,
        (const int*)i_col, (const int*)i_row, n_pix, pf, (float2*)out, total);
  }
  return (int)cudaGetLastError();
}
