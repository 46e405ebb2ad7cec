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
// clipped to [0, n-1] exactly as _gather_trilinear_3d does.
//
// What bounds it on Hopper: memory latency of 8 dependent-free float2
// loads per sample scattered over the cube (~92^3 x 8 B = 6 MB per
// class at 128 px global rounds, L2-resident).  The TPU design packed
// bf16 corner rows because its gather paid per row; on Hopper a plain
// f32 gather through the read-only path is the natural form: one thread
// per output sample, the 8 taps as __ldg float2 loads, neighbouring
// threads on neighbouring pixels of one slice (their taps are close in
// the cube, so the loads share L1/L2 lines).  Rotations are shared by
// all images in global search (rot_l_stride = 0) and per image in the
// phase loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void project_slices_kernel(
    const float2* __restrict__ table, int n, const int* __restrict__ cls,
    const float* __restrict__ rot, long long rot_l_stride, int n_rot,
    const int* __restrict__ i_col, const int* __restrict__ i_row,
    int n_pix, float pf, float2* __restrict__ out, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int p = (int)(idx % n_pix);
  long long lr = idx / n_pix;
  int r = (int)(lr % n_rot);
  long long l = lr / n_rot;

  const float* R = rot + l * rot_l_stride + (long long)r * 9;
  float fx = (float)(i_col[p] * (int)pf);
  float fy = (float)(i_row[p] * (int)pf);
  float x = __ldg(R + 0) * fx + __ldg(R + 1) * fy;
  float y = __ldg(R + 3) * fx + __ldg(R + 4) * fy;
  float z = __ldg(R + 6) * fx + __ldg(R + 7) * fy;

  float flx = floorf(x), fly = floorf(y), flz = floorf(z);
  float wx = x - flx, wy = y - fly, wz = z - flz;
  int c = n / 2;
  int ix = (int)flx + c, iy = (int)fly + c, iz = (int)flz + c;
  int k = cls ? cls[l] : 0;
  const float2* vol = table + (long long)k * n * n * n;

  int x0 = min(max(ix, 0), n - 1), x1 = min(max(ix + 1, 0), n - 1);
  int y0 = min(max(iy, 0), n - 1), y1 = min(max(iy + 1, 0), n - 1);
  int z0 = min(max(iz, 0), n - 1), z1 = min(max(iz + 1, 0), n - 1);
  long long nn = (long long)n * n;

  float2 t000 = __ldg(vol + z0 * nn + (long long)y0 * n + x0);
  float2 t001 = __ldg(vol + z0 * nn + (long long)y0 * n + x1);
  float2 t010 = __ldg(vol + z0 * nn + (long long)y1 * n + x0);
  float2 t011 = __ldg(vol + z0 * nn + (long long)y1 * n + x1);
  float2 t100 = __ldg(vol + z1 * nn + (long long)y0 * n + x0);
  float2 t101 = __ldg(vol + z1 * nn + (long long)y0 * n + x1);
  float2 t110 = __ldg(vol + z1 * nn + (long long)y1 * n + x0);
  float2 t111 = __ldg(vol + z1 * nn + (long long)y1 * n + x1);

  // same weight products and tap order as the JAX gather
  float w000 = (1.f - wz) * (1.f - wy) * (1.f - wx);
  float w001 = (1.f - wz) * (1.f - wy) * wx;
  float w010 = (1.f - wz) * wy * (1.f - wx);
  float w011 = (1.f - wz) * wy * wx;
  float w100 = wz * (1.f - wy) * (1.f - wx);
  float w101 = wz * (1.f - wy) * wx;
  float w110 = wz * wy * (1.f - wx);
  float w111 = wz * wy * wx;

  float re = t000.x * w000;
  float im = t000.y * w000;
  re += t001.x * w001; im += t001.y * w001;
  re += t010.x * w010; im += t010.y * w010;
  re += t011.x * w011; im += t011.y * w011;
  re += t100.x * w100; im += t100.y * w100;
  re += t101.x * w101; im += t101.y * w101;
  re += t110.x * w110; im += t110.y * w110;
  re += t111.x * w111; im += t111.y * w111;
  out[idx] = make_float2(re, im);
}

}  // namespace

extern "C" int thunder_project_slices(
    const void* table, int n, const void* cls, const void* rot,
    long long rot_l_stride, int n_img, int n_rot, const void* i_col,
    const void* i_row, int n_pix, int pf, void* out, void* stream) {
  long long total = (long long)n_img * n_rot * n_pix;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    project_slices_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const float2*)table, n, (const int*)cls, (const float*)rot,
        rot_l_stride, n_rot, (const int*)i_col, (const int*)i_row, n_pix,
        (float)pf, (float2*)out, total);
  }
  return (int)cudaGetLastError();
}
