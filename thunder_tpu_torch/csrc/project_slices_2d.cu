// HK5 project_slices_2d: bilinear in-plane rotated resampling of a
// centered, padded, grid-corrected 2D class spectrum.
//
// Replaces (thunder_tpu): ops/projector.py project_classed /
// project_ri in 2D mode (_gather_quad_bilinear_half over the bf16
// corner-row table of optimiser._prepare_projectee_stack), i.e. the
// 2D gathers of optimiser._global_search, _phase_body and
// _max_stats_h.  Its arithmetic is the f32 _gather_bilinear_2d_stack.
//
// out[l, r, p] = bilinear sample of plane cls[l] at
//                rot[l, r] . (pf * i_col[p], pf * i_row[p])
// in centered coordinates (index = floor(coord) + n/2), every tap index
// clipped to [0, n-1] exactly as _gather_bilinear_2d_stack does.  The
// coordinates are formed without FMA contraction (__fmul_rn /
// __fadd_rn), so floor() sees the same float as the plain version.
//
// What bounds it on Hopper: latency of 4 float2 loads per sample from
// a plane of ~(2 (pf r + 2))^2 x 8 B (under 0.5 MB per class at 160 px
// global rounds, all 30 classes L2-resident).  The TPU packed bf16
// corner rows because its gather paid per row; here one thread per
// output sample issues the 4 taps as __ldg float2 loads, neighbouring
// threads on neighbouring pixels of one slice.  Rotations are shared by
// all images of a global-search class (rot_l_stride = 0, cls[l] = the
// class) or per image in the phase loop (cls[l] = the image's class),
// so all classes of a step go in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void project_slices_2d_kernel(
    const float2* __restrict__ table, int n, const int* __restrict__ cls,
    const float* __restrict__ rot, long long rot_l_stride, int n_rot,
    const int* __restrict__ i_col, const int* __restrict__ i_row,
    int n_pix, int pf, float2* __restrict__ out, long long total) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int p = (int)(idx % n_pix);
  long long lr = idx / n_pix;
  int r = (int)(lr % n_rot);
  long long l = lr / n_rot;

  const float* R = rot + l * rot_l_stride + (long long)r * 4;
  float fx = (float)(i_col[p] * pf);
  float fy = (float)(i_row[p] * pf);
  float x = __fadd_rn(__fmul_rn(__ldg(R + 0), fx), __fmul_rn(__ldg(R + 1), fy));
  float y = __fadd_rn(__fmul_rn(__ldg(R + 2), fx), __fmul_rn(__ldg(R + 3), fy));

  float flx = floorf(x), fly = floorf(y);
  float wx = x - flx, wy = y - fly;
  int c = n / 2;
  int ix = (int)flx + c, iy = (int)fly + c;
  int k = cls ? cls[l] : 0;
  const float2* img = table + (long long)k * n * n;

  int x0 = min(max(ix, 0), n - 1), x1 = min(max(ix + 1, 0), n - 1);
  int y0 = min(max(iy, 0), n - 1), y1 = min(max(iy + 1, 0), n - 1);
  float2 t00 = __ldg(img + (long long)y0 * n + x0);
  float2 t01 = __ldg(img + (long long)y0 * n + x1);
  float2 t10 = __ldg(img + (long long)y1 * n + x0);
  float2 t11 = __ldg(img + (long long)y1 * n + x1);

  // same weight products and tap order as the JAX gather
  float w00 = (1.f - wy) * (1.f - wx);
  float w01 = (1.f - wy) * wx;
  float w10 = wy * (1.f - wx);
  float w11 = wy * wx;
  float re = t00.x * w00, im = t00.y * w00;
  re += t01.x * w01; im += t01.y * w01;
  re += t10.x * w10; im += t10.y * w10;
  re += t11.x * w11; im += t11.y * w11;
  out[idx] = make_float2(re, im);
}

}  // namespace

// table (K, n, n) complex64; rot (n_img, n_rot, 2, 2) with image stride
// rot_l_stride floats (0 = shared); cls (n_img,) or null (plane 0);
// out (n_img, n_rot, n_pix) complex64.
extern "C" int thunder_project_slices_2d(
    const void* table, int n, const void* cls, const void* rot,
    long long rot_l_stride, int n_img, int n_rot, const void* i_col,
    const void* i_row, int n_pix, int pf, void* out, void* stream) {
  long long total = (long long)n_img * n_rot * n_pix;
  if (total > 0) {
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    project_slices_2d_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const float2*)table, n, (const int*)cls, (const float*)rot,
        rot_l_stride, n_rot, (const int*)i_col, (const int*)i_row, n_pix, pf,
        (float2*)out, total);
  }
  return (int)cudaGetLastError();
}
