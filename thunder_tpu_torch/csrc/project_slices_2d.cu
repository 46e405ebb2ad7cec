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
// What bounds it on Hopper: the write of the samples (8 bytes each) and
// the taps' way from L2 through L1; a class plane is small (4.6 KB at
// r = 5, 32 KB at r = 15, 131 KB at r_u = 31), so a block whose threads
// sample one plane finds most taps in L1.  In the first design the
// thread's own work stood in the way: one thread a sample began with
// two 64-bit divisions and two remainders by run-time values, reloaded
// its pixel, class and rotation, and stored 8 bytes.  Here
//   * the block is (pixels) x (images) and the grid (image tiles, pixel
//     tiles, rotation tiles), so every index is a 32-bit sum or product;
//     a thread keeps its pixels' (fx, fy), its image's class and plane,
//     and walks the image's rotations (rt of them; all of them when the
//     launch has enough threads without splitting), so those loads and
//     the index work are paid once for rt samples and the rotation is a
//     broadcast load;
//   * launches of eight million samples or more give a thread two
//     neighbouring pixels of a slice, which leave as one 16-byte store
//     (the pair form needs an even pixel count, which the packed rings
//     have); smaller launches keep one pixel a thread, which measured
//     faster there (more threads to hide the taps' latency).
// Measured and not kept (micro/hk_candidates.py, micro/cand/hk5_cand.cu):
// HK1's quad table carried to 2D (a sample's four taps in one 32-byte
// sector) is slower at every shape, 0.23 against 0.16 ms at r = 15: four
// times the plane no longer sits in L1, which is what serves a plane's
// taps here, where HK1's cubes never fit it; four pixels a thread
// (0.26 ms at r = 15); streaming stores (within 2 %).
// Rotations are shared by all images of a global-search class
// (rot_l_stride = 0, cls[l] = the class) or per image in the phase loop
// (cls[l] = the image's class), so all classes of a step go in one
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_THREADS = 256;
// enough threads to fill the card before a thread walks rotations
constexpr long long WANT_THREADS = 132 * 1024;
// samples from which a thread takes two pixels (3.6 M at r = 5: one
// pixel 0.021 ms, two 0.026; 30 M at r = 15: 0.169 and 0.157)
constexpr long long PAIR_FROM = 1 << 23;

// The sample of one plane at centered (x, y); all loads start before a
// weight is formed.
__device__ __forceinline__ float2 sample_2d(const float2* img, int n, float x, float y) {
  float flx = floorf(x), fly = floorf(y);
  int c = n / 2;
  int ix = (int)flx + c, iy = (int)fly + c;
  int x0 = min(max(ix, 0), n - 1), x1 = min(max(ix + 1, 0), n - 1);
  int y0 = min(max(iy, 0), n - 1), y1 = min(max(iy + 1, 0), n - 1);
  float2 t00 = __ldg(img + y0 * n + x0);
  float2 t01 = __ldg(img + y0 * n + x1);
  float2 t10 = __ldg(img + y1 * n + x0);
  float2 t11 = __ldg(img + y1 * n + x1);
  // same weight products and tap order as the JAX gather
  float wx = x - flx, wy = y - fly;
  float w00 = (1.f - wy) * (1.f - wx);
  float w01 = (1.f - wy) * wx;
  float w10 = wy * (1.f - wx);
  float w11 = wy * wx;
  float re = t00.x * w00, im = t00.y * w00;
  re += t01.x * w01; im += t01.y * w01;
  re += t10.x * w10; im += t10.y * w10;
  re += t11.x * w11; im += t11.y * w11;
  return make_float2(re, im);
}

// W pixels a thread (2: one 16-byte store a rotation; 1: any pixel
// count).  threadIdx.x: the thread's pixel group in the block's pixel
// tile, threadIdx.y: its image in the block's image tile.
template <int W>
__global__ void __launch_bounds__(BLOCK_THREADS)
project_slices_2d_kernel(const float2* __restrict__ table, int n, const int* __restrict__ cls,
                         const float* __restrict__ rot, long long rot_l_stride, int n_img,
                         int n_rot, int rt, const int* __restrict__ i_col,
                         const int* __restrict__ i_row, int n_pix, int pf,
                         float2* __restrict__ out) {
  const int p = (blockIdx.y * blockDim.x + threadIdx.x) * W;
  const int l = blockIdx.x * blockDim.y + threadIdx.y;
  if (l >= n_img || p >= n_pix) return;
  float fx[W], fy[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    fx[w] = (float)(__ldg(i_col + p + w) * pf);
    fy[w] = (float)(__ldg(i_row + p + w) * pf);
  }
  const int k = cls ? __ldg(cls + l) : 0;
  const float2* plane = table + (size_t)k * n * n;
  const int r0 = blockIdx.z * rt, r1 = min(r0 + rt, n_rot);
  const float* R = rot + l * rot_l_stride + r0 * 4;
  float2* o = out + ((long long)l * n_rot + r0) * n_pix + p;
#pragma unroll 3
  for (int r = r0; r < r1; ++r, R += 4, o += n_pix) {
    float m00 = __ldg(R), m01 = __ldg(R + 1), m10 = __ldg(R + 2), m11 = __ldg(R + 3);
    float2 v[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      float x = __fadd_rn(__fmul_rn(m00, fx[w]), __fmul_rn(m01, fy[w]));
      float y = __fadd_rn(__fmul_rn(m10, fx[w]), __fmul_rn(m11, fy[w]));
      v[w] = sample_2d(plane, n, x, y);
    }
    if constexpr (W == 2)
      *(float4*)o = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
    else
      *o = v[0];
  }
}

template <int W>
int launch(const float2* table, int n, const int* cls, const float* rot, long long rot_l_stride,
           int n_img, int n_rot, const int* i_col, const int* i_row, int n_pix, int pf,
           float2* out, cudaStream_t stream) {
  int groups = n_pix / W;
  int bx = groups < BLOCK_THREADS ? groups : BLOCK_THREADS;
  int by = BLOCK_THREADS / bx;
  if (by > n_img) by = n_img;
  long long rt = (long long)n_img * groups * n_rot / WANT_THREADS;
  rt = rt < 1 ? 1 : (rt > n_rot ? n_rot : rt);
  dim3 grid((n_img + by - 1) / by, (groups + bx - 1) / bx, (unsigned)((n_rot + rt - 1) / rt));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  project_slices_2d_kernel<W><<<grid, dim3(bx, by), 0, stream>>>(
      table, n, cls, rot, rot_l_stride, n_img, n_rot, (int)rt, i_col, i_row, n_pix, pf, out);
  return 0;
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
    bool pair = total >= PAIR_FROM && n_pix % 2 == 0 && (uintptr_t)out % 16 == 0;
    auto fn = pair ? launch<2> : launch<1>;
    if (int e = fn((const float2*)table, n, (const int*)cls, (const float*)rot, rot_l_stride,
                   n_img, n_rot, (const int*)i_col, (const int*)i_row, n_pix, pf, (float2*)out,
                   (cudaStream_t)stream))
      return e;
  }
  return (int)cudaGetLastError();
}
