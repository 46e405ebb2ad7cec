// HK13 project_brick: slice projection through brick windows, for the
// concentrated rotation clouds of local and CTF rounds.
//
// Replaces (thunder_tpu): ops/brick.py project_classed_brick (the
// phase loop's projection when Optimiser._table_plan engages a brick
// rung), computed from the port's centered float32 cube (or HK1's quad
// table of it, read one tap a cell) instead of a brick-packed table.
//
// out[l, r, p]: the mean rotation mrot[l] puts pixel p at the mean
// point m = mrot[l] . (pf i_col[p], pf i_row[p], 0); sgn = -1 where m.x
// < 0 folds it into kx >= 0; each axis' anchor is
// rint((sgn m + lo - (span - 1) / 2) / stride) clipped to [0, n_a - 1]
// (lo = c, n_a = nz for z and y; lo = g, n_a = nx for x; c = n / 2 of
// the cube's own size n).  A sample v = rot[l, r] . (...) has window
// offsets sgn v - (anchor stride - lo); if any leaves [0, span - 1] its
// value is 0, else the trilinear value of the window's cells (a cell
// past the cube reads 0), returned as (re, sgn im).  Coordinates and
// anchors are formed without FMA contraction, as the plain version
// (ops/brick.py project_brick_plain) forms them, and the taps blend in
// its order: for each x tap, the four (z, y) taps weighted wz wy, then
// wx.
//
// What bounds it on Hopper: the gather of 8 taps a sample from the cube,
// as for HK1; by its bytes (each input read once, the output written
// once) it is bound by the output.  Design, simple first: one thread an
// (image, pixel) pair walks the image's R rotations, so the mean point,
// the fold, the anchors and the window origin are formed once for all R
// samples (HK5's rotation walk); pixels run across the lanes, so the
// writes to HK1's (L, R, P) layout are coalesced, and a warp's threads
// read the same rotation (one broadcast load).  A rotation's samples of
// neighbouring pixels lie close, so a warp's taps share the cube's
// sectors in L2 as HK1's do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the window's weight of cells j0 and j0 + 1 for offset off (zero past
// the window), thunder_tpu's _axis_hat: max(0, 1 - |off - j|)
struct Axis {
  int i0;        // cube index of cell j0 (less the class's base)
  float w0, w1;  // weights of cells j0 and j0 + 1, 0 past the cube or window
};

__device__ __forceinline__ bool axis(float off, int span, int first, int n, Axis& a) {
  if (!(off >= 0.f && off <= (float)(span - 1))) return false;
  float j0 = floorf(off);
  int j = (int)j0;
  int i = first + j;
  float w0 = fmaxf(0.f, 1.f - fabsf(__fsub_rn(off, j0)));
  float w1 = j + 1 <= span - 1 ? fmaxf(0.f, 1.f - fabsf(__fsub_rn(off, j0 + 1.f))) : 0.f;
  a.i0 = i;
  a.w0 = (i >= 0 && i < n) ? w0 : 0.f;
  a.w1 = (i + 1 >= 0 && i + 1 < n) ? w1 : 0.f;
  return true;
}

// rint((v + lo - half) / stride) clipped to [0, n_a - 1]
__device__ __forceinline__ int anchor(float v, int lo, float half, int stride, int n_a) {
  float q = __fdiv_rn(__fsub_rn(__fadd_rn(v, (float)lo), half), (float)stride);
  return min(max((int)rintf(q), 0), n_a - 1);
}

__device__ __forceinline__ float2 tap(const float2* vol, int cell, int n, int z, int y,
                                      int x, float w) {
  if (w == 0.f) return make_float2(0.f, 0.f);
  float2 v = __ldg(vol + (long long)cell * ((z * n + y) * n + x));
  return make_float2(__fmul_rn(v.x, w), __fmul_rn(v.y, w));
}

__global__ void project_brick_kernel(
    const float2* __restrict__ table, int cell, int n, const int* __restrict__ cls,
    const float* __restrict__ rot, const float* __restrict__ mrot, int n_rot,
    const int* __restrict__ i_col, const int* __restrict__ i_row, int n_pix, int pf,
    int span, int stride, int g, int nz, int nx, float2* __restrict__ out) {
  int per_img = (n_pix + blockDim.x - 1) / blockDim.x;
  int l = blockIdx.x / per_img;
  int p = (blockIdx.x % per_img) * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  int c = n / 2;
  float fx = (float)(i_col[p] * pf), fy = (float)(i_row[p] * pf);
  const float* M = mrot + (long long)l * 9;
  float mx = __fadd_rn(__fmul_rn(__ldg(M + 0), fx), __fmul_rn(__ldg(M + 1), fy));
  float my = __fadd_rn(__fmul_rn(__ldg(M + 3), fx), __fmul_rn(__ldg(M + 4), fy));
  float mz = __fadd_rn(__fmul_rn(__ldg(M + 6), fx), __fmul_rn(__ldg(M + 7), fy));
  float sgn = mx < 0.f ? -1.f : 1.f;
  float half = 0.5f * (float)(span - 1);
  int az = anchor(mz * sgn, c, half, stride, nz);
  int ay = anchor(my * sgn, c, half, stride, nz);
  int ax = anchor(mx * sgn, g, half, stride, nx);
  // window origins (centered) and the cube index of each window's cell 0
  float oz = (float)(az * stride - c), oy = (float)(ay * stride - c);
  float ox = (float)(ax * stride - g);
  int first_z = az * stride, first_y = ay * stride, first_x = ax * stride + c - g;
  const float2* vol = table + (long long)(cls ? cls[l] : 0) * n * n * n * cell;
  const float* R = rot + (long long)l * n_rot * 9;
  float2* o = out + (long long)l * n_rot * n_pix + p;
  for (int r = 0; r < n_rot; ++r, R += 9, o += n_pix) {
    float x = __fadd_rn(__fmul_rn(__ldg(R + 0), fx), __fmul_rn(__ldg(R + 1), fy));
    float y = __fadd_rn(__fmul_rn(__ldg(R + 3), fx), __fmul_rn(__ldg(R + 4), fy));
    float z = __fadd_rn(__fmul_rn(__ldg(R + 6), fx), __fmul_rn(__ldg(R + 7), fy));
    Axis az_, ay_, ax_;
    if (!axis(__fsub_rn(z * sgn, oz), span, first_z, n, az_) ||
        !axis(__fsub_rn(y * sgn, oy), span, first_y, n, ay_) ||
        !axis(__fsub_rn(x * sgn, ox), span, first_x, n, ax_)) {
      *o = make_float2(0.f, 0.f);
      continue;
    }
    float wzy[4] = {__fmul_rn(az_.w0, ay_.w0), __fmul_rn(az_.w0, ay_.w1),
                    __fmul_rn(az_.w1, ay_.w0), __fmul_rn(az_.w1, ay_.w1)};
    int zs[4] = {az_.i0, az_.i0, az_.i0 + 1, az_.i0 + 1};
    int ys[4] = {ay_.i0, ay_.i0 + 1, ay_.i0, ay_.i0 + 1};
    float re = 0.f, im = 0.f;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      float wx = dx ? ax_.w1 : ax_.w0;
      if (wx == 0.f) continue;
      float tr = 0.f, ti = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float2 v = tap(vol, cell, n, zs[q], ys[q], ax_.i0 + dx, wzy[q]);
        tr = __fadd_rn(tr, v.x);
        ti = __fadd_rn(ti, v.y);
      }
      re = __fadd_rn(re, __fmul_rn(tr, wx));
      im = __fadd_rn(im, __fmul_rn(ti, wx));
    }
    *o = make_float2(re, im * sgn);
  }
}

}  // namespace

// table: (K, n, n, n) complex64 (cell 1) or HK1's quad table (K, n, n,
// n, 8) float32 (cell 4: a cell's own tap is its first float2)
extern "C" int thunder_project_brick(
    const void* table, int cell, int n, const void* cls, const void* rot, const void* mrot,
    int n_img, int n_rot, const void* i_col, const void* i_row, int n_pix, int pf, int span,
    int stride, int g, int nz, int nx, void* out, void* stream) {
  if ((long long)n_img * n_rot * n_pix > 0) {
    const int threads = 128;
    unsigned blocks = (unsigned)((long long)n_img * ((n_pix + threads - 1) / threads));
    project_brick_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float2*)table, cell, n, (const int*)cls, (const float*)rot, (const float*)mrot,
        n_rot, (const int*)i_col, (const int*)i_row, n_pix, pf, span, stride, g, nz, nx,
        (float2*)out);
  }
  return (int)cudaGetLastError();
}
