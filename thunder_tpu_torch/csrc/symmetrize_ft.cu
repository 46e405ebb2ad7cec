// HK7 symmetrize_ft: point-group symmetrisation of the insertion grids.
//
// Replaces (thunder_tpu): recon/reconstructor.py symmetrize_ft, a
// lax.scan over the group's elements of a whole-grid trilinear gather,
// applied to F and, in a second call, to T of every class.
//
//   out(f) = grid(f) + sum over the mates s >= 1 of
//            [ |f| < max_radius_pad ] * trilinear(grid, R_s f)
//
// for F (complex64) and T (float32) of every grid g (hemisphere x class)
// in ONE launch (blockIdx.y = g).  Coordinates are centered (index = k +
// big / 2) and every tap index is clipped to [0, big - 1], as
// _gather_trilinear_3d clips it; the mates are added in the group's order.
//
// What bounds it on Hopper: bytes, each grid read once and written once
// (12 bytes a cell).  A thread that gathers its own taps from device
// memory (the first design) reads neighbouring rows, not neighbouring
// cells, under a quarter turn, so sector traffic set its time.  Here a
// block stages what its cells read in shared memory first, in one of two
// forms the wrapper picks from the group's matrices:
//
// * Orbit form, for groups whose mates are signed permutations (C2, C4,
//   D2, D4, O).  Then R_s f is a cell, and the float32 coordinate is that
//   cell up to ~1e-14, so the tap is the cell itself (the plain version's
//   weights are 0 and 1 to within that).  The grid is cut into odd bricks
//   of b^3 cells centered on multiples of b, a set that every signed
//   permutation maps onto itself (flat 23-31 x 23-31 x 1 bricks, long
//   rows, where z keeps its axis; cubes for O).  A block takes one orbit of bricks
//   under the group (the block of the orbit's least brick index; the
//   others return at once), copies each of its bricks into shared memory
//   once (cp.async), and writes each once: a cell is read once and
//   written once.  Taps that leave the grid (a coordinate of -big / 2 on
//   an even grid sent to +big / 2) are clipped and read from device
//   memory.
// * Box form, for every other group (C3, T, I, ...).  A block owns an 8^3
//   brick; for each mate it copies the box of its taps (at most 15 cells
//   an axis, clipped to the grid as the taps are) into one of two shared
//   buffers with cp.async while the previous mate's taps are blended
//   from the other, with the plain version's coordinates, weights and tap
//   order.  The box comes from the brick's corners: the float32
//   coordinate is monotone in each cell index, so its corners bound it.
//
// In both forms a brick wholly outside the band only copies, and one
// wholly inside skips the per-cell test.

#include <cuda_runtime.h>

namespace {

constexpr int BOX_BRICK = 8;        // box form: an 8^3 output brick, a thread a cell
constexpr int BOX_MAX = 16;         // a box edge: a rotated brick's taps span at most 15 cells
constexpr int ORBIT_THREADS = 512;  // orbit form: threads a block
constexpr int MAX_ORBIT = 24;       // the order of O, the largest rotation group of signed permutations
constexpr int MIN_BLOCKS = 2;       // blocks of 512 threads an SM: at most 64 registers a thread

struct SymArgs {
  const float2* f_in;
  const float* t_in;
  float2* f_out;
  float* t_out;
  const float* mats;    // (1 + n_mates, 3, 3) float32, the identity first
  const int* reps;      // orbit form: the least brick index of each orbit, a block each
  int n_mates, big;
  int orbit;            // 1: orbit form, 0: box form
  int bx, by, bz;       // orbit form: the odd brick edges
  int nx, ny, nz;       // bricks an axis: orbit 2M + 1 (indices -M..M), box ceil(big / 8)
  int blocks;           // blocks a grid
  float r2max;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the min and max of k^2 over the integers of [lo, hi]
__device__ __forceinline__ void sq_range(int lo, int hi, int& mn, int& mx) {
  mn = lo > 0 ? lo * lo : hi < 0 ? hi * hi : 0;
  mx = max(lo * lo, hi * hi);
}

// the plain version's rotated coordinate, without FMA contraction
__device__ __forceinline__ float rot_row(const float* R, float kx, float ky, float kz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(R[0], kx), __fmul_rn(R[1], ky)), __fmul_rn(R[2], kz));
}

// The orbit form for odd brick edges BX x BY x BZ (see the header; an
// edge is the same on two axes that a mate exchanges).  A block an orbit,
// named by its least brick index (recon/reconstructor.py SymForm.reps).
template <int BX, int BY, int BZ>
__device__ void orbit_path(const SymArgs& g, float* smem) {
  constexpr int B3 = BX * BY * BZ;
  constexpr int BS[3] = {BX, BY, BZ}, HS[3] = {(BX - 1) / 2, (BY - 1) / 2, (BZ - 1) / 2};
  constexpr int ST[3] = {1, BX, BX * BY};             // a brick's strides in shared memory
  __shared__ int ax[MAX_ORBIT][3], sg[MAX_ORBIT][3];   // mate s: axis a reads sg * k[ax]
  __shared__ int cf[MAX_ORBIT][3];                     // mate s: a tap's offset per (ux, uy, uz)
  __shared__ int orb[MAX_ORBIT][3], full[MAX_ORBIT];   // the orbit's bricks; wholly in the grid?
  __shared__ int jc[MAX_ORBIT][MAX_ORBIT];             // (o, s): the tap's offset at u = 0
  __shared__ int n_orb;
  const int big = g.big, c = big / 2, n_el = g.n_mates + 1;
  const int NS[3] = {g.nx, g.ny, g.nz}, MS[3] = {g.nx / 2, g.ny / 2, g.nz / 2};
  const int tid = threadIdx.x, nth = blockDim.x;
  const long long cells = (long long)big * big * big, base = (long long)blockIdx.y * cells;
  const float2* __restrict__ F = g.f_in + base;
  const float* __restrict__ T = g.t_in + base;
  float2* __restrict__ f_out = g.f_out + base;
  float* __restrict__ t_out = g.t_out + base;
  float2* f_s = (float2*)smem;                          // [n_orb][B3]
  float* t_s = (float*)(f_s + n_el * B3);               // [n_orb][B3]

  for (int i = tid; i < n_el * 3; i += nth) {
    const float* R = g.mats + 9 * (i / 3) + 3 * (i % 3);
    int s = i / 3, a = i % 3;
    int j = fabsf(R[0]) > 0.5f ? 0 : fabsf(R[1]) > 0.5f ? 1 : 2;
    int sgn = R[j] > 0.f ? 1 : -1;
    ax[s][a] = j;
    sg[s][a] = sgn;
    cf[s][j] = sgn * ST[a];                             // u'_a = H_a + sg (u[j] - H_j)
  }
  __syncthreads();
  auto in_grid = [&](int k) { return k >= -c && k < big - c; };

  {
    const int brick = g.reps[blockIdx.x];
    const int m0[3] = {brick % NS[0] - MS[0], (brick / NS[0]) % NS[1] - MS[1],
                       brick / (NS[0] * NS[1]) - MS[2]};
    int mn = 0, mx = 0;                                 // the band test on the whole brick
    for (int a = 0; a < 3; ++a) {
      int lo, hi;
      sq_range(BS[a] * m0[a] - HS[a], BS[a] * m0[a] + HS[a], lo, hi);
      mn += lo;
      mx += hi;
    }
    const bool all_out = (float)mn >= g.r2max, all_in = (float)mx < g.r2max;

    if (tid == 0) {
      int n = 0;
      for (int s = 0; s < n_el; ++s) {
        int q[3];
        for (int a = 0; a < 3; ++a) q[a] = sg[s][a] * m0[ax[s][a]];
        int seen = 0;
        for (int o = 0; o < n; ++o)
          seen |= orb[o][0] == q[0] && orb[o][1] == q[1] && orb[o][2] == q[2];
        if (!seen) {
          int f = 1;
          for (int a = 0; a < 3; ++a) {
            orb[n][a] = q[a];
            f &= in_grid(BS[a] * q[a] - HS[a]) && in_grid(BS[a] * q[a] + HS[a]);
          }
          full[n++] = f;
        }
      }
      n_orb = n;
    }
    __syncthreads();
    const int no = n_orb;
    for (int i = tid; i < no * n_el; i += nth) {
      int o = i / n_el, s = i % n_el, q[3];
      for (int a = 0; a < 3; ++a) q[a] = sg[s][a] * orb[o][ax[s][a]];
      int o2 = 0;
      for (int k = 0; k < no; ++k)
        if (orb[k][0] == q[0] && orb[k][1] == q[1] && orb[k][2] == q[2]) o2 = k;
      int off = o2 * B3;
      for (int a = 0; a < 3; ++a) off += ST[a] * HS[a] * (1 - sg[s][a]);
      jc[o][s] = off;
    }
    // the in-grid cells of the orbit's bricks, each read once, all in flight
    for (int i = tid; i < no * B3; i += nth) {
      int o = i / B3, r = i - o * B3;
      int k0 = BX * orb[o][0] - HS[0] + r % BX, k1 = BY * orb[o][1] - HS[1] + (r / BX) % BY,
          k2 = BZ * orb[o][2] - HS[2] + r / (BX * BY);
      if (!full[o] && !(in_grid(k0) && in_grid(k1) && in_grid(k2))) continue;
      long long at = ((long long)(k2 + c) * big + (k1 + c)) * big + (k0 + c);
      cp_async<8>(f_s + i, F + at);
      cp_async<4>(t_s + i, T + at);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int i = tid; i < no * B3; i += nth) {
      int o = i / B3, r = i - o * B3;
      int ux = r % BX, uy = (r / BX) % BY, uz = r / (BX * BY);
      int k0 = BX * orb[o][0] - HS[0] + ux, k1 = BY * orb[o][1] - HS[1] + uy,
          k2 = BZ * orb[o][2] - HS[2] + uz;
      if (!full[o] && !(in_grid(k0) && in_grid(k1) && in_grid(k2))) continue;
      float2 f = f_s[i];
      float tt = t_s[i];
      if (!all_out && (all_in || k0 * k0 + k1 * k1 + k2 * k2 < g.r2max)) {
        const int k[3] = {k0, k1, k2};
        for (int s = 1; s < n_el; ++s) {
          int j = jc[o][s] + cf[s][0] * ux + cf[s][1] * uy + cf[s][2] * uz;
          float2 v;
          float vt;
          int q[3];
          bool in = true;
          if (!full[jc[o][s] / B3]) {
            for (int a = 0; a < 3; ++a) {
              q[a] = sg[s][a] * k[ax[s][a]];
              in = in && in_grid(q[a]);
            }
          }
          if (in) {
            v = f_s[j];
            vt = t_s[j];
          } else {                                      // a tap past the face: clipped
            long long at = 0;
            for (int a = 2; a >= 0; --a) at = at * big + min(max(q[a], -c), big - 1 - c) + c;
            v = __ldg(F + at);
            vt = __ldg(T + at);
          }
          f.x += v.x;
          f.y += v.y;
          tt += vt;
        }
      }
      long long at = ((long long)(k2 + c) * big + (k1 + c)) * big + (k0 + c);
      f_out[at] = f;
      t_out[at] = tt;
    }
  }
}

__device__ void box_path(const SymArgs& g, float* smem) {
  const int big = g.big, c = big / 2, nb = g.nx;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int o[3] = {(b % nb) * BOX_BRICK, ((b / nb) % nb) * BOX_BRICK, (b / (nb * nb)) * BOX_BRICK};
  const int ix = o[0] + tid % BOX_BRICK, iy = o[1] + (tid / BOX_BRICK) % BOX_BRICK,
            iz = o[2] + tid / (BOX_BRICK * BOX_BRICK);
  const bool valid = ix < big && iy < big && iz < big;
  const int hi[3] = {min(o[0] + BOX_BRICK, big) - 1, min(o[1] + BOX_BRICK, big) - 1,
                     min(o[2] + BOX_BRICK, big) - 1};
  const long long cells = (long long)big * big * big, base = (long long)blockIdx.y * cells;
  const float2* F = g.f_in + base;
  const float* T = g.t_in + base;
  const long long cell = ((long long)iz * big + iy) * big + ix;
  float2 f = valid ? F[cell] : make_float2(0.f, 0.f);
  float tt = valid ? T[cell] : 0.f;
  int mn = 0, mx = 0;
  for (int a = 0; a < 3; ++a) {
    int l2, h2;
    sq_range(o[a] - c, hi[a] - c, l2, h2);
    mn += l2;
    mx += h2;
  }
  const float kx = (float)(ix - c), ky = (float)(iy - c), kz = (float)(iz - c);
  const bool inside = valid && ((float)mx < g.r2max || kx * kx + ky * ky + kz * kz < g.r2max);
  if ((float)mn < g.r2max) {
    constexpr int BOX3 = BOX_MAX * BOX_MAX * BOX_MAX;
    float2* fb = (float2*)smem;                      // [2][BOX3]
    float* tb = (float*)(fb + 2 * BOX3);              // [2][BOX3]
    int* box = (int*)(tb + 2 * BOX3);                 // [n_mates][6]: first cell, extent
    // each mate's box from the brick's corners: [floor(min), floor(max) + 1]
    // clipped to the grid, at most 15 cells an axis (7 sqrt(3) + 2)
    for (int s = tid; s < g.n_mates; s += blockDim.x) {
      const float* R = g.mats + 9 * (s + 1);
      for (int a = 0; a < 3; ++a) {
        float lo = 3.4e38f, up = -3.4e38f;
        for (int q = 0; q < 8; ++q) {
          float v = rot_row(R + 3 * a, (float)((q & 1 ? hi[0] : o[0]) - c),
                            (float)((q & 2 ? hi[1] : o[1]) - c), (float)((q & 4 ? hi[2] : o[2]) - c));
          lo = fminf(lo, v);
          up = fmaxf(up, v);
        }
        int first = min(max((int)floorf(lo) + c, 0), big - 1);
        box[6 * s + a] = first;
        box[6 * s + 3 + a] = min(max((int)floorf(up) + 1 + c, 0), big - 1) - first + 1;
      }
    }
    __syncthreads();
    auto issue = [&](int s, int buf) {
      const int* bx = box + 6 * (s - 1);
      const int nx = bx[3], nxy = bx[3] * bx[4];
      for (int i = tid; i < nxy * bx[5]; i += blockDim.x) {
        int uz = i / nxy, uy = (i - uz * nxy) / nx, ux = i - uz * nxy - uy * nx;
        long long at = ((long long)(bx[2] + uz) * big + bx[1] + uy) * big + bx[0] + ux;
        int j = buf * BOX3 + (uz * BOX_MAX + uy) * BOX_MAX + ux;
        cp_async<8>(fb + j, F + at);
        cp_async<4>(tb + j, T + at);
      }
      cp_async_commit();
    };
    issue(1, 0);
    for (int s = 1; s <= g.n_mates; ++s) {
      cp_async_wait_all();
      __syncthreads();                                // mate s landed; mate s - 1 blended by all
      if (s < g.n_mates) issue(s + 1, s & 1);
      if (inside) {
        const float* R = g.mats + 9 * s;
        const int* bx = box + 6 * (s - 1);
        const float2* fs = fb + ((s - 1) & 1) * BOX3;
        const float* ts = tb + ((s - 1) & 1) * BOX3;
        float x = rot_row(R, kx, ky, kz), y = rot_row(R + 3, kx, ky, kz),
              z = rot_row(R + 6, kx, ky, kz);
        float flx = floorf(x), fly = floorf(y), flz = floorf(z);
        float wx = x - flx, wy = y - fly, wz = z - flz;
        int jx = (int)flx + c, jy = (int)fly + c, jz = (int)flz + c;
        int x0 = min(max(jx, 0), big - 1) - bx[0], x1 = min(max(jx + 1, 0), big - 1) - bx[0];
        int y0 = min(max(jy, 0), big - 1) - bx[1], y1 = min(max(jy + 1, 0), big - 1) - bx[1];
        int z0 = min(max(jz, 0), big - 1) - bx[2], z1 = min(max(jz + 1, 0), big - 1) - bx[2];
        int r00 = (z0 * BOX_MAX + y0) * BOX_MAX, r01 = (z0 * BOX_MAX + y1) * BOX_MAX;
        int r10 = (z1 * BOX_MAX + y0) * BOX_MAX, r11 = (z1 * BOX_MAX + y1) * BOX_MAX;
        int idx[8] = {r00 + x0, r00 + x1, r01 + x0, r01 + x1, r10 + x0, r10 + x1, r11 + x0, r11 + x1};
        float w[8] = {(1.f - wz) * (1.f - wy) * (1.f - wx), (1.f - wz) * (1.f - wy) * wx,
                      (1.f - wz) * wy * (1.f - wx),         (1.f - wz) * wy * wx,
                      wz * (1.f - wy) * (1.f - wx),         wz * (1.f - wy) * wx,
                      wz * wy * (1.f - wx),                 wz * wy * wx};
        float2 v = fs[idx[0]];
        float gr = v.x * w[0], gi = v.y * w[0], gt = ts[idx[0]] * w[0];
#pragma unroll
        for (int i = 1; i < 8; ++i) {
          v = fs[idx[i]];
          gr += v.x * w[i];
          gi += v.y * w[i];
          gt += ts[idx[i]] * w[i];
        }
        f.x += gr;
        f.y += gi;
        tt += gt;
      }
    }
  }
  if (valid) {
    g.f_out[base + cell] = f;
    g.t_out[base + cell] = tt;
  }
}

// MIN_BLOCKS: blocks of 512 threads an SM the registers must allow
template <int MIN_BLOCKS>
__global__ void __launch_bounds__(512, MIN_BLOCKS) symmetrize_ft_kernel(SymArgs g) {
  extern __shared__ float4 smem4[];
  switch (g.orbit ? g.bx * 100 + g.bz : 0) {
    case 3101: orbit_path<31, 31, 1>(g, (float*)smem4); break;
    case 2901: orbit_path<29, 29, 1>(g, (float*)smem4); break;
    case 2701: orbit_path<27, 27, 1>(g, (float*)smem4); break;
    case 2501: orbit_path<25, 25, 1>(g, (float*)smem4); break;
    case 2301: orbit_path<23, 23, 1>(g, (float*)smem4); break;
    case 1501: orbit_path<15, 15, 1>(g, (float*)smem4); break;
    case 1111: orbit_path<11, 11, 11>(g, (float*)smem4); break;
    case 909: orbit_path<9, 9, 9>(g, (float*)smem4); break;
    case 707: orbit_path<7, 7, 7>(g, (float*)smem4); break;
    case 505: orbit_path<5, 5, 5>(g, (float*)smem4); break;
    default: box_path(g, (float*)smem4);
  }
}

}  // namespace

// args: a SymArgs (grids contiguous (G, big, big, big), mats on the card);
// threads, smem: recon/reconstructor.py symmetrize_plan; one launch over
// the G grids
template <int MIN_BLOCKS>
int launch_symmetrize_ft(const void* args, int n_grids, int threads, int smem, void* stream) {
  const SymArgs* g = (const SymArgs*)args;
  if (n_grids <= 0 || g->big <= 0) return 0;
  auto kernel = symmetrize_ft_kernel<MIN_BLOCKS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)g->blocks, (unsigned)n_grids);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(*g);
  return (int)cudaGetLastError();
}

extern "C" int thunder_symmetrize_ft(const void* args, int n_grids, int threads, int smem,
                                     void* stream) {
  return launch_symmetrize_ft<MIN_BLOCKS>(args, n_grids, threads, smem, stream);
}
