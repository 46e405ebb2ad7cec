// The shear sweep's order-free fixed-point sums (HK11 insert_sweep and
// its slab form in insert_trilinear.cu, HK12 insert_sweep_2d in
// insert_bilinear_2d.cu).
//
// A block owns a brick (3D) or a tile (2D) of cells in shared memory as
// 128-bit integers (four 32-bit words each), adds each (sample, cell)
// product there with integer atomics (``fixed_add3``), and writes the
// brick once: bricks are disjoint, so nothing is added in global memory.
// Integer addition is associative, so the sums, and the grids, repeat bit
// for bit whatever order the adds land in.
//
// The scale.  Each component (Re F, Im F, T) of a launch takes its own
// power of two 2^s with 2^s * bound < 2^126, where bound is at least what
// any cell's sum can reach: the sweep's weights of a sample sum to at
// most one (each hat a partition of unity), so |sum| <= count * max
// |value|, count the samples the launch may add (planes times in-disc
// pixels).  The maxima come from the values' own pass (an atomic max on
// the bits of non-negative floats: order-free too).  A tap adds
// rint(v * w * 2^s), v * w the float32 product formed as the plain version
// forms it, rounded to the nearest integer (ties to even), formed from the
// product's significand and exponent with integer operations.  128 bits
// leave 2^-s ~ 2^-99 max |value| at the rounds' counts, so every product
// that matters is added exactly: the grids' cells of tiny T, which the
// rounds' balance loop amplifies, keep their relative precision (64-bit
// sums, 2^-37 max |value|, rounded them away and moved the maps).  A
// cell's result is (float)(((w3 2^96 + w2 2^64) + (w1 2^32 + w0)) * 2^-s)
// in double, w3 signed, added to the grid where the sum is not zero.
// ops/insert.py's ``sweep_fixed_scales`` and ``_sweep_add_fixed`` emulate
// this bit for bit on any device.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sweepfx {

constexpr int FIXED_BITS = 126;
constexpr int WORDS = 4;   // 32-bit words a sum
// widens the candidate ranges against float rounding of the positions
// (|position| < ~300: errors ~1e-4 cells)
constexpr float RANGE_MARGIN = 5e-2f;

__device__ __forceinline__ float hat1(float t) { return fmaxf(0.f, __fsub_rn(1.f, fabsf(t))); }

// s with 2^s * bound < 2^126 (frexp: bound = f 2^e, 1/2 <= f < 1)
__device__ __forceinline__ int scale_exp(double bound) {
  int e;
  frexp(bound, &e);
  return FIXED_BITS - e;
}

// One tap's addend rint(v * w 2^s), the float32 product v * w formed as the
// plain version forms it: its magnitude is the 64-bit value (hi:lo)
// shifted left by 32 wi bits (lo and hi below 2^32 and 2^24), neg its
// sign; false when it is zero.  |v w| = m 2^(E - 150) with m its 24-bit
// significand, so the product times 2^s is m shifted by E - 150 + s:
// exact where that is not negative, else rounded to the nearest integer,
// ties to even.
struct Tap {
  unsigned lo, hi;
  int wi;
  bool neg;
};

__device__ __forceinline__ bool quantise(float v, float w, int s, Tap& q) {
  const unsigned b = __float_as_uint(__fmul_rn(v, w));
  const int ex = (int)((b >> 23) & 0xffu);
  unsigned m = b & 0x7fffffu;
  if (ex) m |= 0x800000u;
  const int sh = (ex ? ex : 1) - 150 + s;
  q.neg = (b >> 31) != 0u;
  if (sh >= 0) {   // below 2^126 - 2^24 by the bound: wi <= 3, hi = 0 at wi 3
    const int bit = sh & 31;
    q.wi = sh >> 5;
    q.lo = m << bit;
    q.hi = bit ? m >> (32 - bit) : 0u;
  } else {
    const int r = -sh;
    q.wi = 0;
    q.hi = 0u;
    if (r >= 32) {
      q.lo = 0u;
    } else {
      const unsigned keep = m >> r, rem = m & ((1u << r) - 1u), half = 1u << (r - 1);
      q.lo = keep + ((rem > half || (rem == half && (keep & 1u))) ? 1u : 0u);
    }
  }
  return (q.lo | q.hi) != 0u;
}

// Adds tap q[c] to component c's 128-bit sum (c = 0, 1, 2: Re F, Im F, T),
// two's complement, whose words lie ``stride`` apart from a[c * WORDS *
// stride] in shared memory (lowest first); nz[c] false: nothing to add.  A
// negative tap is subtracted, so no word above its magnitude is touched
// but for a borrow, as a positive one's carry.  Hopper has a native
// 32-bit shared-memory atomic add and subtract but no 64-bit add (that
// compiles to a compare-and-swap loop, ATOMS.CAST.SPIN.64).  Each word's
// add returns its old value, which says exactly whether this add carried
// (borrowed), and the carry goes to the next word with it: the words hold
// the sum of every tap modulo 2^128, whatever order the adds land in.
// The three components' adds of one word are issued together, so that
// their round trips overlap.
__device__ __forceinline__ void fixed_add3(unsigned* a, int stride, const Tap q[3],
                                           const bool nz[3]) {
  unsigned c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {   // the low word of the magnitude
    c[k] = 0u;
    if (nz[k] && q[k].lo) {
      unsigned* w = a + (k * WORDS + q[k].wi) * stride;
      if (q[k].neg) {
        const unsigned old = atomicSub(w, q[k].lo);
        c[k] = old < q[k].lo ? 1u : 0u;
      } else {
        const unsigned old = atomicAdd(w, q[k].lo);
        c[k] = old + q[k].lo < old ? 1u : 0u;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {   // the high word, with the carry (no overflow: hi < 2^24)
    const unsigned v = nz[k] ? q[k].hi + c[k] : 0u;
    int i = q[k].wi + 1;
    c[k] = 0u;
    if (v && i < WORDS) {
      unsigned* w = a + (k * WORDS + i) * stride;
      if (q[k].neg) {
        const unsigned old = atomicSub(w, v);
        c[k] = old < v ? 1u : 0u;
      } else {
        const unsigned old = atomicAdd(w, v);
        c[k] = old + v < old ? 1u : 0u;
      }
    }
    // a carry (borrow) past both words: rare
    for (++i; c[k] && i < WORDS; ++i) {
      unsigned* w = a + (k * WORDS + i) * stride;
      const unsigned old = q[k].neg ? atomicSub(w, 1u) : atomicAdd(w, 1u);
      c[k] = q[k].neg ? (old == 0u ? 1u : 0u) : (old == 0xffffffffu ? 1u : 0u);
    }
  }
}

// a sum's words back to float32, 1 / 2^s exact
__device__ __forceinline__ float unquantise(const unsigned* a, int stride, double inv) {
  const double hi = __dadd_rn(__dmul_rn((double)(int)a[3 * stride], 0x1p96),
                              __dmul_rn((double)a[2 * stride], 0x1p64));
  const double lo = __dadd_rn(__dmul_rn((double)a[stride], 0x1p32), (double)a[0]);
  return (float)__dmul_rn(__dadd_rn(hi, lo), inv);
}

// whether a sum's words are not all zero
__device__ __forceinline__ bool nonzero(const unsigned* a, int stride) {
  return (a[0] | a[stride] | a[2 * stride] | a[3 * stride]) != 0u;
}

// max of non-negative v over a block's threads into *at (float bits);
// every thread of the block calls it
__device__ __forceinline__ void block_max(float v, unsigned* at) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0 && v > 0.f) atomicMax(at, __float_as_uint(v));
}

// the integers t with coef * t in (lo, hi), widened by RANGE_MARGIN and
// clipped to [-rr, rr] (empty: t0 > t1)
__device__ __forceinline__ void pass_range(float lo, float hi, float coef, int rr, int& t0,
                                           int& t1) {
  float a = lo / coef, b = hi / coef;
  if (a > b) {
    const float c = a;
    a = b;
    b = c;
  }
  t0 = max(-rr, (int)ceilf(a - RANGE_MARGIN));
  t1 = min(rr, (int)floorf(b + RANGE_MARGIN));
}

}  // namespace sweepfx
