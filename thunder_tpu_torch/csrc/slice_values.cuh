// The value of a slice's pixel as the 3D insertions' first passes form
// it (HK3, HK10, HK11; ops/insert.py dense_slice_values):
//   mask_d = 2 at the DC, else 1
//   val    = ft[img[s], c + vr, c + vc] * conj(tra_s) * ctf * mask_d * w[s]
//   c2w    = ctf^2 * mask_d * w[s]
// tra_s the translation phase ramp, ctf from the image's constants, its
// defocus scaled by dfac[s] where one is given.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

struct SliceValues {
  const float2* ft;     // (L, size, size) image spectra, centered
  const float* ctfk;    // (L, 8) CTF constants
  const int* img_idx;   // (B,) image of each slice
  const float* trans;   // (B, 2)
  const float* dfac;    // (B,) defocus factors, or null: 1
  const float* wsl;     // (B,) slice weights
  int size;
  float box_a, tpos;    // the box in angstrom, 2 pi / size
};

__device__ __forceinline__ void slice_value(const SliceValues& V, int s, int vc, int vr,
                                            float& vre, float& vim, float& c2w) {
  int q2 = vc * vc + vr * vr;
  float mask_d = (q2 == 0) ? 2.f : 1.f;
  float w = V.wsl[s];
  int img = V.img_idx[s];
  int c = V.size / 2;
  float2 d = V.ft[((long long)img * V.size + (c + vr)) * V.size + (c + vc)];
  // translation ramp: tra = exp(-i phase), conj(tra) = exp(+i phase)
  float tx = V.trans[2 * s], ty = V.trans[2 * s + 1];
  float ph = V.tpos * ((float)vc * tx + (float)vr * ty);
  float cp = cosf(ph), sp = sinf(ph);
  float dr = d.x * cp - d.y * sp;
  float di = d.x * sp + d.y * cp;
  // CTF from the per-image constants
  // [k1, k2, w1, w2, defocus_u, defocus_v, defocus_theta, phase_shift]
  const float* k = V.ctfk + (long long)img * 8;
  float fx = (float)vc / V.box_a;
  float fy = (float)vr / V.box_a;
  float f = sqrtf(fx * fx + fy * fy);
  float ang = atan2f((float)vr, (float)vc);
  float du = k[4], dv = k[5];
  float defocus = -(du + dv + (du - dv) * cosf(2.f * (ang - k[6]))) / 2.f;
  // ctf_packed squares f; ctf_packed_scaled takes fx^2 + fy^2 as it is
  float f2 = V.dfac ? fx * fx + fy * fy : f * f;
  float dd = V.dfac ? V.dfac[s] : 1.f;
  float chi = k[0] * defocus * dd * f2 + k[1] * (f2 * f2) - k[7];
  float ctf = -k[2] * sinf(chi) + k[3] * cosf(chi);
  float cm = ctf * mask_d;
  vre = dr * cm * w;
  vim = di * cm * w;
  c2w = ctf * ctf * mask_d * w;
}
