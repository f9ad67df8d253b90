// XLA's float32 sin and cos on the CPU, for the tape kernel
// (statevector_tape.cu) and the elementwise kernel (xla_sincos.cu).
//
// XLA's CPU backend calls the C library's sinf / cosf, so under the JAX
// package's jax on glibc 2.36 the gate angles' sines and cosines are
// glibc's (sysdeps/ieee754/flt-32/s_sinf.c): the quadrant from y * 2/pi,
// a reduction in double (one fused multiply-add below 120, 4/pi to 192
// bits above), a polynomial in double with its multiply-adds fused, one
// rounding to float.  repro_torch/xla_trig.py's plain_sincos is the same
// algorithm in torch; here the fused steps are __fma_rn and every other
// step an explicit round-to-nearest intrinsic, so nvcc contracts nothing
// and the values are bitwise the plain version's on any input.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// glibc's __inv_pio4: 4/pi in overlapping 32-bit windows
__constant__ unsigned kInvPio4[24] = {
    0xa2u, 0xa2f9u, 0xa2f983u, 0xa2f9836eu, 0xf9836e4eu, 0x836e4e44u,
    0x6e4e4415u, 0x4e441529u, 0x441529fcu, 0x1529fc27u, 0x29fc2757u,
    0xfc2757d1u, 0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu, 0xf534ddc0u,
    0x34ddc0dbu, 0xddc0db62u, 0xc0db6295u, 0xdb629599u, 0x6295993cu,
    0x95993c43u, 0x993c4390u, 0x3c439041u};

__device__ __forceinline__ void xla_sincosf(float y, float* sp, float* cp)
{
    const unsigned bits = __float_as_uint(y) & 0x7fffffffu;
    const unsigned top = bits >> 20;
    if (bits >= 0x7f800000u) {                   // inf, nan
        *sp = *cp = __int_as_float(0x7fc00000);
        return;
    }
    if (top < 0x398u) {                          // |y| < 2**-12
        *sp = y;
        *cp = 1.f;
        return;
    }
    const bool big = top >= 0x42fu;              // |y| >= 120
    double r;
    int n;
    if (!big) {
        const double x = (double)y;
        const int t = __double2int_rz(__dmul_rn(x, 0x1.45f306dc9c883p+23));
        n = (t + 0x800000) >> 24;
        r = __fma_rn(-(double)n, 0x1.921fb54442d18p+0, x);
    } else {                                     // from |y|
        const unsigned* arr = &kInvPio4[(bits >> 26) & 15];
        const int shift = (bits >> 23) & 7;
        const unsigned xi = ((bits & 0xffffffu) | 0x800000u) << shift;
        uint64_t res0 = (uint64_t)(unsigned)(xi * arr[0]);
        const uint64_t res1 = (uint64_t)xi * arr[4];
        const uint64_t res2 = (uint64_t)xi * arr[8];
        res0 = (res2 >> 32) | (res0 << 32);
        res0 += res1;
        const uint64_t q = (res0 + (1ull << 61)) >> 62;
        res0 -= q << 62;
        r = __dmul_rn(__ll2double_rn((long long)res0), 0x1.921fb54442d18p-62);
        n = (int)q;
    }
    const double x2 = __dmul_rn(r, r);
    const double x3 = __dmul_rn(r, x2);
    const double s1 = __fma_rn(x2, -0x1.994eb3774cf24p-13, 0x1.1107605230bc4p-7);
    const double x7 = __dmul_rn(x3, x2);
    const double s = __fma_rn(x3, -0x1.555545995a603p-3, r);
    const double ps = __fma_rn(x7, s1, s);
    const double x4 = __dmul_rn(x2, x2);
    const double c2 = __fma_rn(x2, 0x1.99343027bf8c3p-16, -0x1.6c087e89a359dp-10);
    const double c1 = __fma_rn(x2, -0x1.ffffffd0c621cp-2, 1.0);
    const double x6 = __dmul_rn(x4, x2);
    const double c = __fma_rn(x4, 0x1.55553e1068f19p-5, c1);
    const double pc = __fma_rn(x6, c2, c);
    const int q = n & 3;
    double sv = (q & 1) ? pc : ps, cv = (q & 1) ? ps : pc;
    if (q >= 2) sv = -sv;
    if (q == 1 || q == 2) cv = -cv;
    float fs = __double2float_rn(sv);
    if (big && y < 0.f) fs = -fs;
    *sp = fs;
    *cp = __double2float_rn(cv);
}
