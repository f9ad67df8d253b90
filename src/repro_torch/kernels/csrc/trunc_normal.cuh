// One value of jax.random.truncated_normal(key, lower, upper) in float32,
// as repro_torch.random.truncated_normal computes it: Threefry-2x32 on
// the value's flat index, the uniform in [a, b) it maps to, and XLA's
// float32 erf_inv over XLA's CPU log1p and log (Cephes' forms), every
// multiply-add fused where XLA fuses it.
//
// Every step is one IEEE operation rounded to nearest, written as an
// intrinsic (__fmul_rn, __fadd_rn, __fmaf_rn, ...) so that nvcc cannot
// contract a product and a sum into a multiply-add the plain version
// does not make: the value is bitwise the plain version's on any device.
// Constants are the plain version's Python floats rounded to float32
// (a double literal cast to float, never a float literal, which rounds
// once from decimal and may differ).
#pragma once

#include <stdint.h>

#define TN_F(v) static_cast<float>(v)

__device__ __forceinline__ uint32_t tn_rotl(uint32_t v, int r)
{
    return (v << r) | (v >> (32 - r));
}

// Threefry-2x32, 20 rounds, on the counter (hi, lo); returns b0 ^ b1
__device__ __forceinline__ uint32_t tn_bits(uint32_t k0, uint32_t k1,
                                            uint32_t hi, uint32_t lo)
{
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t x0 = hi + ks[0], x1 = lo + ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = tn_rotl(x1, rot[i % 2][j]) ^ x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
    }
    return x0 ^ x1;
}

// XLA's float32 log on the CPU (Cephes logf) for x >= 0
__device__ __forceinline__ float tn_log(float x)
{
    int ei;
    float m = frexpf(x, &ei);                 // x = m * 2**e, m in [0.5, 1)
    const bool lo = m < TN_F(0.707106781186547524);
    const float e = (float)(lo ? ei - 1 : ei);
    m = lo ? __fadd_rn(__fsub_rn(m, 1.0f), m) : __fsub_rn(m, 1.0f);
    const float m2 = __fmul_rn(m, m);
    const float m3 = __fmul_rn(m2, m);
    float y = __fmaf_rn(TN_F(7.0376836292E-2), m, TN_F(-1.1514610310E-1));
    float y1 = __fmaf_rn(TN_F(-1.2420140846E-1), m, TN_F(1.4249322787E-1));
    float y2 = __fmaf_rn(TN_F(2.0000714765E-1), m, TN_F(-2.4999993993E-1));
    y = __fmaf_rn(y, m, TN_F(1.1676998740E-1));
    y1 = __fmaf_rn(y1, m, TN_F(-1.6668057665E-1));
    y2 = __fmaf_rn(y2, m, TN_F(3.3333331174E-1));
    y = __fmaf_rn(y, m3, y1);
    y = __fmul_rn(__fmaf_rn(y, m3, y2), m3);
    y = __fmaf_rn(TN_F(-2.12194440e-4), e, y);
    const float out = __fadd_rn(__fmaf_rn(-m2, 0.5f, m), y);
    return __fmaf_rn(TN_F(0.693359375), e, out);
}

// XLA's float32 log1p on the CPU: Cephes' rational form below
// sqrt(2) - 1, else log(1 + x)
__device__ __forceinline__ float tn_log1p(float x)
{
    const float num_c[7] = {
        TN_F(4.5270000862445199635215E-5), TN_F(4.9854102823193375972212E-1),
        TN_F(6.5787325942061044846969E0), TN_F(2.9911919328553073277375E1),
        TN_F(6.0949667980987787057556E1), TN_F(5.7112963590585538103336E1),
        TN_F(2.0039553499201281259648E1)};
    const float den_c[7] = {
        TN_F(1.), TN_F(1.5062909083469192043167E1),
        TN_F(8.3047565967967209469434E1), TN_F(2.2176239823732856465394E2),
        TN_F(3.0909872225312059774938E2), TN_F(2.1642788614495947685003E2),
        TN_F(6.0118660497603843919306E1)};
    float num = 0.0f, den = 0.0f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        num = __fmaf_rn(num, x, num_c[i]);
        den = __fmaf_rn(den, x, den_c[i]);
    }
    const float x2 = __fmul_rn(x, x);
    float small = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
    small = __fadd_rn(x, __fmaf_rn(-0.5f, x2, small));
    if (fabsf(x) < TN_F(0.41421356237309504880)) return small;
    return tn_log(__fadd_rn(1.0f, x));
}

// XLA's float32 erf_inv (Giles' polynomial)
__device__ __forceinline__ float tn_erf_inv(float x)
{
    const float small_c[9] = {
        TN_F(2.81022636e-08), TN_F(3.43273939e-07), TN_F(-3.5233877e-06),
        TN_F(-4.39150654e-06), TN_F(0.00021858087), TN_F(-0.00125372503),
        TN_F(-0.00417768164), TN_F(0.246640727), TN_F(1.50140941)};
    const float big_c[9] = {
        TN_F(-0.000200214257), TN_F(0.000100950558), TN_F(0.00134934322),
        TN_F(-0.00367342844), TN_F(0.00573950773), TN_F(-0.0076224613),
        TN_F(0.00943887047), TN_F(1.00167406), TN_F(2.83297682)};
    float w = -tn_log1p(-__fmul_rn(x, x));
    const bool lt = w < 5.0f;
    w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
    float p = lt ? small_c[0] : big_c[0];
#pragma unroll
    for (int i = 1; i < 9; ++i)
        p = __fmaf_rn(p, w, lt ? small_c[i] : big_c[i]);
    if (fabsf(x) == 1.0f) return __fmul_rn(x, TN_F(3.4028234663852886e+38));
    return __fmul_rn(p, x);
}

// Element ``idx`` of the draw: the uniform in [a, a + span) clamped at
// a, sqrt(2)·erf_inv of it clamped to [clamp_lo, clamp_hi], times std
__device__ __forceinline__ float tn_value(
    uint32_t k0, uint32_t k1, unsigned long long idx, float a, float span,
    float clamp_lo, float clamp_hi, float std_)
{
    const uint32_t bits = tn_bits(k0, k1, (uint32_t)(idx >> 32),
                                  (uint32_t)(idx & 0xFFFFFFFFull));
    const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                              1.0f);
    const float u = fmaxf(__fmaf_rn(f, span, a), a);
    float v = __fmul_rn(TN_F(1.41421353816986083984375), tn_erf_inv(u));
    v = fminf(fmaxf(v, clamp_lo), clamp_hi);
    return __fmul_rn(v, std_);
}
