// A weight draw, jax.random.truncated_normal times a scale, written in
// the weight's dtype, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package draws every base weight with
// jax.random.truncated_normal(key, -2, 2, shape) * scale
// (repro/models/common.py); the port's init_dense draws the same values
// through repro_torch.random.truncated_normal, whose float64 emulation of
// XLA's fused multiply-adds makes a few hundred passes over each slice of
// the leaf.  On the card this kernel draws a whole leaf in one pass: at
// kimi-k2's 384 experts a layer the plain version took minutes.
//
// Design: one thread a value, a grid-stride loop over the flat index;
// tn_value (trunc_normal.cuh) computes the value from the key and its
// index alone, so any slice [start, start + n) of a draw is bitwise the
// same elements of the whole.  The float32 value is scaled and rounded
// once to the output dtype (float32 or bfloat16).  Bound:
// operations (the hash's 20 rounds and two polynomials a value) above
// the bytes written.
//
// C interface for ctypes: the launch returns cudaGetLastError() as int.
#include <cuda_bf16.h>

#include "trunc_normal.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T tn_cast(float v);

template <>
__device__ __forceinline__ float tn_cast<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 tn_cast<__nv_bfloat16>(float v)
{
    return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256) trunc_normal_kernel(
    T* __restrict__ out, long long n, unsigned long long start,
    uint32_t k0, uint32_t k1, float a, float span, float clamp_lo,
    float clamp_hi, float std_)
{
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x)
        out[i] = tn_cast<T>(tn_value(k0, k1, start + (unsigned long long)i,
                                     a, span, clamp_lo, clamp_hi, std_));
}

template <typename T>
int launch(void* out, long long n, unsigned long long start, uint32_t k0,
           uint32_t k1, float a, float span, float clamp_lo,
           float clamp_hi, float std_, cudaStream_t stream)
{
    const long long want = (n + 255) / 256;
    const unsigned blocks = (unsigned)(want < 16384 ? want : 16384);
    trunc_normal_kernel<T><<<blocks, 256, 0, stream>>>(
        (T*)out, n, start, k0, k1, a, span, clamp_lo, clamp_hi, std_);
    return (int)cudaGetLastError();
}

}  // namespace

// out: n values of ``dtype`` (0 float32, 1 bfloat16),
// contiguous, on the current device: elements start .. start + n - 1 of
// the draw of key (k0, k1), uniforms in [a, a + span), values clamped to
// [clamp_lo, clamp_hi] and scaled by std_
extern "C" int tn_draw(void* out, long long n, unsigned long long start,
                       unsigned k0, unsigned k1, float a, float span,
                       float clamp_lo, float clamp_hi, float std_,
                       int dtype, void* stream)
{
    if (n <= 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    switch (dtype) {
    case 0:
        return launch<float>(out, n, start, k0, k1, a, span, clamp_lo,
                             clamp_hi, std_, s);
    case 1:
        return launch<__nv_bfloat16>(out, n, start, k0, k1, a, span,
                                     clamp_lo, clamp_hi, std_, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* tn_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
