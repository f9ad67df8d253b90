// Fused distillation KL for Hopper (sm_90a): per row b,
//   KL_b = sum_c pt * (log pt - log softmax(z)_c),  pt = clip(t, eps, 1),
// teacher probabilities t and student logits z (B, C) float32 -> (B,).
//
// Replaces the TPU kernel src/repro/kernels/distill_kl.py (distill_kl,
// body _kernel), which fuses the max-shifted logsumexp with the KL sum
// so the student's normalised distribution never reaches memory.
//
// Design: one warp per row, 8 rows a CTA.  A first strided pass over
// the row keeps an online max and sum of exp(z - max) in each lane;
// the lanes merge them with shuffles into lse = max + log(sum), taken
// from lane 0 so every lane uses the same value.  A second strided pass
// sums pt * (log pt - (z - lse)), the reference's own per-element form
// (no cancellation between two large sums), and a shuffle tree reduces
// it.  Any B, and any C from 1 up; the row is read from device memory
// once and its second read hits the L1/L2 cache.  expf and logf are the
// accurate versions (no fast math).
//
// Why CUDA and not Triton: it follows the repository's one build route
// (nvcc and ctypes, no extra package at run time), and a warp reduction
// is all the kernel needs.
//
// Bound: bytes (8 * B * C read, 4 * B written; a handful of operations an
// element).  There is no backward, as in the JAX package.
//
// C interface for ctypes: the launch returns cudaGetLastError() as int.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
distill_kl_kernel(const float* __restrict__ t, const float* __restrict__ z,
                  float* __restrict__ out, int64_t B, int64_t C, float eps)
{
    const int lane = threadIdx.x % 32;
    const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
    if (row >= B) return;                // the whole warp leaves together
    const float* zr = z + row * C;
    const float* tr = t + row * C;

    // pass 1: online max and sum of exp(z - max)
    float m = -INFINITY, s = 0.f;
    for (int64_t c = lane; c < C; c += 32) {
        const float v = zr[c];
        if (v > m) {
            s = s * expf(m - v) + 1.f;
            m = v;
        } else {
            s += expf(v - m);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
        const float mo = __shfl_xor_sync(FULL, m, off);
        const float so = __shfl_xor_sync(FULL, s, off);
        const float mn = fmaxf(m, mo);
        s = (m == -INFINITY ? 0.f : s * expf(m - mn))
            + (mo == -INFINITY ? 0.f : so * expf(mo - mn));
        m = mn;
    }
    const float lse = __shfl_sync(FULL, m + logf(s), 0);

    // pass 2: sum pt * (log pt - log q)
    float kl = 0.f;
    for (int64_t c = lane; c < C; c += 32) {
        const float pt = fminf(fmaxf(tr[c], eps), 1.f);
        kl += pt * (logf(pt) - (zr[c] - lse));
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
        kl += __shfl_xor_sync(FULL, kl, off);
    if (lane == 0) out[row] = kl;
}

}  // namespace

extern "C" int dk_distill_kl(const void* t, const void* z, void* out,
                             long long B, long long C, float eps,
                             void* stream)
{
    if (B < 0 || C < 1) return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const int64_t blocks = (B + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    distill_kl_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                        (cudaStream_t)stream>>>(
        (const float*)t, (const float*)z, (float*)out, B, C, eps);
    return (int)cudaGetLastError();
}

extern "C" const char* dk_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
