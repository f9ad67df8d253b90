// XLA's float32 sin and cos on the CPU, elementwise, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package takes its gate matrices'
// sines and cosines with jnp.sin / jnp.cos (repro/quantum/statevector.py,
// repro/quantum/circuits.py), which XLA's CPU code computes with glibc's
// sinf / cosf.  The port's eager circuit (quantum/statevector.py,
// quantum/circuits.py) takes the same values through
// repro_torch.xla_trig.sincos: on the CPU the plain version
// (xla_trig.plain_sincos, torch), on the card this kernel, one launch
// for both functions of every value, where the plain version's hundred
// small torch operations a call would set the pace of the sequential
// engine's gate-by-gate circuit.
//
// Design: one thread a value, a grid-stride loop; xla_sincosf
// (xla_sincos.cuh) in double, bitwise the plain version.  Bound: bytes
// (4 read and 8 written a value) at the path's sizes, where launch
// latency dominates: the eager circuit's angles are one a gate, or one
// a row of a batch.
//
// C interface for ctypes: the launch returns cudaGetLastError() as int.
#include "xla_sincos.cuh"

namespace {

__global__ void __launch_bounds__(256) xla_sincos_kernel(
    const float* __restrict__ x, float* __restrict__ s,
    float* __restrict__ c, long long n)
{
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x)
        xla_sincosf(x[i], s + i, c + i);
}

}  // namespace

// x, s, c: n float32 values each, contiguous, on the current device
extern "C" int xs_sincos(const void* x, void* s, void* c, long long n,
                         void* stream)
{
    if (n <= 0) return (int)cudaSuccess;
    const long long want = (n + 255) / 256;
    const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
    xla_sincos_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)s, (float*)c, n);
    return (int)cudaGetLastError();
}

extern "C" const char* xs_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
