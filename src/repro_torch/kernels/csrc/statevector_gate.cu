// Batched (optionally controlled) 2x2 complex gate on split float32
// statevector planes, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/statevector_gates.py
// (statevector_gate, body _kernel): for every batch row b, apply the
// row's gate g[b] (2x2 complex, re/im planes) to the qubit `target` of
// the (B, 2**n) statevector planes, only on basis states whose `control`
// bit is set (control < 0: on all).  Qubit q is bit n-1-q of the
// big-endian flat index, as in repro_torch.quantum.tape.pair_indices.
//
// Design: one thread per (row, amplitude pair).  The thread computes its
// pair (idx0 with the target bit 0, idx1 = idx0 | stride) and its control
// bit from (target, control, n_qubits) by the bit arithmetic of
// pair_indices, so no index tables are read.  It loads the row's eight
// gate floats (two float4) and its two amplitudes, and writes the two new
// amplitudes to separate output planes.  Each amplitude belongs to
// exactly one pair, so every output element is written exactly once.
//
// The pair update itself is svp::pair_update (statevector_pair.cuh),
// shared with the tape kernel (statevector_tape.cu), each product and sum
// rounded on its own, so a chain of these launches and one tape launch
// give the same bits.
//
// Bound: memory.  Per amplitude 8 bytes are read (re, im) and 8 written;
// the arithmetic (14 flops per amplitude) is far below the card's rate.
// At the quickstart size (B = 4750 rows of 16 amplitudes) one gate moves
// about 1.2 MB, a few hundred nanoseconds at 3.35 TB/s, so the launch
// itself bounds it there.  repro_torch.quantum.tape.run_tape takes this
// kernel only above the tape kernel's size limit (statevector_tape.cu),
// where a row's statevector no longer fits in shared memory.
//
// C interface for ctypes: the launch returns cudaGetLastError() as int.
#include <cuda_runtime.h>
#include <stdint.h>

#include "statevector_pair.cuh"

namespace {

__global__ void statevector_gate_kernel(
    const float* __restrict__ psi_re, const float* __restrict__ psi_im,
    const float4* __restrict__ g_re, const float4* __restrict__ g_im,
    float* __restrict__ out_re, float* __restrict__ out_im,
    int64_t n_threads, int log_half, int shift, int cshift, int controlled)
{
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_threads) return;
    const int64_t row = t >> log_half;
    const int64_t k = t & ((((int64_t)1) << log_half) - 1);
    const int64_t stride = ((int64_t)1) << shift;
    const int64_t i0 = (row << (log_half + 1))
        | ((k >> shift) << (shift + 1)) | (k & (stride - 1));
    const int64_t i1 = i0 | stride;

    float a0r = psi_re[i0], a0i = psi_im[i0];
    float a1r = psi_re[i1], a1i = psi_im[i1];
    // the row offset lies above bit log_half, so i0's low bits are the
    // pair's own flat index and the control test needs no subtraction
    if (!controlled || ((i0 >> cshift) & 1))
        svp::pair_update(g_re[row], g_im[row], a0r, a0i, a1r, a1i);
    out_re[i0] = a0r; out_im[i0] = a0i;
    out_re[i1] = a1r; out_im[i1] = a1i;
}

}  // namespace

extern "C" int svg_statevector_gate(
    const void* psi_re, const void* psi_im, const void* g_re,
    const void* g_im, void* out_re, void* out_im, long long batch,
    int n_qubits, int target, int control, void* stream)
{
    const int log_half = n_qubits - 1;
    const int64_t n_threads = (int64_t)batch << log_half;
    if (n_threads == 0) return (int)cudaSuccess;
    const int block = 256;
    const int64_t grid = (n_threads + block - 1) / block;
    const int shift = n_qubits - 1 - target;
    const int controlled = control >= 0;
    const int cshift = controlled ? n_qubits - 1 - control : 0;
    statevector_gate_kernel<<<(unsigned)grid, block, 0,
                              (cudaStream_t)stream>>>(
        (const float*)psi_re, (const float*)psi_im,
        (const float4*)g_re, (const float4*)g_im,
        (float*)out_re, (float*)out_im,
        n_threads, log_half, shift, cshift, controlled);
    return (int)cudaGetLastError();
}

extern "C" const char* svg_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
