// A whole compiled gate tape replayed on a batch of statevectors in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/statevector_gates.py
// (statevector_gate, body _kernel) together with the scan that calls it
// once a gate (src/repro/quantum/tape.py, run_tape): for every batch row,
// start from |0...0>, apply the tape's G (optionally controlled) 2x2
// gates in order, and write the final (re, im) planes (B, 2**n).  Gate g
// of row b is the matrix of gate_id[g] at angle angles[b, g] (H, P(a),
// RY(a), RZ(a), X: the expressions of ref.gate_planes, entry for entry),
// acting on qubit target[g] where qubit control[g] is set (-1: always).
// Qubit q is bit n-1-q of the big-endian flat index.
//
// Design: the state never leaves the chip between gates.  A row's
// statevector lives in shared memory as (re, im) float2 pairs; the CTA
// builds it as |0...0>, applies every gate there and writes the planes
// to HBM once.
//  - n <= 6 (at most 32 amplitude pairs a row): a group of 2**(n-1)
//    lanes of one warp owns a row, one pair a lane a gate, and the group
//    synchronises with __syncwarp; a 128-thread CTA holds 128 / 2**(n-1)
//    rows.
//  - 7 <= n <= kMaxQubits: a CTA of min(2**(n-1), 256) threads owns a
//    row and synchronises with __syncthreads.
//  - The tape is consumed in chunks of up to 64 gates.  The CTA stages
//    each gate's pair geometry (the bit masks that enumerate the pairs
//    it acts on, from target and control) in shared memory, and each row
//    builds its gate matrices from its angles (4 bytes a gate a row, not
//    the 32 of a matrix), both from one round of global loads; then the
//    rows replay the chunk.  A controlled gate enumerates only the
//    quarter of the amplitudes whose control bit is set, so no thread
//    idles on the half it leaves alone.  The next gate's geometry and
//    matrix are read while the current gate is applied.
//  - The pair update is svp::pair_update (statevector_pair.cuh), the one
//    the per-gate kernel uses, with every product and sum rounded on its
//    own; the gate angles' sines and cosines are XLA's float32 ones
//    (xla_sincosf, in double), as ref.gate_planes takes them.  So a
//    replay is bitwise equal to ref.gate_planes followed by G launches
//    of statevector_gate.cu.
//
// Size rule: a row's state takes 8 * 2**n bytes of shared memory, so the
// largest n whose CTA fits in an SM's 227 KB is kMaxQubits = 14 (128 KB a
// row; n = 15 would need 256 KB).  Above it the caller
// (repro_torch.quantum.tape.run_tape) replays the tape with the per-gate
// kernel; this launch refuses such n.  The Python wrapper
// (statevector_tape.py) holds the same limit and checks it against
// svt_max_qubits when it loads the library.
//
// Bound: a gate touches each of the 2**(n-1) pairs it acts on once (half
// of them for a controlled gate): 32 bytes of shared-memory traffic and
// 28 flops (16 products, 12 sums) a pair.  HBM sees only the angles
// (4 * B * G bytes) and the final planes (8 * B * 2**n bytes).  At the
// wide shape (B = 17,200, n = 10, 485 gates) shared memory (about 30 TB/s
// on 132 SMs) bounds it; the float32 pipes, at half their FMA rate for
// products and sums issued on their own, come next.
//
// C interface for ctypes: the launch returns a cudaError_t as int.
#include <cuda_runtime.h>
#include <stdint.h>

#include "statevector_pair.cuh"
#include "xla_sincos.cuh"

namespace {

constexpr int kMaxQubits = 14;
constexpr int kWarpRowsMaxQubits = 6;   // up to 32 pairs: a warp's lanes
constexpr int kWarpRowsThreads = 128;   // CTA size when lanes own a row
constexpr int kRowThreads = 256;        // threads owning one row above
constexpr int kMaxChunk = 64;           // gates staged at once
constexpr int kChunkMatBytes = 32768;   // a CTA's gate matrices, at most
constexpr float kH = 0x1.6a09e6p-1f;    // float32(1 / sqrt(float32(2)))

enum { GATE_H = 0, GATE_P = 1, GATE_RY = 2, GATE_RZ = 3, GATE_X = 4 };

struct Mat {
    float4 re, im;   // (g00, g01, g10, g11)
};

struct Layout {
    int threads, row_threads, rows, chunk;
    long long smem;
};

Layout layout(int n_qubits)
{
    Layout l;
    const int half = 1 << (n_qubits - 1);
    if (n_qubits <= kWarpRowsMaxQubits) {
        l.threads = kWarpRowsThreads;
        l.row_threads = half;
    } else {
        l.row_threads = half < kRowThreads ? half : kRowThreads;
        l.threads = l.row_threads;
    }
    l.rows = l.threads / l.row_threads;
    const int chunk = kChunkMatBytes / ((int)sizeof(Mat) * l.rows);
    l.chunk = chunk < kMaxChunk ? chunk : kMaxChunk;
    l.smem = 8LL * l.rows * (2LL * half) + (long long)sizeof(Mat) * l.rows
        * l.chunk + (long long)sizeof(int4) * l.chunk;
    return l;
}

// ref.gate_planes for one gate: the same float32 expressions, one sine
// and cosine a gate (of a, a / 2 or -a / 2) through xla_sincosf
__device__ __forceinline__ Mat gate_matrix(int gid, float a)
{
    Mat m;
    m.re = make_float4(0.f, 0.f, 0.f, 0.f);
    m.im = make_float4(0.f, 0.f, 0.f, 0.f);
    switch (gid) {
    case GATE_H:
        m.re = make_float4(kH, kH, kH, -kH);
        break;
    case GATE_P: {
        float sn, cs;
        xla_sincosf(a, &sn, &cs);
        m.re = make_float4(1.f, 0.f, 0.f, cs);
        m.im.w = sn;
        break;
    }
    case GATE_RY: {
        float s, c;
        xla_sincosf(a / 2.0f, &s, &c);
        m.re = make_float4(c, -s, s, c);
        break;
    }
    case GATE_RZ: {                  // exp(-0.5j a): cos and sin of -a/2
        float s, c;
        xla_sincosf(a * -0.5f, &s, &c);
        m.re = make_float4(c, 0.f, 0.f, c);
        m.im = make_float4(s, 0.f, 0.f, -s);
        break;
    }
    case GATE_X:
        m.re = make_float4(0.f, 1.f, 1.f, 0.f);
        break;
    default:
        break;
    }
    return m;
}

template <bool kWarpRows>
__device__ __forceinline__ void row_sync()
{
    if (kWarpRows) __syncwarp();
    else __syncthreads();
}

// The pairs gate (target, control) acts on, as masks: pair k has
// i = k with a 0 bit inserted below bit x (k + (k & ~x)), then below bit
// y; i0 = i | z (the control bit, 0 if uncontrolled) and i1 = i0 | w (the
// target bit).  An uncontrolled gate inserts one bit (y = ~0).
__device__ __forceinline__ int4 pair_geometry(int n_qubits, int tq, int cq)
{
    const int shift = n_qubits - 1 - tq;
    if (cq < 0) return make_int4((1 << shift) - 1, -1, 0, 1 << shift);
    const int cshift = n_qubits - 1 - cq;
    const int lo = min(shift, cshift), hi = max(shift, cshift);
    return make_int4((1 << lo) - 1, (1 << hi) - 1, 1 << cshift, 1 << shift);
}

template <bool kWarpRows>
__global__ void __launch_bounds__(256) statevector_tape_kernel(
    const float* __restrict__ angles, const int* __restrict__ gate_id,
    const int* __restrict__ target, const int* __restrict__ control,
    float* __restrict__ out_re, float* __restrict__ out_im,
    long long batch, int n_gates, int n_qubits, int log_row_threads,
    int chunk)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = 1 << n_qubits, half = N >> 1;
    const int row_threads = 1 << log_row_threads;
    const int rows = blockDim.x >> log_row_threads;
    const int r = threadIdx.x >> log_row_threads;
    const int lane = threadIdx.x & (row_threads - 1);
    const long long row0 = (long long)blockIdx.x * rows;
    const long long row = row0 + r;
    const bool live = row < batch;

    float2* states = reinterpret_cast<float2*>(smem);          // [rows][N]
    Mat* all_mats = reinterpret_cast<Mat*>(states + (size_t)rows * N);
    Mat* mats = all_mats + r * chunk;                           // [rows][chunk]
    int4* geos = reinterpret_cast<int4*>(all_mats + rows * chunk);  // [chunk]
    float2* psi = states + (size_t)r * N;

    for (int e = threadIdx.x; e < rows * N; e += blockDim.x)
        states[e] = make_float2((e & (N - 1)) == 0 ? 1.f : 0.f, 0.f);

    for (int c0 = 0; c0 < n_gates; c0 += chunk) {
        const int kc = min(chunk, n_gates - c0);
        __syncthreads();             // every row is done with the last chunk
        for (int j = threadIdx.x; j < kc; j += blockDim.x)
            geos[j] = pair_geometry(n_qubits, target[c0 + j], control[c0 + j]);
        for (int j = lane; j < kc; j += row_threads) {
            const float a = live ? angles[row * n_gates + c0 + j] : 0.f;
            mats[j] = gate_matrix(gate_id[c0 + j], a);
        }
        __syncthreads();
        int4 geo = geos[0];
        float4 gr = mats[0].re, gi = mats[0].im;
        for (int j = 0; j < kc; ++j) {
            const int4 g = geo;
            const float4 mr = gr, mi = gi;
            if (j + 1 < kc) {        // read ahead: nothing writes these now
                geo = geos[j + 1];
                gr = mats[j + 1].re;
                gi = mats[j + 1].im;
            }
            const int n_pairs = g.z ? half >> 1 : half;
            for (int k = lane; k < n_pairs; k += row_threads) {
                int i = k + (k & ~g.x);
                i += i & ~g.y;
                const int i0 = i | g.z, i1 = i0 | g.w;
                float2 a0 = psi[i0], a1 = psi[i1];
                svp::pair_update(mr, mi, a0.x, a0.y, a1.x, a1.y);
                psi[i0] = a0;
                psi[i1] = a1;
            }
            row_sync<kWarpRows>();
        }
    }
    __syncthreads();
    // the CTA's rows are contiguous in the output: one coalesced sweep
    const long long live_elems = (batch - row0) * N;
    for (int e = threadIdx.x; e < rows * N; e += blockDim.x) {
        if (e < live_elems) {
            out_re[row0 * N + e] = states[e].x;
            out_im[row0 * N + e] = states[e].y;
        }
    }
}

}  // namespace

extern "C" int svt_max_qubits() { return kMaxQubits; }

// rows a CTA holds at n_qubits (-1 outside [1, kMaxQubits])
extern "C" int svt_rows(int n_qubits)
{
    return n_qubits < 1 || n_qubits > kMaxQubits ? -1
                                                 : layout(n_qubits).rows;
}

extern "C" int svt_statevector_tape(
    const void* angles, const void* gate_id, const void* target,
    const void* control, void* out_re, void* out_im, long long batch,
    int n_gates, int n_qubits, void* stream)
{
    if (n_qubits < 1 || n_qubits > kMaxQubits || n_gates < 0 || batch < 0)
        return (int)cudaErrorInvalidValue;
    if (batch == 0) return (int)cudaSuccess;
    const Layout l = layout(n_qubits);
    const long long grid = (batch + l.rows - 1) / l.rows;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    int log_row_threads = 0;
    while ((1 << log_row_threads) < l.row_threads) ++log_row_threads;
    const bool warp_rows = n_qubits <= kWarpRowsMaxQubits;
    auto kernel = warp_rows ? statevector_tape_kernel<true>
                            : statevector_tape_kernel<false>;
    if (l.smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)l.smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)grid, l.threads, (size_t)l.smem,
             (cudaStream_t)stream>>>(
        (const float*)angles, (const int*)gate_id, (const int*)target,
        (const int*)control, (float*)out_re, (float*)out_im, batch, n_gates,
        n_qubits, log_row_threads, l.chunk);
    return (int)cudaGetLastError();
}

extern "C" const char* svt_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
