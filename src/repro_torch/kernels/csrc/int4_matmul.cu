// QLoRA int4 matmul for Hopper (sm_90a): out = A @ dequant(W) (NN) or
// out = A @ dequant(W)^T (NT), float32 accumulation with FFMA (no TF32).
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py (int4_matmul,
// body _kernel).  The frozen base weight W (K, N) stays packed: packed
// (K, N/2) uint8, the low nibble holding column 2j and the high nibble
// column 2j + 1, each as q + 8 with q in [-8, 7]; scales (K, N/qblock)
// float32, one per run of qblock columns of a row.  A weight is
// (nibble - 8) * scale, one float32 multiply, optionally rounded to
// bfloat16 (round to nearest even) before the FMA: the JAX model
// dequantizes to bf16 (peft/lora.py dequantize), its kernel oracle to
// float32, and the caller picks.
//
//   NN (the forward):  y (M, N)  = x (M, K) @ dequant(W),    reduction K.
//   NT (dx):           dx (M, K) = dy (M, N) @ dequant(W)^T, reduction N,
//                      walking each packed row's nibbles in order.
//
// Neither form writes the full-width weight anywhere: each CTA
// dequantizes the (BK x BN) slice of W it needs into shared memory.
//
// Design: the tiling of lora_matmul.cu.  One CTA of 256 threads per
// 128 x 128 output tile, the reduction in steps of 8.  Each step stages
// the activation tile (128 x 8) and the dequantized weight tile
// (8 x 128) in shared memory as float32, in two stages: the next step's
// bytes, scales and activations are loaded into registers (and the
// weights dequantized there) while the current stage is multiplied, one
// barrier a step.  Each thread reads two packed bytes a step and
// accumulates an 8 x 8 block of the output in registers (rows
// ty*4 + {0..3, 64..67}, columns tx*4 + {0..3, 64..67}, so a
// quarter-warp's float4 reads of shared memory are conflict-free).  Every
// edge is guarded: any M and K, any even qblock and any N that qblock
// divides.
//
// Bound: operations at the main path's shapes (2 * M * K * N flops
// against 4 * M * K + K * N / 2 + 4 * K * N / qblock + 4 * M * N bytes;
// at llama3.2-1b's w_in with 4096 rows, 275 GFLOP against 0.1 GB).  A
// SIMT float32 kernel reaches a fraction of the 67 TFLOP/s FFMA peak;
// dequantizing into wgmma operands is later work.
//
// C interface for ctypes: the launch returns cudaGetLastError() as int.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, NT = 256;
constexpr int PAD = BM + 4;                  // row pitch of both tiles
constexpr int STAGE = 2 * BK * PAD;          // [A tile | W tile] floats
constexpr int APT = BM * BK / NT;            // activations a thread a step
constexpr int BPT = BK * BN / 2 / NT;        // packed bytes a thread a step
static_assert(BM == BN, "both tiles share one row pitch");

struct Args {
    const void* a;             // (M, R) row-major: x (NN) or dy (NT)
    const uint8_t* packed;     // (Kw, Nw / 2)
    const float* scales;       // (Kw, Nw / qblock)
    void* out;                 // (M, O) row-major
    int64_t M, R, O;           // rows, reduction length, output columns
    int64_t Kw, Nw;            // the logical weight is (Kw, Nw)
    int qblock;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// (nibble - 8) * scale in float32, then rounded to bf16 if asked
template <bool BF16W>
__device__ __forceinline__ float dequant(unsigned nib, float s) {
    const float v = __fmul_rn((float)((int)nib - 8), s);
    return BF16W ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// rows (or columns) owned by a thread: 4 at t*4 and 4 at 64 + t*4
__device__ __forceinline__ int owned(int t, int i) {
    return (i < 4 ? 0 : 64 - 4) + t * 4 + i;
}

template <typename T, bool TRANS, bool BF16W>
__global__ void __launch_bounds__(NT, 2) int4_matmul_kernel(Args p)
{
    __shared__ __align__(16) float smem[2 * STAGE];

    const int64_t m0 = (int64_t)blockIdx.y * BM;
    const int64_t o0 = (int64_t)blockIdx.x * BN;
    const T* A = (const T*)p.a;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int64_t half = p.Nw / 2, nsb = p.Nw / p.qblock;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // the next step's operands, global -> registers, in flight during the
    // compute; wr holds each byte's (even, odd) column already dequantized
    float ar[APT], wr[BPT][2];
    auto fetch = [&](int64_t r0) {
#pragma unroll
        for (int j = 0; j < APT; ++j) {
            const int i = tid + j * NT;
            const int64_t gm = m0 + i / BK, gr = r0 + i % BK;
            ar[j] = (gm < p.M && gr < p.R) ? load(A + gm * p.R + gr) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < BPT; ++j) {
            const int i = tid + j * NT;
            int64_t k, n;                        // W row, even W column
            if (!TRANS) {                        // tile: BK rows of W
                k = r0 + i / (BN / 2);
                n = o0 + 2 * (i % (BN / 2));
            } else {                             // tile: BN rows of W
                k = o0 + i / (BK / 2);
                n = r0 + 2 * (i % (BK / 2));
            }
            if (k < p.Kw && n < p.Nw) {          // n even, Nw even
                const unsigned byte = __ldg(p.packed + k * half + n / 2);
                const float s = __ldg(p.scales + k * nsb + n / p.qblock);
                wr[j][0] = dequant<BF16W>(byte & 0xFu, s);
                wr[j][1] = dequant<BF16W>(byte >> 4, s);
            } else {
                wr[j][0] = wr[j][1] = 0.f;
            }
        }
    };
    // registers -> a shared-memory stage: As[r][m], Ws[r][o]
    auto stage = [&](float* As) {
        float* Ws = As + BK * PAD;
#pragma unroll
        for (int j = 0; j < APT; ++j) {
            const int i = tid + j * NT;
            As[(i % BK) * PAD + i / BK] = ar[j];
        }
#pragma unroll
        for (int j = 0; j < BPT; ++j) {
            const int i = tid + j * NT;
            if (!TRANS) {
                const int rr = i / (BN / 2), oo = 2 * (i % (BN / 2));
                *(float2*)&Ws[rr * PAD + oo] = make_float2(wr[j][0], wr[j][1]);
            } else {
                const int oo = i / (BK / 2), rr = 2 * (i % (BK / 2));
                Ws[rr * PAD + oo] = wr[j][0];
                Ws[(rr + 1) * PAD + oo] = wr[j][1];
            }
        }
    };

    const int64_t nk = (p.R + BK - 1) / BK;
    if (nk > 0) {
        fetch(0);
        stage(smem);
    }
    __syncthreads();
    for (int64_t t = 0; t < nk; ++t) {
        const float* As = smem + (t & 1) * STAGE;
        const float* Ws = As + BK * PAD;
        if (t + 1 < nk) fetch((t + 1) * BK);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[8], wv[8];
            const float4 a0 = *(const float4*)&As[kk * PAD + ty * 4];
            const float4 a1 = *(const float4*)&As[kk * PAD + 64 + ty * 4];
            const float4 w0 = *(const float4*)&Ws[kk * PAD + tx * 4];
            const float4 w1 = *(const float4*)&Ws[kk * PAD + 64 + tx * 4];
            av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
            av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
            wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
            wv[4] = w1.x; wv[5] = w1.y; wv[6] = w1.z; wv[7] = w1.w;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        }
        if (t + 1 < nk) stage(smem + ((t + 1) & 1) * STAGE);
        __syncthreads();
    }

    T* out = (T*)p.out;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int64_t gm = m0 + owned(ty, i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int64_t go = o0 + owned(tx, j);
            if (gm < p.M && go < p.O) store(out + gm * p.O + go, acc[i][j]);
        }
    }
}

template <typename T, bool TRANS>
void launch(const Args& p, bool bf16w, dim3 grid, cudaStream_t s)
{
    if (bf16w)
        int4_matmul_kernel<T, TRANS, true><<<grid, NT, 0, s>>>(p);
    else
        int4_matmul_kernel<T, TRANS, false><<<grid, NT, 0, s>>>(p);
}

template <typename T>
void launch(const Args& p, bool trans, bool bf16w, dim3 grid,
            cudaStream_t s)
{
    if (trans)
        launch<T, true>(p, bf16w, grid, s);
    else
        launch<T, false>(p, bf16w, grid, s);
}

}  // namespace

// a (M, Kw) for NN or (M, Nw) for NT, row-major, float32 (dtype 0) or
// bfloat16 (dtype 1); out (M, Nw) for NN or (M, Kw) for NT, a's dtype;
// round_bf16: round each dequantized weight to bfloat16 before the FMA.
extern "C" int i4_matmul(
    const void* a, const void* packed, const void* scales, void* out,
    long long M, long long Kw, long long Nw, int qblock, int trans,
    int round_bf16, int dtype, void* stream)
{
    if (qblock < 2 || qblock % 2 || Nw % qblock || M < 0 || Kw < 0)
        return (int)cudaErrorInvalidValue;
    const int64_t R = trans ? Nw : Kw, O = trans ? Kw : Nw;
    if (M == 0 || O == 0) return (int)cudaSuccess;
    if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
    Args p{a, (const uint8_t*)packed, (const float*)scales, out, M, R, O,
           Kw, Nw, qblock};
    const dim3 grid((unsigned)((O + BN - 1) / BN),
                    (unsigned)((M + BM - 1) / BM));
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        launch<float>(p, trans != 0, round_bf16 != 0, grid, s);
    else if (dtype == 1)
        launch<__nv_bfloat16>(p, trans != 0, round_bf16 != 0, grid, s);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

extern "C" const char* i4_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
