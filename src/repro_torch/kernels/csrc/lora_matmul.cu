// Batched LoRA projection y = x @ W + scale * (x @ A) @ B for Hopper
// (sm_90a), float32 accumulation with FFMA (no TF32).
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py (lora_matmul,
// body _kernel).  Operands: x (C, M, K), a frozen W (K, N) shared by all
// C clients, per-client adapters A (C, K, r) and B (C, r, N), r <= 32;
// output y (C, M, N), contiguous.  Every operand is read through its
// strides, so the backward's dx = dy @ W^T + scale * (dy @ B^T) @ A^T is
// this same kernel on transposed views: x <- dy, W <- W^T, A <- B^T,
// B <- A^T, with no copies.
//
// Design: one CTA of 256 threads per (N-tile, M-tile, client), tiles of
// 128 x 128, the reduction in steps of 8.  Each step stages the x tile
// (128 x 8), the W tile (8 x 128) and the A tile (8 x r) in shared
// memory, as float32 whatever the input type, in two stages: the next
// step's tiles are loaded into registers while the current ones are
// multiplied, then stored to the other stage, one barrier a step.  Each
// tile is read with its unit-stride dimension fastest, so a transposed
// view loads as contiguously as a plain one.  Each thread accumulates an
// 8 x 8 block of y in registers (rows ty*4 + {0..3, 64..67}, columns
// tx*4 + {0..3, 64..67}, so a quarter-warp's float4 reads of shared
// memory are conflict-free) and its share of the (128 x r) intermediate
// x@A, which is computed once per M-tile from the same staged x tile, as
// the TPU kernel keeps it in VMEM.  After the reduction x@A goes to
// shared memory beside the B tile, and scale * (x@A) @ B is added to the
// accumulator before the single store.  W is frozen: no dW exists.
// The kernel is compiled for rank bounds 4, 8, 16 and 32, so x@A takes
// only the registers its rank needs, and for two CTAs an SM (128
// registers a thread; the rank-4 float32 variant spills a few hundred
// bytes, which measured faster than one CTA an SM without spills).
//
// Bound: operations at the main path's shapes (2 * M * N * (K + r) +
// 2 * M * K * r flops against 4 bytes per element of x, W, A, B and y;
// at llama3.2-1b's w_in, 275 GFLOP against 0.2 GB).  A SIMT float32
// kernel reaches a fraction of the 67 TFLOP/s FFMA peak; wgmma on TF32 or
// bf16 is the way past it and is later work.
//
// C interface for ctypes: the launch returns cudaGetLastError() as int.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, NT = 256, MAXR = 32;
constexpr int XPAD = BM + 4, WPAD = BN + 4;
// tile elements each thread stages per reduction step
constexpr int XPT = BM * BK / NT, WPT = BK * BN / NT;

// shared memory of a kernel for ranks up to RMAX: two stages of
// [x tile BK x XPAD | W tile BK x WPAD | A tile BK x RMAX], reused by the
// epilogue as [x@A BM x (RMAX + 1) | B tile RMAX x WPAD]
template <int RMAX>
struct Smem {
    static constexpr int STAGE = BK * XPAD + BK * WPAD + BK * RMAX;
    static constexpr int EPI = BM * (RMAX + 1) + RMAX * WPAD;
    static constexpr int FLOATS = 2 * STAGE > EPI ? 2 * STAGE : EPI;
    static constexpr int APT = (BK * RMAX + NT - 1) / NT;   // A per thread
    static constexpr int XAN = BM * RMAX / NT;              // x@A per thread
};

struct Args {
    const void* x; const void* w; const void* a; const void* b; void* y;
    int64_t M, N, K;
    int r;
    float scale;
    int64_t sxc, sxm, sxk;   // x (C, M, K)
    int64_t swk, swn;        // W (K, N)
    int64_t sac, sak, sar;   // A (C, K, r)
    int64_t sbc, sbr, sbn;   // B (C, r, N)
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// rows (or columns) owned by a thread: 4 at t*4 and 4 at 64 + t*4
__device__ __forceinline__ int owned(int t, int i) {
    return (i < 4 ? 0 : 64 - 4) + t * 4 + i;
}

template <typename T, int RMAX>
__global__ void __launch_bounds__(NT, 2) lora_matmul_kernel(Args p)
{
    using L = Smem<RMAX>;
    __shared__ __align__(16) float smem[L::FLOATS];

    const int c = blockIdx.z;
    const int64_t m0 = (int64_t)blockIdx.y * BM;
    const int64_t n0 = (int64_t)blockIdx.x * BN;
    const T* x = (const T*)p.x + c * p.sxc;
    const T* w = (const T*)p.w;
    const T* a = (const T*)p.a + c * p.sac;
    const T* b = (const T*)p.b + c * p.sbc;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int r = p.r;
    const bool x_kfast = p.sxk == 1, w_nfast = p.swn == 1, a_rfast = p.sar == 1;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float xa[L::XAN];
#pragma unroll
    for (int e = 0; e < L::XAN; ++e) xa[e] = 0.f;

    // the next tiles, global -> registers, in flight during the compute
    float xr[XPT], wr[WPT], ar[L::APT];
    auto fetch = [&](int64_t k0) {
#pragma unroll
        for (int j = 0; j < XPT; ++j) {
            const int i = tid + j * NT;
            const int mm = x_kfast ? i / BK : i % BM;
            const int kk = x_kfast ? i % BK : i / BM;
            const int64_t gm = m0 + mm, gk = k0 + kk;
            xr[j] = (gm < p.M && gk < p.K) ? load(x + gm * p.sxm + gk * p.sxk)
                                           : 0.f;
        }
#pragma unroll
        for (int j = 0; j < WPT; ++j) {
            const int i = tid + j * NT;
            const int nn = w_nfast ? i % BN : i / BK;
            const int kk = w_nfast ? i / BN : i % BK;
            const int64_t gn = n0 + nn, gk = k0 + kk;
            wr[j] = (gn < p.N && gk < p.K) ? load(w + gk * p.swk + gn * p.swn)
                                           : 0.f;
        }
#pragma unroll
        for (int j = 0; j < L::APT; ++j) {
            const int i = tid + j * NT;
            const int jj = a_rfast ? i % r : i / BK;
            const int kk = a_rfast ? i / r : i % BK;
            const int64_t gk = k0 + kk;
            ar[j] = (i < BK * r && gk < p.K)
                ? load(a + gk * p.sak + jj * p.sar) : 0.f;
        }
    };
    // registers -> a shared-memory stage
    auto stage = [&](float* Xs) {
        float* Ws = Xs + BK * XPAD;
        float* As = Ws + BK * WPAD;
#pragma unroll
        for (int j = 0; j < XPT; ++j) {
            const int i = tid + j * NT;
            const int mm = x_kfast ? i / BK : i % BM;
            const int kk = x_kfast ? i % BK : i / BM;
            Xs[kk * XPAD + mm] = xr[j];
        }
#pragma unroll
        for (int j = 0; j < WPT; ++j) {
            const int i = tid + j * NT;
            const int nn = w_nfast ? i % BN : i / BK;
            const int kk = w_nfast ? i / BN : i % BK;
            Ws[kk * WPAD + nn] = wr[j];
        }
#pragma unroll
        for (int j = 0; j < L::APT; ++j) {
            const int i = tid + j * NT;
            if (i < BK * r) {
                const int jj = a_rfast ? i % r : i / BK;
                const int kk = a_rfast ? i / r : i % BK;
                As[kk * RMAX + jj] = ar[j];
            }
        }
    };

    const int64_t nk = (p.K + BK - 1) / BK;
    if (nk > 0) {
        fetch(0);
        stage(smem);
    }
    __syncthreads();
    for (int64_t t = 0; t < nk; ++t) {
        const float* Xs = smem + (t & 1) * L::STAGE;
        const float* Ws = Xs + BK * XPAD;
        const float* As = Ws + BK * WPAD;
        if (t + 1 < nk) fetch((t + 1) * BK);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float xv[8], wv[8];
            const float4 x0 = *(const float4*)&Xs[kk * XPAD + ty * 4];
            const float4 x1 = *(const float4*)&Xs[kk * XPAD + 64 + ty * 4];
            const float4 w0 = *(const float4*)&Ws[kk * WPAD + tx * 4];
            const float4 w1 = *(const float4*)&Ws[kk * WPAD + 64 + tx * 4];
            xv[0] = x0.x; xv[1] = x0.y; xv[2] = x0.z; xv[3] = x0.w;
            xv[4] = x1.x; xv[5] = x1.y; xv[6] = x1.z; xv[7] = x1.w;
            wv[0] = w0.x; wv[1] = w0.y; wv[2] = w0.z; wv[3] = w0.w;
            wv[4] = w1.x; wv[5] = w1.y; wv[6] = w1.z; wv[7] = w1.w;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        }
        // the rank-r intermediate x@A from the same staged x tile
#pragma unroll
        for (int e = 0; e < L::XAN; ++e) {
            const int idx = tid + e * NT;
            if (idx < BM * r) {
                const int mm = idx / r, jj = idx % r;
                float s = xa[e];
#pragma unroll
                for (int kk = 0; kk < BK; ++kk)
                    s = fmaf(Xs[kk * XPAD + mm], As[kk * RMAX + jj], s);
                xa[e] = s;
            }
        }
        if (t + 1 < nk) stage(smem + ((t + 1) & 1) * L::STAGE);
        __syncthreads();
    }

    // epilogue: y = acc + scale * (x@A) @ B, one store
    constexpr int XAPAD = RMAX + 1;
    float* XA = smem;                    // [BM][XAPAD]
    float* Bs = XA + BM * XAPAD;         // [RMAX][WPAD]
#pragma unroll
    for (int e = 0; e < L::XAN; ++e) {
        const int idx = tid + e * NT;
        if (idx < BM * r) XA[(idx / r) * XAPAD + idx % r] = xa[e];
    }
    const bool b_nfast = p.sbn == 1;
    for (int i = tid; i < r * BN; i += NT) {
        const int nn = b_nfast ? i % BN : i / r;
        const int jj = b_nfast ? i / BN : i % r;
        const int64_t gn = n0 + nn;
        Bs[jj * WPAD + nn] = gn < p.N ? load(b + jj * p.sbr + gn * p.sbn)
                                      : 0.f;
    }
    __syncthreads();
    T* y = (T*)p.y + (int64_t)c * p.M * p.N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int mm = owned(ty, i);
        const int64_t gm = m0 + mm;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int nn = owned(tx, j);
            float l = 0.f;
            for (int jj = 0; jj < r; ++jj)
                l = fmaf(XA[mm * XAPAD + jj], Bs[jj * WPAD + nn], l);
            const int64_t gn = n0 + nn;
            if (gm < p.M && gn < p.N)
                store(y + gm * p.N + gn, fmaf(p.scale, l, acc[i][j]));
        }
    }
}

// the smallest compiled rank bound that holds r
template <typename T>
void launch(const Args& p, dim3 grid, cudaStream_t s)
{
    if (p.r <= 4)
        lora_matmul_kernel<T, 4><<<grid, NT, 0, s>>>(p);
    else if (p.r <= 8)
        lora_matmul_kernel<T, 8><<<grid, NT, 0, s>>>(p);
    else if (p.r <= 16)
        lora_matmul_kernel<T, 16><<<grid, NT, 0, s>>>(p);
    else
        lora_matmul_kernel<T, MAXR><<<grid, NT, 0, s>>>(p);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, W, A, B and y share it)
extern "C" int lm_lora_matmul(
    const void* x, const void* w, const void* a, const void* b, void* y,
    long long C, long long M, long long N, long long K, int r, float scale,
    long long sxc, long long sxm, long long sxk,
    long long swk, long long swn,
    long long sac, long long sak, long long sar,
    long long sbc, long long sbr, long long sbn,
    int dtype, void* stream)
{
    if (r < 1 || r > MAXR) return (int)cudaErrorInvalidValue;
    if (C == 0 || M == 0 || N == 0) return (int)cudaSuccess;
    Args p{x, w, a, b, y, M, N, K, r, scale, sxc, sxm, sxk, swk, swn,
           sac, sak, sar, sbc, sbr, sbn};
    const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                    (unsigned)C);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        launch<float>(p, grid, s);
    else if (dtype == 1)
        launch<__nv_bfloat16>(p, grid, s);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

extern "C" const char* lm_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
