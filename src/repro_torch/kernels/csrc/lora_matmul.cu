// Batched LoRA projection y = x @ W + scale * (x @ A) @ B for Hopper
// (sm_90a), on the tensor cores: error-compensated TF32 wgmma
// (tf32x3.cuh), float32 accuracy.
//
// Replaces the TPU kernel src/repro/kernels/lora_matmul.py (lora_matmul,
// body _kernel).  Operands: x (C, M, K), a frozen W (K, N) shared by all
// C clients, per-client adapters A (C, K, r) and B (C, r, N), r <= 32;
// output y (C, M, N), contiguous.  Every operand is read through its
// strides, so the backward's dx = dy @ W^T + scale * (dy @ B^T) @ A^T is
// this same kernel on transposed views: x <- dy, W <- W^T, A <- B^T,
// B <- A^T, with no copies.
//
// Design: one CTA of 384 threads per (N-tile, M-tile, client[, split]),
// output tiles of 128 x 128, reduction steps of 32, a ring of 3 stages
// (tf32x3.cuh).  x is the wgmma A operand: float32 x lands by cp.async
// and each consumer warpgroup splits its own rows; bf16 x the producer
// stores.  W is B, split by the producer warpgroup, K-major: a W that is
// N-major in memory (the forward) is transposed as it is split, a
// K-major one (dx, W^T) is not.  A's r
// columns, padded to RP = 8, 16 or 32, are a third tile appended to B,
// so x @ A comes out of the same wgmma pipeline (m64nRPk8) once per
// M-tile, not recomputed with FFMA.  The epilogue adds
// scale * (x @ A) @ B with FFMA over r terms from shared memory, once.
// Products taken: float32 operands three (x_hi W_hi + x_lo W_hi +
// x_hi W_lo), bfloat16 operands one (exact in TF32).  The dropped
// x_lo W_lo term is about 2^-22 |x||W| a term; at this kernel's
// reductions (K up to 8192 forward, N = 16384 for w_in's dx) its sum
// stays two orders below the 2e-5 tolerance.  wgmma accumulates one
// reduction step at a time; each step's sum is added with a float32
// FADD (tf32x3.cuh says why).
//
// Small grids: where the tiles leave most SMs idle and the reduction has
// at least 8 steps (the tiny model's dx and w_out), the reduction is
// split over up to 8 CTAs a tile.  Each writes its partial y and x @ A
// to a workspace the caller allocates (lm_workspace), and a second
// kernel sums the splits in a fixed order and applies the LoRA term, so
// two launches give equal bits.
//
// Bound: operations at the main path's shapes (2 * M * N * (K + r) +
// 2 * M * K * r flops against 4 bytes per element of x, W, A, B and y;
// at llama3.2-1b's w_in, 275 GFLOP against 0.2 GB): three TF32 products
// at 495 TFLOP/s, 1.67 ms there.
//
// C interface for ctypes: the launch returns cudaGetLastError() as int.
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;
constexpr int MAXR = 32;

struct Args {
    const void* x; const void* w; const void* a; const void* b; void* y;
    float* ws;               // split partials, or null
    int64_t C, M, N, K;
    int r, splits;
    int64_t split_steps;
    float scale;
    int64_t sxc, sxm, sxk;   // x (C, M, K)
    int64_t swk, swn;        // W (K, N)
    int64_t sac, sak, sar;   // A (C, K, r)
    int64_t sbc, sbr, sbn;   // B (C, r, N)
};

template <typename T>
__device__ __forceinline__ float ldv(const T* p) { return StridedTile<8, T>::ld(p); }

template <typename T, bool LO, int RP>
__global__ void __launch_bounds__(NT, 1) lora_matmul_kernel(Args p)
{
    extern __shared__ __align__(128) uint8_t smem[];
    using R = Ring<LO ? 2 : 1, LO ? 2 : 1, RP, LO>;
    const int c = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
    const int64_t m0 = (int64_t)blockIdx.y * BM;
    const int64_t n0 = (int64_t)blockIdx.x * BN;
    const int64_t nk = (p.K + BK - 1) / BK;
    const int64_t t0 = split * p.split_steps;
    const int64_t t1 = t0 + p.split_steps < nk ? t0 + p.split_steps : nk;
    const int64_t steps = t1 > t0 ? t1 - t0 : 0;
    const T* x = (const T*)p.x + c * p.sxc;
    const T* w = (const T*)p.w;
    const T* a = (const T*)p.a + c * p.sac;
    init_ring<R>(smem);

    if (threadIdx.x >= NCONS) {                  // producer warpgroup
        StridedTile<BM, T> xt;
        StridedTile<BN, T> wt;
        StridedTile<RP, T> at;
        int64_t k0 = 0;
        produce<R>(
            smem, steps,
            [&](int64_t t) {
                k0 = (t0 + t) * BK;
                if constexpr (LO)
                    wt.load(w, p.swn, p.swk, p.N, p.K, n0, k0);
                else
                    xt.load(x, p.sxm, p.sxk, p.M, p.K, m0, k0);
                at.load(a, p.sar, p.sak, p.r, p.K, 0, k0);
            },
            [&](uint8_t* s, uint64_t* full) {
                if constexpr (LO) {
                    // float32: x as loaded, by cp.async, for the consumers
                    // to split; one arrival when it lands
                    xt.template issue_raw<R::XP>(s + R::A, x, p.sxm, p.sxk,
                                                 p.M, p.K, m0, k0);
                    cp_arrive(full);
                } else {
                    // bf16: x stored here (exact in TF32, one part), then W
                    // read: the producer's registers stay free of spills
                    xt.template put<1>(s + R::A, p.sxk == 1);
                    mbar_arrive(full);
                    wt.load(w, p.swn, p.swk, p.N, p.K, n0, k0);
                }
                wt.template put<LO ? 2 : 1>(s + R::B, p.swk == 1);
                at.template put<LO ? 2 : 1>(s + R::L, p.sak == 1);
            });
        return;
    }

    const int wg = threadIdx.x / 128;
    float acc[64], xa[RP / 2];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < RP / 2; ++i) xa[i] = 0.f;
    consume<R>(smem, steps, wg, acc, xa);

    const int64_t rb = m0 + 64 * wg;             // this warpgroup's rows
    if (p.splits > 1) {                          // partials to the workspace
        const int64_t slab = (int64_t)split * p.C + c;
        float* wy = p.ws + slab * p.M * p.N;
        float* wx = p.ws + (int64_t)p.splits * p.C * p.M * p.N
            + slab * p.M * RP;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            const int64_t gm = rb + acc_row(i), gn = n0 + acc_col(i);
            if (gm < p.M && gn < p.N) wy[gm * p.N + gn] = acc[i];
        }
        if (blockIdx.x == 0) {
#pragma unroll
            for (int i = 0; i < RP / 2; ++i) {
                const int64_t gm = rb + acc_row(i);
                if (gm < p.M) wx[gm * RP + acc_col(i)] = xa[i];
            }
        }
        return;
    }

    // epilogue: y = acc + scale * (x@A) @ B, one store; the ring is free
    // once both consumer warpgroups are past their last wait
    consumers_sync();
    constexpr int XAP = RP + 1, BPAD = BN + 4;
    float* XA = (float*)smem;                    // [2][64][XAP]
    float* Bs = XA + 2 * 64 * XAP;               // [RP][BPAD]
#pragma unroll
    for (int i = 0; i < RP / 2; ++i)
        XA[(wg * 64 + acc_row(i)) * XAP + acc_col(i)] = xa[i];
    const T* b = (const T*)p.b + c * p.sbc;
    const bool b_nfast = p.sbn == 1;
    for (int i = threadIdx.x; i < RP * BN; i += NCONS) {
        const int nn = b_nfast ? i % BN : i / RP;
        const int jj = b_nfast ? i / BN : i % RP;
        const int64_t gn = n0 + nn;
        Bs[jj * BPAD + nn] = (jj < p.r && gn < p.N)
            ? ldv(b + jj * p.sbr + gn * p.sbn) : 0.f;
    }
    consumers_sync();
    T* y = (T*)p.y + (int64_t)c * p.M * p.N;
    const float* xr = XA + wg * 64 * XAP;
    // l = (x@A) @ B for this thread's 64 outputs.  Up to rank 8 (the
    // paths' ranks), EC outputs at a time, rank by rank: EC independent
    // FMAs a rank, where one chain of r per output left a lone CTA twice
    // as long as int4_matmul's; above rank 8 that form spills, and the
    // chain a output is kept.
    if constexpr (RP <= 8) {
        constexpr int EC = 16;
#pragma unroll
        for (int i0 = 0; i0 < 64; i0 += EC) {
            float l[EC];
#pragma unroll
            for (int i = 0; i < EC; ++i) l[i] = 0.f;
#pragma unroll 1
            for (int jj = 0; jj < p.r; ++jj) {
#pragma unroll
                for (int i = 0; i < EC; ++i)
                    l[i] = fmaf(xr[acc_row(i0 + i) * XAP + jj],
                                Bs[jj * BPAD + acc_col(i0 + i)], l[i]);
            }
#pragma unroll
            for (int i = 0; i < EC; ++i) {
                const int64_t gm = rb + acc_row(i0 + i);
                const int64_t gn = n0 + acc_col(i0 + i);
                if (gm < p.M && gn < p.N)
                    store_out(y + gm * p.N + gn,
                              fmaf(p.scale, l[i], acc[i0 + i]));
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            const int row = acc_row(i), col = acc_col(i);
            float l = 0.f;
            for (int jj = 0; jj < p.r; ++jj)
                l = fmaf(xr[row * XAP + jj], Bs[jj * BPAD + col], l);
            const int64_t gm = rb + row, gn = n0 + col;
            if (gm < p.M && gn < p.N)
                store_out(y + gm * p.N + gn, fmaf(p.scale, l, acc[i]));
        }
    }
}

// second pass of a split launch: y = sum_s acc_s + scale * (sum_s xa_s) @ B
template <typename T, int RP>
__global__ void __launch_bounds__(256) lora_reduce_kernel(Args p)
{
    const int64_t n = p.C * p.M * p.N;
    const float* wx = p.ws + (int64_t)p.splits * n;
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        const int64_t c = i / (p.M * p.N), m = (i / p.N) % p.M, gn = i % p.N;
        float s = p.ws[i];
        for (int k = 1; k < p.splits; ++k) s += p.ws[k * n + i];
        const T* b = (const T*)p.b + c * p.sbc;
        float l = 0.f;
        for (int jj = 0; jj < p.r; ++jj) {
            const int64_t o = (c * p.M + m) * RP + jj;
            float xa = wx[o];
            for (int k = 1; k < p.splits; ++k) xa += wx[k * p.C * p.M * RP + o];
            l = fmaf(xa, ldv(b + jj * p.sbr + gn * p.sbn), l);
        }
        store_out((T*)p.y + i, fmaf(p.scale, l, s));
    }
}

template <typename T, bool LO, int RP>
cudaError_t launch_rp(const Args& p, dim3 grid, cudaStream_t s)
{
    using R = Ring<LO ? 2 : 1, LO ? 2 : 1, RP, LO>;
    static bool ready[MAX_DEVICES] = {};
    bool* done = device_flag(ready);
    if (!done || !*done) {
        const cudaError_t e = cudaFuncSetAttribute(
            lora_matmul_kernel<T, LO, RP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES);
        if (e != cudaSuccess) return e;
        if (done) *done = true;
    }
    lora_matmul_kernel<T, LO, RP><<<grid, NT, R::BYTES, s>>>(p);
    if (p.splits > 1) {
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        const int64_t n = p.C * p.M * p.N;
        const unsigned blocks = (unsigned)((n + 255) / 256 < 4096
                                           ? (n + 255) / 256 : 4096);
        lora_reduce_kernel<T, RP><<<blocks, 256, 0, s>>>(p);
    }
    return cudaGetLastError();
}

template <typename T, bool LO>
cudaError_t launch(const Args& p, dim3 grid, cudaStream_t s)
{
    if (p.r <= 8) return launch_rp<T, LO, 8>(p, grid, s);
    if (p.r <= 16) return launch_rp<T, LO, 16>(p, grid, s);
    return launch_rp<T, LO, MAXR>(p, grid, s);
}

int rank_pad(int r) { return r <= 8 ? 8 : r <= 16 ? 16 : MAXR; }

// steps a split takes, and the split count, for this launch
int64_t plan(long long C, long long M, long long N, long long K, int* splits)
{
    static int sms = 0;
    if (!sms) sms = sm_count();
    const int64_t nk = (K + BK - 1) / BK;
    const int64_t ctas = ((N + BN - 1) / BN) * ((M + BM - 1) / BM) * C;
    const int64_t per = split_steps(ctas, nk, sms);
    *splits = nk > 0 ? (int)((nk + per - 1) / per) : 1;
    return per;
}

}  // namespace

// floats of workspace a launch at this shape needs (0: none)
extern "C" long long lm_workspace(long long C, long long M, long long N,
                                  long long K, int r)
{
    int splits;
    plan(C, M, N, K, &splits);
    if (splits < 2 || r < 1 || r > MAXR) return 0;
    return (long long)splits * C * M * (N + rank_pad(r));
}

// dtype: 0 float32, 1 bfloat16 (x, W, A, B and y share it); ws: at least
// lm_workspace(C, M, N, K, r) floats
extern "C" int lm_lora_matmul(
    const void* x, const void* w, const void* a, const void* b, void* y,
    long long C, long long M, long long N, long long K, int r, float scale,
    long long sxc, long long sxm, long long sxk,
    long long swk, long long swn,
    long long sac, long long sak, long long sar,
    long long sbc, long long sbr, long long sbn,
    int dtype, void* ws, void* stream)
{
    if (r < 1 || r > MAXR) return (int)cudaErrorInvalidValue;
    if (C == 0 || M == 0 || N == 0) return (int)cudaSuccess;
    if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
    int splits;
    const int64_t per = plan(C, M, N, K, &splits);
    if (splits > 1 && !ws) return (int)cudaErrorInvalidValue;
    if (C * splits > 65535) return (int)cudaErrorInvalidValue;
    Args p{x, w, a, b, y, (float*)ws, C, M, N, K, r, splits, per, scale,
           sxc, sxm, sxk, swk, swn, sac, sak, sar, sbc, sbr, sbn};
    const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
                    (unsigned)(C * splits));
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return (int)launch<float, true>(p, grid, s);
    if (dtype == 1) return (int)launch<__nv_bfloat16, false>(p, grid, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* lm_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
