// QLoRA int4 matmul for Hopper (sm_90a): out = A @ dequant(W) (NN) or
// out = A @ dequant(W)^T (NT), on the tensor cores: error-compensated
// TF32 wgmma (tf32x3.cuh), float32 accuracy.
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py (int4_matmul,
// body _kernel).  The frozen base weight W (K, N) stays packed: packed
// (K, N/2) uint8, the low nibble holding column 2j and the high nibble
// column 2j + 1, each as q + 8 with q in [-8, 7]; scales (K, N/qblock)
// float32, one per run of qblock columns of a row.  A weight is
// (nibble - 8) * scale, one float32 multiply, optionally rounded to
// bfloat16 (round to nearest even): the JAX model dequantizes to bf16
// (peft/lora.py dequantize), its kernel oracle to float32, and the
// caller picks.
//
//   NN (the forward):  y (M, N)  = x (M, K) @ dequant(W),    reduction K.
//   NT (dx):           dx (M, K) = dy (M, N) @ dequant(W)^T, reduction N,
//                      walking each packed row's nibbles in order.
//
// Neither form writes the full-width weight anywhere: the producer
// warpgroup dequantizes each (BK x BN) slice of W in registers and
// stores it straight into the K-major wgmma layout, split into TF32 hi
// and lo parts; NN transposes as it stores (a thread reads 8 columns of
// 4 rows as aligned 4-byte words where Nw and qblock are multiples of 8,
// else a column of 4 rows byte by byte), NT does not (each warp reads 16
// columns of each of 8 rows).
//
// Design: the tiles, ring and roles of tf32x3.cuh (128 x 128 output
// tiles, reduction steps of 32, 3 stages where they fit, two consumer
// warpgroups that split their own activation rows, landed by cp.async
// (float32) or stored by the producer (bf16), and a producer that reads,
// dequantizes and splits the weight a step ahead).  Products taken: a bf16-rounded weight is exact in TF32, so
// its lo part is 0 and float32 activations take two products (x_hi W +
// x_lo W), the QLoRA path; a float32-rounded weight (the JAX kernel
// oracle's contract) is split into three parts, which hold it exactly,
// and takes four (x_hi times each part, x_lo W_hi), on a ring of two
// stages, where three no longer fit; bf16 activations take one fewer.  The dropped lo.lo term is about 2^-22 |x||W|
// a term; at reductions up to 16384 (w_in's dx) it stays two orders
// below the 2e-5 tolerance, and each reduction step's wgmma sum is added
// with a float32 FADD (tf32x3.cuh).  Small grids (the tiny model's
// NT and w_out) split the reduction over up to 8 CTAs a tile, with a
// workspace (i4_workspace) and a fixed-order second pass, so two
// launches give equal bits.  Every edge is guarded: any M and K, any
// even qblock and any N that qblock divides.
//
// Bound: operations at the main path's shapes (2 * M * K * N flops
// against 4 * M * K + K * N / 2 + 4 * K * N / qblock + 4 * M * N bytes;
// at llama3.2-1b's w_in with 4096 rows, 275 GFLOP against 0.1 GB): two
// TF32 products at 495 TFLOP/s, 1.11 ms there.
//
// C interface for ctypes: the launch returns cudaGetLastError() as int.
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

struct Args {
    const void* a;             // (M, R) row-major: x (NN) or dy (NT)
    const uint8_t* packed;     // (Kw, Nw / 2)
    const float* scales;       // (Kw, Nw / qblock)
    void* out;                 // (M, O) row-major
    float* ws;                 // split partials, or null
    int64_t M, R, O;           // rows, reduction length, output columns
    int64_t Kw, Nw;            // the logical weight is (Kw, Nw)
    int qblock, qshift;        // qshift: log2(qblock), or -1
    int splits;
    int64_t split_steps;
};

// (nibble - 8) * scale in float32, then rounded to bf16 if asked
template <bool BF16W>
__device__ __forceinline__ float dequant(unsigned nib, float s) {
    const float v = __fmul_rn((float)((int)nib - 8), s);
    return BF16W ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The B operand: BN output columns x BK reduction values of dequant(W)
// (NN) or dequant(W)^T (NT), 8 row pieces of 4 values a producer thread.
// The loads keep the nibbles and scales as read, all issued before any
// is used (an element out of range reads the first byte and gets scale
// 0); the stores dequantize.
template <bool TRANS, bool BF16W>
struct WeightTile {
    static constexpr int U = BN * BK / 4 / NPROD;
    static constexpr int NS = TRANS ? 2 : 4;     // scales a piece
    uint32_t nibs[U];                            // 4 nibbles (NN), 2 bytes (NT)
    float sc[U][NS];
    // NN where whole words allow (Nw and qblock multiples of 8): thread t
    // takes columns 8 (t % 16) .. + 7 of rows 4 (t / 16) .. + 3 of the
    // tile, one aligned 4-byte word (8 nibbles) and one scale a row, so 8
    // loads a step instead of 64; its stores then share a bank 8 ways
    bool words_ok;
    uint32_t words[4];
    float wsc[4];

    __device__ __forceinline__ void unit(int i, int& row, int& kg) const
    {
        // NT: along a packed row (K-major); NN: across columns
        kmajor_or_rows((threadIdx.x % NPROD) + i * NPROD, row, kg, TRANS, BN);
    }

    // column block of column n: a shift where qblock is a power of 2
    static __device__ __forceinline__ int block_of(int n, const Args& p)
    {
        return p.qshift >= 0 ? n >> p.qshift : n / p.qblock;
    }

    __device__ __forceinline__ void load(const Args& p, int64_t o0, int64_t r0)
    {
        const int64_t half = p.Nw / 2, nsb = p.Nw / p.qblock;
        words_ok = !TRANS && p.Nw % 8 == 0 && p.qblock % 8 == 0
            && ((uintptr_t)p.packed & 3) == 0;
        if (words_ok) {
            const int tp = threadIdx.x % NPROD;
            const int64_t oc = o0 + 8 * (tp % 16), r = r0 + 4 * (tp / 16);
            const int cb = oc < p.Nw ? block_of((int)oc, p) : 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const bool ok = oc < p.Nw && r + j < p.Kw;
                const uint32_t w = __ldg((const uint32_t*)(
                    ok ? p.packed + (r + j) * half + oc / 2 : p.packed));
                const float sj = __ldg(ok ? p.scales + (r + j) * nsb + cb
                                          : p.scales);
                words[j] = ok ? w : 0u;
                wsc[j] = ok ? sj : 0.f;
            }
            return;
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
            int row, kg;
            unit(i, row, kg);
            const int64_t o = o0 + row, r = r0 + 4 * kg;
            nibs[i] = 0u;
            if constexpr (!TRANS) {              // W[r + j][o], j < 4
                const int cb = o < p.Nw ? block_of((int)o, p) : 0;
                const uint8_t* pk = p.packed + r * half + o / 2;
                const float* ps = p.scales + r * nsb + cb;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const bool ok = o < p.Nw && r + j < p.Kw;
                    const unsigned byte = __ldg(ok ? pk + j * half : p.packed);
                    const float s = __ldg(ok ? ps + j * nsb : p.scales);
                    nibs[i] |= ((o & 1 ? byte >> 4 : byte) & 0xFu) << 4 * j;
                    sc[i][j] = ok ? s : 0.f;
                }
            } else {                             // W[o][r + j], r even
                const uint8_t* pk = p.packed + o * half + r / 2;
                const float* ps = p.scales + o * nsb;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int64_t n = r + 2 * j;
                    const bool ok = o < p.Kw && n < p.Nw;
                    const unsigned byte = __ldg(ok ? pk + j : p.packed);
                    const float s = __ldg(ok ? ps + block_of((int)n, p) : p.scales);
                    nibs[i] |= byte << 8 * j;
                    sc[i][j] = ok ? s : 0.f;
                }
            }
        }
    }

    template <int P>
    __device__ __forceinline__ void put(uint8_t* tile) const
    {
        if (words_ok) {
            const int tp = threadIdx.x % NPROD;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                float w[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    w[j] = dequant<BF16W>((words[j] >> 4 * c) & 0xFu, wsc[j]);
                store_parts<P>(tile, tile_bytes(BN),
                               unit_offset(8 * (tp % 16) + c, tp / 16), w);
            }
            return;
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
            int row, kg;
            unit(i, row, kg);
            float w[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                w[j] = dequant<BF16W>((nibs[i] >> 4 * j) & 0xFu,
                                      sc[i][TRANS ? j / 2 : j]);
            store_parts<P>(tile, tile_bytes(BN), unit_offset(row, kg), w);
        }
    }
};

template <typename T, bool TRANS, bool BF16W>
__global__ void __launch_bounds__(NT, 1) int4_matmul_kernel(Args p)
{
    // TF32 parts: float32 activations 2, bf16 ones 1; a bf16-rounded
    // weight 1, a float32-rounded one 3 (all 24 bits)
    constexpr int AP = sizeof(T) == 4 ? 2 : 1, BP = BF16W ? 1 : 3;
    using R = Ring<AP, BP, 0>;
    extern __shared__ __align__(128) uint8_t smem[];
    const int split = blockIdx.z;
    const int64_t m0 = (int64_t)blockIdx.y * BM;
    const int64_t o0 = (int64_t)blockIdx.x * BN;
    const int64_t nk = (p.R + BK - 1) / BK;
    const int64_t t0 = split * p.split_steps;
    const int64_t t1 = t0 + p.split_steps < nk ? t0 + p.split_steps : nk;
    const int64_t steps = t1 > t0 ? t1 - t0 : 0;
    init_ring<R>(smem);

    if (threadIdx.x >= NCONS) {                  // producer warpgroup
        StridedTile<BM, T> at;
        WeightTile<TRANS, BF16W> wt;
        int64_t k0 = 0;
        produce<R>(
            smem, steps,
            [&](int64_t t) {
                k0 = (t0 + t) * BK;
                wt.load(p, o0, k0);
            },
            [&](uint8_t* s, uint64_t* full) {
                // the activations as loaded, for the consumers to split:
                // by cp.async (float32), arriving when they land, or
                // through registers
                if constexpr (sizeof(T) == 4) {
                    at.template issue_raw<R::XP>(s + R::A, (const T*)p.a, p.R,
                                                 1, p.M, p.R, m0, k0);
                    cp_arrive(full);
                }
                wt.template put<BP>(s + R::B);
                if constexpr (sizeof(T) != 4) {
                    at.load((const T*)p.a, p.R, 1, p.M, p.R, m0, k0);
                    at.template put_raw<R::XP>(s + R::A, true);
                    mbar_arrive(full);
                }
            });
        return;
    }

    const int wg = threadIdx.x / 128;
    float acc[64], none[1];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    none[0] = 0.f;
    consume<R>(smem, steps, wg, acc, none);

    const int64_t rb = m0 + 64 * wg;
    if (p.splits > 1) {
        float* wo = p.ws + (int64_t)split * p.M * p.O;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            const int64_t gm = rb + acc_row(i), go = o0 + acc_col(i);
            if (gm < p.M && go < p.O) wo[gm * p.O + go] = acc[i];
        }
        return;
    }
    T* out = (T*)p.out;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
        const int64_t gm = rb + acc_row(i), go = o0 + acc_col(i);
        if (gm < p.M && go < p.O) store_out(out + gm * p.O + go, acc[i]);
    }
}

template <typename T, bool TRANS, bool BF16W>
cudaError_t launch(const Args& p, dim3 grid, cudaStream_t s)
{
    using R = Ring<sizeof(T) == 4 ? 2 : 1, BF16W ? 1 : 3, 0>;
    static bool ready[MAX_DEVICES] = {};
    bool* done = device_flag(ready);
    if (!done || !*done) {
        const cudaError_t e = cudaFuncSetAttribute(
            int4_matmul_kernel<T, TRANS, BF16W>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, R::BYTES);
        if (e != cudaSuccess) return e;
        if (done) *done = true;
    }
    int4_matmul_kernel<T, TRANS, BF16W><<<grid, NT, R::BYTES, s>>>(p);
    if (p.splits > 1) {
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        const int64_t n = p.M * p.O;
        const unsigned blocks = (unsigned)((n + 255) / 256 < 4096
                                           ? (n + 255) / 256 : 4096);
        reduce_splits<T><<<blocks, 256, 0, s>>>(p.ws, (T*)p.out, n, p.splits);
    }
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& p, bool trans, bool bf16w, dim3 grid,
                   cudaStream_t s)
{
    if (trans)
        return bf16w ? launch<T, true, true>(p, grid, s)
                     : launch<T, true, false>(p, grid, s);
    return bf16w ? launch<T, false, true>(p, grid, s)
                 : launch<T, false, false>(p, grid, s);
}

int64_t plan(long long M, long long R, long long O, int* splits)
{
    static int sms = 0;
    if (!sms) sms = sm_count();
    const int64_t nk = (R + BK - 1) / BK;
    const int64_t ctas = ((O + BN - 1) / BN) * ((M + BM - 1) / BM);
    const int64_t per = split_steps(ctas, nk, sms);
    *splits = nk > 0 ? (int)((nk + per - 1) / per) : 1;
    return per;
}

}  // namespace

// floats of workspace a launch at this shape needs (0: none)
extern "C" long long i4_workspace(long long M, long long Kw, long long Nw,
                                  int trans)
{
    const long long R = trans ? Nw : Kw, O = trans ? Kw : Nw;
    int splits;
    plan(M, R, O, &splits);
    return splits > 1 ? (long long)splits * M * O : 0;
}

// a (M, Kw) for NN or (M, Nw) for NT, row-major, float32 (dtype 0) or
// bfloat16 (dtype 1); out (M, Nw) for NN or (M, Kw) for NT, a's dtype;
// round_bf16: round each dequantized weight to bfloat16 before the
// product; ws: at least i4_workspace(M, Kw, Nw, trans) floats.
extern "C" int i4_matmul(
    const void* a, const void* packed, const void* scales, void* out,
    long long M, long long Kw, long long Nw, int qblock, int trans,
    int round_bf16, int dtype, void* ws, void* stream)
{
    if (qblock < 2 || qblock % 2 || Nw % qblock || M < 0 || Kw < 0)
        return (int)cudaErrorInvalidValue;
    const int64_t R = trans ? Nw : Kw, O = trans ? Kw : Nw;
    if (M == 0 || O == 0) return (int)cudaSuccess;
    if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
    int splits;
    const int64_t per = plan(M, R, O, &splits);
    if (splits > 1 && !ws) return (int)cudaErrorInvalidValue;
    const int qshift = (qblock & (qblock - 1)) ? -1 : __builtin_ctz(qblock);
    Args p{a, (const uint8_t*)packed, (const float*)scales, out, (float*)ws,
           M, R, O, Kw, Nw, qblock, qshift, splits, per};
    const dim3 grid((unsigned)((O + BN - 1) / BN),
                    (unsigned)((M + BM - 1) / BM), (unsigned)splits);
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return (int)launch<float>(p, trans != 0, round_bf16 != 0, grid, s);
    if (dtype == 1)
        return (int)launch<__nv_bfloat16>(p, trans != 0, round_bf16 != 0,
                                          grid, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* i4_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
