// Causal / sliding-window attention with grouped KV heads for Hopper
// (sm_90a), forward and backward, on the tensor cores at float32 accuracy.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel): online-softmax attention whose logits
// never leave the chip, with the TPU kernel's masking (key kpos is
// attendable from qpos iff kpos <= qpos when causal, and qpos - kpos <
// window when window > 0), running max / sum / accumulator in float32,
// NEG_INF = -1e30 and the row sum clamped to 1e-30.  The TPU kernel takes
// K/V already expanded to every q-head; here q-head h reads kv-head
// h / G (G = H / KH, the JAX package's grouping) straight from the
// model's (B, S, H, D) layout through strides, so K/V are never expanded
// or transposed in memory.  Masked entries are zeroed explicitly, so a
// fully masked row gives 0, not NaN.
//
// Bound.  At the main paths' shapes (S = 64, D = 32 or 64, causal) each
// (sequence, head) is one 64 x 64 tile and the work is small: the bytes
// of q, k, v, o (and dO, dq, dk, dv backward) against 3.35 TB/s bound
// both directions, above the FFMA and the tensor-core bounds.  The FFMA
// kernels this file replaced ran 10-14x their bound, on latency: a lone
// CTA took 7.8 us for a 32 x 32 tile (two dependent shuffles a score,
// every expf taken four times, K/V loaded through registers between two
// barriers, and each of the G heads of a kv-head loading K/V again).
// This design runs the forward at 3-5x and the backward at 5-6x the
// bound on an H100 (PERF.md): still latency, with few warps an SM in
// the backward (its registers and shared memory allow one CTA of 8
// warps at D = 64).
//
// Design.  Every product runs on the tensor cores with mma.sync m16n8k8
// TF32, at float32 accuracy through the split of csrc/tf32x3.cuh: x =
// hi + lo, both TF32 (rna), and a.b = a_hi.b_hi + a_lo.b_hi + a_hi.b_lo;
// a bf16 operand is exact in TF32 (lo = 0) and its extra products are
// skipped.  Each of the three products sums one reduction step from zero
// in an accumulator of its own (three short dependent chains of mma, not
// one long one), and the step's sum, small parts first, is added to the
// result in float32, since the tensor cores' accumulation does not round
// to nearest.  A step is 32 keys or queries for the products that take
// P or dS, and one k8 slice for Q K^T and its backward twins (K Q^T,
// V dO^T), which keeps one slice's A fragment live instead of four
// (tests/test_torch_attn_tf32.py emulates every product here).
// mma.sync, not wgmma: the tiles are 16-row slabs of one 64 x 64 tile,
// a warp needs no other warp to issue, and the operands stay in
// shared memory as cp.async landed them (row-major, a pitch of 16 bytes
// more than a row, so every fragment load below is free of bank
// conflicts): each warp loads its fragments and splits them in
// registers, so a K-major transpose (V for PV, Q and dO for dK and dV,
// K for dQ) is index arithmetic.  P and dS go from an accumulator to the
// next product's A operand in registers: with the key order inside each
// k8 slice permuted (logical k = t holds key 2t, k = t + 4 key 2t + 1),
// an accumulator's (c0, c2, c1, c3) is the A fragment, and the B operand
// is read with the same permutation.
//
// Forward (attn_fwd_kernel): one CTA per (q-tile of 64 rows, q-head,
// sequence), 4 warps, each warp 16 rows.  Q and each K/V tile of 64 keys
// are staged once by cp.async (K/V double-buffered over key tiles when
// Sk > 64).  The online softmax runs in the S accumulator's registers,
// 32 keys a step (16 registers of scores, not 32: the unrolled loops fit
// 128 registers): one quad reduction a row a step, each expf taken once,
// per-thread partial row sums reduced once at the end.  Key tiles and
// 8-key blocks that no row of a warp attends are skipped; masks are
// evaluated elementwise only on diagonal, window-edge and ragged tiles.
// One q-head a CTA: on the H100 more, smaller CTAs hid latency better
// than 2 or 4 heads of a kv-head a CTA with K/V staged once for them
// (PERF.md).
//
// Backward (attn_bwd_kernel), FA2-style with P recomputed from the saved
// logsumexp: one CTA per (k-tile of 64 keys, kv-head, sequence), each
// warp owning 16 keys' rows of dK and dV.  Two teams of 4 warps (one for
// D = 128) take the (q-head, q-tile) visits in turn: S^T = K Q^T, P^T,
// dP^T = V dO^T, dS^T = P^T (dP^T - delta), dV += P^T dO, dK += dS^T Q,
// then dS goes through shared memory and dQ = dS K.  With Sk <= 64 (one
// k-tile: every main-path shape) that dQ is final and the backward is one
// launch, delta = rowsum(dO O) computed once a (row, head) in it.  Above,
// a first launch computes delta, each k-tile writes its dQ to a float32
// scratch slab of the wrapper's workspace, and a third launch sums the
// slabs in k-tile order: no float atomics, so the backward is bitwise
// repeatable.  The teams' dK/dV are summed in a fixed order at the end.
//
// Head dims.  One template instance a head dim the configs use: 32, 64
// and 128, stablelm-3b's 80, MLA's 96 (64 + 32 rotary; 48 in the -smoke
// configs) and kimi-k2's 112, each a multiple of 16, so the D / 8 loops
// and the 16-byte row copies cover a row exactly.  The backward's dQ pass takes the widest of
// 64, 48, 32 or 16 columns that divides D.  Two backward teams fit in
// shared memory up to D = 112 (216,064 bytes in float32), one at 128.
// q, k and v share the head dim here; a v narrower than q and k (MLA's 64
// under 96) is zero-padded by the wrapper, which slices the output.
//
// C interface for ctypes: each entry returns cudaGetLastError() as int.
#include "tf32x3.cuh"

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

using tf32x3::cp16;
using tf32x3::device_flag;
using tf32x3::MAX_DEVICES;
using tf32x3::tf32_rna;

constexpr int TILE = 64;           // q rows, keys and queries of a tile
constexpr int DSP = TILE + 8;      // pitch of the backward's dS tile
constexpr float NEG_INF = -1e30f;

struct Args {
    const void* q; const void* k; const void* v; const void* o;
    const void* dout; float* lse;
    void* out; void* dq; void* dk; void* dv;
    float* delta;                  // rowsum(dO O), (B, H, S); Sk > 64 only
    float* dq_part;                // per-k-tile dQ slabs; Sk > 64 only
    int B, S, Sk, H, KH, G;
    float scale;
    int causal, window;
    int64_t sqb, sqs, sqh;   // q (B, S, H, D), unit stride along D
    int64_t skb, sks, skh;   // k (B, Sk, KH, D)
    int64_t svb, svs, svh;   // v (B, Sk, KH, D)
    int64_t sdb, sds, sdh;   // dO (B, S, H, D)
};

template <typename T>
__host__ __device__ constexpr bool exact_tf32()
{
    return std::is_same<T, __nv_bfloat16>::value;
}

// row pitch of a staged tile, in elements: 16 bytes more than a row
template <typename T>
__host__ __device__ constexpr int pitch(int D)
{
    return D + 16 / (int)sizeof(T);
}

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x)
{
    return __bfloat162float(x);
}

// a staged element as float; a bf16 one through the 32-bit word that
// holds it (16-bit loads each held a register beside the float: spills)
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p)
{
    const uint32_t w = *(const uint32_t*)((uintptr_t)p & ~(uintptr_t)3);
    return __uint_as_float(((uintptr_t)p & 2) ? w & 0xFFFF0000u : w << 16);
}

__device__ __forceinline__ void store2(float* p, float a, float b)
{
    *(float2*)p = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b)
{
    *(__nv_bfloat162*)p = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ bool attendable(const Args& p, int qi, int kj)
{
    return qi < p.S && kj < p.Sk && (!p.causal || kj <= qi)
        && (p.window <= 0 || qi - kj < p.window);
}

// does some query of q-tile [q0, q0 + 64) attend some key of k-tile
// [k0, k0 + 64)?  The forward's key tiles, the backward's visits and the
// dQ sum all use this one test.
__device__ __forceinline__ bool tiles_meet(const Args& p, int q0, int k0)
{
    const int qmax = min(q0 + TILE, p.S) - 1;
    const int kmax = min(k0 + TILE, p.Sk) - 1;
    return (!p.causal || k0 <= qmax)
        && (p.window <= 0 || q0 - kmax < p.window);
}

__device__ __forceinline__ int floor_div8(int x)
{
    return x >= 0 ? x / 8 : -((7 - x) / 8);
}

// ---------------------------------------------------------------- copies
__device__ __forceinline__ void cp_commit()
{
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait()
{
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// cp.async of `rows` rows of D elements (row stride rs) into a staged
// tile of 64 rows; rows from `rows` on are zero-filled
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int64_t rs,
                                           int rows, int tid, int nt)
{
    constexpr int PER = 16 / (int)sizeof(T), CPR = D / PER, PT = pitch<T>(D);
    for (int i = tid; i < TILE * CPR; i += nt) {
        const int r = i / CPR, c = (i % CPR) * PER;
        const bool ok = r < rows;
        cp16(dst + r * PT + c, ok ? src + r * rs + c : src, ok);
    }
}

// ------------------------------------------------------- tensor-core math
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2])
{
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// hi and lo TF32 parts of N values; an exact operand keeps hi only
template <bool EXACT, int N>
__device__ __forceinline__ void split(const float (&v)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N])
{
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const float h = EXACT ? v[i] : tf32_rna(v[i]);
        hi[i] = __float_as_uint(h);
        lo[i] = EXACT ? 0u : __float_as_uint(tf32_rna(v[i] - h));
    }
}

// d += a.b as TF32 products, each in an accumulator of its own (three
// short chains instead of one long one): a_hi b_hi, a_lo b_hi, a_hi b_lo,
// skipping those of an exact operand's (zero) lo part
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&d)[3][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2])
{
    mma(d[0], ah, bh);
    if (!AX) mma(d[1], al, bh);
    if (!BX) mma(d[2], ah, bl);
}

// acc += the products' sum, small parts first, in float32
__device__ __forceinline__ void fold(float (&acc)[4], const float (&c)[3][4])
{
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += c[0][i] + (c[1][i] + c[2][i]);
}

// Fragments of row-major staged tiles (lane = 4 g + t).
// A (16 x 8): rows r0 + g, r0 + g + 8 and columns c0 + t, c0 + t + 4.
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_a(const T* tile, int pt, int r0, int c0,
                                       int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4])
{
    const T* a = tile + (r0 + g) * pt + c0 + t;
    const float v[4] = {ldf(a), ldf(a + 8 * pt), ldf(a + 4),
                        ldf(a + 8 * pt + 4)};
    split<EXACT>(v, hi, lo);
}

// B (k 8 x n 8) held transposed: tile rows are n, columns k (Q K^T's K)
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_bt(const T* tile, int pt, int n0, int k0,
                                        int g, int t, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2])
{
    const T* b = tile + (n0 + g) * pt + k0 + t;
    const float v[2] = {ldf(b), ldf(b + 4)};
    split<EXACT>(v, hi, lo);
}

// B held as stored: tile rows are k in the permuted order (logical k = t
// is row k0 + 2t, k = t + 4 row k0 + 2t + 1), columns n (P V's V)
template <bool EXACT, typename T>
__device__ __forceinline__ void frag_bp(const T* tile, int pt, int k0, int n0,
                                        int g, int t, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2])
{
    const T* b = tile + (k0 + 2 * t) * pt + n0 + g;
    const float v[2] = {ldf(b), ldf(b + pt)};
    split<EXACT>(v, hi, lo);
}

// an accumulator block (rows g, g + 8; columns 2t, 2t + 1) as the A
// fragment of the next product over those columns, permuted as frag_bp
__device__ __forceinline__ void acc_to_a(const float (&c)[4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4])
{
    const float v[4] = {c[0], c[2], c[1], c[3]};
    split<false>(v, hi, lo);
}

// d += a.b over one k8 slice, b held transposed (frag_bt): the slice's
// products summed from zero, then added in float32
template <bool EXACT, typename T>
__device__ __forceinline__ void slice(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const T* tile,
                                      int pt, int n0, int k0, int g, int t)
{
    uint32_t bh[2], bl[2];
    frag_bt<EXACT>(tile, pt, n0, k0, g, t, bh, bl);
    float c[3][4] = {};
    mma3<EXACT, EXACT>(c, ah, al, bh, bl);
    fold(d, c);
}

// where an unrolled product loop's iteration begins: a warp barrier,
// across which ptxas does not move shared-memory loads, so the loop holds
// one iteration's fragments in registers, not all of them (which spilled)
__device__ __forceinline__ void pace() { __syncwarp(); }

__device__ __forceinline__ float quad_max(float v)
{
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v)
{
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// --------------------------------------------------------------- forward
// 128 registers a thread (16 warps an SM) up to D = 64; above, the
// accumulator of D / 2 floats a thread needs more (and shared memory
// allows at most two CTAs an SM there)
template <typename T, int D>
__global__ void __launch_bounds__(128, D == 128 ? 1 : D > 64 ? 2 : 4)
attn_fwd_kernel(Args p)
{
    constexpr int NT = 128, PT = pitch<T>(D);
    constexpr bool EX = exact_tf32<T>();
    extern __shared__ __align__(16) uint8_t smem[];
    T* Qs = (T*)smem;                              // [64][PT]
    T* KVs = Qs + TILE * PT;                       // [stage][K, V][64][PT]
    const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
    const int kh = h / p.G;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = warp * 16;
    const int qa = q0 + r0, qb = qa + 15;          // this warp's rows
    const T* kbase = (const T*)p.k + b * p.skb + kh * p.skh;
    const T* vbase = (const T*)p.v + b * p.svb + kh * p.svh;

    // the key tiles some row of this q-tile attends: an interval
    const int nkt = (p.Sk + TILE - 1) / TILE;
    int kt0 = 0;
    while (kt0 < nkt && !tiles_meet(p, q0, kt0 * TILE)) ++kt0;
    int kt1 = kt0;
    while (kt1 < nkt && tiles_meet(p, q0, kt1 * TILE)) ++kt1;
    const int ntile = kt1 - kt0;

    const int qrows = min(TILE, p.S - q0);
    stage_rows<T, D>(Qs, (const T*)p.q + b * p.sqb + (int64_t)q0 * p.sqs
                             + h * p.sqh, p.sqs, qrows, tid, NT);
    auto stage_kv = [&](int j) {
        const int k0 = (kt0 + j) * TILE, rows = min(TILE, p.Sk - k0);
        T* dst = KVs + (j & 1) * 2 * TILE * PT;
        stage_rows<T, D>(dst, kbase + (int64_t)k0 * p.sks, p.sks, rows, tid,
                         NT);
        stage_rows<T, D>(dst + TILE * PT, vbase + (int64_t)k0 * p.svs, p.svs,
                         rows, tid, NT);
    };
    if (ntile > 0) stage_kv(0);
    cp_commit();
    if (ntile > 1) stage_kv(1);
    cp_commit();

    const T* Qw = Qs + r0 * PT;
    float o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    for (int j = 0; j < ntile; ++j) {
        cp_wait<1>();
        __syncthreads();
        const int k0 = (kt0 + j) * TILE;
        const T* Ks = KVs + (j & 1) * 2 * TILE * PT;
        const T* Vs = Ks + TILE * PT;
        // 8-key blocks [nlo, nhi) that some row of this warp attends
        int nlo = 0, nhi = min(8, (p.Sk - k0 + 7) / 8);
        if (p.causal) nhi = min(nhi, max(0, floor_div8(qb - k0) + 1));
        if (p.window > 0)
            nlo = max(0, floor_div8(qa - p.window + 1 - k0));
        if (qa >= p.S) nhi = 0;
        const bool edge = (p.causal && k0 + 8 * nhi - 1 > qa)
            || (p.window > 0 && qb - (k0 + 8 * nlo) >= p.window)
            || k0 + 8 * nhi > p.Sk || qb >= p.S;

        // 32 keys a step (8-key blocks 4hf .. 4hf + 3): S = Q K^T, the
        // online softmax in the accumulator's registers, O += P V
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int b0 = 4 * hf;
            if (b0 >= nhi || b0 + 4 <= nlo) continue;
            float s[4][4] = {};
#pragma unroll
            for (int ks = 0; ks < D / 8; ++ks) {
                pace();
                uint32_t ah[4], al[4];
                frag_a<EX>(Qw, PT, 0, 8 * ks, g, t, ah, al);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int nb = b0 + j;
                    if (nb < nlo || nb >= nhi) continue;
                    slice<EX>(s[j], ah, al, Ks, PT, 8 * nb, 8 * ks, g, t);
                }
            }
            // rows g (i < 2) and g + 8 (i >= 2), keys k0 + 8nb + 2t + (i & 1)
            float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int nb = b0 + j;
                if (nb < nlo || nb >= nhi) continue;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    float x = s[j][i] * p.scale;
                    if (edge && !attendable(p, qa + g + (i >> 1) * 8,
                                            k0 + 8 * nb + 2 * t + (i & 1)))
                        x = -INFINITY;
                    s[j][i] = x;
                    if (i < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
                }
            }
            const float mn0 = fmaxf(m0, quad_max(mx0));
            const float mn1 = fmaxf(m1, quad_max(mx1));
            const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
            float ls0 = 0.f, ls1 = 0.f;
            uint32_t ph[4][4], pl[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int nb = b0 + j;
                if (nb < nlo || nb >= nhi) continue;
                s[j][0] = expf(s[j][0] - mn0); s[j][1] = expf(s[j][1] - mn0);
                s[j][2] = expf(s[j][2] - mn1); s[j][3] = expf(s[j][3] - mn1);
                ls0 += s[j][0] + s[j][1];
                ls1 += s[j][2] + s[j][3];
                acc_to_a(s[j], ph[j], pl[j]);
            }
            l0 = l0 * a0 + ls0;
            l1 = l1 * a1 + ls1;
            m0 = mn0;
            m1 = mn1;
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                pace();
                float c[3][4] = {};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int nb = b0 + j;
                    if (nb < nlo || nb >= nhi) continue;
                    uint32_t bh[2], bl[2];
                    frag_bp<EX>(Vs, PT, 8 * nb, 8 * n, g, t, bh, bl);
                    mma3<false, EX>(c, ph[j], pl[j], bh, bl);
                }
                o[n][0] *= a0; o[n][1] *= a0; o[n][2] *= a1; o[n][3] *= a1;
                fold(o[n], c);
            }
        }
        __syncthreads();
        if (j + 2 < ntile) stage_kv(j + 2);
        cp_commit();
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int qi = qa + g + 8 * half;
        if (qi >= p.S) continue;
        const float inv = half ? inv1 : inv0;
        T* op = (T*)p.out + (((int64_t)b * p.S + qi) * p.H + h) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            store2(op + 8 * n, o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
        if (t == 0) {
            const float l = half ? l1 : l0, m = half ? m1 : m0;
            p.lse[((int64_t)b * p.H + h) * p.S + qi] =
                l > 0.f ? m + logf(l) : -INFINITY;
        }
    }
}

// -------------------------------------------------------------- backward
// columns of dQ = dS K a pass takes: the widest of 64, 48, 32 and 16
// that divides D (the pass's product loop steps two 8-column blocks)
__host__ __device__ constexpr int dq_cols(int D)
{
    return D % 64 == 0 ? 64 : D % 48 == 0 ? 48 : D % 32 == 0 ? 32 : 16;
}

template <typename T, int D>
struct BwdLayout {
    static constexpr int PT = pitch<T>(D);
    static constexpr int TEAMS = D == 128 ? 1 : 2;    // shared memory
    static_assert(D % 16 == 0 && D >= 32 && D <= 128, "head dim");
    static constexpr int TILE_BYTES = TILE * PT * (int)sizeof(T);
    static constexpr int KV = 2 * TILE_BYTES;           // K, V
    // a team's visit: Q, dO, dS (float, pitch DSP), lse, delta
    static constexpr int Q = 0, DO = TILE_BYTES, DS = 2 * TILE_BYTES;
    static constexpr int LSE = DS + TILE * DSP * 4, DL = LSE + TILE * 4;
    static constexpr int TEAM = DL + TILE * 4;
    // team 1's dK and dV for the final sum (4 warps x D floats x 32 lanes),
    // from team 1's area on: in bfloat16 at D >= 96 they outgrow it
    static constexpr int RED = TEAMS > 1 ? 4 * D * 32 * 4 : 0;
    static constexpr int BYTES = KV + TEAM
        + (TEAMS > 1 ? (TEAM > RED ? TEAM : RED) : 0);
    static_assert(BYTES <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ void team_sync(int team, int teams)
{
    if (teams == 1) __syncthreads();
    else asm volatile("bar.sync %0, 128;" :: "r"(1 + team) : "memory");
}

// 128 registers at D = 32, so two CTAs share an SM (the tiny model's
// 160 CTAs in one round); above, shared memory allows one CTA an SM
template <typename T, int D>
__global__ void __launch_bounds__(128 * BwdLayout<T, D>::TEAMS, D == 32 ? 2 : 1)
attn_bwd_kernel(Args p)
{
    using L = BwdLayout<T, D>;
    constexpr int PT = L::PT, TEAMS = L::TEAMS, NT = 128 * TEAMS;
    constexpr bool EX = exact_tf32<T>();
    extern __shared__ __align__(16) uint8_t smem[];
    T* Ks = (T*)smem;
    T* Vs = Ks + TILE * PT;
    const int kt = blockIdx.x, k0 = kt * TILE, kh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int team = warp >> 2, tw = tid & 127, wq = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    uint8_t* ts = smem + L::KV + team * L::TEAM;
    T* Qs = (T*)(ts + L::Q);
    T* dOs = (T*)(ts + L::DO);
    float* dSs = (float*)(ts + L::DS);
    float* lse_s = (float*)(ts + L::LSE);
    float* dl_s = (float*)(ts + L::DL);

    const int krows = min(TILE, p.Sk - k0);
    stage_rows<T, D>(Ks, (const T*)p.k + b * p.skb + kh * p.skh
                         + (int64_t)k0 * p.sks, p.sks, krows, tid, NT);
    stage_rows<T, D>(Vs, (const T*)p.v + b * p.svb + kh * p.svh
                         + (int64_t)k0 * p.svs, p.svs, krows, tid, NT);

    // the q-tiles that attend this k-tile: an interval
    const int nqt = (p.S + TILE - 1) / TILE;
    int qt0 = 0;
    while (qt0 < nqt && !tiles_meet(p, qt0 * TILE, k0)) ++qt0;
    int qt1 = qt0;
    while (qt1 < nqt && tiles_meet(p, qt1 * TILE, k0)) ++qt1;
    const int nq = qt1 - qt0, nvisit = p.G * nq;

    auto stage_visit = [&](int v) {
        const int hh = kh * p.G + v / nq, q0 = (qt0 + v % nq) * TILE;
        const int rows = min(TILE, p.S - q0);
        stage_rows<T, D>(Qs, (const T*)p.q + b * p.sqb + hh * p.sqh
                             + (int64_t)q0 * p.sqs, p.sqs, rows, tw, 128);
        stage_rows<T, D>(dOs, (const T*)p.dout + b * p.sdb + hh * p.sdh
                              + (int64_t)q0 * p.sds, p.sds, rows, tw, 128);
    };
    if (team < nvisit) stage_visit(team);
    cp_commit();
    cp_wait<0>();
    __syncthreads();                               // K, V landed

    const int ka = k0 + 16 * wq;                   // this warp's keys
    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

    for (int v = team; v < nvisit; v += TEAMS) {
        const int hh = kh * p.G + v / nq, q0 = (qt0 + v % nq) * TILE;
        if (v != team) {
            stage_visit(v);
            cp_commit();
        }
        // lse and delta = rowsum(dO O) of the visit's 64 rows, 8 lanes a
        // row (delta from the first launch when Sk > 64)
#pragma unroll
        for (int r = tw >> 3; r < TILE; r += 16) {
            const int qi = q0 + r, j = tw & 7;
            const int64_t row = ((int64_t)b * p.H + hh) * p.S + qi;
            float d = 0.f;
            if (qi < p.S && !p.delta) {
                const T* orow = (const T*)p.o
                    + (((int64_t)b * p.S + qi) * p.H + hh) * D;
                const T* drow = (const T*)p.dout + b * p.sdb
                    + (int64_t)qi * p.sds + hh * p.sdh;
#pragma unroll
                for (int i = j; i < D; i += 8)
                    d = fmaf(tof(drow[i]), tof(orow[i]), d);
            }
            d += __shfl_xor_sync(0xffffffffu, d, 1);
            d += __shfl_xor_sync(0xffffffffu, d, 2);
            d += __shfl_xor_sync(0xffffffffu, d, 4);
            if (j == 0) {
                dl_s[r] = qi < p.S && p.delta ? p.delta[row] : d;
                lse_s[r] = qi < p.S ? p.lse[row] : 0.f;
            }
        }
        cp_wait<0>();
        team_sync(team, TEAMS);

        // query blocks [nlo, nhi) of 8 that attend some key of this warp
        int nlo = 0, nhi = min(8, (p.S - q0 + 7) / 8);
        if (p.causal) nlo = max(0, floor_div8(ka - q0));
        if (p.window > 0)
            nhi = min(nhi, max(0, floor_div8(ka + 15 + p.window - 1 - q0) + 1));
        if (ka >= p.Sk) nhi = 0;
        const bool edge = (p.causal && q0 + 8 * nlo < ka + 15)
            || (p.window > 0 && q0 + 8 * nhi - 1 - ka >= p.window)
            || ka + 16 > p.Sk || q0 + 8 * nhi > p.S;

        // rolled in float32, where the unrolled loop ran 1.4x slower on
        // the H100 (probably its code size); unrolled in bf16, which
        // spills rolled
#pragma unroll (EX ? 2 : 1)
        for (int hf = 0; hf < 2; ++hf) {           // 32 queries a half
            // S^T = K Q^T and dP^T = V dO^T: rows this warp's 16 keys,
            // columns the half's queries
            float s[4][4], dp[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
            const bool live = 4 * hf < nhi && 4 * hf + 4 > nlo;
            if (live) {
#pragma unroll 1
                for (int ks = 0; ks < D / 8; ++ks) {
                    pace();
                    uint32_t ah[4], al[4];
                    frag_a<EX>(Ks, PT, 16 * wq, 8 * ks, g, t, ah, al);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int nb = 4 * hf + j;
                        if (nb < nlo || nb >= nhi) continue;
                        slice<EX>(s[j], ah, al, Qs, PT, 8 * nb, 8 * ks, g, t);
                    }
                    frag_a<EX>(Vs, PT, 16 * wq, 8 * ks, g, t, ah, al);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int nb = 4 * hf + j;
                        if (nb < nlo || nb >= nhi) continue;
                        slice<EX>(dp[j], ah, al, dOs, PT, 8 * nb, 8 * ks, g, t);
                    }
                }
            }
            // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta); dS
            // goes to shared memory for dQ (zeros where nothing attends)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int nb = 4 * hf + j;
                const bool in = nb >= nlo && nb < nhi;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int qc = 8 * nb + 2 * t + (i & 1);
                    const int kr = 16 * wq + g + (i >> 1) * 8;
                    float pr = 0.f, ds = 0.f;
                    if (in && (!edge || attendable(p, q0 + qc, k0 + kr))) {
                        pr = expf(s[j][i] * p.scale - lse_s[qc]);
                        ds = pr * (dp[j][i] - dl_s[qc]);
                    }
                    s[j][i] = pr;
                    dp[j][i] = ds;
                    dSs[qc * DSP + kr] = ds;
                }
            }
            if (!live) continue;
            // dV += P^T dO and dK += dS^T Q over the half's 32 queries
            uint32_t xh[4][4], xl[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc_to_a(s[j], xh[j], xl[j]);
#pragma unroll
            for (int n = 0; n < D / 8; n += 2) {
                pace();
                float c[2][3][4] = {};
#pragma unroll
                for (int u = 0; u < 2; ++u)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int nb = 4 * hf + j;
                        if (nb < nlo || nb >= nhi) continue;
                        uint32_t bh[2], bl[2];
                        frag_bp<EX>(dOs, PT, 8 * nb, 8 * (n + u), g, t, bh,
                                    bl);
                        mma3<false, EX>(c[u], xh[j], xl[j], bh, bl);
                    }
                fold(dv[n], c[0]);
                fold(dv[n + 1], c[1]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) acc_to_a(dp[j], xh[j], xl[j]);
#pragma unroll
            for (int n = 0; n < D / 8; n += 2) {
                pace();
                float c[2][3][4] = {};
#pragma unroll
                for (int u = 0; u < 2; ++u)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int nb = 4 * hf + j;
                        if (nb < nlo || nb >= nhi) continue;
                        uint32_t bh[2], bl[2];
                        frag_bp<EX>(Qs, PT, 8 * nb, 8 * (n + u), g, t, bh,
                                    bl);
                        mma3<false, EX>(c[u], xh[j], xl[j], bh, bl);
                    }
                fold(dk[n], c[0]);
                fold(dk[n + 1], c[1]);
            }
        }
        team_sync(team, TEAMS);                    // dS complete

        // dQ = dS K for this warp's 16 queries, 64 columns at a time
        const int qa = q0 + 16 * wq;
        if (qa < p.S) {
            int klo = 0, khi = min(8, (p.Sk - k0 + 7) / 8);
            if (p.causal) khi = min(khi, max(0, floor_div8(qa + 15 - k0) + 1));
            if (p.window > 0)
                klo = max(0, floor_div8(qa - p.window + 1 - k0));
            constexpr int NQ = dq_cols(D);
            static_assert(D % NQ == 0 && NQ % 16 == 0, "dQ column passes");
#pragma unroll (EX ? 2 : 1)
            for (int dc = 0; dc < D / NQ; ++dc) {
                float dq[NQ / 8][4];
#pragma unroll
                for (int n = 0; n < NQ / 8; ++n)
                    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll (EX ? 2 : 1)
                for (int kg = 0; kg < 2; ++kg) {
                    if (4 * kg >= khi || 4 * kg + 4 <= klo) continue;
                    uint32_t ah[4][4], al[4][4];
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        // (row g, key 2t), (g + 8, 2t), (g, 2t + 1),
                        // (g + 8, 2t + 1): the permuted A fragment
                        const float* a = dSs + (16 * wq + g) * DSP
                            + 32 * kg + 8 * kk + 2 * t;
                        const float2 u = *(const float2*)a;
                        const float2 w = *(const float2*)(a + 8 * DSP);
                        const float x[4] = {u.x, w.x, u.y, w.y};
                        split<false>(x, ah[kk], al[kk]);
                    }
#pragma unroll
                    for (int n = 0; n < NQ / 8; n += 2) {
                        pace();
                        float c[2][3][4] = {};
#pragma unroll
                        for (int u = 0; u < 2; ++u)
#pragma unroll
                            for (int kk = 0; kk < 4; ++kk) {
                                const int kb = 4 * kg + kk;
                                if (kb < klo || kb >= khi) continue;
                                uint32_t bh[2], bl[2];
                                frag_bp<EX>(Ks, PT, 8 * kb,
                                            NQ * dc + 8 * (n + u), g, t, bh,
                                            bl);
                                mma3<false, EX>(c[u], ah[kk], al[kk], bh, bl);
                            }
                        fold(dq[n], c[0]);
                        fold(dq[n + 1], c[1]);
                    }
                }
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int qi = qa + g + 8 * half;
                    if (qi >= p.S) continue;
                    const int64_t at = (((int64_t)b * p.S + qi) * p.H + hh) * D
                        + NQ * dc + 2 * t;
#pragma unroll
                    for (int n = 0; n < NQ / 8; ++n) {
                        const float x = dq[n][2 * half];
                        const float y = dq[n][2 * half + 1];
                        if (p.dq_part)
                            store2(p.dq_part + (int64_t)kt * p.B * p.S * p.H * D
                                       + at + 8 * n, x, y);
                        else
                            store2((T*)p.dq + at + 8 * n, x * p.scale,
                                   y * p.scale);
                    }
                }
            }
        }
        team_sync(team, TEAMS);                    // the team's tiles free
    }

    // the teams' dK and dV, summed in a fixed order
    if (TEAMS > 1) {
        __syncthreads();
        // team 1's area: each of its threads' D values, lane-minor
        float* red = (float*)(smem + L::KV + L::TEAM) + wq * D * 32 + lane;
        if (team == 1) {
#pragma unroll
            for (int n = 0; n < D / 8; ++n)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    red[(4 * n + i) * 32] = dk[n][i];
                    red[(D / 2 + 4 * n + i) * 32] = dv[n][i];
                }
        }
        __syncthreads();
        if (team == 1) return;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                dk[n][i] += red[(4 * n + i) * 32];
                dv[n][i] += red[(D / 2 + 4 * n + i) * 32];
            }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int kj = ka + g + 8 * half;
        if (kj >= p.Sk) continue;
        const int64_t at = (((int64_t)b * p.Sk + kj) * p.KH + kh) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            store2((T*)p.dk + at + 8 * n, dk[n][2 * half] * p.scale,
                   dk[n][2 * half + 1] * p.scale);
            store2((T*)p.dv + at + 8 * n, dv[n][2 * half],
                   dv[n][2 * half + 1]);
        }
    }
}

// delta = rowsum(dO O) of every (row, head), (B, H, S): 8 lanes a row
template <typename T, int D>
__global__ void __launch_bounds__(256) attn_bwd_delta_kernel(Args p)
{
    const int64_t r = (int64_t)blockIdx.x * 32 + threadIdx.x / 8;
    const int j = threadIdx.x % 8;
    const int64_t rows = (int64_t)p.B * p.S * p.H;
    float d = 0.f;
    int b = 0, s = 0, h = 0;
    if (r < rows) {
        h = (int)(r % p.H);
        s = (int)((r / p.H) % p.S);
        b = (int)(r / ((int64_t)p.H * p.S));
        const T* orow = (const T*)p.o + r * D;
        const T* drow = (const T*)p.dout + b * p.sdb + (int64_t)s * p.sds
            + h * p.sdh;
#pragma unroll
        for (int i = j; i < D; i += 8) d = fmaf(tof(drow[i]), tof(orow[i]), d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 4);
    if (r < rows && j == 0) p.delta[((int64_t)b * p.H + h) * p.S + s] = d;
}

// dQ = scale times the sum of the k-tiles' slabs, in k-tile order
template <typename T, int D>
__global__ void __launch_bounds__(256) attn_bwd_dq_sum_kernel(Args p)
{
    const int64_t n = (int64_t)p.B * p.S * p.H * D;
    const int64_t e = ((int64_t)blockIdx.x * 256 + threadIdx.x) * 2;
    if (e >= n) return;
    const int s = (int)((e / ((int64_t)p.H * D)) % p.S);
    const int q0 = s / TILE * TILE;
    const int nkt = (p.Sk + TILE - 1) / TILE;
    float x = 0.f, y = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
        if (!tiles_meet(p, q0, kt * TILE)) continue;
        const float2 u = *(const float2*)(p.dq_part + kt * n + e);
        x += u.x;
        y += u.y;
    }
    store2((T*)p.dq + e, x * p.scale, y * p.scale);
}

// ---------------------------------------------------------------- launch
template <typename K>
void allow_smem(K kernel, int bytes)
{
    if (bytes > 48 * 1024)
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
}

template <typename T, int D>
int forward(const Args& p, cudaStream_t s)
{
    constexpr int TILE_BYTES = TILE * pitch<T>(D) * (int)sizeof(T);
    const int stages = p.Sk > TILE ? 2 : 1;
    static bool ready[MAX_DEVICES] = {};
    bool* done = device_flag(ready);
    if (!done || !*done) {
        allow_smem(attn_fwd_kernel<T, D>, 5 * TILE_BYTES);   // Q, 2 x K/V
        if (done) *done = true;
    }
    const dim3 grid((p.S + TILE - 1) / TILE, p.H, p.B);
    attn_fwd_kernel<T, D><<<grid, 128, (1 + 2 * stages) * TILE_BYTES, s>>>(p);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int backward(const Args& p, cudaStream_t s)
{
    using L = BwdLayout<T, D>;
    const int nkt = (p.Sk + TILE - 1) / TILE;
    if (nkt > 1) {
        const int64_t rows = (int64_t)p.B * p.S * p.H;
        attn_bwd_delta_kernel<T, D>
            <<<(unsigned)((rows + 31) / 32), 256, 0, s>>>(p);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    static bool ready[MAX_DEVICES] = {};
    bool* done = device_flag(ready);
    if (!done || !*done) {
        allow_smem(attn_bwd_kernel<T, D>, L::BYTES);
        if (done) *done = true;
    }
    const dim3 grid(nkt, p.KH, p.B);
    attn_bwd_kernel<T, D><<<grid, 128 * L::TEAMS, L::BYTES, s>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || nkt == 1) return (int)err;
    const int64_t pairs = (int64_t)p.B * p.S * p.H * D / 2;
    attn_bwd_dq_sum_kernel<T, D>
        <<<(unsigned)((pairs + 255) / 256), 256, 0, s>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& p, int D, int bwd, cudaStream_t s)
{
    switch (D) {
        case 32: return bwd ? backward<T, 32>(p, s) : forward<T, 32>(p, s);
        case 48: return bwd ? backward<T, 48>(p, s) : forward<T, 48>(p, s);
        case 64: return bwd ? backward<T, 64>(p, s) : forward<T, 64>(p, s);
        case 80: return bwd ? backward<T, 80>(p, s) : forward<T, 80>(p, s);
        case 96: return bwd ? backward<T, 96>(p, s) : forward<T, 96>(p, s);
        case 112: return bwd ? backward<T, 112>(p, s) : forward<T, 112>(p, s);
        case 128: return bwd ? backward<T, 128>(p, s) : forward<T, 128>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

int run(const Args& p, int D, int dtype, int bwd, void* stream)
{
    if (p.B == 0 || p.S == 0 || p.H == 0) return (int)cudaSuccess;
    if (p.KH <= 0 || p.H % p.KH || p.Sk <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return dispatch<float>(p, D, bwd, s);
    if (dtype == 1) return dispatch<__nv_bfloat16>(p, D, bwd, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dO and the gradients share
// it; lse is float32).  Head dims 32, 48, 64, 80, 96, 112 and 128 (q, k and v
// share it: the wrapper zero-pads a narrower v).  Every row of q, k, v
// and dO starts on 16 bytes (the wrapper checks).
extern "C" int fa_forward(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int Sk, int H, int KH, int D, float scale, int causal,
    int window, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, int dtype, void* stream)
{
    Args p{q, k, v, nullptr, nullptr, lse, out, nullptr, nullptr, nullptr,
           nullptr, nullptr,
           B, S, Sk, H, KH, KH > 0 ? H / KH : 0, scale, causal, window,
           sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, 0, 0, 0};
    return run(p, D, dtype, 0, stream);
}

// floats of the workspace's delta area, (B, H, S), rounded up to 16
// bytes: the dQ slabs after it are read and written as float2
static long long delta_floats(int B, int S, int H)
{
    return ((long long)B * S * H + 3) / 4 * 4;
}

// bytes of float32 workspace fa_backward needs: none when Sk <= 64, else
// delta (B, H, S) and one dQ slab (B, S, H, D) per k-tile
extern "C" long long fa_backward_workspace(int B, int S, int Sk, int H, int D)
{
    const long long nkt = (Sk + TILE - 1) / TILE;
    if (nkt <= 1) return 0;
    return 4LL * (delta_floats(B, S, H) + nkt * B * S * H * D);
}

extern "C" int fa_backward(
    const void* q, const void* k, const void* v, const void* out,
    float* lse, const void* dout, void* dq, void* dk, void* dv,
    int B, int S, int Sk, int H, int KH, int D, float scale, int causal,
    int window, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sdb, long long sds, long long sdh, int dtype, void* workspace,
    void* stream)
{
    float* ws = (float*)workspace;
    const bool split = fa_backward_workspace(B, S, Sk, H, D) > 0;
    if (split && !ws) return (int)cudaErrorInvalidValue;
    Args p{q, k, v, out, dout, lse, nullptr, dq, dk, dv,
           split ? ws : nullptr,
           split ? ws + delta_floats(B, S, H) : nullptr,
           B, S, Sk, H, KH, KH > 0 ? H / KH : 0, scale, causal, window,
           sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sdb, sds, sdh};
    return run(p, D, dtype, 1, stream);
}

extern "C" const char* fa_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
