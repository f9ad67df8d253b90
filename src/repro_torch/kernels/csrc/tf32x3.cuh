// Error-compensated TF32 ("3xTF32") products on Hopper's tensor cores,
// shared by lora_matmul.cu and int4_matmul.cu (sm_90a); flash_attention.cu
// takes its split (tf32_rna) and cp.async copies (cp16) for mma.sync.
//
// Numerics.  A float32 x splits into two TF32 values, hi = rna(x) and
// lo = rna(x - hi), where rna rounds to 10 mantissa bits, to nearest,
// ties away (as cvt.rna.tf32.f32; done here in integer operations).
// x - hi is exact in float32, so x = hi + lo + e with |e| <= 2^-22 |x|.
// A product a.b is taken as a_hi.b_hi + a_lo.b_hi + a_hi.b_lo, three
// TF32 wgmma products summed in float32; the dropped a_lo.b_lo and the
// rounding of the lo parts are each about 2^-22 |a||b| a term.  Over a
// reduction of length K with random signs they add up like sqrt(K)
// against a result that grows like sqrt(K) as well, so the relative
// error stays near float32's.  The tensor cores' own float32
// accumulation does not round to nearest, and its error grows with the
// number of additions into one accumulator, so a wgmma accumulator sums
// one reduction step only and each step's sum is added to the result
// with a float32 FADD (consume() below).  tests/test_torch_tf32_split.py
// emulates both on the CPU at the paths' reduction lengths (K = 128 ...
// 16384) against the 2e-5 tolerance.
//
// An operand that is exact in TF32 has lo = 0 and its products are
// skipped: a bf16 value (10 > 7 mantissa bits), so a bf16-rounded
// dequantized weight needs two products and two bf16 operands one.  A
// split into three parts (hi, lo, lo2) holds all 24 bits of a float32;
// int4_matmul takes it for a float32-rounded weight (four products: x_hi
// times each part, and x_lo W_hi), so that an activation exact in TF32
// reproduces the dequantized weight bit for bit, as the FFMA kernel did.
//
// Tiles.  A CTA computes a 128 x 128 output tile (plus RP extra columns
// where the caller appends them) in reduction steps of BK = 32, with 384
// threads: warpgroups 0 and 1 consume (64 rows each, wgmma m64nNk8 with
// both operands in shared memory), warpgroup 2 produces.  Operands are
// split in registers (a TMA or cp.async copy cannot round) and stored
// K-major in wgmma's no-swizzle layout: core matrices of 8 rows x 4
// values (16 bytes a row, 128 bytes a core matrix), 8 of them along K
// (LBO = 128 bytes) and one 8-row group every 1024 bytes (SBO); a
// source that is not K-major is transposed at that step at no extra
// pass.  The producer reads the weight into registers a step ahead,
// dequantizes (int4) and splits it; float32 activations it only copies
// by cp.async, as loaded, and each consumer warpgroup splits its own 64
// rows (16 values a thread) before its wgmmas: a single warpgroup that
// split every value of a step set the pace on the card (PERF.md), so the
// work is shared out.  bf16 activations in lora_matmul are split by
// the producer, which keeps that kernel within 168 registers a thread
// without spills (OWN = false in Ring).  The ring is tracked by
// mbarriers: full (each producer thread arrives twice, once through
// cp.async.mbarrier.arrive for its copies and once after its stores and
// a proxy fence) and empty (the consumers' 256 threads arrive once the
// wgmma group that read the stage has retired).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int BM = 128, BN = 128, BK = 32, MAX_STAGES = 3;
constexpr int NCONS = 256, NPROD = 128, NT = NCONS + NPROD;
constexpr int CORE = 128;                    // bytes of a core matrix
constexpr int SBO = CORE * BK / 4;           // bytes of an 8-row group
constexpr int MAX_SPLITS = 8;

// bytes of a ROWS x BK tile
__host__ __device__ constexpr int tile_bytes(int rows) { return rows * BK * 4; }

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// ---------------------------------------------------------------- numerics
// cvt.rna.tf32.f32 in two integer operations: add half an ulp of TF32 to
// the magnitude bits and clear the 13 bits TF32 drops (round to nearest,
// ties away from zero; the same bits as the conversion on finite values)
__device__ __forceinline__ float tf32_rna(float x)
{
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// ------------------------------------------------------- shared-memory tile
// byte offset of the 16-byte row piece (row, values 4 kg .. 4 kg + 3)
__device__ __forceinline__ int unit_offset(int row, int kg)
{
    return (row >> 3) * SBO + kg * CORE + (row & 7) * 16;
}

// descriptor of the 8-deep slice ks (0..3) of a tile, from row row0 on
__device__ __forceinline__ uint64_t desc(const uint8_t* tile, int row0, int ks)
{
    const uint32_t a = smem_u32(tile + (row0 >> 3) * SBO + ks * 2 * CORE);
    return (uint64_t)((a & 0x3FFFF) >> 4)
        | ((uint64_t)(CORE >> 4) << 16)       // LBO: next 4 values of K
        | ((uint64_t)(SBO >> 4) << 32);       // SBO: next 8 rows
}

// split v into P TF32 parts (hi, lo, lo2) and store each 16-byte piece
// in its part's tile; tiles of one operand lie tb bytes apart.  Each
// remainder is exact in float32, and three parts hold all 24 bits.
template <int P>
__device__ __forceinline__ void store_parts(uint8_t* tile, int tb, int off,
                                            const float (&v)[4])
{
    float r0 = v[0], r1 = v[1], r2 = v[2], r3 = v[3];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        float4 h;
        h.x = tf32_rna(r0); h.y = tf32_rna(r1);
        h.z = tf32_rna(r2); h.w = tf32_rna(r3);
        *(float4*)(tile + p * tb + off) = h;
        r0 -= h.x; r1 -= h.y; r2 -= h.z; r3 -= h.w;
    }
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence()
{
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(b)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity)
{
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra.uni DONE;\n"
        "bra.uni LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(smem_u32(b)), "r"(parity) : "memory");
}

// generic-proxy stores made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async()
{
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// cp.async of 16 or 4 bytes, global -> shared; ok = false copies no bytes
// and fills the destination with zeros (src is then not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// one arrival on b once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_arrive(uint64_t* b)
{
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(smem_u32(b)) : "memory");
}

// the 128 threads of consumer warpgroup wg only
__device__ __forceinline__ void warpgroup_sync(int wg)
{
    asm volatile("bar.sync %0, 128;" :: "r"(2 + wg) : "memory");
}

// the 256 consumer threads only
__device__ __forceinline__ void consumers_sync()
{
    asm volatile("bar.sync 1, 256;" ::: "memory");
}

// ------------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R])
{
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (m64 x n128) = A (64 x 8) * B (n128 x 8)^T (+ d if accumulate), both
// operands from shared memory
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n128) = A (64 x 8) * B (n128 x 8)^T, d written only, both
// operands from shared memory
__device__ __forceinline__ void wgmma_n128_init(float (&d)[64], uint64_t da,
                                          uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
          "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
          "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
          "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
          "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]),
          "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
          "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
        : "l"(da), "l"(db), "r"(0));
}

// d (m64 x n32) = A (64 x 8) * B (n32 x 8)^T (+ d if accumulate), both
// operands from shared memory
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n32) = A (64 x 8) * B (n32 x 8)^T, d written only, both
// operands from shared memory
__device__ __forceinline__ void wgmma_n32_init(float (&d)[16], uint64_t da,
                                          uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "l"(da), "l"(db), "r"(0));
}

// d (m64 x n16) = A (64 x 8) * B (n16 x 8)^T (+ d if accumulate), both
// operands from shared memory
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n16) = A (64 x 8) * B (n16 x 8)^T, d written only, both
// operands from shared memory
__device__ __forceinline__ void wgmma_n16_init(float (&d)[8], uint64_t da,
                                          uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
          "=f"(d[6]), "=f"(d[7])
        : "l"(da), "l"(db), "r"(0));
}

// d (m64 x n8) = A (64 x 8) * B (n8 x 8)^T (+ d if accumulate), both
// operands from shared memory
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da,
                                          uint64_t db, int accumulate)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64 x n8) = A (64 x 8) * B (n8 x 8)^T, d written only, both
// operands from shared memory
__device__ __forceinline__ void wgmma_n8_init(float (&d)[4], uint64_t da,
                                          uint64_t db)
{
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "l"(da), "l"(db), "r"(0));
}


template <int N> struct Mma;
template <> struct Mma<128> {
    static __device__ __forceinline__ void run(float (&d)[64], uint64_t a,
                                               uint64_t b, int acc) { wgmma_n128(d, a, b, acc); }
    static __device__ __forceinline__ void init(float (&d)[64], uint64_t a,
                                                uint64_t b) { wgmma_n128_init(d, a, b); }
};
template <> struct Mma<32> {
    static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                               uint64_t b, int acc) { wgmma_n32(d, a, b, acc); }
    static __device__ __forceinline__ void init(float (&d)[16], uint64_t a,
                                                uint64_t b) { wgmma_n32_init(d, a, b); }
};
template <> struct Mma<16> {
    static __device__ __forceinline__ void run(float (&d)[8], uint64_t a,
                                               uint64_t b, int acc) { wgmma_n16(d, a, b, acc); }
    static __device__ __forceinline__ void init(float (&d)[8], uint64_t a,
                                                uint64_t b) { wgmma_n16_init(d, a, b); }
};
template <> struct Mma<8> {
    static __device__ __forceinline__ void run(float (&d)[4], uint64_t a,
                                               uint64_t b, int acc) { wgmma_n8(d, a, b, acc); }
    static __device__ __forceinline__ void init(float (&d)[4], uint64_t a,
                                                uint64_t b) { wgmma_n8_init(d, a, b); }
};

// One stage of the ring: the activation tile as loaded (float32, BM
// rows of BK values at a pitch of XP, so the consumers' reads are free
// of bank conflicts), then the TF32 parts of B (BN rows, the weight: BP
// parts) and of L (RP rows appended to B: LoRA's A^T, or none; BP
// parts).  After the stages: each consumer warpgroup's TF32 parts of its
// 64 activation rows (AP = 1, or 2 where A is not exact in TF32), each
// consumer thread's float32 sums of x @ A (RP / 2 values), the
// mbarriers.  With OWN = false the stage holds A's TF32 parts instead,
// split by the producer, and the consumers read them in place.  Three
// stages where they fit, else two.
template <int AP_, int BP_, int RP_, bool OWN_ = true>
struct Ring {
    static constexpr int AP = AP_, BP = BP_, RP = RP_;
    static constexpr bool OWN = OWN_;   // false: the producer splits A too
    static constexpr int XP = BK + 4;
    static constexpr int TX = BM * XP * 4, TB = tile_bytes(BN),
                         TL = tile_bytes(RP), TA = tile_bytes(OWN ? 64 : BM);
    static constexpr int A = 0;
    static constexpr int B = A + (OWN ? TX : AP * TA);
    static constexpr int L = B + BP * TB;
    static constexpr int STAGE = L + BP * TL;
    static constexpr int OWN_BYTES = OWN ? AP * TA : 0;  // a warpgroup's A
    static constexpr int XSUM_BYTES = NCONS * (RP / 2) * 4;
    static constexpr int REST = 2 * OWN_BYTES + XSUM_BYTES;
    static constexpr int S =
        MAX_STAGES * STAGE + REST + 2 * MAX_STAGES * 8 <= 232448 ? MAX_STAGES : 2;
    static constexpr int SPLIT = S * STAGE;
    static constexpr int XSUM = SPLIT + 2 * OWN_BYTES;
    static constexpr int BARS = XSUM + XSUM_BYTES;       // 2 * S mbarriers
    static constexpr int BYTES = BARS + 2 * S * 8;
    static_assert(BYTES <= 232448, "shared memory of one CTA");
};

// The consumers' main loop over `steps` reduction steps: warpgroup wg
// splits its 64 rows of the stage's activation tile into its own TF32
// parts (16 values a thread), then multiplies them by the B tile
// (m64 x n128) and by the L tile (m64 x nRP).  The products are
// A_hi B_hi, A_lo B_hi (AP = 2) and A_hi B_p for each further part of B.
//
// The tensor cores' float32 accumulation does not round to nearest: on
// the card a sum over N = 16384 (w_in's dx) in one wgmma accumulator
// missed the 2e-5 tolerance by 6x.  So wgmma sums only one stage (4
// slices x the products, from zero), and each stage's partial sum is
// added to acc with a float32 FADD (round to nearest), as FFMA would; the
// partial sums of x @ A go to this thread's slots in shared memory.  The
// stage is released once its commit group has retired.  On return acc
// holds the product and xa this thread's share of x @ A.
template <typename R, int XR>
__device__ __forceinline__ void consume(uint8_t* smem, int64_t steps, int wg,
                                        float (&acc)[64], float (&xa)[XR])
{
    constexpr int AP = R::AP, BP = R::BP, RP = R::RP;
    uint64_t* full = (uint64_t*)(smem + R::BARS);
    uint64_t* empty = full + R::S;
    uint8_t* own = smem + R::SPLIT + wg * R::OWN_BYTES;
    float* xsum = (float*)(smem + R::XSUM) + threadIdx.x;   // [XR][NCONS]
    const int tw = threadIdx.x % 128;
    float part[64], xpart[XR];
#pragma unroll
    for (int j = 0; j < XR; ++j) {
        xpart[j] = 0.f;
        if (RP > 0) xsum[j * NCONS] = 0.f;
    }
    for (int64_t t = 0; t < steps; ++t) {
        const int st = (int)(t % R::S);
        mbar_wait(full + st, (unsigned)((t / R::S) & 1));
        const uint8_t* s = smem + st * R::STAGE;
        // A: this warpgroup's rows, split here (OWN) or by the producer
        const uint8_t* at = R::OWN ? own : s + R::A;
        const int a0 = R::OWN ? 0 : 64 * wg;
        if constexpr (R::OWN) {
            warpgroup_sync(wg);             // the last step's wgmmas are done
#pragma unroll 1                            // one piece at a time: registers
            for (int i = 0; i < 64 * BK / 4 / 128; ++i) {
                const int u = tw + 128 * i, row = u % 64, kg = u / 64;
                const float4 f = *(const float4*)(s + R::A
                    + ((64 * wg + row) * R::XP + 4 * kg) * 4);
                const float v[4] = {f.x, f.y, f.z, f.w};
                store_parts<AP>(own, R::TA, unit_offset(row, kg), v);
            }
            fence_proxy_async();
            warpgroup_sync(wg);
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
            const uint64_t ah = desc(at, a0, ks);
            const uint64_t bh = desc(s + R::B, 0, ks);
            // the step's first product writes part without reading it,
            // so part holds no registers while the rows are split
            if (ks == 0) Mma<128>::init(part, ah, bh);
            else Mma<128>::run(part, ah, bh, 1);
            if (AP > 1)
                Mma<128>::run(part, desc(at + R::TA, a0, ks), bh, 1);
#pragma unroll
            for (int q = 1; q < BP; ++q)
                Mma<128>::run(part, ah, desc(s + R::B + q * R::TB, 0, ks), 1);
            if constexpr (RP > 0) {
                const uint64_t lh = desc(s + R::L, 0, ks);
                if (ks == 0) Mma<RP>::init(xpart, ah, lh);
                else Mma<RP>::run(xpart, ah, lh, 1);
                if (AP > 1)
                    Mma<RP>::run(xpart, desc(at + R::TA, a0, ks), lh, 1);
#pragma unroll
                for (int q = 1; q < BP; ++q)
                    Mma<RP>::run(xpart, ah, desc(s + R::L + q * R::TL, 0, ks), 1);
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        fence_regs(xpart);
        mbar_arrive(empty + st);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        if constexpr (RP > 0) {
#pragma unroll
            for (int j = 0; j < XR; ++j) xsum[j * NCONS] += xpart[j];
        }
    }
#pragma unroll
    for (int j = 0; j < XR; ++j) xa[j] = RP > 0 ? xsum[j * NCONS] : 0.f;
}

// The producer's ring protocol around a kernel's own loads and stores:
// fetch(t) reads step t's weight into registers; put(stage, full) stores
// the activations (by cp.async, or through registers) and arrives once
// on full for them, then splits and stores the weight.  Each producer
// thread arrives twice a stage.
template <typename R, typename Fetch, typename Put>
__device__ __forceinline__ void produce(uint8_t* smem, int64_t steps,
                                        Fetch fetch, Put put)
{
    uint64_t* full = (uint64_t*)(smem + R::BARS);
    uint64_t* empty = full + R::S;
    for (int64_t t = 0; t < steps; ++t) {
        const int st = (int)(t % R::S);
        fetch(t);
        mbar_wait(empty + st, (unsigned)(((t / R::S) & 1) ^ 1));
        put(smem + st * R::STAGE, full + st);
        fence_proxy_async();
        mbar_arrive(full + st);
    }
}

// Barrier set-up by thread 0, before the roles split.
template <typename R>
__device__ __forceinline__ void init_ring(uint8_t* smem)
{
    if (threadIdx.x == 0) {
        uint64_t* full = (uint64_t*)(smem + R::BARS);
        for (int i = 0; i < R::S; ++i) {
            mbar_init(full + i, 2 * NPROD);
            mbar_init(full + R::S + i, NCONS);
        }
        mbar_init_fence();
    }
    __syncthreads();
}

// Row and column inside the warpgroup's m64 x nN tile of accumulator
// register i of this thread (the wgmma D fragment layout).
__device__ __forceinline__ int acc_row(int i)
{
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    return warp * 16 + (lane >> 2) + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int i)
{
    return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}

// Row piece u of a tile: (row, kg), values 4 kg .. 4 kg + 3 of K.  Where
// K has unit stride, a warp takes 8 rows x 4 pieces (64 contiguous bytes
// of each row) and each quarter-warp 8 rows of one kg, so its 16-byte
// stores fill one 128-byte wavefront without bank conflicts; where rows
// have unit stride, lanes take consecutive rows.
__device__ __forceinline__ void kmajor_or_rows(int u, int& row, int& kg,
                                               bool kfast, int rows)
{
    if (kfast) {
        row = (u & 7) | ((u >> 6) << 3);
        kg = (u >> 3) & 7;
    } else {
        row = u % rows;
        kg = u / rows;
    }
}

// A ROWS x BK tile of a float32 or bfloat16 matrix read through strides
// (srow, sk): each producer thread holds U row pieces of 4 values, as
// loaded (sizeof(T) words a piece).  The piece order follows the
// unit-stride dimension, so a warp's loads are contiguous both for a
// K-major source (16-byte loads where the whole tile is aligned and in
// range) and for a row-major one (4 loads, each coalesced across the
// warp).  Every load of a step is issued before any is used: a value
// out of range loads from the base address and the store writes a zero
// in its place, so no branch stands between the loads (branches that did
// made each load wait for the one before, several microseconds a step).
template <int ROWS, typename T>
struct StridedTile {
    static constexpr int UNITS = ROWS * BK / 4;
    static constexpr int U = (UNITS + NPROD - 1) / NPROD;
    static constexpr int W = sizeof(T);          // words a piece
    uint32_t raw[U][W];

    __device__ __forceinline__ void unit(int i, int& row, int& kg, bool kfast) const
    {
        kmajor_or_rows((threadIdx.x % NPROD) + i * NPROD, row, kg, kfast, ROWS);
    }

    __device__ __forceinline__ bool owned(int i) const
    {
        return !(UNITS % NPROD) || (threadIdx.x % NPROD) + i * NPROD < UNITS;
    }

    // rows and values of K this step has in range (the stores zero the rest)
    int rows_in, k_in;
    __device__ __forceinline__ bool in_range(int row, int k) const
    {
        return row < rows_in && k < k_in;
    }

    __device__ __forceinline__ void load(const T* base, int64_t srow, int64_t sk,
                                         int64_t nrows, int64_t kmax,
                                         int64_t r0, int64_t k0)
    {
        const bool kfast = sk == 1;
        rows_in = nrows - r0 < ROWS ? (int)(nrows - r0) : ROWS;
        k_in = kmax - k0 < BK ? (int)(kmax - k0) : BK;
        const bool vec = kfast && k_in == BK && srow % 4 == 0
            && ((uintptr_t)base & (4 * sizeof(T) - 1)) == 0;
        const T* b0 = base + r0 * srow + k0 * sk;
        if (vec) {
#pragma unroll
            for (int i = 0; i < U; ++i) {
                int row, kg;
                unit(i, row, kg, true);
                const bool ok = owned(i) && row < rows_in;
                const T* p = ok ? b0 + row * srow + 4 * kg : base;
                if constexpr (W == 4) {
                    const uint4 f = __ldg((const uint4*)p);
                    raw[i][0] = f.x; raw[i][1] = f.y; raw[i][2] = f.z; raw[i][3] = f.w;
                } else {
                    const uint2 h = __ldg((const uint2*)p);
                    raw[i][0] = h.x; raw[i][1] = h.y;
                }
            }
        } else {
#pragma unroll
            for (int i = 0; i < U; ++i) {
                int row, kg;
                unit(i, row, kg, kfast);
#pragma unroll
                for (int w = 0; w < W; ++w) raw[i][w] = 0u;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const bool ok = owned(i) && in_range(row, 4 * kg + j);
                    const T* p = ok ? b0 + row * srow + (4 * kg + j) * sk : base;
                    raw[i][W == 4 ? j : j / 2] |= bits(p) << (W == 4 ? 0 : 16 * (j & 1));
                }
            }
        }
    }

    // the P TF32 parts, into P tiles from `tile` on
    template <int P>
    __device__ __forceinline__ void put(uint8_t* tile, bool kfast) const
    {
#pragma unroll
        for (int i = 0; i < U; ++i) {
            if (!owned(i)) continue;
            int row, kg;
            unit(i, row, kg, kfast);
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float f = W == 4
                    ? __uint_as_float(raw[i][j])
                    : __uint_as_float(((raw[i][j / 2] >> 16 * (j & 1)) & 0xFFFFu) << 16);
                v[j] = in_range(row, 4 * kg + j) ? f : 0.f;
            }
            store_parts<P>(tile, tile_bytes(ROWS), unit_offset(row, kg), v);
        }
    }

    // The activation tile as loaded, float32 at a row pitch of XP floats
    // (the ring's A area), for the consumers to split.  Float32 sources
    // go by cp.async (16-byte copies where the step's tile is K-major and
    // aligned, else 4-byte ones; out of range: zeros), bf16 ones through
    // registers (load, then put_raw).
    template <int XP>
    __device__ __forceinline__ void issue_raw(uint8_t* dst, const T* base,
                                              int64_t srow, int64_t sk,
                                              int64_t nrows, int64_t kmax,
                                              int64_t r0, int64_t k0) const
    {
        static_assert(W == 4, "cp.async takes float32 activations");
        const bool kfast = sk == 1;
        const int rows = nrows - r0 < ROWS ? (int)(nrows - r0) : ROWS;
        const int ks = kmax - k0 < BK ? (int)(kmax - k0) : BK;
        const bool vec = kfast && ks == BK && srow % 4 == 0
            && ((uintptr_t)base & 15) == 0;
        const T* b0 = base + r0 * srow + k0 * sk;
#pragma unroll
        for (int i = 0; i < U; ++i) {
            if (!owned(i)) continue;
            int row, kg;
            unit(i, row, kg, kfast);
            uint8_t* d = dst + (row * XP + 4 * kg) * 4;
            if (vec) {
                const bool ok = row < rows;
                cp16(d, ok ? b0 + row * srow + 4 * kg : base, ok);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const bool ok = row < rows && 4 * kg + j < ks;
                    cp4(d + 4 * j, ok ? b0 + row * srow + (4 * kg + j) * sk
                                      : base, ok);
                }
            }
        }
    }

    template <int XP>
    __device__ __forceinline__ void put_raw(uint8_t* dst, bool kfast) const
    {
#pragma unroll
        for (int i = 0; i < U; ++i) {
            if (!owned(i)) continue;
            int row, kg;
            unit(i, row, kg, kfast);
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float x = W == 4
                    ? __uint_as_float(raw[i][j])
                    : __uint_as_float(((raw[i][j / 2] >> 16 * (j & 1)) & 0xFFFFu) << 16);
                v[j] = in_range(row, 4 * kg + j) ? x : 0.f;
            }
            *(float4*)(dst + (row * XP + 4 * kg) * 4) =
                make_float4(v[0], v[1], v[2], v[3]);
        }
    }

    static __device__ __forceinline__ uint32_t bits(const float* p)
    {
        return __float_as_uint(__ldg(p));
    }
    static __device__ __forceinline__ uint32_t bits(const __nv_bfloat16* p)
    {
        return __ldg((const unsigned short*)p);
    }
    static __device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
    static __device__ __forceinline__ float ld(const __nv_bfloat16* p)
    {
        return __bfloat162float(*p);
    }
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v)
{
    *p = __float2bfloat16(v);
}

// ----------------------------------------------------------------- split-K
// Splits of the reduction for a grid of `ctas` output tiles and `steps`
// reduction steps: only a grid that leaves most SMs idle is split, and
// every split keeps at least 4 steps.  Returns the steps of one split;
// the split count is ceil(steps / that).
inline int64_t split_steps(int64_t ctas, int64_t steps, int sms)
{
    if (ctas <= 0 || steps <= 0 || 4 * ctas >= 3 * sms) return steps > 0 ? steps : 1;
    int64_t s = sms / ctas;
    if (s > steps / 4) s = steps / 4;
    if (s > MAX_SPLITS) s = MAX_SPLITS;
    if (s < 2) return steps;
    return (steps + s - 1) / s;
}

// A kernel's function attributes (the dynamic shared memory it may take)
// belong to the current device, so a launcher sets them once a device:
// `flags` holds one "set" flag a device; null past MAX_DEVICES, where the
// caller sets them every launch.
constexpr int MAX_DEVICES = 64;
inline bool* device_flag(bool (&flags)[MAX_DEVICES])
{
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
        return nullptr;
    return &flags[dev];
}

inline int sm_count()
{
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
}

// The second pass of a split reduction: out[i] = sum over the splits of
// ws[s * n + i], in split order, so two launches give equal bits.
template <typename T>
__global__ void __launch_bounds__(256) reduce_splits(const float* ws, T* out,
                                                     int64_t n, int splits)
{
    for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * blockDim.x) {
        float s = ws[i];
        for (int k = 1; k < splits; ++k) s += ws[k * n + i];
        store_out(out + i, s);
    }
}

}  // namespace tf32x3
