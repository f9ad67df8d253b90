// Causal / sliding-window attention with grouped KV heads for Hopper
// (sm_90a), forward and backward, float32 softmax and accumulation with
// FFMA (no TF32).
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
// Forward (attn_fwd_kernel): one CTA of 128 threads per (q-tile of 32
// rows, q-head, sequence).  Four neighbouring lanes share a q row, each
// holding every fourth of its D dims in registers; K/V tiles of 32 keys
// are staged in shared memory.  A score is four partial dot products
// joined by two warp shuffles, so every lane of a row holds all 32 scores
// of the tile and does the online-softmax update on its own.  Tiles
// wholly outside the causal / window range are skipped.  It writes the
// output and the per-row logsumexp for the backward.
//
// Backward, FA2-style, in two passes that need no atomics: P is
// recomputed from the saved logsumexp, and delta = rowsum(dO * O) is
// recomputed where it is needed.
//  - attn_bwd_dkv_kernel: one CTA per (k-tile of 32 keys, kv-head,
//    sequence).  Each lane holds a slice of one key's K and V rows and of
//    its dK and dV accumulators; the CTA walks the G q-heads that share
//    the kv-head and their q-tiles in range, staging Q and dO tiles.
//  - attn_bwd_dq_kernel: one CTA per (q-tile, q-head, sequence), walking
//    the k-tiles in range, as the forward does.
//
// Bound: at the main path's shapes (S = 64, D = 32 or 64) the work is
// small; the bound is the bytes of q, k, v and o (and dO, dq, dk, dv
// backward) against 3.35 TB/s, and the flops against 67 TFLOP/s.
//
// C interface for ctypes: each launch returns cudaGetLastError() as int.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32, BKV = 32, NT = 128, TPR = 4;
constexpr float NEG_INF = -1e30f;

struct Args {
    const void* q; const void* k; const void* v; const void* o;
    const void* dout; float* lse;
    void* out; void* dq; void* dk; void* dv;
    int B, S, Sk, H, KH, G;
    float scale;
    int causal, window;
    int64_t sqb, sqs, sqh;   // q (B, S, H, D), unit stride along D
    int64_t skb, sks, skh;   // k (B, Sk, KH, D)
    int64_t svb, svs, svh;   // v (B, Sk, KH, D)
    int64_t sdb, sds, sdh;   // dO (B, S, H, D)
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}

// sum over the TPR lanes that share a row
__device__ __forceinline__ float row_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    return v;
}

__device__ __forceinline__ bool attendable(const Args& p, int qi, int kj) {
    return qi < p.S && kj < p.Sk && (!p.causal || kj <= qi)
        && (p.window <= 0 || qi - kj < p.window);
}

// keys [kstart, kend) that some row of q-tile [q0, q0 + BQ) may attend
__device__ __forceinline__ void key_range(const Args& p, int q0, int* kstart,
                                          int* kend) {
    *kstart = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
    *kend = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
}

// output rows are contiguous (B, S, H, D)
__device__ __forceinline__ int64_t out_row(const Args& p, int b, int s, int h,
                                           int D) {
    return (((int64_t)b * p.S + s) * p.H + h) * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_fwd_kernel(Args p)
{
    constexpr int DP = D / TPR;
    __shared__ float Ks[BKV][D];
    __shared__ float Vs[BKV][D];
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kh = h / p.G;
    const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
    const int qi = q0 + row;
    const bool qvalid = qi < p.S;
    const T* qp = (const T*)p.q + b * p.sqb + (int64_t)qi * p.sqs + h * p.sqh;
    const T* kp = (const T*)p.k + b * p.skb + kh * p.skh;
    const T* vp = (const T*)p.v + b * p.svb + kh * p.svh;

    float qv[DP], acc[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) {
        qv[i] = qvalid ? load(qp + sub + TPR * i) : 0.f;
        acc[i] = 0.f;
    }
    float m = NEG_INF, l = 0.f;
    int kstart, kend;
    key_range(p, q0, &kstart, &kend);
    for (int k0 = kstart; k0 < kend; k0 += BKV) {
        __syncthreads();
        for (int i = tid; i < BKV * D; i += NT) {
            const int kk = i / D, d = i % D, kj = k0 + kk;
            Ks[kk][d] = kj < p.Sk ? load(kp + (int64_t)kj * p.sks + d) : 0.f;
            Vs[kk][d] = kj < p.Sk ? load(vp + (int64_t)kj * p.svs + d) : 0.f;
        }
        __syncthreads();
        float s[BKV];
        unsigned valid = 0u;
        float mt = NEG_INF;
#pragma unroll
        for (int j = 0; j < BKV; ++j) {
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < DP; ++i)
                part = fmaf(qv[i], Ks[j][sub + TPR * i], part);
            s[j] = row_sum(part) * p.scale;
            if (attendable(p, qi, k0 + j)) {
                valid |= 1u << j;
                mt = fmaxf(mt, s[j]);
            }
        }
        const float mn = fmaxf(m, mt);
        const float alpha = expf(m - mn);
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < BKV; ++j) {
            s[j] = (valid >> j) & 1u ? expf(s[j] - mn) : 0.f;
            ls += s[j];
        }
        l = l * alpha + ls;
#pragma unroll
        for (int i = 0; i < DP; ++i) {
            float a = acc[i] * alpha;
#pragma unroll
            for (int j = 0; j < BKV; ++j)
                a = fmaf(s[j], Vs[j][sub + TPR * i], a);
            acc[i] = a;
        }
        m = mn;
    }
    if (!qvalid) return;
    T* op = (T*)p.out + out_row(p, b, qi, h, D);
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DP; ++i) store(op + sub + TPR * i, acc[i] * inv);
    if (sub == 0)
        p.lse[((int64_t)b * p.H + h) * p.S + qi] =
            l > 0.f ? m + logf(l) : -INFINITY;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_bwd_dkv_kernel(Args p)
{
    constexpr int DP = D / TPR;
    __shared__ float Qs[BQ][D];
    __shared__ float dOs[BQ][D];
    __shared__ float lse_s[BQ], delta_s[BQ];
    const int k0 = blockIdx.x * BKV, kh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
    const int kj = k0 + row;
    const bool kvalid = kj < p.Sk;
    const T* kp = (const T*)p.k + b * p.skb + (int64_t)kj * p.sks + kh * p.skh;
    const T* vp = (const T*)p.v + b * p.svb + (int64_t)kj * p.svs + kh * p.svh;

    float kv[DP], vv[DP], dk[DP], dv[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) {
        kv[i] = kvalid ? load(kp + sub + TPR * i) : 0.f;
        vv[i] = kvalid ? load(vp + sub + TPR * i) : 0.f;
        dk[i] = 0.f;
        dv[i] = 0.f;
    }
    const int qstart = p.causal ? k0 : 0;
    const int qend = p.window > 0 ? min(p.S, k0 + BKV - 1 + p.window) : p.S;
    for (int g = 0; g < p.G; ++g) {
        const int h = kh * p.G + g;
        const T* qh = (const T*)p.q + b * p.sqb + h * p.sqh;
        const T* dh = (const T*)p.dout + b * p.sdb + h * p.sdh;
        for (int q0 = qstart; q0 < qend; q0 += BQ) {
            __syncthreads();
            for (int i = tid; i < BQ * D; i += NT) {
                const int qq = i / D, d = i % D, qi = q0 + qq;
                const bool ok = qi < p.S;
                Qs[qq][d] = ok ? load(qh + (int64_t)qi * p.sqs + d) : 0.f;
                dOs[qq][d] = ok ? load(dh + (int64_t)qi * p.sds + d) : 0.f;
            }
            {   // delta = rowsum(dO * O) and the logsumexp of row q0 + row
                const int qi = q0 + row;
                float part = 0.f;
                if (qi < p.S) {
                    const T* orow = (const T*)p.o + out_row(p, b, qi, h, D);
                    const T* drow = dh + (int64_t)qi * p.sds;
#pragma unroll
                    for (int i = 0; i < DP; ++i)
                        part = fmaf(load(drow + sub + TPR * i),
                                    load(orow + sub + TPR * i), part);
                }
                part = row_sum(part);
                if (sub == 0) {
                    delta_s[row] = part;
                    lse_s[row] = qi < p.S
                        ? p.lse[((int64_t)b * p.H + h) * p.S + qi] : 0.f;
                }
            }
            __syncthreads();
            for (int qq = 0; qq < BQ; ++qq) {
                const int qi = q0 + qq;
                float sp = 0.f, dp = 0.f;
#pragma unroll
                for (int i = 0; i < DP; ++i) {
                    sp = fmaf(Qs[qq][sub + TPR * i], kv[i], sp);
                    dp = fmaf(dOs[qq][sub + TPR * i], vv[i], dp);
                }
                sp = row_sum(sp) * p.scale;
                dp = row_sum(dp);
                const float pr = attendable(p, qi, kj)
                    ? expf(sp - lse_s[qq]) : 0.f;
                const float ds = pr * (dp - delta_s[qq]);
#pragma unroll
                for (int i = 0; i < DP; ++i) {
                    dv[i] = fmaf(pr, dOs[qq][sub + TPR * i], dv[i]);
                    dk[i] = fmaf(ds, Qs[qq][sub + TPR * i], dk[i]);
                }
            }
        }
    }
    if (!kvalid) return;
    const int64_t o = (((int64_t)b * p.Sk + kj) * p.KH + kh) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
        store((T*)p.dk + o + sub + TPR * i, dk[i] * p.scale);
        store((T*)p.dv + o + sub + TPR * i, dv[i]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) attn_bwd_dq_kernel(Args p)
{
    constexpr int DP = D / TPR;
    __shared__ float Ks[BKV][D];
    __shared__ float Vs[BKV][D];
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kh = h / p.G;
    const int tid = threadIdx.x, row = tid / TPR, sub = tid % TPR;
    const int qi = q0 + row;
    const bool qvalid = qi < p.S;
    const T* qp = (const T*)p.q + b * p.sqb + (int64_t)qi * p.sqs + h * p.sqh;
    const T* dp_ = (const T*)p.dout + b * p.sdb + (int64_t)qi * p.sds + h * p.sdh;
    const T* op = (const T*)p.o + out_row(p, b, qvalid ? qi : 0, h, D);
    const T* kp = (const T*)p.k + b * p.skb + kh * p.skh;
    const T* vp = (const T*)p.v + b * p.svb + kh * p.svh;

    float qv[DP], dov[DP], dq[DP];
    float delta = 0.f;
#pragma unroll
    for (int i = 0; i < DP; ++i) {
        qv[i] = qvalid ? load(qp + sub + TPR * i) : 0.f;
        dov[i] = qvalid ? load(dp_ + sub + TPR * i) : 0.f;
        dq[i] = 0.f;
        if (qvalid) delta = fmaf(dov[i], load(op + sub + TPR * i), delta);
    }
    delta = row_sum(delta);
    const float lse = qvalid ? p.lse[((int64_t)b * p.H + h) * p.S + qi] : 0.f;
    int kstart, kend;
    key_range(p, q0, &kstart, &kend);
    for (int k0 = kstart; k0 < kend; k0 += BKV) {
        __syncthreads();
        for (int i = tid; i < BKV * D; i += NT) {
            const int kk = i / D, d = i % D, kj = k0 + kk;
            Ks[kk][d] = kj < p.Sk ? load(kp + (int64_t)kj * p.sks + d) : 0.f;
            Vs[kk][d] = kj < p.Sk ? load(vp + (int64_t)kj * p.svs + d) : 0.f;
        }
        __syncthreads();
        for (int j = 0; j < BKV; ++j) {
            float sp = 0.f, dp = 0.f;
#pragma unroll
            for (int i = 0; i < DP; ++i) {
                sp = fmaf(qv[i], Ks[j][sub + TPR * i], sp);
                dp = fmaf(dov[i], Vs[j][sub + TPR * i], dp);
            }
            sp = row_sum(sp) * p.scale;
            dp = row_sum(dp);
            const float pr = attendable(p, qi, k0 + j) ? expf(sp - lse) : 0.f;
            const float ds = pr * (dp - delta);
#pragma unroll
            for (int i = 0; i < DP; ++i)
                dq[i] = fmaf(ds, Ks[j][sub + TPR * i], dq[i]);
        }
    }
    if (!qvalid) return;
    T* dqp = (T*)p.dq + out_row(p, b, qi, h, D);
#pragma unroll
    for (int i = 0; i < DP; ++i) store(dqp + sub + TPR * i, dq[i] * p.scale);
}

template <typename T, int D>
int launch(const Args& p, int backward, cudaStream_t s)
{
    if (!backward) {
        const dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
        attn_fwd_kernel<T, D><<<grid, NT, 0, s>>>(p);
    } else {
        const dim3 gkv((p.Sk + BKV - 1) / BKV, p.KH, p.B);
        attn_bwd_dkv_kernel<T, D><<<gkv, NT, 0, s>>>(p);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        const dim3 gq((p.S + BQ - 1) / BQ, p.H, p.B);
        attn_bwd_dq_kernel<T, D><<<gq, NT, 0, s>>>(p);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& p, int D, int backward, cudaStream_t s)
{
    switch (D) {
        case 32: return launch<T, 32>(p, backward, s);
        case 64: return launch<T, 64>(p, backward, s);
        case 128: return launch<T, 128>(p, backward, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

int run(const Args& p, int D, int dtype, int backward, void* stream)
{
    if (p.B == 0 || p.S == 0 || p.H == 0) return (int)cudaSuccess;
    if (p.KH <= 0 || p.H % p.KH) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) return dispatch<float>(p, D, backward, s);
    if (dtype == 1) return dispatch<__nv_bfloat16>(p, D, backward, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dO and the gradients share
// it; lse is float32).  Head dims 32, 64 and 128.
extern "C" int fa_forward(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int B, int S, int Sk, int H, int KH, int D, float scale, int causal,
    int window, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, int dtype, void* stream)
{
    Args p{q, k, v, nullptr, nullptr, lse, out, nullptr, nullptr, nullptr,
           B, S, Sk, H, KH, KH > 0 ? H / KH : 0, scale, causal, window,
           sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, 0, 0, 0};
    return run(p, D, dtype, 0, stream);
}

extern "C" int fa_backward(
    const void* q, const void* k, const void* v, const void* out,
    float* lse, const void* dout, void* dq, void* dk, void* dv,
    int B, int S, int Sk, int H, int KH, int D, float scale, int causal,
    int window, long long sqb, long long sqs, long long sqh,
    long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh,
    long long sdb, long long sds, long long sdh, int dtype, void* stream)
{
    Args p{q, k, v, out, dout, lse, nullptr, dq, dk, dv,
           B, S, Sk, H, KH, KH > 0 ? H / KH : 0, scale, causal, window,
           sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sdb, sds, sdh};
    return run(p, D, dtype, 1, stream);
}

extern "C" const char* fa_error_string(int err)
{
    return cudaGetErrorString((cudaError_t)err);
}
