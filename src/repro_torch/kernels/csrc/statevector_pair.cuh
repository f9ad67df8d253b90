// The amplitude-pair update shared by the statevector kernels
// (statevector_gate.cu, one gate a launch, and statevector_tape.cu, a
// whole tape a launch), so that both round alike.
//
// (a0, a1) <- g (a0, a1) for one 2x2 complex gate given as re/im planes
// (g00, g01, g10, g11) in a float4 each.  The complex products associate
// as (g.a0) + (g.a1), in the order of ref.statevector_gate, and every
// product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn): nvcc may not contract them into fused
// multiply-adds, so the result is bitwise what PyTorch's elementwise
// product and sum kernels give for the same float32 inputs.
#pragma once

namespace svp {

__device__ __forceinline__ void pair_update(
    const float4 gr, const float4 gi,
    float& a0r, float& a0i, float& a1r, float& a1i)
{
    const float n0r = __fadd_rn(__fsub_rn(__fmul_rn(gr.x, a0r), __fmul_rn(gi.x, a0i)),
                                __fsub_rn(__fmul_rn(gr.y, a1r), __fmul_rn(gi.y, a1i)));
    const float n0i = __fadd_rn(__fadd_rn(__fmul_rn(gr.x, a0i), __fmul_rn(gi.x, a0r)),
                                __fadd_rn(__fmul_rn(gr.y, a1i), __fmul_rn(gi.y, a1r)));
    const float n1r = __fadd_rn(__fsub_rn(__fmul_rn(gr.z, a0r), __fmul_rn(gi.z, a0i)),
                                __fsub_rn(__fmul_rn(gr.w, a1r), __fmul_rn(gi.w, a1i)));
    const float n1i = __fadd_rn(__fadd_rn(__fmul_rn(gr.z, a0i), __fmul_rn(gi.z, a0r)),
                                __fadd_rn(__fmul_rn(gr.w, a1i), __fmul_rn(gi.w, a1r)));
    a0r = n0r; a0i = n0i; a1r = n1r; a1i = n1i;
}

}  // namespace svp
