// Whole EGT layer, backward with nothing saved but the inputs ("mono"), for
// sm_90a.
//
// Replaces: egt_tpu/ops/fused_layer_pallas.py::_bwd_kernel, called through
// _fused_layer_bwd_call (_BWD_IMPL "mono").
//
// Per query row it recomputes the edge head, q.k and h_hat in f32 as the
// forward did, runs the tail backward of the row's pairs from rnd(h_hat),
// then the attention and edge-head backward with the softmax chain at the
// f32 h_hat; de_mid and dhh stay on chip in f32. The clip's in-range test
// is strict, on the recomputed raw logit. The math, the bound and the
// design are in fused_layer_bwd_row.cuh.

#include "fused_layer_bwd_row.cuh"

extern "C" int fused_layer_bwd_mono(EGT_ROW_ARGS) {
  return egt::row_entry(dtype, EGT_ROW_PARAMS, dw, stream);
}
