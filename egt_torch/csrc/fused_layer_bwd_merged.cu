// Whole EGT layer, merged backward from the saved h_hat, for sm_90a.
//
// Replaces: egt_tpu/ops/fused_layer_pallas.py::_bwd_merged_kernel, called
// through _fused_layer_bwd_call_merged (_BWD_IMPL "merged").
//
// The bodies of the split backward's two kernels (fused_layer_bwd_tail.cu,
// fused_layer_bwd_attn.cu) in one: per query row, the tail backward of the
// row's pairs from the saved h_hat, then the softmax chain re-entered at
// that h_hat and the attention and edge-head backward, with de_mid and dhh
// kept on chip in f32 (the split writes them to device memory in the
// working type). The clip's in-range test is strict, on hh - E. The math,
// the bound and the design are in fused_layer_bwd_row.cuh.

#include "fused_layer_bwd_row.cuh"

extern "C" int fused_layer_bwd_merged(EGT_ROW_ARGS) {
  return egt::row_entry<false>(dtype, EGT_ROW_PARAMS, dw, stream);
}
