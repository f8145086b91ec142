// Native batch assembler of the port's data reader: builds the dense padded
// per-batch graph tensors (adjacency with self-loops, +-1-marked edge-feature
// matrices, edge-label target matrices) from ragged record arrays in one
// parallel pass.
//
// The port's own copy of `egt_tpu/native/batch_builder.cpp`, byte for byte in
// its functions. The O(B*E) scatter work runs in C++ (OpenMP over the batch)
// so the Python feeding thread does not hold the card back. Exposed via a
// plain C ABI and loaded with ctypes (see __init__.py); output buffers are
// pre-filled by the caller with the pad value, matching the numpy path
// (`egt_torch/data/dataset.py`) exactly: scatter ADDS onto the fill value, so
// duplicate edges sum.
//
// Build: g++ -O3 -shared -fPIC -fopenmp batch_builder.cpp

#include <cstdint>

extern "C" {

// Adjacency: out (nb, L, L) pre-zeroed; adds 1 per edge and +1 on the diagonal
// (self-loops appended as extra edges, `graph.py:4-13,57-66`).
void assemble_adjacency(
    const int64_t* sel, int64_t nb,
    const int32_t* num_nodes,          // per record, full dataset
    const int64_t* edges_flat,         // (sum_E, 2)
    const int64_t* edges_off,          // record offsets into edges_flat rows
    int64_t L,
    float* adj_out) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < nb; ++j) {
    const int64_t rec = sel[j];
    const int64_t n = num_nodes[rec];
    float* adj = adj_out + j * L * L;
    const int64_t e0 = edges_off[rec], e1 = edges_off[rec + 1];
    for (int64_t e = e0; e < e1; ++e) {
      const int64_t s = edges_flat[2 * e], d = edges_flat[2 * e + 1];
      adj[s * L + d] += 1.0f;
    }
    for (int64_t i = 0; i < n; ++i) adj[i * L + i] += 1.0f;
  }
}

// Integer edge-feature matrix: out (nb, L, L) pre-filled with -1; real cells get
// the (possibly duplicate-summed) feature value via the +1/-1 shift.
void assemble_feature_matrix_i32(
    const int64_t* sel, int64_t nb,
    const int64_t* edges_flat, const int64_t* edges_off,
    const int32_t* feat_flat, const int64_t* feat_off,
    int64_t L,
    int32_t* fm_out) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < nb; ++j) {
    const int64_t rec = sel[j];
    int32_t* fm = fm_out + j * L * L;
    const int64_t e0 = edges_off[rec], e1 = edges_off[rec + 1];
    const int64_t f0 = feat_off[rec];
    for (int64_t e = e0; e < e1; ++e) {
      const int64_t s = edges_flat[2 * e], d = edges_flat[2 * e + 1];
      fm[s * L + d] += feat_flat[f0 + (e - e0)] + 1;
    }
  }
}

// Float edge-feature matrix with feature dim F: out (nb, L, L, F) pre-filled -1.
void assemble_feature_matrix_f32(
    const int64_t* sel, int64_t nb,
    const int64_t* edges_flat, const int64_t* edges_off,
    const float* feat_flat, const int64_t* feat_off, int64_t F,
    int64_t L,
    float* fm_out) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < nb; ++j) {
    const int64_t rec = sel[j];
    float* fm = fm_out + j * L * L * F;
    const int64_t e0 = edges_off[rec], e1 = edges_off[rec + 1];
    const int64_t f0 = feat_off[rec];
    for (int64_t e = e0; e < e1; ++e) {
      const int64_t s = edges_flat[2 * e], d = edges_flat[2 * e + 1];
      float* cell = fm + (s * L + d) * F;
      const float* feat = feat_flat + (f0 + (e - e0)) * F;
      for (int64_t f = 0; f < F; ++f) cell[f] += feat[f] + 1.0f;
    }
  }
}

// Multi-column integer edge features (e.g. PCQM4Mv2's 3 bond columns):
// out (nb, L, L, F) pre-filled -1; each real cell gets feat + 1 per column
// (duplicate edges sum, as in tf.scatter_nd).
void assemble_feature_matrix_i32_multi(
    const int64_t* sel, int64_t nb,
    const int64_t* edges_flat, const int64_t* edges_off,
    const int32_t* feat_flat, const int64_t* feat_off, int64_t F,
    int64_t L,
    int32_t* fm_out) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < nb; ++j) {
    const int64_t rec = sel[j];
    int32_t* fm = fm_out + j * L * L * F;
    const int64_t e0 = edges_off[rec], e1 = edges_off[rec + 1];
    const int64_t f0 = feat_off[rec];
    for (int64_t e = e0; e < e1; ++e) {
      const int64_t s = edges_flat[2 * e], d = edges_flat[2 * e + 1];
      int32_t* cell = fm + (s * L + d) * F;
      const int32_t* feat = feat_flat + (f0 + (e - e0)) * F;
      for (int64_t f = 0; f < F; ++f) cell[f] += feat[f] + 1;
    }
  }
}

// Edge-label target matrix: out (nb, L, L) pre-zeroed; labels scatter-add
// (`datasets/tsp.py:117-121` FeatureMatrix without the +-1 shift).
void assemble_edge_targets(
    const int64_t* sel, int64_t nb,
    const int64_t* edges_flat, const int64_t* edges_off,
    const int32_t* labels_flat, const int64_t* labels_off,
    int64_t L,
    int32_t* tgt_out) {
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < nb; ++j) {
    const int64_t rec = sel[j];
    int32_t* tgt = tgt_out + j * L * L;
    const int64_t e0 = edges_off[rec], e1 = edges_off[rec + 1];
    const int64_t l0 = labels_off[rec];
    for (int64_t e = e0; e < e1; ++e) {
      const int64_t s = edges_flat[2 * e], d = edges_flat[2 * e + 1];
      tgt[s * L + d] += labels_flat[l0 + (e - e0)];
    }
  }
}

}  // extern "C"
