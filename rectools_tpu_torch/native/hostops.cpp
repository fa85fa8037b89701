// Native host-side data ops of the PyTorch port (a copy of
// rectools_tpu/native/hostops.cpp).
//
// The GPU does the model compute; the host must keep up when collating
// ragged sessions into fixed-shape batches (KION: 5.5M interactions, ~1M
// sessions). These are the host pipeline's hot loops, built at first use by
// rectools_tpu_torch.native with g++ -O3 and bound with ctypes. The
// vectorised numpy versions beside each call site stay as the fallback when
// no compiler is available or RECTOOLS_TPU_TORCH_NO_NATIVE is set.
//
// All functions use the C ABI; callers pass pre-allocated, pre-filled
// output buffers.
//
// Two differences from the JAX copy. The loops run on one thread: the
// serving and training batches copy 0.05-1.3M values, a few hundred
// microseconds on one core, and an OpenMP region waits for its slowest
// thread, so on a host whose cores are shared its tail is longer (PERF.md
// §6). And csr_rows_padded_i32 takes each row's start and length,
// worked out for the batch's rows only, rather than the whole indptr.

#include <cstdint>
#include <algorithm>

extern "C" {

// Ragged -> dense with left padding and right truncation:
// out[i, out_len - min(len_i, out_len) + j] = values[start_i + drop_i + j]
// where drop_i = max(len_i - out_len, 0). `out` must be pre-filled with the
// pad value. Mirrors data_preparator.scatter_left_padded's numpy path.
void scatter_left_padded_i64(
    const int64_t* values,
    const int64_t* starts,
    const int64_t* lengths,
    int64_t n_rows,
    int64_t out_len,
    int64_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t len = lengths[i];
    int64_t clipped = std::min(len, out_len);
    int64_t src = starts[i] + (len - clipped);
    int64_t dst = i * out_len + (out_len - clipped);
    for (int64_t j = 0; j < clipped; ++j) out[dst + j] = values[src + j];
  }
}

void scatter_left_padded_f32(
    const float* values,
    const int64_t* starts,
    const int64_t* lengths,
    int64_t n_rows,
    int64_t out_len,
    float* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t len = lengths[i];
    int64_t clipped = std::min(len, out_len);
    int64_t src = starts[i] + (len - clipped);
    int64_t dst = i * out_len + (out_len - clipped);
    for (int64_t j = 0; j < clipped; ++j) out[dst + j] = values[src + j];
  }
}

// Per-row CSR column extraction into a right-padded (n_rows, max_len) int32
// table (the top-k engine's seen-list format): row i copies
// indices[starts[i], starts[i] + lengths[i]). `out` pre-filled with the fill
// sentinel. Mirrors ops.topk._csr_rows_to_padded_idx's numpy path.
void csr_rows_padded_i32(
    const int32_t* indices,
    const int64_t* starts,
    const int64_t* lengths,
    int64_t n_rows,
    int64_t max_len,
    int32_t* out) {
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t start = starts[i];
    int64_t dst = i * max_len;
    for (int64_t j = 0; j < lengths[i]; ++j) out[dst + j] = indices[start + j];
  }
}

// SASRec shifted-sequence collation in one pass. The rows are sorted by
// (session, datetime) on the Python side; for each session of the batch it
// writes x = s[:-1], y = s[1:] and yw = the weights of s[1:], right-aligned
// and keeping the last out_len pairs. Mirrors the three scatter_left_padded
// calls of sasrec.SASRecDataPreparator._collate_fn_train.
void sasrec_train_collate(
    const int64_t* items,
    const float* weights,
    const int64_t* starts,
    const int64_t* lengths,  // session lengths (>= 2)
    int64_t n_rows,
    int64_t out_len,
    int64_t* x_out,   // pre-filled with 0
    int64_t* y_out,   // pre-filled with 0
    float* yw_out) {  // pre-filled with 0
  for (int64_t i = 0; i < n_rows; ++i) {
    int64_t m = lengths[i] - 1;            // shifted-pair count
    int64_t clipped = std::min(m, out_len);
    int64_t drop = m - clipped;
    int64_t src = starts[i] + drop;
    int64_t dst = i * out_len + (out_len - clipped);
    for (int64_t j = 0; j < clipped; ++j) {
      x_out[dst + j] = items[src + j];
      y_out[dst + j] = items[src + j + 1];
      yw_out[dst + j] = weights[src + j + 1];
    }
  }
}

}  // extern "C"
