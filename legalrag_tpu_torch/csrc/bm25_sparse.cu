// BM25 from CSR postings: scatter-add of each query's postings into a score
// row, plus a mask of the docs a counted posting touched.
//
// Replaces the Pallas kernel legalrag_tpu/ops/bm25_sparse.py:
// _bm25_sparse_kernel (entry bm25_sparse_scores), which walks, per query
// row, each (term id, count) slot's postings [offsets[t], offsets[t+1]) in
// chunk windows and scatter-adds post_w * count into an f32 row of
// n_docs_pad, dropping ids out of range. For each query b and slot s with
// count c != 0 and term id t in [0, V):
//   for p in [offsets[t], offsets[t] + min(offsets[t+1] - offsets[t], cap)):
//     scores[b, post_docs[p]] += post_w[p] * float(c)
//     touched[b, post_docs[p]] = 1            (only when c > 0)
// Doc ids outside [0, n_docs_pad) are dropped. With cap = INT_MAX the scores
// are the Pallas kernel's; with cap = max_postings / L and the touched mask
// they define the top list of bm25_sparse_topk_auto (the wrapper selects it).
//
// The Pallas kernel never lowered on the TPU, because Mosaic has no
// scatter-add; on Hopper scatter-add is a native atomic. So the design is
// the simple one: one block per (slot, query), its threads striding over the
// slot's postings (coalesced 4-byte loads of doc ids and weights), atomicAdd
// on the f32 score, a plain byte store for the mask (every writer stores 1).
// The atomics reorder the sums from run to run: the scores agree with the
// plain version's slot-by-slot order to float32 rounding, not bit for bit.
//
// What bounds it on an H100: bytes. Both outputs, [B, n_docs_pad] f32 and
// u8, are zeroed on the stream first (cudaMemsetAsync) and are the largest
// traffic: 5 * B * n_docs_pad bytes, 335 MB at B = 64 and 1M docs, 0.1 ms at
// 3.35 TB/s. The gathered postings (8 bytes each, ~3K per query at the
// 1M-doc scale point) are a few MB; the work is one multiply-add per posting.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bm25_sparse_kernel(const int* __restrict__ term_ids,
                   const int* __restrict__ term_counts, int L,
                   const int* __restrict__ offsets, int V,
                   const int* __restrict__ post_docs,
                   const float* __restrict__ post_w, int n_docs_pad, int cap,
                   float* __restrict__ scores,
                   unsigned char* __restrict__ touched) {
  const int slot = blockIdx.x;
  const int b = blockIdx.y;
  const int t = term_ids[b * L + slot];
  const int c = term_counts[b * L + slot];
  if (c == 0 || t < 0 || t >= V) return;
  const int start = offsets[t];
  const int size = min(max(offsets[t + 1] - start, 0), cap);
  const float cf = (float)c;
  const bool mark = c > 0;
  float* row = scores + (size_t)b * n_docs_pad;
  unsigned char* trow = touched + (size_t)b * n_docs_pad;
  for (int p = threadIdx.x; p < size; p += THREADS) {
    const int d = post_docs[start + p];
    if (d < 0 || d >= n_docs_pad) continue;
    atomicAdd(row + d, post_w[start + p] * cf);
    if (mark) trow[d] = 1;
  }
}

}  // namespace

extern "C" {

// term_ids, term_counts int32 [B, L]; offsets int32 [V + 1]; post_docs int32
// and post_w float32 [NNZ_pad]; scores float32 and touched uint8
// [B, n_docs_pad], both zeroed here on the stream before the launch;
// cap >= 0 postings per slot at most. Returns cudaGetLastError().
int bm25_sparse(const void* term_ids, const void* term_counts, int B, int L,
                const void* offsets, int V, const void* post_docs,
                const void* post_w, int n_docs_pad, int cap, void* scores,
                void* touched, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t cells = (size_t)B * n_docs_pad;
  cudaError_t e = cudaMemsetAsync(scores, 0, cells * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(touched, 0, cells, s);
  if (e != cudaSuccess) return (int)e;
  if (B == 0 || L == 0) return (int)cudaGetLastError();
  const dim3 grid(L, B);
  bm25_sparse_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const int*>(term_ids), static_cast<const int*>(term_counts),
      L, static_cast<const int*>(offsets), V,
      static_cast<const int*>(post_docs), static_cast<const float*>(post_w),
      n_docs_pad, cap, static_cast<float*>(scores),
      static_cast<unsigned char*>(touched));
  return (int)cudaGetLastError();
}

}  // extern "C"
