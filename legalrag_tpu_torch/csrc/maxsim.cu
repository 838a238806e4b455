// Full-corpus MaxSim (late interaction) over a padded, masked token store.
//
// Replaces the Pallas kernels legalrag_tpu/ops/maxsim_pallas.py:_maxsim_kernel
// (entry maxsim_scores_pallas) and legalrag_tpu/ops/maxsim_pallas2.py:_kernel
// (entry maxsim_scores_pallas2); both compute the [B, N] map of the XLA
// maxsim_full (ops/maxsim.py:109-132) that the JAX engine runs:
//   score[b, n] = sum_{i : q_mask[b, i]} best(b, i, n)
//   best(b, i, n) = max_{j : doc_mask[n, j]} sum_c float(q[b, i, c]) * float(doc[n, j, c])
//   best(b, i, n) = 0 when doc n has no valid token (empty doc)
// with float32 sums of exact bf16 products. Negative best-matches stay
// negative. The masks are honoured as given: valid tokens need not be a
// prefix.
//
// Two launches: maxsim_tokens_kernel writes best(b, i, n) for every valid
// query token into scratch [N, B * Lq]; maxsim_reduce_kernel sums each
// query's valid tokens in token order into out [B, N] (a fixed order, so the
// result does not change from run to run).
//
// maxsim_tokens_kernel: a block owns up to THREADS valid query tokens (the
// valid tokens of the whole batch, compacted in the block's prologue, so no
// thread spends a doc on a padded query token) and walks a strided set of
// docs. For each doc it compacts the valid doc-token positions, stages those
// tokens widened to float32 in shared memory (<= L * DT * 4 bytes, 110 KB
// at L=220, DT=128) and each thread keeps its query token in DT registers
// and takes the running max of its dot products over the staged tokens.
//
// What bounds it on an H100: the padded work at the zh main-path shapes
// (B=64, Lq=64, N=2048, L=220, DT=128) is 2*64*64*2048*220*128 = 0.47 TFLOP,
// 0.48 ms at 989 TFLOP/s bf16. The valid-token work of real inputs is
// smaller: the zh doc-token fill is 21% with jieba's tokens and 63% with the
// char+bigram fallback, so a batch needs about a third of the padded work.
// The bytes of the valid tokens (plus masks, queries and the output) bound
// it next. This kernel skips all padded work but multiplies on the
// CUDA cores in float32, far above the tensor-core bound; wgmma is later work.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// Block-wide exclusive scan of one int per thread (THREADS threads).
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_tot[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < THREADS / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += n;
    }
    if (lane < THREADS / 32) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  const int before = warp ? warp_tot[warp - 1] : 0;
  *total = warp_tot[THREADS / 32 - 1];
  return before + inc - v;
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS, 1)
maxsim_tokens_kernel(const T* __restrict__ doc_tok,
                     const uint8_t* __restrict__ doc_mask,
                     const T* __restrict__ q_tok,
                     const uint8_t* __restrict__ q_mask, int S, int N, int L,
                     float* __restrict__ tokbest) {
  extern __shared__ float smem[];
  float* dtok = smem;                                // [L][DT] staged doc tokens
  int* vidx = reinterpret_cast<int*>(dtok + L * DT);  // [L] valid positions
  __shared__ int slots[THREADS];
  __shared__ int nvalid;
  const int tid = threadIdx.x;

  // prologue: compact the valid query-token slots (b * Lq + i) of the whole
  // batch and keep this block's run [blockIdx.y * THREADS, + THREADS)
  const int per = (S + THREADS - 1) / THREADS;
  const int s0 = min(S, tid * per), s1 = min(S, s0 + per);
  int cnt = 0;
  for (int s = s0; s < s1; ++s) cnt += q_mask[s] != 0;
  int total;
  int p = block_exclusive_scan(cnt, &total);
  const int first = blockIdx.y * THREADS;
  for (int s = s0; s < s1; ++s) {
    if (q_mask[s]) {
      if (p >= first && p < first + THREADS) slots[p - first] = s;
      ++p;
    }
  }
  __syncthreads();
  if (first >= total) return;  // uniform across the block
  const bool active = first + tid < total;
  const int slot = active ? slots[tid] : 0;

  float qreg[DT];
#pragma unroll
  for (int c = 0; c < DT; c += 8) {
    if (active) {
      lrt::load8(q_tok + (size_t)slot * DT + c, qreg + c);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) qreg[c + j] = 0.f;
    }
  }

  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    if (tid < 32) {  // warp 0 compacts the doc's valid token positions
      int count = 0;
      for (int base = 0; base < L; base += 32) {
        const int j = base + tid;
        const bool m = j < L && doc_mask[(size_t)n * L + j] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, m);
        if (m) vidx[count + __popc(bal & ((1u << tid) - 1u))] = j;
        count += __popc(bal);
      }
      if (tid == 0) nvalid = count;
    }
    __syncthreads();
    const int nv = nvalid;
    for (int e = tid; e < nv * (DT / 8); e += THREADS) {
      const int t = e / (DT / 8), c = (e - t * (DT / 8)) * 8;
      float f[8];
      lrt::load8(doc_tok + ((size_t)n * L + vidx[t]) * DT + c, f);
      float4* dst = reinterpret_cast<float4*>(dtok + t * DT + c);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
    if (active) {
      float best = -INFINITY;
      for (int t = 0; t < nv; ++t) {
        const float4* dv = reinterpret_cast<const float4*>(dtok + t * DT);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int c = 0; c < DT / 4; ++c) {
          const float4 x = dv[c];
          a0 = fmaf(qreg[4 * c + 0], x.x, a0);
          a1 = fmaf(qreg[4 * c + 1], x.y, a1);
          a2 = fmaf(qreg[4 * c + 2], x.z, a2);
          a3 = fmaf(qreg[4 * c + 3], x.w, a3);
        }
        best = fmaxf(best, (a0 + a1) + (a2 + a3));
      }
      tokbest[(size_t)n * S + slot] = nv > 0 ? best : 0.f;  // empty doc -> 0
    }
    __syncthreads();  // dtok / vidx / nvalid are rewritten for the next doc
  }
}

// out[b, n] = sum over the valid tokens i of query b, in order, of tokbest[n, b * Lq + i]
__global__ void maxsim_reduce_kernel(const float* __restrict__ tokbest,
                                     const uint8_t* __restrict__ q_mask, int B,
                                     int Lq, int N, float* __restrict__ out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * N) return;
  const int b = idx / N, n = idx - b * N;
  const size_t S = (size_t)B * Lq;
  float s = 0.f;
  for (int i = 0; i < Lq; ++i)
    if (q_mask[b * Lq + i]) s += tokbest[n * S + b * Lq + i];
  out[(size_t)b * N + n] = s;
}

template <typename T, int DT>
int launch(const void* doc_tok, const void* doc_mask, const void* q_tok,
           const void* q_mask, int B, int Lq, int N, int L, int grid_docs,
           void* scratch, void* out, cudaStream_t stream) {
  const int S = B * Lq;
  const size_t smem = (size_t)L * DT * sizeof(float) + (size_t)L * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_tokens_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_docs, (S + THREADS - 1) / THREADS);
  maxsim_tokens_kernel<T, DT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(doc_tok), static_cast<const uint8_t*>(doc_mask),
      static_cast<const T*>(q_tok), static_cast<const uint8_t*>(q_mask), S, N,
      L, static_cast<float*>(scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = B * N;
  maxsim_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<const uint8_t*>(q_mask),
      B, Lq, N, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dt(int dt, const void* doc_tok, const void* doc_mask,
                const void* q_tok, const void* q_mask, int B, int Lq, int N,
                int L, int grid_docs, void* scratch, void* out,
                cudaStream_t s) {
  switch (dt) {
    case 32:
      return launch<T, 32>(doc_tok, doc_mask, q_tok, q_mask, B, Lq, N, L,
                           grid_docs, scratch, out, s);
    case 64:
      return launch<T, 64>(doc_tok, doc_mask, q_tok, q_mask, B, Lq, N, L,
                           grid_docs, scratch, out, s);
    case 128:
      return launch<T, 128>(doc_tok, doc_mask, q_tok, q_mask, B, Lq, N, L,
                            grid_docs, scratch, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// doc_tok [N, L, dt] and q_tok [B, Lq, dt] of one dtype (lrt::DType),
// doc_mask [N, L] / q_mask [B, Lq] bool (1 byte), all contiguous;
// dt in {32, 64, 128}; scratch float32 [N, B * Lq]; out float32 [B, N].
// grid_docs blocks walk the doc axis. Returns cudaGetLastError().
int maxsim(const void* doc_tok, const void* doc_mask, const void* q_tok,
           const void* q_mask, int dtype, int B, int Lq, int N, int L, int dt,
           int grid_docs, void* scratch, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lrt::kBF16)
    return dispatch_dt<__nv_bfloat16>(dt, doc_tok, doc_mask, q_tok, q_mask, B,
                                      Lq, N, L, grid_docs, scratch, out, s);
  if (dtype == lrt::kF32)
    return dispatch_dt<float>(dt, doc_tok, doc_mask, q_tok, q_mask, B, Lq, N,
                              L, grid_docs, scratch, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
