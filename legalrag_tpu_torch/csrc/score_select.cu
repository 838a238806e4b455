// Fused dense score + tile-local top-kp select.
//
// Replaces the Pallas kernel legalrag_tpu/ops/topk.py:_score_select_kernel
// (entry dense_topk_pallas). It computes, for every tile of TILE corpus
// rows and every query:
//   score[b, r] = sum_c float(q[b, c]) * float(emb[r, c])   (float32 sums)
//   score[b, r] = -1e30 for rows r >= valid_n (never read)
// and writes the tile's top-kp (score desc, global row asc) to
// out_s/out_i [tiles, B, kp]. Unlike the Pallas kernel, which marks a taken
// row with -1e30 and so can pick it again once only masked rows are left,
// a taken row is never picked twice: the tile-local lists hold distinct
// rows, and the merge outside (a stable sort over [B, tiles * kp] in
// ops/topk.py) gives exactly lax.top_k of the full masked score map, which
// is what the JAX engine selects (ops/fused_query.py:135 + :56).
//
// What bounds it on an H100: at the main path's zh shapes (B=64, N=2048,
// d=768, bf16) it must read 3.15 MB of embeddings (about 0.94 us at
// 3.35 TB/s) for 0.2 GFLOP (0.2 us of bf16 tensor-core time): memory bound,
// and at this size launch latency dominates. The design reads each
// embedding row once per query chunk of QB queries, with 16-byte loads, and
// keeps the [QB, TILE] score tile in shared memory, so nothing of the
// [B, N] score map reaches device memory. Products run on the CUDA cores in
// float32; a wgmma version is later work.

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TILE = 128;            // corpus rows per block
constexpr int QB = 8;                // queries per block, one warp each in the select
constexpr int THREADS = 256;         // 8 warps
constexpr int PER_LANE = TILE / 32;  // candidates each lane holds in the select
constexpr float NEG_INF = -1e30f;    // the JAX package's NEG_INF

template <typename T>
__global__ void __launch_bounds__(THREADS)
score_select_kernel(const T* __restrict__ q, const T* __restrict__ emb, int B,
                    int N, int d, int valid_n, int kp,
                    float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qs = smem;            // [QB][d] this block's queries, widened
  float* sc = smem + QB * d;   // [QB][TILE] the score tile
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, B - q0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = tile * TILE;

  for (int e = threadIdx.x * 8; e < QB * d; e += THREADS * 8) {
    const int qi = e / d;  // d % 8 == 0: a run of 8 stays in one query
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (qi < nq) lrt::load8(q + (size_t)(q0 + qi) * d + (e - qi * d), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) qs[e + j] = f[j];
  }
  __syncthreads();

  // scores: warp w takes rows w, w + 8, ...; its lanes split d in runs of 8
  for (int r = warp; r < TILE; r += THREADS / 32) {
    const int row = row0 + r;
    float acc[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) acc[i] = 0.f;
    if (row < valid_n && row < N) {
      const T* er = emb + (size_t)row * d;
      for (int c = lane * 8; c < d; c += 32 * 8) {
        float e8[8];
        lrt::load8(er + c, e8);
#pragma unroll
        for (int i = 0; i < QB; ++i) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + i * d + c);
          const float4 qb = *reinterpret_cast<const float4*>(qs + i * d + c + 4);
          acc[i] = fmaf(qa.x, e8[0], acc[i]);
          acc[i] = fmaf(qa.y, e8[1], acc[i]);
          acc[i] = fmaf(qa.z, e8[2], acc[i]);
          acc[i] = fmaf(qa.w, e8[3], acc[i]);
          acc[i] = fmaf(qb.x, e8[4], acc[i]);
          acc[i] = fmaf(qb.y, e8[5], acc[i]);
          acc[i] = fmaf(qb.z, e8[6], acc[i]);
          acc[i] = fmaf(qb.w, e8[7], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < QB; ++i) acc[i] = lrt::warp_sum(acc[i]);
    }
    if (lane == 0) {
      // rows past N do not exist (-inf: never selected); rows in
      // [valid_n, N) are capacity padding, masked like the JAX kernel's
      const float fill = row < N ? NEG_INF : -INFINITY;
#pragma unroll
      for (int i = 0; i < QB; ++i)
        sc[i * TILE + r] = (row < valid_n && row < N) ? acc[i] : fill;
    }
  }
  __syncthreads();

  // select: warp w owns query q0 + w; lane holds rows lane + 32 t
  if (warp >= nq) return;
  float v[PER_LANE];
  unsigned taken = 0;
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) {
    const int r = lane + 32 * t;
    v[t] = sc[warp * TILE + r];
    if (row0 + r >= N) taken |= 1u << t;
  }
  const size_t out_base = ((size_t)tile * B + (q0 + warp)) * kp;
  for (int j = 0; j < kp; ++j) {
    float bv = -INFINITY;
    int br = INT_MAX;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int r = row0 + lane + 32 * t;
      if (!(taken >> t & 1u) && (v[t] > bv || (v[t] == bv && r < br))) {
        bv = v[t];
        br = r;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int orow = __shfl_xor_sync(0xffffffffu, br, o);
      if (ov > bv || (ov == bv && orow < br)) {
        bv = ov;
        br = orow;
      }
    }
    if (br != INT_MAX && ((br - row0) & 31) == lane) taken |= 1u << ((br - row0) >> 5);
    if (lane == 0) {
      out_s[out_base + j] = bv;
      out_i[out_base + j] = br == INT_MAX ? 0 : br;
    }
  }
}

template <typename T>
int launch(const void* q, const void* emb, int B, int N, int d, int valid_n,
           int kp, void* out_s, void* out_i, cudaStream_t stream) {
  const size_t smem = (size_t)(QB * d + QB * TILE) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(score_select_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  const dim3 grid((N + TILE - 1) / TILE, (B + QB - 1) / QB);
  score_select_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(emb), B, N, d, valid_n,
      kp, static_cast<float*>(out_s), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile, so the wrapper can size [tiles, B, kp].
int score_select_tile() { return TILE; }

// q [B, d] and emb [N, d] of one dtype (lrt::DType), row-major, d % 8 == 0,
// 16-byte aligned; 1 <= kp <= TILE. out_s float32 / out_i int32
// [ceil(N / TILE), B, kp]. Returns cudaGetLastError() after the launch.
int score_select(const void* q, const void* emb, int dtype, int B, int N,
                 int d, int valid_n, int kp, void* out_s, void* out_i,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lrt::kBF16)
    return launch<__nv_bfloat16>(q, emb, B, N, d, valid_n, kp, out_s, out_i, s);
  if (dtype == lrt::kF32)
    return launch<float>(q, emb, B, N, d, valid_n, kp, out_s, out_i, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
