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
// What bounds it on an H100: the products of valid tokens. At the zh main
// path's shapes (B 64, Lq 64, N 2048 of which 1,260 docs hold tokens, L 220,
// token_dim 128, bf16) the batch has 3,511 valid query tokens and 173,762
// valid doc tokens: 2 * 128 * 3511 * 173762 = 0.156 TFLOP, 0.158 ms at the
// 989 TFLOP/s bf16 tensor-core peak. Its bytes (the valid doc tokens once,
// 44.5 MB, 13 us at 3.35 TB/s) bound it far less.
//
// bf16, int8 and nbit4 stores: maxsim_tc_kernel<KIND, DT>, products on
// the tensor cores (mma.sync m16n8k16, bf16 or fp16 operands, float32 sums:
// exact products, so only the order of the sums differs from the
// reference); nbit4 first fills a table with maxsim_centroid_table_kernel.
// - A block has QW consumer warps and a producer warpgroup (which gives
//   most of its registers to the consumers with setmaxnreg). The consumer
//   warps take the batch's queries in order: short queries packed by their
//   valid tokens (below), a long query a warp. Each group of QW warps is
//   served by blocks/groups blocks, each walking a strided slice of the
//   docs, the group fastest in the block index, so the blocks that read
//   one doc run together and find it in L2 (the wrapper launches about one
//   block per SM).
// - A consumer warp keeps its query slots as mma's A in registers, RG
//   slots (RG / 16 m16 tiles, token_dim / 16 k-steps each), loaded once. A
//   query is short when Lq <= 64 and it has at most RG valid tokens: its
//   slots are its valid tokens, compacted, and a warp packs whole short
//   queries up to RG slots. bf16 pads each query to a tile, so a batch of
//   one-token queries costs it a tile a query; int8 and nbit4 pack the
//   slots back to back (a row keeps its own query's scale), so up to 32
//   one-token queries share a warp, and fewer warps mean fewer query groups
//   and longer doc slices for the blocks. A tile that holds no valid slot
//   issues no products. A long query goes through in groups of RG slots as
//   they lie, reloaded for each doc.
// - The stage ring holds each doc's valid tokens as 16-bit rows (bf16;
//   fp16 for int8 and nbit4), compacted
//   in token order (3 stages, or 2 where 3 do not fit; rows padded to
//   dt + 8 against bank conflicts). Per stage, an mbarrier `full` counts
//   the doc in and one `empty` counts the consumers out, so no block
//   barrier ties the warps after the prologue. Rows stored [token][dt] are
//   mma's column-major B as they lie, so ldmatrix reads them without
//   .trans.
// - Two n8 token chunks a pass (nbit4: one, its registers holding the
//   centroid terms): columns past the doc's valid count are
//   masked to -inf, each thread folds its C fragment into running row
//   maxima, and a quad shuffle finishes the doc (max is order-free).
// - Each query's best matches are summed by one lane in token order (for
//   a long query, masked slots add +0.0, which changes nothing), so a run
//   gives the same bits every time. No scratch (bf16, int8).
//
// bf16 store, bf16 queries (the main path): RG = 64 (four tiles). One
// producer warp works: it ballots each doc's mask (its bytes loaded one doc
// ahead) and each valid token's lane issues one bulk copy (TMA) of its row
// into the stage; `full` counts the bytes (issued by the consumers, as
// 16-byte cp.async or as bulk copies, the copies held up the products).
//
// int8 store (round(v * 127) of unit vectors), float32 queries: the same
// kernel with the codes widened once a block. The four producer warps each
// read a quarter of every valid token's row with plain loads, widen the
// codes to fp16 (exact: |code| <= 127 needs 7 bits) and store them into
// the stage; `full` counts the four warps. The float32 queries are split
// as they are loaded: each query's x is scaled by the power of two 2^e that
// brings the largest |x| of its valid tokens into [2^14, 2^15) (exact;
// found before the docs: for a long query by a pass of the warp over its
// valid tokens, four tokens' loads in flight at a time; for packed queries
// a lane a slot, then a lane a query; fp16's
// exponent range is narrow, and without it the low part of a small element
// would go subnormal, or a large one overflow), then hi = fp16(x 2^e) and lo =
// fp16(x 2^e - hi), both rounded to nearest even: |x 2^e - hi - lo| <=
// 2^-22 |x 2^e| per element (fp16 keeps 11 significant bits). Every
// product is issued twice into one float32 accumulator, lo * code and then
// hi * code, each exact (11 + 8 bits), so the dot is 2^e (q . code) but
// for the split's residue and the order of the sums. RG = 32 (two tiles,
// two A parts: the same 128 A registers at token_dim 128 as bf16's 64
// slots). Each finished row maximum is scaled by 2^-e / 127 (e of the
// row's own query), the dequant of
// legalrag_tpu/ops/maxsim.py:80-81 (positive, so it commutes with the
// max). A query's best matches are summed in float64 and rounded once: a
// float32 sum in token order is itself up to ~2e-5 off the exact sum at
// the zh shapes (55 terms near 1), more than the split leaves.
//
// nbit4 store (a centroid id c and 4-bit codes n a token, decoded by
// legalrag_tpu/ops/maxsim.py:69-79 as centroids[c] + (n - 8) * step, step
// = scales / 7), float32 queries: the dot splits into a centroid term and
// a residual term,
//   q . d = T[q, c] + sum_k (q_k step_k) (n_k - 8),  T = q . centroids^T,
// and the residual term runs on the tensor cores as int8's does: the four
// producer warps widen each staged token's packed nibbles to the fp16
// values n - 8 (exact) and store its centroid id beside the stage; the
// queries' x = q * step (rounded once) are scaled and split into fp16 lo
// and hi as above, two exact products each. T [256, B * Lq] float32
// (centroid-major) is computed per call by maxsim_centroid_table_kernel
// (float32 FMAs on the CUDA cores, 2 * 256 * dt flops a valid query
// token, 4 MB at the zh shapes: it does not fit shared memory beside the
// stages, so the epilogue reads it through L2). Each thread gathers the
// centroid terms of its C-fragment elements ahead of a pass's products
// (a tile's 16 slots are consecutive query tokens where the masks are
// prefixes, so a warp's gather then touches 4 sectors, not 32), then adds T + 2^-e * acc,
// rounded once, before the row maximum. The loss against the reference:
// the split's residue (2^-22 of |x| * 8 an element), the rounding of x and
// of the sum, where JAX rounds each decoded value; and the order of the
// float32 sums.
//
// float32 store, float32 queries (TF32 would change the float32 results):
// two launches on the CUDA cores. maxsim_tokens_kernel writes best(b, i, n)
// for every valid query token into scratch [N, B * Lq]; a block owns up to
// THREADS valid query tokens (compacted in its prologue), each thread keeps
// its token in DT registers, and for each doc of its strided set the block
// stages the valid doc tokens in shared memory. maxsim_reduce_kernel sums
// each query's valid tokens in token order into out [B, N]. No path of the
// system takes it (the float32 token store is built only on request).
//
// What bounds the int8 and nbit4 routes: twice the products above on the
// tensor cores (0.316 ms at the zh shapes; nbit4 adds the table, 0.27
// GFLOP at 67 TFLOP/s on the CUDA cores, 4 us); their bytes are a quarter (int8) and an
// eighth (nbit4) of the bf16 rows' in device memory, widened in shared
// memory. The float32 route: the products on the CUDA cores (67 TFLOP/s
// float32 on an H100 SXM): 0.156 TFLOP, 2.3 ms.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int SMEM_OPTIN = 232448;  // sm_90's per-block opt-in shared memory

// ============================================================ tensor cores

constexpr int QW = 8;             // consumer warps a block
constexpr int QTHREADS = (QW + 4) * 32;  // and a producer warpgroup
// Registers a thread: the launch gives 65536 / QTHREADS (168); the
// producer warpgroup hands most of its own to the consumers.
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
static_assert(4 * 32 * PRODUCER_REGS + QW * 32 * CONSUMER_REGS <= 65536,
              "register file");
constexpr int MAX_RG = 64;        // query slots a warp holds at once, at most
constexpr int PACK_LQ = 64;       // queries this long or shorter may pack
constexpr int MAX_STAGES = 3;     // doc stages a block, where they fit
constexpr int MAXCH = 16;         // 32-token mask chunks a lane prefetches
constexpr int MAXQ = 32;          // short queries a consumer warp packs
constexpr unsigned FULL = 0xffffffffu;

// The tensor-core kernel's operands by store kind: the doc tokens, the
// queries, RG, the query slots a consumer warp holds (int8 holds each slot
// as two fp16 parts), and the type a query's best matches are summed in.
template <int KIND> struct TC;
template <> struct TC<lrt::kBF16> {
  typedef __nv_bfloat16 doc;
  typedef __nv_bfloat16 query;
  typedef float sum;
  static constexpr int RG = 64;
};
template <> struct TC<lrt::kI8> {
  typedef int8_t doc;
  typedef float query;
  typedef double sum;
  static constexpr int RG = 32;
};
template <> struct TC<lrt::kNbit4> {
  typedef uint8_t doc;  // the packed nibbles
  typedef float query;
  typedef double sum;
  static constexpr int RG = 32;
};

// The nbit4 store's other tensors, for the tensor-core kernel: codes_c
// [N, L] uint8, step = scales / 7 float32 [dt], and the centroid table
// float32 [256, B * Lq] (centroid-major) that maxsim_centroid_table_kernel
// writes before it; all NULL for the other kinds.
struct Nbit4Args {
  const uint8_t* codes;
  const float* step;
  const float* table;
};

constexpr int NCENT = 256;  // the nbit4 codebook's centroids

__host__ __device__ constexpr int stage_rows(int L) { return (L + 7) / 8 * 8; }

// Dynamic shared memory: the stages [stages][stage_rows(L)][dt + 8] of
// 16-bit values, then per consumer warp its sum buffer [MAX_RG] float32,
// then per stage its barriers full and empty (u64 each) and its doc's valid
// count (int), then the packing: the number of consumer warps the batch
// takes and, per consumer warp of the block, its first query and query
// count (int); nbit4 then per stage its doc's centroid ids
// [stage_rows(L)] uint8.
size_t tc_smem_bytes(int kind, int L, int dt, int stages) {
  return (size_t)stages * stage_rows(L) * (dt + 8) * 2 + (size_t)QW * MAX_RG * 4 +
         stages * (2 * 8 + 4) + (1 + 2 * QW) * 4 +
         (kind == lrt::kNbit4 ? (size_t)stages * stage_rows(L) : 0);
}

// The most stages (of MAX_STAGES, at least 2) that fit a block, or 0.
int tc_stages(int kind, int L, int dt) {
  for (int st = MAX_STAGES; st >= 2; --st)
    if (tc_smem_bytes(kind, L, dt, st) <= (size_t)SMEM_OPTIN) return st;
  return 0;
}

// Bit index of the k-th (from 0) set bit of m, which has more than k.
__device__ __forceinline__ int nth_bit(unsigned long long m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 32; w > 0; w >>= 1) {
    const int c = __popcll(m & ((1ull << w) - 1ull));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// mbarrier and bulk-copy (TMA) primitives, CTA scope.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(lrt::smem_addr(bar)), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(lrt::smem_addr(bar)) : "memory");
}

// The one arrival of the barrier's phase, announcing `bytes` to come.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(lrt::smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(lrt::smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both ends 16-byte aligned) global -> shared by
// the copy engine; their arrival completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(lrt::smem_addr(dst)), "l"(src), "r"(bytes),
         "r"(lrt::smem_addr(bar)) : "memory");
}

// c = a * b (no accumulator read): mma_bf16 with a zero C.
__device__ __forceinline__ void mma_bf16_first(float (&c)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c = a * b with fp16 operands and float32 sums, accumulating (mma_f16)
// or from a zero C (mma_f16_first).
__device__ __forceinline__ void mma_f16(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16_first(float (&c)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Two floats as an fp16 pair, each rounded to nearest even; lo in the low
// half (the lower k of an mma fragment register).
__device__ __forceinline__ unsigned f16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// An fp16 pair as two floats (low half first), exact.
__device__ __forceinline__ float2 f16x2_float2(unsigned p) {
  float2 r;
  asm("{\n .reg .f16 l, h;\n mov.b32 {l, h}, %2;\n"
      " cvt.f32.f16 %0, l;\n cvt.f32.f16 %1, h;\n}"
      : "=f"(r.x), "=f"(r.y) : "r"(p));
  return r;
}

// Eight int8 codes (byte k of the two words is code k, k + 4 in b) as
// eight fp16 values, exact.
__device__ __forceinline__ uint4 widen8(unsigned a, unsigned b) {
  auto pair = [](unsigned w, int k) {
    return f16x2((float)(int8_t)(w >> (8 * k)), (float)(int8_t)(w >> (8 * k + 8)));
  };
  return make_uint4(pair(a, 0), pair(a, 2), pair(b, 0), pair(b, 2));
}

// One of the four producer warps' quarter of an int8 row (DT / 4 codes)
// widened into the stage row (fp16).
template <int DT>
__device__ __forceinline__ void widen_quarter(const int8_t* src,
                                              uint16_t* dst) {
  if constexpr (DT / 4 == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    *reinterpret_cast<uint4*>(dst) = widen8(v.x, v.y);
  } else {
#pragma unroll
    for (int p = 0; p < DT / 64; ++p) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * p);
      *reinterpret_cast<uint4*>(dst + 16 * p) = widen8(v.x, v.y);
      *reinterpret_cast<uint4*>(dst + 16 * p + 8) = widen8(v.z, v.w);
    }
  }
}

// Four packed nibble bytes (byte k: dim 2k in the high nibble, 2k + 1 in
// the low one, each biased by +8) as eight fp16 values n - 8, exact: each
// half is built as the bits of 1024 + n (0x6400 | n), less 1032.
__device__ __forceinline__ uint4 widen_nibbles(unsigned v) {
  const unsigned hi = (v >> 4) & 0x0f0f0f0fu, lo = v & 0x0f0f0f0fu;
  const unsigned p01 = __byte_perm(hi, lo, 0x5140);  // hi0 lo0 hi1 lo1
  const unsigned p23 = __byte_perm(hi, lo, 0x7362);  // hi2 lo2 hi3 lo3
  auto pair = [](unsigned p, unsigned sel) {  // two bytes, each to a half
    unsigned r;
    asm("sub.f16x2 %0, %1, %2;"
        : "=r"(r) : "r"(__byte_perm(p, 0u, sel) | 0x64006400u), "r"(0x64086408u));
    return r;
  };
  return make_uint4(pair(p01, 0x4140), pair(p01, 0x4342), pair(p23, 0x4140),
                    pair(p23, 0x4342));
}

// One of the four producer warps' quarter of an nbit4 row (DT / 8 packed
// bytes, DT / 4 dims) widened into the stage row (fp16).
template <int DT>
__device__ __forceinline__ void widen_nibble_quarter(const uint8_t* src,
                                                     uint16_t* dst) {
  if constexpr (DT / 8 == 4) {
    *reinterpret_cast<uint4*>(dst) = widen_nibbles(*reinterpret_cast<const unsigned*>(src));
  } else {
#pragma unroll
    for (int p = 0; p < DT / 64; ++p) {
      const uint2 v = *reinterpret_cast<const uint2*>(src + 8 * p);
      *reinterpret_cast<uint4*>(dst + 16 * p) = widen_nibbles(v.x);
      *reinterpret_cast<uint4*>(dst + 16 * p + 8) = widen_nibbles(v.y);
    }
  }
}

// The centroid term of one C-fragment element: the table's entry for
// centroid c and query token `row` (S = B * Lq), read through L2 (the
// table is 4 MB at the zh shapes; a block's rows span 256 KB of it).
__device__ __forceinline__ float table_at(const float* __restrict__ table,
                                          unsigned c, int S, int row) {
  return __ldg(table + (size_t)c * S + row);
}

template <int KIND, int DT>
__global__ void __launch_bounds__(QTHREADS, 1)
maxsim_tc_kernel(const typename TC<KIND>::doc* __restrict__ doc_tok,
                 const uint8_t* __restrict__ doc_mask,
                 const typename TC<KIND>::query* __restrict__ q_tok,
                 const uint8_t* __restrict__ q_mask, int B, int Lq, int N,
                 int L, int nst, float* __restrict__ out, const Nbit4Args nb) {
  constexpr bool I8 = KIND == lrt::kI8;
  constexpr bool NB4 = KIND == lrt::kNbit4;
  constexpr bool SPLIT = KIND != lrt::kBF16;  // fp16 operands, split queries
  constexpr int TW = NB4 ? DT / 2 : DT;       // a doc token's elements
  constexpr int RG = TC<KIND>::RG;  // query slots a consumer warp holds
  constexpr int MT = RG / 16;       // m16 tiles in them
  constexpr int NP = SPLIT ? 2 : 1;  // A parts a slot (split: lo, then hi)
  constexpr int LD = DT + 8;        // stage row (16-bit), 16-byte multiple
  constexpr int KS = DT / 16;       // k16 steps
  constexpr int NU = NB4 ? 1 : 2;   // n8 token chunks a pass
  extern __shared__ __align__(16) unsigned char stage_smem[];
  const int rows = stage_rows(L);
  uint16_t* stages = reinterpret_cast<uint16_t*>(stage_smem);
  float* tail = reinterpret_cast<float*>(stages + (size_t)nst * rows * LD);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t* full = reinterpret_cast<uint64_t*>(tail + QW * MAX_RG);  // doc landed
  uint64_t* empty = full + nst;                                   // doc read
  int* nvs = reinterpret_cast<int*>(empty + nst);                // its valid tokens
  int* pack = nvs + nst;
  uint8_t* cids = reinterpret_cast<uint8_t*>(pack + 1 + 2 * QW);  // nbit4: centroid ids

  // Queries to consumer warps. A short query (Lq <= PACK_LQ, at most RG
  // valid tokens) is packed: a warp takes a run of whole short queries
  // whose valid tokens, compacted, fill at most RG slots (and at most MAXQ
  // queries). bf16 pads each query's slots to m16 tiles (at most MT), so a
  // batch of one-token queries costs it a tile a query; the split kinds
  // pack the slots back to back (a row's scale is its query's), so 32
  // one-token queries share a warp. A long query takes a warp of its
  // own (its query count recorded as -1). W warps in all make
  // ceil(W / QW) groups of QW; block x serves group x % groups and the doc
  // slice x / groups, of blocks / groups slices (at most N). Warp 0 walks
  // the batch twice, for W and then for the warps of this block's group.
  auto walk = [&](int lo) {  // records the warps [lo, lo + QW)
    int w = 0, used = 0, nq = 0, begin = 0;
    auto close = [&](int n) {
      if (lane == 0 && w >= lo && w < lo + QW) {
        pack[1 + 2 * (w - lo)] = begin;
        pack[2 + 2 * (w - lo)] = n;
      }
      ++w;
    };
    for (int c0 = 0; c0 < B; c0 += 32) {
      int tiles = -1;  // a long query; else its units: tiles (bf16), slots
      if (c0 + lane < B && Lq <= PACK_LQ) {
        const uint8_t* m = q_mask + (size_t)(c0 + lane) * Lq;
        int v = 0;
#pragma unroll 16
        for (int k = 0; k < Lq; ++k) v += m[k] != 0;
        if (v <= RG) tiles = SPLIT ? v : (v + 15) / 16;
      }
      for (int l = 0; l < 32 && c0 + l < B; ++l) {
        const int t = __shfl_sync(FULL, tiles, l);
        if (t < 0) {
          if (nq > 0) close(nq);
          begin = c0 + l;
          close(-1);
          used = nq = 0;
          begin = c0 + l + 1;
          continue;
        }
        if (nq > 0 && (used + t > (SPLIT ? RG : MT) || nq == MAXQ)) {
          close(nq);
          used = nq = 0;
          begin = c0 + l;
        }
        used += t;
        ++nq;
      }
    }
    if (nq > 0) close(nq);
    return w;
  };
  if (warp == 0) {
    if (lane < QW) pack[2 + 2 * lane] = 0;  // warps past W hold no query
    __syncwarp();
    const int nw = walk(B);  // lo = B: records nothing
    walk(blockIdx.x % ((nw + QW - 1) / QW) * QW);
    if (lane == 0) pack[0] = nw;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < nst; ++k) {
      mbar_init(&full[k], SPLIT ? 4 : 1);  // the producer warps that fill it
      mbar_init(&empty[k], QW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block barrier: the warps run decoupled after it

  const int ngroups = (pack[0] + QW - 1) / QW;
  const int dstep = min(N, (int)gridDim.x / ngroups);  // doc slices
  const int n0 = blockIdx.x / ngroups;                 // this block's slice
  if (n0 >= dstep) return;                             // the whole block
  const int count = (N - 1 - n0) / dstep + 1;          // docs of this block

  // Doc i uses stage i % nst; its (i / nst)-th use completes that
  // phase of the stage's barriers. A phase cannot run ahead of a warp
  // that still waits on the one before: full needs the producer, which
  // first waits for every consumer on empty, and empty needs the
  // consumers, which first wait on full.
  if (warp >= QW) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    const int pw = warp - QW;  // producer warp
    if (!SPLIT && pw > 0) return;
    // bf16: one warp; each valid token's lane issues one bulk copy of its
    // row, compacted in token order, into the stage, and lane 0 announces
    // the doc's bytes on full first. int8 and nbit4: four warps; each valid
    // token's lane widens quarter pw of its row into the stage (fp16; nbit4
    // also stores the token's centroid id from warp 0), and each warp
    // arrives on full when its stores are done. The mask of the next doc
    // (bytes of tokens c * 32 + lane) is loaded while this one's fly.
    const int chunks = (L + 31) / 32;
    unsigned mreg[MAXCH];
    auto fetch_mask = [&](int i) {
      const uint8_t* m = doc_mask + (size_t)(n0 + i * dstep) * L;
#pragma unroll
      for (int c = 0; c < MAXCH; ++c) {
        const int j = c * 32 + lane;
        mreg[c] = i < count && c < chunks && j < L ? m[j] : 0u;
      }
    };
    fetch_mask(0);
    for (int i = 0; i < count; ++i) {
      const int st = i % nst;
      if (i >= nst) mbar_wait(&empty[st], (unsigned)(i / nst - 1) & 1u);
      int nv = 0;
#pragma unroll
      for (int c = 0; c < MAXCH; ++c) nv += __popc(__ballot_sync(FULL, mreg[c] != 0));
      if (pw == 0 && lane == 0) {
        nvs[st] = nv;
        if constexpr (!SPLIT) mbar_arrive_expect(&full[st], (unsigned)nv * DT * 2);
      }
      __syncwarp();
      // bf16: the stage was last read by ldmatrix (the generic proxy); the
      // int8 and nbit4 stores are generic too, ordered by the wait on empty
      if constexpr (!SPLIT) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const size_t doc = (size_t)(n0 + i * dstep) * L;
      const typename TC<KIND>::doc* src = doc_tok + doc * TW;
      uint16_t* dst = stages + (size_t)st * rows * LD;
      int base = 0;
#pragma unroll
      for (int c = 0; c < MAXCH; ++c) {
        const unsigned bal = __ballot_sync(FULL, mreg[c] != 0);
        if (mreg[c]) {
          const int r = base + __popc(bal & ((1u << lane) - 1u));
          if constexpr (I8) {
            widen_quarter<DT>(src + (size_t)(c * 32 + lane) * DT + pw * (DT / 4),
                              dst + (size_t)r * LD + pw * (DT / 4));
          } else if constexpr (NB4) {
            widen_nibble_quarter<DT>(src + (size_t)(c * 32 + lane) * TW + pw * (DT / 8),
                                     dst + (size_t)r * LD + pw * (DT / 4));
            if (pw == 0) cids[st * rows + r] = nb.codes[doc + c * 32 + lane];
          } else
            bulk_copy(dst + (size_t)r * LD, src + (size_t)(c * 32 + lane) * DT,
                      DT * 2, &full[st]);
        }
        base += __popc(bal);
      }
      if constexpr (SPLIT) {
        __syncwarp();  // the warp's stores, then its one arrival (release)
        if (lane == 0) mbar_arrive(&full[st]);
      }
      fetch_mask(i + 1);
    }
    return;
  }

  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
  float* sbuf = tail + warp * MAX_RG;
  const int qb = pack[1 + 2 * warp], qc = pack[2 + 2 * warp];  // its queries
  const bool packed = qc >= 0;        // short queries, or one long one
  const int qn = packed ? qc : 1;
  const bool has_q = qn > 0;
  const int groups = packed ? 1 : (Lq + RG - 1) / RG;
  const int g = lane >> 2, tq = lane & 3;

  // packed: lane j < qn holds query qb + j's valid-token mask, their count
  // and the query's first unit t0 (bf16: tile; split: slot)
  unsigned long long qm64 = 0;
  int vq = 0, t0 = 0;
  if (packed) {
    if (lane < qn) {
      const uint8_t* m = q_mask + (size_t)(qb + lane) * Lq;
#pragma unroll 16
      for (int k = 0; k < Lq; ++k)
        qm64 |= (unsigned long long)(m[k] != 0) << k;
      vq = __popcll(qm64);
    }
    const int tiles = SPLIT ? vq : (vq + 15) / 16;
    t0 = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(FULL, t0, o);
      if (lane >= o) t0 += x;
    }
    t0 -= tiles;
  }

  // A fragments: a[p][t][ks] = (rows g, g + 8 of tile t) x (k 2 tq, 2 tq + 8
  // of step ks), part p. live: tiles that hold a valid slot; qbits: bit
  // 2 t + h when this lane's slot t * 16 + g + 8 h is valid.
  unsigned a[NP][MT][KS][4];
  unsigned live = 0, qbits = 0;
  // split: each query is scaled by the power of two 2^e that brings the
  // largest |x| of its valid tokens' elements into [2^14, 2^15) (x = q;
  // nbit4: q * step, rounded); qex: the exponent e of this lane's query
  // (packed: query qb + lane; long: qb); rex: byte 2 t + h holds the
  // float exponent field 127 - e of 2^-e, the factor that undoes the
  // scale of this lane's row h of tile t (the rows of one tile may belong
  // to different queries; a float a row, or two bf16 a register, spill in
  // the nbit4 instance at token_dim 128); nbit4: trow, the query token
  // (its table row) of this lane's row h of tile t
  static_assert(!SPLIT || MT <= 2, "rex holds four rows");
  int qex = 0;
  unsigned rex = 0;
  int trow[NB4 ? MT : 1][2];
  auto row_back = [&](int t, int h) {  // 2^-e of row h of tile t, exact
    const int sh = 8 * (2 * t + h);
    return __uint_as_float((sh <= 23 ? rex << (23 - sh) : rex >> (sh - 23))
                           & 0x7f800000u);
  };
  // split, packed: the lane whose query holds slot sl (its slots are
  // [t0, t0 + vq) of that lane), or -1
  auto slot_owner = [&](int sl) {
    int o = -1;
    for (int p = 0; p < qn; ++p) {
      const int so = __shfl_sync(FULL, t0, p), vo = __shfl_sync(FULL, vq, p);
      if (sl >= so && sl < so + vo) o = p;
    }
    return o;
  };
  if constexpr (SPLIT) {
    // warp-wide over query b's valid tokens; at most 126 (m zero or
    // subnormal), so that 2^e and 2^-e are normal floats
    // (lane: elements 4 lane .. 4 lane + 3 of a token, DT <= 128; four
    // tokens' loads in flight at a time)
    auto query_exponent = [&](int b) {
      const bool mine = 4 * lane < DT;
      float4 w = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (NB4) {
        if (mine) w = *reinterpret_cast<const float4*>(nb.step + 4 * lane);
      }
      float m = 0.f;
      for (int c0 = 0; c0 < Lq; c0 += 32) {
        unsigned bal = __ballot_sync(
            FULL, c0 + lane < Lq && q_mask[(size_t)b * Lq + c0 + lane]);
        while (bal) {
          float4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = bal ? __ffs(bal) - 1 : -1;
            bal &= bal - 1u;
            v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (j >= 0 && mine)
              v[u] = *reinterpret_cast<const float4*>(
                  q_tok + ((size_t)b * Lq + c0 + j) * DT + 4 * lane);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if constexpr (NB4)
              v[u] = make_float4(v[u].x * w.x, v[u].y * w.y, v[u].z * w.z,
                                 v[u].w * w.w);
            m = fmaxf(m, fmaxf(fmaxf(fabsf(v[u].x), fabsf(v[u].y)),
                               fmaxf(fabsf(v[u].z), fabsf(v[u].w))));
          }
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
      return min(126, 141 - (int)(__float_as_uint(m) >> 23));  // 14 - floor(log2 m)
    };
    // packed: lane s takes slot s (its query's (s - t0)-th valid token,
    // all its loads in flight), then lane j < qn the largest over its
    // query's slots [t0, t0 + vq)
    auto packed_exponent = [&]() {
      const int o = slot_owner(lane);
      const int src = max(o, 0);
      const unsigned long long m = __shfl_sync(FULL, qm64, src);
      const int k = lane - __shfl_sync(FULL, t0, src);
      float ms = 0.f;
      if (o >= 0) {
        const float* x = q_tok + ((size_t)(qb + o) * Lq + nth_bit(m, k)) * DT;
#pragma unroll 8
        for (int c = 0; c < DT; c += 4) {
          float4 v = *reinterpret_cast<const float4*>(x + c);
          if constexpr (NB4) {
            const float4 w = *reinterpret_cast<const float4*>(nb.step + c);
            v = make_float4(v.x * w.x, v.y * w.y, v.z * w.z, v.w * w.w);
          }
          ms = fmaxf(ms, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
        }
      }
      float mq = 0.f;
      for (int j = 0; j < RG; ++j) {
        const float v = __shfl_sync(FULL, ms, (t0 + j) & 31);
        if (j < vq) mq = fmaxf(mq, v);
      }
      return min(126, 141 - (int)(__float_as_uint(mq) >> 23));
    };
    static_assert(!SPLIT || RG == 32, "a lane a slot");
    qex = packed ? packed_exponent() : query_exponent(qb);
  }
  // this lane's row h of tile t from query token `row` (zeros when !ok);
  // split: the float32 token x (nbit4: q * step), scaled by 2^ex, split
  // into its fp16 parts lo (a[0]) and hi (a[1])
  auto load_row = [&](int t, int h, size_t row, bool ok, int ex) {
    if constexpr (SPLIT) {
      const float2* x2 = reinterpret_cast<const float2*>(q_tok + row * DT + 2 * tq);
      const float sc = __uint_as_float((unsigned)(127 + ex) << 23);
      if constexpr (NB4) trow[t][h] = (int)row;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // k 2 tq (+ 8 for e = 1)
          float2 x = ok ? x2[ks * 8 + 4 * e] : make_float2(0.f, 0.f);
          if constexpr (NB4) {
            const float2 w = *reinterpret_cast<const float2*>(
                nb.step + ks * 16 + 8 * e + 2 * tq);
            x = make_float2(x.x * w.x, x.y * w.y);
          }
          const float2 y = make_float2(x.x * sc, x.y * sc);
          const unsigned hi = f16x2(y.x, y.y);
          const float2 hf = f16x2_float2(hi);
          a[1][t][ks][2 * e + h] = hi;
          a[0][t][ks][2 * e + h] = f16x2(y.x - hf.x, y.y - hf.y);
        }
      }
      const int sh = 8 * (2 * t + h);  // 127 - ex in [1, 240]: a byte
      rex = (rex & ~(0xffu << sh)) | (unsigned)(127 - ex) << sh;
    } else {
      const unsigned* x2 = reinterpret_cast<const unsigned*>(q_tok + row * DT + 2 * tq);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        a[0][t][ks][h] = ok ? x2[ks * 8] : 0u;
        a[0][t][ks][2 + h] = ok ? x2[ks * 8 + 4] : 0u;
      }
    }
  };
  // packed, bf16: slot t0 * 16 + k of the warp is the k-th valid token of
  // its query (tiles of no query issue no products); split: slot t0 + k
  auto load_packed = [&]() {
    if constexpr (SPLIT) {
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const int own[2] = {slot_owner(t * 16 + g), slot_owner(t * 16 + g + 8)};
        if (__ballot_sync(FULL, own[0] >= 0 || own[1] >= 0)) live |= 1u << t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = own[h] >= 0;
          const int o = ok ? own[h] : 0;
          const unsigned long long m = __shfl_sync(FULL, qm64, o);
          const int k = t * 16 + g + 8 * h - __shfl_sync(FULL, t0, o);
          if (ok) qbits |= 1u << (2 * t + h);
          load_row(t, h, (size_t)(qb + o) * Lq + (ok ? nth_bit(m, k) : 0), ok,
                   __shfl_sync(FULL, qex, o));
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const unsigned own = __ballot_sync(
            FULL, lane < qn && t0 <= t && t < t0 + (vq + 15) / 16);
        if (!own) continue;
        live |= 1u << t;
        const int o = __ffs(own) - 1;
        const unsigned long long m = __shfl_sync(FULL, qm64, o);
        const int ov = __shfl_sync(FULL, vq, o), ot0 = __shfl_sync(FULL, t0, o);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = (t - ot0) * 16 + g + 8 * h;
          const bool ok = k < ov;
          if (ok) qbits |= 1u << (2 * t + h);
          load_row(t, h, (size_t)(qb + o) * Lq + (ok ? nth_bit(m, k) : 0), ok, 0);
        }
      }
    }
  };
  // a long query (one a warp): its slots [r * RG, r * RG + RG) as they lie;
  // slots past Lq are zero
  auto load_query = [&](int r) {
    live = 0;
    qbits = 0;
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int s0 = r * RG + t * 16;
      const int sl = s0 + (lane & 15);
      if (__ballot_sync(FULL, sl < Lq && q_mask[(size_t)qb * Lq + sl]))
        live |= 1u << t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = s0 + g + 8 * h;
        const bool ok = s < Lq;
        if (ok && q_mask[(size_t)qb * Lq + s]) qbits |= 1u << (2 * t + h);
        load_row(t, h, (size_t)qb * Lq + (ok ? s : 0), ok, qex);
      }
    }
  };

  if (packed) load_packed();

  for (int i = 0; i < count; ++i) {
    const int st = i % nst;
    mbar_wait(&full[st], (unsigned)(i / nst) & 1u);  // doc i has landed
    const int nv = nvs[st];
    const uint16_t* bs = stages + (size_t)st * rows * LD;
    const uint8_t* cs = cids + st * rows;  // nbit4: the doc's centroid ids
    typename TC<KIND>::sum total = 0;
    for (int r = 0; has_q && nv > 0 && r < groups; ++r) {
      if (!packed) load_query(r);
      float best[MT][2];
#pragma unroll
      for (int t = 0; t < MT; ++t) best[t][0] = best[t][1] = -INFINITY;

      // NU n8 token chunks a pass: two (bf16, int8), or one (nbit4, whose
      // centroid terms take the registers of the second)
      for (int j = 0; j < nv; j += 8 * NU) {  // token chunks j (and j + 8)
        const bool two = NU == 2 && j + 8 < nv;
        const uint16_t* p = bs + (j + (lane & 7)) * LD + (lane >> 3) * 8;
        float acc[NU][MT][4];
        unsigned b[2][NU][4];  // [buffer][chunk]: k-steps 2 kk and 2 kk + 1
        lrt::ldmatrix_x4(b[0][0], p);
        if constexpr (NU == 2) {
          if (two) lrt::ldmatrix_x4(b[0][1], p + 8 * LD);
        }
        // nbit4: the centroid terms of this thread's C-fragment elements,
        // (rows g, g + 8) x (tokens j + 2 tq, j + 2 tq + 1), gathered ahead
        // of the products (columns past nv read a stale id, masked below)
        float tv[NB4 ? MT : 1][4];
        if constexpr (NB4) {
          const unsigned ids = *reinterpret_cast<const uint16_t*>(cs + j + 2 * tq);
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            if (!(live >> t & 1u)) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tv[t][e] = table_at(nb.table, e & 1 ? ids >> 8 : ids & 0xffu,
                                  B * Lq, trow[t][e >> 1]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < KS / 2; ++kk) {
          const int cur = kk & 1;
          if (kk + 1 < KS / 2) {  // the next fragments, ahead of the products
            lrt::ldmatrix_x4(b[cur ^ 1][0], p + (kk + 1) * 32);
            if constexpr (NU == 2) {
              if (two) lrt::ldmatrix_x4(b[cur ^ 1][1], p + 8 * LD + (kk + 1) * 32);
            }
          }
          // the products are issued in order (asm volatile): keep each
          // accumulator's products of this pass apart (split: a k-step's lo
          // product, then its hi product)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int pt = 0; pt < NP; ++pt) {
#pragma unroll
              for (int u = 0; u < NU; ++u) {
                if (u == 1 && !two) continue;
#pragma unroll
                for (int t = 0; t < MT; ++t) {
                  if (!(live >> t & 1u)) continue;
                  if (kk == 0 && h == 0 && pt == 0) {
                    if constexpr (SPLIT)
                      mma_f16_first(acc[u][t], a[0][t][0], b[cur][u][0],
                                    b[cur][u][1]);
                    else
                      mma_bf16_first(acc[u][t], a[0][t][0], b[cur][u][0],
                                     b[cur][u][1]);
                  } else {
                    if constexpr (SPLIT)
                      mma_f16(acc[u][t], a[pt][t][2 * kk + h],
                              b[cur][u][2 * h], b[cur][u][2 * h + 1]);
                    else
                      lrt::mma_bf16(acc[u][t], a[pt][t][2 * kk + h],
                                    b[cur][u][2 * h], b[cur][u][2 * h + 1]);
                  }
                }
              }
            }
          }
        }
        // nbit4: the residual term scaled back (exact), plus the centroid
        // term, rounded once
        if constexpr (NB4) {
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            if (!(live >> t & 1u)) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[0][t][e] = __fmaf_rn(acc[0][t][e], row_back(t, e >> 1), tv[t][e]);
          }
        }
        // accumulator (t, e): slot t * 16 + g (+ 8 for e >= 2), token
        // j + 8 u + 2 tq + e % 2; only the last pass has columns to mask
        if (j + 8 * NU <= nv) {
#pragma unroll
          for (int u = 0; u < NU; ++u) {
#pragma unroll
            for (int t = 0; t < MT; ++t) {
              if (!(live >> t & 1u)) continue;
              best[t][0] = fmaxf(best[t][0], fmaxf(acc[u][t][0], acc[u][t][1]));
              best[t][1] = fmaxf(best[t][1], fmaxf(acc[u][t][2], acc[u][t][3]));
            }
          }
        } else {
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            if (u == 1 && !two) break;
            const int c0 = j + 8 * u + 2 * tq;
            const bool v0 = c0 < nv, v1 = c0 + 1 < nv;
#pragma unroll
            for (int t = 0; t < MT; ++t) {
              if (!(live >> t & 1u)) continue;
              best[t][0] = fmaxf(best[t][0], fmaxf(v0 ? acc[u][t][0] : -INFINITY,
                                                   v1 ? acc[u][t][1] : -INFINITY));
              best[t][1] = fmaxf(best[t][1], fmaxf(v0 ? acc[u][t][2] : -INFINITY,
                                                   v1 ? acc[u][t][3] : -INFINITY));
            }
          }
        }
      }

#pragma unroll
      for (int t = 0; t < MT; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = best[t][h];
          m = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
          m = fmaxf(m, __shfl_xor_sync(FULL, m, 2));
          // int8: the row's scale back and the codes' 1 / 127, positive,
          // so they commute with the max
          if constexpr (I8) m *= row_back(t, h) * (1.0f / 127.0f);
          best[t][h] = m;
        }
      }
      __syncwarp();  // the summing lanes have read the last group's buffer
      if (tq == 0) {
#pragma unroll
        for (int t = 0; t < MT; ++t) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sbuf[t * 16 + g + 8 * h] = qbits >> (2 * t + h) & 1u ? best[t][h] : 0.f;
        }
      }
      __syncwarp();
      // lane j sums query qb + j's slots (packed: its valid tokens, then,
      // bf16, zeros to the next 4; long: all RG) in token order; a masked
      // slot holds 0 and adds +0.0, which changes nothing
      if (packed ? lane < qn : lane == 0) {
        if constexpr (SPLIT) {
          const float* s1 = sbuf + (packed ? t0 : 0);
          const int n1 = packed ? vq : RG;
          for (int s = 0; s < n1; ++s) total += s1[s];
        } else {
          const float4* s4 = reinterpret_cast<const float4*>(sbuf + t0 * 16);
          const int n4 = packed ? (vq + 3) / 4 : RG / 4;
#pragma unroll 4
          for (int s = 0; s < n4; ++s) {
            const float4 v = s4[s];
            total += v.x;
            total += v.y;
            total += v.z;
            total += v.w;
          }
        }
      }
    }
    __syncwarp();  // every lane is done with the stage
    if (packed ? lane < qn : lane == 0)  // an empty doc scores 0
      out[(size_t)(qb + (packed ? lane : 0)) * N + n0 + i * dstep] = total;
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

template <int KIND, int DT>
int launch_tc(const void* doc_tok, const void* doc_mask, const void* q_tok,
              const void* q_mask, int B, int Lq, int N, int L, int blocks,
              const Nbit4Args& nb, void* out, cudaStream_t stream) {
  const int nst = tc_stages(KIND, L, DT);
  const size_t smem = tc_smem_bytes(KIND, L, DT, nst);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_tc_kernel<KIND, DT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  maxsim_tc_kernel<KIND, DT><<<blocks, QTHREADS, smem, stream>>>(
      static_cast<const typename TC<KIND>::doc*>(doc_tok),
      static_cast<const uint8_t*>(doc_mask),
      static_cast<const typename TC<KIND>::query*>(q_tok),
      static_cast<const uint8_t*>(q_mask), B, Lq, N, L, nst,
      static_cast<float*>(out), nb);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_tc_kind(const void* doc_tok, const void* doc_mask,
                   const void* q_tok, const void* q_mask, int B, int Lq,
                   int N, int L, int dt, int blocks, const Nbit4Args& nb,
                   void* out, cudaStream_t s) {
  switch (dt) {
    case 32:
      return launch_tc<KIND, 32>(doc_tok, doc_mask, q_tok, q_mask, B, Lq, N,
                                 L, blocks, nb, out, s);
    case 64:
      return launch_tc<KIND, 64>(doc_tok, doc_mask, q_tok, q_mask, B, Lq, N,
                                 L, blocks, nb, out, s);
    default:
      return launch_tc<KIND, 128>(doc_tok, doc_mask, q_tok, q_mask, B, Lq, N,
                                  L, blocks, nb, out, s);
  }
}

// ============================================================ nbit4's table

constexpr int TT = 64;   // the table kernel's tile: query tokens and centroids
constexpr int TK = 32;   // and dims staged at a time

// table[c, s] = sum_k q_tok[s, k] * centroids[c, k] for every valid query
// token s of the batch (S = B * Lq; the rows of masked tokens, which the
// main kernel never keeps, may hold 0): float32 FMAs in k order. A block of
// 256 threads takes TT tokens x TT centroids, each thread one token and 16
// centroids; the tokens run along a warp, so the table's rows are written
// 128 bytes at a time, and a warp whose 32 tokens are all masked skips its
// products. The centroids are staged k-major, so a thread reads its 16
// centroids' values of one k as four 16-byte words (one broadcast a warp);
// their 4-float groups are XOR-swizzled by k & 7 against bank conflicts in
// the transposing stores.
__device__ __forceinline__ int table_col(int k, int c) {
  return (((c >> 2) ^ (k & 7)) << 2) | (c & 3);
}

template <int DT>
__global__ void __launch_bounds__(256)
maxsim_centroid_table_kernel(const float* __restrict__ q_tok,
                             const uint8_t* __restrict__ q_mask,
                             const float* __restrict__ centroids, int S,
                             float* __restrict__ table) {
  __shared__ float qs[TT][TK + 1];
  __shared__ __align__(16) float cs[TK][TT];
  const int tid = threadIdx.x, sl = tid % TT, cg = tid / TT;
  const int s0 = blockIdx.x * TT, c0 = blockIdx.y * TT;
  const bool busy = __any_sync(FULL, s0 + sl < S && q_mask[s0 + sl]);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < DT; k0 += TK) {
    for (int e = tid; e < TT * TK; e += 256) {
      const int r = e / TK, k = e % TK;
      qs[r][k] = s0 + r < S ? q_tok[(size_t)(s0 + r) * DT + k0 + k] : 0.f;
      cs[k][table_col(k, r)] = centroids[(size_t)(c0 + r) * DT + k0 + k];
    }
    __syncthreads();
    if (busy) {
#pragma unroll 8
      for (int k = 0; k < TK; ++k) {
        const float x = qs[sl][k];
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const float4 c = *reinterpret_cast<const float4*>(
              &cs[k][table_col(k, cg * 16 + 4 * i4)]);
          acc[4 * i4] = fmaf(x, c.x, acc[4 * i4]);
          acc[4 * i4 + 1] = fmaf(x, c.y, acc[4 * i4 + 1]);
          acc[4 * i4 + 2] = fmaf(x, c.z, acc[4 * i4 + 2]);
          acc[4 * i4 + 3] = fmaf(x, c.w, acc[4 * i4 + 3]);
        }
      }
    }
    __syncthreads();
  }
  if (s0 + sl < S) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      table[(size_t)(c0 + cg * 16 + i) * S + s0 + sl] = acc[i];
  }
}

template <int DT>
int launch_table(const float* q_tok, const uint8_t* q_mask,
                 const float* centroids, int S, float* table,
                 cudaStream_t stream) {
  const dim3 grid((S + TT - 1) / TT, NCENT / TT);
  maxsim_centroid_table_kernel<DT><<<grid, 256, 0, stream>>>(
      q_tok, q_mask, centroids, S, table);
  return (int)cudaGetLastError();
}

int launch_table_dt(int dt, const void* q_tok, const void* q_mask,
                    const void* centroids, int S, float* table,
                    cudaStream_t s) {
  const float* q = static_cast<const float*>(q_tok);
  const uint8_t* qm = static_cast<const uint8_t*>(q_mask);
  const float* c = static_cast<const float*>(centroids);
  switch (dt) {
    case 32:
      return launch_table<32>(q, qm, c, S, table, s);
    case 64:
      return launch_table<64>(q, qm, c, S, table, s);
    default:
      return launch_table<128>(q, qm, c, S, table, s);
  }
}

// =================================================================== float32

constexpr int THREADS = 256;
constexpr int F32_STATIC = 2048;  // the f32 kernel's static shared arrays, rounded up

size_t f32_smem_bytes(int L, int dt) {
  return (size_t)L * dt * sizeof(float) + (size_t)L * sizeof(int);
}

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

template <int DT>
__global__ void __launch_bounds__(THREADS, 1)
maxsim_tokens_kernel(const float* __restrict__ doc_tok,
                     const uint8_t* __restrict__ doc_mask,
                     const float* __restrict__ q_tok,
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
    for (int e = tid; e < nv * (DT / 4); e += THREADS) {
      const int t = e / (DT / 4), c = (e - t * (DT / 4)) * 4;
      *reinterpret_cast<float4*>(dtok + t * DT + c) =
          *reinterpret_cast<const float4*>(doc_tok + ((size_t)n * L + vidx[t]) * DT + c);
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

template <int DT>
int launch_f32(const void* doc_tok, const void* doc_mask, const void* q_tok,
               const void* q_mask, int B, int Lq, int N, int L, int grid_docs,
               void* scratch, void* out, cudaStream_t stream) {
  const int S = B * Lq;
  const size_t smem = f32_smem_bytes(L, DT);
  cudaError_t err = cudaFuncSetAttribute(
      maxsim_tokens_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(grid_docs, (S + THREADS - 1) / THREADS);
  maxsim_tokens_kernel<DT><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(doc_tok), static_cast<const uint8_t*>(doc_mask),
      static_cast<const float*>(q_tok), static_cast<const uint8_t*>(q_mask), S,
      N, L, static_cast<float*>(scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = B * N;
  maxsim_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(scratch), static_cast<const uint8_t*>(q_mask),
      B, Lq, N, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Consumer warps a block of the tensor-core kernel has; a launch needs at
// least ceil(B / this) blocks.
int maxsim_queries_per_block() { return QW; }

// Dynamic shared memory a launch of the main kernel needs for doc_maxlen L
// and token_dim dt, or -1 when the kernel does not take the shape (dt not in
// {32, 64, 128}, bf16, int8 or nbit4 L above 32 * MAXCH, or more than a
// block may have).
long long maxsim_smem_bytes(int dtype, int L, int dt) {
  if ((dt != 32 && dt != 64 && dt != 128) || L < 1) return -1;
  if (dtype == lrt::kBF16 || dtype == lrt::kI8 || dtype == lrt::kNbit4) {
    const int st = tc_stages(dtype, L, dt);
    return L <= 32 * MAXCH && st ? (long long)tc_smem_bytes(dtype, L, dt, st) : -1;
  }
  if (dtype == lrt::kF32) {
    const size_t s = f32_smem_bytes(L, dt);
    return s <= (size_t)(SMEM_OPTIN - F32_STATIC) ? (long long)s : -1;
  }
  return -1;
}

// doc_tok [N, L, dt] of dtype (lrt::DType; for kNbit4 the packed residuals
// [N, L, dt / 2] uint8, with codes [N, L] uint8, centroids float32
// [256, dt] and step = scales / 7 float32 [dt], NULL for the other
// dtypes), q_tok [B, Lq, dt] bf16 over a bf16 store and float32 over the
// others, doc_mask [N, L] / q_mask [B, Lq] bool (1 byte), all contiguous,
// the token tensors 16-byte aligned; maxsim_smem_bytes(dtype, L, dt) >= 0;
// out float32 [B, N]. bf16, int8 and nbit4: `grid` blocks of the
// tensor-core kernel, at least ceil(B / QW); nbit4 first launches the
// centroid table kernel into scratch float32 [256, B * Lq] (NULL for bf16
// and int8). float32: two launches, `grid` blocks on the doc axis,
// scratch float32 [N, B * Lq]. Returns cudaGetLastError().
int maxsim(const void* doc_tok, const void* doc_mask, const void* q_tok,
           const void* q_mask, const void* codes, const void* centroids,
           const void* step, int dtype, int B, int Lq, int N, int L, int dt,
           int grid, void* scratch, void* out, void* stream) {
  const bool nbit4 = dtype == lrt::kNbit4;
  if (B < 1 || Lq < 1 || N < 1 || grid < 1 ||
      (dtype != lrt::kF32 && grid < (B + QW - 1) / QW) ||
      ((dtype == lrt::kF32 || nbit4) && scratch == nullptr) ||
      (nbit4 && (codes == nullptr || centroids == nullptr || step == nullptr)) ||
      maxsim_smem_bytes(dtype, L, dt) < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lrt::kF32) {
    switch (dt) {
      case 32:
        return launch_f32<32>(doc_tok, doc_mask, q_tok, q_mask, B, Lq, N, L,
                              grid, scratch, out, s);
      case 64:
        return launch_f32<64>(doc_tok, doc_mask, q_tok, q_mask, B, Lq, N, L,
                              grid, scratch, out, s);
      default:
        return launch_f32<128>(doc_tok, doc_mask, q_tok, q_mask, B, Lq, N, L,
                               grid, scratch, out, s);
    }
  }
  if (dtype == lrt::kBF16)
    return launch_tc_kind<lrt::kBF16>(doc_tok, doc_mask, q_tok, q_mask, B,
                                      Lq, N, L, dt, grid, Nbit4Args{}, out, s);
  if (dtype == lrt::kI8)
    return launch_tc_kind<lrt::kI8>(doc_tok, doc_mask, q_tok, q_mask, B, Lq,
                                    N, L, dt, grid, Nbit4Args{}, out, s);
  float* table = static_cast<float*>(scratch);
  const int err = launch_table_dt(dt, q_tok, q_mask, centroids, B * Lq, table, s);
  if (err != 0) return err;
  const Nbit4Args nb{static_cast<const uint8_t*>(codes),
                     static_cast<const float*>(step), table};
  return launch_tc_kind<lrt::kNbit4>(doc_tok, doc_mask, q_tok, q_mask, B, Lq,
                                     N, L, dt, grid, nb, out, s);
}

}  // extern "C"
