// Fused dense score + select + merge: the dense channel's masked top-k in
// one launch.
//
// Replaces the Pallas kernel legalrag_tpu/ops/topk.py:_score_select_kernel
// (entry dense_topk_pallas, pl.pallas_call at :328) and the lax.top_k merge
// of its tile lists after it. For queries q [B, d] float32 and a store
// emb [N, d] (bf16 or float32) it computes
//   score[b, r] = sum_c float(cast(q[b, c])) * float(emb[r, c])  (f32 sums)
// with cast() the rounding of the query to the store dtype (nearest even,
// as torch's .to(bfloat16)) and rows r >= valid_n scored -1e30, and writes
// the top k of each query's masked row: scores [B, k] float32 and rows
// [B, k] int64, in lax.top_k's order (score desc in float total order, so
// -0.0 below +0.0; ties to the lower row; rows >= N never appear).
//
// What bounds it on an H100: at the main path's zh shapes (B 64, N 2048
// rows of which 1260 valid, d 768, bf16, k 64) it must read 1.94 MB of
// valid rows and 0.2 MB of queries: 0.65 us at 3.35 TB/s, against 0.16 us
// of bf16 tensor-core time. A launch takes several microseconds, so no
// single launch comes near that bound; what the design can do is keep the
// whole function in one launch, keep every step short, and spread the
// work over the card.
//
// Design (TILE 128, QB 16, 256 threads; grid [ceil(N / TILE),
// ceil(B / QB)], at zh [16, 4] = 64 blocks; 80 registers a thread and,
// bf16 at d 768, 143,616 bytes of dynamic shared memory a block).
// - One block per (tile of TILE rows, chunk of QB queries). The [QB, TILE]
//   score tile stays in shared memory: nothing of the [B, N] map reaches
//   device memory. Rows at or past valid_n are masked, never read.
// - bf16 store: the scores on the tensor cores, mma.sync m16n8k16 (bf16
//   operands, f32 sums). The block's queries, rounded to bf16 as it stages
//   them (so the query's cast is no launch of its own), are A; the store's
//   rows, streamed in 64-column chunks through a ring of cp.async buffers
//   (80 KB in flight), are B as they lie in memory; ldmatrix feeds both.
//   Each row is read from device memory once; the other query chunks'
//   blocks find it in L2. float32 store (off the main path): CUDA-core FMA
//   in float32 (TF32 would not keep float32's results).
// - Every candidate is one 64-bit key, the score's float32 bits in total
//   order above the reversed row (the keys of ops/topk.py:stable_topk), so
//   the larger key is the better candidate and no two keys tie. Rows >= N
//   get key 0, below every real key.
// - Tile select: each warp bitonic-sorts its two queries' TILE keys at once
//   (TILE / 32 keys a lane, __shfl_xor_sync across lanes) and writes the
//   first kp = min(k, TILE) to scratch lists [tiles, B, kp].
// - Merge in the same launch, without a second pass. k <= TILE: a binary
//   tree over each chunk's tiles, in the blocks themselves. A block that
//   finishes a list draws the ticket of its parent (one acquire-release
//   atomic); the second of two siblings merges them (elementwise max of
//   one list and the other reversed, then a bitonic merge: the top kp of
//   both) and goes up, the first leaves. log2(tiles) merges lie on the
//   critical path instead of tiles - 1, and they run on many SMs. Lists
//   are read with ld.global.cg (past L1, which is not coherent across
//   SMs). k > TILE (off the main path; kp = TILE, every list holds its
//   whole tile): the chunk's last block merges by list heads, one lane per
//   tile, k rounds of a warp max.
// - The tickets are zeroed by a memset on the launch's stream in the C
//   entry, so two streams never share a counter.

#include <math.h>
#include <type_traits>

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int TILE = 128;            // corpus rows per block
constexpr int QB = 16;               // queries per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int PER_LANE = TILE / 32;  // keys each lane holds in the select
constexpr int QPW = QB / WARPS;      // queries per warp in select and merge
constexpr float NEG_INF = -1e30f;    // the JAX package's NEG_INF
constexpr int MAX_D = 2048;          // the wrappers' limit on d

__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 kmin(u64 a, u64 b) { return a < b ? a : b; }

// Float bits made two's-complement (b ^ ((b >> 31) & 0x7FFFFFFF)) and
// offset to unsigned, above 0xFFFFFFFF - row.
__device__ __forceinline__ u64 make_key(float s, int row) {
  const unsigned b = __float_as_uint(s);
  const unsigned ord = b ^ ((unsigned)((int)b >> 31) & 0x7FFFFFFFu);
  return ((u64)(ord ^ 0x80000000u) << 32) | (0xFFFFFFFFu - (unsigned)row);
}

__device__ __forceinline__ float key_score(u64 key) {
  const unsigned ord = (unsigned)(key >> 32) ^ 0x80000000u;
  return __uint_as_float(ord ^ ((unsigned)((int)ord >> 31) & 0x7FFFFFFFu));
}

__device__ __forceinline__ long long key_row(u64 key) {
  return (long long)(0xFFFFFFFFu - (unsigned)key);
}

// A load that reads L2, never a stale L1 line: another SM wrote the lists.
__device__ __forceinline__ u64 load_cg(const u64* p) {
  u64 v;
  asm volatile("ld.global.cg.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// ------------------------------------------------------------------ scores

// bf16 store: the row-major query tile [QB][DP] is mma's A, and the store's
// rows [TILE][KC] staged by cp.async are exactly its column-major B.
constexpr int KC = 64;          // store columns per stage
constexpr int STAGES = 6;       // stages in flight: 5 x 16 KB per block
constexpr int BST = KC + 8;     // padded row of a stage (144 bytes)

__host__ __device__ constexpr int padded_d(int d) {  // query row in smem
  return (d + KC - 1) / KC * KC + 8;
}

// Dynamic shared memory: the score tile sc [QB][TILE] float32, then the
// queries (bf16: [QB][padded_d] rounded; float32: [QB][d]), then for bf16
// the stages [STAGES][TILE][BST].
template <typename T>
constexpr size_t smem_bytes(int d) {
  return std::is_same<T, float>::value
             ? (size_t)QB * TILE * 4 + (size_t)QB * d * 4
             : (size_t)QB * TILE * 4 + (size_t)QB * padded_d(d) * 2 +
                   (size_t)STAGES * TILE * BST * 2;
}

// sc[i][r] = score of query q0 + i with row row0 + r, for the rows in
// [row0, rows) (rows = min(valid_n, N)); the others are left as they are
// and masked by the select. float32 store: CUDA cores, the queries widened
// in shared memory, warp w on rows w, w + 8, ..., its lanes on runs of 8
// columns.
__device__ __forceinline__ void block_scores(const float* __restrict__ q,
                                             const float* __restrict__ emb,
                                             int B, int d, int rows, int q0,
                                             int row0, unsigned char* qmem,
                                             float* sc) {
  float* qs = reinterpret_cast<float*>(qmem);  // [QB][d]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x * 4; e < QB * d; e += THREADS * 4) {
    const int qi = e / d;  // d % 8 == 0: a run of 4 stays in one query
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + qi < B)
      v = *reinterpret_cast<const float4*>(q + (size_t)(q0 + qi) * d + (e - qi * d));
    *reinterpret_cast<float4*>(qs + e) = v;
  }
  __syncthreads();

  for (int r = warp; r < TILE && row0 + r < rows; r += WARPS) {
    const float* er = emb + (size_t)(row0 + r) * d;
    float acc[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) acc[i] = 0.f;
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
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < QB; ++i) sc[i * TILE + r] = acc[i];
    }
  }
  __syncthreads();
}

// bf16 store: the same scores on the tensor cores (mma.sync m16n8k16). The
// block's queries are rounded to bf16 (nearest even) into shared memory
// once; the store's rows come in KC-column chunks through a ring of STAGES
// cp.async buffers (rows past `rows` and columns past d are zero-filled,
// never read). Warp w owns tile rows [16 w, 16 w + 16): two n8 products
// per k16 step, both fed by one ldmatrix.x4 of A and one of B.
__device__ __forceinline__ void block_scores(const float* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ emb,
                                             int B, int d, int rows, int q0,
                                             int row0, unsigned char* qmem,
                                             float* sc) {
  static_assert(QB == 16 && TILE == 16 * WARPS, "one m16 tile, 16 rows a warp");
  typedef __nv_bfloat16 bf16;
  const int dp = padded_d(d);
  const int dk = dp - 8;                       // columns staged, zeros past d
  const int chunks = dk / KC;
  bf16* qs = reinterpret_cast<bf16*>(qmem);   // [QB][dp]
  bf16* stage = qs + QB * dp;                  // [STAGES][TILE][BST]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  auto load_chunk = [&](int c) {
    bf16* dst = stage + (c % STAGES) * TILE * BST;
#pragma unroll
    for (int j = 0; j < TILE * KC / 8 / THREADS; ++j) {
      const int p = threadIdx.x + j * THREADS;  // 16-byte piece
      const int r = p / (KC / 8), col = c * KC + p % (KC / 8) * 8;
      const bool ok = row0 + r < rows && col < d;
      lrt::cp_async16(dst + r * BST + p % (KC / 8) * 8,
                 ok ? emb + (size_t)(row0 + r) * d + col : emb, ok);
    }
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) load_chunk(c);
    lrt::cp_async_commit();
  }

  // queries: float32 -> bf16 (round to nearest even), QLOADS loads in
  // flight a thread
  constexpr int QLOADS = 8;
  for (int base = threadIdx.x; base < QB * dk / 4; base += QLOADS * THREADS) {
    float4 v[QLOADS];
#pragma unroll
    for (int u = 0; u < QLOADS; ++u) {
      const int e = (base + u * THREADS) * 4;
      const int qi = e / dk, c = e - qi * dk;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < QB * dk && q0 + qi < B && c < d)
        v[u] = *reinterpret_cast<const float4*>(q + (size_t)(q0 + qi) * d + c);
    }
#pragma unroll
    for (int u = 0; u < QLOADS; ++u) {
      const int e = (base + u * THREADS) * 4;
      if (e >= QB * dk) break;
      const int qi = e / dk, c = e - qi * dk;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x, v[u].y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z, v[u].w);
      *reinterpret_cast<uint2*>(qs + qi * dp + c) =
          make_uint2(reinterpret_cast<const unsigned&>(lo),
                     reinterpret_cast<const unsigned&>(hi));
    }
  }

  float acc[2][4] = {};
  for (int c = 0; c < chunks; ++c) {
    lrt::cp_async_wait<STAGES - 2>();   // chunk c has landed (this thread's part)
    __syncthreads();               // ... and everyone's; stage c - 1 is free
    if (c + STAGES - 1 < chunks) load_chunk(c + STAGES - 1);
    lrt::cp_async_commit();
    const bf16* bs = stage + (c % STAGES) * TILE * BST;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      unsigned a[4], b[4];
      lrt::ldmatrix_x4(a, qs + (lane & 15) * dp + c * KC + ks * 16 + (lane >> 4) * 8);
      lrt::ldmatrix_x4(b, bs + (warp * 16 + (lane >> 4) * 8 + (lane & 7)) * BST +
                         ks * 16 + ((lane >> 3) & 1) * 8);
      lrt::mma_bf16(acc[0], a, b[0], b[1]);
      lrt::mma_bf16(acc[1], a, b[2], b[3]);
    }
  }
  lrt::cp_async_wait<0>();

  // accumulator (i, j): query lane / 4 (+ 8 for i = 2, 3), row 2 (lane % 4) + j % 2
  const int g = lane >> 2;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int r = warp * 16 + t * 8 + (lane & 3) * 2;
    *reinterpret_cast<float2*>(sc + g * TILE + r) = make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(sc + (g + 8) * TILE + r) =
        make_float2(acc[t][2], acc[t][3]);
  }
  __syncthreads();
}

// ------------------------------------------------------------------ select

__device__ __forceinline__ void store_out(u64 key, size_t at, float* out_s,
                                          long long* out_i) {
  out_s[at] = key_score(key);
  out_i[at] = key_row(key);
}


// Bitonic sort, descending, of the warp's QPW rows of TILE keys each; key
// t of a lane is element lane * PER_LANE + t. The rows are independent, so
// their steps interleave.
__device__ __forceinline__ void sort_desc(u64 (&key)[QPW][PER_LANE], int lane) {
#pragma unroll
  for (int size = 2; size <= TILE; size <<= 1) {
#pragma unroll
    for (int s = size >> 1; s > 0; s >>= 1) {
#pragma unroll
      for (int j = 0; j < QPW; ++j) {
#pragma unroll
        for (int t = 0; t < PER_LANE; ++t) {
          const int i = lane * PER_LANE + t;
          const bool desc = (i & size) == 0;
          if (s < PER_LANE) {  // partner t ^ s in the same lane
            if (t & s) continue;
            const int u = t | s;
            const u64 hi = kmax(key[j][t], key[j][u]);
            const u64 lo = kmin(key[j][t], key[j][u]);
            key[j][t] = desc ? hi : lo;
            key[j][u] = desc ? lo : hi;
          } else {             // partner lane ^ (s / PER_LANE), same t
            const u64 other =
                __shfl_xor_sync(0xffffffffu, key[j][t], s / PER_LANE);
            key[j][t] = (((i & s) == 0) == desc) ? kmax(key[j][t], other)
                                                  : kmin(key[j][t], other);
          }
        }
      }
    }
  }
}

// The warp's queries q0 + warp + j * WARPS: keys from their score rows,
// sorted, the first kp stored to this tile's lists [B, kp] (or, when the
// tile is the only one, to the output).
__device__ __forceinline__ void tile_select(const float* sc, int q0, int B,
                                            int row0, int N, int valid_n,
                                            int kp, u64* list, bool final,
                                            float* out_s, long long* out_i,
                                            int warp, int lane) {
  u64 key[QPW][PER_LANE];
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const float4 v =
        reinterpret_cast<const float4*>(sc + (warp + j * WARPS) * TILE)[lane];
    const float s[PER_LANE] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int row = row0 + lane * PER_LANE + t;
      key[j][t] = row < N ? make_key(row < valid_n ? s[t] : NEG_INF, row) : 0ull;
    }
  }
  sort_desc(key, lane);
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int q = q0 + warp + j * WARPS;
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) {
      const int i = lane * PER_LANE + t;
      if (q >= B || i >= kp) continue;
      if (final)  // one tile (so k <= TILE and kp == k): the output
        store_out(key[j][t], (size_t)q * kp + i, out_s, out_i);
      else
        list[(size_t)q * kp + i] = key[j][t];
    }
  }
}

// ------------------------------------------------------------------- merge

// Sorts each of the QPW bitonic sequences of 32 * E keys descending; key t
// of a lane is element t * 32 + lane.
template <int E>
__device__ __forceinline__ void merge_desc(u64 (&m)[QPW][E], int lane) {
#pragma unroll
  for (int s = 16 * E; s >= 32; s >>= 1) {
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
#pragma unroll
      for (int t = 0; t < E; ++t) {
        const int st = s / 32;
        if (t & st) continue;
        const u64 hi = kmax(m[j][t], m[j][t | st]);
        const u64 lo = kmin(m[j][t], m[j][t | st]);
        m[j][t] = hi;
        m[j][t | st] = lo;
      }
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
#pragma unroll
      for (int t = 0; t < E; ++t) {
        const u64 other = __shfl_xor_sync(0xffffffffu, m[j][t], s);
        m[j][t] = (lane & s) ? kmin(m[j][t], other) : kmax(m[j][t], other);
      }
    }
  }
}

// The merge of two sibling lists for the warp's queries q0 + warp + j *
// WARPS (k <= TILE, so kp == k, and 32 * E >= kp): the elementwise max of
// the left list and the right list reversed is bitonic and holds the top
// kp of both; merge_desc sorts it. The result goes back to the left
// list's slot, or at the root to the output.
template <int E>
__device__ __forceinline__ void merge_pair(u64* left, const u64* right,
                                           bool root, int q0, int B, int kp,
                                           float* out_s, long long* out_i,
                                           int warp, int lane) {
  constexpr int KPP = 32 * E;
  u64 m[QPW][E], c[QPW][E];
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int q = q0 + warp + j * WARPS;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * 32 + lane, rev = KPP - 1 - i;
      m[j][e] = q < B && i < kp ? load_cg(left + (size_t)q * kp + i) : 0ull;
      c[j][e] = q < B && rev < kp ? load_cg(right + (size_t)q * kp + rev) : 0ull;
    }
  }
#pragma unroll
  for (int j = 0; j < QPW; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) m[j][e] = kmax(m[j][e], c[j][e]);
  merge_desc<E>(m, lane);
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int q = q0 + warp + j * WARPS;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = e * 32 + lane;
      if (q >= B || i >= kp) continue;
      if (root)
        store_out(m[j][e], (size_t)q * kp + i, out_s, out_i);
      else
        left[(size_t)q * kp + i] = m[j][e];
    }
  }
}

// True in the block that is the last of `arrivals` blocks to reach this
// ticket. One thread draws it with an acquire-release atomic after the
// block's barrier, so the lists each block wrote before drawing are
// visible to the last one after its barrier (the release/acquire pattern
// of CUTLASS's semaphores).
__device__ __forceinline__ bool last_to_arrive(int* ticket, int arrivals) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int old;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(old) : "l"(ticket) : "memory");
    last = old == arrivals - 1;
  }
  __syncthreads();
  return last;
}

// k <= TILE: a binary tree over the chunk's tile lists, in the blocks
// themselves. Node n of a level covers the tiles [n * width, (n + 1) *
// width) and keeps its list in the slot of its first tile. The second
// block to finish one of two siblings merges them and goes up; the first
// leaves. A node without a sibling goes up as it is. The root's merge
// writes the output. tk: the chunk's tickets, one per node above level 0.
template <int E>
__device__ void tree_merge(u64* lists, int* tk, int tile, int tiles, int q0,
                           int B, int kp, float* out_s, long long* out_i,
                           int warp, int lane) {
  const size_t slot = (size_t)B * kp;  // from one tile's lists to the next
  int node = tile, count = tiles;
  for (int width = 1; count > 1; width <<= 1) {
    const int parent = node >> 1, pcount = (count + 1) >> 1;
    if ((node | 1) < count) {
      if (!last_to_arrive(tk + parent, 2)) return;
      merge_pair<E>(lists + parent * 2 * width * slot,
                    lists + (parent * 2 + 1) * width * slot, pcount == 1, q0,
                    B, kp, out_s, out_i, warp, lane);
    }
    tk += pcount;
    node = parent;
    count = pcount;
  }
}

// k > TILE (kp == TILE): merge by list heads. Lane l owns tiles l, l + 32,
// ...; pos (this query's [tiles] read positions) is touched only by the
// owning lane.
__device__ void merge_heads(const u64* __restrict__ lists,
                            unsigned* __restrict__ pos, int q, int B,
                            int tiles, int kp, int k, float* out_s,
                            long long* out_i, int lane) {
  const size_t stride = (size_t)B * kp;
  const u64* L = lists + (size_t)q * kp;
  unsigned* P = pos + (size_t)q * tiles;
  u64 best = 0;
  int bt = 0;
  for (int t = lane; t < tiles; t += 32) {
    P[t] = 0;
    const u64 h = load_cg(L + t * stride);
    if (h > best) { best = h; bt = t; }
  }
  for (int r = 0; r < k; ++r) {
    u64 m = best;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = kmax(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (m != 0 && best == m) {  // keys are distinct: one lane wins
      store_out(m, (size_t)q * k + r, out_s, out_i);
      P[bt] += 1;
      best = 0;
      for (int t = lane; t < tiles; t += 32) {
        const unsigned p = P[t];
        const u64 h = p < (unsigned)kp ? load_cg(L + t * stride + p) : 0ull;
        if (h > best) { best = h; bt = t; }
      }
    }
  }
}

// ------------------------------------------------------------------ kernel

template <typename T>
__global__ void __launch_bounds__(THREADS)
score_select_kernel(const float* __restrict__ q, const T* __restrict__ emb,
                    int B, int N, int d, int valid_n, int k,
                    u64* __restrict__ lists, int* __restrict__ tickets,
                    unsigned* __restrict__ pos, float* __restrict__ out_s,
                    long long* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);  // [QB][TILE]
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int q0 = blockIdx.y * QB;
  const int row0 = tile * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kp = min(k, TILE);
  const int rows = min(valid_n, N);  // rows past it are masked: not scored

  if (row0 < rows)
    block_scores(q, emb, B, d, rows, q0, row0, smem + QB * TILE * sizeof(float),
                 sc);

  tile_select(sc, q0, B, row0, N, valid_n, kp, lists + (size_t)tile * B * kp,
              tiles == 1, out_s, out_i, warp, lane);

  int* tk = tickets + (size_t)blockIdx.y * 2 * tiles;  // this chunk's
  if (k <= 32) {
    tree_merge<1>(lists, tk, tile, tiles, q0, B, kp, out_s, out_i, warp, lane);
  } else if (k <= 64) {
    tree_merge<2>(lists, tk, tile, tiles, q0, B, kp, out_s, out_i, warp, lane);
  } else if (k <= TILE) {
    tree_merge<4>(lists, tk, tile, tiles, q0, B, kp, out_s, out_i, warp, lane);
  } else if (last_to_arrive(tk, tiles)) {  // the chunk's last block
    for (int j = 0; j < QPW; ++j) {
      const int qq = q0 + warp + j * WARPS;
      if (qq < B) merge_heads(lists, pos, qq, B, tiles, kp, k, out_s, out_i, lane);
    }
  }
}

// Scratch: lists [tiles, B, kp] u64, then tickets [chunks, 2 * tiles] int32
// (zeroed before each launch), then (k > TILE only) read positions
// [B, tiles] u32.
struct Layout {
  int tiles, chunks, kp;
  size_t lists_bytes, tickets_bytes, pos_bytes;
  Layout(int B, int N, int k)
      : tiles((N + TILE - 1) / TILE), chunks((B + QB - 1) / QB),
        kp(k < TILE ? k : TILE),
        lists_bytes((size_t)tiles * B * kp * sizeof(u64)),
        tickets_bytes((size_t)chunks * 2 * tiles * sizeof(int)),
        pos_bytes(k > TILE ? (size_t)B * tiles * sizeof(unsigned) : 0) {}
};

template <typename T>
int launch(const void* q, const void* emb, int B, int N, int d, int valid_n,
           int k, void* scratch, void* out_s, void* out_i,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      score_select_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T>(MAX_D));
  if (attr != cudaSuccess) return (int)attr;
  const Layout lay(B, N, k);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int* tickets = reinterpret_cast<int*>(base + lay.lists_bytes);
  cudaError_t err = cudaMemsetAsync(tickets, 0, lay.tickets_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  score_select_kernel<T><<<dim3(lay.tiles, lay.chunks), THREADS,
                           smem_bytes<T>(d), stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(emb), B, N, d,
      valid_n, k, reinterpret_cast<u64*>(base), tickets,
      reinterpret_cast<unsigned*>(base + lay.lists_bytes + lay.tickets_bytes),
      static_cast<float*>(out_s), static_cast<long long*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per tile and queries per block (the grid is [tiles, chunks]).
int score_select_tile() { return TILE; }
int score_select_queries() { return QB; }

// Bytes of scratch score_select needs for these sizes.
long long score_select_scratch_bytes(int B, int N, int k) {
  const Layout lay(B, N, k);
  return (long long)(lay.lists_bytes + lay.tickets_bytes + lay.pos_bytes);
}

// q [B, d] float32, emb [N, d] of dtype (lrt::DType), both row-major and
// 16-byte aligned, d % 8 == 0, d <= 2048; 1 <= k <= N; scratch of
// score_select_scratch_bytes(B, N, k). Writes out_s float32 and out_i int64
// [B, k]. Zeroes the tickets and launches on `stream`; returns the first
// CUDA error (0 if none).
int score_select(const void* q, const void* emb, int dtype, int B, int N,
                 int d, int valid_n, int k, void* scratch, void* out_s,
                 void* out_i, void* stream) {
  if (B < 1 || N < 1 || k < 1 || k > N || d % 8 || d > MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == lrt::kBF16)
    return launch<__nv_bfloat16>(q, emb, B, N, d, valid_n, k, scratch, out_s,
                                 out_i, s);
  if (dtype == lrt::kF32)
    return launch<float>(q, emb, B, N, d, valid_n, k, scratch, out_s, out_i, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
