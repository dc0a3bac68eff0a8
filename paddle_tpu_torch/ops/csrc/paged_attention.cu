// Ragged paged attention over a paged KV cache — kernels K1 and K2 of the
// port.
//
// K1 replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (launched by `_pallas_paged_attention`).  It computes
// the same function, not a block-by-block copy: for every sequence b,
// KV head h and query row r = (query token i, GQA group member g), row r
// attends to KV positions p < min(seq_lens[b], q_offsets[b] + i + 1,
// pages_max * page), read through block_tables[b, p / page]; softmax is
// online in f32 and the output is acc / max(l, 1e-30), so a row that
// sees nothing (a seq_len 0 slot) writes exact zeros.
//
// K2 replaces `_decode_kernel_q` of the same file: K1's function over
// int8 pages (FLAGS_kv_quant=int8) with per-page, per-head f32 scales
// [Hkv, num_pages].  It is the same kernels instantiated for int8
// storage: each K/V element widens to f32, multiplies by the scale of ITS
// page (looked up per position, since a tile spans several pages when the
// page is smaller than the tile) and rounds through the query dtype and
// back, so the dequantized operands are bit-identical to the plain
// version's; the math after the dequantize is K1's.
//
// Bound.  Decode and the mixed prefill+decode step at serving batch sizes
// are bound by memory: each live K/V byte must be read once, and the
// arithmetic (4 * D flops per visible (row, position) pair) is far below
// the card's rate.  Where the TPU kernel walks a sequential page axis,
// here the live KV of each (sequence, KV head, row tile) is cut into
// chunks of whole 64-position units (split-KV, as flash-decoding does):
// the grid is (split, row tile x KV head, sequence), the split count is
// chosen by the wrapper from host-known sizes only (pages_max * page,
// batch, KV heads, the SM count), and a chunk past its rows' horizon
// exits at once.  Each live chunk writes its partial (m, l, acc) to a
// workspace; the last block of a (sequence, head, row tile) to arrive —
// found by an atomic counter, which it resets — combines the partials in
// split order, so two launches give bitwise-equal outputs and one call
// is one launch.  A tile whose rows reach only one chunk writes its
// output directly.
//
// Two paths, chosen from q_len * group (host-known):
// * SIMT (q_len * group < 16: decode and GQA decode): 4 warps, all busy.
//   32-position tiles of K and V come in by cp.async, 16 bytes a copy,
//   through the block table, into a ring of three (the table's entries
//   for a tile are read a tile ahead of its copy).  For q.k, one group
//   of D / E lanes takes a position (E elements a lane, one 16-byte read
//   of f32/bf16, 8 bytes of int8); for p.v, each lane owns E output
//   columns and a subset of the positions, and the subsets are summed at
//   the end.  f32 math throughout.
// * Tensor cores (q_len * group >= 16: the mixed step, speculative
//   verify, GQA mixed): one block owns 64 query rows of one (sequence,
//   KV head), so a KV tile is read once per chunk, not once per 16 rows.
//   64-position tiles come in by cp.async into swizzled shared memory,
//   double-buffered.  bf16 runs q.k and p.v on mma.sync m16n8k16 from
//   ldmatrix, as the flash kernels K3/K4 do; f32 runs them on m16n8k8
//   TF32 with the 3xTF32 split (each f32 operand is a TF32 high part and
//   a TF32 remainder, and hi*hi + hi*lo + lo*hi accumulate in f32), which
//   keeps f32 accuracy at the tensor cores' rate.  int8 tiles are
//   dequantized in shared memory after they land, then run the same math.
// In both paths q is scaled by scale * log2(e) in f32 (bf16: the product
// is, as in K3), so the softmax runs in log2 units with exp2.
//
// Interface: plain C functions, built with nvcc for sm_90a and loaded
// with ctypes (paddle_tpu_torch/ops/_build.py).  Each launches on the
// given stream, allocates nothing (the wrapper hands in the workspace and
// the zeroed counters), returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

// Every symbol of the port's kernel sources lives in this namespace, so
// a profiler's kernel names tell the port's kernels from PyTorch's.
namespace paddle_tpu_torch {
namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;       // 4 warps, both paths
constexpr int kTcRows = 64;         // query rows of a tensor-core block
constexpr int kTcTile = 64;         // KV positions of a tensor-core tile
constexpr int kTcMinRows = 16;      // q_len * group from which it runs
constexpr int kSimtTile = 32;       // KV positions of a SIMT tile
constexpr int kSimtStages = 3;      // SIMT tiles in flight
constexpr int kChunkUnit = 64;      // a split's chunk is a multiple of this
constexpr int kMaxSplits = 16;      // chunks of one row tile at most
constexpr float kMaskValue = -1e30f;  // paddle_tpu's mask value
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;   // K2 only
  const float* v_scales;
  const int* block_tables;  // [B, pages_max]
  const int* seq_lens;      // [B]
  const int* q_offsets;     // [B]
  void* out;                // [B, Q, Hq, D], dense
  float* ws;                // partials, splits > 1 only
  int* counters;            // zeroed, one per (b, h, row tile)
  long long q_sb, q_si, q_sh;  // q's strides in elements
  int q_len, hq, hkv, group, num_pages, page, pages_max, splits, chunk;
  float sl2;  // scale * log2(e)
};

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// int8 -> f32 times the page's scale, rounded through the query dtype T
template <typename T>
__device__ __forceinline__ float dequant(int8_t c, float scale) {
  return to_f32(from_f32<T>(static_cast<float>(c) * scale));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The rows one thread copies of a tile of NP positions of K and V (rows
// of D elements of KV): their row indices in the pool, looked up through
// the block table (hp0 = h * num_pages) a tile ahead of the copy, so the
// table's latency hides under the previous tile's math; -1 at positions
// >= end, which copy as zeros.  K2: threads below 2 NP also hold the
// page-scale index of position threadIdx.x % NP (threads NP.. for V).
// SWZ: the 16-byte chunk index is XOR-ed with row % 8, so the rows an mma
// fragment reads fall in distinct banks (tensor-core tiles).
template <typename KV, int D, int NP, bool SWZ>
struct TileRows {
  static constexpr int kCpr = D * static_cast<int>(sizeof(KV)) / 16;
  static constexpr int kIt = NP * kCpr / kThreads;
  static_assert(NP * kCpr % kThreads == 0, "chunks per thread");
  static_assert(!SWZ || kCpr >= 8, "a swizzled row has 8 chunks or more");
  static_assert(2 * NP <= kThreads, "one scale a thread");
  int row[kIt];
  int scale;

  __device__ __forceinline__ void find(const int* bt, int hp0, int page,
                                       int t0, int end, bool scales) {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int p = t0 + (it * kThreads + threadIdx.x) / kCpr;
      row[it] = p < end ? (hp0 + bt[p / page]) * page + p % page : -1;
    }
    if (scales) {
      const int p = t0 + threadIdx.x % NP;
      scale = threadIdx.x < 2 * NP && p < end ? hp0 + bt[p / page] : -1;
    }
  }

  // the K and V rows into the tiles at shared addresses dk, dv
  __device__ __forceinline__ void copy(uint32_t dk, uint32_t dv,
                                       const KV* kp, const KV* vp) const {
#pragma unroll
    for (int it = 0; it < kIt; ++it) {
      const int i = it * kThreads + threadIdx.x;
      const int r = i / kCpr, c = i % kCpr;
      const bool ok = row[it] >= 0;
      const size_t o = ok ? static_cast<size_t>(row[it]) * D : 0;
      const uint32_t at = (r * kCpr + (SWZ ? (c ^ (r & 7)) : c)) * 16;
      cp_async16(dk + at, reinterpret_cast<const char*>(kp + o) + c * 16, ok);
      cp_async16(dv + at, reinterpret_cast<const char*>(vp + o) + c * 16, ok);
    }
  }

  // the K scales into dst[0, NP), the V scales into dst[NP, 2 NP)
  __device__ __forceinline__ void copy_scales(float* dst, const float* ks,
                                              const float* vs) const {
    if (threadIdx.x < 2 * NP) {
      const float* s = threadIdx.x < NP ? ks : vs;
      cp_async4(smem_u32(dst + threadIdx.x), scale >= 0 ? s + scale : s,
                scale >= 0);
    }
  }
};

// Where a block stands: its sequence, KV head, rows and chunk.
struct Block {
  int b, h, s, rows, r0, nr, sl, qo, horizon, n_live, c0, c1;
  int counter;  // index of its (b, h, row tile) counter
};

// The causal limit of query row `row`: it sees positions < the result
__device__ __forceinline__ int row_limit(const Params& p, const Block& k,
                                         int row) {
  if (row >= k.rows) return 0;
  return max(min(min(k.sl, k.qo + row / p.group + 1), k.horizon), 0);
}

// Grid (split, KV head x row tile, sequence) of row tiles of RT rows.
template <int RT>
__device__ __forceinline__ Block locate(const Params& p) {
  Block k;
  const int row_tiles = gridDim.y / p.hkv;
  k.b = blockIdx.z;
  k.h = blockIdx.y / row_tiles;
  k.s = blockIdx.x;
  k.rows = p.q_len * p.group;
  k.r0 = (blockIdx.y % row_tiles) * RT;
  k.nr = min(RT, k.rows - k.r0);
  k.sl = p.seq_lens[k.b];
  k.qo = p.q_offsets[k.b];
  k.horizon = p.pages_max * p.page;
  k.counter = k.b * gridDim.y + blockIdx.y;
  // the tile's last row sees furthest
  const int kv_end = row_limit(p, k, k.r0 + k.nr - 1);
  k.n_live = max(1, min(p.splits, (kv_end + p.chunk - 1) / p.chunk));
  k.c0 = k.s * p.chunk;
  k.c1 = min(k.c0 + p.chunk, kv_end);
  return k;
}

// One output row (row r of the block's tile) from f32 acc, scaled by inv
template <typename T, int D>
__device__ __forceinline__ void store_row4(const Params& p, const Block& k,
                                           int row, int c4, float4 a,
                                           float inv) {
  const int i = row / p.group, g = row % p.group;
  T* o = static_cast<T*>(p.out) +
         ((static_cast<size_t>(k.b) * p.q_len + i) * p.hq + k.h * p.group +
          g) * D + 4 * c4;
  const float x = a.x * inv, y = a.y * inv, z = a.z * inv, w = a.w * inv;
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(o) = make_float4(x, y, z, w);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x, y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(z, w);
    uint2 v;
    v.x = *reinterpret_cast<uint32_t*>(&lo);
    v.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(o) = v;
  }
}

// The end of every block of RT-row tiles: acc_s [nr][D], m_s, l_s [nr]
// hold the tile's rows over this block's chunk.  One live chunk: write
// the output.  Else write the partials to the workspace ([B][Hkv][splits][rows][D] acc,
// then [B][Hkv][splits][rows] (m, l)); the last block of the tile to
// arrive resets its counter and combines every row's partials, over the
// chunks that row reaches, in split order (w_s [nr][kMaxSplits] and n_s
// [nr] hold each row's weights and chunk count).
template <typename T, int D, int RT>
__device__ __forceinline__ void epilogue(const Params& p, const float* acc_s,
                                         const float* m_s, const float* l_s,
                                         float* w_s, int* n_s, int* flag_s) {
  constexpr int C4 = D / 4;
  // where the block stands, found again rather than kept live through the
  // loop (ptxas spilled it there)
  const Block k = locate<RT>(p);
  if (k.n_live == 1) {
    for (int i = threadIdx.x; i < k.nr * C4; i += kThreads) {
      const int r = i / C4, c4 = i % C4;
      store_row4<T, D>(p, k, k.r0 + r, c4,
                       reinterpret_cast<const float4*>(acc_s)[i],
                       1.f / fmaxf(l_s[r], 1e-30f));
    }
    return;
  }
  const size_t bh = static_cast<size_t>(k.b) * p.hkv + k.h;
  const size_t n_part = static_cast<size_t>(gridDim.z) * p.hkv * p.splits *
                        k.rows;
  float* ws_acc = p.ws + (bh * p.splits) * k.rows * D;
  float2* ws_ml = reinterpret_cast<float2*>(p.ws + n_part * D) +
                  bh * p.splits * k.rows;
  for (int i = threadIdx.x; i < k.nr * C4; i += kThreads) {
    const int r = i / C4, c4 = i % C4;
    reinterpret_cast<float4*>(ws_acc + (static_cast<size_t>(k.s) * k.rows +
                                        k.r0 + r) * D)[c4] =
        reinterpret_cast<const float4*>(acc_s)[i];
  }
  for (int r = threadIdx.x; r < k.nr; r += kThreads)
    ws_ml[static_cast<size_t>(k.s) * k.rows + k.r0 + r] =
        make_float2(m_s[r], l_s[r]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(p.counters + k.counter, 1) == k.n_live - 1;
    if (last) p.counters[k.counter] = 0;  // every live block has arrived
    *flag_s = last;
  }
  __syncthreads();
  if (!*flag_s) return;
  __threadfence();
  // each row's weights exp2(m_s - max m) / l over the chunks it reaches
  for (int r = threadIdx.x; r < k.nr; r += kThreads) {
    const int row = k.r0 + r;
    const int n = min(k.n_live, (row_limit(p, k, row) + p.chunk - 1) /
                                    p.chunk);
    const float2* ml = ws_ml + row;
    float mx = kMaskValue;
    for (int s = 0; s < n; ++s)
      mx = fmaxf(mx, __ldcg(ml + static_cast<size_t>(s) * k.rows).x);
    float l = 0.f;
    for (int s = 0; s < n; ++s) {
      const float2 v = __ldcg(ml + static_cast<size_t>(s) * k.rows);
      const float w = exp2f(v.x - mx);
      l += v.y * w;
      w_s[r * kMaxSplits + s] = w;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int s = 0; s < n; ++s) w_s[r * kMaxSplits + s] *= inv;
    n_s[r] = n;
  }
  __syncthreads();
  // the partials combined in split order
  for (int i = threadIdx.x; i < k.nr * C4; i += kThreads) {
    const int r = i / C4, c4 = i % C4;
    const int row = k.r0 + r, n = n_s[r];
    const float* w = w_s + r * kMaxSplits;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < n; ++s) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          ws_acc + (static_cast<size_t>(s) * k.rows + row) * D) + c4);
      a.x += x.x * w[s];
      a.y += x.y * w[s];
      a.z += x.z * w[s];
      a.w += x.w * w[s];
    }
    store_row4<T, D>(p, k, row, c4, a, 1.f);
  }
}

// ---------------------------------------------------------------------------
// SIMT path: up to RT query rows a block
// ---------------------------------------------------------------------------
// E elements of a staged K/V row as f32: 4 f32 or 8 bf16 (16 bytes), or 8
// int8 (8 bytes) dequantized by the position's page scale through T
template <typename T, typename KV>
struct Chunk;
template <typename T>
struct Chunk<T, float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void load(const float* src, float,
                                              float* o) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};
template <typename T>
struct Chunk<T, bf16> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const bf16* src, float,
                                              float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <typename T>
struct Chunk<T, int8_t> {
  static constexpr int E = 8;
  __device__ __forceinline__ static void load(const int8_t* src, float scale,
                                              float* o) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = dequant<T>(c[e], scale);
  }
};

// shared memory of the SIMT kernel: a region for the tile ring (later the
// per-group sums of acc), the ring's scales (K2), q, s/p, acc, m, l, alpha,
// limits and the combine flag
template <typename T, typename KV, int D, int RT>
struct SimtSmem {
  static constexpr int E = Chunk<T, KV>::E;
  static constexpr int NPG = kThreads / (D / E);  // position groups
  static constexpr int kStage = 2 * kSimtTile * D;  // KV elements
  static constexpr int kRing = kSimtStages * kStage * sizeof(KV);
  static constexpr int kRed = NPG * RT * D * 4;
  static constexpr int kRegion = kRing > kRed ? kRing : kRed;
  static constexpr int kScales = std::is_same<T, KV>::value
                                     ? 0 : kSimtStages * 2 * kSimtTile * 4;
  static constexpr int kQ = kRegion + kScales;
  static constexpr int kS = kQ + RT * D * 4;
  static constexpr int kAcc = kS + RT * kSimtTile * 4;
  static constexpr int kVec = kAcc + RT * D * 4;  // m, l, alpha, limit
  static constexpr int kW = kVec + 4 * ((4 * RT + 3) / 4 * 4);
  static constexpr int kN = kW + RT * kMaxSplits * 4;  // + RT ints
  static constexpr int kFlag = kN + (RT + 3) / 4 * 16;
  static constexpr int kBytes = kFlag + 16;
};

template <typename T, typename KV, int D, int RT>
__global__ void __launch_bounds__(kThreads) simt_kernel(const Params p) {
  using L = SimtSmem<T, KV, D, RT>;
  using Ld = Chunk<T, KV>;
  constexpr bool kQuant = !std::is_same<T, KV>::value;
  constexpr int E = L::E, C = D / E, NPG = L::NPG;
  constexpr int kOwn = (RT + 3) / 4;  // rows whose softmax a warp keeps
  static_assert(kSimtTile % NPG == 0 && C <= 32, "SIMT layout");
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  KV* ring = reinterpret_cast<KV*>(base);
  float* red = reinterpret_cast<float*>(base);  // after the loop
  float* sc_s = reinterpret_cast<float*>(base + L::kRegion);
  float* q_s = reinterpret_cast<float*>(base + L::kQ);
  float* s_s = reinterpret_cast<float*>(base + L::kS);
  float* acc_s = reinterpret_cast<float*>(base + L::kAcc);
  float* m_s = reinterpret_cast<float*>(base + L::kVec);
  float* l_s = m_s + RT;
  float* alpha_s = l_s + RT;
  int* lim_s = reinterpret_cast<int*>(alpha_s + RT);
  float* w_s = reinterpret_cast<float*>(base + L::kW);
  int* n_s = reinterpret_cast<int*>(base + L::kN);
  int* flag_s = reinterpret_cast<int*>(base + L::kFlag);

  const Block k = locate<RT>(p);
  if (k.s >= k.n_live) return;  // past every row's horizon
  const T* q = static_cast<const T*>(p.q);
  const KV* kp = static_cast<const KV*>(p.k_pages);
  const KV* vp = static_cast<const KV*>(p.v_pages);
  const int* bt = p.block_tables + static_cast<size_t>(k.b) * p.pages_max;
  const int hp0 = k.h * p.num_pages;
  const int n_tiles = (k.c1 - k.c0 + kSimtTile - 1) / kSimtTile;

  // the tile copies: rows looked up a tile ahead (`next`), copied into
  // stage j % kSimtStages of the ring
  TileRows<KV, D, kSimtTile, false> next;
#define SIMT_FIND(j)                                                       \
  next.find(bt, hp0, p.page, k.c0 + (j) * kSimtTile, k.c1, kQuant)
#define SIMT_COPY(j)                                                       \
  do {                                                                     \
    KV* st = ring + ((j) % kSimtStages) * L::kStage;                       \
    next.copy(smem_u32(st), smem_u32(st + kSimtTile * D), kp, vp);         \
    if constexpr (kQuant)                                                  \
      next.copy_scales(sc_s + ((j) % kSimtStages) * 2 * kSimtTile,         \
                       p.k_scales, p.v_scales);                            \
  } while (0)
#pragma unroll
  for (int j = 0; j < kSimtStages - 1; ++j) {
    if (j < n_tiles) {
      SIMT_FIND(j);
      SIMT_COPY(j);
    }
    cp_async_commit();
  }
  SIMT_FIND(kSimtStages - 1);

  for (int i = threadIdx.x; i < RT * D; i += kThreads) {
    const int r = i / D, d = i % D, row = k.r0 + r;
    float val = 0.f;
    if (r < k.nr)
      val = to_f32(q[k.b * p.q_sb + (row / p.group) * p.q_si +
                     (k.h * p.group + row % p.group) * p.q_sh + d]) * p.sl2;
    q_s[i] = val;
  }
  // each row's limit within this chunk
  if (threadIdx.x < RT)
    lim_s[threadIdx.x] = min(row_limit(p, k, k.r0 + threadIdx.x), k.c1);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = threadIdx.x / C, c = threadIdx.x % C;
  float m[kOwn], l[kOwn];
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    m[o] = kMaskValue;
    l[o] = 0.f;
  }
  float acc[RT][E];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + kSimtStages - 1 < n_tiles) SIMT_COPY(j + kSimtStages - 1);
    cp_async_commit();
    SIMT_FIND(j + kSimtStages);  // used next iteration
    cp_async_wait<kSimtStages - 1>();
    __syncthreads();  // tile j has landed for every thread
    const KV* k_t = ring + (j % kSimtStages) * L::kStage;
    const KV* v_t = k_t + kSimtTile * D;
    const float* ksc = sc_s + (j % kSimtStages) * 2 * kSimtTile;
    const float* vsc = ksc + kSimtTile;
    const int t0 = k.c0 + j * kSimtTile;

    // s = q.k: C lanes a position, NPG positions a pass
#pragma unroll
    for (int ps = 0; ps < kSimtTile / NPG; ++ps) {
      const int n = ps * NPG + grp;
      float kf[E];
      Ld::load(k_t + n * D + c * E, kQuant ? ksc[n] : 1.f, kf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r >= k.nr) break;  // uniform across the block
        const float* qr = q_s + r * D + c * E;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qr[e] * kf[e];
#pragma unroll
        for (int o = C / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if (c == 0) s_s[r * kSimtTile + n] = d;
      }
    }
    __syncthreads();

    // online softmax: warp w keeps rows w, w + 4; a lane a position
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      const int r = warp + 4 * o;
      if (r >= k.nr) continue;  // uniform across the warp
      const bool valid = t0 + lane < lim_s[r];
      const float x = valid ? s_s[r * kSimtTile + lane] : kMaskValue;
      const float mn = fmaxf(m[o], warp_max(x));
      const float pr = valid ? exp2f(x - mn) : 0.f;
      const float alpha = exp2f(m[o] - mn);
      l[o] = l[o] * alpha + warp_sum(pr);
      m[o] = mn;
      s_s[r * kSimtTile + lane] = pr;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc += p v: lane (grp, c) owns columns c*E.. over positions grp + NPG i
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r >= k.nr) break;
      const float a = alpha_s[r];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= a;
    }
#pragma unroll
    for (int ps = 0; ps < kSimtTile / NPG; ++ps) {
      const int n = ps * NPG + grp;
      float vf[E];
      Ld::load(v_t + n * D + c * E, kQuant ? vsc[n] : 1.f, vf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r >= k.nr) break;
        const float pr = s_s[r * kSimtTile + n];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] += pr * vf[e];
      }
    }
    __syncthreads();  // the tile is consumed before it is overwritten
  }
#undef SIMT_FIND
#undef SIMT_COPY
  cp_async_wait<0>();
  __syncthreads();

  // sum the position groups' acc, in group order
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(red + (grp * RT + r) * D + c * E + e) =
          make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int r = warp + 4 * o;
    if (r < RT && lane == 0) {
      m_s[r] = m[o];
      l_s[r] = l[o];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RT * D; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < NPG; ++g) a += red[g * RT * D + i];
    acc_s[i] = a;
  }
  __syncthreads();
  epilogue<T, D, RT>(p, acc_s, m_s, l_s, w_s, n_s, flag_s);
}

// ---------------------------------------------------------------------------
// Tensor-core path: 64 query rows a block, 16 a warp
// ---------------------------------------------------------------------------
// bf16 operands, as in flash_attention.cu's tc:: kernels.  Four 8 x 8 bf16
// matrices; lanes 8i..8i+7 give the row addresses of matrix i, and lane l
// gets (row l / 4, columns 2 (l % 4), +1) of each
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// the same, transposed: lane l gets (rows 2 (l % 4), +1; column l / 4)
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to a bf16 pair, x in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of 16-byte chunk `chunk` of row `row` in a tile of rows
// of D elements of type T (8 bf16 or 4 f32 a chunk): the chunk index is
// XOR-ed with row % 8, so 8 consecutive rows fall in distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) * (16 / static_cast<int>(sizeof(T))));
}

// the element (row, col) of a swizzled f32 tile
template <int D>
__device__ __forceinline__ int swz4(int row, int col) {
  return swz<float, D>(row, col >> 2) + (col & 3);
}

// A fragment (16 rows x 16 columns at chunk pair kc) of rows r0.. of a
// swizzled bf16 tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int kc) {
  const int lane = threadIdx.x % 32;
  ldsm(a, smem_u32(tile + swz<bf16, D>(r0 + (lane & 15),
                                       2 * kc + (lane >> 4))));
}

// B fragments of two n8 tiles from 16 rows r0.. of a swizzled [n][k] bf16
// tile (k = columns, chunk pair kc): the operand of x^T
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int r0, int kc) {
  const int lane = threadIdx.x % 32;
  ldsm(b, smem_u32(tile + swz<bf16, D>(r0 + (lane & 7) + ((lane >> 4) << 3),
                                       2 * kc + ((lane >> 3) & 1))));
}

// B fragments of two n8 tiles (columns 16 nc ..) from 16 rows r0.. of a
// swizzled [k][n] bf16 tile (rows = the product's k): the operand of x
template <int D>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* tile,
                                         int r0, int nc) {
  const int lane = threadIdx.x % 32;
  ldsm_t(b, smem_u32(tile + swz<bf16, D>(
                                r0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                2 * nc + (lane >> 4))));
}

// f32 operands: TF32 parts (the low 13 mantissa bits zero, rounded to
// nearest, ties away)
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo: hi its TF32 rounding, lo the remainder's
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c (16 x 8, f32) += a (16 x 8, tf32, row-major) * b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in f32 from TF32 parts: lo*hi + hi*lo + hi*hi
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// shared memory of the tensor-core kernel: q (f32: its TF32 high parts
// and remainders), the KV ring (K2: the int8 ring, its scales and one
// dequantized K/V tile), then m, l and the combine flag.  After the loop
// the ring region holds the f32 acc tile.
template <typename T, typename KV, int D>
struct TcSmem {
  static constexpr bool kQuant = !std::is_same<T, KV>::value;
  static constexpr int kTileT = kTcTile * D * sizeof(T);  // one K or V tile
  static constexpr int kQBytes = (std::is_same<T, float>::value ? 2 : 1) *
                                 kTcRows * D * sizeof(T);
  static constexpr int kRaw = kTcTile * D;                // int8 tile bytes
  static constexpr int kRing = kQuant
      ? 2 * 2 * kRaw + 2 * 2 * kTcTile * 4 + 2 * kTileT
      : 2 * 2 * kTileT;
  static constexpr int kAcc = kTcRows * D * 4;
  static constexpr int kRegion = kRing > kAcc ? kRing : kAcc;
  static constexpr int kVec = kQBytes + kRegion;  // m, l [kTcRows]
  static constexpr int kW = kVec + 2 * kTcRows * 4;
  static constexpr int kN = kW + kTcRows * kMaxSplits * 4;
  static constexpr int kFlag = kN + kTcRows * 4;
  static constexpr int kBytes = kFlag + 16;
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads) tc_kernel(const Params p) {
  using L = TcSmem<T, KV, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int BR = kTcRows, BC = kTcTile, ND = D / 8;
  constexpr int kCpr = D * static_cast<int>(sizeof(T)) / 16;  // chunks a row
  extern __shared__ uint4 smem[];
  char* base = reinterpret_cast<char*>(smem);
  T* q_s = reinterpret_cast<T*>(base);  // f32: hi [BR][D], then lo
  char* region = base + L::kQBytes;
  float* acc_s = reinterpret_cast<float*>(region);  // after the loop
  float* m_s = reinterpret_cast<float*>(base + L::kVec);
  float* l_s = m_s + BR;
  float* w_s = reinterpret_cast<float*>(base + L::kW);
  int* n_s = reinterpret_cast<int*>(base + L::kN);
  int* flag_s = reinterpret_cast<int*>(base + L::kFlag);

  const Block k = locate<BR>(p);
  if (k.s >= k.n_live) return;  // past every row's horizon
  const T* q = static_cast<const T*>(p.q);
  const KV* kp = static_cast<const KV*>(p.k_pages);
  const KV* vp = static_cast<const KV*>(p.v_pages);
  const int* bt = p.block_tables + static_cast<size_t>(k.b) * p.pages_max;
  const int hp0 = k.h * p.num_pages;
  const int n_tiles = (k.c1 - k.c0 + BC - 1) / BC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the tile

  // the stage-j K tile (V follows it), where the math reads it
  auto kv_tile = [&](int j) -> T* {
    return kQuant ? reinterpret_cast<T*>(region + 2 * 2 * L::kRaw +
                                         2 * 2 * BC * 4)
                  : reinterpret_cast<T*>(region) + (j & 1) * 2 * BC * D;
  };
  // the tile copies: rows looked up a tile ahead (`next`), copied into
  // stage j & 1 (K2: of the int8 ring, with the scales)
  TileRows<KV, D, BC, !kQuant> next;
#define TC_FIND(j) next.find(bt, hp0, p.page, k.c0 + (j) * BC, k.c1, kQuant)
#define TC_COPY(j)                                                         \
  do {                                                                     \
    if constexpr (kQuant) {                                                \
      char* raw = region + ((j) & 1) * 2 * L::kRaw;                        \
      next.copy(smem_u32(raw), smem_u32(raw + L::kRaw), kp, vp);           \
      next.copy_scales(reinterpret_cast<float*>(region + 2 * 2 * L::kRaw)  \
                           + ((j) & 1) * 2 * BC,                           \
                       p.k_scales, p.v_scales);                            \
    } else {                                                               \
      T* st = kv_tile(j);                                                  \
      next.copy(smem_u32(st), smem_u32(st + BC * D), kp, vp);              \
    }                                                                      \
  } while (0)
  if (n_tiles > 0) {  // the first tile's copy runs under q's load
    TC_FIND(0);
    TC_COPY(0);
  }

  // q rows (i, g) of this tile; rows past the last are zeros
  auto q_row = [&](int r) {
    const int row = k.r0 + r;
    return q + k.b * p.q_sb + (row / p.group) * p.q_si +
           (k.h * p.group + row % p.group) * p.q_sh;
  };
  if constexpr (kF32) {
    float* qh = reinterpret_cast<float*>(q_s);
    float* ql = qh + BR * D;
    for (int i = threadIdx.x; i < BR * kCpr; i += kThreads) {
      const int r = i / kCpr, c = i % kCpr;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < k.nr) v = *reinterpret_cast<const float4*>(q_row(r) + 4 * c);
      const float x[4] = {v.x * p.sl2, v.y * p.sl2, v.z * p.sl2,
                          v.w * p.sl2};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e], hi[e], lo[e]);
      const int o = swz<float, D>(r, c);
      *reinterpret_cast<uint4*>(qh + o) = make_uint4(hi[0], hi[1], hi[2],
                                                     hi[3]);
      *reinterpret_cast<uint4*>(ql + o) = make_uint4(lo[0], lo[1], lo[2],
                                                     lo[3]);
    }
  } else {
    const uint32_t qa = smem_u32(q_s);
    for (int i = threadIdx.x; i < BR * kCpr; i += kThreads) {
      const int r = i / kCpr, c = i % kCpr;
      const bool ok = r < k.nr;
      cp_async16(qa + 2 * swz<bf16, D>(r, c), ok ? q_row(r) + 8 * c : q, ok);
    }
  }
  cp_async_commit();
  TC_FIND(1);

  // this lane's rows: wr + g and wr + g + 8, their limits in this chunk
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    lim[h] = min(row_limit(p, k, k.r0 + wr + g + 8 * h), k.c1);
  const int warp_end = static_cast<int>(
      warp_max(static_cast<float>(max(lim[0], lim[1]))));

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) TC_COPY(j + 1);
    cp_async_commit();
    TC_FIND(j + 2);  // used next iteration
    cp_async_wait<1>();
    __syncthreads();  // tile j (and q) has landed for every thread
    T* k_s = kv_tile(j);
    T* v_s = k_s + BC * D;
    if constexpr (kQuant) {
      // dequantize the int8 tile j into the swizzled T tiles
      const int8_t* raw = reinterpret_cast<const int8_t*>(
          region + (j & 1) * 2 * L::kRaw);
      const float* sc = reinterpret_cast<const float*>(
          region + 2 * 2 * L::kRaw) + (j & 1) * 2 * BC;
      for (int i = threadIdx.x; i < 2 * BC * D / 8; i += kThreads) {
        const int kv = i / (BC * D / 8), u = i % (BC * D / 8);
        const int r = u / (D / 8), c8 = u % (D / 8);
        const uint2 w = *reinterpret_cast<const uint2*>(
            raw + kv * L::kRaw + r * D + 8 * c8);
        const int8_t* cs = reinterpret_cast<const int8_t*>(&w);
        const float s = sc[kv * BC + r];
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = dequant<T>(cs[e], s);
        T* dst = k_s + kv * BC * D;
        if constexpr (kF32) {
          *reinterpret_cast<float4*>(dst + swz<float, D>(r, 2 * c8)) =
              make_float4(f[0], f[1], f[2], f[3]);
          *reinterpret_cast<float4*>(dst + swz<float, D>(r, 2 * c8 + 1)) =
              make_float4(f[4], f[5], f[6], f[7]);
        } else {
          *reinterpret_cast<uint4*>(dst + swz<bf16, D>(r, c8)) =
              make_uint4(pack(f[0], f[1]), pack(f[2], f[3]),
                         pack(f[4], f[5]), pack(f[6], f[7]));
        }
      }
      __syncthreads();
    }
    const int t0 = k.c0 + j * BC;

    if (t0 < warp_end) {  // some row of the warp sees this tile
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      if constexpr (kF32) {
        const float* qh = reinterpret_cast<const float*>(q_s);
        const float* ql = qh + BR * D;
        const float* kf = reinterpret_cast<const float*>(k_s);
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const int c = 8 * kk + t;
          const int o[4] = {swz4<D>(wr + g, c), swz4<D>(wr + g + 8, c),
                            swz4<D>(wr + g, c + 4),
                            swz4<D>(wr + g + 8, c + 4)};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = __float_as_uint(qh[o[e]]);
            al[e] = __float_as_uint(ql[o[e]]);
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            mma3(s[nt], ah, al, kf[swz4<D>(8 * nt + g, c)],
                 kf[swz4<D>(8 * nt + g, c + 4)]);
        }
      } else {
        const bf16* qb = reinterpret_cast<const bf16*>(q_s);
        const bf16* kb = reinterpret_cast<const bf16*>(k_s);
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          uint32_t qa[4];
          load_a<D>(qa, qb, wr, kc);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            load_b<D>(b, kb, 16 * np, kc);
            mma_bf16(s[2 * np], qa, b[0], b[1]);
            mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
          }
        }
      }

      // log2 units (f32: q carries the scale), masked past each row's limit
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = t0 + 8 * nt + 2 * t + (e & 1);
          const float x = kF32 ? s[nt][e] : s[nt][e] * p.sl2;
          s[nt][e] = kpos < lim[e >> 1] ? x : kMaskValue;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];  // this lane's share of the row sum
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }
      // p = exp2(s - m) in f32, zero where masked
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = t0 + 8 * nt + 2 * t + (e & 1);
          const float pr = kpos < lim[e >> 1]
                               ? exp2f(s[nt][e] - m[e >> 1]) : 0.f;
          l[e >> 1] += pr;
          s[nt][e] = pr;
        }

      if constexpr (kF32) {
        // k index of step ks: A column t is position 8 ks + 2t, column
        // t + 4 position 8 ks + 2t + 1, so p's accumulator fragment is
        // the A fragment; V's rows follow the same order
        const float* vf = reinterpret_cast<const float*>(v_s);
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          uint32_t ah[4], al[4];
          split(s[ks][0], ah[0], al[0]);
          split(s[ks][2], ah[1], al[1]);
          split(s[ks][1], ah[2], al[2]);
          split(s[ks][3], ah[3], al[3]);
          const int r = 8 * ks + 2 * t;
#pragma unroll
          for (int dt = 0; dt < ND; ++dt)
            mma3(acc[dt], ah, al, vf[swz4<D>(r, 8 * dt + g)],
                 vf[swz4<D>(r + 1, 8 * dt + g)]);
        }
      } else {
        const bf16* vb = reinterpret_cast<const bf16*>(v_s);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          uint32_t pa[4];
          pa[0] = pack(s[2 * kc][0], s[2 * kc][1]);
          pa[1] = pack(s[2 * kc][2], s[2 * kc][3]);
          pa[2] = pack(s[2 * kc + 1][0], s[2 * kc + 1][1]);
          pa[3] = pack(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t b[4];
            load_b_t<D>(b, vb, 16 * kc, dp);
            mma_bf16(acc[2 * dp], pa, b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before it is overwritten
  }
#undef TC_FIND
#undef TC_COPY
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (t == 0) {
      m_s[wr + g + 8 * h] = m[h];
      l_s[wr + g + 8 * h] = l[h];
    }
  }
#pragma unroll
  for (int dt = 0; dt < ND; ++dt) {
    const int col = 8 * dt + 2 * t;
    *reinterpret_cast<float2*>(acc_s + (wr + g) * D + col) =
        make_float2(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<float2*>(acc_s + (wr + g + 8) * D + col) =
        make_float2(acc[dt][2], acc[dt][3]);
  }
  __syncthreads();
  epilogue<T, D, BR>(p, acc_s, m_s, l_s, w_s, n_s, flag_s);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// The kernel a launch of (q dtype T, pages KV, head_dim D) runs for
// q_len * group rows: the path, its row tile, its dynamic shared memory
enum Path { kSimt1 = 0, kSimt8 = 1, kTc = 2 };

__host__ __device__ constexpr int path_of(int rows) {
  return rows >= kTcMinRows ? kTc : (rows == 1 ? kSimt1 : kSimt8);
}

__host__ __device__ constexpr int rows_of(int path) {
  return path == kTc ? kTcRows : (path == kSimt1 ? 1 : 8);
}

template <typename T, typename KV, int D>
struct Kernel {
  const void* fn;
  int smem;
  static Kernel of(int path) {
    if (path == kSimt1)
      return {reinterpret_cast<const void*>(simt_kernel<T, KV, D, 1>),
              SimtSmem<T, KV, D, 1>::kBytes};
    if (path == kSimt8)
      return {reinterpret_cast<const void*>(simt_kernel<T, KV, D, 8>),
              SimtSmem<T, KV, D, 8>::kBytes};
    return {reinterpret_cast<const void*>(tc_kernel<T, KV, D>),
            TcSmem<T, KV, D>::kBytes};
  }
};

template <typename T, typename KV, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const int path = path_of(p.q_len * p.group);
  const Kernel<T, KV, D> kern = Kernel<T, KV, D>::of(path);
  // the shared-memory limit, raised once per kernel and device
  static bool raised[3][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !raised[path][dev]) {
    err = cudaFuncSetAttribute(
        kern.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kern.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) raised[path][dev] = true;
  }
  const int rt = rows_of(path);
  const dim3 grid(p.splits, (p.q_len * p.group + rt - 1) / rt * p.hkv, batch);
  void* args[] = {const_cast<Params*>(&p)};
  err = cudaLaunchKernel(kern.fn, grid, dim3(kThreads), args, kern.smem,
                         stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (of q and out; of the pages too for
// K1); head_dim 64 or 128.  Calls F<T, KV, D>(args...).
template <bool kQuant, template <typename, typename, int> class F,
          typename... A>
int dispatch(int dtype, int head_dim, A... args) {
#define PA_CASE(T, D) \
  return F<T, std::conditional_t<kQuant, int8_t, T>, D>::run(args...)
  if (dtype == 0 && head_dim == 64) PA_CASE(float, 64);
  if (dtype == 0 && head_dim == 128) PA_CASE(float, 128);
  if (dtype == 1 && head_dim == 64) PA_CASE(bf16, 64);
  if (dtype == 1 && head_dim == 128) PA_CASE(bf16, 128);
#undef PA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename KV, int D>
struct Launch {
  static int run(const Params* p, int batch, cudaStream_t s) {
    return launch<T, KV, D>(*p, batch, s);
  }
};

template <typename T, typename KV, int D>
struct Attrs {
  static int run(int path, int* out) {
    const Kernel<T, KV, D> kern = Kernel<T, KV, D>::of(path);
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kern.fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = kern.smem;
    return 0;
  }
};

template <bool kQuant>
int forward(const void* q, const void* k_pages, const void* v_pages,
        const void* k_scales, const void* v_scales, const void* block_tables,
        const void* seq_lens, const void* q_offsets, void* out, void* ws,
        void* counters, int batch, int q_len, int hq, int hkv, int head_dim,
        int num_pages, int page, int pages_max, long long q_sb,
        long long q_si, long long q_sh, int splits, int chunk, float scale,
        int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv || splits < 1 || splits > kMaxSplits ||
      chunk % kChunkUnit ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      static_cast<long long>(splits) * chunk <
          static_cast<long long>(pages_max) * page)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.block_tables = static_cast<const int*>(block_tables);
  p.seq_lens = static_cast<const int*>(seq_lens);
  p.q_offsets = static_cast<const int*>(q_offsets);
  p.out = out;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.q_sb = q_sb;
  p.q_si = q_si;
  p.q_sh = q_sh;
  p.q_len = q_len;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.num_pages = num_pages;
  p.page = page;
  p.pages_max = pages_max;
  p.splits = splits;
  p.chunk = chunk;
  p.sl2 = scale * kLog2e;
  return dispatch<kQuant, Launch>(dtype, head_dim, &p, batch,
                                  static_cast<cudaStream_t>(stream));
}

}  // namespace

// K1: pages of q's dtype.  q: [B, Q, Hq, D] with strides (q_sb, q_si, q_sh,
// 1) in elements, each a multiple of 16 bytes; out: [B, Q, Hq, D] dense;
// ws: f32 [B * Hkv * splits * Q * group * (D + 2)] when splits > 1, else
// unused; counters: int32 zeros, one per (sequence, KV head, row tile)
// (B * Hkv * ceil(Q * group / 8) cover every path), left zero.
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, const void* q_offsets,
    void* out, void* ws, void* counters, int batch, int q_len, int hq,
    int hkv, int head_dim, int num_pages, int page, int pages_max,
    long long q_sb, long long q_si, long long q_sh, int splits, int chunk,
    float scale, int dtype, void* stream) {
  return forward<false>(q, k_pages, v_pages, nullptr, nullptr, block_tables,
                    seq_lens, q_offsets, out, ws, counters, batch, q_len, hq,
                    hkv, head_dim, num_pages, page, pages_max, q_sb, q_si,
                    q_sh, splits, chunk, scale, dtype, stream);
}

// K2: int8 pages with f32 scales [Hkv, num_pages]; the rest as K1.
extern "C" int paged_attention_q_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* seq_lens, const void* q_offsets, void* out, void* ws,
    void* counters, int batch, int q_len, int hq, int hkv, int head_dim,
    int num_pages, int page, int pages_max, long long q_sb, long long q_si,
    long long q_sh, int splits, int chunk, float scale, int dtype,
    void* stream) {
  return forward<true>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                   seq_lens, q_offsets, out, ws, counters, batch, q_len, hq,
                   hkv, head_dim, num_pages, page, pages_max, q_sb, q_si,
                   q_sh, splits, chunk, scale, dtype, stream);
}

// Registers, local (stack and spill) bytes, static and dynamic shared
// memory of one instantiation into out[0..4): path 0 = SIMT, one row;
// 1 = SIMT, up to 8 rows; 2 = tensor cores.  quant: K2.
extern "C" int paged_attention_kernel_attrs(int path, int head_dim, int dtype,
                                            int quant, int* out) {
  if (path < 0 || path > 2) return static_cast<int>(cudaErrorInvalidValue);
  return quant ? dispatch<true, Attrs>(dtype, head_dim, path, out)
               : dispatch<false, Attrs>(dtype, head_dim, path, out);
}

}  // namespace paddle_tpu_torch
