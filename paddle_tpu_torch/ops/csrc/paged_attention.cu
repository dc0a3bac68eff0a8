// Ragged paged attention over a paged KV cache — kernels K1 and K2 of the
// port.
//
// K1 replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// `_decode_kernel` (launched by `_pallas_paged_attention`).  It computes
// the same function, not a block-by-block copy: for every sequence b,
// KV head h and query row r = (query token i, GQA group member g), row r
// attends to KV positions p < min(seq_lens[b], q_offsets[b] + i + 1),
// read through block_tables[b, p / page]; softmax is online in f32 and
// the output is acc / max(l, 1e-30), so a row that sees nothing (a
// seq_len 0 slot) writes exact zeros.
//
// Design.  One block per (tile of 16 query rows, KV head, sequence).
// The TPU kernel carried its softmax state across a sequential page
// grid axis in VMEM scratch; here one block loops over the sequence's
// live KV positions itself, 32 at a time (one position per lane), and
// keeps each row's m / l / acc in registers.  The block reads its own
// block-table entries (scalar prefetch on the TPU).  Each tile of K and
// V is staged in shared memory as f32 (K rows padded by one float so a
// lane per KV row reads conflict-free); the q tile, pre-scaled in f32
// as the Pallas kernel does, stays in shared memory for the whole loop.
// The loop stops at the tile's causal horizon, so a prefill chunk's
// early rows do not pay for KV they cannot see.
//
// Bound.  Decode and chunked prefill at serving batch sizes are bound
// by memory: each live K/V byte is read once per query-row tile, and
// the arithmetic (4 * rows * live_kv * D flops) is far below the card's
// rate.  What this simple design leaves on the table: no wgmma or
// tensor cores (the dot products run on the CUDA cores in f32), no TMA
// or cp.async pipelining (a tile's load and its math do not overlap),
// no split-KV (a decode step launches only B * Hkv blocks, fewer than
// the card has SMs, so long sequences run on few SMs), and three of the
// four warps idle during the math when a tile has a single query row.
//
// K2 replaces `_decode_kernel_q` of the same file: K1's function over
// int8 pages (FLAGS_kv_quant=int8) with per-page, per-head f32 scales
// [Hkv, num_pages].  It is the same kernel instantiated for int8 storage:
// each K/V element widens to f32, multiplies by the scale of ITS page
// (scales[h, block_tables[b, p / page]], looked up per position, since a
// 32-position tile spans several pages when the page is smaller than 32)
// and rounds through the query dtype and back (a no-op in f32; in bf16 it
// is the reference's `.to(q.dtype)`), so the dequantized operands are
// bit-identical to the plain version's; the math after the load is K1's.
// An int8 row moves a quarter of an f32 row's bytes, so K2's bound is a
// quarter of K1's; like K1 it is far from it (the loads do not overlap
// the math, and the dot products run on the CUDA cores).
//
// Interface: plain C functions, built with nvcc for sm_90a and loaded
// with ctypes (paddle_tpu_torch/ops/_build.py).  Each launches on the
// given stream, allocates nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

// Every symbol of the port's kernel sources lives in this namespace, so
// a profiler's kernel names tell the port's kernels from PyTorch's.
namespace paddle_tpu_torch {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKvTile = 32;                      // KV positions per tile
constexpr float kMaskValue = -1e30f;             // paddle_tpu's mask value

// 16-byte vector loads: 4 f32, 8 bf16 or 16 int8 per thread
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
};
template <>
struct Vec<int8_t> {
  using type = int4;
  static constexpr int n = 16;
};

__device__ __forceinline__ void unpack(const float4& v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void unpack(const uint4& v, float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte vector of K or V pages as f32.  Pages of the query dtype
// load as they are (K1); int8 pages (K2) dequantize by their page's
// scale and round through the query dtype T, as the plain version does.
template <typename T, typename KV>
struct KvLoad {
  static constexpr int n = Vec<T>::n;
  __device__ __forceinline__ static void load(const KV* src, float,
                                              float* o) {
    unpack(*reinterpret_cast<const typename Vec<T>::type*>(src), o);
  }
};
template <typename T>
struct KvLoad<T, int8_t> {
  static constexpr int n = Vec<int8_t>::n;
  __device__ __forceinline__ static void load(const int8_t* src,
                                              float scale, float* o) {
    const int4 v = *reinterpret_cast<const int4*>(src);
    const int8_t* c = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int e = 0; e < n; ++e)
      o[e] = to_f32(from_f32<T>(static_cast<float>(c[e]) * scale));
  }
};

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

// q, out: [B, Q, Hq, D]; k_pages, v_pages: [Hkv, num_pages, page, D] of
// KV (T for K1, int8 for K2); k_scales, v_scales: [Hkv, num_pages] (K2
// only, else null); block_tables: [B, pages_max]; seq_lens, q_offsets:
// [B].  All dense.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const KV* __restrict__ k_pages,
    const KV* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ block_tables,
    const int* __restrict__ seq_lens, const int* __restrict__ q_offsets,
    T* __restrict__ out, int q_len, int hq, int group, int num_pages,
    int page, int pages_max, float scale) {
  using Load = KvLoad<T, KV>;
  constexpr bool kQuant = !std::is_same<T, KV>::value;
  constexpr int kVec = Load::n;
  constexpr int kPerLane = D / 32;  // accumulator columns per lane

  __shared__ float q_s[kRowTile][D];
  __shared__ float k_s[kKvTile][D + 1];  // +1: conflict-free column reads
  __shared__ float v_s[kKvTile][D];

  const int row0 = blockIdx.x * kRowTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = q_len * group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sl = seq_lens[b];
  const int qo = q_offsets[b];
  const int* bt = block_tables + static_cast<size_t>(b) * pages_max;

  for (int i = threadIdx.x; i < kRowTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < rows) {
      const int qi = row / group, g = row % group;
      val = to_f32(q[((static_cast<size_t>(b) * q_len + qi) * hq +
                      h * group + g) * D + d]) * scale;
    }
    q_s[r][d] = val;
  }

  // positions past the block table's reach do not exist (the reference
  // gathers only pages_max * page positions), whatever seq_len says
  const int horizon = pages_max * page;

  // per-row causal limit, online-softmax state and accumulator
  int limit[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    limit[rr] = row < rows ? min(min(sl, qo + row / group + 1), horizon) : 0;
    m[rr] = kMaskValue;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[rr][j] = 0.f;
  }

  // the tile's end: the last real row sees furthest
  const int last_row = min(row0 + kRowTile, rows) - 1;
  const int kv_end = min(min(sl, qo + last_row / group + 1), horizon);

  for (int t0 = 0; t0 < kv_end; t0 += kKvTile) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    for (int i = threadIdx.x; i < kKvTile * D / kVec; i += kThreads) {
      const int n = i / (D / kVec);
      const int c = (i % (D / kVec)) * kVec;
      const int p = t0 + n;
      float kf[kVec], vf[kVec];
      if (p < kv_end) {
        const size_t hp = static_cast<size_t>(h) * num_pages + bt[p / page];
        const size_t off = (hp * page + p % page) * D + c;
        Load::load(k_pages + off, kQuant ? k_scales[hp] : 1.f, kf);
        Load::load(v_pages + off, kQuant ? v_scales[hp] : 1.f, vf);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[n][c + e] = kf[e];
        v_s[n][c + e] = vf[e];
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      // uniform across the warp: a row that sees nothing in this tile
      // would leave its state unchanged (alpha 1, no mass), so skip it
      if (t0 >= limit[rr]) continue;
      const int r = warp * kRowsPerWarp + rr;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += q_s[r][d] * k_s[lane][d];
      const bool valid = t0 + lane < limit[rr];
      s = valid ? s : kMaskValue;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float pr = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(pr);
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[rr][j] *= alpha;
#pragma unroll 8
      for (int n = 0; n < kKvTile; ++n) {
        const float pn = __shfl_sync(0xffffffffu, pr, n);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          acc[rr][j] += pn * v_s[n][lane + 32 * j];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = row0 + warp * kRowsPerWarp + rr;
    if (row >= rows) continue;
    const int qi = row / group, g = row % group;
    T* o = out + ((static_cast<size_t>(b) * q_len + qi) * hq + h * group +
                  g) * D;
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      o[lane + 32 * j] = from_f32<T>(acc[rr][j] / denom);
  }
}

template <typename T, typename KV, int D>
void launch(const void* q, const void* k_pages, const void* v_pages,
            const void* k_scales, const void* v_scales,
            const void* block_tables, const void* seq_lens,
            const void* q_offsets, void* out, int batch, int q_len, int hq,
            int hkv, int num_pages, int page, int pages_max, float scale,
            cudaStream_t stream) {
  const int group = hq / hkv;
  const dim3 grid((q_len * group + kRowTile - 1) / kRowTile, hkv, batch);
  paged_attention_kernel<T, KV, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k_pages),
      static_cast<const KV*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<const int*>(q_offsets),
      static_cast<T*>(out), q_len, hq, group, num_pages, page, pages_max,
      scale);
}

// KV = T: K1; KV = int8_t: K2.  dtype: 0 = float32, 1 = bfloat16 (of q and
// out; of the pages too for K1).  head_dim: 64 or 128.
template <bool kQuant>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales,
             const void* block_tables, const void* seq_lens,
             const void* q_offsets, void* out, int batch, int q_len, int hq,
             int hkv, int head_dim, int num_pages, int page, int pages_max,
             float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(T, D)                                                    \
  launch<T, std::conditional_t<kQuant, int8_t, T>, D>(                    \
      q, k_pages, v_pages, k_scales, v_scales, block_tables, seq_lens,     \
      q_offsets, out, batch, q_len, hq, hkv, num_pages, page, pages_max,   \
      scale, s)
  if (dtype == 0 && head_dim == 64) {
    PA_LAUNCH(float, 64);
  } else if (dtype == 0 && head_dim == 128) {
    PA_LAUNCH(float, 128);
  } else if (dtype == 1 && head_dim == 64) {
    PA_LAUNCH(__nv_bfloat16, 64);
  } else if (dtype == 1 && head_dim == 128) {
    PA_LAUNCH(__nv_bfloat16, 128);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: pages of q's dtype.
extern "C" int paged_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* seq_lens, const void* q_offsets,
    void* out, int batch, int q_len, int hq, int hkv, int head_dim,
    int num_pages, int page, int pages_max, float scale, int dtype,
    void* stream) {
  return dispatch<false>(q, k_pages, v_pages, nullptr, nullptr,
                         block_tables, seq_lens, q_offsets, out, batch,
                         q_len, hq, hkv, head_dim, num_pages, page,
                         pages_max, scale, dtype, stream);
}

// K2: int8 pages with f32 scales [Hkv, num_pages].
extern "C" int paged_attention_q_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* seq_lens, const void* q_offsets, void* out, int batch,
    int q_len, int hq, int hkv, int head_dim, int num_pages, int page,
    int pages_max, float scale, int dtype, void* stream) {
  return dispatch<true>(q, k_pages, v_pages, k_scales, v_scales,
                        block_tables, seq_lens, q_offsets, out, batch, q_len,
                        hq, hkv, head_dim, num_pages, page, pages_max, scale,
                        dtype, stream);
}

}  // namespace paddle_tpu_torch
