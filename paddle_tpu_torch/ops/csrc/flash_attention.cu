// Dense flash attention, forward (kernel K3) and backward (kernel K4, two
// kernels: dkv and dq) — kernels of the port.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   K3  `_fwd_kernel_resident` and `_fwd_kernel` (both in `_pallas_forward`;
//       the two differ only in their VMEM budget, one kernel here);
//   K4  `_bwd_dkv_kernel` and `_bwd_dq_kernel` (in `_pallas_backward`).
// The function is the TPU kernels', not a block-by-block copy.  Per head,
// with q pre-scaled in f32 (qs = q * scale) and the top-left causal mask
// q_pos >= k_pos (keys past seq_k and queries past seq_q never count):
//   forward   out = softmax(qs k^T) v, lse = m + log(l), online in f32,
//             out = acc / max(l, 1e-30);
//   backward  p = exp(qs k^T - lse), delta = rowsum(dout * out) (in the
//             kernel, from the saved out), ds = p * (dout v^T - delta),
//             dv = p^T dout, dk = ds^T qs, dq = scale * ds k.
// Every output tile has one writer (no atomics): the dkv kernel owns a
// tile of keys and loops over query tiles, the dq kernel owns a tile of
// queries and loops over key tiles, so gradients are deterministic.
//
// Design.  The TPU kernels carry their softmax state (forward) or their
// gradient sums (backward) across a sequential grid axis in VMEM scratch.
// CUDA blocks run in no order, so one block of 256 threads owns one
// 64-row tile and loops over the other operand's 64-row tiles itself,
// keeping its state in registers: each thread owns a 4 x 4 block of the
// 64 x 64 score tile (rows 4*ty.., columns 4*tx..) and a 4 x (D/16) block
// of its accumulator.  Tiles are staged in shared memory as f32 (bf16 is
// widened on load), in the layout each product reads without bank
// conflicts: the operand indexed by the thread's rows padded by 4 floats,
// the one indexed by its columns stored so a thread reads 4 neighbours
// with one 16-byte load (K transposed for q k^T, and so on).  The causal
// loops stop at the diagonal, as the TPU kernels' `live` predicates and
// clamps do; the forward and dq grids put the heaviest (last) query tiles
// first.  Ragged lengths need no divisibility: rows past the end load as
// zeros and are masked.
//
// Bound.  Per head, the products take 2 (forward), 4 (dkv: q k^T,
// dout v^T, p^T dout, ds^T q) and 3 (dq) times 2 * S * S * D flops, halved
// by the causal mask, against a few bytes per row.  At the train path's
// shape (S = 1024, D = 64) the least time is set by operations in f32 and,
// narrowly, by bytes in bf16 (at the tensor cores' rate the products take
// ~85% of the time the bytes do).  This simple design runs the products
// on the CUDA cores in f32 (SIMT FMAs, 16 per two 16-byte shared-memory
// loads) for bf16 and f32 alike, so its f32 FMA rate bounds it; it leaves
// the tensor cores (mma.sync / wgmma for bf16), cp.async or TMA pipelining
// of the next tile under the current one's math, and a fused single-pass
// backward to later work.
//
// Interface: plain C functions, built with nvcc for sm_90a and loaded
// with ctypes (paddle_tpu_torch/ops/_build.py).  Each launches on the
// given stream, allocates nothing, and returns a cudaError_t as int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;             // 16 x 16: tx = t % 16, ty = t / 16
constexpr int kTile = 64;                 // rows of every tile
constexpr int kLdp = kTile + 4;           // padded row of a 64-wide score tile
constexpr float kMaskValue = -1e30f;      // paddle_tpu's mask value

// 16-byte vector loads: 4 f32 or 8 bf16 per thread
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

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* o) {
  unpack(*reinterpret_cast<const typename Vec<T>::type*>(p), o);
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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// max / sum over the 16 lanes that share a row (lanes 0-15 or 16-31)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [r0, r0 + 64) of a dense [n_rows, D] matrix into shared memory as
// f32 times `scale`, row r at dst[r * LD]; rows past n_rows are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n_rows, float scale) {
  constexpr int V = Vec<T>::n;
  constexpr int kChunks = D / V;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * V;
    float f[V];
    if (r0 + r < n_rows) {
      load_vec(src + static_cast<size_t>(r0 + r) * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * LD + c + e] = f[e] * scale;
  }
}

// The same rows transposed: element (r, d) at dst[d * 64 + r].  Neighbour
// threads take neighbour rows, so the transposed stores hit distinct banks.
template <typename T, int D>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src, int r0,
                                            int n_rows, float scale) {
  constexpr int V = Vec<T>::n;
  constexpr int kChunks = D / V;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i % kTile, c = (i / kTile) * V;
    float f[V];
    if (r0 + r < n_rows) {
      load_vec(src + static_cast<size_t>(r0 + r) * D + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[(c + e) * kTile + r] = f[e] * scale;
  }
}

// acc[i][4 * nb + j] += sum_{x < K} A[(ra + i) * LDA + x]
//                                   * B[x * LDB + 64 * nb + cb + j]
// for i, j < 4 and nb < NB: the thread's 4 rows (from A, padded rows) by
// its 4 * NB columns (from B, read 4 at a time).
template <int NB, int K, int LDA, int LDB>
__device__ __forceinline__ void tile_mma(float (&acc)[4][4 * NB],
                                         const float* A, const float* B,
                                         int ra, int cb) {
#pragma unroll 2
  for (int x = 0; x < K; x += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ra + i) * LDA + x);
#pragma unroll
    for (int xx = 0; xx < 4; ++xx) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 b = *reinterpret_cast<const float4*>(
            B + (x + xx) * LDB + 64 * nb + cb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = comp(a[i], xx);
          acc[i][4 * nb + 0] += av * b.x;
          acc[i][4 * nb + 1] += av * b.y;
          acc[i][4 * nb + 2] += av * b.z;
          acc[i][4 * nb + 3] += av * b.w;
        }
      }
    }
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int sq, int sk,
                                        int causal) {
  return qp < sq && kp < sk && (!causal || kp <= qp);
}

// delta[r] = sum_c dout[q0 + r][c] * out[q0 + r][c] and the rows' lse, for
// the 64 rows of a query tile (4 threads a row); rows past sq get 0.
template <typename T, int D>
__device__ __forceinline__ void load_row_stats(float* delta_s, float* lse_s,
                                               const T* dout, const T* out,
                                               const float* lse, int q0,
                                               int sq) {
  constexpr int V = Vec<T>::n;
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  float acc = 0.f;
  if (q0 + r < sq) {
    const size_t row = static_cast<size_t>(q0 + r) * D;
    for (int c = part * V; c < D; c += 4 * V) {
      float a[V], b[V];
      load_vec(dout + row + c, a);
      load_vec(out + row + c, b);
#pragma unroll
      for (int e = 0; e < V; ++e) acc += a[e] * b[e];
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    delta_s[r] = acc;
    lse_s[r] = q0 + r < sq ? lse[q0 + r] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K3: forward.  Grid (B*H, query tiles); q, out: [BH, sq, D], k, v: [BH, sk,
// D], lse: [BH, sq] f32.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int sq, int sk, float scale,
    int causal) {
  constexpr int NB = D / 64;
  constexpr int kLdq = D + 4;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [64][kLdq]  q * scale
  float* kt_s = q_s + kTile * kLdq;    // [D][64]     k transposed
  float* v_s = kt_s + D * kTile;       // [64][D]
  float* p_s = v_s + kTile * D;        // [64][kLdp]  probabilities

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heavy tiles first
  const T* qh = q + bh * sq * D;
  const T* kh = k + bh * sk * D;
  const T* vh = v + bh * sk * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ra = 4 * ty, cb = 4 * tx;

  load_rows<T, D, kLdq>(q_s, qh, q0, sq, scale);

  float m[4], l[4], acc[4][4 * NB];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    load_rows_t<T, D>(kt_s, kh, k0, sk, 1.f);
    load_rows<T, D, D>(v_s, vh, k0, sk, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    tile_mma<1, D, kLdq, kTile>(s, q_s, kt_s, ra, cb);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ra + i;
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(qp, k0 + cb + j, sq, sk, causal)) s[i][j] = kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float4 p;
      p.x = visible(qp, k0 + cb + 0, sq, sk, causal) ? expf(s[i][0] - m_new) : 0.f;
      p.y = visible(qp, k0 + cb + 1, sq, sk, causal) ? expf(s[i][1] - m_new) : 0.f;
      p.z = visible(qp, k0 + cb + 2, sq, sk, causal) ? expf(s[i][2] - m_new) : 0.f;
      p.w = visible(qp, k0 + cb + 3, sq, sk, causal) ? expf(s[i][3] - m_new) : 0.f;
      l[i] = l[i] * alpha + row_sum(p.x + p.y + p.z + p.w);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(p_s + (ra + i) * kLdp + cb) = p;
    }
    __syncthreads();
    tile_mma<NB, kTile, kLdp, D>(acc, p_s, v_s, ra, cb);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (bh * sq + row) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[64 * nb + cb + j] = from_f32<T>(acc[i][4 * nb + j] / denom);
    if (tx == 0) lse[bh * sq + row] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// K4, dkv: grid (B*H, key tiles).  The block owns 64 keys and loops over the
// query tiles that can see them.
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int dkv_region() {  // floats of a q^T tile, reused for p^T
  return D * kTile > kTile * kLdp ? D * kTile : kTile * kLdp;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const float* __restrict__ lse,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int sk, float scale, int causal) {
  constexpr int NB = D / 64;
  constexpr int kLdk = D + 4;
  constexpr int kRegion = dkv_region<D>();
  extern __shared__ float smem[];
  float* k_s = smem;                    // [64][kLdk]
  float* v_s = k_s + kTile * kLdk;      // [64][kLdk]
  float* qt_s = v_s + kTile * kLdk;     // [D][64] q^T * scale, then p^T
  float* dot_s = qt_s + kRegion;        // [D][64] dout^T, then ds^T
  float* q_s = dot_s + kRegion;         // [64][D] q * scale
  float* do_s = q_s + kTile * D;        // [64][D] dout
  float* lse_s = do_s + kTile * D;      // [64]
  float* delta_s = lse_s + kTile;       // [64]

  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const T* qh = q + bh * sq * D;
  const T* oh = out + bh * sq * D;
  const T* doh = dout + bh * sq * D;
  const float* lseh = lse + bh * sq;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ra = 4 * ty, cb = 4 * tx;

  load_rows<T, D, kLdk>(k_s, k + bh * sk * D, k0, sk, 1.f);
  load_rows<T, D, kLdk>(v_s, v + bh * sk * D, k0, sk, 1.f);

  float dk_acc[4][4 * NB], dv_acc[4][4 * NB];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // the first query tile with a row that sees key k0
  const int q_begin = causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < sq; q0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and k_s, v_s written)
    load_rows_t<T, D>(qt_s, qh, q0, sq, scale);
    load_rows_t<T, D>(dot_s, doh, q0, sq, 1.f);
    load_rows<T, D, D>(q_s, qh, q0, sq, scale);
    load_rows<T, D, D>(do_s, doh, q0, sq, 1.f);
    load_row_stats<T, D>(delta_s, lse_s, doh, oh, lseh, q0, sq);
    __syncthreads();

    // transposed scores: rows are keys, columns queries
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    tile_mma<1, D, kLdk, kTile>(st, k_s, qt_s, ra, cb);
    tile_mma<1, D, kLdk, kTile>(dpt, v_s, dot_s, ra, cb);
    float4 pt[4], dst[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ra + i;
      float pv[4], dsv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cb + j;
        pv[j] = visible(q0 + c, kp, sq, sk, causal)
                    ? expf(st[i][j] - lse_s[c]) : 0.f;
        dsv[j] = pv[j] * (dpt[i][j] - delta_s[c]);
      }
      pt[i] = make_float4(pv[0], pv[1], pv[2], pv[3]);
      dst[i] = make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();  // every thread is done with q^T and dout^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<float4*>(qt_s + (ra + i) * kLdp + cb) = pt[i];
      *reinterpret_cast<float4*>(dot_s + (ra + i) * kLdp + cb) = dst[i];
    }
    __syncthreads();
    tile_mma<NB, kTile, kLdp, D>(dv_acc, qt_s, do_s, ra, cb);
    tile_mma<NB, kTile, kLdp, D>(dk_acc, dot_s, q_s, ra, cb);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ra + i;
    if (row >= sk) continue;
    T* dkr = dk + (bh * sk + row) * D;
    T* dvr = dv + (bh * sk + row) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dkr[64 * nb + cb + j] = from_f32<T>(dk_acc[i][4 * nb + j]);
        dvr[64 * nb + cb + j] = from_f32<T>(dv_acc[i][4 * nb + j]);
      }
  }
}

// ---------------------------------------------------------------------------
// K4, dq: grid (B*H, query tiles).  The block owns 64 queries and loops over
// the key tiles they can see.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ out, const float* __restrict__ lse,
    const T* __restrict__ dout, T* __restrict__ dq, int sq, int sk,
    float scale, int causal) {
  constexpr int NB = D / 64;
  constexpr int kLdq = D + 4;
  extern __shared__ float smem[];
  float* q_s = smem;                    // [64][kLdq] q * scale
  float* do_s = q_s + kTile * kLdq;     // [64][kLdq] dout
  float* kt_s = do_s + kTile * kLdq;    // [D][64]    k^T
  float* vt_s = kt_s + D * kTile;       // [D][64]    v^T
  float* k_s = vt_s + D * kTile;        // [64][D]    k
  float* ds_s = k_s + kTile * D;        // [64][kLdp] ds
  float* lse_s = ds_s + kTile * kLdp;   // [64]
  float* delta_s = lse_s + kTile;       // [64]

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heavy tiles first
  const T* kh = k + bh * sk * D;
  const T* vh = v + bh * sk * D;
  const T* doh = dout + bh * sq * D;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ra = 4 * ty, cb = 4 * tx;

  load_rows<T, D, kLdq>(q_s, q + bh * sq * D, q0, sq, scale);
  load_rows<T, D, kLdq>(do_s, doh, q0, sq, 1.f);
  load_row_stats<T, D>(delta_s, lse_s, doh, out + bh * sq * D, lse + bh * sq,
                       q0, sq);

  float dq_acc[4][4 * NB];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NB; ++j) dq_acc[i][j] = 0.f;

  const int kv_end = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and the q tile written)
    load_rows_t<T, D>(kt_s, kh, k0, sk, 1.f);
    load_rows_t<T, D>(vt_s, vh, k0, sk, 1.f);
    load_rows<T, D, D>(k_s, kh, k0, sk, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_mma<1, D, kLdq, kTile>(s, q_s, kt_s, ra, cb);
    tile_mma<1, D, kLdq, kTile>(dp, do_s, vt_s, ra, cb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ra + i;
      float dsv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(q0 + r, k0 + cb + j, sq, sk, causal)
                            ? expf(s[i][j] - lse_s[r]) : 0.f;
        dsv[j] = p * (dp[i][j] - delta_s[r]);
      }
      *reinterpret_cast<float4*>(ds_s + r * kLdp + cb) =
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();
    tile_mma<NB, kTile, kLdp, D>(dq_acc, ds_s, k_s, ra, cb);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + i;
    if (row >= sq) continue;
    T* o = dq + (bh * sq + row) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[64 * nb + cb + j] = from_f32<T>(dq_acc[i][4 * nb + j] * scale);
  }
}

// shared-memory bytes of each kernel
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (kTile * (D + 4) + 2 * D * kTile + kTile * kLdp);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (2 * kTile * (D + 4) + 2 * dkv_region<D>() + 2 * kTile * D + 2 * kTile);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kTile * (D + 4) + 3 * D * kTile + kTile * kLdp +
                          2 * kTile);
}

// Launch `kernel` over (bh, tiles) blocks with `smem` bytes of dynamic
// shared memory (above the 48 KB default, so the limit is raised first).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int bh, int tiles, cudaStream_t stream,
           Args... args) {
  if (bh <= 0 || tiles <= 0) return 0;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(bh, tiles), kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int tiles_of(int n) { return (n + kTile - 1) / kTile; }

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int bh, int sq, int sk, float scale, int causal, cudaStream_t s) {
  return launch(flash_fwd_kernel<T, D>, fwd_smem<D>(), bh, tiles_of(sq), s,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(out),
                static_cast<float*>(lse), sq, sk, scale, causal);
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* out,
        const void* lse, const void* dout, void* dk, void* dv, int bh, int sq,
        int sk, float scale, int causal, cudaStream_t s) {
  return launch(flash_bwd_dkv_kernel<T, D>, dkv_smem<D>(), bh, tiles_of(sk),
                s, static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(out),
                static_cast<const float*>(lse), static_cast<const T*>(dout),
                static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, scale,
                causal);
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* out,
       const void* lse, const void* dout, void* dq_out, int bh, int sq,
       int sk, float scale, int causal, cudaStream_t s) {
  return launch(flash_bwd_dq_kernel<T, D>, dq_smem<D>(), bh, tiles_of(sq), s,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(out),
                static_cast<const float*>(lse), static_cast<const T*>(dout),
                static_cast<T*>(dq_out), sq, sk, scale, causal);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 64 or 128.  Tensors are
// dense: q, out, dout, dq [bh, sq, D]; k, v, dk, dv [bh, sk, D]; lse
// [bh, sq] f32.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int bh, int sq, int sk, int head_dim,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return fwd<float, 64>(q, k, v, out, lse, bh, sq, sk, scale, causal, s);
  if (dtype == 0 && head_dim == 128)
    return fwd<float, 128>(q, k, v, out, lse, bh, sq, sk, scale, causal, s);
  if (dtype == 1 && head_dim == 64)
    return fwd<__nv_bfloat16, 64>(q, k, v, out, lse, bh, sq, sk, scale,
                                  causal, s);
  if (dtype == 1 && head_dim == 128)
    return fwd<__nv_bfloat16, 128>(q, k, v, out, lse, bh, sq, sk, scale,
                                   causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* out,
                                       const void* lse, const void* dout,
                                       void* dk, void* dv, int bh, int sq,
                                       int sk, int head_dim, float scale,
                                       int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return dkv<float, 64>(q, k, v, out, lse, dout, dk, dv, bh, sq, sk, scale,
                          causal, s);
  if (dtype == 0 && head_dim == 128)
    return dkv<float, 128>(q, k, v, out, lse, dout, dk, dv, bh, sq, sk,
                           scale, causal, s);
  if (dtype == 1 && head_dim == 64)
    return dkv<__nv_bfloat16, 64>(q, k, v, out, lse, dout, dk, dv, bh, sq,
                                  sk, scale, causal, s);
  if (dtype == 1 && head_dim == 128)
    return dkv<__nv_bfloat16, 128>(q, k, v, out, lse, dout, dk, dv, bh, sq,
                                   sk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* out,
                                      const void* lse, const void* dout,
                                      void* dq_out, int bh, int sq, int sk,
                                      int head_dim, float scale, int causal,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return dq<float, 64>(q, k, v, out, lse, dout, dq_out, bh, sq, sk, scale,
                         causal, s);
  if (dtype == 0 && head_dim == 128)
    return dq<float, 128>(q, k, v, out, lse, dout, dq_out, bh, sq, sk, scale,
                          causal, s);
  if (dtype == 1 && head_dim == 64)
    return dq<__nv_bfloat16, 64>(q, k, v, out, lse, dout, dq_out, bh, sq, sk,
                                 scale, causal, s);
  if (dtype == 1 && head_dim == 128)
    return dq<__nv_bfloat16, 128>(q, k, v, out, lse, dout, dq_out, bh, sq,
                                  sk, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
