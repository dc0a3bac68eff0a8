// Dense flash attention, forward (kernel K3) and backward (kernel K4, two
// kernels: dkv and dq) — kernels of the port.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   K3  `_fwd_kernel_resident` and `_fwd_kernel` (both in `_pallas_forward`;
//       the two differ only in their VMEM budget, one kernel here);
//   K4  `_bwd_dkv_kernel` and `_bwd_dq_kernel` (in `_pallas_backward`).
// The function is the TPU kernels', not a block-by-block copy.  Per head,
// with the scores scaled in f32 (s = scale * q k^T) and the top-left causal
// mask q_pos >= k_pos (keys past seq_k and queries past seq_q never count):
//   forward   out = softmax(s) v, lse = m + log(l), online in f32,
//             out = acc / max(l, 1e-30);
//   backward  p = exp(s - lse), delta = rowsum(dout * out) (in the
//             kernel, from the saved out), ds = p * (dout v^T - delta),
//             dv = p^T dout, dk = scale * ds^T q, dq = scale * ds k.
// Every output tile has one writer (no atomics): the dkv kernel owns a
// tile of keys and loops over query tiles, the dq kernel owns a tile of
// queries and loops over key tiles, so gradients are deterministic.
//
// Bound.  Per head, the products take 2 (forward), 4 (dkv: q k^T,
// dout v^T, p^T dout, ds^T q) and 3 (dq) times 2 * S * S * D flops, halved
// by the causal mask, against a few bytes per row.  At the train path's
// shape (B*H = 192, S = 1024, D = 64, causal, bf16) the least time is set
// by bytes for K3 (0.030 ms: the products take ~85% of that at the bf16
// tensor cores' 989 TFLOP/s) and, narrowly, by bytes over operations for
// K4; in f32 it is set by operations at the CUDA cores' 67 TFLOP/s.  The
// bf16 design below answers both: every tile moves in 16-byte
// asynchronous copies that overlap the math, and the products run on the
// tensor cores; it reaches about a fifth of the bound (PERF.md).
//
// bf16: tensor-core kernels (tc::*), FlashAttention-2's design on Hopper's
// warp-level instructions.  Every product is mma.sync m16n8k16 (bf16 in,
// f32 accumulators) with operand fragments from ldmatrix (.trans where the
// operand is needed transposed).  Tiles stay bf16 in shared memory, each
// 16-byte chunk of a row XOR-swizzled by row % 8 so that ldmatrix reads
// without bank conflicts.  The streamed tiles go through a ring of two
// stages filled by 16-byte cp.async copies: the next tile's copy is
// issued before the current tile's math, rows past the end zero-fill
// (src-size 0) from a clamped address.  A warp owns 16 rows of a tile, so
// one row's softmax state lives in one quad of lanes.  The scale is
// applied in f32 to the product's sum, and exp is taken of s - m in f32;
// the probabilities (and ds) are rounded to bf16 only as an mma operand,
// from the accumulator registers (the m16n8k16 accumulator layout of two
// adjacent n8 tiles is the A layout of one k16 step).  In the backward,
// p and ds meet their products split into a bf16 high part and a bf16
// remainder, two products each: rounded once, their relative error of
// 2**-9 put dv, dk and dq 0.03125 from the f32 plain versions (one bf16
// ulp in [4, 8)), past the tolerance of 2e-2.  The
// forward's p is rounded once: its out agreed with the plain version as
// closely either way.  dkv thus runs 6 products and dq 4 where the
// function needs 4 and 3.
//   K3   a block owns 128 query rows (8 warps; D = 128: 64 rows, 4 warps)
//        and runs two to an SM, under 128 registers a thread: q stays in
//        shared memory and its fragments are reloaded for each key tile
//        (held in registers, they made the D = 64 kernel spill); the
//        causal loop stops at the diagonal, only tiles that reach it (or
//        the ragged end) mask elements, a warp skips a tile it cannot
//        see, and the heaviest query tiles start first.
//   dkv  a block owns 64 keys (4 warps of 16); k and v stay in shared
//        memory, q, dout, out and lse stream (64 queries a tile; D = 128:
//        32); s^T = k q^T and dp^T = v dout^T come out with rows = keys,
//        so p^T and ds^T feed dv += p^T dout and dk += ds^T q as they are.
//   dq   a block owns 64 queries; q, dout, out stay, k and v stream.
// f32: the SIMT kernels (flash_*): one block of 256 threads owns a 64-row
// tile, each thread a 4 x 4 block of the score tile, tiles staged in
// shared memory as f32; the products run as f32 FMAs on the CUDA cores,
// which keeps f32's precision (TF32 would keep ~3 digits).
//
// Interface: plain C functions, built with nvcc for sm_90a and loaded
// with ctypes (paddle_tpu_torch/ops/_build.py).  Each launches on the
// given stream, allocates nothing, and returns a cudaError_t as int.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// Every symbol of the port's kernel sources lives in this namespace, so
// a profiler's kernel names tell the port's kernels from PyTorch's.
namespace paddle_tpu_torch {
namespace {

constexpr int kThreads = 256;             // 16 x 16: tx = t % 16, ty = t / 16
constexpr int kTile = 64;                 // rows of every tile
constexpr int kLdp = kTile + 4;           // padded row of a 64-wide score tile
constexpr float kMaskValue = -1e30f;      // paddle_tpu's mask value

// 16-byte vector loads: 4 f32 per thread
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};

__device__ __forceinline__ void unpack(const float4& v, float* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
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

// ===========================================================================
// bf16: the tensor-core kernels
// ===========================================================================
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kKeyTile = 64;             // keys of a K/V tile (fwd, dq)
constexpr int kBwdThreads = 128;         // 4 warps of 16 rows (dkv, dq)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and lane l gets (row l / 4, columns 2 (l % 4), +1) of each
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
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) rounded to a bf16 pair, x in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}

// (x, y) = hi + lo, both bf16 pairs: lo is the remainder of hi, rounded
__device__ __forceinline__ void pack_split(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(x - hf.x, y - hf.y);
}

// Element offset of 16-byte chunk `chunk` of row `row` in a tile of rows
// of D bf16: the chunk index is XOR-ed with row % 8, so the 8 rows that
// one ldmatrix matrix reads fall in 8 distinct 16-byte bank groups.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Rows [r0, r0 + R) of a dense [n_rows, D] bf16 matrix into a swizzled
// tile, by NT threads, asynchronously; rows past n_rows are zeros (the
// copy reads nothing, from a clamped address).
template <int D, int R, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;
  static_assert(R * kChunks % NT == 0, "tile chunks per thread");
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int it = 0; it < R * kChunks / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < n_rows;
    const bf16* p =
        src + static_cast<size_t>(ok ? r0 + r : n_rows - 1) * D + c * 8;
    cp_async16(base + 2 * swz<D>(r, c), p, ok);
  }
}

// lse[r0, r0 + R) (f32) into dst asynchronously, zeros past n_rows
template <int R>
__device__ __forceinline__ void load_lse(float* dst, const float* src, int r0,
                                         int n_rows) {
  if (threadIdx.x < R) {
    const int r = r0 + threadIdx.x;
    const bool ok = r < n_rows;
    cp_async4(smem_u32(dst + threadIdx.x), src + (ok ? r : n_rows - 1), ok);
  }
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(x[i]), fy = __bfloat1622float2(y[i]);
    s += fx.x * fy.x + fx.y * fy.y;
  }
  return s;
}

// delta[r] = sum_d dout[r][d] * out[r][d] for the R rows of two swizzled
// tiles, by NT threads (NT / R adjacent lanes a row)
template <int D, int R, int NT>
__device__ __forceinline__ void row_deltas(float* delta, const bf16* do_s,
                                           const bf16* o_s) {
  constexpr int kLanes = NT / R, kPer = D / 8 / kLanes;
  static_assert(NT % R == 0 && 32 % kLanes == 0 && kPer >= 1, "delta split");
  const int r = threadIdx.x / kLanes, part = threadIdx.x % kLanes;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = part * kPer + i;
    acc += dot8(*reinterpret_cast<const uint4*>(do_s + swz<D>(r, c)),
                *reinterpret_cast<const uint4*>(o_s + swz<D>(r, c)));
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (part == 0) delta[r] = acc;
}

// A fragment (16 rows x 16 columns at chunk pair kc) of the rows
// [r0, r0 + 16) of a swizzled tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int kc) {
  const int lane = threadIdx.x % 32;
  ldsm(a, smem_u32(tile + swz<D>(r0 + (lane & 15), 2 * kc + (lane >> 4))));
}

// B fragments of two n8 tiles from 16 rows [r0, r0 + 16) of a swizzled
// [n][k] tile (k = columns, chunk pair kc): b[0..1] rows r0..r0+7,
// b[2..3] rows r0+8..r0+15 — the operand of x^T (rows are the product's n)
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int r0, int kc) {
  const int lane = threadIdx.x % 32;
  ldsm(b, smem_u32(tile + swz<D>(r0 + (lane & 7) + ((lane >> 4) << 3),
                                 2 * kc + ((lane >> 3) & 1))));
}

// B fragments of two n8 tiles (columns 16 nc .. 16 nc + 15) from 16 rows
// [r0, r0 + 16) of a swizzled [k][n] tile (rows = the product's k):
// b[0..1] columns 16 nc..+7, b[2..3] the next 8 — the operand of x
template <int D>
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* tile,
                                         int r0, int nc) {
  const int lane = threadIdx.x % 32;
  ldsm_t(b, smem_u32(tile + swz<D>(r0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                   2 * nc + (lane >> 4))));
}

// An f32 accumulator tile [16 rows x D] of a warp, rows r0.. of a swizzled
// tile, scaled by `mul` (per row half) and rounded to bf16, then written
// to the rows [row0, row0 + 16) of a dense [n_rows, D] matrix with 16-byte
// stores; rows past n_rows are not written.  Only this warp's rows of the
// staging tile are touched.
template <int D>
__device__ __forceinline__ void store_rows(bf16* stage, int r0,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1, bf16* dst,
                                           int row0, int n_rows) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(stage + swz<D>(r0 + g, dt) + 2 * t) =
        pack(acc[dt][0] * mul0, acc[dt][1] * mul0);
    *reinterpret_cast<uint32_t*>(stage + swz<D>(r0 + g + 8, dt) + 2 * t) =
        pack(acc[dt][2] * mul1, acc[dt][3] * mul1);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), c = i % (D / 8);
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(row0 + r) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<D>(r0 + r, c));
  }
}

__host__ __device__ constexpr int fwd_warps(int d) { return d == 64 ? 8 : 4; }
__host__ __device__ constexpr int dkv_q_tile(int d) {
  return d == 64 ? 64 : 32;
}

// ---------------------------------------------------------------------------
// K3: forward.  Grid (B*H, query tiles of 16 W rows), W warps.
// ---------------------------------------------------------------------------
template <int D, int W>
__global__ void __launch_bounds__(32 * W, 2) fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int sq, int sk, float scale, int causal) {
  constexpr int BR = 16 * W, BC = kKeyTile, NT = 32 * W;
  constexpr int KD = D / 16, ND = D / 8;
  extern __shared__ uint4 tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // [BR][D]; out staging
  bf16* kv_s = q_s + BR * D;                     // 2 x {k, v} [BC][D]

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;  // heavy tiles first
  const bf16* kh = k + bh * sk * D;
  const bf16* vh = v + bh * sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;        // the warp's first row in the tile
  const int row0 = q0 + wr + g;    // this lane's rows: row0, row0 + 8
  const int kv_end = causal ? min(sk, q0 + BR) : sk;
  const int n_tiles = (kv_end + BC - 1) / BC;
  const float sl2 = scale * kLog2e;  // scores in log2 units

  load_tile<D, BR, NT>(q_s, q + bh * sq * D, q0, sq);
  load_tile<D, BC, NT>(kv_s, kh, 0, sk);
  load_tile<D, BC, NT>(kv_s + BC * D, vh, 0, sk);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {  // the next tile's copy runs under this math
      bf16* nxt = kv_s + ((j + 1) & 1) * 2 * BC * D;
      load_tile<D, BC, NT>(nxt, kh, (j + 1) * BC, sk);
      load_tile<D, BC, NT>(nxt + BC * D, vh, (j + 1) * BC, sk);
    }
    cp_async_commit();
    const bf16* k_s = kv_s + (j & 1) * 2 * BC * D;
    const bf16* v_s = k_s + BC * D;
    const int k0 = j * BC;

    if (!causal || k0 <= q0 + wr + 15) {  // the warp sees this tile
      float s[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
        uint32_t qa[4];
        load_a<D>(qa, q_s, wr, kc);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          load_b<D>(b, k_s, 16 * np, kc);
          mma(s[2 * np], qa, b[0], b[1]);
          mma(s[2 * np + 1], qa, b[2], b[3]);
        }
      }

      // scale in f32, mask where the tile reaches the diagonal or the end
      const bool edge = k0 + BC > sk || (causal && k0 + BC - 1 > q0 + wr);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sl2;
          if (edge) {
            const int kp = k0 + 8 * nt + 2 * t + (e & 1);
            const int qp = row0 + 8 * (e >> 1);
            if (kp >= sk || (causal && kp > qp)) x = kMaskValue;
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];  // this lane's share of the row sum
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }

      // p = exp(s - m) in f32, as the A fragments of p v
      uint32_t pa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = exp2f(s[nt][0] - m[0]), p1 = exp2f(s[nt][1] - m[0]);
        const float p2 = exp2f(s[nt][2] - m[1]), p3 = exp2f(s[nt][3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        const int kc = nt >> 1, h = (nt & 1) * 2;
        pa[kc][h] = pack(p0, p1);
        pa[kc][h + 1] = pack(p2, p3);
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t b[4];
          load_b_t<D>(b, v_s, 16 * kc, dp);
          mma(acc[2 * dp], pa[kc], b[0], b[1]);
          mma(acc[2 * dp + 1], pa[kc], b[2], b[3]);
        }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile is in; this one is consumed
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / denom;
    const int row = row0 + 8 * r;
    if (t == 0 && row < sq) lse[bh * sq + row] = m[r] * kLn2 + logf(denom);
  }
  store_rows<D>(q_s, wr, acc, inv[0], inv[1], out + bh * sq * D, q0 + wr, sq);
}

// ---------------------------------------------------------------------------
// K4, dkv: grid (B*H, key tiles of 64), 4 warps.  The block owns 64 keys
// and loops over the BQ-query tiles that can see them.
// ---------------------------------------------------------------------------
template <int D, int BQ>
__global__ void __launch_bounds__(kBwdThreads) dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ out,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
    float scale, int causal) {
  constexpr int BC = kKeyTile, NT = kBwdThreads;
  constexpr int KD = D / 16, ND = D / 8, NQ = BQ / 8, KQ = BQ / 16;
  constexpr int kStage = 3 * BQ * D + 2 * BQ;  // bf16 elements of a stage
  extern __shared__ uint4 tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem);  // [BC][D]; dk staging
  bf16* v_s = k_s + BC * D;                      // [BC][D]; dv staging
  bf16* ring = v_s + BC * D;  // 2 x {q, dout, out [BQ][D], lse [BQ] f32}
  float* delta_s = reinterpret_cast<float*>(ring + 2 * kStage);  // [BQ]

  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * BC;
  const bf16* qh = q + bh * sq * D;
  const bf16* oh = out + bh * sq * D;
  const bf16* doh = dout + bh * sq * D;
  const float* lseh = lse + bh * sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int key0 = k0 + wr + g;  // this lane's keys: key0, key0 + 8
  // the first query tile with a row that sees key k0
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int n_tiles = q_begin < sq ? (sq - q_begin + BQ - 1) / BQ : 0;
  const float sl2 = scale * kLog2e;

  auto issue = [&](int stage, int q0) {
    bf16* st = ring + stage * kStage;
    load_tile<D, BQ, NT>(st, qh, q0, sq);
    load_tile<D, BQ, NT>(st + BQ * D, doh, q0, sq);
    load_tile<D, BQ, NT>(st + 2 * BQ * D, oh, q0, sq);
    load_lse<BQ>(reinterpret_cast<float*>(st + 3 * BQ * D), lseh, q0, sq);
  };
  load_tile<D, BC, NT>(k_s, k + bh * sk * D, k0, sk);
  load_tile<D, BC, NT>(v_s, v + bh * sk * D, k0, sk);
  if (n_tiles > 0) issue(0, q_begin);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * BQ;
    if (j + 1 < n_tiles) issue((j + 1) & 1, q0 + BQ);
    cp_async_commit();
    const bf16* q_s = ring + (j & 1) * kStage;
    const bf16* do_s = q_s + BQ * D;
    const float* lse_s = reinterpret_cast<const float*>(q_s + 3 * BQ * D);
    row_deltas<D, BQ, NT>(delta_s, do_s, q_s + 2 * BQ * D);

    // s^T = k q^T and dp^T = v dout^T: rows = the warp's 16 keys
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KD; ++kc) {
      uint32_t ka[4], va[4];
      load_a<D>(ka, k_s, wr, kc);
      load_a<D>(va, v_s, wr, kc);
#pragma unroll
      for (int np = 0; np < KQ; ++np) {
        uint32_t b[4];
        load_b<D>(b, q_s, 16 * np, kc);
        mma(st[2 * np], ka, b[0], b[1]);
        mma(st[2 * np + 1], ka, b[2], b[3]);
        load_b<D>(b, do_s, 16 * np, kc);
        mma(dpt[2 * np], va, b[0], b[1]);
        mma(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }
    __syncthreads();  // delta_s is written

    // p^T = exp(s^T - lse) and ds^T = p^T (dp^T - delta), in f32
    const bool edge = q0 + BQ > sq || (causal && q0 < k0 + wr + 15);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const int c = 8 * nt + 2 * t;  // this lane's query columns c, c + 1
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(st[nt][e] * sl2 - ((e & 1) ? ls.y : ls.x) * kLog2e);
        if (edge) {
          const int qp = q0 + c + (e & 1), kp = key0 + 8 * (e >> 1);
          if (qp >= sq || (causal && kp > qp)) p = 0.f;
        }
        dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dl.y : dl.x));
        st[nt][e] = p;
      }
    }

    // dv += p^T dout, dk += ds^T q (p and ds split in two bf16 parts)
#pragma unroll
    for (int kc = 0; kc < KQ; ++kc) {
      uint32_t ph[4], pl[4], dh[4], dlo[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* p0 = st[2 * kc + h];
        const float* d0 = dpt[2 * kc + h];
        pack_split(p0[0], p0[1], ph[2 * h], pl[2 * h]);
        pack_split(p0[2], p0[3], ph[2 * h + 1], pl[2 * h + 1]);
        pack_split(d0[0], d0[1], dh[2 * h], dlo[2 * h]);
        pack_split(d0[2], d0[3], dh[2 * h + 1], dlo[2 * h + 1]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        load_b_t<D>(b, do_s, 16 * kc, dp);
        mma(dv_acc[2 * dp], ph, b[0], b[1]);
        mma(dv_acc[2 * dp], pl, b[0], b[1]);
        mma(dv_acc[2 * dp + 1], ph, b[2], b[3]);
        mma(dv_acc[2 * dp + 1], pl, b[2], b[3]);
        load_b_t<D>(b, q_s, 16 * kc, dp);
        mma(dk_acc[2 * dp], dh, b[0], b[1]);
        mma(dk_acc[2 * dp], dlo, b[0], b[1]);
        mma(dk_acc[2 * dp + 1], dh, b[2], b[3]);
        mma(dk_acc[2 * dp + 1], dlo, b[2], b[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile is in; this one (and delta) consumed
  }

  store_rows<D>(k_s, wr, dk_acc, scale, scale, dk + bh * sk * D, k0 + wr, sk);
  store_rows<D>(v_s, wr, dv_acc, 1.f, 1.f, dv + bh * sk * D, k0 + wr, sk);
}

// ---------------------------------------------------------------------------
// K4, dq: grid (B*H, query tiles of 64), 4 warps.  The block owns 64
// queries and loops over the 64-key tiles they can see.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kBwdThreads) dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ out,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    bf16* __restrict__ dq, int sq, int sk, float scale, int causal) {
  constexpr int BQ = 64, BC = kKeyTile, NT = kBwdThreads;
  constexpr int KD = D / 16, ND = D / 8;
  extern __shared__ uint4 tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // [BQ][D]; dq staging
  bf16* do_s = q_s + BQ * D;                     // [BQ][D]
  bf16* o_s = do_s + BQ * D;                     // [BQ][D]
  bf16* kv_s = o_s + BQ * D;                     // 2 x {k, v} [BC][D]
  float* delta_s = reinterpret_cast<float*>(kv_s + 4 * BC * D);  // [BQ]

  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const bf16* kh = k + bh * sk * D;
  const bf16* vh = v + bh * sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;
  const int row0 = q0 + wr + g;  // this lane's queries: row0, row0 + 8
  const int kv_end = causal ? min(sk, q0 + BQ) : sk;
  const int n_tiles = (kv_end + BC - 1) / BC;
  const float sl2 = scale * kLog2e;

  load_tile<D, BQ, NT>(q_s, q + bh * sq * D, q0, sq);
  load_tile<D, BQ, NT>(do_s, dout + bh * sq * D, q0, sq);
  load_tile<D, BQ, NT>(o_s, out + bh * sq * D, q0, sq);
  load_tile<D, BC, NT>(kv_s, kh, 0, sk);
  load_tile<D, BC, NT>(kv_s + BC * D, vh, 0, sk);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  row_deltas<D, BQ, NT>(delta_s, do_s, o_s);
  __syncthreads();
  float ls[2], dl[2];  // lse (log2 units) and delta of this lane's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    ls[r] = row < sq ? lse[bh * sq + row] * kLog2e : 0.f;
    dl[r] = delta_s[wr + g + 8 * r];
  }

  float dq_acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    dq_acc[i][0] = dq_acc[i][1] = dq_acc[i][2] = dq_acc[i][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      bf16* nxt = kv_s + ((j + 1) & 1) * 2 * BC * D;
      load_tile<D, BC, NT>(nxt, kh, (j + 1) * BC, sk);
      load_tile<D, BC, NT>(nxt + BC * D, vh, (j + 1) * BC, sk);
    }
    cp_async_commit();
    const bf16* k_s = kv_s + (j & 1) * 2 * BC * D;
    const bf16* v_s = k_s + BC * D;
    const int k0 = j * BC;

    if (!causal || k0 <= q0 + wr + 15) {  // the warp sees this tile
      // s = q k^T and dp = dout v^T: rows = the warp's 16 queries
      float s[8][4], dp[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KD; ++kc) {
        uint32_t qa[4], da[4];
        load_a<D>(qa, q_s, wr, kc);
        load_a<D>(da, do_s, wr, kc);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          load_b<D>(b, k_s, 16 * np, kc);
          mma(s[2 * np], qa, b[0], b[1]);
          mma(s[2 * np + 1], qa, b[2], b[3]);
          load_b<D>(b, v_s, 16 * np, kc);
          mma(dp[2 * np], da, b[0], b[1]);
          mma(dp[2 * np + 1], da, b[2], b[3]);
        }
      }

      // ds = exp(s - lse) (dp - delta) in f32, as the A fragments of ds k
      // (hi and lo)
      const bool edge = k0 + BC > sk || (causal && k0 + BC - 1 > q0 + wr);
      uint32_t dh[4][4], dlo[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = exp2f(s[nt][e] * sl2 - ls[r]);
          if (edge) {
            const int kp = k0 + 8 * nt + 2 * t + (e & 1);
            if (kp >= sk || (causal && kp > row0 + 8 * r)) p = 0.f;
          }
          d[e] = p * (dp[nt][e] - dl[r]);
        }
        const int kc = nt >> 1, h = (nt & 1) * 2;
        pack_split(d[0], d[1], dh[kc][h], dlo[kc][h]);
        pack_split(d[2], d[3], dh[kc][h + 1], dlo[kc][h + 1]);
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int dp2 = 0; dp2 < D / 16; ++dp2) {
          uint32_t b[4];
          load_b_t<D>(b, k_s, 16 * kc, dp2);
          mma(dq_acc[2 * dp2], dh[kc], b[0], b[1]);
          mma(dq_acc[2 * dp2], dlo[kc], b[0], b[1]);
          mma(dq_acc[2 * dp2 + 1], dh[kc], b[2], b[3]);
          mma(dq_acc[2 * dp2 + 1], dlo[kc], b[2], b[3]);
        }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile is in; this one is consumed
  }

  store_rows<D>(q_s, wr, dq_acc, scale, scale, dq + bh * sq * D, q0 + wr, sq);
}

// shared-memory bytes of each kernel
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(bf16) * (16 * fwd_warps(D) * D + 4 * kKeyTile * D);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(bf16) * (2 * kKeyTile * D +
                         2 * (3 * dkv_q_tile(D) * D + 2 * dkv_q_tile(D))) +
         sizeof(float) * dkv_q_tile(D);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (3 * 64 * D + 4 * kKeyTile * D) + sizeof(float) * 64;
}

}  // namespace tc

// ===========================================================================
// f32 launch (SIMT kernels) and bf16 launch (tensor-core kernels)
// ===========================================================================
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

// Launch `kernel` over (bh, tiles) blocks of `threads` with `smem` bytes
// of dynamic shared memory (above the 48 KB default, so the limit is
// raised first).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int bh, int tiles, int threads,
           cudaStream_t stream, Args... args) {
  if (bh <= 0 || tiles <= 0) return 0;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(bh, tiles), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int tiles_of(int n, int tile) { return (n + tile - 1) / tile; }

using bf16 = __nv_bfloat16;
#define F32(p) static_cast<const float*>(p)
#define BF16(p) static_cast<const bf16*>(p)

// f32: the SIMT kernels
template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* out,
            void* lse, int bh, int sq, int sk, float scale, int causal,
            cudaStream_t s) {
  return launch(flash_fwd_kernel<float, D>, fwd_smem<D>(), bh,
                tiles_of(sq, kTile), kThreads, s, F32(q), F32(k), F32(v),
                static_cast<float*>(out), static_cast<float*>(lse), sq, sk,
                scale, causal);
}

template <int D>
int dkv_f32(const void* q, const void* k, const void* v, const void* out,
            const void* lse, const void* dout, void* dk, void* dv, int bh,
            int sq, int sk, float scale, int causal, cudaStream_t s) {
  return launch(flash_bwd_dkv_kernel<float, D>, dkv_smem<D>(), bh,
                tiles_of(sk, kTile), kThreads, s, F32(q), F32(k), F32(v),
                F32(out), F32(lse), F32(dout), static_cast<float*>(dk),
                static_cast<float*>(dv), sq, sk, scale, causal);
}

template <int D>
int dq_f32(const void* q, const void* k, const void* v, const void* out,
           const void* lse, const void* dout, void* dq_out, int bh, int sq,
           int sk, float scale, int causal, cudaStream_t s) {
  return launch(flash_bwd_dq_kernel<float, D>, dq_smem<D>(), bh,
                tiles_of(sq, kTile), kThreads, s, F32(q), F32(k), F32(v),
                F32(out), F32(lse), F32(dout), static_cast<float*>(dq_out),
                sq, sk, scale, causal);
}

// bf16: the tensor-core kernels
template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* out,
             void* lse, int bh, int sq, int sk, float scale, int causal,
             cudaStream_t s) {
  constexpr int W = tc::fwd_warps(D);
  return launch(tc::fwd_kernel<D, W>, tc::fwd_smem<D>(), bh,
                tiles_of(sq, 16 * W), 32 * W, s, BF16(q), BF16(k), BF16(v),
                static_cast<bf16*>(out), static_cast<float*>(lse), sq, sk,
                scale, causal);
}

template <int D>
int dkv_bf16(const void* q, const void* k, const void* v, const void* out,
             const void* lse, const void* dout, void* dk, void* dv, int bh,
             int sq, int sk, float scale, int causal, cudaStream_t s) {
  return launch(tc::dkv_kernel<D, tc::dkv_q_tile(D)>, tc::dkv_smem<D>(), bh,
                tiles_of(sk, tc::kKeyTile), tc::kBwdThreads, s, BF16(q),
                BF16(k), BF16(v), BF16(out), F32(lse), BF16(dout),
                static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, scale,
                causal);
}

template <int D>
int dq_bf16(const void* q, const void* k, const void* v, const void* out,
            const void* lse, const void* dout, void* dq_out, int bh, int sq,
            int sk, float scale, int causal, cudaStream_t s) {
  return launch(tc::dq_kernel<D>, tc::dq_smem<D>(), bh, tiles_of(sq, 64),
                tc::kBwdThreads, s, BF16(q), BF16(k), BF16(v), BF16(out),
                F32(lse), BF16(dout), static_cast<bf16*>(dq_out), sq, sk,
                scale, causal);
}

#undef F32
#undef BF16

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
    return fwd_f32<64>(q, k, v, out, lse, bh, sq, sk, scale, causal, s);
  if (dtype == 0 && head_dim == 128)
    return fwd_f32<128>(q, k, v, out, lse, bh, sq, sk, scale, causal, s);
  if (dtype == 1 && head_dim == 64)
    return fwd_bf16<64>(q, k, v, out, lse, bh, sq, sk, scale, causal, s);
  if (dtype == 1 && head_dim == 128)
    return fwd_bf16<128>(q, k, v, out, lse, bh, sq, sk, scale, causal, s);
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
    return dkv_f32<64>(q, k, v, out, lse, dout, dk, dv, bh, sq, sk, scale,
                       causal, s);
  if (dtype == 0 && head_dim == 128)
    return dkv_f32<128>(q, k, v, out, lse, dout, dk, dv, bh, sq, sk, scale,
                        causal, s);
  if (dtype == 1 && head_dim == 64)
    return dkv_bf16<64>(q, k, v, out, lse, dout, dk, dv, bh, sq, sk, scale,
                        causal, s);
  if (dtype == 1 && head_dim == 128)
    return dkv_bf16<128>(q, k, v, out, lse, dout, dk, dv, bh, sq, sk, scale,
                         causal, s);
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
    return dq_f32<64>(q, k, v, out, lse, dout, dq_out, bh, sq, sk, scale,
                      causal, s);
  if (dtype == 0 && head_dim == 128)
    return dq_f32<128>(q, k, v, out, lse, dout, dq_out, bh, sq, sk, scale,
                       causal, s);
  if (dtype == 1 && head_dim == 64)
    return dq_bf16<64>(q, k, v, out, lse, dout, dq_out, bh, sq, sk, scale,
                       causal, s);
  if (dtype == 1 && head_dim == 128)
    return dq_bf16<128>(q, k, v, out, lse, dout, dq_out, bh, sq, sk, scale,
                        causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What the compiler made of the kernel that a launch of `kernel` (0 =
// forward, 1 = dkv, 2 = dq) runs at `head_dim` and `dtype` as above:
// attrs[0] registers a thread, attrs[1] local bytes a thread (stack and
// spills), attrs[2] static and attrs[3] dynamic shared-memory bytes a
// block (the latter as the launch asks for it).  Returns a cudaError_t.
extern "C" int flash_attention_kernel_attrs(int kernel, int head_dim,
                                            int dtype, int* attrs) {
  const void* fn[2][2][3] = {
      {{reinterpret_cast<const void*>(flash_fwd_kernel<float, 64>),
        reinterpret_cast<const void*>(flash_bwd_dkv_kernel<float, 64>),
        reinterpret_cast<const void*>(flash_bwd_dq_kernel<float, 64>)},
       {reinterpret_cast<const void*>(flash_fwd_kernel<float, 128>),
        reinterpret_cast<const void*>(flash_bwd_dkv_kernel<float, 128>),
        reinterpret_cast<const void*>(flash_bwd_dq_kernel<float, 128>)}},
      {{reinterpret_cast<const void*>(tc::fwd_kernel<64, tc::fwd_warps(64)>),
        reinterpret_cast<const void*>(
            tc::dkv_kernel<64, tc::dkv_q_tile(64)>),
        reinterpret_cast<const void*>(tc::dq_kernel<64>)},
       {reinterpret_cast<const void*>(
            tc::fwd_kernel<128, tc::fwd_warps(128)>),
        reinterpret_cast<const void*>(
            tc::dkv_kernel<128, tc::dkv_q_tile(128)>),
        reinterpret_cast<const void*>(tc::dq_kernel<128>)}}};
  const size_t smem[2][2][3] = {
      {{fwd_smem<64>(), dkv_smem<64>(), dq_smem<64>()},
       {fwd_smem<128>(), dkv_smem<128>(), dq_smem<128>()}},
      {{tc::fwd_smem<64>(), tc::dkv_smem<64>(), tc::dq_smem<64>()},
       {tc::fwd_smem<128>(), tc::dkv_smem<128>(), tc::dq_smem<128>()}}};
  if (kernel < 0 || kernel > 2 || (head_dim != 64 && head_dim != 128) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, fn[dtype][head_dim == 128][kernel]);
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = a.numRegs;
  attrs[1] = static_cast<int>(a.localSizeBytes);
  attrs[2] = static_cast<int>(a.sharedSizeBytes);
  attrs[3] = static_cast<int>(smem[dtype][head_dim == 128][kernel]);
  return 0;
}

}  // namespace paddle_tpu_torch
