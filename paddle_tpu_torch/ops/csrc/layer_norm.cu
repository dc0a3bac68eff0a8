// Row LayerNorm forward — kernel K5 of the port.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/layer_norm.py `_ln_kernel`
// (launched by `_fwd_pallas`, reached through `fused_layer_norm` when
// FLAGS_use_pallas_layernorm is on).  It computes the same function, row
// by row: the f32 mean, the f32 population variance mean((x - mean)^2)
// in a second pass over the row (as the TPU kernel does), rsqrt(var +
// eps), (x - mean) * rstd * w + b in f32 with w and b widened to f32, and
// the result cast to x's dtype.  The backward stays composed, as in JAX.
//
// Design.  The TPU kernel tiles 256 rows into VMEM per grid step; here a
// group of threads owns one row and holds it in registers, so x is read
// from device memory once and y written once.  A group is one warp for
// rows of up to 8 16-byte vectors a lane (d <= 1024 in f32, 2048 in bf16:
// GPT-2-small's d = 768 is 6 float4 a lane), with four rows to a block;
// 4 or 16 warps with a shared-memory reduction for wider rows (up to
// 16384 in f32).  Loads and stores are 16-byte vectors, neighbouring
// lanes on neighbouring addresses; w and b are read per element through
// the cache (a few KB, shared by every row).
//
// Bound.  Memory: one read of x and one write of y (w and b are a
// rounding error); the arithmetic is ~8 flops an element.
//
// Interface: a plain C function, built with nvcc for sm_90a and loaded
// with ctypes (paddle_tpu_torch/ops/_build.py).  Launches on the given
// stream, allocates nothing, returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// Every symbol of the port's kernel sources lives in this namespace, so
// a profiler's kernel names tell the port's kernels from PyTorch's.
namespace paddle_tpu_torch {
namespace {

constexpr int kMaxVecs = 8;  // 16-byte vectors a thread holds

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

__device__ __forceinline__ void pack(const float* o, float4* v) {
  *v = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void pack(const float* o, uint4* v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ constexpr int block_threads(int tpr) {
  return tpr < 128 ? 128 : tpr;
}

// Sum of v over the kTpr threads of row slot r; red holds the warps'
// partial sums when a row spans several warps (one row per block then).
template <int kTpr>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (kTpr == 32) {
    return v;
  } else {
    constexpr int kWarps = kTpr / 32;
    __syncthreads();  // the previous reduction's reads are done
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += red[i];
    return t;
  }
}

// x, y: [rows, d] of T; w, b: [d] of W.  kTpr threads per row; d a
// multiple of Vec<T>::n with d / Vec<T>::n <= kTpr * kMaxVecs.
template <typename T, typename W, int kTpr>
__global__ void __launch_bounds__(block_threads(kTpr)) layer_norm_kernel(
    const T* __restrict__ x, const W* __restrict__ w,
    const W* __restrict__ b, T* __restrict__ y, int rows, int d,
    float eps) {
  using VecT = typename Vec<T>::type;
  constexpr int kVec = Vec<T>::n;
  constexpr int kRowsPerBlock = block_threads(kTpr) / kTpr;
  __shared__ float red[kTpr / 32];

  const int t = threadIdx.x % kTpr;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kTpr;
  // only a one-warp row group can run past the end (several rows to a
  // block); it exits whole, and syncs no block
  if (row >= rows) return;
  const int nvec = d / kVec;
  const VecT* xr = reinterpret_cast<const VecT*>(
      x + static_cast<size_t>(row) * d);
  VecT* yr = reinterpret_cast<VecT*>(y + static_cast<size_t>(row) * d);

  float v[kMaxVecs][kVec];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int c = t + i * kTpr;
    if (c < nvec) {
      unpack(xr[c], v[i]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) sum += v[i][e];
    }
  }
  const float mean = row_sum<kTpr>(sum, red) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    if (t + i * kTpr < nvec) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float dv = v[i][e] - mean;
        sq += dv * dv;
      }
    }
  }
  const float rstd = rsqrtf(row_sum<kTpr>(sq, red) / d + eps);
#pragma unroll
  for (int i = 0; i < kMaxVecs; ++i) {
    const int c = t + i * kTpr;
    if (c < nvec) {
      float o[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int col = c * kVec + e;
        o[e] = (v[i][e] - mean) * rstd * to_f32(w[col]) + to_f32(b[col]);
      }
      pack(o, &yr[c]);
    }
  }
}

template <typename T, typename W, int kTpr>
void launch(const void* x, const void* w, const void* b, void* y, int rows,
            int d, float eps, cudaStream_t stream) {
  constexpr int kRowsPerBlock = block_threads(kTpr) / kTpr;
  const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_kernel<T, W, kTpr><<<grid, block_threads(kTpr), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const W*>(b), static_cast<T*>(y), rows, d, eps);
}

template <typename T, typename W>
int launch_width(const void* x, const void* w, const void* b, void* y,
                 int rows, int d, float eps, cudaStream_t stream) {
  constexpr int kVec = Vec<T>::n;
  if (d <= 0 || d % kVec) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = d / kVec;
  if (nvec <= 32 * kMaxVecs) {
    launch<T, W, 32>(x, w, b, y, rows, d, eps, stream);
  } else if (nvec <= 128 * kMaxVecs) {
    launch<T, W, 128>(x, w, b, y, rows, d, eps, stream);
  } else if (nvec <= 512 * kMaxVecs) {
    launch<T, W, 512>(x, w, b, y, rows, d, eps, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype, w_dtype: 0 = float32, 1 = bfloat16 (w and b share w_dtype).
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, int rows, int d, float eps,
                              int x_dtype, int w_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_width<float, float>(x, w, b, y, rows, d, eps, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_width<float, __nv_bfloat16>(x, w, b, y, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_width<__nv_bfloat16, float>(x, w, b, y, rows, d, eps, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_width<__nv_bfloat16, __nv_bfloat16>(x, w, b, y, rows, d,
                                                      eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace paddle_tpu_torch
