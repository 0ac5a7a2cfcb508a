// conv1 of the inflated ResNet (7x7, stride 2, pad 3, t temporal taps) as a
// direct convolution for Hopper (sm_90a).
//
// Replaces: detectandtrack_tpu/kernels/conv1.py::conv1_s2d_pallas (kernel
// body _conv1_kernel). The TPU kernel folds the 7x7xt window into the MXU
// contraction through a space-to-depth relayout prepared by XLA, and needs
// even H, W and an aligned row block. Here a block reads its input window
// straight from the (B, T, H, W, 3) clip, zero-filling the temporal
// ((t-1)//2, t//2) and spatial (3, 3) padding itself, so any H, W and T work.
//
// What bounds it on the H100: arithmetic. conv1 is 2*441*64 FLOP per output
// pixel (about 0.24 TFLOP for a B=2, T=8, 800x1344 clip) on only 3 input
// channels, which leaves a tensor-core product a 3-wide contraction per tap;
// this first version runs the FMAs on the CUDA cores in f32.
// Design: the whole t*7*7*3 x 64 weight slab (56 KB in bf16 at t=3, 113 KB
// in f32) and the tile's input window live in dynamic shared memory, loaded
// once per block. A block computes an 8x32 tile of output pixels x 64
// channels with 256 threads; each thread owns 4 neighbouring pixels x 16
// channels, so every 16-channel weight vector read from shared memory feeds
// 64 FMAs. Accumulation is f32, the output has the input dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTH = 8;      // output rows per block
constexpr int kTW = 32;     // output columns per block
constexpr int kCout = 64;
constexpr int kCin = 3;
constexpr int kK = 7;
constexpr int kPix = 4;     // output pixels per thread (along a row)
constexpr int kCh = 16;     // output channels per thread
constexpr int kThreads = (kTH * kTW / kPix) * (kCout / kCh);  // 256
constexpr int kWinH = 2 * kTH + kK - 2;  // input rows a tile reads (21)
constexpr int kWinW = 2 * kTW + kK - 2;  // input columns a tile reads (69)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = q[i];
    v[4 * i + 0] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = q[i];
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat162 b2;
      *reinterpret_cast<uint32_t*>(&b2) = words[j];
      const float2 f = __bfloat1622float2(b2);
      v[8 * i + 2 * j + 0] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t words[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b2 =
          __floats2bfloat162_rn(v[8 * i + 2 * j], v[8 * i + 2 * j + 1]);
      words[j] = *reinterpret_cast<const uint32_t*>(&b2);
    }
    q[i] = make_uint4(words[0], words[1], words[2], words[3]);
  }
}

template <typename T>
size_t smem_bytes(int t) {
  return (static_cast<size_t>(t) * kK * kK * kCin * kCout +
          static_cast<size_t>(t) * kWinH * kWinW * kCin) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1_kernel(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ out, int nT, int H, int W, int Ho, int Wo,
             int t) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wn = t * kK * kK * kCin * kCout;
  T* w_s = reinterpret_cast<T*>(smem_raw);
  T* x_s = w_s + wn;

  const int bt = blockIdx.z;  // b * nT + tau
  const int b = bt / nT;
  const int tau = bt % nT;
  const int oy0 = blockIdx.y * kTH;
  const int ox0 = blockIdx.x * kTW;

  // Weight slab: a contiguous copy in 16-byte words.
  {
    const int words = wn * static_cast<int>(sizeof(T)) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(w);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    for (int i = threadIdx.x; i < words; i += blockDim.x) dst[i] = src[i];
  }
  // Input window (t, kWinH, kWinW, 3), zero outside the clip.
  {
    const int pad_t = (t - 1) / 2;
    const int row_len = kWinW * kCin;
    const int total = t * kWinH * row_len;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / row_len;
      const int e = i - r * row_len;
      const int kt = r / kWinH;
      const int wy = r - kt * kWinH;
      const int f = tau + kt - pad_t;
      const int iy = 2 * oy0 - 3 + wy;
      const int ix = 2 * ox0 - 3 + e / kCin;
      T v = zero<T>();
      if (f >= 0 && f < nT && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = x[((static_cast<size_t>(b) * nT + f) * H + iy) * W * kCin +
              static_cast<size_t>(ix) * kCin + (e % kCin)];
      x_s[i] = v;
    }
  }
  __syncthreads();

  const int cg = threadIdx.x % (kCout / kCh);  // channel group
  const int pg = threadIdx.x / (kCout / kCh);  // pixel group
  const int r = pg / (kTW / kPix);             // tile row
  const int cx0 = (pg % (kTW / kPix)) * kPix;  // first tile column

  float acc[kPix][kCh];
#pragma unroll
  for (int j = 0; j < kPix; ++j)
#pragma unroll
    for (int q = 0; q < kCh; ++q) acc[j][q] = 0.0f;

  for (int kt = 0; kt < t; ++kt) {
    for (int ky = 0; ky < kK; ++ky) {
      const T* xrow = x_s + ((kt * kWinH + 2 * r + ky) * kWinW) * kCin;
      const T* wrow = w_s + ((kt * kK + ky) * kK) * kCin * kCout + cg * kCh;
#pragma unroll
      for (int kx = 0; kx < kK; ++kx) {
#pragma unroll
        for (int ci = 0; ci < kCin; ++ci) {
          float wv[kCh];
          load16(wrow + (kx * kCin + ci) * kCout, wv);
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            const float xv = to_float(xrow[(2 * (cx0 + j) + kx) * kCin + ci]);
#pragma unroll
            for (int q = 0; q < kCh; ++q) acc[j][q] = fmaf(xv, wv[q], acc[j][q]);
          }
        }
      }
    }
  }

  const int oy = oy0 + r;
  if (oy >= Ho) return;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int ox = ox0 + cx0 + j;
    if (ox < Wo)
      store16(out + ((static_cast<size_t>(bt) * Ho + oy) * Wo + ox) * kCout +
                  cg * kCh,
              acc[j]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int nT, int H,
           int W, int t, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(t);
  cudaError_t err = cudaFuncSetAttribute(
      conv1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Ho = (H + 1) / 2;
  const int Wo = (W + 1) / 2;
  const dim3 grid((Wo + kTW - 1) / kTW, (Ho + kTH - 1) / kTH, B * nT);
  conv1_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      nT, H, W, Ho, Wo, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* dat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one block needs (0 = f32, 1 = bf16); the caller
// rejects t whose slab does not fit the 227 KB a block may use.
long long dat_conv1_smem_bytes(int t, int dtype) {
  return dtype == 0 ? static_cast<long long>(smem_bytes<float>(t))
                    : static_cast<long long>(smem_bytes<__nv_bfloat16>(t));
}

// x: contiguous (B, T, H, W, 3); w: contiguous (t, 7, 7, 3, 64), 16-byte
// aligned; out: (B, T, ceil(H/2), ceil(W/2), 64); all of the dtype
// (0 = f32, 1 = bf16). Returns a cudaError_t.
int dat_conv1(const void* x, const void* w, void* out, int B, int nT, int H,
              int W, int t, int dtype, void* stream) {
  if (t < 1 || B < 1 || nT < 1 || H < 1 || W < 1 || B * nT > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, w, out, B, nT, H, W, t, st)
                    : launch<__nv_bfloat16>(x, w, out, B, nT, H, W, t, st);
}

}  // extern "C"
