// FPN RoIAlign(-3D) forward as a gather kernel for Hopper (sm_90a).
//
// Replaces: detectandtrack_tpu/kernels/roi_align.py::roi_align_multilevel_pallas
// (kernel body _roi_align_ml_kernel). The TPU kernel DMAs a 64x64 patch per
// roi into VMEM and contracts it with two interpolation matrices on the MXU,
// which window-clips rois wider than the patch. Here every output element
// gathers only the 4 bilinear corners of each of its s*s samples, so the
// result is exact for every roi, with the semantics of roi_align_reference:
// roi_size = max(extent, 1), samples strictly outside [-1, size] count zero,
// in-range samples clamp to [0, size-1], the bin value is the mean over all
// s*s samples, accumulated in f32.
//
// What bounds it on the H100: the latency of dependent gathers. The work is
// 4*s*s loads and FMAs per output element (about 2 GFLOP and 2 GB of corner
// reads for a whole box stage, S=16, K=300, P=7, C=256), far from the
// FLOP and HBM limits: the corner rows of neighbouring samples overlap and
// mostly hit L1/L2.
// Design: one block per (slab, roi, output row) gives S*K*P blocks (33,600
// for the box stage), enough to keep every SM busy; the sample coordinates
// and weights of the row are computed once into shared memory; threads run
// across channels, so in the channels-last maps each corner read of a warp
// is one contiguous run of C values. Loads are f32 or bf16, the sum is f32,
// the output has the feature dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // output_size * sampling_ratio per axis

struct LevelTable {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
};

struct Sample {
  int lo, hi;
  float wlo, whi;
  bool valid;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sample i of bin `bin` along one axis. The _rn intrinsics keep the
// reference's f32 operation order (no FMA contraction), so the sample
// positions are bit-identical to the plain version's.
__device__ __forceinline__ Sample axis_sample(float start, float bin_size,
                                              int bin, int i, int s,
                                              int size) {
  const float off = __fadd_rn(static_cast<float>(bin),
                              __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                                        static_cast<float>(s)));
  const float c = __fadd_rn(start, __fmul_rn(off, bin_size));
  Sample out;
  out.valid = (c >= -1.0f) && (c <= static_cast<float>(size));
  const float cc = fminf(fmaxf(c, 0.0f), static_cast<float>(size - 1));
  const float f0 = floorf(cc);
  const float w1 = __fsub_rn(cc, f0);
  out.lo = static_cast<int>(f0);
  out.hi = min(out.lo + 1, size - 1);
  out.wlo = __fsub_rn(1.0f, w1);
  out.whi = w1;
  return out;
}

template <typename T>
__global__ void roi_align_ml_kernel(LevelTable lv, int n_levels,
                                    const float* __restrict__ rois,
                                    const int* __restrict__ levels,
                                    T* __restrict__ out, int K, int C, int P,
                                    int s) {
  __shared__ Sample xs[kMaxSamples];
  __shared__ Sample ys[kMaxSamples];
  const int n = blockIdx.x;  // slab * K + roi
  const int ph = blockIdx.y;
  const int slab = n / K;

  const int lvl = min(max(levels[n], 0), n_levels - 1);
  const int H = lv.h[lvl];
  const int W = lv.w[lvl];
  const float sc = lv.scale[lvl];
  const float x1 = __fmul_rn(rois[4 * n + 0], sc);
  const float y1 = __fmul_rn(rois[4 * n + 1], sc);
  const float x2 = __fmul_rn(rois[4 * n + 2], sc);
  const float y2 = __fmul_rn(rois[4 * n + 3], sc);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f),
                                static_cast<float>(P));
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f),
                                static_cast<float>(P));

  for (int i = threadIdx.x; i < P * s; i += blockDim.x)
    xs[i] = axis_sample(x1, bin_w, i / s, i % s, s, W);
  for (int i = threadIdx.x; i < s; i += blockDim.x)
    ys[i] = axis_sample(y1, bin_h, ph, i, s, H);
  __syncthreads();

  const T* base = static_cast<const T*>(lv.ptr[lvl]) +
                  static_cast<size_t>(slab) * H * W * C;
  T* o = out + (static_cast<size_t>(n) * P + ph) * P * C;
  const float vw = 1.0f / static_cast<float>(s * s);

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int pw = 0; pw < P; ++pw) {
      float acc = 0.0f;
      for (int iy = 0; iy < s; ++iy) {
        const Sample y = ys[iy];
        if (!y.valid) continue;
        const T* r0 = base + static_cast<size_t>(y.lo) * W * C + c;
        const T* r1 = base + static_cast<size_t>(y.hi) * W * C + c;
        for (int ix = 0; ix < s; ++ix) {
          const Sample x = xs[pw * s + ix];
          if (!x.valid) continue;
          const size_t xl = static_cast<size_t>(x.lo) * C;
          const size_t xh = static_cast<size_t>(x.hi) * C;
          float v = to_float(__ldg(r0 + xl)) * (y.wlo * x.wlo * vw);
          v += to_float(__ldg(r0 + xh)) * (y.wlo * x.whi * vw);
          v += to_float(__ldg(r1 + xl)) * (y.whi * x.wlo * vw);
          v += to_float(__ldg(r1 + xh)) * (y.whi * x.whi * vw);
          acc += v;
        }
      }
      o[pw * C + c] = from_float<T>(acc);
    }
  }
}

}  // namespace

extern "C" {

const char* dat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// level_ptrs/hs/ws/scales: host arrays of n_levels entries; every level map
// is a contiguous (S, H_l, W_l, C) device array of the dtype (0 = f32,
// 1 = bf16). rois: (S, K, 4) f32 image coords; levels: (S, K) i32;
// out: (S, K, P, P, C) of the dtype. Returns a cudaError_t.
int dat_roi_align_multilevel(const void* level_ptrs, const void* hs,
                             const void* ws, const void* scales, int n_levels,
                             const void* rois, const void* levels, void* out,
                             int S, int K, int C, int P, int s, int dtype,
                             void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || P * s > kMaxSamples ||
      P < 1 || s < 1 || C < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S * K == 0) return 0;
  LevelTable lv;
  for (int i = 0; i < n_levels; ++i) {
    lv.ptr[i] = static_cast<const void* const*>(level_ptrs)[i];
    lv.h[i] = static_cast<const int*>(hs)[i];
    lv.w[i] = static_cast<const int*>(ws)[i];
    lv.scale[i] = static_cast<const float*>(scales)[i];
  }
  const dim3 grid(S * K, P);
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(levels);
  if (dtype == 0) {
    roi_align_ml_kernel<float><<<grid, threads, 0, st>>>(
        lv, n_levels, r, l, static_cast<float*>(out), K, C, P, s);
  } else {
    roi_align_ml_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        lv, n_levels, r, l, static_cast<__nv_bfloat16*>(out), K, C, P, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
