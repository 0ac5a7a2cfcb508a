// RoIAlign(-3D) forward and backward as gather / scatter kernels for Hopper
// (sm_90a).
//
// Replaces:
//   K1 detectandtrack_tpu/kernels/roi_align.py::roi_align_multilevel_pallas
//      (kernel body _roi_align_ml_kernel): FPN RoIAlign over slab-grouped
//      rois, entry dat_roi_align_multilevel;
//   K3 detectandtrack_tpu/kernels/roi_align.py::_roi_align_pallas (kernel
//      body _roi_align_kernel): RoIAlign over (roi, slab) pairs, entry
//      dat_roi_align_pairs;
//   and the backward of both, which the JAX package takes from XLA's vjp
//   of its dense form (_roi_align_ml_pallas_bwd, _roi_align_bwd), entry
//   dat_roi_align_backward.
// The TPU kernels DMA a fixed patch per roi into VMEM and contract it with
// two interpolation matrices on the MXU, which window-clips rois wider than
// the patch. Here every output element gathers only the 4 bilinear corners
// of each of its s*s samples, so the result is exact for every roi, with
// the semantics of roi_align_reference: roi_size = max(extent, 1), samples
// strictly outside [-1, size] count zero, in-range samples clamp to
// [0, size-1], the bin value is the mean over all s*s samples, accumulated
// in f32. K1 and K3 run the same device code: K1 derives a roi's slab from
// its row (slab = n / K), K3 reads it from a per-roi table, so the two
// agree bit for bit on the same roi.
//
// What bounds the forward on the H100: the latency of dependent gathers.
// The work is 4*s*s loads and FMAs per output element (about 2 GFLOP and
// 2 GB of corner reads for a whole box stage, S=16, K=300, P=7, C=256), far
// from the FLOP and HBM limits: the corner rows of neighbouring samples
// overlap and mostly hit L1/L2.
// Design: one block per (roi, output row) gives N*P blocks (33,600 for the
// box stage), enough to keep every SM busy; the sample coordinates and
// weights of the row are computed once into shared memory; threads run
// across channels, so in the channels-last maps each corner read of a warp
// is one contiguous run of C values. Loads are f32 or bf16, the sum is f32,
// the output has the feature dtype.
//
// The backward scatters each output gradient back to the same corners with
// f32 atomicAdd into zeroed f32 level maps (the wrapper casts them to the
// feature dtype). What bounds it: L2 atomic throughput (a naive scatter is
// 4*s*s atomics per output element, ~0.8 G for a training box stage,
// S=8, K=512, P=7, C=256). The design cuts the atomics with RoIAlign's
// separability: a block owns one output row, whose samples share their y
// rows, so it folds the row's y taps into at most 2*s distinct rows with
// summed weights (in shared memory) and, per channel, walks the row's x
// taps in increasing x with a two-cell register window, emitting one atomic
// per distinct (y row, x cell) instead of one per tap. Each warp's atomics
// hit C-contiguous addresses. The order of the atomics varies from run to
// run, so the result is not bitwise reproducible (last-ulp differences).

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

// Where roi n pools from and its row of samples: level, slab and the
// x samples of every bin plus the y samples of bin row ph, into shared
// memory (callers __syncthreads() after).
struct RoiGeometry {
  int lvl, slab, H, W;
};

__device__ __forceinline__ RoiGeometry roi_row_samples(
    const LevelTable& lv, int n_levels, const float* __restrict__ rois,
    const int* __restrict__ levels, const int* __restrict__ slabs,
    int n_slabs, int n, int K, int P, int s, int ph, Sample* xs,
    Sample* ys) {
  RoiGeometry g;
  g.lvl = levels ? min(max(levels[n], 0), n_levels - 1) : 0;
  g.slab = slabs ? min(max(slabs[n], 0), n_slabs - 1) : n / K;
  g.H = lv.h[g.lvl];
  g.W = lv.w[g.lvl];
  const float sc = lv.scale[g.lvl];
  const float x1 = __fmul_rn(rois[4 * n + 0], sc);
  const float y1 = __fmul_rn(rois[4 * n + 1], sc);
  const float x2 = __fmul_rn(rois[4 * n + 2], sc);
  const float y2 = __fmul_rn(rois[4 * n + 3], sc);
  const float bin_w = __fdiv_rn(fmaxf(__fsub_rn(x2, x1), 1.0f),
                                static_cast<float>(P));
  const float bin_h = __fdiv_rn(fmaxf(__fsub_rn(y2, y1), 1.0f),
                                static_cast<float>(P));
  for (int i = threadIdx.x; i < P * s; i += blockDim.x)
    xs[i] = axis_sample(x1, bin_w, i / s, i % s, s, g.W);
  for (int i = threadIdx.x; i < s; i += blockDim.x)
    ys[i] = axis_sample(y1, bin_h, ph, i, s, g.H);
  return g;
}

// Forward. slabs == nullptr: roi n pools from slab n / K (K1's slab-grouped
// layout); otherwise from slabs[n] (K3). levels == nullptr: level 0.
template <typename T>
__global__ void roi_align_fwd_kernel(LevelTable lv, int n_levels,
                                     const float* __restrict__ rois,
                                     const int* __restrict__ levels,
                                     const int* __restrict__ slabs,
                                     int n_slabs, T* __restrict__ out, int K,
                                     int C, int P, int s) {
  __shared__ Sample xs[kMaxSamples];
  __shared__ Sample ys[kMaxSamples];
  const int n = blockIdx.x;
  const int ph = blockIdx.y;
  const RoiGeometry g = roi_row_samples(lv, n_levels, rois, levels, slabs,
                                        n_slabs, n, K, P, s, ph, xs, ys);
  __syncthreads();

  const int W = g.W;
  const T* base = static_cast<const T*>(lv.ptr[g.lvl]) +
                  static_cast<size_t>(g.slab) * g.H * W * C;
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

// One x cell's summed gradient, spread over the block's distinct y rows.
__device__ __forceinline__ void emit_cell(float* __restrict__ base, int W,
                                          int C, int c, int x, float v,
                                          const int* yrow, const float* yw,
                                          int ny) {
  if (v == 0.0f) return;
  for (int j = 0; j < ny; ++j)
    atomicAdd(base + (static_cast<size_t>(yrow[j]) * W + x) * C + c,
              yw[j] * v);
}

// Backward: the gradient of output row (n, ph) into f32 level maps
// (lv.ptr[l] is a zeroed float array of the level's shape).
template <typename T>
__global__ void roi_align_bwd_kernel(LevelTable lv, int n_levels,
                                     const float* __restrict__ rois,
                                     const int* __restrict__ levels,
                                     const int* __restrict__ slabs,
                                     int n_slabs,
                                     const T* __restrict__ grad, int K, int C,
                                     int P, int s) {
  __shared__ Sample xs[kMaxSamples];
  __shared__ Sample ys[kMaxSamples];
  __shared__ int yrow[2 * kMaxSamples];
  __shared__ float yw[2 * kMaxSamples];
  __shared__ int ny;
  const int n = blockIdx.x;
  const int ph = blockIdx.y;
  const RoiGeometry g = roi_row_samples(lv, n_levels, rois, levels, slabs,
                                        n_slabs, n, K, P, s, ph, xs, ys);
  __syncthreads();
  if (threadIdx.x == 0) {
    // Distinct y rows of the bin row's taps, each with its summed weight
    // (the 1/s^2 mean folded in).
    const float vw = 1.0f / static_cast<float>(s * s);
    int m = 0;
    for (int iy = 0; iy < s; ++iy) {
      const Sample y = ys[iy];
      if (!y.valid) continue;
      const int cells[2] = {y.lo, y.hi};
      const float ws[2] = {y.wlo * vw, y.whi * vw};
      for (int k = 0; k < 2; ++k) {
        int j = 0;
        while (j < m && yrow[j] != cells[k]) ++j;
        if (j == m) {
          yrow[m] = cells[k];
          yw[m] = 0.0f;
          ++m;
        }
        yw[j] += ws[k];
      }
    }
    ny = m;
  }
  __syncthreads();
  if (ny == 0) return;

  const int W = g.W;
  float* base = static_cast<float*>(const_cast<void*>(lv.ptr[g.lvl])) +
                static_cast<size_t>(g.slab) * g.H * W * C;
  const T* gr = grad + (static_cast<size_t>(n) * P + ph) * P * C;

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    // The x taps arrive in non-decreasing cell order (lo of each sample,
    // then its hi = lo + 1), so a window over cells (cur, cur + 1) sees
    // every tap of a cell before it leaves the window.
    int cur = -1;
    float a0 = 0.0f, a1 = 0.0f;
    for (int pw = 0; pw < P; ++pw) {
      const float gv = to_float(gr[pw * C + c]);
      if (gv == 0.0f) continue;
      for (int ix = 0; ix < s; ++ix) {
        const Sample x = xs[pw * s + ix];
        if (!x.valid) continue;
        const int cells[2] = {x.lo, x.hi};
        const float vals[2] = {x.wlo * gv, x.whi * gv};
        for (int k = 0; k < 2; ++k) {
          const int cell = cells[k];
          if (cur < 0) {
            cur = cell;
            a0 = vals[k];
            a1 = 0.0f;
          } else if (cell == cur) {
            a0 += vals[k];
          } else if (cell == cur + 1) {
            a1 += vals[k];
          } else if (cell == cur + 2) {
            emit_cell(base, W, C, c, cur, a0, yrow, yw, ny);
            cur += 1;
            a0 = a1;
            a1 = vals[k];
          } else if (cell > cur + 2) {
            emit_cell(base, W, C, c, cur, a0, yrow, yw, ny);
            emit_cell(base, W, C, c, cur + 1, a1, yrow, yw, ny);
            cur = cell;
            a0 = vals[k];
            a1 = 0.0f;
          } else {  // behind the window: cannot happen, kept exact anyway
            emit_cell(base, W, C, c, cell, vals[k], yrow, yw, ny);
          }
        }
      }
    }
    if (cur >= 0) {
      emit_cell(base, W, C, c, cur, a0, yrow, yw, ny);
      if (cur + 1 < W) emit_cell(base, W, C, c, cur + 1, a1, yrow, yw, ny);
    }
  }
}

void make_table(const void* level_ptrs, const void* hs, const void* ws,
                const void* scales, int n_levels, LevelTable* lv) {
  for (int i = 0; i < n_levels; ++i) {
    lv->ptr[i] = static_cast<const void* const*>(level_ptrs)[i];
    lv->h[i] = static_cast<const int*>(hs)[i];
    lv->w[i] = static_cast<const int*>(ws)[i];
    lv->scale[i] = static_cast<const float*>(scales)[i];
  }
}

bool bad_args(int n_levels, int C, int P, int s, int dtype) {
  return n_levels < 1 || n_levels > kMaxLevels || P * s > kMaxSamples ||
         P < 1 || s < 1 || C < 1 || (dtype != 0 && dtype != 1);
}

int threads_for(int C) { return C >= 256 ? 256 : ((C + 31) / 32) * 32; }

int launch_forward(const void* level_ptrs, const void* hs, const void* ws,
                   const void* scales, int n_levels, const void* rois,
                   const void* levels, const void* slabs, int n_slabs,
                   void* out, int N, int K, int C, int P, int s, int dtype,
                   void* stream) {
  if (bad_args(n_levels, C, P, s, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  LevelTable lv;
  make_table(level_ptrs, hs, ws, scales, n_levels, &lv);
  const dim3 grid(N, P);
  const int threads = threads_for(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(levels);
  const int* sl = static_cast<const int*>(slabs);
  if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, threads, 0, st>>>(
        lv, n_levels, r, l, sl, n_slabs, static_cast<float*>(out), K, C, P,
        s);
  } else {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        lv, n_levels, r, l, sl, n_slabs, static_cast<__nv_bfloat16*>(out), K,
        C, P, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* dat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1. level_ptrs/hs/ws/scales: host arrays of n_levels entries; every level
// map is a contiguous (S, H_l, W_l, C) device array of the dtype (0 = f32,
// 1 = bf16). rois: (S, K, 4) f32 image coords; levels: (S, K) i32;
// out: (S, K, P, P, C) of the dtype. Returns a cudaError_t.
int dat_roi_align_multilevel(const void* level_ptrs, const void* hs,
                             const void* ws, const void* scales, int n_levels,
                             const void* rois, const void* levels, void* out,
                             int S, int K, int C, int P, int s, int dtype,
                             void* stream) {
  return launch_forward(level_ptrs, hs, ws, scales, n_levels, rois, levels,
                        nullptr, S, out, S * K, K, C, P, s, dtype, stream);
}

// K3. As K1, over N (roi, slab) pairs: rois (N, 4) f32, slabs (N,) i32
// into the S slabs of every level, levels (N,) i32 or null (level 0);
// out: (N, P, P, C).
int dat_roi_align_pairs(const void* level_ptrs, const void* hs,
                        const void* ws, const void* scales, int n_levels,
                        const void* rois, const void* slabs,
                        const void* levels, void* out, int N, int S, int C,
                        int P, int s, int dtype, void* stream) {
  return launch_forward(level_ptrs, hs, ws, scales, n_levels, rois, levels,
                        slabs, S, out, N, 1, C, P, s, dtype, stream);
}

// Backward of both: grad (N, P, P, C) of the dtype for the N rois laid out
// as in dat_roi_align_pairs, added into the zeroed f32 maps at grad_ptrs
// (each (S, H_l, W_l, C)).
int dat_roi_align_backward(const void* grad_ptrs, const void* hs,
                           const void* ws, const void* scales, int n_levels,
                           const void* rois, const void* slabs,
                           const void* levels, const void* grad, int N,
                           int S, int C, int P, int s, int dtype,
                           void* stream) {
  if (bad_args(n_levels, C, P, s, dtype) || slabs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  LevelTable lv;
  make_table(grad_ptrs, hs, ws, scales, n_levels, &lv);
  const dim3 grid(N, P);
  const int threads = threads_for(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(levels);
  const int* sl = static_cast<const int*>(slabs);
  if (dtype == 0) {
    roi_align_bwd_kernel<float><<<grid, threads, 0, st>>>(
        lv, n_levels, r, l, sl, S, static_cast<const float*>(grad), 1, C, P,
        s);
  } else {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        lv, n_levels, r, l, sl, S, static_cast<const __nv_bfloat16*>(grad), 1,
        C, P, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
