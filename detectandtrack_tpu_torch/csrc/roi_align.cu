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
// What bounds the forward on the H100: bytes. The work is 4*s*s loads
// and FMAs per output element (1.9 GFLOP for a whole box stage, S=16,
// K=300, P=7, C=256), far from the FLOP limit; the bound is the output
// (120 MB in bf16) plus the distinct map cells the rois' corners touch,
// read once. Corner rows of neighbouring samples overlap and hit L1/L2.
// Design (redesigned for 16-byte gathers): one block per roi (or per
// slice of its bins when there are too few rois to fill the card, as at
// the keypoint stage); the roi's geometry (level, slab, its P*s x and P*s
// y samples) is computed once into shared memory, and its P*P bins are
// spread over the block's 7 warps (P = 7 and 14 give whole rounds). Each
// lane owns 8 consecutive channels of a bin, so a corner read is one
// 16-byte load (bf16; two in f32) and one warp instruction covers C=256 in
// bf16. A lane issues the 4 corners of each of the s*s samples of its bin
// as independent loads (all 16 in flight at s=2), folds sample validity
// into the weights (an invalid sample still loads its clamped, in-bounds
// corners, with weight 0), keeps the f32 sum in registers in the order
// iy, ix, then the four corners, and writes its 8 outputs with one 16-byte
// store. Where C % 8 != 0 or a map is not 16-byte aligned, the same kernel
// loads each of a lane's channels (the last lane's C % 8 of them) one by
// one, in the same order: it never falls back to the plain version. Loads
// are f32 or bf16, the sum is f32, the output has the feature dtype.
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

#include <algorithm>
#include <cstddef>
#include <cstdint>

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

// Where roi n pools from and its samples: level, slab, the x samples of
// every bin and the y samples of bin rows ph .. ph + n_rows - 1, into shared
// memory (callers __syncthreads() after). The forward takes every row, the
// backward one, so both sample at the same positions.
struct RoiGeometry {
  int lvl, slab, H, W;
};

__device__ __forceinline__ RoiGeometry roi_row_samples(
    const LevelTable& lv, int n_levels, const float* __restrict__ rois,
    const int* __restrict__ levels, const int* __restrict__ slabs,
    int n_slabs, int n, int K, int P, int s, int ph, int n_rows, Sample* xs,
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
  for (int i = threadIdx.x; i < n_rows * s; i += blockDim.x)
    ys[i] = axis_sample(y1, bin_h, ph + i / s, i % s, s, g.H);
  return g;
}

// Eight consecutive channels of one map cell, as loaded: one 16-byte load
// in bf16, two in f32.
template <typename T> struct Chunk;
template <> struct Chunk<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float at(int i) const {
    const uint32_t word = i < 4 ? (i < 2 ? u.x : u.y) : (i < 6 ? u.z : u.w);
    return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
  }
};
template <> struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float at(int i) const {
    const float4& h = i < 4 ? a : b;
    const int j = i & 3;
    return j < 2 ? (j == 0 ? h.x : h.y) : (j == 2 ? h.z : h.w);
  }
};

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&b2);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// A sample's 4 corner cells (lo/hi row x lo/hi column, offsets in values)
// and their bilinear weights with the 1/s^2 mean folded in, zero for an
// invalid sample.
struct Corners {
  size_t c00, c01, c10, c11;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Corners corners(const Sample& y, const Sample& x,
                                           int W, int C, float vw) {
  Corners k;
  const size_t r0 = static_cast<size_t>(y.lo) * W;
  const size_t r1 = static_cast<size_t>(y.hi) * W;
  k.c00 = (r0 + x.lo) * C;
  k.c01 = (r0 + x.hi) * C;
  k.c10 = (r1 + x.lo) * C;
  k.c11 = (r1 + x.hi) * C;
  const bool ok = y.valid && x.valid;
  k.w00 = ok ? y.wlo * x.wlo * vw : 0.0f;
  k.w01 = ok ? y.wlo * x.whi * vw : 0.0f;
  k.w10 = ok ? y.whi * x.wlo * vw : 0.0f;
  k.w11 = ok ? y.whi * x.whi * vw : 0.0f;
  return k;
}

// One bin's 8 channels (base points at the first): the s*s samples'
// corners as 16-byte loads, all independent (kS > 0: s = kS, unrolled).
template <typename T, int kS>
__device__ __forceinline__ void bin_vec(const T* __restrict__ base, int W,
                                        int C, const Sample* ys,
                                        const Sample* xs, int s, float vw,
                                        float* acc) {
  const int ns = kS > 0 ? kS : s;
#pragma unroll
  for (int iy = 0; iy < ns; ++iy) {
#pragma unroll
    for (int ix = 0; ix < ns; ++ix) {
      const Corners k = corners(ys[iy], xs[ix], W, C, vw);
      Chunk<T> v00, v01, v10, v11;
      v00.load(base + k.c00);
      v01.load(base + k.c01);
      v10.load(base + k.c10);
      v11.load(base + k.c11);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = v00.at(i) * k.w00;
        v += v01.at(i) * k.w01;
        v += v10.at(i) * k.w10;
        v += v11.at(i) * k.w11;
        acc[i] += v;
      }
    }
  }
}

// The same sum one value at a time, for the first nch channels.
template <typename T>
__device__ __forceinline__ void bin_scalar(const T* __restrict__ base, int W,
                                           int C, const Sample* ys,
                                           const Sample* xs, int s, float vw,
                                           int nch, float* acc) {
  for (int iy = 0; iy < s; ++iy) {
    for (int ix = 0; ix < s; ++ix) {
      const Corners k = corners(ys[iy], xs[ix], W, C, vw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < nch) {
          float v = to_float(__ldg(base + k.c00 + i)) * k.w00;
          v += to_float(__ldg(base + k.c01 + i)) * k.w01;
          v += to_float(__ldg(base + k.c10 + i)) * k.w10;
          v += to_float(__ldg(base + k.c11 + i)) * k.w11;
          acc[i] += v;
        }
      }
    }
  }
}

constexpr int kFwdThreads = 224;   // 7 warps

// Forward. slabs == nullptr: roi n pools from slab n / K (K1's slab-grouped
// layout); otherwise from slabs[n] (K3). levels == nullptr: level 0. Block
// (n, j) computes bins [j * bins_per_block, ...) of roi n; vec: every map
// and the output are 16-byte aligned and C % 8 == 0.
template <typename T, int kS>
__global__ void __launch_bounds__(kFwdThreads, 2)
roi_align_fwd_kernel(LevelTable lv, int n_levels,
                     const float* __restrict__ rois,
                     const int* __restrict__ levels,
                     const int* __restrict__ slabs, int n_slabs,
                     T* __restrict__ out, int K, int C, int P, int s,
                     int bins_per_block, bool vec) {
  __shared__ Sample xs[kMaxSamples];
  __shared__ Sample ys[kMaxSamples];
  const int n = blockIdx.x;
  const RoiGeometry g = roi_row_samples(lv, n_levels, rois, levels, slabs,
                                        n_slabs, n, K, P, s, 0, P, xs, ys);
  __syncthreads();

  const int W = g.W;
  const T* base = static_cast<const T*>(lv.ptr[g.lvl]) +
                  static_cast<size_t>(g.slab) * g.H * W * C;
  T* o = out + static_cast<size_t>(n) * P * P * C;
  const float vw = 1.0f / static_cast<float>(s * s);
  const int groups = (C + 7) / 8;
  const int bin0 = blockIdx.y * bins_per_block;
  const int items = (min(bin0 + bins_per_block, P * P) - bin0) * groups;

  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int b = item / groups;
    const int c0 = 8 * (item - b * groups);
    const int bin = bin0 + b;
    const int ph = bin / P;
    const int pw = bin - ph * P;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    T* dst = o + static_cast<size_t>(bin) * C + c0;
    if (vec) {
      bin_vec<T, kS>(base + c0, W, C, ys + ph * s, xs + pw * s, s, vw, acc);
      store8(dst, acc);
    } else {
      const int nch = min(8, C - c0);
      bin_scalar<T>(base + c0, W, C, ys + ph * s, xs + pw * s, s, vw, nch,
                    acc);
      for (int i = 0; i < nch; ++i) dst[i] = from_float<T>(acc[i]);
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
                                        n_slabs, n, K, P, s, ph, 1, xs, ys);
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

template <typename T, int kS>
void launch_fwd(dim3 grid, int threads, cudaStream_t st, const LevelTable& lv,
                int n_levels, const float* r, const int* l, const int* sl,
                int n_slabs, void* out, int K, int C, int P, int s, int bpb,
                bool vec) {
  roi_align_fwd_kernel<T, kS><<<grid, threads, 0, st>>>(
      lv, n_levels, r, l, sl, n_slabs, static_cast<T*>(out), K, C, P, s, bpb,
      vec);
}

template <typename T>
void launch_fwd_s(dim3 grid, int threads, cudaStream_t st,
                  const LevelTable& lv, int n_levels, const float* r,
                  const int* l, const int* sl, int n_slabs, void* out, int K,
                  int C, int P, int s, int bpb, bool vec) {
  if (s == 2)
    launch_fwd<T, 2>(grid, threads, st, lv, n_levels, r, l, sl, n_slabs, out,
                     K, C, P, s, bpb, vec);
  else
    launch_fwd<T, 0>(grid, threads, st, lv, n_levels, r, l, sl, n_slabs, out,
                     K, C, P, s, bpb, vec);
}

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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Few rois (the keypoint stage): split each roi's bins over blocks, so
  // that about 8 blocks per SM are in flight.
  const int bins = P * P;
  const long long want = 8LL * sms;
  int split = N >= want ? 1
                        : static_cast<int>(std::min<long long>(
                              bins, (want + N - 1) / N));
  const int bpb = (bins + split - 1) / split;
  split = (bins + bpb - 1) / bpb;
  const int groups = (C + 7) / 8;
  const int threads = std::min(kFwdThreads, ((bpb * groups + 31) / 32) * 32);
  bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int i = 0; i < n_levels; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(lv.ptr[i]) % 16 == 0;
  const dim3 grid(N, split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(levels);
  const int* sl = static_cast<const int*>(slabs);
  if (dtype == 0)
    launch_fwd_s<float>(grid, threads, st, lv, n_levels, r, l, sl, n_slabs,
                        out, K, C, P, s, bpb, vec);
  else
    launch_fwd_s<__nv_bfloat16>(grid, threads, st, lv, n_levels, r, l, sl,
                                n_slabs, out, K, C, P, s, bpb, vec);
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
