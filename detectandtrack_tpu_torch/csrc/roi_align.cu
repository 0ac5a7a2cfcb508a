// RoIAlign(-3D) forward and backward as gather kernels for Hopper (sm_90a).
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
//   dat_roi_align_backward_prep and dat_roi_align_backward.
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
// The backward (redesigned for Hopper) is a gather in which every map cell
// has one owner: no atomics on the maps, no f32 scratch, no cast pass. Its
// bound is bytes: the level maps written once in the feature dtype (366 MB
// in bf16 for a training box stage, S=8 over the four FPN levels of an
// 800x1344 clip, C=256) plus the gradient read (103 MB at K=512, P=7).
// What holds it back on the H100 is the chain of dependent steps each
// visited (tile, pairs) group pays (the pairs' samples, their weights,
// the gradient staging, the sums, with a barrier between each), not bytes
// or operations. Two launches and a sort:
//   roi_align_bwd_prep_kernel, a thread per (roi, slab) pair: its key
//     slab * L + level, its samples on both axes (the forward's
//     axis_sample, validity folded into the weights), and its footprint,
//     the cell box of the bilinear corners of its valid samples widened by
//     one cell on every side (a footprint too narrow would drop gradient
//     silently; one cell of slack costs a little work);
//   the wrapper sorts the pairs by key (stable) and finds each key's
//     segment (torch.sort, searchsorted);
//   roi_align_bwd_kernel: one block owns an 8x8 map tile of one (slab,
//     level) and 128 channels; warp w owns tile column w, lane l its 8
//     rows x channels 4l .. 4l + 3 as f32 registers. The block walks its
//     segment in sorted order, keeps the pairs whose footprint meets the
//     tile (a ballot compaction, 256 at a time), and, 8 pairs at a time,
//     loads their samples and builds their separable weights in shared
//     memory: Wy[bin row][tile row] and Wx[tile column][bin column], the
//     sum of wlo / whi over the samples landing on each cell with 1/s
//     folded into each side (exact: the plain version's weight is
//     wy * wx * [valid(y) and valid(x)] / s^2), with each pair's nonzero
//     bin rectangle over the tile (shared-memory integer min / max). It
//     stages those bins of the gradient as f32 in shared memory, all lanes
//     loading 16 bytes at once (in rounds when they do not fit; a pair
//     too large splits by bin rows), and each warp, whose weights are then
//     warp-uniform, adds per bin row Wy x (sum over its column's bins of
//     Wx x grad) into its rows, skipping rows of zero weight.
// At the end every cell is written once, in the feature dtype (bf16
// rounded to nearest from the f32 sum, as .to() does); tiles that no pair
// meets write zeros. Every cell sums its pairs in key order, then bin row,
// then bin column, so two calls agree bit for bit. Where C % 8 != 0 or a
// pointer is not 16-byte aligned, staging and the store go channel by
// channel, in the same order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
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

// Roi n's first corner and bin size on a level of scale sc:
// max(extent, 1) / P as the plain version computes it (a NaN extent stays
// NaN, as torch's clamp leaves it, so every sample is invalid).
struct RoiBox {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ float at_least_one(float v) {
  return v < 1.0f ? 1.0f : v;
}

__device__ __forceinline__ RoiBox roi_box(const float* __restrict__ rois,
                                          int n, float sc, int P) {
  RoiBox b;
  b.x1 = __fmul_rn(rois[4 * n + 0], sc);
  b.y1 = __fmul_rn(rois[4 * n + 1], sc);
  const float x2 = __fmul_rn(rois[4 * n + 2], sc);
  const float y2 = __fmul_rn(rois[4 * n + 3], sc);
  b.bin_w = __fdiv_rn(at_least_one(__fsub_rn(x2, b.x1)),
                      static_cast<float>(P));
  b.bin_h = __fdiv_rn(at_least_one(__fsub_rn(y2, b.y1)),
                      static_cast<float>(P));
  return b;
}

// Where roi n pools from and its samples: level, slab, the x and y samples
// of every bin, into shared memory (callers __syncthreads() after).
struct RoiGeometry {
  int lvl, slab, H, W;
};

__device__ __forceinline__ RoiGeometry roi_samples(
    const LevelTable& lv, int n_levels, const float* __restrict__ rois,
    const int* __restrict__ levels, const int* __restrict__ slabs,
    int n_slabs, int n, int K, int P, int s, Sample* xs, Sample* ys) {
  RoiGeometry g;
  g.lvl = levels ? min(max(levels[n], 0), n_levels - 1) : 0;
  g.slab = slabs ? min(max(slabs[n], 0), n_slabs - 1) : n / K;
  g.H = lv.h[g.lvl];
  g.W = lv.w[g.lvl];
  const RoiBox b = roi_box(rois, n, lv.scale[g.lvl], P);
  for (int i = threadIdx.x; i < P * s; i += blockDim.x) {
    xs[i] = axis_sample(b.x1, b.bin_w, i / s, i % s, s, g.W);
    ys[i] = axis_sample(b.y1, b.bin_h, i / s, i % s, s, g.H);
  }
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
  const RoiGeometry g = roi_samples(lv, n_levels, rois, levels, slabs,
                                    n_slabs, n, K, P, s, xs, ys);
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

// One axis of a pair: its P*s samples into out (lo and hi as int bits,
// then wlo and whi, zero when the sample is invalid), and its footprint,
// the cells [lo, hi] that the corners of the valid samples touch, widened
// by one cell on each side and clamped to the map, as the half-open
// [*a, *b); a == b == 0 when no sample is valid. The footprint mirrors
// backward_footprint in kernels/roi_align.py.
__device__ __forceinline__ void axis_footprint(float start, float bin_size,
                                               int P, int s, int size,
                                               float4* __restrict__ out,
                                               int* a, int* b) {
  int lo = INT_MAX, hi = -1;
  for (int i = 0; i < P * s; ++i) {
    const Sample smp = axis_sample(start, bin_size, i / s, i % s, s, size);
    out[i] = make_float4(__int_as_float(smp.lo), __int_as_float(smp.hi),
                         smp.valid ? smp.wlo : 0.0f,
                         smp.valid ? smp.whi : 0.0f);
    if (!smp.valid) continue;
    lo = min(lo, smp.lo);
    hi = max(hi, smp.hi);
  }
  *a = hi < 0 ? 0 : max(lo - 1, 0);
  *b = hi < 0 ? 0 : min(hi + 2, size);
}

// Backward, first launch: pair n's key (slab * n_levels + level, both
// clamped as the forward clamps them), footprint (y0, y1, x0, x1),
// half-open, all zero when the pair has no valid sample on either axis,
// and samples [n][axis (y, x)][P * s] on its level.
__global__ void roi_align_bwd_prep_kernel(LevelTable lv, int n_levels,
                                          const float* __restrict__ rois,
                                          const int* __restrict__ levels,
                                          const int* __restrict__ slabs,
                                          int n_slabs, int N, int P, int s,
                                          int* __restrict__ keys,
                                          int4* __restrict__ footprints,
                                          float4* __restrict__ samples) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int lvl = levels ? min(max(levels[n], 0), n_levels - 1) : 0;
  const int slab = min(max(slabs[n], 0), n_slabs - 1);
  const RoiBox b = roi_box(rois, n, lv.scale[lvl], P);
  int y0, y1, x0, x1;
  float4* out = samples + static_cast<size_t>(n) * 2 * P * s;
  axis_footprint(b.y1, b.bin_h, P, s, lv.h[lvl], out, &y0, &y1);
  axis_footprint(b.x1, b.bin_w, P, s, lv.w[lvl], out + P * s, &x0, &x1);
  keys[n] = slab * n_levels + lvl;
  footprints[n] = (y0 == y1 || x0 == x1) ? make_int4(0, 0, 0, 0)
                                         : make_int4(y0, y1, x0, x1);
}

constexpr int kTile = 8;         // a block owns kTile x kTile map cells
constexpr int kCG = 32;          // 4-channel groups a block: 128 channels
constexpr int kCS = 4 * kCG;     // channels a block
constexpr int kBwdThreads = kCG * kTile;  // a warp per tile column
constexpr int kGroupPairs = 8;   // pairs whose weights are built together
constexpr int kStageBytes = 32 * 1024;  // staged gradient per round (least)

// The level maps' pointers (the outputs) and shapes, and the first block
// of each level's tiles (level l owns blocks tile_off[l] .. tile_off[l+1]).
struct BwdTable {
  LevelTable lv;
  int tile_off[kMaxLevels + 1];
};

// Bins of the staging buffer (f32, kCS channels a bin): kStageBytes, and
// at least one bin row.
__host__ __device__ inline int stage_bins(int P) {
  const int bins = kStageBytes / (kCS * static_cast<int>(sizeof(float)));
  return bins > P ? bins : P;
}

// The gather's dynamic shared memory: the samples and weights of
// kGroupPairs pairs, then the staging buffer.
__host__ __device__ inline size_t bwd_dynamic_smem(int P, int s) {
  return (static_cast<size_t>(kGroupPairs) * 2 * P * s * sizeof(float4) +
          static_cast<size_t>(kGroupPairs) * 2 * kTile * P * sizeof(float) +
          static_cast<size_t>(stage_bins(P)) * kCS * sizeof(float));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&b));
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Eight channels of the gradient into the f32 staging buffer.
__device__ __forceinline__ void stage8(float* dst, const __nv_bfloat16* src) {
  Chunk<__nv_bfloat16> c;
  c.load(src);
  reinterpret_cast<float4*>(dst)[0] = make_float4(c.at(0), c.at(1), c.at(2),
                                                  c.at(3));
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.at(4), c.at(5), c.at(6),
                                                  c.at(7));
}
__device__ __forceinline__ void stage8(float* dst, const float* src) {
  const float4* v = reinterpret_cast<const float4*>(src);
  reinterpret_cast<float4*>(dst)[0] = __ldg(v);
  reinterpret_cast<float4*>(dst)[1] = __ldg(v + 1);
}

// Backward, second launch. Block (tile, slice) owns one 8x8 tile of one
// (slab, level) and channels [128 * slice, 128 * slice + 128): warp w owns
// tile column w, lane l its 8 rows and channels 4l .. 4l + 3 (f32
// registers). It writes every cell of its tile once. footprints and order:
// the pairs sorted by key (stable); seg_off[key]: the first of key's pairs
// in that order (n_slabs * n_levels + 1 entries); samples: the prep
// kernel's, by pair.
template <typename TG, typename TO>
__global__ void __launch_bounds__(kBwdThreads, 4)
roi_align_bwd_kernel(BwdTable t, int n_levels,
                     const long long* __restrict__ order,
                     const int* __restrict__ seg_off,
                     const int4* __restrict__ footprints,
                     const float4* __restrict__ samples,
                     const TG* __restrict__ grad, int C, int P, int s,
                     bool vec) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int ps = P * s;
  float4* smp = reinterpret_cast<float4*>(dyn);    // [G][2][ps] samples
  // Wy [G][P][8 rows] (a bin's row weights together), Wx [G][8 cols][P].
  float* wy_all = reinterpret_cast<float*>(smp + kGroupPairs * 2 * ps);
  float* wx_all = wy_all + kGroupPairs * P * kTile;
  float* stage = wx_all + kGroupPairs * kTile * P;
  __shared__ int first[kGroupPairs][kTile];  // each column's nonzero bins
  __shared__ int last[kGroupPairs][kTile];
  __shared__ int rect[kGroupPairs][4];  // YA, YZ, XA, XZ over the tile
  __shared__ int hits[kBwdThreads];
  __shared__ int warp_hits[kBwdThreads / 32];

  // Which tile: level, slab, first row and column.
  int b = blockIdx.x;
  int lvl = 0;
  while (lvl + 1 < n_levels && b >= t.tile_off[lvl + 1]) ++lvl;
  b -= t.tile_off[lvl];
  const int H = t.lv.h[lvl], W = t.lv.w[lvl];
  const int tiles_x = (W + kTile - 1) / kTile;
  const int per_slab = ((H + kTile - 1) / kTile) * tiles_x;
  const int slab = b / per_slab;
  const int ty0 = ((b % per_slab) / tiles_x) * kTile;
  const int tx0 = ((b % per_slab) % tiles_x) * kTile;
  const int key = slab * n_levels + lvl;
  const int seg0 = seg_off[key], seg1 = seg_off[key + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31, col = tid >> 5;
  const int cbase = blockIdx.y * kCS;
  const int c0 = cbase + 4 * lane;
  const bool active = c0 < C;
  const int cap = stage_bins(P);
  const float inv_s = __frcp_rn(static_cast<float>(s));
  float acc[kTile][4];
#pragma unroll
  for (int k = 0; k < kTile; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[k][i] = 0.0f;

  for (int base = seg0; base < seg1; base += kBwdThreads) {
    // The pairs of this chunk whose footprint meets the tile, in order.
    int total;
    {
      const int i = base + tid;
      bool hit = false;
      int n = 0;
      if (i < seg1) {
        const int4 f = footprints[i];
        n = static_cast<int>(order[i]);
        hit = f.x < ty0 + kTile && f.y > ty0 && f.z < tx0 + kTile &&
              f.w > tx0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) warp_hits[col] = __popc(m);
      __syncthreads();
      int before = 0;
      total = 0;
      for (int w = 0; w < kBwdThreads / 32; ++w) {
        before += w < col ? warp_hits[w] : 0;
        total += warp_hits[w];
      }
      if (hit) hits[before + __popc(m & ((1u << lane) - 1u))] = n;
      __syncthreads();
    }

    for (int g0 = 0; g0 < total; g0 += kGroupPairs) {
      const int ng = min(kGroupPairs, total - g0);
      // The prep kernel's samples of ng pairs, both axes, into shared
      // memory, all lanes at once; ranges start empty.
      for (int it = tid; it < ng * 2 * ps; it += kBwdThreads) {
        const int g = it / (2 * ps);
        smp[it] = __ldg(samples + static_cast<size_t>(hits[g0 + g]) * 2 * ps +
                        (it - g * 2 * ps));
      }
      if (tid < ng * kTile) {
        (&first[0][0])[tid] = P;
        (&last[0][0])[tid] = -1;
      }
      if (tid < ng * 4) (&rect[0][0])[tid] = (tid & 1) ? -1 : P;
      __syncthreads();
      // Their separable weights, one (pair, axis, tile row or column, bin)
      // a lane: Wy on the tile's rows, Wx on its columns (1/s folded in),
      // with the first and last bin of nonzero weight per column and over
      // the tile (integer min / max: the same whatever the order).
      for (int it = tid; it < ng * 2 * kTile * P; it += kBwdThreads) {
        const int p = it % P;
        const int r = (it / P) % kTile;
        const int ga = it / (P * kTile);             // g * 2 + axis
        const int g = ga >> 1, axis = ga & 1;
        const int cell = (axis == 0 ? ty0 : tx0) + r;
        const float4* xs = smp + ga * ps + p * s;
        float w = 0.0f;
        for (int j = 0; j < s; ++j) {
          const float4 x = xs[j];
          if (__float_as_int(x.x) == cell) w += x.z;
          if (__float_as_int(x.y) == cell) w += x.w;
        }
        w *= inv_s;
        if (axis == 0) {
          wy_all[(g * P + p) * kTile + r] = w;
        } else {
          wx_all[(g * kTile + r) * P + p] = w;
          if (w != 0.0f) {
            atomicMin(&first[g][r], p);
            atomicMax(&last[g][r], p);
          }
        }
        if (w != 0.0f) {
          atomicMin(&rect[g][2 * axis], p);
          atomicMax(&rect[g][2 * axis + 1], p);
        }
      }
      __syncthreads();

      // Rounds: bin rows of the pairs in order, as many as the staging
      // buffer holds (a pair too large for one round splits by rows). A
      // round starts at pair ga, bin row pa, and ends before (gz, pz).
      int ga = 0, pa = rect[0][0];
      while (ga < ng) {
        int gz = ga, pz = pa, used = 0;
        while (gz < ng) {
          const int nx = rect[gz][3] - rect[gz][2] + 1;
          const int rows_left = rect[gz][1] - pz + 1;
          if (nx > 0 && rows_left > 0) {
            const int take = min(rows_left, (cap - used) / nx);
            if (take <= 0) break;
            used += take * nx;
            if (take < rows_left) {
              pz += take;
              break;
            }
          }
          if (++gz < ng) pz = rect[gz][0];
        }
        // Stage the round's bins as f32, kCS channels each, all lanes at
        // once: bin `bin` of the round is pair g's bin row ph, column pw.
        for (int it = tid; it < used * (kCS / 8); it += kBwdThreads) {
          const int bin = it / (kCS / 8), ch = cbase + 8 * (it % (kCS / 8));
          int g = ga, ph = pa, pw = 0, off = 0;
          for (;;) {
            const int nx = rect[g][3] - rect[g][2] + 1;
            const int end = g == gz ? pz - 1 : rect[g][1];
            const int size = nx > 0 && end >= ph ? (end - ph + 1) * nx : 0;
            if (bin < off + size) {
              ph += (bin - off) / nx;
              pw = rect[g][2] + (bin - off) % nx;
              break;
            }
            off += size;
            ph = rect[++g][0];
          }
          if (ch >= C) continue;
          const TG* src = grad +
              ((static_cast<size_t>(hits[g0 + g]) * P + ph) * P + pw) * C + ch;
          float* dst = stage + static_cast<size_t>(bin) * kCS + (ch - cbase);
          if (vec) {
            stage8(dst, src);
          } else {
            for (int q = 0; q < min(8, C - ch); ++q) dst[q] = to_float(src[q]);
          }
        }
        __syncthreads();
        // Each warp (one tile column, warp-uniform weights) adds the
        // round's pairs into its 8 rows.
        if (active) {
          int off = 0;
          for (int g = ga, ph0 = pa;
               g < ng && (g < gz || (g == gz && ph0 < pz));) {
            const int XA = rect[g][2];
            const int nx = rect[g][3] - XA + 1;
            const int end = g == gz ? pz - 1 : rect[g][1];
            const int xa = first[g][col], xz = last[g][col];
            if (nx > 0 && xa <= xz) {
              const float* wx = wx_all + (g * kTile + col) * P;
              for (int ph = ph0; ph <= end; ++ph) {
                const float4* wyp = reinterpret_cast<const float4*>(
                    wy_all + (g * P + ph) * kTile);
                const float4 w0 = wyp[0], w1 = wyp[1];
                const float wy[kTile] = {w0.x, w0.y, w0.z, w0.w,
                                         w1.x, w1.y, w1.z, w1.w};
                const float* srow = stage +
                    (static_cast<size_t>(off + (ph - ph0) * nx) + (xa - XA)) *
                        kCS + 4 * lane;
                float4 row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                for (int pw = xa; pw <= xz; ++pw, srow += kCS) {
                  const float w = wx[pw];
                  const float4 v = *reinterpret_cast<const float4*>(srow);
                  row.x += w * v.x;
                  row.y += w * v.y;
                  row.z += w * v.z;
                  row.w += w * v.w;
                }
#pragma unroll
                for (int k = 0; k < kTile; ++k) {
                  if (wy[k] != 0.0f) {
                    acc[k][0] += wy[k] * row.x;
                    acc[k][1] += wy[k] * row.y;
                    acc[k][2] += wy[k] * row.z;
                    acc[k][3] += wy[k] * row.w;
                  }
                }
              }
            }
            if (nx > 0 && end >= ph0) off += (end - ph0 + 1) * nx;
            if (++g < ng) ph0 = rect[g][0];
          }
        }
        // The next round rewrites the staging buffer, the next group the
        // weights and ranges (every group runs at least one round).
        __syncthreads();
        ga = gz;
        pa = pz;
      }
    }
  }

  const int x = tx0 + col;
  if (!active || x >= W) return;
  TO* out = static_cast<TO*>(const_cast<void*>(t.lv.ptr[lvl])) +
            static_cast<size_t>(slab) * H * W * C + c0;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const int y = ty0 + k;
    if (y >= H) break;
    TO* dst = out + (static_cast<size_t>(y) * W + x) * C;
    if (vec) {
      store4(dst, acc[k]);
    } else {
      for (int q = 0; q < min(4, C - c0); ++q)
        dst[q] = from_float<TO>(acc[k][q]);
    }
  }
}

void make_table(const void* level_ptrs, const void* hs, const void* ws,
                const void* scales, int n_levels, LevelTable* lv) {
  for (int i = 0; i < n_levels; ++i) {
    lv->ptr[i] = level_ptrs ? static_cast<const void* const*>(level_ptrs)[i]
                            : nullptr;
    lv->h[i] = static_cast<const int*>(hs)[i];
    lv->w[i] = static_cast<const int*>(ws)[i];
    lv->scale[i] = static_cast<const float*>(scales)[i];
  }
}

bool bad_args(int n_levels, int C, int P, int s, int dtype) {
  return n_levels < 1 || n_levels > kMaxLevels || P * s > kMaxSamples ||
         P < 1 || s < 1 || C < 1 || (dtype != 0 && dtype != 1);
}

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

template <typename TG, typename TO>
cudaError_t launch_bwd(unsigned blocks, cudaStream_t st, const BwdTable& t,
                       int n_levels, const long long* order,
                       const int* seg, const int4* fp, const float4* smp,
                       const void* grad, int C, int P, int s, bool vec) {
  auto* kernel = roi_align_bwd_kernel<TG, TO>;
  const size_t smem = bwd_dynamic_smem(P, s);
  static size_t allowed = 0;   // dynamic bytes the kernel is set up for
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  kernel<<<dim3(blocks, (C + kCS - 1) / kCS), kBwdThreads, smem, st>>>(
      t, n_levels, order, seg, fp, smp, static_cast<const TG*>(grad), C, P, s,
      vec);
  return cudaGetLastError();
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

// Backward of both, first launch: for the N (roi, slab) pairs laid out as
// in dat_roi_align_pairs, keys (N,) i32, footprints (N, 4) i32 and samples
// (N, 2, P * s, 4) f32 (both 16-byte aligned).
int dat_roi_align_backward_prep(const void* hs, const void* ws,
                                const void* scales, int n_levels,
                                const void* rois, const void* slabs,
                                const void* levels, void* keys,
                                void* footprints, void* samples, int N, int S,
                                int P, int s, void* stream) {
  if (bad_args(n_levels, 1, P, s, 0) || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;  // empty tensors may have null data pointers
  if (slabs == nullptr || reinterpret_cast<uintptr_t>(footprints) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(samples) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LevelTable lv;
  make_table(nullptr, hs, ws, scales, n_levels, &lv);
  roi_align_bwd_prep_kernel<<<(N + 127) / 128, 128, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      lv, n_levels, static_cast<const float*>(rois),
      static_cast<const int*>(levels), static_cast<const int*>(slabs), S, N,
      P, s, static_cast<int*>(keys), static_cast<int4*>(footprints),
      static_cast<float4*>(samples));
  return static_cast<int>(cudaGetLastError());
}

// Second launch: grad (N, P, P, C) of grad_dtype (0 = f32, 1 = bf16) into
// the level maps at out_ptrs (each (S, H_l, W_l, C) of out_dtype), every
// cell written once. order (N,) i64: the pairs sorted by key (stable);
// footprints (N, 4) i32: theirs, in that order (16-byte aligned); seg_off
// (S * n_levels + 1,) i32: the first of each key's pairs in order;
// samples: the first launch's, by pair.
int dat_roi_align_backward(const void* out_ptrs, const void* hs,
                           const void* ws, const void* scales, int n_levels,
                           const void* order, const void* seg_off,
                           const void* footprints, const void* samples,
                           const void* grad, int N, int S, int C, int P,
                           int s, int grad_dtype, int out_dtype,
                           void* stream) {
  if (bad_args(n_levels, C, P, s, grad_dtype) || (out_dtype != 0 &&
      out_dtype != 1) || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdTable t;
  make_table(out_ptrs, hs, ws, scales, n_levels, &t.lv);
  long long blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    t.tile_off[l] = static_cast<int>(blocks);
    blocks += static_cast<long long>(S) * ((t.lv.h[l] + kTile - 1) / kTile) *
              ((t.lv.w[l] + kTile - 1) / kTile);
  }
  t.tile_off[n_levels] = static_cast<int>(blocks);
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(grad) % 16 == 0;
  for (int i = 0; i < n_levels; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(t.lv.ptr[i]) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* o = static_cast<const long long*>(order);
  const int* sg = static_cast<const int*>(seg_off);
  const int4* fp = static_cast<const int4*>(footprints);
  const float4* sm = static_cast<const float4*>(samples);
  const unsigned nb = static_cast<unsigned>(blocks);
  cudaError_t err;
  if (grad_dtype == 0)
    err = out_dtype == 0
              ? launch_bwd<float, float>(nb, st, t, n_levels, o, sg, fp, sm,
                                         grad, C, P, s, vec)
              : launch_bwd<float, __nv_bfloat16>(nb, st, t, n_levels, o, sg,
                                                 fp, sm, grad, C, P, s, vec);
  else
    err = out_dtype == 0
              ? launch_bwd<__nv_bfloat16, float>(nb, st, t, n_levels, o, sg,
                                                 fp, sm, grad, C, P, s, vec)
              : launch_bwd<__nv_bfloat16, __nv_bfloat16>(
                    nb, st, t, n_levels, o, sg, fp, sm, grad, C, P, s, vec);
  return static_cast<int>(err);
}

}  // extern "C"
