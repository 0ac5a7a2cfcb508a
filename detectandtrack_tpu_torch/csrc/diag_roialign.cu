// The RoIAlign diagnostic mini-kernel for Hopper (sm_90a): per (roi, level)
// pair, gather a 64x64xC bf16 patch from the pair's level, then contract it
// densely with an interpolation matrix twice.
//
// Replaces: tools/diag_roialign.py::mini_kernel (:29), the Pallas kernel
// that run_variant launches (pallas_call :140). It is a micro-benchmark on
// no path of the model: it splits a RoIAlign-shaped kernel's per-pair cost
// into the patch gather, the level select and the two contractions, in four
// variants (semantics in kernels/diag_roialign.py):
//   full (0)     gather from level clip(lvl, 0, L-1), both contractions;
//   noswitch (1) the same from level 0 for every pair;
//   nodma (2)    both contractions on a zero "resident" patch, no map read.
//                The TPU kernel pools its uninitialised VMEM scratch there,
//                which has no defined value (NaN or zeros, as the
//                interpreter is told); the port defines the resident patch
//                as zeros, so the variant has one result;
//   nodot (3)    the whole patch gathered, out = bf16(patch[:p,:p] + x1).
// On the TPU the level had to be picked by a 4-way lax.switch around the
// DMA, because a Pallas ref cannot be chosen by data. Here the level select
// is a table lookup: the level pointers are a kernel argument indexed by
// the pair's level, so "noswitch" differs from "full" only in which level's
// cells the pairs read.
//
// Work and bound: per pair 2*p*64*64*C FLOP for tmp = a @ patch and
// 2*p*64*p*C for the second contraction: 16.29 MFLOP at p=7 and 35.8 MFLOP
// at p=14 (C=256), bf16 products with f32 sums, so the bound's operations
// are counted at the bf16 tensor-core peak; its bytes are the distinct patch
// cells the pairs touch (at most 64 rows x 128 columns per level) plus the
// output, written once. The contractions stay dense over all 64 taps, though
// a row of a has at most two nonzeros: the tool exists to time the gather,
// the select and the contractions apart, and a kernel that skipped the
// zeros would time none of them. They run on the CUDA cores (f32 FMAs), so
// this kernel cannot come near the tensor-core bound; that is left for a
// later change.
//
// Design. The TPU kernel held the whole 2 MiB patch in VMEM behind two DMA
// slots and semaphores. A Hopper block has 227 KB of shared memory, so one
// block takes one (pair, 32-channel tile) and streams the patch's 64 rows
// (4 KB each for the tile) through a 4-deep cp.async ring: the counterpart of
// the DMA slots. Each of the 256 threads owns one (column, 8 channels) of
// the tile: it copies its own 16 bytes of every row and reads back only
// those, so the ring needs no block barrier. The first contraction's sums,
// tmp[r][column][8 channels] for r < p, stay in the thread's registers in
// f32 (64 floats at p <= 8, 128 at p <= 16). They are rounded to bf16, as
// the TPU kernel rounds its intermediate, and staged in shared memory (28 KB
// at p=7, 57 KB at p=14), where the second contraction reads them: one
// thread per (r, q, 8 channels), 64 taps summed in f32, one 16-byte store.
// Dynamic shared memory is opted into on every call (the setting is per
// device).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kPatch = 64;                        // patch rows and columns
constexpr int kTileC = 32;                        // channels per block
constexpr int kThreads = kPatch * kTileC / 8;     // one per 16-byte chunk
constexpr int kStages = 4;                        // rows in flight
constexpr int kRowBytes = kPatch * kTileC * 2;    // one tile row, 4 KB
constexpr int kMaxLevels = 8;

enum Variant { kFull = 0, kNoSwitch = 1, kNoDma = 2, kNoDot = 3 };

struct Levels {
  const __nv_bfloat16* ptr[kMaxLevels];
};

template <int PM>
size_t smem_bytes(int p) {
  return static_cast<size_t>(kStages) * kRowBytes +
         static_cast<size_t>(kPatch) * PM * sizeof(float) +
         static_cast<size_t>(p) * kPatch * kTileC * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void unpack8(const uint4 u, float* v) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b2;
    *reinterpret_cast<uint32_t*>(&b2) = words[i];
    const float2 f = __bfloat1622float2(b2);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint32_t words[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    words[i] = *reinterpret_cast<const uint32_t*>(&b2);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// PM: rows of the interpolation matrix a thread holds, a multiple of 4 and
// at least p (8 for p <= 8, 16 for p <= 16).
template <int PM>
__global__ void __launch_bounds__(kThreads)
diag_pool_kernel(Levels lv, int n_lvl, const float* __restrict__ rois,
                 const int* __restrict__ levels,
                 __nv_bfloat16* __restrict__ out,
                 int W, int C, int p, int variant) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* at = reinterpret_cast<float*>(smem + kStages * kRowBytes);
  __nv_bfloat16* tmp_s = reinterpret_cast<__nv_bfloat16*>(at + kPatch * PM);

  const int tiles = C / kTileC;
  const int pair = blockIdx.x / tiles;
  const int tile = blockIdx.x - pair * tiles;
  const int tid = threadIdx.x;
  const int col = tid >> 2;               // patch column of this thread
  const int chunk = tid & 3;              // its 8 channels of the tile

  // int(x1) truncates toward zero and saturates (NaN -> 0), as XLA's
  // f32 -> s32 convert does; >> 3 floors, as the TPU kernel's // 8.
  const float x1 = rois[4 * static_cast<size_t>(pair)];
  const int ox = min(max((__float2int_rz(x1) >> 3) * 8, 0), kPatch);
  const int lvl =
      variant == kNoSwitch ? 0 : min(max(levels[pair], 0), n_lvl - 1);

  // a transposed, at[j][r] = bf16(max(0, 1 - |j - x1|)) for r < p (every
  // row of a is the same), 0 for p <= r < PM.
  for (int i = tid; i < kPatch * PM; i += kThreads) {
    const int j = i / PM;
    const float v = fmaxf(0.0f, 1.0f - fabsf(static_cast<float>(j) - x1));
    at[i] = i - j * PM < p ? __bfloat162float(__float2bfloat16_rn(v)) : 0.0f;
  }

  const size_t row_stride = static_cast<size_t>(W) * C;
  const __nv_bfloat16* src = lv.ptr[lvl] +
                             static_cast<size_t>(ox + col) * C +
                             tile * kTileC + chunk * 8;
  const uint32_t slot0 = smem_addr(ring) + 16 * tid;
  unsigned char* mine = ring + 16 * tid;
  const bool gather = variant != kNoDma;
  if (gather) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      cp_async16(slot0 + s * kRowBytes, src + s * row_stride);
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      *reinterpret_cast<uint4*>(mine + s * kRowBytes) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();                        // at[] is read by every thread

  const size_t out_c = static_cast<size_t>(tile) * kTileC + chunk * 8;
  float acc[PM][8];
#pragma unroll
  for (int r = 0; r < PM; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.0f;

  for (int y = 0; y < kPatch; ++y) {
    if (gather) {
      const int next = y + kStages - 1;
      if (next < kPatch)
        cp_async16(slot0 + (next % kStages) * kRowBytes,
                   src + next * row_stride);
      cp_async_commit();
      cp_async_wait<kStages - 1>();       // this thread's row y has landed
    }
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(mine + (y % kStages) * kRowBytes),
            v);
    if (variant == kNoDot) {
      if (y < p && col < p) {
        const float xb = __bfloat162float(__float2bfloat16_rn(x1));
        float o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = v[k] + xb;
        *reinterpret_cast<uint4*>(
            out + ((static_cast<size_t>(pair) * p + y) * p + col) * C +
            out_c) = pack8(o);
      }
      continue;
    }
    const float4* arow = reinterpret_cast<const float4*>(at + y * PM);
#pragma unroll
    for (int r4 = 0; r4 < PM / 4; ++r4) {
      const float4 a4 = arow[r4];
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (4 * r4 + i < p) {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            acc[4 * r4 + i][k] = fmaf(a[i], v[k], acc[4 * r4 + i][k]);
        }
      }
    }
  }
  if (gather) cp_async_wait<0>();
  if (variant == kNoDot) return;

  // tmp[r][col][8 channels] rounded to bf16 into shared memory.
#pragma unroll
  for (int r = 0; r < PM; ++r)
    if (r < p)
      *reinterpret_cast<uint4*>(tmp_s + (r * kPatch + col) * kTileC +
                                chunk * 8) = pack8(acc[r]);
  __syncthreads();

  // out[r][q][c] = sum_x a[q][x] * tmp[r][x][c], one thread per (r, q, 8c).
  for (int u = tid; u < p * p * 4; u += kThreads) {
    const int ch = u & 3;
    const int rq = u >> 2;
    const int r = rq / p;
    const int q = rq - r * p;
    const __nv_bfloat16* trow = tmp_s + r * kPatch * kTileC + ch * 8;
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = 0.0f;
#pragma unroll 8
    for (int x = 0; x < kPatch; ++x) {
      const float w = at[x * PM + q];
      float t[8];
      unpack8(*reinterpret_cast<const uint4*>(trow + x * kTileC), t);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = fmaf(w, t[k], o[k]);
    }
    *reinterpret_cast<uint4*>(
        out + ((static_cast<size_t>(pair) * p + r) * p + q) * C +
        static_cast<size_t>(tile) * kTileC + ch * 8) = pack8(o);
  }
}

template <int PM>
int launch(const Levels& lv, int n_lvl, const float* rois, const int* levels,
           __nv_bfloat16* out, int n, int W, int C, int p, int variant,
           cudaStream_t st) {
  const size_t smem = smem_bytes<PM>(p);
  cudaError_t err = cudaFuncSetAttribute(
      diag_pool_kernel<PM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n) * (C / kTileC);
  diag_pool_kernel<PM><<<grid, kThreads, smem, st>>>(lv, n_lvl, rois, levels,
                                                     out, W, C, p, variant);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* dat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// level_ptrs: n_lvl device pointers to contiguous bf16 (1, H, W, C) maps,
// H >= 64, W >= 128, C % 32 == 0, 16-byte aligned; rois: f32 (4n,), the
// pair's x1 at 4i; levels: int32 (n,); out: bf16 (n, p, p, C); p in 1..16;
// variant 0 full, 1 noswitch, 2 nodma, 3 nodot. Returns a cudaError_t.
int dat_diag_pool(const void* level_ptrs, int n_lvl, const void* rois,
                  const void* levels, void* out, int n, int H, int W, int C,
                  int p, int variant, void* stream) {
  if (n_lvl < 1 || n_lvl > kMaxLevels || n < 1 || H < kPatch ||
      W < 2 * kPatch || C < kTileC || C % kTileC != 0 || p < 1 || p > 16 ||
      variant < kFull || variant > kNoDot ||
      static_cast<long long>(n) * (C / kTileC) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  uintptr_t align = reinterpret_cast<uintptr_t>(out);
  for (int i = 0; i < kMaxLevels; ++i) {
    lv.ptr[i] = i < n_lvl ? static_cast<const __nv_bfloat16* const*>(
                                level_ptrs)[i]
                          : nullptr;
    align |= reinterpret_cast<uintptr_t>(lv.ptr[i]);
  }
  if (align % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const int* l = static_cast<const int*>(levels);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  return p <= 8 ? launch<8>(lv, n_lvl, r, l, o, n, W, C, p, variant, st)
                : launch<16>(lv, n_lvl, r, l, o, n, W, C, p, variant, st);
}

}  // extern "C"
