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
// output, written once: 0.079 ms at n=4800, p=7. What every pair really
// moves is its own 2 MiB patch (64 x 64 x 256 bf16), from L2 where pairs
// share cells: 10.1 GB at n=4800, the practical floor of every variant but
// nodma. The contractions stay dense over all 64 taps, though a row of a
// has at most two nonzeros: the tool exists to time the gather, the select
// and the contractions apart, and a kernel that skipped the zeros would time
// none of them.
//
// Design: both contractions on the tensor cores, mma.sync.m16n8k8 bf16 with
// f32 sums, in the transposed form, so that the small side p is N and not a
// padded M: tmp^T[(x, c), r] = sum_y patch^T[(x, c), y] * a^T[y, r], then
// out^T[(r, c), q] = sum_x tmp^T[(r, c), x] * a^T[x, q]. A (the patch, then
// tmp) comes from shared memory with ldmatrix.trans (rows are y or x, 16
// bytes of channels each); B (a^T, p padded to 8 or 16 columns, zero past
// p) is built in registers from x1, as interp_matrix builds it, and is the
// same for both contractions. One block of 8 warps takes one (pair,
// 32-channel tile); warp w owns patch columns 8w..8w+7, 16 m-tiles of 16
// channels, and gathers those columns itself, 64 contiguous bytes of a map
// cell per 4 lanes (two 32-byte sectors: 16-channel tiles, one sector a
// cell, gather at half the rate). The 64 patch rows come in as 8 K steps of
// 8 rows with 16-byte cp.async through a 3-deep ring (32 KB a step, the counterpart of
// the TPU kernel's two DMA slots), and the warp contracts each step as it
// lands: a warp waits only on its own copies (__syncwarp, no block barrier)
// and the gather overlaps the contraction. k8 steps (not k16) keep a ring
// stage at 32 KB, so two blocks fit an SM at p <= 8 (96 KB and 128
// registers each). 16-byte units are XOR-swizzled by row so that
// ldmatrix's 8 rows hit 8 bank groups. The first contraction's sums are
// rounded to bf16, as the TPU kernel rounds its intermediate, and staged as
// tmp[r][x][c] in the ring once every warp is done with it (planes of 257
// units, so the 2-byte stores of 4 r's hit 4 bank groups; units swizzled by
// (x >> 1) & 3 for ldmatrix); warp w then does the second contraction for
// r = w and w + 8, and the p x p x 32 output tile is staged and written with
// 16-byte stores. nodma reads a zero-filled first stage 8 times; nodot
// gathers all 64 rows the same way and writes patch[:p, :p] + bf16(x1).
// Dynamic shared memory is opted into on every call (the setting is per
// device). At n=4800, p=7: full 1.297 ms, nodma 0.657, nodot 1.303 (the
// CUDA-core kernel it replaced: 3.876, 3.326, 1.848; NVIDIA H100 80GB HBM3,
// 700.00 W; chip_smoke.py's [diag] lines).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kPatch = 64;                        // patch rows and columns
constexpr int kTileC = 32;                        // channels per block
constexpr int kWarps = 8;                         // 8 patch columns each
constexpr int kThreads = 32 * kWarps;
constexpr int kStepRows = 8;                      // patch rows per K step
constexpr int kSteps = kPatch / kStepRows;        // 8
constexpr int kRing = 3;                          // K steps in flight
constexpr int kRowUnits = kPatch * kTileC * 2 / 16;       // 16 B units a row
constexpr int kStageBytes = kStepRows * kRowUnits * 16;   // 32 KB
constexpr int kSmemBytes = kRing * kStageBytes;           // 96 KB
constexpr int kTmpPlane = kRowUnits + 1;          // units per tmp plane (r)
constexpr int kMaxLevels = 8;

enum Variant { kFull = 0, kNoSwitch = 1, kNoDma = 2, kNoDot = 3 };

struct Levels {
  const __nv_bfloat16* ptr[kMaxLevels];
};

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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x8, row) * b (8x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_k8(float* d, uint32_t a0, uint32_t a1,
                                       uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// bf16(max(0, 1 - |j - x1|)): one entry of the interpolation matrix.
__device__ __forceinline__ float interp(int j, float x1) {
  return fmaxf(0.0f, 1.0f - fabsf(static_cast<float>(j) - x1));
}
// The entries j and j + 1 as a bf16 pair, j in the low half.
__device__ __forceinline__ uint32_t interp_pair(int j, float x1) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(interp(j, x1), interp(j + 1, x1));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 add8(const uint4 u, float b) {
  uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b2;
    *reinterpret_cast<uint32_t*>(&b2) = w[i];
    const float2 f = __bfloat1622float2(b2);
    const __nv_bfloat162 o = __floats2bfloat162_rn(f.x + b, f.y + b);
    w[i] = *reinterpret_cast<const uint32_t*>(&o);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Unit (16 bytes: 8 channels) of patch row yy (within a step), column x,
// channel group u (0..3), in a ring stage.
__device__ __forceinline__ int patch_unit(int yy, int x, int u) {
  return yy * kRowUnits + ((4 * x + u) ^ yy);
}
// Unit of tmp[r][x][8u..8u+7].
__device__ __forceinline__ int tmp_unit(int r, int x, int u) {
  return r * kTmpPlane + 4 * x + (u ^ ((x >> 1) & 3));
}

// NT: n-tiles of 8 columns of a^T, 1 for p <= 8, 2 for p <= 16; at NT = 1
// two blocks fit an SM (128 registers a thread).
template <int NT>
__global__ void __launch_bounds__(kThreads, 3 - NT)
diag_pool_kernel(Levels lv, int n_lvl, const float* __restrict__ rois,
                 const int* __restrict__ levels,
                 __nv_bfloat16* __restrict__ out,
                 int W, int C, int p, int variant) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);

  const int tiles = C / kTileC;
  const int pair = blockIdx.x / tiles;
  const int tile = blockIdx.x - pair * tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                // fragment row group
  const int q = lane & 3;                 // fragment column pair

  // int(x1) truncates toward zero and saturates (NaN -> 0), as XLA's
  // f32 -> s32 convert does; >> 3 floors, as the TPU kernel's // 8.
  const float x1 = rois[4 * static_cast<size_t>(pair)];
  const int ox = min(max((__float2int_rz(x1) >> 3) * 8, 0), kPatch);
  const int lvl =
      variant == kNoSwitch ? 0 : min(max(levels[pair], 0), n_lvl - 1);

  // The gather: lane copies (column 8w + lane/4, channels 8 (lane & 3) ..
  // +7 of the tile) of each of a step's 8 rows: 64 contiguous bytes of a
  // map cell per 4 lanes.
  const int gx = 8 * warp + (lane >> 2);
  const int gu = lane & 3;
  const size_t row_stride = static_cast<size_t>(W) * C;
  const __nv_bfloat16* src = lv.ptr[lvl] + static_cast<size_t>(ox + gx) * C +
                             tile * kTileC + 8 * gu;
  const bool gather = variant != kNoDma;
  auto issue = [&](int step, int slot) {
#pragma unroll
    for (int yy = 0; yy < kStepRows; ++yy)
      cp_async16(ring + slot * kStageBytes + 16 * patch_unit(yy, gx, gu),
                 src + (step * kStepRows + yy) * row_stride);
  };
  if (gather) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      issue(s, s);
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int yy = 0; yy < kStepRows; ++yy)
      *reinterpret_cast<uint4*>(smem + 16 * patch_unit(yy, gx, gu)) =
          make_uint4(0, 0, 0, 0);
    __syncwarp();
  }

  // B = a^T (64 x p, columns past p zero), per K step and n-tile: the same
  // fragments serve both contractions.
  uint32_t bf[kSteps][NT];
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      bf[s][nt] = 8 * nt + g < p ? interp_pair(kStepRows * s + 2 * q, x1)
                                 : 0u;

  // ldmatrix.trans lane roles: lane provides row lane & 7 of matrix
  // lane >> 3, the channel group; m-tile 0 is groups 0, 1, m-tile 1 is
  // groups 2, 3.
  const int lr = lane & 7;
  const int lu = lane >> 3;

  float acc[8][2][NT][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][mt][nt][e] = 0.0f;

  const float xb = __bfloat162float(__float2bfloat16_rn(x1));
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int slot = gather ? s % kRing : 0;
    if (gather) {
      cp_async_wait<kRing - 1>();         // this warp's step s has landed
      __syncwarp();
    }
    if (variant == kNoDot) {
      if (gx < p) {
#pragma unroll
        for (int yy = 0; yy < kStepRows; ++yy) {
          const int y = s * kStepRows + yy;
          if (y < p)
            *reinterpret_cast<uint4*>(
                out + ((static_cast<size_t>(pair) * p + y) * p + gx) * C +
                tile * kTileC + 8 * gu) =
                add8(*reinterpret_cast<const uint4*>(
                         smem + slot * kStageBytes +
                         16 * patch_unit(yy, gx, gu)),
                     xb);
        }
      }
    } else {
      const uint32_t stage = ring + slot * kStageBytes;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t a[4];
        ldmatrix_x4_trans(stage + 16 * patch_unit(lr, 8 * warp + i, lu), a);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_k8(acc[i][0][nt], a[0], a[1], bf[s][nt]);
          mma_k8(acc[i][1][nt], a[2], a[3], bf[s][nt]);
        }
      }
    }
    if (gather) {
      __syncwarp();                       // every lane is done with the slot
      if (s + kRing < kSteps) issue(s + kRing, slot);
      cp_async_commit();
    }
  }
  if (variant == kNoDot) return;
  __syncthreads();                        // the ring is free: stage tmp

  // tmp[r][x][c] = bf16(acc): x = 8w + i, c = 16mt + g (+8), r = 8nt + 2q
  // (+1).
  unsigned char* tmp_s = smem;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * nt + 2 * q + (e & 1);
          if (r < p)
            *reinterpret_cast<__nv_bfloat16*>(
                tmp_s + 16 * tmp_unit(r, 8 * warp + i, 2 * mt + (e >> 1)) +
                2 * g) = __float2bfloat16_rn(acc[i][mt][nt][e]);
        }
  __syncthreads();

  // out^T[(r, c), q] = sum_x tmp[r][x][c] * a[q][x]; warp w takes r = w,
  // w + 8; the (p, p, 32) tile is staged after the tmp planes.
  unsigned char* out_s = smem + 16 * kTmpPlane * p;
  const uint32_t tmp_a = smem_addr(tmp_s);
  for (int r = warp; r < p; r += kWarps) {
    float d[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[mt][nt][e] = 0.0f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t a[4];
      ldmatrix_x4_trans(tmp_a + 16 * tmp_unit(r, kStepRows * s + lr, lu), a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_k8(d[0][nt], a[0], a[1], bf[s][nt]);
        mma_k8(d[1][nt], a[2], a[3], bf[s][nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = 8 * nt + 2 * q + (e & 1);
          if (qq < p)
            *reinterpret_cast<__nv_bfloat16*>(
                out_s + 64 * (r * p + qq) + 2 * (16 * mt + g + 8 * (e >> 1))) =
                __float2bfloat16_rn(d[mt][nt][e]);
        }
  }
  __syncthreads();
  for (int u = threadIdx.x; u < 4 * p * p; u += kThreads)
    *reinterpret_cast<uint4*>(
        out + (static_cast<size_t>(pair) * p * p + (u >> 2)) * C +
        tile * kTileC + 8 * (u & 3)) =
        *reinterpret_cast<const uint4*>(out_s + 16 * u);
}

template <int NT>
int launch(const Levels& lv, int n_lvl, const float* rois, const int* levels,
           __nv_bfloat16* out, int n, int W, int C, int p, int variant,
           cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      diag_pool_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>(n) * (C / kTileC);
  diag_pool_kernel<NT><<<grid, kThreads, kSmemBytes, st>>>(
      lv, n_lvl, rois, levels, out, W, C, p, variant);
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
  return p <= 8 ? launch<1>(lv, n_lvl, r, l, o, n, W, C, p, variant, st)
                : launch<2>(lv, n_lvl, r, l, o, n, W, C, p, variant, st);
}

}  // extern "C"
