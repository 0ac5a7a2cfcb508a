// The grouped 3x3 convolution of a ResNeXt bottleneck at inference, with its
// frozen-BN affine, an optional residual add and the ReLU applied in its own
// store, for Hopper (sm_90a):
//   y = act(round(conv(x, w)) * s + b [+ r])
// over bf16 NHWC x (N, H, W, C), 64-channel ranges of groups of CG = 4, 8,
// 16 or 32 channels, stride 1 or 2 in H and W, same-padding (1 on each side).
//
// Replaces no Pallas kernel. In the JAX package XLA runs a grouped conv
// (flax feature_group_count) and fuses the AffineChannel and ReLU into its
// consumers. In PyTorch cuDNN runs the grouped conv and writes its output,
// then `affine_elementwise_kernel` (csrc/affine.cu) reads and writes it once
// more. This kernel writes the finished output once.
//
// What bounds it on the H100: bytes. A group of CG channels does 2 * 9 * CG
// FLOP per output for about 4 bytes in and out (18-144 FLOP/B, under the
// bf16 ridge of ~295), so the least time is x read once, y written once (and
// r read once) over 3.35 TB/s. At CG = 16 and 32 the FLOPs would outrun the
// CUDA cores, so the products run on the tensor cores. The design:
// - A block owns one 64-channel range and walks over output tiles (8 or 4
//   rows of 16 pixels at stride 1, 2 or 4 rows at stride 2), persistent.
//   Each tile's input, halo and zero padding included, arrives by one TMA
//   tensor copy (one thread issues it, an mbarrier reports it), into one of
//   two buffers while the other is computed: the threads spend no
//   instructions on loads (issuing them cost a third of the time).
// - The products: mma.sync m16n8k16 bf16 with f32 sums, one row of 16
//   output pixels an M tile, K = 9 taps x the group's channels, taken from
//   the staged input by ldmatrix (an implicit im2col: each row address is a
//   pixel's 8 channels at a tap). A group is a block-diagonal 8 x 8 (CG = 4:
//   two groups to an n-tile, the other group's weights zero), 8 x 8, 16 x 16
//   or 32 x 32 per tap; the K padding of CG = 4 and 8 (9 taps of 8 channels
//   in 5 k-steps of 16) multiplies zero weights. Each warp keeps the B
//   fragments of its 2 n-tiles in registers for the whole walk (read from
//   the f32 weights once, rounded to bf16), so shared memory serves only
//   the A fragments.
// - A staged pixel's 64 channels sit 144 bytes apart (the copy's box is 72
//   channels wide, the last 8 unused), so the 8 rows an ldmatrix phase reads
//   fall in distinct banks at stride 1 (two-way at stride 2).
// - The epilogue: the f32 sums are rounded to bf16 (the conv's output, as
//   cuDNN stores it) into the tile's buffer, then each thread reads 16 bytes
//   of it, applies the frozen-BN affine, the add and the ReLU in the op
//   chain's order and rounding (csrc/affine.cu, kernels/affine.py: each
//   operation in f32 rounded to bf16, s and b rounded first) and stores 16
//   bytes, neighbouring threads on neighbouring addresses.
// - Blocks take consecutive tiles together, and a tile's 64-channel ranges
//   are neighbouring blocks, so the halo rows a tile shares with the next
//   are read back from L2, not from memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTW = 16;          // output columns a tile (one M tile a row)
constexpr int kThreads = 128;    // 4 warps

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The shape of the work for a unit of GU channels (a group, or two groups
// of 4) and a stride S. A block: kCW channels (kQ n-tiles of 8) of kTH x kTW
// output pixels; warp w holds the weights of n-tiles w * kNTW + [0, kNTW)
// in registers and computes them for every row of the tile.
template <int GU, int S>
struct Shape {
  static constexpr int kCW = 64;                       // channels a block
  static constexpr int kTH = S == 1 ? (GU == 8 ? 8 : 4)  // output rows a
                                    : (GU == 32 ? 4 : 2);  // tile
  static constexpr int kPitch = kCW + 8;               // bf16 a pixel
  static constexpr int kIH = (kTH - 1) * S + 3;        // input rows a tile
  static constexpr int kIW = (kTW - 1) * S + 3;        // input columns
  static constexpr int kQ = kCW / 8;                   // n-tiles, 16-B chunks
  static constexpr int kSub = GU / 8;                  // 8-channel chunks
  static constexpr int kChunks = 9 * kSub;             // K chunks a unit
  static constexpr int kSteps = (kChunks + 1) / 2;     // k16 steps a unit
  static constexpr int kNT = GU / 8;                   // n-tiles a unit
  static constexpr int kNTW = kQ / (kThreads / 32);    // n-tiles a warp
  static constexpr int kUW = kNTW >= kNT ? kNTW / kNT : 1;  // units a warp
  static constexpr int kTU = kNTW >= kNT ? kNT : kNTW;  // n-tiles a unit
  static constexpr int kBox = kIH * kIW * kPitch * 2;  // bytes a tile's load
  static constexpr int kBuf = (kBox + 127) / 128 * 128;  // bytes a buffer
  static constexpr int kSmem = 2 * kBuf + 128;         // + the alignment
  static_assert(kQ % (kThreads / 32) == 0, "warps share the n-tiles");
  static_assert(kTH * kTW * kPitch * 2 <= kBox, "the output fits a buffer");
  static_assert(kThreads % kQ == 0, "a thread keeps its channels");
};

// Byte offset, from a pixel row address, of K chunk kc of a unit: its tap
// (kh, kw) and its 8 channels.
template <int GU, int S>
__device__ __forceinline__ int chunk_offset(int kc) {
  using Sh = Shape<GU, S>;
  if (kc >= Sh::kChunks) kc = 0;  // K padding: any staged data, zero weight
  const int tap = kc / Sh::kSub, sub = kc % Sh::kSub;
  const int kh = tap / 3, kw = tap % 3;
  return (kh * Sh::kIW + kw) * Sh::kPitch * 2 + sub * 16;
}

// mma.sync's B fragment of lane l for unit u (in the block's range, from
// channel c0), k-step j, n-tile t: {B[k][n], B[k + 1][n]} and {B[k + 8][n],
// B[k + 9][n]} as bf16 pairs, k = (l % 4) * 2, n = l / 4, B[k][n] the
// weight of output channel t * 8 + n of the unit from input channel (chunk
// 2j + k / 8, channel k % 8): zero across groups of CG and in the K padding.
template <int GU, int S>
__device__ __forceinline__ uint2 b_fragment(const float* __restrict__ w,
                                            int c0, int CG, int u, int j,
                                            int t, int l) {
  using Sh = Shape<GU, S>;
  uint32_t half[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = (l & 3) * 2 + e + h * 8;
      const int kc = 2 * j + (k >> 3);
      v[e] = 0.0f;
      if (kc < Sh::kChunks) {
        const int tap = kc / Sh::kSub, sub = kc % Sh::kSub;
        const int ci = u * GU + sub * 8 + (k & 7);    // in the range
        const int co = u * GU + t * 8 + (l >> 2);     // in the range
        if (ci / CG == co / CG)
          v[e] = w[(static_cast<long long>(c0 + co) * CG + ci % CG) * 9 +
                   tap];
      }
    }
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[0], v[1]);
    memcpy(&half[h], &p, 4);
  }
  return make_uint2(half[0], half[1]);
}

// x (N, H, W, C) bf16 through `xmap` (a TMA descriptor of x: box kPitch
// channels x kIW x kIH x 1, out of bounds read as zero), w (C, CG, 1, 3, 3)
// f32, s and b (C,) f32, r (N, Ho, Wo, C) bf16 or null, y (N, Ho, Wo, C)
// bf16; CG = GU, or 4 with GU = 8. Block i: channel range i % ranges,
// tiles i / ranges, i / ranges + slots, ... with slots = gridDim.x / ranges.
template <int GU, int S>
__global__ void __launch_bounds__(kThreads)
grouped_conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ w,
                       const float* __restrict__ s,
                       const float* __restrict__ b,
                       const __nv_bfloat16* __restrict__ r,
                       __nv_bfloat16* __restrict__ y, int N, int C, int CG,
                       int Ho, int Wo, int relu) {
  using Sh = Shape<GU, S>;
  constexpr int kCW = Sh::kCW, kPitch = Sh::kPitch, kQ = Sh::kQ;
  constexpr int kNTW = Sh::kNTW, kUW = Sh::kUW, kTU = Sh::kTU;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[2];
  // the two tile buffers, 128-byte aligned for the tensor copies
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t buf0 = (raw + 127) & ~127u;
  unsigned char* bufs = smem_raw + (buf0 - raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ranges = C / kCW;
  const int range = blockIdx.x % ranges;
  const int slots = gridDim.x / ranges;
  const int tiles_w = (Wo + kTW - 1) / kTW;
  const int tiles_h = (Ho + Sh::kTH - 1) / Sh::kTH;
  const long long tiles = static_cast<long long>(N) * tiles_h * tiles_w;
  const int c0 = range * kCW;
  const uint32_t bar0 = smem_addr(&bars[0]);

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&xmap))
                 : "memory");
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       bar0 + 8 * i)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The tile's input, halo and padding included, into buffer k: one tensor
  // copy issued by thread 0, completing on barrier k.
  auto load_tile = [&](long long tile, int k) {
    if (tid != 0) return;
    const int tw = static_cast<int>(tile % tiles_w);
    const long long q = tile / tiles_w;
    const int th = static_cast<int>(q % tiles_h);
    const int n = static_cast<int>(q / tiles_h);
    const int y0 = th * Sh::kTH * S - 1, x0 = tw * kTW * S - 1;
    const uint32_t bar = bar0 + 8 * k;
    // the buffer's last reads and writes (generic proxy) come first
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(Sh::kBox)
        : "memory");
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
            buf0 + k * Sh::kBuf),
        "l"(reinterpret_cast<uint64_t>(&xmap)), "r"(c0), "r"(x0), "r"(y0),
        "r"(n), "r"(bar)
        : "memory");
  };

  long long tile = blockIdx.x / ranges;
  if (tile < tiles) load_tile(tile, 0);

  // The warp's n-tiles (from nt0) and their weights, once.
  const int nt0 = warp * kNTW;
  uint2 bfrag[kUW][Sh::kSteps][kTU];
#pragma unroll
  for (int uu = 0; uu < kUW; ++uu)
#pragma unroll
    for (int j = 0; j < Sh::kSteps; ++j)
#pragma unroll
      for (int tt = 0; tt < kTU; ++tt) {
        const int nt = nt0 + uu * kTU + tt;
        bfrag[uu][j][tt] = b_fragment<GU, S>(w, c0, CG, nt / Sh::kNT, j,
                                             nt % Sh::kNT, lane);
      }

  // The epilogue's channels: thread tid stores channels c0 + (tid % kQ) * 8
  // + [0, 8) of its pixels; s and b rounded to bf16 as the chain casts them.
  const int cq = tid % kQ;
  float ks[8], kb[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    ks[k] = rnd(s[c0 + cq * 8 + k]);
    kb[k] = rnd(b[c0 + cq * 8 + k]);
  }

  // A lane's ldmatrix row: matrix mi = lane / 8 is rows (mi & 1) * 8 + [0,
  // 8) (pixels of a tile row) of chunk 2j + mi / 2.
  const int mi = lane >> 3;
  const int arow = (lane & 7) + ((mi & 1) << 3);
  const int ahalf = mi >> 1;

  for (int it = 0; tile < tiles; ++it, tile += slots) {
    const int k = it & 1;
    __nv_bfloat16* buf = reinterpret_cast<__nv_bfloat16*>(bufs + k * Sh::kBuf);
    if (tile + slots < tiles) load_tile(tile + slots, k ^ 1);
    mbar_wait(bar0 + 8 * k, (it >> 1) & 1);

    float acc[Sh::kTH][kNTW][4];
#pragma unroll
    for (int rr = 0; rr < Sh::kTH; ++rr)
#pragma unroll
      for (int q = 0; q < kNTW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rr][q][e] = 0.0f;

    const uint32_t arow_addr = buf0 + k * Sh::kBuf + arow * S * kPitch * 2;
#pragma unroll
    for (int uu = 0; uu < kUW; ++uu) {
      const int u = (nt0 + uu * kTU) / Sh::kNT;
#pragma unroll
      for (int j = 0; j < Sh::kSteps; ++j) {
        const int off = (ahalf ? chunk_offset<GU, S>(2 * j + 1)
                               : chunk_offset<GU, S>(2 * j)) +
                        u * GU * 2;
#pragma unroll
        for (int rr = 0; rr < Sh::kTH; ++rr) {
          uint32_t a[4];
          ldmatrix_x4(arow_addr + rr * S * Sh::kIW * kPitch * 2 + off, a);
#pragma unroll
          for (int tt = 0; tt < kTU; ++tt)
            mma_bf16(acc[rr][uu * kTU + tt], a, bfrag[uu][j][tt].x,
                     bfrag[uu][j][tt].y);
        }
      }
    }
    __syncthreads();  // every warp is done with the staged input

    // The conv's output rounded to bf16, into the same buffer: row g = lane
    // / 4 (+ 8) of tile row rr is its pixel g, channels (nt0 + q) * 8 +
    // (lane % 4) * 2 + {0, 1}.
#pragma unroll
    for (int rr = 0; rr < Sh::kTH; ++rr)
#pragma unroll
      for (int q = 0; q < kNTW; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = rr * kTW + (lane >> 2) + h * 8;
          *reinterpret_cast<__nv_bfloat162*>(
              buf + p * kPitch + (nt0 + q) * 8 + (lane & 3) * 2) =
              __floats2bfloat162_rn(acc[rr][q][2 * h], acc[rr][q][2 * h + 1]);
        }
    __syncthreads();

    // The epilogue and the store: 16 bytes a thread, a pixel's channels on
    // kQ neighbouring threads.
    {
      const int tw = static_cast<int>(tile % tiles_w);
      const long long q = tile / tiles_w;
      const int th = static_cast<int>(q % tiles_h);
      const int n = static_cast<int>(q / tiles_h);
#pragma unroll
      for (int i = tid; i < Sh::kTH * kTW * kQ; i += kThreads) {
        const int p = i / kQ;
        const int gy = th * Sh::kTH + p / kTW, gx = tw * kTW + p % kTW;
        if (gy >= Ho || gx >= Wo) continue;
        const long long at =
            ((static_cast<long long>(n) * Ho + gy) * Wo + gx) * C + c0 +
            cq * 8;
        uint4 raw4 = *reinterpret_cast<const uint4*>(buf + p * kPitch + cq * 8);
        uint4 rr4 = make_uint4(0, 0, 0, 0);
        if (r != nullptr) rr4 = *reinterpret_cast<const uint4*>(r + at);
        __nv_bfloat16 v8[8], r8[8];
        memcpy(v8, &raw4, 16);
        memcpy(r8, &rr4, 16);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float v = rnd(__fmul_rn(__bfloat162float(v8[e]), ks[e]));
          v = rnd(__fadd_rn(v, kb[e]));
          if (r != nullptr) v = rnd(__fadd_rn(v, __bfloat162float(r8[e])));
          if (relu && v < 0.0f) v = 0.0f;  // NaN stays NaN, as torch.relu
          v8[e] = __float2bfloat16_rn(v);
        }
        memcpy(&raw4, v8, 16);
        *reinterpret_cast<uint4*>(y + at) = raw4;
      }
    }
    __syncthreads();  // the buffer takes the tile after next
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against the driver library).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int GU, int S>
cudaError_t launch(const void* x, const float* w, const float* s,
                   const float* b, const void* r, void* y, int N, int H,
                   int W, int C, int CG, int Ho, int Wo, int relu,
                   cudaStream_t st) {
  using Sh = Shape<GU, S>;
  if (C % Sh::kCW != 0) return cudaErrorInvalidValue;
  auto kernel = grouped_conv3x3_kernel<GU, S>;
  // Set once per instantiation, before any capture: the first call of a
  // graphed function runs eagerly.
  static int per_sm = -1;
  static int sms = 0;
  if (per_sm < 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int dev = 0, blocks = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, Sh::kSmem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    per_sm = blocks;
  }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {Sh::kPitch, Sh::kIW, Sh::kIH, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int ranges = C / Sh::kCW;
  const long long tiles = static_cast<long long>(N) *
                          ((Ho + Sh::kTH - 1) / Sh::kTH) *
                          ((Wo + kTW - 1) / kTW);
  long long slots = static_cast<long long>(per_sm) * sms / ranges;
  if (slots < 1) slots = 1;
  if (slots > tiles) slots = tiles;
  kernel<<<static_cast<unsigned>(slots * ranges), kThreads, Sh::kSmem, st>>>(
      xmap, w, s, b, static_cast<const __nv_bfloat16*>(r),
      static_cast<__nv_bfloat16*>(y), N, C, CG, Ho, Wo, relu);
  return cudaGetLastError();
}

template <int GU>
cudaError_t by_stride(int stride, const void* x, const float* w,
                      const float* s, const float* b, const void* r, void* y,
                      int N, int H, int W, int C, int CG, int Ho, int Wo,
                      int relu, cudaStream_t st) {
  return stride == 1 ? launch<GU, 1>(x, w, s, b, r, y, N, H, W, C, CG, Ho,
                                     Wo, relu, st)
                     : launch<GU, 2>(x, w, s, b, r, y, N, H, W, C, CG, Ho,
                                     Wo, relu, st);
}

}  // namespace

extern "C" {

const char* dat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (N, H, W, C) bf16 contiguous, 16-byte aligned; w (C, CG, 1, 3, 3) f32;
// s, b (C,) f32; r (may be null) and y (N, Ho, Wo, C) bf16, 16-byte aligned,
// Ho = (H - 1) / stride + 1, Wo likewise. CG in {4, 8, 16, 32}, C a multiple
// of 64, stride 1 or 2. y = act(bf16(conv) * s + b [+ r]).
int dat_grouped_conv3x3(const void* x, const void* w, const void* s,
                        const void* b, const void* r, void* y, int N, int H,
                        int W, int C, int CG, int stride, int relu,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  if (x == nullptr || w == nullptr || s == nullptr || b == nullptr ||
      y == nullptr || C <= 0 || C % 64 != 0 ||
      (stride != 1 && stride != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const auto* fw = static_cast<const float*>(w);
  const auto* fs = static_cast<const float*>(s);
  const auto* fb = static_cast<const float*>(b);
  cudaError_t err;
  switch (CG) {
    case 4:   // two groups to a unit of 8
    case 8:
      err = by_stride<8>(stride, x, fw, fs, fb, r, y, N, H, W, C, CG, Ho,
                         Wo, relu, st);
      break;
    case 16:
      err = by_stride<16>(stride, x, fw, fs, fb, r, y, N, H, W, C, CG, Ho,
                          Wo, relu, st);
      break;
    case 32:
      err = by_stride<32>(stride, x, fw, fs, fb, r, y, N, H, W, C, CG, Ho,
                          Wo, relu, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"
