// conv1 of the inflated ResNet (7x7, stride 2, pad 3, t temporal taps) for
// Hopper (sm_90a): two implicit GEMMs on the tensor cores, one per dtype,
// conv1_tc_kernel for bf16 and conv1_tf32_kernel for f32 (3-pass TF32).
//
// Replaces: detectandtrack_tpu/kernels/conv1.py::conv1_s2d_pallas (kernel
// body _conv1_kernel). The TPU kernel folds the 7x7xt window into the MXU
// contraction through a space-to-depth relayout prepared by XLA, and needs
// even H, W and an aligned row block. Here a block reads its input window
// straight from the (B, T, H, W, 3) clip, zero-filling the temporal
// ((t-1)//2, t//2) and spatial (3, 3) padding itself, so any H, W and T work.
//
// What bounds it on the H100: arithmetic. conv1 is 2*441*64 FLOP per output
// pixel at t=3 (243 GFLOP for a B=2, T=8, 800x1344 clip). In bf16 that is
// 0.246 ms at the 989 TFLOP/s tensor-core peak (its 103 MB in and 551 MB out
// take 0.195 ms at 3.35 TB/s). In f32 the CUDA cores' 67 TFLOP/s allow no
// less than 3.62 ms; the 3-pass TF32 split below does three products per
// multiply-add at the 495 TFLOP/s TF32 peak: 1.47 ms (the bytes, 1.31 GB,
// take 0.39 ms).
//
// Both kernels are persistent implicit GEMMs on mma.sync from registers:
// M = output pixels, N = the 64 channels, K ordered (kt, ky, kx, ci). For
// one (kt, ky) a pixel's 21 values (kx, ci) are one contiguous run of its
// clip row, x from 2*ox-3 to 2*ox+3, so the A operand is read straight out
// of the input window in shared memory: no im2col staging. Each (kt, ky)
// group takes 24 K slots. A block keeps the prepared (64, K) weights in
// shared memory for its life, with K contiguous (B fragments by ldmatrix,
// conflict-free: a row is an odd number of 16-byte chunks), and walks
// output tiles 64 columns wide. Windows (zero-filled outside the clip) come
// in with 16-byte cp.async ahead of the compute; every 16-byte chunk must
// lie wholly inside or outside a clip row, so the wrapper pads W with zero
// columns, which the conv's own zero padding makes exact.
//
// conv1_tc_kernel (bf16): 2-row x 64-column tiles, 4 warps of 32 pixels x
// 64 channels, 2 blocks per SM (63 KB of weights at t=3), the next tile's
// window (t frames x 9 rows x 408 values) double-buffered. Slot 0 of a
// group is the element just before the run (the previous column's last
// channel), slots 1..21 the run, slots 22..23 the next column; slots 0, 22
// and 23 have zero weights. The slot before the run makes every bf16 pair
// start at an even element (a pixel's run starts at an odd one when W is
// even), so a pair is one aligned 32-bit shared-memory load, and 24 = 16 + 8
// is one mma.m16n8k16 plus one mma.m16n8k8: K = 504 at t=3, 1.14x the 441
// MACs. Slots 22..23 are never loaded (their registers are zero); slot 0 is
// loaded, so a non-finite input value also reaches the pixel to its right,
// which the plain conv does not read. A warp's 16 pixels of one row are 3
// words apart: conflict-free A loads. W % 8 == 0. The epilogue rounds to
// bf16, stages the 128 x 64 tile in shared memory (16-byte chunks
// XOR-swizzled by pixel) and writes each pixel's 128-byte row with 16-byte
// stores. 0.902 ms at (2, 8, 800, 1344, 3), t=3 (NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// conv1_tf32_kernel (f32): a TF32 product keeps 10 mantissa bits of each
// operand, about 3 decimal digits: one pass would miss the 1e-4 f32 parity
// bound. So each operand v is split into big = cvt.rna.tf32.f32(v) and
// small = cvt.rna.tf32.f32(v - big), both formed explicitly (the tensor core
// would drop a raw f32's low 13 bits, and small must be the remainder of the
// rounded big), and each k8 step takes big*big + big*small + small*big on
// mma.m16n8k8.tf32: the dropped small*small term is about 2^-22 of a
// product, where one TF32 pass is off by 2^-11. Slot s < 21 of a group is
// run value s, slots 21..23 are padding: 3 k8 steps per (kt, ky), K = 504
// at t=3. The pad slots are zero in registers and never loaded, so a
// non-finite input reaches only the pixels the plain conv reads (the split
// of +-inf gives small = NaN, so where the plain conv gives +-inf the kernel
// may give NaN: the non-finite masks are equal). W % 4 == 0.
//   The sum over K stays on IEEE f32 adds: each k8 step's three products
// start from zero on the tensor core and are then added to the f32
// accumulator, because the tensor core truncates its own sums (PERF.md §6
// gives the error of both orders).
//   What bounds it: instruction issue next to the MMAs. Per k8 step a warp
// (64 pixels x 32 channels) issues 48 MMAs, 64 adds, 8 weight splits, 16
// shared-memory loads of the split clip and 2 ldmatrix. The clip is split
// once per frame window into big and small halves in shared memory (each
// value serves about 11 A fragments), with cvt; the weights are split as
// they are loaded, since both halves of them resident would not fit, on
// their bits (tf32_bits, half the instructions of cvt: 4.70 ms at the
// main shape against 5.03 with cvt, NVIDIA H100 80GB HBM3, 700.00 W,
// chip_smoke.py's [conv1] line), after the block has given every NaN
// weight the one NaN pattern for which the two agree.
//   Layout: 4-row x 64-column tiles, 8 warps (4 rows x 2 channel halves),
// one block per SM: the raw weights (64 x (K + 4) f32, an odd number of
// 16-byte chunks a row, so ldmatrix is conflict-free; 130 KB at t=3), two
// raw frame windows in flight (13 rows x 404 values, 21 KB each) and the
// frame being computed as big and small halves (42 KB) fill 214 KB. Frames
// stream in (tile, frame) order with 16-byte cp.async, two ahead. A
// fragments: fragment rows g and g + 8 are pixels 2g and 2g + 1 of an
// m-tile, 12 and 6 words apart, so a warp's 32 loads hit 32 banks. The
// epilogue needs no shared memory: lanes q and q ^ 1 swap halves of their
// accumulators so that each holds 4 neighbouring channels of one pixel and
// writes them with one 16-byte store. mma.sync rather than wgmma: the A
// fragments come from per-pixel windows and the f32 adds need each step's
// products in registers. Its time at (2, 8, 800, 1344, 3), t=3, against
// the 1.471 ms bound is in PERF.md §6 (chip_smoke.py's [conv1] line).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kCout = 64;   // output channels
constexpr int kK = 7;       // spatial taps

// ---------------------------------------------------------------------------
// Tensor-core implicit GEMM (bf16)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 2;                      // output rows per tile
constexpr int kTcCols = 64;                     // output columns per tile
constexpr int kTcThreads = 128;                 // 4 warps: 2 rows x 2 halves
constexpr int kTcWinRows = 2 * kTcRows + 5;     // input rows per frame (9)
// A window row starts 16 values before clip column 2*ox0 (the 3 columns of
// padding and slot 0, rounded down to a 16-byte chunk), so pixel column c's
// slot s is value 6*c + 6 + s; it holds the 64 pixels' slots 0..23.
constexpr int kTcRowElems = 6 * kTcCols + 24;   // 408 bf16 = 51 chunks
constexpr int kTcRowChunks = kTcRowElems / 8;
constexpr int kTcSlots = 24;                    // K slots per (kt, ky)
constexpr int kTcStageBytes = kTcRows * kTcCols * kCout * 2;  // 16 KB

size_t tc_k(int t) { return static_cast<size_t>(kTcSlots) * kK * t; }
__host__ __device__ inline size_t tc_buf_bytes(int t) {
  const size_t win = static_cast<size_t>(t) * kTcWinRows * kTcRowElems * 2;
  return win > kTcStageBytes ? win : kTcStageBytes;
}
size_t tc_smem_bytes(int t) {
  return kCout * tc_k(t) * 2 + 2 * tc_buf_bytes(t);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_k16(float* d, uint32_t a0, uint32_t a1,
                                        uint32_t a2, uint32_t a3, uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a (16x8, row) * b (8x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_k8(float* d, uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

struct TcTile {
  int bt, oy0, ox0;
};

__device__ __forceinline__ TcTile tc_tile(int tile, int tiles_x,
                                          int tiles_y) {
  TcTile tt;
  const int rest = tile / tiles_x;
  tt.ox0 = (tile - rest * tiles_x) * kTcCols;
  tt.bt = rest / tiles_y;
  tt.oy0 = (rest - tt.bt * tiles_y) * kTcRows;
  return tt;
}

// Queue the cp.async copies of a tile's input window: (t, 9, 408) values,
// row (kt, wy) from frame tau + kt - (t-1)//2, clip row 2*oy0 - 3 + wy,
// values from 6*ox0 - 16 of that row on; zeros outside the clip.
__device__ __forceinline__ void tc_issue_window(
    const __nv_bfloat16* __restrict__ x, uint32_t dst, const TcTile& tt,
    int nT, int H, int W, int t) {
  const int tau = tt.bt % nT;
  const int pad_t = (t - 1) / 2;
  const int row_len = 3 * W;                  // values per clip row
  const int g0 = 6 * tt.ox0 - 16;
  const int total = t * kTcWinRows * kTcRowChunks;
  for (int i = threadIdx.x; i < total; i += kTcThreads) {
    const int r = i / kTcRowChunks;
    const int c = i - r * kTcRowChunks;
    const int kt = r / kTcWinRows;
    const int wy = r - kt * kTcWinRows;
    const int f = tau + kt - pad_t;
    const int iy = 2 * tt.oy0 - 3 + wy;
    const int g = g0 + 8 * c;
    const bool in = f >= 0 && f < nT && iy >= 0 && iy < H && g >= 0 &&
                    g < row_len;
    const __nv_bfloat16* src =
        in ? x + (static_cast<size_t>(tt.bt + kt - pad_t) * H + iy) *
                     row_len + g
           : x;
    cp_async16(dst + 16 * i, src, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kTcThreads, 2)
conv1_tc_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ wk,
                __nv_bfloat16* __restrict__ out, int nT, int H, int W, int Ho,
                int Wo, int t, int tiles_x, int tiles_y, int n_tiles) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int kdim = kTcSlots * kK * t;
  const int buf_bytes = static_cast<int>(tc_buf_bytes(t));
  unsigned char* bufs = tc_smem + kCout * kdim * 2;
  const uint32_t w_s = smem_addr(tc_smem);
  const uint32_t bufs_s = smem_addr(bufs);

  // The weights (64, K), once for the block's life, in the first group.
  for (int i = threadIdx.x; i < kCout * kdim / 8; i += kTcThreads)
    cp_async16(w_s + 16 * i, wk + 8 * i, 16);
  int tile = blockIdx.x;
  tc_issue_window(x, bufs_s, tc_tile(tile, tiles_x, tiles_y), nT, H, W, t);
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;            // fragment row group
  const int q = lane & 3;             // fragment column pair
  const int row = warp >> 1;          // tile row of this warp
  const int px0 = (warp & 1) * 32;    // first tile column of this warp
  // ldmatrix row addresses (bytes into the weights), per lane: the k16
  // part's x4 covers n-tiles (2p, 2p+1) x k halves (0, 8), the k8 part's
  // x4 covers n-tiles 4p..4p+3.
  const uint32_t b16_lane =
      w_s + 2 * ((8 * (lane >> 4) + (lane & 7)) * kdim + ((lane >> 3) & 1) * 8);
  const uint32_t b8_lane = w_s + 2 * ((8 * (lane >> 3) + (lane & 7)) * kdim +
                                      16);

  int cur = 0;
  for (; tile < n_tiles; tile += gridDim.x) {
    const TcTile tt = tc_tile(tile, tiles_x, tiles_y);
    const int next = tile + gridDim.x;
    if (next < n_tiles)
      tc_issue_window(x, bufs_s + (cur ^ 1) * buf_bytes,
                      tc_tile(next, tiles_x, tiles_y), nT, H, W, t);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const unsigned char* win = bufs + cur * buf_bytes;
    float acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;

    for (int kt = 0; kt < t; ++kt) {
#pragma unroll
      for (int ky = 0; ky < kK; ++ky) {
        const int grp = kt * kK + ky;
        uint32_t b16[8][2], b8[8];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          ldmatrix_x4(b16_lane + 2 * (16 * p * kdim + kTcSlots * grp),
                      b16[2 * p][0], b16[2 * p][1], b16[2 * p + 1][0],
                      b16[2 * p + 1][1]);
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldmatrix_x4(b8_lane + 2 * (32 * p * kdim + kTcSlots * grp),
                      b8[4 * p], b8[4 * p + 1], b8[4 * p + 2], b8[4 * p + 3]);
        // Slot 0 of pixel column c of this window row is value 6*c + 6.
        const unsigned char* wrow =
            win + 2 * ((kt * kTcWinRows + 2 * row + ky) * kTcRowElems + 6 +
                       6 * px0 + 2 * q);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const unsigned char* r0 = wrow + 2 * 6 * (16 * m + g);
          const unsigned char* r1 = r0 + 2 * 6 * 8;       // row g + 8
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(r0);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(r1);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(r0 + 16);
          const uint32_t a3 = *reinterpret_cast<const uint32_t*>(r1 + 16);
          // Slots 16..23: pair q = 3 (slots 22, 23) has zero weights.
          const uint32_t c0 =
              q < 3 ? *reinterpret_cast<const uint32_t*>(r0 + 32) : 0u;
          const uint32_t c1 =
              q < 3 ? *reinterpret_cast<const uint32_t*>(r1 + 32) : 0u;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            mma_k16(acc[m][n], a0, a1, a2, a3, b16[n][0], b16[n][1]);
            mma_k8(acc[m][n], c0, c1, b8[n]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with the window: reuse it

    // Stage the bf16 tile, pixel-major with 128-byte rows whose 16-byte
    // chunks are XOR-swizzled by (pixel & 7).
    unsigned char* stage = bufs + cur * buf_bytes;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = row * kTcCols + px0 + 16 * m + g + 8 * h;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[m][n][2 * h], acc[m][n][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              stage + pix * 128 + ((n ^ (pix & 7)) << 4) + 4 * q) = v;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTcRows * kTcCols * 8; i += kTcThreads) {
      const int pix = i >> 3;
      const int ch = i & 7;
      const int oy = tt.oy0 + pix / kTcCols;
      const int ox = tt.ox0 + pix % kTcCols;
      if (oy < Ho && ox < Wo) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            stage + pix * 128 + ((ch ^ (pix & 7)) << 4));
        *reinterpret_cast<uint4*>(
            out + ((static_cast<size_t>(tt.bt) * Ho + oy) * Wo + ox) * kCout +
            8 * ch) = v;
      }
    }
    __syncthreads();   // the staging buffer is the window the next loads fill
    cur ^= 1;
  }
  cp_async_wait<0>();
}

int launch_tc(const void* x, const void* wk, void* out, int B, int nT, int H,
              int W, int Wo, int t, cudaStream_t st) {
  const size_t smem = tc_smem_bytes(t);
  cudaError_t err = cudaFuncSetAttribute(
      conv1_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv1_tc_kernel, kTcThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int Ho = (H + 1) / 2;
  const int tiles_x = (Wo + kTcCols - 1) / kTcCols;
  const int tiles_y = (Ho + kTcRows - 1) / kTcRows;
  const long long n_tiles = static_cast<long long>(tiles_x) * tiles_y * B * nT;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(
      n_tiles < static_cast<long long>(sms) * per_sm ? n_tiles
                                                    : sms * per_sm);
  conv1_tc_kernel<<<grid, kTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wk), static_cast<__nv_bfloat16*>(out),
      nT, H, W, Ho, Wo, t, tiles_x, tiles_y, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// 3-pass TF32 implicit GEMM (f32)
// ---------------------------------------------------------------------------

constexpr int kTfRows = 4;                      // output rows per tile
constexpr int kTfThreads = 64 * kTfRows;        // 8 warps: rows x halves
constexpr int kTfHalf = kCout / 2;              // channels per warp
constexpr int kTfWinRows = 2 * kTfRows + 5;     // input rows per frame (13)
// A window row starts 12 values before clip value 6*ox0 (the 3 columns of
// padding, rounded down to a 16-byte chunk), so pixel column c's slot s is
// value 6*c + 3 + s; it holds the 64 pixels' slots 0..20.
constexpr int kTfRowElems = 6 * kTcCols + 20;   // 404 f32 = 101 chunks
constexpr int kTfRowChunks = kTfRowElems / 4;
constexpr int kTfSlots = 24;                    // K slots per (kt, ky)
constexpr int kTfFrameElems = kTfWinRows * kTfRowElems;
constexpr int kTfFrameBytes = kTfFrameElems * 4;  // 21 KB

// Row stride of the weights in shared memory, in floats: K + 4, an odd
// number of 16-byte chunks (K / 4 = 42 t is even).
__host__ __device__ inline int tf_wstride(int t) {
  return kTfSlots * kK * t + 4;
}
// The weights, two raw frame windows in flight, and the frame being
// computed as big and small halves.
size_t tf_smem_bytes(int t) {
  return static_cast<size_t>(kCout) * tf_wstride(t) * 4 + 4 * kTfFrameBytes;
}

// The TF32 value nearest v (ties away from zero), in an f32 register.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// cvt.rna.tf32.f32 on the bits, in 2 instructions where cvt takes about 4
// (a compare, an add, a mask, a select): round the magnitude half up at
// bit 13, clear the 13 low bits. It equals cvt for every finite and
// infinite value and for the quiet NaN 0x7fc00000, which the kernel gives
// every NaN weight (another NaN could carry into the sign and become 0).
__device__ __forceinline__ uint32_t tf32_bits(uint32_t v) {
  return (v + 0x1000u) & 0xffffe000u;
}

// d = a (16x8, row) * b (8x8, col) + c, tf32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b, const float* c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ TcTile tf_tile(int tile, int tiles_x,
                                          int tiles_y) {
  TcTile tt;
  const int rest = tile / tiles_x;
  tt.ox0 = (tile - rest * tiles_x) * kTcCols;
  tt.bt = rest / tiles_y;
  tt.oy0 = (rest - tt.bt * tiles_y) * kTfRows;
  return tt;
}

// Queue the cp.async copies of one frame of a tile's f32 input window:
// (13, 404) values, row wy from frame tau + kt - (t-1)//2, clip row
// 2*oy0 - 3 + wy, values from 6*ox0 - 12 of that row on; zeros outside
// the clip.
__device__ __forceinline__ void tf_issue_frame(const float* __restrict__ x,
                                               uint32_t dst, const TcTile& tt,
                                               int kt, int nT, int H, int W,
                                               int t) {
  const int f = tt.bt % nT + kt - (t - 1) / 2;
  const bool frame_in = f >= 0 && f < nT;
  const int row_len = 3 * W;                  // values per clip row
  const int g0 = 6 * tt.ox0 - 12;
  const float* base =
      frame_in ? x + static_cast<size_t>(tt.bt + kt - (t - 1) / 2) * H *
                         row_len
               : x;
  for (int i = threadIdx.x; i < kTfWinRows * kTfRowChunks;
       i += kTfThreads) {
    const int wy = i / kTfRowChunks;
    const int g = g0 + 4 * (i - wy * kTfRowChunks);
    const int iy = 2 * tt.oy0 - 3 + wy;
    const bool in = frame_in && iy >= 0 && iy < H && g >= 0 && g < row_len;
    cp_async16(dst + 16 * i,
               in ? base + static_cast<size_t>(iy) * row_len + g : x,
               in ? 16 : 0);
  }
}

// Frame windows stream in (tile, kt) order, "jobs"; job j of this block is
// frame j % t of its tile j / t. Raw windows land in 2 slots; each job's
// window is split once into big and small halves, which the warps read.
// Warp w computes tile row w / 2 (64 pixels) x channels 32 (w % 2) .. +31.
__global__ void __launch_bounds__(kTfThreads, 1)
conv1_tf32_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                  float* __restrict__ out, int nT, int H, int W, int Ho,
                  int Wo, int t, int tiles_x, int tiles_y, int n_tiles) {
  extern __shared__ __align__(16) unsigned char tf_smem[];
  const int kdim = kTfSlots * kK * t;
  const int ws = tf_wstride(t);
  const float* raw = reinterpret_cast<const float*>(tf_smem + kCout * ws * 4);
  uint32_t* big_s = reinterpret_cast<uint32_t*>(tf_smem + kCout * ws * 4 +
                                                2 * kTfFrameBytes);
  uint32_t* small_s = big_s + kTfFrameElems;
  const uint32_t w_s = smem_addr(tf_smem);
  const uint32_t raw_s = smem_addr(raw);
  const int my_tiles = (n_tiles - 1 - static_cast<int>(blockIdx.x)) /
                           static_cast<int>(gridDim.x) + 1;
  const int jobs = my_tiles * t;
  auto issue = [&](int j) {
    if (j < jobs)
      tf_issue_frame(x, raw_s + (j & 1) * kTfFrameBytes,
                     tf_tile(blockIdx.x + (j / t) * gridDim.x, tiles_x,
                             tiles_y),
                     j % t, nT, H, W, t);
    cp_async_commit();
  };

  // The weights (64, K) into rows of ws floats, once for the block's life,
  // in the first group with job 0.
  const int row_chunks = kdim / 4;
  for (int i = threadIdx.x; i < kCout * row_chunks; i += kTfThreads)
    cp_async16(w_s + 16 * (i + i / row_chunks), wk + 4 * i, 16);
  issue(0);
  issue(1);

  const int warp = threadIdx.x >> 5;
  const int row = warp >> 1;          // tile row: 64 pixels
  const int half = warp & 1;          // channels 32 half .. +31
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;            // fragment row group
  const int q = lane & 3;             // fragment column
  // ldmatrix row addresses (bytes into the weights), per lane: x4 number p
  // covers n-tiles (2p, 2p+1) of the half x k halves (0..3, 4..7) of a k8
  // step; one 8x8 b16 matrix is 8 channels x 4 f32 k values.
  const uint32_t b_lane =
      w_s + 4 * ((kTfHalf * half + 8 * (lane >> 4) + (lane & 7)) * ws +
                 4 * ((lane >> 3) & 1));
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  float acc[4][4][4];
  for (int j = 0; j < jobs; ++j) {
    cp_async_wait<1>();               // job j (and the weights) landed
    __syncthreads();                  // ... for every thread; job j-1 done
    // Split the frame once: big = cvt.rna(v), small = cvt.rna(v - big).
    const float* src = raw + (j & 1) * kTfFrameElems;
    for (int i = threadIdx.x; i < kTfFrameElems; i += kTfThreads) {
      const float v = src[i];
      const uint32_t b = to_tf32(v);
      big_s[i] = b;
      small_s[i] = to_tf32(v - __uint_as_float(b));
    }
    if (j == 0) {                     // every NaN weight: 0x7fc00000
      uint32_t* w = reinterpret_cast<uint32_t*>(tf_smem);
      for (int i = threadIdx.x; i < kCout * ws; i += kTfThreads)
        if ((w[i] & 0x7fffffffu) > 0x7f800000u) w[i] = 0x7fc00000u;
    }
    __syncthreads();                  // the halves are in; the slot is free
    issue(j + 2);
    const int kt = j % t;
    if (kt == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
    }
    for (int ky = 0; ky < kK; ++ky) {
      const int grp = kt * kK + ky;
      // Fragment row g of m-tile m is pixel 16m + 2g of this tile row, row
      // g + 8 pixel 16m + 2g + 1; slot s of pixel column c is value
      // 6*c + 3 + s of the window row.
      const int a_off = (2 * row + ky) * kTfRowElems + 3 + 6 * 2 * g + q;
#pragma unroll
      for (int js = 0; js < 3; ++js) {
        // B, split as loaded, on the bits.
        uint32_t bb[4][2], bs[4][2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4(b_lane + 4 * (16 * p * ws + kTfSlots * grp + 8 * js),
                      r[0], r[1], r[2], r[3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t b = tf32_bits(r[e]);
            bb[2 * p + (e >> 1)][e & 1] = b;
            bs[2 * p + (e >> 1)][e & 1] = tf32_bits(__float_as_uint(
                __uint_as_float(r[e]) - __uint_as_float(b)));
          }
        }
        // Slots 8js + q + 4 of step 2 are 20..23: only q = 0 is a value.
        const bool upper = js < 2 || q == 0;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int o = a_off + 6 * 16 * m + 8 * js;
          const uint32_t ab[4] = {big_s[o], big_s[o + 6],
                                  upper ? big_s[o + 4] : 0u,
                                  upper ? big_s[o + 10] : 0u};
          const uint32_t as[4] = {small_s[o], small_s[o + 6],
                                  upper ? small_s[o + 4] : 0u,
                                  upper ? small_s[o + 10] : 0u};
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            // The three products of this k8 step from zero, then one f32
            // add: the tensor core truncates its sums, so the long sum
            // over K stays on IEEE adds.
            float d[4];
            mma_tf32(d, ab, bb[n], zero);
            mma_tf32(d, ab, bs[n], d);
            mma_tf32(d, as, bb[n], d);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] += d[e];
          }
        }
      }
    }
    if (kt < t - 1) continue;

    // The tile is done: lanes q and q ^ 1 swap halves so that each holds 4
    // neighbouring channels of one pixel (even q: fragment row g, odd q:
    // row g + 8) and writes them with one 16-byte store; a pixel's 256-byte
    // row takes 16 of them (8 from each half's warp), two lanes per 32-byte
    // sector.
    const TcTile tt =
        tf_tile(blockIdx.x + (j / t) * gridDim.x, tiles_x, tiles_y);
    const bool odd = q & 1;
    const int oy = tt.oy0 + row;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int ox = tt.ox0 + 16 * m + 2 * g + odd;
      float* dst = out + ((static_cast<size_t>(tt.bt) * Ho + oy) * Wo + ox) *
                             kCout + kTfHalf * half + 2 * (q & 2);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* a = acc[m][n];
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
        if (oy < Ho && ox < Wo)
          *reinterpret_cast<float4*>(dst + 8 * n) =
              odd ? make_float4(s0, s1, a[2], a[3])
                  : make_float4(a[0], a[1], s0, s1);
      }
    }
  }
  cp_async_wait<0>();
}

int launch_tf32(const void* x, const void* wk, void* out, int B, int nT,
                int H, int W, int Wo, int t, cudaStream_t st) {
  const size_t smem = tf_smem_bytes(t);
  cudaError_t err = cudaFuncSetAttribute(
      conv1_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, conv1_tf32_kernel, kTfThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int Ho = (H + 1) / 2;
  const int tiles_x = (Wo + kTcCols - 1) / kTcCols;
  const int tiles_y = (Ho + kTfRows - 1) / kTfRows;
  const long long n_tiles = static_cast<long long>(tiles_x) * tiles_y * B * nT;
  if (n_tiles * t > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(
      n_tiles < static_cast<long long>(sms) * per_sm ? n_tiles
                                                    : sms * per_sm);
  conv1_tf32_kernel<<<grid, kTfThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(wk),
      static_cast<float*>(out), nT, H, W, Ho, Wo, t, tiles_x, tiles_y,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* dat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory one block of the tensor-core kernel needs.
long long dat_conv1_tc_smem_bytes(int t) {
  return static_cast<long long>(tc_smem_bytes(t));
}

// The bf16 tensor-core kernel. x: contiguous bf16 (B, T, H, W, 3) with
// W % 8 == 0 (zero columns past the clip's own width are exact); wk: the
// prepared bf16 (64, 24 * 7 * t) weight matrix (kernels/conv1.py::
// conv1_tc_weights), 16-byte aligned; out: bf16 (B, T, ceil(H/2), Wo, 64),
// Wo = ceil(W_clip/2). Returns a cudaError_t.
int dat_conv1_tc(const void* x, const void* wk, void* out, int B, int nT,
                 int H, int W, int Wo, int t, void* stream) {
  if (t < 1 || B < 1 || nT < 1 || H < 1 || W < 8 || W % 8 != 0 || Wo < 1 ||
      2 * Wo > W + 1 || (reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(wk) |
                         reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc(x, wk, out, B, nT, H, W, Wo, t,
                   static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one block of the 3-pass TF32 kernel needs; the
// caller rejects t whose weights and windows do not fit the 227 KB a block
// may use (t <= 3).
long long dat_conv1_tf32_smem_bytes(int t) {
  return static_cast<long long>(tf_smem_bytes(t));
}

// The f32 3-pass TF32 kernel. x: contiguous f32 (B, T, H, W, 3) with
// W % 4 == 0 (zero columns past the clip's own width are exact); wk: the
// prepared f32 (64, 24 * 7 * t) weight matrix (kernels/conv1.py::
// conv1_tf32_weights), 16-byte aligned; out: f32 (B, T, ceil(H/2), Wo, 64),
// Wo = ceil(W_clip/2). Returns a cudaError_t.
int dat_conv1_tf32(const void* x, const void* wk, void* out, int B, int nT,
                   int H, int W, int Wo, int t, void* stream) {
  if (t < 1 || B < 1 || nT < 1 || H < 1 || W < 4 || W % 4 != 0 || Wo < 1 ||
      2 * Wo > W + 1 || (reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(wk) |
                         reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tf32(x, wk, out, B, nT, H, W, Wo, t,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
