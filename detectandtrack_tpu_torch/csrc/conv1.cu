// conv1 of the inflated ResNet (7x7, stride 2, pad 3, t temporal taps) for
// Hopper (sm_90a): a tensor-core implicit GEMM for bf16 (conv1_tc_kernel)
// and a CUDA-core direct convolution for f32 (conv1_kernel).
//
// Replaces: detectandtrack_tpu/kernels/conv1.py::conv1_s2d_pallas (kernel
// body _conv1_kernel). The TPU kernel folds the 7x7xt window into the MXU
// contraction through a space-to-depth relayout prepared by XLA, and needs
// even H, W and an aligned row block. Here a block reads its input window
// straight from the (B, T, H, W, 3) clip, zero-filling the temporal
// ((t-1)//2, t//2) and spatial (3, 3) padding itself, so any H, W and T work.
//
// What bounds it on the H100: arithmetic. conv1 is 2*441*64 FLOP per output
// pixel at t=3 (243 GFLOP for a B=2, T=8, 800x1344 clip: 0.246 ms at the
// 989 TFLOP/s bf16 tensor-core peak; its 103 MB in and 551 MB out take
// 0.195 ms at 3.35 TB/s). On the CUDA cores' 67 TFLOP/s f32 it cannot go
// below 3.6 ms, so bf16 runs on the tensor cores.
//
// conv1_tc_kernel (bf16): an implicit GEMM, M = output pixels, N = the 64
// channels, K ordered (kt, ky, kx, ci). For one (kt, ky) a pixel's 21 values
// (kx, ci) are one contiguous run of its clip row, x from 2*ox-3 to 2*ox+3,
// so the A operand is read straight out of the input window in shared
// memory: no im2col staging. Each (kt, ky) group takes 24 K slots: slot 0
// is the element just before the run (the previous column's last channel),
// slots 1..21 the run, slots 22..23 the next column; slots 0, 22 and 23 have
// zero weights. The slot before the run makes every bf16 pair start at an
// even element (a pixel's run starts at an odd one when W is even), so a
// pair is one aligned 32-bit shared-memory load, and 24 = 16 + 8 is one
// mma.m16n8k16 plus one mma.m16n8k8: K = 504 at t=3, 1.14x the 441 MACs
// (padding each group to 32 would cost 1.52x). Slots 22..23 are never loaded
// (their registers are zero); slot 0 is loaded, so a non-finite input value
// also reaches the pixel to its right, which the plain conv does not read.
// The MMA is mma.sync (bf16 -> f32) from registers: the A fragments come
// from 32-bit loads of the window (conflict-free: a warp's 16 pixels of one
// row are 3 words apart), the B fragments from ldmatrix on the weight
// matrix, stored (64, K) with K contiguous (its row stride, 63 or 21 16-byte
// chunks, is odd, so ldmatrix is conflict-free). A persistent block (2 per
// SM) keeps the prepared (64, K) bf16 weights (63 KB at t=3) in shared
// memory for its life and walks 2-row x 64-column output tiles: 4 warps,
// each 32 pixels x 64 channels. Each tile's input window (t frames x 9
// rows x 408 values, zero-filled outside the clip) comes in with 16-byte
// cp.async, double-buffered: the next tile's window loads while this one
// computes. That needs W % 8 == 0 (every 16-byte chunk lies wholly inside
// or outside the clip row); the wrapper pads W with zero columns, which the
// conv's own zero padding makes exact. The epilogue rounds to bf16, stages
// the 128 x 64 tile in shared memory (16-byte chunks XOR-swizzled by pixel,
// conflict-free) and writes each pixel's 128-byte row with 16-byte stores.
// Left for later: wgmma (the full tensor-core rate; mma.sync reaches about
// two thirds of it), TMA loads, and the frozen-BN affine + ReLU epilogue.
//
// conv1_kernel (f32, and bf16 for comparison): the whole t*7*7*3 x 64
// weight slab (113 KB in f32 at t=3) and the tile's input window live in
// dynamic shared memory, loaded once per block. A block computes an 8x32
// tile of output pixels x 64 channels with 256 threads; each thread owns 4
// neighbouring pixels x 16 channels, so every 16-channel weight vector read
// from shared memory feeds 64 FMAs. f32 stays off the tensor cores: TF32
// would miss the 1e-4 f32 parity bound. Accumulation is f32, the output has
// the input dtype.

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

}  // extern "C"
