// The epilogue of every conv of the inference path in one pass, for Hopper
// (sm_90a): out = act(y * s + b [+ r * s_r + b_r | + r]) over a conv output
// y in the port's channels-last (..., C) layout, written over y.
//
// Replaces no Pallas kernel. In the JAX package the frozen-BN affine (flax
// AffineChannel), a conv's bias, the residual or top-down add and the ReLU
// are XLA elementwise ops that XLA fuses into the conv's consumers. PyTorch
// runs each as its own pass over the conv output: two for an affine (the
// per-channel broadcasts, through its strided elementwise kernel), one for
// a bias, one for an add, one for a ReLU. This kernel does them all in one
// read of y (and of the shortcut r) and one write.
//
// What bounds it on the H100: bytes. It does a few operations a byte, so
// its least time is the bytes it moves (y read and written, r read once)
// over 3.35 TB/s. The design serves that bound:
// - 16-byte loads and stores, 8 bf16 or 4 f32 channels a thread, with
//   neighbouring threads on neighbouring addresses (a scalar path takes C
//   not a multiple of that, such as the RPN's 3 logits, or an unaligned
//   operand).
// - Each block owns a contiguous chunk of y, 16 packs a thread, so the
//   blocks resident at a time read and write neighbouring memory (a
//   grid-stride loop over the whole tensor, tried first, reached 82-86% of
//   the bound against 88-91%). A block's stride is a multiple of the
//   channel groups, so a thread always sees the same channels: it loads
//   their f32 scale and bias (and the shortcut's) into registers once, and
//   the loop carries no division. Four packs in flight a thread.
// - The shortcut is read as the caller has it: at y's shape, or at half its
//   H and W for the FPN's nearest x2 top-down add (the upsampled tensor is
//   never made); with its own per-channel affine for a projection
//   shortcut, so the projection's conv output is read raw.
// - The op chain's arithmetic, in its order (kernels/affine.py's plain
//   version: y * s, + b, + (r * s_r + b_r) or + r, ReLU): each operation in
//   f32 and rounded to y's type, as a bf16 op of PyTorch or of XLA on the
//   CPU rounds, with s and b rounded to it first, as the chain's casts do
//   (the intrinsics keep nvcc from contracting a * b + c into an FMA). So
//   the kernel equals the plain version and the chain bit for bit, and the
//   bf16 port keeps the JAX package's rounding.
//
// y is written in place: it is a conv's fresh output that nothing else
// holds, so the pass allocates nothing (and a CUDA graph's pool holds one
// tensor less at each site).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kPacks = 16;  // packs a thread: a multiple of 2 and 4

enum Shortcut { kNone = 0, kPlain = 1, kAffine = 2 };

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// A pack moves as one access: 16 bytes as a uint4 (ld/st.global.v4).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const Pack<T, V>* p) {
  Pack<T, V> out;
  if constexpr (sizeof(Pack<T, V>) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    memcpy(&out, &raw, 16);
  } else {
    out = *p;
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void store(Pack<T, V>* p, const Pack<T, V>& v) {
  if constexpr (sizeof(Pack<T, V>) == 16) {
    uint4 raw;
    memcpy(&raw, &v, 16);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *p = v;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T (and back): one operation of the chain in T.
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// y: n packs of V channels, cv packs a position. Block x owns the packs
// [x * chunk, x * chunk + chunk), kPacks a thread; its thread t < sb (a
// multiple of cv) owns channel group t % cv and the packs x * chunk + t +
// m * sb, kUnroll of them in flight (two where the shortcut is upsampled:
// its index arithmetic takes the registers). With UP the
// shortcut is at (H / 2, W / 2) of y's (H, W): pack i of y at position
// p = i / cv = p0 + m * (sb / cv) reads the shortcut at the position of
// (n, h / 2, w / 2).
template <typename T, int V, int SC, bool UP>
__global__ void __launch_bounds__(kMaxThreads)
affine_elementwise_kernel(Pack<T, V>* __restrict__ y,
                          const Pack<T, V>* __restrict__ r,
                          const float* __restrict__ s,
                          const float* __restrict__ b,
                          const float* __restrict__ sr,
                          const float* __restrict__ br, long long n, int cv,
                          int sb, long long chunk, unsigned H, unsigned W,
                          int relu) {
  constexpr int kUnroll = UP ? 2 : 4;
  const int t = threadIdx.x;
  if (t >= sb) return;
  const int g = t % cv;
  float ks[V], kb[V], krs[V], krb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    ks[k] = s != nullptr ? rnd<T>(s[g * V + k]) : 1.0f;
    kb[k] = rnd<T>(b[g * V + k]);
    if (SC == kAffine) {
      krs[k] = rnd<T>(sr[g * V + k]);
      krb[k] = rnd<T>(br[g * V + k]);
    }
  }
  const long long first = static_cast<long long>(blockIdx.x) * chunk;
  const long long start = first + t;
  const long long end = first + chunk < n ? first + chunk : n;
  const unsigned long long p0 = static_cast<unsigned long long>(start / cv);
  const unsigned long long pstep = static_cast<unsigned long long>(sb / cv);
  for (long long m0 = 0;; m0 += kUnroll) {
    const long long base = start + m0 * sb;
    if (base >= end) break;
    Pack<T, V> a[kUnroll], rr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * sb;
      if (i < end) {
        a[u] = load(y + i);
        if (SC != kNone) {
          long long j = i;
          if (UP) {
            // positions fit 32 bits (the wrapper checks)
            const unsigned p =
                static_cast<unsigned>(p0 + (m0 + u) * pstep);
            const unsigned w = p % W, q = p / W;
            const unsigned h = q % H, img = q / H;
            const unsigned long long rp =
                (static_cast<unsigned long long>(img) * (H / 2) + h / 2) *
                    (W / 2) + w / 2;
            j = static_cast<long long>(rp) * cv + g;
          }
          rr[u] = load(r + j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * sb;
      if (i < end) {
        Pack<T, V> o;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          // y * 1 is y: a bias-only pass is y + b
          float v = rnd<T>(__fmul_rn(to_f32(a[u].v[k]), ks[k]));
          v = rnd<T>(__fadd_rn(v, kb[k]));
          if (SC == kPlain) v = rnd<T>(__fadd_rn(v, to_f32(rr[u].v[k])));
          if (SC == kAffine) {
            float q = rnd<T>(__fmul_rn(to_f32(rr[u].v[k]), krs[k]));
            q = rnd<T>(__fadd_rn(q, krb[k]));
            v = rnd<T>(__fadd_rn(v, q));
          }
          if (relu && v < 0.0f) v = 0.0f;  // NaN stays NaN, as torch.relu
          o.v[k] = from_f32<T>(v);
        }
        store(y + i, o);
      }
    }
  }
}

template <typename T, int V, int SC, bool UP>
cudaError_t launch(void* y, const void* r, const float* s, const float* b,
                   const float* sr, const float* br, long long rows, int C,
                   int H, int W, int relu, cudaStream_t st) {
  const int cv = C / V;
  const long long n = rows * cv;
  // a block of 256 threads, or of cv rounded up to a warp past that
  const int threads = cv <= 256 ? 256 : (cv + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  const int sb = threads / cv * cv;
  const long long chunk = static_cast<long long>(sb) * kPacks;
  const long long blocks = (n + chunk - 1) / chunk;
  affine_elementwise_kernel<T, V, SC, UP><<<static_cast<unsigned>(blocks),
                                            threads, 0, st>>>(
      static_cast<Pack<T, V>*>(y), static_cast<const Pack<T, V>*>(r), s, b,
      sr, br, n, cv, sb, chunk, static_cast<unsigned>(H),
      static_cast<unsigned>(W), relu);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dispatch(void* y, const void* r, const float* s, const float* b,
                     const float* sr, const float* br, long long rows, int C,
                     int H, int W, int up, int relu, cudaStream_t st) {
  if (r == nullptr)
    return launch<T, V, kNone, false>(y, r, s, b, sr, br, rows, C, H, W,
                                      relu, st);
  if (sr == nullptr)
    return up ? launch<T, V, kPlain, true>(y, r, s, b, sr, br, rows, C, H, W,
                                           relu, st)
              : launch<T, V, kPlain, false>(y, r, s, b, sr, br, rows, C, H,
                                            W, relu, st);
  return up ? launch<T, V, kAffine, true>(y, r, s, b, sr, br, rows, C, H, W,
                                          relu, st)
            : launch<T, V, kAffine, false>(y, r, s, b, sr, br, rows, C, H, W,
                                           relu, st);
}

}  // namespace

extern "C" {

const char* dat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y (rows, C) of `bf16` (1) or f32 (0), contiguous, overwritten with
// act(y * s + b [+ r * sr + br | + r]). s (may be null: 1), b: f32 (C,).
// r (may be null): y's dtype, contiguous, (rows, C); with `up`, rows = N * H
// * W of y and r is (N, H / 2, W / 2, C) (H, W even, N * H * W < 2^32).
// sr, br: both or neither, f32 (C,). `vec`: 16-byte packs (C a multiple of
// 8 bf16 or 4 f32 channels, y and r 16-byte aligned), else one channel a
// thread.
int dat_affine_epilogue(void* y, const void* r, const void* s, const void* b,
                        const void* sr, const void* br, long long rows, int C,
                        int H, int W, int up, int relu, int bf16, int vec,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  if (b == nullptr || (sr == nullptr) != (br == nullptr) ||
      (r == nullptr && (sr != nullptr || up)) ||
      (up && (H <= 0 || W <= 0 || H % 2 || W % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* fs = static_cast<const float*>(s);
  const auto* fb = static_cast<const float*>(b);
  const auto* fsr = static_cast<const float*>(sr);
  const auto* fbr = static_cast<const float*>(br);
  cudaError_t err;
  if (bf16)
    err = vec ? dispatch<__nv_bfloat16, 8>(y, r, fs, fb, fsr, fbr, rows, C, H,
                                           W, up, relu, st)
              : dispatch<__nv_bfloat16, 1>(y, r, fs, fb, fsr, fbr, rows, C, H,
                                           W, up, relu, st);
  else
    err = vec ? dispatch<float, 4>(y, r, fs, fb, fsr, fbr, rows, C, H, W, up,
                                   relu, st)
              : dispatch<float, 1>(y, r, fs, fb, fsr, fbr, rows, C, H, W, up,
                                   relu, st);
  return static_cast<int>(err);
}

}  // extern "C"
