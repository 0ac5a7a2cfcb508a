// The two data-dependent NMS loops on the device, for Hopper (sm_90a):
// greedy NMS's keep sweep (nms_keep) and soft-NMS's confirmation rounds
// (soft_nms_confirm). Both run the whole loop inside one launch, so a
// request never waits on the host for a loop's end.
//
// Replaces: the `jax.lax.while_loop`s of detectandtrack_tpu/ops/nms.py,
// `nms_fixed` (the Jacobi fixpoint, :79-89) and `soft_nms_fixed` (the
// bulk-confirmation fixpoint, :152-178). The TPU runs each round as one
// dense O(N^2) masked reduction on the VPU and loops on the device. Here
// greedy NMS is a sequential sweep over the score-sorted boxes, one warp
// per lane, which gives the fixpoint's result (its unique solution) in one
// pass; soft-NMS keeps the rounds, one block per lane, and ends on a
// block-wide "nothing new" vote.
//
// What bounds them on the H100: latency, not bytes or operations. The
// sweep is a chain of N dependent decisions; a round of soft-NMS is a
// block's pass over its lane's N x N matrices, and the rounds are
// dependent. The byte bound (the suppression matrix read once, the keep
// mask written once: 10 MB and 3 us for the RPN's 10 lanes of 1000) is far
// below either chain.
//
// nms_keep: the wrapper gives the strictly upper-triangular suppression
// matrix supp (L, N, N) as bytes (torch bool) and valid (L, N). A first
// kernel packs each row into 64-bit words (bit c of word w = supp[.., 64w+c],
// one __ballot_sync per 32 bytes, coalesced) into scratch (L, N, W). The
// sweep keeps "removed" (W words) in shared memory, lane w % 32 owning word
// w: box i is kept iff valid and its removed bit is clear, and a kept box
// ORs its packed row into removed. The packed rows are loaded R rows ahead
// of the decisions (registers, double-buffered chunks), so a decision waits
// on a shared-memory read and a __syncwarp, not on a global load.
//
// soft_nms_confirm: per round, thread i (strided over columns) takes the
// product of the decays of its confirmed overlappers in a fixed order —
// chunks of kProdChunk rows in index order, each chunk's product taken
// in index order from 1, the chunk products multiplied in index order
// from 1 — then prov(i) = s_i * product; then tests whether an unconfirmed
// alive overlapper outranks it on (prov, -index). The plain version,
// kernels/nms.py::soft_nms_confirm_reference, multiplies in exactly that
// order, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProdChunk = 32;      // soft_nms_confirm's product chunk
constexpr int kSoftThreads = 512;

// Bit c of word w of row r = (supp[r, 64 w + c] != 0); one warp a row.
__global__ void nms_pack_kernel(const uint8_t* __restrict__ supp,
                                unsigned long long* __restrict__ bits,
                                long long rows, int N, int W) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long r = warp; r < rows; r += n_warps) {
    const uint8_t* row = supp + r * N;
    unsigned long long* out = bits + r * W;
    for (int w = 0; w < W; ++w) {
      const int c0 = 64 * w + lane, c1 = c0 + 32;
      const unsigned lo = __ballot_sync(0xffffffffu, c0 < N && row[c0] != 0);
      const unsigned hi = __ballot_sync(0xffffffffu, c1 < N && row[c1] != 0);
      if (lane == 0)
        out[w] = (static_cast<unsigned long long>(hi) << 32) | lo;
    }
  }
}

// Words per lane KW (each lane owns words lane + 32 k), rows a chunk R.
template <int KW, int R>
__device__ __forceinline__ void load_chunk(
    const unsigned long long* __restrict__ bits, int base, int N, int W,
    int lane, unsigned long long (&buf)[KW][R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int w = lane + 32 * k;
      const int i = base + j;
      buf[k][j] = (i < N && w < W) ? bits[static_cast<long long>(i) * W + w]
                                   : 0ull;
    }
  }
}

// One warp per lane: the greedy sweep over the lane's N sorted boxes.
template <int KW, int R>
__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ bits,
                                 const uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ kept, int N, int W) {
  extern __shared__ unsigned long long removed[];     // W words
  const int lane = threadIdx.x;
  const long long l = blockIdx.x;
  const unsigned long long* lb = bits + l * N * static_cast<long long>(W);
  const uint8_t* lv = valid + l * N;
  uint8_t* lk = kept + l * N;
  for (int w = lane; w < W; w += 32) removed[w] = 0ull;
  __syncwarp();

  unsigned long long cur[KW][R], nxt[KW][R];
  load_chunk<KW, R>(lb, 0, N, W, lane, cur);
  for (int base = 0; base < N; base += R) {
    load_chunk<KW, R>(lb, base + R, N, W, lane, nxt);
    // The chunk's valid bytes, one per lane, broadcast by shuffle.
    const int v_mine = (lane < R && base + lane < N) ? lv[base + lane] : 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = base + j;
      const bool v = __shfl_sync(0xffffffffu, v_mine, j) != 0;
      const bool keep =
          i < N && v && !((removed[i >> 6] >> (i & 63)) & 1ull);
      __syncwarp();                 // every lane has read word i >> 6
      if (i < N) {
        if (keep) {
#pragma unroll
          for (int k = 0; k < KW; ++k) {
            const int w = lane + 32 * k;
            if (w < W) removed[w] |= cur[k][j];
          }
        }
        if (lane == 0) lk[i] = keep ? 1 : 0;
      }
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int k = 0; k < KW; ++k) cur[k][j] = nxt[k][j];
  }
}

template <int KW, int R>
cudaError_t launch_sweep(const unsigned long long* bits, const uint8_t* valid,
                         uint8_t* kept, int L, int N, int W,
                         cudaStream_t st) {
  nms_sweep_kernel<KW, R><<<L, 32, W * sizeof(unsigned long long), st>>>(
      bits, valid, kept, N, W);
  return cudaGetLastError();
}

// One block per lane: soft-NMS's confirmation rounds until one confirms
// nothing (at most N + 1 rounds: every round but the last confirms the
// lane's prov-argmax at least).
__global__ void soft_nms_confirm_kernel(const float* __restrict__ scores,
                                        const float* __restrict__ dmat,
                                        const uint8_t* __restrict__ overlaps,
                                        const uint8_t* __restrict__ alive,
                                        float* __restrict__ final_scores,
                                        int N, float neg_inf) {
  extern __shared__ unsigned char smem[];
  float* prov = reinterpret_cast<float*>(smem);                // N
  uint8_t* conf = reinterpret_cast<uint8_t*>(prov + N);        // N
  uint8_t* live = conf + N;                                    // N
  uint8_t* fresh = live + N;                                   // N
  const long long l = blockIdx.x;
  const float* s = scores + l * N;
  const float* d = dmat + l * N * static_cast<long long>(N);
  const uint8_t* ov = overlaps + l * N * static_cast<long long>(N);
  float* fin = final_scores + l * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    conf[i] = 0;
    fresh[i] = 0;
    live[i] = alive[l * N + i];
    fin[i] = neg_inf;
  }
  __syncthreads();
  for (int round = 0; round <= N; ++round) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      float p = 1.0f;
      for (int j0 = 0; j0 < N; j0 += kProdChunk) {
        float q = 1.0f;
        const int j1 = min(j0 + kProdChunk, N);
        for (int j = j0; j < j1; ++j) {
          const long long at = static_cast<long long>(j) * N + i;
          if (conf[j] && ov[at]) q = q * d[at];
        }
        p = p * q;
      }
      prov[i] = s[i] * p;
    }
    __syncthreads();
    int any_new = 0;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      if (conf[i] || !live[i]) continue;
      const float pi = prov[i];
      bool outranked = false;
      for (int j = 0; j < N && !outranked; ++j) {
        if (conf[j] || !live[j]) continue;
        const float pj = prov[j];
        outranked = ov[static_cast<long long>(j) * N + i] &&
                    (pj > pi || (pj == pi && j < i));
      }
      if (!outranked) {
        fin[i] = pi;
        fresh[i] = 1;
        any_new = 1;
      }
    }
    // Every thread has read conf for this round; now mark the new ones.
    any_new = __syncthreads_or(any_new);
    if (!any_new) break;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      conf[i] |= fresh[i];
      fresh[i] = 0;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* dat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kept (L, N) bytes from supp (L, N, N) bytes and valid (L, N) bytes;
// bits is scratch of L * N * ceil(N / 64) words. N <= 32768.
int dat_nms_keep(const void* supp, const void* valid, void* bits, void* kept,
                 int L, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const int W = (N + 63) / 64;
  if (W > 32 * 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(L) * N;
  const long long blocks = (rows + 7) / 8;                 // 8 warps a block
  nms_pack_kernel<<<static_cast<int>(blocks < 65535 * 16 ? blocks
                                                         : 65535 * 16),
                    256, 0, st>>>(static_cast<const uint8_t*>(supp),
                                  static_cast<unsigned long long*>(bits),
                                  rows, N, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* b = static_cast<const unsigned long long*>(bits);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* k = static_cast<uint8_t*>(kept);
  if (W <= 32) err = launch_sweep<1, 8>(b, v, k, L, N, W, st);
  else if (W <= 64) err = launch_sweep<2, 8>(b, v, k, L, N, W, st);
  else if (W <= 128) err = launch_sweep<4, 4>(b, v, k, L, N, W, st);
  else if (W <= 256) err = launch_sweep<8, 2>(b, v, k, L, N, W, st);
  else err = launch_sweep<16, 1>(b, v, k, L, N, W, st);
  return static_cast<int>(err);
}

// final (L, N) f32 from scores (L, N) f32, dmat (L, N, N) f32, overlaps
// (L, N, N) bytes and alive (L, N) bytes; unconfirmed entries get neg_inf.
int dat_soft_nms_confirm(const void* scores, const void* dmat,
                         const void* overlaps, const void* alive,
                         void* final_scores, int L, int N, float neg_inf,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(N) * (sizeof(float) + 3);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = N < kSoftThreads ? ((N + 31) / 32) * 32 : kSoftThreads;
  soft_nms_confirm_kernel<<<L, threads, smem, st>>>(
      static_cast<const float*>(scores), static_cast<const float*>(dmat),
      static_cast<const uint8_t*>(overlaps),
      static_cast<const uint8_t*>(alive), static_cast<float*>(final_scores),
      N, neg_inf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
