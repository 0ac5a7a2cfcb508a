// The two data-dependent NMS loops on the device, for Hopper (sm_90a):
// greedy NMS from the score-sorted boxes to the keep mask (nms_keep) and
// soft-NMS's confirmation rounds (soft_nms_confirm). Each runs its whole
// loop on the device, so a request never waits on the host for a loop's end.
//
// Replaces: the `jax.lax.while_loop`s of detectandtrack_tpu/ops/nms.py,
// `nms_fixed` (the IoU suppression matrix and the Jacobi fixpoint, :62-89)
// and `soft_nms_fixed` (the bulk-confirmation fixpoint, :152-178). The TPU
// runs each round as one dense O(N^2) masked reduction on the VPU and
// loops on the device.
//
// What bounds them on the H100: latency, not bytes or operations. Greedy
// NMS is a chain of dependent decisions; soft-NMS's rounds are dependent.
// The byte bound (boxes and validity read once, the keep mask written once:
// 0.2 MB, 0.07 us for the RPN's 10 lanes of 1000) is far below either
// chain, so the designs below shorten the chains and keep them on chip.
//
// nms_keep, two kernels:
// - nms_mask_kernel: one block per upper-triangle tile of 64 x 64 (row
//   tile r <= column tile c) and lane. A block stages its 64 column boxes
//   in shared memory; two threads make the 64-bit word of row 64 r + t
//   against them, 32 columns each: bit k = IoU(row, 64 c + k) > thresh,
//   for columns after the row. The IoU is ops/boxes.py::bbox_overlaps
//   operation by operation in f32, with the rounding intrinsics (nvcc
//   would otherwise contract a*b+c into an FMA, and one fused rounding
//   flips a pair at the threshold) and torch's NaN outcome (see
//   inter_union); a pair far from the threshold is decided without the
//   division (iou_above_sure). Words go to scratch bits (L, W, 64 W): word
//   c of row i at [c][i], so the words one sweep step needs (a column
//   word's rows 0 .. 64 c + 63) are one contiguous run. The diagonal
//   tiles also pack the validity bytes into words vw (L, W).
// - nms_sweep_kernel: one block per lane, two warps. Warp 1 streams the
//   lane's column runs into a shared-memory ring with the bulk
//   asynchronous copy (cp.async.bulk, completion on an mbarrier per
//   stage). Warp 0 sweeps word by word: removed(c) = OR of column c's
//   words over the kept rows of earlier words (each lane ORs its two rows
//   of every 64-row piece, the kept bits held transposed per lane, then
//   one warp reduction); the candidates valid & ~removed; then, if a
//   candidate suppresses a later one in the same word (one vote), the
//   greedy chain over the 64 diagonal words, unrolled in registers; else
//   all candidates are kept. The chain is at most 64 short steps a word
//   and a reduction, not N dependent decisions; the keep mask is written
//   a word at a time.
//
// soft_nms_confirm: one block per lane, one thread per box (strided past
// the block size). Its latencies are global loads, so the lane's state is
// brought on chip once where it fits: the overlaps, staged through shared
// memory by the bulk asynchronous copy, become column bit words (bit j of
// column i's word = overlaps[j, i]); the decays of every overlapping pair
// are gathered into an on-chip cache by column; so are the decay
// product's chunk products q[c][i] (chunks of kProdChunk rows), the
// provisional scores and the unconfirmed / alive / newly confirmed sets as
// 32-bit words (one a chunk). Past that size the column words and q go to
// a global scratch and the decays are read from dmat. A round: each
// unconfirmed alive box scans the set bits of its column &
// unconfirmed-alive for an overlapper that beats it on (prov, -index); a
// block-wide vote ends the loop when none confirms. Then only the chunk
// products that a newly confirmed box changes are recomputed, from 1 in
// index order over the chunk's confirmed overlappers, and prov(i) = s_i *
// (q[0][i] * q[1][i] * ...) from 1 in index order: the association of
// kernels/nms.py::soft_nms_confirm_reference, so the two agree bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;            // nms_keep's tile and word width
constexpr int kRingStages = 8;       // nms_sweep_kernel's ring
constexpr int kMaxPieces = 32;       // 64-row pieces a ring stage holds
constexpr int kProdChunk = 32;       // soft_nms_confirm's product chunk
constexpr int kSoftThreads = 512;
constexpr size_t kSoftSmem = 226 * 1024;    // soft_nms_confirm's shared memory

// ops/boxes.py::boxes_area: (x2 - x1 + 1) * (y2 - y1 + 1).
__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// bbox_overlaps(a, b)'s intersection and union, operation by operation.
// fminf / fmaxf drop a NaN that torch.minimum / maximum / clamp keep; the
// outcome is the same: an intersection side is NaN only where a box has a
// NaN side (inf - inf), and a NaN coordinate or side makes its box's area
// NaN, so the union is NaN, fails `uni > 0`, and the IoU is 0 whatever the
// intersection is.
__device__ __forceinline__ void inter_union(float4 a, float area_a, float4 b,
                                            float area_b, float& inter,
                                            float& uni) {
  const float iw = fmaxf(__fadd_rn(__fsub_rn(fminf(a.z, b.z),
                                             fmaxf(a.x, b.x)), 1.0f), 0.0f);
  const float ih = fmaxf(__fadd_rn(__fsub_rn(fminf(a.w, b.w),
                                             fmaxf(a.y, b.y)), 1.0f), 0.0f);
  inter = __fmul_rn(iw, ih);
  uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
}

// where(uni > 0, inter / uni, 0) > thresh, exactly (the rounded quotient).
__device__ __forceinline__ bool iou_above(float inter, float uni,
                                          float thresh) {
  return (uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f) > thresh;
}

// The same bit without dividing, where the comparison is certain; sets
// `unsure` where it is not. With f = RN(thresh * uni) normal, inter above
// f (1 + 2^-20) puts inter / uni above the next float after thresh, and
// inter below f (1 - 2^-20) puts it below thresh.
__device__ __forceinline__ bool iou_above_sure(float inter, float uni,
                                               float thresh, bool& unsure) {
  const bool pos = uni > 0.0f;
  const float f = __fmul_rn(thresh, uni);
  const bool above = inter > __fmul_rn(f, 1.0f + 0x1p-20f);
  const bool below = inter < __fmul_rn(f, 1.0f - 0x1p-20f);
  unsure = pos && !(f >= 0x1p-100f && (above || below));
  return pos ? above : 0.0f > thresh;
}

// Suppression words of the upper-triangle tile (row tile r, column tile c)
// of one lane, and (on the diagonal tiles) the lane's validity words.
// Thread t: row 64 r + (t % 64) against column half t / 64 (32 columns):
// straight-line code (no branch a pair), then the few pairs near the
// threshold are divided exactly. Grid (W (W + 1) / 2, lanes): block x is
// tile (r, c), r <= c, numbered column by column.
__global__ void __launch_bounds__(2 * kTile) nms_mask_kernel(
    const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
    u64* __restrict__ bits, u64* __restrict__ vwords, int N, int W,
    float thresh) {
  const int x = blockIdx.x;
  int c = static_cast<int>((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
  while (c * (c + 1) / 2 > x) --c;
  while ((c + 1) * (c + 2) / 2 <= x) ++c;
  const int r = x - c * (c + 1) / 2;
  const long long l = blockIdx.y;
  const int t = threadIdx.x & (kTile - 1), half = threadIdx.x >> 6;
  __shared__ float4 cb[kTile];
  __shared__ float ca[kTile];
  const float4* lb = boxes + l * N;
  const int j = kTile * c + t;
  if (half == 0) {
    if (j < N) {
      const float4 b = lb[j];
      cb[t] = b;
      ca[t] = box_area(b);
    } else {
      cb[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      ca[t] = 0.0f;
    }
    if (r == c) {
      const unsigned m = __ballot_sync(0xffffffffu,
                                       j < N && valid[l * N + j]);
      if ((t & 31) == 0)
        reinterpret_cast<unsigned*>(vwords + l * W + c)[t >> 5] = m;
    }
  }
  __syncthreads();
  const int i = kTile * r + t;
  unsigned word = 0;
  if (i < N) {
    const float4 a = lb[i];
    const float aa = box_area(a);
    const float4* hb = cb + 32 * half;
    const float* ha = ca + 32 * half;
    unsigned unsure = 0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      float inter, uni;
      bool u;
      inter_union(a, aa, hb[k], ha[k], inter, uni);
      word |= static_cast<unsigned>(iou_above_sure(inter, uni, thresh, u))
              << k;
      unsure |= static_cast<unsigned>(u) << k;
    }
    // Columns after the row and before N only.
    const int k0 = (r == c) ? t + 1 : 0;
    const int k1 = min(kTile, N - kTile * c);
    const u64 cols = (k1 == kTile ? ~0ull : (1ull << k1) - 1) &
                     ~(k0 == kTile ? ~0ull : (1ull << k0) - 1);
    const unsigned mine = static_cast<unsigned>(cols >> (32 * half));
    word &= mine;
    unsure &= mine;
    while (unsure) {
      const int k = __ffs(unsure) - 1;
      unsure &= unsure - 1;
      float inter, uni;
      inter_union(a, aa, hb[k], ha[k], inter, uni);
      word = (word & ~(1u << k)) |
             (static_cast<unsigned>(iou_above(inter, uni, thresh)) << k);
    }
  }
  reinterpret_cast<unsigned*>(
      bits + (l * W + c) * (static_cast<long long>(kTile) * W) + i)[half] =
      word;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Waits for the phase of parity `parity` to complete; a wait that never
// ends (a schedule bug) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}
// Global -> shared, `bytes` a multiple of 16, both addresses 16-aligned;
// completion counted on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ u64 warp_or(u64 x) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x));
  const unsigned hi =
      __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x >> 32));
  return (static_cast<u64>(hi) << 32) | lo;
}

// The greedy chain inside one word: candidate j (in index order), if still
// a candidate, is kept and clears the later candidates it suppresses
// (diag[j], bits above j only). Unrolled, so every step is a bit test and a
// predicated and-not on registers.
__device__ __forceinline__ u64 greedy_word(const u64* diag, u64 cur) {
  unsigned lo = static_cast<unsigned>(cur);
  unsigned hi = static_cast<unsigned>(cur >> 32);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const u64 d = diag[j];
    if ((lo >> j) & 1u) {
      lo &= ~static_cast<unsigned>(d);
      hi &= ~static_cast<unsigned>(d >> 32);
    }
  }
#pragma unroll
  for (int j = 32; j < 64; ++j) {
    const unsigned d = static_cast<unsigned>(diag[j] >> 32);
    if ((hi >> (j - 32)) & 1u) hi &= ~d;
  }
  return (static_cast<u64>(hi) << 32) | lo;
}

// One block per lane: warp 1 streams, warp 0 sweeps (see the header).
// Loads: for each column word c, its pieces r = 0 .. c (64 rows each) in
// runs of at most G pieces (G = min(W, 32), so a run's pieces share one
// group of 64 pieces); load t uses stage t % S. The kept bits are held
// transposed for the OR: lane l keeps, per group g of 64 words, the words
// klo / khi whose bit r is row 64 (64 g + r) + l / + l + 32 kept, so a
// piece's OR needs no load but its own two entries.
__global__ void __launch_bounds__(64) nms_sweep_kernel(
    const u64* __restrict__ bits, const u64* __restrict__ vwords,
    uint8_t* __restrict__ kept, int N, int W, int G, int S) {
  extern __shared__ __align__(128) u64 sm[];
  const int groups = (W + 63) >> 6;
  u64* ring = sm;                                  // S * G * 64 words
  u64* kt = ring + static_cast<long long>(S) * G * kTile;  // groups x 64
  u64* vw = kt + groups * kTile;                   // W valid words
  u64* full = vw + W;                              // S mbarriers
  u64* empty = full + S;                           // S mbarriers
  const long long l = blockIdx.x;
  const long long np = static_cast<long long>(kTile) * W;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(full + s), 1);
      mbar_init(smem_addr(empty + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32) {                         // the producer warp
    if (threadIdx.x == 32) {
      const u64* lb = bits + l * W * np;
      int t = 0, s = 0;
      uint32_t phase = 0;
      for (int c = 0; c < W; ++c) {
        for (int p0 = 0; p0 <= c; p0 += G, ++t) {
          if (t >= S) mbar_wait(smem_addr(empty + s), phase ^ 1u);
          const uint32_t bytes = min(c + 1 - p0, G) * kTile * 8;
          const uint32_t bar = smem_addr(full + s);
          mbar_expect_tx(bar, bytes);
          bulk_load(smem_addr(ring + static_cast<long long>(s) * G * kTile),
                    lb + c * np + p0 * kTile, bytes, bar);
          if (++s == S) {
            s = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  const int lane = threadIdx.x;
  for (int w = lane; w < W; w += 32) vw[w] = vwords[l * W + w];
  for (int g = 0; g < groups; ++g) {
    kt[g * kTile + lane] = 0ull;
    kt[g * kTile + 32 + lane] = 0ull;
  }
  __syncwarp();
  uint8_t* lk = kept + l * N;
  int s = 0, held = 0;                   // the next stage; the diagonal's
  uint32_t phase = 0;
  for (int c = 0; c < W; ++c) {
    u64 part_lo = 0, part_hi = 0;
    const u64* diag = nullptr;
    for (int p0 = 0; p0 <= c; p0 += G) {
      mbar_wait(smem_addr(full + s), phase);
      const u64* run = ring + static_cast<long long>(s) * G * kTile;
      const int n_pieces = min(c + 1 - p0, G);
      const int n_or = min(n_pieces, c - p0);      // pieces before c
      if (n_or > 0) {
        const int g = p0 >> 6;
        const u64 klo = kt[g * kTile + lane] >> (p0 & 63);
        const u64 khi = kt[g * kTile + 32 + lane] >> (p0 & 63);
#pragma unroll 8
        for (int p = 0; p < n_or; ++p) {         // loads unpredicated: apart
          part_lo |= run[p * kTile + lane] & (0ull - ((klo >> p) & 1ull));
          part_hi |= run[p * kTile + 32 + lane] & (0ull - ((khi >> p) & 1ull));
        }
      }
      if (n_pieces > n_or) {
        diag = run + n_or * kTile;                 // piece c: this load's last
        held = s;
      } else {                                     // done with this stage
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_addr(empty + s));
      }
      if (++s == S) {
        s = 0;
        phase ^= 1u;
      }
    }
    u64 cur = vw[c] & ~warp_or(part_lo | part_hi);
    const u64 d_lo = diag[lane], d_hi = diag[32 + lane];
    if (__any_sync(0xffffffffu, (((cur >> lane) & 1ull) && (d_lo & cur)) ||
                                    (((cur >> (32 + lane)) & 1ull) &&
                                     (d_hi & cur))))
      cur = greedy_word(diag, cur);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(empty + held));
    const int g = c >> 6, b = c & 63;
    kt[g * kTile + lane] |= ((cur >> lane) & 1ull) << b;
    kt[g * kTile + 32 + lane] |= ((cur >> (32 + lane)) & 1ull) << b;
    const int i0 = kTile * c + lane, i1 = i0 + 32;
    if (i0 < N) lk[i0] = static_cast<uint8_t>((cur >> lane) & 1ull);
    if (i1 < N) lk[i1] = static_cast<uint8_t>((cur >> (32 + lane)) & 1ull);
  }
}

// Soft-NMS's shared-memory layout for N boxes, the same on host and card.
// On chip: cols (W x N words) | q (NC x N floats) | s, prov (N floats
// each) | ua (2 x NW), alv, fresh (NW 32-bit words each) | scan (32) |
// coff (N + 1) | bar (an mbarrier) | stage (16-aligned) | dval (dcap
// floats). Off chip (cols and q in the global scratch) the layout ends
// after scan.
struct SoftLayout {
  size_t cols, q, s, ua, scan, coff, bar, stage, dval, total;
  int stage_bytes, dcap;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__host__ __device__ inline SoftLayout soft_layout(int N, bool on_chip) {
  const size_t n = N, W = (n + 63) / 64, NC = (n + 31) / 32, NW = 2 * W;
  SoftLayout lay{};
  size_t at = 0;
  if (on_chip) {
    lay.cols = at;
    at += W * n * 8;
    lay.q = at;
    at += NC * n * 4;
  }
  lay.s = at;                      // s, then prov
  at += 2 * n * 4;
  lay.ua = at;                     // ua (2 NW), alv (NW), fresh (NW)
  at += 4 * NW * 4;
  lay.scan = at;
  at += 32 * 4;
  lay.coff = at;
  if (!on_chip) {
    lay.total = at;
    return lay;
  }
  at = align16(at + (n + 1) * 4);
  lay.bar = at;
  at += 16;
  lay.stage = at;
  // The stage holds 64 rows of overlaps at least, the whole lane where it
  // fits beside a decay cache as large as itself.
  const size_t left = kSoftSmem > at ? kSoftSmem - at : 0;
  const size_t want = align16(n * n + 16);
  const size_t least = align16(64 * n + 16);
  size_t stage = want <= left / 2 ? want : left / 2;
  if (stage < least) stage = least;
  lay.stage_bytes = static_cast<int>(stage);
  at += stage;
  lay.dval = at;
  lay.dcap = left > stage ? static_cast<int>((left - stage) / 4) : 0;
  lay.total = at + static_cast<size_t>(lay.dcap) * 4;
  return lay;
}

// Whether the lane's state for N boxes fits in shared memory.
inline bool soft_fits(int N) {
  const SoftLayout lay = soft_layout(N, true);
  return lay.stage + static_cast<size_t>(lay.stage_bytes) <= kSoftSmem;
}

// Copies len bytes from g into the stage, starting at stage + (g mod 16)
// so that the aligned middle goes in one bulk asynchronous copy (thread 0
// issues it, every thread waits on the mbarrier `bar`, whose phase parity
// each thread tracks in `phase`); the ragged ends by bytes. Returns the
// copy's start; the caller syncs the block before reading it.
__device__ __forceinline__ unsigned char* stage_copy(
    unsigned char* __restrict__ stage, const unsigned char* __restrict__ g,
    int len, int tid, int bd, uint32_t bar, uint32_t& phase) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  unsigned char* dst = stage + mis;
  const int head = min(len, (16 - mis) & 15);
  const int mid = (len - head) & ~15;
  if (tid == 0 && mid > 0) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect_tx(bar, static_cast<uint32_t>(mid));
    bulk_load(smem_addr(dst + head), g + head, static_cast<uint32_t>(mid),
              bar);
  }
  for (int k = tid; k < head; k += bd) dst[k] = g[k];
  for (int k = head + mid + tid; k < len; k += bd) dst[k] = g[k];
  if (mid > 0) {
    mbar_wait(bar, phase);
    phase ^= 1u;
  }
  return dst;
}

// The product of one chunk's confirmed decays of column i from global
// memory, from 1 in index order; d points at dmat[32 c][i], bit p of
// `rows` selects row 32 c + p.
__device__ __forceinline__ float chunk_product(const float* __restrict__ d,
                                               int N, uint32_t rows) {
  float p = 1.0f;
#pragma unroll
  for (int h = 0; h < kProdChunk; h += 16) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = ((rows >> (h + k)) & 1u)
                 ? __ldg(d + static_cast<long long>(h + k) * N)
                 : 1.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) p = __fmul_rn(p, v[k]);
  }
  return p;
}

// One block per lane (see the header). kOnChip: column words and chunk
// products in shared memory, the overlaps staged through shared memory
// by bulk copies, and (when they fit) the decays of every overlapping pair
// cached on chip by column (dval[coff[i] + k]: column i's k-th
// overlapper); else column words and products in the global scratch
// g_cols, g_q and the decays read from dmat.
template <bool kOnChip>
__global__ void __launch_bounds__(kSoftThreads, 1) soft_nms_confirm_kernel(
    const float* __restrict__ scores, const float* __restrict__ dmat,
    const uint8_t* __restrict__ overlaps, const uint8_t* __restrict__ alive,
    float* __restrict__ final_scores, u64* __restrict__ g_cols,
    float* __restrict__ g_q, int N, float neg_inf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (N + 63) >> 6;
  const int NC = (N + 31) >> 5;        // chunks = 32-bit words of a set
  const int NW = 2 * W;                // set words, padded to whole u64s
  const long long l = blockIdx.x;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const SoftLayout lay = soft_layout(N, kOnChip);
  u64* cols = kOnChip ? reinterpret_cast<u64*>(smem + lay.cols)
                      : g_cols + l * W * N;
  float* q = kOnChip ? reinterpret_cast<float*>(smem + lay.q)
                     : g_q + l * NC * N;
  float* s = reinterpret_cast<float*>(smem + lay.s);
  float* prov = s + N;
  uint32_t* ua = reinterpret_cast<uint32_t*>(smem + lay.ua);  // 2 x NW
  uint32_t* alv = ua + 2 * NW;                                 // NW
  uint32_t* fresh = alv + NW;                                  // NW
  uint32_t* scan = reinterpret_cast<uint32_t*>(smem + lay.scan);
  uint32_t* coff = reinterpret_cast<uint32_t*>(smem + lay.coff);
  float* dval = reinterpret_cast<float*>(smem + lay.dval);
  const float* sc = scores + l * N;
  const float* dm = dmat + l * N * static_cast<long long>(N);
  const uint8_t* ov = overlaps + l * N * static_cast<long long>(N);
  float* fin = final_scores + l * N;

  for (int i = tid; i < N; i += bd) {
    s[i] = sc[i];
    prov[i] = sc[i];                   // s_i * (1 * 1 * ...) = s_i
    fin[i] = neg_inf;
#pragma unroll 1
    for (int c = 0; c < NC; ++c) q[static_cast<long long>(c) * N + i] = 1.0f;
  }
  for (int k = tid; k < NW; k += bd) fresh[k] = 0u;
  for (int k = NC + tid; k < NW; k += bd) alv[k] = 0u;
  for (int base = 0; base < N; base += bd) {
    const int i = base + tid;
    const unsigned m = __ballot_sync(0xffffffffu, i < N && alive[l * N + i]);
    if (lane == 0 && base + 32 * warp < N) alv[(base >> 5) + warp] = m;
  }
  bool cache = false;
  if (kOnChip) {
    // Column words from the overlaps, staged rows at a time.
    unsigned char* stage = smem + lay.stage;
    const uint32_t bar = smem_addr(smem + lay.bar);
    uint32_t phase = 0;
    if (tid == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    int rows_per = (lay.stage_bytes - 16) / N;
    rows_per = rows_per >= N ? N : (rows_per & ~63);
    for (int j0 = 0; j0 < N; j0 += rows_per) {
      const int rows = min(rows_per, N - j0);
      __syncthreads();                 // the stage is free
      const unsigned char* st =
          stage_copy(stage, ov + static_cast<long long>(j0) * N, rows * N,
                     tid, bd, bar, phase);
      __syncthreads();
      for (int i = tid; i < N; i += bd) {
        for (int b0 = 0; b0 < rows; b0 += 64) {
          const int nb = min(64, rows - b0);
          u64 word = 0;
#pragma unroll 16
          for (int b = 0; b < nb; ++b)
            word |= static_cast<u64>(st[(b0 + b) * N + i] != 0) << b;
          cols[static_cast<long long>((j0 + b0) >> 6) * N + i] = word;
        }
      }
    }
    __syncthreads();
    // Column offsets of the decay cache: an exclusive scan of the column
    // popcounts.
    uint32_t carry = 0;
    const int warps = bd >> 5;
    for (int base = 0; base < N; base += bd) {
      const int i = base + tid;
      uint32_t v = 0;
      if (i < N)
        for (int w = 0; w < W; ++w)
          v += __popcll(cols[static_cast<long long>(w) * N + i]);
      uint32_t x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) scan[warp] = x;
      __syncthreads();
      if (warp == 0) {
        uint32_t t = lane < warps ? scan[lane] : 0u;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t y = __shfl_up_sync(0xffffffffu, t, o);
          if (lane >= o) t += y;
        }
        scan[lane] = t;
      }
      __syncthreads();
      if (i < N) coff[i] = carry + (warp > 0 ? scan[warp - 1] : 0u) + x - v;
      carry += scan[warps - 1];
      __syncthreads();
    }
    cache = carry <= static_cast<uint32_t>(lay.dcap);
    if (cache) {
      // Column i's overlapping decays in row order, gathered eight loads
      // at a time (unpredicated: row 0 stands in past the last).
      for (int i = tid; i < N; i += bd) {
        uint32_t at = coff[i];
        for (int w = 0; w < W; ++w) {
          u64 m = cols[static_cast<long long>(w) * N + i];
          while (m) {
            float v[8];
            int n_got = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int j =
                  m ? 64 * w + __ffsll(static_cast<long long>(m)) - 1 : 0;
              n_got += m != 0;
              m &= m - 1;
              v[k] = __ldg(dm + static_cast<long long>(j) * N + i);
            }
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if (k < n_got) dval[at + k] = v[k];
            at += n_got;
          }
        }
      }
    }
  } else {
    for (int i = tid; i < N; i += bd) {
      const uint8_t* oc = ov + i;
      for (int w = 0; w < W; ++w) {
        const int rows = min(64, N - 64 * w);
        const uint8_t* o = oc + static_cast<long long>(64 * w) * N;
        u64 word = 0;
#pragma unroll 16
        for (int b = 0; b < rows; ++b)
          word |= static_cast<u64>(
                      __ldg(o + static_cast<long long>(b) * N) != 0) << b;
        cols[static_cast<long long>(w) * N + i] = word;
      }
    }
  }
  __syncthreads();
  for (int k = tid; k < NW; k += bd) ua[k] = alv[k];
  __syncthreads();

  int cur = 0;
  for (int round = 0; round <= N; ++round) {
    const uint32_t* uc = ua + cur * NW;
    // 1. Newly confirmed: unconfirmed alive boxes that no unconfirmed alive
    //    overlapper beats on (prov, -index).
    int any_new = 0;
    for (int base = 0; base < N; base += bd) {
      const int i = base + tid;
      bool newly = false;
      if (i < N && ((uc[i >> 5] >> (i & 31)) & 1u)) {
        const float pi = prov[i];
        bool outranked = false;
        for (int w = 0; w < W && !outranked; ++w) {
          u64 m = cols[static_cast<long long>(w) * N + i] &
                  ((static_cast<u64>(uc[2 * w + 1]) << 32) | uc[2 * w]);
          while (m) {
            const int j = 64 * w + __ffsll(static_cast<long long>(m)) - 1;
            const float pj = prov[j];
            if (pj > pi || (pj == pi && j < i)) {
              outranked = true;
              break;
            }
            m &= m - 1;
          }
        }
        newly = !outranked;
      }
      const unsigned m = __ballot_sync(0xffffffffu, newly);
      if (lane == 0 && base + 32 * warp < N) fresh[(base >> 5) + warp] = m;
      any_new |= newly;
    }
    if (!__syncthreads_or(any_new)) break;
    // 2. Record the newly confirmed; recompute the chunk products they
    //    change, and then prov, for the boxes still unconfirmed.
    for (int i = tid; i < N; i += bd) {
      const uint32_t bit = 1u << (i & 31);
      if (fresh[i >> 5] & bit) {
        fin[i] = prov[i];
        continue;
      }
      if (!(uc[i >> 5] & bit)) continue;
      bool changed = false;
      uint32_t pre = kOnChip ? coff[i] : 0u;   // overlappers before word w
      for (int w = 0; w < W; ++w) {
        const u64 cw = cols[static_cast<long long>(w) * N + i];
        for (int h = 0; h < 2 && 2 * w + h < NC; ++h) {
          const int c = 2 * w + h;
          const uint32_t f = fresh[c];
          const uint32_t col = static_cast<uint32_t>(cw >> (32 * h));
          if (!(col & f)) continue;
          const uint32_t conf = alv[c] & ~(uc[c] & ~f);
          float pr = 1.0f;
          if (cache) {                 // from 1 in index order, on chip
            uint32_t at =
                pre + (h ? __popc(static_cast<uint32_t>(cw)) : 0u);
            for (uint32_t m = col; m; m &= m - 1, ++at)
              if ((conf >> (__ffs(m) - 1)) & 1u)
                pr = __fmul_rn(pr, dval[at]);
          } else {
            pr = chunk_product(
                dm + static_cast<long long>(kProdChunk * c) * N + i, N,
                col & conf);
          }
          q[static_cast<long long>(c) * N + i] = pr;
          changed = true;
        }
        pre += __popcll(cw);
      }
      if (changed) {
        float pr = 1.0f;
        for (int c = 0; c < NC; ++c)
          pr = __fmul_rn(pr, q[static_cast<long long>(c) * N + i]);
        prov[i] = __fmul_rn(s[i], pr);
      }
    }
    // 3. The next round's unconfirmed alive set.
    uint32_t* un = ua + (cur ^ 1) * NW;
    for (int k = tid; k < NW; k += bd) un[k] = uc[k] & ~fresh[k];
    cur ^= 1;
    __syncthreads();
  }
}

// nms_sweep_kernel's shared memory: the ring of S stages of G pieces, the
// transposed kept bits, the validity words and 2 S mbarriers.
__host__ __device__ inline size_t sweep_smem(int W, int G, int S) {
  return (static_cast<size_t>(S) * G * kTile +
          static_cast<size_t>((W + 63) / 64) * kTile + W + 2 * S) * 8;
}

constexpr int kMaxDevices = 64;
std::atomic<bool> sweep_opted[kMaxDevices];
std::atomic<bool> soft_opted[2][kMaxDevices];

// Raises a kernel's dynamic shared memory limit to `most` bytes, the most
// any of its launches asks for, once per device (the opt-in belongs to the
// function on each device, and a launch that asks for less runs under
// it), so later launches make no host call for it. Legal under stream
// capture.
cudaError_t smem_opt_in(const void* kernel, size_t most,
                        std::atomic<bool>* opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && opted[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err == cudaSuccess && dev < kMaxDevices)
    opted[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

extern "C" {

const char* dat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// kept (L, N) bytes from the score-sorted boxes (L, N, 4) f32 (16-byte
// aligned), valid (L, N) bytes and the IoU threshold. Scratch: L * W *
// (64 W + 1) words (the bits, then the validity words), W = ceil(N / 64).
// N <= 32768.
int dat_nms_keep(const void* boxes, const void* valid, void* scratch,
                 void* kept, int L, int N, float thresh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const int W = (N + 63) / 64;
  if (W > 512 || L > 65535) return static_cast<int>(cudaErrorInvalidValue);
  u64* bits = static_cast<u64*>(scratch);
  u64* vwords = bits + static_cast<size_t>(L) * W * kTile * W;
  nms_mask_kernel<<<dim3(W * (W + 1) / 2, L), 2 * kTile, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      bits, vwords, N, W, thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = W < kMaxPieces ? W : kMaxPieces;
  int loads = 0;
  for (int c = 0; c < W; ++c) loads += (c + G) / G;
  const int S = loads < kRingStages ? loads : kRingStages;
  const size_t smem = sweep_smem(W, G, S);
  if (smem > 48 * 1024) {
    err = smem_opt_in(reinterpret_cast<const void*>(nms_sweep_kernel),
                      sweep_smem(512, kMaxPieces, kRingStages), sweep_opted);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_sweep_kernel<<<L, 64, smem, st>>>(bits, vwords,
                                        static_cast<uint8_t*>(kept), N, W,
                                        G, S);
  return static_cast<int>(cudaGetLastError());
}

// Whether soft_nms_confirm's state for N boxes stays on chip; if not, the
// caller gives scratch of L * ceil(N/64) * N words and L * ceil(N/32) * N
// floats.
int dat_soft_nms_on_chip(int N) { return soft_fits(N) ? 1 : 0; }

// final (L, N) f32 from scores (L, N) f32, dmat (L, N, N) f32, overlaps
// (L, N, N) bytes and alive (L, N) bytes; unconfirmed entries get neg_inf.
int dat_soft_nms_confirm(const void* scores, const void* dmat,
                         const void* overlaps, const void* alive,
                         void* final_scores, void* scratch_cols,
                         void* scratch_q, int L, int N, float neg_inf,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const bool on_chip = soft_fits(N);
  if (!on_chip && (scratch_cols == nullptr || scratch_q == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = soft_layout(N, on_chip).total;
  if (smem > kSoftSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = N < kSoftThreads ? ((N + 31) / 32) * 32 : kSoftThreads;
  const void* kernel =
      on_chip ? reinterpret_cast<const void*>(soft_nms_confirm_kernel<true>)
              : reinterpret_cast<const void*>(soft_nms_confirm_kernel<false>);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        smem_opt_in(kernel, kSoftSmem, soft_opted[on_chip]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto* sc = static_cast<const float*>(scores);
  const auto* dm = static_cast<const float*>(dmat);
  const auto* ov = static_cast<const uint8_t*>(overlaps);
  const auto* al = static_cast<const uint8_t*>(alive);
  auto* fin = static_cast<float*>(final_scores);
  auto* cols = static_cast<u64*>(scratch_cols);
  auto* q = static_cast<float*>(scratch_q);
  if (on_chip)
    soft_nms_confirm_kernel<true><<<L, threads, smem, st>>>(
        sc, dm, ov, al, fin, cols, q, N, neg_inf);
  else
    soft_nms_confirm_kernel<false><<<L, threads, smem, st>>>(
        sc, dm, ov, al, fin, cols, q, N, neg_inf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
