// Microbenchmark kernels: the phases of the tile kernels K1/K4 one at a
// time, and a tensor-core form of their accumulate.
//
// M1 micro_stagea_phases replaces the TPU kernel of
//    scripts/micro_stagea_phases.py:build (:162-186).  One CTA of 512
//    threads per (K, 1024) tile of samples (two columns a thread, as K1/K4);
//    the mode selects the phases:
//      list  - block list: K1/K4's tile_block_list (warp lists, one merge)
//      rank  - list + each sample's rank, count form of the TPU kernel
//      full  - list + ranks + accumulate: K4's own tile_accumulate()
//      mxu   - accumulate only, with the fixed list 0..nb-1 and rank
//              clamp(key, 0, nb - 1)
//      plist - presorted list: each thread sorts its columns of K keys with
//              Batcher's bitonic network in registers, drops duplicates,
//              sorts again, then nb rounds of block-wide min over the
//              column heads, popping the heads that were taken
//      pfull - plist + ranks + accumulate (coverage key <= the list's last)
//    Outputs are the TPU kernel's: the list (the iota for mxu), and partial
//    rows that are zero for list/rank/plist except cell (0, 0) of each
//    tile: row 0 column 0's rank (rank) or column 0's head after the pops
//    (plist).  full and pfull leave dead rows unwritten, as K1/K4 do.
// M2 micro_tile_accum replaces scripts/micro_tile_accum.py:run (:70-95):
//    tiles of (rows, 1024) samples, block list, count-form ranks and the
//    accumulate of every sample (a sample beyond the list lands in row
//    nb - 1, as on the TPU).
// M3 micro_mxu8 replaces scripts/micro_mxu8.py:build (:121-144): per
//    1024-point tile, onehot(offset)^T (512 x K*1024) contracted with
//    [sel . sdq, sel] (K*1024 x 2nb) on the tensor cores, in bf16 with f32
//    sums or in int8 with int32 sums.  sdq must lie in [-127, 127]: then
//    both precisions are exact (every sum is an integer below 2^24).
//
// M1/M2 sum sd as integers on the SD_QUANT grid (quantized with qscale,
// dequantized with dscale), as K1/K4 do; their plain versions do the same.
// What bounds them is what bounds K1/K4: the list's rounds and the
// shared-memory atomics.
//
// M3's design (one CTA of two warpgroups per tile, two CTAs an SM):
//   1. stage: the tile's 10,240 samples are read once (int4 a thread and
//      row, two rows of loads in flight) and packed into one word each in
//      shared memory; samples with use == 0 or lrow outside [0, nb) become
//      0 and add nothing;
//   2. bucket: a counting sort by offset group (okey >> 6, 8 groups of 64
//      rows) through a block scan of packed 16-bit counts.  A sample now
//      meets only the 64 rows of its group: 8x fewer multiply-adds than
//      the dense 512-row one-hot.  Each group's list is read as if padded
//      with null samples to a multiple of one wgmma's K (16 bf16, 32 int8);
//   3. wgmma: each warpgroup takes 4 groups; per group D (64 x 2nb) +=
//      A (64 x samples) B (samples x 2nb), both operands in shared memory,
//      K-major (int8 wgmma takes no other), chunk by chunk: 128 bytes of K
//      (4 wgmmas) where two CTAs still fit an SM (nb <= 40), else 64.  A
//      chunk is written by one store a sample for the one-hot and two for
//      [sel . sdq, sel] into buffers that are zero, and its writer clears
//      the same three entries once the chunk's wgmmas are done
//      (wait_group 1), so nothing is zero-filled per chunk; two buffers a
//      warpgroup let the next chunk be written while this one runs.  Each
//      group's 64 x 2nb sums are written straight from the accumulator
//      fragments, zero rows included.
//   The one-hot stays in shared memory (the SS form) rather than in
//   registers: built in registers, each k16 step costs every thread 4
//   (bf16) or 8 (int8) shared loads and compares, and fragments kept alive
//   across the asynchronous wgmmas cost 16-32 registers more.
//   Bound: M3's inputs need their bytes, 16 B x K x N in and 2 x 4 B x T x
//   nb x 512 out: 0.100 ms at the H100's 3.35 TB/s for K = 10, N = 2^20,
//   nb = 40.  The bucketed product (77.9 GFLOP in bf16, 78.6 in int8 at
//   the script's inputs, where 72% of the samples are kept: 0.079 ms at
//   the bf16 peak, 0.040 ms at int8's) is what this design spends, not
//   what the function needs.  On the card (scripts/m3_turns.py, PERF.md)
//   the kernel takes about 0.23 ms in bf16 and 0.18 ms in int8: staging
//   and bucketing alone take 0.07 ms, and the chunk loop (writes, proxy
//   fence, warpgroup barrier) and the stores, not the wgmmas, set the
//   pace; two CTAs an SM overlap one tile's loads with another's chunks
//   only in part.  The kernel writes the wgmmas it issued per tile
//   (steps), so a run can hold them to the padded lists.
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace chad {

enum StageMode { kList = 0, kRank, kFull, kMxu, kPList, kPFull };
constexpr int kSortWidth = 16;        // register column of the presort

// Count form of a key's rank: # of list[1..nb) <= key (the TPU kernels'
// sum of nb - 1 compares); nb - 1 for a key beyond the list.
__device__ __forceinline__ int count_rank(const int* list, int nb, int key) {
  int lo = 1, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// Batcher's bitonic sorting network, ascending, fully unrolled so that v
// stays in registers.
template <int N>
__device__ __forceinline__ void bitonic_sort(int (&v)[N]) {
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const int a = v[i], b = v[j];
          const bool up = (i & size) == 0;
          v[i] = up ? min(a, b) : max(a, b);
          v[j] = up ? max(a, b) : min(a, b);
        }
      }
    }
  }
}

// Presorted block list (the TPU's list_phase_presort): fills s.list like
// tile_block_list and returns the head of this thread's first column after
// the pops.
static __device__ int tile_presorted_list(TileSmem s, int k, int nb) {
  const int tid = threadIdx.x;
  int v[kCols][kSortWidth];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
#pragma unroll
    for (int j = 0; j < kSortWidth; ++j) {
      v[c][j] = j < k ? s.key[j * kTile + tile_col0() + c] : kInt32Max;
    }
    bitonic_sort(v[c]);
#pragma unroll
    for (int j = kSortWidth - 1; j >= 1; --j) {   // duplicates are adjacent
      if (v[c][j] == v[c][j - 1]) v[c][j] = kInt32Max;
    }
    bitonic_sort(v[c]);
  }
  int r = 0;
  for (; r < nb; ++r) {
    const int m = block_min(min(v[0][0], v[1][0]), s.red);
    if (tid == 0) s.list[r] = m;
    if (m == kInt32Max) break;              // uniform
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const bool pop = v[c][0] == m;
#pragma unroll
      for (int j = 0; j < kSortWidth - 1; ++j) {
        v[c][j] = pop ? v[c][j + 1] : v[c][j];
      }
      v[c][kSortWidth - 1] = pop ? kInt32Max : v[c][kSortWidth - 1];
    }
  }
  for (int i = r + 1 + tid; i < nb; i += kTileThreads) s.list[i] = kInt32Max;
  __syncthreads();
  return v[0][0];
}

// Loads this thread's columns of a tile whose row r starts at
// base + r * stride.
__device__ __forceinline__ void load_tile(TileSmem s, const int* bkey,
                                          const int* okey, const float* sd,
                                          size_t base, size_t stride, int k,
                                          float qscale) {
  for (int r = 0; r < k; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const size_t g = base + (size_t)r * stride + tile_col0() + c;
      const int si = r * kTile + tile_col0() + c;
      s.key[si] = bkey[g];
      s.pay[si] = pack_payload(okey[g], quantize_sd(sd[g], qscale));
    }
  }
  __syncthreads();
}

template <bool Wide>
__global__ void __launch_bounds__(kTileThreads, 2)
micro_stagea_kernel(const int* __restrict__ bkey, const int* __restrict__ okey,
                    const float* __restrict__ sd, int n, int k, int nb,
                    int mode, float qscale, float dscale,
                    int* __restrict__ pkeys, float* __restrict__ psd,
                    float* __restrict__ pw) {
  extern __shared__ int smem[];
  TileSmem s = tile_smem(smem, k, nb);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  load_tile(s, bkey, okey, sd, (size_t)tile * kTile, n, k, qscale);
  if (mode == kFull) {
    tile_accumulate<Wide>(s, k, nb, tile, dscale, pkeys, psd, pw);
    return;
  }
  int head = kInt32Max;
  if (mode == kPList || mode == kPFull) {
    head = tile_presorted_list(s, k, nb);
  } else if (mode == kMxu) {
    for (int i = tid; i < nb; i += kTileThreads) s.list[i] = i;
    __syncthreads();
  } else {
    tile_block_list(s, k, nb);
  }
  for (int i = tid; i < nb; i += kTileThreads) {
    pkeys[(size_t)tile * nb + i] = s.list[i];
  }

  if (mode == kPFull) {
    tile_ranks<Wide>(s, k, nb);
    tile_slab_accumulate<Wide>(s, k, nb, tile, dscale, psd, pw, false);
    return;
  }
  if (mode == kMxu) {
    for (int j = 0; j < k; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int si = j * kTile + tile_col0() + c;
        const int key = s.key[si];
        set_rank<Wide>(s, si, key == kInt32Max ? -1
                                               : min(max(key, 0), nb - 1));
      }
    }
    tile_slab_accumulate<Wide>(s, k, nb, tile, dscale, psd, pw, true);
    return;
  }
  if (mode == kRank) {
    for (int j = 0; j < k; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int si = j * kTile + tile_col0() + c;
        s.key[si] = count_rank(s.list, nb, s.key[si]);
      }
    }
  }
  // thread 0 holds cell (0, 0): its own first sample's rank, or its head
  const float first = mode == kRank ? (float)s.key[0]
                                    : mode == kPList ? (float)head : 0.0f;
  const size_t o0 = (size_t)tile * nb * kRowLen;
  for (int i = tid; i < nb * kRowLen; i += kTileThreads) {
    psd[o0 + i] = i == 0 ? first : 0.0f;
    pw[o0 + i] = 0.0f;
  }
}

template <bool Wide>
__global__ void __launch_bounds__(kTileThreads, 2)
micro_tile_accum_kernel(const int* __restrict__ bkeys,
                        const int* __restrict__ offs,
                        const float* __restrict__ sds, int rows, int nb,
                        float qscale, float dscale, int* __restrict__ pkeys,
                        float* __restrict__ psd, float* __restrict__ pw) {
  extern __shared__ int smem[];
  TileSmem s = tile_smem(smem, rows, nb);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  load_tile(s, bkeys, offs, sds, (size_t)tile * rows * kTile, kTile, rows,
            qscale);
  tile_block_list(s, rows, nb);
  for (int i = tid; i < nb; i += kTileThreads) {
    pkeys[(size_t)tile * nb + i] = s.list[i];
  }
  for (int j = 0; j < rows; ++j) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int si = j * kTile + tile_col0() + c;
      set_rank<Wide>(s, si, count_rank(s.list, nb, s.key[si]));
    }
  }
  tile_slab_accumulate<Wide>(s, rows, nb, tile, dscale, psd, pw, true);
}

// ---- M3: one-hot contraction bucketed by offset group, on wgmma ----
constexpr int kM3Threads = 256;        // two warpgroups
constexpr int kM3WgThreads = 128;
constexpr int kM3Groups = 8;           // okey >> 6: groups of 64 offset rows
constexpr int kM3GroupRows = 64;       // = wgmma's M
constexpr int kM3Parities = 2;         // chunk buffers a warpgroup (c & 1)
constexpr int kM3RowsInFlight = 2;     // rows of a tile loaded at once
constexpr unsigned kM3Keep = 1u << 31;

// staged sample word, 0 for a sample that adds nothing:
// okey (9 bits) | lrow (6) << 9 | sdq (8) << 16 | kM3Keep
__device__ __forceinline__ int m3_group(unsigned w) { return (w >> 6) & 7; }
__device__ __forceinline__ int m3_row(unsigned w) { return w & 63; }
__device__ __forceinline__ int m3_lrow(unsigned w) { return (w >> 9) & 63; }
__device__ __forceinline__ int m3_sdq(unsigned w) {
  return (int)(signed char)((w >> 16) & 0xFF);
}

// 16-bit count of group g in a pair of packed counters (groups 0-3 in lo)
__device__ __forceinline__ int m3_field(unsigned long long lo,
                                        unsigned long long hi, int g) {
  return (int)(((g < 4 ? lo : hi) >> (16 * (g & 3))) & 0xFFFF);
}

// N = 2 nb columns of [sel . sdq, sel]
template <int N, bool kInt8>
struct M3Shape {
  static constexpr int kElem = kInt8 ? 1 : 2;           // operand bytes
  static constexpr int kStep = kInt8 ? 32 : 16;         // K of one wgmma
  static constexpr int kCore = 16 / kElem;              // K of a core row
  // K bytes of a chunk: 128 (4 wgmmas) where two CTAs still fit an SM
  static constexpr int kChunkBytes = N <= 80 ? 128 : 64;
  static constexpr int kChunk = kChunkBytes / kElem;    // samples a chunk
  static constexpr int kSteps = kChunk / kStep;         // wgmmas a chunk
  static constexpr int kABytes = kM3GroupRows * kChunkBytes;
  static constexpr int kParBytes = kABytes + N * kChunkBytes;
  // the chunk buffers of both warpgroups
  static constexpr int kBufBytes = 2 * kM3Parities * kParBytes;
  static_assert(kChunk <= kM3WgThreads, "one sample a thread and chunk");
};

// bytes of the region that holds the staged words, then the chunk buffers
template <int N, bool kInt8>
__host__ __device__ constexpr int m3_region_bytes(int k) {
  return M3Shape<N, kInt8>::kBufBytes > k * kTile * 4
             ? M3Shape<N, kInt8>::kBufBytes : k * kTile * 4;
}

// byte of element (row, k) in a chunk of a K-major operand of `rows` rows:
// core matrices along K are rows * 16 bytes apart (LBO), 8-row groups 128
// (SBO)
template <int N, bool kInt8>
__device__ __forceinline__ int m3_kmajor(int row, int k, int rows) {
  using S = M3Shape<N, kInt8>;
  return (k / S::kCore) * rows * 16 + (row >> 3) * 128 + (row & 7) * 16 +
         (k % S::kCore) * S::kElem;
}

// Sets (or clears) one sample's entries in a chunk: A[row][slot] = 1,
// B[lrow][slot] = sdq, B[nb + lrow][slot] = 1.
template <int N, bool kInt8>
__device__ __forceinline__ void m3_put(unsigned char* a, unsigned char* b,
                                       unsigned w, int slot, bool set) {
  const int lr = m3_lrow(w);
  const int ia = m3_kmajor<N, kInt8>(m3_row(w), slot, kM3GroupRows);
  const int isd = m3_kmajor<N, kInt8>(lr, slot, N);
  const int iw = m3_kmajor<N, kInt8>(N / 2 + lr, slot, N);
  if (kInt8) {
    a[ia] = set ? 1 : 0;
    b[isd] = set ? (unsigned char)m3_sdq(w) : 0;
    b[iw] = set ? 1 : 0;
  } else {   // bf16 bits; exact for |sdq| <= 256
    const unsigned short one = 0x3F80;
    const unsigned short sd =
        (unsigned short)(__float_as_uint((float)m3_sdq(w)) >> 16);
    *reinterpret_cast<unsigned short*>(a + ia) = set ? one : 0;
    *reinterpret_cast<unsigned short*>(b + isd) = set ? sd : 0;
    *reinterpret_cast<unsigned short*>(b + iw) = set ? one : 0;
  }
}

// One CTA per tile.
template <int N, bool kInt8>
__global__ void __launch_bounds__(kM3Threads, 2)
micro_mxu8_kernel(const int* __restrict__ okey, const int* __restrict__ sdq,
                  const int* __restrict__ lrow, const int* __restrict__ use,
                  int n, int k, float* __restrict__ psd,
                  float* __restrict__ pw, int* __restrict__ steps_out) {
  using S = M3Shape<N, kInt8>;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int nb = N / 2;
  extern __shared__ __align__(128) unsigned char m3_smem[];
  __shared__ unsigned long long wsum[2][kM3Threads / 32];
  __shared__ int gstart[kM3Groups], gkept[kM3Groups];
  __shared__ int nsteps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  unsigned* stage = reinterpret_cast<unsigned*>(m3_smem);
  unsigned* sorted =
      reinterpret_cast<unsigned*>(m3_smem + m3_region_bytes<N, kInt8>(k));

  // 1. stage the tile's samples as words (4 columns a thread, each row
  // read as int4, kM3RowsInFlight rows of loads issued at once) and count
  // the kept ones of each group
  unsigned long long lo = 0, hi = 0;
  for (int r0 = 0; r0 < k; r0 += kM3RowsInFlight) {
    int4 o[kM3RowsInFlight], s[kM3RowsInFlight], l[kM3RowsInFlight],
        u[kM3RowsInFlight];
#pragma unroll
    for (int h = 0; h < kM3RowsInFlight; ++h) {
      if (r0 + h >= k) break;
      const size_t g0 =
          (size_t)(r0 + h) * n + (size_t)tile * kTile + 4 * tid;
      o[h] = __ldg(reinterpret_cast<const int4*>(okey + g0));
      s[h] = __ldg(reinterpret_cast<const int4*>(sdq + g0));
      l[h] = __ldg(reinterpret_cast<const int4*>(lrow + g0));
      u[h] = __ldg(reinterpret_cast<const int4*>(use + g0));
    }
#pragma unroll
    for (int h = 0; h < kM3RowsInFlight; ++h) {
      if (r0 + h >= k) break;
      const int oo[4] = {o[h].x, o[h].y, o[h].z, o[h].w};
      const int ss[4] = {s[h].x, s[h].y, s[h].z, s[h].w};
      const int ll[4] = {l[h].x, l[h].y, l[h].z, l[h].w};
      const int uu[4] = {u[h].x, u[h].y, u[h].z, u[h].w};
      unsigned w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool keep = uu[c] != 0 && ll[c] >= 0 && ll[c] < nb;
        w[c] = keep ? (unsigned)(oo[c] & 0x1FF) | ((unsigned)ll[c] << 9) |
                          (((unsigned)ss[c] & 0xFF) << 16) | kM3Keep
                    : 0u;
        const int g = (oo[c] >> 6) & 7;
        const unsigned long long one =
            keep ? 1ull << (16 * (g & 3)) : 0ull;
        if (g < 4) lo += one; else hi += one;
      }
      *reinterpret_cast<uint4*>(stage + (r0 + h) * kTile + 4 * tid) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  // 2. counting sort by group: exclusive block scan of the packed counts
  const unsigned long long own_lo = lo, own_hi = hi;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long a = __shfl_up_sync(0xFFFFFFFFu, lo, d);
    const unsigned long long b = __shfl_up_sync(0xFFFFFFFFu, hi, d);
    if (lane >= d) { lo += a; hi += b; }
  }
  if (lane == 31) { wsum[0][warp] = lo; wsum[1][warp] = hi; }
  __syncthreads();
  unsigned long long base_lo = lo - own_lo, base_hi = hi - own_hi;
  unsigned long long tot_lo = 0, tot_hi = 0;
#pragma unroll
  for (int w = 0; w < kM3Threads / 32; ++w) {
    if (w < warp) { base_lo += wsum[0][w]; base_hi += wsum[1][w]; }
    tot_lo += wsum[0][w];
    tot_hi += wsum[1][w];
  }
  if (tid == 0) {
    int start = 0;
    for (int g = 0; g < kM3Groups; ++g) {
      gstart[g] = start;
      gkept[g] = m3_field(tot_lo, tot_hi, g);
      start += gkept[g];
    }
    nsteps = 0;
  }
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    const uint4 v = *reinterpret_cast<const uint4*>(stage + r * kTile +
                                                   4 * tid);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (w[c] == 0u) continue;
      const int g = m3_group(w[c]);
      sorted[gstart[g] + m3_field(base_lo, base_hi, g)] = w[c];
      const unsigned long long one = 1ull << (16 * (g & 3));
      if (g < 4) base_lo += one; else base_hi += one;
    }
  }
  __syncthreads();
  // the chunk buffers (over the staged words) start zero; a chunk's
  // writer clears its entries once the wgmmas that read them are done
  for (int i = tid; i < S::kBufBytes / 16; i += kM3Threads) {
    reinterpret_cast<uint4*>(m3_smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  __syncthreads();

  // 3. per group, D (64 x N) += onehot(okey & 63) (64 x samples) times
  // [sel . sdq, sel] (samples x N), chunk by chunk; each group's list is
  // read as if padded with null samples to a multiple of one wgmma's K.
  // Double buffered: a chunk is written while the one before runs.
  // wg is warp-uniform (shuffled from lane 0), so that ptxas sees the
  // group loop and the wgmmas in it as uniform and does not serialize them
  const int wg = __shfl_sync(0xFFFFFFFFu, tid / kM3WgThreads, 0);
  const int wtid = tid % kM3WgThreads;
  unsigned char* bufs = m3_smem + wg * kM3Parities * S::kParBytes;
  const uint32_t bufs_s = (uint32_t)__cvta_generic_to_shared(bufs);
  Acc acc[N / 2];
  unsigned last0 = 0u, last1 = 0u;    // word each parity holds at wtid
  int c = 0, my_steps = 0;
  for (int g = wg; g < kM3Groups; g += 2) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0;
    wgmma_fence_regs(acc);
    const int kept = gkept[g];
    const int len = (kept + S::kStep - 1) / S::kStep * S::kStep;
    const unsigned* list = sorted + gstart[g];
    for (int k0 = 0; k0 < len; k0 += S::kChunk, ++c) {
      const int q = c & 1;
      unsigned char* a = bufs + q * S::kParBytes;
      wgmma_wait<kM3Parities - 1>();   // chunk c - 2 (parity q) is done
      if (wtid < S::kChunk) {
        const unsigned old = q ? last1 : last0;
        if (old) m3_put<N, kInt8>(a, a + S::kABytes, old, wtid, false);
        const unsigned w = k0 + wtid < kept ? list[k0 + wtid] : 0u;
        if (w) m3_put<N, kInt8>(a, a + S::kABytes, w, wtid, true);
        if (q) last1 = w; else last0 = w;
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kM3WgThreads)
                   : "memory");
      const uint32_t sa = bufs_s + q * S::kParBytes;
      const uint64_t da = wgmma_desc(sa, kM3GroupRows * 16, 128);
      const uint64_t db = wgmma_desc(sa + S::kABytes, N * 16, 128);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < S::kSteps; ++st) {
        // step st reads K core matrices 2 st and 2 st + 1
        if (k0 + st * S::kStep < len) {
          wgmma_ss(acc, da + ((2 * st * kM3GroupRows * 16) >> 4),
                   db + ((2 * st * N * 16) >> 4));
          ++my_steps;
        }
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    wgmma_fence_regs(acc);
    const int row = (wtid >> 5) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * (lane & 3) + (e & 1);
        float* out = 8 * j < nb ? psd : pw;
        const int b = 8 * j < nb ? col : col - nb;
        out[((size_t)tile * nb + b) * kRowLen + g * kM3GroupRows + row +
            8 * (e >> 1)] = (float)acc[4 * j + e];
      }
    }
  }
  if (wtid == 0) atomicAdd(&nsteps, my_steps);
  __syncthreads();
  if (tid == 0 && steps_out != nullptr) steps_out[tile] = nsteps;
}

template <int N, bool kInt8>
int launch_mxu8(const int* okey, const int* sdq, const int* lrow,
                const int* use, int n, int k, float* psd, float* pw,
                int* steps, cudaStream_t stream) {
  auto kern = micro_mxu8_kernel<N, kInt8>;
  const int smem = m3_region_bytes<N, kInt8>(k) + k * kTile * 4;
  cudaError_t err = tile_kernel_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  if (n / kTile == 0) return 0;
  kern<<<n / kTile, kM3Threads, smem, stream>>>(okey, sdq, lrow, use, n, k,
                                                psd, pw, steps);
  CHAD_RETURN_LAUNCH_ERROR();
}

template <bool kInt8>
int dispatch_mxu8(const int* okey, const int* sdq, const int* lrow,
                  const int* use, int n, int k, int nb, float* psd, float* pw,
                  int* steps, cudaStream_t stream) {
  switch (nb) {   // wgmma's N = 2 nb
    case 16: return launch_mxu8<32, kInt8>(okey, sdq, lrow, use, n, k, psd, pw, steps, stream);
    case 32: return launch_mxu8<64, kInt8>(okey, sdq, lrow, use, n, k, psd, pw, steps, stream);
    case 40: return launch_mxu8<80, kInt8>(okey, sdq, lrow, use, n, k, psd, pw, steps, stream);
    case 48: return launch_mxu8<96, kInt8>(okey, sdq, lrow, use, n, k, psd, pw, steps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace chad

extern "C" int chad_micro_stagea_phases(const int* bkey, const int* okey,
                                        const float* sd, int n, int k, int nb,
                                        int mode, float qscale, float dscale,
                                        int* pkeys, float* psd, float* pw,
                                        void* stream) {
  if (!chad::tile_args_ok(k, nb)) return (int)cudaErrorInvalidValue;
  const int tiles = n / chad::kTile;
  cudaStream_t s = (cudaStream_t)stream;
  return chad::tile_wide(nb)
      ? chad::launch_tile_kernel(chad::micro_stagea_kernel<true>, tiles, k,
                                nb, s, bkey, okey, sd, n, k, nb, mode, qscale,
                                dscale, pkeys, psd, pw)
      : chad::launch_tile_kernel(chad::micro_stagea_kernel<false>, tiles, k,
                                nb, s, bkey, okey, sd, n, k, nb, mode, qscale,
                                dscale, pkeys, psd, pw);
}

extern "C" int chad_micro_tile_accum(const int* bkeys, const int* offs,
                                     const float* sds, int ntiles, int rows,
                                     int nb, float qscale, float dscale,
                                     int* pkeys, float* psd, float* pw,
                                     void* stream) {
  if (!chad::tile_args_ok(rows, nb)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return chad::tile_wide(nb)
      ? chad::launch_tile_kernel(chad::micro_tile_accum_kernel<true>, ntiles,
                                rows, nb, s, bkeys, offs, sds, rows, nb,
                                qscale, dscale, pkeys, psd, pw)
      : chad::launch_tile_kernel(chad::micro_tile_accum_kernel<false>, ntiles,
                                rows, nb, s, bkeys, offs, sds, rows, nb,
                                qscale, dscale, pkeys, psd, pw);
}

extern "C" int chad_micro_mxu8(const int* okey, const int* sdq,
                               const int* lrow, const int* use, int n, int k,
                               int nb, int int8, float* psd, float* pw,
                               int* steps, void* stream) {
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return int8 ? chad::dispatch_mxu8<true>(okey, sdq, lrow, use, n, k, nb, psd,
                                          pw, steps, s)
              : chad::dispatch_mxu8<false>(okey, sdq, lrow, use, n, k, nb,
                                           psd, pw, steps, s);
}
