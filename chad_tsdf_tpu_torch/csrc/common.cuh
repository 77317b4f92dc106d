// Device code shared by the port's Hopper kernels.
//
// tile_accumulate() is the stage that kernels K1 (fused_integrate.cu) and
// K4 (tile_accum.cu) have in common: the block list, coverage rule, ranks
// and per-tile partial rows of one 1024-point tile.  Both kernels call this
// one function, so the coverage rule that the fused insert's fallback
// re-derives through K4 cannot diverge from K1's.  Its phases (block list,
// ranks, slab accumulate) are also separate functions, which the
// microbenchmark kernels of micro.cu time one at a time.
//
// A tile is 1024 sample columns on a CTA of 512 threads (two adjacent
// columns each).  The list is built per warp with warp reductions and
// merged once (two CTA barriers, not nb rounds of three); only live partial
// rows are written, 16 bytes a thread; and the keys' shared memory holds
// the accumulate slab once ranks are packed into the payloads, so a CTA
// needs 107 KiB at K = 10, nb = 48 and two fit on an SM.
//
// The list may hold any number of blocks that shared memory allows (the
// host checks tile_smem_words against kMaxTileSmemBytes).  Up to
// kNarrowMaxNb the rank rides in the sample word's top 7 bits (pack_rank);
// a wider list keeps a 16-bit rank per sample beside the words (TileSmem
// rank), which costs K x 2 KiB more shared memory.  The stages are
// templates on that choice (Wide), picked at launch from nb, so the narrow
// kernels are the ones they were.
//
// It replaces the list/rank/accumulate stages of the TPU kernels
// chad_tsdf_tpu/ops/tile_accum.py:_tile_kernel and
// chad_tsdf_tpu/ops/fused_integrate.py:_kernel (:175-325).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace chad {

constexpr int kTile = 1024;        // points (sample columns) per tile
constexpr int kTileThreads = 512;  // threads per tile CTA
constexpr int kCols = kTile / kTileThreads;   // adjacent columns per thread
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kInt32Max = 0x7fffffff;
// an invalid slot of the carve's int64 sample keys (INT32_MAX << 32 |
// INT32_MAX), which sorts after every valid key
constexpr unsigned long long kInvalidKey =
    ((unsigned long long)kInt32Max << 32) | (unsigned)kInt32Max;
// carve_sort's digit (carve_sort.cu): kSortBits bits of a valid carve key's
// sort value bkey << 9 | okey, which has at most 3 * 10 + 9 bits
constexpr int kSortBits = 8;
constexpr int kSortBins = 1 << kSortBits;
constexpr int kMaxSortPasses = (3 * 10 + 9 + kSortBits - 1) / kSortBits;
constexpr int kSlab = 16;          // list ranks accumulated per pass
constexpr int kRowLen = 512;       // voxels per 8x8x8 block
constexpr int kRegRows = 12;       // rows the list phase holds in registers
constexpr int kNarrowMaxNb = 127;  // the rank field of a packed sample: 7 bits
constexpr int kSkip = -1;          // packed sample that no rank takes
constexpr unsigned short kWideSkip = 0xFFFF;   // wide rank that none takes
// dynamic shared memory a CTA may opt into on sm_90 (227 KiB)
constexpr int kMaxTileSmemBytes = 227 * 1024;
static_assert(kCols == 2, "the tile phases load column pairs as int2");

__device__ __forceinline__ int spread3_10(int x) {
  x &= 0x3FF;
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

__device__ __forceinline__ int compact3_10(int x) {
  x &= 0x09249249;
  x = (x | (x >> 2)) & 0x030C30C3;
  x = (x | (x >> 4)) & 0x0300F00F;
  x = (x | (x >> 8)) & 0x030000FF;
  x = (x | (x >> 16)) & 0x000003FF;
  return x;
}

// The combining operations of cta_scan's second value: a maximum over
// values >= -1 (-1 the identity), or a sum.
struct MaxOp {
  static constexpr int kIdentity = -1;
  __device__ static int apply(int x, int y) { return max(x, y); }
};
struct SumOp {
  static constexpr int kIdentity = 0;
  __device__ static int apply(int x, int y) { return x + y; }
};

// Exclusive scan over the CTA of (a, b): a by sum, b by Op.  Every thread
// gets the totals.  s holds 2 * kWarps ints and may be reused once the call
// returns.
template <int kWarps, typename Op>
__device__ __forceinline__ void cta_scan(int& a, int& b, int& total_a,
                                         int& total_b, int* s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = a, y = b;
  for (int d = 1; d < 32; d <<= 1) {
    const int xu = __shfl_up_sync(0xffffffffu, x, d);
    const int yu = __shfl_up_sync(0xffffffffu, y, d);
    if (lane >= d) {
      x += xu;
      y = Op::apply(y, yu);
    }
  }
  if (lane == 31) {
    s[warp] = x;
    s[kWarps + warp] = y;
  }
  __syncthreads();
  if (warp == 0) {
    int wx = lane < kWarps ? s[lane] : 0;
    int wy = lane < kWarps ? s[kWarps + lane] : Op::kIdentity;
    for (int d = 1; d < 32; d <<= 1) {
      const int xu = __shfl_up_sync(0xffffffffu, wx, d);
      const int yu = __shfl_up_sync(0xffffffffu, wy, d);
      if (lane >= d) {
        wx += xu;
        wy = Op::apply(wy, yu);
      }
    }
    if (lane < kWarps) {
      s[lane] = wx;
      s[kWarps + lane] = wy;
    }
  }
  __syncthreads();
  int xe = __shfl_up_sync(0xffffffffu, x, 1);
  int ye = __shfl_up_sync(0xffffffffu, y, 1);
  if (lane == 0) {
    xe = 0;
    ye = Op::kIdentity;
  }
  a = xe + (warp > 0 ? s[warp - 1] : 0);
  b = Op::apply(ye, warp > 0 ? s[kWarps + warp - 1] : Op::kIdentity);
  total_a = s[kWarps - 1];
  total_b = s[2 * kWarps - 1];
  __syncthreads();
}

// The sort value of a valid carve key: bkey << 9 | okey.
__device__ __forceinline__ unsigned long long sort_value(
    unsigned long long key) {
  return (key >> 32) << 9 | (key & 511ull);
}

__device__ __forceinline__ int encode_block(int bx, int by, int bz) {
  return spread3_10(bx) | (spread3_10(by) << 1) | (spread3_10(bz) << 2);
}

__device__ __forceinline__ int spread3_3(int x) {
  x &= 7;
  return (x & 1) | ((x & 2) << 2) | ((x & 4) << 4);
}

__device__ __forceinline__ int encode_offset(int ox, int oy, int oz) {
  return spread3_3(ox) | (spread3_3(oy) << 1) | (spread3_3(oz) << 2);
}

// Signed distance -> 16-bit fixed point on the SD_QUANT = 32767 grid of
// the sort path's payload (core/integrate.py pack_payload): round half to
// even, as torch.round does in the plain version.
__device__ __forceinline__ int quantize_sd(float sd, float qscale) {
  int q = __float2int_rn(sd * qscale);
  return min(max(q, -32767), 32767);
}

__device__ __forceinline__ int pack_payload(int okey, int q) {
  return (okey << 16) | (q & 0xFFFF);
}

// ---- The ray walk of K1 (fused_integrate.cu) and seg_samples
// (seg_samples.cu): the Amanatides-Woo traversal of ops/dda.py through a
// ray's truncation band, its projective signed distances and local keys.
// Both kernels must give the voxels of the plain PyTorch traversal bit for
// bit (the fused insert's fallback re-derives K1's coverage through it,
// and the seg insert's plain twin is it), so every expression is the same
// sequence of rounded f32 operations as dda.py, built with -fmad=false,
// and res_recip is the host-rounded f32 of 1/res.

constexpr float kFmax = 3.4028235e38f;

// A voxel's local coordinates (each taken mod 2^13, the largest extent)
// interleaved into one 39-bit Morton code: bits >> 9 are the block key,
// bits & 511 the offset key (encode_block / encode_offset).  A DDA step
// moves one axis by one voxel, which is an add on that axis's bits.
constexpr unsigned long long kMortonX = 0x1249249249ull;   // x's 13 bits

__device__ __forceinline__ unsigned long long spread3_13(int v) {
  unsigned long long x = (unsigned)v & 0x1FFFu;
  x = (x | (x << 16)) & 0x1F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

__device__ __forceinline__ unsigned long long step_morton(
    unsigned long long m, unsigned long long mask, int dir) {
  const unsigned long long a = dir > 0 ? (m | ~mask) + 1ull
                                       : (m & mask) - 1ull;
  return dir == 0 ? m : (a & mask) | (m & ~mask);
}

struct Axis {
  int vs, vf, sdir;
  float delta, tmax;
};

__device__ __forceinline__ Axis axis_setup(float p, float d, float res,
                                           float res_recip, float trunc) {
  Axis a;
  const float start = p - d * trunc;
  const float final_ = p + d * trunc;
  a.vs = (int)floorf(start * res_recip);
  a.vf = (int)floorf(final_ * res_recip);
  const int diff = a.vf - a.vs;
  a.sdir = (diff > 0) - (diff < 0);
  const float d_recip = 1.0f / d;
  a.delta = fabsf(d_recip * res);
  const float bound = a.sdir < 0 ? floorf(start * res_recip) * res
                                 : ceilf(start * res_recip) * res;
  a.tmax = fabsf((bound - start) * d_recip);
  if (a.sdir == 0) {
    a.tmax = kFmax;
    a.delta = kFmax;
  }
  return a;
}

// One ray's walk: its three axes, its current voxel, the axes' next
// boundary crossings, whether it still emits, and the voxel's local Morton
// code.
struct Ray {
  Axis ax, ay, az;
  int vx, vy, vz;
  float tx, ty, tz;
  bool alive;
  unsigned long long mc;
};

// The ray from the scanner q through the point (x, y, z), at its first
// voxel (octree.hpp:96-125); valid is false for a padding point.  (ox, oy,
// oz) is the local extent's origin voxel.
__device__ __forceinline__ Ray ray_start(float x, float y, float z, float qx,
                                         float qy, float qz, bool valid,
                                         int ox, int oy, int oz, float res,
                                         float res_recip, float trunc) {
  float dx = x - qx;
  float dy = y - qy;
  float dz = z - qz;
  const float norm = sqrtf(dx * dx + dy * dy + dz * dz);
  const float inv = 1.0f / norm;
  dx = dx * inv;
  dy = dy * inv;
  dz = dz * inv;
  const bool dir_ok = isfinite(dx) && isfinite(dy) && isfinite(dz);
  Ray w;
  w.ax = axis_setup(x, dx, res, res_recip, trunc);
  w.ay = axis_setup(y, dy, res, res_recip, trunc);
  w.az = axis_setup(z, dz, res, res_recip, trunc);
  w.vx = w.ax.vs;
  w.vy = w.ay.vs;
  w.vz = w.az.vs;
  w.tx = w.ax.tmax;
  w.ty = w.ay.tmax;
  w.tz = w.az.tmax;
  w.alive = dir_ok && valid;
  w.mc = spread3_13(w.vx - ox) | (spread3_13(w.vy - oy) << 1) |
         (spread3_13(w.vz - oz) << 2);
  return w;
}

// One step to the next voxel: the axis pick of octree.hpp:128-148; the ray
// stops emitting once the stepped axis passes its final voxel.
__device__ __forceinline__ void ray_step(Ray& w) {
  const bool pick_x = (w.tx < w.ty) && (w.tx < w.tz);
  const bool pick_y = !(w.tx < w.ty) && (w.ty < w.tz);
  bool passed;
  if (pick_x) {
    w.vx += w.ax.sdir;
    w.tx = w.tx + w.ax.delta;
    passed = w.vx == w.ax.vf + w.ax.sdir;
    w.mc = step_morton(w.mc, kMortonX, w.ax.sdir);
  } else if (pick_y) {
    w.vy += w.ay.sdir;
    w.ty = w.ty + w.ay.delta;
    passed = w.vy == w.ay.vf + w.ay.sdir;
    w.mc = step_morton(w.mc, kMortonX << 1, w.ay.sdir);
  } else {
    w.vz += w.az.sdir;
    w.tz = w.tz + w.az.delta;
    passed = w.vz == w.az.vf + w.az.sdir;
    w.mc = step_morton(w.mc, kMortonX << 2, w.az.sdir);
  }
  w.alive = w.alive && !passed;
}

// The sample at the ray's current voxel: key is its local block key and
// pay its pack_payload(offset, quantized sd), or kInt32Max and 0 where the
// ray no longer emits or the voxel lies outside the local extent.  Counts
// the valid samples and the emitted ones outside the extent.
__device__ __forceinline__ void ray_sample(const Ray& w, float x, float y,
                                           float z, float n0, float n1,
                                           float n2, int ox, int oy, int oz,
                                           int extent, float res, float trunc,
                                           float qscale, int& key, int& pay,
                                           int& n_valid, int& n_samp_ovf) {
  const int lx = w.vx - ox, ly = w.vy - oy, lz = w.vz - oz;
  const bool in_range = lx >= 0 && lx < extent && ly >= 0 && ly < extent &&
                        lz >= 0 && lz < extent;
  n_samp_ovf += (w.alive && !in_range);
  const bool ok = w.alive && in_range;
  n_valid += ok;
  key = kInt32Max;
  pay = 0;
  if (ok) {
    key = (int)(w.mc >> 9);              // encode_block(l >> 3)
    const int okey = (int)(w.mc & 511u);   // encode_offset(l & 7)
    // projective sd along the normal (octree.hpp:156-159)
    float sd = n0 * ((float)w.vx * res - x) + n1 * ((float)w.vy * res - y) +
               n2 * ((float)w.vz * res - z);
    sd = fminf(fmaxf(sd, -trunc), trunc);
    pay = pack_payload(okey, quantize_sd(sd, qscale));
  }
}

// Minimum over the CTA; every thread gets the result.
__device__ __forceinline__ int block_min(int v, int* s_red) {
  v = __reduce_min_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < warps ? s_red[lane] : kInt32Max;
    w = __reduce_min_sync(0xffffffffu, w);
    if (lane == 0) s_red[32] = w;
  }
  __syncthreads();
  const int out = s_red[32];
  __syncthreads();          // s_red is reused by the next call
  return out;
}

// Whether a list of nb blocks needs the separate 16-bit ranks.
__host__ __device__ inline bool tile_wide(int nb) {
  return nb > kNarrowMaxNb;
}

// Dynamic shared memory of tile_accumulate's callers, in 32-bit words: the
// keys, later overlaid by the accumulate slab; the payloads; a wide list's
// 16-bit ranks; the warp lists; the list; scratch.  k = 10, nb = 48:
// 27,488 words (107 KiB), so two CTAs fit on an SM; k = 1, nb = 128:
// 20,144 words (78.7 KiB); k = 10, nb = 1024: 49,200 words (192.2 KiB).
__host__ __device__ inline int tile_smem_words(int k, int nb) {
  const int keys = k * kTile, slab = 2 * kSlab * kRowLen;
  const int ranks = tile_wide(nb) ? keys / 2 : 0;
  return (keys > slab ? keys : slab) + keys + ranks + kTileWarps * nb + nb +
         48;
}

struct TileSmem {
  int* key;    // [k * kTile] block key per sample, kInt32Max = invalid
  int* accq;   // [kSlab * kRowLen] quantized sd sums of a slab; aliases key
  int* accw;   // [kSlab * kRowLen] sample counts of a slab, after accq
  int* pay;    // [k * kTile] pack_payload(offset, q), then (narrow) with
               // its rank
  unsigned short* rank;   // wide lists only: [k * kTile] rank per sample
  int* wl;     // [kTileWarps * nb] each warp's list
  int* list;   // [nb] the tile's block list, ascending
  int* red;    // [48] reduction scratch and counters
};

__device__ __forceinline__ TileSmem tile_smem(int* base, int k, int nb) {
  const int keys = k * kTile, slab = 2 * kSlab * kRowLen;
  TileSmem s;
  s.key = base;
  s.accq = base;
  s.accw = base + kSlab * kRowLen;
  s.pay = base + (keys > slab ? keys : slab);
  s.rank = nullptr;
  s.wl = s.pay + keys;
  if (tile_wide(nb)) {
    s.rank = reinterpret_cast<unsigned short*>(s.wl);
    s.wl += keys / 2;
  }
  s.list = s.wl + kTileWarps * nb;
  s.red = s.list + nb;
  return s;
}

// Sample word of a narrow list's accumulate: rank (7 bits) << 25 |
// pack_payload's 25 bits; kSkip (rank field 127) is taken by no rank.  (The
// rank replaces the key, so the keys' shared memory can hold the
// accumulate slab.)
__device__ __forceinline__ int pack_rank(int rank, int pay) {
  return (int)(((unsigned)rank << 25) | ((unsigned)pay & 0x1FFFFFFu));
}

// Records sample idx's rank in the list; rank < 0: the sample adds to no
// row.  A narrow list packs it into the sample word, a wide one keeps it
// in s.rank and leaves the word as it is.
template <bool Wide>
__device__ __forceinline__ void set_rank(TileSmem s, int idx, int rank) {
  if constexpr (Wide) {
    s.rank[idx] = rank < 0 ? kWideSkip : (unsigned short)rank;
  } else {
    s.pay[idx] = rank < 0 ? kSkip : pack_rank(rank, s.pay[idx]);
  }
}

// Sample idx's rank as set_rank recorded it (>= nb for a skipped sample);
// p is its sample word.
template <bool Wide>
__device__ __forceinline__ int get_rank(TileSmem s, int idx, unsigned p) {
  if constexpr (Wide) {
    return (int)s.rank[idx];
  } else {
    return (int)(p >> 25);
  }
}

// This thread's first sample column; its columns are tile_col0() + c,
// c < kCols.
__device__ __forceinline__ int tile_col0() { return kCols * threadIdx.x; }

// Per-column bit masks over the sample rows r.
struct ColMask {
  unsigned m[kCols];
};

// The phases of a tile, each over the samples in s.key / s.pay at
// [r * kTile + col], r < k, for this thread's columns (block keys >= 0,
// kInt32Max = invalid).
//
// warp_block_list: this warp's ascending distinct valid keys, at most nb,
// into its s.wl row (kInt32Max-terminated when shorter).  Rounds of "the
// smallest key above the last one" over the warp's 64 columns, with a warp
// reduction and no CTA barrier.
static __device__ void warp_block_list(TileSmem s, int k, int nb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = tile_col0();
  int* wl = s.wl + warp * nb;
  int prev = -1;
  if (k <= kRegRows) {
    int key[kRegRows][kCols];
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
      const int2 v = r < k
          ? *reinterpret_cast<const int2*>(&s.key[r * kTile + col])
          : make_int2(kInt32Max, kInt32Max);
      key[r][0] = v.x;
      key[r][1] = v.y;
    }
    for (int i = 0; i < nb; ++i) {
      int local = kInt32Max;
#pragma unroll
      for (int r = 0; r < kRegRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int x = key[r][c];
          if (x > prev && x < local) local = x;
        }
      const int m = __reduce_min_sync(0xffffffffu, local);
      if (lane == 0) wl[i] = m;
      if (m == kInt32Max) break;       // uniform over the warp
      prev = m;
    }
  } else {
    for (int i = 0; i < nb; ++i) {
      int local = kInt32Max;
      for (int r = 0; r < k; ++r) {
        const int2 v = *reinterpret_cast<const int2*>(&s.key[r * kTile + col]);
        if (v.x > prev && v.x < local) local = v.x;
        if (v.y > prev && v.y < local) local = v.y;
      }
      const int m = __reduce_min_sync(0xffffffffu, local);
      if (lane == 0) wl[i] = m;
      if (m == kInt32Max) break;
      prev = m;
    }
  }
}

// tile_block_list: the list of the nb smallest distinct valid block keys,
// ascending and kInt32Max-padded, in s.list (visible to the whole CTA on
// return).  The warps' lists (each holding its nb smallest) are merged once
// by warp 0, lane w walking warp w's list: two CTA barriers in all.
static __device__ void tile_block_list(TileSmem s, int k, int nb) {
  warp_block_list(s, k, nb);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int* wl = s.wl + lane * nb;
    int pos = 0;
    int cand = lane < kTileWarps ? wl[0] : kInt32Max;
    int i = 0;
    for (; i < nb; ++i) {
      const int m = __reduce_min_sync(0xffffffffu, cand);
      if (lane == 0) s.list[i] = m;
      if (m == kInt32Max) break;
      if (cand == m) {
        ++pos;
        cand = pos < nb ? wl[pos] : kInt32Max;
      }
    }
    for (int j = i + 1 + lane; j < nb; j += 32) s.list[j] = kInt32Max;
  }
  __syncthreads();
}

// Number of live entries of s.list (they form its prefix).
__device__ __forceinline__ int list_live(const int* list, int nb) {
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] != kInt32Max) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// tile_ranks: records each of this thread's samples' rank in s.list
// (set_rank), or none where the sample is invalid or not covered (key
// beyond the list's last entry); returns, per column, the bit mask over r
// of the valid uncovered samples.  A ray's consecutive samples mostly share
// a block, so the last lookup is reused; a lookup searches the live prefix.
template <bool Wide>
static __device__ ColMask tile_ranks(TileSmem s, int k, int nb) {
  // covered <=> key among the list <=> key <= the list's last entry
  const int last = s.list[nb - 1];
  const int live = list_live(s.list, nb);
  ColMask ovf;
  int ck = -1, cr = 0;                   // last key looked up, its rank
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    ovf.m[c] = 0;
    for (int r = 0; r < k; ++r) {
      const int idx = r * kTile + tile_col0() + c;
      const int key = s.key[idx];
      int rank = -1;
      if (key != kInt32Max) {
        if (key <= last) {
          if (key != ck) {
            int lo = 0, hi = live - 1;       // lower_bound in the list
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (s.list[mid] < key) lo = mid + 1; else hi = mid;
            }
            ck = key;
            cr = lo;
          }
          rank = cr;
        } else {
          ovf.m[c] |= 1u << r;
        }
      }
      set_rank<Wide>(s, idx, rank);
    }
  }
  return ovf;
}

// tile_slab_accumulate: the tile's partial rows psd/pw (nb x 512) from the
// samples in s.pay and their ranks (get_rank), with sd sums dequantized by
// dscale, one slab of
// kSlab ranks at a time.  Only the live rows (list entry != kInt32Max, a
// prefix of the list) are accumulated and written; dead rows of psd/pw are
// left as they were, and their readers skip them.  With all_rows every
// row is accumulated and written (the microbenchmarks' fixed ranks).  Sums
// are 32-bit integer atomics in shared memory, order free, so the result
// is the same on every run; rows are written 16 bytes a thread.  Starts
// with a barrier: the slab overlays the keys.
template <bool Wide>
static __device__ void tile_slab_accumulate(TileSmem s, int k, int nb,
                                            int tile, float dscale,
                                            float* psd, float* pw,
                                            bool all_rows) {
  const int tid = threadIdx.x;
  const int live = all_rows ? nb : list_live(s.list, nb);
  __syncthreads();
  int4* q4 = reinterpret_cast<int4*>(s.accq);
  int4* w4 = reinterpret_cast<int4*>(s.accw);
  for (int r0 = 0; r0 < live; r0 += kSlab) {
    const int rows = min(kSlab, live - r0);
    const int quads = rows * (kRowLen / 4);
    for (int i = tid; i < quads; i += kTileThreads) {
      q4[i] = make_int4(0, 0, 0, 0);
      w4[i] = make_int4(0, 0, 0, 0);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      for (int r = 0; r < k; ++r) {
        const int idx = r * kTile + tile_col0() + c;
        const unsigned p = (unsigned)s.pay[idx];
        const int rr = get_rank<Wide>(s, idx, p) - r0;
        if (rr >= 0 && rr < rows) {
          const int cell = rr * kRowLen + ((p >> 16) & 0x1FF);
          atomicAdd(&s.accq[cell], (int)(short)(p & 0xFFFFu));
          atomicAdd(&s.accw[cell], 1);
        }
      }
    }
    __syncthreads();
    float4* sd4 = reinterpret_cast<float4*>(
        psd + ((size_t)tile * nb + r0) * kRowLen);
    float4* pw4 = reinterpret_cast<float4*>(
        pw + ((size_t)tile * nb + r0) * kRowLen);
    for (int i = tid; i < quads; i += kTileThreads) {
      const int4 q = q4[i], w = w4[i];
      sd4[i] = make_float4((float)q.x * dscale, (float)q.y * dscale,
                           (float)q.z * dscale, (float)q.w * dscale);
      pw4[i] = make_float4((float)w.x, (float)w.y, (float)w.z, (float)w.w);
    }
    if (r0 + kSlab < live) __syncthreads();
  }
}

// The block list, coverage rule, ranks and live partial rows of one tile:
// writes the list to pkeys and the live partial rows to psd/pw, and returns,
// per column of this thread, the bit mask over r of the valid samples that
// are NOT covered.  Wide must be tile_wide(nb).
template <bool Wide>
static __device__ ColMask tile_accumulate(TileSmem s, int k, int nb, int tile,
                                          float dscale, int* pkeys,
                                          float* psd, float* pw) {
  tile_block_list(s, k, nb);
  for (int i = threadIdx.x; i < nb; i += kTileThreads) {
    pkeys[(size_t)tile * nb + i] = s.list[i];
  }
  const ColMask ovf = tile_ranks<Wide>(s, k, nb);
  tile_slab_accumulate<Wide>(s, k, nb, tile, dscale, psd, pw, false);
  return ovf;
}

// Whether a tile kernel's arguments are in range: 1 <= k <= 32 (the
// column masks' bits), nb >= 1, and the shared memory a CTA needs within
// what it may opt into.
inline bool tile_args_ok(int k, int nb) {
  return k >= 1 && k <= 32 && nb >= 1 &&
         (long long)tile_smem_words(k, nb) * (long long)sizeof(int) <=
             kMaxTileSmemBytes;
}

// Opt a tile kernel into the shared memory it needs, with the SM's carveout
// at its maximum so that two CTAs fit.
template <typename Kernel>
inline cudaError_t tile_kernel_smem(Kernel kern, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Launches a tile kernel, one CTA of kTileThreads per tile, with the shared
// memory of (k, nb); the caller has checked tile_args_ok.  Returns the
// launch's error code.
template <typename Kernel, typename... Args>
inline int launch_tile_kernel(Kernel kern, int tiles, int k, int nb,
                              cudaStream_t stream, Args... args) {
  const int smem = tile_smem_words(k, nb) * (int)sizeof(int);
  cudaError_t err = tile_kernel_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  if (tiles == 0) return 0;
  kern<<<tiles, kTileThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace chad

#define CHAD_RETURN_LAUNCH_ERROR() return (int)cudaGetLastError()
