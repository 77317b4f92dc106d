// Device code shared by the port's Hopper kernels.
//
// tile_accumulate() is the stage that kernels K1 (fused_integrate.cu) and
// K4 (tile_accum.cu) have in common: the block list, coverage rule, ranks
// and per-tile partial rows of one 1024-point tile.  Both kernels call this
// one function, so the coverage rule that the fused insert's fallback
// re-derives through K4 cannot diverge from K1's.
//
// It replaces the list/rank/accumulate stages of the TPU kernels
// chad_tsdf_tpu/ops/tile_accum.py:_tile_kernel and
// chad_tsdf_tpu/ops/fused_integrate.py:_kernel (:175-325).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace chad {

constexpr int kTile = 1024;        // points per tile = threads per CTA
constexpr int kInt32Max = 0x7fffffff;
constexpr int kSlab = 16;          // list ranks accumulated per pass
constexpr int kRowLen = 512;       // voxels per 8x8x8 block

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

// Minimum over the CTA (blockDim.x == kTile); every thread gets the result.
__device__ __forceinline__ int block_min(int v, int* s_red) {
  v = __reduce_min_sync(0xffffffffu, v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = s_red[lane];
    w = __reduce_min_sync(0xffffffffu, w);
    if (lane == 0) s_red[32] = w;
  }
  __syncthreads();
  const int out = s_red[32];
  __syncthreads();          // s_red is reused by the next call
  return out;
}

// Dynamic shared memory of tile_accumulate's callers, in 32-bit words.
__host__ __device__ inline int tile_smem_words(int k, int nb) {
  return 2 * k * kTile + 2 * kSlab * kRowLen + nb + 40;
}

struct TileSmem {
  int* key;    // [k * kTile] block key per sample, kInt32Max = invalid
  int* pay;    // [k * kTile] pack_payload(offset, q)
  int* accq;   // [kSlab * kRowLen] quantized sd sums of one slab
  int* accw;   // [kSlab * kRowLen] sample counts of one slab
  int* list;   // [nb] the tile's block list, ascending
  int* red;    // [40] reduction scratch and counters
};

__device__ __forceinline__ TileSmem tile_smem(int* base, int k, int nb) {
  TileSmem s;
  s.key = base;
  s.pay = s.key + k * kTile;
  s.accq = s.pay + k * kTile;
  s.accw = s.accq + kSlab * kRowLen;
  s.list = s.accw + kSlab * kRowLen;
  s.red = s.list + nb;
  return s;
}

// The tile's samples sit in s.key / s.pay at [r * kTile + threadIdx.x],
// r < k.  Builds the list of the nb smallest distinct valid block keys
// (ascending, kInt32Max-padded) and writes it to pkeys; writes the tile's
// partial rows psd/pw (nb x 512, zero where nothing landed) with sd sums
// dequantized by dscale; and returns, for this thread's column, a bit mask
// over r of the valid samples that are NOT covered (key beyond the list).
//
// Sums are integer atomics in shared memory: integer addition is order
// free, so the result is the same on every run.
static __device__ unsigned tile_accumulate(TileSmem s, int k, int nb, int tile,
                                    float dscale, int* pkeys, float* psd,
                                    float* pw) {
  const int tid = threadIdx.x;

  // ---- block list: nb rounds of "smallest key above the last one" ----
  int prev = -1;
  int r = 0;
  for (; r < nb; ++r) {
    int local = kInt32Max;
    for (int j = 0; j < k; ++j) {
      const int key = s.key[j * kTile + tid];
      if (key > prev && key < local) local = key;
    }
    const int m = block_min(local, s.red);
    if (tid == 0) s.list[r] = m;
    if (m == kInt32Max) break;   // uniform: every thread holds the same m
    prev = m;
  }
  for (int i = r + 1 + tid; i < nb; i += kTile) s.list[i] = kInt32Max;
  __syncthreads();
  for (int i = tid; i < nb; i += kTile) {
    pkeys[(size_t)tile * nb + i] = s.list[i];
  }
  // covered <=> key among the list <=> key <= the list's last entry
  const int last = s.list[nb - 1];

  // ---- ranks (overwrite the keys: -1 = not accumulated) ----
  unsigned ovf = 0;
  for (int j = 0; j < k; ++j) {
    const int key = s.key[j * kTile + tid];
    int rank = -1;
    if (key != kInt32Max) {
      if (key <= last) {
        int lo = 0, hi = nb - 1;           // lower_bound in the list
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s.list[mid] < key) lo = mid + 1; else hi = mid;
        }
        rank = lo;
      } else {
        ovf |= 1u << j;
      }
    }
    s.key[j * kTile + tid] = rank;
  }

  // ---- accumulate, one slab of kSlab list ranks at a time ----
  const int nslab = (nb + kSlab - 1) / kSlab;
  for (int sl = 0; sl < nslab; ++sl) {
    const int r0 = sl * kSlab;
    const int rows = min(kSlab, nb - r0);
    const bool live = s.list[r0] != kInt32Max;     // uniform
    if (live) {
      for (int i = tid; i < kSlab * kRowLen; i += kTile) {
        s.accq[i] = 0;
        s.accw[i] = 0;
      }
      __syncthreads();
      for (int j = 0; j < k; ++j) {
        const int rank = s.key[j * kTile + tid] - r0;
        if (rank >= 0 && rank < rows) {
          const int pay = s.pay[j * kTile + tid];
          const int off = (pay >> 16) & 0x1FF;
          const int q = (pay << 16) >> 16;
          atomicAdd(&s.accq[rank * kRowLen + off], q);
          atomicAdd(&s.accw[rank * kRowLen + off], 1);
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < rows * kRowLen; i += kTile) {
      const size_t o = ((size_t)tile * nb + r0) * kRowLen + i;
      psd[o] = live ? (float)s.accq[i] * dscale : 0.0f;
      pw[o] = live ? (float)s.accw[i] : 0.0f;
    }
    __syncthreads();
  }
  return ovf;
}

}  // namespace chad

#define CHAD_RETURN_LAUNCH_ERROR() return (int)cudaGetLastError()
