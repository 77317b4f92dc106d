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
//    [sel . sdq, sel] (K*1024 x 2nb) on the tensor cores with mma.sync, in
//    bf16 with f32 sums (m16n8k16) or in int8 with int32 sums (m16n8k32).
//    Fragments are built in registers from the samples, so the one-hot never
//    exists in memory; each of 16 warps owns 32 offset rows.  sdq must lie
//    in [-127, 127] and lrow in [0, nb): then both precisions are exact.
//
// M1/M2 sum sd as integers on the SD_QUANT grid (quantized with qscale,
// dequantized with dscale), as K1/K4 do; their plain versions do the same.
// What bounds them is what bounds K1/K4: the list's rounds and the
// shared-memory atomics.  M3 is bound by the rate at which MMAs are
// started: the dense one-hot spends 512 multiply-adds per sample and
// column.
#include "common.cuh"

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
    tile_accumulate(s, k, nb, tile, dscale, pkeys, psd, pw);
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
    tile_ranks(s, k, nb);
    tile_slab_accumulate(s, k, nb, tile, dscale, psd, pw, false);
    return;
  }
  if (mode == kMxu) {
    for (int j = 0; j < k; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int si = j * kTile + tile_col0() + c;
        const int key = s.key[si];
        s.pay[si] = key == kInt32Max
            ? kSkip : pack_rank(min(max(key, 0), nb - 1), s.pay[si]);
      }
    }
    tile_slab_accumulate(s, k, nb, tile, dscale, psd, pw, true);
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
      s.pay[si] = pack_rank(count_rank(s.list, nb, s.key[si]), s.pay[si]);
    }
  }
  tile_slab_accumulate(s, rows, nb, tile, dscale, psd, pw, true);
}

// ---- M3: tensor-core one-hot contraction ----
constexpr int kMmaWarps = 16;                    // 16 x 32 = 512 offset rows
constexpr unsigned kBf16One = 0x3F80u;

// sample word: okey (9 bits) | lrow (6 bits) << 9 | use << 15 | sdq << 16
__device__ __forceinline__ int mma_off(int w) { return w & 0x1FF; }
__device__ __forceinline__ int mma_lrow(int w) { return (w >> 9) & 0x3F; }
__device__ __forceinline__ bool mma_use(int w) { return (w >> 15) & 1; }
__device__ __forceinline__ int mma_sdq(int w) { return w >> 16; }

// column j of [sel . sdq, sel] for one sample (nb columns each)
__device__ __forceinline__ int mma_val(int w, int j, int nb) {
  const bool is_w = j >= nb;
  const bool sel = mma_use(w) && mma_lrow(w) == (is_w ? j - nb : j);
  return sel ? (is_w ? 1 : mma_sdq(w)) : 0;
}

__device__ __forceinline__ unsigned bf16_bits(int x) {   // exact, |x| <= 256
  return __float_as_uint((float)x) >> 16;
}

__device__ __forceinline__ unsigned pack_bf16(unsigned lo, unsigned hi) {
  return lo | (hi << 16);
}

__device__ __forceinline__ unsigned pack_s8(int a, int b, int c, int d) {
  return (unsigned)(a & 0xFF) | ((unsigned)(b & 0xFF) << 8) |
         ((unsigned)(c & 0xFF) << 16) | ((unsigned)(d & 0xFF) << 24);
}

template <int NT, bool kInt8>
__global__ void __launch_bounds__(kMmaWarps * 32)
micro_mxu8_kernel(const int* __restrict__ okey, const int* __restrict__ sdq,
                  const int* __restrict__ lrow, const int* __restrict__ use,
                  int n, int k, int nb, float* __restrict__ psd,
                  float* __restrict__ pw) {
  extern __shared__ int words[];                 // [k * kTile]
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int samples = k * kTile;
  for (int i = tid; i < samples; i += kMmaWarps * 32) {
    const int r = i / kTile, c = i - r * kTile;
    const size_t gi = (size_t)r * n + (size_t)tile * kTile + c;
    const int lr = lrow[gi];
    const bool u = use[gi] != 0 && lr >= 0 && lr < nb;
    words[i] = (okey[gi] & 0x1FF) | ((u ? lr : 0) << 9) | ((int)u << 15) |
               (int)((unsigned)sdq[gi] << 16);
  }
  __syncthreads();

  // rows (offsets) of this thread's A fragments: m-tile mt, half h
  int row[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    row[mt][0] = warp * 32 + mt * 16 + g;
    row[mt][1] = row[mt][0] + 8;
  }
  float accf[2][NT][4];
  int acci[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accf[mt][nt][e] = 0.0f;
        acci[mt][nt][e] = 0;
      }

  if (!kInt8) {
    // m16n8k16: this thread's samples are chunk columns t4*2 + {0,1,8,9}
    for (int base = 0; base < samples; base += 16) {
      int w[4];
      w[0] = words[base + t4 * 2];
      w[1] = words[base + t4 * 2 + 1];
      w[2] = words[base + t4 * 2 + 8];
      w[3] = words[base + t4 * 2 + 9];
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = row[mt][h];
          // a0,a1 (row g) / a2,a3 (row g+8): columns 0,1; a4..a7: +8
          a[mt][h] = pack_bf16(mma_off(w[0]) == rr ? kBf16One : 0u,
                               mma_off(w[1]) == rr ? kBf16One : 0u);
          a[mt][h + 2] = pack_bf16(mma_off(w[2]) == rr ? kBf16One : 0u,
                                   mma_off(w[3]) == rr ? kBf16One : 0u);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = nt * 8 + g;
        const unsigned b0 = pack_bf16(bf16_bits(mma_val(w[0], j, nb)),
                                      bf16_bits(mma_val(w[1], j, nb)));
        const unsigned b1 = pack_bf16(bf16_bits(mma_val(w[2], j, nb)),
                                      bf16_bits(mma_val(w[3], j, nb)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float* c = accf[mt][nt];
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
                "r"(b0), "r"(b1));
        }
      }
    }
  } else {
    // m16n8k32: this thread's samples are chunk columns t4*4 + {0..3} and
    // t4*4 + 16 + {0..3}
    for (int base = 0; base < samples; base += 32) {
      int w[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        w[e] = words[base + t4 * 4 + e];
        w[e + 4] = words[base + t4 * 4 + 16 + e];
      }
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = row[mt][h];
          // a0..a3 (row g) / a4..a7 (row g+8): columns 0..3; a8..a15: +16
          a[mt][h] = pack_s8(mma_off(w[0]) == rr, mma_off(w[1]) == rr,
                             mma_off(w[2]) == rr, mma_off(w[3]) == rr);
          a[mt][h + 2] = pack_s8(mma_off(w[4]) == rr, mma_off(w[5]) == rr,
                                 mma_off(w[6]) == rr, mma_off(w[7]) == rr);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = nt * 8 + g;
        const unsigned b0 = pack_s8(mma_val(w[0], j, nb), mma_val(w[1], j, nb),
                                    mma_val(w[2], j, nb), mma_val(w[3], j, nb));
        const unsigned b1 = pack_s8(mma_val(w[4], j, nb), mma_val(w[5], j, nb),
                                    mma_val(w[6], j, nb), mma_val(w[7], j, nb));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          int* c = acci[mt][nt];
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
                "r"(b0), "r"(b1));
        }
      }
    }
  }

  // C fragment: c0,c1 at (row g, columns t4*2 + {0,1}); c2,c3 at row g+8
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = row[mt][e >> 1];
        const int j = nt * 8 + t4 * 2 + (e & 1);
        const float v = kInt8 ? (float)acci[mt][nt][e] : accf[mt][nt][e];
        float* out = j < nb ? psd : pw;
        const int b = j < nb ? j : j - nb;
        out[((size_t)tile * nb + b) * kRowLen + off] = v;
      }
    }
  }
}

template <int NT, bool kInt8>
int launch_mxu8(const int* okey, const int* sdq, const int* lrow,
                const int* use, int n, int k, int nb, float* psd, float* pw,
                cudaStream_t stream) {
  auto kern = micro_mxu8_kernel<NT, kInt8>;
  const int smem = k * kTile * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<n / kTile, kMmaWarps * 32, smem, stream>>>(okey, sdq, lrow, use, n,
                                                    k, nb, psd, pw);
  CHAD_RETURN_LAUNCH_ERROR();
}

template <bool kInt8>
int dispatch_mxu8(const int* okey, const int* sdq, const int* lrow,
                  const int* use, int n, int k, int nb, float* psd, float* pw,
                  cudaStream_t stream) {
  switch (nb) {   // 2 nb columns in n-tiles of 8
    case 16: return launch_mxu8<4, kInt8>(okey, sdq, lrow, use, n, k, nb, psd, pw, stream);
    case 32: return launch_mxu8<8, kInt8>(okey, sdq, lrow, use, n, k, nb, psd, pw, stream);
    case 40: return launch_mxu8<10, kInt8>(okey, sdq, lrow, use, n, k, nb, psd, pw, stream);
    case 48: return launch_mxu8<12, kInt8>(okey, sdq, lrow, use, n, k, nb, psd, pw, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace chad

extern "C" int chad_micro_stagea_phases(const int* bkey, const int* okey,
                                        const float* sd, int n, int k, int nb,
                                        int mode, float qscale, float dscale,
                                        int* pkeys, float* psd, float* pw,
                                        void* stream) {
  if (nb < 1 || nb > chad::kMaxNb || k < 1 || k > 32)
    return (int)cudaErrorInvalidValue;
  const int smem = chad::tile_smem_words(k, nb) * (int)sizeof(int);
  cudaError_t err = chad::tile_kernel_smem(chad::micro_stagea_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n / chad::kTile == 0) return 0;
  chad::micro_stagea_kernel<<<n / chad::kTile, chad::kTileThreads, smem,
                              (cudaStream_t)stream>>>(
      bkey, okey, sd, n, k, nb, mode, qscale, dscale, pkeys, psd, pw);
  CHAD_RETURN_LAUNCH_ERROR();
}

extern "C" int chad_micro_tile_accum(const int* bkeys, const int* offs,
                                     const float* sds, int ntiles, int rows,
                                     int nb, float qscale, float dscale,
                                     int* pkeys, float* psd, float* pw,
                                     void* stream) {
  if (nb < 1 || nb > chad::kMaxNb || rows < 1 || rows > 32)
    return (int)cudaErrorInvalidValue;
  const int smem = chad::tile_smem_words(rows, nb) * (int)sizeof(int);
  cudaError_t err = chad::tile_kernel_smem(chad::micro_tile_accum_kernel,
                                           smem);
  if (err != cudaSuccess) return (int)err;
  if (ntiles == 0) return 0;
  chad::micro_tile_accum_kernel<<<ntiles, chad::kTileThreads, smem,
                                  (cudaStream_t)stream>>>(
      bkeys, offs, sds, rows, nb, qscale, dscale, pkeys, psd, pw);
  CHAD_RETURN_LAUNCH_ERROR();
}

extern "C" int chad_micro_mxu8(const int* okey, const int* sdq,
                               const int* lrow, const int* use, int n, int k,
                               int nb, int int8, float* psd, float* pw,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return int8 ? chad::dispatch_mxu8<true>(okey, sdq, lrow, use, n, k, nb, psd,
                                          pw, s)
              : chad::dispatch_mxu8<false>(okey, sdq, lrow, use, n, k, nb,
                                           psd, pw, s);
}
