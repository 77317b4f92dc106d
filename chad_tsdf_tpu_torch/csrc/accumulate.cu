// K5: accumulate_segments — the sort path's accumulate into the pool.
//
// Replaces the TPU kernel chad_tsdf_tpu/ops/accumulate.py:accumulate_pallas
// (Pallas body _accum_kernel, :75-192).  Samples arrive sorted by block
// key as packed payloads (offset << 16 | sd_q16); each live member of the
// slot-sorted tables owns one segment [start, start + len) of them and one
// pool row, and gets onehot(offset)^T . [sd, 1] over its segment added to
// that row.  The TPU design (8-row DMA groups, 1024-sample aligned windows,
// a re-scan of each window once per member) is Mosaic's; member slots are
// distinct pool rows, so here members are independent.
//
// Design: the work unit is a chunk of at most C = 8192 samples (picked by
// measurement from 2048 / 4096 / 8192), not a member, so the time follows
// the number of samples and not the longest segment.
//
// 1. plan_chunks_kernel (one CTA, launched by the same C entry) scans the
//    member table: a live member (slot < reserved, len > 0) gets
//    ceil(len / C) chunks, contiguous and in order; a dead member gets
//    none.  It writes the chunk list (member, index within the member), a
//    scratch row for each member with more than one chunk, and that row's
//    count of pending chunks.  The count lives on the device, so the grid
//    below is static and the host reads nothing.  The list and the scratch
//    are sized for live segments that are disjoint ranges of the payload
//    (at most T + S / C chunks, S / (C + 1) multi-chunk members); a table
//    that needs more gets no chunk at all and sets the overflow word, which
//    checks read (the insert path's tables always fit).
// 2. accumulate_chunks_kernel is a persistent grid (as many CTAs as fit on
//    the card at once, launched as a programmatic dependent of the plan so
//    that it starts while the plan runs) that strides over the chunk list,
//    so no CTA is launched for a dead member.  Each warp of a CTA takes a
//    contiguous share of the chunk and each lane a contiguous stretch of
//    that share, loaded as int4 pairs into registers before any is used.
//    The next chunk's loads are issued as soon as this chunk's samples are
//    summed, so they overlap its flush; its descriptor is fetched a chunk
//    ahead, and a single-chunk member's pool row is read while the chunk
//    is summed.  Cells are summed in shared memory.  A dense voxel puts
//    whole warps on one or two cells, and same-cell atomics serialise, so a
//    lane first sums its stretch in registers: it keeps its two most recent
//    cells open (samples of one block arrive in point order, so a stretch
//    sees a run of one cell, or two alternating ones where rays through
//    one voxel cross a voxel face at different steps) and adds a cell to
//    shared memory only when a third arrives and at the end.  This beat
//    __match_any_sync groups across the warp per sample position on every
//    cloud measured (PERF.md).
//
// What bounds it on the H100: bytes — 4 B a sample read once, each touched
// pool row read and written once.  What holds it back from that is
// latency: per chunk a CTA waits on its loads, on two barriers, and for a
// multi-chunk member on a fence and an atomic round trip, with four CTAs
// an SM (64 registers a thread: the chunk's payload lives in registers).
//
// Exactness: a chunk sums sd on the SD_QUANT grid of the payload as int32
// (C x 32767 < 2^31) and counts as int32.  A single-chunk member scales
// its cells once and adds them to its pool row once.  A multi-chunk
// member's chunks add their cells into its zeroed int64 / int32 scratch
// row with global integer atomics; the CTA that brings the pending count
// to 0 takes the row (atomicExch back to 0, so scratch is zero between
// calls), scales once and adds once.  Integer sums do not depend on their
// order, so every run gives the same pool, equal bit for bit to the plain
// version (ops/accumulate.py accumulate_segments_plain), and no segment
// length can overflow a sum (65,536 x 32,767 already exceeds int32).
// No float atomics.
//
// The payload is read in 32-byte groups from the 32-byte boundary at or
// below its first sample, so up to 28 bytes before it and after its end
// are read (and ignored): inside the 512-byte-aligned allocations of
// PyTorch's CUDA caching allocator.
#include "common.cuh"

namespace chad {

constexpr int kLgChunk = 13;
constexpr int kChunk = 1 << kLgChunk;    // samples per chunk
constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kVec = 8;            // samples per lane and round
constexpr int kLoads = kVec / 4;   // int4 loads per lane and round
constexpr int kPlanThreads = 1024;
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kPlanRounds = 16;    // rounds of 1,024 members per pass
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHead = 2;           // ws words before the chunk list

// Inclusive scan of (a, b) over the warp.
__device__ __forceinline__ void warp_scan2(int& a, int& b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int xa = __shfl_up_sync(kFull, a, d);
    const int xb = __shfl_up_sync(kFull, b, d);
    if (lane >= d) {
      a += xa;
      b += xb;
    }
  }
}

// Workspace ws: [0] chunk count, [1] overflow (1 when the table needs
// more than cap chunks or rows scratch rows; the count is then 0), then
// cmember[cap], cindex[cap], srow[t] (-1 for a member with one chunk or
// none), pending[rows].  Every write stays inside those bounds.  A round
// is 1,024 consecutive members, one a thread (coalesced), placed by one
// CTA-wide scan; a round without a live member costs one barrier (live
// members are a prefix of the slot-sorted tables).  A lane writes its
// member's first 32 chunks; the warp together writes the rest of a longer
// member's.
__global__ void __launch_bounds__(kPlanThreads)
plan_chunks_kernel(const int* __restrict__ lens,
                   const int* __restrict__ slots, int t, int reserved,
                   int cap, int rows, int* __restrict__ ws) {
  static_assert(kPlanWarps == 32, "one warp scans the warp totals");
  int* cmember = ws + kHead;
  int* cindex = cmember + cap;
  int* srow = cindex + cap;
  int* pending = srow + t;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int low = kChunk - 1;
  __shared__ int s_c[kPlanWarps], s_r[kPlanWarps];
  // the accumulate kernel may launch now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  int base_c = 0, base_r = 0;                // chunks, scratch rows so far
  for (int p0 = 0; p0 < t; p0 += kPlanThreads * kPlanRounds) {
    int nch[kPlanRounds];
#pragma unroll
    for (int i = 0; i < kPlanRounds; ++i) {
      const int m = p0 + kPlanThreads * i + tid;
      const int len = m < t ? lens[m] : 0;
      const int slot = m < t ? slots[m] : reserved;
      nch[i] = (slot < reserved && len > 0)
                   ? (len >> kLgChunk) + ((len & low) != 0) : 0;
    }
#pragma unroll
    for (int i = 0; i < kPlanRounds; ++i) {
      const int m = p0 + kPlanThreads * i + tid;
      const int n = nch[i];
      if (m < t) srow[m] = -1;
      // (also the barrier that frees s_c, s_r from the last live round)
      if (!__syncthreads_or(n > 0)) continue;
      int ic = n, ir = n > 1;
      warp_scan2(ic, ir);
      if (lane == 31) {
        s_c[warp] = ic;
        s_r[warp] = ir;
      }
      __syncthreads();
      if (warp == 0) {
        int a = s_c[lane], b = s_r[lane];
        warp_scan2(a, b);
        s_c[lane] = a;
        s_r[lane] = b;
      }
      __syncthreads();
      const int c0 = base_c + (warp ? s_c[warp - 1] : 0) + ic - n;
      const int r0 = base_r + (warp ? s_r[warp - 1] : 0) + ir - (n > 1);
      base_c += s_c[kPlanWarps - 1];
      base_r += s_r[kPlanWarps - 1];
      for (int k = 0; k < n && k < 32 && c0 + k < cap; ++k) {
        cmember[c0 + k] = m;
        cindex[c0 + k] = k;
      }
      if (n > 1 && r0 < rows) {
        srow[m] = r0;
        pending[r0] = n;
      }
      for (unsigned many = __ballot_sync(kFull, n > 32); many;
           many &= many - 1) {
        const int src = __ffs(many) - 1;
        const int sm = __shfl_sync(kFull, m, src);
        const int sn = __shfl_sync(kFull, n, src);
        const int sc = __shfl_sync(kFull, c0, src);
        for (int k = 32 + lane; k < sn && sc + k < cap; k += 32) {
          cmember[sc + k] = sm;
          cindex[sc + k] = k;
        }
      }
    }
  }
  if (tid == 0) {
    const bool over = base_c > cap || base_r > rows;
    ws[0] = over ? 0 : base_c;
    ws[1] = over;
  }
}

// A cell's chunk sum (|q| < 2^31) and count, in the CTA's shared cells.
struct Cells {
  int* q;
  int* n;
};

__device__ __forceinline__ void cell_add(Cells acc, int off, int q, int n) {
  atomicAdd(&acc.q[off], q);
  atomicAdd(&acc.n[off], n);
}

// A chunk: its member's tables and its index in the member.
struct Chunk {
  int start, len, slot, sr, k;
};

__device__ __forceinline__ Chunk chunk_at(int m, int k,
                                          const int* __restrict__ starts,
                                          const int* __restrict__ lens,
                                          const int* __restrict__ slots,
                                          const int* __restrict__ srow) {
  return {starts[m], lens[m], slots[m], srow[m], k};
}

// A warp's share of a chunk: groups [g_lo, g_hi) of kVec samples, R =
// rounds of them per lane, and the chunk's samples [s_lo, s_hi), all in
// the shifted index space (sample x at x + mis, so that group g is samples
// kVec g .. kVec g + kVec - 1).
struct Share {
  int g_lo, g_hi, rounds, s_lo, s_hi;
};

__device__ __forceinline__ Share share_of(const Chunk& c, int mis) {
  Share s;
  s.s_lo = c.start + c.k * kChunk + mis;
  s.s_hi = s.s_lo + min(kChunk, c.len - c.k * kChunk);
  const int g0 = s.s_lo / kVec;
  const int ng = (s.s_hi + kVec - 1) / kVec - g0;
  const int per = (ng + kSegWarps - 1) / kSegWarps;
  s.g_lo = g0 + (threadIdx.x >> 5) * per;
  s.g_hi = min(s.g_lo + per, g0 + ng);
  s.rounds = (per + 31) / 32;
  return s;
}

template <int kRounds>
__device__ __forceinline__ void load_share(int4 (&v)[kRounds][kLoads],
                                           const int4* __restrict__ p4,
                                           const Share& s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int g = s.g_lo + lane * s.rounds + r;
    const bool in = r < s.rounds && g < s.g_hi;
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      v[r][l] = in ? p4[kLoads * g + l] : make_int4(0, 0, 0, 0);
    }
  }
}

// One warp's share of its chunk, held in v: lane l holds groups
// g_lo + l R + r (r < R = sh.rounds), so it walks a contiguous stretch of
// kVec R samples; a sample outside the chunk or the warp's groups (only at
// the ends of a stretch) is skipped.  Each lane keeps its two most recent
// cells open (samples of one block arrive in point order, so a lane's
// stretch sees few cells: one run, or two alternating ones in a dense
// voxel) and adds the one it drops when a third arrives, and its open
// cells at the end.
template <int kRounds>
__device__ __forceinline__ void warp_accumulate(
    const int4 (&v)[kRounds][kLoads], const Share& sh, Cells acc) {
  const int lane = threadIdx.x & 31;
  // this lane's samples: [t_lo, t_hi) of its stretch
  const int base = kVec * (sh.g_lo + lane * sh.rounds);
  const int t_lo = sh.s_lo - base;
  const int t_hi = min(sh.s_hi, kVec * sh.g_hi) - base;
  int oa = -1, qa = 0, na = 0;               // the most recent open cell
  int ob = -1, qb = 0, nb = 0;               // the one before it
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r >= sh.rounds) break;               // uniform over the warp
    int p[kVec];
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      p[4 * l] = v[r][l].x;
      p[4 * l + 1] = v[r][l].y;
      p[4 * l + 2] = v[r][l].z;
      p[4 * l + 3] = v[r][l].w;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int t = kVec * r + j;
      if (t < t_lo || t >= t_hi) continue;
      const int o = (p[j] >> 16) & 0x1FF;
      const int q = (p[j] << 16) >> 16;      // arithmetic shift: sd_q16
      const bool ha = o == oa, hb = o == ob;
      if (!ha && !hb && ob >= 0) cell_add(acc, ob, qb, nb);
      const int q_new = (ha ? qa : hb ? qb : 0) + q;
      const int n_new = (ha ? na : hb ? nb : 0) + 1;
      if (!ha) {
        ob = oa;
        qb = qa;
        nb = na;
      }
      oa = o;
      qa = q_new;
      na = n_new;
    }
  }
  if (oa >= 0) cell_add(acc, oa, qa, na);   // the lane's open cells
  if (ob >= 0) cell_add(acc, ob, qb, nb);
}

__global__ void __launch_bounds__(kSegThreads, 4)
accumulate_chunks_kernel(float* __restrict__ pool_sd,
                         float* __restrict__ pool_w,
                         const int* __restrict__ starts,
                         const int* __restrict__ lens,
                         const int* __restrict__ slots,
                         const int* __restrict__ payload, int t, int cap,
                         int* __restrict__ ws,
                         unsigned long long* __restrict__ scr_q,
                         int* __restrict__ scr_w, float dscale) {
  // a chunk spans at most C / kVec + 1 groups, split over the warps
  constexpr int kRounds = kChunk / (kVec * kSegThreads) + 1;
  constexpr int kCells = kRowLen / kSegThreads;   // flushed per thread
  static_assert(kChunk % (kVec * kSegThreads) == 0, "whole rounds");
  static_assert(kRowLen % kSegThreads == 0, "whole cells per thread");
  static_assert((long long)kChunk * 32767 < 0x7fffffffLL,
                "a chunk's sd sum must fit int32");
  const int* cmember = ws + kHead;
  const int* cindex = cmember + cap;
  const int* srow = cindex + cap;
  int* pending = ws + kHead + 2 * cap + t;
  // group loads from the (4 kVec)-byte boundary at or below the payload
  const int mis =
      (int)((reinterpret_cast<uintptr_t>(payload) >> 2) & (kVec - 1));
  const int4* p4 = reinterpret_cast<const int4*>(payload - mis);
  __shared__ int acc_q[kRowLen], acc_n[kRowLen];
  __shared__ int s_last;
  const Cells acc{acc_q, acc_n};
  const int tid = threadIdx.x;
  for (int c = tid; c < kRowLen; c += kSegThreads) {
    acc_q[c] = 0;
    acc_n[c] = 0;
  }
  __syncthreads();
  // launched while the plan runs: wait for its chunk list
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int n = ws[0];
  const int stride = gridDim.x;
  int j = blockIdx.x;
  if (j >= n) return;                        // uniform over the CTA
  Chunk cur = chunk_at(cmember[j], cindex[j], starts, lens, slots, srow);
  // (member, index) of the chunk after next: a step ahead of its tables
  int m2 = 0, k2 = 0;
  if (j + stride < n) {
    m2 = cmember[j + stride];
    k2 = cindex[j + stride];
  }
  Share sh = share_of(cur, mis);
  int4 v[kRounds][kLoads];
  load_share(v, p4, sh);
  for (; j < n; j += stride) {
    const bool more = j + stride < n;
    Chunk nxt = cur;
    if (more) nxt = chunk_at(m2, k2, starts, lens, slots, srow);
    if (j + 2 * stride < n) {
      m2 = cmember[j + 2 * stride];
      k2 = cindex[j + 2 * stride];
    }
    // a single-chunk member's pool row, read while the chunk is summed
    const size_t row = (size_t)cur.slot * kRowLen;
    float pre_sd[kCells], pre_w[kCells];
    if (cur.sr < 0) {
#pragma unroll
      for (int i = 0; i < kCells; ++i) {
        pre_sd[i] = pool_sd[row + tid + i * kSegThreads];
        pre_w[i] = pool_w[row + tid + i * kSegThreads];
      }
    }
    warp_accumulate<kRounds>(v, sh, acc);
    if (more) {                              // v is free: load the next chunk
      sh = share_of(nxt, mis);
      load_share(v, p4, sh);
    }
    __syncthreads();
    if (cur.sr < 0) {                        // uniform: the member's only chunk
#pragma unroll
      for (int i = 0; i < kCells; ++i) {
        const int c = tid + i * kSegThreads;
        const int w = acc_n[c];
        if (w != 0) {
          const int q = acc_q[c];
          acc_q[c] = 0;
          acc_n[c] = 0;
          pool_sd[row + c] = pre_sd[i] + (float)q * dscale;
          pool_w[row + c] = pre_w[i] + (float)w;
        }
      }
    } else {
      unsigned long long* sq = scr_q + (size_t)cur.sr * kRowLen;
      int* sw = scr_w + (size_t)cur.sr * kRowLen;
      for (int c = tid; c < kRowLen; c += kSegThreads) {
        const int w = acc_n[c];
        if (w != 0) {
          const int q = acc_q[c];
          acc_q[c] = 0;
          acc_n[c] = 0;
          atomicAdd(&sq[c], (unsigned long long)(long long)q);
          atomicAdd(&sw[c], w);
        }
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) s_last = atomicSub(&pending[cur.sr], 1) == 1;
      __syncthreads();
      if (s_last) {                          // every chunk of the member is in
        __threadfence();
        for (int c = tid; c < kRowLen; c += kSegThreads) {
          const int w = atomicExch(&sw[c], 0);
          if (w != 0) {
            const long long q = (long long)atomicExch(&sq[c], 0ull);
            pool_sd[row + c] = pool_sd[row + c] + (float)q * dscale;
            pool_w[row + c] = pool_w[row + c] + (float)w;
          }
        }
      }
    }
    __syncthreads();                         // cells zeroed, s_last read
    cur = nxt;
  }
}

int launch_chunks(float* pool_sd, float* pool_w, const int* starts,
                  const int* lens, const int* slots, const int* payload,
                  int t, int cap, int* ws, unsigned long long* scr_q,
                  int* scr_w, float dscale, cudaStream_t stream) {
  // persistent: as many CTAs as are resident on the card at once
  static int grid = 0;
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, accumulate_chunks_kernel, kSegThreads, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  // programmatic dependent launch: the grid starts during the plan kernel
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kSegThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, accumulate_chunks_kernel, pool_sd, pool_w,
      starts, lens, slots, payload, t, cap, ws, scr_q, scr_w, dscale);
  if (err != cudaSuccess) return (int)err;
  CHAD_RETURN_LAUNCH_ERROR();
}

}  // namespace chad

// The chunk list alone (ws as in plan_chunks_kernel), for checks.
extern "C" int chad_plan_chunks(const int* lens, const int* slots, int t,
                                int reserved, int cap, int rows, int* ws,
                                void* stream) {
  if (t <= 0) return 0;
  chad::plan_chunks_kernel<<<1, chad::kPlanThreads, 0,
                             (cudaStream_t)stream>>>(
      lens, slots, t, reserved, cap, rows, ws);
  CHAD_RETURN_LAUNCH_ERROR();
}

// K5: plan, then the persistent accumulate, on one stream.  ws holds
// 2 + 2 cap + t + rows ints; scr_q / scr_w hold rows x 512 cells and must
// be zero (each call leaves them zero).
extern "C" int chad_accumulate_segments(
    float* pool_sd, float* pool_w, const int* starts, const int* lens,
    const int* slots, const int* payload, int t, int reserved, float dscale,
    int cap, int rows, int* ws, unsigned long long* scr_q, int* scr_w,
    void* stream) {
  if (t <= 0) return 0;
  const int err = chad_plan_chunks(lens, slots, t, reserved, cap, rows, ws,
                                   stream);
  if (err != 0) return err;
  return chad::launch_chunks(pool_sd, pool_w, starts, lens, slots, payload,
                             t, cap, ws, scr_q, scr_w, dscale,
                             (cudaStream_t)stream);
}
