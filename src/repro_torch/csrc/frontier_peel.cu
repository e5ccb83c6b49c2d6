// One fused removal round of the truss peel over B lanes, for Hopper (sm_90a),
// over a per-lane list of live triangle rows that the kernel compacts.
//
// Replaces the Pallas TPU kernel src/repro/kernels/frontier_peel/kernel.py
// (fused_round, body _round_kernel).  Same function:
//   alive' = alive * (1 - rm)
//   sup'   = sup - #{triangles whose three corners were alive and >= 1 was
//                    removed}, counted at each surviving corner
// over (B, E) int32 sup/alive/rm (alive and rm are 0/1, rm a subset of
// alive) and (B, T, 3) int32 triangle edge ids, where a corner id equal to E
// (the per-lane drop slot of the padding rows) makes the row inert.
//
// Rows.  Lane b reads only its rows [0, n_rows[b]) and writes the rows that
// stay live into tris_out, counting them in n_rows_out[b].  A row stays live
// when its three corners are alive after the round; a row with a corner on
// the drop slot, or with a dead corner, never is, so the first round drops
// the padding wherever it lies, and every later round reads only the
// triangles that can still die.  Row order within a lane is not kept: the
// int32 sums are exact in any order.  The TPU kernel swept every padded row
// of every round, because its shapes were static.
//
// Design.  One cooperative launch a round (cudaLaunchCooperativeKernel), a
// persistent grid of at most SMs x the occupancy the runtime reports.
//   Phase 1, elementwise over B E: sup_out = sup, alive_out = alive (1 - rm),
//   and the pre-round state packed as two bit planes, one uint2 {alive bits,
//   rm bits} per 32 edges (E / 4 bytes a lane, from two __ballot_sync of a
//   warp); n_rows_out = 0.
//   A grid-wide barrier (cooperative_groups::this_grid().sync()).
//   Phase 2, over (lane, row): the blocks split into one group per lane (a
//   block takes lanes g, g + groups, ... when B exceeds the grid).  A block
//   copies its lane's packed state into shared memory (78.5 KB at E =
//   314,000; lanes over 200 KB gather from the global copy, in L2), then
//   takes 4,096 consecutive rows of the lane at a time, four a thread: one
//   8-byte gather a corner.  The block's live rows take one run of the
//   lane's output, from one atomicAdd on the lane's counter (warp counts by
//   __ballot_sync/__popc, offsets by a scan of the 32 counts in one warp).
//   For a dying triangle each surviving corner loses 1 by atomicSub into
//   sup_out, after the warp's lanes are grouped by target edge
//   (__match_any_sync): the lowest lane of a group subtracts the group's
//   count, so a hub edge that many of a warp's rows share takes one atomic.
// The counts are read on the device; none crosses to the host.  No
// decrement buffer and no memset: one call enqueues one kernel.  The
// offsets take one atomic a block, not a warp: with one every 32 rows, the
// lane's counter set the pace on an H100 (PERF.md).
//
// Bound: memory.  The round reads sup, alive and rm once and writes sup' and
// alive' once (20 B E bytes), and reads each live-in row once and writes each
// live-out row once (12 bytes a row), over 3.35 TB/s.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // 32: one scan by one warp
constexpr int kRows = 4;               // rows a thread takes at a time
constexpr int kChunk = kRows * kThreads;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 200 * 1024;  // a lane's state in shared memory
constexpr int kStaticSmemBytes = kWarps * 4;  // warp_pos[kWarps], int32

// Dynamic shared memory of one block at E edges a lane: the lane's packed
// state (ceil(E / 32) uint2), when it fits kMaxSmemBytes, else none.
inline int dynamic_smem_bytes(int E) {
  const long long lane_bytes = (long long)((E + 31) / 32) * 8;
  return lane_bytes <= kMaxSmemBytes ? (int)lane_bytes : 0;
}

// One atomicSub per distinct target edge of the warp; e < 0 means none.
__device__ __forceinline__ void decrement(int32_t* sup, int e, int lane) {
  const unsigned peers = __match_any_sync(kFull, e);
  if (e >= 0 && lane == __ffs(peers) - 1) atomicSub(sup + e, __popc(peers));
}

// The state of edge e: bit 0 alive, bit 1 removed this round.
__device__ __forceinline__ int state_of(const uint2* words, int e) {
  const uint2 w = words[e >> 5];
  const int bit = e & 31;
  return ((w.x >> bit) & 1) | (((w.y >> bit) & 1) << 1);
}

// words: B * W uint2 of scratch, W = ceil(E / 32); use_smem: the lanes'
// state fits kMaxSmemBytes and the launch gave W * 8 bytes of it.
__global__ void __launch_bounds__(kThreads)
frontier_peel_live_round(const int32_t* __restrict__ sup,
                         const int32_t* __restrict__ alive,
                         const int32_t* __restrict__ rm,
                         const int32_t* __restrict__ tris,
                         const int32_t* __restrict__ n_rows,
                         int32_t* __restrict__ sup_out,
                         int32_t* __restrict__ alive_out,
                         uint2* __restrict__ words,
                         int32_t* __restrict__ tris_out,
                         int32_t* __restrict__ n_rows_out, int B, int E,
                         long long T, int use_smem) {
  extern __shared__ uint2 smem_words[];
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long warp = tid >> 5;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const int W = (E + 31) >> 5;

  // phase 1: the elementwise update and the packed pre-round state, 32
  // consecutive edges of one lane a warp
  for (long long k = warp; k < (long long)B * W; k += n_warps) {
    const long long b = k / W;
    const int e = (int)(k - b * W) * 32 + lane;
    int a = 0, r = 0;
    if (e < E) {
      const long long i = b * E + e;
      a = alive[i];
      r = rm[i];
      sup_out[i] = sup[i];
      alive_out[i] = a * (1 - r);
    }
    const unsigned wa = __ballot_sync(kFull, a != 0);
    const unsigned wr = __ballot_sync(kFull, r != 0);
    if (lane == 0) words[k] = make_uint2(wa, wr);
  }
  for (long long b = tid; b < B; b += (long long)gridDim.x * kThreads)
    n_rows_out[b] = 0;
  cg::this_grid().sync();

  // phase 2: one group of blocks a lane, kChunk consecutive rows a block
  const int groups = min(B, (int)gridDim.x);
  const int per = gridDim.x / groups;  // blocks of a group
  const int g = blockIdx.x / per;
  if (g >= groups) return;  // the blocks left over
  __shared__ int warp_pos[kWarps];
  const int w = threadIdx.x / 32;
  for (int b = g; b < B; b += groups) {
    const uint2* st = words + (long long)b * W;
    if (use_smem) {
      __syncthreads();  // the last lane's state is no longer read
      for (int i = threadIdx.x; i < W; i += kThreads) smem_words[i] = st[i];
      __syncthreads();
      st = smem_words;
    }
    const long long nb = min((long long)max(n_rows[b], 0), T);
    const int32_t* rows = tris + (long long)b * T * 3;
    int32_t* out = tris_out + (long long)b * T * 3;
    int32_t* so = sup_out + (long long)b * E;
    for (long long t0 = (long long)(blockIdx.x - g * per) * kChunk; t0 < nb;
         t0 += (long long)per * kChunk) {
      // kRows rows a thread, kThreads apart: each load is coalesced
      int e[kRows][3], s[kRows];
      unsigned live[kRows];
      int n_live = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const long long t = t0 + j * kThreads + threadIdx.x;
        e[j][0] = e[j][1] = e[j][2] = E;
        if (t < nb) {
          e[j][0] = rows[3 * t];
          e[j][1] = rows[3 * t + 1];
          e[j][2] = rows[3 * t + 2];
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        // the drop slot (id E) and anything outside [0, E) is inert
        s[j] = 0;
        if ((unsigned)e[j][0] < (unsigned)E &&
            (unsigned)e[j][1] < (unsigned)E &&
            (unsigned)e[j][2] < (unsigned)E) {
          const int s0 = state_of(st, e[j][0]), s1 = state_of(st, e[j][1]),
                    s2 = state_of(st, e[j][2]);
          // bit 0: all three alive; bits 1-3: which corners are removed
          s[j] = (s0 & s1 & s2 & 1) | (s0 & 2) | ((s1 & 2) << 1) |
                 ((s2 & 2) << 2);
        }
        live[j] = __ballot_sync(kFull, (s[j] & 1) && !(s[j] & 14));
        n_live += __popc(live[j]);
      }

      // the block's live rows take one run of the lane's output: one
      // atomicAdd a block, offsets by a scan over the warps' counts
      if (lane == 0) warp_pos[w] = n_live;
      __syncthreads();
      if (w == 0) {
        const int own = warp_pos[lane];
        int incl = own;
#pragma unroll
        for (int o = 1; o < kWarps; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        int base = 0;
        if (lane == kWarps - 1 && incl > 0)
          base = atomicAdd(n_rows_out + b, incl);
        base = __shfl_sync(kFull, base, kWarps - 1);
        warp_pos[lane] = base + incl - own;
      }
      __syncthreads();
      int pos = warp_pos[w];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (live[j] >> lane & 1) {
          int32_t* o = out +
                       (long long)(pos + __popc(live[j] & ((1u << lane) - 1))) *
                           3;
          o[0] = e[j][0];
          o[1] = e[j][1];
          o[2] = e[j][2];
        }
        pos += __popc(live[j]);
        const bool dies = (s[j] & 1) && (s[j] & 14);
        if (__any_sync(kFull, dies)) {
          // each corner that survives the round loses 1
          decrement(so, dies && !(s[j] & 2) ? e[j][0] : -1, lane);
          decrement(so, dies && !(s[j] & 4) ? e[j][1] : -1, lane);
          decrement(so, dies && !(s[j] & 8) ? e[j][2] : -1, lane);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// One live-row round.  words: B * ceil(E / 32) * 8 bytes of scratch.  tris_out/n_rows_out must not alias tris/n_rows.  Returns the
// launch's error, or the cudaGetLastError() code after it.
int frontier_peel_live_round_launch(
    const void* sup, const void* alive, const void* rm, const void* tris,
    const void* n_rows, void* sup_out, void* alive_out, void* words,
    void* tris_out, void* n_rows_out, int B, int E, long long T, int device,
    void* stream) {
  if (B <= 0 || E <= 0) return (int)cudaGetLastError();
  cudaSetDevice(device);  // this library's runtime keeps its own device
  static bool configured = false;
  if (!configured) {
    const cudaError_t rc = cudaFuncSetAttribute(
        frontier_peel_live_round, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
    configured = true;
  }
  const int smem = dynamic_smem_bytes(E);
  int use_smem = smem > 0;
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, frontier_peel_live_round, kThreads, smem);
  const int full = sms * per_sm;
  if (full <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  // no more blocks than the larger sweep needs: a smaller grid meets at the
  // barrier sooner
  const long long rows = (T + kRows - 1) / kRows;
  const long long work = (long long)B * (E > rows ? (long long)E : rows);
  const long long want = (work + kThreads - 1) / kThreads;
  const int blocks = (int)(want < full ? (want > 0 ? want : 1) : full);
  void* args[] = {&sup,       &alive,     &rm,    &tris,  &n_rows,
                  &sup_out,   &alive_out, &words, &tris_out,
                  &n_rows_out, &B,        &E,     &T,     &use_smem};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      (const void*)frontier_peel_live_round, dim3(blocks), dim3(kThreads),
      args, smem, static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// Shared memory of one block at E edges a lane, in bytes: the static
// warp_pos array plus the dynamic bytes a launch at E asks for.
int frontier_peel_smem_bytes(int E) {
  return kStaticSmemBytes + dynamic_smem_bytes(E);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
