// Embedding bag: out[b] = sum or mean over l of table[idx[b, l]], for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (embedding_bag_kernel, body _bag_kernel), which walks a (B, L) grid and
// fetches one prefetched table row per step into a (1, D) float32
// accumulator; a mean bag divides by L on the last step.
//
// Bound: bytes.  B L D itemsize bytes of rows gathered, 4 B L bytes of
// indices and B D itemsize bytes written, over 3.35 TB/s.  The rows sit at
// random addresses, so the memory moves whole 32-byte sectors: a 72-byte row
// (D = 18 float32) at offset 72 i always touches three, 96 bytes.
//
// Two entries, chosen by the binding from the bag length L
// (kernel.L_SMALL): embedding_bag_small for short bags (DIN's lookups are
// bags of one row), embedding_bag_kernel, a warp per bag, for long ones.
//
// Small bags (embedding_bag_small): at L = 1 a warp per bag wastes most of
// the warp (9 lanes of 32 at D = 18 float32), stages 128 index slots for one
// index and combines row groups of which all but one are empty; the cost is
// per bag, not per byte.  So:
// - Bags.  A lane group of `chunks` lanes (the row layout below) serves one
//   bag, so one load instruction covers `rows` bags (3 at D = 18 float32:
//   27 of 32 lanes).  A warp takes a tile of rows x SMALL_BAGS consecutive
//   bags; bag first + j rows + r goes to group r in slot j, so the groups'
//   stores of one slot are neighbouring output rows.
// - Indices.  No shared-memory stage: each group reads its bags' indices
//   directly (the group's lanes read one address, the warp's groups
//   neighbouring ones).  A shuffle from one coalesced load would not save a
//   load instruction at L = 1, and this reads any L with one code path.
//   The indices of position l + 1, or after the last position those of
//   position 0 of the warp's next tile, are loaded while the rows of l
//   arrive, so a warp waits on one load latency a position, not two.
// - In flight.  Each lane keeps SMALL_BAGS = 8 bags' row loads in flight
//   before it adds (24 rows of the warp at D = 18 float32), at 90 registers
//   for DIN's float2 rows (phase 1 of chip_smoke.py prints each
//   instantiation's).
// - Grid.  Sized to the card: the SMs times the blocks of SMALL_WARPS warps
//   that fit on one (cudaOccupancyMaxActiveBlocksPerMultiprocessor), each
//   warp striding over the tiles, not a block per few bags.
// - Order.  Each bag is summed in float32 in bag order, from 0.0f, by one
//   lane per vector: at L = 1 a sum is 0.0f + row, equal to the row (a -0.0
//   becomes 0.0, which compares equal), so DIN's bag route equals the take.
//   A mean multiplies the sum by 1 / L once (one rounding more than a
//   division; at L = 1 exact).
// - Wide rows.  A row of 32 vectors or more (D = 256 float32) is walked in
//   passes of 32 vectors by the whole warp, one bag a group (rows = 1), each
//   pass over all the warp's tiles; no row is left to the other entry, so
//   the choice depends on L alone.
// It uses no shared memory.
//
// Long bags (embedding_bag_kernel): a warp per bag, every index loaded
// once, rows as vectors, many rows in flight.
// - Indices.  The warp stages its bag's indices in shared memory, STAGE = 128
//   at a time (four coalesced loads of 32; the next 128 are loaded while the
//   rows of the current ones arrive), and every lane reads its rows' indices
//   from there.
// - Rows.  A row is read with the widest vector its byte alignment allows
//   (VEC = 16, 8, 4 or 2 bytes; the wrapper picks it from D, the element
//   size and the table's address).  `chunks` = row bytes / VEC lanes cover a
//   row and one load instruction covers `rows` = 32 / chunks rows (D = 18
//   float32: float2, 9 lanes a row, 3 rows, 27 of 32 lanes); a row of more
//   than 32 vectors (D = 256 float32) is walked in passes of 32 vectors.
// - In flight.  Each lane issues UNROLL = 8 independent row loads before its
//   first add (24 rows of the warp at D = 18 float32).
// - Sums.  Lane (r, c) sums in float32, in bag order, the rows whose position
//   p in their group of STAGE has p % rows == r; the row groups are then
//   combined by shuffles, group 0 first, then 1, 2, ... (tests model this
//   order).  A mean divides by L once; the lanes of group 0 write the result
//   in the table's type (float32 or bf16) as vectors.
// Indices must lie in [0, V): the kernel does not check them.
//
// gather_probe is a measuring tool, not a port kernel: it reads the same
// rows with the same vectors, and the indices, but without bags (UNROLL_PROBE
// rows a lane in flight, one warp per UNROLL_PROBE x rows indices) and writes
// one float a warp, the sum of what it read.  Its time is the floor of this
// gather on the card.
//
// The table loads use __ldg.  ld.global.nc.L1::no_allocate (a row is read
// once, so it need not displace anything in L1) was measured 2-3 % slower at
// DIN's shapes on an H100 80GB HBM3 at 700 W (PERF.md, Findings).

#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;          // warps (bags) a block
constexpr int UNROLL = 8;         // row loads a lane issues before adding
constexpr int STAGE = 128;        // indices a warp stages at a time
constexpr int PER_LANE = STAGE / 32;
constexpr int UNROLL_PROBE = 16;  // row loads a lane of the probe issues
constexpr int SMALL_WARPS = 8;    // warps a block of the small-bag entry
constexpr int SMALL_BAGS = 8;     // bags a lane group keeps in flight
constexpr int SMALL_SMEM = 0;     // the small-bag entry's shared memory
constexpr unsigned FULL = 0xffffffffu;

// VEC bytes of a row as 32-bit words (a 2-byte load in the low half of w[0])
template <int VEC>
constexpr int kWords = VEC >= 4 ? VEC / 4 : 1;

template <int VEC>
__device__ __forceinline__ void load_vec(unsigned* w, const void* p) {
  if constexpr (VEC == 16) {
    const uint4 v = __ldg(static_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if constexpr (VEC == 8) {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (VEC == 4) {
    w[0] = __ldg(static_cast<const unsigned*>(p));
  } else {
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(void* p, const unsigned* w) {
  if constexpr (VEC == 16)
    *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else if constexpr (VEC == 8)
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else if constexpr (VEC == 4)
    *static_cast<unsigned*>(p) = w[0];
  else
    *static_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
}

// element i of a loaded vector, as float32 (bf16 is the high half of a float)
template <typename T>
__device__ __forceinline__ float elem(const unsigned* w, int i) {
  if constexpr (std::is_same_v<T, float>) {
    return __uint_as_float(w[i]);
  } else {
    const unsigned x = w[i >> 1];
    return __uint_as_float(i & 1 ? x & 0xffff0000u : x << 16);
  }
}

// element i of a vector to store, rounded to T; w starts zeroed
template <typename T>
__device__ __forceinline__ void put(unsigned* w, int i, float x) {
  if constexpr (std::is_same_v<T, float>) {
    w[i] = __float_as_uint(x);
  } else {
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16(x));
    w[i >> 1] |= h << (16 * (i & 1));
  }
}

// One warp per bag (see the note at the top).
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ idx, T* __restrict__ out,
                     long long B, int L, int D, int mean) {
  constexpr int E = VEC / static_cast<int>(sizeof(T));  // elements a vector
  constexpr int NW = kWords<VEC>;
  __shared__ int32_t stage[WARPS][STAGE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long bag = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (bag >= B) return;  // the whole warp leaves
  const int chunks = D / E;
  const bool narrow = chunks < 32;
  const int rows = narrow ? 32 / chunks : 1;
  const int r = narrow ? lane / chunks : 0;
  const int32_t* bag_idx = idx + bag * L;
  int32_t* st = stage[warp];

  for (int c0 = 0; c0 < chunks; c0 += 32) {  // passes over a wide row
    const int c = narrow ? lane % chunks : c0 + lane;
    const bool active = narrow ? r < rows : c < chunks;
    const T* col = table + static_cast<long long>(c) * E;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;

    int32_t next[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int l = k * 32 + lane;
      next[k] = l < L ? __ldg(bag_idx + l) : 0;
    }
    for (int base = 0; base < L; base += STAGE) {
      __syncwarp();  // every lane is done with the last group
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) st[k * 32 + lane] = next[k];
      __syncwarp();
      const int n = min(STAGE, L - base);
      if (base + STAGE < L) {  // the next group, in flight with these rows
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
          const int l = base + STAGE + k * 32 + lane;
          next[k] = l < L ? __ldg(bag_idx + l) : 0;
        }
      }
      for (int s = 0; s < n; s += rows * UNROLL) {
        unsigned v[UNROLL][NW];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const int p = s + j * rows + r;
          if (active && p < n) {
            load_vec<VEC>(v[j], col + static_cast<long long>(st[p]) * D);
          } else {
#pragma unroll
            for (int w = 0; w < NW; ++w) v[j][w] = 0u;
          }
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += elem<T>(v[j], e);
        }
      }
    }

    // lane (0, c) adds the sums of lanes (1, c), (2, c), ... in turn (read
    // from acc, which no lane changes meanwhile)
    float sum[E];
#pragma unroll
    for (int e = 0; e < E; ++e) sum[e] = acc[e];
    for (int k = 1; k < rows; ++k) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        sum[e] += __shfl_sync(FULL, acc[e], lane + k * chunks);
    }
    if (active && r == 0) {
      unsigned w[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = 0u;
#pragma unroll
      for (int e = 0; e < E; ++e)
        put<T>(w, e, mean ? sum[e] / static_cast<float>(L) : sum[e]);
      store_vec<VEC>(out + bag * D + static_cast<long long>(c) * E, w);
    }
  }
}

// Short bags, a lane group per bag (see the note at the top).
template <typename T, int VEC>
__global__ void __launch_bounds__(SMALL_WARPS * 32)
embedding_bag_small(const T* __restrict__ table,
                    const int32_t* __restrict__ idx, T* __restrict__ out,
                    long long B, int L, int D, int mean) {
  constexpr int E = VEC / static_cast<int>(sizeof(T));  // elements a vector
  constexpr int NW = kWords<VEC>;
  const int lane = threadIdx.x & 31;
  const int chunks = D / E;
  const bool narrow = chunks < 32;
  const int rows = narrow ? 32 / chunks : 1;  // bags a load instruction
  const int r = narrow ? lane / chunks : 0;
  const long long per_tile = static_cast<long long>(rows) * SMALL_BAGS;
  const long long tiles = (B + per_tile - 1) / per_tile;
  const long long stride = static_cast<long long>(gridDim.x) * SMALL_WARPS;
  const long long t0 = static_cast<long long>(blockIdx.x) * SMALL_WARPS +
                       (threadIdx.x >> 5);
  const long long slot = static_cast<long long>(rows) * L;  // j to j + 1
  // a mean scales by 1 / L (a division in the unrolled stores would be a
  // call, and spill the other slots' sums around it)
  const float inv = mean ? 1.f / static_cast<float>(L) : 1.f;
  for (int c0 = 0; c0 < chunks; c0 += 32) {  // passes over a wide row
    const int c = narrow ? lane % chunks : c0 + lane;
    const bool active = narrow ? r < rows : c < chunks;
    const T* col = table + static_cast<long long>(c) * E;
    int32_t id[SMALL_BAGS];
    // the indices of position 0 of tile t0
    {
      const long long left = B - (t0 * per_tile + r);
      const int32_t* p = idx + (t0 * per_tile + r) * L;
#pragma unroll
      for (int j = 0; j < SMALL_BAGS; ++j)
        id[j] = active && left > j * rows && L > 0 ? __ldg(p + j * slot) : -1;
    }
    for (long long t = t0; t < tiles; t += stride) {
      const long long first = t * per_tile + r;
      const long long left = B - first;
      const int32_t* bag_idx = idx + first * L;
      float acc[SMALL_BAGS][E];
#pragma unroll
      for (int j = 0; j < SMALL_BAGS; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
      }
      for (int l = 0; l < L; ++l) {
        unsigned v[SMALL_BAGS][NW];
#pragma unroll
        for (int j = 0; j < SMALL_BAGS; ++j) {
          if (id[j] >= 0) {
            load_vec<VEC>(v[j], col + static_cast<long long>(id[j]) * D);
          } else {
#pragma unroll
            for (int w = 0; w < NW; ++w) v[j][w] = 0u;
          }
        }
        // the next indices, in flight with these rows: position l + 1, or
        // position 0 of the warp's next tile
        if (l + 1 < L) {
#pragma unroll
          for (int j = 0; j < SMALL_BAGS; ++j)
            if (id[j] >= 0) id[j] = __ldg(bag_idx + j * slot + l + 1);
        } else {
          const long long nf = first + stride * per_tile;
          const long long nleft = B - nf;
          const int32_t* p = idx + nf * L;
#pragma unroll
          for (int j = 0; j < SMALL_BAGS; ++j)
            id[j] = active && nleft > j * rows ? __ldg(p + j * slot) : -1;
        }
#pragma unroll
        for (int j = 0; j < SMALL_BAGS; ++j) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] += elem<T>(v[j], e);
        }
      }
#pragma unroll
      for (int j = 0; j < SMALL_BAGS; ++j) {
        if (active && left > j * rows) {
          unsigned w[NW];
#pragma unroll
          for (int i = 0; i < NW; ++i) w[i] = 0u;
#pragma unroll
          for (int e = 0; e < E; ++e)
            put<T>(w, e, mean ? acc[j][e] * inv : acc[j][e]);
          store_vec<VEC>(out + (first + j * rows) * D +
                             static_cast<long long>(c) * E,
                         w);
        }
      }
    }
  }
}

// The gather floor (see the note at the top): warp g reads the rows of
// flat positions [g U rows, (g + 1) U rows) of idx, U = UNROLL_PROBE.
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
gather_probe(const T* __restrict__ table, const int32_t* __restrict__ idx,
             float* __restrict__ out, long long n, int D) {
  constexpr int E = VEC / static_cast<int>(sizeof(T));
  constexpr int NW = kWords<VEC>;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) >> 5;
  const int chunks = D / E;
  const bool narrow = chunks < 32;
  const int rows = narrow ? 32 / chunks : 1;
  const int r = narrow ? lane / chunks : 0;
  const long long first = warp * rows * UNROLL_PROBE;
  float acc = 0.f;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = narrow ? lane % chunks : c0 + lane;
    const bool active = narrow ? r < rows : c < chunks;
    int32_t row[UNROLL_PROBE];
#pragma unroll
    for (int j = 0; j < UNROLL_PROBE; ++j) {
      const long long p = first + j * rows + r;
      row[j] = active && p < n ? __ldg(idx + p) : -1;
    }
    unsigned v[UNROLL_PROBE][NW];
#pragma unroll
    for (int j = 0; j < UNROLL_PROBE; ++j) {
      if (row[j] >= 0) {
        load_vec<VEC>(
            v[j], table + static_cast<long long>(row[j]) * D +
                      static_cast<long long>(c) * E);
      } else {
#pragma unroll
        for (int w = 0; w < NW; ++w) v[j][w] = 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL_PROBE; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc += elem<T>(v[j], e);
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  if (lane == 0) out[warp] = acc;
}

long long probe_warps(long long n, int D, int E) {
  const int chunks = D / E;
  const long long per_warp =
      static_cast<long long>(chunks < 32 ? 32 / chunks : 1) * UNROLL_PROBE;
  return (n + per_warp - 1) / per_warp;
}

// The launches, as F<T, VEC>::run for dispatch.
template <typename T, int VEC>
struct Bag {
  static int run(const void* table, const void* idx, void* out, long long B,
                 int L, int D, int mean, cudaStream_t stream) {
    const long long blocks = (B + WARPS - 1) / WARPS;
    embedding_bag_kernel<T, VEC>
        <<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
            static_cast<const T*>(table), static_cast<const int32_t*>(idx),
            static_cast<T*>(out), B, L, D, mean);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int VEC>
struct Small {
  static int run(const void* table, const void* idx, void* out, long long B,
                 int L, int D, int mean, cudaStream_t stream) {
    // blocks that fit on one SM, the same for every call of this type
    static const int per_sm = [] {
      int n = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, embedding_bag_small<T, VEC>, SMALL_WARPS * 32, 0);
      return n;
    }();
    int dev = 0, sms = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int chunks = D / (VEC / static_cast<int>(sizeof(T)));
    const long long per_warp =
        static_cast<long long>(chunks < 32 ? 32 / chunks : 1) * SMALL_BAGS;
    const long long warps = (B + per_warp - 1) / per_warp;
    const long long blocks =
        std::min((warps + SMALL_WARPS - 1) / SMALL_WARPS,
                 static_cast<long long>(sms) * per_sm);
    embedding_bag_small<T, VEC>
        <<<static_cast<unsigned>(blocks), SMALL_WARPS * 32, 0, stream>>>(
            static_cast<const T*>(table), static_cast<const int32_t*>(idx),
            static_cast<T*>(out), B, L, D, mean);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int VEC>
struct Probe {
  static int run(const void* table, const void* idx, float* out, long long n,
                 int D, cudaStream_t stream) {
    const long long warps =
        probe_warps(n, D, VEC / static_cast<int>(sizeof(T)));
    const long long blocks = (warps + WARPS - 1) / WARPS;
    gather_probe<T, VEC>
        <<<static_cast<unsigned>(blocks), WARPS * 32, 0, stream>>>(
            static_cast<const T*>(table), static_cast<const int32_t*>(idx),
            out, n, D);
    return static_cast<int>(cudaGetLastError());
  }
};

// F<T, VEC>::run(args...) for the runtime (bf16, vec); float32 takes vec 16,
// 8 or 4, bf16 also 2.
template <template <typename, int> class F, typename... Args>
int dispatch(int bf16, int vec, Args... args) {
  if (bf16) {
    switch (vec) {
      case 16: return F<__nv_bfloat16, 16>::run(args...);
      case 8: return F<__nv_bfloat16, 8>::run(args...);
      case 4: return F<__nv_bfloat16, 4>::run(args...);
      case 2: return F<__nv_bfloat16, 2>::run(args...);
    }
  } else {
    switch (vec) {
      case 16: return F<float, 16>::run(args...);
      case 8: return F<float, 8>::run(args...);
      case 4: return F<float, 4>::run(args...);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// vec must divide the row and the table's address, and hold whole elements
bool bad_vec(const void* table, int D, int bf16, int vec) {
  const int item = bf16 ? 2 : 4;
  return vec < item || (static_cast<long long>(D) * item) % vec != 0 ||
         reinterpret_cast<uintptr_t>(table) % vec != 0;
}

}  // namespace

extern "C" {

// table: (V, D) float32 (bf16 == 0) or bf16 (bf16 == 1), contiguous;
// idx: (B, L) int32, contiguous, every entry in [0, V); out: (B, D) of the
// table's type.  mean != 0 divides each bag's sum by L.  vec: the bytes of
// one row load (16, 8, 4, or 2 for bf16), dividing the row's bytes and the
// table's address.  Returns the CUDA error code of the launch
// (0 on success).
int embedding_bag(const void* table, const void* idx, void* out, long long B,
                  int L, int D, int mean, int bf16, int vec, void* stream) {
  if (B == 0 || D == 0) return 0;
  if (bad_vec(table, D, bf16, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Bag>(bf16, vec, table, idx, out, B, L, D, mean,
                       static_cast<cudaStream_t>(stream));
}

// The same bags by the small-bag entry (same arguments and rules), for
// short bags.
int embedding_bag_small(const void* table, const void* idx, void* out,
                        long long B, int L, int D, int mean, int bf16,
                        int vec, void* stream) {
  if (B == 0 || D == 0) return 0;
  if (bad_vec(table, D, bf16, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Small>(bf16, vec, table, idx, out, B, L, D, mean,
                         static_cast<cudaStream_t>(stream));
}

// The gather probe over the n = B L indices of idx (same table and vec
// rules); out holds n_out floats, at least one a warp: ceil(n / (rows
// UNROLL_PROBE)), rows = 32 / (row bytes / vec) or 1 for a row of 32 vectors
// or more.
int embedding_bag_probe(const void* table, const void* idx, float* out,
                        long long n, long long n_out, int D, int bf16,
                        int vec, void* stream) {
  if (n == 0 || D == 0) return 0;
  if (bad_vec(table, D, bf16, vec) ||
      n_out < probe_warps(n, D, vec / (bf16 ? 2 : 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<Probe>(bf16, vec, table, idx, out, n, D,
                         static_cast<cudaStream_t>(stream));
}

// Shared memory of one block, in bytes, the larger of the two entries':
// embedding_bag_kernel's static index stage, embedding_bag_small's none (no
// dynamic shared memory; the probe uses none).
int embedding_bag_smem_bytes(void) {
  const int warp_entry = static_cast<int>(sizeof(int32_t)) * WARPS * STAGE;
  return warp_entry > SMALL_SMEM ? warp_entry : SMALL_SMEM;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
