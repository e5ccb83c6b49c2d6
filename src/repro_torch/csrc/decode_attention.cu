// Decode attention (B5): one new query token a row against that row's KV
// cache, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's decode attention
// (src/repro/models/transformer.py, _decode_attention) is plain jnp: two
// einsums over the float32-cast cache, left to XLA.  The port ran the same
// arithmetic as two torch.matmul calls on float32 copies of the bf16 cache,
// which held 86 % of a decode step's device time at 160 requests of
// DeepSeekMoE-16B (PERF.md), so this kernel was written for it.
//
// Semantics (the plain version, kernels/decode_attention/ref.py): for row
// b, kv head h and query head h g + j, key t is seen when t <= pos[b] and,
// with a window, t > pos[b] - window; the scores q . k_t are float32 dot
// products times 1 / sqrt(D), the softmax and P V are float32, and the
// output is rounded once to the query's type.  Each bf16 value is widened
// exactly to float32 and every product is a float32 FMA on the CUDA cores;
// no score or probability is rounded below float32.  The softmax is online
// (a running max and sum a row group, combined at the end), which reorders
// the float32 sums and is the only difference from the plain version.
//
// Bound: bytes.  A row at position p reads 2 (p + 1) Hkv D cache values once
// (a window: at most 2 window Hkv D), and does 4 Hq D flops a position: at a
// GQA group g = Hq / Hkv <= 8 that is at most 8 flops a bf16 byte, far under
// the 20 flops a byte the float32 CUDA cores give against 3.35 TB/s.  So the
// design streams bytes:
// - Only visible positions are read.  A block serves one (row, kv head,
//   split) and walks positions [first, last] of that row, first = pos -
//   window + 1 (or 0) and last = pos, cut into `nsplit` equal spans; no
//   position outside the window or past pos is loaded.
// - Loads are 16 bytes a lane, neighbouring lanes on neighbouring addresses.
//   A lane holds 8 values of a row (dims 8c .. 8c + 7; a float32 lane two
//   16-byte vectors); `lanes` = the power of two at or above D / 8 lanes
//   cover a head's row of one position (16 at D = 128 bf16: 256 contiguous
//   bytes, two whole 128-byte lines), so one load instruction covers 32 /
//   lanes positions (a row group each).
// - Loads in flight: each warp owns a ring of kStages stages in shared
//   memory and keeps kStages - 1 of them in flight with cp.async (zero-fill
//   past the span, so a masked position reads nothing); a lane reads back
//   only the bytes it copied, so a warp needs no barrier.  Each stage holds
//   kUnroll position rows a lane of K and of V.  Several blocks share an SM.
// - Split: the binding picks nsplit from the shape alone (B Hkv pairs
//   against the card's SMs, and the longest visible span;
//   kernel.split_plan).  At 160 rows x 16 kv heads there are 2,560 blocks
//   and no split: one launch.  At a few rows (8 x 4 at gemma3-4b) the
//   positions are split and decode_attention_combine merges the partial
//   (max, sum, accumulator) triples of a pair in a second launch.
// Each row group keeps its own running max, sum and float32 accumulator per
// query head; the row groups of a warp are merged by shuffles, the warps of
// a block through shared memory (reusing the rings), then the block writes
// the output (one split) or its partial triple.
//
// Rows whose span is empty (pos outside [0, S), which decode never gives)
// write zeros.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;            // warps a block
constexpr int kStages = 4;           // cp.async ring stages a warp
constexpr int kUnroll = 2;           // position rows a lane loads a stage
constexpr int kVecBytes = 16;        // bytes one cp.async moves
constexpr int kVals = 8;             // values of a row a lane holds
constexpr int kMaxD = 256;           // head dimensions the kernel takes
constexpr int kCombineThreads = 256; // threads a block of the combine
constexpr unsigned kFull = 0xffffffffu;

// 16-byte vectors that hold a lane's 8 values: bf16 1, float32 2
template <typename T>
constexpr int kVecs = static_cast<int>(sizeof(T)) * kVals / kVecBytes;

// the query-head count a kernel instantiation holds: 1, 2, 4 or 8
int group_bucket(int g) { return g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8; }

// shared memory of a block: the warps' rings, reused by the warps' combine
// (acc[kWarps][G][d], then max and sum [kWarps][G], float32)
int ring_bytes(int bf16) {
  return kWarps * kStages * kUnroll * 2 * (bf16 ? 1 : 2) * 32 * kVecBytes;
}
int combine_bytes(int d, int g) {
  return kWarps * group_bucket(g) * (d + 2) * static_cast<int>(sizeof(float));
}
int block_smem_bytes(int d, int g, int bf16) {
  const int ring = ring_bytes(bf16), merge = combine_bytes(d, g);
  return ring > merge ? ring : merge;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool copy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = copy ? kVecBytes : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the 8 values of vector w (bf16: one; float32: two, `stride` uint4 apart)
// widened exactly to float32
template <typename T>
__device__ __forceinline__ void unpack(const uint4* w, int stride,
                                       float (&x)[kVals]) {
  if constexpr (kVecs<T> == 1) {
    const uint4 a = *w;
    const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
    const uint4 a = w[0], b = w[stride];
    x[0] = __uint_as_float(a.x), x[1] = __uint_as_float(a.y);
    x[2] = __uint_as_float(a.z), x[3] = __uint_as_float(a.w);
    x[4] = __uint_as_float(b.x), x[5] = __uint_as_float(b.y);
    x[6] = __uint_as_float(b.z), x[7] = __uint_as_float(b.w);
  }
}

template <typename T>
__device__ __forceinline__ T to_out(float x);
template <>
__device__ __forceinline__ float to_out<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's .to()
}

// e^(m - mx), 0 when both are empty (mx = -inf)
__device__ __forceinline__ float rescale(float m, float mx) {
  return mx == -INFINITY ? 0.f : expf(m - mx);
}

// q, out: (B, Hkv g, D); k, v: (B, S, Hkv, D), all contiguous; pos: (B,).
// Grid: B Hkv nsplit blocks of kWarps warps, block x = (b Hkv + h) nsplit +
// split.  With nsplit > 1, part[(b Hkv + h) nsplit + split] holds g D
// accumulators, then g maxima and g sums (float32).
template <typename T, int G>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int32_t* __restrict__ pos,
                            T* __restrict__ out, float* __restrict__ part,
                            int S, int Hkv, int g, int D, int window,
                            int nsplit, int lanes_log2, float scale) {
  constexpr int NV = kVecs<T>;
  constexpr int kRing = kStages * kUnroll * 2 * NV * 32;   // uint4 a warp
  extern __shared__ __align__(16) uint4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;
  const int rows = 32 >> lanes_log2;            // row groups a warp
  const int r = lane >> lanes_log2, c = lane & (lanes - 1);
  const bool has = c * kVals < D;               // this lane holds dims
  const long long pair = blockIdx.x / nsplit;   // b Hkv + h
  const int split = static_cast<int>(blockIdx.x - pair * nsplit);
  const long long b = pair / Hkv;
  const int h = static_cast<int>(pair - b * Hkv);

  // the split's span [s0, s1) of the visible positions [first, last]
  const int p = pos[b];
  const int last = min(p, S - 1);
  const int first = window > 0 ? max(0, p - window + 1) : 0;
  const int n = last >= first ? last - first + 1 : 0;
  const int chunk = (n + nsplit - 1) / nsplit;
  const int s0 = first + split * chunk;
  const int s1 = min(last + 1, s0 + chunk);
  const int step_rows = rows * kUnroll;         // positions a warp step
  const int nsteps = s1 > s0 ? (s1 - s0 + step_rows - 1) / step_rows : 0;
  const int my_steps =
      warp < nsteps ? (nsteps - warp + kWarps - 1) / kWarps : 0;

  // this lane's 8 dims of the group's query heads, as float32
  float qv[G][kVals];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < g && has) {
      const T* src = q + (pair * g + j) * D + c * kVals;
      unpack<T>(reinterpret_cast<const uint4*>(src), 1, qv[j]);
    } else {
#pragma unroll
      for (int e = 0; e < kVals; ++e) qv[j][e] = 0.f;
    }
  }

  const long long row = static_cast<long long>(Hkv) * D;   // between positions
  const long long head = (b * S * Hkv + h) * D + c * kVals;
  uint4* ring = smem + warp * kRing;
  // stage `slot` <- the warp's step i: K and V of positions t0 + u rows + r
  auto issue = [&](int i, int slot) {
    const int t0 = s0 + (warp + i * kWarps) * step_rows;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * rows + r;
      const bool copy = has && t < s1;
      const long long off = head + static_cast<long long>(t) * row;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const T* base = kv ? v : k;
#pragma unroll
        for (int w = 0; w < NV; ++w)
          cp_async16(ring + (((slot * kUnroll + u) * 2 + kv) * NV + w) * 32 +
                         lane,
                     copy ? base + off + w * (kVecBytes / sizeof(T)) : base,
                     copy);
      }
    }
    cp_async_commit();
  };

  float m[G], l[G], acc[G][kVals];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = -INFINITY, l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < kVals; ++e) acc[j][e] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i, i);
  for (int i = 0; i < my_steps; ++i) {
    cp_async_wait<kStages - 2>();
    const int slot = i % kStages;
    const int t0 = s0 + (warp + i * kWarps) * step_rows;
    float s[kUnroll][G];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kx[kVals];
      unpack<T>(ring + ((slot * kUnroll + u) * 2 * NV) * 32 + lane, 32, kx);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kVals; ++e) d = fmaf(qv[j][e], kx[e], d);
        s[u][j] = d;
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < G; ++j)
          s[u][j] += __shfl_xor_sync(kFull, s[u][j], off);
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float mx = m[j];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u][j] = t0 + u * rows + r < s1 ? s[u][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[u][j]);
      }
      const float alpha = mx == -INFINITY ? 1.f : expf(m[j] - mx);
      float sum = l[j] * alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u][j] = mx == -INFINITY ? 0.f : expf(s[u][j] - mx);
        sum += s[u][j];
      }
      l[j] = sum;
      m[j] = mx;
#pragma unroll
      for (int e = 0; e < kVals; ++e) acc[j][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vx[kVals];
      unpack<T>(ring + ((slot * kUnroll + u) * 2 + 1) * NV * 32 + lane, 32,
                vx);
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < kVals; ++e)
          acc[j][e] = fmaf(s[u][j], vx[e], acc[j][e]);
    }
    issue(i + kStages - 1, (i + kStages - 1) % kStages);
  }
  cp_async_wait<0>();

  // merge the warp's row groups (lanes c, c + lanes, ...) by shuffles
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float mo = __shfl_xor_sync(kFull, m[j], off);
      const float lo = __shfl_xor_sync(kFull, l[j], off);
      const float mx = fmaxf(m[j], mo);
      const float a = rescale(m[j], mx), bo = rescale(mo, mx);
      l[j] = l[j] * a + lo * bo;
      m[j] = mx;
#pragma unroll
      for (int e = 0; e < kVals; ++e)
        acc[j][e] = acc[j][e] * a + __shfl_xor_sync(kFull, acc[j][e], off) * bo;
    }
  }

  // then the block's warps through shared memory (the rings are done)
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem);    // [kWarps][G][D]
  float* m_s = acc_s + kWarps * G * D;               // [kWarps][G]
  float* l_s = m_s + kWarps * G;                     // [kWarps][G]
  if (r == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (has)
#pragma unroll
        for (int e = 0; e < kVals; ++e)
          acc_s[(warp * G + j) * D + c * kVals + e] = acc[j][e];
      if (c == 0) m_s[warp * G + j] = m[j], l_s[warp * G + j] = l[j];
    }
  }
  __syncthreads();
  float* mine =
      nsplit > 1 ? part + (pair * nsplit + split) * g * (D + 2) : nullptr;
  for (int i = threadIdx.x; i < g * D; i += kWarps * 32) {
    const int j = i / D, d = i - j * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + j]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = rescale(m_s[w * G + j], mx);
      sum += l_s[w * G + j] * f;
      a += acc_s[(w * G + j) * D + d] * f;
    }
    if (nsplit == 1) {
      out[(pair * g + j) * D + d] = to_out<T>(sum > 0.f ? a / sum : 0.f);
    } else {
      mine[j * D + d] = a;
      if (d == 0) mine[g * D + j] = mx, mine[g * D + g + j] = sum;
    }
  }
}

// out[(b Hkv + h) g + j] from the nsplit partial triples of pair (b, h):
// one block a pair
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_attention_combine(const float* __restrict__ part,
                             T* __restrict__ out, int g, int D, int nsplit) {
  const long long pair = blockIdx.x;
  const int stride = g * (D + 2);
  const float* base = part + pair * nsplit * stride;
  for (int i = threadIdx.x; i < g * D; i += kCombineThreads) {
    const int j = i / D, d = i - j * D;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s)
      mx = fmaxf(mx, base[s * stride + g * D + j]);
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float f = rescale(base[s * stride + g * D + j], mx);
      if (f > 0.f) {
        sum += base[s * stride + g * D + g + j] * f;
        a += base[s * stride + j * D + d] * f;
      }
    }
    out[(pair * g + j) * D + d] = to_out<T>(sum > 0.f ? a / sum : 0.f);
  }
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, float* part, int B, int S, int Hkv, int g, int D,
           int window, int nsplit, int lanes_log2, float scale,
           cudaStream_t stream) {
  const int bf16 = sizeof(T) == 2;
  // once an instantiation: the most shared memory any D asks of it
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      block_smem_bytes(kMaxD, G, bf16));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = static_cast<long long>(B) * Hkv * nsplit;
  decode_attention_kernel<T, G>
      <<<static_cast<unsigned>(blocks), kWarps * 32,
         block_smem_bytes(D, g, bf16), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int32_t*>(pos),
          static_cast<T*>(out), part, S, Hkv, g, D, window, nsplit,
          lanes_log2, scale);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || nsplit == 1) return static_cast<int>(rc);
  decode_attention_combine<T>
      <<<static_cast<unsigned>(static_cast<long long>(B) * Hkv),
         kCombineThreads, 0, stream>>>(part, static_cast<T*>(out), g, D,
                                       nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int g, const void* q, const void* k, const void* v,
             const void* pos, void* out, float* part, int B, int S, int Hkv,
             int D, int window, int nsplit, int lanes_log2, float scale,
             cudaStream_t stream) {
  switch (group_bucket(g)) {
    case 1:
      return launch<T, 1>(q, k, v, pos, out, part, B, S, Hkv, g, D, window,
                          nsplit, lanes_log2, scale, stream);
    case 2:
      return launch<T, 2>(q, k, v, pos, out, part, B, S, Hkv, g, D, window,
                          nsplit, lanes_log2, scale, stream);
    case 4:
      return launch<T, 4>(q, k, v, pos, out, part, B, S, Hkv, g, D, window,
                          nsplit, lanes_log2, scale, stream);
    default:
      return launch<T, 8>(q, k, v, pos, out, part, B, S, Hkv, g, D, window,
                          nsplit, lanes_log2, scale, stream);
  }
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVecBytes != 0;
}

}  // namespace

extern "C" {

// q: (B, Hkv g, D) and out of q's type; k, v: (B, S, Hkv, D); float32
// (bf16 == 0) or bf16 (bf16 == 1), contiguous, 16-byte aligned; pos: (B,)
// int32.  window <= 0: none.  D a multiple of 8 up to 256, g in 1 .. 8,
// nsplit >= 1, lanes_log2 = log2 of the power of two at or above D / 8;
// with nsplit > 1, part holds B Hkv nsplit g (D + 2) float32.  Launches the
// kernel and, with nsplit > 1, the combine on `stream`; returns the CUDA
// error code of the launches (0 on success).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* pos, void* out, void* part, int B, int S,
                     int Hkv, int g, int D, int window, int nsplit,
                     int lanes_log2, float scale, int bf16, void* stream) {
  if (B == 0 || Hkv == 0) return 0;
  if (D % kVals != 0 || D < kVals || D > kMaxD || g < 1 || g > 8 ||
      nsplit < 1 || S < 1 || (kVals << lanes_log2) < D ||
      lanes_log2 > 5 || (nsplit > 1 && part == nullptr) || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  return bf16 ? dispatch<__nv_bfloat16>(g, q, k, v, pos, out, pf, B, S, Hkv,
                                        D, window, nsplit, lanes_log2, scale,
                                        s)
              : dispatch<float>(g, q, k, v, pos, out, pf, B, S, Hkv, D,
                                window, nsplit, lanes_log2, scale, s);
}

// Shared memory of one block of the kernel at head dimension d, group g, in
// bytes (all of it dynamic): the larger of the warps' rings and their
// combine.
int decode_attention_smem_bytes(int d, int g, int bf16) {
  return block_smem_bytes(d, g, bf16);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
