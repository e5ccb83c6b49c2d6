// Forward causal / sliding-window GQA attention with an online softmax, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _attn_kernel): o[b, h, i] = softmax_j(q[b, h,
// i] . k[b, h / group, j] / sqrt(D)) v[b, h / group, j] over the keys j that
// row i sees: j <= i when causal, i - window < j when a window is given.
// Accumulation is in float32; the output has q's type (float32 or bf16).
//
// Bound: operations.  4 B Hq D flops for every visible (query, key) pair over
// 989 TFLOP/s (bf16 tensor cores), against the bytes of q, k, v and o once
// over 3.35 TB/s.  Two routes, by type:
//
// bf16: tensor cores (tc_kernel), warp-specialised as FlashAttention-3 is.
// A block of three warpgroups (384 threads) is persistent: one a SM, it walks
// pairs of 128-row query blocks of one (batch, query head), the longest
// block with the shortest so that every pair is the same work under a
// causal mask.  Warpgroup 0 produces: one thread issues the TMA loads (Q
// once an item, then K and V tiles into a two-stage ring, each stage with a
// full and an empty mbarrier) through 4-D tensor maps over (D, S, H, B),
// which read strided (B, S, H, D) views in place and fill the sequence tail
// with zeros.  It gives its registers to the two consumer warpgroups
// (setmaxnreg 24 / 240), each of which owns 64 of the rows.  A K / V tile is
// 16 KB: 64 keys at D = 128, 32 at D = 256, 128 at D = 64, because a
// consumer holds O (D / 2 registers), S and the split P (keys / 2 each), and
// 128 keys at D = 128 or 64 at D = 256 spilled at 240 registers.  Tiles are
// column blocks of 64 (128-byte rows) under the 128-byte swizzle that TMA
// writes and wgmma reads without bank conflicts.  S = Q K^T is wgmma
// m64nKk16 with both operands in shared memory (K-major); O += P V is wgmma
// m64nDk16 with P from registers and V read transposed (N-major).  The two
// consumers ping-pong on named barriers: one issues its products while the
// other runs its softmax on the CUDA cores.  Inside a warpgroup, the next
// tile's S = Q K^T and this tile's P V are issued together, before the next
// tile's softmax.  No block-wide barrier runs in the tile loop.
//
// bf16 numerics: the online softmax runs on the accumulator fragments in
// base 2 (log2(e)/sqrt(D) folded into one multiply, ex2.approx), the quad
// that shares a row shuffles its max, and the row sum, of float32 p, stays
// partial in the thread until the end.  P is split into two bf16 terms,
// P_hi = bf16(p) and P_lo = bf16(p - P_hi), and both multiply V: P rounded
// once to bf16 errs by up to 2^-8 |p|, which took a model of this kernel
// past chip_smoke.B3_TOL on some of its cases
// (tests/test_torch_flash_attention.py); the pair keeps about 16 bits of p.
// fp16 P against V turned into fp16 in shared memory was measured too: the
// conversion of every V tile, in every block that reads it, cost more than
// the split's second product (PERF.md).  Widths D = 64, 128 and 256 are
// instantiated; another multiple of 16 runs on the next one up with zero
// Q / K / V columns (TMA's fill), which change no score, and the extra
// output columns are never stored.  On an H100 80GB HBM3 at 700 W,
// moonshot's (B, Hq, Hkv, S, D) = (8, 16, 16, 2048, 128) causal call takes
// 0.37-0.39 ms (1.5x scaled_dot_product_attention, 2.7x the bound) and
// gemma3-4b's (8, 8, 4, 2048, 256) 0.39-0.41 ms global and 0.35-0.37 with
// a window of 1024 (PERF.md).
//
// float32: CUDA cores (f32_kernel).  One block of 256 threads owns 64 query
// rows; Q, K and V tiles are staged as float32 in shared memory (Q and K
// rows padded by two words so that a half-warp's 8-byte reads of 16 rows
// fall on 32 distinct banks).  Thread (ty, tx) of a 16 x 16 grid holds a
// 4 x 4 patch of S in registers (rows ty + 16 r, columns tx + 16 c); the 16
// threads of a half-warp share their rows, so the row max and row sum are
// butterfly shuffles inside the half-warp.  P goes through shared memory and
// the thread keeps a 4 x (D / 16) patch of O.  Float32 FMAs (67 TFLOP/s at
// most) keep the result within 2e-5 of the float32 reference, which TF32
// tensor cores could not; no serving path runs attention in float32.
//
// Both routes: the last query blocks, which see the most keys, start first
// (the bf16 route: each pair's long block first, the pairs of the first
// heads first); key tiles wholly after a block's last row (causal) or wholly
// before its first row's window are never visited, which is the TPU
// kernel's block skipping, and the bf16 route also skips, per warpgroup, the
// products of the tiles that none of its 64 rows sees.  Scores a row cannot
// see are -inf and take probability 0 exactly (the bf16 route masks only
// the tiles that straddle the causal diagonal, the window edge or the end of
// the keys); a row with no visible key so far keeps m = -inf, l = 0 and its
// tile is a no-op, so the result is the reference softmax
// (ref.mha_reference), and a row that sees no key at all outputs 0, as the
// TPU kernel does (l == 0).
//
// Shapes: D a multiple of 16 up to 256 (the wrapper raises otherwise); any
// sequence length; strides in elements for the batch, head and sequence
// dimensions (the head dimension is contiguous), so (B, S, H, D) tensors
// transposed to (B, H, S, D) are read in place.  The bf16 route needs base
// pointers and strides that are multiples of 16 bytes (the wrapper checks),
// as TMA does.  Its tensor maps are encoded on the host for each call by
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library links no -lcuda.

#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, h, s;
};

// ---- float32 route: CUDA cores --------------------------------------------

constexpr int kBQ = 64;             // query rows of a block
constexpr int kBK = 64;             // key rows of a tile
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 16;  // P row stride: half-warps on other banks

// Shared memory of one block, in floats, for head dimension d.
__host__ __device__ inline int smem_floats(int d) {
  return kBQ * (d + 2) + kBK * (d + 2) + kBK * d + kBQ * kPStride;
}

// NC is the capacity of the accumulator in 16-column groups (d <= 16 NC).
template <int NC>
__global__ void __launch_bounds__(kThreads)
f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, Strides qs,
           Strides ks, Strides vs, Strides os, int s_q, int s_kv, int d,
           int group, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 2;              // Q and K row stride
  float* Qs = smem;                  // [kBQ][ld]
  float* Ks = Qs + kBQ * ld;         // [kBK][ld]
  float* Vs = Ks + kBK * ld;         // [kBK][d]
  float* Ps = Vs + kBK * d;          // [kBQ][kPStride]
  const int nc = d / 16;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // the last query blocks see the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  float* op = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int qi = q0 + r;
    Qs[r * ld + c] = qi < s_q ? qp[qi * qs.s + c] : 0.f;
  }

  // the key tiles these rows can see
  int k_hi = s_kv;
  if (causal) k_hi = min(s_kv, q0 + kBQ);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1) / kBK * kBK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is read (and Q is staged)
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const int kj = k0 + r;
      const bool in = kj < s_kv;
      Ks[r * ld + c] = in ? kp[kj * ks.s + c] : 0.f;
      Vs[r * d + c] = in ? vp[kj * vs.s + c] : 0.f;
    }
    __syncthreads();

    // S = Q K^T, a 4 x 4 patch per thread
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    for (int dd = 0; dd < d; dd += 2) {
      float2 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float2*>(&Qs[(ty + 16 * r) * ld + dd]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float2*>(&Ks[(tx + 16 * c) * ld + dd]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sc[r][c] = fmaf(qv[r].x, kv[c].x, fmaf(qv[r].y, kv[c].y, sc[r][c]));
    }

    // mask, online softmax; P to shared memory, rescale the accumulator
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool ok = kj < s_kv && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        sc[r][c] = ok ? sc[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float alpha = 1.f, sum = 0.f;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      if (m_new != -INFINITY) {      // else: nothing visible yet, a no-op
        alpha = expf(m[r] - m_new);  // 0 while m[r] is -inf
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p[c] = expf(sc[r][c] - m_new);  // exp(-inf) = 0 for masked keys
          sum += p[c];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        Ps[(ty + 16 * r) * kPStride + tx + 16 * c] = p[c];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    // O += P V
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p4[r] = *reinterpret_cast<const float4*>(
            &Ps[(ty + 16 * r) * kPStride + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* vrow = Vs + (kk + j) * d + tx;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (c < nc) {
            const float vv = vrow[16 * c];
            acc[0][c] = fmaf((&p4[0].x)[j], vv, acc[0][c]);
            acc[1][c] = fmaf((&p4[1].x)[j], vv, acc[1][c]);
            acc[2][c] = fmaf((&p4[2].x)[j], vv, acc[2][c]);
            acc[3][c] = fmaf((&p4[3].x)[j], vv, acc[3][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= s_q) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no visible key -> 0
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) op[qi * os.s + tx + 16 * c] = acc[r][c] * inv;
  }
}

// ---- bf16 route: tensor cores ----------------------------------------------

constexpr int kRows = 128;          // query rows of a block: 64 a consumer
constexpr int kStages = 2;          // the K / V ring
constexpr int kTcThreads = 384;     // one producer and two consumer warpgroups
constexpr int kBarrierBytes = 128;  // the mbarriers

// Key rows of a K / V tile of instantiation width dp (16 KB tiles: 128
// keys at dp = 64, 64 at 128, 32 at 256).  With P split in two, a consumer
// holds O (dp / 2 registers), S and P (keys / 2 each): 128 keys at dp = 128
// or 64 at dp = 256 spilled at 240 registers.
__host__ __device__ constexpr int tc_keys(int dp) { return 8192 / dp; }

// Shared memory of one block, in bytes, for instantiation width dp: Q, then
// kStages K tiles, then kStages V tiles, then the barriers, and 1 KB to
// align the first to the swizzle's 1024-byte period.
__host__ __device__ constexpr int tc_smem_bytes(int dp) {
  return (kRows + 2 * kStages * tc_keys(dp)) * dp * 2 + kBarrierBytes + 1024;
}

__host__ __device__ constexpr int tc_width(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// wgmma matrix descriptor of a 128-byte-swizzled operand at shared address
// addr: lbo and sbo in bytes, layout type 1 (128-byte swizzle) in bits 62-63.
// K-major operands (Q, K): rows of 128 bytes, sbo = 1024 between groups of
// 8 rows, lbo unused.  The N-major operand (V read as V^T): lbo between
// column blocks of 64, sbo = 1024 between groups of 8 keys.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's product groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers across the
// asynchronous products (it does not know that wgmma writes its
// accumulators, and reads its A fragments, late).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// mbarriers (shared addresses): a full barrier completes when its TMA bytes
// land, an empty one when both consumers have read the stage.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: the box at coordinates (c0, c1, c2, c3) of the tensor map into shared
// memory at dst; its bytes complete the transaction of barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Named barriers of the two consumer warpgroups (256 threads): id 1 is
// consumer 0's turn to issue products, id 2 consumer 1's.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// S (64 x N, float32) {=, +=} A B^T, A and B K-major bf16 in shared memory
// (scale_d 0 overwrites S).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (64 x N, float32) += P V: P (64 x 16, bf16) in registers, V (16 x N)
// N-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(
    float (&d)[128], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S = Q K^T for one consumer's 64 rows and a tile of KEYS keys: qd and kd
// are the descriptors of its Q rows and of the K tile (descriptors count
// 16-byte units: column block cb, k-step kk of 16 columns).
template <int DP, int KEYS>
__device__ __forceinline__ void issue_s(float (&s)[KEYS / 2], uint64_t qd,
                                        uint64_t kd) {
  wgmma_fence();
#pragma unroll
  for (int cb = 0; cb < DP / 64; ++cb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<KEYS>(s, qd + ((cb * kRows * 128 + kk * 32) >> 4),
                     kd + ((cb * KEYS * 128 + kk * 32) >> 4), cb + kk);
  wgmma_commit();
}

// O += P V over a tile of KEYS keys at shared address vt, P split into
// bf16 P_hi (registers 0 .. KEYS / 4 - 1) and P_lo (the rest); keys
// 16 kk .. 16 kk + 15 are registers 4 kk .. 4 kk + 3 of each.
template <int DP, int KEYS>
__device__ __forceinline__ void issue_pv(float (&acc)[DP / 2],
                                         const uint32_t (&p)[KEYS / 2],
                                         uint32_t vt) {
  const uint64_t vd = desc(vt, KEYS * 128, 1024);
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    wgmma_rs<DP>(acc, p + 4 * kk, vd + (kk * 16 * 128 >> 4));
    wgmma_rs<DP>(acc, p + KEYS / 4 + 4 * kk, vd + (kk * 16 * 128 >> 4));
  }
  wgmma_commit();
}

// 2^x on the special-function unit; results under 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Mask tile k0 where it straddles the causal diagonal, the window edge or
// the end of the keys, then run the online softmax on it: s becomes p in
// float32, m and l move on, and alpha[i] is the factor that brings row i's
// accumulator to the new maximum.  This thread holds rows r0 and r0 + 8,
// columns col and col + 1 of every group of 8 (fragment j: group j / 4, row
// r0 + 8 (j / 2 % 2), column col + j % 2); r_lo is its warpgroup's first row.
template <int N>
__device__ __forceinline__ void online_softmax(
    float (&s)[N], float (&m)[2], float (&l)[2], float (&alpha)[2], int k0,
    int r_lo, int r0, int col, int s_kv, int causal, int window, float c) {
  constexpr int kKeys = 2 * N;
  if (k0 + kKeys > s_kv || (causal && k0 + kKeys - 1 > r_lo) ||
      (window > 0 && k0 <= r_lo + 63 - window)) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int qi = r0 + (j & 2 ? 8 : 0);
      const int kj = k0 + 8 * (j / 4) + col + (j & 1);
      const bool ok = kj < s_kv && (!causal || kj <= qi) &&
                      (window <= 0 || kj > qi - window);
      if (!ok) s[j] = -INFINITY;
    }
  }
  // the quad of a row shares its max (four partial maxima a row, for
  // independent chains); sums stay partial
  float mx4[2][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) mx4[j / 2 % 2][j / 4 * 2 + j % 2] = s[j];
#pragma unroll
  for (int j = 8; j < N; ++j)
    mx4[j / 2 % 2][j / 4 % 2 * 2 + j % 2] =
        fmaxf(mx4[j / 2 % 2][j / 4 % 2 * 2 + j % 2], s[j]);
  float mx[2], ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    mx[i] = fmaxf(fmaxf(mx4[i][0], mx4[i][1]), fmaxf(mx4[i][2], mx4[i][3]));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    // nothing visible yet: p = 0 and the tile is a no-op
    ms[i] = m_new == -INFINITY ? 0.f : m_new * c;
    alpha[i] = ex2(m[i] * c - ms[i]);  // 0 while m[i] is -inf
    m[i] = m_new;
  }
  float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] = ex2(fmaf(s[j], c, -ms[j / 2 % 2]));  // exp2(-inf) = 0
    sum[j / 2 % 2][j % 2] += s[j];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + (sum[i][0] + sum[i][1]);
}

// P = P_hi + P_lo in bf16, packed as the A fragments of P V: fragment pair
// (2i, 2i + 1) of S is register i of P_hi and N / 2 + i of P_lo.
template <int N>
__device__ __forceinline__ void pack(uint32_t (&p)[N], const float (&s)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    // P_hi's two halves back in float32 by bit operations: no chain
    const uint32_t hi = bits(__floats2bfloat162_rn(s[j], s[j + 1]));
    p[j / 2] = hi;
    p[N / 2 + j / 2] = bits(__floats2bfloat162_rn(
        s[j] - __uint_as_float(hi << 16),
        s[j + 1] - __uint_as_float(hi & 0xFFFF0000u)));
  }
}

// The query blocks of one (batch, query head), longest first in pairs: pair
// i of a head is query block n_qb - 1 - i, then block i (their key tiles sum
// to the same count under a causal mask), so equal shares of pairs are
// equal work.  Pairs are numbered head by head, so the blocks that run at
// once share few heads' K and V in L2.  When the pairs would not fill the
// card, each query block is a pair of its own (paired == 0).
struct Items {
  int n_qb, pairs_a_head, n_pairs, heads, paired;
  __device__ int count(int pair) const {
    const int i = pair % pairs_a_head;
    return paired && n_qb - 1 - i != i ? 2 : 1;
  }
  // item k (0 or 1) of a pair: its first query row, head and batch
  __device__ void get(int pair, int k, int& q0, int& h, int& b) const {
    const int i = pair % pairs_a_head, hb = pair / pairs_a_head;
    q0 = (k == 0 ? n_qb - 1 - i : i) * kRows;
    h = hb % heads;
    b = hb / heads;
  }
};

// DP is the instantiation width (64, 128 or 256), d <= DP the head dimension.
// tq, tk, tv: 4-D tensor maps over (d, rows, heads, batch) of q, k and v,
// boxes of 64 columns by kRows (Q) or tc_keys(DP) (K, V) rows.  A block is
// persistent: it walks pairs blockIdx.x, blockIdx.x + gridDim.x, ... while
// its K / V ring and its consumers' turns run on from one item to the next,
// so one item's loads overlap the last one's tail.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
          Strides os, Items items, int s_q, int s_kv, int d, int group,
          int causal, int window, float c) {
  constexpr int kKeys = tc_keys(DP);
  static_assert(16 + 4 * 8 * kStages <= kBarrierBytes, "room for barriers");
  constexpr uint32_t kTile = kKeys * DP * 2;  // bytes of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t k_s = q_s + kRows * DP * 2;   // [kStages] K tiles
  const uint32_t v_s = k_s + kStages * kTile;  // [kStages] V tiles
  // the barriers, 8 bytes each (stage st at + 8 st)
  const uint32_t q_full = v_s + kStages * kTile, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, k_empty = k_full + 8 * kStages;
  const uint32_t v_full = k_empty + 8 * kStages;
  const uint32_t v_empty = v_full + 8 * kStages;

  // the key tiles that query rows q0 .. q0 + kRows - 1 can see
  auto tiles = [&](int q0, int& k_lo) {
    const int k_hi = causal ? min(s_kv, q0 + kRows) : s_kv;
    k_lo = window > 0 ? max(0, q0 - window + 1) / kKeys * kKeys : 0;
    return k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 2);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    int it = 0, n = 0;  // K / V tiles and Q blocks loaded so far
    for (int pair = blockIdx.x; pair < items.n_pairs; pair += gridDim.x) {
      for (int k = 0; k < items.count(pair); ++k) {
        int q0, h, b, k_lo;
        items.get(pair, k, q0, h, b);
        const int n_tiles = tiles(q0, k_lo), hk = h / group;
        if (n_tiles == 0) continue;
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);  // both read the last Q
        mbar_expect_tx(q_full, kRows * DP * 2);
#pragma unroll
        for (int cb = 0; cb < DP / 64; ++cb)
          tma_load(q_s + cb * kRows * 128, &tq, q_full, 64 * cb, q0, h, b);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int st = it % kStages, k0 = k_lo + t * kKeys;
          const uint32_t ph = (it / kStages) & 1;
          mbar_wait(k_empty + 8 * st, ph ^ 1);  // round 0 passes at once
          mbar_expect_tx(k_full + 8 * st, kTile);
#pragma unroll
          for (int cb = 0; cb < DP / 64; ++cb)
            tma_load(k_s + st * kTile + cb * kKeys * 128, &tk,
                     k_full + 8 * st, 64 * cb, k0, hk, b);
          mbar_wait(v_empty + 8 * st, ph ^ 1);
          mbar_expect_tx(v_full + 8 * st, kTile);
#pragma unroll
          for (int cb = 0; cb < DP / 64; ++cb)
            tma_load(v_s + st * kTile + cb * kKeys * 128, &tv,
                     v_full + 8 * st, 64 * cb, k0, hk, b);
        }
        ++n;
      }
    }
    if (n > 0) mbar_wait(q_full, (n - 1) & 1);  // no copy outlives the block
    return;
  }

  // ---- consumers: warpgroup cw owns rows q0 + 64 cw .. q0 + 64 cw + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int col = 2 * (lane % 4);
  const int mine = 1 + cw, other = 2 - cw;
  if (cw == 1) turn_pass(1);  // consumer 0 takes the first turn
  const uint64_t qd = desc(q_s + cw * 64 * 128, 16, 1024);
  int it = 0, n = 0;  // K / V tiles and Q blocks of the items before this one

  // a turn on tile it + t without products: free its stage
  auto skip = [&](int t) {
    turn_wait(mine);
    turn_pass(other);
    if (tid == 0) {
      const int st = (it + t) % kStages;
      const uint32_t ph = ((it + t) / kStages) & 1;
      mbar_wait(k_full + 8 * st, ph);
      mbar_arrive(k_empty + 8 * st);
      mbar_wait(v_full + 8 * st, ph);
      mbar_arrive(v_empty + 8 * st);
    }
  };

  for (int pair = blockIdx.x; pair < items.n_pairs; pair += gridDim.x) {
    for (int k = 0; k < items.count(pair); ++k) {
      int q0, h, b, k_lo;
      items.get(pair, k, q0, h, b);
      const int n_tiles = tiles(q0, k_lo);
      const int r_lo = q0 + 64 * cw;
      const int r0 = r_lo + 16 * warp + lane / 4;
      // this warpgroup's tiles are lo .. hi - 1 of the item's n_tiles; on
      // the others it only takes its turn and frees the stage
      int lo = 0, hi = n_tiles;
      if (window > 0 && r_lo - window + 1 > k_lo)
        lo = (r_lo - window + 1 - k_lo) / kKeys;
      if (causal) hi = min(hi, (r_lo + 63 - k_lo) / kKeys + 1);
      if (r_lo >= s_q || lo >= hi) lo = hi = n_tiles;

      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
      float acc[DP / 2];
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
      float s[kKeys / 2];
      uint32_t p[kKeys / 2];

      for (int t = 0; t < lo; ++t) skip(t);
      if (lo < hi) {
        mbar_wait(q_full, n & 1);
        {  // the first tile: S = Q K^T alone
          const int st = (it + lo) % kStages;
          mbar_wait(k_full + 8 * st, ((it + lo) / kStages) & 1);
          turn_wait(mine);
          issue_s<DP, kKeys>(s, qd, desc(k_s + st * kTile, 16, 1024));
          turn_pass(other);
          wgmma_wait<0>();
          pin(s);
          if (tid == 0) {
            mbar_arrive(k_empty + 8 * st);
            if (hi == lo + 1) mbar_arrive(q_empty);  // Q is read
          }
          online_softmax(s, m, l, alpha, k_lo + lo * kKeys, r_lo, r0, col,
                         s_kv, causal, window, c);
          pack(p, s);
        }
        for (int t = lo + 1; t < hi; ++t) {
          // S = Q K^T of tile t and O += P V of tile t - 1 in one turn
          const int st = (it + t) % kStages, pst = (it + t - 1) % kStages;
          mbar_wait(k_full + 8 * st, ((it + t) / kStages) & 1);
          turn_wait(mine);
          issue_s<DP, kKeys>(s, qd, desc(k_s + st * kTile, 16, 1024));
          mbar_wait(v_full + 8 * pst, ((it + t - 1) / kStages) & 1);
          issue_pv<DP, kKeys>(acc, p, v_s + pst * kTile);
          turn_pass(other);
          wgmma_wait<1>();
          pin(s);
          if (tid == 0) {
            mbar_arrive(k_empty + 8 * st);
            if (t == hi - 1) mbar_arrive(q_empty);
          }
          online_softmax(s, m, l, alpha, k_lo + t * kKeys, r_lo, r0, col,
                         s_kv, causal, window, c);
          wgmma_wait<0>();
          pin(acc);
          pin(p);
          if (tid == 0) mbar_arrive(v_empty + 8 * pst);
          pack(p, s);
          // most tiles move no row's maximum: then alpha is 1 for the warp
          if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
            for (int j = 0; j < DP / 2; ++j) acc[j] *= alpha[j / 2 % 2];
          }
        }
        // O += P V of the last tile, outside the turns
        const int pst = (it + hi - 1) % kStages;
        mbar_wait(v_full + 8 * pst, ((it + hi - 1) / kStages) & 1);
        issue_pv<DP, kKeys>(acc, p, v_s + pst * kTile);
        wgmma_wait<0>();
        pin(acc);
        if (tid == 0) mbar_arrive(v_empty + 8 * pst);
      } else if (n_tiles > 0 && tid == 0) {
        mbar_arrive(q_empty);  // this warpgroup never reads the item's Q
      }
      for (int t = hi; t < n_tiles; ++t) skip(t);

      bf16* op = o + b * os.b + h * os.h;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        const int qi = r0 + 8 * i;
        if (qi >= s_q) continue;
        const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no key -> 0
#pragma unroll
        for (int g = 0; g < DP / 8; ++g)
          if (8 * g + col < d)
            *reinterpret_cast<__nv_bfloat162*>(op + qi * os.s + 8 * g + col) =
                __floats2bfloat162_rn(acc[4 * g + 2 * i] * inv,
                                      acc[4 * g + 2 * i + 1] * inv);
      }
      it += n_tiles;
      n += n_tiles > 0;
    }
  }
  if (cw == 0) turn_wait(mine);  // consumer 1's last pass
}

// ---- launch ----------------------------------------------------------------

template <int NC>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Strides* st, int B, int Hq, int s_q, int s_kv, int d,
               int group, int causal, int window, cudaStream_t stream) {
  auto kern = f32_kernel<NC>;
  const int bytes = smem_floats(d) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_q + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1],
      st[2], st[3], s_q, s_kv, d, group, causal, window,
      1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

// A 4-D tensor map over (d, rows, heads, batch) of a bf16 tensor with element
// strides st, read in boxes of 64 columns by box_rows rows under the 128-byte
// swizzle; rows past the end read as zeros.  The encoder comes from the
// driver through the runtime, so the library links no -lcuda.
int tensor_map(CUtensorMap* map, const void* ptr, const Strides& st, int d,
               int rows, int heads, int batch, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const int n[3] = {rows, heads, batch};
  const long long e[3] = {st.s, st.h, st.b};
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)  // a dimension of length 1 is never stepped
    strides[i] = n[i] > 1 ? (cuuint64_t)e[i] * 2 : 16;
  cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;  // devices whose launch set-up is cached

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              const Strides* st, int B, int Hq, int s_q, int s_kv, int d,
              int group, int causal, int window, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptr[3] = {q, k, v};
  // a map has no empty dimension: with no key, no K / V tile is loaded
  const int kv_rows = s_kv > 0 ? s_kv : 1;
  const int rows[3] = {s_q, kv_rows, kv_rows};
  const int heads[3] = {Hq, Hq / group, Hq / group};
  const int box[3] = {kRows, tc_keys(DP), tc_keys(DP)};
  for (int i = 0; i < 3; ++i) {
    const int err = tensor_map(&maps[i], ptr[i], st[i], d, rows[i], heads[i],
                               B, box[i]);
    if (err != 0) return err;
  }
  auto kern = tc_kernel<DP>;
  const int bytes = tc_smem_bytes(DP);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the shared-memory opt-in and the SM count, once a device: both are host
  // calls that every launch would otherwise repeat
  static int sms_of[kMaxDevices] = {};
  int sms = dev < kMaxDevices ? sms_of[dev] : 0;
  if (sms == 0) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) sms_of[dev] = sms;
  }
  Items items;
  items.n_qb = (s_q + kRows - 1) / kRows;
  items.paired = (items.n_qb + 1) / 2 * Hq * B >= sms;
  items.pairs_a_head = items.paired ? (items.n_qb + 1) / 2 : items.n_qb;
  items.n_pairs = items.pairs_a_head * Hq * B;
  items.heads = Hq;
  // one block an SM, each walking its share of the pairs
  const int grid = items.n_pairs < sms ? items.n_pairs : sms;
  kern<<<grid, kTcThreads, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), st[3], items, s_q,
      s_kv, d, group, causal, window,
      1.4426950408889634f / sqrtf((float)d));  // log2(e) / sqrt(d)
  return (int)cudaGetLastError();
}

}  // namespace


extern "C" {

// q, o: (B, Hq, s_q, d); k, v: (B, Hq / group, s_kv, d), of type float32
// (bf16 == 0) or bf16 (bf16 == 1), the last dimension contiguous.  strides:
// 12 element strides (batch, head, seq) of q, k, v and o.  d % 16 == 0,
// 16 <= d <= 256, and for bf16 16-byte aligned pointers and strides
// (checked by the caller); window <= 0 means no window.  Returns the CUDA
// error code of the launch (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const long long* strides, int B, int Hq, int s_q,
                    int s_kv, int d, int group, int causal, int window,
                    int bf16, void* stream) {
  if (B == 0 || Hq == 0 || s_q == 0) return 0;
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  if (bf16) {
    switch (tc_width(d)) {
      case 64:
        return launch_tc<64>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group,
                             causal, window, sm);
      case 128:
        return launch_tc<128>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group,
                              causal, window, sm);
      default:
        return launch_tc<256>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group,
                              causal, window, sm);
    }
  }
  const int nc = d / 16;
  if (nc <= 1)
    return launch_f32<1>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                         window, sm);
  if (nc <= 2)
    return launch_f32<2>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                         window, sm);
  if (nc <= 4)
    return launch_f32<4>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                         window, sm);
  if (nc <= 8)
    return launch_f32<8>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                         window, sm);
  return launch_f32<16>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                        window, sm);
}

// Shared memory of one block, in bytes, for head dimension d: the dynamic
// bytes a launch asks for (neither route declares a static array).
int flash_attention_smem_bytes(int d, int bf16) {
  return bf16 ? tc_smem_bytes(tc_width(d))
              : smem_floats(d) * (int)sizeof(float);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
