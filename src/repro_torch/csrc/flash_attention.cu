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
// bf16: tensor cores (tc_kernel).  One block of two warpgroups (256 threads)
// owns 128 query rows of one (batch, query head); each warpgroup owns 64 of
// them.  Q stays in shared memory as bf16 for the whole block; key and value
// tiles of 64 rows go through a two-stage ring filled by 16-byte cp.async, so
// the next tile's copy overlaps this tile's products.  Every tile is stored
// as column blocks of 64 bf16 (128-byte rows) under the 128-byte XOR swizzle
// that wgmma reads without bank conflicts.  S = Q K^T is wgmma m64n64k16
// with both operands in shared memory (Q and K rows are K-major); O += P V is
// wgmma m64nDk16 with P from registers and V read transposed (N-major) from
// shared memory.  The online softmax runs on the accumulator fragments: a
// thread holds 2 rows x 16 columns of S, the row max is a shuffle within the
// quad that shares a row, the partial row sum stays in the thread until the
// end, and exp2f takes log2(e)/sqrt(D) folded into one multiply.  P is split
// into two bf16 terms, P_hi = bf16(p) and P_lo = bf16(p - P_hi), and both
// multiply V: P rounded once to bf16 errs by up to 2^-8 |p|, which took a
// model of this kernel past chip_smoke.B3_TOL on some of its cases
// (tests/test_torch_flash_attention.py); the pair keeps about 16 bits of p,
// at 1.5x the tensor-core work of a single product.  Widths
// D = 64, 128 and 256 are instantiated; another multiple of 16 runs on the
// next one up with zero Q / K / V columns, which change no score, and the
// extra output columns are never stored.  Registers at D = 256: the O
// accumulator of 64 x 256 float32 is 128 a thread, S 32 and P 32 more, with
// one block of 256 threads per SM (193 KB of shared memory); ptxas gives it
// 229 registers and no spills.  On an H100 80GB HBM3 at 700 W, gemma3-4b's
// heads at (B, Hq, Hkv, S, D) = (8, 8, 4, 2048, 256) take 0.56 ms causal
// (2.2x scaled_dot_product_attention, 4.0x the bound) and 0.44 ms with a
// window of 1024 (PERF.md).
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
// Both routes: the last query blocks, which see the most keys, start first;
// key tiles wholly after a block's last row (causal) or wholly before its
// first row's window are never visited, which is the TPU kernel's block
// skipping, and the bf16 route also skips, per warpgroup, the tiles that
// none of its 64 rows sees.  Scores a row cannot see are -inf and take
// probability 0 exactly (the bf16 route masks only the tiles that straddle
// the causal diagonal, the window edge or the end of the keys); a row with
// no visible key so far keeps m = -inf, l = 0 and its tile is a no-op, so
// the result is the reference softmax (ref.mha_reference), and a row that
// sees no key at all outputs 0, as the TPU kernel does (l == 0).
//
// Shapes: D a multiple of 16 up to 256 (the wrapper raises otherwise); any
// sequence length; strides in elements for the batch, head and sequence
// dimensions (the head dimension is contiguous), so (B, S, H, D) tensors
// transposed to (B, H, S, D) are read in place.  The bf16 route needs base
// pointers and strides that are multiples of 16 bytes (the wrapper checks).

#include <cstdint>
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

constexpr int kRows = 128;  // query rows of a block: two warpgroups of 64
constexpr int kKeys = 64;   // key rows of a tile
constexpr int kStages = 2;  // the K / V ring

// Shared memory of one block, in bytes, for instantiation width dp: Q, then
// kStages K tiles, then kStages V tiles, and 1 KB to align the first to the
// swizzle's 1024-byte period.
__host__ __device__ constexpr int tc_smem_bytes(int dp) {
  return (kRows + 2 * kStages * kKeys) * dp * 2 + 1024;
}

__host__ __device__ constexpr int tc_width(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

// Byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r in a tile
// of R rows, stored as column blocks of 64 bf16: block c / 8 holds R rows of
// 128 bytes, and chunk c % 8 of row r sits at chunk (c % 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swizzled(int R, int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Copy rows row0 .. row0 + R - 1 of a (rows, d) bf16 matrix with row stride
// ld into the swizzled tile at shared address dst, asynchronously: rows at
// or after limit and columns at or after d are filled with zeros.  A thread
// copies the same chunk c of rows r, r + kStep, ...; kStep is a multiple of
// 8, so the swizzle of those rows is the same.
template <int R, int DP>
__device__ __forceinline__ void stage(uint32_t dst, const bf16* g,
                                      long long ld, int row0, int limit,
                                      int d) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks a row
  constexpr int kStep = kThreads / kChunks;
  static_assert(kStep % 8 == 0 && R % kStep == 0, "whole rounds of rows");
  const int c = threadIdx.x % kChunks, r = threadIdx.x / kChunks;
  dst += swizzled(R, r, c);
  const bf16* src = g + (row0 + r) * ld + c * 8;
  const int rows = c * 8 < d ? limit - row0 - r : 0;  // rows to copy
#pragma unroll
  for (int it = 0; it < R / kStep; ++it) {
    const bool ok = it * kStep < rows;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(dst + it * kStep * 128),
                 "l"(ok ? src + it * kStep * ld : g), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products (it does not know that wgmma writes them late).
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S (64 x 64, float32) {=, +=} A B^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
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

// O (64 x N, float32) += P V, P (64 x 16, bf16) in registers, V (16 x N)
// N-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                            const uint32_t* a, uint64_t b) {
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
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                            const uint32_t* a, uint64_t b) {
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
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                            const uint32_t* a, uint64_t b) {
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// DP is the instantiation width (64, 128 or 256), d <= DP the head dimension.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, Strides qs,
          Strides ks, Strides vs, Strides os, int s_q, int s_kv, int d,
          int group, int causal, int window, float c) {
  constexpr int kBlocks = DP / 64;             // column blocks of a row
  constexpr uint32_t kTile = kKeys * DP * 2;   // bytes of a K or V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  const uint32_t k_s = q_s + kRows * DP * 2;   // [kStages] K tiles
  const uint32_t v_s = k_s + kStages * kTile;  // [kStages] V tiles

  const int wg = threadIdx.x / 128;  // warpgroup
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  // the last query blocks see the most keys: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const bf16* qp = q + b * qs.b + h * qs.h;
  const bf16* kp = k + b * ks.b + hk * ks.h;
  const bf16* vp = v + b * vs.b + hk * vs.h;
  bf16* op = o + b * os.b + h * os.h;

  // the key tiles these rows can see
  int k_hi = s_kv;
  if (causal) k_hi = min(s_kv, q0 + kRows);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1) / kKeys * kKeys;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kKeys - 1) / kKeys : 0;

  stage<kRows, DP>(q_s, qp, qs.s, q0, s_q, d);
  if (n_tiles > 0) {
    stage<kKeys, DP>(k_s, kp, ks.s, k_lo, s_kv, d);
    stage<kKeys, DP>(v_s, vp, vs.s, k_lo, s_kv, d);
  }
  cp_async_commit();

  // this warpgroup's rows are r_lo .. r_lo + 63; in the accumulator layout
  // this thread holds rows r0 and r0 + 8, columns col and col + 1 of every
  // group of 8 (fragment j: group j / 4, row r0 + 8 (j / 2 % 2), column
  // col + j % 2)
  const int r_lo = q0 + 64 * wg;
  const int r0 = r_lo + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kKeys;
    const uint32_t kt = k_s + (t % kStages) * kTile;
    const uint32_t vt = v_s + (t % kStages) * kTile;
    if (t + 1 < n_tiles) {  // the next tile's copy overlaps this tile
      const uint32_t next = (t + 1) % kStages * kTile;
      stage<kKeys, DP>(k_s + next, kp, ks.s, k0 + kKeys, s_kv, d);
      stage<kKeys, DP>(v_s + next, vp, vs.s, k0 + kKeys, s_kv, d);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile t (and of Q) landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();     // and every thread's, visible to wgmma

    // a tile none of this warpgroup's rows sees is skipped
    const bool seen = r_lo < s_q && !(causal && k0 > r_lo + 63) &&
                      !(window > 0 && k0 + kKeys - 1 <= r_lo - window);
    if (seen) {
      // S = Q K^T
      float s[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = 0.f;
      const uint64_t qd = desc(q_s + wg * 64 * 128, 16, 1024);
      const uint64_t kd = desc(kt, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int cb = 0; cb < kBlocks; ++cb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // descriptors count 16-byte units
          wgmma_ss_n64(s, qd + ((cb * kRows * 128 + kk * 32) >> 4),
                       kd + ((cb * kKeys * 128 + kk * 32) >> 4), cb + kk);
      wgmma_commit();
      wgmma_wait();
      pin(s);

      // mask, only on tiles that straddle the diagonal, the window edge or
      // the end of the keys
      if (k0 + kKeys > s_kv || (causal && k0 + kKeys - 1 > r_lo) ||
          (window > 0 && k0 <= r_lo + 63 - window)) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int qi = r0 + (j & 2 ? 8 : 0);
          const int kj = k0 + 8 * (j / 4) + col + (j & 1);
          const bool ok = kj < s_kv && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
          if (!ok) s[j] = -INFINITY;
        }
      }

      // online softmax: the quad of a row shares its max; sums stay partial
      float mx[2] = {-INFINITY, -INFINITY}, ms[2], alpha[2];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        mx[j / 2 % 2] = fmaxf(mx[j / 2 % 2], s[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // nothing visible yet: p = 0 and the tile is a no-op
        ms[i] = m_new == -INFINITY ? 0.f : m_new * c;
        alpha[i] = exp2f(m[i] * c - ms[i]);  // 0 while m[i] is -inf
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      // P = P_hi + P_lo in bf16, packed as the A fragments of P V: fragment
      // pair (2i, 2i + 1) of S is register i, so keys 16 ks .. 16 ks + 15
      // are registers 4 ks .. 4 ks + 3
      uint32_t p_hi[16], p_lo[16];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int i = j / 2 % 2;
        const float p0 = exp2f(fmaf(s[j], c, -ms[i]));  // exp2(-inf) = 0
        const float p1 = exp2f(fmaf(s[j + 1], c, -ms[i]));
        l[i] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 back = __bfloat1622float2(hi);
        p_hi[j / 2] = bits(hi);
        p_lo[j / 2] = bits(__floats2bfloat162_rn(p0 - back.x, p1 - back.y));
      }
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] *= alpha[j / 2 % 2];

      // O += P_hi V + P_lo V
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vd = desc(vt, kKeys * 128, 1024) + (kk * 16 * 128 >> 4);
        wgmma_rs<DP>(acc, p_hi + 4 * kk, vd);
        wgmma_rs<DP>(acc, p_lo + 4 * kk, vd);
      }
      wgmma_commit();
      wgmma_wait();
      pin(acc);
    }
    __syncthreads();  // tile t is read: its stage may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = r0 + 8 * i;
    if (qi >= s_q) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no visible key -> 0
#pragma unroll
    for (int g = 0; g < DP / 8; ++g)
      if (8 * g + col < d)
        *reinterpret_cast<__nv_bfloat162*>(op + qi * os.s + 8 * g + col) =
            __floats2bfloat162_rn(acc[4 * g + 2 * i] * inv,
                                  acc[4 * g + 2 * i + 1] * inv);
  }
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

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              const Strides* st, int B, int Hq, int s_q, int s_kv, int d,
              int group, int causal, int window, cudaStream_t stream) {
  auto kern = tc_kernel<DP>;
  const int bytes = tc_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s_q + kRows - 1) / kRows, Hq, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), st[0], st[1],
      st[2], st[3], s_q, s_kv, d, group, causal, window,
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

// Dynamic shared memory of one block, in bytes, for head dimension d.
int flash_attention_smem_bytes(int d, int bf16) {
  return bf16 ? tc_smem_bytes(tc_width(d))
              : smem_floats(d) * (int)sizeof(float);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
