// Forward causal / sliding-window GQA attention with an online softmax, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_kernel, body _attn_kernel): o[b, h, i] = softmax_j(q[b, h,
// i] . k[b, h / group, j] / sqrt(D)) v[b, h / group, j] over the keys j that
// row i sees: j <= i when causal, i - window < j when a window is given.
// Accumulation is in float32; the output has q's type (float32 or bf16).
//
// Design.  One block of 256 threads owns 64 query rows of one (batch, query
// head) and walks the key tiles of 64 rows that those rows can see: tiles
// wholly after the last row (causal) or wholly before the first row's window
// are never visited, which is the TPU kernel's block skipping.  Query, key
// and value tiles are staged in shared memory as float32 (Q and K rows
// padded by two words so that a half-warp's 8-byte reads of 16 rows fall
// on 32 distinct banks).  Thread (ty, tx) of a
// 16 x 16 grid holds a 4 x 4 patch of the score tile S = Q K^T in registers:
// rows ty + 16 r, columns tx + 16 c.  The 16 threads of a half-warp share
// their rows, so the row max and row sum of the online softmax are butterfly
// shuffles inside the half-warp.  The probabilities go to shared memory, and
// the same thread keeps the 4 x (D / 16) patch of the output accumulator
// (rows ty + 16 r, columns tx + 16 c) in registers, rescaled by
// exp(m_old - m_new) before each tile's P V is added.
//
// Masking: scores a row cannot see are -inf and take probability 0 exactly;
// a row with no visible key so far keeps m = -inf, l = 0 and its tile is a
// no-op, so the result is the reference softmax (ref.mha_reference), and a
// row that sees no key at all outputs 0, as the TPU kernel does (l == 0).
//
// Bound: operations.  4 B Hq D flops for every visible (query, key) pair over
// 989 TFLOP/s (bf16 tensor cores), against the bytes of q, k, v and o once
// over 3.35 TB/s.  This first kernel runs on the CUDA cores in float32 FMAs
// (67 TFLOP/s at most), so it cannot come near that bound; tensor cores
// (mma.sync / wgmma) and TMA staging are left to a later change.
//
// Shapes: D a multiple of 16 up to 256 (the wrapper raises otherwise); any
// sequence length; strides in elements for the batch, head and sequence
// dimensions (the head dimension is contiguous), so (B, S, H, D) tensors
// transposed to (B, H, S, D) are read in place.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;             // query rows of a block
constexpr int kBK = 64;             // key rows of a tile
constexpr int kThreads = 256;
constexpr int kPStride = kBK + 16;  // P row stride: half-warps on other banks

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Strides {
  long long b, h, s;
};

// Shared memory of one block, in floats, for head dimension d.
__host__ __device__ inline int smem_floats(int d) {
  return kBQ * (d + 2) + kBK * (d + 2) + kBK * d + kBQ * kPStride;
}

// NC is the capacity of the accumulator in 16-column groups (d <= 16 NC).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       int s_q, int s_kv, int d, int group, int causal,
                       int window, float scale) {
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
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    const int qi = q0 + r;
    Qs[r * ld + c] = qi < s_q ? to_f(qp[qi * qs.s + c]) : 0.f;
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
      Ks[r * ld + c] = in ? to_f(kp[kj * ks.s + c]) : 0.f;
      Vs[r * d + c] = in ? to_f(vp[kj * vs.s + c]) : 0.f;
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
      if (c < nc) store(&op[qi * os.s + tx + 16 * c], acc[r][c] * inv);
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Hq, int s_q, int s_kv, int d,
           int group, int causal, int window, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, NC>;
  const int bytes = smem_floats(d) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((s_q + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, s_q,
      s_kv, d, group, causal, window, 1.0f / sqrtf((float)d));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* st, int B, int Hq, int s_q, int s_kv, int d,
             int group, int causal, int window, cudaStream_t stream) {
  const int nc = d / 16;
  if (nc <= 1)
    return launch<T, 1>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                        window, stream);
  if (nc <= 2)
    return launch<T, 2>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                        window, stream);
  if (nc <= 4)
    return launch<T, 4>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                        window, stream);
  if (nc <= 8)
    return launch<T, 8>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                        window, stream);
  return launch<T, 16>(q, k, v, o, st, B, Hq, s_q, s_kv, d, group, causal,
                       window, stream);
}

}  // namespace

extern "C" {

// q, o: (B, Hq, s_q, d); k, v: (B, Hq / group, s_kv, d), of type float32
// (bf16 == 0) or bf16 (bf16 == 1), the last dimension contiguous.  strides:
// 12 element strides (batch, head, seq) of q, k, v and o.  d % 16 == 0,
// 16 <= d <= 256 (checked by the caller); window <= 0 means no window.
// Returns the CUDA error code of the launch (0 on success).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const long long* strides, int B, int Hq, int s_q,
                    int s_kv, int d, int group, int causal, int window,
                    int bf16, void* stream) {
  if (B == 0 || Hq == 0 || s_q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, Hq, s_q, s_kv, d,
                                   group, causal, window, st);
  return dispatch<float>(q, k, v, o, strides, B, Hq, s_q, s_kv, d, group,
                         causal, window, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
