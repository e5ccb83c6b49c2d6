// Embedding bag: out[b] = sum or mean over l of table[idx[b, l]], for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (embedding_bag_kernel, body _bag_kernel), which walks a (B, L) grid and
// fetches one prefetched table row per step into a (1, D) float32
// accumulator; a mean bag divides by L on the last step.
//
// Design.  One thread per output element (bag b, column d): consecutive
// threads take consecutive columns of a bag and then the next bag, so a warp
// reads whole table rows (D = 18 float32 is a 72-byte row, not 16-byte
// aligned, hence scalar loads) and no lane idles whatever D is.  Each thread
// walks its bag's L indices in order, four loads in flight at a time, and
// sums in float32; a mean divides the sum by L at the end, as the TPU kernel
// does.  The result is written in the table's type (float32 or bf16).  The
// order of the sum is the reference's only up to rounding, so the kernel is
// held to a tolerance, not to bit equality.  Indices must lie in [0, V): the
// kernel does not check them.
//
// Bound: bytes.  B L D itemsize bytes of rows gathered, 4 B L bytes of
// indices and B D itemsize bytes written, over 3.35 TB/s; the gather reads
// whole 32-byte sectors, so rows that are not sector-aligned cost more.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
embedding_bag_kernel(const T* __restrict__ table,
                     const int32_t* __restrict__ idx, T* __restrict__ out,
                     long long n_out, int L, int D, int mean) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_out) return;
  const long long bag = g / D;
  const int d = (int)(g - bag * D);
  const int32_t* rows = idx + bag * L;
  const T* col = table + d;
  float acc = 0.f;
  int l = 0;
  for (; l + 4 <= L; l += 4) {
    const long long r0 = __ldg(rows + l), r1 = __ldg(rows + l + 1),
                    r2 = __ldg(rows + l + 2), r3 = __ldg(rows + l + 3);
    const float v0 = to_f(col[r0 * D]), v1 = to_f(col[r1 * D]),
                v2 = to_f(col[r2 * D]), v3 = to_f(col[r3 * D]);
    acc += v0;
    acc += v1;
    acc += v2;
    acc += v3;
  }
  for (; l < L; ++l) acc += to_f(col[(long long)__ldg(rows + l) * D]);
  if (mean) acc /= (float)L;
  store(out + g, acc);
}

template <typename T>
int launch(const void* table, const void* idx, void* out, long long B, int L,
           int D, int mean, cudaStream_t stream) {
  const long long n_out = B * D;
  const long long blocks = (n_out + 255) / 256;
  embedding_bag_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(idx),
      static_cast<T*>(out), n_out, L, D, mean);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: (V, D) float32 (bf16 == 0) or bf16 (bf16 == 1), contiguous;
// idx: (B, L) int32, contiguous, every entry in [0, V); out: (B, D) of the
// table's type.  mean != 0 divides each bag's sum by L.  Returns the CUDA
// error code of the launch (0 on success).
int embedding_bag(const void* table, const void* idx, void* out, long long B,
                  int L, int D, int mean, int bf16, void* stream) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(table, idx, out, B, L, D, mean, st);
  return launch<float>(table, idx, out, B, L, D, mean, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
