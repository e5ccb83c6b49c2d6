// Dense triangle counting S = (A . A) o A over a 0/1 adjacency, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/triangle_count/kernel.py
// (triangle_count_kernel, body _kernel): S[i, j] = A[i, j] * sum_k A[i, k]
// A[k, j], i.e. the support of edge (i, j) when A is an adjacency matrix.
//
// Design.  A tiled product with a mask epilogue.  A block owns one 64 x 64
// output tile and walks k in steps of 64; each step stages the A[i, k] tile
// and the A[k, j] tile in shared memory, the latter transposed so that four
// consecutive k of one column pack into one 32-bit word.  Each of the 256
// threads keeps a 4 x 4 patch of int32 accumulators in registers and feeds
// them with __dp4a (four uint8 products and a 32-bit add per instruction),
// which is exact at any n.  The epilogue multiplies by A[i, j] and writes
// int32.  Inputs are uint8 with n a multiple of 64 (the wrapper pads).
// Tensor-core int8 (mma.sync / wgmma) is left to a later change.
//
// Bound: operations, 2 n^3 int8 operations over 1,979 TOP/s, against n^2
// bytes read and 4 n^2 bytes written over 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;            // output tile edge and k step (bytes)
constexpr int kWords = kTile / 4;    // packed 32-bit words per k step
constexpr int kStride = kWords + 1;  // odd row stride: conflict-free reads

__global__ void __launch_bounds__(256)
triangle_count_kernel(const uint8_t* __restrict__ A, int32_t* __restrict__ S,
                      int n) {
  __shared__ uint32_t As[kTile][kStride];  // As[i][w]: A[i0+i][k0+4w..+3]
  __shared__ uint32_t Bs[kTile][kStride];  // Bs[j][w]: A[k0+4w..+3][j0+j]
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const long long i0 = (long long)blockIdx.y * kTile;
  const long long j0 = (long long)blockIdx.x * kTile;
  // staging coordinates: one 16-byte chunk of each tile per thread
  const int ld_row = t / 4, ld_q = t % 4;

  uint32_t acc[4][4] = {};
  for (int k0 = 0; k0 < n; k0 += kTile) {
    const uint4 va = *reinterpret_cast<const uint4*>(
        A + (i0 + ld_row) * n + k0 + 16 * ld_q);
    As[ld_row][4 * ld_q + 0] = va.x;
    As[ld_row][4 * ld_q + 1] = va.y;
    As[ld_row][4 * ld_q + 2] = va.z;
    As[ld_row][4 * ld_q + 3] = va.w;
    const uint4 vb = *reinterpret_cast<const uint4*>(
        A + (long long)(k0 + ld_row) * n + j0 + 16 * ld_q);
    const uint32_t words[4] = {vb.x, vb.y, vb.z, vb.w};
    // row ld_row of the k-slab holds columns j0 + 16 ld_q + c; scatter each
    // byte into column c's packed k word
    for (int c = 0; c < 16; ++c) {
      const uint8_t byte = (words[c / 4] >> (8 * (c % 4))) & 0xFF;
      reinterpret_cast<uint8_t*>(&Bs[16 * ld_q + c][ld_row / 4])[ld_row % 4] =
          byte;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[ty + 16 * r][w];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[tx + 16 * c][w];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long idx = (i0 + ty + 16 * r) * n + j0 + tx + 16 * c;
      S[idx] = (int32_t)(acc[r][c] * A[idx]);
    }
  }
}

}  // namespace

extern "C" {

// A: (n, n) uint8 0/1, n % 64 == 0, 16-byte aligned; S: (n, n) int32.
// Returns the cudaGetLastError() code after the launch.
int triangle_count(const void* A, void* S, int n, void* stream) {
  if (n > 0) {
    dim3 grid(n / kTile, n / kTile);
    triangle_count_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(A), static_cast<int32_t*>(S), n);
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
