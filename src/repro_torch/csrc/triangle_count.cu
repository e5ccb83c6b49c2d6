// Dense triangle counting S = (A . A) o A over a 0/1 adjacency, for Hopper
// (sm_90a), on the int8 tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/triangle_count/kernel.py
// (triangle_count_kernel, body _kernel): S[i, j] = A[i, j] * sum_k A[i, k]
// A[k, j], i.e. the support of edge (i, j) when A is an adjacency matrix.
//
// Design.  A block of two warpgroups (256 threads) owns one 128 x 128 output
// tile; each warpgroup owns 64 of its rows.  The k dimension goes in slabs of
// 128 bytes through a three-stage ring in shared memory, filled by 16-byte
// cp.async, so the next slabs' copies overlap this slab's products.  Both
// operands are K-major, as int8 wgmma requires: the A operand is rows
// i0 .. i0 + 127 of A, the B operand rows j0 .. j0 + 127 of A^T (for a
// symmetric A, A's own rows; the caller passes the matrix whose rows to
// read).  A slab tile is 128 rows of 128 bytes under the 128-byte XOR
// swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)), the layout of
// csrc/flash_attention.cu, which wgmma reads without bank conflicts.  Each
// slab is four wgmma m64n128k32 with u8 operands and s32 accumulators (64
// a thread), exact at any n (a sum of at most n 0/1 products).  The
// epilogue multiplies by the mask A[i, j] and writes int32 pairs.  n must be
// a multiple of 128 (the wrapper pads with zeros, which count nothing).
//
// Bound: operations, 2 n^3 int8 operations over 1,979 TOP/s, against n^2
// bytes read and 4 n^2 bytes written over 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;     // output tile edge
constexpr int kSlab = 128;     // k bytes a stage: one swizzled 128-byte row
constexpr int kStages = 3;
constexpr int kThreads = 256;  // two warpgroups
constexpr uint32_t kTileBytes = kTile * kSlab;  // one operand's slab tile
// the ring, and 1 KB to align it to the swizzle's 1024-byte period
constexpr int kSmemBytes = kStages * 2 * kTileBytes + 1024;

// Copy rows row0 .. row0 + 127, bytes k0 .. k0 + 127 of an (n, n) uint8
// matrix into the swizzled tile at shared address dst, asynchronously.  A
// thread copies chunk c of rows r, r + 32, r + 64, r + 96: one swizzle.
__device__ __forceinline__ void stage(uint32_t dst, const uint8_t* g, int n,
                                      long long row0, int k0) {
  const int c = threadIdx.x % 8, r = threadIdx.x / 8;
  dst += r * 128 + ((c ^ (r & 7)) << 4);
  const uint8_t* src = g + (row0 + r) * n + k0 + 16 * c;
#pragma unroll
  for (int it = 0; it < kTile / 32; ++it)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     dst + it * 32 * 128),
                 "l"(src + (long long)it * 32 * n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma matrix descriptor of a K-major operand under the 128-byte swizzle at
// shared address addr: rows of 128 bytes, sbo = 1024 bytes between groups of
// 8 rows, lbo unused; layout type 1 (128-byte swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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
// the asynchronous products.
__device__ __forceinline__ void pin(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 128, s32) += A B^T over 32 bytes of k, A (64 x 32) and B (128 x
// 32) u8, both K-major in shared memory.
__device__ __forceinline__ void wgmma_u8_n128(int32_t (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// A: the mask and the A operand's rows; At: the B operand's rows (A^T).
__global__ void __launch_bounds__(kThreads)
triangle_count_kernel(const uint8_t* __restrict__ A,
                      const uint8_t* __restrict__ At,
                      int32_t* __restrict__ S, int n) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) &
      ~1023u;
  // stage s: the A slab tile at ring + 2 s kTileBytes, the B one after it
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const long long i0 = (long long)blockIdx.y * kTile;
  const long long j0 = (long long)blockIdx.x * kTile;
  const int n_slabs = n / kSlab;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slabs) {
      stage(ring + 2 * s * kTileBytes, A, n, i0, s * kSlab);
      stage(ring + (2 * s + 1) * kTileBytes, At, n, j0, s * kSlab);
    }
    cp_async_commit();
  }

  int32_t acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0;

  for (int t = 0; t < n_slabs; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slab t landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // every thread's, and slab t - 1's products are done
    const int nx = t + kStages - 1;  // refill the slot slab t - 1 used
    if (nx < n_slabs) {
      const int slot = nx % kStages;
      stage(ring + 2 * slot * kTileBytes, A, n, i0, nx * kSlab);
      stage(ring + (2 * slot + 1) * kTileBytes, At, n, j0, nx * kSlab);
    }
    cp_async_commit();

    const uint32_t a_t = ring + 2 * (t % kStages) * kTileBytes;
    const uint64_t ad = desc(a_t + wg * 64 * 128);
    const uint64_t bd = desc(a_t + kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlab / 32; ++kk)  // descriptors count 16 bytes
      wgmma_u8_n128(acc, ad + 2 * kk, bd + 2 * kk);
    wgmma_commit();
    wgmma_wait();
    pin(acc);
  }

  // accumulator layout: this thread holds rows r0 and r0 + 8, columns
  // 8 g + col and 8 g + col + 1 of every group g of 8 (fragment 4 g + 2 h
  // + e: row r0 + 8 h, column 8 g + col + e)
  const long long r0 = i0 + 64 * wg + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int g = 0; g < 16; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long idx = (r0 + 8 * h) * n + j0 + 8 * g + col;
      const uint16_t mask = *reinterpret_cast<const uint16_t*>(A + idx);
      *reinterpret_cast<int2*>(S + idx) =
          make_int2(acc[4 * g + 2 * h] * (mask & 0xFF),
                    acc[4 * g + 2 * h + 1] * (mask >> 8));
    }
  }
}

}  // namespace

extern "C" {

// A, At: (n, n) uint8 0/1, At = A^T (the same pointer for a symmetric A),
// n % 128 == 0, 16-byte aligned; S: (n, n) int32.  Returns the
// cudaGetLastError() code after the launch.
int triangle_count(const void* A, const void* At, void* S, int n,
                   void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t rc = cudaFuncSetAttribute(
        triangle_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (rc != cudaSuccess) return (int)rc;
    configured = true;
  }
  if (n > 0) {
    dim3 grid(n / kTile, n / kTile);
    triangle_count_kernel<<<grid, kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(At),
        static_cast<int32_t*>(S), n);
  }
  return (int)cudaGetLastError();
}

// Shared memory of one block, in bytes: the dynamic ring (no static
// arrays), the same at every n.
int triangle_count_smem_bytes(void) { return kSmemBytes; }

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
