// One fused removal round of the truss peel over B lanes, for Hopper (sm_90a).
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
// Design.  The Pallas kernel gathers corners and scatters decrements through
// one-hot (bt, E) matmuls because a TPU has no fast dynamic indexing; that is
// layout, not semantics.  Here one thread owns one triangle row (grid: x over
// triangle blocks, y over lanes), gathers the pre-round alive/rm of its three
// corners and, when the triangle dies, atomicAdds 1 into a separate int32
// (B, E) decrement buffer at each surviving corner.  Nothing updates in
// place, so every thread reads the pre-round state.  A second, elementwise
// launch applies sup - dec and alive * (1 - rm).  Int32 atomics are exact at
// any size (the Pallas f32 accumulator was exact only below 2^24 per edge).
//
// Bound: memory.  The function reads each triangle row once (12 B per row)
// and sup/alive/rm once, and writes sup'/alive' once: (12 B T + 20 B E)
// bytes over 3.35 TB/s.  The kernel adds the decrement buffer's zeroing,
// atomics and read-back (about 12 B E more); the corner gathers are served
// from L2 while B E 8 bytes of alive/rm fit in its 50 MB.  Atomic
// contention on hub edges is left to a later change.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void decrement_kernel(const int32_t* __restrict__ alive,
                                 const int32_t* __restrict__ rm,
                                 const int32_t* __restrict__ tris,
                                 int32_t* __restrict__ dec,
                                 int E, long long T) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const long long lane = blockIdx.y;
  const int32_t* row = tris + (lane * T + t) * 3;
  const int e0 = row[0], e1 = row[1], e2 = row[2];
  // the drop slot (id E) and anything outside [0, E) is inert
  if ((unsigned)e0 >= (unsigned)E || (unsigned)e1 >= (unsigned)E ||
      (unsigned)e2 >= (unsigned)E)
    return;
  const long long base = lane * (long long)E;
  if (!(alive[base + e0] && alive[base + e1] && alive[base + e2])) return;
  const int r0 = rm[base + e0] != 0, r1 = rm[base + e1] != 0,
            r2 = rm[base + e2] != 0;
  if (!(r0 | r1 | r2)) return;
  // the triangle dies: each corner that survives the round loses 1
  if (!r0) atomicAdd(dec + base + e0, 1);
  if (!r1) atomicAdd(dec + base + e1, 1);
  if (!r2) atomicAdd(dec + base + e2, 1);
}

__global__ void apply_kernel(const int32_t* __restrict__ sup,
                             const int32_t* __restrict__ alive,
                             const int32_t* __restrict__ rm,
                             const int32_t* __restrict__ dec,
                             int32_t* __restrict__ sup_out,
                             int32_t* __restrict__ alive_out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  sup_out[i] = sup[i] - dec[i];
  alive_out[i] = alive[i] * (1 - rm[i]);
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// dec must hold B*E zeros on entry.  B <= 65535 (grid y).  Returns the
// cudaGetLastError() code after both launches.
int frontier_peel_round(const void* sup, const void* alive, const void* rm,
                        const void* tris, void* dec, void* sup_out,
                        void* alive_out, int B, int E, long long T,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && T > 0 && E > 0) {
    dim3 grid((unsigned)((T + kThreads - 1) / kThreads), (unsigned)B);
    decrement_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(alive), static_cast<const int32_t*>(rm),
        static_cast<const int32_t*>(tris), static_cast<int32_t*>(dec), E, T);
  }
  const long long n = (long long)B * E;
  if (n > 0) {
    apply_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                   s>>>(
        static_cast<const int32_t*>(sup), static_cast<const int32_t*>(alive),
        static_cast<const int32_t*>(rm), static_cast<const int32_t*>(dec),
        static_cast<int32_t*>(sup_out), static_cast<int32_t*>(alive_out), n);
  }
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
