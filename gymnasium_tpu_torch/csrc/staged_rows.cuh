// Fixed part shared by the generated kernels that write one row of floats
// an env from the env's q and qd: the contact wrenches
// (contact_wrenches.cuh) and the bodies' centre-of-mass velocities
// (com_kinematics.cuh).
//
// gymnasium_tpu_torch/ops/articulated_codegen.py emits, per model, a struct
// R with the widths kNq, kNv, the row kRow, the shared-memory stride kStride
// (kRow rounded up to odd) and the block kBlock, and a static
// run(q, qd, out) that writes the env's row to out, one C statement per
// float operation. Each header instantiates these templates for its struct.
//
// Layout: one thread an env. The kinematics stay in registers and no value
// passes between threads. Each thread writes its row to the block's shared
// memory at stride kStride (odd, so the 32 stores of one value by a warp hit
// 32 banks); after one barrier the block's threads store the block's rows,
// which lie side by side in the (N, kRow) output, coalesced.
//
// Under a plain C++ compiler only the host loop is defined, so a test builds
// a generated text with g++ and holds it against the plain PyTorch twin.

#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ROWS_FN __host__ __device__ __forceinline__
#else
#define ROWS_FN inline
#endif

namespace rows {

// Every env's row on the host: the same run() as the kernel's.
template <typename R>
void host(const float* q, const float* qd, float* out, int n) {
  for (int e = 0; e < n; ++e)
    R::run(q + static_cast<size_t>(e) * R::kNq, qd + static_cast<size_t>(e) * R::kNv,
           out + static_cast<size_t>(e) * R::kRow);
}

#ifdef __CUDACC__
template <typename R>
__global__ void __launch_bounds__(R::kBlock)
    staged_kernel(const float* __restrict__ q, const float* __restrict__ qd,
                  float* __restrict__ out, int n) {
  __shared__ float rows[R::kBlock * R::kStride];
  const int first = blockIdx.x * R::kBlock;
  const int e = first + static_cast<int>(threadIdx.x);
  if (e < n)
    R::run(q + static_cast<size_t>(e) * R::kNq, qd + static_cast<size_t>(e) * R::kNv,
           rows + threadIdx.x * R::kStride);
  __syncthreads();
  const int envs = n - first < R::kBlock ? n - first : R::kBlock;
  float* block_out = out + static_cast<size_t>(first) * R::kRow;
  for (int j = threadIdx.x; j < envs * R::kRow; j += R::kBlock)
    block_out[j] = rows[(j / R::kRow) * R::kStride + j % R::kRow];
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// never synchronises. q (n, kNq), qd (n, kNv), out (n, kRow), row-major
// float32, n >= 1.
template <typename R>
int launch(const float* q, const float* qd, float* out, int n, void* stream) {
  staged_kernel<R><<<(n + R::kBlock - 1) / R::kBlock, R::kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(q, qd, out, n);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace rows
