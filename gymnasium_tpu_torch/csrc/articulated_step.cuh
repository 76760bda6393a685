// Fixed part of the generated articulated (MuJoCo-class) substep kernels.
//
// Replaces gymnasium_tpu/ops/pallas_articulated.py::make_fused_step (body
// `kernel` :512, pallas_call :563). The TPU kernel lays 1024 envs out as
// (8, 128) row blocks and runs one program per block. Here each thread owns
// one env: it loads q, qd and ctrl into registers, runs `frame_skip`
// substeps of straight-line code and stores q', qd'. Any N works; the last
// block is masked by a bounds check.
//
// gymnasium_tpu_torch/ops/articulated_codegen.py emits, per (model,
// frame_skip), a struct with the widths kNq, kNv, kNu and a static
// run(q, qd, ctrl) that holds the whole step, one C statement per float
// operation of the JAX row program, in its order, with its float32
// constants. The generated file includes this header and ends with
// ART_ENTRY_POINTS(struct). Under nvcc that defines the C launcher
// articulated_step_launch, loaded with ctypes. Under a plain C++ compiler it
// defines the host loop articulated_step_host instead, so a test can build
// the same text with g++ and hold it against the plain PyTorch twin before
// any card sees it.
//
// Bound: an env reads (nq + nv + nu) floats and writes (nq + nv), 168 B for
// HalfCheetah, while it runs several thousand float operations a substep
// (the generator counts them). So operations bound it, at one float32
// operation a lane a clock (-fmad=false: no add or multiply is fused).
// With one thread per env, N=4096 gives only 128 warps, one a scheduler on
// 32 SMs: the kernel is latency-bound, by the dependent chain of each env's
// substep, far from that bound. Blocks of 128 threads keep the four warps
// that share an SM on one copy of the long instruction stream.
//
// The build uses precise sinf/cosf/sqrtf, IEEE division and -fmad=false, so
// every operation rounds where the plain twin's does.

#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ART_FN __host__ __device__ __forceinline__
#define ART_NO_UNROLL _Pragma("unroll 1")
#else
#define ART_FN inline
#define ART_NO_UNROLL
#endif

namespace art {

constexpr int kBlock = 128;  // threads a block

template <typename Step>
struct Row {
  static constexpr int kNuPad = Step::kNu > 0 ? Step::kNu : 1;
};

// One env's step on the host: the same run() as the kernel's.
template <typename Step>
void step_host(const float* q, const float* qd, const float* ctrl, float* q_out,
               float* qd_out, int n) {
  for (int e = 0; e < n; ++e) {
    float qv[Step::kNq], vv[Step::kNv], cv[Row<Step>::kNuPad];
    for (int i = 0; i < Step::kNq; ++i) qv[i] = q[static_cast<size_t>(e) * Step::kNq + i];
    for (int i = 0; i < Step::kNv; ++i) vv[i] = qd[static_cast<size_t>(e) * Step::kNv + i];
    for (int i = 0; i < Step::kNu; ++i) cv[i] = ctrl[static_cast<size_t>(e) * Step::kNu + i];
    Step::run(qv, vv, cv);
    for (int i = 0; i < Step::kNq; ++i) q_out[static_cast<size_t>(e) * Step::kNq + i] = qv[i];
    for (int i = 0; i < Step::kNv; ++i) qd_out[static_cast<size_t>(e) * Step::kNv + i] = vv[i];
  }
}

#ifdef __CUDACC__
template <typename Step>
__global__ void __launch_bounds__(kBlock)
    step_kernel(const float* __restrict__ q, const float* __restrict__ qd,
                const float* __restrict__ ctrl, float* __restrict__ q_out,
                float* __restrict__ qd_out, int n) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= n) return;
  float qv[Step::kNq], vv[Step::kNv], cv[Row<Step>::kNuPad];
#pragma unroll
  for (int i = 0; i < Step::kNq; ++i) qv[i] = q[static_cast<size_t>(e) * Step::kNq + i];
#pragma unroll
  for (int i = 0; i < Step::kNv; ++i) vv[i] = qd[static_cast<size_t>(e) * Step::kNv + i];
#pragma unroll
  for (int i = 0; i < Step::kNu; ++i) cv[i] = ctrl[static_cast<size_t>(e) * Step::kNu + i];
  Step::run(qv, vv, cv);
#pragma unroll
  for (int i = 0; i < Step::kNq; ++i) q_out[static_cast<size_t>(e) * Step::kNq + i] = qv[i];
#pragma unroll
  for (int i = 0; i < Step::kNv; ++i) qd_out[static_cast<size_t>(e) * Step::kNv + i] = vv[i];
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// never synchronises.
template <typename Step>
int launch(const float* q, const float* qd, const float* ctrl, float* q_out, float* qd_out,
           int n, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  step_kernel<Step><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      q, qd, ctrl, q_out, qd_out, n);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace art

// q (n, kNq), qd (n, kNv), ctrl (n, kNu), row-major float32; q_out and
// qd_out likewise. n >= 1.
#ifdef __CUDACC__
#define ART_ENTRY_POINTS(Step)                                                         \
  extern "C" int articulated_step_launch(const float* q, const float* qd,              \
                                         const float* ctrl, float* q_out,              \
                                         float* qd_out, int n, void* stream) {         \
    return art::launch<Step>(q, qd, ctrl, q_out, qd_out, n, stream);                   \
  }
#else
#define ART_ENTRY_POINTS(Step)                                                         \
  extern "C" void articulated_step_host(const float* q, const float* qd,               \
                                        const float* ctrl, float* q_out,               \
                                        float* qd_out, int n) {                        \
    art::step_host<Step>(q, qd, ctrl, q_out, qd_out, n);                               \
  }
#endif
