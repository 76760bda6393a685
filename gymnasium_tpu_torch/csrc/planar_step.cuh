// Fixed part of the generated planar (Box2D-class) solver kernels.
//
// Replaces gymnasium_tpu/ops/pallas_planar.py::make_fused_planar_step (body
// `kernel` :327, row program `substep_rows` :100, pallas_call :385). The TPU
// kernel lays 1024 envs out as (8, 128) row blocks and runs one program per
// block. Here each thread owns one env: it loads the env's 68 floats (18 body,
// 9 external, 11 terrain, 10 joint impulse, 20 contact impulse for the lander)
// into registers, runs `substeps` solver ticks of scalar code and stores 48
// floats and 10 contact flags. The flags are written as one byte
// each straight into the torch.bool output. Any N works; the last block is
// masked by a bounds check.
//
// gymnasium_tpu_torch/ops/planar_codegen.py emits, per (world, terrain,
// substeps), a struct with the widths kBodies, kJoints, kContacts, kChunks
// and a static run(body, ext, terrain, jimp, cimp, flags) that holds the whole
// call, one C statement per float operation of the JAX row program, in its
// order, with its float32 constants; the solver iterations are C loops. The
// generated file includes this header and ends with
// PLANAR_ENTRY_POINTS(struct). Under nvcc that defines the C launcher
// planar_step_launch, loaded with ctypes. Under a plain C++ compiler it
// defines the host loop planar_step_host instead, so a test can build the
// same text with g++ and hold it against the plain PyTorch twin.
//
// Bound: an env moves 474 B (68 floats in, 48 floats and 10 flag bytes out)
// and runs 15,085 float operations a call for the lander (the generator
// counts them), so operations bound it, at one float32 operation a lane a
// clock (-fmad=false): 1.85 us at N=4096 on an H100. The solver is one long
// dependent chain an env, and N=4096 is 128 warps, at most one a scheduler,
// so the chain's latency sets the time, not that bound.
//
// Design against that, measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/port_planar_probe.py): the first port unrolled all 8 velocity and 4
// position iterations, 20,760 SASS instructions (332 KB) a pass of the
// substep loop, more than an SM's instruction caches hold: about 5 clocks
// an instruction run. The generator now keeps each set of iterations as
// one C loop that is not unrolled, with its invariants hoisted, and takes
// each angle's sine and cosine from one sincosf (17 sites instead of 118):
// 4,344 SASS instructions (69 KB; loop bodies of 868 and 2,219), 148
// registers, no spills, the same bits, and 0.054 ms of device time a call
// instead of the first port's 0.116, at about 4 clocks an instruction.
// Blocks of 32 threads put the 128 warps on 128 SMs, one each: 0.054 ms,
// against 0.056 at 64 and 0.060 at 128 threads. Two envs a thread would
// give each scheduler two chains.
//
// The build uses precise sinf/cosf/sincosf, IEEE division and -fmad=false,
// so every operation rounds where the plain twin's does, and a contact flag
// (depth > 0) flips on the same inputs on both.

#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PLANAR_FN __host__ __device__ __forceinline__
#define PLANAR_NO_UNROLL _Pragma("unroll 1")
#else
#define PLANAR_FN inline
#define PLANAR_NO_UNROLL
#endif

namespace planar {

constexpr int kBlock = 32;  // threads a block

template <typename Step>
struct Widths {
  static constexpr int kBody = 6 * Step::kBodies;
  static constexpr int kExt = 3 * Step::kBodies;
  static constexpr int kJimp = Step::kJoints > 0 ? 5 * Step::kJoints : 1;
  static constexpr int kCimp = 2 * Step::kContacts;
};

// One env: load its rows, run the ticks, store its rows and flags.
template <typename Step>
PLANAR_FN void step_env(int e, const float* bodies, const float* ext, const float* terrain,
                        const float* jimp, const float* cimp, float* bodies_out,
                        float* jimp_out, float* cimp_out, bool* flags_out) {
  using W = Widths<Step>;
  float bv[W::kBody], ev[W::kExt], hv[Step::kChunks], jv[W::kJimp], cv[W::kCimp];
  bool fv[Step::kContacts];
  const size_t i = static_cast<size_t>(e);
#pragma unroll
  for (int k = 0; k < W::kBody; ++k) bv[k] = bodies[i * W::kBody + k];
#pragma unroll
  for (int k = 0; k < W::kExt; ++k) ev[k] = ext[i * W::kExt + k];
#pragma unroll
  for (int k = 0; k < Step::kChunks; ++k) hv[k] = terrain[i * Step::kChunks + k];
#pragma unroll
  for (int k = 0; k < 5 * Step::kJoints; ++k) jv[k] = jimp[i * 5 * Step::kJoints + k];
#pragma unroll
  for (int k = 0; k < W::kCimp; ++k) cv[k] = cimp[i * W::kCimp + k];
  Step::run(bv, ev, hv, jv, cv, fv);
#pragma unroll
  for (int k = 0; k < W::kBody; ++k) bodies_out[i * W::kBody + k] = bv[k];
#pragma unroll
  for (int k = 0; k < 5 * Step::kJoints; ++k) jimp_out[i * 5 * Step::kJoints + k] = jv[k];
#pragma unroll
  for (int k = 0; k < W::kCimp; ++k) cimp_out[i * W::kCimp + k] = cv[k];
#pragma unroll
  for (int k = 0; k < Step::kContacts; ++k) flags_out[i * Step::kContacts + k] = fv[k];
}

// The same run() on the host, env by env.
template <typename Step>
void step_host(const float* bodies, const float* ext, const float* terrain, const float* jimp,
               const float* cimp, float* bodies_out, float* jimp_out, float* cimp_out,
               bool* flags_out, int n) {
  for (int e = 0; e < n; ++e)
    step_env<Step>(e, bodies, ext, terrain, jimp, cimp, bodies_out, jimp_out, cimp_out,
                   flags_out);
}

#ifdef __CUDACC__
template <typename Step>
__global__ void __launch_bounds__(kBlock)
    step_kernel(const float* __restrict__ bodies, const float* __restrict__ ext,
                const float* __restrict__ terrain, const float* __restrict__ jimp,
                const float* __restrict__ cimp, float* __restrict__ bodies_out,
                float* __restrict__ jimp_out, float* __restrict__ cimp_out,
                bool* __restrict__ flags_out, int n) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= n) return;
  step_env<Step>(e, bodies, ext, terrain, jimp, cimp, bodies_out, jimp_out, cimp_out,
                 flags_out);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// never synchronises.
template <typename Step>
int launch(const float* bodies, const float* ext, const float* terrain, const float* jimp,
           const float* cimp, float* bodies_out, float* jimp_out, float* cimp_out,
           bool* flags_out, int n, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  step_kernel<Step><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      bodies, ext, terrain, jimp, cimp, bodies_out, jimp_out, cimp_out, flags_out, n);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace planar

// bodies (n, kBodies, 6), ext (n, kBodies, 3), terrain (n, kChunks), jimp
// (n, kJoints, 5), cimp (n, kContacts, 2), row-major float32; the outputs
// likewise, and flags (n, kContacts) as one byte each (torch.bool). n >= 1.
#ifdef __CUDACC__
#define PLANAR_ENTRY_POINTS(Step)                                                         \
  extern "C" int planar_step_launch(const float* bodies, const float* ext,               \
                                    const float* terrain, const float* jimp,             \
                                    const float* cimp, float* bodies_out,                \
                                    float* jimp_out, float* cimp_out, bool* flags_out,   \
                                    int n, void* stream) {                               \
    return planar::launch<Step>(bodies, ext, terrain, jimp, cimp, bodies_out, jimp_out,  \
                                cimp_out, flags_out, n, stream);                         \
  }
#else
#define PLANAR_ENTRY_POINTS(Step)                                                         \
  extern "C" void planar_step_host(const float* bodies, const float* ext,                \
                                   const float* terrain, const float* jimp,              \
                                   const float* cimp, float* bodies_out, float* jimp_out, \
                                   float* cimp_out, bool* flags_out, int n) {            \
    planar::step_host<Step>(bodies, ext, terrain, jimp, cimp, bodies_out, jimp_out,      \
                            cimp_out, flags_out, n);                                     \
  }
#endif
