// Fixed part of the generated centre-of-mass kernels.
//
// Replaces no TPU kernel: the JAX package computes the bodies' centre-of-mass
// velocities as a forward derivative (jax.jvp) of make_dynamics' com_world
// along integrate_pos, and the Humanoid's mass centre from com_world, both
// plain jnp that XLA fuses (gymnasium_tpu/envs/mujoco/humanoid.py). The
// port's eager form of the same was a torch.func.jvp of about 800 kernel
// launches a call and about 220 for the mass centre: the Humanoid's
// observation takes the velocities once an env step and its reward the mass
// centre twice, and together they held most of the step's host time, with
// the card idle. This header makes each call one launch.
//
// gymnasium_tpu_torch/ops/articulated_codegen.py emits, per model, two
// structs over the forward kinematics the substep kernel runs (the same
// generator function, so the same formula and constants), one C statement
// per float operation:
// - ComVelocity: the widths kNq, kNv, the row kRow = 3 * nbody, the
//   shared-memory stride kStride (kRow rounded up to odd) and the block
//   kBlock, and a static run(q, qd, v) that writes the env's velocity row;
// - MassCenterX: kNq, kBlock and a static run(q) that returns the env's
//   mass centre along x.
// The generated file includes this header and ends with
// COM_ENTRY_POINTS(ComVelocity, MassCenterX). Under nvcc that defines the C
// launchers com_velocity_launch and mass_center_x_launch, loaded with
// ctypes; under a plain C++ compiler the host loops com_velocity_host and
// mass_center_x_host, so a test builds the same text with g++ and holds it
// against the plain PyTorch twin.
//
// Layout: one thread an env, the kinematics in registers, no value passed
// between threads. The velocities are the contact wrenches' staged-row
// kernel, rows::staged_kernel<ComVelocity> (staged_rows.cuh): each thread's
// row staged through shared memory at an odd stride, the block's rows
// stored coalesced into the (N, nbody, 3) output. The mass-centre kernel,
// com::mass_center_kernel<MassCenterX>, stores its one float an env
// directly: a warp's 32 stores are already side by side.
//
// Bound, Humanoid at 65,536 envs: the velocities read (nq + nv) = 47 floats
// an env and write 39, 22.5 MB, 6.7 us at 3.35 TB/s, against 2,709 float
// operations an env (the generator counts them; a sine or a cosine counts
// one), 5.3 us at 3.35e13 operations/s (-fmad=false): bytes bound it. The
// mass centre reads 24 floats and writes 1, 6.6 MB, 2.0 us, against 475
// operations, 0.9 us. The build uses precise sincosf, IEEE division and
// -fmad=false, so every operation rounds where the plain twin's does.

#pragma once

#include "staged_rows.cuh"

// The generated structs' run()s are __host__ __device__ under nvcc.
#define COM_FN ROWS_FN

namespace com {

// Every env's mass centre on the host: the same run() as the kernel's.
template <typename M>
void mass_center_host(const float* q, float* x, int n) {
  for (int e = 0; e < n; ++e) x[e] = M::run(q + static_cast<size_t>(e) * M::kNq);
}

#ifdef __CUDACC__
template <typename M>
__global__ void __launch_bounds__(M::kBlock)
    mass_center_kernel(const float* __restrict__ q, float* __restrict__ x, int n) {
  const int e = blockIdx.x * M::kBlock + static_cast<int>(threadIdx.x);
  if (e < n) x[e] = M::run(q + static_cast<size_t>(e) * M::kNq);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// never synchronises.
template <typename M>
int launch_mass_center(const float* q, float* x, int n, void* stream) {
  mass_center_kernel<M><<<(n + M::kBlock - 1) / M::kBlock, M::kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(q, x, n);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace com

// q (n, kNq), qd (n, kNv), v (n, kRow), x (n,), row-major float32. n >= 1.
#ifdef __CUDACC__
#define COM_ENTRY_POINTS(V, M)                                                           \
  extern "C" int com_velocity_launch(const float* q, const float* qd, float* v, int n,   \
                                     void* stream) {                                     \
    return rows::launch<V>(q, qd, v, n, stream);                                         \
  }                                                                                      \
  extern "C" int mass_center_x_launch(const float* q, float* x, int n, void* stream) {   \
    return com::launch_mass_center<M>(q, x, n, stream);                                  \
  }
#else
#define COM_ENTRY_POINTS(V, M)                                                           \
  extern "C" void com_velocity_host(const float* q, const float* qd, float* v, int n) {  \
    rows::host<V>(q, qd, v, n);                                                          \
  }                                                                                      \
  extern "C" void mass_center_x_host(const float* q, float* x, int n) {                  \
    com::mass_center_host<M>(q, x, n);                                                   \
  }
#endif
