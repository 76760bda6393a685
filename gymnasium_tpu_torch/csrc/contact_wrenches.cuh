// Fixed part of the generated contact-wrench kernels.
//
// Replaces no TPU kernel: the JAX package computes the wrenches as plain jnp
// (gymnasium_tpu/physics/articulated.py, make_dynamics' contact_wrenches),
// which XLA fuses into a few loops. The port's eager form of the same
// formula was about 250 kernel launches a call, with (N, nc, nv, 3)
// intermediates in device memory: Ant's observation and reward, which take
// the wrenches twice an env step, spent most of the step's host and device
// time there. This kernel computes a call in one launch.
//
// gymnasium_tpu_torch/ops/articulated_codegen.py emits, per model, a struct
// with the widths kNq, kNv, the row kRow = 6 * nbody, the shared-memory
// stride kStride (kRow rounded up to odd) and the block kBlock, and a static
// run(q, qd, w) that holds the forward kinematics and the substep kernel's
// own contact forces (the same generator function, so the same formula and
// constants), one C statement per float operation, and writes the env's
// wrench row to w. The generated file includes this header and ends with
// CW_ENTRY_POINTS(struct). Under nvcc that defines the C launcher
// contact_wrenches_launch, loaded with ctypes, of the staged-row kernel
// rows::staged_kernel<ContactWrenches> (staged_rows.cuh: one thread an env,
// the rows staged through shared memory and stored coalesced into the
// (N, nbody, 6) output); under a plain C++ compiler the host loop
// contact_wrenches_host, so a test builds the same text with g++ and holds
// it against the plain PyTorch twin.
//
// Bound: an env reads (nq + nv) floats and writes 6 * nbody, 116 + 312 B for
// Ant: 28 MB at 65,536 envs, 8.4 us at 3.35 TB/s. Its arithmetic is 4,686
// float operations an env for Ant (the generator counts them; a sine or a
// cosine counts one), 9.2 us at 65,536 envs and 3.35e13 operations/s
// (-fmad=false): operations bound it, by a little. With one thread an env
// the registers hold the kinematics: on an H100, -Xptxas -v reads 215
// registers for Ant, 244 for Humanoid and 254 for HumanoidStandup, none
// spilled. The build uses precise sincosf/sqrtf, IEEE division and
// -fmad=false, so every operation rounds where the plain twin's does.

#pragma once

#include "staged_rows.cuh"

// The generated struct's run() is __host__ __device__ under nvcc.
#define CW_FN ROWS_FN

// q (n, kNq), qd (n, kNv), w (n, kRow), row-major float32. n >= 1.
#ifdef __CUDACC__
#define CW_ENTRY_POINTS(W)                                                              \
  extern "C" int contact_wrenches_launch(const float* q, const float* qd, float* w,     \
                                         int n, void* stream) {                         \
    return rows::launch<W>(q, qd, w, n, stream);                                        \
  }
#else
#define CW_ENTRY_POINTS(W)                                                              \
  extern "C" void contact_wrenches_host(const float* q, const float* qd, float* w,      \
                                        int n) {                                        \
    rows::host<W>(q, qd, w, n);                                                         \
  }
#endif
