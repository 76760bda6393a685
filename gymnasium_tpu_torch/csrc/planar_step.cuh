// Fixed part of the generated planar (Box2D-class) solver kernels.
//
// Replaces gymnasium_tpu/ops/pallas_planar.py::make_fused_planar_step (body
// `kernel` :327, row program `substep_rows` :100, pallas_call :385). The TPU
// kernel lays 1024 envs out as (8, 128) row blocks and runs one program per
// block. Here an env's whole call runs in registers: `substeps` solver ticks
// of scalar code over its body rows, external forces, joint and contact
// impulses and motor inputs where the world has them, storing the bodies, the
// impulses it carries and one contact flag byte each straight into the
// torch.bool output. Any N works.
//
// gymnasium_tpu_torch/ops/planar_codegen.py emits, per (world, terrain,
// substeps), a struct with the widths kBodies, kJoints, kContacts, kChunks
// and a static run() that holds the whole call, one C statement per float
// operation of the program, with its float32 constants; the solver
// iterations are C loops. A struct may declare its parts (kExternal,
// kJointCarry, kMotors; Parts below): a world with per-env motors
// (BipedalWalker) takes them as inputs, and a world whose env carries no
// joint impulses or applies no external force has no such rows. The file
// includes this header and ends with PLANAR_ENTRY_POINTS(struct). Under nvcc
// that defines the C launcher planar_step_launch, loaded with ctypes; under
// a plain C++ compiler the host loop planar_step_host, so a test can build
// the same text with g++ and hold it against the plain PyTorch twin. A
// pointer to a part the world lacks may be null.
//
// Two layouts, one emitter:
//
// - One thread an env (no kLanes; step_kernel): run(body, ext, terrain,
//   jimp, cimp, flags[, motors]) on the env's rows copied into registers.
// - A group of kLanes lanes of one warp an env (lane_step_kernel), 32 /
//   kLanes envs a warp: body b and its contact probes on lane b, each joint
//   on a lane of one of its bodies. The generator places the tick's units
//   (a body, a probe, a joint) in phases of one shape, so every lane runs the
//   same statements on its own operands: the velocity and position sweeps
//   run body by body side by side, each body's updates in the twin's order.
//   What one lane reads of another's values goes through __shfl_sync within
//   the group; per-lane constants are selected once a call. The PL_ macros
//   below write each statement once: on the card a value is a lane's
//   register; on the host an array over the lanes, each statement run for
//   every lane in turn, so the g++ build reproduces the card's exchanges.
//   A lane past the last env steps the last env again and stores nothing:
//   every lane of a warp reaches every shuffle. Where the struct declares
//   kStageTerrain, the group copies the env's heightfield into shared memory
//   before the first tick.
//
// Bound: the lander's env moves 474 B and runs 15,085 float operations a
// call, the walker's (4 ticks of 12 velocity and 8 position iterations, 19
// probes, per-env motors, no joint impulse rows) 1,395 B and 80,624, so
// operations bound both, at one float32 operation a lane a clock
// (-fmad=false): 0.0018 and 0.0097 ms at N=4096 on an H100. The solver is a
// long dependent chain an env, so the chain's latency, not that bound, sets
// the time.
//
// Design against that, measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/port_planar_probe.py, its `lanes` sweep for the group layout):
// the first port unrolled the iterations, 20,760 SASS instructions (332 KB)
// a pass for the lander, more than an SM's instruction caches hold; rolled
// C loops with one sincosf an angle took it from 0.116 to 0.054 ms. One
// thread an env still gives N=4096 only 128 warps, one on each of 128 SMs,
// each walking the whole chain: the walker's build took 0.418 ms (225
// registers, 8,240 SASS instructions), 0.372 at N=1. A lane a body runs the
// probes of five bodies side by side and joints that share no body
// together: 37 phases a tick, the schedule's estimate 46,072 clocks against
// 103,736. Measured: 0.149 ms at N=4096 and 0.122 at N=1 (8 lanes, 166
// registers, no spills, 3,592 SASS instructions), 0.148 with the row
// staged; 16 lanes put four warps on a scheduler and took 0.305. The
// lander's three bodies take 4 lanes: 0.0448 ms against 0.0547 at N=4096.
// Shuffles beat the shared-memory exchange (0.1490 against 0.1543 ms), and
// 32, 64 and 128 threads a block differ by under 1 %.
//
// The build uses precise sinf/cosf/sincosf, IEEE division and -fmad=false,
// and every lane computes the same operation on the same operands as the
// one-thread form, so every value rounds where the plain twin's does and a
// contact flag (depth > 0) flips on the same inputs on both.

#pragma once

#include <math.h>
#include <stddef.h>

#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PLANAR_FN __host__ __device__ __forceinline__
#define PLANAR_NO_UNROLL _Pragma("unroll 1")
#else
#define PLANAR_FN inline
#define PLANAR_NO_UNROLL
#endif

// The statements of a run() laid over kLanes lanes. On the card each lane
// is a thread and a value one register; PL_SHFL reads a value of another
// lane of the group. On the host every value is an array over the lanes,
// and each statement runs for lane l = 0 .. kLanes - 1 in turn before the
// next one starts, which is when the card's lanes meet at a shuffle.
#ifdef __CUDACC__
#define PL_LANE lane
#define PL_V(x) (x)
#define PL_LET(T, x, e) const T x = (e)
#define PL_VAR(T, x, e) T x = (e)
#define PL_SET(x, e) x = (e)
#define PL_SINCOS(x, a) \
  float x##s, x##c;     \
  sincosf((a), &x##s, &x##c)
#define PL_SHFL(x, s) planar::lane_get<kLanes>((x), (s))
#define PL_STORE(p, dst, v) \
  if (store && (p)) dst = (v)
#else
#define PL_LANE l
#define PL_V(x) (x)[l]
#define PL_LET(T, x, e) \
  T x[kLanes];          \
  for (int l = 0; l < kLanes; ++l) x[l] = (e)
#define PL_VAR(T, x, e) PL_LET(T, x, e)
#define PL_SET(x, e) \
  for (int l = 0; l < kLanes; ++l) x[l] = (e)
#define PL_SINCOS(x, a)                 \
  float x##s[kLanes], x##c[kLanes];     \
  for (int l = 0; l < kLanes; ++l) sincosf((a), &x##s[l], &x##c[l])
#define PL_SHFL(x, s) (x)[s]
#define PL_STORE(p, dst, v) \
  for (int l = 0; l < kLanes; ++l) \
    if (p) dst = (v)
#endif

namespace planar {

constexpr int kBlock = 32;  // threads a block

// The parts of a world's call. A struct that declares none is the lander's
// form: external forces and joint impulses in, joint impulses out, motors
// folded into the program.
template <typename Step, typename = void>
struct Parts {
  static constexpr bool kExternal = true;
  static constexpr bool kJointCarry = true;
  static constexpr bool kMotors = false;
};

template <typename Step>
struct Parts<Step, std::void_t<decltype(Step::kMotors)>> {
  static constexpr bool kExternal = Step::kExternal;
  static constexpr bool kJointCarry = Step::kJointCarry;
  static constexpr bool kMotors = Step::kMotors;
};

template <typename Step>
struct Widths {
  using P = Parts<Step>;
  static constexpr int kBody = 6 * Step::kBodies;
  static constexpr int kExt = P::kExternal ? 3 * Step::kBodies : 0;
  static constexpr int kJimp = P::kJointCarry ? 5 * Step::kJoints : 0;
  static constexpr int kCimp = 2 * Step::kContacts;
  static constexpr int kMotor = P::kMotors ? Step::kJoints : 0;
};

// How the generated struct lays an env over lanes: kLanes lanes of a warp
// an env (1: one thread). A group of lanes copies the env's terrain row into
// shared memory before the solver reads it where the struct declares
// kStageTerrain.
template <typename Step, typename = void>
struct Lanes {
  static constexpr int kLanes = 1;
};

template <typename Step>
struct Lanes<Step, std::void_t<decltype(Step::kLanes)>> {
  static constexpr int kLanes = Step::kLanes;
};

template <typename Step, typename = void>
struct Stage {
  static constexpr bool kStage = false;
};

template <typename Step>
struct Stage<Step, std::void_t<decltype(Step::kStageTerrain)>> {
  static constexpr bool kStage = Step::kStageTerrain;
};

// Value v of lane src of the caller's group of kLanes lanes. Every lane of
// the warp calls it at the same point of the same code.
template <int kLanes, typename T>
PLANAR_FN T lane_get(T v, int src) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same_v<T, bool>) {
    return __shfl_sync(0xffffffffu, static_cast<int>(v), src, kLanes) != 0;
  } else {
    return __shfl_sync(0xffffffffu, v, src, kLanes);
  }
#else
  (void)src;
  return v;
#endif
}

// A register array of n floats; one unused float where n is 0.
template <int n>
struct Regs {
  float v[n > 0 ? n : 1];
};

// One env: load its rows, run the ticks, store its rows and flags.
template <typename Step>
PLANAR_FN void step_env(int e, const float* bodies, const float* ext, const float* terrain,
                        const float* jimp, const float* cimp, const float* motor_speed,
                        const float* motor_torque, float* bodies_out, float* jimp_out,
                        float* cimp_out, bool* flags_out) {
  using W = Widths<Step>;
  Regs<W::kBody> bv;
  Regs<W::kExt> ev;
  Regs<W::kJimp> jv;
  Regs<W::kCimp> cv;
  Regs<2 * W::kMotor> mv;
  bool fv[Step::kContacts];
  const size_t i = static_cast<size_t>(e);
#pragma unroll
  for (int k = 0; k < W::kBody; ++k) bv.v[k] = bodies[i * W::kBody + k];
#pragma unroll
  for (int k = 0; k < W::kExt; ++k) ev.v[k] = ext[i * W::kExt + k];
#pragma unroll
  for (int k = 0; k < W::kJimp; ++k) jv.v[k] = jimp[i * W::kJimp + k];
#pragma unroll
  for (int k = 0; k < W::kCimp; ++k) cv.v[k] = cimp[i * W::kCimp + k];
#pragma unroll
  for (int k = 0; k < W::kMotor; ++k) {
    mv.v[k] = motor_speed[i * W::kMotor + k];
    mv.v[W::kMotor + k] = motor_torque[i * W::kMotor + k];
  }
  const float* row = terrain + i * Step::kChunks;
  if constexpr (Parts<Step>::kMotors) {
    Step::run(bv.v, ev.v, row, jv.v, cv.v, fv, mv.v);
  } else {
    Step::run(bv.v, ev.v, row, jv.v, cv.v, fv);
  }
#pragma unroll
  for (int k = 0; k < W::kBody; ++k) bodies_out[i * W::kBody + k] = bv.v[k];
#pragma unroll
  for (int k = 0; k < W::kJimp; ++k) jimp_out[i * W::kJimp + k] = jv.v[k];
#pragma unroll
  for (int k = 0; k < W::kCimp; ++k) cimp_out[i * W::kCimp + k] = cv.v[k];
#pragma unroll
  for (int k = 0; k < Step::kContacts; ++k) flags_out[i * Step::kContacts + k] = fv[k];
}

// One env over kLanes lanes, lane `lane` of its group: run() reads the env's
// rows and stores its lanes' share of the outputs where `store`.
template <typename Step>
PLANAR_FN void step_lanes(size_t i, int lane, bool store, const float* bodies, const float* ext,
                          const float* row, const float* jimp, const float* cimp,
                          const float* motor_speed, const float* motor_torque, float* bodies_out,
                          float* jimp_out, float* cimp_out, bool* flags_out) {
  using W = Widths<Step>;
  Step::run(bodies + i * W::kBody, ext + i * W::kExt, row, jimp + i * W::kJimp, cimp + i * W::kCimp,
            motor_speed + i * W::kMotor, motor_torque + i * W::kMotor, bodies_out + i * W::kBody,
            jimp_out + i * W::kJimp, cimp_out + i * W::kCimp, flags_out + i * Step::kContacts, lane,
            store);
}

// The same run() on the host, env by env. A layout of several lanes runs
// them in lockstep inside run(): each statement for every lane in turn (the
// PL_ macros below), so a lane reads another's value where the card's
// shuffle would.
template <typename Step>
void step_host(const float* bodies, const float* ext, const float* terrain, const float* jimp,
               const float* cimp, const float* motor_speed, const float* motor_torque,
               float* bodies_out, float* jimp_out, float* cimp_out, bool* flags_out, int n) {
  for (int e = 0; e < n; ++e) {
    if constexpr (Lanes<Step>::kLanes > 1) {
      const size_t i = static_cast<size_t>(e);
      step_lanes<Step>(i, 0, true, bodies, ext, terrain + i * Step::kChunks, jimp, cimp,
                       motor_speed, motor_torque, bodies_out, jimp_out, cimp_out, flags_out);
    } else {
      step_env<Step>(e, bodies, ext, terrain, jimp, cimp, motor_speed, motor_torque, bodies_out,
                     jimp_out, cimp_out, flags_out);
    }
  }
}

#ifdef __CUDACC__
template <typename Step>
__global__ void __launch_bounds__(kBlock)
    step_kernel(const float* __restrict__ bodies, const float* __restrict__ ext,
                const float* __restrict__ terrain, const float* __restrict__ jimp,
                const float* __restrict__ cimp, const float* __restrict__ motor_speed,
                const float* __restrict__ motor_torque, float* __restrict__ bodies_out,
                float* __restrict__ jimp_out, float* __restrict__ cimp_out,
                bool* __restrict__ flags_out, int n) {
  static_assert(!Stage<Step>::kStage, "a terrain row is staged by a group of lanes");
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= n) return;
  step_env<Step>(e, bodies, ext, terrain, jimp, cimp, motor_speed, motor_torque, bodies_out,
                 jimp_out, cimp_out, flags_out);
}

// kLanes threads an env: thread t of the grid is lane t % kLanes of env
// t / kLanes. A thread past the last env steps the last env again and
// stores nothing, so every lane of a warp reaches every shuffle.
template <typename Step>
__global__ void __launch_bounds__(kBlock)
    lane_step_kernel(const float* __restrict__ bodies, const float* __restrict__ ext,
                 const float* __restrict__ terrain, const float* __restrict__ jimp,
                 const float* __restrict__ cimp, const float* __restrict__ motor_speed,
                 const float* __restrict__ motor_torque, float* __restrict__ bodies_out,
                 float* __restrict__ jimp_out, float* __restrict__ cimp_out,
                 bool* __restrict__ flags_out, int n) {
  constexpr int G = Lanes<Step>::kLanes;
  static_assert(kBlock % G == 0, "a block holds whole groups");
  const int t = blockIdx.x * kBlock + threadIdx.x;
  const int e = t / G, lane = t % G;
  const size_t i = static_cast<size_t>(e < n ? e : n - 1);
  const float* row = terrain + i * Step::kChunks;
  if constexpr (Stage<Step>::kStage) {
    __shared__ float rows[kBlock / G][Step::kChunks];
    float* mine = rows[threadIdx.x / G];
    for (int c = lane; c < Step::kChunks; c += G) mine[c] = row[c];
    __syncwarp();
    row = mine;
  }
  step_lanes<Step>(i, lane, e < n, bodies, ext, row, jimp, cimp, motor_speed, motor_torque,
                   bodies_out, jimp_out, cimp_out, flags_out);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// never synchronises.
template <typename Step>
int launch(const float* bodies, const float* ext, const float* terrain, const float* jimp,
           const float* cimp, const float* motor_speed, const float* motor_torque,
           float* bodies_out, float* jimp_out, float* cimp_out, bool* flags_out, int n,
           void* stream) {
  constexpr int G = Lanes<Step>::kLanes;
  const dim3 grid((static_cast<long long>(n) * G + kBlock - 1) / kBlock), block(kBlock);
  if constexpr (G > 1) {
    lane_step_kernel<Step><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        bodies, ext, terrain, jimp, cimp, motor_speed, motor_torque, bodies_out, jimp_out,
        cimp_out, flags_out, n);
  } else {
    step_kernel<Step><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        bodies, ext, terrain, jimp, cimp, motor_speed, motor_torque, bodies_out, jimp_out,
        cimp_out, flags_out, n);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace planar

// bodies (n, kBodies, 6), ext (n, kBodies, 3), terrain (n, kChunks), jimp
// (n, kJoints, 5), cimp (n, kContacts, 2), motor_speed and motor_torque (n,
// kJoints), row-major float32; the outputs likewise, and flags (n,
// kContacts) as one byte each (torch.bool). n >= 1.
#ifdef __CUDACC__
#define PLANAR_ENTRY_POINTS(Step)                                                          \
  extern "C" int planar_step_launch(                                                      \
      const float* bodies, const float* ext, const float* terrain, const float* jimp,     \
      const float* cimp, const float* motor_speed, const float* motor_torque,             \
      float* bodies_out, float* jimp_out, float* cimp_out, bool* flags_out, int n,        \
      void* stream) {                                                                      \
    return planar::launch<Step>(bodies, ext, terrain, jimp, cimp, motor_speed,            \
                                motor_torque, bodies_out, jimp_out, cimp_out, flags_out,  \
                                n, stream);                                                \
  }
#else
#define PLANAR_ENTRY_POINTS(Step)                                                          \
  extern "C" void planar_step_host(                                                       \
      const float* bodies, const float* ext, const float* terrain, const float* jimp,     \
      const float* cimp, const float* motor_speed, const float* motor_torque,             \
      float* bodies_out, float* jimp_out, float* cimp_out, bool* flags_out, int n) {      \
    planar::step_host<Step>(bodies, ext, terrain, jimp, cimp, motor_speed, motor_torque,  \
                            bodies_out, jimp_out, cimp_out, flags_out, n);                \
  }
#endif
