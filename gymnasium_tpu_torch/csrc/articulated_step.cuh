// Fixed part of the generated articulated (MuJoCo-class) substep kernels.
//
// Replaces gymnasium_tpu/ops/pallas_articulated.py::make_fused_step (body
// `kernel` :512, pallas_call :563). The TPU kernel lays 1024 envs out as
// (8, 128) row blocks and runs one program per block.
//
// gymnasium_tpu_torch/ops/articulated_codegen.py emits, per (model,
// frame_skip), a struct with the widths kNq, kNv, kNu and a static run that
// holds the whole step, one C statement per float operation of the JAX row
// program, in its order, with its float32 constants. The generated file
// includes this header and ends with ART_ENTRY_POINTS(struct) or
// ART_PARTS_ENTRY_POINTS(struct). Under nvcc that defines the C launcher
// articulated_step_launch, loaded with ctypes. Under a plain C++ compiler it
// defines the host loop articulated_step_host instead, so a test can build
// the same text with g++ and hold it against the plain PyTorch twin before
// any card sees it. Any N works.
//
// Bound: an env reads (nq + nv + nu) floats and writes (nq + nv), 168 B for
// HalfCheetah, while it runs several thousand float operations a substep
// (the generator counts them). So operations bound it, at one float32
// operation a lane a clock (-fmad=false: no add or multiply is fused). Far
// from that bound, the time is set by how long a group of envs takes to
// walk its substep: tens of thousands of dependent instructions for the
// largest robots, and by what the SMs share while they walk it (instruction
// fetch and spills through L2).
//
// Two layouts; the generator picks one for each robot by its layout model
// (ops/warp_partition.py::layout_clocks, fitted to the card), together with
// kParts and kGroups:
//
// - One thread an env (ART_ENTRY_POINTS, run(q, qd, ctrl)): each thread
//   loads q, qd and ctrl into registers, runs frame_skip substeps of
//   straight-line code and stores q', qd'. N=4096 gives only 128 warps, one
//   a scheduler on 32 SMs. Blocks of 128 threads keep the four warps that
//   share an SM on one copy of the instruction stream.
// - Warp-specialised (ART_PARTS_ENTRY_POINTS, run<part>(q, qd, ctrl, x)):
//   kParts warps share a group of 32 envs, lane l of every warp being env l,
//   and warp p runs partition p of each substep's operations (the generator
//   makes the partition: ops/warp_partition.py). Partitions exchange values
//   through the group's shared memory, slot s of env l at [s * 32 + l], so a
//   warp's 32 lanes hit 32 banks; between phases the group's warps meet at
//   their own named barrier (bar.sync 1 + group, 32 * kParts). A block holds
//   kGroups groups. N=4096 then gives 128 * kParts warps over up to 128
//   SMs, and each walks about a kParts-th of the substep. The values carried
//   from one substep to the next end each substep in slots 0 .. kNq + kNv - 1,
//   from which the group's threads store q' and qd' at the end, coalesced.
//   Recomputed operations and the shared-memory traffic are overhead, not
//   work: the bound counts each distinct operation once.
//
// A group's partitions spread over the blocks of a thread-block cluster,
// exchanging through distributed shared memory, ran slower than one block on
// every robot measured (Humanoid 0.4872 ms at best against 0.3349 in one
// block of 8 warps on an H100: PERF.md), so no layout uses clusters.
//
// The build uses precise sinf/cosf/sqrtf, IEEE division and -fmad=false, so
// every operation rounds where the plain twin's does, in either layout.

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

// A block of a partitioned run<kPart> guarded by ART_PART(p) belongs to
// partition p: on the card run<p> keeps only its own blocks, and the host's
// run<-1> keeps them all, so it runs each phase's partitions in order.
#define ART_PART(p) (kPart < 0 || kPart == (p))

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

// The sine and cosine of one angle from one sincosf, for the partitioned
// text. On the card it is a call: one copy of sincosf's code, its slow path
// for large angles included, that every angle shares, where an inline copy
// at each angle would lengthen the substep's straight-line code.
// The same function, so the same bits.
struct SinCos {
  float s, c;
};
#ifdef __CUDA_ARCH__
__device__ __noinline__ SinCos sin_cos(float x) {
  SinCos r;
  sincosf(x, &r.s, &r.c);
  return r;
}
#else
inline SinCos sin_cos(float x) {
  SinCos r;
  sincosf(x, &r.s, &r.c);
  return r;
}
#endif

// The exchange buffer of one env on the host, for run<-1>.
struct HostExchange {
  float* base;
  float& operator[](int slot) const { return base[slot]; }
  void sync() const {}
};

// One env's partitioned step on the host: every partition of every phase in
// turn; the new q and qd end in the first kNq + kNv slots.
template <typename Step>
void parts_host(const float* q, const float* qd, const float* ctrl, float* q_out,
                float* qd_out, int n) {
  for (int e = 0; e < n; ++e) {
    float qv[Step::kNq], vv[Step::kNv], cv[Row<Step>::kNuPad], xs[Step::kSlots];
    for (int i = 0; i < Step::kNq; ++i) qv[i] = q[static_cast<size_t>(e) * Step::kNq + i];
    for (int i = 0; i < Step::kNv; ++i) vv[i] = qd[static_cast<size_t>(e) * Step::kNv + i];
    for (int i = 0; i < Step::kNu; ++i) cv[i] = ctrl[static_cast<size_t>(e) * Step::kNu + i];
    HostExchange x{xs};
    Step::template run<-1>(qv, vv, cv, x);
    for (int i = 0; i < Step::kNq; ++i) q_out[static_cast<size_t>(e) * Step::kNq + i] = xs[i];
    for (int i = 0; i < Step::kNv; ++i) qd_out[static_cast<size_t>(e) * Step::kNv + i] = xs[Step::kNq + i];
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

// The exchange buffer of one group of 32 envs on the card.
struct GroupExchange {
  float* base;  // the group's kSlots * 32 floats
  int lane;
  int barrier;  // the group's named barrier, 1 + its index in the block
  int threads;  // 32 * kParts
  ART_FN float& operator[](int slot) const { return base[slot * 32 + lane]; }
  ART_FN void sync() const {
#ifdef __CUDA_ARCH__
    asm volatile("bar.sync %0, %1;" ::"r"(barrier), "r"(threads) : "memory");
#endif
  }
};

// run<part>, with the warp's part known only at run time: each warp takes
// one branch, so no warp diverges inside a partition.
template <typename Step, int kPart = 0>
__device__ __forceinline__ void run_part(int part, const float* q, const float* qd,
                                         const float* ctrl, GroupExchange& x) {
  if constexpr (kPart < Step::kParts) {
    if (part == kPart) {
      Step::template run<kPart>(q, qd, ctrl, x);
    } else {
      run_part<Step, kPart + 1>(part, q, qd, ctrl, x);
    }
  }
}

template <typename Step>
__global__ void __launch_bounds__(32 * Step::kParts * Step::kGroups)
    parts_kernel(const float* __restrict__ q, const float* __restrict__ qd,
                 const float* __restrict__ ctrl, float* __restrict__ q_out,
                 float* __restrict__ qd_out, int n) {
  extern __shared__ float exchange[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / Step::kParts, part = warp % Step::kParts;
  const int first = (blockIdx.x * Step::kGroups + group) * 32;  // the group's first env
  // A lane past the end steps the last env and stores nothing: it still
  // reaches every barrier of its group.
  const int e = first + lane < n ? first + lane : n - 1;
  float qv[Step::kNq], vv[Step::kNv], cv[Row<Step>::kNuPad];
#pragma unroll
  for (int i = 0; i < Step::kNq; ++i) qv[i] = q[static_cast<size_t>(e) * Step::kNq + i];
#pragma unroll
  for (int i = 0; i < Step::kNv; ++i) vv[i] = qd[static_cast<size_t>(e) * Step::kNv + i];
#pragma unroll
  for (int i = 0; i < Step::kNu; ++i) cv[i] = ctrl[static_cast<size_t>(e) * Step::kNu + i];
  float* xs = exchange + static_cast<size_t>(group) * Step::kSlots * 32;
  GroupExchange x{xs, lane, 1 + group, 32 * Step::kParts};
  run_part<Step>(part, qv, vv, cv, x);
  // After run's last barrier the first kNq + kNv slots hold the group's q'
  // and qd'; its threads store the group's rows, which lie side by side.
  const int envs = n - first < 32 ? n - first : 32;
  for (int j = part * 32 + lane; j < envs * Step::kNq; j += 32 * Step::kParts)
    q_out[static_cast<size_t>(first) * Step::kNq + j] = xs[(j % Step::kNq) * 32 + j / Step::kNq];
  for (int j = part * 32 + lane; j < envs * Step::kNv; j += 32 * Step::kParts)
    qd_out[static_cast<size_t>(first) * Step::kNv + j] =
        xs[(Step::kNq + j % Step::kNv) * 32 + j / Step::kNv];
}

template <typename Step>
int parts_launch(const float* q, const float* qd, const float* ctrl, float* q_out,
                 float* qd_out, int n, void* stream) {
  constexpr int kEnvs = 32 * Step::kGroups;
  constexpr int kShared = static_cast<int>(sizeof(float)) * 32 * Step::kSlots * Step::kGroups;
  if (kShared > 48 * 1024) {  // above 48 KB a block must ask for its shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        parts_kernel<Step>, cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  parts_kernel<Step><<<(n + kEnvs - 1) / kEnvs, 32 * Step::kParts * Step::kGroups, kShared,
                       static_cast<cudaStream_t>(stream)>>>(q, qd, ctrl, q_out, qd_out, n);
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
#define ART_PARTS_ENTRY_POINTS(Step)                                                   \
  extern "C" int articulated_step_launch(const float* q, const float* qd,              \
                                         const float* ctrl, float* q_out,              \
                                         float* qd_out, int n, void* stream) {         \
    return art::parts_launch<Step>(q, qd, ctrl, q_out, qd_out, n, stream);             \
  }
#else
#define ART_ENTRY_POINTS(Step)                                                         \
  extern "C" void articulated_step_host(const float* q, const float* qd,               \
                                        const float* ctrl, float* q_out,               \
                                        float* qd_out, int n) {                        \
    art::step_host<Step>(q, qd, ctrl, q_out, qd_out, n);                               \
  }
#define ART_PARTS_ENTRY_POINTS(Step)                                                   \
  extern "C" void articulated_step_host(const float* q, const float* qd,               \
                                        const float* ctrl, float* q_out,               \
                                        float* qd_out, int n) {                        \
    art::parts_host<Step>(q, qd, ctrl, q_out, qd_out, n);                              \
  }
#endif
