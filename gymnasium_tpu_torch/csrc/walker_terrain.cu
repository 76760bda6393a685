// BipedalWalker's terrain: the 200-point heightfield of each env's reset.
//
// Port-only kernel: the JAX package computes it with a lax.scan inside
// envs/box2d/bipedal_walker.py::generate_terrain (:218-260) and adds the
// hardcore obstacles with _overlay_obstacles (:263-290); no TPU kernel
// replaces it. Semantics, per env, in float32:
//
//   y = TERRAIN_HEIGHT, v = 0
//   for i in 0..199:  v = 0.8 v + 0.01 sign(TERRAIN_HEIGHT - y)
//                     v += [i > 20] u_i / SCALE;  y += v;  out_i = y
//
// then, in hardcore mode, for each window start s = 30, 45, ..., 180 with
// d = draws[s], e = draws[s + 1]: a stump (d < 0.33) raises out[s], out[s+1]
// by (1 + 2e) TERRAIN_STEP; stairs (d < 0.66) raise out[s..s+5] by 0, 0, 1,
// 1, 2, 2 TERRAIN_STEP; a pit lowers out[s], out[s+1] by (2 + 2e)
// TERRAIN_STEP. Each height gets every add of the JAX code (a zero where the
// window does not cover it), in its order.
//
// Why a kernel: the functional autoreset draws a reset for the whole batch on
// every env step, and the recurrence is sequential: about 1,400 eager torch
// launches a reset. Here one thread owns one env and keeps y and v in
// registers. A block of 32 envs stages its 32 x 200 draws in shared memory
// with coalesced loads, each thread overwrites its row with the heights, and
// the block stores the rows back coalesced. Rows are padded to 201 floats,
// so the 32 threads reading column i of their rows hit 32 different banks.
//
// Bound: an env reads 200 floats (u) and writes 200, plus 22 obstacle draws
// in hardcore mode; 6 to 8 float operations a point of the walk, 1,558 in
// all. It is bytes-bound at N=4096 (6.6 MB moved, about 2 us at 3.35 TB/s),
// but each thread's 200 points form one dependent chain of about 1,200
// operations. Measured on an NVIDIA H100 80GB HBM3 at 700 W: 0.025 ms a call
// at N=4096 (chip_smoke.py), about 250 clocks a point. Moving the divisions
// into the staging loop doubled it; dividing each row in place before the
// walk, or unrolling the walk, left it at 0.025 ms, so the walk's chain is
// not what sets the time.
//
// Built with -fmad=false and IEEE division, so every operation rounds where
// the plain twin's (ops/walker_terrain.py) does. Under a plain C++ compiler
// the file defines the host loop walker_terrain_host instead of the launcher,
// so a test can build it with g++ and hold it against the twin.

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WT_FN __host__ __device__ __forceinline__
#else
#define WT_FN inline
#endif

namespace walker_terrain {

constexpr int kLength = 200;      // TERRAIN_LENGTH
constexpr int kStartPad = 20;     // TERRAIN_STARTPAD
constexpr int kFirstWindow = 30;  // TERRAIN_STARTPAD + 10
constexpr int kWindowStride = 15;
constexpr int kWindowEnd = kLength - 10;
constexpr int kBlock = 32;  // envs (threads) a block
constexpr int kPitch = kLength + 1;
// float32 roundings of the python constants
constexpr float kHeight = 3.33333325f;  // TERRAIN_HEIGHT = 400 / 30 / 4
constexpr float kScale = 30.0f;         // SCALE
constexpr float kStep = 0.466666669f;   // TERRAIN_STEP = 14 / 30

WT_FN float sign(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

// The recurrence over one env's row, in place: draws in, heights out.
WT_FN void walk(float* row) {
  float y = kHeight, v = 0.0f;
  for (int i = 0; i < kLength; ++i) {
    v = 0.8f * v + 0.01f * sign(kHeight - y);
    if (i > kStartPad) v = v + row[i] / kScale;
    y = y + v;
    row[i] = y;
  }
}

// The hardcore obstacles of one env, added to its heights; `draws` is the
// env's row of 200 U[0, 1) draws.
WT_FN void overlay(float* row, const float* draws) {
  for (int s = kFirstWindow; s < kWindowEnd; s += kWindowStride) {
    const float d_type = draws[s], d_size = draws[s + 1];
    const float stump = (1.0f + 2.0f * d_size) * kStep;
    const float pit = -(2.0f + 2.0f * d_size) * kStep;
    for (int k = 0; k < 6; ++k) {
      const float stair = static_cast<float>(k / 2) * kStep;
      const float delta = d_type < 0.33f ? (k < 2 ? stump : 0.0f)
                          : d_type < 0.66f ? stair
                                           : (k < 2 ? pit : 0.0f);
      row[s + k] = row[s + k] + delta;
    }
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kBlock)
    terrain_kernel(const float* __restrict__ u, const float* __restrict__ draws,
                   float* __restrict__ out, int n, int hardcore) {
  __shared__ float rows[kBlock * kPitch];
  const int first = blockIdx.x * kBlock;
  const int envs = min(kBlock, n - first);
  const size_t base = static_cast<size_t>(first) * kLength;
  for (int k = threadIdx.x; k < envs * kLength; k += kBlock)
    rows[(k / kLength) * kPitch + k % kLength] = u[base + k];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < envs) {
    float* row = rows + t * kPitch;
    walk(row);
    if (hardcore) overlay(row, draws + base + static_cast<size_t>(t) * kLength);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < envs * kLength; k += kBlock)
    out[base + k] = rows[(k / kLength) * kPitch + k % kLength];
}
#endif

}  // namespace walker_terrain

// u and draws (n, 200) row-major float32, u in [-1, 1) and draws in [0, 1)
// (read only when hardcore is nonzero); out (n, 200). n >= 1.
#ifdef __CUDACC__
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// never synchronises.
extern "C" int walker_terrain_launch(const float* u, const float* draws, float* out, int n,
                                     int hardcore, void* stream) {
  using namespace walker_terrain;
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  terrain_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(u, draws, out, n,
                                                                        hardcore);
  return static_cast<int>(cudaGetLastError());
}
#else
extern "C" void walker_terrain_host(const float* u, const float* draws, float* out, int n,
                                    int hardcore) {
  using namespace walker_terrain;
  for (int e = 0; e < n; ++e) {
    float* row = out + static_cast<size_t>(e) * kLength;
    for (int i = 0; i < kLength; ++i) row[i] = u[static_cast<size_t>(e) * kLength + i];
    walk(row);
    if (hardcore) overlay(row, draws + static_cast<size_t>(e) * kLength);
  }
}
#endif
