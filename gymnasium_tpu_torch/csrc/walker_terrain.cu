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
// launches a reset.
//
// Bound: an env reads 200 floats (u) and writes 200, plus 22 obstacle draws
// in hardcore mode; 6 to 8 float operations a point of the walk, 1,558 in
// all. It is bytes-bound at N=4096 (6.6 MB moved, about 2 us at 3.35 TB/s),
// but each env's 200 points form one dependent chain. Its first form, one
// warp of 32 envs a block, took 0.0233 ms at N=4096: clock64() stamps put a
// block's 45k clocks in the walk (22k, about 110 a point, an IEEE divide
// inside the loop) and in one warp staging and storing 6,400 floats (17k and
// 6k).
//
// Design: a block of kEnvs = 8 envs runs kThreads = 200 threads, thread c
// owning column c of the block's rows. It loads its column of the 8 rows at
// once (coalesced across the block; in hardcore mode also its window's two
// draws a row, all in flight together) and divides each step by SCALE (one
// IEEE divide, off the walk's chain). Then one thread an env (lanes of the
// first warp) walks its row in shared memory with y and v in registers; the
// sign term makes the recurrence non-linear, so it is no parallel scan. Rows
// are padded to 201 floats, so the walkers reading column i of their rows
// hit different banks. Last, thread c adds its obstacle heights and stores
// column c of every row, coalesced. At N=4096 the 512 blocks put about four
// on each SM, whose stagings, walks and stores overlap. It takes 0.0053 ms
// (0.0059 hardcore), 37 % of the bound: a block's 8.4k clocks are the
// walk's 5.4k (27 a point, the chain that now sets the time), the staging's
// 2.1k and the store's 0.8k. At 32, 16 and 4 envs a block it took 0.0064,
// 0.0061 and 0.0054 ms; unrolling the walk by 4, or computing v's three
// candidates before the comparison picks one, made the walk slower (6.3k and
// 6.5k clocks) (tools/port_planar_probe.py terrain; NVIDIA H100 80GB HBM3,
// 700 W).
//
// Built with -fmad=false and IEEE division, so every operation rounds where
// the plain twin's (ops/walker_terrain.py) does. Under a plain C++ compiler
// the file defines the host loop walker_terrain_host instead of the launcher,
// so a test can build it with g++ and hold it against the twin. A build with
// WT_CLOCKS defined (tools/port_planar_probe.py terrain) stamps clock64() at
// each phase's end into a device table that walker_terrain_clocks reads.

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
constexpr int kWindow = 6;        // heights an obstacle window covers
constexpr int kEnvs = 8;          // envs a block, walked by lanes of the first warp
constexpr int kThreads = kLength; // a thread a column for the loads and stores
constexpr int kPitch = kLength + 1;
// float32 roundings of the python constants
constexpr float kHeight = 3.33333325f;  // TERRAIN_HEIGHT = 400 / 30 / 4
constexpr float kScale = 30.0f;         // SCALE
constexpr float kStep = 0.466666669f;   // TERRAIN_STEP = 14 / 30

// The recurrence over one env's row, in place: steps u / SCALE in, heights
// out. 0.01 sign(kHeight - y) is taken from the comparisons of y with
// kHeight: kHeight - y is positive, negative or +0 exactly when y is below,
// above or equal to it, and 0.01f times 1, -1 or +0 is 0.01f, -0.01f or +0.
WT_FN void walk(float* row) {
  float y = kHeight, v = 0.0f;
  for (int i = 0; i <= kStartPad; ++i) {
    v = 0.8f * v + (y < kHeight ? 0.01f : (y > kHeight ? -0.01f : 0.0f));
    y = y + v;
    row[i] = y;
  }
  for (int i = kStartPad + 1; i < kLength; ++i) {
    v = 0.8f * v + (y < kHeight ? 0.01f : (y > kHeight ? -0.01f : 0.0f));
    v = v + row[i];
    y = y + v;
    row[i] = y;
  }
}

// The start of the obstacle window that covers column c, or -1.
WT_FN int window_start(int c) {
  if (c < kFirstWindow || c >= kWindowEnd) return -1;
  const int k = (c - kFirstWindow) % kWindowStride;
  return k < kWindow ? c - k : -1;
}

// The height an obstacle of draws d_type, d_size adds at offset k of its window.
WT_FN float obstacle(float d_type, float d_size, int k) {
  const float stump = (1.0f + 2.0f * d_size) * kStep;
  const float pit = -(2.0f + 2.0f * d_size) * kStep;
  const float stair = static_cast<float>(k / 2) * kStep;
  return d_type < 0.33f ? (k < 2 ? stump : 0.0f) : d_type < 0.66f ? stair : (k < 2 ? pit : 0.0f);
}

#ifdef __CUDACC__
#ifdef WT_CLOCKS
constexpr int kClockBlocks = 1024;
constexpr int kStamps = 4;  // the start, and the ends of the staging, the walk and the store
__device__ long long clocks[kClockBlocks * kStamps];
#define WT_STAMP(k)                                                        \
  do {                                                                     \
    __syncthreads();                                                       \
    if (threadIdx.x == 0 && blockIdx.x < kClockBlocks)                     \
      clocks[blockIdx.x * kStamps + (k)] = clock64();                      \
  } while (0)
#else
#define WT_STAMP(k) \
  do {              \
  } while (0)
#endif

__global__ void __launch_bounds__(kThreads)
    terrain_kernel(const float* __restrict__ u, const float* __restrict__ draws,
                   float* __restrict__ out, int n, int hardcore) {
  __shared__ float rows[kEnvs * kPitch];
  const int first = blockIdx.x * kEnvs;
  const int envs = min(kEnvs, n - first);
  const int c = threadIdx.x;
  const size_t column = static_cast<size_t>(first) * kLength + c;
  WT_STAMP(0);
  // every load of the thread first, all in flight at once: each one
  // predicated on its row, none waiting on another's value
  const int s = hardcore ? window_start(c) : -1;
  float step[kEnvs], kind[kEnvs], size[kEnvs], rise[kEnvs];
#pragma unroll
  for (int r = 0; r < kEnvs; ++r) step[r] = r < envs ? u[column + r * kLength] : 0.0f;
  if (s >= 0) {
    const float* window = draws + (column - c + s);
#pragma unroll
    for (int r = 0; r < kEnvs; ++r) {
      kind[r] = r < envs ? window[r * kLength] : 0.0f;
      size[r] = r < envs ? window[r * kLength + 1] : 0.0f;
    }
  }
#pragma unroll
  for (int r = 0; r < kEnvs; ++r)
    if (r < envs) rows[r * kPitch + c] = step[r] / kScale;
  if (s >= 0) {
#pragma unroll
    for (int r = 0; r < kEnvs; ++r) rise[r] = obstacle(kind[r], size[r], c - s);
  }
  __syncthreads();
  WT_STAMP(1);
  if (c < envs) walk(rows + c * kPitch);
  __syncthreads();
  WT_STAMP(2);
#pragma unroll
  for (int r = 0; r < kEnvs; ++r) {
    if (r < envs) {
      const float h = rows[r * kPitch + c];
      out[column + r * kLength] = s >= 0 ? h + rise[r] : h;
    }
  }
  WT_STAMP(3);
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
  const dim3 grid((n + kEnvs - 1) / kEnvs), block(kThreads);
  terrain_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(u, draws, out, n,
                                                                        hardcore);
  return static_cast<int>(cudaGetLastError());
}
#ifdef WT_CLOCKS
// Copies the first `count` stamps (kStamps a block) into `dst` on the host;
// returns the CUDA error code.
extern "C" int walker_terrain_clocks(long long* dst, int count) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, walker_terrain::clocks, sizeof(long long) * count));
}
#endif
#else
extern "C" void walker_terrain_host(const float* u, const float* draws, float* out, int n,
                                    int hardcore) {
  using namespace walker_terrain;
  for (int e = 0; e < n; ++e) {
    float* row = out + static_cast<size_t>(e) * kLength;
    const float* drawn = draws + static_cast<size_t>(e) * kLength;
    for (int i = 0; i < kLength; ++i) row[i] = u[static_cast<size_t>(e) * kLength + i] / kScale;
    walk(row);
    for (int c = 0; hardcore && c < kLength; ++c) {
      const int s = window_start(c);
      if (s >= 0) row[c] = row[c] + obstacle(drawn[s], drawn[s + 1], c - s);
    }
  }
}
#endif
