// The terrain kernel as it was before its redesign (one warp of 32 envs a
// block, the staging and the store by that warp alone), kept for
// tools/port_planar_probe.py terrain, which builds it beside the shipped
// gymnasium_tpu_torch/csrc/walker_terrain.cu and times both in turns. It is
// the earlier source, with clock64() stamps at each phase's end when built
// with WT_CLOCKS defined (each stamp after a __syncthreads, one between the
// walk and the overlay so that they are stamped apart); without it, the
// kernel as it was. Nothing else of the port builds it.

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WT_FN __host__ __device__ __forceinline__
#else
#define WT_FN inline
#endif

namespace walker_terrain {

#ifdef WT_CLOCKS
constexpr int kClockBlocks = 1024;
constexpr int kStamps = 5;  // the start, and the ends of the staging, the walk, the overlay and the store
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
  WT_STAMP(0);
  for (int k = threadIdx.x; k < envs * kLength; k += kBlock)
    rows[(k / kLength) * kPitch + k % kLength] = u[base + k];
  __syncthreads();
  WT_STAMP(1);
  const int t = threadIdx.x;
  if (t < envs) walk(rows + t * kPitch);
  WT_STAMP(2);
  if (t < envs && hardcore) overlay(rows + t * kPitch, draws + base + static_cast<size_t>(t) * kLength);
  __syncthreads();
  WT_STAMP(3);
  for (int k = threadIdx.x; k < envs * kLength; k += kBlock)
    out[base + k] = rows[(k / kLength) * kPitch + k % kLength];
  WT_STAMP(4);
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

#ifdef WT_CLOCKS
// Copies the first `count` stamps (kStamps a block) into `dst` on the host;
// returns the CUDA error code.
extern "C" int walker_terrain_clocks(long long* dst, int count) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, walker_terrain::clocks, sizeof(long long) * count));
}
#endif
#endif
