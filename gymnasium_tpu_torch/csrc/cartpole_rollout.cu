// Fused CartPole-v1 rollout: `num_steps` auto-resetting steps of N
// environments under a uniform random policy, in one kernel launch.
//
// Replaces gymnasium_tpu/ops/pallas_rollout.py::_rollout_kernel (the Pallas
// TPU kernel behind cartpole_rollout_fused). The TPU kernel runs a sequential
// grid over steps and carries the (4, N) state in VMEM scratch from one grid
// step to the next. GPU blocks run in no order, so nothing carries between
// blocks here: each thread owns one environment, keeps its state in
// registers, and runs the whole step loop itself.
//
// Semantics (as the TPU kernel and gymnasium_tpu.functional.make_autoreset_step):
// explicit-Euler Florian ODE; NEXT_STEP autoreset (a lane that was done
// ignores the transition, takes its reset state, reward 0, both flags
// False, step counter 0); terminated = |x| > x_threshold or
// |theta| > theta_threshold; truncated = not terminated and
// steps >= time_limit; reward 1 otherwise.
//
// Random numbers: the TPU's on-core PRNG has no CUDA counterpart. Each
// env-step draws one Philox4x32-10 block keyed on the seed and counted on
// (env, step, 0, 0). The action is the lowest bit of word 0; reset component
// i is the top 24 bits of word i times 2^-24, mapped to
// (u * 2 - 1) * reset_bound. A lane uses either its action (no reset) or its
// reset values (reset step), never both, so sharing word 0 costs no
// independence. The plain version in gymnasium_tpu_torch/ops/cartpole_rollout.py
// reproduces these draws bit for bit.
//
// Bound: the function must write 16 B obs + 4 B reward + 1 B terminated +
// 1 B truncated = 22 B per env-step (14 B with bf16 obs). At N=4096, S=2048
// that is 184.5 MB, about 55 us at the H100's 3.35 TB/s (with bf16 obs the
// Philox integer operations bound it, at about 49 us). Stores are coalesced
// for free: obs[s, c, n] has n contiguous and neighbouring threads own
// neighbouring envs.
//
// What sets the time instead, measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, tools/port_planar_probe.py): only N threads are live, 128
// warps at N=4096, one a scheduler at most, and each runs 2048 steps as one
// dependent chain. The loop body is 310 SASS instructions, about 200 of them
// on a step's usual path, at about 4 clocks each. The design keeps what it
// can off that chain. A draw depends on (env, step) alone, so step s + 1's
// Philox block is drawn during step s, where the compiler interleaves it
// with the range reduction of sincosf; one sincosf replaces sinf and cosf;
// the reset values are selected after the transition instead of branching
// around it (the compiler still skips their block when no lane of a warp is
// done). 0.80 ms a call, from 0.91; blocks of 32, 64 and 128 threads take
// the same time. Taken back one at a time (the probe's ablations), sinf and
// cosf cost 0.06 ms, the draw at the top of its step and the branch under
// 0.01 ms each: the compiler already overlapped the draw. What is left on
// the chain: four IEEE divides, each behind its slow-path call, which the
// compiler neither overlaps nor keeps the constants in registers across.
//
// The build uses precise sinf/cosf/sincosf and -fmad=false (no FMA
// contraction) so that every float operation rounds where the plain version's
// does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // threads a block; 32 and 128 take as long at N=4096

struct Constants {
  float gravity;
  float masspole;
  float total_mass;
  float polemass_length;
  float length;
  float force_mag;
  float tau;
  float theta_threshold;
  float x_threshold;
  float reset_bound;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kW0;
    k1 += kW1;
  }
  return c;
}

__device__ __forceinline__ float reset_value(uint32_t bits, float bound) {
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
  return (u * 2.0f - 1.0f) * bound;
}

template <typename ObsT>
__device__ __forceinline__ ObsT to_obs(float v);
template <>
__device__ __forceinline__ float to_obs<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_obs<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename ObsT>
__global__ void __launch_bounds__(kBlock) cartpole_rollout_kernel(
    const float* __restrict__ state, const int32_t* __restrict__ steps,
    const bool* __restrict__ prev_done, float* __restrict__ final_state,
    int32_t* __restrict__ final_steps, bool* __restrict__ final_done,
    ObsT* __restrict__ obs, float* __restrict__ reward, bool* __restrict__ term,
    bool* __restrict__ trunc, int n, int num_steps, uint32_t seed,
    int time_limit, Constants p) {
  const int e = blockIdx.x * kBlock + threadIdx.x;
  if (e >= n) return;

  float x = state[e], x_dot = state[n + e];
  float theta = state[2 * n + e], theta_dot = state[3 * n + e];
  int32_t t = steps[e];
  bool done = prev_done[e];

  // A draw depends on (env, step) alone, so step s + 1's block is drawn
  // while step s runs: its Philox rounds overlap the physics.
  uint4 r = philox4x32_10(make_uint4(e, 0u, 0u, 0u), seed, 0u);
  for (int s = 0; s < num_steps; ++s) {
    const uint4 r_next = philox4x32_10(make_uint4(e, s + 1, 0u, 0u), seed, 0u);

    // The transition runs on every lane, in the operation order of
    // envs/dynamics/cartpole.py::accelerations; a lane that was done then
    // takes its reset state instead. No branch holds the trig and the
    // divides back.
    const float force = (r.x & 1u) ? p.force_mag : -p.force_mag;
    float sintheta, costheta;
    sincosf(theta, &sintheta, &costheta);
    const float temp =
        (force + p.polemass_length * (theta_dot * theta_dot) * sintheta) / p.total_mass;
    const float thetaacc =
        (p.gravity * sintheta - costheta * temp) /
        (p.length * (4.0f / 3.0f - p.masspole * (costheta * costheta) / p.total_mass));
    const float xacc = temp - p.polemass_length * thetaacc * costheta / p.total_mass;
    const float nx = x + p.tau * x_dot;
    const float nx_dot = x_dot + p.tau * xacc;
    const float ntheta = theta + p.tau * theta_dot;
    const float ntheta_dot = theta_dot + p.tau * thetaacc;
    x = done ? reset_value(r.x, p.reset_bound) : nx;
    x_dot = done ? reset_value(r.y, p.reset_bound) : nx_dot;
    theta = done ? reset_value(r.z, p.reset_bound) : ntheta;
    theta_dot = done ? reset_value(r.w, p.reset_bound) : ntheta_dot;
    t = done ? 0 : t + 1;

    const bool te =
        !done && (fabsf(x) > p.x_threshold || fabsf(theta) > p.theta_threshold);
    const bool tr = !done && !te && t >= time_limit;

    const size_t o = static_cast<size_t>(s) * 4 * n + e;
    obs[o] = to_obs<ObsT>(x);
    obs[o + n] = to_obs<ObsT>(x_dot);
    obs[o + 2 * static_cast<size_t>(n)] = to_obs<ObsT>(theta);
    obs[o + 3 * static_cast<size_t>(n)] = to_obs<ObsT>(theta_dot);
    const size_t f = static_cast<size_t>(s) * n + e;
    reward[f] = done ? 0.0f : 1.0f;
    term[f] = te;
    trunc[f] = tr;
    done = te || tr;
    r = r_next;
  }

  final_state[e] = x;
  final_state[n + e] = x_dot;
  final_state[2 * n + e] = theta;
  final_state[3 * n + e] = theta_dot;
  final_steps[e] = t;
  final_done[e] = done;
}

}  // namespace

// C entry point, loaded with ctypes. `constants` points to 10 host floats in
// the order of `Constants`. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int cartpole_rollout_launch(
    const float* state, const int32_t* steps, const bool* prev_done,
    float* final_state, int32_t* final_steps, bool* final_done, void* obs,
    float* reward, bool* term, bool* trunc, int n, int num_steps, int seed,
    int time_limit, int obs_bf16, const float* constants, void* stream) {
  Constants p;
  p.gravity = constants[0];
  p.masspole = constants[1];
  p.total_mass = constants[2];
  p.polemass_length = constants[3];
  p.length = constants[4];
  p.force_mag = constants[5];
  p.tau = constants[6];
  p.theta_threshold = constants[7];
  p.x_threshold = constants[8];
  p.reset_bound = constants[9];

  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t key = static_cast<uint32_t>(seed);
  if (obs_bf16) {
    cartpole_rollout_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        state, steps, prev_done, final_state, final_steps, final_done,
        static_cast<__nv_bfloat16*>(obs), reward, term, trunc, n, num_steps,
        key, time_limit, p);
  } else {
    cartpole_rollout_kernel<float><<<grid, block, 0, s>>>(
        state, steps, prev_done, final_state, final_steps, final_done,
        static_cast<float*>(obs), reward, term, trunc, n, num_steps, key,
        time_limit, p);
  }
  return static_cast<int>(cudaGetLastError());
}
