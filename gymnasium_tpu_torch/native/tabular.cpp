// Native batched tabular-MDP stepper.
//
// Host-side counterpart of the device TabularFuncEnv: steps N tabular envs
// (dense [S, A, K] transition tensors, see
// gymnasium_tpu/envs/toy_text/tabular_core.py) in one call, replacing the
// Python per-env loop of SyncVectorEnv for toy-text workloads. Sampling is
// cumsum-compare over the K branches, identical semantics to
// categorical_sample; the caller supplies one uniform draw per env so RNG
// stays under Python's control (PCG64 parity preserved).
//
// Built at import time with g++ (see build.py); pure C ABI via ctypes.

#include <cstdint>

extern "C" {

// Advance N envs one step.
//   probs:      [S*A*K] float64 transition probabilities
//   next_state: [S*A*K] int32
//   reward:     [S*A*K] float64
//   term:       [S*A*K] uint8
//   states:     [N] int32, updated in place
//   actions:    [N] int32
//   uniforms:   [N] float64 — one uniform(0,1) draw per env
//   out_reward: [N] float64
//   out_term:   [N] uint8
void tabular_step_batch(const double *probs, const int32_t *next_state,
                        const double *reward, const uint8_t *term, int32_t S,
                        int32_t A, int32_t K, int32_t *states,
                        const int32_t *actions, const double *uniforms,
                        double *out_reward, uint8_t *out_term, int32_t N) {
  for (int32_t i = 0; i < N; ++i) {
    const int64_t base = ((int64_t)states[i] * A + actions[i]) * K;
    double cum = 0.0;
    int32_t k = 0;
    // argmax(cumsum(p) > u): first k whose cumulative probability exceeds u
    for (; k < K - 1; ++k) {
      cum += probs[base + k];
      if (cum > uniforms[i])
        break;
    }
    states[i] = next_state[base + k];
    out_reward[i] = reward[base + k];
    out_term[i] = term[base + k];
  }
}

// Roll out T steps for N envs with next-step autoreset, accumulating
// rewards.  reset_states: [N] initial-state draws used when an env restarts
// (refreshed by the caller between calls); uniforms: [T*N].
void tabular_rollout_batch(const double *probs, const int32_t *next_state,
                           const double *reward, const uint8_t *term,
                           int32_t S, int32_t A, int32_t K, int32_t *states,
                           uint8_t *prev_done, const int32_t *actions,
                           const double *uniforms,
                           const int32_t *reset_states, double *out_reward,
                           uint8_t *out_term, int32_t N, int32_t T) {
  for (int32_t t = 0; t < T; ++t) {
    const int32_t *act_t = actions + (int64_t)t * N;
    const double *u_t = uniforms + (int64_t)t * N;
    double *r_t = out_reward + (int64_t)t * N;
    uint8_t *d_t = out_term + (int64_t)t * N;
    for (int32_t i = 0; i < N; ++i) {
      if (prev_done[i]) {
        states[i] = reset_states[(int64_t)t * N + i];
        r_t[i] = 0.0;
        d_t[i] = 0;
        prev_done[i] = 0;
        continue;
      }
      const int64_t base = ((int64_t)states[i] * A + act_t[i]) * K;
      double cum = 0.0;
      int32_t k = 0;
      for (; k < K - 1; ++k) {
        cum += probs[base + k];
        if (cum > u_t[i])
          break;
      }
      states[i] = next_state[base + k];
      r_t[i] = reward[base + k];
      d_t[i] = term[base + k];
      prev_done[i] = term[base + k];
    }
  }
}

}  // extern "C"
