// Native scenario generation for player-selection datasets.
//
// C++ counterpart of the reference's Python scenario sampler
// (scripts/data_generation.py:20-47): rejection-sample N player start
// positions and goals with a pairwise minimum-separation constraint, plus
// uniform initial velocities. The Python loop is O(tries · N²) per scenario
// and dominates dataset generation at large scenario counts; this native
// path generates millions of scenarios per second and is exposed to Python
// through a minimal C ABI (ctypes — no pybind11 in this toolchain).
//
// Determinism: splitmix64-seeded xoshiro256++ per scenario stream, so
// generation is reproducible and parallelizable by seed.

#include <cstdint>
#include <cmath>
#include <cstddef>

namespace {

struct Xoshiro256pp {
  uint64_t s[4];

  explicit Xoshiro256pp(uint64_t seed) {
    // splitmix64 initialization
    for (int i = 0; i < 4; ++i) {
      seed += 0x9e3779b97f4a7c15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }

  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  inline uint64_t next() {
    const uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }

  // uniform double in [lo, hi)
  inline double uniform(double lo, double hi) {
    const double u = (next() >> 11) * 0x1.0p-53;  // [0, 1)
    return lo + u * (hi - lo);
  }
};

// Sample `n` 2-D points in [-hw, hw]² with pairwise distance >= min_sep.
// Returns false if no valid configuration found within max_tries.
bool sample_separated(Xoshiro256pp& rng, int n, double hw, double min_sep,
                      double* out /* n*2 */, int max_tries) {
  const double min_sep2 = min_sep * min_sep;
  for (int attempt = 0; attempt < max_tries; ++attempt) {
    for (int i = 0; i < n; ++i) {
      out[2 * i] = rng.uniform(-hw, hw);
      out[2 * i + 1] = rng.uniform(-hw, hw);
    }
    bool ok = true;
    for (int i = 0; i < n && ok; ++i) {
      for (int j = i + 1; j < n; ++j) {
        const double dx = out[2 * i] - out[2 * j];
        const double dy = out[2 * i + 1] - out[2 * j + 1];
        if (dx * dx + dy * dy < min_sep2) {
          ok = false;
          break;
        }
      }
    }
    if (ok) return true;
  }
  return false;
}

}  // namespace

extern "C" {

// Generate `num_scenarios` scenarios of `num_players` agents.
// out_states: num_scenarios * num_players * 4 doubles (px, py, vx, vy)
// out_goals:  num_scenarios * num_players * 2 doubles (gx, gy)
// Returns the number of successfully generated scenarios.
int mcp_generate_scenarios(int num_scenarios, int num_players,
                           double arena_half_width, double min_separation,
                           double max_speed, uint64_t seed,
                           double* out_states, double* out_goals) {
  int generated = 0;
  const int max_tries = 10000;
  for (int k = 0; k < num_scenarios; ++k) {
    Xoshiro256pp rng(seed * 0x9e3779b97f4a7c15ULL + (uint64_t)k);
    double* states = out_states + (size_t)generated * num_players * 4;
    double* goals = out_goals + (size_t)generated * num_players * 2;

    double starts[2 * 64];
    if (num_players > 64) return generated;  // fixed stack bound
    if (!sample_separated(rng, num_players, arena_half_width, min_separation,
                          starts, max_tries))
      continue;
    if (!sample_separated(rng, num_players, arena_half_width, min_separation,
                          goals, max_tries))
      continue;
    for (int i = 0; i < num_players; ++i) {
      states[4 * i] = starts[2 * i];
      states[4 * i + 1] = starts[2 * i + 1];
      states[4 * i + 2] = rng.uniform(-max_speed, max_speed);
      states[4 * i + 3] = rng.uniform(-max_speed, max_speed);
    }
    ++generated;
  }
  return generated;
}

}  // extern "C"
