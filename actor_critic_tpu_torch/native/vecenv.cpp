// Native batched environment engine (first-party C++ runtime component).
//
// The reference's env stepping bottoms out in native dependency code —
// MuJoCo's C physics and ALE's C++ emulator under gym (SURVEY.md §2.2;
// reference mount empty at survey, §0). This is the build's first-party
// equivalent for the classic-control family: the WHOLE env batch steps
// in one C call (dynamics, reward, termination, SAME_STEP auto-reset),
// removing the Python per-env loop from the host hot path that matters
// on this 1-core host (SURVEY.md §7.2 item 2).
//
// Dynamics are exact gymnasium semantics — CartPole-v1 (Euler
// integration, 12deg/2.4m termination, 500-step limit), Pendulum-v1
// (clipped torque, 200 steps), MountainCarContinuous-v0 (inelastic left
// wall, +100 goal bonus minus raw-action penalty, 999 steps), and
// Acrobot-v1 (book dynamics, one RK4 step of dt=0.2, ±4π/±9π velocity
// clips, 500 steps) — so trainers can swap backends without re-tuning.
// Layout: row-major; state is float64 (gymnasium computes these envs in
// float64 — except MountainCar, whose float32 per-op arithmetic is
// emulated op-for-op in mountaincar_step) and observations float32.
//
// Built standalone:
//   g++ -O3 -ffp-contract=off -shared -fPIC vecenv.cpp -o _vecenv.so
// (-ffp-contract=off is load-bearing: FMA contraction breaks the
// bit-parity contract — see native/__init__.py. The Python side
// builds+caches automatically.)

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// splitmix64 — tiny, seedable, good enough for env-reset jitter.
inline uint64_t next_u64(uint64_t* s) {
  uint64_t z = (*s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

inline float uniform(uint64_t* s, float lo, float hi) {
  // 24-bit mantissa uniform in [0,1)
  float u = (float)(next_u64(s) >> 40) * (1.0f / 16777216.0f);
  return lo + u * (hi - lo);
}

constexpr float kPi = 3.14159265358979323846f;
constexpr double kPiD = 3.14159265358979323846;  // double-precision math

// ---- CartPole-v1 ---------------------------------------------------------
constexpr double kGravity = 9.8;
constexpr double kMassCart = 1.0;
constexpr double kMassPole = 0.1;
constexpr double kTotalMass = kMassCart + kMassPole;
constexpr double kLength = 0.5;  // half pole length
constexpr double kPoleMassLength = kMassPole * kLength;
constexpr double kForceMag = 10.0;
constexpr double kTau = 0.02;
constexpr double kThetaThreshold = 12.0 * 2.0 * 3.14159265358979323846 / 360.0;
constexpr double kXThreshold = 2.4;

inline void cartpole_reset_one(double* st, uint64_t* rng) {
  for (int k = 0; k < 4; ++k) st[k] = uniform(rng, -0.05f, 0.05f);
}

inline void obs_from_state(const double* st, float* obs, int d) {
  for (int k = 0; k < d; ++k) obs[k] = (float)st[k];
}

// ---- Pendulum-v1 ---------------------------------------------------------
constexpr double kPendG = 10.0;
constexpr double kPendM = 1.0;
constexpr double kPendL = 1.0;
constexpr double kPendDt = 0.05;
constexpr double kMaxSpeed = 8.0;
constexpr double kMaxTorque = 2.0;

inline double angle_normalize(double x) {
  const double pi = 3.14159265358979323846;
  double y = std::fmod(x + pi, 2.0 * pi);
  if (y < 0) y += 2.0 * pi;
  return y - pi;
}

inline void pendulum_reset_one(double* st, uint64_t* rng) {
  st[0] = uniform(rng, -kPi, kPi);   // theta
  st[1] = uniform(rng, -1.0f, 1.0f); // theta_dot
}

inline void pendulum_obs(const double* st, float* obs) {
  obs[0] = (float)std::cos(st[0]);
  obs[1] = (float)std::sin(st[0]);
  obs[2] = (float)st[1];
}

// ---- MountainCarContinuous-v0 -------------------------------------------
constexpr double kMcMinPos = -1.2;
constexpr double kMcMaxPos = 0.6;
constexpr double kMcMaxSpeed = 0.07;
constexpr double kMcGoalPos = 0.45;
constexpr double kMcGoalVel = 0.0;
constexpr double kMcPower = 0.0015;

inline void mountaincar_reset_one(double* st, uint64_t* rng) {
  st[0] = uniform(rng, -0.6f, -0.4f);  // position
  st[1] = 0.0;                         // velocity
}

// ---- Acrobot-v1 ----------------------------------------------------------
// Double-pendulum swing-up, gymnasium's "book" dynamics (Sutton & Barto),
// RK4-integrated with one dt=0.2 step, velocities clipped to ±4π/±9π.
constexpr double kAcDt = 0.2;
constexpr double kAcM1 = 1.0, kAcM2 = 1.0;   // link masses
constexpr double kAcL1 = 1.0;                // link 1 length
constexpr double kAcLc1 = 0.5, kAcLc2 = 0.5; // link COM positions
constexpr double kAcI1 = 1.0, kAcI2 = 1.0;   // moments of inertia
constexpr double kAcG = 9.8;
constexpr double kAcMaxVel1 = 4.0 * kPiD;
constexpr double kAcMaxVel2 = 9.0 * kPiD;

inline void acrobot_reset_one(double* st, uint64_t* rng) {
  for (int k = 0; k < 4; ++k) st[k] = uniform(rng, -0.1f, 0.1f);
}

inline void acrobot_obs(const double* st, float* obs) {
  obs[0] = (float)std::cos(st[0]);
  obs[1] = (float)std::sin(st[0]);
  obs[2] = (float)std::cos(st[1]);
  obs[3] = (float)std::sin(st[1]);
  obs[4] = (float)st[2];
  obs[5] = (float)st[3];
}

// ds/dt of the torque-augmented state (gymnasium Acrobot._dsdt, book eqs).
inline void acrobot_dsdt(const double* s, double torque, double* ds) {
  const double th1 = s[0], th2 = s[1], dth1 = s[2], dth2 = s[3];
  const double d1 =
      kAcM1 * kAcLc1 * kAcLc1 +
      kAcM2 * (kAcL1 * kAcL1 + kAcLc2 * kAcLc2 +
               2.0 * kAcL1 * kAcLc2 * std::cos(th2)) +
      kAcI1 + kAcI2;
  const double d2 =
      kAcM2 * (kAcLc2 * kAcLc2 + kAcL1 * kAcLc2 * std::cos(th2)) + kAcI2;
  const double phi2 =
      kAcM2 * kAcLc2 * kAcG * std::cos(th1 + th2 - kPiD / 2.0);
  const double phi1 =
      -kAcM2 * kAcL1 * kAcLc2 * dth2 * dth2 * std::sin(th2) -
      2.0 * kAcM2 * kAcL1 * kAcLc2 * dth2 * dth1 * std::sin(th2) +
      (kAcM1 * kAcLc1 + kAcM2 * kAcL1) * kAcG * std::cos(th1 - kPiD / 2.0) +
      phi2;
  const double ddth2 =
      (torque + d2 / d1 * phi1 -
       kAcM2 * kAcL1 * kAcLc2 * dth1 * dth1 * std::sin(th2) - phi2) /
      (kAcM2 * kAcLc2 * kAcLc2 + kAcI2 - d2 * d2 / d1);
  const double ddth1 = -(d2 * ddth2 + phi1) / d1;
  ds[0] = dth1;
  ds[1] = dth2;
  ds[2] = ddth1;
  ds[3] = ddth2;
}

inline double wrap_pi(double x) {
  // gymnasium wrap(x, -π, π)
  const double diff = 2.0 * kPiD;
  while (x > kPiD) x -= diff;
  while (x < -kPiD) x += diff;
  return x;
}

// One RK4 step of size kAcDt on the 4-state with constant torque
// (gymnasium's rk4 over t=[0, 0.2]; the augmented torque slot has zero
// derivative, so it is simply threaded through).
inline void acrobot_rk4(double* st, double torque) {
  double k1[4], k2[4], k3[4], k4[4], tmp[4];
  acrobot_dsdt(st, torque, k1);
  for (int k = 0; k < 4; ++k) tmp[k] = st[k] + 0.5 * kAcDt * k1[k];
  acrobot_dsdt(tmp, torque, k2);
  for (int k = 0; k < 4; ++k) tmp[k] = st[k] + 0.5 * kAcDt * k2[k];
  acrobot_dsdt(tmp, torque, k3);
  for (int k = 0; k < 4; ++k) tmp[k] = st[k] + kAcDt * k3[k];
  acrobot_dsdt(tmp, torque, k4);
  for (int k = 0; k < 4; ++k)
    st[k] += kAcDt / 6.0 * (k1[k] + 2.0 * k2[k] + 2.0 * k3[k] + k4[k]);
}

}  // namespace

extern "C" {

// state: [n,4] float64 (gymnasium precision); obs out: [n,4] float32
void cartpole_reset(double* state, float* obs, int n, uint64_t* rng,
                    int32_t* steps) {
  for (int i = 0; i < n; ++i) {
    cartpole_reset_one(state + 4 * i, rng);
    obs_from_state(state + 4 * i, obs + 4 * i, 4);
    steps[i] = 0;
  }
}

// One synchronous batch step with SAME_STEP auto-reset: where an episode
// ends, final_obs keeps the ending observation and obs/state hold the
// freshly reset episode (mirrors gymnasium.vector SAME_STEP semantics,
// which envs/host_pool.py already normalizes trainers against).
void cartpole_step(double* state, const int64_t* action, int n, uint64_t* rng,
                   int32_t* steps, int32_t max_steps, float* obs,
                   float* reward, uint8_t* terminated, uint8_t* truncated,
                   float* final_obs) {
  for (int i = 0; i < n; ++i) {
    double* st = state + 4 * i;
    const double force = action[i] == 1 ? kForceMag : -kForceMag;
    const double x = st[0], x_dot = st[1], th = st[2], th_dot = st[3];
    const double costh = std::cos(th);
    const double sinth = std::sin(th);
    const double temp =
        (force + kPoleMassLength * th_dot * th_dot * sinth) / kTotalMass;
    const double thetaacc =
        (kGravity * sinth - costh * temp) /
        (kLength * (4.0 / 3.0 - kMassPole * costh * costh / kTotalMass));
    const double xacc = temp - kPoleMassLength * thetaacc * costh / kTotalMass;
    // Euler, gymnasium order (positions first with OLD velocities),
    // double math to track gymnasium's float64 trajectories.
    st[0] = x + kTau * x_dot;
    st[1] = x_dot + kTau * xacc;
    st[2] = th + kTau * th_dot;
    st[3] = th_dot + kTau * thetaacc;
    steps[i] += 1;

    const bool term = st[0] < -kXThreshold || st[0] > kXThreshold ||
                      st[2] < -kThetaThreshold || st[2] > kThetaThreshold;
    const bool trunc = !term && steps[i] >= max_steps;
    reward[i] = 1.0f;
    terminated[i] = term;
    truncated[i] = trunc;
    obs_from_state(st, final_obs + 4 * i, 4);
    if (term || trunc) {
      cartpole_reset_one(st, rng);
      steps[i] = 0;
    }
    obs_from_state(st, obs + 4 * i, 4);
  }
}

// state: [n,2] float64; obs out: [n,3] float32 (cos, sin, thetadot)
void pendulum_reset(double* state, float* obs, int n, uint64_t* rng,
                    int32_t* steps) {
  for (int i = 0; i < n; ++i) {
    pendulum_reset_one(state + 2 * i, rng);
    pendulum_obs(state + 2 * i, obs + 3 * i);
    steps[i] = 0;
  }
}

void pendulum_step(double* state, const float* action, int n, uint64_t* rng,
                   int32_t* steps, int32_t max_steps, float* obs,
                   float* reward, uint8_t* terminated, uint8_t* truncated,
                   float* final_obs) {
  for (int i = 0; i < n; ++i) {
    double* st = state + 2 * i;
    double u = action[i];
    if (u > kMaxTorque) u = kMaxTorque;
    if (u < -kMaxTorque) u = -kMaxTorque;
    const double th = st[0];
    const double thdot = st[1];
    const double an = angle_normalize(th);
    const double cost = an * an + 0.1 * thdot * thdot + 0.001 * u * u;

    double newthdot =
        thdot + (3.0 * kPendG / (2.0 * kPendL) * std::sin(th) +
                 3.0 / (kPendM * kPendL * kPendL) * u) *
                    kPendDt;
    if (newthdot > kMaxSpeed) newthdot = kMaxSpeed;
    if (newthdot < -kMaxSpeed) newthdot = -kMaxSpeed;
    st[0] = th + newthdot * kPendDt;
    st[1] = newthdot;
    steps[i] += 1;

    const bool trunc = steps[i] >= max_steps;
    reward[i] = -cost;
    terminated[i] = 0;
    truncated[i] = trunc;
    pendulum_obs(st, final_obs + 3 * i);
    if (trunc) {
      pendulum_reset_one(st, rng);
      steps[i] = 0;
    }
    pendulum_obs(st, obs + 3 * i);
  }
}

// state: [n,2] float64 (position, velocity); obs out: [n,2] float32
void mountaincar_reset(double* state, float* obs, int n, uint64_t* rng,
                       int32_t* steps) {
  for (int i = 0; i < n; ++i) {
    mountaincar_reset_one(state + 2 * i, rng);
    obs_from_state(state + 2 * i, obs + 2 * i, 2);
    steps[i] = 0;
  }
}

void mountaincar_step(double* state, const float* action, int n,
                      uint64_t* rng, int32_t* steps, int32_t max_steps,
                      float* obs, float* reward, uint8_t* terminated,
                      uint8_t* truncated, float* final_obs) {
  // Bit-exact emulation of gymnasium's float32 MountainCar arithmetic.
  // Unlike the other classic-control envs, gymnasium keeps this state
  // in float32 and (via NumPy 2 weak promotion) performs EACH velocity/
  // position update op in float32, while clamps assign python float64
  // constants and comparisons run in float64 — rounding only at the end
  // of the step is NOT equivalent (the wall/clip discontinuities
  // amplify a 1-ulp difference chaotically; measured ~0.55 obs
  // divergence within one 999-step episode). The mixed float/double
  // locals below mirror that op-for-op.
  for (int i = 0; i < n; ++i) {
    double* st = state + 2 * i;
    const float raw = action[i];
    const float pos_f = (float)st[0];
    const float vel_f = (float)st[1];
    // velocity += force*power - 0.0025*cos(3*position). The cos term is
    // python-float (double) math on the float32 product 3*position.
    // When the force clamps, python's min/max returns the PYTHON float
    // bound, so force*power - cosTerm is one double expression rounded
    // ONCE on the float32 +=; unclamped, force stays np.float32 and the
    // product/subtraction are separate float32 ops. The branches differ
    // by 1 ulp often enough (~each few hundred clamped steps) that
    // collapsing them breaks long-horizon parity.
    const double cos_term = 0.0025 * std::cos((double)(3.0f * pos_f));
    float delta_f;
    if (raw > 1.0f) {
      delta_f = (float)(1.0 * kMcPower - cos_term);
    } else if (raw < -1.0f) {
      delta_f = (float)(-1.0 * kMcPower - cos_term);
    } else {
      delta_f = (raw * (float)kMcPower) - (float)cos_term;
    }
    float vel1_f = vel_f + delta_f;
    // Clamps assign the python float64 constant; comparisons in double.
    double vel_d = (double)vel1_f;
    if (vel_d > kMcMaxSpeed) vel_d = kMcMaxSpeed;
    if (vel_d < -kMcMaxSpeed) vel_d = -kMcMaxSpeed;
    // position += velocity is a float32 op regardless of which branch
    // velocity took (weak promotion casts a python float back down).
    const float pos1_f = pos_f + (float)vel_d;
    double pos_d = (double)pos1_f;
    if (pos_d > kMcMaxPos) pos_d = kMcMaxPos;
    if (pos_d < kMcMinPos) pos_d = kMcMinPos;
    // `position == min_position` can only be true via the clamp branch
    // (-1.2 is not float32-representable), exactly as in gymnasium.
    if (pos_d == kMcMinPos && vel_d < 0.0) vel_d = 0.0;
    st[0] = (double)(float)pos_d;  // np.array([...], dtype=np.float32)
    st[1] = (double)(float)vel_d;
    steps[i] += 1;
    const double pos = pos_d;
    const double vel = vel_d;

    const bool term = pos >= kMcGoalPos && vel >= kMcGoalVel;
    const bool trunc = !term && steps[i] >= max_steps;
    // gymnasium penalizes the RAW action (not the clipped force) and
    // pays +100 on reaching the goal.
    reward[i] =
        (float)((term ? 100.0 : 0.0) - 0.1 * ((double)raw * (double)raw));
    terminated[i] = term;
    truncated[i] = trunc;
    obs_from_state(st, final_obs + 2 * i, 2);
    if (term || trunc) {
      mountaincar_reset_one(st, rng);
      steps[i] = 0;
    }
    obs_from_state(st, obs + 2 * i, 2);
  }
}

// state: [n,4] float64 (θ1, θ2, dθ1, dθ2); obs out: [n,6] float32
void acrobot_reset(double* state, float* obs, int n, uint64_t* rng,
                   int32_t* steps) {
  for (int i = 0; i < n; ++i) {
    acrobot_reset_one(state + 4 * i, rng);
    acrobot_obs(state + 4 * i, obs + 6 * i);
    steps[i] = 0;
  }
}

void acrobot_step(double* state, const int64_t* action, int n, uint64_t* rng,
                  int32_t* steps, int32_t max_steps, float* obs,
                  float* reward, uint8_t* terminated, uint8_t* truncated,
                  float* final_obs) {
  for (int i = 0; i < n; ++i) {
    double* st = state + 4 * i;
    const double torque = (double)(action[i] - 1);  // {0,1,2} → {-1,0,+1}
    acrobot_rk4(st, torque);
    st[0] = wrap_pi(st[0]);
    st[1] = wrap_pi(st[1]);
    if (st[2] > kAcMaxVel1) st[2] = kAcMaxVel1;
    if (st[2] < -kAcMaxVel1) st[2] = -kAcMaxVel1;
    if (st[3] > kAcMaxVel2) st[3] = kAcMaxVel2;
    if (st[3] < -kAcMaxVel2) st[3] = -kAcMaxVel2;
    steps[i] += 1;

    const bool term = -std::cos(st[0]) - std::cos(st[1] + st[0]) > 1.0;
    const bool trunc = !term && steps[i] >= max_steps;
    reward[i] = term ? 0.0f : -1.0f;
    terminated[i] = term;
    truncated[i] = trunc;
    acrobot_obs(st, final_obs + 6 * i);
    if (term || trunc) {
      acrobot_reset_one(st, rng);
      steps[i] = 0;
    }
    acrobot_obs(st, obs + 6 * i);
  }
}

// Test hook: deterministic state injection (bypasses RNG).
void set_state(double* state, const double* values, int n, int dim) {
  std::memcpy(state, values, (size_t)n * dim * sizeof(double));
}

}  // extern "C"
