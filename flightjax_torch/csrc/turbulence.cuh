// Dryden continuous-gust turbulence (MIL-F-8785C), the "1-cosine" discrete
// gust and the logarithmic mean-wind shear, as per-aircraft __device__
// functions, and the counter-based stream that redraws the Dryden drive.
// Ports of flightjax/physics/turbulence.py (scales :61, shear_scale :83,
// discrete_gust :109, DrydenTurbulence :121-216) and of the disturbance
// chain of flightjax/physics/aircraftbase.py::Vehicle (:167-205), mirroring
// the plain PyTorch port (flightjax_torch/physics/turbulence.py,
// aircraftbase.py::Vehicle.apply_disturbances) operation by operation in
// Strict<F>; the kernels that read them are the turbulent C172S instances
// (ACT_TURB of c172_systems.cuh): rk4_stage_turb, rk4_finish_turb,
// megakernel_turb.
//
// The stream is jax.random's threefry2x32 in its partitionable layout
// (flightjax_torch/ops/random.py): key(seed, n) = fold_in(fold_in((0,
// 0x0D27), seed), n), fold_in(k, d) = threefry2x32(k, (0, d)), and the j-th
// normal of a draw from the hash y = threefry2x32(key, (0, j)): in float
// the 23 top bits of y0 ^ y1, in double the 52 top bits of (y0 << 32) | y1,
// as a mantissa in [1, 2), then u = (f - 1) 2 + nextafter(-1, 0) (its span
// 1 - nextafter(-1, 0) is 2 in either type, so the product is exact and
// the sum rounds once, as the fused form the reference draws) and
// sqrt(2) erfinv(u).
#pragma once

#include <stdint.h>

#include "flight_math.cuh"

namespace fj {

constexpr double FT = 0.3048;
constexpr double TURB_V_MIN = 5.0;
constexpr double H_AGL_MIN_FT = 10.0, H_LOW_FT = 1000.0, H_HIGH_FT = 2000.0,
                 L_HIGH_FT = 1750.0;
constexpr uint32_t TURB_STREAM = 0x0D27u;

// the turbulence's rows: x_turb = ug, vg[2], wg[2]; u_turb (the seed rides
// in the int32 operand) = W20, gust_amp[3], gust_t0, gust_T, shear_z0_ft;
// the held drive eta[3]
constexpr int N_XTURB = 5;
constexpr int TU_W20 = 0, TU_AMP = 1, TU_T0 = 4, TU_TG = 5, TU_Z0 = 6,
              N_UTURB = 7;
constexpr int N_ETA = 3;
// the int32 rows of the turbulent vehicle: step counter, seed, drive counter
constexpr int TI_I = 0, TI_SEED = 1, TI_N = 2, N_TURB_INT = 3;

static __device__ __noinline__ SF Log(SF x) { return SF::of(logf(x.v)); }
static __device__ __noinline__ SD Log(SD x) { return SD::of(log(x.v)); }
static __device__ __noinline__ SF Erfinv(SF x) { return SF::of(erfinvf(x.v)); }
static __device__ __noinline__ SD Erfinv(SD x) { return SD::of(erfinv(x.v)); }

// torch.maximum of two non-NaN values
template <typename T>
__device__ __forceinline__ T max2(T a, T b) {
  return a < b ? b : a;
}

// the scale lengths and intensities (L_v = L_u, sigma_v = sigma_u)
template <typename T>
struct Scales {
  T L_u, L_w, sig_u, sig_w;
};

// turbulence.py::scales at the height above ground h_agl [m] and the 20-ft
// wind W20 [m/s]
template <typename T>
__device__ __forceinline__ Scales<T> scales(T h_agl, T W20) {
  const T h_ft = clamp_min(h_agl / T(FT), T(H_AGL_MIN_FT));
  const T h_low = clamp(h_ft, T(H_AGL_MIN_FT), T(H_LOW_FT));
  const T den = T(0.177) + T(0.000823) * h_low;
  const T L_uv_lo = h_low / Pow(den, T(1.2));
  const T sig_w = T(0.1) * W20;
  const T sig_uv_lo = sig_w / Pow(den, T(0.4));
  const T blend =
      clamp((h_ft - T(H_LOW_FT)) / T(H_HIGH_FT - H_LOW_FT), T(0.0), T(1.0));
  const T nb = T(1.0) - blend;
  Scales<T> s;
  s.L_u = (nb * L_uv_lo + blend * T(L_HIGH_FT)) * T(FT);
  s.L_w = (nb * h_low + blend * T(L_HIGH_FT)) * T(FT);
  s.sig_u = nb * sig_uv_lo + blend * sig_w;
  s.sig_w = sig_w;
  return s;
}

// turbulence.py::shear_scale: the horizontal mean wind's multiplier under
// the logarithmic profile at roughness length z0 [ft] (<= 0: off, 1)
template <typename T>
__device__ __forceinline__ T shear_scale(T z0, T h_agl) {
  const T h_ft =
      max2(h_agl / T(FT), max2(z0 * T(1.0 + 1e-6), T(1e-3)));
  const bool on = z0 > T(0.0);
  const T safe_z0 = on ? z0 : T(1.0);
  const T k = Log(h_ft / safe_z0) / Log(T(20.0) / safe_z0);
  return on ? clamp_min(k, T(0.0)) : T(1.0);
}

// turbulence.py::discrete_gust: amp/2 (1 - cos(pi (t - t0)/T)) over
// [t0, t0 + 2T], zero outside
template <typename T>
__device__ __forceinline__ V3<T> discrete_gust(V3<T> amp, T t0, T Tg, T t) {
  const T tau = (t - t0) / Tg;
  const T env = tau >= T(0.0) && tau <= T(2.0)
                    ? T(0.5) * (T(1.0) - Cos(T(PI) * tau))
                    : T(0.0);
  return {amp.x * env, amp.y * env, amp.z * env};
}

// the turbulence's inputs of a lane (u_turb rows at r)
template <typename T>
struct TurbU {
  T W20, t0, Tg, z0;
  V3<T> amp;
};

template <typename T>
__device__ __forceinline__ TurbU<T> load_turb_u(const Col<T>& c, int r) {
  return {c(r + TU_W20), c(r + TU_T0), c(r + TU_TG), c(r + TU_Z0),
          c.v3(r + TU_AMP)};
}

// DrydenTurbulence._gust at the filter time constants
template <typename T>
__device__ __forceinline__ V3<T> dryden_gust(const T (&x)[N_XTURB], T T_u,
                                             T T_w, const Scales<T>& sc) {
  const T sqrt2pi = T(0.7978845608028654);  // sqrt(2 / pi)
  const T sqrt1pi = T(0.5641895835477563);  // sqrt(1 / pi)
  const T sqrt3 = T(1.7320508075688772);
  return {sc.sig_u * sqrt2pi * Sqrt(T_u) * x[0],
          sc.sig_u * sqrt1pi * Sqrt(T_u) * (x[1] + sqrt3 * T_u * x[2]),
          sc.sig_w * sqrt1pi * Sqrt(T_w) * (x[3] + sqrt3 * T_w * x[4])};
}

// DrydenTurbulence.gust (and the gust of .f_ode): the body-axes gust of the
// filter states x at the relative airspeed V and the height above ground
// h_agl, time t; the filters' time constants T_u (= T_v) and T_w, which
// their derivative reads, are left in T_u, T_w
template <typename T>
__device__ __forceinline__ V3<T> dryden_gust(const T (&x)[N_XTURB],
                                             const TurbU<T>& u, T t, T V,
                                             T h_agl, T& T_u, T& T_w) {
  V = clamp_min(V, T(TURB_V_MIN));
  const Scales<T> sc = scales(h_agl, u.W20);
  T_u = sc.L_u / V;
  T_w = sc.L_w / V;
  return add(dryden_gust(x, T_u, T_w, sc),
             discrete_gust(u.amp, u.t0, u.Tg, t));
}

// the filters' derivative of DrydenTurbulence.f_ode x alive: the held
// drive eta times k_eta = sqrt(pi / dt) through the first-order u filter
// and the second-order v and w filters of time constants T_u, T_w
template <typename T>
__device__ __forceinline__ void dryden_dot(const T (&x)[N_XTURB],
                                           const T (&eta)[N_ETA], T k_eta,
                                           T T_u, T T_w, T alive,
                                           T (&d)[N_XTURB]) {
  const T e0 = eta[0] * k_eta, e1 = eta[1] * k_eta, e2 = eta[2] * k_eta;
  d[0] = alive * ((e0 - x[0]) / T_u);
  d[1] = alive * x[2];
  d[2] = alive * ((e1 - x[1] - T(2.0) * T_u * x[2]) / (T_u * T_u));
  d[3] = alive * x[4];
  d[4] = alive * ((e2 - x[3] - T(2.0) * T_w * x[4]) / (T_w * T_w));
}

// Vehicle.apply_disturbances + air_data: the mean wind sheared at the
// height above the terrain elevation, the filters on the airspeed relative
// to it, the gust superposed; returns the disturbed AirData of the lane at
// KinData k and leaves the filters' time constants in T_u, T_w. The
// atmosphere of atm_air (ISA layers skipped above the aircraft with
// SKIP_ABOVE) is the same as without the gust.
template <bool SKIP_ABOVE = false, typename T>
__device__ __forceinline__ Air<T> turb_air(const Kin<T>& k, const AtmU<T>& a,
                                           T elevation,
                                           const T (&x)[N_XTURB],
                                           const TurbU<T>& u, T t, T& T_u,
                                           T& T_w) {
  const T h_agl = k.h_o - elevation;
  const T ks = shear_scale(u.z0, h_agl);
  const V3<T> v_mean = {a.wind.x * ks, a.wind.y * ks, a.wind.z * T(1.0)};
  const V3<T> v_ew_b = qrot_inv(k.q_nb, v_mean);
  const T V = norm3(sub(k.v_eb_b, v_ew_b));
  const V3<T> g = dryden_gust(x, u, t, V, h_agl, T_u, T_w);
  return atm_air<SKIP_ABOVE, true>(k, a.T_sl, a.p_sl,
                                   add(v_mean, qrot(k.q_nb, g)),
                                   add(v_ew_b, g));
}

// ------------------------------------------------------------- the stream

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// threefry2x32, 20 rounds (jax._src.prng.threefry2x32)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, rot[j % 2][r]);
      x1 ^= x0;
    }
    x0 += ks[(j + 1) % 3];
    x1 += ks[(j + 2) % 3] + uint32_t(j + 1);
  }
}

// fold_in(key, d): the key hashes (0, d)
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// the mantissa draw f in [0, 1) of a hash (y0, y1) in float / double
__device__ __forceinline__ SF unit_draw(SF, uint32_t y0, uint32_t y1) {
  return SF::of(__uint_as_float(((y0 ^ y1) >> 9) | 0x3F800000u)) - SF(1.0);
}
__device__ __forceinline__ SD unit_draw(SD, uint32_t y0, uint32_t y1) {
  const unsigned long long bits =
      (((unsigned long long)y0 << 32) | y1) >> 12;
  return SD::of(__longlong_as_double(
             (long long)(bits | 0x3FF0000000000000ull))) -
         SD(1.0);
}

// nextafter(-1, 0) in float and double
__device__ __forceinline__ SF normal_lo(SF) {
  return SF::of(-0.99999994039535522461f);
}
__device__ __forceinline__ SD normal_lo(SD) {
  return SD::of(-0.99999999999999988898);
}

// DrydenTurbulence.f_step: the drive of step counter n (the new counter)
// for the lane's seed, eta[j] = normal(key(seed, n), (3,))[j]
template <typename T>
__device__ __forceinline__ void turb_redraw(uint32_t seed, uint32_t n,
                                            T (&eta)[N_ETA]) {
  uint32_t k0 = 0u, k1 = TURB_STREAM;
  fold_in(k0, k1, seed);
  fold_in(k0, k1, n);
  const T lo = normal_lo(T(0.0));
  const T span = T(1.0) - lo;
#pragma unroll
  for (int j = 0; j < N_ETA; ++j) {
    uint32_t y0 = 0u, y1 = uint32_t(j);
    threefry2x32(k0, k1, y0, y1);
    const T u = max2(lo, unit_draw(T(0.0), y0, y1) * span + lo);
    eta[j] = T(1.4142135623730951) * Erfinv(u);
  }
}

}  // namespace fj
