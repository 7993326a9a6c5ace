// The navigation avionics' pass as device code: the sensors, the fault
// stage, the 15-state INS/GPS filter with its monitored aiding block and
// the estimated VehicleY the inner control laws read, for one aircraft
// carried by the N_ROLES threads of the role layout (c172_systems.cuh). One
// entry point, nav_pass_roles, which nav_pass.cu (the splits' pass) and the
// megakernel's navigation instances (megakernel_nav, megakernel_nav_turb)
// call; and truth_roles, the fifth evaluation of the vehicle's derivative
// at the new state that the megakernel makes for the sensors.
//
// The port of flightjax_torch/physics/navigation.py::NavAvionics.nav_pass,
// aid_block and systems_est (each alpha_beta policy), utils/estimation.py's
// InsGps (predict_mean, accum_A, propagate_P or, without defer_cov,
// predict's first-order transition every firing, stacked_rows,
// stacked_innovation, update_stacked, blocked_spd_solve), nis and
// innovation_monitor, physics/sensors.py's SensorSuite.epoch_draws, f_step
// and measure, operation by operation in their order. Four findings of the
// reference's review are carried as the reference has them (ADVICE.md): P
// compounds on the fastest cadence p_every, propagate_P truncates the
// transition at second order, the stacked update solves by blocks (the
// m > 3 Cholesky gain is never reached), a monitor holds at most 32 epochs.
//
// The aiding block runs where the lane's own epoch has a GPS, baro, mag (or
// radar) epoch, and is skipped elsewhere, as the reference's fleet step
// skips it behind a scalar lax.cond (core/sim.py:375-389): on a lane
// without an epoch every row of the stacked update is masked, and the
// ungated update (Simulation.step) leaves the state as it was but for the
// attitude's renormalisation, a rounding.
//
// The draws: the sensors' stream is jax.random's threefry2x32 in float32
// (ops/random.py::normal_f32); each normal is read from normal_table, the
// float32 normal of each of the 2^23 mantissas, by the hash's top 23 bits.
//
// The work: the role layout carries each aircraft in N_ROLES threads; role
// 0 (the lead) works the elementwise parts (draws, sensors, faults, the
// mechanisation, the stacked rows, the NIS values and monitors, the blocked
// solve, the injection and the estimates) and the 15 x 15 products are
// spread over the N_ROLES threads of the lane, rows role and role + 8 each,
// between barriers. A lane's P does not fit in registers, and P, the
// transition and one product are ~5.4 KB a lane in double: the matrices
// live in a global work buffer [N_WORK, B] (batch-minor, so neighbouring
// lanes touch neighbouring addresses; 4096 lanes are a few MB, in L2). The
// algebra is plain multiplies and adds in T: no tensor core, no TF32, no
// contraction (Strict<F>), since P spans ~1e-8..1e1.
#pragma once

#include "c172_systems.cuh"
#include "c172x_gdc.cuh"
#include "turbulence.cuh"

namespace fj {

// ------------------------------------------------------------- rows

// NAV_U: the navigation avionics' inputs (after the inner avionics' rows):
// the sensor catalog per lane (imu, airdata, gps, mag, baro, radar, in the
// order of sensors.suite_params), the filter's origin and the fault's size
constexpr int NU_SG = 0, NU_SA = 1, NU_RWG = 2, NU_RWA = 3, NU_B0G = 4,
              NU_B0A = 5, NU_SCG = 6, NU_SCA = 7, NU_RIMU = 8, NU_SP = 11,
              NU_SPT = 12, NU_BP = 13, NU_BPT = 14, NU_ST = 15, NU_SPOS = 16,
              NU_SVEL = 17, NU_GMS = 18, NU_GMT = 19, NU_MBN = 20, NU_MS = 23,
              NU_HI = 24, NU_BS = 27, NU_QNH = 28, NU_RS = 29, NU_HMAX = 30,
              NU_LAT0 = 31, NU_LON0 = 32, NU_H0 = 33, NU_DATUM = 34,
              NU_NGEO = 35, NU_BN = 36, NU_DELTA = 39, N_NAVU = 40;
// NAV_S: the state's floating rows: the sensors' error processes, the
// filter (q, v, p, b_g, b_a, P row-major), the accumulator A (w, cf, c,
// row-major), the fault hold registers, the last NIS of each channel (baro,
// gps, gps_vel, mag, radar) and the five monitors' alarms (gps, vel, baro,
// mag, radar)
constexpr int NS_BG = 0, NS_BA = 3, NS_GM = 6, NS_Q = 9, NS_V = 13,
              NS_P = 16, NS_FBG = 19, NS_FBA = 22, NS_PP = 25, NS_AW = 250,
              NS_ACF = 259, NS_AC = 268, NS_HGP = 277, NS_HGV = 280,
              NS_HHB = 283, NS_HMG = 284, NS_NIS = 287, NS_ALARM = 292,
              N_NAVS = 297;
constexpr int NIS_BARO = 0, NIS_GPS = 1, NIS_VEL = 2, NIS_MAG = 3,
              NIS_RADAR = 4;
constexpr int MON_GPS = 0, MON_VEL = 1, MON_BARO = 2, MON_MAG = 3,
              MON_RADAR = 4, N_MON = 5;
// NAV_INT: the integers past what float32 holds exactly, an int32 operand:
// the stream's seed, the sensor epoch, the fault's channel, mode, k0 and
// k1, each monitor's bit register (uint32 in int32)
constexpr int NI_SEED = 0, NI_N = 1, NI_CH = 2, NI_MODE = 3, NI_K0 = 4,
              NI_K1 = 5, NI_BITS = 6, N_NAVI = NI_BITS + N_MON;      // 11
// NAV_T: the truth the sensors read (nav_pass.cu's input): KinData's
// omega_eb_b, q_eb, q_nb, lat, lon, n_e, h_e, h_o, v_eb_n; AirData's p, pt,
// T; DynamicsY's f_c_c, alpha_ib_b and the summed mass's r_OG; the terrain
// under the vehicle
constexpr int NT_OM_EB = 0, NT_Q_EB = 3, NT_Q_NB = 7, NT_LAT = 11,
              NT_LON = 12, NT_N_E = 13, NT_H_E = 16, NT_H_O = 17,
              NT_V_EB_N = 18, NT_P = 21, NT_PT = 22, NT_T = 23, NT_F_C = 24,
              NT_ALPHA = 27, NT_R_OG = 30, NT_H_TRN = 33, N_NAVT = 34;
// the parameter block (kernels.nav_params, appended to the gains; its
// offset in G[N_GAIN_TABLES]): dt, sqrt(dt), dt^2, p_every dt, -0.5 dt, Q
// p_every (15), the rows' variances (11), the gates (gps, vel, baro, mag,
// radar), the monitors' window and hits, the cadences (gps, baro, mag,
// radar, p), use_radar, radar_max_agl, use_estimates, then per ISA layer
// (zero lapse, h_b, the layer's factor, exponent, p_b), then the airflow
// angles' policy (AB_*) with the perturbation's two offsets, and defer_cov.
// Without defer_cov the covariance steps every firing through the first-
// order transition (InsGps.predict): p_every is 1 there, Q unscaled
constexpr int NP_DT = 0, NP_SQ = 1, NP_DT2 = 2, NP_KDT = 3, NP_MHDT = 4,
              NP_QK = 5, NP_R = 20, NP_GATE = 31, NP_WIN = 36, NP_HITS = 37,
              NP_EVERY = 38, NP_P_EVERY = 42, NP_RADAR = 43,
              NP_RADAR_MAX = 44, NP_USE_EST = 45, NP_ISA = 46,
              N_ISA = 7, ISA_N = 5, NP_AB = NP_ISA + N_ISA * ISA_N,
              NP_DA = NP_AB + 1, NP_DB = NP_AB + 2, NP_DEFER = NP_AB + 3,
              N_NAVP = NP_AB + 4;                                     // 85
// the airflow angles the inner laws read (NavAvionics.systems_est): the
// truth's, "synthetic" (alpha from the estimated attitude and velocity and
// the measured TAS, beta 0), ("perturb", da, db) the truth's offset
constexpr int AB_TRUTH = 0, AB_SYNTHETIC = 1, AB_PERTURB = 2;
constexpr int EV_GPS = 0, EV_BARO = 1, EV_MAG = 2, EV_RADAR = 3;
// the fault spec (navigation.py:98-109)
constexpr int FAULT_GPS = 1, FAULT_BARO = 2, FAULT_GPS_VEL = 3,
              FAULT_MAG = 4;
constexpr int MODE_FREEZE = 0, MODE_BIAS = 1, MODE_DROPOUT = 2,
              MODE_RAMP = 3;
// the sensors' stream key base (physics/sensors.py::KEY_BASE)
constexpr uint32_t SENSOR_STREAM = 0x5E45u;

// the work rows of a lane: the transition or I - K H, a product, the
// unsymmetrised product, the propagated P, H (masked after the monitors),
// P H^T, S, K, the masked variances, the lead's flags for the others (aid,
// p_new)
constexpr int NX = 15, NM = 11;
constexpr int W_PHI = 0, W_M = W_PHI + NX * NX, W_P1 = W_M + NX * NX,
              W_PP = W_P1 + NX * NX, W_H = W_PP + NX * NX,
              W_PHT = W_H + NM * NX, W_S = W_PHT + NX * NM,
              W_K = W_S + NM * NM, W_RM = W_K + NX * NM, W_FLAG = W_RM + NM,
              W_A = W_FLAG + 2, N_WORK = W_A + 27;                // 1556

// the nav parameter block of the gains
template <typename T>
__device__ __forceinline__ const T* nav_params(const T* G) {
  return G + int(G[N_GAIN_TABLES].v);
}

// ------------------------------------------------------------- the truth

// what the sensors read of the truth at the new state
template <typename T>
struct NavTruth {
  V3<T> om_eb, n_e, v_eb_n, f_c_c, alpha_ib_b, r_OG;
  Q4<T> q_eb, q_nb;
  T lat, lon, h_e, h_o, p, pt, Tk;
};

template <typename T>
__device__ __forceinline__ NavTruth<T> load_truth(const Col<T>& c) {
  NavTruth<T> tr;
  tr.om_eb = c.v3(NT_OM_EB);
  tr.q_eb = c.q4(NT_Q_EB);
  tr.q_nb = c.q4(NT_Q_NB);
  tr.lat = c(NT_LAT);
  tr.lon = c(NT_LON);
  tr.n_e = c.v3(NT_N_E);
  tr.h_e = c(NT_H_E);
  tr.h_o = c(NT_H_O);
  tr.v_eb_n = c.v3(NT_V_EB_N);
  tr.p = c(NT_P);
  tr.pt = c(NT_PT);
  tr.Tk = c(NT_T);
  tr.f_c_c = c.v3(NT_F_C);
  tr.alpha_ib_b = c.v3(NT_ALPHA);
  tr.r_OG = c.v3(NT_R_OG);
  return tr;
}

// VehicleDynamics.output (dynamics.py:263-276): the specific force at the
// CoM and the angular acceleration wrt inertial space, from the sums (the
// Newton-Euler solve of dynamics_lane, unscaled)
template <typename T>
__device__ __forceinline__ void dynamics_output(const XDyn<T>& xi,
                                                const MP<T>& mp, V3<T> F_b,
                                                V3<T> tau_b, V3<T> ho,
                                                Q4<T> q_eb, V3<T> r_eb_e,
                                                V3<T>& f_c_c,
                                                V3<T>& alpha_ib_b) {
  const V3<T> omega_eb_b = xi.omega_eb_b, v_eb_b = xi.v_eb_b;
  const T m = mp.m;
  const M33<T>& J = mp.J;
  const V3<T> r_OG = mp.r;
  const V3<T> omega_ie_b = qrot_inv(q_eb, V3<T>{T(0), T(0), T(OMEGA_IE)});
  const V3<T> r_bc_b = r_OG;
  const M33<T> SSc = mm(skew(r_OG), skew(r_OG));
  const V3<T> r_bG_b = add(neg(r_bc_b), r_OG);
  const M33<T> SSb = mm(skew(r_bG_b), skew(r_bG_b));
  M33<T> J_c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      J_c.m[i][j] = (J.m[i][j] + m * SSc.m[i][j]) - m * SSb.m[i][j];
  const V3<T> F_c = F_b;
  const V3<T> tau_c = add(tau_b, cross(neg(r_bc_b), F_c));
  const V3<T> omega_ec_c = omega_eb_b;
  const V3<T> v_ec_c = add(v_eb_b, cross(omega_ec_c, r_bc_b));
  const V3<T> omega_ie_c = omega_ie_b;
  const V3<T> omega_ic_c = add(omega_ie_c, omega_ec_c);
  const V3<T> r_ec_e = add(r_eb_e, qrot(q_eb, r_bc_b));
  V3<T> n_c;
  T h_c;
  geographic_from_cartesian(r_ec_e, n_c, h_c);
  const T g_mag = gravity(n_c, h_c);
  const V3<T> g_c_c = scale(g_mag, qrot_inv(q_eb, neg(n_c)));
  const V3<T> hc = add(mv(J_c, omega_ic_c), ho);
  const V3<T> rhs = sub(sub(tau_c, mv(J_c, cross(omega_ie_c, omega_ec_c))),
                        cross(omega_ic_c, hc));
  const V3<T> omega_dot = solve3(J_c, rhs);
  const V3<T> F_m = {F_c.x / m, F_c.y / m, F_c.z / m};
  const V3<T> v_dot_ec_c =
      sub(add(F_m, g_c_c),
          cross(add(omega_ec_c, scale(T(2), omega_ie_c)), v_ec_c));
  const V3<T> r_ec_c = qrot_inv(q_eb, r_ec_e);
  const V3<T> centripetal = cross(omega_ie_c, cross(omega_ie_c, r_ec_c));
  const V3<T> a_ic_c = add(
      add(v_dot_ec_c,
          cross(add(omega_ec_c, scale(T(2), omega_ie_c)), v_ec_c)),
      centripetal);
  const V3<T> G_c_c = add(g_c_c, centripetal);
  alpha_ib_b = sub(omega_dot, cross(omega_eb_b, omega_ie_c));
  f_c_c = sub(a_ic_c, G_c_c);
}

// The vehicle's derivative once more at the new state xn (each role its
// slots, after the finish), for what the IMU reads (Aircraft.f_periodic
// evaluates vehicle.f_ode at the new state with the step's inputs; the
// port's kernels.vehicle_truth): role KIN the kinematics and air data at
// the undulation of CTX (the step's start, as the reference's megakernel
// reads it before its refresh; on the turbulent vehicle with the new filter
// states tl->d at the new time tl->t), the subsystems with the new discrete
// state (role AERO its stall flag s_new.stall, role ENG its engine state),
// then role KIN the dynamics' outputs. Every lane alive (the truth of a
// terminated lane as of a live one, as vehicle_truth forms it). Role KIN
// returns the truth in tr. All threads of the block must call it.
template <int ACT, typename T>
__device__ __forceinline__ void truth_roles(const T* P, T* sh,
                                            const RoleThread& t,
                                            const T (&xn)[N_SLOTS],
                                            const Col<T>& c, int r_ctx,
                                            const SSys& s_new,
                                            const TurbLane<T>* tl,
                                            NavTruth<T>& tr) {
  using L = SysL<ACT>;
  const Col<T> si{sh, t.L, t.lane};
  XDyn<T> xi_dyn;
  Q4<T> q_eb;
  V3<T> r_eb_e;
  T tau_shaft;
  subsystem_roles_share<ACT>(sh, t, xn);
  if (t.role == ROLE_KIN) {
    const XKin<T> xi_kin = {{xn[0], xn[1], xn[2], xn[3]},
                            {xn[4], xn[5], xn[6], xn[7]}, xn[8]};
    xi_dyn = {{xn[9], xn[10], xn[11]}, {xn[12], xn[13], xn[14]}};
    XKin<T> kd;
    Kin<T> kin;
    Air<T> air;
    if constexpr (act_turb(ACT)) {
      wa_f_ode(xi_kin.q_wb, xi_kin.q_ew, xi_kin.h_e, xi_dyn.omega_eb_b,
               xi_dyn.v_eb_b, c(r_ctx + L::CX_GEOID), kd, kin);
      T T_u, T_w;
      air = turb_air(kin, load_atm(c, r_ctx + L::CX_UATM),
                     c(r_ctx + L::CX_TRN + TR_ELEV), tl->d,
                     load_turb_u(c, r_ctx + L::CX_UTURB), tl->t, T_u, T_w);
    } else {
      kinair_lane(xi_kin, xi_dyn, c(r_ctx + L::CX_GEOID),
                  load_atm(c, r_ctx + L::CX_UATM), T(1.0), kd, kin, air);
    }
    share_kin_air(Out<T>{sh, t.L, t.lane}, kin, air);
    q_eb = kin.q_eb;
    r_eb_e = kin.r_eb_e;
    tr.om_eb = kin.omega_eb_b;
    tr.q_eb = kin.q_eb;
    tr.q_nb = kin.q_nb;
    tr.lat = kin.lat;
    tr.lon = kin.lon;
    tr.n_e = kin.n_e;
    tr.h_e = kin.h_e;
    tr.h_o = kin.h_o;
    tr.v_eb_n = kin.v_eb_n;
    tr.p = air.p;
    tr.pt = air.pt;
    tr.Tk = air.Tk;
  }
  __syncthreads();
  if (t.role != ROLE_KIN) {
    // the role's inputs, terrain and the new discrete state, compact
    constexpr int NU = L::NU, R_S = NU, R_TRN = NU + N_SSYS;
    T cl[NU + N_SSYS + N_TRN];
#pragma unroll
    for (int k = 0; k < NU; ++k) cl[k] = c(r_ctx + CX_USYS + k);
#pragma unroll
    for (int k = 0; k < N_SSYS; ++k) cl[R_S + k] = c(r_ctx + L::CX_SSYS + k);
#pragma unroll
    for (int k = 0; k < N_TRN; ++k) cl[R_TRN + k] = c(r_ctx + L::CX_TRN + k);
    if (t.role == ROLE_AERO) cl[R_S + SS_STALL] = T(s_new.stall ? 1.0 : 0.0);
    if (t.role == ROLE_ENG) cl[R_S + SS_STATE] = T(double(s_new.state));
    T d[N_SLOTS];
    subsystem_roles<ACT>(P, sh, t, xn, Col<T>{cl, 1, 0}, 0, R_S, R_TRN,
                         T(1.0), tau_shaft, d);
  }
  __syncthreads();
  if (t.role == ROLE_KIN) {
    V3<T> F_b, tau_b;
    role_wrench(si, F_b, tau_b);
    const MP<T> mp = role_mp(si);
    dynamics_output(xi_dyn, mp, F_b, tau_b, si.v3(SH_HR), q_eb, r_eb_e,
                    tr.f_c_c, tr.alpha_ib_b);
    tr.r_OG = mp.r;
  }
}

// ------------------------------------------------------------- helpers

// the normal of a hash (y0, y1): the table's entry of its top 23 bits
template <typename T>
__device__ __forceinline__ T table_normal(const float* table, uint32_t y0,
                                          uint32_t y1) {
  return T(double(table[(y0 ^ y1) >> 9]));
}

// SensorSuite.epoch_draws: the 9 process draws (tag 0) and the 20
// measurement draws (tag 1) of epoch n of the lane's seed
template <typename T>
__device__ __forceinline__ void epoch_draws(const float* table, uint32_t seed,
                                            uint32_t n, T (&e0)[9],
                                            T (&e1)[20]) {
  uint32_t k0 = 0u, k1 = SENSOR_STREAM;
  fold_in(k0, k1, seed);
  fold_in(k0, k1, n);
  uint32_t a0 = k0, a1 = k1, b0 = k0, b1 = k1;
  fold_in(a0, a1, 0u);
  fold_in(b0, b1, 1u);
#pragma unroll 1
  for (int j = 0; j < 9; ++j) {
    uint32_t y0 = 0u, y1 = uint32_t(j);
    threefry2x32(a0, a1, y0, y1);
    e0[j] = table_normal<T>(table, y0, y1);
  }
#pragma unroll 1
  for (int j = 0; j < 20; ++j) {
    uint32_t y0 = 0u, y1 = uint32_t(j);
    threefry2x32(b0, b1, y0, y1);
    e1[j] = table_normal<T>(table, y0, y1);
  }
}

// sensors.pressure_altitude: the layer of the pressure, the first layer's
// law below sea level (the layers' constants from the block)
template <typename T>
__device__ __forceinline__ T pressure_altitude(const T* NP, T p) {
  T h_out = T(0.0);
#pragma unroll 1
  for (int i = 0; i < N_ISA; ++i) {
    const T* l = NP + NP_ISA + i * ISA_N;
    const T h_b = l[1], f = l[2], e = l[3], p_b = l[4];
    T h;
    if (l[0].v != 0)  // zero lapse: h_b - (R T_b / g) log(p / p_b)
      h = h_b - f * Log(p / p_b);
    else  // h_b + (T_b / beta) ((p / p_b)^(-beta R / g) - 1)
      h = f * (Pow(p / p_b, e) - T(1.0)) + h_b;
    h_out = (i == 0 || p < p_b) ? h : h_out;
  }
  return h_out;
}

template <typename T>
__device__ __forceinline__ V3<T> nvector_from_latlon(T lat, T lon) {
  const T cl = Cos(lat);
  return {cl * Cos(lon), cl * Sin(lon), Sin(lat)};
}

// ops/attitude.py::quat_to_matrix (normalised first)
template <typename T>
__device__ __forceinline__ M33<T> quat_to_matrix(Q4<T> q) {
  const T n = Sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  const T q1 = q.w / n, q2 = q.x / n, q3 = q.y / n, q4 = q.z / n;
  const T dq12 = T(2) * q1 * q2, dq13 = T(2) * q1 * q3;
  const T dq14 = T(2) * q1 * q4, dq23 = T(2) * q2 * q3;
  const T dq24 = T(2) * q2 * q4, dq34 = T(2) * q3 * q4;
  const T s2 = q2 * q2, s3 = q3 * q3, s4 = q4 * q4;
  return {{{T(1) - T(2) * (s3 + s4), dq23 - dq14, dq24 + dq13},
           {dq23 + dq14, T(1) - T(2) * (s2 + s4), dq34 - dq12},
           {dq24 - dq13, dq34 + dq12, T(1) - T(2) * (s2 + s3)}}};
}

template <typename T>
__device__ __forceinline__ Q4<T> qnormalize(Q4<T> q) {
  const T n = Sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

// estimation.rvec_to_quat: [cos(mu/2), axis sin(mu/2)], identity at mu = 0
template <typename T>
__device__ __forceinline__ Q4<T> rvec_to_quat(V3<T> rv) {
  const T mu = norm3(rv);
  if (!(mu > T(0))) return {T(1), T(0), T(0), T(0)};
  const V3<T> axis = {rv.x / mu, rv.y / mu, rv.z / mu};
  const T half = T(0.5) * mu;
  const T s = Sin(half);
  return {Cos(half), axis.x * s, axis.y * s, axis.z * s};
}

// estimation._inv3: the adjugate over the determinant, a[i][j] row-major
template <typename T>
__device__ __forceinline__ void inv3(const T* a, int ld, T (&r)[9]) {
  const T a00 = a[0], a01 = a[1], a02 = a[2];
  const T a10 = a[ld], a11 = a[ld + 1], a12 = a[ld + 2];
  const T a20 = a[2 * ld], a21 = a[2 * ld + 1], a22 = a[2 * ld + 2];
  const T c00 = a11 * a22 - a12 * a21;
  const T c01 = a12 * a20 - a10 * a22;
  const T c02 = a10 * a21 - a11 * a20;
  const T det = a00 * c00 + a01 * c01 + a02 * c02;
  const T c10 = a02 * a21 - a01 * a22;
  const T c11 = a00 * a22 - a02 * a20;
  const T c12 = a01 * a20 - a00 * a21;
  const T c20 = a01 * a12 - a02 * a11;
  const T c21 = a02 * a10 - a00 * a12;
  const T c22 = a00 * a11 - a01 * a10;
  r[0] = c00 / det, r[1] = c10 / det, r[2] = c20 / det;
  r[3] = c01 / det, r[4] = c11 / det, r[5] = c21 / det;
  r[6] = c02 / det, r[7] = c12 / det, r[8] = c22 / det;
}

// nis: y^T S^-1 y over rows a.. of n (1 or 3) of the stacked system
template <typename T>
__device__ __forceinline__ T nis_of(const T* S, const T* y, int a, int n) {
  if (n == 1) return (y[a] * y[a]) / S[a * NM + a];
  T r[9];
  inv3(S + a * NM + a, NM, r);
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T ti = r[3 * i] * y[a] + r[3 * i + 1] * y[a + 1] +
                 r[3 * i + 2] * y[a + 2];
    acc = acc + y[a + i] * ti;
  }
  return acc;
}

// innovation_monitor's update: one epoch's hit shifted in where valid, the
// alarm latched at min_hits of the last `window`
__device__ __forceinline__ bool monitor_step(uint32_t& bits, bool alarm,
                                             bool hit, bool valid,
                                             int window, int min_hits) {
  const uint32_t mask =
      window >= 32 ? 0xFFFFFFFFu : ((1u << window) - 1u);
  if (valid) bits = ((bits << 1) | uint32_t(hit)) & mask;
  return alarm || __popc(bits) >= min_hits;
}

// the block partition of the stacked system: (3, 3, 1, 3[, 1])
__device__ __forceinline__ int blk_size(int i) {
  return (i == 2 || i == 4) ? 1 : 3;
}
__device__ __forceinline__ int blk_ofs(int i) {
  return i == 0 ? 0 : i == 1 ? 3 : i == 2 ? 6 : i == 3 ? 7 : 10;
}

// blocked_spd_solve(S, X) over the partition, in place: S m x m (NM
// stride), X m x NX (NX stride), the pivots inverted in closed form; X
// becomes the solution
template <typename T>
__device__ __forceinline__ void blocked_spd_solve(T* S, T* X, int nb) {
  T inv[5][9];
#pragma unroll 1
  for (int i = 0; i < nb; ++i) {
    const int oi = blk_ofs(i), ni = blk_size(i);
    if (ni == 1)
      inv[i][0] = T(1.0) / S[oi * NM + oi];
    else
      inv3(S + oi * NM + oi, NM, inv[i]);
#pragma unroll 1
    for (int j = i + 1; j < nb; ++j) {
      const int oj = blk_ofs(j), nj = blk_size(j);
      T Lji[9];  // Sb[j][i] @ inv_i, nj x ni
      for (int r = 0; r < nj; ++r)
        for (int q = 0; q < ni; ++q) {
          T acc = T(0);
          for (int k = 0; k < ni; ++k)
            acc = acc + S[(oj + r) * NM + oi + k] * inv[i][k * ni + q];
          Lji[r * ni + q] = acc;
        }
      for (int l = i + 1; l < nb; ++l) {
        const int ol = blk_ofs(l), nl = blk_size(l);
        for (int r = 0; r < nj; ++r)
          for (int q = 0; q < nl; ++q) {
            T acc = T(0);
            for (int k = 0; k < ni; ++k)
              acc = acc + Lji[r * ni + k] * S[(oi + k) * NM + ol + q];
            S[(oj + r) * NM + ol + q] = S[(oj + r) * NM + ol + q] - acc;
          }
      }
      for (int r = 0; r < nj; ++r)
        for (int q = 0; q < NX; ++q) {
          T acc = T(0);
          for (int k = 0; k < ni; ++k)
            acc = acc + Lji[r * ni + k] * X[(oi + k) * NX + q];
          X[(oj + r) * NX + q] = X[(oj + r) * NX + q] - acc;
        }
    }
  }
#pragma unroll 1
  for (int i = nb - 1; i >= 0; --i) {
    const int oi = blk_ofs(i), ni = blk_size(i);
    for (int q = 0; q < NX; ++q) {
      T acc[3];
      for (int r = 0; r < ni; ++r) acc[r] = X[(oi + r) * NX + q];
      for (int j = i + 1; j < nb; ++j) {
        const int oj = blk_ofs(j), nj = blk_size(j);
        for (int r = 0; r < ni; ++r) {
          T s = T(0);
          for (int k = 0; k < nj; ++k)
            s = s + S[(oi + r) * NM + oj + k] * X[(oj + k) * NX + q];
          acc[r] = acc[r] - s;
        }
      }
      for (int r = 0; r < ni; ++r) {
        T s = T(0);
        for (int k = 0; k < ni; ++k) s = s + inv[i][r * ni + k] * acc[k];
        X[(oi + r) * NX + q] = s;
      }
    }
  }
}

// a lane's matrix in the work buffer: element k of the rows at r
template <typename T>
struct WMat {
  T* w;  // the lane's work column (element row k at w[k * B])
  int B, r;
  __device__ __forceinline__ T get(int k) const {
    return w[(size_t)(r + k) * B];
  }
  __device__ __forceinline__ void set(int k, T v) const {
    w[(size_t)(r + k) * B] = v;
  }
};

// ------------------------------------------------------------- the pass

// NavAvionics.nav_pass of one aircraft by its N_ROLES threads (role t.role,
// lane t.lane): where `fires`, the sensors at epoch n + 1 from the truth tr
// (read by role 0 only) and the terrain h_trn, the faults, the filter with
// the aiding block on an epoch, the new state into `so` (the NAV_S rows,
// floats) and `no` (the NAV_INT rows), and the estimated CTL_Y fields into
// yo (with `gdc` the n-vector of the estimated position too; in shadow mode
// nothing is written to yo); elsewhere the state passes through. u and s
// are the lane's NAV_U and NAV_S rows, ni the lane's NAV_INT rows (stride
// B), W its work column (stride B), NP the parameter block. Stores only
// where `store` (a ragged block's extra threads recompute the last lane).
// All threads of the block must call it.
template <typename T>
__device__ __noinline__ void nav_pass_roles(
    int role, bool store, bool fires, const T* NP, const float* table,
    const NavTruth<T>& tr, T h_trn, const Col<T>& u, const Col<T>& s,
    const Out<T>& so, const int* ni, int* no, T* W, int B, const Out<T>& yo,
    bool gdc) {
  const WMat<T> Wphi{W, B, W_PHI}, Wm{W, B, W_M}, Wp1{W, B, W_P1},
      Wpp{W, B, W_PP}, Wh{W, B, W_H}, Wpht{W, B, W_PHT}, Ws{W, B, W_S},
      Wk{W, B, W_K}, Wrm{W, B, W_RM};
  const bool lead = role == 0;
  const bool defer = NP[NP_DEFER].v != 0;
  const int m = NP[NP_RADAR].v != 0 ? NM : NM - 1;
  // the lead's lane state, held across the barriers
  Q4<T> q;
  V3<T> v, p, bg, ba, omega_m;
  T y[NM], r[NM];
  T p_s = T(0), p_t = T(0), T_oat = T(0), h_radar = T(0);
  bool radar_valid = false, gps_new = false, baro_new = false,
       mag_new = false, radar_new = false;
  int n_new = 0;
  uint32_t bits[N_MON];
  bool alarm[N_MON];
  T nis[5];
  T A_acc[27];
  // ---- the elementwise part (lead): draws, sensors, faults, mechanisation
  if (lead && fires) {
    const T dt = NP[NP_DT];
    const uint32_t seed = uint32_t(ni[NI_SEED * B]);
    n_new = ni[NI_N * B] + 1;
    T e0[9], e1[20];
    epoch_draws(table, seed, uint32_t(n_new), e0, e1);
    // f_step: the bias walks and the GPS Gauss-Markov error
    const T sq = NP[NP_SQ];
    const T rwg = u(NU_RWG) * sq, rwa = u(NU_RWA) * sq;
    const V3<T> bg_s = {s(NS_BG) + rwg * e0[0], s(NS_BG + 1) + rwg * e0[1],
                        s(NS_BG + 2) + rwg * e0[2]};
    const V3<T> ba_s = {s(NS_BA) + rwa * e0[3], s(NS_BA + 1) + rwa * e0[4],
                        s(NS_BA + 2) + rwa * e0[5]};
    const T phi = Exp((T(1.0) / u(NU_GMT)) * (-dt));
    const T gmq = u(NU_GMS) * Sqrt(T(1.0) - phi * phi);
    const V3<T> gm = {phi * s(NS_GM) + gmq * e0[6],
                      phi * s(NS_GM + 1) + gmq * e0[7],
                      phi * s(NS_GM + 2) + gmq * e0[8]};
    if (store) {
      so.v3(NS_BG, bg_s);
      so.v3(NS_BA, ba_s);
      so.v3(NS_GM, gm);
    }
    // measure
    const V3<T> omega_ib_b =
        add(tr.om_eb, qrot_inv(tr.q_eb, V3<T>{T(0), T(0), T(OMEGA_IE)}));
    const V3<T> r_imu = sub(u.v3(NU_RIMU), tr.r_OG);
    const V3<T> f_imu =
        add(add(tr.f_c_c, cross(tr.alpha_ib_b, r_imu)),
            cross(omega_ib_b, cross(omega_ib_b, r_imu)));
    const T kg = u(NU_SCG) + T(1.0), ka = u(NU_SCA) + T(1.0);
    const T sgy = u(NU_SG), sac = u(NU_SA);
    omega_m = {(omega_ib_b.x * kg + bg_s.x) + sgy * e1[0],
               (omega_ib_b.y * kg + bg_s.y) + sgy * e1[1],
               (omega_ib_b.z * kg + bg_s.z) + sgy * e1[2]};
    const V3<T> f_m = {(f_imu.x * ka + ba_s.x) + sac * e1[3],
                       (f_imu.y * ka + ba_s.y) + sac * e1[4],
                       (f_imu.z * ka + ba_s.z) + sac * e1[5]};
    p_s = (tr.p + u(NU_BP)) + u(NU_SP) * e1[6];
    p_t = (tr.pt + u(NU_BPT)) + u(NU_SPT) * e1[7];
    p_t = p_t < p_s ? p_s : p_t;
    T_oat = tr.Tk + u(NU_ST) * e1[8];
    const T h_baro = (pressure_altitude(NP, p_s) -
                      pressure_altitude(NP, u(NU_QNH))) +
                     u(NU_BS) * e1[9];
    const T sm = u(NU_MS);
    const V3<T> mb0 = add(qrot_inv(tr.q_nb, u.v3(NU_MBN)), u.v3(NU_HI));
    const V3<T> mag_b = {mb0.x + sm * e1[10], mb0.y + sm * e1[11],
                         mb0.z + sm * e1[12]};
    const T spos = u(NU_SPOS);
    const V3<T> d_ned = {gm.x + spos * e1[13], gm.y + spos * e1[14],
                         gm.z + spos * e1[15]};
    T Mr, Nr;
    radii(tr.n_e, Mr, Nr);
    const T gps_lat = tr.lat + d_ned.x / (Mr + tr.h_e);
    const T gps_lon = tr.lon + d_ned.y / ((Nr + tr.h_e) * Cos(tr.lat));
    const T gps_h = tr.h_e - d_ned.z;
    const T svel = u(NU_SVEL);
    const V3<T> gps_v = {tr.v_eb_n.x + svel * e1[16],
                         tr.v_eb_n.y + svel * e1[17],
                         tr.v_eb_n.z + svel * e1[18]};
    const int every_gps = int(NP[NP_EVERY + EV_GPS].v);
    gps_new = n_new % every_gps == 0;
    const T h_agl = (tr.h_o - h_trn) + u(NU_RS) * e1[19];
    const T h_max = u(NU_HMAX);
    radar_valid = h_agl >= T(0.0) && h_agl <= h_max;
    h_radar = clamp_max(clamp_min(h_agl, T(0.0)), h_max);
    // the GPS fix in the filter's NED frame
    const T lat0 = u(NU_LAT0), lon0 = u(NU_LON0), h0 = u(NU_H0);
    const V3<T> n0 = nvector_from_latlon(lat0, lon0);
    T M0, N0;
    radii(n0, M0, N0);
    V3<T> p_gps = {(gps_lat - lat0) * (M0 + h0),
                   ((gps_lon - lon0) * (N0 + h0)) * Cos(lat0), h0 - gps_h};
    // the fault stage on the record index k = n - 1
    V3<T> v_gps = gps_v, m_f = mag_b;
    T h_f = h_baro;
    {
      const int ch = ni[NI_CH * B], mode = ni[NI_MODE * B];
      const int k0 = ni[NI_K0 * B], k1 = ni[NI_K1 * B];
      const int k = n_new - 1;
      const bool active = k >= k0, in_win = active && k < k1;
      const bool take = k <= k0;
      const T delta = u(NU_DELTA);
      const T ramp = (delta * dt) * T(double(max(k - k0, 0)));
      const V3<T> hgp = take ? p_gps : s.v3(NS_HGP);
      const V3<T> hgv = take ? gps_v : s.v3(NS_HGV);
      const T hhb = take ? h_baro : s(NS_HHB);
      const V3<T> hmg = take ? mag_b : s.v3(NS_HMG);
      if (store) {
        so.v3(NS_HGP, hgp);
        so.v3(NS_HGV, hgv);
        so.s(NS_HHB, hhb);
        so.v3(NS_HMG, hmg);
      }
      const bool gps_on = ch == FAULT_GPS, vel_on = ch == FAULT_GPS_VEL;
      const bool baro_on = ch == FAULT_BARO, mag_on = ch == FAULT_MAG;
      auto fz = [&](T z, T held, bool frz_on, bool bias_on, bool drp_on) {
        const bool frz = frz_on && active && mode == MODE_FREEZE;
        const bool bia = bias_on && active && mode == MODE_BIAS;
        const bool rmp = bias_on && active && mode == MODE_RAMP;
        const bool drp = drp_on && in_win && mode == MODE_DROPOUT;
        z = frz ? held : z;
        z = bia ? z + delta : z;
        z = rmp ? z + ramp : z;
        return drp ? T(0.0) : z;
      };
      p_gps = {fz(p_gps.x, hgp.x, gps_on, gps_on, false),
               fz(p_gps.y, hgp.y, gps_on, gps_on, false),
               fz(p_gps.z, hgp.z, gps_on, gps_on, false)};
      v_gps = {fz(gps_v.x, hgv.x, gps_on || vel_on, vel_on, vel_on),
               fz(gps_v.y, hgv.y, gps_on || vel_on, vel_on, vel_on),
               fz(gps_v.z, hgv.z, gps_on || vel_on, vel_on, vel_on)};
      h_f = fz(h_baro, hhb, baro_on, baro_on, baro_on);
      m_f = {fz(mag_b.x, hmg.x, mag_on, mag_on, mag_on),
             fz(mag_b.y, hmg.y, mag_on, mag_on, mag_on),
             fz(mag_b.z, hmg.z, mag_on, mag_on, mag_on)};
      gps_new = gps_new && !(gps_on && in_win && mode == MODE_DROPOUT);
    }
    // predict_mean and accum_A
    const Q4<T> q0 = s.q4(NS_Q);
    const V3<T> w = sub(omega_m, s.v3(NS_FBG));
    const V3<T> f = sub(f_m, s.v3(NS_FBA));
    q = qnormalize(qmul(q0, rvec_to_quat(scale(dt, w))));
    const M33<T> C = quat_to_matrix(q0);
    const V3<T> v0 = s.v3(NS_V), pn0 = s.v3(NS_P);
    const V3<T> a_n = add(mv(C, f), V3<T>{T(0.0), T(0.0), T(G_STD)});
    v = add(v0, scale(dt, a_n));
    const T dt2 = NP[NP_DT2];
    p = add(add(pn0, scale(dt, v0)), scale(dt2, scale(T(0.5), a_n)));
    bg = s.v3(NS_FBG);
    ba = s.v3(NS_FBA);
    const M33<T> Sw = skew(w), Sf = skew(f);
    const M33<T> Cf = mm(C, Sf);
    // the accumulator A (deferred) or this firing's parts alone (predict)
    auto a0 = [&](int k) { return defer ? s(k) : T(0.0); };
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        A_acc[3 * i + j] = a0(NS_AW + 3 * i + j) + Sw.m[i][j] * dt;
        A_acc[9 + 3 * i + j] = a0(NS_ACF + 3 * i + j) + Cf.m[i][j] * dt;
        A_acc[18 + 3 * i + j] = a0(NS_AC + 3 * i + j) + C.m[i][j] * dt;
      }
    const int nrec = n_new;
    const bool p_new = nrec % int(NP[NP_P_EVERY].v) == 0;
    baro_new = nrec % int(NP[NP_EVERY + EV_BARO].v) == 0;
    mag_new = nrec % int(NP[NP_EVERY + EV_MAG].v) == 0;
    const bool use_radar = NP[NP_RADAR].v != 0;
    const T h_meas = h_f - u(NU_DATUM);
    T h_radar_e = T(0.0);
    if (use_radar) {
      h_radar_e = (h_trn + h_radar) + u(NU_NGEO);
      radar_new = nrec % int(NP[NP_EVERY + EV_RADAR].v) == 0 &&
                  radar_valid && h_radar <= NP[NP_RADAR_MAX];
    }
    const bool aid = nrec % every_gps == 0 || baro_new || mag_new ||
                     (use_radar &&
                      nrec % int(NP[NP_EVERY + EV_RADAR].v) == 0);
#pragma unroll
    for (int k = 0; k < N_MON; ++k) {
      bits[k] = uint32_t(ni[(NI_BITS + k) * B]);
      alarm[k] = s(NS_ALARM + k).v != 0;
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) nis[k] = T(0.0);
    // the stacked rows (the mechanised state; P comes later)
    if (aid) {
      const V3<T> bn = u.v3(NU_BN);
      const T nb = norm3(bn);
      const V3<T> b_dir = {bn.x / nb, bn.y / nb, bn.z / nb};
      const V3<T> v_pred = qrot_inv(q, b_dir);
      const T nm = norm3(m_f) + T(1e-30);
      const V3<T> mm_ = {m_f.x / nm, m_f.y / nm, m_f.z / nm};
      const M33<T> Sv = skew(v_pred);
      if (store)
        for (int row = 0; row < NM; ++row)
          for (int col = 0; col < NX; ++col) {
            T hv = T(0.0);
            if (row < 3 && col == 6 + row) hv = T(1.0);
            if (row >= 3 && row < 6 && col == row) hv = T(1.0);
            if ((row == 6 || row == 10) && col == 8) hv = T(-1.0);
            if (row >= 7 && row < 10 && col < 3) hv = Sv.m[row - 7][col];
            Wh.set(row * NX + col, hv);
          }
      y[0] = p_gps.x - p.x, y[1] = p_gps.y - p.y, y[2] = p_gps.z - p.z;
      y[3] = v_gps.x - v.x, y[4] = v_gps.y - v.y, y[5] = v_gps.z - v.z;
      y[6] = (h_meas - h0) + p.z;
      y[7] = mm_.x - v_pred.x, y[8] = mm_.y - v_pred.y;
      y[9] = mm_.z - v_pred.z;
      y[10] = (h_radar_e - h0) + p.z;
#pragma unroll
      for (int k = 0; k < NM; ++k) r[k] = NP[NP_R + k];
    }
    if (store) {
      W[(size_t)W_FLAG * B] = T(aid ? 1.0 : 0.0);
      W[(size_t)(W_FLAG + 1) * B] = T((aid || !defer) && p_new ? 1.0 : 0.0);
      for (int k = 0; k < 27; ++k) W[(size_t)(W_A + k) * B] = A_acc[k];
    }
  }
  __syncthreads();
  const bool aid = fires && W[(size_t)W_FLAG * B].v != 0;
  const bool p_new = fires && W[(size_t)(W_FLAG + 1) * B].v != 0;
  // ---- propagate_P on the p_every cadence: Phi = I + Am + Am^2 / 2
  // (without defer_cov predict's Phi = I + Am, every firing)
  if (p_new && store) {  // Am's rows
    const T kdt = NP[NP_KDT], mhdt = NP[NP_MHDT];
    for (int i = role; i < NX; i += N_ROLES)
      for (int j = 0; j < NX; ++j) {
        const int bi = i / 3, bj = j / 3, ii = i % 3, jj = j % 3;
        const T a = W[(size_t)(W_A + 3 * ii + jj) * B];
        const T acf = W[(size_t)(W_A + 9 + 3 * ii + jj) * B];
        const T ac = W[(size_t)(W_A + 18 + 3 * ii + jj) * B];
        const T dg = ii == jj ? kdt : T(0.0);
        T v_ = T(0.0);
        if (bi == 0 && bj == 0) v_ = -a;
        if (bi == 0 && bj == 3) v_ = -dg;
        if (bi == 1 && bj == 0) v_ = -acf;
        if (bi == 1 && bj == 4) v_ = -ac;
        if (bi == 2 && bj == 0) v_ = mhdt * acf;
        if (bi == 2 && bj == 1) v_ = dg;
        if (bi == 2 && bj == 4) v_ = mhdt * ac;
        Wm.set(i * NX + j, v_);
      }
  }
  __syncthreads();
  if (p_new && store) {
    for (int i = role; i < NX; i += N_ROLES)
      for (int j = 0; j < NX; ++j) {
        const T I = T(i == j ? 1.0 : 0.0);
        T phi = I + Wm.get(i * NX + j);
        if (defer) {
          T acc = T(0.0);
          for (int k = 0; k < NX; ++k)
            acc = acc + Wm.get(i * NX + k) * Wm.get(k * NX + j);
          phi = phi + T(0.5) * acc;
        }
        Wphi.set(i * NX + j, phi);
      }
  }
  __syncthreads();
  if (p_new && store) {  // Phi P0
    for (int i = role; i < NX; i += N_ROLES)
      for (int j = 0; j < NX; ++j) {
        T acc = T(0.0);
        for (int k = 0; k < NX; ++k)
          acc = acc + Wphi.get(i * NX + k) * s(NS_PP + k * NX + j);
        Wm.set(i * NX + j, acc);
      }
  }
  __syncthreads();
  if (p_new && store) {  // (Phi P0) Phi^T + Q p_every
    for (int i = role; i < NX; i += N_ROLES)
      for (int j = 0; j < NX; ++j) {
        T acc = T(0.0);
        for (int k = 0; k < NX; ++k)
          acc = acc + Wm.get(i * NX + k) * Wphi.get(j * NX + k);
        Wp1.set(i * NX + j, acc + (i == j ? NP[NP_QK + i] : T(0.0)));
      }
  }
  __syncthreads();
  if (p_new && store) {
    for (int i = role; i < NX; i += N_ROLES)
      for (int j = 0; j < NX; ++j)
        Wpp.set(i * NX + j, T(0.5) * (Wp1.get(i * NX + j) +
                                      Wp1.get(j * NX + i)));
  }
  __syncthreads();
  // the P the aiding block reads: propagated or the state's
  auto Pget = [&](int k) { return p_new ? Wpp.get(k) : s(NS_PP + k); };
  // ---- P H^T and S = H P H^T + diag(r)
  if (aid && store) {
    for (int i = role; i < NX; i += N_ROLES)
      for (int a = 0; a < m; ++a) {
        T acc = T(0.0);
        for (int k = 0; k < NX; ++k)
          acc = acc + Pget(i * NX + k) * Wh.get(a * NX + k);
        Wpht.set(i * NM + a, acc);
      }
  }
  __syncthreads();
  if (aid && store) {
    for (int a = role; a < m; a += N_ROLES)
      for (int b2 = 0; b2 < m; ++b2) {
        T acc = T(0.0);
        for (int k = 0; k < NX; ++k)
          acc = acc + Wh.get(a * NX + k) * Wpht.get(k * NM + b2);
        Ws.set(a * NM + b2, acc + (a == b2 ? NP[NP_R + a] : T(0.0)));
      }
  }
  __syncthreads();
  // ---- the NIS values, the monitors, the masked update's gain (lead)
  if (lead && aid) {
    T S[NM * NM], X[NM * NX];
    for (int k = 0; k < m * NM; ++k) S[k] = Ws.get(k);
    nis[NIS_GPS] = nis_of(S, y, 0, 3);
    nis[NIS_VEL] = nis_of(S, y, 3, 3);
    nis[NIS_BARO] = nis_of(S, y, 6, 1);
    nis[NIS_MAG] = nis_of(S, y, 7, 3);
    nis[NIS_RADAR] = m == NM ? nis_of(S, y, 10, 1) : T(0.0);
    const T* g = NP + NP_GATE;
    const int win = int(NP[NP_WIN].v), hits = int(NP[NP_HITS].v);
    const bool a_pos = monitor_step(bits[MON_GPS], alarm[MON_GPS],
                                    gps_new && nis[NIS_GPS] > g[0],
                                    gps_new, win, hits);
    const bool a_vel = monitor_step(bits[MON_VEL], alarm[MON_VEL],
                                    gps_new && nis[NIS_VEL] > g[1],
                                    gps_new, win, hits);
    const bool a_bar = monitor_step(bits[MON_BARO], alarm[MON_BARO],
                                    baro_new && nis[NIS_BARO] > g[2],
                                    baro_new, win, hits);
    const bool a_mag = monitor_step(bits[MON_MAG], alarm[MON_MAG],
                                    mag_new && nis[NIS_MAG] > g[3], mag_new,
                                    win, hits);
    const bool a_rad = monitor_step(bits[MON_RADAR], alarm[MON_RADAR],
                                    radar_new && nis[NIS_RADAR] > g[4],
                                    radar_new, win, hits);
    alarm[MON_GPS] = a_pos, alarm[MON_VEL] = a_vel, alarm[MON_BARO] = a_bar;
    alarm[MON_MAG] = a_mag, alarm[MON_RADAR] = a_rad;
    const bool mg = gps_new && !(a_pos || a_vel) && nis[NIS_GPS] <= g[0] &&
                    nis[NIS_VEL] <= g[1];
    const bool mb = baro_new && !a_bar && nis[NIS_BARO] <= g[2];
    const bool mmg = mag_new && !a_mag && nis[NIS_MAG] <= g[3];
    const bool mr = radar_new && !a_rad && nis[NIS_RADAR] <= g[4];
    bool mask[NM];
    for (int a = 0; a < NM; ++a)
      mask[a] = a < 6 ? mg : a == 6 ? mb : a < 10 ? mmg : mr;
    // update_stacked: masked rows zeroed in H, y, P H^T and S, their
    // diagonal reset to 1
    T rm[NM], ym[NM];
    for (int a = 0; a < m; ++a) {
      const T mf = T(mask[a] ? 1.0 : 0.0);
      ym[a] = y[a] * mf;
      rm[a] = mask[a] ? r[a] : T(1.0);
      for (int b2 = 0; b2 < m; ++b2) {
        const T mf2 = T(mask[b2] ? 1.0 : 0.0);
        const T d = S[a * NM + b2];
        S[a * NM + b2] = a == b2 ? (mask[a] ? d : T(1.0)) : d * (mf * mf2);
      }
      for (int k = 0; k < NX; ++k) X[a * NX + k] = Wpht.get(k * NM + a) * mf;
      if (store) {
        Wrm.set(a, rm[a]);
        for (int k = 0; k < NX; ++k)
          Wh.set(a * NX + k, Wh.get(a * NX + k) * mf);
      }
    }
    blocked_spd_solve(S, X, m == NM ? 5 : 4);
    // K = X^T; dx = K ym; the injection
    T dx[NX];
    for (int k = 0; k < NX; ++k) {
      T acc = T(0.0);
      for (int a = 0; a < m; ++a) {
        if (store) Wk.set(k * NM + a, X[a * NX + k]);
        acc = acc + X[a * NX + k] * ym[a];
      }
      dx[k] = acc;
    }
    q = qnormalize(qmul(q, rvec_to_quat(V3<T>{dx[0], dx[1], dx[2]})));
    v = add(v, V3<T>{dx[3], dx[4], dx[5]});
    p = add(p, V3<T>{dx[6], dx[7], dx[8]});
    bg = add(bg, V3<T>{dx[9], dx[10], dx[11]});
    ba = add(ba, V3<T>{dx[12], dx[13], dx[14]});
  }
  __syncthreads();
  // ---- the Joseph update: P2 = (I - K H) P (I - K H)^T + K diag(r) K^T
  if (aid && store) {  // I - K Hm
    for (int i = role; i < NX; i += N_ROLES)
      for (int j = 0; j < NX; ++j) {
        T acc = T(0.0);
        for (int a = 0; a < m; ++a)
          acc = acc + Wk.get(i * NM + a) * Wh.get(a * NX + j);
        Wphi.set(i * NX + j, T(i == j ? 1.0 : 0.0) - acc);
      }
  }
  __syncthreads();
  if (aid && store) {  // (I - K H) P
    for (int i = role; i < NX; i += N_ROLES)
      for (int j = 0; j < NX; ++j) {
        T acc = T(0.0);
        for (int k = 0; k < NX; ++k)
          acc = acc + Wphi.get(i * NX + k) * Pget(k * NX + j);
        Wm.set(i * NX + j, acc);
      }
  }
  __syncthreads();
  if (aid && store) {
    for (int i = role; i < NX; i += N_ROLES)
      for (int j = 0; j < NX; ++j) {
        T acc = T(0.0), kr = T(0.0);
        for (int k = 0; k < NX; ++k)
          acc = acc + Wm.get(i * NX + k) * Wphi.get(j * NX + k);
        for (int a = 0; a < m; ++a)
          kr = kr + (Wk.get(i * NM + a) * Wrm.get(a)) * Wk.get(j * NM + a);
        Wp1.set(i * NX + j, acc + kr);
      }
  }
  __syncthreads();
  // ---- the new P (symmetrised) and the state
  if (store) {
    for (int i = role; i < NX; i += N_ROLES)
      for (int j = 0; j < NX; ++j) {
        const int k = i * NX + j;
        const T v_ = !fires ? s(NS_PP + k)
                     : aid ? T(0.5) * (Wp1.get(k) + Wp1.get(j * NX + i))
                           : Pget(k);
        so.s(NS_PP + k, v_);
      }
  }
  if (!lead || !store) return;
  if (!fires) {  // the state passes through
    for (int k = 0; k < N_NAVS; ++k)
      if (k < NS_PP || k >= NS_PP + NX * NX) so.s(k, s(k));
    for (int k = 0; k < N_NAVI; ++k) no[k * B] = ni[k * B];
    return;
  }
  so.q4(NS_Q, q);
  so.v3(NS_V, v);
  so.v3(NS_P, p);
  so.v3(NS_FBG, bg);
  so.v3(NS_FBA, ba);
  for (int k = 0; k < 27; ++k)
    so.s(NS_AW + k, !defer ? s(NS_AW + k) : p_new ? T(0.0) : A_acc[k]);
  // the channels' last NIS where they had an epoch
  so.s(NS_NIS + NIS_BARO, baro_new ? nis[NIS_BARO] : s(NS_NIS + NIS_BARO));
  so.s(NS_NIS + NIS_GPS, gps_new ? nis[NIS_GPS] : s(NS_NIS + NIS_GPS));
  so.s(NS_NIS + NIS_VEL, gps_new ? nis[NIS_VEL] : s(NS_NIS + NIS_VEL));
  so.s(NS_NIS + NIS_MAG, mag_new ? nis[NIS_MAG] : s(NS_NIS + NIS_MAG));
  so.s(NS_NIS + NIS_RADAR,
       radar_new ? nis[NIS_RADAR] : s(NS_NIS + NIS_RADAR));
  for (int k = 0; k < N_MON; ++k) {
    so.s(NS_ALARM + k, T(alarm[k] ? 1.0 : 0.0));
    no[(NI_BITS + k) * B] = int(bits[k]);
  }
  for (int k = 0; k < NI_BITS; ++k) no[k * B] = ni[k * B];
  no[NI_N * B] = n_new;
  // ---- the estimated VehicleY (estimate_airspeed, the kinematics)
  if (NP[NP_USE_EST].v == 0) return;
  const T Dp = clamp_min(p_t - p_s, T(0.0));
  const T M2 = T(2.0 / (GAMMA - 1.0)) *
               (Pow(T(1.0) + Dp / p_s, T((GAMMA - 1.0) / GAMMA)) - T(1.0));
  const T a_s = Sqrt(T(GAMMA * R_GAS) * T_oat);
  const T TAS = Sqrt(M2) * a_s;
  const T rho = p_s / (T(R_GAS) * T_oat);
  const T EAS = TAS * Sqrt(rho / T(RHO_STD));
  const T lat0 = u(NU_LAT0), lon0 = u(NU_LON0), h0 = u(NU_H0);
  const V3<T> om_ie_n = {T(OMEGA_IE) * Cos(lat0), T(OMEGA_IE) * T(0.0),
                         T(OMEGA_IE) * (-Sin(lat0))};
  const V3<T> omega_est = sub(sub(omega_m, bg), qrot_inv(q, om_ie_n));
  yo.v3(CY_OM_WB, omega_est);
  yo.v3(CY_OM_EB, omega_est);
  yo.v3(CY_E_NB, quat_to_euler(q));
  yo.v3(CY_V_EB_N, v);
  yo.s(CY_CHI, Atan2(v.y, v.x));
  yo.s(CY_EAS, EAS);
  yo.s(CY_H_E, h0 - p.z);
  if (gdc) {
    const V3<T> n0 = nvector_from_latlon(lat0, lon0);
    T M0, N0;
    radii(n0, M0, N0);
    const T lat_e = lat0 + p.x / (M0 + h0);
    const T lon_e = lon0 + p.y / ((N0 + h0) * Cos(lat0));
    yo.v3(CY_N_E, nvector_from_latlon(lat_e, lon_e));
  }
  // systems_est: the airflow angles by the policy (yo holds the truth's)
  const int ab = int(NP[NP_AB].v);
  if (ab == AB_SYNTHETIC) {
    const V3<T> e = quat_to_euler(q);  // (psi, theta, phi)
    const T sin_ga =
        clamp(-v.z / clamp_min(TAS, T(10.0)), T(-0.99), T(0.99));
    const T alpha = (e.y - Asin(sin_ga)) / clamp_min(Cos(e.z), T(0.5));
    yo.s(CY_ALPHA, alpha);
    yo.s(CY_ALPHA_F, alpha);
    yo.s(CY_BETA, T(0.0));
    yo.s(CY_BETA_F, T(0.0));
  } else if (ab == AB_PERTURB) {
    auto y = [&](int r) { return yo.buf[r * yo.B + yo.b]; };
    const T da = NP[NP_DA], db = NP[NP_DB];
    yo.s(CY_ALPHA, y(CY_ALPHA) + da);
    yo.s(CY_ALPHA_F, y(CY_ALPHA_F) + da);
    yo.s(CY_BETA, y(CY_BETA) + db);
    yo.s(CY_BETA_F, y(CY_BETA_F) + db);
  }
}

}  // namespace fj
