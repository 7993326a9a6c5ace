// The C172X's gain-scheduled multimode control laws as per-aircraft
// __device__ functions: the discrete control primitives, the gain
// schedules, wrap_to_pi and the lon and lat passes of ControlLaws
// (flightjax_torch/models/c172/c172x_ctl.py, flightjax_torch/physics/
// control.py), in Strict<F> like the rest of flight_math.cuh, operation by
// operation and in the same association order as the plain PyTorch port.
// ctl_laws.cu runs the pass alone over a fleet; the fly-by-wire instances
// of megakernel.cu run it inside the whole step, when it fires. The
// C172Xv2's guidance (c172x_gdc.cuh) overrides some requests first.
//
// The pass reads the VehicleY fields of CTL_Y (below), the avionics' inputs
// u and their discrete state s (modes, the altitude machine's state and
// the saturation flags as exact small integers in T), and writes the new s
// and the four servo commands. The plain version works every
// sub-controller out on every lane and selects (tree_where); a disabled
// sub-controller neither advances its state nor is selected, so here it is
// skipped and its state rows pass through, which gives the same rows.
//
// The gains arrive in one buffer (flightjax_torch/parallel/kernels.py::
// ctl_gains): the offsets of N_GAIN_TABLES tables, then the tables as
// flight_math.cuh::lookup reads them, each a channel's gains stacked on the
// trailing axis over the (EAS, h) grid with flat extrapolation: the lon
// channels first, then the lat ones. The fused schedule of the plain
// version interpolates the same cell with the same weights in the same
// corner order, so a channel's values are the same. The buffer is read
// through the cache, not copied into shared memory.
#pragma once

#include "c172_systems.cuh"

namespace fj {

// ------------------------------------------------------------- row maps

// lon modes and lat modes (models/c172/c172x_ctl.py), the altitude
// machine's states
constexpr int LON_DIRECT = 0, LON_SAS = 1, LON_THR_Q = 2, LON_THR_THETA = 3,
              LON_THR_EAS = 4, LON_EAS_Q = 5, LON_EAS_THETA = 6,
              LON_EAS_CLM = 7, LON_EAS_ALT = 8;
constexpr int LAT_DIRECT = 0, LAT_SAS = 1, LAT_P_BETA = 2, LAT_PHI_BETA = 3,
              LAT_CHI_BETA = 4;
constexpr int ALT_ACQUIRE = 0, ALT_HOLD = 1;
constexpr double K_P_THETA = 1.0, H_THR = 10.0, H_HYS = 1.0;

// the states of the primitives: an LQR tracker's int_out_0[2] and
// out_sat_0[2], an integrator's x0 and sat_out_0, a PID's x_i0, x_d0 and
// sat_out_0
constexpr int LQ_INT = 0, LQ_SAT = 2, LQ_N = 4;
constexpr int IN_X0 = 0, IN_SAT = 1, IN_N = 2;
constexpr int PD_XI = 0, PD_XD = 1, PD_SAT = 2, PD_N = 3;

// avionics inputs u: lon, then lat
constexpr int UL_MODE = 0, UL_THR_AXIS = 1, UL_THR_OFF = 2, UL_ELV_AXIS = 3,
              UL_ELV_OFF = 4, UL_Q_REF = 5, UL_THETA_REF = 6, UL_EAS_REF = 7,
              UL_CLM_REF = 8, UL_H_REF = 9, N_ULON = 10;
constexpr int UA_MODE = 0, UA_AIL_AXIS = 1, UA_AIL_OFF = 2, UA_RUD_AXIS = 3,
              UA_RUD_OFF = 4, UA_P_REF = 5, UA_BETA_REF = 6, UA_PHI_REF = 7,
              UA_CHI_REF = 8, N_ULAT = 9;
// avionics state s: lon (29 rows), then lat (20 rows)
constexpr int SL_MODE = 0, SL_H_STATE = 1, SL_TE2TE = 2,
              SL_TV2TE = SL_TE2TE + LQ_N, SL_VH2TE = SL_TV2TE + LQ_N,
              SL_Q2E_INT = SL_VH2TE + LQ_N, SL_Q2E_PID = SL_Q2E_INT + IN_N,
              SL_C2T_PID = SL_Q2E_PID + PD_N, SL_V2T_PID = SL_C2T_PID + PD_N,
              SL_PREV_THR = SL_V2T_PID + PD_N, SL_PREV_ELV = SL_PREV_THR + 1,
              SL_OUT_THR = SL_PREV_ELV + 1, SL_OUT_ELV = SL_OUT_THR + 1,
              N_SLON = SL_OUT_ELV + 1;
constexpr int SA_MODE = 0, SA_AR2AR = 1, SA_PB2AR = SA_AR2AR + LQ_N,
              SA_P2PHI_INT = SA_PB2AR + LQ_N,
              SA_P2PHI_PID = SA_P2PHI_INT + IN_N,
              SA_CHI2PHI_PID = SA_P2PHI_PID + PD_N,
              SA_PREV_PHI = SA_CHI2PHI_PID + PD_N, SA_OUT_AIL = SA_PREV_PHI + 1,
              SA_OUT_RUD = SA_OUT_AIL + 1, N_SLAT = SA_OUT_RUD + 1;
// the avionics block of a buffer: u lon, u lat, s lon, s lat
constexpr int AV_ULON = 0, AV_ULAT = AV_ULON + N_ULON,
              AV_SLON = AV_ULAT + N_ULAT, AV_SLAT = AV_SLON + N_SLON,
              N_AV = AV_SLAT + N_SLAT;                              // 68

// the four commanded channels, in the order of their names
constexpr int CC_AIL = 0, CC_ELV = 1, CC_RUD = 2, CC_THR = 3, N_CMD = 4;
// CTL_Y, the VehicleY fields the control laws read: omega_wb_b, omega_eb_b,
// e_nb, v_eb_n, chi_gnd, EAS, h_e; the gated airflow angles and their
// filters; the engine's speed ratio; the four commands clipped to their
// servos' ranges and the four servo positions (act cmd and pos); each leg's
// weight on wheels
constexpr int CY_OM_WB = 0, CY_OM_EB = 3, CY_E_NB = 6, CY_V_EB_N = 9,
              CY_CHI = 12, CY_EAS = 13, CY_H_E = 14, CY_ALPHA = 15,
              CY_BETA = 16, CY_ALPHA_F = 17, CY_BETA_F = 18, CY_N = 19,
              CY_CMD = 20, CY_POS = CY_CMD + N_CMD, CY_WOW = CY_POS + N_CMD,
              N_CTLY = CY_WOW + N_LEGS;                             // 31
// ctl_laws: in = CTL_Y, the avionics block ; out = s lon, s lat, commands
constexpr int CTL_N_IN = N_CTLY + N_AV;                              // 99
constexpr int CTL_N_OUT = N_SLON + N_SLAT + N_CMD;                   // 53

// the fly-by-wire megakernel's state buffer: t, X, CTX, C as the C172S's
// (fly-by-wire rows), then the avionics block
constexpr int MG_AV_FBW = 1 + N_X_FBW + N_CTX_FBW + N_C;
constexpr int MEGA_N_ROWS_FBW = MG_AV_FBW + N_AV;                    // 141

// the gain tables: lon channels, then lat; a PID's k_p, k_i, k_d, tau_f, an
// LQR tracker's K_fbk[2][NX], K_fwd[2][2], K_int[2][2], x_trim[NX],
// u_trim[2], z_trim[2]
constexpr int GT_V2T = 0, GT_C2THETA = 1, GT_Q2E = 2, GT_TE2TE = 3,
              GT_TV2TE = 4, GT_VH2TE = 5, GT_P2PHI = 6, GT_CHI2PHI = 7,
              GT_AR2AR = 8, GT_PB2AR = 9, N_GAIN_TABLES = 10;
constexpr int NX_RED = 8, NX_FULL = 9, N_PID_GAINS = 4;

// ------------------------------------------------------------- primitives
// flightjax_torch/physics/control.py

// saturation_status: +1 at or above hi, -1 at or below lo
template <typename T>
__device__ __forceinline__ int saturation(T x, T lo, T hi) {
  return int(x >= hi) - int(x <= lo);
}

// _halted: integration halts where the input pushes further into the
// previous output saturation or the external one
template <typename T>
__device__ __forceinline__ T alive_of(T inp, int sat0, int sat_ext) {
  const bool halted =
      inp * T(double(sat0)) > T(0) || inp * T(double(sat_ext)) > T(0);
  return T(1.0) - T(halted ? 1.0 : 0.0);
}

// x shifted by a multiple of 2 pi into (-pi, pi] (ops/attitude.py)
template <typename T>
__device__ __forceinline__ T wrap_to_pi(T x) {
  return x + T(2.0 * PI) * Floor((T(PI) - x) / T(2.0 * PI));
}

template <typename T>
struct Integ {
  T x0;
  int sat;
};

template <typename T>
struct Pid {
  T x_i, x_d;
  int sat;
};

template <typename T>
struct Lqr {
  T out[2];  // int_out_0
  int sat[2];
};

template <typename T>
__device__ __forceinline__ Integ<T> load_integ(const Col<T>& s, int r) {
  return {s(r + IN_X0), int(s(r + IN_SAT).v)};
}
template <typename T>
__device__ __forceinline__ void store_integ(const Out<T>& o, int r,
                                            const Integ<T>& v) {
  o.s(r + IN_X0, v.x0);
  o.s(r + IN_SAT, T(double(v.sat)));
}
template <typename T>
__device__ __forceinline__ Pid<T> load_pid(const Col<T>& s, int r) {
  return {s(r + PD_XI), s(r + PD_XD), int(s(r + PD_SAT).v)};
}
template <typename T>
__device__ __forceinline__ void store_pid(const Out<T>& o, int r,
                                          const Pid<T>& v) {
  o.s(r + PD_XI, v.x_i);
  o.s(r + PD_XD, v.x_d);
  o.s(r + PD_SAT, T(double(v.sat)));
}
template <typename T>
__device__ __forceinline__ Lqr<T> load_lqr(const Col<T>& s, int r) {
  return {{s(r + LQ_INT), s(r + LQ_INT + 1)},
          {int(s(r + LQ_SAT).v), int(s(r + LQ_SAT + 1).v)}};
}
template <typename T>
__device__ __forceinline__ void store_lqr(const Out<T>& o, int r,
                                          const Lqr<T>& v) {
  o.s(r + LQ_INT, v.out[0]);
  o.s(r + LQ_INT + 1, v.out[1]);
  o.s(r + LQ_SAT, T(double(v.sat[0])));
  o.s(r + LQ_SAT + 1, T(double(v.sat[1])));
}
// rows r..r+n-1 of s unchanged: a sub-controller that is off
template <typename T>
__device__ __forceinline__ void pass_rows(const Col<T>& s, const Out<T>& o,
                                          int r, int n) {
  for (int k = 0; k < n; ++k) o.s(r + k, s(r + k));
}

// the PID re-seeded on a mode change (c172x_ctl.py::_pid_reset)
template <typename T>
__device__ __forceinline__ Pid<T> pid_reset(T seed, T k_i) {
  return {k_i != T(0) ? seed : T(0.0), T(0.0), 0};
}

// integrator_step, unbounded: returns its output x1
template <typename T>
__device__ __forceinline__ T integrator_step(Integ<T>& s, T inp, T dt,
                                             int sat_ext) {
  const T x1 = s.x0 + dt * inp * alive_of(inp, s.sat, sat_ext);
  s.x0 = x1;
  s.sat = saturation(x1, T(-INFINITY), T(INFINITY));
  return x1;
}

// pid_step with the gains g = (k_p, k_i, k_d, tau_f), beta_p = beta_d = 1:
// alpha = 1 / (tau_f + dt) the true quotient, the output clipped to
// [lo, hi]
template <typename T>
__device__ __forceinline__ T pid_step(const T (&g)[N_PID_GAINS], Pid<T>& s,
                                      T inp, T dt, int sat_ext, T lo, T hi) {
  const T k_p = g[0], k_i = g[1], k_d = g[2], tau_f = g[3];
  const T alpha = T(1.0) / (tau_f + dt);
  const T x_i = s.x_i + dt * k_i * inp * alive_of(inp, s.sat, sat_ext);
  const T x_d = alpha * tau_f * s.x_d + dt * alpha * k_d * inp;
  const T y_d = alpha * (-s.x_d + k_d * inp);
  const T out_free = k_p * inp + x_i + y_d;
  s.x_i = x_i;
  s.x_d = x_d;
  s.sat = saturation(out_free, lo, hi);
  return clamp(out_free, lo, hi);
}

// lqr_step on x (NX), z and z_ref (2) with the gains g: the matrix-vector
// products summed left to right; outputs clipped to [lo, hi]
template <typename T, int NX>
__device__ __forceinline__ void lqr_step(const T* g, Lqr<T>& s,
                                         const T (&x)[NX], const T (&z)[2],
                                         const T (&z_ref)[2], T dt,
                                         const T (&lo)[2], const T (&hi)[2],
                                         T (&out)[2]) {
  const T* K_fbk = g;
  const T* K_fwd = K_fbk + 2 * NX;
  const T* K_int = K_fwd + 4;
  const T* x_trim = K_int + 4;
  const T* u_trim = x_trim + NX;
  const T* z_trim = u_trim + 2;
  const T e[2] = {z_ref[0] - z[0], z_ref[1] - z[1]};
  const T ef[2] = {z_ref[0] - z_trim[0], z_ref[1] - z_trim[1]};
  T dx[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) dx[k] = x[k] - x_trim[k];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const T int_in = K_int[2 * u] * e[0] + K_int[2 * u + 1] * e[1];
    const T int_out = s.out[u] + dt * int_in * alive_of(int_in, s.sat[u], 0);
    const T fwd = K_fwd[2 * u] * ef[0] + K_fwd[2 * u + 1] * ef[1];
    T fbk = K_fbk[NX * u] * dx[0];
#pragma unroll
    for (int k = 1; k < NX; ++k) fbk = fbk + K_fbk[NX * u + k] * dx[k];
    const T out_free = u_trim[u] + int_out + fwd - fbk;
    s.out[u] = int_out;
    s.sat[u] = saturation(out_free, lo[u], hi[u]);
    out[u] = clamp(out_free, lo[u], hi[u]);
  }
}

// the gains of table k at (EAS, h)
template <typename T, int W>
__device__ __forceinline__ LookupOut<T, W> gains(const T* G, int k, T EAS,
                                                 T h) {
  return lookup<T, 2, W>(G + int(G[k].v), EAS, h, T(0));
}

template <typename T>
__device__ __forceinline__ void pid_gains(const T* G, int k, T EAS, T h,
                                          T (&g)[N_PID_GAINS]) {
  const LookupOut<T, N_PID_GAINS> v = gains<T, N_PID_GAINS>(G, k, EAS, h);
#pragma unroll
  for (int j = 0; j < N_PID_GAINS; ++j) g[j] = v.v[j];
}

template <typename T>
__device__ __forceinline__ bool on_ground(const Col<T>& y) {
  return y(CY_WOW).v != 0 || y(CY_WOW + 1).v != 0 || y(CY_WOW + 2).v != 0;
}

// the commands a pass writes: throttle and elevator (lon), aileron and
// rudder (lat)
template <typename T>
struct Cmd2 {
  T a, b;
};

// the guidance's override of one side's requests (c172x_gdc.py::
// GuidanceLaws.override_ctl_u): where `on`, the side's mode request is its
// guided mode (lon LON_EAS_ALT, lat LAT_CHI_BETA) and `ref` its reference
// (lon h_ref, lat chi_ref). The passes read it only in their GDC instances
// (the C172Xv2's), so those of the C172Xv1 are what they were.
template <typename T>
struct Ovr {
  bool on;
  T ref;
};

// ------------------------------------------------------------- lon pass
// ControlLaws.lon_step (c172x_ctl.py): y the CTL_Y rows, u the lon inputs,
// s the lon state of the lane; writes the new lon state to so and returns
// (throttle_cmd, elevator_cmd). One function, not inlined: one warp calls it.
// With GDC the guidance's override `ovr` takes the place of the altitude
// reference and the mode request where it is on.
template <typename T, bool GDC = false>
__device__ __noinline__ Cmd2<T> lon_step(const T* G, Col<T> y, Col<T> u,
                                         Col<T> s, Out<T> so, T dt,
                                         Ovr<T> ovr = Ovr<T>{}) {
  const T one = T(1.0), zero = T(0.0), inf = T(INFINITY);
  const T EAS = y(CY_EAS), h_e = y(CY_H_E);
  const bool guided = GDC && ovr.on;
  const T h_ref = guided ? ovr.ref : u(UL_H_REF);
  const T h_err = h_ref - h_e;
  const int mode_prev = int(s(SL_MODE).v);
  const int h_state = int(s(SL_H_STATE).v);
  const int mode_req = guided ? LON_EAS_ALT : int(u(UL_MODE).v);
  T throttle_ref =
      clamp(clamp(u(UL_THR_AXIS), zero, one) + u(UL_THR_OFF), zero, one);
  T elevator_ref =
      clamp(clamp(u(UL_ELV_AXIS), -one, one) + u(UL_ELV_OFF), -one, one);

  // mode arbitration and the altitude acquire / hold machine
  const bool acquiring = h_state == ALT_ACQUIRE;
  const bool alt_req = mode_req == LON_EAS_ALT;
  const int mode_air =
      alt_req ? (acquiring ? LON_THR_EAS : LON_EAS_ALT) : mode_req;
  if (alt_req && acquiring) throttle_ref = h_err > zero ? one : zero;
  const T ah = Abs(h_err);
  const int h_state_new =
      !alt_req ? h_state
      : acquiring ? (ah < T(H_THR - H_HYS) ? ALT_HOLD : ALT_ACQUIRE)
                  : (ah > T(H_THR + H_HYS) ? ALT_ACQUIRE : ALT_HOLD);
  const int mode = on_ground(y) ? LON_DIRECT : mode_air;
  const bool changed = mode != mode_prev;
  const bool te2te_on = mode == LON_SAS || mode == LON_THR_Q ||
                        mode == LON_THR_THETA || mode == LON_EAS_Q ||
                        mode == LON_EAS_THETA || mode == LON_EAS_CLM;
  const bool q2e_on = te2te_on && mode != LON_SAS;
  const bool t2q_on = mode == LON_THR_THETA || mode == LON_EAS_THETA ||
                      mode == LON_EAS_CLM;
  const bool v2t_on = mode == LON_EAS_Q || mode == LON_EAS_THETA ||
                      mode == LON_EAS_CLM;
  const bool c2t_on = mode == LON_EAS_CLM;
  const bool tv2te_on = mode == LON_THR_EAS;
  const bool vh2te_on = mode == LON_EAS_ALT;
  // the previous te2te saturation feeds the upstream compensators
  const int sat_thr = int(s(SL_TE2TE + LQ_SAT).v);
  const int sat_ele = int(s(SL_TE2TE + LQ_SAT + 1).v);
  T g[N_PID_GAINS];

  // v2t: EAS -> throttle_ref
  if (v2t_on) {
    pid_gains(G, GT_V2T, EAS, h_e, g);
    Pid<T> p = changed ? pid_reset(s(SL_PREV_THR), g[1])
                       : load_pid(s, SL_V2T_PID);
    throttle_ref = pid_step(g, p, u(UL_EAS_REF) - EAS, dt, sat_thr, -inf, inf);
    store_pid(so, SL_V2T_PID, p);
  } else {
    pass_rows(s, so, SL_V2T_PID, PD_N);
  }

  // c2theta: climb rate -> theta_ref
  const T theta = y(CY_E_NB + 1);
  T theta_ref = u(UL_THETA_REF);
  if (c2t_on) {
    pid_gains(G, GT_C2THETA, EAS, h_e, g);
    Pid<T> p = changed ? pid_reset(theta, g[1]) : load_pid(s, SL_C2T_PID);
    theta_ref = pid_step(g, p, u(UL_CLM_REF) - -y(CY_V_EB_N + 2), dt,
                         sat_ele, -inf, inf);
    store_pid(so, SL_C2T_PID, p);
  } else {
    pass_rows(s, so, SL_C2T_PID, PD_N);
  }

  // q2e: pitch rate -> elevator_ref, after theta2q with bank compensation
  if (q2e_on) {
    T q_ref = u(UL_Q_REF);
    if (t2q_on) {
      const T theta_dot_ref = T(K_P_THETA) * (theta_ref - theta);
      const T phi_bnd = clamp(y(CY_E_NB + 2), T(-PI / 3), T(PI / 3));
      q_ref = theta_dot_ref / Cos(phi_bnd) + y(CY_OM_WB + 2) * Tan(phi_bnd);
    }
    pid_gains(G, GT_Q2E, EAS, h_e, g);
    Integ<T> it = changed ? Integ<T>{T(0.0), 0} : load_integ(s, SL_Q2E_INT);
    Pid<T> p = changed ? pid_reset(s(SL_PREV_ELV), g[1])
                       : load_pid(s, SL_Q2E_PID);
    const T i_out =
        integrator_step(it, q_ref - y(CY_OM_WB + 1), dt, sat_ele);
    elevator_ref = pid_step(g, p, i_out, dt, sat_ele, -inf, inf);
    store_integ(so, SL_Q2E_INT, it);
    store_pid(so, SL_Q2E_PID, p);
  } else {
    pass_rows(s, so, SL_Q2E_INT, IN_N + PD_N);
  }

  // the inner trackers: te2te (the SAS, purely proportional, no reset),
  // tv2te (throttle + EAS), vh2te (EAS + altitude); at most one is on
  T cmd[2] = {throttle_ref, elevator_ref};
  const T lo[2] = {zero, -one}, hi[2] = {one, one};
  const int tracker = te2te_on ? SL_TE2TE
                      : tv2te_on ? SL_TV2TE
                      : vh2te_on ? SL_VH2TE : -1;
  for (int r = SL_TE2TE; r < SL_Q2E_INT; r += LQ_N)
    if (r != tracker) pass_rows(s, so, r, LQ_N);
  if (tracker >= 0) {
    Lqr<T> st = changed && !te2te_on ? Lqr<T>{{zero, zero}, {0, 0}}
                                     : load_lqr(s, tracker);
    const T n = y(CY_N), alpha = y(CY_ALPHA), alpha_f = y(CY_ALPHA_F);
    const T q_b = y(CY_OM_EB + 1);
    const T pos_thr = y(CY_POS + CC_THR), pos_elv = y(CY_POS + CC_ELV);
    if (vh2te_on) {
      const LookupOut<T, 3 * NX_FULL + 12> k =
          gains<T, 3 * NX_FULL + 12>(G, GT_VH2TE, EAS, h_e);
      const T x[NX_FULL] = {q_b, theta, EAS, alpha, h_e, alpha_f, n,
                            pos_thr, pos_elv};
      const T z[2] = {EAS, h_e}, z_ref[2] = {u(UL_EAS_REF), h_ref};
      lqr_step<T, NX_FULL>(k.v, st, x, z, z_ref, dt, lo, hi, cmd);
    } else {
      const LookupOut<T, 3 * NX_RED + 12> k = gains<T, 3 * NX_RED + 12>(
          G, te2te_on ? GT_TE2TE : GT_TV2TE, EAS, h_e);
      const T x[NX_RED] = {q_b, theta, EAS, alpha, alpha_f, n, pos_thr,
                           pos_elv};
      const T z[2] = {y(CY_CMD + CC_THR), te2te_on ? y(CY_CMD + CC_ELV) : EAS};
      const T z_ref[2] = {throttle_ref,
                          te2te_on ? elevator_ref : u(UL_EAS_REF)};
      lqr_step<T, NX_RED>(k.v, st, x, z, z_ref, dt, lo, hi, cmd);
    }
    store_lqr(so, tracker, st);
  }

  so.s(SL_MODE, T(double(mode)));
  so.s(SL_H_STATE, T(double(h_state_new)));
  so.s(SL_PREV_THR, cmd[0]);
  so.s(SL_PREV_ELV, elevator_ref);
  so.s(SL_OUT_THR, cmd[0]);
  so.s(SL_OUT_ELV, cmd[1]);
  return {cmd[0], cmd[1]};
}

// ------------------------------------------------------------- lat pass
// ControlLaws.lat_step: as lon_step, for the lat inputs and state; returns
// (aileron_cmd, rudder_cmd). With GDC the override takes the place of the
// course reference and the mode request where it is on.
template <typename T, bool GDC = false>
__device__ __noinline__ Cmd2<T> lat_step(const T* G, Col<T> y, Col<T> u,
                                         Col<T> s, Out<T> so, T dt,
                                         Ovr<T> ovr = Ovr<T>{}) {
  const T one = T(1.0), zero = T(0.0);
  const T EAS = y(CY_EAS), h_e = y(CY_H_E);
  const bool guided = GDC && ovr.on;
  const int mode_prev = int(s(SA_MODE).v);
  const int mode = on_ground(y)
                       ? LAT_DIRECT
                       : (guided ? LAT_CHI_BETA : int(u(UA_MODE).v));
  const bool changed = mode != mode_prev;
  const bool ar2ar_on = mode == LAT_SAS;
  const bool pb2ar_on = mode == LAT_P_BETA || mode == LAT_PHI_BETA ||
                        mode == LAT_CHI_BETA;
  const bool p2phi_on = mode == LAT_P_BETA;
  const bool chi2phi_on = mode == LAT_CHI_BETA;
  const T aileron_ref =
      clamp(clamp(u(UA_AIL_AXIS), -one, one) + u(UA_AIL_OFF), -one, one);
  const T rudder_ref =
      clamp(clamp(u(UA_RUD_AXIS), -one, one) + u(UA_RUD_OFF), -one, one);
  const int sat_ail = int(s(SA_PB2AR + LQ_SAT).v);
  const T seed = s(SA_PREV_PHI);
  T g[N_PID_GAINS];
  T phi_ref = u(UA_PHI_REF);

  // p2phi: roll rate -> phi_ref
  if (p2phi_on) {
    pid_gains(G, GT_P2PHI, EAS, h_e, g);
    Integ<T> it = changed ? Integ<T>{zero, 0} : load_integ(s, SA_P2PHI_INT);
    Pid<T> p = changed ? pid_reset(seed, g[1]) : load_pid(s, SA_P2PHI_PID);
    const T i_out =
        integrator_step(it, u(UA_P_REF) - y(CY_OM_WB), dt, sat_ail);
    phi_ref = pid_step(g, p, i_out, dt, sat_ail, T(-INFINITY), T(INFINITY));
    store_integ(so, SA_P2PHI_INT, it);
    store_pid(so, SA_P2PHI_PID, p);
  } else {
    pass_rows(s, so, SA_P2PHI_INT, IN_N + PD_N);
  }

  // chi2phi: course angle -> phi_ref, the error wrapped
  if (chi2phi_on) {
    pid_gains(G, GT_CHI2PHI, EAS, h_e, g);
    Pid<T> p = changed ? pid_reset(seed, g[1]) : load_pid(s, SA_CHI2PHI_PID);
    const T chi_ref = guided ? ovr.ref : u(UA_CHI_REF);
    phi_ref = pid_step(g, p, wrap_to_pi(chi_ref - y(CY_CHI)), dt, sat_ail,
                       T(-PI / 4), T(PI / 4));
    store_pid(so, SA_CHI2PHI_PID, p);
  } else {
    pass_rows(s, so, SA_CHI2PHI_PID, PD_N);
  }

  // the inner trackers: ar2ar (the SAS, no reset) or phibeta2ar
  T cmd[2] = {aileron_ref, rudder_ref};
  const T lo[2] = {-one, -one}, hi[2] = {one, one};
  const int tracker = ar2ar_on ? SA_AR2AR : pb2ar_on ? SA_PB2AR : -1;
  for (int r = SA_AR2AR; r < SA_P2PHI_INT; r += LQ_N)
    if (r != tracker) pass_rows(s, so, r, LQ_N);
  if (tracker >= 0) {
    Lqr<T> st = changed && pb2ar_on ? Lqr<T>{{zero, zero}, {0, 0}}
                                    : load_lqr(s, tracker);
    const LookupOut<T, 3 * NX_RED + 12> k = gains<T, 3 * NX_RED + 12>(
        G, ar2ar_on ? GT_AR2AR : GT_PB2AR, EAS, h_e);
    const T phi = y(CY_E_NB + 2), beta = y(CY_BETA);
    const T x[NX_RED] = {y(CY_OM_EB), y(CY_OM_EB + 2), phi, EAS, beta,
                         y(CY_BETA_F), y(CY_POS + CC_AIL),
                         y(CY_POS + CC_RUD)};
    const T z[2] = {ar2ar_on ? y(CY_CMD + CC_AIL) : phi,
                    ar2ar_on ? y(CY_CMD + CC_RUD) : beta};
    const T z_ref[2] = {ar2ar_on ? aileron_ref : phi_ref,
                        ar2ar_on ? rudder_ref : u(UA_BETA_REF)};
    lqr_step<T, NX_RED>(k.v, st, x, z, z_ref, dt, lo, hi, cmd);
    store_lqr(so, tracker, st);
  }

  so.s(SA_MODE, T(double(mode)));
  so.s(SA_PREV_PHI, phi_ref);
  so.s(SA_OUT_AIL, cmd[0]);
  so.s(SA_OUT_RUD, cmd[1]);
  return {cmd[0], cmd[1]};
}

}  // namespace fj
