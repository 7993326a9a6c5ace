// A scripted mission's phase machine as per-aircraft __device__ functions
// (flightjax_torch/core/mission.py::MissionAvionics over the C172Xv2's
// avionics, with the phases of flightjax_torch/models/c172/missions.py),
// in Strict<F> like the rest of flight_math.cuh, operation by operation and
// in the same order as the plain PyTorch port.
//
// The phases are data: each phase of the mission library carries a
// descriptor (an apply kind, a done kind, a systems kind and their numbers),
// and parallel/kernels.py::mission_table lays the descriptors and the legs
// they fly out in one table, built in float64 on the host and cast once to
// the state's dtype. The kernels read it through the cache at the end of the
// control laws' gain buffer (kernels.ctl_gains of a MissionAvionics: one
// more offset after the gain tables' points at it).
//
// The plain version works out every phase on every lane and selects (the
// JAX package's lax.switch on a batched index); a lane here works out its
// own phase, which gives the same rows. Each firing: the current (old)
// phase's `apply` overrides the inputs the inner pass reads (transiently:
// the stored inputs do not change), its `done` at the old mission clock
// advances the index while it is not the last, the clock grows by the
// periodic dt, and after the inner pass the new phase's `systems` overrides
// the flaps, brake and engine-start inputs. ctl_laws.cu runs the pass over
// a fleet as the `msn_ctl_laws` kernel; the `megakernel_msn` instance of
// megakernel.cu runs it inside the whole step, when it fires.
//
// The sensor-fed missions (NavAvionics around the MissionAvionics) run the
// same phase machine on the navigation avionics' estimates, which also
// hold the estimated orthometric height h_o: the radar altimeter's flare
// gate (MD_AGL) reads it. Their rows (MSN_Y and h_o) and that done kind are
// compiled in only where the NAV template parameter is set, so that the
// truth-fed instances keep their code: `msn_nav_ctl_laws` of ctl_laws.cu
// and the `megakernel_msn_nav` instance of megakernel.cu.
#pragma once

#include "c172x_gdc.cuh"

namespace fj {

// ------------------------------------------------------------- row maps

// MSN_Y, what the phase machine, the guidance and the control laws read:
// GDC_Y, then the engine's state machine (ENG_OFF, ENG_STARTING,
// ENG_RUNNING), which the finish stores in S_SYS
constexpr int CY_ENG = N_GDCY, N_MSNY = CY_ENG + 1;                   // 35
// under the navigation avionics MSN_Y is followed by the orthometric height
// (the estimate, or the truth's in shadow mode)
constexpr int CY_H_O = N_MSNY, N_MSNNAVY = CY_H_O + 1;                 // 36
// the avionics kind of the sensor-fed missions (megakernel.cu's AV_MSN_NAV):
// the template argument of their instances, so that their machine code has
// a name of its own (tools/sass_torch_kernels.py)
constexpr int MSN_NAV_KIND = 6;
constexpr int ENG_RUNNING = 2;
// the phase machine's state: the phase index and the mission clock
constexpr int SM_PHASE = 0, SM_T = 1, N_SMSN = 2;
// the systems inputs a phase's `systems` may override: the flaps and
// brake commands and the engine's starter
constexpr int MU_FLAPS = 0, MU_BRK_L = 1, MU_BRK_R = 2, MU_START = 3,
              N_MUSYS = 4;
// msn_ctl_laws: in = MSN_Y, the avionics block, the guidance's inputs,
// the phase machine's state, the MU rows ; out = gdc_ctl_laws' rows, the
// new phase machine's state, the MU rows after `assign`
constexpr int MSN_AV = N_MSNY, MSN_UGDC = MSN_AV + N_AV,
              MSN_SMSN = MSN_UGDC + N_UGDC, MSN_MUSYS = MSN_SMSN + N_SMSN,
              MSN_N_IN = MSN_MUSYS + N_MUSYS;                        // 126
constexpr int MSN_N_OUT = GDC_N_OUT + N_SMSN + N_MUSYS;               // 65
// the input rows of a mission's pass, truth-fed (NAV false: the MSN_* rows
// above) or on the estimates (msn_nav_ctl_laws: MSN_Y and h_o first)
template <bool NAV>
struct MsnIn {
  enum : int {
    Y = NAV ? N_MSNNAVY : N_MSNY,
    AV = Y,
    UGDC = AV + N_AV,
    SMSN = UGDC + N_UGDC,
    MUSYS = SMSN + N_SMSN,
    N = MUSYS + N_MUSYS  // 126, 127
  };
};
// the megakernel_msn state buffer: megakernel_gdc's, then the phase
// machine's state
constexpr int MEGA_N_ROWS_MSN = MEGA_N_ROWS_GDC + N_SMSN;             // 160

// the mission table: the number of phases, the offset of the legs, one
// record per phase, then the legs (n_e1, h_e1, n_e2, h_e2 each, in the
// order of the guidance's UG_N_E1 .. UG_H_E2 rows)
constexpr int MT_N_PHASES = 0, MT_LEGS = 1, MT_PHASES = 2;
constexpr int PH_APPLY = 0, PH_LEG = 1, PH_EAS = 2, PH_THR_ON = 3,
              PH_THR = 4, PH_VRT = 5, PH_DONE = 6, PH_DONE_VAL = 7,
              PH_DONE_LEG = 8, PH_SYS = 9, PH_FLAPS = 10, PH_N = 11;
constexpr int LEG_N = 8;
// the kinds: apply (hold, fly a leg, flare, ground roll), done (never,
// mission clock, engine running, airborne, on the ground, leg captured,
// final done, the height over the terrain under a gate: the sensor-fed
// missions' radar gate), systems (none, flaps, ground, engine start)
constexpr int MA_HOLD = 0, MA_LEG = 1, MA_FLARE = 2, MA_GROUND = 3;
constexpr int MD_NEVER = 0, MD_CLOCK = 1, MD_ENGINE = 2, MD_AIRBORNE = 3,
              MD_ON_GND = 4, MD_CAPTURED = 5, MD_FINAL = 6, MD_AGL = 7;
constexpr int MS_NONE = 0, MS_FLAPS = 1, MS_GROUND = 2, MS_START = 3;
// the along-track gate of a captured leg and the height over the runway's
// end that ends the final leg (m); the flare's climb-rate reference; the
// ground roll's rudder
constexpr double CAPTURE_THRESHOLD = -200.0, FINAL_DH = 6.0,
                 FLARE_CLM = -0.3, GROUND_RUDDER = -0.04;

// the u_sys row of MU row k (fly-by-wire layout)
__device__ __forceinline__ int msn_usys_row(int k) {
  return k == MU_START ? int(SysL<ACT_FBW>::U_E_START)
                       : fbw_cmd_row(k == MU_FLAPS   ? CH_FLAPS
                                     : k == MU_BRK_L ? CH_BRK_L
                                                     : CH_BRK_R);
}

// ------------------------------------------------------------- the table

// the mission table at the end of a mission's gain buffer: its offset in
// the head's slot after the gain tables (`slot` 1 in the navigation
// avionics' buffer, whose slot 0 points at the filter's constants)
template <typename T>
__device__ __forceinline__ const T* mission_table(const T* G, int slot = 0) {
  return G + int(G[N_GAIN_TABLES + slot].v);
}

// the phase index clipped to the phases, as the switch takes it
template <typename T>
__device__ __forceinline__ int phase_index(const T* M, T phase) {
  const int n = int(M[MT_N_PHASES].v), p = int(phase.v);
  return p < 0 ? 0 : (p > n - 1 ? n - 1 : p);
}

template <typename T>
__device__ __forceinline__ const T* phase_rec(const T* M, int p) {
  return M + MT_PHASES + PH_N * p;
}

// leg k as the rows UG_N_E1 .. UG_H_E2 that segment_data reads
template <typename T>
__device__ __forceinline__ const T* leg_of(const T* M, int k) {
  return M + int(M[MT_LEGS].v) + LEG_N * k;
}

// segment_data of leg k at the lane's new position (MSN_Y rows y)
template <typename T>
__device__ __forceinline__ SegData<T> leg_data(const T* M, int k,
                                               const Col<T>& y) {
  const V3<T> n_e = y.v3(CY_N_E);
  const V3<T> r_eb = cartesian_from_geographic(n_e, y(CY_H_E));
  return segment_data(Col<T>{leg_of(M, k) - UG_N_E1, 1, 0}, ltf(n_e), r_eb);
}

// ------------------------------------------------------------- the phases

// phase p's `apply` on one side: overrides the guidance's inputs ug
// (N_UGDC values) and the side's control-law inputs uc (lon N_ULON, lat
// N_ULAT), which hold the lane's stored inputs
template <typename T>
__device__ __forceinline__ void msn_apply(const T* M, int p, bool lon,
                                          const Col<T>& y, T* ug, T* uc) {
  const T* ph = phase_rec(M, p);
  const int kind = int(ph[PH_APPLY].v);
  if (kind == MA_HOLD) return;
  if (kind == MA_GROUND) {  // idle, slight left rudder, direct modes
    ug[UG_MODE] = T(double(GDC_DIRECT));
    if (lon) {
      uc[UL_THR_AXIS] = T(0.0);
      uc[UL_MODE] = T(double(LON_DIRECT));
    } else {
      uc[UA_RUD_AXIS] = T(GROUND_RUDDER);
      uc[UA_MODE] = T(double(LAT_DIRECT));
    }
    return;
  }
  // a leg or the flare: segment guidance on the leg, lateral requested
  const int leg = int(ph[PH_LEG].v);
  const T* L = leg_of(M, leg);
  ug[UG_MODE] = T(double(GDC_SEGMENT));
#pragma unroll
  for (int k = 0; k < LEG_N; ++k) ug[UG_N_E1 + k] = L[k];
  ug[UG_HOR] = T(1.0);
  if (kind == MA_LEG) {
    ug[UG_VRT] = ph[PH_VRT];
    if (lon) {
      uc[UL_EAS_REF] = ph[PH_EAS];
      if (ph[PH_THR_ON].v != 0) uc[UL_THR_AXIS] = ph[PH_THR];
    }
    return;
  }
  // the flare: no vertical guidance, EAS + climb rate, decrab onto the
  // crab angle against the leg's course
  ug[UG_VRT] = T(0.0);
  if (lon) {
    uc[UL_MODE] = T(double(LON_EAS_CLM));
    uc[UL_CLM_REF] = T(FLARE_CLM);
    uc[UL_EAS_REF] = ph[PH_EAS];
  } else {
    uc[UA_MODE] = T(double(LAT_PHI_BETA));
    const SegData<T> d = leg_data(M, leg, y);
    uc[UA_BETA_REF] = wrap_to_pi(y(CY_E_NB) - d.chi_12);
    uc[UA_PHI_REF] = T(0.0);
  }
}

// phase p's `done` at the mission clock t; with NAV the y rows are
// MSN_NAV_Y and the radar gate MD_AGL reads their h_o
template <typename T, bool NAV = false>
__device__ __forceinline__ bool msn_done(const T* M, int p, const Col<T>& y,
                                         T t) {
  const T* ph = phase_rec(M, p);
  switch (int(ph[PH_DONE].v)) {
    case MD_CLOCK:
      return t >= ph[PH_DONE_VAL];
    case MD_ENGINE:
      return int(y(CY_ENG).v) == ENG_RUNNING;
    case MD_AIRBORNE:
      return !on_ground(y);
    case MD_ON_GND:
      return on_ground(y);
    case MD_CAPTURED: {
      const SegData<T> d = leg_data(M, int(ph[PH_DONE_LEG].v), y);
      return d.s_1b - d.s_12 > T(CAPTURE_THRESHOLD);
    }
    case MD_FINAL:
      return y(CY_H_E) - ph[PH_DONE_VAL] < T(FINAL_DH);
    default:
      if constexpr (NAV) {
        if (int(ph[PH_DONE].v) == MD_AGL)
          return y(CY_H_O) - ph[PH_DONE_VAL] < T(FINAL_DH);
      }
      return false;
  }
}

// phase p's `systems` on the MU rows us
template <typename T>
__device__ __forceinline__ void msn_systems(const T* M, int p,
                                            T (&us)[N_MUSYS]) {
  const T* ph = phase_rec(M, p);
  switch (int(ph[PH_SYS].v)) {
    case MS_FLAPS:
      us[MU_FLAPS] = ph[PH_FLAPS];
      break;
    case MS_GROUND:
      us[MU_FLAPS] = T(0.0);
      us[MU_BRK_L] = T(1.0);
      us[MU_BRK_R] = T(1.0);
      break;
    case MS_START:
      us[MU_START] = T(1.0);
      break;
    default:
      break;
  }
}

// the phase machine where the pass fires: the old phase's predicate at the
// old clock advances the index while it is not the last phase; the clock
// grows by dt; then the new phase's systems overrides on us. Returns the
// new (phase, t).
template <typename T>
struct MsnState {
  T phase, t;
};

template <typename T, bool NAV = false>
__device__ __forceinline__ MsnState<T> msn_step(const T* M, const Col<T>& y,
                                                T phase, T t, T dt,
                                                T (&us)[N_MUSYS]) {
  const int n = int(M[MT_N_PHASES].v), ph = int(phase.v);
  const bool done = msn_done<T, NAV>(M, phase_index(M, phase), y, t);
  const int ph_new = done && ph < n - 1 ? ph + 1 : ph;
  const T phase_new = T(double(ph_new));
  msn_systems(M, phase_index(M, phase_new), us);
  return {phase_new, t + dt};
}

// one side's inputs with the lane's phase applied: the guidance's (from
// rows r_gdc of c) into ug and the side's control-law inputs (rows r_u)
// into uc
template <typename T>
__device__ __forceinline__ void msn_inputs(const T* M, bool lon,
                                           const Col<T>& c, int r_gdc,
                                           int r_u, T phase, const Col<T>& y,
                                           T (&ug)[N_UGDC], T (&uc)[N_ULON]) {
#pragma unroll
  for (int k = 0; k < N_UGDC; ++k) ug[k] = c(r_gdc + k);
  const int n_u = lon ? N_ULON : N_ULAT;
#pragma unroll
  for (int k = 0; k < N_ULON; ++k) uc[k] = k < n_u ? c(r_u + k) : T(0.0);
  msn_apply(M, phase_index(M, phase), lon, y, ug, uc);
}

}  // namespace fj
