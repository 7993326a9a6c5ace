// megakernel: one whole `Simulation.step` of the flagship per launch -- the
// four RK4 stages of World.f_ode, the k-sum, the RK4 combine (compensated on
// q_ew and h_e when residuals are carried), World.f_step with the
// terminated latch, the t / i bookkeeping and the EGM96 geoid refresh under
// the new position, on every step.
//
// Replaces the TPU kernel of flightjax/parallel/megakernel.py::
// make_megakernel_step (:43, pallas_call :120), which traces
// jax.vmap(Simulation.step) into one Pallas call, and the geoid refresh that
// path runs after it on every step (:144-154); its `geoid_every` is ignored
// there as here. Plain PyTorch version:
// flightjax_torch/parallel/megakernel.py::megakernel_step_plain.
//
// The state stays resident on the card in one [MEGA_N_ROWS, B] buffer of the
// state's dtype (t, X, CTX, C; layout in c172_systems.cuh) and an int32
// [1, B] step counter: the host does one launch per step and no packing.
//
// What bounds it on the H100: neither bytes (69 + 1 rows read and written
// per lane, 2.3 MB in float32 at B = 4096, ~0.7 us of HBM) nor operations
// (~22k per lane and step), but one thread's dependent chain through four
// derivatives and the finish. With one thread per aircraft that thread also
// held x, k_prev and the k-sum of all 27 states (81 values) beside the
// systems body, and spilled.
//
// What the design does about it: several threads carry one aircraft, one
// warp per subsystem (the roles of c172_systems.cuh; see rk4_stage.cu). Each
// role carries k_prev of its own rows in registers through the four stages
// and keeps x and the k-sum of those rows in shared memory, where they are
// touched once per stage, so the systems' derivatives never leave their
// role; the finish splits the same way, with the crash flags meeting in
// shared memory for the terminated latch and role KIN looking up the
// undulation while the struts run. Two barriers per stage and two for the
// finish. The stage loop stays rolled (`#pragma unroll 1`), so the role
// bodies are emitted once, as the JAX kernel swaps in rk4_step_loop for the
// same reason (megakernel.py:56-67). Stage offsets, the k-sum
// ((((0 + k1) + 2 k2) + 2 k3) + k4), t = t_start + T(i + 1) dt and the
// compensated add are those of the plain step, and the result is
// bit-identical to the one-thread form. The parameters and tables are read
// from shared memory. PERF.md records ptxas's registers and spills and the
// times on the card.
//
// The fly-by-wire instance (megakernel_fbw, ACT_FBW) is the same TPU
// kernel's instance on the C172Xv1, whose traced Simulation.step ends with
// the masked periodic pass (core/sim.py:327-333): the control laws of
// c172x_ctl.cuh where the lane's new step counter is a multiple of
// steps_per_periodic, elsewhere the avionics and the four commands stand
// still. Its state buffer also holds the servos (X), their commands (CTX)
// and the avionics' inputs and state. After the finish each role puts the
// CTL_Y fields it holds into the scratch; one more barrier; then role PROP
// runs the lon pass and role DRAG the lat pass, each a function of its own
// (two of eight warps work: the pass is each lane's chain of lookups and
// controllers, the same as ctl_laws.cu runs). The pass reads the kinematics
// at the undulation of the step's start, as the JAX kernel does under
// geoid_deferred. The gains are read through the cache. The C172S instance
// keeps its rows (MegaL) and its parameters come first, so its machine code
// is what it was.
//
// The C172Xv2 instance (megakernel_gdc, ACT_FBW with the avionics AV_GDC)
// is the same TPU kernel traced over the C172Xv2, whose pass runs the
// guidance laws (c172x_gdc.cuh) before the control laws, overriding their
// requests (c172x_gdc.py::Avionics.f_periodic). Its state buffer holds
// megakernel_fbw's rows, then the guidance's inputs (AV_U_GDC, which pass
// through). Role KIN also puts the n-vector of the new q_ew into the
// scratch; after the barrier each pass warp works out the guidance its side
// needs (role PROP the altitude reference and the cross-track gate, role
// DRAG the course), and only on the lanes where that side's guidance is
// requested in a guided mode, since no row of the state holds the rest.
//
// The mission instance (megakernel_msn, ACT_FBW with the avionics AV_MSN)
// is the same TPU kernel traced over a world whose C172Xv2 flies a
// scripted mission (core/mission.py::MissionAvionics, the LOWS phase sets),
// whose pass runs the phase machine of c172x_msn.cuh around the guidance
// and control laws. Its state buffer holds megakernel_gdc's rows, then the
// phase index and the mission clock. Role ENG also puts the engine's new
// state into the scratch. After the barrier each pass warp applies the
// lane's (old) phase to the inputs its side reads, the guidance's and its
// own control laws', in registers and local memory (the stored inputs pass
// through), then runs its guidance and its side; role KIN, idle after its
// stores, works out the phase's predicate at the old clock, the new phase
// and clock and the new phase's systems overrides, which it writes in
// place of the flaps, brake and starter inputs that the CTX pass-through
// of this instance skips. The mission table arrives at the end of the
// gains (kernels.ctl_gains), so the kernel's parameters, and the other
// instances' machine code, are those of before.
//
// The turbulent instance (megakernel_turb, ACT_TURB) is the same TPU kernel
// traced over the C172S with DrydenTurbulence. Its state buffer holds the
// C172S's rows with the five filter states after X's systems rows and the
// turbulence's inputs and held drive after CTX's latch (84 rows), and its
// int32 counter is [3, B]: the step counter, the stream's seed and the
// drive's counter. Role KIN carries the filter states as the other roles
// carry theirs (x and the k-sum in the scratch, k_prev in registers), works
// out their derivative and the gust in each stage at the stage time t + c
// dt, and combines them in the finish with the gust at the new time; role
// PROP redraws the drive for the new counter during the finish.
//
// The turbulent C172Xv1's instance (megakernel_fbw_turb, ACT_FBW_TURB with
// the control laws AV_CTL) is the same TPU kernel traced over the C172Xv1
// on `c172x.build_vehicle(turbulence=)`: megakernel_fbw's rows with the
// turbulence's rows placed as in megakernel_turb, and its int32 [3, B]
// rows. Roles KIN and PROP do the turbulence's work as there; a leg's warp
// passes the turbulence's inputs through, since role DRAG runs the lateral
// pass after the finish.
//
// The sensor-fed C172Xv1's instances (megakernel_nav, ACT_FBW with the
// avionics AV_NAV: the calm `c172x.build_xv1_nav`; megakernel_nav_turb,
// ACT_FBW_TURB: the joint navigation study's aircraft in Dryden
// turbulence) are the same TPU kernel traced over a world whose avionics
// are NavAvionics(ControlLaws) (physics/navigation.py): its pass runs the
// sensors and the 15-state filter before the control laws, which read the
// estimates. Their state buffer holds megakernel_fbw's (or
// megakernel_fbw_turb's) rows, then the navigation avionics' inputs and
// floating state (NAV_U, NAV_S of nav.cuh: the sensor catalog per lane, the
// origin, the fault's size; the error processes, the filter with its P as
// 225 rows, the accumulator, the hold registers, the NIS values, the
// alarms); their int32 operand the step counter (and the turbulence's seed
// and counter), then NAV_INT (the sensors' seed and epoch, the fault's
// integers, the monitors' bits). After the finish and the roles' CTL_Y
// fields, every role evaluates the derivative once more at the new state
// (nav.cuh::truth_roles: the IMU reads the dynamics there, at the
// undulation of the step's start, the one the reference's megakernel reads
// before its refresh), then the lane's eight threads run the navigation
// pass (nav.cuh::nav_pass_roles; its matrices in the `work` operand), which
// puts the estimated CTL_Y fields into the scratch; one more barrier, then
// role PROP runs lon and role DRAG lat as in megakernel_fbw. The filter's
// constants arrive at the end of the gains (kernels.nav_params), the normal
// table of the sensors' draws as an operand of its own.
//
// The turbulent C172Xv2's instances (megakernel_gdc_turb and
// megakernel_msn_turb, ACT_FBW_TURB with AV_GDC or AV_MSN) compose
// megakernel_fbw_turb's rows and turbulence with megakernel_gdc's guidance
// or megakernel_msn's phase machine: the guidance's inputs (and the phase
// and clock) follow the control laws' block as there. The sensor-fed
// C172Xv2's instance (megakernel_gdc_nav, ACT_FBW with AV_GDC_NAV) holds
// megakernel_gdc's rows and then megakernel_nav's navigation rows; its
// scratch holds GDC_Y, and its navigation pass writes the n-vector of the
// estimated position beside the estimated CTL_Y fields, so that the
// guidance, as the control laws, reads the estimates wherever
// use_estimates is on. Each is built in a translation unit of its own.
//
// The sensor-fed missions' instance (megakernel_msn_nav, ACT_FBW with
// AV_MSN_NAV: NavAvionics(MissionAvionics(...), use_radar=True), the
// radar-gated landing and the cold-start takeoff of flightjax/demos/
// c172_demos.py:413-532) holds megakernel_msn's rows and then the
// navigation rows; its scratch holds MSN_Y and the orthometric height
// (N_MSNNAVY rows), and its navigation pass writes the estimated h_o there
// beside the estimated GDC_Y fields (the truth's in shadow mode), while the
// engine's state and the weight on wheels stay the truth's. The phase
// machine, the guidance and the control laws run after the pass's barrier,
// on the estimates, as the reference's f_periodic runs the inner avionics
// on y_est; its radar gate (MD_AGL) reads the estimated h_o. Its gains hold
// the filter's constants (slot 0 after the gain tables) and the mission
// table (slot 1).
//
// The sensor-fed C172Xv2's and missions' turbulent instances
// (megakernel_gdc_nav_turb, megakernel_msn_nav_turb: ACT_FBW_TURB with
// AV_GDC_NAV or AV_MSN_NAV, the C172Xv2 of build_xv2_nav(turbulence=) and
// a mission flown on it) compose megakernel_gdc_turb's (megakernel_msn_turb's)
// rows and turbulence with the navigation rows and pass of
// megakernel_gdc_nav (megakernel_msn_nav), as megakernel_nav_turb composes
// them on the C172Xv1: the IMU's derivative at the new state reads the gust
// at the new time, and the int32 operand holds the turbulence's three rows
// before NAV_INT. Each is built in a translation unit of its own.
#include "c172x_msn.cuh"
#include "nav.cuh"
#include "turbulence.cuh"

using namespace fj;

// the avionics of an instance: none (the C172S), the control laws (the
// C172Xv1), the guidance and control laws (the C172Xv2), a scripted mission
// over them, the navigation avionics around the control laws (the
// sensor-fed C172Xv1), around the guidance and control laws (the sensor-fed
// C172Xv2) and around a mission over them (the sensor-fed missions)
constexpr int AV_NONE = 0, AV_CTL = 1, AV_GDC = 2, AV_MSN = 3, AV_NAV = 4,
              AV_GDC_NAV = 5, AV_MSN_NAV = MSN_NAV_KIND;
static_assert(AV_MSN_NAV == 6, "the SASS record names the kind 6");
// the kinds whose pass runs the guidance (their buffer holds its inputs,
// their scratch the GDC_Y rows at least), the kinds whose pass the
// navigation avionics run, and the kinds whose pass runs a mission's phase
// machine (their buffer holds its state, their scratch MSN_Y)
__host__ __device__ constexpr bool av_gdc(int avk) {
  return avk == AV_GDC || avk == AV_MSN || avk == AV_GDC_NAV ||
         avk == AV_MSN_NAV;
}
__host__ __device__ constexpr bool av_nav(int avk) {
  return avk == AV_NAV || avk == AV_GDC_NAV || avk == AV_MSN_NAV;
}
__host__ __device__ constexpr bool av_msn(int avk) {
  return avk == AV_MSN || avk == AV_MSN_NAV;
}

// the rows of an instance's state buffer and scratch: t, X, CTX, C (and the
// avionics block, fly-by-wire; and the guidance's inputs; and the phase
// machine's state; and the navigation avionics' inputs and floating state,
// NAV_U and NAV_S of nav.cuh); the scratch holds the roles' shared rows,
// then each thread's x and k-sum (and the CTL_Y, GDC_Y or MSN_Y rows of the
// pass, with the orthometric height after MSN_Y around the navigation
// avionics)
template <int ACT, int AVK = (act_fbw(ACT) ? AV_CTL : AV_NONE)>
struct MegaL {
  enum : int {
    X = 1,
    CTX = X + SysL<ACT>::NXV,
    C = CTX + SysL<ACT>::NCTX,
    AV = C + N_C,
    GDC = AV + (act_fbw(ACT) ? N_AV : 0),
    MSN = GDC + (av_gdc(AVK) ? N_UGDC : 0),
    NAV = MSN + (av_msn(AVK) ? N_SMSN : 0),
    ROWS = NAV + (av_nav(AVK) ? N_NAVU + N_NAVS : 0),
    SH_X = act_fbw(ACT) ? SH_N_FBW : SH_N,
    SH_KSUM = SH_X + SysL<ACT>::NXV,
    SH_Y = SH_KSUM + SysL<ACT>::NXV,
    SH_ROWS = SH_Y + (AVK == AV_MSN_NAV ? N_MSNNAVY
                      : AVK == AV_MSN  ? N_MSNY
                      : av_gdc(AVK)    ? N_GDCY
                      : AVK == AV_CTL || AVK == AV_NAV ? N_CTLY
                                                       : 0)
  };
};

// the fly-by-wire instances: each role puts the CTL_Y fields it holds after
// the finish into the scratch, role KIN the kinematics, air data and new
// h_e (with GDC also the n-vector of the new q_ew), role AERO the gated
// airflow angles and the filters, role ENG the speed ratio (with MSN also
// the engine's new state), role DRAG the commands (clipped, from CTX) and
// the servo positions, each leg its weight on wheels
template <bool GDC, typename T, bool MSN = false>
__device__ __forceinline__ void share_ctl_y(const T* P, const Out<T>& so,
                                            const Col<T>& c, int r_usys,
                                            const RoleThread& t,
                                            const T (&xn)[N_SLOTS],
                                            const FinishOut<T>& f) {
  if (t.role == ROLE_KIN) {
    so.v3(CY_OM_WB, f.om_wb);
    so.v3(CY_OM_EB, V3<T>{xn[9], xn[10], xn[11]});
    so.v3(CY_E_NB, f.e_nb);
    so.v3(CY_V_EB_N, f.v_eb_n);
    so.s(CY_CHI, f.chi);
    so.s(CY_EAS, f.EAS);
    so.s(CY_H_E, xn[8]);
    if constexpr (GDC)
      so.v3(CY_N_E, nvector_from_qew(Q4<T>{xn[4], xn[5], xn[6], xn[7]}));
  } else if (t.role == ROLE_AERO) {
    so.s(CY_ALPHA, f.alpha);
    so.s(CY_BETA, f.beta);
    so.s(CY_ALPHA_F, xn[0]);
    so.s(CY_BETA_F, xn[1]);
  } else if (t.role == ROLE_ENG) {
    so.s(CY_N, xn[PW_OMEGA] / P[P_EN + EN_omega_rated]);
    if constexpr (MSN) so.s(CY_ENG, T(double(f.s.state)));
  } else if (t.role == ROLE_DRAG) {
    const int ch[N_CMD] = {CH_AIL, CH_ELV, CH_RUD, CH_THR};
#pragma unroll
    for (int k = 0; k < N_CMD; ++k) {
      const T* A = P + P_ACT + ch[k] * AC_N;
      so.s(CY_CMD + k, clamp(c(r_usys + fbw_cmd_row(ch[k])), A[AC_lo],
                             A[AC_hi]));
      so.s(CY_POS + k, servo_pos(P, ch[k], xn[ch[k]]));
    }
  } else if (t.role >= ROLE_LEG0) {
    so.s(CY_WOW + t.role - ROLE_LEG0, T(f.wow ? 1.0 : 0.0));
  }
}

// the roles that run the fly-by-wire instance's periodic pass
constexpr int ROLE_LON = ROLE_PROP, ROLE_LAT = ROLE_DRAG;

// the pass of one side (lon or lat) where it fires: the new state and the
// side's two commands (in place of those of CTX); elsewhere both pass
// through. The side's inputs pass through. With GDC the side's guidance,
// from the guidance's inputs at row r_gdc, overrides its requests; with MSN
// the lane's phase (row r_msn) first overrides the inputs the side reads
// (the mission table in the gains' slot SLOT).
template <bool GDC, typename T, bool MSN = false, int SLOT = 0>
__device__ __forceinline__ void periodic_side(bool lon, bool fires,
                                              const T* G, const Col<T>& y,
                                              const Col<T>& c, const Out<T>& o,
                                              int r_av, int r_usys, int r_gdc,
                                              T pdt, int r_msn = 0) {
  const int r_u = r_av + (lon ? AV_ULON : AV_ULAT);
  const int r_s = r_av + (lon ? AV_SLON : AV_SLAT);
  const int n_u = lon ? N_ULON : N_ULAT, n_s = lon ? N_SLON : N_SLAT;
  const int row_a = r_usys + fbw_cmd_row(lon ? CH_THR : CH_AIL);
  const int row_b = r_usys + fbw_cmd_row(lon ? CH_ELV : CH_RUD);
  pass_rows(c, o, r_u, n_u);
  if (!fires) {
    pass_rows(c, o, r_s, n_s);
    o.s(row_a, c(row_a));
    o.s(row_b, c(row_b));
    return;
  }
  const Col<T> u{c.buf + r_u * c.B, c.B, c.b};
  const Col<T> s{c.buf + r_s * c.B, c.B, c.b};
  const Out<T> so{o.buf + r_s * o.B, o.B, o.b};
  Cmd2<T> cmd;
  if constexpr (MSN) {
    T ug_v[N_UGDC], uc_v[N_ULON];
    msn_inputs(mission_table(G, SLOT), lon, c, r_gdc, r_u,
               c(r_msn + SM_PHASE), y, ug_v, uc_v);
    const Col<T> ug{ug_v, 1, 0}, uo{uc_v, 1, 0};
    if (lon) {
      const Gdc<T> g = guidance<GDC_VRT>(ug, y);
      cmd = lon_step<T, true>(G, y, uo, s, so, pdt, Ovr<T>{g.vrt, g.h_ref});
    } else {
      const Gdc<T> g = guidance<GDC_HOR>(ug, y);
      cmd = lat_step<T, true>(G, y, uo, s, so, pdt, Ovr<T>{g.hor, g.chi_ref});
    }
  } else if constexpr (GDC) {
    const Col<T> ug{c.buf + r_gdc * c.B, c.B, c.b};
    if (lon) {
      const Gdc<T> g = guidance<GDC_VRT>(ug, y);
      cmd = lon_step<T, true>(G, y, u, s, so, pdt, Ovr<T>{g.vrt, g.h_ref});
    } else {
      const Gdc<T> g = guidance<GDC_HOR>(ug, y);
      cmd = lat_step<T, true>(G, y, u, s, so, pdt, Ovr<T>{g.hor, g.chi_ref});
    }
  } else {
    cmd = lon ? lon_step(G, y, u, s, so, pdt) : lat_step(G, y, u, s, so, pdt);
  }
  o.s(row_a, cmd.a);
  o.s(row_b, cmd.b);
}

template <int ACT, typename T, int AVK = (act_fbw(ACT) ? AV_CTL : AV_NONE)>
__global__ void __launch_bounds__(N_ROLES * MAX_LANES)
    megakernel_kernel(const T* __restrict__ in, const int* __restrict__ i_in,
                      const T* __restrict__ P, const T* __restrict__ G,
                      T* __restrict__ out, int* __restrict__ i_out, int B,
                      int n_params, double dt, double t_start, int comp,
                      const T* __restrict__ gains, int spp, double pdt,
                      const float* __restrict__ table = nullptr,
                      T* __restrict__ work = nullptr) {
  using M = MegaL<ACT, AVK>;
  using L = SysL<ACT>;
  T* sP = block_shared<T>();
  T* sh = sP + n_params;
  share_params(P, n_params, sP);  // published by the first stage's barrier
  const RoleThread t = role_thread(B);
  const Col<T> c{in, B, t.b};
  const Out<T> o{out, B, t.b};
  // x and the k-sum live in the scratch, each thread its role's rows of its
  // lane (no other thread touches them); k_prev stays in registers
  const Col<T> sx{sh + M::SH_X * t.L, t.L, t.lane};
  const Col<T> ss{sh + M::SH_KSUM * t.L, t.L, t.lane};
  const Out<T> sxo{sh + M::SH_X * t.L, t.L, t.lane};
  const Out<T> sso{sh + M::SH_KSUM * t.L, t.L, t.lane};
  T x[N_SLOTS], kprev[N_SLOTS], acc[N_SLOTS];
  load_slots<ACT>(c, M::X, t.role, x);
  store_slots<ACT>(sxo, 0, t.role, x);
#pragma unroll
  for (int k = 0; k < N_SLOTS; ++k) kprev[k] = acc[k] = T(0);
  store_slots<ACT>(sso, 0, t.role, acc);
  // the turbulent instance: role KIN's filter states, like its slots
  TurbLane<T> tl;
  T kprev_t[N_XTURB];
  if constexpr (act_turb(ACT)) {
    if (t.role == ROLE_KIN) {
#pragma unroll
      for (int j = 0; j < N_XTURB; ++j) {
        sxo.s(L::X_TURB + j, c(M::X + L::X_TURB + j));
        sso.s(L::X_TURB + j, T(0));
        kprev_t[j] = T(0);
      }
    }
  }

  // the four stages; stage offsets and weights as in clusterstep.py:124-125,
  // the k-sum ((((0 + k1) + 2 k2) + 2 k3) + k4) as the plain step forms it
#pragma unroll 1
  for (int s = 0; s < 4; ++s) {
    const T cs = T(s == 0 ? 0.0 : (s == 3 ? dt : 0.5 * dt));
    const T w = T(s == 0 || s == 3 ? 1.0 : 2.0);
    T xi[N_SLOTS];
    load_slots<ACT>(sx, 0, t.role, x);
#pragma unroll
    for (int k = 0; k < N_SLOTS; ++k) xi[k] = x[k] + cs * kprev[k];
    if constexpr (act_turb(ACT)) {
      if (t.role == ROLE_KIN) {
#pragma unroll
        for (int j = 0; j < N_XTURB; ++j)
          tl.x[j] = sx(L::X_TURB + j) + cs * kprev_t[j];
        tl.t = c(MG_T) + cs;
      }
      f_ode_roles<ACT>(sP, sh, t, xi, c, M::CTX, kprev, &tl);
      if (t.role == ROLE_KIN) {
#pragma unroll
        for (int j = 0; j < N_XTURB; ++j) {
          kprev_t[j] = tl.d[j];
          sso.s(L::X_TURB + j, ss(L::X_TURB + j) + w * kprev_t[j]);
        }
      }
    } else {
      f_ode_roles<ACT>(sP, sh, t, xi, c, M::CTX, kprev);
    }
    load_slots<ACT>(ss, 0, t.role, acc);
#pragma unroll
    for (int k = 0; k < N_SLOTS; ++k) acc[k] = acc[k] + w * kprev[k];
    store_slots<ACT>(sso, 0, t.role, acc);
  }

  T xn[N_SLOTS];
  FinishOut<T> f;
  load_slots<ACT>(sx, 0, t.role, x);
  load_slots<ACT>(ss, 0, t.role, acc);
  if constexpr (act_turb(ACT)) {
    T eta[N_ETA];
    if (t.role == ROLE_KIN) {
#pragma unroll
      for (int j = 0; j < N_XTURB; ++j) {
        tl.x[j] = sx(L::X_TURB + j);
        tl.k[j] = ss(L::X_TURB + j);
      }
      tl.t = T(t_start) + T(double(i_in[TI_I * B + t.b] + 1)) * T(dt);
    } else if (t.role == ROLE_PROP) {
      turb_redraw(uint32_t(i_in[TI_SEED * B + t.b]),
                  uint32_t(i_in[TI_N * B + t.b] + 1), eta);
    }
    finish_roles<true, ACT>(sP, G, sh, t, x, acc, T(dt / 6.0), comp != 0, c,
                            M::CTX, M::C, xn, f, &tl);
    if (t.valid) {
      if (t.role == ROLE_KIN) {
#pragma unroll
        for (int j = 0; j < N_XTURB; ++j) o.s(M::X + L::X_TURB + j, tl.d[j]);
        i_out[TI_SEED * B + t.b] = i_in[TI_SEED * B + t.b];
        i_out[TI_N * B + t.b] = i_in[TI_N * B + t.b] + 1;
      } else if (t.role == ROLE_PROP) {
#pragma unroll
        for (int j = 0; j < N_ETA; ++j) o.s(M::CTX + L::CX_ETA + j, eta[j]);
      } else if (t.role == (act_fbw(ACT) ? ROLE_LEG0 : ROLE_DRAG)) {
        // the turbulence's inputs (a leg's warp where DRAG runs a pass)
#pragma unroll
        for (int j = 0; j < N_UTURB; ++j)
          o.s(M::CTX + L::CX_UTURB + j, c(M::CTX + L::CX_UTURB + j));
      }
    }
  } else {
    finish_roles<true, ACT>(sP, G, sh, t, x, acc, T(dt / 6.0), comp != 0, c,
                            M::CTX, M::C, xn, f);
  }
  if constexpr (AVK != AV_NONE) {
    // what the avionics read of the new state, into the scratch
    share_ctl_y<av_gdc(AVK), T, av_msn(AVK)>(
        sP, Out<T>{sh + M::SH_Y * t.L, t.L, t.lane}, c, M::CTX + CX_USYS, t,
        xn, f);
    __syncthreads();
  }
  // rows of the navigation instances' int32 operand: i (, seed, n), then
  // NAV_INT
  constexpr int NI0 = act_turb(ACT) ? N_TURB_INT : 1;
  if constexpr (av_nav(AVK)) {
    // the truth at the new state for the sensors (a fifth evaluation), then
    // the navigation pass where the lane fires, which puts the estimated
    // CTL_Y fields into the scratch in place of the truth's (around the
    // guidance also the n-vector of the estimated position, so that every
    // GDC_Y field the guidance reads is the estimate's; in shadow mode the
    // truth's stay; around a mission also the orthometric height, the
    // estimate's or the truth's); one more barrier before the pass warps
    // and the phase machine read them
    NavTruth<T> tr;
    truth_roles<ACT>(sP, sh, t, xn, c, M::CTX, f.s, &tl, tr);
    nav_pass_roles<T, AVK == AV_MSN_NAV ? CY_H_O : 0>(
        t.role, t.valid, (i_in[t.b] + 1) % spp == 0, nav_params(gains),
        table, tr, c(M::CTX + L::CX_TRN + TR_ELEV),
        Col<T>{in + M::NAV * B, B, t.b},
        Col<T>{in + (M::NAV + N_NAVU) * B, B, t.b},
        Out<T>{out + (M::NAV + N_NAVU) * B, B, t.b}, i_in + NI0 * B + t.b,
        i_out + NI0 * B + t.b, work + t.b, B,
        Out<T>{sh + M::SH_Y * t.L, t.L, t.lane}, av_gdc(AVK));
    __syncthreads();
  }
  if (!t.valid) return;  // past the last barrier

  store_slots<ACT>(o, M::X, t.role, xn);
  // inputs and terrain pass through, a few rows per role (the fly-by-wire
  // instance's four commands come from the pass); the discrete state, the
  // undulation and the latch come from the roles that made them
  for (int r = t.role; r < L::CX_SSYS; r += N_ROLES) {
    if constexpr (act_fbw(ACT)) {
      if (r == fbw_cmd_row(CH_AIL) || r == fbw_cmd_row(CH_ELV) ||
          r == fbw_cmd_row(CH_RUD) || r == fbw_cmd_row(CH_THR))
        continue;
    }
    if constexpr (av_msn(AVK)) {  // role KIN writes the mission's rows
      if (r == msn_usys_row(MU_FLAPS) || r == msn_usys_row(MU_BRK_L) ||
          r == msn_usys_row(MU_BRK_R) || r == msn_usys_row(MU_START))
        continue;
    }
    o.s(M::CTX + r, c(M::CTX + r));
  }
  if (t.role == ROLE_AERO) {
    o.s(M::CTX + L::CX_SSYS + SS_STALL, T(f.s.stall ? 1.0 : 0.0));
  } else if (t.role == ROLE_ENG) {
    o.s(M::CTX + L::CX_SSYS + SS_STATE, T(double(f.s.state)));
  } else if (t.role == ROLE_KIN) {
    const int i_new = i_in[t.b] + 1;
    o.s(MG_T, T(t_start) + T(double(i_new)) * T(dt));
    o.s(M::CTX + L::CX_SSYS + SS_CRASHED, T(f.s.crashed ? 1.0 : 0.0));
    o.s(M::CTX + L::CX_GEOID, f.geoid_N);
    o.s(M::CTX + L::CX_TERM, f.term);
    o.q4(M::C, f.r_q);
    o.s(M::C + 4, f.r_h);
    i_out[t.b] = i_new;
  }
  if constexpr (AVK != AV_NONE) {
    // the periodic pass where the counter the step makes is a multiple of
    // steps_per_periodic (core/sim.py::Simulation.step): lon in one warp,
    // lat in another
    if (t.role == ROLE_LON || t.role == ROLE_LAT) {
      const bool fires = (i_in[t.b] + 1) % spp == 0;
      const Col<T> y{sh + M::SH_Y * t.L, t.L, t.lane};
      periodic_side<av_gdc(AVK), T, av_msn(AVK), av_nav(AVK) ? 1 : 0>(
          t.role == ROLE_LON, fires, gains, y, c, o, M::AV, M::CTX + CX_USYS,
          M::GDC, T(pdt), M::MSN);
    }
  }
  if constexpr (av_nav(AVK)) {
    // the navigation avionics' inputs pass through
    for (int r = t.role; r < N_NAVU; r += N_ROLES)
      o.s(M::NAV + r, c(M::NAV + r));
  }
  if constexpr (av_gdc(AVK)) {
    // the guidance's inputs pass through
    if (t.role == ROLE_KIN) pass_rows(c, o, M::GDC, N_UGDC);
  }
  if constexpr (av_msn(AVK)) {
    // the phase machine where the pass fires: the new phase and clock and
    // the new phase's systems overrides; elsewhere the rows pass through
    // (around the navigation avionics on the estimates, the radar gate on
    // the estimated h_o)
    if (t.role == ROLE_KIN) {
      T phase = c(M::MSN + SM_PHASE), clock = c(M::MSN + SM_T);
      T us[N_MUSYS];
#pragma unroll
      for (int k = 0; k < N_MUSYS; ++k)
        us[k] = c(M::CTX + CX_USYS + msn_usys_row(k));
      if ((i_in[t.b] + 1) % spp == 0) {
        const Col<T> y{sh + M::SH_Y * t.L, t.L, t.lane};
        const MsnState<T> m = msn_step<T, av_nav(AVK)>(
            mission_table(gains, av_nav(AVK) ? 1 : 0), y, phase, clock,
            T(pdt), us);
        phase = m.phase;
        clock = m.t;
      }
      o.s(M::MSN + SM_PHASE, phase);
      o.s(M::MSN + SM_T, clock);
#pragma unroll
      for (int k = 0; k < N_MUSYS; ++k)
        o.s(M::CTX + CX_USYS + msn_usys_row(k), us[k]);
    }
  }
}

template <int ACT, int AVK, typename T>
static int launch(const void* in, const void* i_in, const void* params,
                  const void* grid_, const void* gains, void* out,
                  void* i_out, int B, int n_params, double dt,
                  double t_start, int comp, int spp, double pdt, int lanes,
                  void* stream, const void* table = nullptr,
                  void* work = nullptr) {
  if (B <= 0) return 0;
  if (lanes <= 0 || lanes > MAX_LANES || lanes % 32 != 0 || spp < 1)
    return (int)cudaErrorInvalidValue;
  const RoleLaunch l = role_launch(B, lanes, n_params, (int)sizeof(T),
                                   MegaL<ACT, AVK>::SH_ROWS);
  // the attribute belongs to the device in use, so every launch sets it
  const cudaError_t err = cudaFuncSetAttribute(
      megakernel_kernel<ACT, T, AVK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, l.shared);
  if (err != cudaSuccess) return (int)err;
  megakernel_kernel<ACT, T, AVK><<<l.grid, l.block, l.shared,
                                   (cudaStream_t)stream>>>(
      (const T*)in, (const int*)i_in, (const T*)params, (const T*)grid_,
      (T*)out, (int*)i_out, B, n_params, dt, t_start, comp, (const T*)gains,
      spp, pdt, (const float*)table, (T*)work);
  return (int)cudaGetLastError();
}

#if !defined(FJ_NAV_ACT) && !defined(FJ_FBW_ACT)
extern "C" {
int megakernel_f32(const void* in, const void* i_in, const void* params,
                   const void* grid, void* out, void* i_out, int B,
                   int n_params, double dt, double t_start, int comp,
                   int lanes, void* stream) {
  return launch<ACT_MECH, AV_NONE, SF>(in, i_in, params, grid, nullptr, out,
                                       i_out, B, n_params, dt, t_start, comp,
                                       1, 0.0, lanes, stream);
}
int megakernel_f64(const void* in, const void* i_in, const void* params,
                   const void* grid, void* out, void* i_out, int B,
                   int n_params, double dt, double t_start, int comp,
                   int lanes, void* stream) {
  return launch<ACT_MECH, AV_NONE, SD>(in, i_in, params, grid, nullptr, out,
                                       i_out, B, n_params, dt, t_start, comp,
                                       1, 0.0, lanes, stream);
}
// the fly-by-wire instance also takes the control laws' gains, their
// steps per periodic pass and their interval
int megakernel_fbw_f32(const void* in, const void* i_in, const void* params,
                       const void* grid, const void* gains, void* out,
                       void* i_out, int B, int n_params, double dt,
                       double t_start, int comp, int spp, double pdt,
                       int lanes, void* stream) {
  return launch<ACT_FBW, AV_CTL, SF>(in, i_in, params, grid, gains, out,
                                     i_out, B, n_params, dt, t_start, comp,
                                     spp, pdt, lanes, stream);
}
int megakernel_fbw_f64(const void* in, const void* i_in, const void* params,
                       const void* grid, const void* gains, void* out,
                       void* i_out, int B, int n_params, double dt,
                       double t_start, int comp, int spp, double pdt,
                       int lanes, void* stream) {
  return launch<ACT_FBW, AV_CTL, SD>(in, i_in, params, grid, gains, out,
                                     i_out, B, n_params, dt, t_start, comp,
                                     spp, pdt, lanes, stream);
}
// the C172Xv2 instance, on the fly-by-wire instance's signature
int megakernel_gdc_f32(const void* in, const void* i_in, const void* params,
                       const void* grid, const void* gains, void* out,
                       void* i_out, int B, int n_params, double dt,
                       double t_start, int comp, int spp, double pdt,
                       int lanes, void* stream) {
  return launch<ACT_FBW, AV_GDC, SF>(in, i_in, params, grid, gains, out,
                                     i_out, B, n_params, dt, t_start, comp,
                                     spp, pdt, lanes, stream);
}
int megakernel_gdc_f64(const void* in, const void* i_in, const void* params,
                       const void* grid, const void* gains, void* out,
                       void* i_out, int B, int n_params, double dt,
                       double t_start, int comp, int spp, double pdt,
                       int lanes, void* stream) {
  return launch<ACT_FBW, AV_GDC, SD>(in, i_in, params, grid, gains, out,
                                     i_out, B, n_params, dt, t_start, comp,
                                     spp, pdt, lanes, stream);
}
// the mission instance, on the fly-by-wire instance's signature; its gains
// hold the mission table
int megakernel_msn_f32(const void* in, const void* i_in, const void* params,
                       const void* grid, const void* gains, void* out,
                       void* i_out, int B, int n_params, double dt,
                       double t_start, int comp, int spp, double pdt,
                       int lanes, void* stream) {
  return launch<ACT_FBW, AV_MSN, SF>(in, i_in, params, grid, gains, out,
                                     i_out, B, n_params, dt, t_start, comp,
                                     spp, pdt, lanes, stream);
}
int megakernel_msn_f64(const void* in, const void* i_in, const void* params,
                       const void* grid, const void* gains, void* out,
                       void* i_out, int B, int n_params, double dt,
                       double t_start, int comp, int spp, double pdt,
                       int lanes, void* stream) {
  return launch<ACT_FBW, AV_MSN, SD>(in, i_in, params, grid, gains, out,
                                     i_out, B, n_params, dt, t_start, comp,
                                     spp, pdt, lanes, stream);
}
// the turbulent C172Xv1's instance: the fly-by-wire instance's signature,
// its i the int32 [3, B] rows (i, seed, n)
int megakernel_fbw_turb_f32(const void* in, const void* i_in,
                            const void* params, const void* grid,
                            const void* gains, void* out, void* i_out, int B,
                            int n_params, double dt, double t_start, int comp,
                            int spp, double pdt, int lanes, void* stream) {
  return launch<ACT_FBW_TURB, AV_CTL, SF>(in, i_in, params, grid, gains, out,
                                          i_out, B, n_params, dt, t_start,
                                          comp, spp, pdt, lanes, stream);
}
int megakernel_fbw_turb_f64(const void* in, const void* i_in,
                            const void* params, const void* grid,
                            const void* gains, void* out, void* i_out, int B,
                            int n_params, double dt, double t_start, int comp,
                            int spp, double pdt, int lanes, void* stream) {
  return launch<ACT_FBW_TURB, AV_CTL, SD>(in, i_in, params, grid, gains, out,
                                          i_out, B, n_params, dt, t_start,
                                          comp, spp, pdt, lanes, stream);
}
void megakernel_fbw_turb_layout(int* n_in, int* n_out) {
  *n_in = *n_out = MegaL<ACT_FBW_TURB, AV_CTL>::ROWS;
}
void megakernel_fbw_turb_launch_shape(int B, int lanes, int n_params,
                                      int elem_size, int* grid, int* block,
                                      int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size,
                         MegaL<ACT_FBW_TURB, AV_CTL>::SH_ROWS),
             grid, block, shared);
}
void vehicle_fbw_turb_layout(int* n_x, int* n_ctx, int* n_c, int* n_mega) {
  *n_x = N_X_FBW_TURB;
  *n_ctx = N_CTX_FBW_TURB;
  *n_c = N_C;
  *n_mega = MegaL<ACT_FBW_TURB, AV_CTL>::ROWS;
}
// the turbulent C172S's instance: the C172S's signature, its i the int32
// [3, B] rows (i, seed, n)
int megakernel_turb_f32(const void* in, const void* i_in, const void* params,
                        const void* grid, void* out, void* i_out, int B,
                        int n_params, double dt, double t_start, int comp,
                        int lanes, void* stream) {
  return launch<ACT_TURB, AV_NONE, SF>(in, i_in, params, grid, nullptr, out,
                                       i_out, B, n_params, dt, t_start, comp,
                                       1, 0.0, lanes, stream);
}
int megakernel_turb_f64(const void* in, const void* i_in, const void* params,
                        const void* grid, void* out, void* i_out, int B,
                        int n_params, double dt, double t_start, int comp,
                        int lanes, void* stream) {
  return launch<ACT_TURB, AV_NONE, SD>(in, i_in, params, grid, nullptr, out,
                                       i_out, B, n_params, dt, t_start, comp,
                                       1, 0.0, lanes, stream);
}
void megakernel_turb_layout(int* n_in, int* n_out) {
  *n_in = MEGA_N_ROWS_TURB;
  *n_out = MEGA_N_ROWS_TURB;
}
void megakernel_turb_launch_shape(int B, int lanes, int n_params,
                                  int elem_size, int* grid, int* block,
                                  int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size,
                         MegaL<ACT_TURB>::SH_ROWS),
             grid, block, shared);
}
void megakernel_layout(int* n_in, int* n_out) {
  *n_in = MEGA_N_ROWS;
  *n_out = MEGA_N_ROWS;
}
void megakernel_fbw_layout(int* n_in, int* n_out) {
  *n_in = MEGA_N_ROWS_FBW;
  *n_out = MEGA_N_ROWS_FBW;
}
void megakernel_gdc_layout(int* n_in, int* n_out) {
  *n_in = MEGA_N_ROWS_GDC;
  *n_out = MEGA_N_ROWS_GDC;
}
void megakernel_msn_layout(int* n_in, int* n_out) {
  *n_in = MEGA_N_ROWS_MSN;
  *n_out = MEGA_N_ROWS_MSN;
}
void megakernel_launch_shape(int B, int lanes, int n_params, int elem_size,
                             int* grid, int* block, int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size, SH_MEGA_N), grid,
             block, shared);
}
void megakernel_fbw_launch_shape(int B, int lanes, int n_params,
                                 int elem_size, int* grid, int* block,
                                 int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size,
                         MegaL<ACT_FBW>::SH_ROWS),
             grid, block, shared);
}
void megakernel_gdc_launch_shape(int B, int lanes, int n_params,
                                 int elem_size, int* grid, int* block,
                                 int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size,
                         MegaL<ACT_FBW, AV_GDC>::SH_ROWS),
             grid, block, shared);
}
void megakernel_msn_launch_shape(int B, int lanes, int n_params,
                                 int elem_size, int* grid, int* block,
                                 int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size,
                         MegaL<ACT_FBW, AV_MSN>::SH_ROWS),
             grid, block, shared);
}
// the whole-vehicle row groups: X, CTX, C and the megakernel's state buffer,
// of the C172S and of the fly-by-wire C172
void vehicle_layout(int* n_x, int* n_ctx, int* n_c, int* n_mega) {
  *n_x = N_X;
  *n_ctx = N_CTX;
  *n_c = N_C;
  *n_mega = MEGA_N_ROWS;
}
void vehicle_turb_layout(int* n_x, int* n_ctx, int* n_c, int* n_mega) {
  *n_x = N_X_TURB;
  *n_ctx = N_CTX_TURB;
  *n_c = N_C;
  *n_mega = MEGA_N_ROWS_TURB;
}
void vehicle_fbw_layout(int* n_x, int* n_ctx, int* n_c, int* n_mega) {
  *n_x = N_X_FBW;
  *n_ctx = N_CTX_FBW;
  *n_c = N_C;
  *n_mega = MEGA_N_ROWS_FBW;
}
}
#elif defined(FJ_NAV_ACT)
// the sensor-fed instances, each in a translation unit of its own
// (megakernel_nav.cu, megakernel_nav_turb.cu, megakernel_gdc_nav.cu,
// megakernel_msn_nav.cu define FJ_NAV_ACT, the ActKind, FJ_NAV_NAME, the
// instance's name, and, around the guidance, FJ_NAV_AVK AV_GDC_NAV or
// around a mission AV_MSN_NAV (default AV_NAV), and include this
// file; megakernel_gdc_nav_turb.cu and megakernel_msn_nav_turb.cu the same
// kinds on ACT_FBW_TURB), so that nvcc builds them beside this one: the
// fly-by-wire signature with the normal table and the work buffer of
// nav.cuh; i the int32 rows (i, then NAV_INT; turbulent: i, seed, n, then
// NAV_INT), the gains with the filter's parameter block
#ifndef FJ_NAV_AVK
#define FJ_NAV_AVK AV_NAV
#endif
// the scratch at the most aircraft per block in float64, beside a copy of
// the parameters (3605 values for the turbulent fly-by-wire C172X,
// kernels.system_params; PARAMS_ROOM leaves room to grow), fits the
// H100's 227 KiB of shared memory a block may take
constexpr int PARAMS_ROOM = 4096, SHARED_PER_BLOCK = 227 * 1024;
static_assert((MegaL<FJ_NAV_ACT, FJ_NAV_AVK>::SH_ROWS * MAX_LANES +
               PARAMS_ROOM) * (int)sizeof(double) <= SHARED_PER_BLOCK,
              "the navigation instance's scratch outgrows a block's shared "
              "memory at MAX_LANES aircraft");
#define FJ_CAT2(a, b) a##b
#define FJ_CAT(a, b) FJ_CAT2(a, b)
#define NAV_INSTANCE(NAME, T)                                               \
  int NAME(const void* in, const void* i_in, const void* params,           \
           const void* grid, const void* gains, const void* table,         \
           void* work, void* out, void* i_out, int B, int n_params,        \
           double dt, double t_start, int comp, int spp, double pdt,       \
           int lanes, void* stream) {                                      \
    return launch<FJ_NAV_ACT, FJ_NAV_AVK, T>(in, i_in, params, grid,       \
                                             gains, out, i_out, B,         \
                                             n_params, dt, t_start, comp,  \
                                             spp, pdt, lanes, stream,      \
                                             table, work);                 \
  }
extern "C" {
NAV_INSTANCE(FJ_CAT(FJ_NAV_NAME, _f32), SF)
NAV_INSTANCE(FJ_CAT(FJ_NAV_NAME, _f64), SD)
void FJ_CAT(FJ_NAV_NAME, _layout)(int* n_in, int* n_out) {
  *n_in = *n_out = MegaL<FJ_NAV_ACT, FJ_NAV_AVK>::ROWS;
}
void FJ_CAT(FJ_NAV_NAME, _launch_shape)(int B, int lanes, int n_params,
                                        int elem_size, int* grid,
                                        int* block, int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size,
                         MegaL<FJ_NAV_ACT, FJ_NAV_AVK>::SH_ROWS),
             grid, block, shared);
}
}
#undef NAV_INSTANCE
#else
// the turbulent C172Xv2's instances, each in a translation unit of its own
// (megakernel_gdc_turb.cu, megakernel_msn_turb.cu define FJ_FBW_ACT, the
// ActKind, FJ_FBW_AVK, the avionics, and FJ_FBW_NAME, the instance's name,
// and include this file), so that nvcc builds them beside this one: the
// fly-by-wire signature; i the int32 rows (i, seed, n)
#define FJ_CAT2(a, b) a##b
#define FJ_CAT(a, b) FJ_CAT2(a, b)
#define FBW_INSTANCE(NAME, T)                                               \
  int NAME(const void* in, const void* i_in, const void* params,           \
           const void* grid, const void* gains, void* out, void* i_out,    \
           int B, int n_params, double dt, double t_start, int comp,       \
           int spp, double pdt, int lanes, void* stream) {                 \
    return launch<FJ_FBW_ACT, FJ_FBW_AVK, T>(in, i_in, params, grid,       \
                                             gains, out, i_out, B,         \
                                             n_params, dt, t_start, comp,  \
                                             spp, pdt, lanes, stream);     \
  }
extern "C" {
FBW_INSTANCE(FJ_CAT(FJ_FBW_NAME, _f32), SF)
FBW_INSTANCE(FJ_CAT(FJ_FBW_NAME, _f64), SD)
void FJ_CAT(FJ_FBW_NAME, _layout)(int* n_in, int* n_out) {
  *n_in = *n_out = MegaL<FJ_FBW_ACT, FJ_FBW_AVK>::ROWS;
}
void FJ_CAT(FJ_FBW_NAME, _launch_shape)(int B, int lanes, int n_params,
                                        int elem_size, int* grid,
                                        int* block, int* shared) {
  put_launch(role_launch(B, lanes, n_params, elem_size,
                         MegaL<FJ_FBW_ACT, FJ_FBW_AVK>::SH_ROWS),
             grid, block, shared);
}
}
#undef FBW_INSTANCE
#endif
