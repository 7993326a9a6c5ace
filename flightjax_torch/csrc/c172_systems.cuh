// The Cessna 172 systems as per-aircraft __device__ functions: the
// actuation (the C172S's mechanical linkage or the C172X's fly-by-wire
// servos, chosen at compile time by an ActKind), aerodynamics, one
// landing-gear leg (strut and contact), the IO-360 engine with its
// propeller, fuel, payload and the mass-property sum.
// They are the fine parts of the systems clusters of flightjax/parallel/
// clusterstep.py (k_actaero, k_ldg0..2, k_pwp; k_fin_act, k_fin_ldg0..2,
// k_fin_rest), composed by finish_sys.cu one aircraft per thread and by
// the role kernels (systems, rk4_stage, rk4_finish, megakernel) one warp
// per subsystem (the roles section below).
//
// Every formula mirrors the plain PyTorch port (flightjax_torch/models/c172/
// common.py, flightjax_torch/physics/{landinggear,piston,propellers,
// control}.py) operation by operation and in the same association order,
// in Strict<F> like the rest of flight_math.cuh. Model parameters and
// tables are not compiled in: they arrive in one parameter buffer built by
// flightjax_torch/parallel/kernels.py::system_params from the Python model
// objects, laid out by the enums below (the parity tests check the two
// agree). Formula literals stay literals, as in the Python.
#pragma once

#include "flight_math.cuh"
#include "turbulence.cuh"

namespace fj {

// ------------------------------------------------------------- parameters

// Aero (models/c172/common.py::Aero): geometry, filter, control ranges as
// (lower end, slope) of the _scale map, stall hysteresis, AERO_CONST
enum AeroP : int {
  AE_S, AE_b, AE_c, AE_tau, AE_V_min, AE_e_lo, AE_e_sc, AE_a_lo, AE_a_sc,
  AE_r_lo, AE_r_sc, AE_f_lo, AE_f_sc, AE_stall_lo, AE_stall_hi,
  AE_CD_zero, AE_CY_dr, AE_CY_da, AE_CL_de, AE_CL_q, AE_CL_adot, AE_Cl_da,
  AE_Cl_dr, AE_Cl_beta, AE_Cl_p, AE_Cm_zero, AE_Cm_de, AE_Cm_alpha, AE_Cm_q,
  AE_Cm_adot, AE_Cn_dr, AE_Cn_da, AE_Cn_beta, AE_Cn_p, AE_Cn_r, AE_N
};

// one gear leg (physics/landinggear.py::LandingGearUnit), friction PI last
enum LegP : int {
  LG_r_bs_x, LG_r_bs_y, LG_r_bs_z, LG_l_0, LG_k_s, LG_k_d_ext, LG_k_d_cmp,
  LG_psi_max, LG_eta_br, LG_frc_k_p, LG_frc_k_i, LG_frc_k_l, LG_frc_beta_p,
  LG_frc_lo, LG_frc_hi, LG_N
};

// engine (physics/piston.py::PistonEngine) and the thruster's gear ratio;
// J_sum = J + gear_ratio^2 J_xx of the propeller, tau_fr_sc the friction
// torque scale 0.01 P_rated / omega_rated, both formed in Python
enum EngP : int {
  EN_omega_idle, EN_omega_rated, EN_omega_stall, EN_tau_start, EN_P_rated,
  EN_tau_fr_sc, EN_J_sum, EN_gear_ratio, EN_idle_k_p, EN_idle_k_i,
  EN_idle_k_l, EN_idle_beta_p, EN_idle_lo, EN_idle_hi, EN_frc_k_p,
  EN_frc_k_i, EN_frc_k_l, EN_frc_beta_p, EN_frc_lo, EN_frc_hi, EN_N
};

// propeller (physics/propellers.py::Propeller); d/2, d^4, d^5 formed in
// Python as its output() forms them
enum PropP : int {
  PR_d, PR_d_half, PR_d4, PR_d5, PR_J_xx, PR_sense, PR_dbeta, PR_r_bp_x,
  PR_r_bp_y, PR_r_bp_z, PR_N
};

// airframe mass properties, unusable and usable fuel mass (M_RES and
// M_FULL - M_RES, formed in Python), tanks and payload slots (in the order
// Systems.payload_mp_b sums them)
enum MassP : int {
  MS_m, MS_J00, MS_J01, MS_J02, MS_J10, MS_J11, MS_J12, MS_J20, MS_J21,
  MS_J22, MS_r_OG_x, MS_r_OG_y, MS_r_OG_z, MS_M_RES, MS_M_USABLE, MS_tank0_x,
  MS_tank0_y, MS_tank0_z, MS_tank1_x, MS_tank1_y, MS_tank1_z, MS_pilot_x,
  MS_pilot_y, MS_pilot_z, MS_copilot_x, MS_copilot_y, MS_copilot_z,
  MS_lpass_x, MS_lpass_y, MS_lpass_z, MS_rpass_x, MS_rpass_y, MS_rpass_z,
  MS_baggage_x, MS_baggage_y, MS_baggage_z, MS_N
};

// tables: the buffer holds each one's offset at P_TB + index
enum TableP : int {
  TB_CD_df, TB_CD_ge, TB_CD_alpha_df, TB_CY_beta_df, TB_CY_p, TB_CY_r,
  TB_CL_ge, TB_CL_alpha, TB_CL_df, TB_Cl_r, TB_Cm_df, TB_delta_wot,
  TB_mu_wot, TB_pi_std, TB_pi_wot, TB_pi_ratio, TB_sfc_ratio, TB_sfc_pow,
  TB_prop, TB_N
};

constexpr int N_LEGS = 3;
constexpr int P_AE = 0;
constexpr int P_LG = P_AE + AE_N;
constexpr int P_EN = P_LG + N_LEGS * LG_N;
constexpr int P_PR = P_EN + EN_N;
constexpr int P_MS = P_PR + PR_N;
constexpr int P_TB = P_MS + MS_N;
constexpr int P_HEAD = P_TB + TB_N;

// one servo of the fly-by-wire actuation (models/c172/c172x.py::Actuator1):
// its time constant and range. The buffer of the fly-by-wire instances
// holds N_ACT of them after the table offsets, in channel order (below)
enum ActP : int { AC_tau, AC_lo, AC_hi, AC_N };

// ------------------------------------------------------------- row maps

// x_sys: aero alpha_filt, beta_filt; fuel; ldg frc[3][2]; engine frc, idle,
// omega
constexpr int XS_ALPHA = 0, XS_BETA = 1, XS_FUEL = 2, XS_FRC = 3,
              XS_EFRC = 9, XS_IDLE = 10, XS_OMEGA = 11, N_XSYS = 12;
// u_sys: act (11, sorted names), engine mixture, mixture_ctl, start, stop,
// throttle; payload pilot, copilot, lpass, rpass, baggage
constexpr int US_AIL = 0, US_AIL_OFF = 1, US_BRK_L = 2, US_BRK_R = 3,
              US_ELV = 4, US_ELV_OFF = 5, US_FLAPS = 6, US_MIX = 7,
              US_RUD = 8, US_RUD_OFF = 9, US_THR = 10, US_E_MIX = 11,
              US_E_MIXCTL = 12, US_E_START = 13, US_E_STOP = 14,
              US_E_THR = 15, US_PLD = 16, N_USYS = 21;
// s_sys: aero stall, crashed, engine state (all as 0/1/2 in T)
constexpr int SS_STALL = 0, SS_CRASHED = 1, SS_STATE = 2, N_SSYS = 3;
// terrain: elevation, normal[3], surface code
constexpr int TR_ELEV = 0, TR_NORMAL = 1, TR_SURF = 4, N_TRN = 5;
// mass properties m, J[3][3], r_OG[3]; wrench F[3], tau[3]; rotor momentum
constexpr int N_MP = 13, N_WR = 6, N_HR = 3;

// systems: in  = x_sys, k_sys, u_sys, s_sys, trn, KinData, AirData, term
//          out = x_sys derivative, mp_b, wr_b, hr_b
constexpr int SYS_N_IN =
    2 * N_XSYS + N_USYS + N_SSYS + N_TRN + N_KIN + N_AIR + 1;        // 116
constexpr int SYS_N_OUT = N_XSYS + N_MP + N_WR + N_HR;               // 34
// finish_sys: in  = x_sys, ksum_sys, u_sys, s_sys, trn, KinData, AirData
//             out = x_sys, s_sys
constexpr int FSYS_N_IN =
    2 * N_XSYS + N_USYS + N_SSYS + N_TRN + N_KIN + N_AIR;            // 115
constexpr int FSYS_N_OUT = N_XSYS + N_SSYS;                          // 15

// The actuation a kernel instance carries: the mechanical linkage of the
// C172S (ACT_MECH) or the fly-by-wire servos of the C172X (the ACT_FBW bit:
// seven first-order servos, their positions the last rows of x_sys, their
// commands at the head of u_sys). An instance of each kernel that carries
// the systems is compiled for each; the ACT_MECH ones are the code they
// were before the C172X came. The ACT_TURB bit, beside the actuation, puts
// the vehicle in Dryden turbulence (turbulence.cuh): five filter states
// after X's systems rows, its inputs and held drive after CTX, which role
// KIN integrates and applies to the air data (the whole-vehicle kernels
// only). ACT_TURB alone is the turbulent C172S, ACT_FBW_TURB the turbulent
// fly-by-wire C172X; the values of the first three are those they had
// before the bits, so their instances keep their machine code. Above
// ACT_TURB, one bit per servo channel puts a second-order servo on it
// (ACT_A2_SHIFT, below).
enum ActKind : int {
  ACT_MECH = 0,
  ACT_FBW = 1,
  ACT_TURB = 2,
  ACT_FBW_TURB = ACT_FBW | ACT_TURB
};
__host__ __device__ constexpr bool act_fbw(int act) {
  return (act & ACT_FBW) != 0;
}
__host__ __device__ constexpr bool act_turb(int act) {
  return (act & ACT_TURB) != 0;
}

// the fly-by-wire C172: the servo channels (sorted names, the order of
// their x_sys rows and parameters); x_sys the mechanical rows, then the
// servo positions; u_sys the seven commands and the mixture (sorted
// names), then the engine and payload rows as in the mechanical layout
constexpr int CH_AIL = 0, CH_BRK_L = 1, CH_BRK_R = 2, CH_ELV = 3,
              CH_FLAPS = 4, CH_RUD = 5, CH_THR = 6, N_ACT = 7;
// a second-order servo (models/c172/c172x.py::Actuator2) on channel ch: the
// ActKind bit ACT_A2_SHIFT + ch. Its two states, the position p and the
// rate v, take the channel's row of x_sys and the next (every later row of
// X, CTX, C and the megakernel's buffer moves by one), and two of role
// DRAG's slots alike (act_slot); the scratch's SH_ACT + ch holds the
// position, which is all the other roles read. The instances of ACT_FBW and
// ACT_FBW_TURB carry no such bit: each `if constexpr` on the bits, and
// act_slot, which is the channel itself for them, compile to their code of
// before. The card carries the elevator set, ACT_FBW_A2
// (the vehicle of the JAX package's tests/test_actuators.py:95).
constexpr int ACT_A2_SHIFT = 2;
enum : int { ACT_FBW_A2 = ACT_FBW | (1 << (ACT_A2_SHIFT + CH_ELV)) };
__host__ __device__ constexpr bool act_a2(int act, int ch) {
  return ((act >> (ACT_A2_SHIFT + ch)) & 1) != 0;
}
// the second-order channels below channel ch (all of them by default)
__host__ __device__ constexpr int n_a2(int act, int ch = N_ACT) {
  int n = 0;
  for (int k = 0; k < ch; ++k) n += act_a2(act, k) ? 1 : 0;
  return n;
}
// role DRAG's slot of channel ch's first state (its row after XS_ACT): ch
// itself where the kind has no second-order channel
__host__ __device__ constexpr int act_slot(int act, int ch) {
  return (act >> ACT_A2_SHIFT) == 0 ? ch : ch + n_a2(act, ch);
}
// a second-order servo's coefficients omega_n^2 and 2 zeta omega_n, formed
// in float64 on the host (kernels.py::param_act); the instances that carry
// such servos read them after the servos' ActP, a pair per second-order
// channel in channel order
enum A2P : int { A2_W2, A2_ZW2, A2_N };
constexpr int XS_ACT = N_XSYS, N_XSYS_FBW = XS_ACT + N_ACT;          // 19
constexpr int UF_MIX = 5, UF_E_MIX = 8, UF_PLD = 13, N_USYS_FBW = 18;
constexpr int P_ACT = P_HEAD, P_HEAD_FBW = P_ACT + N_ACT * AC_N;
constexpr int P_A2 = P_HEAD_FBW;
// the turbulent vehicle's buffer holds the drive's scale sqrt(pi / dt) after
// the table offsets (after the servos, fly-by-wire)
constexpr int P_TURB_K_ETA = P_HEAD, P_HEAD_TURB = P_HEAD + 1;
constexpr int P_TURB_K_ETA_FBW = P_HEAD_FBW,
              P_HEAD_FBW_TURB = P_HEAD_FBW + 1;
// what the finish kernels of the fly-by-wire C172 store for its avionics:
// SYS_Y the gated airflow angles and each leg's weight on wheels at the new
// state (finish_sys, rk4_finish), KIN_Y the KinData and AirData fields the
// control laws read (rk4_finish; on the cluster path finish_kin stores
// them all): omega_wb_b, e_nb, v_eb_n, chi_gnd, EAS
constexpr int SY_ALPHA = 0, SY_BETA = 1, SY_WOW = 2, N_SYSY = 5;
constexpr int KY_OM_WB = 0, KY_E_NB = 3, KY_V_EB_N = 6, KY_CHI = 9,
              KY_EAS = 10, N_KINY = 11;
constexpr int SYS_N_IN_FBW =
    2 * N_XSYS_FBW + N_USYS_FBW + N_SSYS + N_TRN + N_KIN + N_AIR + 1;  // 139
constexpr int SYS_N_OUT_FBW = N_XSYS_FBW + N_MP + N_WR + N_HR;       // 41
constexpr int FSYS_N_IN_FBW =
    2 * N_XSYS_FBW + N_USYS_FBW + N_SSYS + N_TRN + N_KIN + N_AIR;      // 138
constexpr int FSYS_N_OUT_FBW = N_XSYS_FBW + N_SSYS + N_SYSY;         // 27

// the systems rows of an actuation: x_sys and u_sys rows, where the engine
// and payload inputs start in u_sys, and the whole vehicle's X and CTX
// (below) built on them
template <int ACT>
struct SysL {
  enum : int {
    NX = act_fbw(ACT) ? N_XSYS_FBW + n_a2(ACT) : N_XSYS,
    // the servos' states (role DRAG's slots)
    NACT = act_fbw(ACT) ? N_ACT + n_a2(ACT) : 0,
    NU = act_fbw(ACT) ? N_USYS_FBW : N_USYS,
    U_E = act_fbw(ACT) ? UF_E_MIX : US_E_MIX,
    U_E_MIXCTL = U_E + 1,
    U_E_START = U_E + 2,
    U_E_STOP = U_E + 3,
    U_PLD = U_E + 5,
    NXV = N_XKIN + N_XDYN + NX + (act_turb(ACT) ? N_XTURB : 0),
    CX_UATM = NU,
    CX_TRN = CX_UATM + N_UATM,
    CX_SSYS = CX_TRN + N_TRN,
    CX_GEOID = CX_SSYS + N_SSYS,
    CX_TERM = CX_GEOID + 1,
    // the turbulent vehicle: x_turb after the systems rows of X; u_turb and
    // the held drive after the latch in CTX
    X_TURB = N_XKIN + N_XDYN + NX,
    CX_UTURB = CX_TERM + 1,
    CX_ETA = CX_UTURB + (act_turb(ACT) ? N_UTURB : 0),
    NCTX = CX_ETA + (act_turb(ACT) ? N_ETA : 0),
    // where the parameters hold the drive's scale
    P_TURB = act_fbw(ACT) ? P_TURB_K_ETA_FBW : P_TURB_K_ETA
  };
};

// the whole vehicle (rk4_stage, rk4_finish, megakernel):
// X   = x_kin, x_dyn, x_sys                          (N_X rows)
// CTX = u_sys, u_atm, trn, s_sys, geoid_N, term      (N_CTX rows)
// C   = the residuals of q_ew[4] and h_e             (N_C rows)
constexpr int N_X = N_XKIN + N_XDYN + N_XSYS;                        // 27
constexpr int X_DYN = N_XKIN, X_SYS = N_XKIN + N_XDYN;
constexpr int CX_USYS = 0, CX_UATM = N_USYS, CX_TRN = N_USYS + N_UATM,
              CX_SSYS = CX_TRN + N_TRN, CX_GEOID = CX_SSYS + N_SSYS,
              CX_TERM = CX_GEOID + 1, N_CTX = CX_TERM + 1;           // 36
constexpr int N_C = 5;
// rk4_stage: in = X, CTX ; k = X ; out = X derivative
constexpr int STAGE_N_IN = N_X + N_CTX;                              // 63
constexpr int STAGE_N_OUT = N_X;                                     // 27
// rk4_finish: in = X, CTX, C ; ksum = X ; out = X, s_sys, term, C
constexpr int RKFIN_N_IN = N_X + N_CTX + N_C;                        // 68
constexpr int RKFIN_N_OUT = N_X + N_SSYS + 1 + N_C;                  // 36
// megakernel: one [MEGA_N_ROWS, B] state buffer t, X, CTX, C, and the
// int32 step counter i beside it
constexpr int MG_T = 0, MG_X = 1, MG_CTX = MG_X + N_X, MG_C = MG_CTX + N_CTX,
              MEGA_N_ROWS = MG_C + N_C;                              // 69
// the fly-by-wire vehicle (rk4_stage, rk4_finish; rk4_finish stores the
// avionics' KIN_Y and SYS_Y after its mechanical outputs)
constexpr int N_X_FBW = N_XKIN + N_XDYN + N_XSYS_FBW;                // 34
constexpr int N_CTX_FBW = N_USYS_FBW + N_UATM + N_TRN + N_SSYS + 2;  // 33
constexpr int STAGE_N_IN_FBW = N_X_FBW + N_CTX_FBW;                  // 67
constexpr int STAGE_N_OUT_FBW = N_X_FBW;                             // 34
constexpr int RKFIN_N_IN_FBW = N_X_FBW + N_CTX_FBW + N_C;            // 72
constexpr int RKFIN_N_OUT_FBW =
    N_X_FBW + N_SSYS + 1 + N_C + N_KINY + N_SYSY;                    // 59
// the turbulent C172S (ACT_TURB): X and CTX with the turbulence's rows; the
// stage reads the step's start time after CTX, the finish the residuals
// after it and the int32 rows (i, seed, n), and stores the new drive after
// its C172S outputs; the megakernel's buffer is t, X, CTX, C beside the
// int32 [3, B] rows
enum : int {
  N_X_TURB = N_X + N_XTURB,                                          // 32
  N_CTX_TURB = N_CTX + N_UTURB + N_ETA,                              // 46
  STAGE_N_IN_TURB = N_X_TURB + N_CTX_TURB + 1,                       // 79
  STAGE_N_OUT_TURB = N_X_TURB,                                       // 32
  RKFIN_N_IN_TURB = STAGE_N_IN_TURB + N_C,                           // 84
  RKFIN_N_OUT_TURB = N_X_TURB + N_SSYS + 1 + N_C + N_ETA,            // 44
  MEGA_N_ROWS_TURB = 1 + N_X_TURB + N_CTX_TURB + N_C                 // 84
};
// the turbulent fly-by-wire C172X (ACT_FBW_TURB): the fly-by-wire X and CTX
// with the turbulence's rows as above; the finish stores the avionics'
// KIN_Y and SYS_Y after the residuals, then the new drive
enum : int {
  N_X_FBW_TURB = N_X_FBW + N_XTURB,                                  // 39
  N_CTX_FBW_TURB = N_CTX_FBW + N_UTURB + N_ETA,                      // 43
  STAGE_N_IN_FBW_TURB = N_X_FBW_TURB + N_CTX_FBW_TURB + 1,           // 83
  STAGE_N_OUT_FBW_TURB = N_X_FBW_TURB,                               // 39
  RKFIN_N_IN_FBW_TURB = STAGE_N_IN_FBW_TURB + N_C,                   // 88
  RKFIN_N_OUT_FBW_TURB =
      N_X_FBW_TURB + N_SSYS + 1 + N_C + N_KINY + N_SYSY + N_ETA      // 67
};

// ------------------------------------------------------------- helpers

template <typename T>
__device__ __forceinline__ const T* table(const T* P, int k) {
  return P + int(P[P_TB + k].v);
}

template <typename T>
__device__ __forceinline__ T lookup1(const T* P, int k, T x0) {
  return lookup<T, 1, 1>(table(P, k), x0, T(0), T(0)).v[0];
}

template <typename T>
__device__ __forceinline__ T lookup2(const T* P, int k, T x0, T x1) {
  return lookup<T, 2, 1>(table(P, k), x0, x1, T(0)).v[0];
}

template <typename T>
struct PIParams {
  T k_p, k_i, k_l, beta_p, lo, hi;
};

template <typename T>
__device__ __forceinline__ PIParams<T> pi_params(const T* p) {
  return {p[0], p[1], p[2], p[3], p[4], p[5]};
}

// continuous PI with anti-windup, sat_ext = 0 (physics/control.py::pi_ode):
// returns the integrator derivative, sets the clamped output
template <typename T>
__device__ __forceinline__ T pi_ode(const PIParams<T>& p, T x_i, T inp,
                                    T& output) {
  const T u_p = p.beta_p * inp;
  const T out_free = p.k_p * u_p + x_i;
  output = clamp(out_free, p.lo, p.hi);
  const int sat = int(out_free >= p.hi) - int(out_free <= p.lo);
  const bool halted = inp * T(double(sat)) > T(0);
  return p.k_i * inp * (T(1.0) - T(halted ? 1.0 : 0.0)) - p.k_l * x_i;
}

// ------------------------------------------------------------- actuation
// models/c172/c172s.py::MechanicalActuation

template <typename T>
struct Act {
  T e, a, r, f, steering, brake_left, brake_right, throttle, mixture;
};

template <typename T>
__device__ __forceinline__ Act<T> actuation(const T (&u)[N_USYS]) {
  const T one = T(1.0), zero = T(0.0);
  const T ail = clamp(u[US_AIL_OFF] + u[US_AIL], -one, one);
  const T elv = clamp(u[US_ELV_OFF] + u[US_ELV], -one, one);
  const T rud = clamp(u[US_RUD_OFF] + u[US_RUD], -one, one);
  return {-elv, ail, -rud, clamp(u[US_FLAPS], zero, one), rud,
          clamp(u[US_BRK_L], zero, one), clamp(u[US_BRK_R], zero, one),
          clamp(u[US_THR], zero, one), clamp(u[US_MIX], zero, one)};
}

// models/c172/c172x.py::FlyByWireActuation, Actuator1: the position of
// servo `ch` is its state clipped to its range; its derivative
// (clip(cmd) - x) / tau, the true quotient
template <typename T>
__device__ __forceinline__ T servo_pos(const T* P, int ch, T x) {
  const T* A = P + P_ACT + ch * AC_N;
  return clamp(x, A[AC_lo], A[AC_hi]);
}

template <typename T>
__device__ __forceinline__ T servo_dot(const T* P, int ch, T x, T cmd) {
  const T* A = P + P_ACT + ch * AC_N;
  return (clamp(cmd, A[AC_lo], A[AC_hi]) - x) / A[AC_tau];
}

// Actuator2 on channel ch, the j-th second-order channel: the derivatives
// p' = v and v' = omega_n^2 (clip(cmd) - p) - 2 zeta omega_n v of its
// position p and rate v, in the association order of the Python
template <typename T>
__device__ __forceinline__ void servo2_dot(const T* P, int ch, int j, T p,
                                           T v, T cmd, T& p_dot, T& v_dot) {
  const T* A = P + P_ACT + ch * AC_N;
  const T* W = P + P_A2 + j * A2_N;
  p_dot = v;
  v_dot = W[A2_W2] * (clamp(cmd, A[AC_lo], A[AC_hi]) - p) - W[A2_ZW2] * v;
}

// the u_sys row of channel ch's command (the mixture sits among them)
__device__ __forceinline__ int fbw_cmd_row(int ch) {
  return ch < UF_MIX ? ch : ch + 1;
}

// the assignments of the servo states x (channel order), with the C172S's
// sign conventions; the mixture from its command
template <typename T>
__device__ __forceinline__ Act<T> fbw_actuation(const T* P,
                                                const T (&x)[N_ACT],
                                                T mixture) {
  T p[N_ACT];
#pragma unroll
  for (int k = 0; k < N_ACT; ++k) p[k] = servo_pos(P, k, x[k]);
  return {-p[CH_ELV], p[CH_AIL], -p[CH_RUD], p[CH_FLAPS], p[CH_RUD],
          p[CH_BRK_L], p[CH_BRK_R], p[CH_THR],
          clamp(mixture, T(0.0), T(1.0))};
}

// ------------------------------------------------------------- aero
// models/c172/common.py::Aero

// airflow angles with the low-TAS guard, and the guarded velocity
template <typename T>
__device__ __forceinline__ void alpha_gated(const Air<T>& air, T& alpha,
                                            T& beta, V3<T>& v_safe) {
  const bool small = air.TAS <= T(0.1);
  v_safe = small ? V3<T>{T(1.0), T(0), T(0)} : air.v_wb_b;
  T a, b;
  airflow_angles(v_safe, a, b);
  alpha = small ? T(0) : a;
  beta = small ? T(0) : b;
}

template <typename T>
__device__ __forceinline__ T scale_u(T u, double lo_u, double hi_u, T lo,
                                     T sc) {
  return lo + sc * (clamp(u, T(lo_u), T(hi_u)) - T(lo_u));
}

// which half of the aero coefficients a call works out; the two need not
// wait for each other
constexpr int AERO_DRAG_SIDE = 1, AERO_LIFT_MOMENTS = 2;

// the derivative of the alpha/beta filters, the aero force in stability
// axes with the cos/sin of alpha that turn it into body axes, and the
// torque. AERO_DRAG_SIDE fills f_s.x and f_s.y only, AERO_LIFT_MOMENTS the
// rest
template <typename T>
struct AeroOut {
  T alpha_filt_dot, beta_filt_dot;
  V3<T> f_s;
  T ca, sa;
  V3<T> tau;
};

template <int PART, typename T>
__device__ __forceinline__ void aero_parts(const T* P, T alpha_filt,
                                           T beta_filt, const Act<T>& u,
                                           bool stall, const Kin<T>& kin,
                                           const Air<T>& air, T elevation,
                                           AeroOut<T>& o) {
  constexpr bool drag_side = PART == AERO_DRAG_SIDE;
  constexpr bool lift_moments = PART == AERO_LIFT_MOMENTS;
  const T* A = P + P_AE;
  T alpha, beta;
  V3<T> v_safe;
  alpha_gated(air, alpha, beta, v_safe);
  const T V = clamp_min(air.TAS, A[AE_V_min]);
  o.alpha_filt_dot = (alpha - alpha_filt) / A[AE_tau];
  o.beta_filt_dot = (beta - beta_filt) / A[AE_tau];
  const T V2 = T(2.0) * V;
  const T p_nd = kin.omega_wb_b.x * A[AE_b] / V2;
  const T q_nd = kin.omega_wb_b.y * A[AE_c] / V2;
  const T r_nd = kin.omega_wb_b.z * A[AE_b] / V2;
  T alpha_dot_nd = o.alpha_filt_dot * A[AE_c] / V2;
  const T de = scale_u(u.e, -1.0, 1.0, A[AE_e_lo], A[AE_e_sc]);
  const T da = scale_u(u.a, -1.0, 1.0, A[AE_a_lo], A[AE_a_sc]);
  const T dr = scale_u(u.r, -1.0, 1.0, A[AE_r_lo], A[AE_r_sc]);
  const T df = scale_u(u.f, 0.0, 1.0, A[AE_f_lo], A[AE_f_sc]);
  const T dh_nd = (kin.h_o - elevation) / A[AE_b];
  const T qS = air.q * A[AE_S];

  // coefficient assembly (get_aero_coeffs)
  alpha = clamp(alpha, T(-0.1), T(0.36));
  beta = clamp(beta, T(-0.2), T(0.2));
  alpha_dot_nd = clamp(alpha_dot_nd, T(-0.04), T(0.04));
  if (drag_side) {
    const T cd_beta = T(0.17) * Abs(beta);
    const T cd_de = T(0.06) * Abs(de);
    const T cd_df = lookup1(P, TB_CD_df, df);
    const T cd_ge = lookup1(P, TB_CD_ge, dh_nd);
    const T cd_adf = lookup2(P, TB_CD_alpha_df, alpha, df);
    const T cy_bdf = lookup2(P, TB_CY_beta_df, beta, df);
    const T cy_p = lookup2(P, TB_CY_p, alpha, df);
    const T cy_r = lookup2(P, TB_CY_r, alpha, df);
    const T C_D = A[AE_CD_zero] + cd_ge * (cd_adf + cd_df) + cd_de + cd_beta;
    const T C_Y = A[AE_CY_dr] * dr + A[AE_CY_da] * da + cy_bdf +
                  cy_p * p_nd + cy_r * r_nd;
    o.f_s.x = qS * -C_D;
    o.f_s.y = qS * C_Y;
  }
  if (lift_moments) {
    const T stall_f = T(stall ? 1.0 : 0.0);
    const T cl_ge = lookup1(P, TB_CL_ge, dh_nd);
    const T cl_a = lookup2(P, TB_CL_alpha, alpha, stall_f);
    const T cl_df = lookup1(P, TB_CL_df, df);
    const T cl_r = lookup2(P, TB_Cl_r, alpha, df);
    const T cm_df = lookup1(P, TB_Cm_df, df);
    const T C_L = cl_ge * (cl_a + cl_df) + A[AE_CL_de] * de +
                  A[AE_CL_q] * q_nd + A[AE_CL_adot] * alpha_dot_nd;
    const T C_l = A[AE_Cl_da] * da + A[AE_Cl_dr] * dr + A[AE_Cl_beta] * beta +
                  A[AE_Cl_p] * p_nd + cl_r * r_nd;
    const T C_m = A[AE_Cm_zero] + A[AE_Cm_de] * de + cm_df +
                  A[AE_Cm_alpha] * alpha + A[AE_Cm_q] * q_nd +
                  A[AE_Cm_adot] * alpha_dot_nd;
    const T C_n = A[AE_Cn_dr] * dr + A[AE_Cn_da] * da + A[AE_Cn_beta] * beta +
                  A[AE_Cn_p] * p_nd + A[AE_Cn_r] * r_nd;
    o.f_s.z = qS * -C_L;
    o.tau = {qS * (C_l * A[AE_b]), qS * (C_m * A[AE_c]),
             qS * (C_n * A[AE_b])};

    // stability -> airframe rotation from the algebraic cos/sin alpha
    const T vx = v_safe.x, vz = v_safe.z;
    const T m2 = vx * vx + vz * vz;
    const T minv = Rsqrt(clamp_min(m2, T(1e-30)));
    const bool okm = m2 > T(0);
    o.ca = okm ? vx * minv : T(1.0);
    o.sa = okm ? vz * minv : T(0.0);
  }
}

// the aero force in body axes from its stability-axes components
template <typename T>
__device__ __forceinline__ V3<T> aero_force(T ca, T sa, V3<T> f_s) {
  return rot2_y(ca, -sa, f_s);
}

// ------------------------------------------------------------- gear leg
// physics/landinggear.py::LandingGearUnit

constexpr double PSI_SKID = 10.0 * (PI / 180.0);
constexpr double ALPHA_TS_MAX = 60.0 * (PI / 180.0);
constexpr double XI_DOT_MAX = 10.0;

// strut quantities, masked to the weight-off-wheels defaults; `live` is
// false where the strut's body was skipped (strut_y)
template <typename T>
struct Strut {
  bool wow, live;
  T xi_dot, F_dmp_zs, alpha_ts;
  V3<T> r_bc_b;
  Q4<T> q_sc, q_bc;
  T vx, vy;
};

// the head of the strut: is the wheel at or below the terrain?
template <typename T>
struct StrutHead {
  bool wow;
  T delta_h;
  V3<T> ks_e, n_up_e;
};

template <typename T>
__device__ __forceinline__ StrutHead<T> strut_head(const T* L,
                                                   const Kin<T>& kin,
                                                   T elevation) {
  const T l_0 = L[LG_l_0];
  const Q4<T> q_bs = {T(1.0), T(0.0), T(0.0), T(0.0)};
  const V3<T> r_bs_b = {L[LG_r_bs_x], L[LG_r_bs_y], L[LG_r_bs_z]};
  const V3<T> E3 = {T(0.0), T(0.0), T(1.0)};

  const Q4<T> q_es = qmul(kin.q_eb, q_bs);
  const V3<T> ks_e = qrot(q_es, E3);
  const V3<T> r_bs_e = qrot(kin.q_eb, r_bs_b);
  const V3<T> n_up_e = kin.n_e;
  const V3<T> d_e = add(r_bs_e, scale(l_0, ks_e));
  const T h_e_w0 = kin.h_e + dot(d_e, n_up_e);
  const T h_e_trn = elevation + (kin.h_e - kin.h_o);
  const T delta_h = h_e_w0 - h_e_trn;
  return {delta_h <= T(0), delta_h, ks_e, n_up_e};
}

// the strut from its head on: compression, contact frame and contact-point
// velocity, masked to the defaults where the wheel is off the ground
template <typename T>
__device__ Strut<T> strut_body(const T* L, T steering, const Kin<T>& kin,
                               V3<T> normal, const StrutHead<T>& hd) {
  const T l_0 = L[LG_l_0];
  const Q4<T> q_bs = {T(1.0), T(0.0), T(0.0), T(0.0)};
  const V3<T> r_bs_b = {L[LG_r_bs_x], L[LG_r_bs_y], L[LG_r_bs_z]};
  const V3<T> E1 = {T(1.0), T(0.0), T(0.0)}, E3 = {T(0.0), T(0.0), T(1.0)};
  const bool wow = hd.wow;
  const V3<T> ks_e = hd.ks_e;
  const V3<T> r_st_e = sub(scale(l_0, ks_e), scale(hd.delta_h, hd.n_up_e));

  const V3<T> ut_n = normal;
  const V3<T> ut_e = qrot(kin.q_en, ut_n);
  const T ut_ks = dot(ut_e, ks_e);
  const T ut_ks_safe = Abs(ut_ks) < T(1e-6)
                           ? (ut_ks < T(0) ? T(-1e-6) : T(1e-6))
                           : ut_ks;
  const T l = dot(ut_e, r_st_e) / ut_ks_safe;
  const T alpha_ts = Acos(clamp(ut_ks, T(-1.0), T(1.0)));
  const T xi = clamp_max(l - l_0, T(0.0));

  const T ls = l_0 + xi;
  const V3<T> r_sc_b = qrot(q_bs, V3<T>{E3.x * ls, E3.y * ls, E3.z * ls});
  const V3<T> r_bc_b = add(r_sc_b, r_bs_b);
  const V3<T> v_ec_b_body = add(kin.v_eb_b, cross(kin.omega_eb_b, r_bc_b));
  const T psi_sw = clamp(steering, T(-1.0), T(1.0)) * L[LG_psi_max];

  const Q4<T> q_sw = rot_z(psi_sw);
  const Q4<T> q_ns = qmul(kin.q_nb, q_bs);
  const Q4<T> q_nw = qmul(q_ns, q_sw);
  const V3<T> kc_n = ut_n;
  const V3<T> iw_n = qrot(q_nw, E1);
  const V3<T> iw_n_trn = sub(iw_n, scale(dot(iw_n, kc_n), kc_n));
  const T nrm = Sqrt(iw_n_trn.x * iw_n_trn.x + iw_n_trn.y * iw_n_trn.y +
                     iw_n_trn.z * iw_n_trn.z + T(1e-12));
  const V3<T> ic_n = {iw_n_trn.x / nrm, iw_n_trn.y / nrm, iw_n_trn.z / nrm};
  const V3<T> jc_n = cross(kc_n, ic_n);
  const Q4<T> q_nc = matrix_to_quat(ic_n, jc_n, kc_n);
  const Q4<T> q_sc = qmul(qconj(q_ns), q_nc);
  const Q4<T> q_bc = qmul(q_bs, q_sc);

  const V3<T> v_ec_c_body = qrot_inv(q_bc, v_ec_b_body);
  const V3<T> ks_c = qrot_inv(q_sc, E3);
  const T ks_c3 = Abs(ks_c.z) < T(1e-6) ? T(1e-6) : ks_c.z;
  const T xi_dot = -v_ec_c_body.z / ks_c3;
  const T k_d = xi_dot > T(0) ? L[LG_k_d_ext] : L[LG_k_d_cmp];
  const T F_dmp_zs = -(L[LG_k_s] * xi + k_d * xi_dot);
  const V3<T> v_ec_c = add(v_ec_c_body, scale(xi_dot, ks_c));

  const T z = T(0.0);
  const Q4<T> q1 = {T(1.0), z, z, z};
  Strut<T> s;
  s.wow = wow;
  s.live = true;
  s.xi_dot = wow ? xi_dot : z;
  s.F_dmp_zs = wow ? F_dmp_zs : z;
  s.alpha_ts = wow ? alpha_ts : z;
  s.r_bc_b = wow ? r_bc_b : V3<T>{z, z, z};
  s.q_sc = wow ? q_sc : q1;
  s.q_bc = wow ? q_bc : q1;
  s.vx = wow ? v_ec_c.x : z;
  s.vy = wow ? v_ec_c.y : z;
  return s;
}

// Strut quantities of one leg. Off the ground strut_body masks everything
// to fixed values, so where no thread of the warp that runs this with ours
// has its wheel on the ground, the body is skipped and those values are
// returned: per warp what the reference's fleet gear gate does
// (flightjax/physics/landinggear.py:59), and exact for the same reason,
// whichever threads the vote happens to see. On an airborne fleet it takes
// 5% off rk4_stage and 7-10% off the megakernel (PERF.md).
template <typename T>
__device__ __forceinline__ Strut<T> strut_y(const T* L, T steering,
                                            const Kin<T>& kin, T elevation,
                                            V3<T> normal) {
  const StrutHead<T> hd = strut_head(L, kin, elevation);
  if (__any_sync(__activemask(), hd.wow))
    return strut_body(L, steering, kin, normal, hd);
  const T z = T(0.0);
  const Q4<T> q1 = {T(1.0), z, z, z};
  return {false, false, z, z, z, {z, z, z}, q1, q1, z, z};
}

template <typename T>
__device__ __forceinline__ T mu_blend(T mu_s, T mu_d, double v_s, double v_d,
                                      T v) {
  const T k_sd = clamp((v - T(v_s)) / T(v_d - v_s), T(0.0), T(1.0));
  return k_sd * mu_d + (T(1.0) - k_sd) * mu_s;
}

// contact wrench in body axes, zero off the ground; out_x/out_y are the
// friction regulator's outputs
template <typename T>
__device__ void contact_wrench(const T* L, T braking, const Strut<T>& s,
                               int surface, T out_x, T out_y, V3<T>& F,
                               V3<T>& tau) {
  const T norm_v = Sqrt(s.vx * s.vx + s.vy * s.vy + T(1e-12));
  const T m_roll = mu_blend(T(0.03), T(0.02), 0.005, 0.01, norm_v);
  const double mu_s = surface == 0 ? 0.75 : (surface == 1 ? 0.25 : 0.075);
  const double mu_d = surface == 0 ? 0.25 : (surface == 1 ? 0.15 : 0.025);
  const T m_skid = mu_blend(T(mu_s), T(mu_d), 0.005, 0.01, norm_v);
  const T kappa_br = clamp(braking, T(0.0), T(1.0)) * L[LG_eta_br];
  const T mu_x = m_roll + (m_skid - m_roll) * kappa_br;

  const bool small_v = norm_v < T(1e-3);
  const T psi_cv = small_v ? T(PI / 2) : Atan2(s.vy, s.vx);
  const T psi_skid = T(PSI_SKID);
  const T psi_abs = Abs(psi_cv);
  const T mu_y =
      psi_abs < psi_skid
          ? m_skid * psi_abs / psi_skid
          : (psi_abs > T(PI - PSI_SKID)
                 ? m_skid * (T(1.0) - (psi_skid + psi_abs - T(PI)) / psi_skid)
                 : m_skid);

  const T sc = clamp_max(m_skid / Sqrt(mu_x * mu_x + mu_y * mu_y + T(1e-12)),
                         T(1.0));
  const V3<T> f_c = {out_x * (mu_x * sc), out_y * (mu_y * sc), T(-1.0)};
  const V3<T> f_s = qrot(s.q_sc, f_c);
  const T f_s3 = Abs(f_s.z) < T(1e-6) ? T(-1e-6) : f_s.z;
  const T N = clamp_min(-s.F_dmp_zs / f_s3, T(0.0));
  const V3<T> F_c = {f_c.x * N, f_c.y * N, f_c.z * N};
  const V3<T> F_b = qrot(s.q_bc, F_c);
  const V3<T> tau_b = add(qrot(s.q_bc, V3<T>{T(0.0), T(0.0), T(0.0)}),
                          cross(s.r_bc_b, F_b));
  const V3<T> z = {T(0.0), T(0.0), T(0.0)};
  F = s.wow ? F_b : z;
  tau = s.wow ? tau_b : z;
}

// gear leg `leg`: friction-regulator derivative and contact wrench (zero
// off the ground, so not worked out where the strut's body was skipped)
template <typename T>
__device__ void gear_leg(const T* P, int leg, T frc_x, T frc_y, T steering,
                         T braking, const Kin<T>& kin, T elevation,
                         V3<T> normal, int surface, T& frc_dot_x,
                         T& frc_dot_y, V3<T>& F, V3<T>& tau) {
  const T* L = P + P_LG + leg * LG_N;
  const Strut<T> s = strut_y(L, steering, kin, elevation, normal);
  const PIParams<T> pi = pi_params(L + LG_frc_k_p);
  T out_x, out_y;
  frc_dot_x = pi_ode(pi, frc_x, -s.vx, out_x);
  frc_dot_y = pi_ode(pi, frc_y, -s.vy, out_y);
  F = tau = {T(0.0), T(0.0), T(0.0)};
  if (s.live) contact_wrench(L, braking, s, surface, out_x, out_y, F, tau);
}

// ------------------------------------------------------------- powerplant
// physics/propellers.py::Propeller.output, physics/piston.py

template <typename T>
struct PropOut {
  V3<T> F_b, tau_b, hr_b;
  T tau_px;  // shaft torque component of the propeller-frame wrench
};

template <typename T>
__device__ PropOut<T> propeller(const T* P, const Kin<T>& kin,
                                const Air<T>& air, T omega) {
  const T* R = P + P_PR;
  const Q4<T> q_bp = {T(1.0), T(0.0), T(0.0), T(0.0)};
  const V3<T> r_bp = {R[PR_r_bp_x], R[PR_r_bp_y], R[PR_r_bp_z]};
  const V3<T> v_b = add(air.v_wb_b, cross(kin.omega_eb_b, r_bp));
  const V3<T> v_p = qrot_inv(q_bp, v_b);
  const T v_J = Sqrt(v_p.x * v_p.x + v_p.y * v_p.y + v_p.z * v_p.z + T(1e-12));
  const T omega_J = clamp_min(Abs(omega), T(1.0));
  const T J = T(2.0 * PI) * v_J / (omega_J * R[PR_d]);
  const T Mt = Abs(omega) * R[PR_d_half] / air.a;
  const LookupOut<T, 6> prop_c =
      lookup<T, 3, 6>(table(P, TB_prop), J, Mt, R[PR_dbeta]);
  const T(&C)[6] = prop_c.v;
  T alpha_p, beta_p;
  airflow_angles(v_p, alpha_p, beta_p);
  const T sense = R[PR_sense];
  const V3<T> C_F = {C[0], C[2] * beta_p, C[2] * alpha_p};
  const V3<T> C_M = {sense * C[1], sense * (C[3] * beta_p),
                     sense * (C[3] * alpha_p)};
  const T f = omega / T(2.0 * PI);
  const T f2 = f * f;
  const V3<T> F_p = scale(air.rho * f2 * R[PR_d4], C_F);
  const V3<T> tau_p = scale(air.rho * f2 * R[PR_d5], C_M);
  PropOut<T> o;
  o.F_b = qrot(q_bp, F_p);
  o.tau_b = add(qrot(q_bp, tau_p), cross(r_bp, o.F_b));
  o.tau_px = tau_p.x;
  o.hr_b = qrot(q_bp, V3<T>{R[PR_J_xx] * omega, T(0.0), T(0.0)});
  return o;
}

constexpr double BETA_TROPO = -6.5e-3;
constexpr double F_LEAN = 0.0625, F_RICH = 0.0950;

template <typename T>
__device__ __forceinline__ T T_ISA(T p) {
  return T(T_STD) * Pow(p / T(P_STD), T(-BETA_TROPO * R_GAS / G_STD));
}

// engine: its shaft torque, the derivatives of the idle and friction
// regulators and the fuel flow; `state` is 0 off, 1 starting, 2 running.
// The propeller's load joins the shaft torque in engine_omega_dot, so the
// two can be worked out side by side
template <typename T>
__device__ void engine(const T* P, T omega, T idle, T frc, T throttle_u,
                       T mixture_u, T mixture_ctl, int state,
                       const Air<T>& air, T& tau_shaft, T& idle_dot,
                       T& frc_dot, T& mdot) {
  const T* E = P + P_EN;
  const T throttle = clamp(throttle_u, T(0.0), T(1.0));
  const T mixture = clamp(mixture_u, T(0.0), T(1.0));
  T frc_out, idle_out;
  frc_dot = pi_ode(pi_params(E + EN_frc_k_p), frc, -omega, frc_out);
  idle_dot = pi_ode(pi_params(E + EN_idle_k_p), idle,
                    T(1.0) - omega / E[EN_omega_idle], idle_out);
  const T mu_ratio_idle = T(0.5) + idle_out;
  const T n = omega / E[EN_omega_rated];
  const T delta = air.p / T(P_STD) * Rsqrt(T_ISA(air.p) / T(T_STD));

  const T k_f = T(1.0) / Sqrt(air.rho / T(RHO_STD));
  const T f_target = T(F_LEAN) + mixture * T(F_RICH - F_LEAN);
  const T mixture_pos = mixture_ctl == T(0.0)
                            ? T(0.5) * (mixture + T(1.0))
                            : f_target / (k_f * T(F_RICH));
  const T f_run = k_f * T(F_RICH) * mixture_pos;

  const T mu_wot = lookup2(P, TB_mu_wot, n, delta);
  const T pi_ratio_f = lookup1(P, TB_pi_ratio, f_run);
  const T sfc_ratio_f = lookup1(P, TB_sfc_ratio, f_run);
  const T mu = mu_wot * (mu_ratio_idle + throttle * (T(1.0) - mu_ratio_idle));
  const T delta_wot = lookup2(P, TB_delta_wot, n, mu);
  const T pi_std = lookup2(P, TB_pi_std, n, mu);
  const T pi_wot = lookup2(P, TB_pi_wot, n, delta_wot);
  const T denom = delta_wot - T(1.0);
  const bool degenerate = Abs(denom) < T(5e-3);
  const T denom_safe = degenerate ? T(1.0) : denom;
  const T pi_interp = pi_std + (pi_wot - pi_std) / denom_safe * (delta - T(1.0));
  const T pi_isa = clamp_min(degenerate ? pi_std : pi_interp, T(0.0));

  const T pi_pow = pi_isa * Sqrt(T_ISA(air.p) / air.Tk);
  const T pi_actual = pi_pow * pi_ratio_f;
  const T P_run = E[EN_P_rated] * pi_actual;
  const T omega_safe = omega > T(1e-3) ? omega : T(1.0);
  const T tau_run = omega > T(0) ? P_run / omega_safe : T(0.0);
  const T SFC_run = lookup2(P, TB_sfc_pow, n, pi_actual) * sfc_ratio_f;
  const T mdot_run = SFC_run * P_run;
  const T tau_fr = frc_out * E[EN_tau_fr_sc];

  tau_shaft = state == 0 ? tau_fr : (state == 1 ? E[EN_tau_start] : tau_run);
  mdot = state == 2 ? mdot_run : T(0.0);
}

// shaft acceleration under the engine's torque and the propeller's load
template <typename T>
__device__ __forceinline__ T engine_omega_dot(const T* P, T tau_shaft,
                                              T tau_load) {
  return (tau_shaft + tau_load) / P[P_EN + EN_J_sum];
}

// engine state machine (PistonEngine.f_step)
template <typename T>
__device__ __forceinline__ int engine_step(const T* P, int state, T omega,
                                           bool start, bool stop,
                                           bool fuel_available) {
  const T* E = P + P_EN;
  const int next_off = start ? 1 : 0;
  const int next_starting = (omega > E[EN_omega_idle] && fuel_available)
                                ? 2
                                : (!start ? 0 : 1);
  const bool dies = stop || omega < E[EN_omega_stall] || !fuel_available;
  const int next_running = dies ? 0 : 2;
  return state == 0 ? next_off : (state == 1 ? next_starting : next_running);
}

// ------------------------------------------------------------- mass

template <typename T>
__device__ __forceinline__ MP<T> mp_zero() {
  const T z = T(0.0);
  return {z, {{{z, z, z}, {z, z, z}, {z, z, z}}}, {z, z, z}};
}

// MassProps.__add__
template <typename T>
__device__ __forceinline__ MP<T> mp_add(const MP<T>& a, const MP<T>& b) {
  MP<T> o;
  o.m = a.m + b.m;
  const T safe_m = o.m > T(0) ? o.m : T(1.0);
  o.r = {(a.m * a.r.x + b.m * b.r.x) / safe_m,
         (a.m * a.r.y + b.m * b.r.y) / safe_m,
         (a.m * a.r.z + b.m * b.r.z) / safe_m};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.J.m[i][j] = a.J.m[i][j] + b.J.m[i][j];
  return o;
}

// point mass m at r (mass_props_point)
template <typename T>
__device__ __forceinline__ MP<T> mp_point(T m, V3<T> r) {
  const M33<T> SS = mm(skew(r), skew(r));
  MP<T> o;
  o.m = m;
  o.r = r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.J.m[i][j] = -(m * SS.m[i][j]);
  return o;
}

template <typename T>
__device__ __forceinline__ V3<T> pvec(const T* p) {
  return {p[0], p[1], p[2]};
}

template <typename T>
__device__ __forceinline__ T fuel_m_total(const T* M, T x_fuel) {
  return M[MS_M_RES] + x_fuel * M[MS_M_USABLE];
}

// airframe + payload + fuel (Systems.pwp_mass); `pld` are the five slot
// masses in summation order
template <typename T>
__device__ MP<T> mass_sum(const T* P, const T (&pld)[5], T x_fuel) {
  const T* M = P + P_MS;
  MP<T> af;
  af.m = M[MS_m];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) af.J.m[i][j] = M[MS_J00 + 3 * i + j];
  af.r = pvec(M + MS_r_OG_x);
  // the loops stay rolled: one copy of mp_point and mp_add each, not seven
  MP<T> pay = mp_zero<T>();
#pragma unroll 1
  for (int k = 0; k < 5; ++k) {
    const T m01 = k == 0 ? pld[0] : pld[1];
    const T m = k < 2 ? m01 : (k == 2 ? pld[2] : (k == 3 ? pld[3] : pld[4]));
    pay = mp_add(pay, mp_point(clamp(m, T(0.0), T(100.0)),
                               pvec(M + MS_pilot_x + 3 * k)));
  }
  const T m_f = clamp_min(fuel_m_total(M, x_fuel), T(0.0));
  MP<T> fuel = mp_zero<T>();
#pragma unroll 1
  for (int k = 0; k < 2; ++k)
    fuel = mp_add(fuel, mp_point(T(0.5) * m_f, pvec(M + MS_tank0_x + 3 * k)));
  return mp_add(mp_add(af, pay), fuel);
}

// ------------------------------------------------------------- lanes

// s_sys and the terrain under a lane
struct SSys {
  bool stall, crashed;
  int state;
};

template <typename T>
struct Trn {
  T elevation;
  V3<T> normal;
  int surface;
};

// k5_lane after the RK4 combine, in its parts (k_fin_act, k_fin_ldg0..2,
// k_fin_rest), at the new kinematics: finish_sys runs them in warps of its
// own, finish_roles in the subsystem warps.

// gear leg `leg` (k_fin_ldg<leg>, with the steering of k_fin_act: only the
// nose leg steers): its strut, and its friction regulator's states frc_x,
// frc_y (after the combine) reset off the ground; returns whether the leg
// crashes, its strut tilted past ALPHA_TS_MAX on the ground or compressing
// faster than XI_DOT_MAX, and sets `wow`. The mechanical linkage steers
// from the inputs u; the fly-by-wire nose leg from its servo's position
// after the combine, `steer_fbw`
template <int ACT = ACT_MECH, typename T>
__device__ __forceinline__ bool finish_leg(const T* P, int leg,
                                           const T (&u)[SysL<ACT>::NU],
                                           T steer_fbw, const Kin<T>& kin,
                                           const Trn<T>& trn, T& frc_x,
                                           T& frc_y, bool& wow) {
  T steering;
  if constexpr (act_fbw(ACT))
    steering = leg == 2 ? steer_fbw : T(0.0);
  else
    steering = leg == 2 ? actuation(u).steering : T(0.0);
  const Strut<T> st = strut_y(P + P_LG + leg * LG_N, steering, kin,
                              trn.elevation, trn.normal);
  if (!st.wow) frc_x = frc_y = T(0.0);
  wow = st.wow;
  return (st.wow && st.alpha_ts > T(ALPHA_TS_MAX)) ||
         -st.xi_dot > T(XI_DOT_MAX);
}

// the stall hysteresis at the new airflow (k_fin_rest)
template <typename T>
__device__ __forceinline__ bool finish_stall(const T* P, const Air<T>& air,
                                             bool stall) {
  T alpha, beta;
  V3<T> v_safe;
  alpha_gated(air, alpha, beta, v_safe);
  return alpha > P[P_AE + AE_stall_hi] ||
         (stall && alpha >= P[P_AE + AE_stall_lo]);
}

// the engine state machine at the new fuel state and shaft speed
// (k_fin_rest)
template <int ACT = ACT_MECH, typename T>
__device__ __forceinline__ int finish_engine(const T* P, int state, T x_fuel,
                                             T x_omega,
                                             const T (&u)[SysL<ACT>::NU]) {
  const T* M = P + P_MS;
  const bool fuel_available = fuel_m_total(M, x_fuel) - M[MS_M_RES] > T(0);
  return engine_step(P, state, x_omega, u[SysL<ACT>::U_E_START].v != 0,
                     u[SysL<ACT>::U_E_STOP].v != 0, fuel_available);
}

// x_sys (N_XSYS rows), s_sys (N_SSYS rows) and the terrain (N_TRN rows)
template <typename T>
__device__ __forceinline__ SSys load_ssys(const Col<T>& c, int r) {
  return {c(r + SS_STALL).v != 0, c(r + SS_CRASHED).v != 0,
          int(c(r + SS_STATE).v)};
}
template <typename T>
__device__ __forceinline__ void store_ssys(const Out<T>& o, int r,
                                           const SSys& s) {
  o.s(r + SS_STALL, T(s.stall ? 1.0 : 0.0));
  o.s(r + SS_CRASHED, T(s.crashed ? 1.0 : 0.0));
  o.s(r + SS_STATE, T(double(s.state)));
}
template <typename T>
__device__ __forceinline__ Trn<T> load_trn(const Col<T>& c, int r) {
  return {c(r + TR_ELEV), c.v3(r + TR_NORMAL), int(c(r + TR_SURF).v)};
}

// ------------------------------------------------------------- roles
// The C172 with several threads per aircraft (systems, rk4_stage,
// rk4_finish, megakernel), in the role layout of flight_math.cuh with
// N_ROLES roles. The subsystems read only the kinematics, the air data,
// the inputs and their own states, and meet again in the wrench and mass
// sums, so they run side by side:
//
//   ROLE_KIN    kinematics, air data; the sums and the dynamics (in
//               systems: it shares the KinData and AirData it is given)
//   ROLE_AERO   aerodynamics: the alpha/beta filters, lift and the moments
//   ROLE_DRAG   aerodynamics: drag and side force (it owns no state)
//   ROLE_ENG    engine and fuel
//   ROLE_PROP   propeller and the mass sum (it owns no state)
//   ROLE_LEG0+j gear leg j (left, right, nose)
//
// The roles that work longest come first, so that with 32 lanes each has a
// warp scheduler of its SM to itself (warp w issues from scheduler w % 4)
// and shares it only with a short role. Measured on the card, the engine
// with the propeller behind it was the longest chain and aero the second,
// and aero the longest once those two were apart. The engine needs the
// propeller only for the load on its shaft, so the two are roles of their
// own and the load joins after the second barrier; aero's table lookups
// fall into two halves that meet only in the rotation of the force into
// body axes, which role KIN does with the sums.
//
// A role owns the rows of X it integrates (role_row) and holds them in
// slots 0.. of a T[N_SLOTS] array; what crosses roles goes through the
// block's scratch in shared memory, [SH_N, L] values laid out like the
// global buffers, and two barriers per derivative.

constexpr int N_ROLES = 8;
constexpr int ROLE_KIN = 0, ROLE_AERO = 1, ROLE_DRAG = 2, ROLE_ENG = 3,
              ROLE_PROP = 4, ROLE_LEG0 = 5;
constexpr int N_SLOTS = N_XKIN + N_XDYN;  // the most rows one role owns
// slots of ROLE_ENG
constexpr int PW_FUEL = 0, PW_EFRC = 1, PW_IDLE = 2, PW_OMEGA = 3;

// scratch rows: the KinData and AirData fields the systems read, then each
// role's wrench (aero's force in stability axes, with the cos/sin of alpha
// after the other rows), the rotor momentum, the mass properties, the legs'
// crash flags, and what the engine and the propeller tell each other: the
// stage's fuel and shaft speed, the propeller's shaft torque
constexpr int SH_Q_NB = 0, SH_Q_EB = 4, SH_Q_EN = 8, SH_N_E = 12, SH_H_E = 15,
              SH_H_O = 16, SH_OM_WB = 17, SH_OM_EB = 20, SH_V_EB = 23,
              SH_V_WB = 26, SH_TK = 29, SH_P = 30, SH_RHO = 31, SH_A = 32,
              SH_Q = 33, SH_TAS = 34, SH_AERO = 35, SH_LEG = SH_AERO + N_WR,
              SH_PWP = SH_LEG + N_LEGS * N_WR, SH_HR = SH_PWP + N_WR,
              SH_MP = SH_HR + N_HR, SH_CRASH = SH_MP + N_MP,
              SH_XFUEL = SH_CRASH + N_LEGS, SH_XOMEGA = SH_XFUEL + 1,
              SH_TAU_PX = SH_XOMEGA + 1, SH_CA = SH_TAU_PX + 1,
              SH_SA = SH_CA + 1, SH_N = SH_SA + 1;                   // 89
// the megakernel also keeps the step's start state and the k-sum there, each
// thread the rows of its role: they are touched once per stage, and in
// registers they would sit beside every role's body for the whole step
constexpr int SH_X = SH_N, SH_KSUM = SH_X + N_X,
              SH_MEGA_N = SH_KSUM + N_X;                             // 143
// the fly-by-wire instances also pass the servos' states at the stage point
// (after the combine, in the finish) from role DRAG, which integrates them,
// to the roles that read a servo's position
constexpr int SH_ACT = SH_N, SH_N_FBW = SH_ACT + N_ACT;              // 96

// scratch rows of an instance
template <int ACT>
__host__ __device__ __forceinline__ int sh_rows() {
  return act_fbw(ACT) ? SH_N_FBW : SH_N;
}

// the block's dynamic shared memory: the parameter buffer (n_params
// values), then the scratch
template <typename T>
__device__ __forceinline__ T* block_shared() {
  extern __shared__ __align__(16) unsigned char fj_shared[];
  return reinterpret_cast<T*>(fj_shared);
}

// the launch of B aircraft at `lanes` per block, for elements of elem_size
// bytes: the block's dynamic shared memory holds the parameter buffer
// (n_params values), then a scratch of sh_rows rows
inline RoleLaunch role_launch(int B, int lanes, int n_params, int elem_size,
                              int sh_rows) {
  return role_launch(B, lanes, N_ROLES,
                     (n_params + sh_rows * lanes) * elem_size);
}

// row of X in slot k of a role, -1 past its rows; in the fly-by-wire
// instances role DRAG integrates the servo states (two of a second-order
// servo)
template <int ACT = ACT_MECH>
__device__ __forceinline__ int role_row(int role, int k) {
  static_assert(SysL<ACT>::NACT <= N_SLOTS, "role DRAG's servo states");
  if (role == ROLE_KIN) return k;
  if (role == ROLE_AERO) return k < 2 ? X_SYS + XS_ALPHA + k : -1;
  if (role == ROLE_ENG)
    return k == PW_FUEL ? X_SYS + XS_FUEL
                        : (k <= PW_OMEGA ? X_SYS + XS_EFRC + k - 1 : -1);
  if (role >= ROLE_LEG0)
    return k < 2 ? X_SYS + XS_FRC + 2 * (role - ROLE_LEG0) + k : -1;
  if (act_fbw(ACT) && role == ROLE_DRAG)
    return k < SysL<ACT>::NACT ? X_SYS + XS_ACT + k : -1;
  return -1;  // ROLE_DRAG, ROLE_PROP
}

// a thread of the C172 role layout
__device__ __forceinline__ RoleThread role_thread(int B) {
  return role_thread(B, N_ROLES);
}

// copy the parameter buffer into shared memory, all threads of the block,
// 16 bytes a thread and turn (P is a tensor's first element and sP the
// start of the block's shared memory, both 16-byte aligned), then the tail;
// the next barrier publishes it
struct alignas(16) Bytes16 {
  unsigned int w[4];
};
template <typename T>
__device__ __forceinline__ void share_params(const T* __restrict__ P,
                                             int n_params, T* sP) {
  const int per = int(sizeof(Bytes16) / sizeof(T));
  const int n16 = n_params / per;
  const Bytes16* src = reinterpret_cast<const Bytes16*>(P);
  Bytes16* dst = reinterpret_cast<Bytes16*>(sP);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = src[i];
  for (int i = n16 * per + threadIdx.x; i < n_params; i += blockDim.x)
    sP[i] = P[i];
}

// a role's slots of rows r.. of column c, 0 in the slots it does not own
template <int ACT = ACT_MECH, typename T>
__device__ __forceinline__ void load_slots(const Col<T>& c, int r, int role,
                                           T (&x)[N_SLOTS]) {
#pragma unroll
  for (int k = 0; k < N_SLOTS; ++k) {
    const int row = role_row<ACT>(role, k);
    x[k] = T(0);
    if (row >= 0) x[k] = c(r + row);
  }
}

template <int ACT = ACT_MECH, typename T>
__device__ __forceinline__ void store_slots(const Out<T>& o, int r, int role,
                                            const T (&x)[N_SLOTS]) {
#pragma unroll
  for (int k = 0; k < N_SLOTS; ++k) {
    const int row = role_row<ACT>(role, k);
    if (row >= 0) o.s(r + row, x[k]);
  }
}

// the KinData and AirData fields the systems read, into the scratch. With
// ATMOSPHERE false the air's state (Tk, p, rho, a, q) is left out, NaN in
// its rows: the finish reads only the airflow, and unread, the pressure
// chain of isa_data (a library power per layer) is never worked out
template <bool ATMOSPHERE = true, typename T>
__device__ __forceinline__ void share_kin_air(const Out<T>& o,
                                              const Kin<T>& k,
                                              const Air<T>& a) {
  o.q4(SH_Q_NB, k.q_nb);
  o.q4(SH_Q_EB, k.q_eb);
  o.q4(SH_Q_EN, k.q_en);
  o.v3(SH_N_E, k.n_e);
  o.s(SH_H_E, k.h_e);
  o.s(SH_H_O, k.h_o);
  o.v3(SH_OM_WB, k.omega_wb_b);
  o.v3(SH_OM_EB, k.omega_eb_b);
  o.v3(SH_V_EB, k.v_eb_b);
  o.v3(SH_V_WB, a.v_wb_b);
  const T nan = T(double(NAN));
  o.s(SH_TK, ATMOSPHERE ? a.Tk : nan);
  o.s(SH_P, ATMOSPHERE ? a.p : nan);
  o.s(SH_RHO, ATMOSPHERE ? a.rho : nan);
  o.s(SH_A, ATMOSPHERE ? a.a : nan);
  o.s(SH_Q, ATMOSPHERE ? a.q : nan);
  o.s(SH_TAS, a.TAS);
}

// the shared fields; every other field NaN, so that a system which came to
// read one would show it
template <typename T>
__device__ __forceinline__ void shared_kin_air(const Col<T>& c, Kin<T>& k,
                                               Air<T>& a) {
  const T nan = T(double(NAN));
  const V3<T> nan3 = {nan, nan, nan};
  k.e_nb = k.r_eb_e = k.v_eb_n = nan3;
  k.lat = k.lon = k.v_gnd = k.chi = k.gamma = nan;
  k.q_nb = c.q4(SH_Q_NB);
  k.q_eb = c.q4(SH_Q_EB);
  k.q_en = c.q4(SH_Q_EN);
  k.n_e = c.v3(SH_N_E);
  k.h_e = c(SH_H_E);
  k.h_o = c(SH_H_O);
  k.omega_wb_b = c.v3(SH_OM_WB);
  k.omega_eb_b = c.v3(SH_OM_EB);
  k.v_eb_b = c.v3(SH_V_EB);
  a.v_ew_n = a.v_ew_b = nan3;
  a.mu = a.M = a.Tt = a.pt = a.Dp = a.EAS = a.CAS = nan;
  a.v_wb_b = c.v3(SH_V_WB);
  a.Tk = c(SH_TK);
  a.p = c(SH_P);
  a.rho = c(SH_RHO);
  a.a = c(SH_A);
  a.q = c(SH_Q);
  a.TAS = c(SH_TAS);
}

// What a subsystem role reads of its lane's column besides the kinematics,
// the air data and its own states: u_sys, s_sys and the terrain. The roles
// of the finish load it before the first barrier, so that its loads overlap
// role KIN's work (a load after a barrier cannot start before it); those of
// a derivative after it, where loading it before held more registers across
// the barrier and made rk4_stage 2% slower (PERF.md).
template <typename T, int ACT = ACT_MECH>
struct SysIn {
  T u[SysL<ACT>::NU];
  SSys s;
  Trn<T> trn;
};

template <int ACT = ACT_MECH, typename T>
__device__ __forceinline__ SysIn<T, ACT> load_sys_in(const Col<T>& c,
                                                     int r_u, int r_s,
                                                     int r_trn) {
  SysIn<T, ACT> in;
#pragma unroll
  for (int k = 0; k < SysL<ACT>::NU; ++k) in.u[k] = c(r_u + k);
  in.s = load_ssys(c, r_s);
  in.trn = load_trn(c, r_trn);
  return in;
}

// the assignments a subsystem role reads: the mechanical linkage's from the
// inputs, the fly-by-wire servos' from the states role DRAG shared
template <int ACT, typename T>
__device__ __forceinline__ Act<T> role_actuation(const T* P, const Col<T>& si,
                                                 const SysIn<T, ACT>& in) {
  if constexpr (act_fbw(ACT)) {
    T x[N_ACT];
#pragma unroll
    for (int k = 0; k < N_ACT; ++k) x[k] = si(SH_ACT + k);
    return fbw_actuation(P, x, in.u[UF_MIX]);
  } else {
    return actuation(in.u);
  }
}

// the wrench role KIN sums from the subsystems' shares as the one-thread
// systems summed it, (aero + propeller) + ((leg 0 + leg 1) + leg 2), with
// aero's force turned into body axes
template <typename T>
__device__ __forceinline__ void role_wrench(const Col<T>& si, V3<T>& F_b,
                                            V3<T>& tau_b) {
  const V3<T> F_ldg = add(add(si.v3(SH_LEG), si.v3(SH_LEG + N_WR)),
                          si.v3(SH_LEG + 2 * N_WR));
  const V3<T> tau_ldg = add(add(si.v3(SH_LEG + 3), si.v3(SH_LEG + N_WR + 3)),
                            si.v3(SH_LEG + 2 * N_WR + 3));
  const V3<T> F_aero = aero_force(si(SH_CA), si(SH_SA), si.v3(SH_AERO));
  F_b = add(add(F_aero, si.v3(SH_PWP)), F_ldg);
  tau_b = add(add(si.v3(SH_AERO + 3), si.v3(SH_PWP + 3)), tau_ldg);
}

// the mass properties role PROP shares
template <typename T>
__device__ __forceinline__ MP<T> role_mp(const Col<T>& si) {
  MP<T> mp;
  mp.m = si(SH_MP);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) mp.J.m[i][j] = si(SH_MP + 1 + 3 * i + j);
  mp.r = si.v3(SH_MP + 10);
  return mp;
}

// The subsystem roles of one derivative, every role but KIN, as systems,
// rk4_stage and the megakernel run them, in three parts around the two
// barriers of a derivative; role KIN does its own part beside each:
//   subsystem_roles_share, before the first barrier: role ENG shares the
//     stage's fuel and shaft speed (role KIN shares KinData and AirData);
//   subsystem_roles, between the barriers: each role loads its SysIn from
//     rows r_u, r_s and r_trn of its lane's column c and works out its slots
//     of the derivative d, zeroed on a terminated lane (alive 0), from the
//     shared KinData and AirData, and shares its wrench; role PROP the rotor
//     momentum and the mass properties too; role ENG keeps its shaft torque
//     in tau_shaft;
//   subsystem_roles_shaft, after the second barrier: role ENG puts the
//     propeller's load on its shaft (role KIN sums the wrench, role_wrench).
// P is the parameter buffer, sh the scratch, xi the role's slots of the
// stage state.
template <int ACT = ACT_MECH, typename T>
__device__ __forceinline__ void subsystem_roles_share(T* sh,
                                                      const RoleThread& t,
                                                      const T (&xi)[N_SLOTS]) {
  if (t.role == ROLE_ENG) {
    const Out<T> so{sh, t.L, t.lane};
    so.s(SH_XFUEL, xi[PW_FUEL]);
    so.s(SH_XOMEGA, xi[PW_OMEGA]);
  }
  if (act_fbw(ACT) && t.role == ROLE_DRAG) {
    const Out<T> so{sh, t.L, t.lane};
#pragma unroll  // the positions
    for (int k = 0; k < N_ACT; ++k) so.s(SH_ACT + k, xi[act_slot(ACT, k)]);
  }
}

template <int ACT = ACT_MECH, typename T>
__device__ __forceinline__ void subsystem_roles(const T* P, T* sh,
                                                const RoleThread& t,
                                                const T (&xi)[N_SLOTS],
                                                const Col<T>& c, int r_u,
                                                int r_s, int r_trn, T alive,
                                                T& tau_shaft,
                                                T (&d)[N_SLOTS]) {
  const Col<T> si{sh, t.L, t.lane};
  const Out<T> so{sh, t.L, t.lane};
  const int role = t.role;
  const SysIn<T, ACT> in = load_sys_in<ACT>(c, r_u, r_s, r_trn);
  Kin<T> kin;
  Air<T> air;
  shared_kin_air(si, kin, air);
  const Act<T> act = role_actuation<ACT>(P, si, in);
  if (role == ROLE_AERO) {
    AeroOut<T> a;
    aero_parts<AERO_LIFT_MOMENTS>(P, xi[0], xi[1], act, in.s.stall, kin, air,
                                  in.trn.elevation, a);
    d[0] = alive * a.alpha_filt_dot;
    d[1] = alive * a.beta_filt_dot;
    so.s(SH_AERO + 2, a.f_s.z);
    so.v3(SH_AERO + 3, a.tau);
    so.s(SH_CA, a.ca);
    so.s(SH_SA, a.sa);
  } else if (role == ROLE_DRAG) {
    AeroOut<T> a;
    aero_parts<AERO_DRAG_SIDE>(P, T(0.0), T(0.0), act, false, kin, air,
                               in.trn.elevation, a);
    so.s(SH_AERO, a.f_s.x);
    so.s(SH_AERO + 1, a.f_s.y);
    if constexpr (act_fbw(ACT)) {  // the servos, second-order ones too
#pragma unroll
      for (int k = 0; k < N_ACT; ++k) {
        const int j = act_slot(ACT, k);
        const T cmd = in.u[fbw_cmd_row(k)];
        if (act_a2(ACT, k)) {
          T p_dot, v_dot;
          servo2_dot(P, k, n_a2(ACT, k), xi[j], xi[j + 1], cmd, p_dot,
                     v_dot);
          d[j] = alive * p_dot;
          d[j + 1] = alive * v_dot;
        } else {
          d[j] = alive * servo_dot(P, k, xi[j], cmd);
        }
      }
    }
  } else if (role == ROLE_ENG) {
    T mdot;
    engine(P, xi[PW_OMEGA], xi[PW_IDLE], xi[PW_EFRC], act.throttle,
           act.mixture, in.u[SysL<ACT>::U_E_MIXCTL], in.s.state, air,
           tau_shaft, d[PW_IDLE], d[PW_EFRC], mdot);
    d[PW_FUEL] = alive * (-mdot / P[P_MS + MS_M_USABLE]);
    d[PW_IDLE] = alive * d[PW_IDLE];
    d[PW_EFRC] = alive * d[PW_EFRC];
  } else if (role == ROLE_PROP) {
    const T gr = P[P_EN + EN_gear_ratio];
    const PropOut<T> prop = propeller(P, kin, air, gr * si(SH_XOMEGA));
    T pld[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) pld[k] = in.u[SysL<ACT>::U_PLD + k];
    const MP<T> mp = mass_sum(P, pld, si(SH_XFUEL));
    so.v3(SH_PWP, prop.F_b);
    so.v3(SH_PWP + 3, prop.tau_b);
    so.v3(SH_HR, prop.hr_b);
    so.s(SH_TAU_PX, prop.tau_px);
    so.s(SH_MP, mp.m);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) so.s(SH_MP + 1 + 3 * i + j, mp.J.m[i][j]);
    so.v3(SH_MP + 10, mp.r);
  } else {
    // steering on the nose leg, brakes on the mains
    const int leg = role - ROLE_LEG0;
    const T zero = T(0.0);
    const T steering = leg == 2 ? act.steering : zero;
    const T braking =
        leg == 0 ? act.brake_left : (leg == 1 ? act.brake_right : zero);
    V3<T> F, tau;
    gear_leg(P, leg, xi[0], xi[1], steering, braking, kin, in.trn.elevation,
             in.trn.normal, in.trn.surface, d[0], d[1], F, tau);
    d[0] = alive * d[0];
    d[1] = alive * d[1];
    so.v3(SH_LEG + N_WR * leg, F);
    so.v3(SH_LEG + N_WR * leg + 3, tau);
  }
}

template <typename T>
__device__ __forceinline__ void subsystem_roles_shaft(const T* P, T* sh,
                                                      const RoleThread& t,
                                                      T alive, T tau_shaft,
                                                      T (&d)[N_SLOTS]) {
  if (t.role == ROLE_ENG)
    d[PW_OMEGA] = alive * engine_omega_dot(
        P, tau_shaft,
        P[P_EN + EN_gear_ratio] * Col<T>{sh, t.L, t.lane}(SH_TAU_PX));
}

// what role KIN of the turbulent instances integrates besides its slots:
// the five filter states (in the stage the stage state x and the
// derivative d; in the finish the start state x, the k-sum k and the new
// state d) and the time of the air data (the stage time, the new time)
template <typename T>
struct TurbLane {
  T x[N_XTURB], k[N_XTURB], d[N_XTURB];
  T t;
};

// stage_lane of flightjax/parallel/clusterstep.py:81-85 by roles: the
// derivative at the stage state xi, every role its own slots of d, zeroed on
// a terminated lane. P is the parameter buffer (in shared memory), sh the
// scratch, c the lane's column of the buffer that holds CTX at row r_ctx.
// Role KIN works out and shares KinData and AirData, the subsystem roles run
// beside it, and after the second barrier role KIN sums the wrench and runs
// the dynamics. All threads of the block must call it. In the turbulent
// instances role KIN also applies the gust of the filters' stage state
// tl->x at the stage time tl->t to the air data it shares (turbulence.cuh::
// turb_air), and between the barriers, where it waits for the subsystem
// roles, works out the filters' derivative tl->d from the held drive and
// its scale in the parameters.
template <int ACT = ACT_MECH, typename T>
__device__ __forceinline__ void f_ode_roles(const T* P, T* sh,
                                            const RoleThread& t,
                                            const T (&xi)[N_SLOTS],
                                            const Col<T>& c, int r_ctx,
                                            T (&d)[N_SLOTS],
                                            TurbLane<T>* tl = nullptr) {
  using L = SysL<ACT>;
  const Col<T> si{sh, t.L, t.lane};
  const T alive = T(1.0) - c(r_ctx + L::CX_TERM);
  // role KIN keeps these from the kinematics to the dynamics
  XDyn<T> xi_dyn;
  Q4<T> q_eb;
  V3<T> r_eb_e;
  T tau_shaft;  // role ENG keeps it until the propeller's load is known
  T T_u, T_w;   // role KIN of the turbulent instances: the filters' times
  subsystem_roles_share<ACT>(sh, t, xi);
  if (t.role == ROLE_KIN) {
    const XKin<T> xi_kin = {{xi[0], xi[1], xi[2], xi[3]},
                            {xi[4], xi[5], xi[6], xi[7]}, xi[8]};
    xi_dyn = {{xi[9], xi[10], xi[11]}, {xi[12], xi[13], xi[14]}};
    XKin<T> kd;
    Kin<T> kin;
    Air<T> air;
    if constexpr (act_turb(ACT)) {
      XKin<T> kd_raw;
      wa_f_ode(xi_kin.q_wb, xi_kin.q_ew, xi_kin.h_e, xi_dyn.omega_eb_b,
               xi_dyn.v_eb_b, c(r_ctx + L::CX_GEOID), kd_raw, kin);
      air = turb_air(kin, load_atm(c, r_ctx + L::CX_UATM),
                     c(r_ctx + L::CX_TRN + TR_ELEV), tl->x,
                     load_turb_u(c, r_ctx + L::CX_UTURB), tl->t, T_u, T_w);
      kd = scale(alive, kd_raw);
    } else {
      kinair_lane(xi_kin, xi_dyn, c(r_ctx + L::CX_GEOID),
                  load_atm(c, r_ctx + L::CX_UATM), alive, kd, kin, air);
    }
    share_kin_air(Out<T>{sh, t.L, t.lane}, kin, air);
    q_eb = kin.q_eb;
    r_eb_e = kin.r_eb_e;
    d[0] = kd.q_wb.w, d[1] = kd.q_wb.x, d[2] = kd.q_wb.y, d[3] = kd.q_wb.z;
    d[4] = kd.q_ew.w, d[5] = kd.q_ew.x, d[6] = kd.q_ew.y, d[7] = kd.q_ew.z;
    d[8] = kd.h_e;
  }
  __syncthreads();
  if (t.role != ROLE_KIN) {
    subsystem_roles<ACT>(P, sh, t, xi, c, r_ctx + CX_USYS,
                         r_ctx + L::CX_SSYS, r_ctx + L::CX_TRN, alive,
                         tau_shaft, d);
  } else if constexpr (act_turb(ACT)) {
    T eta[N_ETA];
#pragma unroll
    for (int j = 0; j < N_ETA; ++j) eta[j] = c(r_ctx + L::CX_ETA + j);
    dryden_dot(tl->x, eta, P[L::P_TURB], T_u, T_w, alive, tl->d);
  }
  __syncthreads();
  if (t.role == ROLE_KIN) {
    V3<T> F_b, tau_b;
    role_wrench(si, F_b, tau_b);
    const XDyn<T> dd = dynamics_lane(xi_dyn, role_mp(si), F_b, tau_b,
                                     si.v3(SH_HR), q_eb, r_eb_e, alive);
    d[9] = dd.omega_eb_b.x, d[10] = dd.omega_eb_b.y, d[11] = dd.omega_eb_b.z;
    d[12] = dd.v_eb_b.x, d[13] = dd.v_eb_b.y, d[14] = dd.v_eb_b.z;
  } else {
    subsystem_roles_shaft(P, sh, t, alive, tau_shaft, d);
  }
}

// what finish_roles leaves with each role: role KIN the residuals, the
// crash and terminated latches and the undulation, role AERO the stall
// flag, role ENG the engine state; in the fly-by-wire instances also what
// the avionics read: role KIN the KIN_Y fields, role AERO the airflow
// angles, each leg its weight on wheels
template <typename T>
struct FinishOut {
  Q4<T> r_q;
  T r_h, geoid_N, term;
  SSys s;
  V3<T> om_wb, e_nb, v_eb_n;
  T chi, EAS, alpha, beta;
  bool wow;
};

// finish_lane of clusterstep.py:97-103 by roles, with the compensated add
// of flightjax/core/sim.py:315-320 when `comp` (finish_kin_lane and
// finish_sys_lane, split as f_ode_roles splits the stage): role KIN
// combines and renormalises the kinematics and shares the new KinData and
// AirData (without the atmosphere, which no role of the finish reads), the
// other roles combine their own slots and load their inputs; barrier; the
// legs run their struts (regulator reset off the ground, crash flag), role
// AERO the stall hysteresis, role ENG the engine state machine, and role KIN
// meanwhile, with REFRESH_GEOID, the undulation under the new position from
// the grid G (without, the undulation of CTX passes through and G is not
// read); barrier; role KIN latches crashed and terminated. x and ksum are
// the role's slots, c the lane's column of the buffer holding CTX at r_ctx
// and the residuals at r_c. In the fly-by-wire instances role DRAG combines
// the servo states and shares them before the first barrier, for the nose
// leg's steering. In the turbulent instances role KIN also combines the
// filter states (tl->x + c6 tl->k into tl->d) and applies their gust at the
// new time tl->t to the air data it shares (Vehicle._context). All threads
// of the block must call it.
template <bool REFRESH_GEOID, int ACT = ACT_MECH, typename T>
__device__ __forceinline__ void finish_roles(const T* P, const T* G, T* sh,
                                             const RoleThread& t,
                                             const T (&x)[N_SLOTS],
                                             const T (&ksum)[N_SLOTS], T c6,
                                             bool comp, const Col<T>& c,
                                             int r_ctx, int r_c,
                                             T (&xn)[N_SLOTS],
                                             FinishOut<T>& o,
                                             TurbLane<T>* tl = nullptr) {
  using L = SysL<ACT>;
  const Col<T> si{sh, t.L, t.lane};
  const Out<T> so{sh, t.L, t.lane};
  const int role = t.role;
  V3<T> n_e;  // role KIN keeps the new position for the undulation
  bool crashed, term;  // and the latches it had
  SysIn<T, ACT> in;    // the other roles' inputs
  if (role == ROLE_KIN) {
    crashed = c(r_ctx + L::CX_SSYS + SS_CRASHED).v != 0;
    term = c(r_ctx + L::CX_TERM).v != 0;
    const XKin<T> xk = {{x[0], x[1], x[2], x[3]}, {x[4], x[5], x[6], x[7]},
                        x[8]};
    const XDyn<T> xd = {{x[9], x[10], x[11]}, {x[12], x[13], x[14]}};
    const XKin<T> kk = {{ksum[0], ksum[1], ksum[2], ksum[3]},
                        {ksum[4], ksum[5], ksum[6], ksum[7]}, ksum[8]};
    const XDyn<T> kd = {{ksum[9], ksum[10], ksum[11]},
                        {ksum[12], ksum[13], ksum[14]}};
    o.r_q = c.q4(r_c);
    o.r_h = c(r_c + 4);
    XKin<T> yk;
    XDyn<T> yd;
    Kin<T> kin;
    Air<T> air;
    if constexpr (act_turb(ACT)) {
      finish_kin_combine(xk, xd, kk, kd, c6, comp, o.r_q, o.r_h, yk, yd);
      XKin<T> unused;
      wa_f_ode(yk.q_wb, yk.q_ew, yk.h_e, yd.omega_eb_b, yd.v_eb_b,
               c(r_ctx + L::CX_GEOID), unused, kin);
#pragma unroll
      for (int j = 0; j < N_XTURB; ++j) tl->d[j] = tl->x[j] + c6 * tl->k[j];
      T T_u, T_w;
      air = turb_air(kin, load_atm(c, r_ctx + L::CX_UATM),
                     c(r_ctx + L::CX_TRN + TR_ELEV), tl->d,
                     load_turb_u(c, r_ctx + L::CX_UTURB), tl->t, T_u, T_w);
    } else {
      finish_kin_lane(xk, xd, kk, kd, c6, comp, o.r_q, o.r_h,
                      c(r_ctx + L::CX_GEOID),
                      load_atm(c, r_ctx + L::CX_UATM), yk, yd, kin, air);
    }
    share_kin_air<false>(so, kin, air);
    if constexpr (act_fbw(ACT)) {
      o.om_wb = kin.omega_wb_b;
      o.e_nb = kin.e_nb;
      o.v_eb_n = kin.v_eb_n;
      o.chi = kin.chi;
      o.EAS = air.EAS;
    }
    xn[0] = yk.q_wb.w, xn[1] = yk.q_wb.x, xn[2] = yk.q_wb.y, xn[3] = yk.q_wb.z;
    xn[4] = yk.q_ew.w, xn[5] = yk.q_ew.x, xn[6] = yk.q_ew.y, xn[7] = yk.q_ew.z;
    xn[8] = yk.h_e;
    xn[9] = yd.omega_eb_b.x, xn[10] = yd.omega_eb_b.y;
    xn[11] = yd.omega_eb_b.z;
    xn[12] = yd.v_eb_b.x, xn[13] = yd.v_eb_b.y, xn[14] = yd.v_eb_b.z;
    n_e = kin.n_e;
  } else {
    // the role's own rows: the engine's four at most, DRAG's servos
#pragma unroll
    for (int k = 0; k < (act_fbw(ACT) ? L::NACT : PW_OMEGA + 1); ++k)
      xn[k] = x[k] + c6 * ksum[k];
    in = load_sys_in<ACT>(c, r_ctx + CX_USYS, r_ctx + L::CX_SSYS,
                          r_ctx + L::CX_TRN);
    if (act_fbw(ACT) && role == ROLE_DRAG) {
#pragma unroll  // the positions
      for (int k = 0; k < N_ACT; ++k) so.s(SH_ACT + k, xn[act_slot(ACT, k)]);
    }
  }
  __syncthreads();
  if (role == ROLE_KIN) {
    o.geoid_N =
        REFRESH_GEOID ? geoid_height(G, n_e) : c(r_ctx + L::CX_GEOID);
  } else {
    Kin<T> kin;
    Air<T> air;
    shared_kin_air(si, kin, air);
    if (role == ROLE_AERO) {
      o.s.stall = finish_stall(P, air, in.s.stall);
      if constexpr (act_fbw(ACT)) {
        V3<T> v_safe;
        alpha_gated(air, o.alpha, o.beta, v_safe);
      }
    } else if (role == ROLE_ENG) {
      o.s.state = finish_engine<ACT>(P, in.s.state, xn[PW_FUEL],
                                     xn[PW_OMEGA], in.u);
    } else if (role >= ROLE_LEG0) {
      const int leg = role - ROLE_LEG0;
      T steer_fbw = T(0.0);
      if constexpr (act_fbw(ACT))
        steer_fbw = servo_pos(P, CH_RUD, si(SH_ACT + CH_RUD));
      const bool crash = finish_leg<ACT>(P, leg, in.u, steer_fbw, kin,
                                         in.trn, xn[0], xn[1], o.wow);
      so.s(SH_CRASH + leg, T(crash ? 1.0 : 0.0));
    }
  }
  __syncthreads();
  if (role == ROLE_KIN) {
    o.s.crashed = crashed || si(SH_CRASH).v != 0 || si(SH_CRASH + 1).v != 0 ||
                  si(SH_CRASH + 2).v != 0;
    o.term = T(term || o.s.crashed ? 1.0 : 0.0);
  }
}

}  // namespace fj
