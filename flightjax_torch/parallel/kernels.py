"""The kernels of the fleet step, each a CUDA kernel with its plain PyTorch
version beside it.

The five clusters of the `subsystems` split:

- `kinair`     <- `k_kinair`,     lane fn `k1_lane` (`clusterstep.py:250-262`)
- `systems`    <- `k_systems`,    lane fn `k2_lane` (`clusterstep.py:274-287`),
                  the fine parts `k_actaero`, `k_ldg0..2`, `k_pwp`
- `dynamics`   <- `k_dynamics`,   lane fn `k3_lane` (`clusterstep.py:403-414`)
- `finish_kin` <- `k_finish_kin`, lane fn `k4_lane` (`clusterstep.py:433-448`)
- `finish_sys` <- `k_finish_sys`, lane fn `k5_lane` (`clusterstep.py:452-465`),
                  the fine parts `k_fin_act`, `k_fin_ldg0..2`, `k_fin_rest`

The whole vehicle (the `vehicle` split and the megakernel):

- `rk4_stage`  <- `rk4_stage`,  lane fn `stage_lane` (`clusterstep.py:81-93`)
- `rk4_finish` <- `rk4_finish`, lane fn `finish_lane` (`clusterstep.py:97-108`)
- `geoid`      <- the EGM96 refresh (`geodesy.geoid_height`), which the TPU
                  paths run outside their kernels
- `megakernel` <- `megakernel.py::make_megakernel_step` (its wrapper is
                  `launch_megakernel`; the step is `parallel/megakernel.py`),
                  `megakernel_fbw`, its instance on the C172Xv1 with the
                  control laws' periodic pass inside it, and
                  `megakernel_gdc`, its instance on the C172Xv2 with the
                  guidance and control laws' pass inside it

The C172Xv1 whose elevator is a second-order servo (`Actuator2`; layout
FBW_A2) has instances of its own of the whole-vehicle kernels and the
megakernel, `rk4_stage_fbw_a2`, `rk4_finish_fbw_a2` and
`megakernel_fbw_a2`; another set of second-order channels flies the plain
path only, and the card refuses it, and the subsystems split over any,
by name (`a2_refusal`).

The C172X's periodic pass:

- `ctl_laws`   <- `ControlLaws.f_periodic` and `assign`, which the TPU
                  megakernel runs inside the step on the C172Xv1
                  (`core/sim.py:327-333`) and the TPU cluster paths as XLA
                  glue (`clusterstep.py:591-607`)
- `gdc_ctl_laws` <- the C172Xv2's `c172x_gdc.Avionics.f_periodic` (the
                  guidance laws, then the control laws on the requests they
                  override) and `assign`, the same places on the C172Xv2
- `msn_ctl_laws` <- a scripted mission's `MissionAvionics.f_periodic` and
                  `assign` over the C172Xv2's avionics (the phase machine,
                  then the guidance and the control laws on the inputs the
                  phase overrides, then the phase's systems overrides), the
                  same places over a mission world; `megakernel_msn` is the
                  megakernel's instance there
- `nav_pass`   <- the navigation avionics' pass before the inner laws
                  (`NavAvionics.nav_pass`: sensors, faults, filter,
                  monitors, estimated VehicleY), which the TPU megakernel
                  runs inside the step over `build_xv1_nav` and the TPU
                  cluster paths as XLA glue; `megakernel_nav` and
                  `megakernel_nav_turb` are the megakernel's instances there
- `msn_nav_ctl_laws` <- a sensor-fed mission's `MissionAvionics.f_periodic`
                  and `assign` on the navigation avionics' estimates, which
                  also read the estimated orthometric height (the radar
                  altimeter's flare gate); `megakernel_msn_nav` is the
                  megakernel's instance there

Each wrapper runs its plain version for CPU tensors and launches its kernel
for CUDA tensors (or raises); there is no fallback between the two.
`LAUNCHES[name]` counts kernel launches, nothing else: every launch goes
through `launch_kernel` or `launch_megakernel`.

The kernels read and write batch-minor `[n_fields, B]` buffers; the column
maps below are the Python half of the layouts declared in
`csrc/flight_math.cuh` and `csrc/c172_systems.cuh` (the library reports its
row counts, and `launch` checks them). A map entry is (name or key path,
per-lane shape, an int for a vector). The kernels of the C172 systems also
read its parameters and tables from one buffer, `system_params`, and the
geoid kernels the EGM96 grid from `geoid_grid`.
"""

import math
import weakref
from typing import NamedTuple

import torch

from flightjax_torch.core.mission import MissionAvionics
from flightjax_torch.core.modeling import bscale, tree_map
from flightjax_torch.core.sim import comp_add
from flightjax_torch.models.c172.c172x_ctl import ControlLaws
from flightjax_torch.models.c172.c172x_gdc import Avionics, Circle, Segment
from flightjax_torch.models.c172.common import (AERO_CONST, M_FULL, M_RES,
                                                AeroY, EngineY, LdgY,
                                                StrutWow, SystemsY, ThrusterY,
                                                _alpha_gated, systems_y)
from flightjax_torch.ops.geodesy import nvector_from_qew
from flightjax_torch.ops.random import normal_table
from flightjax_torch.ops.interp import Lookup
from flightjax_torch.parallel import launch as L
from flightjax_torch.physics import control as CTL
from flightjax_torch.physics.aircraftbase import VehicleY
from flightjax_torch.physics.atmosphere import AirData, SimpleAtmosphere, air_data
from flightjax_torch.physics.dynamics import DynamicsU, MassProps, VehicleDynamics, Wrench
from flightjax_torch.physics.kinematics import WA, KinData

LAUNCHES = {name: 0 for name in L.KERNELS}

_WA = WA()
_ATM = SimpleAtmosphere()
_DYN = VehicleDynamics()

# ------------------------------------------------------------ column maps

X_KIN = (("q_wb", 4), ("q_ew", 4), ("h_e", 1))
X_DYN = (("omega_eb_b", 3), ("v_eb_b", 3))
U_ATM = (("T_sl", 1), ("p_sl", 1), ("wind", 3))
KIN_DATA = (("e_nb", 3), ("q_nb", 4), ("q_eb", 4), ("q_en", 4), ("lat", 1),
            ("lon", 1), ("n_e", 3), ("h_e", 1), ("h_o", 1), ("r_eb_e", 3),
            ("omega_wb_b", 3), ("omega_eb_b", 3), ("v_eb_b", 3),
            ("v_eb_n", 3), ("v_gnd", 1), ("chi_gnd", 1), ("gamma_gnd", 1))
AIR_DATA = (("v_ew_n", 3), ("v_ew_b", 3), ("v_wb_b", 3), ("T", 1), ("p", 1),
            ("rho", 1), ("a", 1), ("mu", 1), ("M", 1), ("Tt", 1), ("pt", 1),
            ("Dp", 1), ("q", 1), ("TAS", 1), ("EAS", 1), ("CAS", 1))
COMP = (("q_ew", 4), ("h_e", 1))

X_SYS = ((("aero", "alpha_filt"), 1), (("aero", "beta_filt"), 1),
         ("fuel", 1), (("ldg", "frc"), (3, 2)),
         (("pwp", "engine", "frc"), 1), (("pwp", "engine", "idle"), 1),
         (("pwp", "engine", "omega"), 1))
ACT_KEYS = ("aileron", "aileron_offset", "brake_left", "brake_right",
            "elevator", "elevator_offset", "flaps", "mixture", "rudder",
            "rudder_offset", "throttle")
PAYLOAD_KEYS = ("pilot", "copilot", "lpass", "rpass", "baggage")
U_SYS = (tuple((("act", k), 1) for k in ACT_KEYS)
         + tuple((("pwp", "engine", k), 1) for k in (
             "mixture", "mixture_ctl", "start", "stop", "throttle"))
         + tuple((("pld", k), 1) for k in PAYLOAD_KEYS))
S_SYS = ((("aero", "stall"), 1), ("crashed", 1),
         (("pwp", "engine", "state"), 1))
# the fly-by-wire C172 (`FlyByWireActuation`): the mechanical x_sys rows and
# the seven servo positions, in the channel order of the kernels (sorted
# names); u_sys holds the seven commands and the mixture in place of the
# mechanical linkage's inputs
FBW_CHANNELS = ("aileron", "brake_left", "brake_right", "elevator", "flaps",
                "rudder", "throttle")
FBW_CMD_KEYS = ("aileron", "brake_left", "brake_right", "elevator", "flaps",
                "mixture", "rudder", "throttle")


def x_sys_fbw(a2=()):
    """x_sys of the fly-by-wire C172: the mechanical rows, then each
    servo's state in channel order, its position, or on a second-order
    channel (of `a2`) its position p and rate v, in the order JAX flattens
    {"p", "v"}."""
    return X_SYS + tuple(r for ch in FBW_CHANNELS for r in (
        ((("act", ch, "p"), 1), (("act", ch, "v"), 1)) if ch in a2
        else ((("act", ch), 1),)))


X_SYS_FBW = x_sys_fbw()
U_SYS_FBW = (tuple((("act", k), 1) for k in FBW_CMD_KEYS) + U_SYS[
    len(ACT_KEYS):])
# what the finish kernels of the fly-by-wire C172 store for its avionics:
# the gated airflow angles and each leg's weight on wheels at the new state
# (finish_sys, rk4_finish), and the KinData and AirData fields the control
# laws read (rk4_finish; on the cluster path finish_kin stores them all)
SYS_Y = (("alpha", 1), ("beta", 1), ("wow", 3))
KIN_Y = (("omega_wb_b", 3), ("e_nb", 3), ("v_eb_n", 3), ("chi_gnd", 1),
         ("EAS", 1))
# the C172X control laws (`models/c172/c172x_ctl.py`; rows of
# csrc/c172x_ctl.cuh): the avionics' inputs u and discrete state s, lon and
# lat, with the primitives' states as NamedTuples of `physics/control.py`;
# CTL_Y the VehicleY fields the laws read, the commands and servo positions
# of the four channels they command (by name)
CTL_CMD = ("aileron", "elevator", "rudder", "throttle")
AV_U_LON = tuple((k, 1) for k in (
    "mode_req", "throttle_axis", "throttle_offset", "elevator_axis",
    "elevator_offset", "q_ref", "theta_ref", "EAS_ref", "clm_ref", "h_ref"))
AV_U_LAT = tuple((k, 1) for k in (
    "mode_req", "aileron_axis", "aileron_offset", "rudder_axis",
    "rudder_offset", "p_ref", "beta_ref", "phi_ref", "chi_ref"))
_AV_STATES = {"lqr": (CTL.LQRState, (2, 2)),
              "int": (CTL.IntegratorState, (1, 1)),
              "pid": (CTL.PIDState, (1, 1, 1))}
# the primitive of each controller state, by its key
AV_PRIMITIVES = {"te2te": "lqr", "tv2te": "lqr", "vh2te": "lqr",
                 "q2e_int": "int", "q2e_pid": "pid", "c2theta_pid": "pid",
                 "v2t_pid": "pid", "ar2ar": "lqr", "pb2ar": "lqr",
                 "p2phi_int": "int", "p2phi_pid": "pid",
                 "chi2phi_pid": "pid"}


def _av_rows(*keys):
    out = []
    for k in keys:
        if k in AV_PRIMITIVES:
            cls, widths = _AV_STATES[AV_PRIMITIVES[k]]
            out += [((k, f), w) for f, w in zip(cls._fields, widths)]
        else:
            out.append((k, 1))
    return tuple(out)


AV_S_LON = _av_rows("mode_prev", "h_state", "te2te", "tv2te", "vh2te",
                    "q2e_int", "q2e_pid", "c2theta_pid", "v2t_pid",
                    "prev_throttle_cmd", "prev_te_zref_ele") + (
    (("out", "throttle_cmd"), 1), (("out", "elevator_cmd"), 1))
AV_S_LAT = _av_rows("mode_prev", "ar2ar", "pb2ar", "p2phi_int", "p2phi_pid",
                    "chi2phi_pid", "prev_pb_zref_phi") + (
    (("out", "aileron_cmd"), 1), (("out", "rudder_cmd"), 1))
AV_GROUPS = (AV_U_LON, AV_U_LAT, AV_S_LON, AV_S_LAT)
CTL_Y = ((("omega_wb_b", 3), ("omega_eb_b", 3), ("e_nb", 3), ("v_eb_n", 3),
          ("chi_gnd", 1), ("EAS", 1), ("h_e", 1), ("alpha", 1), ("beta", 1),
          ("alpha_filt", 1), ("beta_filt", 1), ("n", 1))
         + tuple((("cmd", ch), 1) for ch in CTL_CMD)
         + tuple((("pos", ch), 1) for ch in CTL_CMD) + (("wow", 3),))
CTL_IN = (CTL_Y,) + AV_GROUPS
CTL_OUT = (AV_S_LON, AV_S_LAT, tuple((ch, 1) for ch in CTL_CMD))
# the C172Xv2's guidance (`models/c172/c172x_gdc.py`; rows of
# csrc/c172x_gdc.cuh): its inputs, which follow the avionics block; GDC_Y
# what the guidance and the control laws read (CTL_Y and the n-vector of
# the new position); GDC_YOUT the GdcY fields gdc_ctl_laws writes after
# ctl_laws' rows
AV_U_GDC = (("mode_req", 1), (("target", "n_e1"), 3),
            (("target", "h_e1"), 1), (("target", "n_e2"), 3),
            (("target", "h_e2"), 1), (("orbit", "n_e"), 3),
            (("orbit", "h_e"), 1), (("orbit", "radius"), 1),
            (("orbit", "turn_dir"), 1), ("hor_gdc_req", 1),
            ("vrt_gdc_req", 1))
GDC_Y = CTL_Y + (("n_e", 3),)
GDC_YOUT = tuple((k, 1) for k in ("mode", "dchi", "chi_ref", "h_ref",
                                  "hor_gdc", "vrt_gdc"))
GDC_IN = (GDC_Y,) + AV_GROUPS + (AV_U_GDC,)
GDC_OUT = CTL_OUT + (GDC_YOUT,)
# a scripted mission over the C172Xv2's avionics (`core/mission.py`; rows
# of csrc/c172x_msn.cuh): the phase machine's state, which follows the
# guidance's inputs; MSN_Y what the phase machine, the guidance and the
# control laws read (GDC_Y and the engine's state, which the finish stores
# in S_SYS); MSN_USYS the systems inputs the phases' `systems` override
AV_S_MSN = (("phase", 1), ("t", 1))
MSN_Y = GDC_Y + (("eng_state", 1),)
MSN_USYS = ((("act", "flaps"), 1), (("act", "brake_left"), 1),
            (("act", "brake_right"), 1), (("pwp", "engine", "start"), 1))
MSN_IN = (MSN_Y,) + AV_GROUPS + (AV_U_GDC, AV_S_MSN, MSN_USYS)
MSN_OUT = GDC_OUT + (AV_S_MSN, MSN_USYS)
# a mission on the navigation avionics' estimates (msn_nav_ctl_laws): MSN_Y
# and the estimated orthometric height the radar gate reads (the truth's in
# shadow mode)
HO_ROW = (("h_o", 1),)
MSN_NAV_Y = MSN_Y + HO_ROW
MSN_NAV_IN = (MSN_NAV_Y,) + MSN_IN[1:]
# the turbulent C172S (`physics/turbulence.py`; rows of csrc/turbulence.cuh):
# the five filter states after x_sys, the Dryden and discrete-gust inputs
# and the held drive after CTX, the step's start time after them (which the
# stage reads; the megakernel keeps t in its row 0). The stream's seed and
# the drive's step counter are integers up to 2^31, past what float32 holds
# exactly, so they ride with the step counter i in an int32 [3, B] operand
X_TURB = (("ug", 1), ("vg", 2), ("wg", 2))
U_TURB = (("W20", 1), ("gust_amp", 3), ("gust_t0", 1), ("gust_T", 1),
          ("shear_z0_ft", 1))
S_TURB = (("eta", 3),)
T_ROW = (("t", 1),)
TURB_INT = ("i", "seed", "n")
N_TI = len(TURB_INT)
# the navigation avionics (`physics/navigation.py`; rows of csrc/nav.cuh)
# around the C172Xv1's control laws: NAV_U their inputs (the sensor catalog
# per lane in the order of `sensors.suite_params`, the filter's origin, the
# fault's size), NAV_S their floating state (the sensors' error processes,
# the filter with P as 225 rows, the accumulator A, the fault hold
# registers, the channels' last NIS, the monitors' alarms), both after the
# control laws' avionics block; the integers past float32's exact range
# (the stream's seed up to 2^31, the sensor epoch, the fault's channel,
# mode, k0 and k1, each monitor's bit register) ride in an int32 operand,
# NAV_INT; NAV_T the truth the sensors read (nav_pass's input)
_P = ("sens", "params")
NAV_U = (tuple(((*_P, "imu", k), 3 if k == "r_imu_b" else 1) for k in (
    "sigma_gyro", "sigma_accel", "rw_gyro", "rw_accel", "bias0_gyro",
    "bias0_accel", "scale_gyro", "scale_accel", "r_imu_b"))
    + tuple(((*_P, "airdata", k), 1) for k in (
        "sigma_p", "sigma_pt", "bias_p", "bias_pt", "sigma_T"))
    + tuple(((*_P, "gps", k), 1) for k in (
        "sigma_pos", "sigma_vel", "gm_sigma", "gm_tau"))
    + (((*_P, "mag", "B_n"), 3), ((*_P, "mag", "sigma"), 1),
       ((*_P, "mag", "hard_iron"), 3), ((*_P, "baro", "sigma"), 1),
       ((*_P, "baro", "qnh"), 1), ((*_P, "radar", "sigma"), 1),
       ((*_P, "radar", "h_max"), 1))
    + tuple((("origin", k), 1) for k in ("lat0", "lon0", "h0", "baro_datum",
                                         "N_geo")) + ((("origin", "B_n"), 3),
                                                      (("fault", "delta"), 1)))
MONITORS = ("gps", "vel", "baro", "mag", "radar")
NAV_S = ((("sens", "b_g"), 3), (("sens", "b_a"), 3), (("sens", "gm_gps"), 3),
         (("nav", "q_nb"), 4), (("nav", "v_n"), 3), (("nav", "p_n"), 3),
         (("nav", "b_g"), 3), (("nav", "b_a"), 3), (("nav", "P"), (15, 15)),
         (("A", "w"), (3, 3)), (("A", "cf"), (3, 3)), (("A", "c"), (3, 3)),
         (("hold", "gps_p"), 3), (("hold", "gps_v"), 3),
         (("hold", "h_baro"), 1), (("hold", "mag"), 3)) + tuple(
    (("nis", k), 1) for k in ("baro", "gps", "gps_vel", "mag", "radar")) + \
    tuple((("mon_" + k, "alarm"), 1) for k in MONITORS)
NAV_INT = ((("sens", "seed"), "u"), (("sens", "n"), "s"),
           *((("fault", k), "u") for k in ("channel", "mode", "k0", "k1")),
           *((("mon_" + k, "bits"), "s") for k in MONITORS))
NAV_T = (("omega_eb_b", 3), ("q_eb", 4), ("q_nb", 4), ("lat", 1), ("lon", 1),
         ("n_e", 3), ("h_e", 1), ("h_o", 1), ("v_eb_n", 3), ("p", 1),
         ("pt", 1), ("T", 1), ("f_c_c", 3), ("alpha_ib_b", 3), ("r_OG", 3),
         ("h_trn", 1))
TRN = (("elevation", 1), ("normal", 3), ("surface", 1))
MP = (("m", 1), ("J", (3, 3)), ("r_OG", 3))
WR = (("F", 3), ("tau", 3))


def _shape(w):
    return () if w == 1 else ((w,) if isinstance(w, int) else tuple(w))


def _width(spec):
    return sum(math.prod(_shape(w)) for _, w in spec)


KINAIR_IN = (X_KIN, X_DYN, X_KIN, X_DYN, (("geoid_N", 1),), U_ATM,
             (("term", 1),))
KINAIR_OUT = (X_KIN, KIN_DATA, AIR_DATA, X_DYN)
DYN_IN = (X_DYN, (("m", 1), ("J", 9), ("r_OG", 3)), (("F", 3), ("tau", 3)),
          (("hr_b", 3), ("q_eb", 4), ("r_eb_e", 3), ("term", 1)))
DYN_OUT = (X_DYN,)
FIN_IN = (X_KIN, X_DYN, X_KIN, X_DYN, (("geoid_N", 1),), U_ATM, COMP)
FIN_OUT = (X_KIN, X_DYN, KIN_DATA, AIR_DATA, COMP)
GEOID_IN = ((("q_ew", 4),),)
GEOID_OUT = ((("geoid_N", 1),),)

# the leaves that are not floating point; buffers hold them as 0/1/2
LEAF_DTYPES = {(("pwp", "engine", "mixture_ctl")): torch.int32,
               ("pwp", "engine", "start"): torch.bool,
               ("pwp", "engine", "stop"): torch.bool,
               ("pwp", "engine", "state"): torch.int32,
               ("aero", "stall"): torch.bool, "crashed": torch.bool,
               "surface": torch.int32, "terminated": torch.bool,
               "wow": torch.bool, "mode_req": torch.int32,
               "mode_prev": torch.int32, "h_state": torch.int32,
               "hor_gdc_req": torch.bool, "vrt_gdc_req": torch.bool,
               "mode": torch.int32, "hor_gdc": torch.bool,
               "vrt_gdc": torch.bool, "phase": torch.int32,
               "eng_state": torch.int32}
LEAF_DTYPES.update({(k, f): torch.int32 for k in AV_PRIMITIVES
                    for f in ("out_sat_0", "sat_out_0")})
LEAF_DTYPES.update({("mon_" + k, "alarm"): torch.bool for k in MONITORS})
# nav_pass (csrc/nav_pass.cu): in the truth's GDC_Y, the truth the sensors
# read, the navigation avionics' inputs and floating state; out the GDC_Y
# fields the inner laws read (the estimates in place of the truth's, the
# truth's in shadow mode) and the new floating state
NAV_IN = (GDC_Y, NAV_T, NAV_U, NAV_S)
NAV_OUT = (GDC_Y, NAV_S)
# around a mission the pass also writes the h_o row after NAV_S
NAV_OUT_MSN = NAV_OUT + (HO_ROW,)


class Layout(NamedTuple):
    """The row groups of the systems kernels for one actuation, and the
    name of each kernel's instance for it: systems and finish_sys, and the
    whole vehicle (state X, context CTX: inputs, discrete state, carried
    undulation, the terminated latch; the position residuals C); `mega` the
    megakernel's state buffer: t, X, CTX, C and, fly-by-wire, the control
    laws' avionics block (and the guidance's inputs on the C172Xv2, and a
    mission's phase and clock after them);
    `pass_name` the kernel of the avionics' periodic pass, if any; `turb`
    the turbulent C172S, whose X, CTX and finish output also hold the
    turbulence's rows (X_TURB, U_TURB, S_TURB) and whose whole-vehicle
    kernels read the start time (T_ROW) and the int32 rows TURB_INT, the
    turbulent fly-by-wire C172X's too; `nav` avionics that fly the inner
    avionics' pass on the navigation avionics' estimates: around the
    C172Xv1's control laws the megakernel's instances `megakernel_nav` and
    `megakernel_nav_turb`, around the C172Xv2's guidance and control laws
    `megakernel_gdc_nav` and in turbulence `megakernel_gdc_nav_turb`,
    around a mission over them `megakernel_msn_nav` and
    `megakernel_msn_nav_turb` (their buffer also holds NAV_U and NAV_S,
    their int32 operand NAV_INT after the step counter's rows, the
    turbulent ones after (i, seed, n); the mission's pass in the splits is
    `msn_nav_ctl_laws`); `a2` the channels of the calm C172Xv1 that carry
    a second-order servo (`Actuator2`), two rows each in x_sys
    (`x_sys_fbw`): on the elevator (A2_CARD) the instances
    `rk4_stage_fbw_a2`, `rk4_finish_fbw_a2`, `megakernel_fbw_a2` (and
    `systems_fbw_a2`, `finish_sys_fbw_a2`, which the card has not yet),
    on another set names of the plain path only, tagged with its
    channels."""
    fbw: bool
    x_sys: tuple
    u_sys: tuple
    sys_in: tuple
    sys_out: tuple
    fsys_in: tuple
    fsys_out: tuple
    x_groups: tuple
    ctx_groups: tuple
    stage_in: tuple
    stage_out: tuple
    rkfin_in: tuple
    rkfin_out: tuple
    mega: tuple
    names: dict
    mega_name: str
    pass_name: str
    turb: bool = False
    nav: bool = False
    a2: tuple = ()


# the channel set with second-order servos whose instances the card
# carries: the elevator, the vehicle of the JAX package's
# tests/test_actuators.py:95
A2_CARD = ("elevator",)


def _a2_suffix(a2):
    return "" if not a2 else "_fbw_a2" + (
        "" if a2 == A2_CARD else "_" + "_".join(a2))


def _layout(fbw, gdc=False, msn=False, turb=False, nav=False, a2=()):
    x_sys, u_sys = (x_sys_fbw(a2), U_SYS_FBW) if fbw else (X_SYS, U_SYS)
    x_groups = (X_KIN, X_DYN, x_sys) + ((X_TURB,) if turb else ())
    ctx = (u_sys, U_ATM, TRN, S_SYS, (("geoid_N", 1),), (("terminated", 1),)
           ) + ((U_TURB, S_TURB) if turb else ())
    stage_in = x_groups + ctx + ((T_ROW,) if turb else ())
    y = ((SYS_Y,) if fbw else ())
    return Layout(
        fbw=fbw, x_sys=x_sys, u_sys=u_sys,
        sys_in=(x_sys, x_sys, u_sys, S_SYS, TRN, KIN_DATA, AIR_DATA,
                (("term", 1),)),
        sys_out=(x_sys, MP, WR, (("hr_b", 3),)),
        fsys_in=(x_sys, x_sys, u_sys, S_SYS, TRN, KIN_DATA, AIR_DATA),
        fsys_out=(x_sys, S_SYS) + y,
        x_groups=x_groups, ctx_groups=ctx, stage_in=stage_in,
        stage_out=x_groups, rkfin_in=stage_in + (COMP,),
        rkfin_out=x_groups + (S_SYS, (("terminated", 1),), COMP)
        + ((KIN_Y,) + y if fbw else ()) + ((S_TURB,) if turb else ()),
        mega=((("t", 1),),) + x_groups + ctx + (COMP,)
        + (AV_GROUPS if fbw else ()) + ((AV_U_GDC,) if gdc else ())
        + ((AV_S_MSN,) if msn else ()) + ((NAV_U, NAV_S) if nav else ()),
        # the subsystems split carries no turbulence: its turbulent
        # fly-by-wire names are the fly-by-wire ones, never launched
        names={k: k + (_a2_suffix(a2) if a2 else "_fbw" if fbw else "") + (
            "_turb" if turb and k.startswith("rk4") else "")
            for k in ("systems", "finish_sys", "rk4_stage", "rk4_finish")},
        mega_name=("megakernel" + _a2_suffix(a2) if a2
                   else "megakernel_msn_nav" + "_turb" * turb if nav and msn
                   else "megakernel_gdc_nav" + "_turb" * turb if nav and gdc
                   else ("megakernel_nav_turb" if turb else "megakernel_nav")
                   if nav else "megakernel_msn" + "_turb" * turb if msn
                   else "megakernel_gdc" + "_turb" * turb if gdc
                   else "megakernel_fbw_turb" if fbw and turb
                   else "megakernel_fbw" if fbw else "megakernel_turb" if turb
                   else "megakernel"),
        pass_name=("msn_nav_ctl_laws" if msn and nav
                   else "msn_ctl_laws" if msn else "gdc_ctl_laws" if gdc
                   else "ctl_laws" if fbw else None), turb=turb, nav=nav,
        a2=tuple(a2))


# the C172S; the fly-by-wire C172X with its ControlLaws (the C172Xv1), with
# its guidance and control laws (the C172Xv2) and with a scripted mission
# over them: the same systems kernels, the megakernel and the pass
# instances of their own
MECH, FBW, GDC = _layout(False), _layout(True), _layout(True, gdc=True)
MSN = _layout(True, gdc=True, msn=True)
# the turbulent C172S (DrydenTurbulence): the whole-vehicle kernels and the
# megakernel only, as the JAX package's subsystems split has no turbulent
# instance (clusterstep.py:568)
TURB = _layout(False, turb=True)
# the turbulent fly-by-wire C172X (c172x.build_vehicle(turbulence=), the
# navigation study's vehicle): its whole-vehicle kernels and its megakernels
# with the control laws, with the C172Xv2's avionics and with a mission
FBW_TURB = _layout(True, turb=True)
GDC_TURB, MSN_TURB = (_layout(True, gdc=True, turb=True),
                      _layout(True, gdc=True, msn=True, turb=True))
# the sensor-fed C172Xv1 (NavAvionics around its ControlLaws; c172x.
# build_xv1_nav) and the sensor-fed C172Xv2 (around its guidance and control
# laws; c172x.build_xv2_nav), each calm and in Dryden turbulence: the
# fly-by-wire layouts with the navigation avionics' rows in the megakernel's
# buffer
FBW_NAV, FBW_TURB_NAV = _layout(True, nav=True), _layout(True, turb=True,
                                                         nav=True)
GDC_NAV, GDC_TURB_NAV = (_layout(True, gdc=True, nav=True),
                         _layout(True, gdc=True, turb=True, nav=True))
# the sensor-fed missions (NavAvionics around a MissionAvionics over the
# C172Xv2's guidance and control laws; missions.mission_nav_sim), calm and
# in turbulence
MSN_NAV, MSN_TURB_NAV = (_layout(True, gdc=True, msn=True, nav=True),
                         _layout(True, gdc=True, msn=True, turb=True,
                                 nav=True))
# the mechanical C172's groups (the C172S and its megakernel)
SYS_IN, SYS_OUT, FSYS_IN, FSYS_OUT = (MECH.sys_in, MECH.sys_out,
                                      MECH.fsys_in, MECH.fsys_out)
X_GROUPS, CTX_GROUPS, STAGE_IN, STAGE_OUT, RKFIN_IN, RKFIN_OUT = (
    MECH.x_groups, MECH.ctx_groups, MECH.stage_in, MECH.stage_out,
    MECH.rkfin_in, MECH.rkfin_out)


def layout_of(vehicle, avionics=None):
    """The layout of the vehicle's actuation: FBW for the fly-by-wire
    servos, `Actuator1` on every channel, GDC where its `avionics` are the
    C172Xv2's guidance and control laws, MSN a mission over them; TURB for
    the C172S with Dryden turbulence, FBW_TURB (GDC_TURB, MSN_TURB) for the
    turbulent fly-by-wire C172X. Navigation avionics take their inner
    avionics' layout, marked `nav`: around the control laws FBW_NAV
    (FBW_TURB_NAV), around the guidance and control laws GDC_NAV
    (GDC_TURB_NAV), around a mission MSN_NAV (MSN_TURB_NAV). A calm
    C172Xv1 with second-order servos (`Actuator2`) on some channels takes
    the layout of that set, `a2_layout` (FBW_A2 on the elevator); those
    servos with turbulence, the C172Xv2's guidance, a mission or the
    navigation avionics are refused (ROADMAP Queue 2)."""
    act = vehicle.systems.act
    stateful = getattr(act, "stateful", False)
    turb = getattr(vehicle, "turbulence", None) is not None
    if not stateful:
        return TURB if turb else MECH
    from flightjax_torch.physics.navigation import NavAvionics
    nav = isinstance(avionics, NavAvionics)
    inner = avionics.inner if nav else avionics
    a2 = tuple(ch for ch in FBW_CHANNELS if act.actuators[ch].order == 2)
    if a2:
        what = ("Dryden turbulence" if turb else "the navigation avionics"
                if nav else "the C172Xv2's guidance laws"
                if isinstance(inner, Avionics) else "a scripted mission"
                if isinstance(inner, MissionAvionics) else None)
        if what is not None:
            raise ValueError(
                f"the kernels carry second-order servos (Actuator2 on "
                f"{list(a2)}) on the calm C172Xv1 with its control laws, "
                f"not with {what}: ROADMAP Queue 2, 'Actuator2 channels in "
                f"the kernels'")
        return a2_layout(a2)
    if isinstance(inner, Avionics):
        if nav:
            return GDC_TURB_NAV if turb else GDC_NAV
        lay = GDC_TURB if turb else GDC
    elif isinstance(inner, MissionAvionics):
        if nav:
            return MSN_TURB_NAV if turb else MSN_NAV
        lay = MSN_TURB if turb else MSN
    elif nav:
        return FBW_TURB_NAV if turb else FBW_NAV
    else:
        lay = FBW_TURB if turb else FBW
    return lay


def mission_refusal(avionics):
    """Why the kernels do not carry the MissionAvionics `avionics`, or None
    where they do: they carry a mission over the C172Xv2's guidance and
    control laws whose phases carry the descriptors of `models/c172/
    missions.py::mission_phase_lib`."""
    from flightjax_torch.models.c172.missions import (MissionApply,
                                                      MissionDone,
                                                      MissionSystems)
    where = ("; such a mission flies on the plain path "
             "(Simulation.fleet_step or make_cluster_step on the CPU)")
    if not isinstance(avionics.inner, Avionics):
        return (f"the mission kernels carry a MissionAvionics over the "
                f"C172Xv2's guidance and control laws (c172x_gdc.Avionics), "
                f"not over {type(avionics.inner).__name__}" + where)
    for p in avionics.phases:
        if not (isinstance(p.apply, MissionApply)
                and isinstance(p.done, MissionDone)
                and (p.systems is None
                     or isinstance(p.systems, MissionSystems))):
            return (f"the mission kernels read the phases' descriptors; "
                    f"phase {p.name!r} has arbitrary callables, not those "
                    f"of models/c172/missions.py::mission_phase_lib" + where)
    return None


def avionics_layout(vehicle, avionics):
    """The layout of an aircraft whose avionics run as kernels: the
    C172X's `ControlLaws` (FBW), the C172Xv2's `Avionics` (GDC) or a
    mission over them whose phases carry descriptors (MSN), each also
    inside the navigation avionics (their pass the inner avionics' kernel
    on the estimates; MSN_NAV the sensor-fed missions); other avionics have
    no kernel and are refused."""
    from flightjax_torch.physics.navigation import NavAvionics
    inner = avionics.inner if isinstance(avionics, NavAvionics) else avionics
    if isinstance(inner, MissionAvionics):
        why = mission_refusal(inner)
        if why is not None:
            raise NotImplementedError(why)
    elif not isinstance(inner, (ControlLaws, Avionics)):
        raise NotImplementedError(
            f"the kernels carry the C172X's ControlLaws, the C172Xv2's "
            f"guidance and control laws and a scripted mission over them "
            f"(core/mission.py), not {type(inner).__name__}: these "
            f"avionics have no kernel")
    return layout_of(vehicle, avionics)


def rows(groups):
    return sum(_width(g) for g in groups)


def _get(obj, key):
    for k in (key if isinstance(key, tuple) else (key,)):
        obj = obj[k] if isinstance(obj, dict) else getattr(obj, k)
    return obj


def pack(groups, objs, B, dtype=None):
    """Concatenate the named fields of `objs` (one per spec group) into a
    contiguous batch-minor `[rows, B]` tensor of `dtype` (default: the
    first field's); bool and integer fields become 0/1/... in it."""
    cols = []
    for spec, obj in zip(groups, objs):
        cols += [_get(obj, k).reshape(B, -1) for k, _ in spec]
    dtype = cols[0].dtype if dtype is None else dtype
    return torch.cat([c.to(dtype) for c in cols], dim=1).t().contiguous()


def _unpack(spec, buf, o, typed):
    out = {}
    for key, w in spec:
        shape = _shape(w)
        n = math.prod(shape)
        v = buf[o] if shape == () else buf[o:o + n].t()
        if len(shape) > 1:
            v = v.reshape((buf.shape[1],) + shape)
        dtype = LEAF_DTYPES.get(key) if typed else None
        if dtype == torch.bool:
            v = v > 0.5
        elif dtype is not None:
            v = v.to(dtype)
        node = out
        path = key if isinstance(key, tuple) else (key,)
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
        o += n
    return out, o


def unpack(groups, buf, typed=False):
    """Views of a `[rows, B]` buffer as one (nested) dict per spec group;
    with `typed`, the leaves of LEAF_DTYPES are converted back to their
    bool or integer type."""
    out, o = [], 0
    for spec in groups:
        d, o = _unpack(spec, buf, o, typed)
        out.append(d)
    return out


def rows_of(groups, key):
    """The row slice of field `key` in a buffer of `groups`."""
    o = 0
    for spec in groups:
        for k, w in spec:
            n = math.prod(_shape(w))
            if k == key:
                return slice(o, o + n)
            o += n
    raise KeyError(key)


# ------------------------------------------------------------ parameters
# The C172 systems' parameter buffer; the names and order are the enums of
# csrc/c172_systems.cuh without their prefixes.

PI_P = ("k_p", "k_i", "k_l", "beta_p", "lo", "hi")
AERO_P = ("S", "b", "c", "tau", "V_min", "e_lo", "e_sc", "a_lo", "a_sc",
          "r_lo", "r_sc", "f_lo", "f_sc", "stall_lo", "stall_hi",
          *AERO_CONST)
LEG_P = ("r_bs_x", "r_bs_y", "r_bs_z", "l_0", "k_s", "k_d_ext", "k_d_cmp",
         "psi_max", "eta_br", *("frc_" + k for k in PI_P))
ENG_P = ("omega_idle", "omega_rated", "omega_stall", "tau_start", "P_rated",
         "tau_fr_sc", "J_sum", "gear_ratio", *("idle_" + k for k in PI_P),
         *("frc_" + k for k in PI_P))
PROP_P = ("d", "d_half", "d4", "d5", "J_xx", "sense", "dbeta", "r_bp_x",
          "r_bp_y", "r_bp_z")
MASS_P = ("m", *(f"J{i}{j}" for i in range(3) for j in range(3)), "r_OG_x",
          "r_OG_y", "r_OG_z", "M_RES", "M_USABLE",
          *(f"{n}_{a}" for n in ("tank0", "tank1", *PAYLOAD_KEYS)
            for a in "xyz"))
# one servo of the fly-by-wire actuation (the FBW buffer holds them after
# the table offsets, in the order of FBW_CHANNELS)
ACT_P = ("tau", "lo", "hi")
TABLES = ("CD_df", "CD_ge", "CD_alpha_df", "CY_beta_df", "CY_p", "CY_r",
          "CL_ge", "CL_alpha", "CL_df", "Cl_r", "Cm_df", "delta_wot",
          "mu_wot", "pi_std", "pi_wot", "pi_ratio", "sfc_ratio", "sfc_pow",
          "prop")
# the axes of each table, which the kernels' lookups know at compile time
# (the length of each query in csrc/c172_systems.cuh); `system_params`
# holds the model's tables to it
TABLE_RANKS = dict(zip(TABLES, (1, 1, 2, 2, 2, 2, 1, 2, 1, 2, 1, 2, 2, 2, 2,
                                1, 1, 2, 3)))


def _pi(p):
    return [p.k_p, p.k_i, p.k_l, p.beta_p, p.bound_lo, p.bound_hi]


def _scale_map(rng, lo_u, hi_u):
    """(lower end, slope) of `Aero._scale`, formed as it forms them."""
    return [rng[0], (rng[1] - rng[0]) / (hi_u - lo_u)]


def param_scalars(vehicle):
    """The scalar head of the parameter buffer, in float64: {group: values}
    in the order of the *_P names above."""
    sys_ = vehicle.systems
    a, th = sys_.aero, sys_.pwp
    e, pr = th.engine, th.propeller
    legs = []
    for leg in sys_.ldg.legs:
        d = leg.damper
        legs += [*leg.r_bs.tolist(), leg.l_0, d.k_s, d.k_d_ext, d.k_d_cmp,
                 leg.psi_max, leg.eta_br, *_pi(leg.frc)]
    mp = sys_.airframe_mp
    return {
        "aero": [a.S, a.b, a.c, a.tau, a.V_min,
                 *_scale_map(a.de_range, -1.0, 1.0),
                 *_scale_map(a.da_range, -1.0, 1.0),
                 *_scale_map(a.dr_range, -1.0, 1.0),
                 *_scale_map(a.df_range, 0.0, 1.0), *a.alpha_stall,
                 *AERO_CONST.values()],
        "legs": legs,
        "engine": [e.omega_idle, e.omega_rated, e.omega_stall, e.tau_start,
                   e.P_rated, 0.01 * e.P_rated / e.omega_rated,
                   e.J + th.gear_ratio ** 2 * pr.J_xx, th.gear_ratio,
                   *_pi(e.idle), *_pi(e.frc)],
        "prop": [pr.d, pr.d / 2, pr.d ** 4, pr.d * pr.d ** 4, pr.J_xx,
                 pr.sense, pr.dbeta, *pr.r_bp.tolist()],
        "mass": [float(mp.m), *mp.J.reshape(-1).tolist(), *mp.r_OG.tolist(),
                 M_RES, M_FULL - M_RES,
                 *(v for r in sys_.tank_r for v in r.tolist()),
                 *(v for k in PAYLOAD_KEYS for v in sys_.payload_r[k].tolist())],
    }


def param_act(vehicle):
    """The servos' time constants and ranges, in float64, in the order of
    FBW_CHANNELS and ACT_P (NaN for the time constant of a second-order
    servo, which has none); then, with second-order servos, each one's
    omega_n^2 and 2 zeta omega_n in channel order (csrc/c172_systems.cuh,
    A2_*), formed in float64 as `Actuator2.f_ode` forms them; [] for a
    stateless actuation."""
    lay = layout_of(vehicle)
    if not lay.fbw:
        return []
    acts = vehicle.systems.act.actuators
    out = [v for ch in FBW_CHANNELS for v in (
        acts[ch].tau if acts[ch].order == 1 else math.nan, *acts[ch].range)]
    return out + [v for ch in lay.a2 for v in (
        acts[ch].omega_n ** 2, 2.0 * acts[ch].zeta * acts[ch].omega_n)]


def param_turb(vehicle):
    """The turbulent C172S's drive scale sqrt(pi / dt) (`turbulence.py:
    181`), in float64; [] without turbulence."""
    turb = getattr(vehicle, "turbulence", None)
    return [] if turb is None else [math.sqrt(math.pi / turb.dt)]


def param_tables(vehicle):
    """{name: Lookup} of the tables the systems kernels read."""
    sys_ = vehicle.systems
    tables = dict(sys_.aero.tables, **sys_.pwp.engine.tables,
                  prop=sys_.pwp.propeller.lookup)
    return {k: tables[k] for k in TABLES}


def encode_table(lk):
    """A `Lookup` as the flat float64 list `csrc/flight_math.cuh::lookup`
    reads: n_axes, outputs per knot, per axis (n, line?, uniform?, x0, dx),
    the knots, the values in C order."""
    d = len(lk.axes)
    out = [float(d), float(math.prod(lk.values.shape[d:]))]
    for ax, mode, uni in zip(lk.axes, lk.extrap, lk._uni):
        out += [float(ax.shape[0]), float(mode == "line"),
                float(uni is not None),
                float(uni[0]) if uni is not None else 0.0,
                float(uni[1]) if uni is not None else 0.0]
    for ax in lk.axes:
        out += ax.double().tolist()
    return out + lk.values.double().reshape(-1).tolist()


_PARAMS = weakref.WeakKeyDictionary()


def system_params(vehicle):
    """The parameter buffer of the systems kernels for this vehicle, on its
    device and in its dtype (built once): the scalars of `param_scalars`,
    one offset per table, the servos of `param_act` (fly-by-wire only) or
    the drive's scale of `param_turb` (turbulent only), then the tables
    (`encode_table`)."""
    sys_ = vehicle.systems
    buf = _PARAMS.get(sys_)
    if buf is None:
        head = [v for vs in param_scalars(vehicle).values() for v in vs]
        act = param_act(vehicle) + param_turb(vehicle)
        tables = list(param_tables(vehicle).values())
        for name, lk in zip(TABLES, tables):
            if len(lk.axes) != TABLE_RANKS[name]:
                raise ValueError(f"table {name} has {len(lk.axes)} axes, "
                                 f"the kernels read {TABLE_RANKS[name]}")
        offsets, body = [], []
        base = len(head) + len(tables) + len(act)
        for lk in tables:
            offsets.append(float(base + len(body)))
            body += encode_table(lk)
        like = sys_.airframe_mp.m
        buf = torch.tensor(head + offsets + act + body,
                           dtype=torch.float64).to(device=like.device,
                                                   dtype=like.dtype)
        _PARAMS[sys_] = buf
    return buf


_GRIDS = weakref.WeakKeyDictionary()


def geoid_grid(geo):
    """The EGM96 grid of an `ops.geodesy.Geoid` as the geoid kernels read
    it (built once): `[n_lat + 1, n_lon]` on its device in its dtype, row 0
    starting with n_lat, n_lon and the (first knot, spacing) of both axes as
    `RowLookup` holds them, rows 1.. the undulations."""
    buf = _GRIDS.get(geo)
    if buf is None:
        lk = geo.lookup
        head = torch.zeros(lk.n1, dtype=torch.float64)
        head[:L.GEO_HEAD] = torch.tensor([lk.n0, lk.n1, lk.x0, lk.d0, lk.y0,
                                          lk.d1], dtype=torch.float64)
        buf = torch.cat([head.to(device=lk.values.device,
                                 dtype=lk.values.dtype)[None], lk.values])
        _GRIDS[geo] = buf
    return buf


# the gain tables of the control laws, in the order of csrc/c172x_ctl.cuh
# (GT_*): lon channels, then lat; each channel's gains stacked per knot
CTL_TABLES = ("v2t", "c2theta", "q2e", "te2te", "tv2te", "vh2te", "p2phi",
              "chi2phi", "ar2ar", "phibeta2ar")
PID_GAINS = ("k_p", "k_i", "k_d", "tau_f")
LQR_GAINS = ("K_fbk", "K_fwd", "K_int", "x_trim", "u_trim", "z_trim")
# the number of states of each tracker's feature vector the kernels read
CTL_NX = {"te2te": 8, "tv2te": 8, "vh2te": 9, "ar2ar": 8, "phibeta2ar": 8}

_GAINS = weakref.WeakKeyDictionary()

# the mission table (csrc/c172x_msn.cuh): the number of phases and the
# offset of the legs, then one record of PHASE_FIELDS per phase, then the
# legs (n_e1, h_e1, n_e2, h_e2 each)
MT_HEAD = ("n_phases", "legs")
PHASE_FIELDS = ("apply", "leg", "EAS", "throttle_on", "throttle", "vrt",
                "done", "done_value", "done_leg", "systems", "flaps")
LEG_N = 8


def control_laws(avionics):
    """The `ControlLaws` of the C172Xv1's avionics, the C172Xv2's, a
    mission over them or the navigation avionics around any of those."""
    while hasattr(avionics, "inner"):
        avionics = avionics.inner
    return getattr(avionics, "ctl", avionics)


def mission_table_values(avionics):
    """The mission table of a MissionAvionics the kernels carry
    (`mission_refusal`), in float64: the phases' descriptors and the legs
    they read, each leg once."""
    why = mission_refusal(avionics)
    if why is not None:
        raise NotImplementedError(why)
    legs = []

    def leg(seg):
        if seg is None:
            return 0.0
        for k, other in enumerate(legs):
            if other is seg:
                return float(k)
        legs.append(seg)
        return float(len(legs) - 1)

    recs = []
    for p in avionics.phases:
        a, d, sy = p.apply, p.done, p.systems
        thr = a.values.get("throttle")
        rec = dict(apply=a.kind, leg=leg(a.leg), EAS=a.values.get("EAS", 0.0),
                   throttle_on=float(thr is not None),
                   throttle=0.0 if thr is None else thr,
                   vrt=float(a.values.get("vrt", False)), done=d.kind,
                   done_value=d.values.get("value", 0.0),
                   done_leg=leg(d.leg), systems=0 if sy is None else sy.kind,
                   flaps=0.0 if sy is None else sy.values.get("flaps", 0.0))
        recs += [float(rec[k]) for k in PHASE_FIELDS]
    head = [float(len(avionics.phases)),
            float(len(MT_HEAD) + len(recs))]
    body = [float(v) for seg in legs for v in (
        *seg.n_e1.double().tolist(), float(seg.h_e1),
        *seg.n_e2.double().tolist(), float(seg.h_e2))]
    return head + recs + body


def nav_param_values(nav):
    """The filter's constants the navigation kernels read (csrc/nav.cuh,
    NP_*), in float64: dt, sqrt(dt), dt^2, p_every dt, -0.5 dt, Q p_every,
    the stacked rows' variances (the GPS position's for the avionics'
    dtype), the gates, the monitors' window and hits, the cadences,
    use_radar, radar_max_agl, use_estimates, then each ISA layer of the
    baro altimeter's pressure altitude (zero lapse, base height, factor,
    exponent, base pressure), then the airflow angles' policy (0 the
    truth's, 1 "synthetic", 2 ("perturb", da, db)) with da and db, and
    defer_cov. Without defer_cov the covariance steps every firing
    (`InsGps.predict`): p_every is 1 and Q unscaled."""
    from flightjax_torch.physics.atmosphere import G_STD, ISA_LAYERS, R_GAS
    from flightjax_torch.physics.sensors import _ISA_BASES
    f, dt = nav.filter, nav.dt
    k = nav.p_every if nav.defer_cov else 1
    r = ([f.r_pos_eff(nav.dtype)] * 3 + [f.r_vel] * 3 + [f.r_baro]
         + [f.r_mag_dir] * 3 + [f.sigma_radar ** 2])
    out = [dt, math.sqrt(dt), dt ** 2, float(k) * dt, -0.5 * dt]
    out += (float(k) * f.Q_diag).tolist() + r
    out += [nav.gps_gate, nav.vel_gate, nav.baro_gate, nav.mag_gate,
            nav.radar_gate, float(nav.monitor_window),
            float(nav.monitor_min_hits), float(nav.suite.gps_every),
            float(nav.baro_every), float(nav.mag_every),
            float(nav.radar_every), float(k), float(nav.use_radar),
            nav.radar_max_agl, float(nav.use_estimates)]
    for (beta, _), (h_b, T_b, p_b) in zip(ISA_LAYERS, _ISA_BASES):
        if beta == 0.0:
            out += [1.0, h_b, R_GAS * T_b / G_STD, 0.0, p_b]
        else:
            out += [0.0, h_b, T_b / beta, -beta * R_GAS / G_STD, p_b]
    ab = nav.alpha_beta
    if ab == "truth":
        out += [0.0, 0.0, 0.0]
    elif ab == "synthetic":
        out += [1.0, 0.0, 0.0]
    else:
        tag, da, db = ab
        assert tag == "perturb", ab
        out += [2.0, float(da), float(db)]
    out.append(float(nav.defer_cov))
    return [float(v) for v in out]


def mission_table(avionics):
    """The mission table on the avionics' device in their dtype, cast once
    from float64 (`mission_table_values`)."""
    return torch.tensor(mission_table_values(avionics),
                        dtype=torch.float64).to(device=avionics.device,
                                                dtype=avionics.dtype)


def ctl_gains(avionics):
    """The control laws' gain buffer on their device in their dtype (built
    once) of a `ControlLaws`, of the C172Xv2's avionics (their control
    laws') or of a mission over them: the offsets of the CTL_TABLES, then
    each channel's schedule as one table (`encode_table`) whose values are
    its gains stacked per knot (PID_GAINS, or LQR_GAINS flattened), on the
    schedules' own (EAS, h) grid and extrapolation. A mission's buffer
    holds one more offset after the tables' (that of the mission table)
    and the mission table at its end: the mission instances read both from
    it, and the megakernel keeps the other instances' parameters. The
    navigation avionics' buffer holds the filter's constants there in the
    same way (`nav_param_values`), which nav_pass and the megakernel's
    navigation instances read; around a mission (`megakernel_msn_nav`) a
    second offset after it points at the mission table, which follows the
    filter's constants."""
    from flightjax_torch.physics.navigation import NavAvionics
    mission = isinstance(avionics, MissionAvionics)
    nav = isinstance(avionics, NavAvionics)
    laws = control_laws(avionics)
    key = avionics if mission or nav else laws
    buf = _GAINS.get(key)
    if buf is None:
        extras = ([mission_table_values(avionics)] if mission
                  else [nav_param_values(avionics)] if nav else [])
        if nav and isinstance(avionics.inner, MissionAvionics):
            extras.append(mission_table_values(avionics.inner))
        n_head = len(CTL_TABLES) + len(extras)
        body = []
        offsets = []
        for ch in CTL_TABLES:
            g = laws.gains[ch]
            keys = PID_GAINS if ch in ("v2t", "c2theta", "q2e", "p2phi",
                                       "chi2phi") else LQR_GAINS
            first = g[keys[0]]
            d = len(first.axes)
            if ch in CTL_NX and tuple(first.values.shape[d:]) != (
                    2, CTL_NX[ch]):
                raise ValueError(f"gain table {ch}/K_fbk has the shape "
                                 f"{tuple(first.values.shape)}, the kernels "
                                 f"read (..., 2, {CTL_NX[ch]})")
            values = torch.cat([g[k].values.reshape(
                g[k].values.shape[:d] + (-1,)) for k in keys], dim=-1)
            lk = Lookup([a.cpu().double().numpy() for a in first.axes],
                        values.cpu().double().numpy(), first.extrap,
                        device="cpu", dtype=first.values.dtype)
            offsets.append(float(n_head + len(body)))
            body += encode_table(lk)
        for extra in extras:
            offsets.append(float(n_head + len(body)))
            body += extra
        like = laws.gains["v2t"]["k_p"].values
        buf = torch.tensor(offsets + body, dtype=torch.float64).to(
            device=like.device, dtype=like.dtype)
        _GAINS[key] = buf
    return buf


# ------------------------------------------------------------ plain versions

def _fma(xt, kt, adt):
    return tree_map(lambda a, b: a + adt * b, xt, kt)


def _alive_scale(tree, term):
    alive = 1.0 - term
    return tree_map(lambda v: bscale(alive, v), tree)


def kinair_plain(x_kin, x_dyn, k_kin, k_dyn, geoid_N, u_atm, adt, term):
    """Stage FMA on kinematics and dynamics, WA f_ode -> KinData, ISA
    atmosphere with wind, air data, derivative x alive (`k1_lane`).
    `adt` is the stage offset (Python float), `term` 0/1 per lane."""
    xi_kin = _fma(x_kin, k_kin, adt)
    xi_dyn = _fma(x_dyn, k_dyn, adt)
    kin_dot, kin = _WA.f_ode(xi_kin, xi_dyn, geoid_N)
    atm_d = _ATM.atmospheric_data(u_atm, kin.n_e, kin.h_o)
    air = air_data(atm_d, kin)
    return _alive_scale(kin_dot, term), kin, air, xi_dyn


def kinair_turb_plain(vehicle, x_kin, x_dyn, k_kin, k_dyn, geoid_N, u_atm,
                      adt, term, x_turb, k_turb, u_turb, s_turb, t, elevation):
    """`kinair_plain` on the turbulent vehicle: also the filters' stage
    state x_turb + adt k_turb, and the disturbance chain between the
    atmosphere and the air data at the stage time `t`
    (`Vehicle.apply_disturbances`, `aircraftbase.py:207-218`). Returns
    (kin_dot, kin, air, xi_dyn, turb_dot), the derivatives x alive."""
    xi_kin = _fma(x_kin, k_kin, adt)
    xi_dyn = _fma(x_dyn, k_dyn, adt)
    xi_turb = _fma(x_turb, k_turb, adt)
    kin_dot, kin = _WA.f_ode(xi_kin, xi_dyn, geoid_N)
    atm_d = _ATM.atmospheric_data(u_atm, kin.n_e, kin.h_o)
    atm_d, v_ew_b, turb_dot = vehicle.apply_disturbances(
        xi_turb, u_turb, s_turb, t, kin, atm_d, elevation, True)
    air = air_data(atm_d, kin, v_ew_b)
    return (_alive_scale(kin_dot, term), kin, air, xi_dyn,
            _alive_scale(turb_dot, term))


def finish_kin_turb_plain(vehicle, x_kin, x_dyn, ksum_kin, ksum_dyn, geoid_N,
                          u_atm, dt, c_kin, x_turb, ksum_turb, u_turb, s_turb,
                          t_new, elevation):
    """`finish_kin_plain` on the turbulent vehicle: also the filters'
    combine, and the air data at the new state disturbed by the gust at
    `t_new` (`Vehicle._context`, `aircraftbase.py:194-205`). Returns
    (x_kin, x_dyn, kin, air, c_kin, x_turb)."""
    x_kin2, x_dyn2, kin, _, c_kin = finish_kin_plain(
        x_kin, x_dyn, ksum_kin, ksum_dyn, geoid_N, u_atm, dt, c_kin)
    x_turb2 = tree_map(lambda a, b: a + (dt / 6.0) * b, x_turb, ksum_turb)
    atm_d = _ATM.atmospheric_data(u_atm, kin.n_e, kin.h_o)
    atm_d, v_ew_b, _ = vehicle.apply_disturbances(
        x_turb2, u_turb, s_turb, t_new, kin, atm_d, elevation, False)
    return x_kin2, x_dyn2, kin, air_data(atm_d, kin, v_ew_b), c_kin, x_turb2


def dynamics_plain(xi_dyn, mp_b, wr_b, hr_b, q_eb, r_eb_e, term):
    """Newton-Euler at the CoM, x alive (`k3_lane`)."""
    dyn_dot = _DYN.f_ode(xi_dyn, DynamicsU(mp_sum_b=mp_b, wr_sum_b=wr_b,
                                           ho_sum_b=hr_b, q_eb=q_eb,
                                           r_eb_e=r_eb_e))
    return _alive_scale(dyn_dot, term)


def finish_kin_plain(x_kin, x_dyn, ksum_kin, ksum_dyn, geoid_N, u_atm, dt,
                     c_kin=None):
    """RK4 combine x + dt/6 ksum on kinematics (compensated on q_ew/h_e
    when residuals `c_kin` are carried) and dynamics, WA renorm, fresh
    KinData and AirData (`k4_lane` + `comp_add`). Returns (x_kin, x_dyn,
    kin, air, c_kin)."""
    c6 = dt / 6.0
    incr = {k: c6 * v for k, v in ksum_kin.items()}
    if c_kin is None:
        x_kin2 = {k: x_kin[k] + incr[k] for k in x_kin}
    else:
        x_kin2, c_kin = comp_add(x_kin, incr, c_kin)
    x_dyn2 = {k: x_dyn[k] + c6 * ksum_dyn[k] for k in x_dyn}
    x_kin2 = _WA.f_step(x_kin2)
    _, kin = _WA.f_ode(x_kin2, x_dyn2, geoid_N)
    atm_d = _ATM.atmospheric_data(u_atm, kin.n_e, kin.h_o)
    return x_kin2, x_dyn2, kin, air_data(atm_d, kin), c_kin


def systems_plain(vehicle, x_sys, k_sys, u_sys, s_sys, u_trn, kin, air, adt,
                  term):
    """Stage FMA on the systems state, actuation + aero, the three gear
    legs, powerplant + fuel + mass, derivative x alive (`k2_lane`, composed
    as the fine split composes `k_actaero`, `k_ldg0..2` and `k_pwp`).
    Returns (x_sys derivative, mp_b, wr_b, hr_b)."""
    sys_ = vehicle.systems
    trn = vehicle.terrain.terrain_data(u_trn)
    xi = _fma(x_sys, k_sys, adt)
    aero_dot, gear_u, thr_mix, wr_aero = sys_.actaero(
        xi["aero"], u_sys["act"], s_sys["aero"], kin, air, trn,
        xi.get("act"))
    frc_dots, wr_ldg = [], None
    for i in range(sys_.ldg.n):
        d, w = sys_.ldg_leg(i, xi["ldg"]["frc"][:, i],
                            gear_u["steering"][:, i],
                            gear_u["braking"][:, i], kin, trn)
        frc_dots.append(d)
        wr_ldg = w if wr_ldg is None else wr_ldg + w
    pwp_dot, fuel_dot, mp_b, wr_b, hr_b = sys_.pwp_mass(
        xi["pwp"], xi["fuel"], u_sys["pwp"], s_sys["pwp"], thr_mix,
        u_sys["pld"], kin, air, wr_aero, wr_ldg)
    sys_dot = {"aero": aero_dot, "ldg": {"frc": torch.stack(frc_dots, dim=1)},
               "pwp": pwp_dot, "fuel": fuel_dot}
    if "act" in xi:
        sys_dot["act"] = sys_.actuate(xi["act"], u_sys["act"])[2]
    return _alive_scale(sys_dot, term), mp_b, wr_b, hr_b


def finish_sys_plain(vehicle, x_sys, ksum_sys, u_sys, s_sys, u_trn, kin,
                     air, dt):
    """RK4 combine x + dt/6 ksum on the systems state, then actuation (at
    the combined servo positions, fly-by-wire), the three struts and stall
    / gear reset / crash / engine state machine at the new kinematics
    (`k5_lane`, composed as the fine split composes `k_fin_act`,
    `k_fin_ldg0..2` and `k_fin_rest`). Returns (x_sys, s_sys, sys_y):
    sys_y is the SYS_Y the fly-by-wire C172's avionics read (the gated
    airflow angles and each leg's weight on wheels), None for the
    mechanical one."""
    sys_ = vehicle.systems
    trn = vehicle.terrain.terrain_data(u_trn)
    x = tree_map(lambda a, b: a + (dt / 6.0) * b, x_sys, ksum_sys)
    gear_u = sys_.fin_act(u_sys["act"], x.get("act"))
    legs = [sys_.fin_ldg_leg(j, gear_u["steering"][:, j], kin, trn)
            for j in range(sys_.ldg.n)]
    wow, alpha_ts, xi_dot = (torch.stack([leg[j] for leg in legs], dim=1)
                             for j in range(3))
    x2, s2 = sys_.fin_rest(x, u_sys["pwp"], s_sys, air, wow, alpha_ts,
                           xi_dot)
    if "act" not in x:
        return x2, s2, None
    alpha, beta, _ = _alpha_gated(air)
    return x2, s2, {"alpha": alpha, "beta": beta, "wow": wow > 0.5}


def geoid_plain(geo, q_ew):
    """EGM96 undulation under the WA position quaternion (`Geoid.height` at
    `nvector_from_qew`)."""
    return geo.height(nvector_from_qew(q_ew))


def stage_clusters(C, vehicle, xv, kv, uv, sv, term, adt, t=None):
    """World derivative at the RK4 stage state xv + adt kv through the
    cluster functions `C` (`WRAPPERS` or `PLAIN`): kinair -> systems ->
    dynamics, `stage_lane` of `clusterstep.py:81-85`. `term` is 0/1. A
    turbulent vehicle (its trees under "turb") takes the kinair part
    through `kinair_turb_plain` at the stage time t + adt, `t` the step's
    start time per lane."""
    turb = None
    if "turb" in xv:
        kin_dot, kin, air, xi_dyn, turb = kinair_turb_plain(
            vehicle, xv["kinematics"], xv["dynamics"], kv["kinematics"],
            kv["dynamics"], sv["geoid_N"], uv["atm"], adt, term, xv["turb"],
            kv["turb"], uv["turb"], sv["turb"], t + adt,
            vehicle.terrain.terrain_data(uv["trn"]).elevation)
    else:
        kin_dot, kin, air, xi_dyn = C["kinair"](
            xv["kinematics"], xv["dynamics"], kv["kinematics"],
            kv["dynamics"], sv["geoid_N"], uv["atm"], adt, term)
    sys_dot, mp_b, wr_b, hr_b = C["systems"](
        vehicle, xv["systems"], kv["systems"], uv["systems"], sv["systems"],
        uv["trn"], kin, air, adt, term)
    dyn_dot = C["dynamics"](xi_dyn, mp_b, wr_b, hr_b, kin.q_eb, kin.r_eb_e,
                            term)
    out = {"kinematics": kin_dot, "dynamics": dyn_dot, "systems": sys_dot}
    if turb is not None:
        out["turb"] = turb
    return out


def step_time(t_start, i, dt, like):
    """t_start + (i + 1) dt in `like`'s dtype, the new time of a step from
    counter i as `Simulation.step` forms it (`sim.py:322`)."""
    return t_start + (i + 1).to(like.dtype) * dt


def finish_clusters(C, vehicle, xv, ksum, uv, sv, terminated, dt, c_kin,
                    i=None, t_start=0.0):
    """The RK4 combine x + dt/6 ksum (compensated on q_ew / h_e with the
    residuals `c_kin`, or None) and World.f_step through the cluster
    functions `C`: finish_kin -> finish_sys -> the terminated latch,
    `finish_lane` of `clusterstep.py:97-103`. Returns (xv, s_sys,
    terminated, c_kin, kin_y, sys_y): for the fly-by-wire C172 kin_y and
    sys_y are what its avionics read of the new state (the KIN_Y and SYS_Y
    fields, `vehicle_y` assembles the VehicleY), None for the mechanical
    one. A turbulent vehicle takes the finish_kin part through
    `finish_kin_turb_plain` at the new time (`step_time` of the step
    counter `i`), and its drive is redrawn (`DrydenTurbulence.f_step`, on
    every lane, terminated or not, as World.f_step does): then a seventh
    value, the new s["turb"], follows, and xv holds the new filter
    states."""
    turb = "turb" in xv
    if turb:
        x_kin2, x_dyn2, kin2, air2, c_kin2, x_turb2 = finish_kin_turb_plain(
            vehicle, xv["kinematics"], xv["dynamics"], ksum["kinematics"],
            ksum["dynamics"], sv["geoid_N"], uv["atm"], dt, c_kin, xv["turb"],
            ksum["turb"], uv["turb"], sv["turb"],
            step_time(t_start, i, dt, xv["kinematics"]["h_e"]),
            vehicle.terrain.terrain_data(uv["trn"]).elevation)
    else:
        x_kin2, x_dyn2, kin2, air2, c_kin2 = C["finish_kin"](
            xv["kinematics"], xv["dynamics"], ksum["kinematics"],
            ksum["dynamics"], sv["geoid_N"], uv["atm"], dt, c_kin)
    x_sys2, s_sys2, sys_y = C["finish_sys"](
        vehicle, xv["systems"], ksum["systems"], uv["systems"],
        sv["systems"], uv["trn"], kin2, air2, dt)
    xv2 = {"kinematics": x_kin2, "dynamics": x_dyn2, "systems": x_sys2}
    kin_y = None
    if sys_y is not None:
        kin_y = {k: (air2.EAS if k == "EAS" else getattr(kin2, k))
                 for k, _ in KIN_Y}
    out = (xv2, s_sys2, terminated | s_sys2["crashed"], c_kin2, kin_y, sys_y)
    if not turb:
        return out
    xv2["turb"] = x_turb2
    return out + (vehicle.turbulence.f_step(uv["turb"], sv["turb"]),)


def vehicle_truth(vehicle, xv, uv, sv, t, systems_fn=None):
    """(KinData, AirData, DynamicsY) at the state xv itself (the stage
    state with a zero offset) and time `t`, as `Vehicle.f_ode` forms them
    (`aircraftbase.py:215-241`): the kinematics, the air data (disturbed
    by the gust at `t` on a turbulent vehicle), the systems' wrench and
    mass through `systems_fn` (`systems_plain`, or the `systems` wrapper)
    and the dynamics' outputs, f_c_c, alpha_ib_b and the summed mass."""
    zero = tree_map(torch.zeros_like, xv)
    term = torch.zeros_like(xv["kinematics"]["h_e"])
    if vehicle.turbulence is not None:
        _, kin, air, xi_dyn, _ = kinair_turb_plain(
            vehicle, xv["kinematics"], xv["dynamics"], zero["kinematics"],
            zero["dynamics"], sv["geoid_N"], uv["atm"], 0.0, term,
            xv["turb"], zero["turb"], uv["turb"], sv["turb"], t,
            vehicle.terrain.terrain_data(uv["trn"]).elevation)
    else:
        _, kin, air, xi_dyn = kinair_plain(
            xv["kinematics"], xv["dynamics"], zero["kinematics"],
            zero["dynamics"], sv["geoid_N"], uv["atm"], 0.0, term)
    _, mp_b, wr_b, hr_b = (systems_fn or systems_plain)(
        vehicle, xv["systems"], zero["systems"], uv["systems"], sv["systems"],
        uv["trn"], kin, air, 0.0, term)
    dyn = _DYN.output(xi_dyn, DynamicsU(mp_sum_b=mp_b, wr_sum_b=wr_b,
                                        ho_sum_b=hr_b, q_eb=kin.q_eb,
                                        r_eb_e=kin.r_eb_e))
    return kin, air, dyn


def world_output(world, state):
    """`Simulation.output` on a fleet as far as the loads read it: the
    world's derivative at `state` (time state.t, the stage state the state
    itself) through the plain clusters, and the dynamics' specific force at
    the CoM. Returns an AircraftY whose vehicle holds the KinData, the
    AirData and the DynamicsY."""
    from flightjax_torch.physics.aircraftbase import AircraftY
    kin, air, dyn = vehicle_truth(world.aircraft.vehicle, state.x["vehicle"],
                                  state.u["vehicle"], state.s["vehicle"],
                                  state.t)
    return AircraftY(vehicle=VehicleY(systems=None, kinematics=kin,
                                      dynamics=dyn, airflow=air),
                     avionics=None)


def vehicle_y(vehicle, xv, uv, kin_y, sys_y, eng_state=None):
    """The VehicleY the avionics read at the new state `xv`, from what the
    finish kernels store: `kin_y` the KIN_Y fields (and the n-vector where
    the guidance reads it), `sys_y` the SYS_Y ones, `eng_state` the
    engine's state machine of the new S_SYS (where a mission reads it).
    The servo commands and positions, the filters, the engine's speed
    ratio, omega_eb_b and h_e are the state's and the inputs' own
    (`common.systems_y`); the KinData and AirData fields no avionics reads
    are None."""
    kin = KinData(**dict(dict.fromkeys(KinData._fields),
                         omega_eb_b=xv["dynamics"]["omega_eb_b"],
                         h_e=xv["kinematics"]["h_e"],
                         **{k: v for k, v in kin_y.items() if k != "EAS"}))
    air = AirData(**dict(dict.fromkeys(AirData._fields), EAS=kin_y["EAS"]))
    sys_ = systems_y(vehicle.systems, xv["systems"], uv["systems"],
                     sys_y["alpha"], sys_y["beta"], sys_y["wow"], eng_state)
    return VehicleY(systems=sys_, kinematics=kin, dynamics=None,
                    airflow=air)


def ctl_y(vy):
    """The CTL_Y fields of a VehicleY: what the control laws read."""
    k, sy = vy.kinematics, vy.systems
    aero = sy.aero
    return {"omega_wb_b": k.omega_wb_b, "omega_eb_b": k.omega_eb_b,
            "e_nb": k.e_nb, "v_eb_n": k.v_eb_n, "chi_gnd": k.chi_gnd,
            "EAS": vy.airflow.EAS, "h_e": k.h_e, "alpha": aero.alpha,
            "beta": aero.beta, "alpha_filt": aero.alpha_filt,
            "beta_filt": aero.beta_filt, "n": sy.pwp.engine.n,
            "cmd": {ch: sy.act["cmd"][ch] for ch in CTL_CMD},
            "pos": {ch: sy.act["pos"][ch] for ch in CTL_CMD},
            "wow": sy.ldg.strut.wow}


def gdc_y(vy):
    """The GDC_Y fields of a VehicleY: what the guidance and the control
    laws read."""
    return dict(ctl_y(vy), n_e=vy.kinematics.n_e)


def msn_y(vy):
    """The MSN_Y fields of a VehicleY: what a mission's phase machine, the
    guidance and the control laws read."""
    return dict(gdc_y(vy), eng_state=vy.systems.pwp.engine.state)


def msn_nav_y(vy):
    """The MSN_NAV_Y fields of a VehicleY: MSN_Y and the orthometric height
    the radar gate reads."""
    return dict(msn_y(vy), h_o=vy.kinematics.h_o)


def ctl_vehicle_y(y):
    """The VehicleY that holds the CTL_Y (or GDC_Y, MSN_Y, MSN_NAV_Y)
    fields `y` (the others None)."""
    kin = KinData(**dict(dict.fromkeys(KinData._fields), **{
        k: y[k] for k in ("omega_wb_b", "omega_eb_b", "e_nb", "v_eb_n",
                          "chi_gnd", "h_e", "n_e", "h_o") if k in y}))
    air = AirData(**dict(dict.fromkeys(AirData._fields), EAS=y["EAS"]))
    sys_ = SystemsY(act={"cmd": y["cmd"], "pos": y["pos"]},
                    aero=AeroY(y["alpha"], y["beta"], y["alpha_filt"],
                               y["beta_filt"]),
                    ldg=LdgY(strut=StrutWow(wow=y["wow"])),
                    pwp=ThrusterY(engine=EngineY(n=y["n"],
                                                 state=y.get("eng_state"))))
    return VehicleY(systems=sys_, kinematics=kin, dynamics=None,
                    airflow=air)


def ctl_laws_plain(avionics, y, u_av, s_av, dt):
    """The control laws' periodic pass on the CTL_Y fields `y`:
    `ControlLaws.f_periodic` and the commands `assign` writes. Returns
    (the new avionics state, {channel: command} of CTL_CMD)."""
    s2, av_y = avionics.f_periodic(s_av, u_av, ctl_vehicle_y(y), dt)
    return s2, _commands(av_y)


def _commands(ctl_y):
    return {"aileron": ctl_y.lat.aileron_cmd,
            "elevator": ctl_y.lon.elevator_cmd,
            "rudder": ctl_y.lat.rudder_cmd,
            "throttle": ctl_y.lon.throttle_cmd}


def gdc_ctl_laws_plain(avionics, y, u_av, s_av, dt):
    """The C172Xv2's periodic pass on the GDC_Y fields `y`:
    `Avionics.f_periodic` (the guidance, then the control laws on the
    requests it overrides) and the commands `assign` writes. Returns (the
    new avionics state, {channel: command} of CTL_CMD, the GDC_YOUT fields
    of the guidance's GdcY)."""
    s2, av_y = avionics.f_periodic(s_av, u_av, ctl_vehicle_y(y), dt)
    g = av_y["gdc"]
    return s2, _commands(av_y["ctl"]), {k: getattr(g, k)
                                        for k, _ in GDC_YOUT}


def msn_usys(u_sys):
    """The MSN_USYS fields of the systems' inputs (those a mission's phases
    may override)."""
    return {"act": {k: u_sys["act"][k] for k in ("flaps", "brake_left",
                                                 "brake_right")},
            "pwp": {"engine": {"start": u_sys["pwp"]["engine"]["start"]}}}


def msn_ctl_laws_plain(avionics, y, u_av, s_av, dt, u_sys):
    """A scripted mission's periodic pass on the MSN_Y fields `y` and the
    systems' inputs `u_sys` (their MSN_USYS fields are read):
    `MissionAvionics.f_periodic` (the current phase's overrides, its
    predicate, the guidance and the control laws on the overridden inputs)
    and `assign` (the commands, then the new phase's systems overrides).
    Returns (the new avionics state, {channel: command} of CTL_CMD, the
    GDC_YOUT fields of the guidance's GdcY, the MSN_USYS fields after
    `assign`)."""
    s2, av_y = avionics.f_periodic(s_av, u_av, ctl_vehicle_y(y), dt)
    sys2 = avionics.assign(msn_usys(u_sys), av_y)
    g = av_y["inner"]["gdc"]
    return (s2, _commands(av_y["inner"]["ctl"]),
            {k: getattr(g, k) for k, _ in GDC_YOUT}, msn_usys(sys2))


# the sensor-fed mission's pass is the same function on the MSN_NAV_Y
# fields, whose estimated h_o the radar gate reads
msn_nav_ctl_laws_plain = msn_ctl_laws_plain


def rk4_stage_plain(vehicle, xv, kv, uv, sv, term, adt, t=None):
    """The plain clusters composed as `stage_lane` (with the disturbance
    chain at the stage time t + adt on the turbulent vehicle)."""
    return stage_clusters(PLAIN, vehicle, xv, kv, uv, sv, term, adt, t)


def rk4_finish_plain(vehicle, xv, ksum, uv, sv, terminated, dt, c_kin=None,
                     i=None, t_start=0.0):
    """The plain clusters composed as `finish_lane`, with `comp_add` when
    residuals are carried: (xv, s_sys, terminated, c_kin, kin_y, sys_y),
    kin_y and sys_y None for the mechanical C172; on the turbulent vehicle
    the disturbed air data at the new time of step counter `i` and the
    redrawn drive, the new s["turb"], as a seventh value."""
    return finish_clusters(PLAIN, vehicle, xv, ksum, uv, sv, terminated, dt,
                           c_kin, i, t_start)


# ------------------------------------------------------------ wrappers

def _term(term, like):
    return term.to(like.dtype) if term.dtype == torch.bool else term


def pack_kinair(x_kin, x_dyn, k_kin, k_dyn, geoid_N, u_atm, adt, term):
    """(packed input, output rows, scalar arguments, other operands) of
    the kinair kernel; the other pack_* functions alike."""
    buf = pack(KINAIR_IN, (x_kin, x_dyn, k_kin, k_dyn, {"geoid_N": geoid_N},
                           u_atm, {"term": _term(term, geoid_N)}),
               geoid_N.shape[0])
    return buf, rows(KINAIR_OUT), (float(adt),), {}


def pack_dynamics(xi_dyn, mp_b, wr_b, hr_b, q_eb, r_eb_e, term):
    B = r_eb_e.shape[0]
    mp = {"m": torch.broadcast_to(mp_b.m, (B,)),
          "J": torch.broadcast_to(mp_b.J, (B, 3, 3)), "r_OG": mp_b.r_OG}
    buf = pack(DYN_IN, (xi_dyn, mp, wr_b, {
        "hr_b": hr_b, "q_eb": q_eb, "r_eb_e": r_eb_e,
        "term": _term(term, r_eb_e)}), B)
    return buf, rows(DYN_OUT), (), {}


def pack_finish_kin(x_kin, x_dyn, ksum_kin, ksum_dyn, geoid_N, u_atm, dt,
                    c_kin=None):
    comp = c_kin is not None
    if not comp:
        c_kin = {"q_ew": torch.zeros_like(x_kin["q_ew"]),
                 "h_e": torch.zeros_like(x_kin["h_e"])}
    buf = pack(FIN_IN, (x_kin, x_dyn, ksum_kin, ksum_dyn,
                        {"geoid_N": geoid_N}, u_atm, c_kin),
               geoid_N.shape[0])
    return buf, rows(FIN_OUT), (dt / 6.0, int(comp)), {}


def _trn(vehicle, u_trn, B):
    trn = vehicle.terrain.terrain_data(u_trn)
    return {"elevation": trn.elevation.expand(B),
            "normal": trn.normal.expand(B, 3), "surface": trn.surface}


def pack_systems(vehicle, x_sys, k_sys, u_sys, s_sys, u_trn, kin, air, adt,
                 term):
    lay = layout_of(vehicle)
    B, dt = kin.h_e.shape[0], kin.h_e.dtype
    buf = pack(lay.sys_in, (x_sys, k_sys, u_sys, s_sys,
                            _trn(vehicle, u_trn, B), kin, air,
                            {"term": _term(term, kin.h_e)}), B, dt)
    return buf, rows(lay.sys_out), (float(adt),), {
        "params": system_params(vehicle)}


def pack_finish_sys(vehicle, x_sys, ksum_sys, u_sys, s_sys, u_trn, kin, air,
                    dt):
    lay = layout_of(vehicle)
    B = kin.h_e.shape[0]
    buf = pack(lay.fsys_in, (x_sys, ksum_sys, u_sys, s_sys,
                             _trn(vehicle, u_trn, B), kin, air), B,
               kin.h_e.dtype)
    return buf, rows(lay.fsys_out), (dt / 6.0,), {
        "params": system_params(vehicle)}


def _x(xv):
    return (xv["kinematics"], xv["dynamics"], xv["systems"]) + (
        (xv["turb"],) if "turb" in xv else ())


def _x_tree(views):
    x = {"kinematics": views[0], "dynamics": views[1], "systems": views[2]}
    if len(views) > 3:
        x["turb"] = views[3]
    return x


def pack_vehicle(vehicle, xv, uv, sv, terminated, c_kin=None, t=None):
    """The whole vehicle as one `[X; CTX; C]` buffer (`rkfin_in` of its
    layout) in the state's dtype, C zero without residuals; the turbulent
    vehicle's holds the start time `t` before C. `rk4_stage` reads its
    first `rows(stage_in)` rows, `rk4_finish` all of them."""
    lay = layout_of(vehicle)
    like = xv["kinematics"]["h_e"]
    if c_kin is None:
        c_kin = {"q_ew": torch.zeros_like(xv["kinematics"]["q_ew"]),
                 "h_e": torch.zeros_like(like)}
    B = like.shape[0]
    turb = ((uv["turb"], sv["turb"], {"t": t}) if lay.turb else ())
    return pack(lay.rkfin_in, (*_x(xv), uv["systems"], uv["atm"],
                               _trn(vehicle, uv["trn"], B), sv["systems"],
                               {"geoid_N": sv["geoid_N"]},
                               {"terminated": terminated}, *turb, c_kin), B,
                like.dtype)


def pack_turb_int(i, uv, sv):
    """The int32 `[3, B]` rows TURB_INT of the turbulent vehicle: the step
    counter, the stream's seed and the drive's counter."""
    return torch.stack([i, uv["turb"]["seed"], sv["turb"]["n"]]).to(
        torch.int32).contiguous()


def unpack_vehicle(buf, lay=MECH, ints=None):
    """(xv, uv, sv, terminated, c_kin, t) from a `pack_vehicle` buffer of
    layout `lay`, or from its first `rows(stage_in)` rows (c_kin None
    then); bool and int leaves typed again, terrain constants dropped. The
    turbulent layout's seed and drive counter come from `ints`, its
    TURB_INT rows; t is None for the others."""
    v = unpack(lay.rkfin_in if buf.shape[0] == rows(lay.rkfin_in)
               else lay.stage_in, buf, typed=True)
    nx = len(lay.x_groups)
    x, (u_sys, u_atm, trn, s_sys, geo, term, *more) = v[:nx], v[nx:]
    uv = {"systems": u_sys, "atm": u_atm, "trn": {"surface": trn["surface"]}}
    sv = {"systems": s_sys, "geoid_N": geo["geoid_N"]}
    t = None
    if lay.turb:
        u_turb, s_turb, t_row, *more = more
        uv["turb"] = dict(u_turb, seed=ints[1])
        sv["turb"] = dict(s_turb, n=ints[2])
        t = t_row["t"]
    return (_x_tree(x), uv, sv, term["terminated"],
            more[0] if more else None, t)


def pack_rk4_stage(vehicle, xv, kv, uv, sv, term, adt, t=None):
    lay = layout_of(vehicle)
    buf = pack_vehicle(vehicle, xv, uv, sv, term, t=t)[:rows(lay.stage_in)]
    k = pack(lay.x_groups, _x(kv), buf.shape[1], buf.dtype)
    return buf, rows(lay.stage_out), (float(adt),), {
        "k": k, "params": system_params(vehicle)}


def pack_rk4_finish(vehicle, xv, ksum, uv, sv, terminated, dt, c_kin=None,
                    i=None, t_start=0.0):
    lay = layout_of(vehicle)
    buf = pack_vehicle(vehicle, xv, uv, sv, terminated, c_kin,
                       t=torch.zeros_like(xv["kinematics"]["h_e"])
                       if lay.turb else None)
    k = pack(lay.x_groups, _x(ksum), buf.shape[1], buf.dtype)
    ops = {"k": k, "params": system_params(vehicle)}
    scalars = (dt / 6.0, int(c_kin is not None))
    if lay.turb:
        ops["ints"] = pack_turb_int(i, uv, sv)
        scalars += (float(dt), float(t_start))
    return buf, rows(lay.rkfin_out), scalars, ops


def pack_ctl_laws(avionics, y, u_av, s_av, dt):
    like = y["EAS"]
    buf = pack(CTL_IN, (y, u_av["lon"], u_av["lat"], s_av["lon"],
                        s_av["lat"]), like.shape[0], like.dtype)
    return buf, rows(CTL_OUT), (float(dt),), {
        "gains": ctl_gains(avionics)}


def pack_gdc_ctl_laws(avionics, y, u_av, s_av, dt):
    like = y["EAS"]
    ctl_u, ctl_s = u_av["ctl"], s_av["ctl"]
    buf = pack(GDC_IN, (y, ctl_u["lon"], ctl_u["lat"], ctl_s["lon"],
                        ctl_s["lat"], u_av["gdc"]), like.shape[0], like.dtype)
    return buf, rows(GDC_OUT), (float(dt),), {"gains": ctl_gains(avionics)}


def pack_msn_ctl_laws(avionics, y, u_av, s_av, dt, u_sys, groups=MSN_IN):
    like = y["EAS"]
    ctl_u, ctl_s = u_av["ctl"], s_av["inner"]["ctl"]
    buf = pack(groups, (y, ctl_u["lon"], ctl_u["lat"], ctl_s["lon"],
                        ctl_s["lat"], u_av["gdc"], s_av, u_sys),
               like.shape[0], like.dtype)
    return buf, rows(MSN_OUT), (float(dt),), {"gains": ctl_gains(avionics)}


def pack_msn_nav_ctl_laws(avionics, y, u_av, s_av, dt, u_sys):
    return pack_msn_ctl_laws(avionics, y, u_av, s_av, dt, u_sys, MSN_NAV_IN)


def pack_geoid(geo, q_ew):
    buf = pack(GEOID_IN, ({"q_ew": q_ew},), q_ew.shape[0])
    return buf, rows(GEOID_OUT), (), {"grid": geoid_grid(geo)}


PACK = {"kinair": pack_kinair, "dynamics": pack_dynamics,
        "finish_kin": pack_finish_kin, "systems": pack_systems,
        "finish_sys": pack_finish_sys, "rk4_stage": pack_rk4_stage,
        "rk4_finish": pack_rk4_finish, "geoid": pack_geoid,
        "ctl_laws": pack_ctl_laws, "gdc_ctl_laws": pack_gdc_ctl_laws,
        "msn_ctl_laws": pack_msn_ctl_laws,
        "msn_nav_ctl_laws": pack_msn_nav_ctl_laws}
# the fly-by-wire instances pack as their mechanical twins (by the
# vehicle's layout)
PACK.update({FBW.names[k]: PACK[k] for k in FBW.names})
PACK.update({lay.names[k]: PACK[k] for lay in (TURB, FBW_TURB)
             for k in ("rk4_stage", "rk4_finish")})


# instance name -> (kernel, layout)
_INSTANCES = {n: (k, lay) for lay in (MECH, FBW)
              for k, n in dict(lay.names, megakernel=lay.mega_name).items()}
_INSTANCES.update({lay.names[k]: (k, lay) for lay in (TURB, FBW_TURB)
                   for k in ("rk4_stage", "rk4_finish")})
for _lay in (TURB, FBW_TURB, GDC, MSN, GDC_TURB, MSN_TURB, FBW_NAV,
             FBW_TURB_NAV, GDC_NAV, MSN_NAV, GDC_TURB_NAV, MSN_TURB_NAV):
    _INSTANCES[_lay.mega_name] = ("megakernel", _lay)
_A2_LAYOUTS = {}


def a2_layout(a2):
    """The layout of the calm C172Xv1 whose channels `a2` (in FBW_CHANNELS
    order) carry second-order servos, made and registered once: its
    instances pack and unpack as the fly-by-wire ones."""
    lay = _A2_LAYOUTS.get(a2)
    if lay is None:
        lay = _A2_LAYOUTS[a2] = _layout(True, a2=a2)
        for k, n in dict(lay.names, megakernel=lay.mega_name).items():
            _INSTANCES[n] = (k, lay)
            if k in PACK:
                PACK[n] = PACK[k]
    return lay


# the C172Xv1 with a second-order servo on the elevator
FBW_A2 = a2_layout(A2_CARD)


def a2_refusal(lay, kernels):
    """Why the card has no instance of each of `kernels` (the kernels'
    names, "megakernel" among them) for the layout `lay`, as the exception
    to raise, or None: the card carries second-order servos on the
    elevator alone (A2_CARD), in the whole-vehicle kernels and the
    megakernel; the subsystems split's instances over them and every other
    channel set fly the plain path only (ROADMAP Queue 2)."""
    if not lay.a2:
        return None
    if lay.a2 != A2_CARD:
        return ValueError(
            f"the kernels on the card carry a second-order servo on the "
            f"elevator alone, not on {list(lay.a2)}: such a vehicle flies "
            f"the plain path (the CPU); ROADMAP Queue 2, 'Actuator2 "
            f"channels in the kernels'")
    names = dict(lay.names, megakernel=lay.mega_name)
    missing = [names[k] for k in kernels if names[k] not in L.KERNELS]
    if missing:
        return NotImplementedError(
            f"the card has no {' and no '.join(missing)} yet (ROADMAP Queue "
            f"2, 'Actuator2 channels in the kernels'): the C172Xv1 with a "
            f"second-order elevator flies make_cluster_step(split="
            f"'vehicle') and make_megakernel_step on the card, "
            f"Simulation.fleet_step on the CPU")
    return None


def _card_kernel(name):
    """Raise where the card has no kernel instance `name`: over second-order
    servos, `a2_refusal` naming every instance of its layout the card
    lacks (the subsystems split's two)."""
    if name not in L.KERNELS:
        _, lay = _INSTANCES.get(name, (name, MECH))
        raise (a2_refusal(lay, (*lay.names, "megakernel"))
               or ValueError(f"no kernel {name}"))


def _av_tree(d):
    """An unpacked lon or lat avionics group with its controller states as
    the NamedTuples of `physics/control.py`."""
    return {k: (_AV_STATES[AV_PRIMITIVES[k]][0](**v) if k in AV_PRIMITIVES
                else v) for k, v in d.items()}


def _gdc_tree(d):
    """An unpacked AV_U_GDC group with its segment and circle as the
    NamedTuples of `models/c172/c172x_gdc.py`."""
    return dict(d, target=Segment(**d["target"]), orbit=Circle(**d["orbit"]))


def av_groups(lay):
    """The row groups of the avionics' block of `lay`'s megakernel buffer
    (after t, X, CTX and C)."""
    return lay.mega[2 + len(lay.x_groups) + len(lay.ctx_groups):]


def pack_avionics(lay, u_av, s_av, B, dtype):
    """The avionics' inputs and state as the rows of `av_groups(lay)`: u
    lon, u lat, s lon, s lat (of the control laws), then on the C172Xv2 the
    guidance's inputs, then a mission's phase and clock; around the
    navigation avionics (their inner avionics' rows first) their NAV_U and
    NAV_S rows (their integers in `pack_nav_int`)."""
    if lay.nav and lay.pass_name == "msn_nav_ctl_laws":
        u_in, s_msn = u_av["inner"], s_av["inner"]
        s_ctl = s_msn["inner"]["ctl"]
        objs = (u_in["ctl"]["lon"], u_in["ctl"]["lat"], s_ctl["lon"],
                s_ctl["lat"], u_in["gdc"], s_msn, u_av, s_av)
    elif lay.nav and lay.pass_name == "gdc_ctl_laws":
        u_in, s_ctl = u_av["inner"], s_av["inner"]["ctl"]
        objs = (u_in["ctl"]["lon"], u_in["ctl"]["lat"], s_ctl["lon"],
                s_ctl["lat"], u_in["gdc"], u_av, s_av)
    elif lay.nav:
        objs = (u_av["inner"]["lon"], u_av["inner"]["lat"],
                s_av["inner"]["lon"], s_av["inner"]["lat"], u_av, s_av)
    elif lay.pass_name == "msn_ctl_laws":
        s_ctl = s_av["inner"]["ctl"]
        objs = (u_av["ctl"]["lon"], u_av["ctl"]["lat"], s_ctl["lon"],
                s_ctl["lat"], u_av["gdc"], s_av)
    elif lay.pass_name == "gdc_ctl_laws":
        objs = (u_av["ctl"]["lon"], u_av["ctl"]["lat"], s_av["ctl"]["lon"],
                s_av["ctl"]["lat"], u_av["gdc"])
    else:
        objs = (u_av["lon"], u_av["lat"], s_av["lon"], s_av["lat"])
    return pack(av_groups(lay), objs, B, dtype)


def pack_nav_int(u_av, s_av):
    """The NAV_INT rows of the navigation avionics, an int32 `[11, B]`
    tensor: the sensors' seed and epoch, the fault's channel, mode, k0 and
    k1, each monitor's bit register (its uint32 in int32)."""
    rows_ = []
    for key, side in NAV_INT:
        v = _get(u_av if side == "u" else s_av, key).to(torch.int64)
        rows_.append(torch.where(v >= 2 ** 31, v - 2 ** 32, v))
    return torch.stack(rows_).to(torch.int32).contiguous()


def _nav_trees(u_nav, s_nav, ints):
    """The navigation avionics' u and s (but their "inner") from the
    unpacked NAV_U and NAV_S groups and the NAV_INT rows `ints`."""
    from flightjax_torch.utils.estimation import InsGpsState
    u_nav, s_nav = dict(u_nav), dict(s_nav)
    for (key, side), v in zip(NAV_INT, ints):
        v = v.to(torch.int64) & 0xFFFFFFFF if key[1] == "bits" else v
        node = u_nav if side == "u" else s_nav
        node[key[0]] = dict(node.get(key[0], {}), **{key[1]: v})
    s_nav["nav"] = InsGpsState(**s_nav["nav"])
    return u_nav, s_nav


def unpack_avionics(lay, buf, ints=None):
    """(u_av, s_av) of the rows `pack_avionics` writes, typed again; the
    navigation avionics' integers from their NAV_INT rows `ints`."""
    u_lon, u_lat, s_lon, s_lat, *more = unpack(av_groups(lay), buf,
                                               typed=True)
    u_av = {"lon": u_lon, "lat": u_lat}
    s_av = {"lon": _av_tree(s_lon), "lat": _av_tree(s_lat)}
    if lay.nav:
        if lay.pass_name == "msn_nav_ctl_laws":
            u_gdc, s_msn, *more = more
            u_av, s_av = {"ctl": u_av, "gdc": _gdc_tree(u_gdc)}, {
                "inner": {"ctl": s_av}, **s_msn}
        elif lay.pass_name == "gdc_ctl_laws":
            u_gdc, *more = more
            u_av, s_av = {"ctl": u_av, "gdc": _gdc_tree(u_gdc)}, {
                "ctl": s_av}
        u_nav, s_nav = _nav_trees(*more, ints)
        return dict(u_nav, inner=u_av), dict(s_nav, inner=s_av)
    if not more:
        return u_av, s_av
    u_av = {"ctl": u_av, "gdc": _gdc_tree(more[0])}
    if len(more) > 1:
        return u_av, {"inner": {"ctl": s_av}, **more[1]}
    return u_av, {"ctl": s_av}


def mega_rows(lay, buf):
    """A `pack_vehicle` buffer of the turbulent layout ([X; CTX; t; C]) in
    the order of its megakernel's state buffer ([t; X; CTX; C])."""
    n = rows(lay.x_groups + lay.ctx_groups)
    return torch.cat([buf[n:n + 1], buf[:n], buf[n + 1:]])


def vehicle_rows(lay, mega):
    """The inverse of `mega_rows`."""
    n = rows(lay.x_groups + lay.ctx_groups)
    return torch.cat([mega[1:n + 1], mega[:1], mega[n + 1:]])


def unpack_out(name, out, comp=False, ints=None):
    """The packed output `out` of kernel instance `name` as its wrapper
    returns it (`comp`: finish_kin or rk4_finish carried residuals); bool
    and int leaves typed again. The megakernels' is their state buffer:
    (t, xv, uv, sv, terminated, c_kin, u_av, s_av), c_kin None without
    `comp`, the avionics' u and s None for the C172S. The turbulent
    instances read their integers from `ints`: the megakernel's its int32
    state rows (TURB_INT), rk4_finish_turb's the rows it was given, whose
    drive counter the new s["turb"] takes one step on."""
    base, lay = _INSTANCES.get(name, (name, MECH))
    if base == "nav_pass":
        y, s_nav, *ho = unpack(NAV_OUT_MSN if out.shape[0] == rows(
            NAV_OUT_MSN) else NAV_OUT, out, typed=True)
        return _nav_trees({}, s_nav, ints)[1], dict(y, **(ho[0] if ho
                                                         else {}))
    if base == "ctl_laws":
        s_lon, s_lat, cmd = unpack(CTL_OUT, out, typed=True)
        return {"lon": _av_tree(s_lon), "lat": _av_tree(s_lat)}, cmd
    if base == "gdc_ctl_laws":
        s_lon, s_lat, cmd, g = unpack(GDC_OUT, out, typed=True)
        return ({"ctl": {"lon": _av_tree(s_lon), "lat": _av_tree(s_lat)}},
                cmd, g)
    if base in ("msn_ctl_laws", "msn_nav_ctl_laws"):
        s_lon, s_lat, cmd, g, sm, sys_ = unpack(MSN_OUT, out, typed=True)
        return ({"inner": {"ctl": {"lon": _av_tree(s_lon),
                                   "lat": _av_tree(s_lat)}}, **sm},
                cmd, g, sys_)
    if base == "megakernel":
        # the vehicle's rows: t, X, CTX, C (the turbulent layouts keep t
        # among the vehicle's rows, `mega_rows`)
        n = rows(lay.rkfin_in) + (0 if lay.turb else 1)
        if lay.turb:
            xv, uv, sv, terminated, c_kin, t = unpack_vehicle(
                vehicle_rows(lay, out[:n]), lay, ints)
        else:
            t = out[0]
            xv, uv, sv, terminated, c_kin, _ = unpack_vehicle(out[1:n], lay)
        u_av = s_av = None
        if lay.fbw:
            u_av, s_av = unpack_avionics(
                lay, out[n:], ints[(N_TI if lay.turb else 1):]
                if lay.nav else None)
        return (t, xv, uv, sv, terminated, c_kin if comp else None, u_av,
                s_av)
    if base == "kinair":
        kin_dot, kin, air, xi_dyn = unpack(KINAIR_OUT, out)
        return kin_dot, KinData(**kin), AirData(**air), xi_dyn
    if base == "dynamics":
        return unpack(DYN_OUT, out)[0]
    if base == "finish_kin":
        x_kin, x_dyn, kin, air, c = unpack(FIN_OUT, out)
        return x_kin, x_dyn, KinData(**kin), AirData(**air), \
            (c if comp else None)
    if base == "geoid":
        return out[0]
    if base == "systems":
        dot, mp, wr, hr = unpack(lay.sys_out, out)
        return dot, MassProps(**mp), Wrench(**wr), hr["hr_b"]
    if base == "finish_sys":
        x2, s2, *y = unpack(lay.fsys_out, out, typed=True)
        return x2, s2, (y[0] if y else None)
    if base == "rk4_stage":
        return _x_tree(unpack(lay.stage_out, out))
    if base == "rk4_finish":
        v = unpack(lay.rkfin_out, out, typed=True)
        nx = len(lay.x_groups)
        s_sys, term, c = v[nx:nx + 3]
        res = (_x_tree(v[:nx]), s_sys, term["terminated"],
               c if comp else None,
               *(v[nx + 3:nx + 5] if lay.fbw else (None, None)))
        if lay.turb:
            res += (dict(v[-1], n=ints[2] + 1),)
        return res
    raise ValueError(f"no kernel {name}")


def launch_kernel(name, buf, n_out, scalars, operands, block=None):
    """Launch kernel `name` on packed operands (the form `PACK[name]`
    returns) and count the launch; raises where the card has no instance
    `name` (`a2_refusal`)."""
    _card_kernel(name)
    out = L.launch(name, buf, n_out, scalars, block=block, **operands)
    LAUNCHES[name] += 1
    return out


def _launch(name, args):
    return launch_kernel(name, *PACK[name](*args))


def _instance(name, vehicle):
    """The instance of kernel `name` for the vehicle's actuation."""
    return layout_of(vehicle).names[name]


def kinair(x_kin, x_dyn, k_kin, k_dyn, geoid_N, u_atm, adt, term):
    """`kinair_plain` on the CPU, the `kinair` CUDA kernel on the card."""
    args = (x_kin, x_dyn, k_kin, k_dyn, geoid_N, u_atm, adt, term)
    if geoid_N.device.type == "cpu":
        return kinair_plain(*args[:-1], _term(term, geoid_N))
    return unpack_out("kinair", _launch("kinair", args))


def systems(vehicle, x_sys, k_sys, u_sys, s_sys, u_trn, kin, air, adt,
            term):
    """`systems_plain` on the CPU, the `systems` CUDA kernel on the
    card."""
    args = (vehicle, x_sys, k_sys, u_sys, s_sys, u_trn, kin, air, adt, term)
    if kin.h_e.device.type == "cpu":
        return systems_plain(*args[:-1], _term(term, kin.h_e))
    name = _instance("systems", vehicle)
    return unpack_out(name, _launch(name, args))


def dynamics(xi_dyn, mp_b, wr_b, hr_b, q_eb, r_eb_e, term):
    """`dynamics_plain` on the CPU, the `dynamics` CUDA kernel on the
    card."""
    args = (xi_dyn, mp_b, wr_b, hr_b, q_eb, r_eb_e, term)
    if r_eb_e.device.type == "cpu":
        return dynamics_plain(*args[:-1], _term(term, r_eb_e))
    return unpack_out("dynamics", _launch("dynamics", args))


def _check_comp(c_kin):
    if c_kin is not None and set(c_kin) != {"q_ew", "h_e"}:
        raise ValueError("the finish compensates exactly q_ew and h_e")


def finish_kin(x_kin, x_dyn, ksum_kin, ksum_dyn, geoid_N, u_atm, dt,
               c_kin=None):
    """`finish_kin_plain` on the CPU, the `finish_kin` CUDA kernel on the
    card. `c_kin`: None or residuals for exactly {q_ew, h_e}."""
    _check_comp(c_kin)
    args = (x_kin, x_dyn, ksum_kin, ksum_dyn, geoid_N, u_atm, dt, c_kin)
    if geoid_N.device.type == "cpu":
        return finish_kin_plain(*args)
    return unpack_out("finish_kin", _launch("finish_kin", args),
                      c_kin is not None)


def finish_sys(vehicle, x_sys, ksum_sys, u_sys, s_sys, u_trn, kin, air, dt):
    """`finish_sys_plain` on the CPU, the `finish_sys` CUDA kernel on the
    card."""
    args = (vehicle, x_sys, ksum_sys, u_sys, s_sys, u_trn, kin, air, dt)
    if kin.h_e.device.type == "cpu":
        return finish_sys_plain(*args)
    name = _instance("finish_sys", vehicle)
    return unpack_out(name, _launch(name, args))


def geoid(geo, q_ew):
    """`geoid_plain` on the CPU, the `geoid` CUDA kernel on the card."""
    if q_ew.device.type == "cpu":
        return geoid_plain(geo, q_ew)
    return unpack_out("geoid", _launch("geoid", (geo, q_ew)))


def rk4_stage(vehicle, xv, kv, uv, sv, term, adt, t=None):
    """`rk4_stage_plain` on the CPU, the `rk4_stage` CUDA kernel on the
    card: the derivative of the whole vehicle at xv + adt kv (on the
    turbulent vehicle at the stage time t + adt, `t` per lane)."""
    like = xv["kinematics"]["h_e"]
    args = (vehicle, xv, kv, uv, sv, term, adt, t)
    if like.device.type == "cpu":
        return rk4_stage_plain(*args[:-3], _term(term, like), adt, t)
    name = _instance("rk4_stage", vehicle)
    return unpack_out(name, _launch(name, args))


def rk4_finish(vehicle, xv, ksum, uv, sv, terminated, dt, c_kin=None,
               i=None, t_start=0.0):
    """`rk4_finish_plain` on the CPU, the `rk4_finish` CUDA kernel on the
    card. Returns (xv, s_sys, terminated, c_kin, kin_y, sys_y), kin_y and
    sys_y None for the mechanical C172; on the turbulent vehicle, whose
    finish reads the step counter `i` and the simulation's `t_start`, the
    new s["turb"] follows."""
    _check_comp(c_kin)
    args = (vehicle, xv, ksum, uv, sv, terminated, dt, c_kin, i, t_start)
    if xv["kinematics"]["h_e"].device.type == "cpu":
        return rk4_finish_plain(*args)
    name = _instance("rk4_finish", vehicle)
    packed = PACK[name](*args)
    return unpack_out(name, launch_kernel(name, *packed), c_kin is not None,
                      packed[3].get("ints"))


def rk4_stage_packed(vehicle, buf, k, adt, block=None):
    """One RK4 stage on packed buffers: `buf` holds X; CTX
    (`rows(STAGE_IN)` rows, the start time last on the turbulent vehicle),
    `k` the previous stage's derivative; returns the stage derivative
    (`rows(STAGE_OUT)` rows). The kernel on the card (`block`: aircraft per
    block, 32 or 64), the plain stage between unpack and pack on the
    CPU."""
    lay = layout_of(vehicle)
    if buf.device.type != "cpu":
        return launch_kernel(lay.names["rk4_stage"], buf,
                             rows(lay.stage_out), (float(adt),),
                             {"k": k, "params": system_params(vehicle)},
                             block)
    return rk4_stage_packed_plain(vehicle, buf, k, adt)


def rk4_stage_packed_plain(vehicle, buf, k, adt):
    """`rk4_stage_packed`'s plain version, on any device."""
    lay = layout_of(vehicle)
    xv, uv, sv, terminated, _, t = unpack_vehicle(
        buf, lay, torch.zeros((3, buf.shape[1]), dtype=torch.int32,
                              device=buf.device))
    d = rk4_stage_plain(vehicle, xv, _x_tree(unpack(lay.x_groups, k)), uv,
                        sv, terminated.to(buf.dtype), adt, t)
    return pack(lay.stage_out, _x(d), buf.shape[1], buf.dtype)


def rk4_finish_packed(vehicle, buf, ksum, dt, comp, block=None, ints=None,
                      t_start=0.0):
    """The RK4 combine and World.f_step on packed buffers: `buf` from
    `pack_vehicle`, `ksum` the k-sum; returns X; s_sys; terminated; C
    (`rows(RKFIN_OUT)` rows, C zero unless `comp`; the drive eta last on
    the turbulent vehicle, whose finish also reads the int32 TURB_INT
    rows `ints` and `t_start`). The kernel on the card (`block`: aircraft
    per block, 32 or 64), the plain finish between unpack and pack on the
    CPU."""
    lay = layout_of(vehicle)
    if buf.device.type != "cpu":
        scalars = (dt / 6.0, int(bool(comp)))
        ops = {"k": ksum, "params": system_params(vehicle)}
        if lay.turb:
            scalars += (float(dt), float(t_start))
            ops["ints"] = ints
        return launch_kernel(lay.names["rk4_finish"], buf,
                             rows(lay.rkfin_out), scalars, ops, block)
    return rk4_finish_packed_plain(vehicle, buf, ksum, dt, comp, ints,
                                   t_start)


def rk4_finish_packed_plain(vehicle, buf, ksum, dt, comp, ints=None,
                            t_start=0.0):
    """`rk4_finish_packed`'s plain version, on any device."""
    lay = layout_of(vehicle)
    xv, uv, sv, terminated, c_kin, _ = unpack_vehicle(buf, lay, ints)
    xv2, s2, term2, c2, kin_y, sys_y, *st = rk4_finish_plain(
        vehicle, xv, _x_tree(unpack(lay.x_groups, ksum)), uv, sv, terminated,
        dt, c_kin if comp else None, None if ints is None else ints[0],
        t_start)
    if c2 is None:
        c2 = tree_map(torch.zeros_like, c_kin)
    y = (kin_y, sys_y) if lay.fbw else ()
    return pack(lay.rkfin_out, (*_x(xv2), s2, {"terminated": term2}, c2,
                                *y, *st), buf.shape[1], buf.dtype)


def ctl_laws(avionics, y, u_av, s_av, dt):
    """`ctl_laws_plain` on the CPU, the `ctl_laws` CUDA kernel on the
    card."""
    args = (avionics, y, u_av, s_av, dt)
    if y["EAS"].device.type == "cpu":
        return ctl_laws_plain(*args)
    return unpack_out("ctl_laws", _launch("ctl_laws", args))


def gdc_ctl_laws(avionics, y, u_av, s_av, dt):
    """`gdc_ctl_laws_plain` on the CPU, the `gdc_ctl_laws` CUDA kernel on
    the card."""
    args = (avionics, y, u_av, s_av, dt)
    if y["EAS"].device.type == "cpu":
        return gdc_ctl_laws_plain(*args)
    return unpack_out("gdc_ctl_laws", _launch("gdc_ctl_laws", args))


def msn_ctl_laws(avionics, y, u_av, s_av, dt, u_sys):
    """`msn_ctl_laws_plain` on the CPU, the `msn_ctl_laws` CUDA kernel on
    the card."""
    args = (avionics, y, u_av, s_av, dt, u_sys)
    if y["EAS"].device.type == "cpu":
        return msn_ctl_laws_plain(*args)
    return unpack_out("msn_ctl_laws", _launch("msn_ctl_laws", args))


def msn_nav_ctl_laws(avionics, y, u_av, s_av, dt, u_sys):
    """`msn_nav_ctl_laws_plain` on the CPU, the `msn_nav_ctl_laws` CUDA
    kernel on the card: the mission's pass on the MSN_NAV_Y fields `y`."""
    args = (avionics, y, u_av, s_av, dt, u_sys)
    if y["EAS"].device.type == "cpu":
        return msn_nav_ctl_laws_plain(*args)
    return unpack_out("msn_nav_ctl_laws", _launch("msn_nav_ctl_laws", args))


def nav_truth(truth, h_trn):
    """The NAV_T fields of a VehicleY holding the truth's KinData, AirData
    and DynamicsY (`vehicle_truth`) and the terrain's elevation."""
    k, a, d = truth.kinematics, truth.airflow, truth.dynamics
    out = {f: getattr(k, f) for f in ("omega_eb_b", "q_eb", "q_nb", "lat",
                                      "lon", "n_e", "h_e", "h_o", "v_eb_n")}
    out.update(p=a.p, pt=a.pt, T=a.T, f_c_c=d.f_c_c, alpha_ib_b=d.alpha_ib_b,
               r_OG=d.mp_sum_b.r_OG, h_trn=h_trn.expand_as(a.p))
    return out


def nav_pass_plain(nav, vy, truth, h_trn, u_av, s_av):
    """The navigation avionics' pass before the inner laws,
    `NavAvionics.nav_pass`, its aiding block skipped where no lane's own
    sensor epoch aids (`epoch_gate`; a lane without an epoch leaves it
    unchanged but for a rounding, as the kernel skips it lane by lane):
    `vy` the VehicleY the truth-fed inner laws read (with the n-vector),
    `truth` the one holding the truth the sensors read (`vehicle_truth`),
    `h_trn` the terrain's elevation. Returns (the new state but its
    "inner", the GDC_Y fields the inner laws read: the estimates, or in
    shadow mode the truth's; around a mission also the orthometric height
    h_o its radar gate reads, the estimate's or `vy`'s)."""
    s_nav, y_est, _ = nav.nav_pass(s_av, u_av, truth, h_trn,
                                   nav.epoch_gate(s_av["sens"]["n"] + 1))
    y = y_est if nav.use_estimates else vy
    out = gdc_y(y)
    if isinstance(nav.inner, MissionAvionics):
        out["h_o"] = y.kinematics.h_o
    return s_nav, out


def pack_nav_pass(nav, vy, truth, h_trn, u_av, s_av):
    like = truth.airflow.p
    buf = pack(NAV_IN, (gdc_y(vy), nav_truth(truth, h_trn), u_av, s_av),
               like.shape[0], like.dtype)
    msn = isinstance(nav.inner, MissionAvionics)
    return buf, rows(NAV_OUT_MSN if msn else NAV_OUT), (), {
        "gains": ctl_gains(nav), "ints": pack_nav_int(u_av, s_av)}


def nav_pass(nav, vy, truth, h_trn, u_av, s_av, block=None):
    """`nav_pass_plain` on the CPU, the `nav_pass` CUDA kernel on the card
    (the aiding block where each lane's own epoch aids; around a mission
    its instance that also writes the h_o row)."""
    args = (nav, vy, truth, h_trn, u_av, s_av)
    if h_trn.device.type == "cpu":
        return nav_pass_plain(*args)
    buf, n_out, _, ops = pack_nav_pass(*args)
    out, ints = L.launch_nav_pass(buf, n_out, ops["ints"], ops["gains"],
                                  normal_table(buf.device), block,
                                  ho=n_out == rows(NAV_OUT_MSN))
    LAUNCHES["nav_pass"] += 1
    return unpack_out("nav_pass", out, ints=ints)


def geoid_packed(geo, q_rows, block=None):
    """The undulation `[1, B]` under the q_ew rows `[4, B]`: the kernel on
    the card, `geoid_plain` on the CPU."""
    if q_rows.device.type != "cpu":
        return launch_kernel("geoid", q_rows, rows(GEOID_OUT), (),
                             {"grid": geoid_grid(geo)}, block)
    return geoid_plain(geo, q_rows.t()).reshape(1, -1)


def launch_megakernel(vehicle, bufs, dt, t_start, comp, block=None,
                      avionics=None, spp=1, periodic_dt=0.0):
    """One launch of the whole-step kernel on the resident (state, i)
    buffers of `parallel/megakernel.py`; returns the new buffers. `block`
    is the aircraft per block, 32 or 64. With the fly-by-wire vehicle the
    instance `megakernel_fbw`, which also runs the `avionics`' (the control
    laws') periodic pass every `spp` steps at their `periodic_dt`, with the
    C172Xv2's avionics `megakernel_gdc`, whose pass runs the guidance
    first, or with a mission over them `megakernel_msn`, whose pass runs
    the phase machine first; with the turbulent C172S `megakernel_turb`,
    whose int32 buffer holds (i, seed, n), and with the turbulent C172Xv1
    `megakernel_fbw_turb`, the turbulent C172Xv2 `megakernel_gdc_turb` or
    a mission on it `megakernel_msn_turb`, whose int32 buffers hold them
    too; with the navigation avionics around the C172Xv1's control laws
    `megakernel_nav` (`megakernel_nav_turb` in turbulence), around the
    C172Xv2's guidance and control laws `megakernel_gdc_nav`
    (`megakernel_gdc_nav_turb`), around a mission over them
    `megakernel_msn_nav` (`megakernel_msn_nav_turb`), whose int32 buffer
    holds the NAV_INT rows after those and which reads the sensors' normal
    table (`ops/random.normal_table`); with a second-order servo on the
    elevator `megakernel_fbw_a2` (the control laws' pass as in
    `megakernel_fbw`; another channel set is refused, `a2_refusal`)."""
    lay = layout_of(vehicle, avionics)
    name = lay.mega_name
    _card_kernel(name)
    out = L.launch_megakernel(
        bufs[0], bufs[1], system_params(vehicle), geoid_grid(vehicle.geoid),
        dt, t_start, comp, block,
        None if avionics is None else ctl_gains(avionics), spp, periodic_dt,
        gdc=lay.pass_name == "gdc_ctl_laws",
        msn=lay.pass_name in ("msn_ctl_laws", "msn_nav_ctl_laws"),
        turb=lay.turb,
        table=normal_table(bufs[0].device) if lay.nav else None,
        a2=bool(lay.a2))
    LAUNCHES[name] += 1
    return out


WRAPPERS = {"kinair": kinair, "systems": systems, "dynamics": dynamics,
            "finish_kin": finish_kin, "finish_sys": finish_sys}
PLAIN = {"kinair": kinair_plain, "systems": systems_plain,
         "dynamics": dynamics_plain, "finish_kin": finish_kin_plain,
         "finish_sys": finish_sys_plain}


def operand_args(d, vehicle, device, dtype, adt=0.01, dt=0.02):
    """Positional arguments of each kernel's wrapper (the megakernel's
    aside) from a numpy operand dict (`flightjax_torch.testing.
    cluster_operands`), on `device`; the systems clusters take KinData and
    AirData from `kinair_plain` at the stage state."""
    from flightjax_torch.bridge import tree_from_numpy
    t = {k: tree_from_numpy(v, device, dtype) for k, v in d.items()}
    args = {
        "kinair": (t["x_kin"], t["x_dyn"], t["k_kin"], t["k_dyn"],
                   t["geoid_N"], t["u_atm"], adt, t["term"]),
        "dynamics": (t["x_dyn"], MassProps(**t["mp"]), Wrench(**t["wr"]),
                     t["hr"], t["q_eb"], t["r_eb_e"], t["term"]),
        "finish_kin": (t["x_kin"], t["x_dyn"], t["ksum_kin"], t["ksum_dyn"],
                       t["geoid_N"], t["u_atm"], dt, t["c_kin"]),
    }
    _, kin, air, _ = kinair_plain(*args["kinair"])
    args["systems"] = (vehicle, t["x_sys"], t["k_sys"], t["u_sys"],
                       t["s_sys"], t["u_trn"], kin, air, adt, t["term"])
    args["finish_sys"] = (vehicle, t["x_sys"], t["ksum_sys"], t["u_sys"],
                          t["s_sys"], t["u_trn"], kin, air, dt)
    xv = {"kinematics": t["x_kin"], "dynamics": t["x_dyn"],
          "systems": t["x_sys"]}
    uv = {"systems": t["u_sys"], "atm": t["u_atm"], "trn": t["u_trn"]}
    sv = {"systems": t["s_sys"], "geoid_N": t["geoid_N"]}
    k = {"kinematics": t["k_kin"], "dynamics": t["k_dyn"],
         "systems": t["k_sys"]}
    ksum = {"kinematics": t["ksum_kin"], "dynamics": t["ksum_dyn"],
            "systems": t["ksum_sys"]}
    args["rk4_stage"] = (vehicle, xv, k, uv, sv, t["term"], adt)
    args["rk4_finish"] = (vehicle, xv, ksum, uv, sv, t["term"] > 0.5, dt,
                          t["c_kin"])
    args["geoid"] = (vehicle.geoid, t["q_globe"])
    return args


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
