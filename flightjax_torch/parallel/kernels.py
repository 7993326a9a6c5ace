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
                  and `megakernel_fbw`, its instance on the C172Xv1 with
                  the control laws' periodic pass inside it

The C172X's periodic pass:

- `ctl_laws`   <- `ControlLaws.f_periodic` and `assign`, which the TPU
                  megakernel runs inside the step on the C172Xv1
                  (`core/sim.py:327-333`) and the TPU cluster paths as XLA
                  glue (`clusterstep.py:591-607`)

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

from flightjax_torch.core.modeling import bscale, tree_map
from flightjax_torch.core.sim import comp_add
from flightjax_torch.models.c172.common import (AERO_CONST, M_FULL, M_RES,
                                                AeroY, EngineY, LdgY,
                                                StrutWow, SystemsY, ThrusterY,
                                                _alpha_gated, systems_y)
from flightjax_torch.ops.geodesy import nvector_from_qew
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
X_SYS_FBW = X_SYS + tuple((("act", ch), 1) for ch in FBW_CHANNELS)
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
               "mode_prev": torch.int32, "h_state": torch.int32}
LEAF_DTYPES.update({(k, f): torch.int32 for k in AV_PRIMITIVES
                    for f in ("out_sat_0", "sat_out_0")})


class Layout(NamedTuple):
    """The row groups of the systems kernels for one actuation, and the
    name of each kernel's instance for it: systems and finish_sys, and the
    whole vehicle (state X, context CTX: inputs, discrete state, carried
    undulation, the terminated latch; the position residuals C); `mega` the
    megakernel's state buffer: t, X, CTX, C and, fly-by-wire, the control
    laws' avionics block."""
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


def _layout(fbw):
    x_sys, u_sys = (X_SYS_FBW, U_SYS_FBW) if fbw else (X_SYS, U_SYS)
    x_groups = (X_KIN, X_DYN, x_sys)
    ctx = (u_sys, U_ATM, TRN, S_SYS, (("geoid_N", 1),), (("terminated", 1),))
    y = ((SYS_Y,) if fbw else ())
    return Layout(
        fbw=fbw, x_sys=x_sys, u_sys=u_sys,
        sys_in=(x_sys, x_sys, u_sys, S_SYS, TRN, KIN_DATA, AIR_DATA,
                (("term", 1),)),
        sys_out=(x_sys, MP, WR, (("hr_b", 3),)),
        fsys_in=(x_sys, x_sys, u_sys, S_SYS, TRN, KIN_DATA, AIR_DATA),
        fsys_out=(x_sys, S_SYS) + y,
        x_groups=x_groups, ctx_groups=ctx, stage_in=x_groups + ctx,
        stage_out=x_groups, rkfin_in=x_groups + ctx + (COMP,),
        rkfin_out=x_groups + (S_SYS, (("terminated", 1),), COMP)
        + ((KIN_Y,) + y if fbw else ()),
        mega=((("t", 1),),) + x_groups + ctx + (COMP,)
        + (AV_GROUPS if fbw else ()),
        names={k: k + ("_fbw" if fbw else "") for k in (
            "systems", "finish_sys", "rk4_stage", "rk4_finish")},
        mega_name="megakernel_fbw" if fbw else "megakernel")


MECH, FBW = _layout(False), _layout(True)
# the mechanical C172's groups (the C172S and its megakernel)
SYS_IN, SYS_OUT, FSYS_IN, FSYS_OUT = (MECH.sys_in, MECH.sys_out,
                                      MECH.fsys_in, MECH.fsys_out)
X_GROUPS, CTX_GROUPS, STAGE_IN, STAGE_OUT, RKFIN_IN, RKFIN_OUT = (
    MECH.x_groups, MECH.ctx_groups, MECH.stage_in, MECH.stage_out,
    MECH.rkfin_in, MECH.rkfin_out)


def layout_of(vehicle):
    """The layout of the vehicle's actuation: FBW for the fly-by-wire
    servos, whose kernel instances carry `Actuator1` on every channel; a
    second-order servo has no kernel yet."""
    act = vehicle.systems.act
    if not getattr(act, "stateful", False):
        return MECH
    bad = [ch for ch, a in act.actuators.items() if a.order != 1]
    if bad:
        raise ValueError(
            f"the kernels carry first-order servos only, not {bad}: "
            "ROADMAP Queue 2, 'Actuator2 channels in the kernels'")
    return FBW


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
    FBW_CHANNELS and ACT_P; [] for a stateless actuation."""
    if not layout_of(vehicle).fbw:
        return []
    acts = vehicle.systems.act.actuators
    return [v for ch in FBW_CHANNELS
            for v in (acts[ch].tau, *acts[ch].range)]


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
    one offset per table, the servos of `param_act` (fly-by-wire only),
    then the tables (`encode_table`)."""
    sys_ = vehicle.systems
    buf = _PARAMS.get(sys_)
    if buf is None:
        head = [v for vs in param_scalars(vehicle).values() for v in vs]
        act = param_act(vehicle)
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


def ctl_gains(avionics):
    """The control laws' gain buffer on their device in their dtype (built
    once): the offsets of the CTL_TABLES, then each channel's schedule as
    one table (`encode_table`) whose values are its gains stacked per knot
    (PID_GAINS, or LQR_GAINS flattened), on the schedules' own (EAS, h) grid
    and extrapolation."""
    buf = _GAINS.get(avionics)
    if buf is None:
        body = []
        offsets = []
        for ch in CTL_TABLES:
            g = avionics.gains[ch]
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
            offsets.append(float(len(CTL_TABLES) + len(body)))
            body += encode_table(lk)
        like = avionics.gains["v2t"]["k_p"].values
        buf = torch.tensor(offsets + body, dtype=torch.float64).to(
            device=like.device, dtype=like.dtype)
        _GAINS[avionics] = buf
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


def stage_clusters(C, vehicle, xv, kv, uv, sv, term, adt):
    """World derivative at the RK4 stage state xv + adt kv through the
    cluster functions `C` (`WRAPPERS` or `PLAIN`): kinair -> systems ->
    dynamics, `stage_lane` of `clusterstep.py:81-85`. `term` is 0/1."""
    kin_dot, kin, air, xi_dyn = C["kinair"](
        xv["kinematics"], xv["dynamics"], kv["kinematics"], kv["dynamics"],
        sv["geoid_N"], uv["atm"], adt, term)
    sys_dot, mp_b, wr_b, hr_b = C["systems"](
        vehicle, xv["systems"], kv["systems"], uv["systems"], sv["systems"],
        uv["trn"], kin, air, adt, term)
    dyn_dot = C["dynamics"](xi_dyn, mp_b, wr_b, hr_b, kin.q_eb, kin.r_eb_e,
                            term)
    return {"kinematics": kin_dot, "dynamics": dyn_dot, "systems": sys_dot}


def finish_clusters(C, vehicle, xv, ksum, uv, sv, terminated, dt, c_kin):
    """The RK4 combine x + dt/6 ksum (compensated on q_ew / h_e with the
    residuals `c_kin`, or None) and World.f_step through the cluster
    functions `C`: finish_kin -> finish_sys -> the terminated latch,
    `finish_lane` of `clusterstep.py:97-103`. Returns (xv, s_sys,
    terminated, c_kin, kin_y, sys_y): for the fly-by-wire C172 kin_y and
    sys_y are what its avionics read of the new state (the KIN_Y and SYS_Y
    fields, `vehicle_y` assembles the VehicleY), None for the mechanical
    one."""
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
    return (xv2, s_sys2, terminated | s_sys2["crashed"], c_kin2, kin_y,
            sys_y)


def vehicle_y(vehicle, xv, uv, kin_y, sys_y):
    """The VehicleY the avionics read at the new state `xv`, from what the
    finish kernels store: `kin_y` the KIN_Y fields, `sys_y` the SYS_Y
    ones. The servo commands and positions, the filters, the engine's
    speed ratio, omega_eb_b and h_e are the state's and the inputs' own
    (`common.systems_y`); the KinData and AirData fields no avionics reads
    are None."""
    kin = KinData(**dict(dict.fromkeys(KinData._fields),
                         omega_eb_b=xv["dynamics"]["omega_eb_b"],
                         h_e=xv["kinematics"]["h_e"],
                         **{k: v for k, v in kin_y.items() if k != "EAS"}))
    air = AirData(**dict(dict.fromkeys(AirData._fields), EAS=kin_y["EAS"]))
    sys_ = systems_y(vehicle.systems, xv["systems"], uv["systems"],
                     sys_y["alpha"], sys_y["beta"], sys_y["wow"])
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


def ctl_vehicle_y(y):
    """The VehicleY that holds the CTL_Y fields `y` (the others None)."""
    kin = KinData(**dict(dict.fromkeys(KinData._fields), **{
        k: y[k] for k in ("omega_wb_b", "omega_eb_b", "e_nb", "v_eb_n",
                          "chi_gnd", "h_e")}))
    air = AirData(**dict(dict.fromkeys(AirData._fields), EAS=y["EAS"]))
    sys_ = SystemsY(act={"cmd": y["cmd"], "pos": y["pos"]},
                    aero=AeroY(y["alpha"], y["beta"], y["alpha_filt"],
                               y["beta_filt"]),
                    ldg=LdgY(strut=StrutWow(wow=y["wow"])),
                    pwp=ThrusterY(engine=EngineY(n=y["n"])))
    return VehicleY(systems=sys_, kinematics=kin, dynamics=None,
                    airflow=air)


def ctl_laws_plain(avionics, y, u_av, s_av, dt):
    """The control laws' periodic pass on the CTL_Y fields `y`:
    `ControlLaws.f_periodic` and the commands `assign` writes. Returns
    (the new avionics state, {channel: command} of CTL_CMD)."""
    s2, av_y = avionics.f_periodic(s_av, u_av, ctl_vehicle_y(y), dt)
    return s2, {"aileron": av_y.lat.aileron_cmd,
                "elevator": av_y.lon.elevator_cmd,
                "rudder": av_y.lat.rudder_cmd,
                "throttle": av_y.lon.throttle_cmd}


def rk4_stage_plain(vehicle, xv, kv, uv, sv, term, adt):
    """The plain clusters composed as `stage_lane`."""
    return stage_clusters(PLAIN, vehicle, xv, kv, uv, sv, term, adt)


def rk4_finish_plain(vehicle, xv, ksum, uv, sv, terminated, dt, c_kin=None):
    """The plain clusters composed as `finish_lane`, with `comp_add` when
    residuals are carried: (xv, s_sys, terminated, c_kin, kin_y, sys_y),
    kin_y and sys_y None for the mechanical C172."""
    return finish_clusters(PLAIN, vehicle, xv, ksum, uv, sv, terminated, dt,
                           c_kin)


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
    return xv["kinematics"], xv["dynamics"], xv["systems"]


def _x_tree(views):
    return {"kinematics": views[0], "dynamics": views[1],
            "systems": views[2]}


def pack_vehicle(vehicle, xv, uv, sv, terminated, c_kin=None):
    """The whole vehicle as one `[X; CTX; C]` buffer (`rkfin_in` of its
    layout) in the state's dtype, C zero without residuals. `rk4_stage`
    reads its first `rows(stage_in)` rows, `rk4_finish` all of them."""
    lay = layout_of(vehicle)
    like = xv["kinematics"]["h_e"]
    if c_kin is None:
        c_kin = {"q_ew": torch.zeros_like(xv["kinematics"]["q_ew"]),
                 "h_e": torch.zeros_like(like)}
    B = like.shape[0]
    return pack(lay.rkfin_in, (*_x(xv), uv["systems"], uv["atm"],
                               _trn(vehicle, uv["trn"], B), sv["systems"],
                               {"geoid_N": sv["geoid_N"]},
                               {"terminated": terminated}, c_kin), B,
                like.dtype)


def unpack_vehicle(buf, lay=MECH):
    """(xv, uv, sv, terminated, c_kin) from a `pack_vehicle` buffer of
    layout `lay`, or from its first `rows(stage_in)` rows (c_kin None
    then); bool and int leaves typed again, terrain constants dropped."""
    v = unpack(lay.rkfin_in if buf.shape[0] == rows(lay.rkfin_in)
               else lay.stage_in, buf, typed=True)
    uv = {"systems": v[3], "atm": v[4], "trn": {"surface": v[5]["surface"]}}
    sv = {"systems": v[6], "geoid_N": v[7]["geoid_N"]}
    return (_x_tree(v), uv, sv, v[8]["terminated"],
            v[9] if len(v) > 9 else None)


def pack_rk4_stage(vehicle, xv, kv, uv, sv, term, adt):
    lay = layout_of(vehicle)
    buf = pack_vehicle(vehicle, xv, uv, sv, term)[:rows(lay.stage_in)]
    k = pack(lay.x_groups, _x(kv), buf.shape[1], buf.dtype)
    return buf, rows(lay.stage_out), (float(adt),), {
        "k": k, "params": system_params(vehicle)}


def pack_rk4_finish(vehicle, xv, ksum, uv, sv, terminated, dt, c_kin=None):
    lay = layout_of(vehicle)
    buf = pack_vehicle(vehicle, xv, uv, sv, terminated, c_kin)
    k = pack(lay.x_groups, _x(ksum), buf.shape[1], buf.dtype)
    return buf, rows(lay.rkfin_out), (dt / 6.0, int(c_kin is not None)), {
        "k": k, "params": system_params(vehicle)}


def pack_ctl_laws(avionics, y, u_av, s_av, dt):
    like = y["EAS"]
    buf = pack(CTL_IN, (y, u_av["lon"], u_av["lat"], s_av["lon"],
                        s_av["lat"]), like.shape[0], like.dtype)
    return buf, rows(CTL_OUT), (float(dt),), {
        "gains": ctl_gains(avionics)}


def pack_geoid(geo, q_ew):
    buf = pack(GEOID_IN, ({"q_ew": q_ew},), q_ew.shape[0])
    return buf, rows(GEOID_OUT), (), {"grid": geoid_grid(geo)}


PACK = {"kinair": pack_kinair, "dynamics": pack_dynamics,
        "finish_kin": pack_finish_kin, "systems": pack_systems,
        "finish_sys": pack_finish_sys, "rk4_stage": pack_rk4_stage,
        "rk4_finish": pack_rk4_finish, "geoid": pack_geoid,
        "ctl_laws": pack_ctl_laws}
# the fly-by-wire instances pack as their mechanical twins (by the
# vehicle's layout)
PACK.update({FBW.names[k]: PACK[k] for k in FBW.names})


# instance name -> (kernel, layout)
_INSTANCES = {n: (k, lay) for lay in (MECH, FBW)
              for k, n in dict(lay.names, megakernel=lay.mega_name).items()}


def _av_tree(d):
    """An unpacked lon or lat avionics group with its controller states as
    the NamedTuples of `physics/control.py`."""
    return {k: (_AV_STATES[AV_PRIMITIVES[k]][0](**v) if k in AV_PRIMITIVES
                else v) for k, v in d.items()}


def unpack_out(name, out, comp=False):
    """The packed output `out` of kernel instance `name` as its wrapper
    returns it (`comp`: finish_kin or rk4_finish carried residuals); bool
    and int leaves typed again. The megakernels' is their state buffer:
    (t, xv, uv, sv, terminated, c_kin, u_av, s_av), c_kin None without
    `comp`, the avionics' u and s None for the C172S."""
    base, lay = _INSTANCES.get(name, (name, MECH))
    if base == "ctl_laws":
        s_lon, s_lat, cmd = unpack(CTL_OUT, out, typed=True)
        return {"lon": _av_tree(s_lon), "lat": _av_tree(s_lat)}, cmd
    if base == "megakernel":
        n = 1 + rows(lay.rkfin_in)
        xv, uv, sv, terminated, c_kin = unpack_vehicle(out[1:n], lay)
        u_av = s_av = None
        if lay.fbw:
            u_lon, u_lat, s_lon, s_lat = unpack(AV_GROUPS, out[n:],
                                                typed=True)
            u_av = {"lon": u_lon, "lat": u_lat}
            s_av = {"lon": _av_tree(s_lon), "lat": _av_tree(s_lat)}
        return (out[0], xv, uv, sv, terminated, c_kin if comp else None,
                u_av, s_av)
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
        return (_x_tree(v), v[3], v[4]["terminated"], v[5] if comp else None,
                *(v[6:8] if lay.fbw else (None, None)))
    raise ValueError(f"no kernel {name}")


def launch_kernel(name, buf, n_out, scalars, operands, block=None):
    """Launch kernel `name` on packed operands (the form `PACK[name]`
    returns) and count the launch."""
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


def rk4_stage(vehicle, xv, kv, uv, sv, term, adt):
    """`rk4_stage_plain` on the CPU, the `rk4_stage` CUDA kernel on the
    card: the derivative of the whole vehicle at xv + adt kv."""
    like = xv["kinematics"]["h_e"]
    args = (vehicle, xv, kv, uv, sv, term, adt)
    if like.device.type == "cpu":
        return rk4_stage_plain(*args[:-2], _term(term, like), adt)
    name = _instance("rk4_stage", vehicle)
    return unpack_out(name, _launch(name, args))


def rk4_finish(vehicle, xv, ksum, uv, sv, terminated, dt, c_kin=None):
    """`rk4_finish_plain` on the CPU, the `rk4_finish` CUDA kernel on the
    card. Returns (xv, s_sys, terminated, c_kin, kin_y, sys_y), kin_y and
    sys_y None for the mechanical C172."""
    _check_comp(c_kin)
    args = (vehicle, xv, ksum, uv, sv, terminated, dt, c_kin)
    if xv["kinematics"]["h_e"].device.type == "cpu":
        return rk4_finish_plain(*args)
    name = _instance("rk4_finish", vehicle)
    return unpack_out(name, _launch(name, args), c_kin is not None)


def rk4_stage_packed(vehicle, buf, k, adt, block=None):
    """One RK4 stage on packed buffers: `buf` holds X; CTX
    (`rows(STAGE_IN)` rows), `k` the previous stage's derivative; returns
    the stage derivative (`rows(STAGE_OUT)` rows). The kernel on the card
    (`block`: aircraft per block, 32 or 64), the plain stage between unpack
    and pack on the CPU."""
    lay = layout_of(vehicle)
    if buf.device.type != "cpu":
        return launch_kernel(lay.names["rk4_stage"], buf,
                             rows(lay.stage_out), (float(adt),),
                             {"k": k, "params": system_params(vehicle)},
                             block)
    xv, uv, sv, terminated, _ = unpack_vehicle(buf, lay)
    d = rk4_stage_plain(vehicle, xv, _x_tree(unpack(lay.x_groups, k)), uv,
                        sv, terminated.to(buf.dtype), adt)
    return pack(lay.stage_out, _x(d), buf.shape[1], buf.dtype)


def rk4_finish_packed(vehicle, buf, ksum, dt, comp, block=None):
    """The RK4 combine and World.f_step on packed buffers: `buf` from
    `pack_vehicle`, `ksum` the k-sum; returns X; s_sys; terminated; C
    (`rows(RKFIN_OUT)` rows, C zero unless `comp`). The kernel on the
    card (`block`: aircraft per block, 32 or 64), the plain finish between
    unpack and pack on the CPU."""
    lay = layout_of(vehicle)
    if buf.device.type != "cpu":
        return launch_kernel(lay.names["rk4_finish"], buf,
                             rows(lay.rkfin_out),
                             (dt / 6.0, int(bool(comp))),
                             {"k": ksum, "params": system_params(vehicle)},
                             block)
    xv, uv, sv, terminated, c_kin = unpack_vehicle(buf, lay)
    xv2, s2, term2, c2, kin_y, sys_y = rk4_finish_plain(
        vehicle, xv, _x_tree(unpack(lay.x_groups, ksum)), uv, sv, terminated,
        dt, c_kin if comp else None)
    if c2 is None:
        c2 = tree_map(torch.zeros_like, c_kin)
    y = (kin_y, sys_y) if lay.fbw else ()
    return pack(lay.rkfin_out, (*_x(xv2), s2, {"terminated": term2}, c2,
                                *y), buf.shape[1], buf.dtype)


def ctl_laws(avionics, y, u_av, s_av, dt):
    """`ctl_laws_plain` on the CPU, the `ctl_laws` CUDA kernel on the
    card."""
    args = (avionics, y, u_av, s_av, dt)
    if y["EAS"].device.type == "cpu":
        return ctl_laws_plain(*args)
    return unpack_out("ctl_laws", _launch("ctl_laws", args))


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
    laws') periodic pass every `spp` steps at their `periodic_dt`."""
    name = layout_of(vehicle).mega_name
    out = L.launch_megakernel(
        bufs[0], bufs[1], system_params(vehicle), geoid_grid(vehicle.geoid),
        dt, t_start, comp, block,
        None if avionics is None else ctl_gains(avionics), spp, periodic_dt)
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
