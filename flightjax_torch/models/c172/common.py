"""Cessna 172 platform: airframe, aerodynamics, gear set, payload, fuel and
the systems composite, as data-flow parts (port of
`flightjax/models/c172/common.py`).

`Systems` exposes the same decomposition the JAX package's fine cluster
split uses (`f_ode_parts`, `f_ode_gear_legs`, `f_step_parts`,
`common.py:478-584`); `parallel/clusterstep.py` composes them.
"""

from typing import NamedTuple

import numpy as np
import torch

from flightjax_torch.core.modeling import bwhere, divc
from flightjax_torch.ops.interp import Lookup
from flightjax_torch.ops.quaternions import rot2_y
from flightjax_torch.physics import atmosphere as atm
from flightjax_torch.physics.dynamics import (FrameTransform, MassProps,
                                              Wrench, mass_props_point,
                                              mass_props_rigid)
from flightjax_torch.physics.landinggear import (ALPHA_TS_MAX, XI_DOT_MAX,
                                                 GearSet, SimpleDamper)

# ---------------------------------------------------------------- aero data
# digitized JSBSim C172R tables (`common.py:62-124`): (axes, values, extrap)

_d2r = np.deg2rad


def _tbl(axes, vals, extrap="flat"):
    return (tuple(np.asarray(a, float) for a in axes),
            np.asarray(vals, float), extrap)


AERO_TABLES = dict(
    CD_beta=_tbl([[-1.0, 0.0, 1.0]], [0.17, 0.0, 0.17]),
    CD_de=_tbl([[-1.0, 0.0, 1.0]], [0.06, 0.0, 0.06]),
    CD_df=_tbl([_d2r([0, 10, 20, 30])], [0.0, 0.007, 0.012, 0.018]),
    CD_ge=_tbl([[0.0, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1]],
               [0.48, 0.515, 0.629, 0.709, 0.815, 0.882, 0.928, 0.962, 0.988,
                1.0, 1.0, 1.0, 1.0]),
    CD_alpha_df=_tbl(
        [[-0.0873, -0.0698, -0.0524, -0.0349, -0.0175, 0.0, 0.0175, 0.0349,
          0.0524, 0.0698, 0.0873, 0.1047, 0.1222, 0.1396, 0.1571, 0.1745,
          0.192, 0.2094, 0.2269, 0.2443, 0.2618, 0.2793, 0.2967, 0.3142,
          0.3316, 0.3491],
         _d2r([0, 10, 20, 30])],
        np.array([
            [0.0041, 0.0013, 0.0001, 0.0003, 0.002, 0.0052, 0.0099, 0.0162,
             0.024, 0.0334, 0.0442, 0.0566, 0.0706, 0.086, 0.0962, 0.1069,
             0.118, 0.1298, 0.1424, 0.1565, 0.1727, 0.1782, 0.1716, 0.1618,
             0.1475, 0.1097],
            [0.0, 0.0004, 0.0023, 0.0057, 0.0105, 0.0168, 0.0248, 0.0342,
             0.0452, 0.0577, 0.0718, 0.0874, 0.1045, 0.1232, 0.1353, 0.1479,
             0.161, 0.1746, 0.1892, 0.2054, 0.224, 0.2302, 0.2227, 0.2115,
             0.1951, 0.1512],
            [0.0005, 0.0025, 0.0059, 0.0108, 0.0172, 0.0251, 0.0346, 0.0457,
             0.0583, 0.0724, 0.0881, 0.1053, 0.124, 0.1442, 0.1573, 0.1708,
             0.1849, 0.1995, 0.2151, 0.2323, 0.2521, 0.2587, 0.2507, 0.2388,
             0.2214, 0.1744],
            [0.0014, 0.0041, 0.0084, 0.0141, 0.0212, 0.0299, 0.0402, 0.0521,
             0.0655, 0.0804, 0.0968, 0.1148, 0.1343, 0.1554, 0.169, 0.183,
             0.1975, 0.2126, 0.2286, 0.2464, 0.2667, 0.2735, 0.2653, 0.2531,
             0.2351, 0.1866]]).T),
    CY_beta_df=_tbl([[-0.349, 0.0, 0.349], _d2r([0, 30])],
                    [[0.137, 0.106], [0.0, 0.0], [-0.137, -0.106]]),
    CY_p=_tbl([[0.0, 0.094], _d2r([0, 30])],
              [[-0.075, -0.161], [-0.145, -0.231]]),
    CY_r=_tbl([[0.0, 0.094], _d2r([0, 30])],
              [[0.214, 0.162], [0.267, 0.215]]),
    CL_ge=_tbl([[0.0, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1]],
               [1.203, 1.127, 1.09, 1.073, 1.046, 1.055, 1.019, 1.013, 1.008,
                1.006, 1.003, 1.002, 1.0]),
    CL_alpha=_tbl(
        [[-0.09, 0.0, 0.09, 0.1, 0.12, 0.14, 0.16, 0.17, 0.19, 0.21, 0.24,
          0.26, 0.28, 0.3, 0.32, 0.34, 0.36],
         [0.0, 1.0]],
        np.array([
            [-0.22, 0.25, 0.73, 0.83, 0.92, 1.02, 1.08, 1.13, 1.19, 1.25,
             1.35, 1.44, 1.47, 1.43, 1.38, 1.3, 1.15],
            [-0.22, 0.25, 0.73, 0.78, 0.79, 0.81, 0.82, 0.83, 0.85, 0.86,
             0.88, 0.9, 0.92, 0.95, 0.99, 1.05, 1.15]]).T),
    CL_df=_tbl([_d2r([0, 10, 20, 30])], [0.0, 0.2, 0.3, 0.35]),
    Cl_r=_tbl([[0.0, 0.094], _d2r([0, 30])],
              [[0.0798, 0.1246], [0.1869, 0.2317]]),
    Cm_df=_tbl([_d2r([0, 10, 20, 30])], [0.0, -0.0654, -0.0981, -0.114]),
)

AERO_CONST = dict(
    CD_zero=0.027,
    CY_dr=0.187, CY_da=0.0,
    CL_de=0.43, CL_q=3.9, CL_adot=1.7,
    Cl_da=0.229, Cl_dr=0.0147, Cl_beta=-0.09226, Cl_p=-0.484,
    Cm_zero=0.1, Cm_de=-1.122, Cm_alpha=-1.8, Cm_q=-12.4, Cm_adot=-7.27,
    Cn_dr=-0.043, Cn_da=-0.0053, Cn_beta=0.05874, Cn_p=-0.0278, Cn_r=-0.0937,
)


def get_aero_coeffs(T, alpha, beta, p_nd, q_nd, r_nd, da, dr, de, df,
                    alpha_dot_nd, beta_dot_nd, dh_nd, stall):
    """Coefficient assembly (`common.py:151-209`) over the uploaded tables
    `T`; returns (C_D, C_Y, C_L, C_l, C_m, C_n)."""
    K = AERO_CONST
    alpha = torch.clamp(alpha, -0.1, 0.36)
    beta = torch.clamp(beta, -0.2, 0.2)
    alpha_dot_nd = torch.clamp(alpha_dot_nd, -0.04, 0.04)
    stall = stall.to(alpha.dtype)

    cd_beta = 0.17 * torch.abs(beta)
    cd_de = 0.06 * torch.abs(de)
    cd_df, cd_ge, cd_adf = T["CD_df"](df), T["CD_ge"](dh_nd), \
        T["CD_alpha_df"](alpha, df)
    cy_bdf, cy_p, cy_r = T["CY_beta_df"](beta, df), T["CY_p"](alpha, df), \
        T["CY_r"](alpha, df)
    cl_ge, cl_a, cl_df = T["CL_ge"](dh_nd), T["CL_alpha"](alpha, stall), \
        T["CL_df"](df)
    cl_r, cm_df = T["Cl_r"](alpha, df), T["Cm_df"](df)

    C_D = K["CD_zero"] + cd_ge * (cd_adf + cd_df) + cd_de + cd_beta
    C_Y = (K["CY_dr"] * dr + K["CY_da"] * da + cy_bdf
           + cy_p * p_nd + cy_r * r_nd)
    C_L = (cl_ge * (cl_a + cl_df)
           + K["CL_de"] * de + K["CL_q"] * q_nd + K["CL_adot"] * alpha_dot_nd)
    C_l = (K["Cl_da"] * da + K["Cl_dr"] * dr + K["Cl_beta"] * beta
           + K["Cl_p"] * p_nd + cl_r * r_nd)
    C_m = (K["Cm_zero"] + K["Cm_de"] * de + cm_df
           + K["Cm_alpha"] * alpha + K["Cm_q"] * q_nd
           + K["Cm_adot"] * alpha_dot_nd)
    C_n = (K["Cn_dr"] * dr + K["Cn_da"] * da + K["Cn_beta"] * beta
           + K["Cn_p"] * p_nd + K["Cn_r"] * r_nd)
    return C_D, C_Y, C_L, C_l, C_m, C_n


def _alpha_gated(air):
    """Airflow angles with the low-TAS chattering guard
    (`common.py:268-273`); also returns the guarded velocity."""
    small = air.TAS <= 0.1
    e1 = torch.zeros_like(air.v_wb_b)
    e1[..., 0] = 1.0
    v_safe = bwhere(small, e1, air.v_wb_b)
    alpha_raw, beta_raw = atm.get_airflow_angles(v_safe)
    zero = torch.zeros_like(alpha_raw)
    return (torch.where(small, zero, alpha_raw),
            torch.where(small, zero, beta_raw), v_safe)


class Aero:
    """C172 aerodynamics (`common.py:232-327`); x = {alpha_filt,
    beta_filt}, s = {stall}."""

    S = 16.165
    b = 10.912
    c = 1.494
    de_range = tuple(float(v) for v in _d2r((-28.0, 23.0)))
    da_range = tuple(float(v) for v in _d2r((-20.0, 20.0)))
    dr_range = tuple(float(v) for v in _d2r((-16.0, 16.0)))
    df_range = tuple(float(v) for v in _d2r((0.0, 30.0)))
    alpha_stall = (0.09, 0.36)
    V_min = 1.0
    tau = 0.02

    def __init__(self, *, device, dtype):
        self.tables = {k: Lookup(ax, v, ex, device=device, dtype=dtype)
                       for k, (ax, v, ex) in AERO_TABLES.items()}

    @staticmethod
    def _scale(u, rng, lo_u=-1.0, hi_u=1.0):
        u = torch.clamp(u, lo_u, hi_u)
        return rng[0] + (rng[1] - rng[0]) / (hi_u - lo_u) * (u - lo_u)

    def f_ode(self, x, u, s, kin, air, trn):
        """(x_dot, aero wrench in body axes)."""
        alpha_filt, beta_filt = x["alpha_filt"], x["beta_filt"]
        alpha, beta, v_safe = _alpha_gated(air)
        V = torch.clamp_min(air.TAS, self.V_min)

        alpha_filt_dot = divc(alpha - alpha_filt, self.tau)
        beta_filt_dot = divc(beta - beta_filt, self.tau)

        p_nd = kin.omega_wb_b[..., 0] * self.b / (2 * V)
        q_nd = kin.omega_wb_b[..., 1] * self.c / (2 * V)
        r_nd = kin.omega_wb_b[..., 2] * self.b / (2 * V)
        alpha_dot_nd = alpha_filt_dot * self.c / (2 * V)
        beta_dot_nd = beta_filt_dot * self.b / (2 * V)

        de = self._scale(u["e"], self.de_range)
        da = self._scale(u["a"], self.da_range)
        dr = self._scale(u["r"], self.dr_range)
        df = self._scale(u["f"], self.df_range, lo_u=0.0)

        dh_nd = divc(kin.h_o - trn.elevation, self.b)

        C_D, C_Y, C_L, C_l, C_m, C_n = get_aero_coeffs(
            self.tables, alpha, beta, p_nd, q_nd, r_nd, da, dr, de, df,
            alpha_dot_nd, beta_dot_nd, dh_nd, s["stall"])

        # stability -> airframe rotation from the algebraic cos/sin alpha
        vx, vz = v_safe[..., 0], v_safe[..., 2]
        m2 = vx * vx + vz * vz
        minv = torch.rsqrt(torch.clamp_min(m2, 1e-30))
        okm = m2 > 0
        ca = torch.where(okm, vx * minv, torch.ones_like(m2))
        sa = torch.where(okm, vz * minv, torch.zeros_like(m2))
        qS = (air.q * self.S)[..., None]
        F_s = qS * torch.stack([-C_D, C_Y, -C_L], dim=-1)
        F_a = rot2_y(ca, -sa, F_s)
        tau_a = qS * torch.stack([C_l * self.b, C_m * self.c, C_n * self.b],
                                 dim=-1)
        x_dot = {"alpha_filt": alpha_filt_dot, "beta_filt": beta_filt_dot}
        return x_dot, Wrench(F=F_a, tau=tau_a)

    def f_step_stall(self, alpha, stall):
        return (alpha > self.alpha_stall[1]) | (stall & (alpha >= self.alpha_stall[0]))


def make_ldg(*, device, dtype) -> GearSet:
    """Tricycle gear with C172 geometry (`common.py:332-343`)."""
    mlg = SimpleDamper(k_s=39404.0, k_d_ext=9340.0, k_d_cmp=9340.0)
    nlg = SimpleDamper(k_s=26269.0, k_d_ext=3503.0, k_d_cmp=3503.0)
    return GearSet(
        names=("left", "right", "nose"),
        r_bs=[[-0.381, -1.092, 1.902], [-0.381, 1.092, 1.902],
              [1.27, 0.0, 1.9]],
        dampers=[mlg, mlg, nlg], psi_max=[0.0, 0.0, np.pi / 6],
        eta_br=[1.0, 1.0, 0.0], device=device, dtype=dtype)


PAYLOAD_SLOTS = {
    "pilot": [0.183, -0.356, 0.899],
    "copilot": [0.183, 0.356, 0.899],
    "lpass": [-0.681, -0.356, 0.899],
    "rpass": [-0.681, 0.356, 0.899],
    "baggage": [-1.316, 0.0, 0.899],
}

M_FULL = 114.4
M_RES = 1.0
FUEL_TANKS = ([0.325, -2.845, 0.0], [0.325, 2.845, 0.0])


def _mass_props_zero(like):
    return MassProps(m=torch.zeros_like(like),
                     J=like.new_zeros(like.shape + (3, 3)),
                     r_OG=like.new_zeros(like.shape + (3,)))


def fuel_m_total(x_fuel):
    return M_RES + x_fuel * (M_FULL - M_RES)


class Systems:
    """C172 systems (`common.py:408-613`): actuation, aero, gear,
    powerplant, payload and fuel.

    The actuation is mechanical (stateless: `act.f_ode(u)` gives the
    assignments) or stateful (`act.stateful`, the fly-by-wire servos:
    `act.f_ode(x['act'], u)` gives (act_y, assignments, {'act': x_dot}),
    and the servo positions after the RK4 combine drive the finish)."""

    def __init__(self, pwp, act, *, device, dtype):
        self.aero = Aero(device=device, dtype=dtype)
        self.ldg = make_ldg(device=device, dtype=dtype)
        self.pwp = pwp
        self.act = act
        self.airframe_mp = mass_props_rigid(
            torch.tensor(767.0, dtype=dtype, device=device),
            torch.diag(torch.tensor([820.0, 1164.0, 1702.0], dtype=dtype,
                                    device=device)),
            FrameTransform(
                r=torch.tensor([0.056, 0.0, 0.582], dtype=dtype,
                               device=device),
                q=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                               device=device)))
        self.payload_r = {k: torch.tensor(r, dtype=dtype, device=device)
                          for k, r in PAYLOAD_SLOTS.items()}
        self.tank_r = [torch.tensor(r, dtype=dtype, device=device)
                       for r in FUEL_TANKS]

    @staticmethod
    def gear_inputs(asg):
        """Stacked (left, right, nose) steering/braking [B, 3]."""
        z = torch.zeros_like(asg["steering"])
        return {"steering": torch.stack([z, z, asg["steering"]], dim=-1),
                "braking": torch.stack([asg["brake_left"],
                                        asg["brake_right"], z], dim=-1)}

    def payload_mp_b(self, u_pld):
        mp = _mass_props_zero(u_pld["pilot"])
        for name, r in self.payload_r.items():
            mp = mp + mass_props_point(torch.clamp(u_pld[name], 0.0, 100.0),
                                       r)
        return mp

    def fuel_mp_b(self, x_fuel):
        m = torch.clamp_min(fuel_m_total(x_fuel), 0.0)
        mp = _mass_props_zero(x_fuel)
        for r in self.tank_r:
            mp = mp + mass_props_point(0.5 * m, r)
        return mp

    def actuate(self, x_act, u_act):
        """(act_y, assignments, servo derivative): act_y and the derivative
        None for a stateless actuation, which ignores `x_act`."""
        if getattr(self.act, "stateful", False):
            act_y, asg, x_dot = self.act.f_ode(x_act, u_act)
            return act_y, asg, x_dot["act"]
        return None, self.act.f_ode(u_act), None

    # ------------------------------------------------ f_ode parts (K3-K5)

    def actaero(self, x_aero, u_act, s_aero, kin, air, trn, x_act=None):
        """Actuation + aero: (aero_dot, gear_u, thr_mix, wr_aero); `x_act`
        the servo states of a stateful actuation."""
        _, asg, _ = self.actuate(x_act, u_act)
        aero_u = {k: asg[k] for k in ("e", "a", "r", "f")}
        aero_dot, wr_aero = self.aero.f_ode(x_aero, aero_u, s_aero, kin, air,
                                            trn)
        thr_mix = {"throttle": asg["throttle"], "mixture": asg["mixture"]}
        return aero_dot, self.gear_inputs(asg), thr_mix, wr_aero

    def ldg_leg(self, i, x_frc, steering, braking, kin, trn):
        """Gear leg i: (frc_dot [B, 2], contact wrench)."""
        return self.ldg.f_ode_leg(i, x_frc, steering, braking, kin, trn)

    def pwp_mass(self, x_pwp, x_fuel, u_pwp, s_pwp, thr_mix, u_pld, kin, air,
                 wr_aero, wr_ldg):
        """Powerplant + fuel + mass aggregation: (pwp_dot, fuel_dot, mp_b,
        wr_b, hr_b)."""
        pwp_u = dict(u_pwp)
        pwp_u["engine"] = dict(pwp_u["engine"], throttle=thr_mix["throttle"],
                               mixture=thr_mix["mixture"])
        pwp_dot, mdot, prop_y = self.pwp.f_ode(x_pwp, pwp_u, s_pwp, air, kin)
        fuel_dot = divc(-mdot, M_FULL - M_RES)
        mp_b = (self.airframe_mp + self.payload_mp_b(u_pld)
                + self.fuel_mp_b(x_fuel))
        wr_b = wr_aero + prop_y.wr_b + wr_ldg
        return pwp_dot, fuel_dot, mp_b, wr_b, prop_y.hr_b

    # ------------------------------------------------ f_step parts (K7)

    def fin_act(self, u_act, x_act=None):
        """Steering and braking at the servo states `x_act` after the
        combine (a stateless actuation ignores them)."""
        return self.gear_inputs(self.actuate(x_act, u_act)[1])

    def fin_ldg_leg(self, i, steering, kin, trn):
        """Leg i's (wow as 0/1, alpha_ts, xi_dot)."""
        sy = self.ldg.strut_y_leg(i, steering, kin, trn)
        return sy.wow.to(kin.h_e.dtype), sy.alpha_ts, sy.xi_dot

    def fin_rest(self, x, u_pwp, s, air, wow, alpha_ts, xi_dot):
        """Stall hysteresis, gear regulator reset, crash latch, engine state
        machine (`common.py:559-582`); wow/alpha_ts/xi_dot are [B, 3]."""
        alpha, _, _ = _alpha_gated(air)
        stall = self.aero.f_step_stall(alpha, s["aero"]["stall"])
        wow_b = wow > 0.5
        x_ldg = {"frc": bwhere(wow_b, x["ldg"]["frc"],
                               torch.zeros_like(x["ldg"]["frc"]))}
        crashed = s["crashed"] | torch.any(
            (wow_b & (alpha_ts > ALPHA_TS_MAX)) | (-xi_dot > XI_DOT_MAX),
            dim=-1)
        fuel_avail = fuel_m_total(x["fuel"]) - M_RES > 0
        x_pwp, s_pwp = self.pwp.f_step(x["pwp"], u_pwp, s["pwp"], fuel_avail)
        x2 = dict(x, ldg=x_ldg, pwp=x_pwp)
        s2 = {"aero": {"stall": stall}, "pwp": s_pwp, "crashed": crashed}
        return x2, s2


class AeroY(NamedTuple):
    """The aero outputs the avionics read (`common.py:212-229`): the gated
    airflow angles and the filter states."""
    alpha: torch.Tensor
    beta: torch.Tensor
    alpha_filt: torch.Tensor
    beta_filt: torch.Tensor


class EngineY(NamedTuple):
    n: torch.Tensor  # shaft speed over the rated speed
    state: torch.Tensor = None  # ENG_OFF / ENG_STARTING / ENG_RUNNING


class ThrusterY(NamedTuple):
    engine: EngineY


class StrutWow(NamedTuple):
    wow: torch.Tensor  # [..., 3] weight on each wheel (left, right, nose)


class LdgY(NamedTuple):
    strut: StrutWow


class SystemsY(NamedTuple):
    """The part of the JAX package's `SystemsY` (`common.py:399-406`) the
    avionics read: act_y, the airflow angles and filters, the engine's
    speed ratio and the weight on wheels."""
    act: object
    aero: AeroY
    ldg: LdgY
    pwp: ThrusterY


def systems_y(sys_, x_sys, u_sys, alpha, beta, wow, eng_state=None):
    """SystemsY at the state `x_sys` from the airflow angles and weight on
    wheels (the rest are the state's own functions), with the engine's
    state machine `eng_state` (the discrete state's) where given."""
    act_y, _, _ = sys_.actuate(x_sys.get("act"), u_sys["act"])
    eng = x_sys["pwp"]["engine"]
    return SystemsY(
        act=act_y,
        aero=AeroY(alpha=alpha, beta=beta,
                   alpha_filt=x_sys["aero"]["alpha_filt"],
                   beta_filt=x_sys["aero"]["beta_filt"]),
        ldg=LdgY(strut=StrutWow(wow=wow)),
        pwp=ThrusterY(engine=EngineY(
            n=divc(eng["omega"], sys_.pwp.engine.omega_rated),
            state=eng_state)))
