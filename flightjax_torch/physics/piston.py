"""Normalized IO-360 piston engine and the engine + propeller thruster (port
of `flightjax/physics/piston.py`). The chart tables are built in numpy
exactly as the JAX package builds them and uploaded as `Lookup`s."""


import numpy as np
import torch

from flightjax_torch.core.modeling import divc
from flightjax_torch.ops.interp import Lookup
from flightjax_torch.physics import control as C
from flightjax_torch.physics.atmosphere import G_STD, P_STD, R_GAS, RHO_STD, T_STD
from flightjax_torch.physics.propellers import Propeller

BETA_TROPO = -6.5e-3

F_CUTOFF = 0.0580
F_LEAN = 0.0625
F_RICH = 0.0950

ENG_OFF, ENG_STARTING, ENG_RUNNING = 0, 1, 2
MIX_MANUAL, MIX_AUTO = 0, 1


def hp2w(P):
    return 735.49875 * P


def rpm2radps(n):
    return n * np.pi / 30.0


def T_ISA(p):
    return T_STD * divc(p, P_STD) ** (-BETA_TROPO * R_GAS / G_STD)


def p2delta(p):
    return divc(p, P_STD) * torch.rsqrt(divc(T_ISA(p), T_STD))


def _interp_line(x, y, xq):
    """1-D linear interpolation with Line extrapolation (numpy)."""
    x, y, xq = map(np.asarray, (x, y, xq))
    out = np.interp(xq, x, y)
    lo = xq < x[0]
    hi = xq > x[-1]
    out = np.where(lo, y[0] + (xq - x[0]) * (y[1] - y[0]) / (x[1] - x[0]), out)
    out = np.where(hi, y[-1] + (xq - x[-1]) * (y[-1] - y[-2])
                   / (x[-1] - x[-2]), out)
    return out


def _hat_weights(x, a, mode):
    """numpy piecewise-linear hat weights over axis `a` at scalar `x`: the
    weights `flightjax.ops.interp.Lookup` builds for its small tables."""
    a = np.asarray(a, np.float64)
    if mode == "flat":
        x = min(max(x, a[0]), a[-1])
    d = np.diff(a)
    dl = np.concatenate([d[:1], d])
    dr = np.concatenate([d, d[-1:]])
    t = x - a
    w = np.minimum(1.0 + np.minimum(t / dl, 0.0),
                   1.0 + np.minimum(-t / dr, 0.0))
    w = np.maximum(w, 0.0)
    if mode == "line":
        if x < a[0]:
            t0 = (x - a[0]) / (a[1] - a[0])
            w[0], w[1] = 1.0 - t0, t0
        if x > a[-1]:
            tn = (x - a[-2]) / (a[-1] - a[-2])
            w[-2], w[-1] = 1.0 - tn, tn
    return w


def _eval2(table, x0, x1):
    """Scalar 2-D evaluation of a (axes, values, extrap) table in numpy,
    contracting axis 0 then axis 1 like the JAX dense path."""
    (a0, a1), V, ex = table
    ex = (ex, ex) if isinstance(ex, str) else ex
    row = _hat_weights(x0, a0, ex[0]) @ np.asarray(V)
    return float(np.sum(row * _hat_weights(x1, a1, ex[1])))


def build_tables(n_stall, n_max):
    """Digitized IO-360 charts (`piston.py:70-144`) as numpy
    (axes, values, extrap) triples."""
    n_ax2 = np.array([0.667, 1.0])
    mu_ax9 = np.linspace(0.401, 0.936, 9)
    delta_data = np.array([
        [0.455, 0.523, 0.587, 0.652, 0.718, 0.781, 0.844, 0.906, 0.965],
        [0.464, 0.530, 0.596, 0.662, 0.727, 0.792, 0.855, 0.921, 0.981]])
    delta_wot = ((n_ax2, mu_ax9), delta_data, "line")

    delta_ax9 = np.linspace(0.441, 1.0, 9)
    mu_data = np.zeros((2, 9))
    for i in range(2):
        mu_data[i] = _interp_line(delta_data[i], mu_ax9, delta_ax9)
    mu_wot = ((n_ax2, delta_ax9), mu_data, "line")

    n_data = np.array([n_stall, 0.667, 0.704, 0.741, 0.778, 0.815, 0.852,
                       0.889, 0.926, 0.963, 1.000, 1.074, n_max])
    mu_data3 = np.array([0.0, 0.568, 1.0])
    mu_knots = np.vstack([
        np.zeros(len(n_data)),
        np.full(len(n_data), 0.568),
        [1.000, 0.836, 0.854, 0.874, 0.898, 0.912, 0.939, 0.961, 0.959,
         0.958, 0.956, 0.953, 1.000]])
    pi_knots = np.vstack([
        np.zeros(len(n_data)),
        [0, 0.270, 0.305, 0.335, 0.360, 0.380, 0.405, 0.428, 0.450, 0.476,
         0.498, 0.498, 0],
        [0, 0.489, 0.548, 0.609, 0.680, 0.729, 0.810, 0.880, 0.920, 0.965,
         1.000, 0.950, 0]])
    pi_std_data = np.zeros((len(n_data), 3))
    for i in range(len(n_data)):
        pi_std_data[i] = _interp_line(mu_knots[:, i], pi_knots[:, i], mu_data3)
    pi_std = ((n_data, mu_data3), pi_std_data, "flat")

    n_data5 = np.array([n_stall, 0.667, 1.000, 1.074, n_max])
    delta_data3 = np.array([0.0, 0.441, 1.0])
    pi_wot_data = np.zeros((5, 3))
    pi_wot_data[:, 1] = [0, 0.23, 0.409, 0.409, 0]
    for i, n in enumerate(n_data5):
        mu_w = _eval2(mu_wot, n, 1.0)
        pi_wot_data[i, 2] = _eval2(pi_std, n, mu_w)
    pi_wot = ((n_data5, delta_data3), pi_wot_data, ("flat", "line"))

    f_ax = np.concatenate([[F_CUTOFF], np.linspace(F_LEAN, F_RICH, 10)])
    pi_ratio = ((f_ax,), np.array(
        [0.000, 0.8600, 0.9492, 0.9776, 0.9933, 1.000, 0.9983, 0.9910,
         0.9798, 0.9657, 0.9500]), "flat")
    sfc_ratio = ((f_ax,), np.array(
        [5, 0.8700, 0.8524, 0.8818, 0.9261, 0.9839, 1.0510, 1.1279,
         1.2135, 1.3163, 1.4280]), "flat")

    n_sfc = np.array([2000, 2200, 2400, 2600, 2700]) / 2700
    pi_sfc = 10 ** np.linspace(-1, 0, 8)
    sfc_data = 1e-7 * np.array([
        [1.7671, 1.43728, 1.19992, 1.02909, 0.906153, 0.817674, 0.753997, 0.708169],
        [1.83791, 1.49664, 1.25103, 1.07427, 0.947056, 0.855503, 0.789613, 0.742193],
        [1.98614, 1.60588, 1.3322, 1.13524, 0.993496, 0.891482, 0.818064, 0.765226],
        [2.11663, 1.70062, 1.40123, 1.18576, 1.03069, 0.919083, 0.838765, 0.780961],
        [2.33484, 1.85418, 1.50825, 1.2593, 1.08012, 0.951177, 0.858376, 0.791588]])
    sfc_pow = ((n_sfc, pi_sfc), sfc_data, "line")

    return dict(delta_wot=delta_wot, mu_wot=mu_wot, pi_std=pi_std,
                pi_wot=pi_wot, pi_ratio=pi_ratio, sfc_ratio=sfc_ratio,
                sfc_pow=sfc_pow)


class PistonEngine:
    """`piston.py:189-327`: x = {omega, idle, frc}, u = {start, stop,
    throttle, mixture, mixture_ctl}, s = {state} (int32 off/starting/
    running)."""

    def __init__(self, *, device, dtype, P_rated=hp2w(200),
                 omega_rated=rpm2radps(2700), omega_stall=rpm2radps(300),
                 omega_max=rpm2radps(3100), omega_idle=rpm2radps(600),
                 tau_start=40.0, J=0.05):
        self.P_rated = float(P_rated)
        self.omega_rated = float(omega_rated)
        self.omega_stall = float(omega_stall)
        self.omega_max = float(omega_max)
        self.omega_idle = float(omega_idle)
        self.tau_start = float(tau_start)
        self.J = float(J)
        self.table_data = build_tables(omega_stall / omega_rated,
                                       omega_max / omega_rated)
        self.tables = {k: Lookup(ax, v, ex, device=device, dtype=dtype)
                       for k, (ax, v, ex) in self.table_data.items()}
        self.idle = C.pi_params(k_p=4.0, k_i=2.0, bound_lo=-0.5,
                                bound_hi=0.5)
        self.frc = C.pi_params(k_p=5.0, k_i=200.0, bound_lo=-1.0,
                               bound_hi=1.0)

    def f_ode(self, x, u, s, air, tau_load, J_load):
        """Returns (x_dot, mdot)."""
        omega = x["omega"]
        state = s["state"]
        throttle = torch.clamp(u["throttle"], 0.0, 1.0)
        mixture = torch.clamp(u["mixture"], 0.0, 1.0)

        frc_dot, frc_out = C.pi_ode(self.frc, x["frc"], -omega)
        idle_dot, idle_out = C.pi_ode(self.idle, x["idle"],
                                      1.0 - divc(omega, self.omega_idle))

        mu_ratio_idle = 0.5 + idle_out.output
        n = divc(omega, self.omega_rated)
        delta = p2delta(air.p)

        k_f = 1.0 / torch.sqrt(divc(air.rho, RHO_STD))
        f_target = F_LEAN + mixture * (F_RICH - F_LEAN)
        mixture_pos = torch.where(u["mixture_ctl"] == MIX_MANUAL,
                                  0.5 * (mixture + 1.0),
                                  f_target / (k_f * F_RICH))
        f_run = k_f * F_RICH * mixture_pos

        T = self.tables
        mu_wot = T["mu_wot"](n, delta)
        pi_ratio_f = T["pi_ratio"](f_run)
        sfc_ratio_f = T["sfc_ratio"](f_run)
        mu = mu_wot * (mu_ratio_idle + throttle * (1.0 - mu_ratio_idle))

        delta_wot = T["delta_wot"](n, mu)
        pi_std = T["pi_std"](n, mu)
        pi_wot = T["pi_wot"](n, delta_wot)
        denom = delta_wot - 1.0
        degenerate = torch.abs(denom) < 5e-3
        denom_safe = torch.where(degenerate, torch.ones_like(denom), denom)
        pi_interp = pi_std + (pi_wot - pi_std) / denom_safe * (delta - 1.0)
        pi_isa = torch.clamp_min(torch.where(degenerate, pi_std, pi_interp),
                                 0.0)

        pi_pow = pi_isa * torch.sqrt(T_ISA(air.p) / air.T)
        pi_actual = pi_pow * pi_ratio_f
        P_run = self.P_rated * pi_actual
        omega_safe = torch.where(omega > 1e-3, omega, torch.ones_like(omega))
        tau_run = torch.where(omega > 0, P_run / omega_safe,
                              torch.zeros_like(omega))
        SFC_run = T["sfc_pow"](n, pi_actual) * sfc_ratio_f
        mdot_run = SFC_run * P_run

        tau_fr = frc_out.output * (0.01 * self.P_rated / self.omega_rated)

        off = state == ENG_OFF
        starting = state == ENG_STARTING
        running = state == ENG_RUNNING
        tau_shaft = torch.where(off, tau_fr, torch.where(
            starting, torch.full_like(omega, self.tau_start), tau_run))
        mdot = torch.where(running, mdot_run, torch.zeros_like(omega))

        omega_dot = divc(tau_shaft + tau_load, self.J + J_load)
        return {"omega": omega_dot, "idle": idle_dot, "frc": frc_dot}, mdot

    def f_step(self, x, u, s, fuel_available):
        """Engine state machine (`piston.py:309-327`), branch-free."""
        omega = x["omega"]
        state = s["state"]
        start, stop = u["start"], u["stop"]
        i32 = lambda v: torch.full_like(state, v)

        next_off = torch.where(start, i32(ENG_STARTING), i32(ENG_OFF))
        next_starting = torch.where(
            (omega > self.omega_idle) & fuel_available, i32(ENG_RUNNING),
            torch.where(~start, i32(ENG_OFF), i32(ENG_STARTING)))
        dies = stop | (omega < self.omega_stall) | ~fuel_available
        next_running = torch.where(dies, i32(ENG_OFF), i32(ENG_RUNNING))
        new_state = torch.where(
            state == ENG_OFF, next_off,
            torch.where(state == ENG_STARTING, next_starting, next_running))
        return x, {"state": new_state.to(torch.int32)}


class PistonThruster:
    """Engine + propeller + gear ratio (`piston.py:337-374`)."""

    def __init__(self, engine: PistonEngine, propeller: Propeller,
                 gear_ratio=1.0):
        self.engine = engine
        self.propeller = propeller
        self.gear_ratio = float(gear_ratio)
        if not np.sign(self.gear_ratio) * self.propeller.sense > 0:
            raise ValueError("gear ratio sign must match propeller sense")

    def f_ode(self, x, u, s, air, kin):
        """Returns (x_dot, mdot, PropellerY)."""
        gr = self.gear_ratio
        omega_prop = gr * x["engine"]["omega"]
        prop_y = self.propeller.output(kin, air, omega_prop)
        tau_eq = gr * prop_y.wr_p.tau[..., 0]
        J_eq = gr**2 * self.propeller.J_xx
        eng_dot, mdot = self.engine.f_ode(x["engine"], u["engine"],
                                          s["engine"], air, tau_eq, J_eq)
        return {"engine": eng_dot}, mdot, prop_y

    def f_step(self, x, u, s, fuel_available):
        xe, se = self.engine.f_step(x["engine"], u["engine"], s["engine"],
                                    fuel_available)
        return {"engine": xe}, {"engine": se}
