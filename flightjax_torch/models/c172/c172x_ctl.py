"""C172X gain-scheduled multimode control laws, all discrete (port of
`flightjax/models/c172/c172x_ctl.py`, the whole of it).

- longitudinal modes direct / sas / thr_q / thr_theta / thr_EAS / EAS_q /
  EAS_theta / EAS_clm / EAS_alt, a cascade of PIDs over inner LQR
  trackers, with the ground override to direct and the altitude
  acquire / hold state machine;
- lateral modes direct / sas / p_beta / phi_beta / chi_beta;
- anti-windup chaining (the inner LQR's previous output saturation halts
  the upstream integrators), bumpless mode transitions (integrators
  re-seeded from the current commands when the mode changes), gains
  interpolated from (EAS, h) schedules.

Every sub-controller is worked out on each firing and its state advances
where its branch is enabled, as masked selects over the fleet: these are
PyTorch ops on `[B]` leaves (or unbatched leaves for one aircraft). On the
card they run between the fleet step's kernels, as the JAX package runs
them as XLA glue between its Pallas kernels.
"""

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from flightjax_torch.core.modeling import divc, tree_map, tree_where
from flightjax_torch.ops.attitude import wrap_to_pi
from flightjax_torch.ops.interp import Lookup
from flightjax_torch.physics import control as C

GAINS_NPZ = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                         "data", "c172x_gains.npz")

# longitudinal modes (`c172x_ctl.py:36-38`)
LON_DIRECT, LON_SAS, LON_THR_Q, LON_THR_THETA, LON_THR_EAS, LON_EAS_Q, \
    LON_EAS_THETA, LON_EAS_CLM, LON_EAS_ALT = range(9)
# lateral modes (`:40`)
LAT_DIRECT, LAT_SAS, LAT_P_BETA, LAT_PHI_BETA, LAT_CHI_BETA = range(5)

ALT_ACQUIRE, ALT_HOLD = 0, 1


def load_gains(path=GAINS_NPZ, *, device, dtype):
    """The gain schedules as {channel: {name: Lookup over (EAS, h)}} with
    flat extrapolation (`c172x_design.py:334-345`)."""
    out = {}
    with np.load(path) as data:
        axes = (data["__EAS__"], data["__h__"])
        for key in data.files:
            if key.startswith("__"):
                continue
            ch, name = key.split("/")
            out.setdefault(ch, {})[name] = Lookup(
                axes, data[key], extrap="flat", device=device, dtype=dtype)
    return out


class FusedSchedule:
    """The gain schedules of some channels evaluated as one `Lookup`: all
    their tables lie over the same grid (`load_gains` reads one (EAS, h)
    pair of axes), so their values stack on a trailing axis and one
    interpolation serves them all. Each value is worked out by the same
    operations as its own Lookup would (the same cell, weights and corner
    order), so the result is the same as `control.schedule`'s; the fleet
    pays one gather per corner instead of one per table."""

    def __init__(self, gains, channels):
        tables = [(ch, name, lk) for ch in channels
                  for name, lk in gains[ch].items()]
        first = tables[0][2]
        for ch, name, lk in tables:
            if not (len(lk.axes) == len(first.axes)
                    and lk.extrap == first.extrap
                    and all(torch.equal(a, b)
                            for a, b in zip(lk.axes, first.axes))):
                raise ValueError(
                    f"gain table {ch}/{name} does not share the grid and "
                    f"extrapolation of {tables[0][0]}/{tables[0][1]}")
        d = len(first.axes)
        self.split = [(ch, name, tuple(lk.values.shape[d:]))
                      for ch, name, lk in tables]
        values = torch.cat([lk.values.reshape(lk.values.shape[:d] + (-1,))
                            for _, _, lk in tables], dim=-1)
        self.lookup = Lookup([a.cpu().double().numpy() for a in first.axes],
                             values.cpu().double().numpy(), first.extrap,
                             device=first.values.device,
                             dtype=first.values.dtype)

    def __call__(self, *coords):
        flat = self.lookup(*coords)
        out, o = {}, 0
        for ch, name, tail in self.split:
            n = math.prod(tail)
            out.setdefault(ch, {})[name] = flat[..., o:o + n].reshape(
                flat.shape[:-1] + tail)
            o += n
        return out


LON_CHANNELS = ("v2t", "c2theta", "q2e", "te2te", "tv2te", "vh2te")
LAT_CHANNELS = ("p2phi", "chi2phi", "ar2ar", "phibeta2ar")


def _isin(mode, modes):
    out = torch.zeros_like(mode, dtype=torch.bool)
    for m in modes:
        out = out | (mode == m)
    return out


def _full(v, like):
    return torch.full_like(like, v)


def _pid_params(g, bound_lo=-C.INF, bound_hi=C.INF):
    return C.pid_params(k_p=g["k_p"], k_i=g["k_i"], k_d=g["k_d"],
                        tau_f=g["tau_f"], bound_lo=bound_lo,
                        bound_hi=bound_hi)


def _lqr_params(g, lo, hi):
    like = g["u_trim"]
    return C.LQRParams(K_fbk=g["K_fbk"], K_fwd=g["K_fwd"], K_int=g["K_int"],
                       x_trim=g["x_trim"], u_trim=g["u_trim"],
                       z_trim=g["z_trim"],
                       bound_lo=torch.tensor(lo, dtype=like.dtype,
                                             device=like.device),
                       bound_hi=torch.tensor(hi, dtype=like.dtype,
                                             device=like.device))


def _pid_reset(s_pid, seed, k_i):
    """The PID re-seeded on a mode change (`c172x_ctl.py:75-80`)."""
    x_i0 = torch.where(k_i != 0, seed, torch.zeros_like(seed))
    return C.PIDState(x_i0=x_i0, x_d0=torch.zeros_like(s_pid.x_d0),
                      sat_out_0=torch.zeros_like(s_pid.sat_out_0))


def _int_reset(s_int):
    return C.IntegratorState(x0=torch.zeros_like(s_int.x0),
                             sat_out_0=torch.zeros_like(s_int.sat_out_0))


def _lqr_reset(s_lqr):
    return tree_map(torch.zeros_like, s_lqr)


def flaps_schedule(EAS):
    return torch.clamp(1.0 - divc(EAS - 30.0, 5.0), 0.0, 1.0)


# ----------------------------------------------------------- vehicle feature
# extraction (`c172x_ctl.py:88-119`)

def x_lon_red(y):
    act = y.systems.act["pos"]
    k = y.kinematics
    return torch.stack([
        k.omega_eb_b[..., 1], k.e_nb[..., 1], y.airflow.EAS,
        y.systems.aero.alpha, y.systems.aero.alpha_filt,
        y.systems.pwp.engine.n, act["throttle"], act["elevator"]], dim=-1)


def x_lon_full(y):
    act = y.systems.act["pos"]
    k = y.kinematics
    return torch.stack([
        k.omega_eb_b[..., 1], k.e_nb[..., 1], y.airflow.EAS,
        y.systems.aero.alpha, k.h_e, y.systems.aero.alpha_filt,
        y.systems.pwp.engine.n, act["throttle"], act["elevator"]], dim=-1)


def x_lat_red(y):
    act = y.systems.act["pos"]
    k = y.kinematics
    return torch.stack([
        k.omega_eb_b[..., 0], k.omega_eb_b[..., 2], k.e_nb[..., 2],
        y.airflow.EAS, y.systems.aero.beta, y.systems.aero.beta_filt,
        act["aileron"], act["rudder"]], dim=-1)


def is_on_gnd(y):
    return torch.any(y.systems.ldg.strut.wow, dim=-1)


class LonY(NamedTuple):
    mode: torch.Tensor
    throttle_ref: torch.Tensor
    elevator_ref: torch.Tensor
    q_ref: torch.Tensor
    theta_ref: torch.Tensor
    EAS_ref: torch.Tensor
    clm_ref: torch.Tensor
    h_ref: torch.Tensor
    h_state: torch.Tensor
    throttle_cmd: torch.Tensor
    elevator_cmd: torch.Tensor


class LatY(NamedTuple):
    mode: torch.Tensor
    aileron_ref: torch.Tensor
    rudder_ref: torch.Tensor
    p_ref: torch.Tensor
    beta_ref: torch.Tensor
    phi_ref: torch.Tensor
    chi_ref: torch.Tensor
    aileron_cmd: torch.Tensor
    rudder_cmd: torch.Tensor


class CtlY(NamedTuple):
    lon: LonY
    lat: LatY


class ControlLaws:
    """Avionics of the Aircraft protocol: the lon and lat cascades
    (`c172x_ctl.py:153-516`). `gains` defaults to `load_gains()` on
    `device` in `dtype`, which also type the inputs and states it
    makes."""

    K_P_THETA = 1.0   # theta -> q proportional gain
    H_THR = 10.0      # altitude tracking mode switch threshold
    H_HYS = 1.0       # and its hysteresis

    def __init__(self, gains=None, *, device, dtype):
        self.device, self.dtype = torch.device(device), dtype
        self.gains = (load_gains(device=device, dtype=dtype)
                      if gains is None else gains)
        self.lon_gains = FusedSchedule(self.gains, LON_CHANNELS)
        self.lat_gains = FusedSchedule(self.gains, LAT_CHANNELS)

    def _f(self, v, shape=()):
        return torch.full(shape, v, dtype=self.dtype, device=self.device)

    def _i(self, v, shape=()):
        return torch.full(shape, v, dtype=torch.int32, device=self.device)

    # -------------------------------------------------------------- inputs

    def init_u(self, shape=()):
        """The inputs of `shape` aircraft (`c172x_ctl.py:168-193`)."""
        f = lambda v: self._f(v, shape)
        i = lambda v: self._i(v, shape)
        return {
            "lon": {"mode_req": i(LON_DIRECT), "throttle_axis": f(0.0),
                    "throttle_offset": f(0.0), "elevator_axis": f(0.0),
                    "elevator_offset": f(0.0), "q_ref": f(0.0),
                    "theta_ref": f(0.0), "EAS_ref": f(50.0),
                    "clm_ref": f(0.0), "h_ref": f(0.0)},
            "lat": {"mode_req": i(LAT_DIRECT), "aileron_axis": f(0.0),
                    "aileron_offset": f(0.0), "rudder_axis": f(0.0),
                    "rudder_offset": f(0.0), "p_ref": f(0.0),
                    "beta_ref": f(0.0), "phi_ref": f(0.0),
                    "chi_ref": f(0.0)},
        }

    def init_s(self, shape=()):
        """The discrete state of `shape` aircraft (`c172x_ctl.py:195-
        214`)."""
        f = lambda v: self._f(v, shape)
        i = lambda v: self._i(v, shape)
        kw = dict(dtype=self.dtype, device=self.device)
        lqr = lambda: C.LQRState(
            int_out_0=self._f(0.0, shape + (2,)),
            out_sat_0=self._i(0, shape + (2,)))
        integ = lambda: C.IntegratorState(x0=f(0.0), sat_out_0=i(0))
        return {
            "lon": {
                "mode_prev": i(LON_DIRECT), "h_state": i(ALT_HOLD),
                "te2te": lqr(), "tv2te": lqr(), "vh2te": lqr(),
                "q2e_int": integ(),
                "q2e_pid": C.pid_state(shape, **kw),
                "c2theta_pid": C.pid_state(shape, **kw),
                "v2t_pid": C.pid_state(shape, **kw),
                "prev_throttle_cmd": f(0.0), "prev_te_zref_ele": f(0.0),
                "out": {"throttle_cmd": f(0.0), "elevator_cmd": f(0.0)},
            },
            "lat": {
                "mode_prev": i(LAT_DIRECT),
                "ar2ar": lqr(), "pb2ar": lqr(),
                "p2phi_int": integ(),
                "p2phi_pid": C.pid_state(shape, **kw),
                "chi2phi_pid": C.pid_state(shape, **kw),
                "prev_pb_zref_phi": f(0.0),
                "out": {"aileron_cmd": f(0.0), "rudder_cmd": f(0.0)},
            },
        }

    # ------------------------------------------------------------ lon pass

    def lon_step(self, s, u, y, dt):
        """(`c172x_ctl.py:218-373`)"""
        kin = y.kinematics
        EAS = y.airflow.EAS
        h_e = kin.h_e
        q = kin.omega_wb_b[..., 1]
        r = kin.omega_wb_b[..., 2]
        theta = kin.e_nb[..., 1]
        phi = kin.e_nb[..., 2]
        clm = -kin.v_eb_n[..., 2]
        h_err = u["h_ref"] - h_e
        mode_prev = s["mode_prev"]
        act_cmd = y.systems.act["cmd"]
        gains = self.lon_gains(EAS, h_e)
        sched = gains.__getitem__

        throttle_ref = torch.clamp(
            torch.clamp(u["throttle_axis"], 0, 1) + u["throttle_offset"],
            0.0, 1.0)
        elevator_ref = torch.clamp(
            torch.clamp(u["elevator_axis"], -1, 1) + u["elevator_offset"],
            -1.0, 1.0)

        # mode arbitration + altitude acquire/hold FSM
        h_state = s["h_state"]
        acquiring = h_state == ALT_ACQUIRE
        alt_req = u["mode_req"] == LON_EAS_ALT
        mode_req = torch.broadcast_to(u["mode_req"], h_err.shape)
        mode_air = torch.where(
            alt_req, torch.where(acquiring, _full(LON_THR_EAS, mode_req),
                                 _full(LON_EAS_ALT, mode_req)), mode_req)
        throttle_ref = torch.where(
            alt_req & acquiring,
            torch.where(h_err > 0, torch.ones_like(h_err),
                        torch.zeros_like(h_err)), throttle_ref)
        hs = torch.broadcast_to(h_state, h_err.shape)
        hold, acq = _full(ALT_HOLD, hs), _full(ALT_ACQUIRE, hs)
        h_state_new = torch.where(
            alt_req,
            torch.where(acquiring,
                        torch.where(torch.abs(h_err)
                                    < self.H_THR - self.H_HYS, hold, acq),
                        torch.where(torch.abs(h_err)
                                    > self.H_THR + self.H_HYS, acq, hold)),
            hs)
        mode = torch.where(is_on_gnd(y), _full(LON_DIRECT, mode_air),
                           mode_air)
        changed = mode != mode_prev

        te2te_on = _isin(mode, (LON_SAS, LON_THR_Q, LON_THR_THETA,
                                LON_EAS_Q, LON_EAS_THETA, LON_EAS_CLM))
        q2e_on = _isin(mode, (LON_THR_Q, LON_THR_THETA, LON_EAS_Q,
                              LON_EAS_THETA, LON_EAS_CLM))
        t2q_on = _isin(mode, (LON_THR_THETA, LON_EAS_THETA, LON_EAS_CLM))
        v2t_on = _isin(mode, (LON_EAS_Q, LON_EAS_THETA, LON_EAS_CLM))
        c2t_on = mode == LON_EAS_CLM
        tv2te_on = mode == LON_THR_EAS
        vh2te_on = mode == LON_EAS_ALT

        # the previous te2te saturation feeds the upstream compensators
        sat_thr = s["te2te"].out_sat_0[..., 0]
        sat_ele = s["te2te"].out_sat_0[..., 1]

        # ---- v2t: EAS -> throttle_ref
        pv = _pid_params(sched("v2t"))
        s_v2t = tree_where(
            changed & v2t_on,
            _pid_reset(s["v2t_pid"], s["prev_throttle_cmd"], pv.k_i),
            s["v2t_pid"])
        s_v2t_new, v2t_out = C.pid_step(pv, s_v2t, u["EAS_ref"] - EAS, dt,
                                        sat_ext=sat_thr)
        s_v2t_final = tree_where(v2t_on, s_v2t_new, s["v2t_pid"])
        throttle_ref = torch.where(v2t_on, v2t_out.output, throttle_ref)

        # ---- c2theta: climb rate -> theta_ref
        pc = _pid_params(sched("c2theta"))
        s_c2t = tree_where(
            changed & c2t_on,
            _pid_reset(s["c2theta_pid"], theta, pc.k_i), s["c2theta_pid"])
        s_c2t_new, c2t_out = C.pid_step(pc, s_c2t, u["clm_ref"] - clm, dt,
                                        sat_ext=sat_ele)
        s_c2t_final = tree_where(c2t_on, s_c2t_new, s["c2theta_pid"])
        theta_ref = torch.where(c2t_on, c2t_out.output, u["theta_ref"])

        # ---- theta2q with bank compensation
        theta_dot_ref = self.K_P_THETA * (theta_ref - theta)
        phi_bnd = torch.clamp(phi, -math.pi / 3, math.pi / 3)
        q_ref_t2q = theta_dot_ref / torch.cos(phi_bnd) + r * torch.tan(
            phi_bnd)
        q_ref = torch.where(t2q_on, q_ref_t2q, u["q_ref"])

        # ---- q2e: pitch rate -> elevator_ref
        pq = _pid_params(sched("q2e"))
        q2e_changed = changed & q2e_on
        s_q2e_int = tree_where(q2e_changed, _int_reset(s["q2e_int"]),
                               s["q2e_int"])
        s_q2e_pid = tree_where(
            q2e_changed,
            _pid_reset(s["q2e_pid"], s["prev_te_zref_ele"], pq.k_i),
            s["q2e_pid"])
        s_int_new, int_out = C.integrator_step(s_q2e_int, q_ref - q, dt,
                                               sat_ext=sat_ele)
        s_pid_new, q2e_out = C.pid_step(pq, s_q2e_pid, int_out.output, dt,
                                        sat_ext=sat_ele)
        s_int_final = tree_where(q2e_on, s_int_new, s["q2e_int"])
        s_pid_final = tree_where(q2e_on, s_pid_new, s["q2e_pid"])
        elevator_ref = torch.where(q2e_on, q2e_out.output, elevator_ref)

        # ---- te2te SAS LQR: purely proportional, no reset
        p_te = _lqr_params(sched("te2te"), [0.0, -1.0], [1.0, 1.0])
        x_red = x_lon_red(y)
        z_te = torch.stack([act_cmd["throttle"], act_cmd["elevator"]],
                           dim=-1)
        z_ref_te = torch.stack([throttle_ref, elevator_ref], dim=-1)
        s_te_new, te_out = C.lqr_step(p_te, s["te2te"], x_red, z_te,
                                      z_ref_te, dt)
        s_te_final = tree_where(te2te_on, s_te_new, s["te2te"])
        throttle_cmd = torch.where(te2te_on, te_out.output[..., 0],
                                   throttle_ref)
        elevator_cmd = torch.where(te2te_on, te_out.output[..., 1],
                                   elevator_ref)

        # ---- tv2te: throttle + EAS tracker
        p_tv = _lqr_params(sched("tv2te"), [0.0, -1.0], [1.0, 1.0])
        s_tv = tree_where(changed & tv2te_on, _lqr_reset(s["tv2te"]),
                          s["tv2te"])
        z_tv = torch.stack([act_cmd["throttle"], EAS], dim=-1)
        z_ref_tv = torch.stack([throttle_ref, torch.broadcast_to(
            u["EAS_ref"], throttle_ref.shape)], dim=-1)
        s_tv_new, tv_out = C.lqr_step(p_tv, s_tv, x_red, z_tv, z_ref_tv, dt)
        s_tv_final = tree_where(tv2te_on, s_tv_new, s["tv2te"])
        throttle_cmd = torch.where(tv2te_on, tv_out.output[..., 0],
                                   throttle_cmd)
        elevator_cmd = torch.where(tv2te_on, tv_out.output[..., 1],
                                   elevator_cmd)

        # ---- vh2te: EAS + altitude tracker
        p_vh = _lqr_params(sched("vh2te"), [0.0, -1.0], [1.0, 1.0])
        s_vh = tree_where(changed & vh2te_on, _lqr_reset(s["vh2te"]),
                          s["vh2te"])
        z_vh = torch.stack([EAS, h_e], dim=-1)
        z_ref_vh = torch.stack(torch.broadcast_tensors(u["EAS_ref"],
                                                       u["h_ref"], EAS)[:2],
                               dim=-1)
        s_vh_new, vh_out = C.lqr_step(p_vh, s_vh, x_lon_full(y), z_vh,
                                      z_ref_vh, dt)
        s_vh_final = tree_where(vh2te_on, s_vh_new, s["vh2te"])
        throttle_cmd = torch.where(vh2te_on, vh_out.output[..., 0],
                                   throttle_cmd)
        elevator_cmd = torch.where(vh2te_on, vh_out.output[..., 1],
                                   elevator_cmd)

        s_new = {
            "mode_prev": mode, "h_state": h_state_new,
            "te2te": s_te_final, "tv2te": s_tv_final, "vh2te": s_vh_final,
            "q2e_int": s_int_final, "q2e_pid": s_pid_final,
            "c2theta_pid": s_c2t_final, "v2t_pid": s_v2t_final,
            "prev_throttle_cmd": throttle_cmd,
            "prev_te_zref_ele": elevator_ref,
            "out": {"throttle_cmd": throttle_cmd,
                    "elevator_cmd": elevator_cmd},
        }
        y_out = LonY(mode=mode, throttle_ref=throttle_ref,
                     elevator_ref=elevator_ref, q_ref=q_ref,
                     theta_ref=theta_ref, EAS_ref=u["EAS_ref"],
                     clm_ref=u["clm_ref"], h_ref=u["h_ref"],
                     h_state=h_state_new, throttle_cmd=throttle_cmd,
                     elevator_cmd=elevator_cmd)
        return s_new, y_out

    # ------------------------------------------------------------ lat pass

    def lat_step(self, s, u, y, dt):
        """(`c172x_ctl.py:377-463`)"""
        kin = y.kinematics
        EAS = y.airflow.EAS
        h_e = kin.h_e
        p = kin.omega_wb_b[..., 0]
        chi = kin.chi_gnd
        mode_prev = s["mode_prev"]
        act_cmd = y.systems.act["cmd"]
        gains = self.lat_gains(EAS, h_e)
        sched = gains.__getitem__

        mode_req = torch.broadcast_to(u["mode_req"], EAS.shape)
        mode = torch.where(is_on_gnd(y), _full(LAT_DIRECT, mode_req),
                           mode_req)
        changed = mode != mode_prev

        ar2ar_on = mode == LAT_SAS
        pb2ar_on = _isin(mode, (LAT_P_BETA, LAT_PHI_BETA, LAT_CHI_BETA))
        p2phi_on = mode == LAT_P_BETA
        chi2phi_on = mode == LAT_CHI_BETA

        aileron_ref = torch.clamp(
            torch.clamp(u["aileron_axis"], -1, 1) + u["aileron_offset"],
            -1, 1)
        rudder_ref = torch.clamp(
            torch.clamp(u["rudder_axis"], -1, 1) + u["rudder_offset"], -1, 1)

        sat_ail = s["pb2ar"].out_sat_0[..., 0]

        # ---- p2phi: roll rate -> phi_ref
        pp = _pid_params(sched("p2phi"))
        s_p2phi_int = tree_where(changed & p2phi_on,
                                 _int_reset(s["p2phi_int"]), s["p2phi_int"])
        s_p2phi_pid = tree_where(
            changed & p2phi_on,
            _pid_reset(s["p2phi_pid"], s["prev_pb_zref_phi"], pp.k_i),
            s["p2phi_pid"])
        s_pint_new, pint_out = C.integrator_step(
            s_p2phi_int, u["p_ref"] - p, dt, sat_ext=sat_ail)
        s_ppid_new, p2phi_out = C.pid_step(pp, s_p2phi_pid, pint_out.output,
                                           dt, sat_ext=sat_ail)
        s_pint_final = tree_where(p2phi_on, s_pint_new, s["p2phi_int"])
        s_ppid_final = tree_where(p2phi_on, s_ppid_new, s["p2phi_pid"])

        # ---- chi2phi: course angle -> phi_ref, error wrapped
        pc = _pid_params(sched("chi2phi"), bound_lo=-math.pi / 4,
                         bound_hi=math.pi / 4)
        s_chi2phi = tree_where(
            changed & chi2phi_on,
            _pid_reset(s["chi2phi_pid"], s["prev_pb_zref_phi"], pc.k_i),
            s["chi2phi_pid"])
        s_cpid_new, chi2phi_out = C.pid_step(
            pc, s_chi2phi, wrap_to_pi(u["chi_ref"] - chi), dt,
            sat_ext=sat_ail)
        s_cpid_final = tree_where(chi2phi_on, s_cpid_new, s["chi2phi_pid"])

        phi_ref = torch.where(p2phi_on, p2phi_out.output,
                              torch.where(chi2phi_on, chi2phi_out.output,
                                          u["phi_ref"]))

        x_lat = x_lat_red(y)

        # ---- ar2ar SAS: no reset needed
        p_ar = _lqr_params(sched("ar2ar"), [-1.0, -1.0], [1.0, 1.0])
        z_ar = torch.stack([act_cmd["aileron"], act_cmd["rudder"]], dim=-1)
        z_ref_ar = torch.stack(torch.broadcast_tensors(
            aileron_ref, rudder_ref, EAS)[:2], dim=-1)
        s_ar_new, ar_out = C.lqr_step(p_ar, s["ar2ar"], x_lat, z_ar,
                                      z_ref_ar, dt)
        s_ar_final = tree_where(ar2ar_on, s_ar_new, s["ar2ar"])
        aileron_cmd = torch.where(ar2ar_on, ar_out.output[..., 0],
                                  aileron_ref)
        rudder_cmd = torch.where(ar2ar_on, ar_out.output[..., 1], rudder_ref)

        # ---- phibeta2ar tracker
        p_pb = _lqr_params(sched("phibeta2ar"), [-1.0, -1.0], [1.0, 1.0])
        s_pb = tree_where(changed & pb2ar_on, _lqr_reset(s["pb2ar"]),
                          s["pb2ar"])
        z_pb = torch.stack([kin.e_nb[..., 2], y.systems.aero.beta], dim=-1)
        z_ref_pb = torch.stack(torch.broadcast_tensors(
            phi_ref, u["beta_ref"], EAS)[:2], dim=-1)
        s_pb_new, pb_out = C.lqr_step(p_pb, s_pb, x_lat, z_pb, z_ref_pb, dt)
        s_pb_final = tree_where(pb2ar_on, s_pb_new, s["pb2ar"])
        aileron_cmd = torch.where(pb2ar_on, pb_out.output[..., 0],
                                  aileron_cmd)
        rudder_cmd = torch.where(pb2ar_on, pb_out.output[..., 1], rudder_cmd)

        s_new = {
            "mode_prev": mode,
            "ar2ar": s_ar_final, "pb2ar": s_pb_final,
            "p2phi_int": s_pint_final, "p2phi_pid": s_ppid_final,
            "chi2phi_pid": s_cpid_final,
            "prev_pb_zref_phi": phi_ref,
            "out": {"aileron_cmd": aileron_cmd, "rudder_cmd": rudder_cmd},
        }
        y_out = LatY(mode=mode, aileron_ref=aileron_ref,
                     rudder_ref=rudder_ref, p_ref=u["p_ref"],
                     beta_ref=u["beta_ref"], phi_ref=phi_ref,
                     chi_ref=u["chi_ref"], aileron_cmd=aileron_cmd,
                     rudder_cmd=rudder_cmd)
        return s_new, y_out

    # -------------------------------------------------- avionics protocol

    def f_periodic(self, s, u, veh_y, dt):
        s_lon, y_lon = self.lon_step(s["lon"], u["lon"], veh_y, dt)
        s_lat, y_lat = self.lat_step(s["lat"], u["lat"], veh_y, dt)
        return {"lon": s_lon, "lat": s_lat}, CtlY(lon=y_lon, lat=y_lat)

    def assign(self, u_systems, av_y: CtlY):
        """The commands onto the fly-by-wire actuation inputs
        (`c172x_ctl.py:472-481`)."""
        act = dict(u_systems["act"], throttle=av_y.lon.throttle_cmd,
                   elevator=av_y.lon.elevator_cmd,
                   aileron=av_y.lat.aileron_cmd,
                   rudder=av_y.lat.rudder_cmd)
        return dict(u_systems, act=act)

    def output(self, s, u, veh_y):
        """The carried commands (`c172x_ctl.py:483-485`)."""
        return {"lon": s["lon"]["out"], "lat": s["lat"]["out"]}

    # -------------------------------------------------------------- init

    def init_from_trim(self, veh_y, dt):
        """Bumpless start (`c172x_ctl.py:489-516`): the inputs seeded from
        the trim condition and each SAS mode run once, so the LQR and PID
        outputs match the trim's actuator commands before the first
        firing."""
        shape = tuple(veh_y.airflow.EAS.shape)
        u = self.init_u(shape)
        s = self.init_s(shape)
        act_pos = veh_y.systems.act["pos"]
        kin = veh_y.kinematics
        u["lon"].update(
            throttle_axis=act_pos["throttle"],
            elevator_axis=act_pos["elevator"], q_ref=kin.omega_wb_b[..., 1],
            theta_ref=kin.e_nb[..., 1], EAS_ref=veh_y.airflow.EAS,
            clm_ref=-kin.v_eb_n[..., 2], h_ref=kin.h_e)
        u["lat"].update(
            aileron_axis=act_pos["aileron"], rudder_axis=act_pos["rudder"],
            p_ref=kin.omega_wb_b[..., 0], phi_ref=kin.e_nb[..., 2],
            beta_ref=veh_y.systems.aero.beta, chi_ref=kin.chi_gnd)
        s["lon"]["prev_throttle_cmd"] = act_pos["throttle"]
        s["lon"]["prev_te_zref_ele"] = act_pos["elevator"]
        s["lat"]["prev_pb_zref_phi"] = kin.e_nb[..., 2]
        for mode in (LON_SAS, LON_THR_EAS, LON_EAS_ALT, LON_DIRECT):
            u["lon"]["mode_req"] = self._i(mode, shape)
            s["lon"], _ = self.lon_step(s["lon"], u["lon"], veh_y, dt)
        for mode in (LAT_SAS, LAT_PHI_BETA, LAT_DIRECT):
            u["lat"]["mode_req"] = self._i(mode, shape)
            s["lat"], _ = self.lat_step(s["lat"], u["lat"], veh_y, dt)
        return u, s
