"""In-loop navigation avionics: the sensor suite and the fused INS/GPS
filter between the vehicle's truth and an inner avionics (port of
`flightjax/physics/navigation.py`, whole).

    truth (VehicleY) -> SensorSuite.measure -> fault injection
        -> InsGps (predict every firing; the GPS / baro / mag / radar aiding
           as one stacked masked Joseph update) -> innovation monitors
        -> the estimated VehicleY -> the inner avionics (ControlLaws, the
           C172Xv2's guidance and control laws)

Fleet-shaped PyTorch: every leaf of the avionics' trees leads with the
batch's shape, and the pass runs as tensor code on the state's device (the
inner laws then run as their own pass kernel in the fleet step,
`parallel/clusterstep.py::_periodic`). `nav_pass` is the part before the
inner avionics, `f_periodic` the whole pass.

The aiding-epoch gate. The reference hoists the stacked monitored block
behind a fleet-level scalar `lax.cond` whose predicate it reads from the
sensors' epoch counter (`epoch_preds`, `core/sim.py:375-389`); where no
lane has an aiding epoch the block is skipped, exactly. Here the caller
passes that predicate (`aid`), `epoch_gate` of the lanes' own epoch
counters (`kernels.nav_pass_plain`) or of a host counter: True runs the
block, False skips it, None runs it ungated (the reference's
`Simulation.step`).

Four findings of the reference's review (ADVICE.md) are carried as the
reference has them, and the port matches it on each (ROADMAP Queue 3):
- under `defer_cov`, P compounds on the fastest aiding cadence `p_every`;
  with non-nested cadences an update on another channel's epoch may see P
  stale by fewer than `p_every` firings (`navigation.py:238-251`);
- `propagate_P` truncates the transition at second order
  (`estimation.py:793`);
- `_gain`'s m > 3 path is the unrolled Cholesky, which the stacked update
  never reaches (`estimation.py:143`);
- a monitor window holds at most 32 epochs (`estimation.py:1018`).
"""

import math
from typing import NamedTuple

import torch

from flightjax_torch.core.modeling import bwhere, tree_map
from flightjax_torch.ops import geodesy as geo
from flightjax_torch.ops.attitude import quat_to_euler
from flightjax_torch.ops.quaternions import qmul, qrot_inv
from flightjax_torch.physics.atmosphere import GAMMA, R_GAS, RHO_STD
from flightjax_torch.physics.sensors import (SensorData, SensorSuite,
                                             mag_field_dipole, param_tensors,
                                             pressure_altitude, suite_params)
from flightjax_torch.utils.estimation import (InsGps, innovation_monitor,
                                              ned_from_geodetic, nis,
                                              qnormalize, rvec_to_quat)

# the fault spec's enums (u["fault"], `navigation.py:98-109`)
FAULT_NONE, FAULT_GPS, FAULT_BARO, FAULT_GPS_VEL, FAULT_MAG = 0, 1, 2, 3, 4
MODE_FREEZE, MODE_BIAS, MODE_DROPOUT, MODE_RAMP = 0, 1, 2, 3

NEVER = 2 ** 31 - 1


def no_fault(shape, device, dtype):
    """The inactive fault spec (k0 = never) over a batch of `shape`."""
    i = lambda v: torch.full(shape, v, dtype=torch.int32, device=device)
    return {"channel": i(FAULT_NONE), "mode": i(MODE_FREEZE), "k0": i(NEVER),
            "k1": i(NEVER),
            "delta": torch.zeros(shape, dtype=dtype, device=device)}


def estimate_airspeed(z: SensorData):
    """(TAS, EAS) from the measured pitot-static pressures and OAT, the
    inverse of the truth's air data (`navigation.py:143-155`)."""
    Dp = torch.clamp_min(z.p_t - z.p_s, 0.0)
    M2 = 2.0 / (GAMMA - 1) * ((1.0 + Dp / z.p_s) ** ((GAMMA - 1) / GAMMA)
                              - 1.0)
    a = torch.sqrt(GAMMA * R_GAS * z.T_oat)
    TAS = torch.sqrt(M2) * a
    rho = z.p_s / (R_GAS * z.T_oat)
    return TAS, TAS * torch.sqrt(rho / RHO_STD)


class NavY(NamedTuple):
    """The navigation output of one firing (`navigation.py:158-177`)."""
    q_nb: torch.Tensor
    b_g: torch.Tensor
    p_n: torch.Tensor
    v_n: torch.Tensor
    b_a: torch.Tensor
    h_est: torch.Tensor
    EAS_est: torch.Tensor
    nis_gps: torch.Tensor
    nis_gps_vel: torch.Tensor
    nis_baro: torch.Tensor
    nis_mag: torch.Tensor
    nis_radar: torch.Tensor
    gps_alarm: torch.Tensor
    baro_alarm: torch.Tensor
    mag_alarm: torch.Tensor
    radar_alarm: torch.Tensor
    z: SensorData


def _v(pred, like):
    """A per-lane predicate against `like`'s trailing axes."""
    return pred.reshape(pred.shape + (1,) * (like.dim() - pred.dim()))


class NavAvionics:
    """The sensor and estimation stage around an inner avionics
    (`navigation.py:180-778`). `dt` is the periodic interval (the sensor
    and filter rate); `use_estimates=False` runs the stack in shadow mode,
    the inner avionics flying on the truth. The state tree: the sensors'
    error processes, the filter, the deferred transition's accumulator,
    the fault hold registers, the last NIS of each channel and the five
    monitors."""

    needs_terrain = True  # Aircraft.f_periodic passes h_trn

    def __init__(self, inner, dt, gps_every=10, mag_every=5, baro_every=5,
                 params=None, use_estimates=True, gps_gate=16.27,
                 vel_gate=21.11, baro_gate=10.83, mag_gate=16.27,
                 radar_gate=10.83, monitor_window=6, monitor_min_hits=3,
                 filter_kw=None, use_radar=False, radar_every=None,
                 radar_max_agl=150.0, alpha_beta="truth", geomag="dipole",
                 defer_cov=True, *, device, dtype):
        self.inner = inner
        self.device, self.dtype = torch.device(device), dtype
        self.dt = float(dt)
        self.use_estimates = bool(use_estimates)
        self.suite = SensorSuite(dt=dt, gps_every=gps_every)
        self.mag_every = int(mag_every)
        self.baro_every = int(baro_every)
        self.use_radar = bool(use_radar)
        self.radar_every = int(baro_every if radar_every is None
                               else radar_every)
        self.radar_max_agl = float(radar_max_agl)
        self.alpha_beta = alpha_beta
        self.geomag = geomag
        self.defer_cov = bool(defer_cov)
        self.p_every = min(self.everys())
        p = params if params is not None else suite_params()
        self._params = p
        f = lambda d, k: float(torch.as_tensor(d[k], dtype=torch.float64))
        kw = {"sigma_gyro": f(p["imu"], "sigma_gyro"),
              "rw_gyro": f(p["imu"], "rw_gyro"),
              "sigma_accel": f(p["imu"], "sigma_accel"),
              "rw_accel": f(p["imu"], "rw_accel"),
              "sigma_mag": max(f(p["mag"], "sigma"), 1e-9),
              "B_n": torch.as_tensor(p["mag"]["B_n"], dtype=torch.float64),
              "sigma_gps_pos": max(math.hypot(f(p["gps"], "sigma_pos"),
                                              f(p["gps"], "gm_sigma")), 1e-3),
              "sigma_gps_vel": max(f(p["gps"], "sigma_vel"), 1e-3),
              "sigma_baro": max(f(p["baro"], "sigma"), 1e-3) + 1.0}
        kw.update(filter_kw or {})
        self.filter = InsGps(dt=dt, **kw)
        self.gps_gate = float(gps_gate)
        self.vel_gate = float(vel_gate)
        self.baro_gate = float(baro_gate)
        self.mag_gate = float(mag_gate)
        self.radar_gate = float(radar_gate)
        self.monitor_window = int(monitor_window)
        self.monitor_min_hits = int(monitor_min_hits)
        mk = dict(window=monitor_window, min_hits=monitor_min_hits)
        self.monitors = {name: innovation_monitor(gate, **mk) for name, gate
                         in (("gps", gps_gate), ("vel", vel_gate),
                             ("baro", baro_gate), ("mag", mag_gate),
                             ("radar", radar_gate))}

    def everys(self):
        """The aiding cadences: GPS, baro, mag (and radar)."""
        out = [self.suite.gps_every, self.baro_every, self.mag_every]
        if self.use_radar:
            out.append(self.radar_every)
        return out

    # ------------------------------------------------------------- protocol

    def _z(self, shape, n=()):
        return torch.zeros(tuple(shape) + n, dtype=self.dtype,
                           device=self.device)

    def init_u(self, shape=()):
        shape = tuple(shape)
        return {"inner": self.inner.init_u(shape),
                "sens": {"seed": torch.zeros(shape, dtype=torch.int32,
                                             device=self.device),
                         "params": param_tensors(self._params, shape,
                                                 self.device, self.dtype)},
                "origin": {"lat0": self._z(shape), "lon0": self._z(shape),
                           "h0": self._z(shape),
                           "baro_datum": self._z(shape),
                           "N_geo": self._z(shape),
                           "B_n": self.filter.B_n.to(
                               device=self.device, dtype=self.dtype).expand(
                                   shape + (3,)).clone()},
                "fault": no_fault(shape, self.device, self.dtype)}

    def init_s(self, shape=()):
        shape = tuple(shape)
        like = self._z(shape)
        return {"inner": self.inner.init_s(shape),
                "sens": {"b_g": self._z(shape, (3,)),
                         "b_a": self._z(shape, (3,)),
                         "gm_gps": self._z(shape, (3,)),
                         "n": torch.zeros(shape, dtype=torch.int32,
                                          device=self.device)},
                "nav": self.filter.identity(shape, self.device, self.dtype),
                "A": InsGps.zero_A(self._z(shape, (3,))),
                "hold": {"gps_p": self._z(shape, (3,)),
                         "gps_v": self._z(shape, (3,)),
                         "h_baro": self._z(shape),
                         "mag": self._z(shape, (3,))},
                "nis": {k: self._z(shape) for k in
                        ("baro", "gps", "gps_vel", "mag", "radar")},
                **{"mon_" + k: self.monitors[k][0](like)
                   for k in ("gps", "vel", "baro", "mag", "radar")}}

    def assign(self, u_systems, av_y):
        return self.inner.assign(u_systems, av_y["inner"])

    # ----------------------------------------------------------- fault stage

    def apply_faults(self, fault, hold, n, p_gps, v_gps, gps_new, h_baro,
                     mag_b):
        """In-loop fault injection on the record index k = n - 1
        (`navigation.py:360-410`): hold registers capture the epoch-k0
        values for freeze; FAULT_GPS freezes or drops the whole receiver
        and biases or ramps its position, FAULT_GPS_VEL any mode on the
        velocity alone, FAULT_MAG every body axis. Returns (hold, p, v,
        gps_new, h_baro, mag)."""
        ch, mode = fault["channel"], fault["mode"]
        k = n - 1
        active = k >= fault["k0"]
        in_win = active & (k < fault["k1"])
        take = k <= fault["k0"]
        delta = fault["delta"]
        ramp = delta * self.dt * torch.clamp_min(k - fault["k0"], 0).to(
            p_gps.dtype)

        hold_gp = bwhere(take, p_gps, hold["gps_p"])
        hold_gv = bwhere(take, v_gps, hold["gps_v"])
        hold_hb = bwhere(take, h_baro, hold["h_baro"])
        hold_mg = bwhere(take, mag_b, hold["mag"])

        def faulted(z, held, frz_on, bias_on, drp_on):
            frz = frz_on & active & (mode == MODE_FREEZE)
            bia = bias_on & active & (mode == MODE_BIAS)
            rmp = bias_on & active & (mode == MODE_RAMP)
            drp = drp_on & in_win & (mode == MODE_DROPOUT)
            z = bwhere(frz, held, z)
            z = bwhere(bia, z + _v(delta, z), z)
            z = bwhere(rmp, z + _v(ramp, z), z)
            return bwhere(drp, torch.zeros_like(z), z)

        gps_on = ch == FAULT_GPS
        vel_on = ch == FAULT_GPS_VEL
        baro_on = ch == FAULT_BARO
        mag_on = ch == FAULT_MAG
        p_f = faulted(p_gps, hold_gp, gps_on, gps_on,
                      torch.zeros_like(gps_on))
        v_f = faulted(v_gps, hold_gv, gps_on | vel_on, vel_on, vel_on)
        h_f = faulted(h_baro, hold_hb, baro_on, baro_on, baro_on)
        m_f = faulted(mag_b, hold_mg, mag_on, mag_on, mag_on)
        gps_new = gps_new & ~(gps_on & in_win & (mode == MODE_DROPOUT))
        return ({"gps_p": hold_gp, "gps_v": hold_gv, "h_baro": hold_hb,
                 "mag": hold_mg}, p_f, v_f, gps_new, h_f, m_f)

    # ------------------------------------------------------------- the pass

    def epoch_gate(self, n1):
        """The host form of `epoch_preds` (`navigation.py:668-685`): does
        the firing that makes sensor epoch `n1` (an int, or each lane's as
        a tensor) aid on any channel on any lane? None where a channel aids
        every firing (the gate would never skip)."""
        everys = self.everys()
        if min(everys) <= 1:
            return None
        if isinstance(n1, torch.Tensor):
            return any(bool((n1 % e == 0).any()) for e in everys)
        return any(int(n1) % e == 0 for e in everys)

    def nav_pass(self, s, u, veh_y, h_trn=0.0, aid=None):
        """Steps 1-4 of `f_periodic` (`navigation.py:414-543`): the sensors,
        the faults, the filter with its monitored aiding block (run where
        `aid` is True or None, skipped where False), the estimated
        VehicleY. Returns (the new state but its "inner", y_est, NavY)."""
        kin, air, dyn = veh_y.kinematics, veh_y.airflow, veh_y.dynamics
        org = u["origin"]

        eta = self.suite.epoch_draws(u["sens"]["seed"], s["sens"]["n"] + 1,
                                     s["sens"]["b_g"].dtype)
        s_sens = self.suite.f_step(u["sens"], s["sens"], eta[0])
        z = self.suite.measure(u["sens"], s_sens, kin, air, dyn, h_trn,
                               eta[1])

        p_gps = ned_from_geodetic(z.gps_lat, z.gps_lon, z.gps_h,
                                  org["lat0"], org["lon0"], org["h0"])
        hold, p_gps, v_gps, gps_new, h_baro, mag_b = self.apply_faults(
            u["fault"], s["hold"], s_sens["n"], p_gps, z.gps_v_n, z.gps_new,
            z.h_baro, z.mag_b)
        z = z._replace(gps_v_n=v_gps, gps_new=gps_new, h_baro=h_baro,
                       mag_b=mag_b)

        nrec = s_sens["n"]
        if self.defer_cov:
            st, parts = self.filter.predict_mean(s["nav"], z.omega_b, z.f_b)
            A_acc = InsGps.accum_A(s["A"], parts)
            p_new = (nrec % self.p_every) == 0
        else:
            st = self.filter.predict(s["nav"], z.omega_b, z.f_b)
            A_acc = s["A"]
            p_new = torch.zeros_like(gps_new)

        baro_new = (nrec % self.baro_every) == 0
        mag_new = (nrec % self.mag_every) == 0
        h_meas = h_baro - org["baro_datum"]
        if self.use_radar:
            h_radar_e = h_trn + z.h_radar + org["N_geo"]
            radar_new = (((nrec % self.radar_every) == 0) & z.radar_valid
                         & (z.h_radar <= self.radar_max_agl))
        else:
            h_radar_e = None
            radar_new = torch.zeros_like(gps_new)

        mons = {k: s["mon_" + k] for k in ("gps", "vel", "baro", "mag",
                                           "radar")}
        if aid is False:
            zz = torch.zeros_like(h_meas)
            nises = (zz, zz, zz, zz, zz)
            alarms = (mons["gps"]["alarm"] | mons["vel"]["alarm"],
                      mons["baro"]["alarm"], mons["mag"]["alarm"],
                      mons["radar"]["alarm"])
            A_out = A_acc
        else:
            st, mons, nises, alarms, A_out = self.aid_block(
                st, mons, org, p_gps, v_gps, gps_new, h_meas, mag_b,
                h_radar_e, baro_new, mag_new, radar_new, A_acc, p_new)
        nis_pos, nis_vel, nis_bar, nis_mag, nis_rad = nises
        gps_alarm, baro_alarm, mag_alarm, radar_alarm = alarms
        q_est = st.q_nb

        TAS_est, EAS_est = estimate_airspeed(z)
        lat0 = org["lat0"]
        om_ie_n = geo.omega_ie * torch.stack(
            [torch.cos(lat0), torch.zeros_like(lat0), -torch.sin(lat0)],
            dim=-1)
        omega_est = z.omega_b - st.b_g - qrot_inv(q_est, om_ie_n.to(q_est))
        h_est = org["h0"] - st.p_n[..., 2]
        v_n = st.v_n
        chi_est = torch.atan2(v_n[..., 1], v_n[..., 0])
        gamma_est = torch.atan2(
            -v_n[..., 2], torch.hypot(v_n[..., 0], v_n[..., 1]) + 1e-9)
        n0 = geo.nvector_from_latlon(org["lat0"], org["lon0"])
        M, N = geo.radii(n0)
        lat_est = org["lat0"] + st.p_n[..., 0] / (M + org["h0"])
        lon_est = org["lon0"] + st.p_n[..., 1] / ((N + org["h0"])
                                                  * torch.cos(org["lat0"]))
        h_o_est = torch.where(z.radar_valid, h_trn + z.h_radar,
                              h_est - org["N_geo"])
        kin_est = kin._replace(
            q_nb=q_est, e_nb=quat_to_euler(q_est), omega_eb_b=omega_est,
            omega_wb_b=omega_est, v_eb_n=v_n, h_e=h_est, chi_gnd=chi_est,
            gamma_gnd=gamma_est, lat=lat_est, lon=lon_est,
            n_e=geo.nvector_from_latlon(lat_est, lon_est), h_o=h_o_est)
        air_est = air._replace(EAS=EAS_est, TAS=TAS_est, CAS=z.CAS, p=z.p_s,
                               T=z.T_oat)
        y_est = veh_y._replace(kinematics=kin_est, airflow=air_est,
                               systems=self.systems_est(veh_y, q_est, v_n,
                                                        TAS_est))

        nav_y = NavY(q_nb=q_est, b_g=st.b_g, p_n=st.p_n, v_n=st.v_n,
                     b_a=st.b_a, h_est=h_est, EAS_est=EAS_est,
                     nis_gps=nis_pos, nis_gps_vel=nis_vel, nis_baro=nis_bar,
                     nis_mag=nis_mag, nis_radar=nis_rad, gps_alarm=gps_alarm,
                     baro_alarm=baro_alarm, mag_alarm=mag_alarm,
                     radar_alarm=radar_alarm, z=z)
        keep = lambda new, nv, old: torch.where(new, nv, old)
        s_nis = s["nis"]
        s_new = {"sens": s_sens, "nav": st, "A": A_out, "hold": hold,
                 "nis": {"gps": keep(gps_new, nis_pos, s_nis["gps"]),
                         "gps_vel": keep(gps_new, nis_vel, s_nis["gps_vel"]),
                         "baro": keep(baro_new, nis_bar, s_nis["baro"]),
                         "mag": keep(mag_new, nis_mag, s_nis["mag"]),
                         "radar": keep(radar_new, nis_rad, s_nis["radar"])},
                 **{"mon_" + k: v for k, v in mons.items()}}
        return s_new, y_est, nav_y

    def f_periodic(self, s, u, veh_y, dt, h_trn=0.0, aid=None):
        """The whole pass (`navigation.py:414-569`): `nav_pass`, then the
        inner avionics on the estimated VehicleY (the truth in shadow
        mode). Returns (s, {"inner": the inner's output, "nav": NavY})."""
        s_nav, y_est, nav_y = self.nav_pass(s, u, veh_y, h_trn, aid)
        s_in, y_in = self.inner.f_periodic(
            s["inner"], u["inner"], y_est if self.use_estimates else veh_y,
            dt)
        return dict(s_nav, inner=s_in), {"inner": y_in, "nav": nav_y}

    def aid_block(self, st, mons, org, p_g, v_g, g_new, h_m, m_b, h_r_e,
                  b_new, m_new, r_new, A_acc, p_new):
        """The stacked monitored aiding pass (`navigation.py:571-635`): the
        covariance compounded on the p_every cadence, each channel's NIS
        from its marginal innovation system against the pre-update P, the
        monitors, then one masked simultaneous update whose rows are gated
        by the epoch flags, the latched alarms and each epoch's own NIS."""
        if self.defer_cov:
            prop = self.filter.propagate_P(st, A_acc, self.p_every)
            st = st._replace(P=bwhere(p_new, prop.P, st.P))
            A_out = tree_map(lambda a: bwhere(p_new, torch.zeros_like(a), a),
                             A_acc)
        else:
            A_out = A_acc
        H, y, r = self.filter.stacked_rows(st, p_g, v_g, h_m, org["h0"], m_b,
                                           org["B_n"], h_r_e)
        PHt, S = self.filter.stacked_innovation(st, H, r)

        def ch_nis(a, b):
            return nis(y[..., a:b], S[..., a:b, a:b])

        nis_pos, nis_vel = ch_nis(0, 3), ch_nis(3, 6)
        nis_bar, nis_mag = ch_nis(6, 7), ch_nis(7, 10)
        nis_rad = (ch_nis(10, 11) if h_r_e is not None
                   else torch.zeros_like(nis_bar))
        upd = {k: self.monitors[k][1] for k in self.monitors}
        mon_gps, a_pos = upd["gps"](mons["gps"], nis_pos, g_new)
        mon_vel, a_vel = upd["vel"](mons["vel"], nis_vel, g_new)
        mon_bar, a_bar = upd["baro"](mons["baro"], nis_bar, b_new)
        mon_mag, a_mag = upd["mag"](mons["mag"], nis_mag, m_new)
        mon_rad, a_rad = upd["radar"](mons["radar"], nis_rad, r_new)
        a_gps = a_pos | a_vel
        mg = (g_new & ~a_gps & (nis_pos <= self.gps_gate)
              & (nis_vel <= self.vel_gate))
        mb = b_new & ~a_bar & (nis_bar <= self.baro_gate)
        mm = m_new & ~a_mag & (nis_mag <= self.mag_gate)
        rows = [mg] * 6 + [mb] + [mm] * 3
        sizes = (3, 3, 1, 3)
        if h_r_e is not None:
            rows.append(r_new & ~a_rad & (nis_rad <= self.radar_gate))
            sizes = (3, 3, 1, 3, 1)
        st2 = self.filter.update_stacked(st, H, y, r,
                                         torch.stack(rows, dim=-1), PHt=PHt,
                                         S=S, sizes=sizes)
        mons2 = {"gps": mon_gps, "vel": mon_vel, "baro": mon_bar,
                 "mag": mon_mag, "radar": mon_rad}
        return (st2, mons2, (nis_pos, nis_vel, nis_bar, nis_mag, nis_rad),
                (a_gps, a_bar, a_mag, a_rad), A_out)

    def systems_est(self, veh_y, q_est, v_n, TAS_est):
        """The systems output the inner laws see, by the alpha_beta policy
        (`navigation.py:637-666`): the truth; "synthetic", alpha from the
        filter's attitude and velocity and the measured TAS, beta 0; or
        ("perturb", da, db), the truth offset."""
        if self.alpha_beta == "truth":
            return veh_y.systems
        aero = veh_y.systems.aero
        if self.alpha_beta == "synthetic":
            e_est = quat_to_euler(q_est)
            theta, phi = e_est[..., 1], e_est[..., 2]
            sin_ga = torch.clamp(-v_n[..., 2] / torch.clamp_min(TAS_est, 10.0),
                                 -0.99, 0.99)
            alpha = ((theta - torch.arcsin(sin_ga))
                     / torch.clamp_min(torch.cos(phi), 0.5))
            beta = torch.zeros_like(alpha)
            aero = aero._replace(alpha=alpha, alpha_filt=alpha, beta=beta,
                                 beta_filt=beta)
        else:
            tag, da, db = self.alpha_beta
            assert tag == "perturb", self.alpha_beta
            aero = aero._replace(alpha=aero.alpha + da,
                                 alpha_filt=aero.alpha_filt + da,
                                 beta=aero.beta + db,
                                 beta_filt=aero.beta_filt + db)
        return veh_y.systems._replace(aero=aero)

    # ----------------------------------------------------------------- init

    def init_from_trim(self, veh_y, dt, seed=0, init_key=None,
                       init_errors=None):
        """The trim-aligned start (`navigation.py:689-718`): the inner
        avionics' bumpless start on the truth, the filter's origin at the
        trim fix, aligned to the trim's attitude and velocity, the baro
        datum from the trim's static pressure."""
        assert abs(float(dt) - self.dt) < 1e-12, \
            f"NavAvionics(dt={self.dt}) vs periodic dt {dt}"
        u_in, s_in = self.inner.init_from_trim(veh_y, dt)
        shape = tuple(veh_y.airflow.EAS.shape)
        u, s = self.init_u(shape), self.init_s(shape)
        u["inner"], s["inner"] = u_in, s_in
        return self._align(u, s, veh_y, seed, init_key, init_errors)

    def align_cold(self, u, s, veh_y, seed=0, init_key=None,
                   init_errors=None):
        """The parked ground alignment of a cold start (`navigation.py:
        720-734`): origin, baro datum and field at the parked fix, the
        filter aligned to the stationary veh_y, the inner avionics as
        built."""
        return self._align(dict(u), dict(s), veh_y, seed, init_key,
                           init_errors)

    def _align(self, u, s, veh_y, seed, init_key, init_errors):
        kin, air = veh_y.kinematics, veh_y.airflow
        shape = tuple(kin.h_e.shape)
        u["sens"] = dict(u["sens"], seed=torch.as_tensor(
            seed, dtype=torch.int32, device=kin.h_e.device).expand(
                shape).clone())
        p = u["sens"]["params"]
        if self.geomag == "dipole":
            B_n = mag_field_dipole(kin.lat, kin.lon, kin.h_e)
            p = dict(p, mag=dict(p["mag"], B_n=B_n.to(p["mag"]["B_n"])))
            u["sens"] = dict(u["sens"], params=p)
        else:
            B_n = self.filter.B_n.to(kin.h_e).expand(shape + (3,))
        datum = (pressure_altitude(air.p)
                 - pressure_altitude(p["baro"]["qnh"]) - kin.h_e)
        u["origin"] = {"lat0": kin.lat, "lon0": kin.lon, "h0": kin.h_e,
                       "baro_datum": datum, "N_geo": kin.h_e - kin.h_o,
                       "B_n": B_n}
        s["sens"] = self.suite.init_s(u["sens"], init_key=init_key)

        cat = self._params["imu"]
        q0, v0 = kin.q_nb, kin.v_eb_n
        p0 = torch.zeros_like(v0)
        init_kw = dict(bg_std=float(cat["bias0_gyro"]) + 1e-4,
                       ba_std=float(cat["bias0_accel"]) + 1e-3)
        if init_errors:
            e = dict(init_errors)
            f = lambda k: torch.as_tensor(e.pop(k, (0.0, 0.0, 0.0)),
                                          dtype=torch.float64)
            rv, dp, dv = f("datt_n"), f("dp_n"), f("dv_n")
            assert not e, f"unknown init_errors keys {sorted(e)}"
            # a NED-frame error composes on the left of q_nb
            q0 = qnormalize(qmul(rvec_to_quat(rv.to(q0)).expand_as(q0), q0))
            p0 = p0 + dp.to(p0)
            v0 = v0 + dv.to(v0)
            norm = lambda t: float(torch.linalg.vector_norm(t))
            init_kw.update(att_std=max(0.05, norm(rv)),
                           pos_std=max(3.0, norm(dp)),
                           vel_std=max(0.2, norm(dv)))
        s["nav"] = self.filter.init(q_nb=q0, v_n=v0, p_n=p0, **init_kw)
        return u, s
