"""The sensor-fed navigation study (port of `flightjax/demos/
estimation_demos.py:109-269`): a Monte Carlo fleet of the C172Xv1 flying
its turning climb on its own navigation solution, each lane in its own
Dryden turbulence with its own sensor grade and sensor stream, reporting
the exceedance of its peak attitude and position errors and the fraction
of lanes whose fault monitors latched (all false alarms: every sensor is
healthy).

    sim, st = nav_fleet_setup(4096)           # on the card
    r = joint_navigation_study(4096)          # 30 s, closed loop
    r = joint_navigation_study(4096, megakernel=True)   # one launch a step

`navigation_demo`, `fleet_navigation_study` (the `Ahrs` cascade) and
`fdi_mission_demo` are not ported (ROADMAP Queue 1, P11).
"""

import torch

from flightjax_torch.models.c172 import c172x
from flightjax_torch.ops import random as R
from flightjax_torch.parallel import fleet
from flightjax_torch.physics.kinematics import WA
from flightjax_torch.physics.sensors import pressure_altitude
from flightjax_torch.physics.turbulence import DrydenTurbulence
from flightjax_torch.utils.estimation import (attitude_error_deg,
                                              ned_from_geodetic)

STUDY_KEY = 0x17A


def nav_fleet_setup(n_lanes=32, dt=0.02, W20_max=7.7, grade_range=(0.5, 2.0),
                    key=None, use_estimates=True, device="cuda",
                    dtype=torch.float32):
    """(sim, fleet state) of the joint study (`estimation_demos.py:
    109-198`): the C172Xv1 on `NavAvionics(ControlLaws)` in Dryden
    turbulence (`c172x.c172xv1_nav_sim`), engaged on the turning climb,
    broadcast to `n_lanes`, randomised by `monte_carlo_c172` (wind N(0,
    3 m/s), height N(0, 30 m)), each lane's W20 ~ U[0, W20_max], its IMU
    noise scaled by a grade ~ U[grade_range] (the filter keeps the catalog
    tuning), its sensor seed drawn, and its filter origin and baro datum
    re-aligned at its own fix; all from `key` (default PRNGKey(0x17A)) as
    the JAX package draws them. The position is not compensated, as in
    the reference's study."""
    sim, state, _ = c172x.c172xv1_nav_sim(
        device, dtype, turbulence=DrydenTurbulence(dt),
        use_estimates=use_estimates)
    # uncompensated, as the reference's trim_world state is
    state = c172x.turning_climb(state)._replace(c=None)
    st = fleet.broadcast_state(state, n_lanes)
    dev = st.t.device
    key = R.PRNGKey(STUDY_KEY, dev) if key is None else key.to(dev)
    k_mc, k_w20, k_grade, k_seed = R.split(key, 4)
    st = fleet.monte_carlo_c172(st, k_mc, wind_std=3.0, h_jitter=30.0)

    veh_u = dict(st.u["vehicle"])
    veh_u["turb"] = dict(veh_u["turb"], W20=R.uniform(
        k_w20, (n_lanes,), dtype, 0.0, W20_max))
    av_u = dict(st.u["avionics"])
    grade = R.uniform(k_grade, (n_lanes,), dtype, grade_range[0],
                      grade_range[1])
    params = dict(av_u["sens"]["params"])
    params["imu"] = dict(params["imu"], **{
        k: params["imu"][k] * grade for k in ("sigma_gyro", "sigma_accel",
                                              "rw_gyro", "rw_accel")})
    av_u["sens"] = dict(av_u["sens"], params=params, seed=R.randint(
        k_seed, (n_lanes,), 0, 2 ** 31 - 1, torch.int32))

    # re-align each lane's filter origin at its jittered height: the
    # filter starts at p_n = 0, so h0 and the baro datum are the lane's own
    vehicle = sim.system.aircraft.vehicle
    y = vehicle.output(st.x["vehicle"], veh_u, st.s["vehicle"], st.t)
    kin, air = y.kinematics, y.airflow
    qnh = state.u["avionics"]["sens"]["params"]["baro"]["qnh"]
    datum = pressure_altitude(air.p) - pressure_altitude(qnh) - kin.h_e
    av_u["origin"] = dict(av_u["origin"], lat0=kin.lat, lon0=kin.lon,
                          h0=kin.h_e, baro_datum=datum)
    return sim, st._replace(u=dict(st.u, vehicle=veh_u, avionics=av_u))


def nav_errors(state):
    """Each lane's attitude-estimate error [deg] and horizontal position-
    estimate error [m] at `state` (`estimation_demos.py:212-222`): the
    filter's solution against the truth's kinematics."""
    xv, sv = state.x["vehicle"], state.s["vehicle"]
    _, kin = WA().f_ode(xv["kinematics"], xv["dynamics"], sv["geoid_N"])
    nav = state.s["avionics"]["nav"]
    org = state.u["avionics"]["origin"]
    att = attitude_error_deg(nav.q_nb, kin.q_nb)
    p_true = ned_from_geodetic(kin.lat, kin.lon, kin.h_e, org["lat0"],
                               org["lon0"], org["h0"])
    pos = torch.linalg.vector_norm(nav.p_n[..., :2] - p_true[..., :2],
                                   dim=-1)
    return att, pos


def fleet_rollout_nav_errors(sim, state, n_steps, sample_every=10,
                             megakernel=False):
    """Roll a navigation fleet `n_steps` through `Simulation.fleet_step`
    (with `megakernel`, through `make_megakernel_step`: the whole step and
    the navigation pass in one launch, the state unpacked at the samples)
    while tracking each lane's peak attitude and horizontal position
    errors, sampled every `sample_every` steps and at the start
    (`estimation_demos.py:201-232`). Returns (final state, peak_att_deg,
    peak_pos_m)."""
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    n_outer, rem = divmod(int(n_steps), int(sample_every))
    if rem:
        raise ValueError("n_steps must be a multiple of sample_every")
    i = fleet._shared_counter(state)
    peak_att, peak_pos = nav_errors(state)
    if megakernel:
        bufs, step_packed, unpack = make_megakernel_step(sim, state)
    for _ in range(n_outer):
        for _ in range(int(sample_every)):
            if megakernel:
                bufs = step_packed(bufs)
            else:
                state = sim.fleet_step(state, i=i)
                i += 1
        if megakernel:
            state = unpack(bufs)
        att, pos = nav_errors(state)
        peak_att = torch.maximum(peak_att, att)
        peak_pos = torch.maximum(peak_pos, pos)
    return state, peak_att, peak_pos


def joint_navigation_study(n_lanes=32, t_end=30.0, dt=0.02,
                           att_thresholds=(0.5, 1.0, 2.0, 5.0),
                           pos_thresholds=(2.0, 5.0, 10.0, 25.0), key=None,
                           device="cuda", dtype=torch.float32,
                           megakernel=False):
    """The joint Monte Carlo of turbulence severity, manoeuvre dispersion
    and sensor grade, each lane flying closed loop on its own estimates
    (`estimation_demos.py:235-269`): the peaks, their exceedance over the
    thresholds, their 95th percentiles, and per monitor the fraction of
    lanes whose alarm latched. With `megakernel` the fleet flies
    `make_megakernel_step` (`megakernel_nav_turb` on the card)."""
    sim, st = nav_fleet_setup(n_lanes, dt, key=key, device=device,
                              dtype=dtype)
    final, peak_att, peak_pos = fleet_rollout_nav_errors(
        sim, st, int(round(t_end / dt)), sample_every=10,
        megakernel=megakernel)
    s_av = final.s["avionics"]
    alarm = {name: float(torch.mean(s_av[mon]["alarm"].to(torch.float32)))
             for name, mon in (("gps", "mon_gps"), ("gps_vel", "mon_vel"),
                               ("baro", "mon_baro"), ("mag", "mon_mag"))}
    return {
        "final": final, "peak_att_deg": peak_att, "peak_pos_m": peak_pos,
        "att_exceedance": fleet.exceedance(peak_att, list(att_thresholds)),
        "pos_exceedance": fleet.exceedance(peak_pos, list(pos_thresholds)),
        "p95_att_deg": float(torch.quantile(peak_att.double(), 0.95)),
        "p95_pos_m": float(torch.quantile(peak_pos.double(), 0.95)),
        "alarm_fraction": alarm,
    }
