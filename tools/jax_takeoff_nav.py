"""The JAX package's sensor-fed takeoff at a fleet's size, as the
reference for `chip_smoke.py`'s run of the port's.

Flies `flightjax/demos/c172_demos.py::takeoff_nav`'s aircraft (the cold
start on the LOWS 15 threshold, `NavAvionics.align_cold` on the parked
truth, standby, engine start, full-throttle roll, departure) on `--lanes`
lanes whose sensor streams are seeded 0, 1, ... (lane 0 is the single
aircraft of `tests/test_missions.py:254-300`), through the JAX fleet step
on the CPU in float32 (JAX's default precision, whose sensor draws the
port's float32 draws equal), the position Kahan-compensated as the port's
float32 fleets fly (`Simulation.with_compensation`: uncompensated, the
float32 truth's position wanders off in the climb and the GPS monitor
latches on every lane), for `--t-end` seconds. Every 10 steps (that
test's log) it reads each lane's estimated and true altitude and attitude
and its alarms, and writes as JSON (default `tools/jax_takeoff_nav.json`,
which `chip_smoke.py` reads) each lane's peak attitude error (deg, three
decimals), their quantiles and exceedance fractions, and the fleet's
worst of the test's other assertions: the peak altitude errors (on the
runway phases too), the final phases and heights, the alarms and
terminated lanes.

    python tools/jax_takeoff_nav.py [--lanes 4096] [--t-end 80] [--out FILE]

Takes minutes on a CPU at 4096 lanes.
"""

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from flightjax.core.mission import Phase  # noqa: E402
from flightjax.core.sim import SimState, Simulation  # noqa: E402
from flightjax.demos import c172_demos as D  # noqa: E402
from flightjax.parallel import fleet  # noqa: E402
from flightjax.physics.kinematics import kin_init  # noqa: E402

DT, SAVE_EVERY = 0.02, 10
ATT_THRESHOLDS = (0.5, 1.0, 2.0, 5.0)


def takeoff_fleet(lanes):
    """(sim, the fleet's SimState): `takeoff_nav`'s world and start
    (`c172_demos.py:485-527`) on `lanes` lanes, lane k's sensors seeded
    k, with the compensation's residuals."""
    legs = D._lows_pattern()
    lib = D._mission_phase_lib(legs)
    hold = lambda u, y, t: u
    phases = [
        Phase("standby", hold, lambda y, t: t >= 5.0),
        Phase("startup", hold, lib["engine_running"],
              systems=lib["engine_start"]),
        Phase("takeoff", lib["fly_leg"](legs["departure"], 35.0,
                                        throttle=1.0), lib["airborne"]),
        Phase("departure",
              lib["fly_leg"](legs["departure"], 35.0, throttle=1.0),
              lib["captured"](legs["departure"])),
    ]
    world = D._mission_world_nav(phases, dt=DT)
    sim = Simulation(world, dt=DT, periodic_dt=DT)
    ic = kin_init(lat=D.LAT_LOWS15, lon=D.LON_LOWS15,
                  h=D.H_LOWS15 + D.DH_TO_GND, h_datum="orthometric",
                  euler=[D.PSI_LOWS15, 0.0, 0.0])
    x, u, s = world.init(kin_init=ic, fuel=0.5)
    _, veh_y = world.aircraft.vehicle.f_ode(x["vehicle"], u["vehicle"],
                                            s["vehicle"], 0.0)
    u["avionics"], s["avionics"] = world.aircraft.avionics.align_cold(
        u["avionics"], s["avionics"], veh_y, seed=0)
    st = fleet.broadcast_state(sim.with_compensation(SimState(
        t=jnp.asarray(0.0), i=jnp.asarray(0, dtype=jnp.int32), x=x, u=u,
        s=s)), lanes)
    av_u = dict(st.u["avionics"])
    av_u["sens"] = dict(av_u["sens"],
                        seed=jnp.arange(lanes, dtype=jnp.int32))
    return sim, st._replace(u=dict(st.u, avionics=av_u))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--t-end", type=float, default=80.0)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tools", "jax_takeoff_nav.json"))
    args = ap.parse_args()
    t0 = time.time()
    sim, st = takeoff_fleet(args.lanes)

    def block(st):
        return jax.lax.fori_loop(0, SAVE_EVERY,
                                 lambda _, s: sim.fleet_step(s), st)
    run = jax.jit(block)
    out = jax.jit(jax.vmap(lambda s: sim.output(s, ())))
    n = args.lanes
    peak_att, peak_h, peak_rwy = (np.zeros(n) for _ in range(3))
    alarm = np.zeros(n, bool)
    for _ in range(int(round(args.t_end / DT)) // SAVE_EVERY):
        st = run(st)
        y = out(st)
        kin, nav = y.vehicle.kinematics, y.avionics["nav"]
        h = np.abs(np.asarray(nav["h_est"], np.float64)
                   - np.asarray(kin.h_e, np.float64))
        q_t = np.asarray(kin.q_nb, np.float64)
        q_e = np.asarray(nav["q_nb"], np.float64)
        att = np.degrees(2 * np.arccos(np.clip(np.abs(np.sum(
            q_t * q_e, axis=-1)), 0.0, 1.0)))
        rwy = np.asarray(y.avionics["inner"]["phase"]) <= 1
        peak_att = np.maximum(peak_att, att)
        peak_h = np.maximum(peak_h, h)
        peak_rwy = np.maximum(peak_rwy, np.where(rwy, h, 0.0))
        for ch in ("gps_alarm", "baro_alarm", "mag_alarm", "radar_alarm"):
            alarm |= np.asarray(nav[ch])
    y = out(st)
    agl = np.asarray(y.vehicle.kinematics.h_o, np.float64) - D.H_LOWS15
    phase = np.asarray(st.s["avionics"]["inner"]["phase"])
    rec = {"lanes": n, "t_end": args.t_end, "save_every": SAVE_EVERY,
           "seeds": "lane k seeded k",
           "dtype": str(np.asarray(y.vehicle.kinematics.h_e).dtype),
           "att_thresholds": list(ATT_THRESHOLDS),
           "att_p50": float(np.percentile(peak_att, 50.0)),
           "att_p95": float(np.percentile(peak_att, 95.0)),
           "att_max": float(peak_att.max()),
           "att_exceedance": [float((peak_att >= a).mean())
                              for a in ATT_THRESHOLDS],
           "h_err_max": float(peak_h.max()),
           "h_err_runway_max": float(peak_rwy.max()),
           "agl_end_min": float(agl.min()),
           "phase_end_min": int(phase.min()),
           "alarm_lanes": int(alarm.sum()),
           "terminated_lanes": int(np.asarray(st.s["terminated"]).sum()),
           "peak_att_deg": [round(float(v), 3) for v in peak_att],
           "wall_s": time.time() - t0}
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "peak_att_deg"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
