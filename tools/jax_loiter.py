"""The JAX package's loiter on estimates at a fleet's size, calm or in
Dryden turbulence, as the reference for `chip_smoke.py`'s runs of the
port's.

Flies the aircraft, orbit and speed of `tests/test_navigation.py:276-327`
(the trimmed C172Xv2 on `NavAvionics` around its guidance and control
laws, circular guidance lateral and vertical over the filter's solution:
a 1500 m circle centred 2000 m north of the start at its height, EAS_ref
40 m/s) on `--lanes` lanes, lane k's sensor stream seeded k (lane 0 the
test's single aircraft), through the JAX fleet step on the CPU in float32
(JAX's default precision, whose sensor draws the port's float32 draws
equal), the position Kahan-compensated as the port's float32 fleets fly
(`Simulation.with_compensation`), for `--t-end` seconds. With `--W20` > 0
the vehicle flies in `DrydenTurbulence(dt)` at that 20-ft wind on every
lane, lane k's turbulence stream seeded k too, with no shear and no
discrete gust (the turbulence's defaults); with `--W20 0` it is the test's
calm vehicle, without the turbulence.

The start is the trim the test's `c172x.trim_world` makes (float64, the
values `tools/export_torch_c172x.py` stored in
`flightjax_torch/data/c172xv1_trim.npz`, read here as data), rounded to
float32, the avionics started bumpless from it in float32
(`init_from_trim`), the orbit worked out in float64 as the test does. So
the port's fleets (`flightjax_torch/testing.py::loiter_fleet_sim`,
`turb_loiter_fleet_sim`) start from the same state.

At the test's saves (every 100 steps) it reads each lane's altitude and
alarms (`gps_alarm`, the position or velocity monitor, and `baro_alarm`,
as the test reads them); at the end the radial error from the orbit.
It writes as JSON (default `tools/jax_loiter.json` calm,
`tools/jax_loiter_turb.json` in turbulence; `chip_smoke.py` reads both)
per lane the final |e_cb| and the largest |h_e - h0| at the saves (m,
three decimals), their p50, p95 and max and those of the ratio of the
final |e_cb| to the start's, and the counts of lanes with an alarm,
terminated, and failing each of the test's assertions.

    python tools/jax_loiter.py [--lanes 4096] [--t-end 60] [--W20 0]
                               [--out FILE]

Takes about ten minutes on a CPU at 4096 lanes.
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

from flightjax.core.sim import SimState, Simulation  # noqa: E402
from flightjax.models.c172 import c172x  # noqa: E402
from flightjax.models.c172 import c172x_gdc as GDC  # noqa: E402
from flightjax.ops import geodesy as geo  # noqa: E402
from flightjax.ops.quaternions import qrot  # noqa: E402
from flightjax.parallel import fleet  # noqa: E402
from flightjax.physics.aircraftbase import SimpleWorld  # noqa: E402
from flightjax.physics.turbulence import DrydenTurbulence  # noqa: E402

DT, SAVE_EVERY = 0.02, 100
NORTH, RADIUS, EAS_REF = 2000.0, 1500.0, 40.0
TRIM = os.path.join(ROOT, "flightjax_torch", "data", "c172xv1_trim.npz")


def trimmed_vehicle(template):
    """The vehicle's x, u, s trees of `template` (the world's init) with
    the trim's values, as float32 (the turbulence's leaves, which the trim
    does not hold, stay at their initial values)."""
    with np.load(TRIM) as z:
        flat = {k: z[k] for k in z.files}
    out = []
    for prefix, tree in zip("xus", template):
        leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
        new = []
        for path, leaf in leaves:
            key = "/".join([prefix, "vehicle"] + [str(p.key) for p in path])
            new.append(jnp.asarray(flat[key], dtype=jnp.asarray(leaf).dtype)
                       if key in flat else leaf)
        out.append(jax.tree_util.tree_unflatten(treedef, new))
    return out


def loiter_fleet(lanes, W20):
    """(sim, the fleet's SimState, orbit): the test's aircraft, trimmed,
    on circular guidance over its estimates, `lanes` lanes seeded k (and
    in turbulence at W20 seeded k where W20 > 0)."""
    kw = {"turbulence": DrydenTurbulence(DT)} if W20 > 0 else {}
    aircraft = c172x.build_xv2_nav("wa", periodic_dt=DT, **kw)
    world = SimpleWorld(aircraft)
    sim = Simulation(world, dt=DT, periodic_dt=DT)
    x, u, s = world.init()
    xv, uv, sv = trimmed_vehicle((x["vehicle"], u["vehicle"], s["vehicle"]))
    _, y0 = aircraft.vehicle.f_ode(xv, uv, sv, 0.0)
    av_u, av_s = aircraft.avionics.init_from_trim(y0, DT)
    h0 = float(y0.kinematics.h_e)
    # the orbit's centre NORTH m north of the start at its height, in
    # float64 (the test's construction)
    q_ew = np.asarray(xv["kinematics"]["q_ew"], np.float64)
    with jax.enable_x64(True):
        n_e = geo.nvector_from_qew(jnp.asarray(q_ew))
        r_c = geo.cartesian_from_geographic(n_e, jnp.asarray(h0)) + qrot(
            geo.ltf(n_e), jnp.asarray([NORTH, 0.0, 0.0]))
        lat_c, lon_c = (float(v) for v in geo.latlon_from_nvector(
            geo.geographic_from_cartesian(r_c)[0]))
    orbit = GDC.circle(lat_c, lon_c, h0, radius=RADIUS)
    inner = dict(av_u["inner"])
    inner["gdc"] = dict(inner["gdc"],
                        mode_req=jnp.asarray(GDC.GDC_CIRCULAR, jnp.int32),
                        orbit=orbit, hor_gdc_req=jnp.asarray(True),
                        vrt_gdc_req=jnp.asarray(True))
    inner["ctl"] = dict(inner["ctl"], lon=dict(inner["ctl"]["lon"],
                                               EAS_ref=jnp.asarray(EAS_REF)))
    av_u = dict(av_u, inner=inner)
    state = SimState(t=jnp.asarray(0.0), i=jnp.asarray(0, dtype=jnp.int32),
                     x=dict(x, vehicle=xv), u=dict(u, vehicle=uv,
                                                   avionics=av_u),
                     s=dict(s, vehicle=sv, avionics=av_s,
                            terminated=jnp.asarray(False)))
    st = fleet.broadcast_state(sim.with_compensation(state), lanes)
    seeds = jnp.arange(lanes, dtype=jnp.int32)
    av = dict(st.u["avionics"])
    av["sens"] = dict(av["sens"], seed=seeds)
    uv = dict(st.u["vehicle"])
    if W20 > 0:
        uv["turb"] = dict(uv["turb"], seed=seeds,
                          W20=jnp.full((lanes,), float(W20)))
    return sim, st._replace(u=dict(st.u, vehicle=uv, avionics=av)), orbit


def quantiles(v):
    v = np.asarray(v, np.float64)
    return {"p50": float(np.percentile(v, 50.0)),
            "p95": float(np.percentile(v, 95.0)), "max": float(v.max())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--t-end", type=float, default=60.0)
    ap.add_argument("--W20", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out_path = args.out or os.path.join(
        ROOT, "tools", "jax_loiter" + ("_turb" if args.W20 > 0 else "")
        + ".json")
    t0 = time.time()
    sim, st, orbit = loiter_fleet(args.lanes, args.W20)

    def block(st):
        return jax.lax.fori_loop(0, SAVE_EVERY,
                                 lambda _, s: sim.fleet_step(s), st)
    run = jax.jit(block)
    out = jax.jit(jax.vmap(lambda s: sim.output(s, ())))
    e_cb = jax.jit(jax.vmap(lambda n_e, h_e: GDC.circle_data(
        orbit, n_e, h_e).e_cb))
    y = out(st)
    h0 = np.asarray(y.vehicle.kinematics.h_e, np.float64)
    d0 = np.abs(np.asarray(e_cb(y.vehicle.kinematics.n_e,
                                y.vehicle.kinematics.h_e), np.float64))
    n = args.lanes
    dh = np.zeros(n)
    alarm = {"gps": np.zeros(n, bool), "baro": np.zeros(n, bool)}
    for _ in range(int(round(args.t_end / DT)) // SAVE_EVERY):
        st = run(st)
        y = out(st)
        kin, nav = y.vehicle.kinematics, y.avionics["nav"]
        dh = np.maximum(dh, np.abs(np.asarray(kin.h_e, np.float64) - h0))
        for ch in alarm:
            alarm[ch] |= np.asarray(nav[ch + "_alarm"])
    d1 = np.abs(np.asarray(e_cb(y.vehicle.kinematics.n_e,
                                y.vehicle.kinematics.h_e), np.float64))
    dh_end = np.abs(np.asarray(y.vehicle.kinematics.h_e, np.float64) - h0)
    term = np.asarray(st.s["terminated"])
    ratio = d1 / d0
    rec = {"lanes": n, "t_end": args.t_end, "W20": args.W20,
           "save_every": SAVE_EVERY,
           "seeds": "lane k's sensors (and turbulence) seeded k",
           "dtype": str(np.asarray(y.vehicle.kinematics.h_e).dtype),
           "e_cb_start": quantiles(d0), "e_cb_end": quantiles(d1),
           "e_cb_ratio": quantiles(ratio), "dh_max": quantiles(dh),
           "gps_alarm_lanes": int(alarm["gps"].sum()),
           "baro_alarm_lanes": int(alarm["baro"].sum()),
           "terminated_lanes": int(term.sum()),
           "test_fails": {"terminated": int(term.sum()),
                          "|h_e - h0| >= 10 m": int((dh_end >= 10.0).sum()),
                          "|e_cb| >= 0.7 |e_cb(0)|": int((ratio >= 0.7).sum()),
                          "a GPS or baro alarm": int(
                              (alarm["gps"] | alarm["baro"]).sum())},
           "lane0": {"e_cb_start": float(d0[0]), "e_cb_end": float(d1[0]),
                     "dh_max": float(dh[0])},
           "e_cb_end_m": [round(float(v), 3) for v in d1],
           "dh_max_m": [round(float(v), 3) for v in dh],
           "wall_s": time.time() - t0}
    with open(out_path, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("e_cb_end_m", "dh_max_m")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
