"""Write the trimmed C172Xv1 state and the two starts of the LOWS missions
for `flightjax_torch`.

Runs the JAX package's trim solver (float64, CPU) on the fly-by-wire
C172X of `c172x.build_xv1("wa")` at the default trim parameters and saves
`flightjax_torch/data/c172xv1_trim.npz` with:
- the world-level x, u and s of one aircraft without the avionics,
  flattened by path ("x/vehicle/systems/act/rudder", ...), floats as
  float64, integer and bool leaves in their own types;
- `trim_state`: the 7-vector TrimState the solver returned;
- `trim_rnorm`: the residual norm it reached.

The avionics' inputs and state are left out: `flightjax_torch` works out
their bumpless start itself (`ControlLaws.init_from_trim`), so it needs no
JAX at run time. `flightjax_torch.models.c172.c172x.c172xv1_sim` reads this
file. In the same form it writes the starts of the scripted missions over
the flat terrain at LOWS elevation (`flightjax/demos/c172_demos.py`), which
`flightjax_torch/models/c172/missions.py` reads:
- `c172x_lows_final_trim.npz`: the trim on the final leg of the crosswind
  landing (EAS 30 m/s, -3 deg, full flaps, half fuel; `:396-401`);
- `c172x_lows_runway.npz`: the cold aircraft on the runway 15 threshold of
  the traffic pattern (`kin_init` + `world.init(fuel=0.5)`, `:572-579`),
  which no trim made (`trim_state` empty, `trim_rnorm` NaN);
- `c172x_lows_final_nav_trim.npz`: the trim of the sensor-fed landing,
  1500 m up the final leg (`_landing_nav_rig` of
  `tests/test_missions.py:238-251`, `c172_demos.py:467-478`).

Run from the repository root, with the names of the files to write (all
four by default):

    python tools/export_torch_c172x.py [xv1] [landing] [runway] [landing_nav]
"""

import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from flightjax.models.c172 import c172x, common as C172  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_torch_flagship import flatten  # noqa: E402

DATA = os.path.join(ROOT, "flightjax_torch", "data")
OUT = os.path.join(DATA, "c172xv1_trim.npz")
FILES = {"xv1": OUT,
         "landing": os.path.join(DATA, "c172x_lows_final_trim.npz"),
         "runway": os.path.join(DATA, "c172x_lows_runway.npz"),
         "landing_nav": os.path.join(DATA, "c172x_lows_final_nav_trim.npz")}


def save(path, x, u, s, ts, rnorm):
    """The vehicle's x, u, s at world level (and the terminated latch),
    flattened by path, with the TrimState vector and residual norm."""
    world_s = {"vehicle": s, "terminated": np.asarray(False)}
    flat = {**flatten({"vehicle": x}, "x"), **flatten({"vehicle": u}, "u"),
            **flatten(world_s, "s")}
    flat["trim_state"] = np.asarray([np.asarray(v) for v in ts], np.float64)
    flat["trim_rnorm"] = np.asarray(float(rnorm))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **flat)
    print(f"wrote {path}: {len(flat)} arrays, trim residual "
          f"{float(rnorm):.3e}")


def lows_vehicle():
    from flightjax.demos import c172_demos as D
    from flightjax.physics.terrain import HorizontalTerrain
    return c172x.build_vehicle("wa", terrain=HorizontalTerrain(D.H_LOWS15))


def landing():
    """The final-leg trim of `c172_demos.crosswind_landing`."""
    from flightjax.demos import c172_demos as D
    from flightjax.ops import geodesy as geo
    legs = D._lows_pattern()
    lat1, lon1 = (float(v) for v in geo.latlon_from_nvector(
        legs["final"].n_e1))
    tp = C172.trim_parameters(lat=lat1, lon=lon1,
                              h=float(legs["final"].h_e1),
                              psi_nb=D.PSI_LOWS15, EAS=30.0,
                              gamma=-np.deg2rad(3), flaps=1.0, fuel_load=0.5)
    return c172x.trim(lows_vehicle(), tp)


def landing_nav(s_togo=1500.0):
    """The trim of `c172_demos.crosswind_landing_nav`: `s_togo` m up the
    final leg, on its heading and slope."""
    from flightjax.demos import c172_demos as D
    from flightjax.models.c172 import c172x_gdc as GDC
    legs = D._lows_pattern()
    seg_up = GDC.segment_from_vector(D.LAT_LOWS15, D.LON_LOWS15,
                                     float(legs["final"].h_e2),
                                     D.PSI_LOWS15 + np.pi, float(s_togo),
                                     gamma=np.deg2rad(3))
    lat1, lon1 = (float(v) for v in GDC.segment_latlon(seg_up.n_e2))
    tp = C172.trim_parameters(lat=lat1, lon=lon1, h=float(seg_up.h_e2),
                              psi_nb=D.PSI_LOWS15, EAS=30.0,
                              gamma=-np.deg2rad(3), flaps=1.0, fuel_load=0.5)
    return c172x.trim(lows_vehicle(), tp)


def runway():
    """The cold start of `c172_demos.traffic_pattern` (no trim)."""
    from flightjax.demos import c172_demos as D
    from flightjax.physics.aircraftbase import Aircraft, SimpleWorld
    from flightjax.physics.kinematics import kin_init
    world = SimpleWorld(Aircraft(lows_vehicle()))
    ic = kin_init(lat=D.LAT_LOWS15, lon=D.LON_LOWS15,
                  h=D.H_LOWS15 + D.DH_TO_GND, h_datum="orthometric",
                  euler=[D.PSI_LOWS15, 0.0, 0.0])
    x, u, s = world.init(kin_init=ic, fuel=0.5)
    return (x["vehicle"], u["vehicle"], s["vehicle"], np.zeros(0),
            float("nan"))


def main(names):
    for name in names or FILES:
        if name == "xv1":
            vehicle = c172x.build_xv1("wa").vehicle
            out = c172x.trim(vehicle, C172.trim_parameters())
        else:
            out = {"landing": landing, "runway": runway,
                   "landing_nav": landing_nav}[name]()
        save(FILES[name], *out)


if __name__ == "__main__":
    main(sys.argv[1:])
