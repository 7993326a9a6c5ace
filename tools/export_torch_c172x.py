"""Write the trimmed C172Xv1 state for `flightjax_torch`.

Runs the JAX package's trim solver once (float64, CPU) on the fly-by-wire
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
file. Run from the repository root:

    python tools/export_torch_c172x.py
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

OUT = os.path.join(ROOT, "flightjax_torch", "data", "c172xv1_trim.npz")


def main():
    vehicle = c172x.build_xv1("wa").vehicle
    x, u, s, ts, rnorm = c172x.trim(vehicle, C172.trim_parameters())
    world_x = {"vehicle": x}
    world_u = {"vehicle": u}
    world_s = {"vehicle": s, "terminated": np.asarray(False)}
    flat = {**flatten(world_x, "x"), **flatten(world_u, "u"),
            **flatten(world_s, "s")}
    flat["trim_state"] = np.asarray([np.asarray(v) for v in ts], np.float64)
    flat["trim_rnorm"] = np.asarray(float(rnorm))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **flat)
    print(f"wrote {OUT}: {len(flat)} arrays, trim residual {float(rnorm):.3e}")


if __name__ == "__main__":
    main()
