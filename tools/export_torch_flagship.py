"""Write the trimmed C172S flagship state for `flightjax_torch`.

Runs the JAX package's trim solver once (float64, CPU) at the default trim
parameters and saves `flightjax_torch/data/c172s_flagship.npz` with:
- the world-level x, u and s of one aircraft, flattened by path
  ("x/vehicle/kinematics/q_wb", ...), floats as float64, integer and bool
  leaves in their own types;
- `trim_state`: the 7-vector TrimState the solver returned;
- `trim_rnorm`: the residual norm it reached.

`flightjax_torch.models.c172.c172s.flagship_sim` reads this file, so the
port builds its flagship without JAX. Run from the repository root:

    python tools/export_torch_flagship.py
"""

import os
import sys

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from flightjax.models.c172 import c172s, common as C172  # noqa: E402

OUT = os.path.join(ROOT, "flightjax_torch", "data", "c172s_flagship.npz")


def flatten(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join([prefix] + [str(p.key) for p in path])
        a = np.asarray(leaf)
        out[key] = a.astype(np.float64) if a.dtype.kind == "f" else a
    return out


def main():
    vehicle = c172s.flagship_world("wa").aircraft.vehicle
    x, u, s, ts, rnorm = c172s.trim(vehicle, C172.trim_parameters())
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
