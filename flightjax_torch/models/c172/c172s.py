"""Cessna 172S with mechanical actuation and the flagship simulation (port
of `flightjax/models/c172/c172s.py`).

The trimmed flagship state is read from `data/c172s_flagship.npz`, written
by `tools/export_torch_flagship.py` from the JAX package's trim solver
(the trim itself is not ported yet), so this module needs no JAX.
"""

import os

import numpy as np
import torch

from flightjax_torch.bridge import tree_from_numpy
from flightjax_torch.core.sim import SimState, Simulation
from flightjax_torch.models.c172 import common as C172
from flightjax_torch.physics import piston as PE
from flightjax_torch.physics import propellers
from flightjax_torch.physics.aircraftbase import Aircraft, SimpleWorld, Vehicle
from flightjax_torch.physics.kinematics import WA
from flightjax_torch.physics.terrain import HorizontalTerrain

FLAGSHIP_NPZ = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                            "data", "c172s_flagship.npz")


def power_plant(*, device, dtype) -> PE.PistonThruster:
    """IO-360 + fixed-pitch 2-blade propeller at [2.055, 0, 0.833]."""
    prop = propellers.Propeller(
        propellers.load_prop_lookup(device=device, dtype=dtype), dbeta=0.0,
        sense=propellers.CW, d=2.0, J_xx=0.3, r_bp=[2.055, 0.0, 0.833],
        device=device, dtype=dtype)
    return PE.PistonThruster(PE.PistonEngine(device=device, dtype=dtype),
                             prop, gear_ratio=1.0)


class MechanicalActuation:
    """Direct linkage (`c172s.py:48-80`): aero.e = -elevator, aero.r =
    -rudder, nose steering = +rudder, offsets added, everything clamped."""

    def f_ode(self, u):
        clip1 = lambda v: torch.clamp(v, -1.0, 1.0)
        ail = clip1(u["aileron_offset"] + u["aileron"])
        elv = clip1(u["elevator_offset"] + u["elevator"])
        rud = clip1(u["rudder_offset"] + u["rudder"])
        return {
            "e": -elv, "a": ail, "r": -rud,
            "f": torch.clamp(u["flaps"], 0.0, 1.0),
            "steering": rud,
            "brake_left": torch.clamp(u["brake_left"], 0.0, 1.0),
            "brake_right": torch.clamp(u["brake_right"], 0.0, 1.0),
            "throttle": torch.clamp(u["throttle"], 0.0, 1.0),
            "mixture": torch.clamp(u["mixture"], 0.0, 1.0),
        }


def build_vehicle(*, device, dtype) -> Vehicle:
    systems = C172.Systems(power_plant(device=device, dtype=dtype),
                           MechanicalActuation(), device=device, dtype=dtype)
    return Vehicle(systems, WA(), HorizontalTerrain(device=device,
                                                    dtype=dtype),
                   device=device, dtype=dtype)


def flagship_world(*, device, dtype) -> SimpleWorld:
    return SimpleWorld(Aircraft(build_vehicle(device=device, dtype=dtype)))


def unflatten(flat, prefix):
    """{'a/b/c': v} entries under `prefix/` -> nested dict."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def load_flagship_state(path=FLAGSHIP_NPZ):
    """(x, u, s) numpy trees of the trimmed single aircraft, the TrimState
    vector and the trim residual norm."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return (unflatten(flat, "x"), unflatten(flat, "u"), unflatten(flat, "s"),
            flat["trim_state"], float(flat["trim_rnorm"]))


def flagship_sim(device, dtype):
    """(sim, trimmed single-aircraft SimState, ctx) on the WA C172S: dt =
    0.02 s, geoid refresh every 128 steps, Kahan-compensated position in
    float32 (the JAX package's `flagship_sim`). Leaves are unbatched;
    `parallel.fleet.broadcast_state` makes a fleet."""
    world = flagship_world(device=device, dtype=dtype)
    sim = Simulation(world, dt=0.02, periodic_dt=0.02, geoid_every=128)
    x, u, s, _, _ = load_flagship_state()
    state = SimState(
        t=torch.tensor(0.0, dtype=dtype, device=device),
        i=torch.tensor(0, dtype=torch.int32, device=device),
        x=tree_from_numpy(x, device, dtype),
        u=tree_from_numpy(u, device, dtype),
        s=tree_from_numpy(s, device, dtype))
    return sim, sim.with_compensation(state), ()
