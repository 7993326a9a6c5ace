"""The JAX package's C172Xv1 on its turning climb at a fleet's size, with a
second-order elevator or on first-order servos, as the reference for the
stall that `chip_smoke.py`'s 60 s flight of the port's `megakernel_fbw_a2`
shows on some lanes.

Flies the lanes `chip_smoke.py` flies (`flightjax_torch.testing.
xv1_fleet_sim(4096, 1016, a2=("elevator",))`: `perturbed_xv1`'s trimmed
C172Xv1, each lane perturbed from the seed, the autopilot engaged on the
turning climb, EAS 45 m/s, 1.5 m/s climb, course pi / 2, the elevator's
rate drawn per lane from the seed + 7) through the JAX fleet step of
`c172x.build_xv1("wa", actuators={"elevator": Actuator2()})` on the CPU,
dt = periodic_dt = 0.02 s, geoid refresh every 128 steps, in float32 with
the position Kahan-compensated (`Simulation.with_compensation`), as the
port's float32 fleet flies; `--float64` flies it in float64 instead,
`--first-order` the twin on `Actuator1` servos (no rate drawn). The
numpy start comes from the port's `testing` module, so both packages
start from the same values.

Each lane's stall flag (`s.vehicle.systems.aero.stall`) is or-ed over
every step, as `chip_smoke.py` does. It writes as JSON (default
`tools/jax_turning_climb.json`; `chip_smoke.py` reads it) the stalled
lanes, their count, the terminated lanes, the fleet's mean EAS and mean
height at the end, the settings and the wall time.

    python tools/jax_turning_climb.py [--lanes 4096] [--steps 3000]
        [--float64] [--first-order] [--out FILE]

Takes several minutes on a CPU at 4096 lanes.
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
from flightjax.physics.aircraftbase import SimpleWorld  # noqa: E402
from flightjax_torch.core.modeling import tree_leaves_with_path  # noqa: E402
from flightjax_torch.testing import perturbed_xv1, with_a2  # noqa: E402

DT, SEED, BLOCK = 0.02, 1016, 100


def as_jax(tree, template, dtype):
    """The port's numpy tree as the JAX package's (its NamedTuples from
    `template`; the leaves pair by path, both flatten dict keys sorted),
    floats in `dtype`."""
    leaves = tree_leaves_with_path(tree)
    ref = jax.tree_util.tree_flatten_with_path(template)
    names = [tuple(getattr(k, "key", getattr(k, "name", None)) for k in p)
             for p, _ in ref[0]]
    if [p for p, _ in leaves] != names:
        raise ValueError("the port's tree and the JAX package's differ")
    cast = lambda v: jnp.asarray(v, dtype if np.issubdtype(
        np.asarray(v).dtype, np.floating) else None)
    return jax.tree_util.tree_unflatten(ref[1], [cast(v) for _, v in leaves])


def climb_fleet(lanes, dtype, first_order):
    """(sim, the fleet's SimState) of the turning-climb lanes."""
    a2 = () if first_order else ("elevator",)
    aircraft = c172x.build_xv1("wa", actuators={
        ch: c172x.Actuator2() for ch in a2} or None)
    world = SimpleWorld(aircraft)
    sim = Simulation(world, dt=DT, periodic_dt=DT, geoid_every=128)
    t, i, x, u, s = perturbed_xv1(lanes, SEED)
    x_sys = x["vehicle"]["systems"]
    x_sys["act"] = with_a2(x_sys["act"], a2, np.random.default_rng(SEED + 7))
    bcast = lambda tree: jax.tree.map(
        lambda l: jnp.broadcast_to(l, (lanes,) + jnp.shape(l)), tree)
    x0, u0, s0 = world.init()
    st = SimState(t=jnp.asarray(t, dtype), i=jnp.asarray(i),
                  x=as_jax(x, bcast(x0), dtype), u=as_jax(u, bcast(u0), dtype),
                  s=as_jax(s, bcast(s0), dtype))
    return sim, sim.with_compensation(st)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--first-order", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "tools",
                                                  "jax_turning_climb.json"))
    args = ap.parse_args()
    if args.float64:
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if args.float64 else jnp.float32
    t0 = time.time()
    sim, st = climb_fleet(args.lanes, dtype, args.first_order)
    stall = lambda s_: s_.s["vehicle"]["systems"]["aero"]["stall"]

    def block(carry):
        def body(_, c):
            st_, stalled = sim.fleet_step(c[0]), c[1]
            return st_, stalled | stall(st_)
        return jax.lax.fori_loop(0, BLOCK, body, carry)
    run = jax.jit(block)
    out = jax.jit(jax.vmap(lambda s_: sim.output(s_, ())))
    carry = (st, jnp.zeros(args.lanes, bool))
    if args.steps % BLOCK:
        raise ValueError(f"--steps must be a multiple of {BLOCK}")
    for _ in range(args.steps // BLOCK):
        carry = run(carry)
    st, stalled = carry
    y = out(st)
    stalled = np.asarray(stalled)
    term = np.asarray(st.s["terminated"])
    rec = {"lanes": args.lanes, "steps": args.steps, "dt": DT, "seed": SEED,
           "servo": "Actuator1" if args.first_order else
           "Actuator2 on the elevator",
           "dtype": str(np.dtype(dtype)),
           "stalled_lanes": int(stalled.sum()),
           "terminated_lanes": int(term.sum()),
           "eas_mean": float(np.mean(np.asarray(
               y.vehicle.airflow.EAS, np.float64))),
           "h_e_mean": float(np.mean(np.asarray(
               y.vehicle.kinematics.h_e, np.float64))),
           "stalled": [int(k) for k in np.flatnonzero(stalled)],
           "wall_s": time.time() - t0}
    with open(args.out, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "stalled"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
