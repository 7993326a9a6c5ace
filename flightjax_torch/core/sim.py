"""Fixed-step RK4 fleet simulation (port of the parts of
`flightjax/core/sim.py` the flagship fleet step uses).

`SimState.c` carries the compensated-accumulation residuals as a nested
dict mirroring `x` but holding only the compensated leaves (the JAX package
keeps a list aligned with x's flattened leaves; tests map one onto the
other by path).
"""

from typing import Any, NamedTuple

import torch

from flightjax_torch.core.modeling import tree_leaves_with_path


class SimState(NamedTuple):
    t: Any   # [B] time
    i: Any   # [B] int32 step counter
    x: Any
    u: Any
    s: Any
    c: Any = None


def default_comp_predicate(path):
    """The geodetic position states of the kinematic mechanizations
    (`sim.py:126-138`)."""
    keys = list(path)
    return "kinematics" in keys and keys[-1] in ("q_ew", "n_e", "lat",
                                                 "lon", "h_e")


def comp_residuals(x, predicate=default_comp_predicate, force=False):
    """Zero residuals for the leaves of `x` that the predicate selects and
    that are floating and not float64 (float64 too with `force=True`), as
    a nested dict; None when nothing qualifies (`sim.py:141-155`)."""
    out = {}
    for path, v in tree_leaves_with_path(x):
        if (predicate(path) and v.dtype.is_floating_point
                and (force or v.dtype != torch.float64)):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.zeros_like(v)
    return out or None


def comp_add(x, incr, c):
    """x + incr with Kahan/Neumaier compensation on the leaves present in
    the residual tree `c` (`sim.py:158-180`); returns (x_new, c_new)."""
    if c is None:
        return {k: comp_add(x[k], incr[k], None)[0] if isinstance(x[k], dict)
                else x[k] + incr[k] for k in x}, None
    out, c_new = {}, {}
    for k in x:
        if isinstance(x[k], dict):
            out[k], ck = comp_add(x[k], incr[k], c.get(k))
            if ck is not None:
                c_new[k] = ck
        elif k in c:
            xv, y = x[k], incr[k] + c[k]
            snew = xv + y
            c_new[k] = torch.where(torch.abs(xv) >= torch.abs(y),
                                   (xv - snew) + y, (y - snew) + xv)
            out[k] = snew
        else:
            out[k] = x[k] + incr[k]
    return out, (c_new or None)


class Simulation:
    """RK4 fleet stepper over a `SimpleWorld` (`sim.py:201-410`).

    `geoid_every`: the carried EGM96 undulation is refreshed on every
    `geoid_every`-th step. `compensate`: "auto" attaches Kahan residuals to
    the sub-float64 position states in `with_compensation`, False never.
    The gear is evaluated on every lane: the JAX package's gear gate
    (`gear_gate_margin`, kept here as a setting) is a fleet-scalar skip
    whose airborne branch is state-exact, so the margin changes no state;
    only JAX's diagnostic of the strut's `delta_h` differs. A Dryden
    turbulence model on the vehicle must hold its drive over this `dt`
    (`sim.py:251-259`)."""

    def __init__(self, system, dt=0.02, periodic_dt=None, t_start=0.0,
                 geoid_every=1, compensate="auto", gear_gate_margin=None):
        self.system = system
        self.dt = float(dt)
        self.periodic_dt = (float(periodic_dt) if periodic_dt is not None
                            else float(dt))
        self.t_start = float(t_start)
        ratio = self.periodic_dt / self.dt
        self.steps_per_periodic = int(round(ratio))
        if (abs(ratio - self.steps_per_periodic) > 1e-9
                or self.steps_per_periodic < 1):
            raise ValueError(
                f"periodic_dt ({self.periodic_dt}) must be a positive integer "
                f"multiple of dt ({self.dt})")
        # the system's periodic interval, which the avionics read
        system.periodic_dt = self.periodic_dt
        self.geoid_every = max(1, int(geoid_every))
        if compensate not in ("auto", False):
            raise ValueError("compensate must be 'auto' or False")
        self.compensate = compensate
        self.gear_gate_margin = (None if gear_gate_margin is None
                                 else float(gear_gate_margin))
        turb = getattr(getattr(getattr(system, "aircraft", None), "vehicle",
                               None), "turbulence", None)
        if turb is not None and abs(turb.dt - self.dt) > 1e-12:
            raise ValueError(
                f"DrydenTurbulence(dt={turb.dt}) does not match "
                f"Simulation dt={self.dt}: the gust variance would be "
                f"scaled by {turb.dt / self.dt:.3g}")

    def with_compensation(self, state: SimState) -> SimState:
        if state.c is not None or self.compensate is False:
            return state
        return state._replace(c=comp_residuals(state.x))

    def fleet_step(self, state: SimState, ctx=(), *, i) -> SimState:
        """One step of a batch-leading fleet state, with the avionics'
        periodic pass after it when it fires. `ctx` is () as in every
        model of the JAX package (a mission is an avionics wrapper,
        `core/mission.py`). `i` is the
        fleet's shared step counter as a Python int (the value of every
        lane of `state.i`); `fleet_rollout` keeps it on the host, so
        neither the geoid cadence nor the periodic pass costs a device
        sync: every lane takes the same branch, as the uniform mask of the
        JAX package's `tree_where` does. A turbulent vehicle steps through
        the whole-vehicle kernels (`rk4_stage_turb`, `rk4_finish_turb`),
        compensated as the subsystems split is (where `state.c` holds
        residuals), as that split carries no turbulence."""
        from flightjax_torch.parallel.clusterstep import (cluster_step,
                                                          vehicle_step)
        if ctx != ():
            raise NotImplementedError(
                "the step takes no context: ctx is () in every model, and "
                "the mission is an avionics wrapper (MissionAvionics, "
                "core/mission.py)")
        if self.system.aircraft.vehicle.turbulence is not None:
            return vehicle_step(self, state, int(i), comp=state.c is not None)
        return cluster_step(self, state, int(i))

    def output(self, state: SimState):
        """The outputs of the world at `state` as far as the fleet's loads
        read them (`sim.py:412`): an AircraftY whose vehicle's `dynamics`
        holds the specific force at the CoM, `f_c_c` (`dynamics.py:
        266-274`), in plain PyTorch on the state's device."""
        from flightjax_torch.parallel import kernels as K
        return K.world_output(self.system, state)
