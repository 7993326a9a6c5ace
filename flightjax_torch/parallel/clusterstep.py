"""One fleet step as kernels (port of `flightjax/parallel/clusterstep.py::
make_cluster_step`, `clusterstep.py:34-611`).

`split="subsystems"` (`cluster_step`, the orchestration of
`_make_cluster_step_split`, `clusterstep.py:183-611`): per RK4 stage kinair
-> systems (act + aero -> three gear legs -> powerplant + mass) ->
dynamics; after the stages finish_kin -> finish_sys (act -> three gear
struts -> stall/gear/engine/crash), then the geoid refresh on every
`geoid_every`-th step and the terminated latch. The systems run as one
kernel per stage and one per step, the JAX package's `k_systems` /
`k_finish_sys`; its finer per-part split exists only for the TPU's compile
helper, and its parts are the kernels' `__device__` functions here, called
in the same order. This is `Simulation.fleet_step`, and it carries the
Kahan residuals of `SimState.c` through `finish_kin`.

`split="vehicle"` (`vehicle_step`, `clusterstep.py:116-171`): four
`rk4_stage` launches and one `rk4_finish` on the state packed once per
step, then the `geoid` kernel on every `geoid_every`-th step. Like the JAX
path it is uncompensated: `SimState.c` passes through untouched
(`clusterstep.py:170`).

Each kernel is its plain PyTorch version on the CPU. Stage offsets, weights
and the k-sum association ((k1 + 2k2) + 2k3) + k4 follow
`clusterstep.py:124-136` and `sim.py:53-68`, so float64 parity with
`flightjax` holds to rounding.

A world whose aircraft has avionics (the C172Xv1's `ControlLaws`) runs its
periodic pass after the step when it fires, `(i + 1) % steps_per_periodic
== 0` (`clusterstep.py:591-607`): the avionics read the VehicleY at the new
state, which the finish kernels of the fly-by-wire C172 store beside the
state (finish_kin's KinData and AirData and finish_sys's airflow angles
and weight on wheels; rk4_finish's KIN_Y and SYS_Y rows), and write the
servo commands. The control laws run as the `ctl_laws` kernel on the card
(their plain version on the CPU or with `plain`). The pass reads the state
before the geoid refresh of the same step, as `Simulation.fleet_step`
orders them (the JAX cluster kernels refresh first; the two differ on
refresh steps by the undulation's change over 128 steps, micrometres).
"""

import torch

from flightjax_torch.core.modeling import tree_map
from flightjax_torch.core.sim import SimState
from flightjax_torch.models.c172.c172x_ctl import ControlLaws
from flightjax_torch.parallel import kernels as K

# (stage offset as a multiple of dt, k-sum weight)
STAGES = ((0.0, 1.0), (0.5, 2.0), (0.5, 2.0), (1.0, 1.0))


def _comp_kin(state):
    """The kinematics residuals of `state.c`, or None."""
    if state.c is None:
        return None
    if set(state.c) != {"vehicle"} or set(state.c["vehicle"]) != {
            "kinematics"}:
        raise ValueError("only kinematics position states are compensated")
    return state.c["vehicle"]["kinematics"]


def cluster_step(sim, state: SimState, i: int, *, plain=False,
                 geoid_every=None) -> SimState:
    """Advance a batch-leading world SimState whose step counter is `i`
    through the five cluster kernels, or with `plain` through their plain
    versions on any device. The geoid is refreshed when (i + 1) is a
    multiple of `geoid_every` (default `sim.geoid_every`)."""
    vehicle = sim.system.aircraft.vehicle
    C = K.PLAIN if plain else K.WRAPPERS
    dt = sim.dt
    t, x, u, s = state.t, state.x, state.u, state.s
    xv, uv, sv = x["vehicle"], u["vehicle"], s["vehicle"]
    term = s["terminated"].to(t.dtype)

    kprev = tree_map(torch.zeros_like, xv)
    acc = kprev
    for c, w in STAGES:
        kcur = K.stage_clusters(C, vehicle, xv, kprev, uv, sv, term, c * dt)
        acc = tree_map(lambda a, b: a + w * b, acc, kcur)
        kprev = kcur

    i_new = state.i + 1
    t_new = sim.t_start + i_new.to(t.dtype) * dt
    xv2, s_sys2, term2, c_kin2, kin_y, sys_y = K.finish_clusters(
        C, vehicle, xv, acc, uv, sv, s["terminated"], dt, _comp_kin(state))
    sv2 = dict(sv, systems=s_sys2)
    if (i + 1) % (sim.geoid_every if geoid_every is None
                  else geoid_every) == 0:
        sv2 = vehicle.refresh_geoid(xv2, sv2, plain=plain)
    s2 = dict(s, vehicle=sv2, terminated=term2)
    u2, s2 = _periodic(sim, xv2, u, s2, kin_y, sys_y, i, plain)
    c2 = None if c_kin2 is None else {"vehicle": {"kinematics": c_kin2}}
    return SimState(t=t_new, i=i_new, x=dict(x, vehicle=xv2), u=u2, s=s2,
                    c=c2)


def _periodic(sim, xv, u, s, kin_y, sys_y, i, plain=False):
    """The world's periodic pass after step `i` if it fires, when the
    counter it makes, i + 1, is a multiple of `steps_per_periodic`
    (`sim.py:327-328`; no ported avionics reads the firing index): the
    control laws on the VehicleY at the new state xv (from the finish's
    kin_y and sys_y) write the servo commands, as the `ctl_laws` kernel
    (its plain version with `plain`). Returns (u, s)."""
    world = sim.system
    avionics = world.aircraft.avionics
    if avionics is None or (i + 1) % sim.steps_per_periodic != 0:
        return u, s
    if not isinstance(avionics, ControlLaws):
        raise NotImplementedError(
            "the periodic pass carries the C172X's ControlLaws; the Xv2's "
            "guidance (c172x_gdc.py) is ROADMAP P9")
    vy = K.vehicle_y(world.aircraft.vehicle, xv, u["vehicle"], kin_y, sys_y)
    fn = K.ctl_laws_plain if plain else K.ctl_laws
    s_av, cmd = fn(avionics, K.ctl_y(vy), u["avionics"], s["avionics"],
                   world.periodic_dt)
    u_sys = u["vehicle"]["systems"]
    u2 = dict(u, vehicle=dict(u["vehicle"], systems=dict(
        u_sys, act=dict(u_sys["act"], **cmd))))
    return u2, dict(s, avionics=s_av)


def vehicle_step(sim, state: SimState, i: int, block=None) -> SimState:
    """Advance a batch-leading world SimState whose step counter is `i`
    through `rk4_stage` x 4 and `rk4_finish` (their plain versions on the
    CPU), uncompensated; `state.c` passes through."""
    vehicle = sim.system.aircraft.vehicle
    lay = K.layout_of(vehicle)
    dt = sim.dt
    t, x, u, s = state.t, state.x, state.u, state.s
    xv, uv, sv = x["vehicle"], u["vehicle"], s["vehicle"]

    buf = K.pack_vehicle(vehicle, xv, uv, sv, s["terminated"])
    stage_in = buf[:K.rows(lay.stage_in)]
    k = torch.zeros((K.rows(lay.stage_out), buf.shape[1]), dtype=buf.dtype,
                    device=buf.device)
    acc = k
    for c, w in STAGES:
        k = K.rk4_stage_packed(vehicle, stage_in, k, c * dt, block)
        acc = acc + w * k
    out = K.rk4_finish_packed(vehicle, buf, acc, dt, False, block)

    i_new = state.i + 1
    t_new = sim.t_start + i_new.to(t.dtype) * dt
    xv2, s_sys2, term2, _, kin_y, sys_y = K.unpack_out(
        lay.names["rk4_finish"], out)
    sv2 = dict(sv, systems=s_sys2)
    if (i + 1) % sim.geoid_every == 0:
        q_rows = out[K.rows_of(lay.x_groups, "q_ew")]
        sv2["geoid_N"] = K.geoid_packed(vehicle.geoid, q_rows, block)[0]
    s2 = dict(s, vehicle=sv2, terminated=term2)
    u2, s2 = _periodic(sim, xv2, u, s2, kin_y, sys_y, i)
    return SimState(t=t_new, i=i_new, x=dict(x, vehicle=xv2), u=u2, s=s2,
                    c=state.c)


def make_cluster_step(sim, state, ctx=(), block=None, split="vehicle"):
    """`step(state, *, i)` advancing a batch-leading SimState like `state`
    by one step, `i` being its (host) step counter, with the avionics'
    periodic pass when it fires: `split="vehicle"` the whole-vehicle
    kernels, `"subsystems"` the five cluster kernels
    (`Simulation.fleet_step`). `block` sizes the vehicle kernels' blocks
    (default: each kernel's own, `launch.LANES` and `launch.BLOCK`): for
    `rk4_stage` and `rk4_finish`, which carry each aircraft in several
    threads, it is the aircraft per block, 32 or 64; for `geoid` the
    threads per block, at most 128. The cluster kernels run at their
    defaults."""
    if ctx != ():
        raise NotImplementedError(
            "mission contexts (core/mission.py) are not ported: ROADMAP P9")
    vehicle = sim.system.aircraft.vehicle
    if state.t.device.type != "cpu":  # build the kernels' operands once
        K.system_params(vehicle)
        K.geoid_grid(vehicle.geoid)
    if split == "vehicle":
        return lambda st, *, i: vehicle_step(sim, st, int(i), block)
    if split == "subsystems":
        return lambda st, *, i: cluster_step(sim, st, int(i))
    raise ValueError(f"split must be 'vehicle' or 'subsystems', not {split!r}")
