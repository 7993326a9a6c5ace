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

A world whose aircraft has avionics (the C172Xv1's `ControlLaws`, the
C172Xv2's guidance and control laws) runs its periodic pass after the step
when it fires, `(i + 1) % steps_per_periodic == 0`
(`clusterstep.py:591-607`): the avionics read the VehicleY at the new
state, which the finish kernels of the fly-by-wire C172 store beside the
state (finish_kin's KinData and AirData and finish_sys's airflow angles
and weight on wheels; rk4_finish's KIN_Y and SYS_Y rows), and write the
servo commands. The pass runs as the `ctl_laws` or `gdc_ctl_laws` kernel
on the card (their plain versions on the CPU or with `plain`); the
guidance also reads the n-vector of the new position, which the pass
works out from the new q_ew, as KinData holds it. A scripted mission over
the C172Xv2 (`core/mission.py`) runs as the `msn_ctl_laws` kernel, which
also reads the engine's state of the new S_SYS and writes the flaps,
brake and engine-start inputs its phases override; a mission the kernels
do not carry (arbitrary callables, another inner avionics) runs its own
plain pass, on the CPU or with `plain` only. The navigation avionics
(`physics/navigation.py`) run their sensors and filter as the `nav_pass`
kernel on the card (its plain version on the CPU or with `plain`) and then
the inner avionics' pass kernel on the estimates (`_nav_periodic`). The
pass runs before the geoid refresh of the same step and reads the state
before it, as `Simulation.fleet_step` orders them (the JAX cluster kernels
refresh first; the two differ on refresh steps by the undulation's change
over 128 steps, micrometres).
"""

import torch

from flightjax_torch.core.mission import MissionAvionics
from flightjax_torch.core.modeling import tree_map
from flightjax_torch.core.sim import SimState
from flightjax_torch.ops.geodesy import nvector_from_qew
from flightjax_torch.parallel import kernels as K
from flightjax_torch.physics.navigation import NavAvionics

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


def _refuse_turbulence(vehicle):
    if getattr(vehicle, "turbulence", None) is not None:
        raise NotImplementedError(
            "the subsystems split carries no turbulence, as the JAX "
            "package's has no turbulent instance (clusterstep.py:568): a "
            "turbulent vehicle steps through Simulation.fleet_step or "
            "make_cluster_step(split='vehicle')")


def cluster_step(sim, state: SimState, i: int, *, plain=False,
                 geoid_every=None) -> SimState:
    """Advance a batch-leading world SimState whose step counter is `i`
    through the five cluster kernels, or with `plain` through their plain
    versions on any device. The geoid is refreshed when (i + 1) is a
    multiple of `geoid_every` (default `sim.geoid_every`). A turbulent
    vehicle is refused (`vehicle_step` carries it)."""
    vehicle = sim.system.aircraft.vehicle
    _refuse_turbulence(vehicle)
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
    s2 = dict(s, vehicle=sv2, terminated=term2)
    u2, s2 = _periodic(sim, xv2, u, s2, kin_y, sys_y, i, plain)
    if (i + 1) % (sim.geoid_every if geoid_every is None
                  else geoid_every) == 0:
        s2["vehicle"] = vehicle.refresh_geoid(xv2, s2["vehicle"],
                                              plain=plain)
    c2 = None if c_kin2 is None else {"vehicle": {"kinematics": c_kin2}}
    return SimState(t=t_new, i=i_new, x=dict(x, vehicle=xv2), u=u2, s=s2,
                    c=c2)


def check_sensor_epoch(sim, state, i):
    """On the CPU, that a navigation fleet's sensor epoch on every lane
    counts the periodic firings before step `i` (the fleet starts at step
    0 with its sensors' counter at 0, where `init_s` and `init_from_trim`
    start it): the entry points that take the host's step counter check
    it. The pass itself reads each lane's own counter."""
    from flightjax_torch.physics.navigation import NavAvionics
    if not isinstance(sim.system.aircraft.avionics, NavAvionics):
        return
    n = state.s["avionics"]["sens"]["n"]
    n0 = i // sim.steps_per_periodic
    if n.device.type == "cpu" and bool((n != n0).any()):
        raise ValueError(
            f"the sensor epoch {int(n.reshape(-1)[0])} is not the count of "
            f"firings before step {i} ({n0}): the navigation fleet starts "
            f"at step 0 with its sensors' counter at 0")


def _nav_periodic(sim, xv, u, s, kin_y, sys_y, i, plain, t):
    """The navigation avionics' pass (`NavAvionics.f_periodic` and
    `assign`) after step `i`: the truth at the new state for the sensors
    (`kernels.vehicle_truth`, its systems through the `systems` kernel on
    the card), then on the card the `nav_pass` kernel (the sensors, the
    filter and its monitors, the estimated VehicleY; the aiding block where
    each lane's own epoch aids), on the CPU or with `plain` its plain
    version (`kernels.nav_pass_plain`, the aiding block skipped where no
    lane's own epoch aids), then the inner avionics' pass kernel
    (`ctl_laws` or `gdc_ctl_laws`, their plain versions on the CPU or with
    `plain`) on the estimated VehicleY, or in shadow mode on the truth the
    truth-fed pass reads."""
    world = sim.system
    nav = world.aircraft.avionics
    vehicle = world.aircraft.vehicle
    uv, sv = u["vehicle"], s["vehicle"]
    s_av, u_av = s["avionics"], u["avionics"]
    name = K.avionics_layout(vehicle, nav).pass_name
    vy = K.vehicle_y(vehicle, xv, uv, kin_y, sys_y)
    kin, air, dyn = K.vehicle_truth(vehicle, xv, uv, sv, t,
                                    K.systems_plain if plain else K.systems)
    truth = vy._replace(kinematics=kin, airflow=air, dynamics=dyn)
    vy = vy._replace(kinematics=vy.kinematics._replace(n_e=kin.n_e))
    h_trn = vehicle.terrain.terrain_data(uv["trn"]).elevation
    if plain or h_trn.device.type == "cpu":
        s_nav, y = K.nav_pass_plain(nav, vy, truth, h_trn, u_av, s_av)
    else:
        s_nav, y = K.nav_pass(nav, vy, truth, h_trn, u_av, s_av)
    fn = getattr(K, name + "_plain" if plain else name)
    s_in, cmd, *_ = fn(nav.inner, y, u_av["inner"], s_av["inner"],
                       world.periodic_dt)
    u_sys = u["vehicle"]["systems"]
    u_sys = dict(u_sys, act=dict(u_sys["act"], **cmd))
    return (dict(u, vehicle=dict(u["vehicle"], systems=u_sys)),
            dict(s, avionics=dict(s_nav, inner=s_in)))


def _periodic(sim, xv, u, s, kin_y, sys_y, i, plain=False, t=None):
    """The world's periodic pass after step `i` if it fires, when the
    counter it makes, i + 1, is a multiple of `steps_per_periodic`
    (`sim.py:327-328`; no ported avionics reads the firing index): the
    avionics on the VehicleY at the new state xv (from the finish's kin_y
    and sys_y; for the guidance also the n-vector of xv's q_ew, for a
    mission the engine's state of the new S_SYS in `s`) write the servo
    commands, as the `ctl_laws` kernel (the C172Xv1's control laws), the
    `gdc_ctl_laws` kernel (the C172Xv2's guidance and control laws) or the
    `msn_ctl_laws` kernel (a mission over them, which also writes the
    systems inputs its phases override), or their plain versions with
    `plain`; the navigation avionics through `_nav_periodic`, which reads
    the new time `t` on a turbulent vehicle. Returns (u, s)."""
    world = sim.system
    avionics = world.aircraft.avionics
    if avionics is None or (i + 1) % sim.steps_per_periodic != 0:
        return u, s
    if isinstance(avionics, NavAvionics):
        return _nav_periodic(sim, xv, u, s, kin_y, sys_y, i, plain, t)
    vehicle = world.aircraft.vehicle
    eng = s["vehicle"]["systems"]["pwp"]["engine"]["state"]
    q_ew = xv["kinematics"]["q_ew"]
    if (isinstance(avionics, MissionAvionics)
            and (plain or q_ew.device.type == "cpu")
            and K.mission_refusal(avionics) is not None):
        # a mission the kernels do not carry: its own pass, plain
        vy = K.vehicle_y(vehicle, xv, u["vehicle"], dict(
            kin_y, n_e=nvector_from_qew(q_ew)), sys_y, eng)
        return world.aircraft.f_periodic(u, s, vy)
    name = K.avionics_layout(vehicle, avionics).pass_name
    if name != "ctl_laws":
        kin_y = dict(kin_y, n_e=nvector_from_qew(q_ew))
    vy = K.vehicle_y(vehicle, xv, u["vehicle"], kin_y, sys_y,
                     eng if name == "msn_ctl_laws" else None)
    y = {"ctl_laws": K.ctl_y, "gdc_ctl_laws": K.gdc_y,
         "msn_ctl_laws": K.msn_y}[name](vy)
    fn = getattr(K, name + "_plain" if plain else name)
    u_sys = u["vehicle"]["systems"]
    extra = (u_sys,) if name == "msn_ctl_laws" else ()
    s_av, cmd, *rest = fn(avionics, y, u["avionics"], s["avionics"],
                          world.periodic_dt, *extra)
    act = dict(u_sys["act"], **cmd)
    u_sys = dict(u_sys, act=act)
    if name == "msn_ctl_laws":  # the phases' systems overrides
        over = rest[1]
        act.update(over["act"])
        pwp = u_sys["pwp"]
        u_sys["pwp"] = dict(pwp, engine=dict(pwp["engine"],
                                             **over["pwp"]["engine"]))
    u2 = dict(u, vehicle=dict(u["vehicle"], systems=u_sys))
    return u2, dict(s, avionics=s_av)


def vehicle_step(sim, state: SimState, i: int, block=None, comp=False,
                 plain=False, geoid_every=None) -> SimState:
    """Advance a batch-leading world SimState whose step counter is `i`
    through `rk4_stage` x 4 and `rk4_finish` (their plain versions on the
    CPU or with `plain`), uncompensated as the JAX path is unless `comp`,
    when the finish carries the residuals of `state.c` (the turbulent
    `Simulation.fleet_step`); without it `state.c` passes through. The
    geoid is refreshed when (i + 1) is a multiple of `geoid_every` (default
    `sim.geoid_every`). On the turbulent C172S the instances
    `rk4_stage_turb` and `rk4_finish_turb`, which also read the start time
    and the int32 rows (i, seed, n)."""
    vehicle = sim.system.aircraft.vehicle
    lay = K.layout_of(vehicle)
    dt = sim.dt
    t, x, u, s = state.t, state.x, state.u, state.s
    xv, uv, sv = x["vehicle"], u["vehicle"], s["vehicle"]
    c_kin = _comp_kin(state) if comp else None

    buf = K.pack_vehicle(vehicle, xv, uv, sv, s["terminated"], c_kin,
                         t=t if lay.turb else None)
    ints = K.pack_turb_int(state.i, uv, sv) if lay.turb else None
    stage_in = buf[:K.rows(lay.stage_in)]
    k = torch.zeros((K.rows(lay.stage_out), buf.shape[1]), dtype=buf.dtype,
                    device=buf.device)
    acc = k
    for c, w in STAGES:
        k = (K.rk4_stage_packed_plain(vehicle, stage_in, k, c * dt) if plain
             else K.rk4_stage_packed(vehicle, stage_in, k, c * dt, block))
        acc = acc + w * k
    if plain:
        out = K.rk4_finish_packed_plain(vehicle, buf, acc, dt, comp, ints,
                                        sim.t_start)
    else:
        out = K.rk4_finish_packed(vehicle, buf, acc, dt, comp, block, ints,
                                  sim.t_start)

    i_new = state.i + 1
    t_new = K.step_time(sim.t_start, state.i, dt, t)
    xv2, s_sys2, term2, c_kin2, kin_y, sys_y, *s_turb = K.unpack_out(
        lay.names["rk4_finish"], out, comp, ints)
    sv2 = dict(sv, systems=s_sys2)
    if s_turb:
        sv2["turb"] = s_turb[0]
    s2 = dict(s, vehicle=sv2, terminated=term2)
    u2, s2 = _periodic(sim, xv2, u, s2, kin_y, sys_y, i, plain,
                       t=t_new if s_turb else None)
    if (i + 1) % (sim.geoid_every if geoid_every is None
                  else geoid_every) == 0:
        q_rows = out[K.rows_of(lay.x_groups, "q_ew")]
        s2["vehicle"] = dict(s2["vehicle"], geoid_N=(
            K.geoid_plain(vehicle.geoid, q_rows.t()) if plain
            else K.geoid_packed(vehicle.geoid, q_rows, block)[0]))
    c2 = state.c
    if comp and c_kin2 is not None:
        c2 = {"vehicle": {"kinematics": c_kin2}}
    return SimState(t=t_new, i=i_new, x=dict(x, vehicle=xv2), u=u2, s=s2,
                    c=c2)


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
            "the step takes no context: ctx is () in every model, and the "
            "mission is an avionics wrapper (MissionAvionics, "
            "core/mission.py)")
    aircraft = sim.system.aircraft
    vehicle = aircraft.vehicle
    if state.t.device.type != "cpu":  # build the kernels' operands once
        K.system_params(vehicle)
        K.geoid_grid(vehicle.geoid)
        if aircraft.avionics is not None:  # refuses what has no kernel
            if K.avionics_layout(vehicle, aircraft.avionics).nav:
                K.ctl_gains(K.control_laws(aircraft.avionics))
                K.normal_table(state.t.device)
            K.ctl_gains(aircraft.avionics)
    if split == "vehicle":
        fn = lambda st, i: vehicle_step(sim, st, i, block)
    elif split == "subsystems":
        _refuse_turbulence(vehicle)
        fn = lambda st, i: cluster_step(sim, st, i)
    else:
        raise ValueError(
            f"split must be 'vehicle' or 'subsystems', not {split!r}")

    def step(st, *, i):
        check_sensor_epoch(sim, st, int(i))
        return fn(st, int(i))
    return step
