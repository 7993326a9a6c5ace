"""Cessna 172X: the fly-by-wire variant, the C172Xv1 world with its
gain-scheduled control laws and the C172Xv2 world with its guidance laws
on top of them (port of `flightjax/models/c172/c172x.py`).

`FlyByWireActuation` carries seven servo states (`x['act']`) with their
own ODEs; its commands arrive in `u['act']`, written by the control laws
on every periodic pass. The trimmed vehicle state, the same for both
worlds, is read from `data/c172xv1_trim.npz`, written by
`tools/export_torch_c172x.py` from the JAX package's trim solver, and the
avionics' bumpless start is worked out here by their `init_from_trim`, so
this module needs no JAX.
"""

import os

import numpy as np
import torch

from flightjax_torch.bridge import tree_from_numpy
from flightjax_torch.core.modeling import divc, tree_map
from flightjax_torch.core.sim import SimState, Simulation
from flightjax_torch.models.c172 import common as C172
from flightjax_torch.models.c172.c172s import power_plant, unflatten
from flightjax_torch.physics.aircraftbase import Aircraft, SimpleWorld, Vehicle
from flightjax_torch.physics.kinematics import WA
from flightjax_torch.physics.terrain import HorizontalTerrain

XV1_NPZ = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                       "data", "c172xv1_trim.npz")

ACT_CHANNELS = ("throttle", "aileron", "elevator", "rudder", "flaps",
                "brake_left", "brake_right")
ACT_RANGES = {"throttle": (0.0, 1.0), "aileron": (-1.0, 1.0),
              "elevator": (-1.0, 1.0), "rudder": (-1.0, 1.0),
              "flaps": (0.0, 1.0), "brake_left": (0.0, 1.0),
              "brake_right": (0.0, 1.0)}
ACT_TAU = 0.05


def _saturation(cmd, lo, hi):
    """Saturation flag of the command (`c172x.py:41-47`): +1 at or above
    the upper bound, -1 at or below the lower, 0 inside."""
    return (cmd >= hi).to(torch.int32) - (cmd <= lo).to(torch.int32)


class Actuator1:
    """First-order servo 1/(1 + s tau) (`c172x.py:50-75`): x_dot =
    (clip(cmd) - x) / tau, the true quotient; the reported position is
    clipped to the range."""

    order = 1

    def __init__(self, tau=ACT_TAU, range=(-1.0, 1.0)):
        self.tau = float(tau)
        self.range = tuple(float(v) for v in range)

    def f_ode(self, x, cmd):
        lo, hi = self.range
        c = torch.clamp(cmd, lo, hi)
        y = {"cmd": c, "pos": torch.clamp(x, lo, hi),
             "sat": _saturation(cmd, lo, hi)}
        return y, divc(c - x, self.tau)


class Actuator2:
    """Second-order servo (`c172x.py:78-106`), underdamped by default; the
    state is {p, v}, the output position clipped, saturation flagged on the
    command."""

    order = 2

    def __init__(self, omega_n=10.0 * np.pi, zeta=0.6, range=(-1.0, 1.0)):
        self.omega_n = float(omega_n)
        self.zeta = float(zeta)
        self.range = tuple(float(v) for v in range)

    def f_ode(self, x, cmd):
        lo, hi = self.range
        c = torch.clamp(cmd, lo, hi)
        y = {"cmd": c, "pos": torch.clamp(x["p"], lo, hi), "vel": x["v"],
             "sat": _saturation(cmd, lo, hi)}
        x_dot = {"p": x["v"],
                 "v": self.omega_n ** 2 * (c - x["p"])
                 - 2.0 * self.zeta * self.omega_n * x["v"]}
        return y, x_dot


class FlyByWireActuation:
    """Seven servo channels (`c172x.py:109-167`), `Actuator1(tau=0.05)` on
    each unless `actuators` overrides a channel. `f_ode(x_act, u)` returns
    (act_y, assignments, {'act': x_act derivative}): act_y is
    {cmd, pos, sat[, vel]}[ch], the assignments those of the C172S sign
    conventions from the servo positions."""

    stateful = True

    def __init__(self, actuators=None):
        self.actuators = {ch: Actuator1(ACT_TAU, ACT_RANGES[ch])
                          for ch in ACT_CHANNELS}
        for ch, act in (actuators or {}).items():
            if ch not in ACT_RANGES:
                raise KeyError(f"unknown actuation channel {ch!r}")
            act.range = ACT_RANGES[ch]
            self.actuators[ch] = act

    def f_ode(self, x_act, u):
        pos, cmd, sat, vel, x_dot = {}, {}, {}, {}, {}
        for ch in ACT_CHANNELS:
            y, dx = self.actuators[ch].f_ode(x_act[ch], u[ch])
            cmd[ch], pos[ch], sat[ch] = y["cmd"], y["pos"], y["sat"]
            if "vel" in y:
                vel[ch] = y["vel"]
            x_dot[ch] = dx
        asg = {"e": -pos["elevator"], "a": pos["aileron"],
               "r": -pos["rudder"], "f": pos["flaps"],
               "steering": pos["rudder"], "brake_left": pos["brake_left"],
               "brake_right": pos["brake_right"],
               "throttle": pos["throttle"],
               "mixture": torch.clamp(u["mixture"], 0.0, 1.0)}
        act_y = {"cmd": cmd, "pos": pos, "sat": sat}
        if vel:
            act_y["vel"] = vel
        return act_y, asg, {"act": x_dot}


def build_vehicle(*, device, dtype, actuators=None, terrain=None,
                  turbulence=None) -> Vehicle:
    """The fly-by-wire C172X on WA kinematics over `terrain` (default flat
    at orthometric 0 m), in Dryden `turbulence` if given (`c172x.py:
    170-175`)."""
    systems = C172.Systems(power_plant(device=device, dtype=dtype),
                           FlyByWireActuation(actuators), device=device,
                           dtype=dtype)
    if terrain is None:
        terrain = HorizontalTerrain(device=device, dtype=dtype)
    return Vehicle(systems, WA(), terrain, device=device, dtype=dtype,
                   turbulence=turbulence)


def build_aircraft(avionics=None, *, device, dtype, **kw) -> Aircraft:
    return Aircraft(build_vehicle(device=device, dtype=dtype, **kw),
                    avionics=avionics)


def build_xv1(gains=None, *, device, dtype, **kw) -> Aircraft:
    """Cessna172Xv1: fly-by-wire actuation and `ControlLaws`
    (`c172x.py:365-370`)."""
    from flightjax_torch.models.c172.c172x_ctl import ControlLaws
    return build_aircraft(ControlLaws(gains, device=device, dtype=dtype),
                          device=device, dtype=dtype, **kw)


def build_xv2(gains=None, *, device, dtype, **kw) -> Aircraft:
    """Cessna172Xv2: fly-by-wire actuation and the guidance laws over the
    control laws, `c172x_gdc.Avionics` (`c172x.py:372-377`)."""
    from flightjax_torch.models.c172.c172x_gdc import Avionics
    return build_aircraft(Avionics(gains, device=device, dtype=dtype),
                          device=device, dtype=dtype, **kw)


def build_xv1_nav(gains=None, *, device, dtype, periodic_dt=0.02,
                  use_estimates=True, nav_kw=None, **kw) -> Aircraft:
    """The C172Xv1 flying on estimated states: fly-by-wire actuation and
    `NavAvionics(ControlLaws)`, the sensors and the 15-state filter between
    the truth and the control laws (`c172x.py:379-390`); `periodic_dt` the
    Simulation's periodic interval, the sensors' and the filter's rate."""
    from flightjax_torch.models.c172.c172x_ctl import ControlLaws
    from flightjax_torch.physics.navigation import NavAvionics
    nav = NavAvionics(ControlLaws(gains, device=device, dtype=dtype),
                      dt=periodic_dt, use_estimates=use_estimates,
                      device=device, dtype=dtype, **(nav_kw or {}))
    return build_aircraft(nav, device=device, dtype=dtype, **kw)


def build_xv2_nav(gains=None, *, device, dtype, periodic_dt=0.02,
                  use_estimates=True, nav_kw=None, **kw) -> Aircraft:
    """The C172Xv2 flying on estimated states: `NavAvionics` around its
    guidance and control laws, which read the filter's position and course
    (`c172x.py:393-406`)."""
    from flightjax_torch.models.c172.c172x_gdc import Avionics
    from flightjax_torch.physics.navigation import NavAvionics
    nav = NavAvionics(Avionics(gains, device=device, dtype=dtype),
                      dt=periodic_dt, use_estimates=use_estimates,
                      device=device, dtype=dtype, **(nav_kw or {}))
    return build_aircraft(nav, device=device, dtype=dtype, **kw)


def load_xv1_state(path=XV1_NPZ):
    """(x, u, s) numpy trees of the trimmed C172Xv1 vehicle at world level
    (without the avionics), the TrimState vector and the trim residual
    norm; `path` another state file of `tools/export_torch_c172x.py`."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return (unflatten(flat, "x"), unflatten(flat, "u"), unflatten(flat, "s"),
            flat["trim_state"], float(flat["trim_rnorm"]))


def trimmed_xv1_state(periodic_dt, dtype, device, build=build_xv1,
                      path=XV1_NPZ, turbulence=None, actuators=None):
    """The world SimState of one trimmed aircraft with its avionics' inputs
    and state from `init_from_trim` (the bumpless start of
    `c172x.py::trim_world`); `build` makes the aircraft (`build_xv1`,
    `build_xv2` or their navigation forms, whose vehicles are the same; a
    mission's, over its terrain), `path` the trim point. With a Dryden
    `turbulence` the vehicle flies in it and the state holds its initial
    trees (W20 = 0, the gusts off: there the trim is the turbulence-free
    one). With `actuators` ({channel: servo}, as `FlyByWireActuation`
    takes them) a second-order servo starts at rest at the trim position,
    {p: position, v: 0} (`Actuator2.trim_x`). The start is worked out on
    the CPU in `dtype` and then moved to `device`."""
    x, u, s, _, _ = load_xv1_state(path)
    kw = {} if turbulence is None else {"turbulence": turbulence}
    if actuators is not None:
        kw["actuators"] = actuators
    cpu = build(device="cpu", dtype=dtype, **kw)
    # the plain vehicle functions take a fleet: one aircraft
    xv, uv, sv = (tree_from_numpy(tree_map(lambda l: np.asarray(l)[None],
                                           t["vehicle"]), "cpu", dtype)
                  for t in (x, u, s))
    x_act = xv["systems"]["act"]
    for ch, servo in cpu.vehicle.systems.act.actuators.items():
        if servo.order == 2:
            x_act[ch] = {"p": x_act[ch], "v": torch.zeros_like(x_act[ch])}
    if turbulence is not None:
        like = xv["kinematics"]["h_e"]
        xv["turb"] = turbulence.init_x(like)
        uv["turb"] = turbulence.init_u(like)
        sv["turb"] = turbulence.init_s(like)
    veh_y = cpu.vehicle.output(xv, uv, sv)
    av_u, av_s = cpu.avionics.init_from_trim(veh_y, periodic_dt)
    state = SimState(
        t=torch.tensor([0.0], dtype=dtype),
        i=torch.tensor([0], dtype=torch.int32),
        x={"vehicle": xv}, u=dict(cpu.init_u(uv), avionics=av_u),
        s=dict(cpu.init_s(sv), avionics=av_s,
               terminated=torch.tensor([bool(s["terminated"])])))
    return tree_map(lambda l: l[0].to(device), state)


def c172xv1_sim(device="cuda", dtype=torch.float32, turbulence=None,
                actuators=None):
    """(sim, trimmed single-aircraft SimState, ctx) of the C172Xv1 on WA
    kinematics: dt = periodic_dt = 0.02 s, geoid refresh every 128 steps,
    Kahan-compensated position in float32, the avionics started bumpless
    from the trim (the JAX package's `trim_world`); in Dryden `turbulence`
    (its dt the step's) if given; with `actuators` ({channel: servo}, e.g.
    {"elevator": Actuator2()}) those channels' servos in place of
    `Actuator1`, a second-order one starting at rest at the trim position.
    Leaves are unbatched; `parallel.fleet.broadcast_state` makes a fleet.
    The modes are those of the trim start (`LON_DIRECT`, `LAT_DIRECT`);
    `turning_climb` engages the autopilot."""
    kw = {} if turbulence is None else {"turbulence": turbulence}
    if actuators is not None:
        kw["actuators"] = actuators
    world = SimpleWorld(build_xv1(device=device, dtype=dtype, **kw))
    sim = Simulation(world, dt=0.02, periodic_dt=0.02, geoid_every=128)
    state = trimmed_xv1_state(sim.periodic_dt, dtype, device,
                              turbulence=turbulence, actuators=actuators)
    return sim, sim.with_compensation(state), ()


def c172xv1_nav_sim(device="cuda", dtype=torch.float32, turbulence=None,
                    use_estimates=True):
    """(sim, trimmed single-aircraft SimState, ctx) of the C172Xv1 on its
    navigation avionics (`build_xv1_nav`, in shadow mode without
    `use_estimates`): dt = periodic_dt = 0.02 s, the sensors and filter at
    50 Hz, in Dryden `turbulence` if given, the geoid refreshed every step
    (the JAX package's `Simulation` default, as `estimation_demos.
    nav_fleet_setup` flies it), Kahan-compensated position in float32; the
    control laws started bumpless and the filter aligned at the trim
    (`NavAvionics.init_from_trim`). `turning_climb` engages the
    autopilot."""
    kw = {} if turbulence is None else {"turbulence": turbulence}
    build = lambda **k: build_xv1_nav(use_estimates=use_estimates, **k)
    world = SimpleWorld(build(device=device, dtype=dtype, **kw))
    sim = Simulation(world, dt=0.02, periodic_dt=0.02)
    state = trimmed_xv1_state(sim.periodic_dt, dtype, device, build=build,
                              turbulence=turbulence)
    return sim, sim.with_compensation(state), ()


def trimmed_xv2_state(periodic_dt, dtype, device, build=build_xv2,
                      turbulence=None):
    """The trimmed C172Xv2: the C172Xv1's vehicle state with the guidance
    and control laws started bumpless (`Avionics.init_from_trim`, the
    guidance direct and not engaged); `build` makes the aircraft
    (`build_xv2`, or `build_xv2_nav`, whose filter is aligned at the trim
    too); in Dryden `turbulence` as `trimmed_xv1_state` puts it."""
    return trimmed_xv1_state(periodic_dt, dtype, device, build=build,
                             turbulence=turbulence)


def c172xv2_sim(device="cuda", dtype=torch.float32, turbulence=None):
    """(sim, trimmed single-aircraft SimState, ctx) of the C172Xv2 on WA
    kinematics, in the form of `c172xv1_sim`: dt = periodic_dt = 0.02 s,
    geoid refresh every 128 steps, Kahan-compensated position in float32,
    the avionics started bumpless; in Dryden `turbulence` (its dt the
    step's) if given. `engage_guidance` engages the guidance."""
    kw = {} if turbulence is None else {"turbulence": turbulence}
    world = SimpleWorld(build_xv2(device=device, dtype=dtype, **kw))
    sim = Simulation(world, dt=0.02, periodic_dt=0.02, geoid_every=128)
    state = trimmed_xv2_state(sim.periodic_dt, dtype, device,
                              turbulence=turbulence)
    return sim, sim.with_compensation(state), ()


def c172xv2_nav_sim(device="cuda", dtype=torch.float32, turbulence=None):
    """(sim, trimmed single-aircraft SimState, ctx) of the C172Xv2 on its
    navigation avionics (`build_xv2_nav`: the guidance and control laws on
    the filter's estimates), in the form of `c172xv1_nav_sim`: dt =
    periodic_dt = 0.02 s, the sensors and filter at 50 Hz, in Dryden
    `turbulence` if given (trimmed without the gusts, the state holding the
    turbulence's initial trees), the geoid refreshed every step,
    Kahan-compensated position in float32; the start `trimmed_xv2_state`
    (the laws bumpless, the filter aligned at the trim, the guidance not
    engaged). `engage_guidance` engages the guidance."""
    kw = {} if turbulence is None else {"turbulence": turbulence}
    world = SimpleWorld(build_xv2_nav(device=device, dtype=dtype, **kw))
    sim = Simulation(world, dt=0.02, periodic_dt=0.02)
    state = trimmed_xv2_state(sim.periodic_dt, dtype, device,
                              build=build_xv2_nav, turbulence=turbulence)
    return sim, sim.with_compensation(state), ()


def offset_point(lat, lon, h, north, east):
    """(lat, lon) of the point `north` and `east` metres from (lat, lon, h)
    along the local level frame there, in float64 (numbers or arrays of
    one shape): the construction of the loiter test,
    `tests/test_c172x2.py:150-157`."""
    from flightjax_torch.ops import geodesy as geo
    from flightjax_torch.ops.quaternions import qrot
    f = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    n_e = geo.nvector_from_latlon(f(lat), f(lon))
    north, east = torch.broadcast_tensors(f(north), f(east))
    r_n = torch.stack([north, east, torch.zeros_like(north)], dim=-1)
    r = geo.cartesian_from_geographic(n_e, f(h)) + qrot(geo.ltf(n_e), r_n)
    lat2, lon2 = geo.latlon_from_nvector(geo.geographic_from_cartesian(r)[0])
    return lat2.numpy(), lon2.numpy()


def engage_guidance(state, mode, target=None, orbit=None, hor=True,
                    vrt=True):
    """`state` (a C172Xv2 SimState) with its guidance requesting `mode`
    (`GDC_SEGMENT` or `GDC_CIRCULAR`, an int or a per-lane array) on
    `target` (a `Segment`) or `orbit` (a `Circle`), each one for all lanes
    or one per lane, with the lateral (`hor`) and vertical (`vrt`)
    guidance requested (bools or per-lane arrays): the scenario of
    `tests/test_c172x2.py:115-125` and `:159-163`; on the sensor-fed
    C172Xv2 its navigation avionics' inner guidance."""
    av = state.u["avionics"]
    inner = av.get("inner", av)
    g = dict(inner["gdc"])
    def like(v, ref):
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        return v.to(device=ref.device, dtype=ref.dtype).expand_as(
            ref).clone()

    g["mode_req"] = like(mode, g["mode_req"])
    g["hor_gdc_req"] = like(hor, g["hor_gdc_req"])
    g["vrt_gdc_req"] = like(vrt, g["vrt_gdc_req"])
    for key, geom in (("target", target), ("orbit", orbit)):
        if geom is not None:
            g[key] = type(geom)(*(like(v, r) for v, r in zip(geom, g[key])))
    inner = dict(inner, gdc=g)
    av = dict(av, inner=inner) if "inner" in av else inner
    return state._replace(u=dict(state.u, avionics=av))


def turning_climb(state, EAS_ref=45.0, clm_ref=1.5, chi_ref=np.pi / 2):
    """`state` with the autopilot engaged on the turning climb of the f32
    envelope study: `LON_EAS_CLM` at EAS 45 m/s and 1.5 m/s climb,
    `LAT_CHI_BETA` onto course pi / 2 (`tools/exp_f32_comp.py:52-70`)."""
    from flightjax_torch.models.c172 import c172x_ctl as CTL
    av = state.u["avionics"]
    ctl = av.get("inner", av)  # the navigation avionics' inner laws
    set_ = lambda d, **kw: dict(d, **{k: torch.full_like(d[k], v)
                                      for k, v in kw.items()})
    lon = set_(ctl["lon"], mode_req=CTL.LON_EAS_CLM, EAS_ref=EAS_ref,
               clm_ref=clm_ref)
    lat = set_(ctl["lat"], mode_req=CTL.LAT_CHI_BETA, chi_ref=chi_ref)
    ctl = dict(ctl, lon=lon, lat=lat)
    av = dict(av, inner=ctl) if "inner" in av else ctl
    return state._replace(u=dict(state.u, avionics=av))
