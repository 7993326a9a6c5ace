"""The scripted-mission path of flightjax_torch against flightjax, float64
on the CPU (the kernels' plain versions), on inputs drawn with numpy from a
seed and handed to both packages:

- `ellip_from_orth` and the LOWS traffic-pattern legs to 1e-12;
- every phase's `apply`, `done` and `systems` of the traffic pattern and
  the whole `MissionAvionics.f_periodic` with `assign` on the mode-rich
  mission operands (`testing.msn_laws_args`: lanes in every phase, each
  done kind on both sides of its switch, a phase past the end) against
  the JAX package's vmapped ones, to 1e-12 (modes, flags and phases
  exactly), and the wrapper's plain version is that pass;
- 8 lanes of the card's mission fleet, among them lanes whose phase
  advances inside the window, stepped 5 times through
  `Simulation.fleet_step`, `make_cluster_step(split="vehicle")` and
  `make_megakernel_step` with the geoid refreshed every step, against
  `jax.jit(sim.fleet_step)` of the JAX mission world, every leaf to 1e-9;
- (slow) 16 lanes of the fleet over 1000 steps against JAX, to 1e-9
  until the runway lanes start rolling, the landing lanes throughout;
- a phase machine of arbitrary callables over the C172Xv1's control laws
  (`tests/test_c172x2.py::test_mission_phase_machine`) on the port's
  plain path, against JAX over a few steps and (slow) over its 120 s;
- the refusals of the kernel paths, the row maps of `csrc/c172x_msn.cuh`,
  the megakernel buffer's round trip and the mission paths without JAX.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.mission import MissionAvionics as JMissionAvionics
from flightjax.core.mission import Phase as JPhase
from flightjax.core.sim import SimState as JSimState
from flightjax.core.sim import Simulation as JSimulation
from flightjax.demos import c172_demos as D
from flightjax.models.c172 import c172x_ctl as JCTL
from flightjax.ops import geodesy as Jgeo

from flightjax_torch.bridge import tree_to_numpy
from flightjax_torch.core.mission import MissionAvionics, Phase
from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.core.sim import SimState, Simulation
from flightjax_torch.models.c172 import c172x as Tx
from flightjax_torch.models.c172 import c172x_ctl as TCTL
from flightjax_torch.models.c172 import missions as M
from flightjax_torch.ops import geodesy as Tgeo
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import make_cluster_step
from flightjax_torch.parallel.fleet import fleet_rollout
from flightjax_torch.parallel.megakernel import make_megakernel_step
from flightjax_torch.testing import (CROSS_TRACK, PAST_END, msn_laws_args,
                                     msn_operand_state, msn_scenario,
                                     msn_sim)

from test_torch_support import F64, assert_tree_close, to_jax, to_torch

TOL_OP = 1e-12
TOL = 1e-9
# the steps of the fleet's slow test before the pattern lanes' engines
# pull against the tyres' friction (the standby and the engine start)
BREAKAWAY = 250
DT = 0.02
SEED = 20261017
B = 8
STEPS = 5
# the mode-rich operands' lanes with a wheel on the ground (past the lanes
# `msn_operands` sets)
GROUND = (21, 27)


def _as_jax(tree_np, template):
    """The port's numpy tree with the JAX package's NamedTuple classes of
    `template` (the leaves pair by path; both flatten dict keys sorted)."""
    leaves = tree_leaves_with_path(tree_np)
    ref = jax.tree_util.tree_flatten_with_path(template)
    names = [tuple(getattr(k, "key", getattr(k, "name", None)) for k in p)
             for p, _ in ref[0]]
    assert [p for p, _ in leaves] == names
    return jax.tree_util.tree_unflatten(ref[1], [jnp.asarray(v)
                                                 for _, v in leaves])


def _jax_pattern():
    """The JAX package's traffic-pattern phases, as `c172_demos.
    traffic_pattern` lists them (`:548-570`)."""
    legs = D._lows_pattern()
    lib = D._mission_phase_lib(legs)
    hold = lambda u, y, t: u
    return [
        JPhase("standby", hold, lambda y, t: t >= 5.0),
        JPhase("startup", hold, lib["engine_running"],
               systems=lib["engine_start"]),
        JPhase("takeoff", lib["fly_leg"](legs["departure"], 35.0,
                                         throttle=1.0), lib["airborne"]),
        JPhase("departure", lib["fly_leg"](legs["departure"], 35.0,
                                           throttle=1.0),
               lib["captured"](legs["departure"])),
        JPhase("crosswind", lib["fly_leg"](legs["crosswind"], 35.0,
                                           throttle=1.0),
               lib["captured"](legs["crosswind"])),
        JPhase("downwind", lib["fly_leg"](legs["downwind"], 50.0),
               lib["captured"](legs["downwind"])),
        JPhase("base", lib["fly_leg"](legs["base"], 30.0),
               lib["captured"](legs["base"]), systems=lib["flaps"](1.0)),
        JPhase("final", lib["fly_leg"](legs["final"], 30.0),
               lib["final_done"], systems=lib["flaps"](1.0)),
        JPhase("flare", lib["flare_apply"], lib["on_gnd"],
               systems=lib["flaps"](1.0)),
        JPhase("ground", lib["ground_apply"],
               lambda y, t: jnp.asarray(False),
               systems=lib["ground_systems"]),
    ]


# ------------------------------------------------------------ geodesy, legs

def test_ellip_from_orth_matches_jax():
    rng = np.random.default_rng(SEED)
    lat, lon = rng.uniform(-1.5, 1.5, 64), rng.uniform(-np.pi, np.pi, 64)
    h = rng.uniform(-100.0, 4000.0, 64)
    n_t = Tgeo.nvector_from_latlon(torch.as_tensor(lat),
                                   torch.as_tensor(lon))
    n_j = Jgeo.nvector_from_latlon(jnp.asarray(lat), jnp.asarray(lon))
    got = Tgeo.ellip_from_orth(torch.as_tensor(h), n_t)
    ref = jax.vmap(Jgeo.ellip_from_orth)(jnp.asarray(h), n_j)
    assert_tree_close(got, np.asarray(ref), TOL_OP)
    back = Tgeo.orth_from_ellip(got, n_t)
    assert_tree_close(back, h, TOL_OP)


def test_lows_pattern_matches_jax():
    """The five legs (n-vectors and ellipsoidal heights of both endpoints)
    and the runway's height to 1e-12, and the legs chain."""
    got, ref = M.lows_pattern(), D._lows_pattern()
    assert set(got) == set(ref)
    for name in M.LEG_NAMES:
        for f in ("n_e1", "h_e1", "n_e2", "h_e2"):
            assert_tree_close(getattr(got[name], f),
                              np.asarray(getattr(ref[name], f)), TOL_OP,
                              f"{name}.{f}")
    assert got["h_rwy"] == pytest.approx(ref["h_rwy"], rel=TOL_OP)
    assert torch.equal(got["base"].n_e2, got["final"].n_e1)


# ------------------------------------------------------------ the phases

@pytest.fixture(scope="module")
def mode_rich():
    """(avionics, y, u, s, dt, u_sys) of `msn_laws_args` on 32 lanes."""
    return msn_laws_args(32, SEED, "cpu", F64, ground_lanes=GROUND)


def _jax_args(args):
    """The JAX package's (u, s, VehicleY, t, u_sys) of the port's pass
    arguments."""
    avionics, y, u, s, dt, u_sys = args
    jm = JMissionAvionics(None, _jax_pattern())
    from flightjax.models.c172.c172x_gdc import Avionics as JAvionics
    jav = JAvionics()
    ju = _as_jax(tree_to_numpy(u), jav.init_u())
    js = _as_jax(tree_to_numpy(s), {"inner": jav.init_s(),
                                    "phase": jnp.asarray(0, jnp.int32),
                                    "t": jnp.asarray(0.0)})
    jvy = K.ctl_vehicle_y(to_jax(tree_to_numpy(y)))
    return jm, jav, ju, js, jvy, to_jax(tree_to_numpy(K.msn_usys(u_sys)))


def test_mode_rich_operands_cross_every_switch(mode_rich):
    """Lanes in every phase and past the end; each predicate on both sides
    of its switch (the port's plain predicates, held to JAX's below)."""
    avionics, y, u, s, _, _ = mode_rich
    vy = K.ctl_vehicle_y(y)
    phase = s["phase"]
    assert set(range(10)) | {PAST_END} <= set(phase.tolist())
    for k, p in enumerate(avionics.phases):
        if k == M.GROUND:
            continue
        done = torch.broadcast_to(p.done(vy, s["t"]), phase.shape)
        on = phase == k
        assert bool(done[on].any()) and bool((~done[on]).any()), p.name


@pytest.mark.parametrize("k", range(10), ids=[p.name for p in
                                               M.traffic_pattern_phases()])
def test_phase_matches_jax(mode_rich, k):
    """Phase k's `apply`, `done` and `systems` on every lane of the
    mode-rich operands against the JAX package's vmapped ones: the
    overridden inputs to 1e-12, the predicate exactly."""
    avionics, y, u, s, _, u_sys = mode_rich
    _, _, ju, js, jvy, ju_sys = _jax_args(mode_rich)
    p, jp = avionics.phases[k], _jax_pattern()[k]
    vy = K.ctl_vehicle_y(y)
    got = p.apply(u, vy, s["t"])
    ref = jax.vmap(jp.apply)(ju, jvy, js["t"])
    assert_tree_close(got, jax.tree.map(np.asarray, ref), TOL_OP)
    got_d = torch.broadcast_to(p.done(vy, s["t"]), s["phase"].shape)
    ref_d = jax.vmap(lambda yy, tt: jnp.asarray(jp.done(yy, tt)))(jvy,
                                                                  js["t"])
    assert got_d.tolist() == np.asarray(ref_d).tolist()
    if p.systems is None:
        assert jp.systems is None
        return
    sub = K.msn_usys(u_sys)
    assert_tree_close(p.systems(sub), jax.tree.map(
        np.asarray, jax.vmap(jp.systems)(ju_sys)), 0.0)


def test_mission_pass_matches_jax(mode_rich):
    """`MissionAvionics.f_periodic` and `assign` on the mode-rich operands
    against the JAX package's pass run eagerly: the new state (the phase
    exactly), the control laws' outputs and the systems inputs to 1e-12,
    the guidance's mode and flags exactly; the wrapper's plain version is
    that pass."""
    avionics, y, u, s, dt, u_sys = mode_rich
    jm, jav, ju, js, jvy, ju_sys = _jax_args(mode_rich)
    jm.inner = jav
    got = avionics.f_periodic(s, u, K.ctl_vehicle_y(y), dt)
    ref = jax.vmap(jm.f_periodic, in_axes=(0, 0, 0, None))(js, ju, jvy, dt)
    assert_tree_close(got[0], jax.tree.map(np.asarray, ref[0]), TOL_OP)
    assert_tree_close(got[1]["inner"]["ctl"], jax.tree.map(
        np.asarray, ref[1]["inner"]["ctl"]), TOL_OP)
    assert got[1]["phase"].tolist() == np.asarray(ref[1]["phase"]).tolist()
    for f in ("mode", "hor_gdc", "vrt_gdc"):
        assert getattr(got[1]["inner"]["gdc"], f).tolist() == np.asarray(
            getattr(ref[1]["inner"]["gdc"], f)).tolist(), f
    sub = dict(K.msn_usys(u_sys), act=dict(K.msn_usys(u_sys)["act"], **{
        ch: torch.zeros(32, dtype=F64) for ch in K.CTL_CMD}))
    got_sys = avionics.assign(sub, got[1])
    ref_sys = jax.vmap(jm.assign)(to_jax(tree_to_numpy(sub)), ref[1])
    assert_tree_close(got_sys, jax.tree.map(np.asarray, ref_sys), TOL_OP)
    # the phase advanced on some lanes and held on others, the last and the
    # past-the-end lanes stay
    phase = s["phase"]
    moved = got[0]["phase"] != phase
    assert bool(moved.any()) and bool((~moved).any())
    assert not bool(moved[phase >= M.GROUND].any())
    # the wrapper's plain version is this pass
    s2, cmd, g, sys2 = K.msn_ctl_laws_plain(*mode_rich)
    assert_tree_close(s2, tree_to_numpy(got[0]), 0.0)
    assert_tree_close(cmd, {k: got_sys["act"][k] for k in K.CTL_CMD}, 0.0)
    assert_tree_close(g, {k: getattr(got[1]["inner"]["gdc"], k)
                          for k, _ in K.GDC_YOUT}, 0.0)
    assert_tree_close(sys2, tree_to_numpy(K.msn_usys(got_sys)), 0.0)


# ------------------------------------------------------------ fleet step

# the window's lanes: two landing lanes on the final, one landing lane put
# in the takeoff (airborne: it moves on to the departure at the first
# firing), one in the flare; one pattern lane whose standby ends inside the
# window, two in the standby, one in the startup and one rolling out on the
# ground
PHASES = {2: M.TAKEOFF, 3: M.FLARE, 5: M.STARTUP, 7: M.GROUND}
CLOCK_LANE, CLOCK_T0 = 4, 4.95


def _fleet():
    """numpy (t, i, x, u, s) of the step tests: `msn_scenario` on B lanes
    with the phases of PHASES and CLOCK_LANE's standby ending after three
    firings."""
    (t, i, x, u, s), _ = msn_scenario(B, SEED)
    for lane, ph in PHASES.items():
        s["avionics"]["phase"][lane] = ph
    s["avionics"]["t"][CLOCK_LANE] = CLOCK_T0
    return t, i, x, u, s


def _jax_state(t, i, x, u, s, av):
    u = dict(u, avionics=_as_jax(u["avionics"], av.init_u()))
    s = dict(s, avionics=_as_jax(s["avionics"], av.init_s()))
    return JSimState(t=jnp.asarray(t), i=jnp.asarray(i), x=to_jax(x),
                     u=to_jax(u), s=to_jax(s))


@pytest.fixture(scope="module")
def jax_world():
    return D._mission_world(_jax_pattern())


@pytest.fixture(scope="module")
def jax_steps(jax_world):
    """The JAX fleet step of the mission world with the geoid refreshed
    after every step, STEPS times from `_fleet`."""
    sim = JSimulation(jax_world, dt=DT, periodic_dt=DT, geoid_every=1)
    step = jax.jit(sim.fleet_step)
    st = _jax_state(*_fleet(), jax_world.aircraft.avionics)
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(jax.tree.map(np.asarray, st))
    return out


def _sim():
    return Simulation(M.mission_world(M.traffic_pattern_phases(),
                                      device="cpu", dtype=F64),
                      dt=DT, periodic_dt=DT, geoid_every=1)


@pytest.mark.parametrize("path", ["subsystems", "vehicle", "megakernel"])
def test_fleet_step_matches_jax(jax_steps, path):
    """Both splits and the megakernel of the mission world with the geoid
    refreshed every step against the JAX fleet step, every leaf after each
    of STEPS steps to 1e-9; lanes move to their next phase inside the
    window (the takeoff lane at the first firing, the standby lane at the
    fourth, which starts its engine)."""
    t, i, x, u, s = _fleet()
    sim = _sim()
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    if path == "megakernel":
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
    step = (make_cluster_step(sim, st, split="vehicle") if path == "vehicle"
            else sim.fleet_step)
    K.reset_launches()
    phases = []
    for k in range(STEPS):
        if path == "megakernel":
            bufs = step_packed(bufs)
            st = unpack(bufs)
        else:
            st = step(st, i=k)
        ref = jax_steps[k]
        for name in ("t", "i", "x", "u", "s"):
            assert_tree_close({name: getattr(st, name)},
                              {name: getattr(ref, name)}, TOL, f"step {k}: ")
        phases.append(st.s["avionics"]["phase"].tolist())
    assert not any(K.LAUNCHES.values())
    assert phases[0][2] == M.DEPARTURE and phases[-1][2] == M.DEPARTURE
    assert [p[CLOCK_LANE] for p in phases] == [0, 0, 0, 1, 1]
    start = st.u["vehicle"]["systems"]["pwp"]["engine"]["start"]
    assert bool(start[CLOCK_LANE]) and bool(start[5]) and not bool(start[6])
    brake = st.u["vehicle"]["systems"]["act"]["brake_left"]
    assert float(brake[7]) == 1.0 and float(brake[6]) == 0.0


def test_megakernel_buffers_roundtrip_msn():
    """The mission world's resident buffer (megakernel_gdc's rows, then the
    phase and the clock) round-trips through pack / unpack exactly, the
    phase back as int32."""
    from flightjax_torch.core.sim import comp_residuals
    sim = msn_sim("cpu", F64)
    st = msn_operand_state(24, SEED, "cpu", F64, (3, 17), (5,), (11,))
    st = st._replace(c=comp_residuals(st.x, force=True))
    bufs, _, unpack = make_megakernel_step(sim, st)
    assert bufs[0].shape == (K.rows(K.MSN.mega), 24) == (160, 24)
    back = unpack(bufs)
    pa, pb = tree_leaves_with_path(tuple(back)), tree_leaves_with_path(
        tuple(st))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, a), (_, b) in zip(pa, pb):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    assert back.s["avionics"]["phase"].dtype == torch.int32
    assert PAST_END - 1 in back.s["avionics"]["phase"].tolist()


def test_scenario_starts():
    """The fleet's two starts: the landing lanes on the final leg within
    the cross-track and height offsets of its trim, in the final phase,
    their easterly crosswinds in 3..9 m/s; the pattern lanes on the
    threshold with the engine off, in the standby."""
    (t, i, x, u, s), (land, pattern) = msn_scenario(16, SEED)
    sim = M.mission_sim(M.traffic_pattern_phases(), device="cpu", dtype=F64)
    vehicle = sim.system.aircraft.vehicle
    vy = vehicle.output(*(to_torch(tree["vehicle"]) for tree in (x, u, s)))
    legs = M.lows_pattern()
    from flightjax_torch.models.c172 import c172x_gdc as GDC
    d = GDC.segment_data(legs["final"], vy.kinematics.n_e, vy.kinematics.h_e)
    assert bool((d.e_sb[land].abs() < CROSS_TRACK + 1.0).all())
    assert bool((d.v_sb[land].abs() < 6.0).all())
    assert bool((d.s_1b[land].abs() < 1.0).all())
    wind = u["vehicle"]["atm"]["wind"]
    assert np.all((wind[land, 1] > 3.0) & (wind[land, 1] < 9.0))
    h = vehicle.h_agl(*(to_torch(tree["vehicle"]) for tree in (x, u, s)))
    assert bool((h[pattern] - M.DH_TO_GND).abs().max() < 1e-6)
    assert s["avionics"]["phase"][land].tolist() == [M.FINAL] * len(land)
    assert s["avionics"]["phase"][pattern].tolist() == [M.STANDBY] * len(
        pattern)
    assert not s["vehicle"]["systems"]["pwp"]["engine"]["state"][
        pattern].any()
    assert bool(vy.systems.ldg.strut.wow[pattern].any(dim=-1).all())


@pytest.mark.slow
def test_mission_fleet_matches_jax_over_20s(jax_world):
    """16 lanes of the mission fleet over 1000 steps (20 s: the landing
    lanes down the final leg, the pattern lanes through the standby, the
    engine start and the takeoff roll) through `Simulation.fleet_step`
    against JAX's with the geoid refreshed every step (several minutes on
    the CPU): every leaf of every lane to 1e-9 after BREAKAWAY steps, of
    the landing lanes after 1000, and the pattern lanes' phases and engine
    states exactly. On the runway the tyres' friction regulators amplify
    the two packages' rounding apart once the engine pulls (from 1e-13 to
    1e-4 in 15 steps, from step 280 on), so the rolling lanes' continuous
    state is not compared after that."""
    t, i, x, u, s = msn_scenario(16, 1016)[0]
    sim = JSimulation(jax_world, dt=DT, periodic_dt=DT, geoid_every=1)
    step = jax.jit(sim.fleet_step)
    js = _jax_state(t, i, x, u, s, jax_world.aircraft.avionics)
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    psim = _sim()
    land = lambda tree: jax.tree.map(lambda v: v[:8], tree)
    for k in range(1000):
        js = step(js)
        st = psim.fleet_step(st, i=k)
        if k + 1 in (BREAKAWAY, 1000):
            ref = jax.tree.map(np.asarray, js)
            pick = (lambda tree: tree) if k + 1 == BREAKAWAY else land
            for name in ("t", "i", "x", "u", "s"):
                assert_tree_close({name: pick(getattr(st, name))},
                                  {name: pick(getattr(ref, name))}, TOL,
                                  f"step {k + 1}: ")
    phase = st.s["avionics"]["phase"]
    assert phase.tolist() == ref.s["avionics"]["phase"].tolist()
    eng = st.s["vehicle"]["systems"]["pwp"]["engine"]["state"]
    assert eng.tolist() == ref.s["vehicle"]["systems"]["pwp"]["engine"][
        "state"].tolist()
    assert phase[:8].tolist() == [M.FINAL] * 8
    assert bool((phase[8:] >= M.TAKEOFF).all())


# ------------------------------------------------------------ arbitrary phases

def _v1_mission(h_target):
    """The three phases of `tests/test_c172x2.py::test_mission_phase_machine`
    (climb, level, turn) over the C172Xv1's control laws, as arbitrary
    callables, in the port."""
    def eng_climb(u, y, t):
        lon = dict(u["lon"], mode_req=torch.full_like(u["lon"]["mode_req"],
                                                      TCTL.LON_EAS_CLM),
                   clm_ref=torch.full_like(u["lon"]["clm_ref"], 2.0),
                   EAS_ref=torch.full_like(u["lon"]["EAS_ref"], 45.0))
        return dict(u, lon=lon)

    def level(u):
        return dict(u["lon"], mode_req=torch.full_like(u["lon"]["mode_req"],
                                                       TCTL.LON_EAS_ALT),
                    h_ref=torch.full_like(u["lon"]["h_ref"], h_target))

    def eng_turn(u, y, t):
        lat = dict(u["lat"], mode_req=torch.full_like(u["lat"]["mode_req"],
                                                      TCTL.LAT_CHI_BETA),
                   chi_ref=torch.full_like(u["lat"]["chi_ref"], np.pi / 2))
        return dict(u, lon=level(u), lat=lat)

    return [Phase("climb", eng_climb,
                  lambda y, t: y.kinematics.h_e > h_target),
            Phase("level", lambda u, y, t: dict(u, lon=level(u)),
                  lambda y, t: (y.kinematics.h_e - h_target).abs() < 5.0),
            Phase("turn", eng_turn, lambda y, t: torch.tensor(False))]


def _jax_v1_mission(h_target):
    def eng_climb(u, y, t):
        lon = dict(u["lon"], mode_req=jnp.asarray(JCTL.LON_EAS_CLM,
                                                  jnp.int32),
                   clm_ref=jnp.asarray(2.0), EAS_ref=jnp.asarray(45.0))
        return dict(u, lon=lon)

    def level(u):
        return dict(u["lon"], mode_req=jnp.asarray(JCTL.LON_EAS_ALT,
                                                   jnp.int32),
                    h_ref=jnp.asarray(h_target))

    def eng_turn(u, y, t):
        lat = dict(u["lat"], mode_req=jnp.asarray(JCTL.LAT_CHI_BETA,
                                                  jnp.int32),
                   chi_ref=jnp.asarray(np.pi / 2))
        return dict(u, lon=level(u), lat=lat)

    return [JPhase("climb", eng_climb,
                   lambda y, t: y.kinematics.h_e > h_target),
            JPhase("level", lambda u, y, t: dict(u, lon=level(u)),
                   lambda y, t: jnp.abs(y.kinematics.h_e - h_target) < 5.0),
            JPhase("turn", eng_turn, lambda y, t: jnp.asarray(False))]


def _v1_state(phases, n=1):
    """The C172Xv1 trim with the mission over its control laws started
    bumpless, `n` aircraft, on the CPU in float64."""
    from flightjax_torch.parallel.fleet import broadcast_state
    from flightjax_torch.physics.aircraftbase import Aircraft, SimpleWorld
    build = lambda **kw: Aircraft(
        Tx.build_vehicle(**kw), MissionAvionics(
            TCTL.ControlLaws(device="cpu", dtype=F64), phases))
    st = Tx.trimmed_xv1_state(DT, F64, "cpu", build=build)
    sim = Simulation(SimpleWorld(build(device="cpu", dtype=F64)), dt=DT,
                     periodic_dt=DT)
    return sim, broadcast_state(st, n)


def test_arbitrary_phases_fly_the_plain_path_as_jax():
    """A phase machine of arbitrary callables over the C172Xv1's control
    laws (the JAX package's `test_mission_phase_machine`) flies the port's
    plain path (`Simulation.fleet_step` on the CPU) as JAX's fleet step
    does, 4 steps at 1e-9: with the target altitude just under the trim's,
    the climb ends at the first firing and the level at the second."""
    h0 = float(np.load(Tx.XV1_NPZ)["x/vehicle/kinematics/h_e"])
    h_target = h0 - 1.0
    sim, st = _v1_state(_v1_mission(h_target), n=2)
    from flightjax.models.c172 import c172x as Jx
    from flightjax.physics.aircraftbase import Aircraft as JAircraft
    from flightjax.physics.aircraftbase import SimpleWorld as JSimpleWorld
    jm = JMissionAvionics(JCTL.ControlLaws(), _jax_v1_mission(h_target))
    jworld = JSimpleWorld(JAircraft(Jx.build_xv1("wa").vehicle, avionics=jm))
    jsim = JSimulation(jworld, dt=DT, periodic_dt=DT)
    t, i, x, u, s = (tree_to_numpy(v) for v in st[:5])
    js = _jax_state(t, i, x, u, s, jm)
    step = jax.jit(jsim.fleet_step)
    phases = []
    for k in range(4):
        js = step(js)
        st = sim.fleet_step(st, i=k)
        ref = jax.tree.map(np.asarray, js)
        for name in ("t", "i", "x", "u", "s"):
            assert_tree_close({name: getattr(st, name)},
                              {name: getattr(ref, name)}, TOL, f"step {k}: ")
        phases.append(int(st.s["avionics"]["phase"][0]))
    assert phases == [1, 2, 2, 2]


@pytest.mark.slow
def test_arbitrary_phases_mission_reaches_the_turn():
    """The JAX package's `test_mission_phase_machine` on the port's plain
    path: 120 s of climb 50 m, level off, turn onto pi / 2 (about 10 min on
    the CPU); the turn phase reached, the height within 5 m of the target,
    the ground course within 0.1 rad."""
    h0 = float(np.load(Tx.XV1_NPZ)["x/vehicle/kinematics/h_e"])
    sim, st = _v1_state(_v1_mission(h0 + 50.0))
    final = fleet_rollout(sim, st, int(round(120.0 / DT)))
    assert int(final.s["avionics"]["phase"][0]) == 2
    vy = sim.system.aircraft.vehicle.output(final.x["vehicle"],
                                            final.u["vehicle"],
                                            final.s["vehicle"])
    assert abs(float(vy.kinematics.h_e[0]) - (h0 + 50.0)) < 5.0
    assert abs(float(vy.kinematics.chi_gnd[0]) - np.pi / 2) < 0.1


# ------------------------------------------------------------ refusals

def test_kernel_paths_refuse_what_they_do_not_carry():
    """A mission of arbitrary callables, and a mission over another inner
    avionics, fly the plain path but no kernel path: the megakernel and
    the kernels' layout refuse them and say why."""
    sim, st = _v1_state(_v1_mission(1000.0), n=2)
    with pytest.raises(NotImplementedError, match="c172x_gdc.Avionics"):
        make_megakernel_step(sim, st)
    with pytest.raises(NotImplementedError, match="c172x_gdc.Avionics"):
        K.avionics_layout(sim.system.aircraft.vehicle,
                          sim.system.aircraft.avionics)
    fleet_rollout(sim, st, 1)  # the plain path flies it
    # descriptor-less phases over the C172Xv2's avionics
    phases = M.traffic_pattern_phases()
    phases[3] = phases[3]._replace(done=lambda y, t: torch.tensor(False))
    world = M.mission_world(phases, device="cpu", dtype=F64)
    with pytest.raises(NotImplementedError, match="arbitrary callables"):
        K.avionics_layout(world.aircraft.vehicle, world.aircraft.avionics)
    with pytest.raises(NotImplementedError, match="arbitrary callables"):
        K.ctl_gains(world.aircraft.avionics)
    msim = Simulation(world, dt=DT, periodic_dt=DT)
    mst = msn_operand_state(24, SEED, "cpu", F64)
    with pytest.raises(NotImplementedError, match="arbitrary callables"):
        make_megakernel_step(msim, mst)
    out = msim.fleet_step(mst, i=0)  # the plain path flies it
    assert out.s["avionics"]["phase"].dtype == torch.int32


# ------------------------------------------------------------ row maps

def test_msn_layouts_match_csrc():
    """The mission's row maps and table (`csrc/c172x_msn.cuh`) against
    `parallel/kernels.py`, `models/c172/missions.py` and
    `parallel/launch.py`."""
    from flightjax_torch.parallel import launch as L
    from test_torch_support import _constexprs, _csrc, _enums
    env = _constexprs(_csrc("flight_math.cuh"), {})
    sys_src = _csrc("c172_systems.cuh")
    for members in _enums(sys_src).values():
        env.update({m: i for i, m in enumerate(members)})
    env = _constexprs(sys_src, env)
    for name in ("c172x_ctl.cuh", "c172x_gdc.cuh", "c172x_msn.cuh"):
        env = _constexprs(_csrc(name), env)
    for name, groups in (("N_MSNY", (K.MSN_Y,)), ("N_SMSN", (K.AV_S_MSN,)),
                         ("N_MUSYS", (K.MSN_USYS,)), ("MSN_N_IN", K.MSN_IN),
                         ("MSN_N_OUT", K.MSN_OUT),
                         ("MEGA_N_ROWS_MSN", K.MSN.mega),
                         ("MSN_AV", K.MSN_IN[:1]),
                         ("MSN_UGDC", K.MSN_IN[:5]),
                         ("MSN_SMSN", K.MSN_IN[:6]),
                         ("MSN_MUSYS", K.MSN_IN[:7])):
        assert env[name] == K.rows(groups), name
    assert env["CY_ENG"] == K.rows_of((K.MSN_Y,), "eng_state").start
    assert [env["SM_" + n] for n in ("PHASE", "T")] == [0, 1]
    for j, key in enumerate(k for k, _ in K.MSN_USYS):
        assert [env["MU_FLAPS"], env["MU_BRK_L"], env["MU_BRK_R"],
                env["MU_START"]][j] == j
        assert K.rows_of((K.U_SYS_FBW,), key).start in (4, 1, 2, 10)
    assert K.rows_of((K.U_SYS_FBW,), ("pwp", "engine", "start")).start == 10
    assert [env["PH_" + f] for f in ("APPLY", "LEG", "EAS", "THR_ON", "THR",
                                     "VRT", "DONE", "DONE_VAL", "DONE_LEG",
                                     "SYS", "FLAPS")] == list(range(
        len(K.PHASE_FIELDS)))
    assert env["PH_N"] == len(K.PHASE_FIELDS) and env["LEG_N"] == K.LEG_N
    assert [env["MT_N_PHASES"], env["MT_LEGS"], env["MT_PHASES"]] == [
        0, 1, len(K.MT_HEAD)]
    for prefix, names in (("MA_", ("HOLD", "LEG", "FLARE", "GROUND")),
                          ("MD_", ("NEVER", "CLOCK", "ENGINE", "AIRBORNE",
                                   "ON_GND", "CAPTURED", "FINAL")),
                          ("MS_", ("NONE", "FLAPS", "GROUND", "START"))):
        for n in names:
            assert env[prefix + n] == getattr(M, prefix + n), prefix + n
    src = _csrc("c172x_msn.cuh")
    doubles = {}
    for decl in re.findall(r"constexpr double ([^;]+);", src):
        for item in decl.split(","):
            name, expr = item.split("=")
            doubles[name.strip()] = float(expr)
    for c in ("CAPTURE_THRESHOLD", "FINAL_DH", "FLARE_CLM", "GROUND_RUDDER"):
        assert doubles[c] == getattr(M, c), c
    assert {"megakernel_msn", "msn_ctl_laws"} <= set(L.ROLE_KERNELS)
    assert K.MSN.mega_name == "megakernel_msn"
    assert K.MSN.pass_name == "msn_ctl_laws"
    # the table of the traffic pattern: ten phases, five legs
    av = M.mission_avionics(M.traffic_pattern_phases(), device="cpu",
                            dtype=F64)
    v = K.mission_table_values(av)
    assert v[0] == 10 and v[1] == 2 + 10 * len(K.PHASE_FIELDS)
    assert len(v) == v[1] + 5 * K.LEG_N
    g = K.ctl_gains(av)
    assert int(g[L.N_GAIN_TABLES]) + len(v) == g.numel()
    assert torch.equal(g[int(g[L.N_GAIN_TABLES]):], K.mission_table(av))
