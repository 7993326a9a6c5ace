"""The C172Xv1 with second-order servos (`Actuator2`) of flightjax_torch
against flightjax, float64 on the CPU (the kernels' plain versions), on
inputs drawn with numpy from a seed and handed to both packages:

- the elevator swapped for an `Actuator2` (the vehicle of the JAX
  package's `tests/test_actuators.py:95`): the turning-climb fleet of
  `tests/test_torch_c172x.py` with each lane's elevator rate drawn, a lane
  whose position starts past its range on either side, a lane in the
  direct mode whose elevator command saturates, a SAS lane, through
  `Simulation.fleet_step`, `make_cluster_step(split="vehicle")` (the plain
  `rk4_stage_fbw_a2`, `rk4_finish_fbw_a2` and the `ctl_laws` pass) and
  `make_megakernel_step` (the plain version of `megakernel_fbw_a2`);
- all seven channels second-order through `make_megakernel_step`'s plain
  version, whose rows move every servo offset;

5 steps each against `jax.jit(sim.fleet_step)` of
`Jx.build_xv1("wa", actuators=...)` at `geoid_every=1`, every leaf to
1e-9. One JAX compile per world, each in a module-scoped fixture; the
seven-channel world's (~30 s on a CPU) is marked slow, and the same
packed step is held without JAX to the port's `Simulation.fleet_step`,
which packs nothing and is held to JAX through the elevator's world.
"""

import jax
import numpy as np
import pytest
import torch

from flightjax.core.sim import Simulation as JSimulation
from flightjax.models.c172 import c172x as Jx
from flightjax.physics.aircraftbase import SimpleWorld as JSimpleWorld

from flightjax_torch.core.sim import SimState, Simulation
from flightjax_torch.models.c172 import c172x as Tx
from flightjax_torch.models.c172 import c172x_ctl as TCTL
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import make_cluster_step
from flightjax_torch.parallel.megakernel import make_megakernel_step
from flightjax_torch.physics.aircraftbase import SimpleWorld
from flightjax_torch.testing import perturbed_xv1

from test_torch_c172x import _jax_state
from test_torch_support import F64, assert_tree_close, to_torch

TOL = 1e-9
DT = 0.02
SEED = 20261019
STEPS = 5
B = 8
SAS_LANE, SAT_LANE, OVER_LANE, UNDER_LANE = 4, 5, 6, 7
PATHS = ["fleet", "vehicle", "megakernel"]
ALL_SEVEN = Tx.ACT_CHANNELS


def _fleet(channels):
    """numpy (t, i, x, u, s) of B C172Xv1 lanes with second-order servos on
    `channels`, each at rest in the trim start but for a rate drawn from
    N(0, 3) per lane: the turning climb, SAS_LANE in the SAS modes,
    SAT_LANE in the direct modes with its elevator axis and command past
    the range (its command saturates at every firing), OVER_LANE and
    UNDER_LANE with their positions past the range, moving outward."""
    t, i, x, u, s = perturbed_xv1(B, SEED, sas_lanes=(SAS_LANE,))
    rng = np.random.default_rng(SEED + 1)
    act = x["vehicle"]["systems"]["act"]
    for ch in channels:
        act[ch] = {"p": act[ch], "v": rng.normal(0.0, 3.0, B)}
    elv = act["elevator"]
    elv["p"][[OVER_LANE, UNDER_LANE]] = [1.06, -1.07]
    elv["v"][[OVER_LANE, UNDER_LANE]] = [4.0, -5.0]
    lon = u["avionics"]["lon"]
    lon["mode_req"][SAT_LANE] = TCTL.LON_DIRECT
    u["avionics"]["lat"]["mode_req"][SAT_LANE] = TCTL.LAT_DIRECT
    lon["elevator_axis"][SAT_LANE] = 1.3
    u["vehicle"]["systems"]["act"]["elevator"][SAT_LANE] = 1.2
    return t, i, x, u, s


def _jax_steps(channels):
    """The JAX fleet step of the C172Xv1 with `Actuator2` on `channels`,
    the geoid refreshed after every step, STEPS times from `_fleet`."""
    aircraft = Jx.build_xv1("wa", actuators={ch: Jx.Actuator2()
                                             for ch in channels})
    sim = JSimulation(JSimpleWorld(aircraft), dt=DT, periodic_dt=DT,
                      geoid_every=1)
    step = jax.jit(sim.fleet_step)
    st = _jax_state(*_fleet(channels), aircraft)
    out = []
    for _ in range(STEPS):
        st = step(st)
        out.append(jax.tree.map(np.asarray, st))
    return out


def _sim(channels):
    return Simulation(SimpleWorld(Tx.build_xv1(
        device="cpu", dtype=F64,
        actuators={ch: Tx.Actuator2() for ch in channels})), dt=DT,
        periodic_dt=DT, geoid_every=1)


def _run(sim, tree, path, ref):
    """STEPS steps of the port's `path` from the numpy `tree`, each held to
    the JAX step `ref[k]`; returns the states."""
    t, i, x, u, s = tree
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    if path == "megakernel":
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
    step = (make_cluster_step(sim, st, split="vehicle") if path == "vehicle"
            else sim.fleet_step)
    K.reset_launches()
    out = []
    for k in range(STEPS):
        if path == "megakernel":
            bufs = step_packed(bufs)
            st = unpack(bufs)
        else:
            st = step(st, i=k)
        for name in ("t", "i", "x", "u", "s"):
            assert_tree_close({name: getattr(st, name)},
                              {name: getattr(ref[k], name)}, TOL,
                              f"{path} step {k}: ")
        out.append(st)
    assert not any(K.LAUNCHES.values())
    return out


@pytest.fixture(scope="module")
def elevator_steps():
    return _jax_steps(("elevator",))


@pytest.mark.parametrize("path", PATHS)
def test_second_order_elevator_matches_jax(elevator_steps, path):
    """The C172Xv1 with a second-order elevator through each entry point
    against the JAX fleet step, every leaf (the elevator's p and v, the
    commands, the avionics) after each of STEPS steps to 1e-9: the servo
    moves on every lane, the direct lane's command stays saturated and
    its position overshoots past the range, the autopilot's elevator
    commands change inside the window."""
    sim = _sim(("elevator",))
    lay = K.avionics_layout(sim.system.aircraft.vehicle,
                            sim.system.aircraft.avionics)
    assert lay is K.FBW_A2 and lay.mega_name == "megakernel_fbw_a2"
    tree = _fleet(("elevator",))
    out = _run(sim, tree, path, elevator_steps)
    p0 = tree[2]["vehicle"]["systems"]["act"]["elevator"]["p"]
    assert p0[OVER_LANE] > 1.0 and p0[UNDER_LANE] < -1.0
    elv = [st.x["vehicle"]["systems"]["act"]["elevator"] for st in out]
    assert all(bool((e["v"] != 0).all()) for e in elv)
    cmd = [st.u["vehicle"]["systems"]["act"]["elevator"] for st in out]
    assert all(float(c[SAT_LANE]) == 1.0 for c in cmd)
    # underdamped, the servo overshoots the saturated command past its
    # range; the state is not clipped
    assert max(float(e["p"][SAT_LANE]) for e in elv) > 1.0
    # the turning climb moves the command of a lane it does not saturate
    assert len(set(float(c[UNDER_LANE]) for c in cmd)) == STEPS
    lon = out[-1].s["avionics"]["lon"]["mode_prev"].tolist()
    assert lon[SAT_LANE] == TCTL.LON_DIRECT and lon[SAS_LANE] == TCTL.LON_SAS
    assert lon[0] == TCTL.LON_EAS_CLM


@pytest.fixture(scope="module")
def seven_steps():
    return _jax_steps(ALL_SEVEN)


@pytest.mark.slow
def test_seven_second_order_servos_megakernel_matches_jax(seven_steps):
    """All seven channels second-order through `make_megakernel_step`'s
    plain version against the JAX fleet step, every leaf to 1e-9 over
    STEPS steps: each channel's two rows sit where the row derivation puts
    them, which moves every later row of X, CTX, C and the avionics."""
    sim = _sim(ALL_SEVEN)
    lay = K.layout_of(sim.system.aircraft.vehicle)
    assert lay.a2 == K.FBW_CHANNELS
    assert K.rows(lay.mega) == K.rows(K.FBW.mega) + len(ALL_SEVEN)
    out = _run(sim, _fleet(ALL_SEVEN), "megakernel", seven_steps)
    act = out[-1].x["vehicle"]["systems"]["act"]
    assert set(act) == set(ALL_SEVEN) and all(
        bool((act[ch]["v"] != 0).any()) for ch in ALL_SEVEN)


def test_seven_second_order_servos_megakernel_matches_fleet_step():
    """All seven channels second-order through `make_megakernel_step`'s
    plain version against the port's `Simulation.fleet_step` on the same
    lanes, every leaf to 1e-9 over STEPS steps: the per-operation step
    packs nothing, so the packed step's rows, wherever the row derivation
    puts them, must carry each servo's p and v and every later group as
    it does."""
    sim = _sim(ALL_SEVEN)
    tree = _fleet(ALL_SEVEN)
    t, i, x, u, s = tree
    st = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                  u=to_torch(u), s=to_torch(s))
    ref = []
    for k in range(STEPS):
        st = sim.fleet_step(st, i=k)
        ref.append(st)
    out = _run(sim, tree, "megakernel", ref)
    act = out[-1].x["vehicle"]["systems"]["act"]
    assert set(act) == set(ALL_SEVEN) and all(
        bool((act[ch]["v"] != 0).any()) for ch in ALL_SEVEN)
