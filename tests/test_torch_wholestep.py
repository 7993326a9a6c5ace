"""The whole-step entry points of flightjax_torch against flightjax, float64
on the CPU (the kernels' plain versions), on the perturbed flagship fleet of
`test_torch_support` (8 lanes, two on the runway, one terminated):

- `make_cluster_step(split="vehicle")` against `jax.jit(sim.fleet_step)`
  (the plain reference `tests/test_clusterstep.py` holds the JAX vehicle
  kernels to), uncompensated as the JAX vehicle path is, 3 steps from
  i = 126 so the geoid refresh at step 128 fires;
- `make_megakernel_step` (`step_packed` on CPU tensors) against
  `jax.jit(jax.vmap(Simulation.step))` with the geoid refreshed on every
  step and no gear gate, what the JAX megakernel computes, with and without
  forced compensation, 3 steps;
- the plain `rk4_stage` / `rk4_finish` against the JAX lane functions
  `stage_lane` / `finish_lane` (`flightjax/parallel/clusterstep.py:81-108`)
  on the same inputs, and the plain `geoid` against
  `flightjax.ops.geodesy.geoid_height`;
- the megakernel's resident buffers round-tripped through pack / unpack,
  and the whole-vehicle row counts of `csrc/` against the column maps.

Every leaf agrees within 1e-9 relative to max(1, |reference|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.sim import SimState as JSimState
from flightjax.core.sim import Simulation as JSimulation
from flightjax.core.sim import comp_residuals as jcomp_residuals
from flightjax.models.c172 import c172s as Jc
from flightjax.ops import geodesy as jgeo
from flightjax.physics.aircraftbase import geoid_deferred

from flightjax_torch.core.modeling import tree_leaves_with_path
from flightjax_torch.core.sim import SimState, comp_residuals
from flightjax_torch.models.c172 import c172s as Tc
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel import launch as L
from flightjax_torch.parallel.clusterstep import make_cluster_step
from flightjax_torch.parallel.megakernel import MEGA_GROUPS, make_megakernel_step
from flightjax_torch.testing import cluster_operands

from test_torch_support import (B, CONTACT_LANES, F64, SEED, TERMINATED_LANE,
                                _constexprs, _csrc, _enums, assert_tree_close,
                                perturbed_fleet, to_jax, to_torch)
from test_torch_slice import _jax_c_as_tree

TOL = 1e-9
I0 = 126
STEPS = 3
DT = 0.02
ADT = 0.5 * DT


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX flagship world and its jitted references: the fleet step
    (geoid every 128 steps, gear gate at 10 m), the vmapped
    `Simulation.step` (geoid every step, no gear gate), and the two lane
    functions of the JAX vehicle kernels."""
    world = Jc.flagship_world("wa")
    fleet = JSimulation(world, dt=DT, periodic_dt=DT, geoid_every=128,
                        gear_gate_margin=10.0)
    step = JSimulation(world, dt=DT, periodic_dt=DT, geoid_every=1)

    def stage_lane(x, k_prev, u, s, t, adt):
        xi = jax.tree.map(lambda xv, kv: xv + adt * kv, x, k_prev)
        return world.f_ode(xi, u, s, t)[0]

    def finish_lane(x, ksum, u, s, t_new):
        x_new = jax.tree.map(lambda xv, kv: xv + (DT / 6.0) * kv, x, ksum)
        with geoid_deferred():
            return world.f_step(x_new, u, s, t_new)

    return {"fleet_step": jax.jit(fleet.fleet_step),
            "step": jax.jit(jax.vmap(lambda st: step.step(st, ()))),
            "stage": jax.jit(jax.vmap(stage_lane)),
            "finish": jax.jit(jax.vmap(finish_lane))}


def _states(i0):
    """The same perturbed fleet as a JAX and as a torch SimState."""
    t, i, x, u, s = perturbed_fleet(i0)
    ref = JSimState(t=jnp.asarray(t), i=jnp.asarray(i), x=to_jax(x),
                    u=to_jax(u), s=to_jax(s))
    got = SimState(t=torch.tensor(t), i=torch.tensor(i), x=to_torch(x),
                   u=to_torch(u), s=to_torch(s))
    return ref, got


def _assert_states_close(got, ref):
    ref = jax.tree.map(np.asarray, ref)
    for name in ("t", "i", "x", "u", "s"):
        assert_tree_close({name: getattr(got, name)},
                          {name: getattr(ref, name)}, TOL)


def test_vehicle_step_matches_jax_fleet_step(jax_ref):
    ref, got = _states(I0)
    sim, _, _ = Tc.flagship_sim("cpu", F64)
    step = make_cluster_step(sim, got, split="vehicle")
    N0 = got.s["vehicle"]["geoid_N"].clone()
    K.reset_launches()
    for k in range(STEPS):
        ref = jax_ref["fleet_step"](ref)
        got = step(got, i=I0 + k)
    assert not any(K.LAUNCHES.values())
    assert got.c is None and ref.c is None
    _assert_states_close(got, ref)
    # the refresh at step 128 moved the undulation; the terminated lane
    # stayed where it was
    assert not torch.equal(got.s["vehicle"]["geoid_N"], N0)
    assert torch.equal(got.s["terminated"],
                       torch.arange(B) == TERMINATED_LANE)


@pytest.mark.parametrize("force_comp", [False, True],
                         ids=["uncompensated", "compensated"])
def test_megakernel_step_matches_jax_step(jax_ref, force_comp):
    ref, got = _states(0)
    if force_comp:
        ref = ref._replace(c=jcomp_residuals(ref.x, force=True))
        got = got._replace(c=comp_residuals(got.x, force=True))
    sim, _, _ = Tc.flagship_sim("cpu", F64)
    bufs, step_packed, unpack = make_megakernel_step(sim, got)
    K.reset_launches()
    for _ in range(STEPS):
        ref = jax_ref["step"](ref)
        bufs = step_packed(bufs)
    assert not any(K.LAUNCHES.values())
    got = unpack(bufs)
    ref = jax.tree.map(np.asarray, ref)
    _assert_states_close(got, ref)
    if force_comp:
        assert_tree_close(got.c, _jax_c_as_tree(ref.x, ref.c), TOL, "c/")
    else:
        assert got.c is None and ref.c is None


def _lane_operands():
    """numpy operands of the vehicle kernels and the world-level trees the
    JAX lane functions take."""
    d = cluster_operands(B, SEED, CONTACT_LANES, (TERMINATED_LANE,))
    x = {"vehicle": {"kinematics": d["x_kin"], "dynamics": d["x_dyn"],
                     "systems": d["x_sys"]}}
    k = {"vehicle": {"kinematics": d["k_kin"], "dynamics": d["k_dyn"],
                     "systems": d["k_sys"]}}
    ksum = {"vehicle": {"kinematics": d["ksum_kin"],
                        "dynamics": d["ksum_dyn"], "systems": d["ksum_sys"]}}
    u = {"vehicle": {"systems": d["u_sys"], "atm": d["u_atm"],
                     "trn": d["u_trn"]}}
    s = {"vehicle": {"systems": d["s_sys"], "geoid_N": d["geoid_N"]},
         "terminated": d["term"] > 0.5}
    return d, x, k, ksum, u, s


def test_rk4_stage_matches_jax_stage_lane(jax_ref):
    d, x, k, _, u, s = _lane_operands()
    vehicle = Tc.build_vehicle(device="cpu", dtype=F64)
    tv = lambda tree: to_torch(tree)["vehicle"]
    got = K.rk4_stage(vehicle, tv(x), tv(k), tv(u), tv(s),
                      torch.as_tensor(d["term"]), ADT)
    ref = jax_ref["stage"](to_jax(x), to_jax(k), to_jax(u), to_jax(s),
                           jnp.zeros(B), jnp.full(B, ADT))
    assert_tree_close(got, jax.tree.map(np.asarray, ref["vehicle"]), TOL)


def test_rk4_finish_matches_jax_finish_lane(jax_ref):
    _, x, _, ksum, u, s = _lane_operands()
    vehicle = Tc.build_vehicle(device="cpu", dtype=F64)
    tv = lambda tree: to_torch(tree)["vehicle"]
    xv, s_sys, term, c_kin = K.rk4_finish(
        vehicle, tv(x), tv(ksum), tv(u), tv(s),
        torch.as_tensor(s["terminated"]), DT)
    x2, s2 = jax_ref["finish"](to_jax(x), to_jax(ksum), to_jax(u),
                               to_jax(s), jnp.full(B, DT))
    x2, s2 = jax.tree.map(np.asarray, (x2, s2))
    assert c_kin is None
    assert_tree_close({"x": xv, "s": s_sys, "terminated": term},
                      {"x": x2["vehicle"], "s": s2["vehicle"]["systems"],
                       "terminated": s2["terminated"]}, TOL)
    # f_step leaves the carried undulation alone on this path
    np.testing.assert_array_equal(s2["vehicle"]["geoid_N"],
                                  s["vehicle"]["geoid_N"])


def test_geoid_matches_jax_geoid_height():
    rng = np.random.default_rng(SEED)
    q = rng.normal(size=(256, 4))
    # the poles and both sides of the date line and of lon = 0
    q[:6] = [[1, 0, 0, 0], [0, 1, 0, 0], [0.5, 0.5, 0.5, 0.5],
             [0.5, -0.5, 0.5, -0.5], [0.7, 0.1, 0.7, 1e-9],
             [0.7, 0.1, 0.7, -1e-9]]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    vehicle = Tc.build_vehicle(device="cpu", dtype=F64)
    got = K.geoid(vehicle.geoid, torch.as_tensor(q))
    ref = jgeo.geoid_height(jgeo.nvector_from_qew(jnp.asarray(q)))
    assert_tree_close({"N": got}, {"N": np.asarray(ref)}, TOL)


def _exactly_equal(a, b):
    pa, pb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, va), (_, vb) in zip(pa, pb):
        assert va.dtype == vb.dtype and torch.equal(va, vb), p


@pytest.mark.parametrize("comp", [False, True],
                         ids=["uncompensated", "compensated"])
def test_megakernel_buffers_roundtrip(comp):
    _, st = _states(I0)
    if comp:
        st = st._replace(c=comp_residuals(st.x, force=True))
    sim, _, _ = Tc.flagship_sim("cpu", F64)
    bufs, _, unpack = make_megakernel_step(sim, st)
    assert bufs[0].shape == (K.rows(MEGA_GROUPS), B)
    assert bufs[1].dtype == torch.int32 and bufs[1].shape == (1, B)
    back = unpack(bufs)
    _exactly_equal(tuple(back), tuple(st))
    again, _, _ = make_megakernel_step(sim, back)
    assert torch.equal(again[0], bufs[0]) and torch.equal(again[1], bufs[1])


def test_vehicle_layouts_match_csrc():
    """The row counts of the whole-vehicle kernels and of the megakernel's
    state buffer (`csrc/c172_systems.cuh`, `csrc/flight_math.cuh`) against
    the column maps of `parallel/kernels.py`."""
    env = _constexprs(_csrc("flight_math.cuh"), {})
    src = _csrc("c172_systems.cuh")
    for members in _enums(src).values():
        env.update({m: i for i, m in enumerate(members)})
    env = _constexprs(src, env)
    for name, groups in (("N_X", K.X_GROUPS), ("N_CTX", K.CTX_GROUPS),
                         ("N_C", (K.COMP,)),
                         ("STAGE_N_IN", K.STAGE_IN),
                         ("STAGE_N_OUT", K.STAGE_OUT),
                         ("RKFIN_N_IN", K.RKFIN_IN),
                         ("RKFIN_N_OUT", K.RKFIN_OUT),
                         ("GEOID_N_IN", K.GEOID_IN),
                         ("GEOID_N_OUT", K.GEOID_OUT),
                         ("MEGA_N_ROWS", MEGA_GROUPS)):
        assert env[name] == K.rows(groups), name
    assert env["GEO_HEAD"] == L.GEO_HEAD
    # the offsets the kernels read the context at
    ctx = K.CTX_GROUPS
    for name, key in (("CX_UATM", "T_sl"), ("CX_TRN", "elevation"),
                      ("CX_SSYS", ("aero", "stall")),
                      ("CX_GEOID", "geoid_N"), ("CX_TERM", "terminated")):
        assert env[name] == K.rows_of(ctx, key).start, name
    assert env["MG_X"] == 1 and env["MG_CTX"] == 1 + env["N_X"]


def test_system_params_holds_tables_to_the_kernels_ranks(monkeypatch):
    """The kernels' lookups know each table's number of axes at compile
    time; `system_params` refuses a model whose table has another."""
    from flightjax_torch.models.c172.c172s import build_vehicle
    vehicle = build_vehicle(device="cpu", dtype=torch.float64)
    tables = K.param_tables(vehicle)
    assert {k: len(lk.axes) for k, lk in tables.items()} == K.TABLE_RANKS
    monkeypatch.setitem(K.TABLE_RANKS, "CL_alpha", 1)
    with pytest.raises(ValueError, match="CL_alpha"):
        K.system_params(build_vehicle(device="cpu", dtype=torch.float64))
