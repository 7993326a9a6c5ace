"""The C172 system clusters of flightjax_torch against the JAX package's
`Systems.f_ode_parts`, `f_ode_gear_legs` and `f_step_parts`
(`models/c172/common.py:478-584`), part by part and composed as the
`systems` / `finish_sys` kernel clusters (`k2_lane` / `k5_lane` of
`flightjax/parallel/clusterstep.py`, in its fine split), vmapped and
jitted once; and the stored flagship trim point against the JAX trim
assignment. float64 on the CPU, tolerance 1e-12 relative to
max(1, |reference|). The inputs (`flightjax_torch.testing.
cluster_operands`) put lanes through every engine state, the stall latch,
manual mixture, all three runway surfaces, ground contact and a
terminated lane; the finish is also held to `k5_lane` on the same fleet
with CRASH_LANE sinking onto the runway, so that the crash latch switches
on during the step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.models.c172 import c172s as Jc
from flightjax.models.c172 import common as JC

from flightjax_torch.models.c172 import c172s as Tc
from flightjax_torch.parallel import kernels as K
from flightjax_torch.physics.atmosphere import AirData
from flightjax_torch.physics.dynamics import Wrench
from flightjax_torch.physics.kinematics import KinData
from flightjax_torch.testing import cluster_operands

from test_torch_kernels import ADT, DT, alive_scale, fma, k1_lane
from test_torch_support import (B, CONTACT_LANES, F64, SEED,
                                TERMINATED_LANE, assert_close,
                                assert_tree_close, to_torch)

TOL = 1e-12
# the lane of the crash case (icy runway, stalled) that crashes in the step
CRASH_LANE = 7


@pytest.fixture(scope="module")
def jax_vehicle():
    return Jc.flagship_world("wa").aircraft.vehicle


@pytest.fixture(scope="module")
def case(jax_vehicle):
    """Inputs at the perturbed flagship (KinData / AirData from the JAX
    k1 lane) and every JAX system part's outputs, from one jit."""
    d = cluster_operands(B, SEED, CONTACT_LANES, (TERMINATED_LANE,))
    sys_c, trn_c = jax_vehicle.systems, jax_vehicle.terrain
    actaero_p, _, pwp_p = sys_c.f_ode_parts()
    leg_fns = sys_c.f_ode_gear_legs()
    pre_p, fleg_fns, rest_p = sys_c.f_step_parts()

    def ode_parts(xs, us, ss, t, kin, air, trn_fn):
        _, aero_dot, gear_u, thr_mix, wr_aero = actaero_p(
            {}, xs["aero"], us["act"], ss["aero"], t, kin, air, trn_fn)
        legs = [leg_fns[i](xs["ldg"]["frc"][i], gear_u["steering"][i],
                           gear_u["braking"][i], t, kin, trn_fn)
                for i in range(3)]
        wr_ldg = legs[0][1]
        for leg in legs[1:]:
            wr_ldg = jax.tree.map(jnp.add, wr_ldg, leg[1])
        pwp = pwp_p(xs["pwp"], xs["fuel"], us["pwp"], ss["pwp"], thr_mix,
                    us["pld"], t, kin, air, wr_aero, wr_ldg)
        return (aero_dot, gear_u, thr_mix, wr_aero), legs, wr_ldg, pwp

    def step_parts(xs, us, ss, t, kin, air, trn_fn):
        gear_u = pre_p({}, us["act"], t)
        flegs = [fleg_fns[i](gear_u["steering"][i], gear_u["braking"][i],
                             kin, trn_fn) for i in range(3)]
        wow, ats, xid = (jnp.stack([o[j] for o in flegs]) for j in range(3))
        return gear_u, flegs, rest_p(xs, us["pwp"], ss, t, kin, air, wow,
                                     ats, xid)

    def parts(j):
        t = j["t"]
        zk = jax.tree.map(jnp.zeros_like, (j["k_kin"], j["k_dyn"]))
        _, kin, air, _ = k1_lane(j["x_kin"], j["x_dyn"], *zk, j["geoid_N"],
                                 j["u_atm"], t, 0.0 * t, 0.0 * t)
        xs, us, ss = j["x_sys"], j["u_sys"], j["s_sys"]
        trn_fn = lambda n_e=None: trn_c.terrain_data(j["u_trn"], n_e)
        actaero, legs, wr_ldg, pwp = ode_parts(xs, us, ss, t, kin, air,
                                               trn_fn)
        fin_act, fin_legs, fin_rest = step_parts(xs, us, ss, t, kin, air,
                                                 trn_fn)
        # k2_lane: stage FMA, the parts, derivative x alive
        xi = fma(xs, j["k_sys"], 0.0 * t + ADT)
        (a_dot, _, _, _), s_legs, _, s_pwp = ode_parts(xi, us, ss, t, kin,
                                                       air, trn_fn)
        sys_dot = alive_scale({"aero": a_dot, "ldg": {"frc": jnp.stack(
            [leg[0] for leg in s_legs])}, "pwp": s_pwp[0],
            "fuel": s_pwp[1]}, j["term"])
        # k5_lane: RK4 combine, then the step parts
        x2 = jax.tree.map(lambda a, b: a + (DT / 6.0) * b, xs, j["ksum_sys"])
        return dict(kin=kin, air=air, actaero=actaero, legs=legs,
                    wr_ldg=wr_ldg, pwp=pwp, fin_act=fin_act,
                    fin_legs=fin_legs, fin_rest=fin_rest,
                    systems=(sys_dot, *s_pwp[2:]),
                    finish_sys=step_parts(x2, us, ss, t, kin, air,
                                          trn_fn)[2])

    jparts = jax.jit(jax.vmap(parts))
    veh = Tc.build_vehicle(device="cpu", dtype=F64)

    def inputs(d):
        ref = jax.tree.map(np.asarray, jparts(jax.tree.map(jnp.asarray, d)))
        T = to_torch({k: d[k] for k in ("x_sys", "k_sys", "ksum_sys",
                                        "u_sys", "s_sys", "u_trn", "term")})
        kin = KinData(*to_torch(tuple(ref["kin"])))
        air = AirData(*to_torch(tuple(ref["air"])))
        return dict(ref=ref, T=T, kin=kin, air=air, veh=veh, d=d)

    # the crash fleet has the same shapes, so the same executable serves it
    crash = cluster_operands(B, SEED, CONTACT_LANES, (TERMINATED_LANE,),
                             (CRASH_LANE,))
    return dict(inputs(d), crash=inputs(crash))


def _sys(case):
    veh, T = case["veh"], case["T"]
    return (veh.systems, veh.terrain.terrain_data(T["u_trn"]), T["x_sys"],
            T["u_sys"], T["s_sys"])


def test_actaero(case):
    sys_, trn, xs, us, ss = _sys(case)
    got = sys_.actaero(xs["aero"], us["act"], ss["aero"], case["kin"],
                       case["air"], trn)
    ref = case["ref"]["actaero"]
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_tree_close(a, b, TOL, f"actaero[{k}]/")


@pytest.mark.parametrize("leg", [0, 1, 2])
def test_gear_leg(case, leg):
    sys_, trn, xs, us, ss = _sys(case)
    gear_u = sys_.actaero(xs["aero"], us["act"], ss["aero"], case["kin"],
                          case["air"], trn)[1]
    frc_dot, wr = sys_.ldg_leg(leg, xs["ldg"]["frc"][:, leg],
                               gear_u["steering"][:, leg],
                               gear_u["braking"][:, leg], case["kin"], trn)
    ref_dot, ref_wr = case["ref"]["legs"][leg]
    assert_close(frc_dot, ref_dot, TOL, f"leg{leg}/frc_dot")
    assert_tree_close(wr, ref_wr, TOL, f"leg{leg}/wr/")


def test_pwp_mass(case):
    sys_, trn, xs, us, ss = _sys(case)
    _, _, thr_mix, wr_aero = sys_.actaero(xs["aero"], us["act"], ss["aero"],
                                          case["kin"], case["air"], trn)
    wr_ldg = to_torch(tuple(case["ref"]["wr_ldg"]))
    got = sys_.pwp_mass(xs["pwp"], xs["fuel"], us["pwp"], ss["pwp"], thr_mix,
                        us["pld"], case["kin"], case["air"], wr_aero,
                        Wrench(*wr_ldg))
    names = ("pwp_dot", "fuel_dot", "mp_b", "wr_b", "hr_b")
    for name, a, b in zip(names, got, case["ref"]["pwp"]):
        if isinstance(b, np.ndarray):
            assert_close(a, b, TOL, name)
        else:
            assert_tree_close(a, b, TOL, name + "/")


def test_fin_act(case):
    sys_, trn, xs, us, ss = _sys(case)
    assert_tree_close(sys_.fin_act(us["act"]), case["ref"]["fin_act"], TOL)


@pytest.mark.parametrize("leg", [0, 1, 2])
def test_fin_ldg_leg(case, leg):
    sys_, trn, xs, us, ss = _sys(case)
    steer = sys_.fin_act(us["act"])["steering"][:, leg]
    got = sys_.fin_ldg_leg(leg, steer, case["kin"], trn)
    for name, a, b in zip(("wow", "alpha_ts", "xi_dot"), got,
                          case["ref"]["fin_legs"][leg]):
        assert_close(a, b, TOL, f"leg{leg}/{name}")
    if leg < 2:  # main gear: the lowered lanes have weight on wheels
        assert bool(torch.all(got[0][list(CONTACT_LANES)] == 1.0))
        assert bool(torch.all(torch.cat([got[0][:2], got[0][3:5]]) == 0.0))


def test_fin_rest(case):
    sys_, trn, xs, us, ss = _sys(case)
    legs = [sys_.fin_ldg_leg(j, sys_.fin_act(us["act"])["steering"][:, j],
                             case["kin"], trn) for j in range(3)]
    wow, ats, xid = (torch.stack([leg[j] for leg in legs], dim=1)
                     for j in range(3))
    x2, s2 = sys_.fin_rest(xs, us["pwp"], ss, case["air"], wow, ats, xid)
    rx, rs = case["ref"]["fin_rest"]
    assert_tree_close(x2, rx, TOL, "x/")
    assert_tree_close(s2, rs, TOL, "s/")


def test_systems_plain_matches_k2_lane(case):
    T = case["T"]
    got = K.systems_plain(case["veh"], T["x_sys"], T["k_sys"], T["u_sys"],
                          T["s_sys"], T["u_trn"], case["kin"], case["air"],
                          ADT, T["term"])
    ref = case["ref"]["systems"]
    for name, a, b in zip(("sys_dot", "mp_b", "wr_b", "hr_b"), got, ref):
        assert_tree_close(a, b, TOL, name + "/")
    assert float(got[0]["pwp"]["engine"]["omega"][TERMINATED_LANE]) == 0.0


@pytest.mark.parametrize("fleet", ["contact", "crash"])
def test_finish_sys_plain_matches_k5_lane(case, fleet):
    if fleet == "crash":
        case = case["crash"]
    T = case["T"]
    x2, s2, _ = K.finish_sys_plain(case["veh"], T["x_sys"], T["ksum_sys"],
                                T["u_sys"], T["s_sys"], T["u_trn"],
                                case["kin"], case["air"], DT)
    rx, rs = case["ref"]["finish_sys"]
    assert_tree_close(x2, rx, TOL, "x/")
    assert_tree_close(s2, rs, TOL, "s/")
    # every engine transition is taken: off -> starting, starting ->
    # running, starting held, running -> off (stop), starting -> off
    state = s2["pwp"]["engine"]["state"]
    assert state[[0, 1, 2, 3, 5]].tolist() == [1, 2, 1, 0, 0]
    crashed = s2["crashed"]
    if fleet == "contact":  # no lane crashes
        assert not bool(crashed.any())
        return
    # the crash lane, not crashed on entry, latches crashed (as in JAX) and
    # no other lane does; the whole finish latches it terminated too
    assert not bool(T["s_sys"]["crashed"].any())
    assert crashed.nonzero().flatten().tolist() == [CRASH_LANE]
    args = K.operand_args(case["d"], case["veh"], "cpu", F64)["rk4_finish"]
    terminated = args[5]
    assert not bool(terminated[CRASH_LANE])
    _, s3, term3, *_ = K.finish_clusters(K.PLAIN, *args)
    assert bool(s3["crashed"][CRASH_LANE])
    assert term3.tolist() == (terminated | s3["crashed"]).tolist()
    assert term3.nonzero().flatten().tolist() == [TERMINATED_LANE,
                                                  CRASH_LANE]


def test_flagship_npz_is_the_jax_trim_assignment(jax_vehicle):
    """The stored state is exactly `trim_assign` at the stored TrimState,
    and that TrimState is a trim point (residual at the solver's level)."""
    x_np, u_np, s_np, ts, rnorm = Tc.load_flagship_state()
    tp = JC.trim_parameters()
    jts = JC.TrimState(*[jnp.asarray(v) for v in ts])
    x, u, s = Jc.trim_assign(jax_vehicle, tp, jts)
    ref = {"x": {"vehicle": x}, "u": {"vehicle": u},
           "s": {"vehicle": s, "terminated": np.asarray(False)}}
    got = {"x": x_np, "u": u_np, "s": s_np}
    r_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    g_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in r_leaves] == [p for p, _ in g_leaves]
    for (p, a), (_, b) in zip(g_leaves, r_leaves):
        b = np.asarray(b)
        assert a.dtype == (np.float64 if b.dtype.kind == "f" else b.dtype), p
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    res = jax.jit(lambda v: Jc.trim_residual(jax_vehicle, tp, v))(
        jnp.asarray(ts))
    assert float(jnp.linalg.norm(res)) <= max(10.0 * rnorm, 1e-13)
    assert rnorm < 1e-12


def test_port_flagship_state_is_the_npz():
    sim, st, ctx = Tc.flagship_sim("cpu", F64)
    x_np, u_np, s_np, _, _ = Tc.load_flagship_state()
    assert_tree_close(st.x, x_np, 0.0, "x/")
    assert_tree_close(st.u, u_np, 0.0, "u/")
    assert_tree_close(st.s, s_np, 0.0, "s/")
    assert st.c is None and ctx == ()
    assert sim.dt == 0.02 and sim.geoid_every == 128
    sim32, st32, _ = Tc.flagship_sim("cpu", torch.float32)
    assert set(st32.c["vehicle"]["kinematics"]) == {"q_ew", "h_e"}
