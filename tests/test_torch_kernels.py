"""The vehicle-generic kernel clusters of flightjax_torch: each plain
PyTorch version against the JAX lane function it replaces, rebuilt here from
the JAX package's public components exactly as `flightjax/parallel/
clusterstep.py` builds `k1_lane` (:250-256), `k3_lane` (:403-407) and
`k4_lane` (:433-442), vmapped and jitted once (no Pallas). float64 on the
CPU, tolerance 1e-12 relative to max(1, |reference|). The C172 systems
clusters are held against `k2_lane` / `k5_lane` in tests/test_torch_c172.py.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax.core.modeling import bscale
from flightjax.core.sim import comp_add as jcomp_add
from flightjax.physics.atmosphere import SimpleAtmosphere as JAtm
from flightjax.physics.atmosphere import air_data as jair_data
from flightjax.physics.dynamics import DynamicsU as JDynU
from flightjax.physics.dynamics import MassProps as JMassProps
from flightjax.physics.dynamics import VehicleDynamics as JDyn
from flightjax.physics.dynamics import Wrench as JWrench
from flightjax.physics.kinematics import WA as JWA

from flightjax_torch.models.c172.c172s import build_vehicle
from flightjax_torch.parallel import kernels as K
from flightjax_torch.physics.dynamics import MassProps, Wrench
from flightjax_torch.testing import cluster_operands

from test_torch_support import (B, CONTACT_LANES, SEED, TERMINATED_LANE,
                                assert_tree_close, to_torch)

TOL = 1e-12
DT = 0.02
ADT = 0.5 * DT

kin_c, atm_c, dyn_c = JWA(), JAtm(), JDyn()


def fma(xt, kt, adt):
    return jax.tree.map(lambda a, b: a + bscale(adt, b), xt, kt)


def alive_scale(tree, term):
    alive = 1.0 - term
    return jax.tree.map(lambda v: bscale(alive, v), tree)


def k1_lane(x_kin, x_dyn, k_kin, k_dyn, geoid_N, u_atm, t, adt, term):
    xi_kin = fma(x_kin, k_kin, adt)
    xi_dyn = fma(x_dyn, k_dyn, adt)
    kin_dot, kin = kin_c.f_ode(xi_kin, xi_dyn, geoid_N, t)
    atm_d = atm_c.atmospheric_data(u_atm, kin.n_e, kin.h_o)
    air = jair_data(atm_d, kin)
    return alive_scale(kin_dot, term), kin, air, xi_dyn


def k3_lane(xi_dyn, mp_b, wr_b, hr_b, q_eb, r_eb_e, t, term):
    dyn_u = JDynU(mp_sum_b=mp_b, wr_sum_b=wr_b, ho_sum_b=hr_b, q_eb=q_eb,
                  r_eb_e=r_eb_e)
    dyn_dot, _ = dyn_c.f_ode(xi_dyn, dyn_u, None, t)
    return alive_scale(dyn_dot, term)


def k4_lane(x_kin, x_dyn, ksum_kin, ksum_dyn, geoid_N, u_atm, t_new,
            c_kin=None):
    """`k4_lane`; with residuals, the combine is `Simulation.step`'s
    `comp_add` of the (dt/6) k-sum (kinematics leaves in flattening order
    h_e, q_ew, q_wb)."""
    comb = lambda xv, kv: jax.tree.map(lambda a, b: a + (DT / 6.0) * b, xv,
                                       kv)
    if c_kin is None:
        x_kin2 = comb(x_kin, ksum_kin)
    else:
        incr = jax.tree.map(lambda b: (DT / 6.0) * b, ksum_kin)
        x_kin2, c_l = jcomp_add(x_kin, incr,
                                [c_kin["h_e"], c_kin["q_ew"], None])
        c_kin = {"h_e": c_l[0], "q_ew": c_l[1]}
    x_dyn2 = comb(x_dyn, ksum_dyn)
    x_kin2, _ = kin_c.f_step(x_kin2, x_dyn2, None, t_new)
    _, kin = kin_c.f_ode(x_kin2, x_dyn2, geoid_N, t_new)
    atm_d = atm_c.atmospheric_data(u_atm, kin.n_e, kin.h_o)
    air = jair_data(atm_d, kin)
    return x_kin2, x_dyn2, kin, air, c_kin


def _inputs():
    """numpy inputs for the three clusters at the perturbed flagship."""
    return cluster_operands(B, SEED, CONTACT_LANES, (TERMINATED_LANE,))


@pytest.fixture(scope="module")
def case():
    """Inputs and the JAX lane outputs, one jit for all four lanes."""
    d = _inputs()
    j = jax.tree.map(jnp.asarray, d)

    def lanes(j):
        adt = jnp.zeros_like(j["t"]) + ADT
        o1 = k1_lane(j["x_kin"], j["x_dyn"], j["k_kin"], j["k_dyn"],
                     j["geoid_N"], j["u_atm"], j["t"], adt, j["term"])
        mp = JMassProps(m=j["mp"]["m"], J=j["mp"]["J"], r_OG=j["mp"]["r_OG"])
        wr = JWrench(F=j["wr"]["F"], tau=j["wr"]["tau"])
        o3 = k3_lane(j["x_dyn"], mp, wr, j["hr"], j["q_eb"], j["r_eb_e"],
                     j["t"], j["term"])
        args4 = (j["x_kin"], j["x_dyn"], j["ksum_kin"], j["ksum_dyn"],
                 j["geoid_N"], j["u_atm"], j["t"] + DT)
        o4 = k4_lane(*args4)[:4]
        o4c = k4_lane(*args4, c_kin=j["c_kin"])
        return o1, o3, o4, o4c

    ref = jax.jit(jax.vmap(lanes))(j)
    return d, jax.tree.map(np.asarray, ref)


def _kinair_args(d):
    T = to_torch({k: d[k] for k in ("x_kin", "x_dyn", "k_kin", "k_dyn",
                                    "geoid_N", "u_atm", "term")})
    return (T["x_kin"], T["x_dyn"], T["k_kin"], T["k_dyn"], T["geoid_N"],
            T["u_atm"], ADT, T["term"])


def _dynamics_args(d):
    T = to_torch({k: d[k] for k in ("x_dyn", "mp", "wr", "hr", "q_eb",
                                    "r_eb_e", "term")})
    return (T["x_dyn"], MassProps(**T["mp"]), Wrench(**T["wr"]), T["hr"],
            T["q_eb"], T["r_eb_e"], T["term"])


def _finish_args(d, comp):
    T = to_torch({k: d[k] for k in ("x_kin", "x_dyn", "ksum_kin", "ksum_dyn",
                                    "geoid_N", "u_atm", "c_kin")})
    return (T["x_kin"], T["x_dyn"], T["ksum_kin"], T["ksum_dyn"],
            T["geoid_N"], T["u_atm"], DT, T["c_kin"] if comp else None)


def test_kinair_plain_matches_k1_lane(case):
    d, (ref, _, _, _) = case
    kin_dot, kin, air, xi_dyn = K.kinair_plain(*_kinair_args(d))
    assert_tree_close(kin_dot, ref[0], TOL, "kin_dot/")
    assert_tree_close(kin, ref[1], TOL, "kin/")
    assert_tree_close(air, ref[2], TOL, "air/")
    assert_tree_close(xi_dyn, ref[3], TOL, "xi_dyn/")
    assert torch.all(torch.stack([v[TERMINATED_LANE].abs().max()
                                  for v in kin_dot.values()]) == 0)


def test_dynamics_plain_matches_k3_lane(case):
    d, (_, ref, _, _) = case
    dyn_dot = K.dynamics_plain(*_dynamics_args(d))
    assert_tree_close(dyn_dot, ref, TOL, "dyn_dot/")
    assert float(dyn_dot["v_eb_b"][TERMINATED_LANE].abs().max()) == 0.0


@pytest.mark.parametrize("comp", [False, True], ids=["plain", "compensated"])
def test_finish_kin_plain_matches_k4_lane(case, comp):
    d, (_, _, ref4, ref4c) = case
    x_kin2, x_dyn2, kin, air, c2 = K.finish_kin_plain(*_finish_args(d, comp))
    ref = ref4c if comp else ref4
    assert_tree_close(x_kin2, ref[0], TOL, "x_kin/")
    assert_tree_close(x_dyn2, ref[1], TOL, "x_dyn/")
    assert_tree_close(kin, ref[2], TOL, "kin/")
    assert_tree_close(air, ref[3], TOL, "air/")
    if comp:
        assert_tree_close(c2, ref[4], TOL, "c/")
        assert float(c2["h_e"].abs().max()) > 0.0
    else:
        assert c2 is None


def test_wrappers_run_plain_on_cpu_without_launching(case):
    """On CPU tensors the wrappers are the plain versions and launch
    nothing, on the mechanical C172, on the fly-by-wire one and the
    turbulent C172S and C172X (whose instances the same wrappers launch on
    the card), on the C172X's three passes (the control laws, the
    guidance, a mission) and on the navigation pass."""
    from flightjax_torch.models.c172.c172x import build_vehicle as fbw_vehicle
    from flightjax_torch.parallel.launch import (FBW_KERNELS,
                                                 FBW_TURB_KERNELS,
                                                 TURB_KERNELS)
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import (fbw_cluster_operands,
                                         fbw_turb_operands,
                                         turb_operand_args, turb_operands)
    d, _ = case
    args = K.operand_args(d, build_vehicle(device="cpu", dtype=torch.float64),
                          "cpu", torch.float64, adt=ADT, dt=DT)
    fbw = K.operand_args(fbw_cluster_operands(B, SEED, CONTACT_LANES,
                                              (TERMINATED_LANE,)),
                         fbw_vehicle(device="cpu", dtype=torch.float64),
                         "cpu", torch.float64, adt=ADT, dt=DT)
    from flightjax_torch.testing import (ctl_laws_args, gdc_laws_args,
                                         msn_laws_args, msn_nav_laws_args)
    ctl = {"ctl_laws": ctl_laws_args(B, SEED, "cpu", torch.float64, (1,)),
           "gdc_ctl_laws": gdc_laws_args(B, SEED, "cpu", torch.float64,
                                         (1,)),
           "msn_ctl_laws": msn_laws_args(B, SEED, "cpu", torch.float64,
                                         (1,)),
           "msn_nav_ctl_laws": msn_nav_laws_args(B, SEED, "cpu",
                                                 torch.float64, (1,))}
    turb = {K.TURB.names[k]: a for k, a in turb_operand_args(
        turb_operands(B, SEED, CONTACT_LANES, (TERMINATED_LANE,)),
        build_vehicle(device="cpu", dtype=torch.float64,
                      turbulence=DrydenTurbulence(DT)), "cpu",
        torch.float64, adt=ADT, dt=DT).items()}
    fbw_turb = {K.FBW_TURB.names[k]: a for k, a in turb_operand_args(
        fbw_turb_operands(B, SEED, CONTACT_LANES, (TERMINATED_LANE,)),
        fbw_vehicle(device="cpu", dtype=torch.float64,
                    turbulence=DrydenTurbulence(DT)), "cpu",
        torch.float64, adt=ADT, dt=DT).items()}
    K.reset_launches()
    # every kernel but the megakernels, whose steps have their own wrapper
    mega = {"megakernel", "megakernel_fbw", "megakernel_gdc",
            "megakernel_msn", "megakernel_turb", "megakernel_fbw_turb",
            "megakernel_nav", "megakernel_nav_turb", "megakernel_gdc_turb",
            "megakernel_msn_turb", "megakernel_gdc_nav",
            "megakernel_msn_nav", "megakernel_gdc_nav_turb",
            "megakernel_msn_nav_turb"}
    turbs = {*TURB_KERNELS, *FBW_TURB_KERNELS}
    assert set(args) | set(ctl) == set(K.LAUNCHES) - {*mega, *FBW_KERNELS,
                                                      *turbs, "nav_pass"}
    assert {K.FBW.names.get(k, k) for k in fbw} == (
        set(K.LAUNCHES) - {*mega, *ctl, *K.FBW.names, *turbs, "nav_pass"})
    assert set(turb) == set(TURB_KERNELS) - mega
    assert set(fbw_turb) == set(FBW_TURB_KERNELS) - mega
    for name, a in (*turb.items(), *fbw_turb.items()):
        base = name[:name.index("_", len("rk4_s"))]
        got = getattr(K, base)(*a)
        ref = getattr(K, base + "_plain")(*a)
        for (pa, ta), (pb, tb) in zip(_leaves(got), _leaves(ref)):
            assert pa == pb and torch.equal(ta, tb), (name, pa)
    from flightjax_torch.testing import nav_operand_state, nav_pass_args
    nav = {"nav_pass": nav_pass_args(*nav_operand_state(
        B, SEED, "cpu", torch.float64))}
    for ops in (args, fbw, ctl, nav):
        for name in ops:
            a = getattr(K, name)(*ops[name])
            b = getattr(K, name + "_plain")(*ops[name])
            for (pa, ta), (pb, tb) in zip(_leaves(a), _leaves(b)):
                assert pa == pb and torch.equal(ta, tb), (name, pa)
    assert K.LAUNCHES == {name: 0 for name in (
        "kinair", "dynamics", "finish_kin", "systems", "finish_sys",
        "rk4_stage", "rk4_finish", "geoid", "megakernel", *FBW_KERNELS,
        "megakernel_fbw", "ctl_laws", "megakernel_gdc", "gdc_ctl_laws",
        "megakernel_msn", "msn_ctl_laws", *TURB_KERNELS,
        *FBW_TURB_KERNELS, "nav_pass", "megakernel_nav",
        "megakernel_nav_turb", "megakernel_gdc_nav", "megakernel_gdc_turb",
        "megakernel_msn_turb", "megakernel_msn_nav", "msn_nav_ctl_laws",
        "megakernel_gdc_nav_turb", "megakernel_msn_nav_turb")}


def test_finish_kin_rejects_other_residual_sets(case):
    d, _ = case
    args = list(_finish_args(d, True))
    args[-1] = {"h_e": args[-1]["h_e"]}
    with pytest.raises(ValueError):
        K.finish_kin(*args)


def _leaves(tree):
    from flightjax_torch.core.modeling import tree_leaves_with_path
    return tree_leaves_with_path(tree)
