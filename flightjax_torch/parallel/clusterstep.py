"""One fleet step as clusters (port of the orchestration of
`flightjax/parallel/clusterstep.py::_make_cluster_step_split`,
`clusterstep.py:183-611`).

Per RK4 stage: kinair -> systems (act + aero -> three gear legs ->
powerplant + mass) -> dynamics. After the stages: finish_kin -> finish_sys
(act -> three gear struts -> stall/gear/engine/crash), then the geoid
refresh on every `geoid_every`-th step and the terminated latch. Each
cluster is a CUDA kernel of `parallel/kernels.py` on the card and its plain
PyTorch version on the CPU. The systems run as one kernel per stage and
one per step, the JAX package's `k_systems` / `k_finish_sys`; its finer
per-part split exists only for the TPU's compile helper, and its parts are
the kernels' `__device__` functions here, called in the same order.

Stage offsets, weights and the k-sum association ((k1 + 2k2) + 2k3) + k4
follow `clusterstep.py:543-560` and `sim.py:53-68`, so float64 parity with
`flightjax` holds to rounding.
"""

import torch

from flightjax_torch.core.modeling import tree_map
from flightjax_torch.core.sim import SimState
from flightjax_torch.parallel import kernels as K


def f_ode_stage(vehicle, xv, kv, uv, sv, term, adt):
    """World derivative at the RK4 stage state xv + adt kv."""
    kin_dot, kin, air, xi_dyn = K.kinair(
        xv["kinematics"], xv["dynamics"], kv["kinematics"], kv["dynamics"],
        sv["geoid_N"], uv["atm"], adt, term)
    sys_dot, mp_b, wr_b, hr_b = K.systems(
        vehicle, xv["systems"], kv["systems"], uv["systems"], sv["systems"],
        uv["trn"], kin, air, adt, term)
    dyn_dot = K.dynamics(xi_dyn, mp_b, wr_b, hr_b, kin.q_eb, kin.r_eb_e,
                         term)
    return {"kinematics": kin_dot, "dynamics": dyn_dot, "systems": sys_dot}


def cluster_step(sim, state: SimState, i: int) -> SimState:
    """Advance a batch-leading world SimState whose step counter is `i`."""
    vehicle = sim.system.aircraft.vehicle
    dt = sim.dt
    t, x, u, s = state.t, state.x, state.u, state.s
    xv, uv, sv = x["vehicle"], u["vehicle"], s["vehicle"]
    term = s["terminated"].to(t.dtype)

    kprev = tree_map(torch.zeros_like, xv)
    acc = kprev
    for c, w in ((0.0, 1.0), (0.5 * dt, 2.0), (0.5 * dt, 2.0), (dt, 1.0)):
        kcur = f_ode_stage(vehicle, xv, kprev, uv, sv, term, c)
        acc = tree_map(lambda a, b: a + w * b, acc, kcur)
        kprev = kcur

    i_new = state.i + 1
    t_new = sim.t_start + i_new.to(t.dtype) * dt

    c_kin = None
    if state.c is not None:
        if set(state.c) != {"vehicle"} or set(state.c["vehicle"]) != {
                "kinematics"}:
            raise ValueError("only kinematics position states are "
                             "compensated")
        c_kin = state.c["vehicle"]["kinematics"]
    x_kin2, x_dyn2, kin2, air2, c_kin2 = K.finish_kin(
        xv["kinematics"], xv["dynamics"], acc["kinematics"],
        acc["dynamics"], sv["geoid_N"], uv["atm"], dt, c_kin)

    x_sys2, s_sys2 = K.finish_sys(vehicle, xv["systems"], acc["systems"],
                                  uv["systems"], sv["systems"], uv["trn"],
                                  kin2, air2, dt)

    xv2 = {"kinematics": x_kin2, "dynamics": x_dyn2, "systems": x_sys2}
    sv2 = dict(sv, systems=s_sys2)
    if (i + 1) % sim.geoid_every == 0:
        sv2 = vehicle.refresh_geoid(xv2, sv2)
    s2 = dict(s, vehicle=sv2,
              terminated=s["terminated"] | s_sys2["crashed"])
    c2 = None if c_kin2 is None else {"vehicle": {"kinematics": c_kin2}}
    return SimState(t=t_new, i=i_new, x=dict(x, vehicle=xv2), u=u, s=s2,
                    c=c2)
