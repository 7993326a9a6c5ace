"""The whole fleet step in one kernel launch (port of
`flightjax/parallel/megakernel.py::make_megakernel_step`, `:43-156`).

The state stays resident on the card between steps, in the layout the
`megakernel` kernel declares (`csrc/c172_systems.cuh`): one `[rows, B]`
buffer of the state's dtype holding t, the vehicle state X, the context
CTX (inputs, discrete state, carried undulation, terminated latch; bools
and integers as exact 0/1/2) and the position residuals C, beside an int32
`[1, B]` step counter. On the C172Xv1 (`megakernel_fbw`) X and CTX carry
the servos and their commands, and the avionics' inputs and state (the
control laws' modes, altitude machine and saturation flags as exact small
integers) follow C (`csrc/c172x_ctl.cuh`). This takes the place of the part
of `flightjax/parallel/packed.py::make_packer` the JAX kernel uses: the
layout is fixed by the kernel, so `pack` / `unpack` here are plain row
maps.

The step is `Simulation.step` vmapped over the fleet, as the JAX kernel
computes it: RK4, the compensated add when residuals are carried
(`core/sim.py:315-320`), World.f_step with the terminated latch, on the
C172Xv1 the masked periodic pass (`sim.py:327-333`: the control laws where
a lane's new counter is a multiple of `steps_per_periodic`), and the geoid
refreshed on every step (`megakernel.py:144-154`, which ignores
`geoid_every`). The pass reads the undulation from before the refresh, as
the JAX kernel, stepping under `geoid_deferred`, does. There is no fleet
gear gate, as in the rest of the port.
"""

import torch

from flightjax_torch.core.modeling import tree_where
from flightjax_torch.core.sim import SimState
from flightjax_torch.models.c172.c172x_ctl import ControlLaws
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import cluster_step

# the rows of the C172S's resident state buffer: t, then X; CTX; C
MEGA_GROUPS = K.MECH.mega


def megakernel_step_plain(sim, state: SimState) -> SimState:
    """The plain cluster step with the geoid refreshed on every step and
    the periodic pass where each lane's counter fires: the port of
    `jax.vmap(Simulation.step)`, the kernel's plain version."""
    spp = sim.steps_per_periodic
    # a fleet counter at which the pass fires; the lanes whose own counter
    # does not fire keep their inputs and avionics state
    new = cluster_step(sim, state, spp - 1, plain=True, geoid_every=1)
    if sim.system.aircraft.avionics is None:
        return new
    fires = (state.i + 1) % spp == 0
    return new._replace(u=tree_where(fires, new.u, state.u), s=dict(
        new.s, avionics=tree_where(fires, new.s["avionics"],
                                   state.s["avionics"])))


def make_megakernel_step(sim, state, ctx=(), block=None):
    """`(bufs0, step_packed, unpack)` for a batch-leading SimState like
    `state`: `bufs0` its resident buffers (state, i), `step_packed(bufs)`
    one step (one kernel launch on the card; unpack -> plain -> pack on the
    CPU) returning new buffers, `unpack(bufs)` the SimState. `block` is the
    aircraft per block, 32 or 64 (default `launch.LANES`): the kernel
    carries each aircraft in several threads, one warp per subsystem, so a
    block has eight times as many threads. The step compensates iff
    `state.c` is set, as `Simulation.step` does. Carries the C172S, and
    the fly-by-wire C172Xv1 with its `ControlLaws`."""
    if ctx != ():
        raise NotImplementedError(
            "mission contexts (core/mission.py) are not ported: ROADMAP P9")
    aircraft = sim.system.aircraft
    vehicle, avionics = aircraft.vehicle, aircraft.avionics
    lay = K.layout_of(vehicle)  # refuses second-order servos
    if lay.fbw and not isinstance(avionics, ControlLaws):
        raise NotImplementedError(
            "the fly-by-wire megakernel carries the C172X's ControlLaws; "
            "the Xv2's guidance (c172x_gdc.py) is ROADMAP P9")
    name = lay.mega_name
    comp = state.c is not None

    def pack(st):
        if (st.c is not None) != comp:
            raise ValueError("the residuals must be set as in the template")
        xv, uv, sv = st.x["vehicle"], st.u["vehicle"], st.s["vehicle"]
        c_kin = None if st.c is None else st.c["vehicle"]["kinematics"]
        buf = K.pack_vehicle(vehicle, xv, uv, sv, st.s["terminated"], c_kin)
        parts = [st.t.to(buf.dtype)[None], buf]
        if lay.fbw:
            u_av, s_av = st.u["avionics"], st.s["avionics"]
            parts.append(K.pack(K.AV_GROUPS, (u_av["lon"], u_av["lat"],
                                              s_av["lon"], s_av["lat"]),
                                buf.shape[1], buf.dtype))
        return (torch.cat(parts),
                st.i.to(torch.int32).reshape(1, -1).contiguous())

    def unpack(bufs):
        buf, i = bufs
        t, xv, uv, sv, terminated, c_kin, u_av, s_av = K.unpack_out(
            name, buf, comp)
        u, s = {"vehicle": uv}, {"vehicle": sv, "terminated": terminated}
        if lay.fbw:
            u["avionics"], s["avionics"] = u_av, s_av
        return SimState(t=t, i=i[0], x={"vehicle": xv}, u=u, s=s,
                        c={"vehicle": {"kinematics": c_kin}} if comp
                        else None)

    def step_packed(bufs):
        if bufs[0].device.type == "cpu":
            return pack(megakernel_step_plain(sim, unpack(bufs)))
        return K.launch_megakernel(vehicle, bufs, sim.dt, sim.t_start, comp,
                                   block, avionics, sim.steps_per_periodic,
                                   sim.periodic_dt)

    if state.t.device.type != "cpu":  # build the kernel's operands once
        K.system_params(vehicle)
        K.geoid_grid(vehicle.geoid)
        if lay.fbw:
            K.ctl_gains(avionics)
    return pack(state), step_packed, unpack
