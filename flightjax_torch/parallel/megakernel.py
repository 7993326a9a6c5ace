"""The whole fleet step in one kernel launch (port of
`flightjax/parallel/megakernel.py::make_megakernel_step`, `:43-156`).

The state stays resident on the card between steps, in the layout the
`megakernel` kernel declares (`csrc/c172_systems.cuh`): one `[rows, B]`
buffer of the state's dtype holding t, the vehicle state X, the context
CTX (inputs, discrete state, carried undulation, terminated latch; bools
and integers as exact 0/1/2) and the position residuals C, beside an int32
`[1, B]` step counter. This takes the place of the part of
`flightjax/parallel/packed.py::make_packer` the JAX kernel uses: the layout
is fixed by the kernel, so `pack` / `unpack` here are plain row maps.

The step is `Simulation.step` vmapped over the fleet, as the JAX kernel
computes it: RK4, the compensated add when residuals are carried
(`core/sim.py:315-320`), World.f_step with the terminated latch, and the
geoid refreshed on every step (`megakernel.py:144-154`, which ignores
`geoid_every`). There is no fleet gear gate, as in the rest of the port.
"""

import torch

from flightjax_torch.core.sim import SimState
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import cluster_step

# the rows of the resident state buffer: t, then X; CTX; C
MEGA_GROUPS = ((("t", 1),),) + K.RKFIN_IN


def megakernel_step_plain(sim, state: SimState) -> SimState:
    """The plain cluster step with the geoid refreshed on every step: the
    port of `jax.vmap(Simulation.step)`, the kernel's plain version."""
    return cluster_step(sim, state, 0, plain=True, geoid_every=1)


def make_megakernel_step(sim, state, ctx=(), block=None):
    """`(bufs0, step_packed, unpack)` for a batch-leading SimState like
    `state`: `bufs0` its resident buffers (state, i), `step_packed(bufs)`
    one step (one kernel launch on the card; unpack -> plain -> pack on the
    CPU) returning new buffers, `unpack(bufs)` the SimState. `block` is the
    aircraft per block, 32 or 64 (default `launch.LANES`): the kernel
    carries each aircraft in several threads, one warp per subsystem, so a
    block has eight times as many threads. The step compensates iff
    `state.c` is set, as `Simulation.step` does."""
    if ctx != ():
        raise NotImplementedError(
            "mission contexts (core/mission.py) are not ported: ROADMAP P9")
    vehicle = sim.system.aircraft.vehicle
    if (sim.system.aircraft.avionics is not None
            or K.layout_of(vehicle).fbw):
        raise NotImplementedError(
            "the megakernel carries the mechanical C172 without avionics; "
            "the fly-by-wire megakernel with the control laws inside it is "
            "ROADMAP Queue 2, item 1")
    comp = state.c is not None

    def pack(st):
        if (st.c is not None) != comp:
            raise ValueError("the residuals must be set as in the template")
        xv, uv, sv = st.x["vehicle"], st.u["vehicle"], st.s["vehicle"]
        c_kin = None if st.c is None else st.c["vehicle"]["kinematics"]
        buf = K.pack_vehicle(vehicle, xv, uv, sv, st.s["terminated"], c_kin)
        buf = torch.cat([st.t.to(buf.dtype)[None], buf])
        return buf, st.i.to(torch.int32).reshape(1, -1).contiguous()

    def unpack(bufs):
        buf, i = bufs
        xv, uv, sv, terminated, c_kin = K.unpack_vehicle(buf[1:])
        return SimState(t=buf[0], i=i[0], x={"vehicle": xv},
                        u={"vehicle": uv},
                        s={"vehicle": sv, "terminated": terminated},
                        c={"vehicle": {"kinematics": c_kin}} if comp
                        else None)

    def step_packed(bufs):
        if bufs[0].device.type == "cpu":
            return pack(megakernel_step_plain(sim, unpack(bufs)))
        return K.launch_megakernel(vehicle, bufs, sim.dt, sim.t_start, comp,
                                   block)

    if state.t.device.type != "cpu":  # build the kernel's operands once
        K.system_params(vehicle)
        K.geoid_grid(vehicle.geoid)
    return pack(state), step_packed, unpack
