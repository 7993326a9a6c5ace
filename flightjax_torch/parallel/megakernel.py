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
integers) follow C (`csrc/c172x_ctl.cuh`); on the C172Xv2
(`megakernel_gdc`) the guidance's inputs follow them
(`csrc/c172x_gdc.cuh`), and over a scripted mission (`megakernel_msn`)
the phase index and the mission clock follow those (`csrc/c172x_msn.cuh`).
The rows of the buffer: 69 (the C172S), 141 (the C172Xv1; 142 with a
second-order elevator, `megakernel_fbw_a2`, whose rate follows its
position), 158 (the C172Xv2), 160 (a mission), 84 (the turbulent C172S,
`megakernel_turb`:
the C172S's rows with the five filter states after X and the Dryden and
discrete-gust inputs and the held drive after CTX). On the turbulent C172S
the int32 counter is `[3, B]`: the step counter, the stream's seed and the
drive's counter, integers past what float32 holds exactly; the turbulent
C172Xv1, C172Xv2 and mission (`megakernel_fbw_turb`, `megakernel_gdc_turb`,
`megakernel_msn_turb`) hold their calm twins' rows with the turbulence's
placed as on the C172S, and that int32 `[3, B]`; the sensor-fed C172Xv1
and C172Xv2 (`megakernel_nav(_turb)`, `megakernel_gdc_nav(_turb)`) and
the sensor-fed missions (`megakernel_msn_nav(_turb)`) their truth-fed
twins' rows, then the navigation avionics' NAV_U and NAV_S, and their
int32 rows also NAV_INT (after the step counter, or after the turbulent
twin's three rows). This takes the place of the part
of `flightjax/parallel/packed.py::make_packer` the JAX kernel uses: the
layout is fixed by the kernel, so `pack` / `unpack` here are plain row
maps.

The step is `Simulation.step` vmapped over the fleet, as the JAX kernel
computes it: RK4, the compensated add when residuals are carried
(`core/sim.py:315-320`), World.f_step with the terminated latch, on the
C172Xv1 the masked periodic pass (`sim.py:327-333`: the control laws where
a lane's new counter is a multiple of `steps_per_periodic`), and the geoid
refreshed on every step (`megakernel.py:144-154`, which ignores
`geoid_every`). On the C172Xv2 the pass runs the guidance laws first;
over a mission the phase machine runs before them, and the new phase's
systems overrides (flaps, brakes, engine start) follow them; around the
navigation avionics the sensors and the filter run first, and the phase
machine, the guidance and the control laws read the estimates (the
estimated orthometric height too, which the radar gate reads). The
pass reads the undulation from before the refresh, as the JAX kernel,
stepping under `geoid_deferred`, does. There is no fleet
gear gate, as in the rest of the port.
"""

import torch

from flightjax_torch.core.modeling import tree_where
from flightjax_torch.core.sim import SimState
from flightjax_torch.parallel import kernels as K
from flightjax_torch.parallel.clusterstep import cluster_step, vehicle_step

# the rows of the C172S's resident state buffer: t, then X; CTX; C
MEGA_GROUPS = K.MECH.mega


def megakernel_step_plain(sim, state: SimState) -> SimState:
    """The plain cluster step with the geoid refreshed on every step and
    the periodic pass where each lane's counter fires: the port of
    `jax.vmap(Simulation.step)`, the kernel's plain version (on the
    turbulent C172S the plain whole-vehicle step, compensated iff
    `state.c`). The navigation avionics' pass reads each lane's own sensor
    epoch, as `Simulation.step` does."""
    spp = sim.steps_per_periodic
    # a fleet counter at which the pass fires; the lanes whose own counter
    # does not fire keep their inputs and avionics state
    if sim.system.aircraft.vehicle.turbulence is not None:
        new = vehicle_step(sim, state, spp - 1, comp=state.c is not None,
                           plain=True, geoid_every=1)
    else:
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
    `state.c` is set, as `Simulation.step` does. Carries the C172S, the
    fly-by-wire C172Xv1 with its `ControlLaws` and the C172Xv2 with its
    guidance and control laws (`c172x_gdc.Avionics`), a scripted mission
    over those whose phases carry descriptors (`core/mission.py`,
    `models/c172/missions.py`), the turbulent C172S (`megakernel_turb`,
    whose int32 buffer is `[3, B]`: i, seed, n) and the turbulent C172Xv1
    on its control laws (`megakernel_fbw_turb`, the same int32 rows), and
    the sensor-fed C172Xv1 (`NavAvionics(ControlLaws)`, `c172x.
    build_xv1_nav`: `megakernel_nav`, in turbulence `megakernel_nav_turb`,
    whose int32 buffer holds the navigation avionics' NAV_INT rows after
    the step counter's), the turbulent C172Xv2 and a mission on it
    (`megakernel_gdc_turb`, `megakernel_msn_turb`, int32 rows i, seed, n)
    and the sensor-fed C172Xv2 (`c172x.build_xv2_nav`:
    `megakernel_gdc_nav`, its guidance and control laws on the estimates)
    and missions (`missions.mission_nav_sim`: `megakernel_msn_nav`, the
    phase machine on the estimates too), calm and in turbulence
    (`megakernel_gdc_nav_turb`, `megakernel_msn_nav_turb`: int32 rows i,
    seed, n, then NAV_INT), and the C172Xv1 with a second-order elevator
    (`c172x.c172xv1_sim(actuators={"elevator": Actuator2()})`:
    `megakernel_fbw_a2`; on the CPU any set of second-order channels,
    which the card refuses by name, `kernels.a2_refusal`)."""
    if ctx != ():
        raise NotImplementedError(
            "the step takes no context: ctx is () in every model, and the "
            "mission is an avionics wrapper (MissionAvionics, "
            "core/mission.py)")
    aircraft = sim.system.aircraft
    vehicle, avionics = aircraft.vehicle, aircraft.avionics
    lay = K.layout_of(vehicle)
    if lay.fbw:  # refuses avionics that have no kernel
        lay = K.avionics_layout(vehicle, avionics)
    if state.t.device.type != "cpu":  # a second-order servo the card lacks
        why = K.a2_refusal(lay, ("megakernel",))
        if why is not None:
            raise why
    name = lay.mega_name
    comp = state.c is not None

    def pack(st):
        if (st.c is not None) != comp:
            raise ValueError("the residuals must be set as in the template")
        xv, uv, sv = st.x["vehicle"], st.u["vehicle"], st.s["vehicle"]
        c_kin = None if st.c is None else st.c["vehicle"]["kinematics"]
        if lay.turb:
            parts = [K.mega_rows(lay, K.pack_vehicle(
                vehicle, xv, uv, sv, st.s["terminated"], c_kin, t=st.t))]
            ints = K.pack_turb_int(st.i, uv, sv)
        else:
            buf = K.pack_vehicle(vehicle, xv, uv, sv, st.s["terminated"],
                                 c_kin)
            parts = [st.t.to(buf.dtype)[None], buf]
            ints = st.i.to(torch.int32).reshape(1, -1).contiguous()
        if lay.fbw:
            parts.append(K.pack_avionics(lay, st.u["avionics"],
                                         st.s["avionics"], parts[-1].shape[1],
                                         parts[-1].dtype))
        if lay.nav:
            ints = torch.cat([ints, K.pack_nav_int(st.u["avionics"],
                                                   st.s["avionics"])])
        return torch.cat(parts).contiguous(), ints

    def unpack(bufs):
        buf, i = bufs
        t, xv, uv, sv, terminated, c_kin, u_av, s_av = K.unpack_out(
            name, buf, comp, i)
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
        if lay.nav:
            K.normal_table(state.t.device)
    return pack(state), step_packed, unpack
