"""Scripted-mission phase machines (port of `flightjax/core/mission.py`).

A pure phase machine wrapped around the avionics: the phase index and the
mission clock live in the avionics' discrete state; each periodic firing
applies the current phase's input overrides to the inner avionics' inputs,
advances the index when the phase's completion predicate fires, and after
the inner pass the phase's vehicle-systems overrides (flaps, brakes,
engine start). Every fleet lane can be in a different phase.

Leaves are fleet-shaped (a leading batch axis). `lax.switch` on a batched
index computes every branch and selects; so does this port: every phase's
`apply`, `done` and `systems` run on every lane and each lane takes its
phase's, which selection gives exactly. The phases of the LOWS missions
(`models/c172/missions.py`) also carry a descriptor, which the kernels
(`csrc/c172x_msn.cuh`) read in place of the Python callables.
"""

from typing import Callable, NamedTuple, Sequence

import torch

from flightjax_torch.core.modeling import tree_where


class Phase(NamedTuple):
    """One mission leg.

    apply(u_avionics, veh_y, t) -> u_avionics : input overrides while active
    done(veh_y, t) -> bool                    : advance to the next phase
    systems(u_systems) -> u_systems           : vehicle-systems overrides
        while active (flaps, brakes, engine start)

    `t` is the mission clock (seconds since mission start, carried in the
    discrete state). Only the current phase's overrides run each firing, so
    each phase specifies its complete override set."""
    name: str
    apply: Callable
    done: Callable
    systems: Callable = None


def _laws(inner):
    """The control laws of an inner avionics (they type its leaves)."""
    return getattr(inner, "ctl", inner)


class MissionAvionics:
    """Wrap an avionics component with a phase machine. Satisfies the
    avionics protocol of `physics/aircraftbase.py::Aircraft`; adds
    s['phase'] (int32) and s['t'] (the mission clock, in the state's
    dtype), the inner avionics' state under s['inner']."""

    def __init__(self, inner, phases: Sequence[Phase]):
        self.inner = inner
        self.phases = list(phases)
        laws = _laws(inner)
        self.device, self.dtype = laws.device, laws.dtype

    def _clock(self, shape):
        return {"phase": torch.zeros(shape, dtype=torch.int32,
                                     device=self.device),
                "t": torch.zeros(shape, dtype=self.dtype,
                                 device=self.device)}

    def init_u(self, shape=()):
        return self.inner.init_u(shape)

    def init_s(self, shape=()):
        return {"inner": self.inner.init_s(shape), **self._clock(shape)}

    def _index(self, phase):
        """The phase index clipped to the phases, as the switch takes it."""
        return torch.clamp(phase, 0, len(self.phases) - 1)

    def overrides(self, s, u, veh_y):
        """The inputs the inner pass reads: the current (old) phase's
        `apply` on the stored inputs at the mission clock."""
        idx = self._index(s["phase"])
        out = None
        for k, p in enumerate(self.phases):
            cand = p.apply(u, veh_y, s["t"])
            out = cand if out is None else tree_where(idx == k, cand, out)
        return out

    def advance(self, s, veh_y):
        """The new phase index: the current phase's `done` at the mission
        clock advances it while it is not the last phase."""
        phase = s["phase"]
        idx = self._index(phase)
        done = None
        for k, p in enumerate(self.phases):
            d = torch.broadcast_to(torch.as_tensor(p.done(veh_y, s["t"]),
                                                   device=phase.device),
                                   phase.shape)
            done = d if done is None else torch.where(idx == k, d, done)
        return torch.where(done & (phase < len(self.phases) - 1), phase + 1,
                           phase).to(torch.int32)

    def f_periodic(self, s, u, veh_y, dt):
        """The overrides feed the inner pass only; the index advances by the
        old phase's predicate at the old clock; the clock grows by dt."""
        u_over = self.overrides(s, u, veh_y)
        phase_new = self.advance(s, veh_y)
        s_inner, y_inner = self.inner.f_periodic(s["inner"], u_over, veh_y,
                                                 dt)
        return ({"inner": s_inner, "phase": phase_new, "t": s["t"] + dt},
                {"inner": y_inner, "phase": phase_new})

    def assign(self, u_systems, av_y):
        """The inner avionics' assignment, then the new phase's systems
        overrides (only if some phase has any)."""
        u_systems = self.inner.assign(u_systems, av_y["inner"])
        if any(p.systems is not None for p in self.phases):
            idx = self._index(av_y["phase"])
            out = None
            for k, p in enumerate(self.phases):
                cand = (p.systems(u_systems) if p.systems is not None
                        else u_systems)
                out = cand if out is None else tree_where(idx == k, cand,
                                                          out)
            u_systems = out
        return u_systems

    def output(self, s, u, veh_y):
        return {"inner": self.inner.output(s["inner"], u, veh_y),
                "phase": s["phase"]}

    def init_from_trim(self, veh_y, dt):
        """The inner avionics' bumpless start, the mission in its first
        phase at clock 0."""
        u, s = self.inner.init_from_trim(veh_y, dt)
        return u, {"inner": s,
                   **self._clock(tuple(veh_y.airflow.EAS.shape))}
