"""The scripted LOWS missions of the C172Xv2: the traffic-pattern legs
around Salzburg runway 15, the phase library and the two phase sets
(port of the scripted-mission part of `flightjax/demos/c172_demos.py`,
`:229-371`, `:387-394`, `:548-570`; the demos' `Simulation.run` is not
ported), and the sensor-fed missions flown on the navigation avionics'
estimates (`:413-532`): the radar-gated crosswind landing and the
cold-start takeoff, `NavAvionics(MissionAvionics(...), use_radar=True)`.

Every phase the library makes carries a descriptor beside its Python
callable: its apply kind (hold, fly a leg, flare, ground roll) with the
leg, EAS, throttle and vertical request; its done kind (never, clock,
engine running, airborne, on the ground, leg captured, final done, the
estimated height over the terrain under a gate) with its value or leg; its systems kind (none, flaps, ground, engine start).
`parallel/kernels.py::mission_table` lays the descriptors and the legs out
in one table that the kernels read (`csrc/c172x_msn.cuh`), so that the
phase sets are data and not one kernel per demo. The callables do the
same arithmetic in the same order as the kernels, in the state's dtype;
the legs are built in float64 on the host, as the JAX legs are, and cast
once to the state's dtype.
"""

import os

import numpy as np
import torch

from flightjax_torch.bridge import tree_from_numpy
from flightjax_torch.core.mission import MissionAvionics, Phase
from flightjax_torch.core.modeling import tree_map
from flightjax_torch.core.sim import SimState, Simulation
from flightjax_torch.models.c172 import c172x
from flightjax_torch.models.c172 import c172x_ctl as CTL
from flightjax_torch.models.c172 import c172x_gdc as GDC
from flightjax_torch.ops import geodesy as geo
from flightjax_torch.ops.attitude import wrap_to_pi
from flightjax_torch.physics.aircraftbase import Aircraft, SimpleWorld
from flightjax_torch.physics.piston import ENG_RUNNING
from flightjax_torch.physics.terrain import HorizontalTerrain

# Salzburg LOWS runway 15 (`c172_demos.py:229-233`); h is orthometric
LAT_LOWS15 = np.deg2rad(47.80433)
LON_LOWS15 = np.deg2rad(12.997)
H_LOWS15 = 427.2
PSI_LOWS15 = np.deg2rad(157.0)
DH_TO_GND = 1.81          # gear-extended CoM height over ground
CAPTURE_THRESHOLD = -200.0  # along-track distance-to-go gate (m)
# the height over the runway's end below which the final leg is done (m),
# the flare's climb-rate and EAS references, the ground roll's rudder
FINAL_DH, FLARE_CLM, FLARE_EAS, GROUND_RUDDER = 6.0, -0.3, 30.0, -0.04
# the two starts of the missions (`tools/export_torch_c172x.py`)
_DATA = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir, "data")
LANDING_NPZ = os.path.join(_DATA, "c172x_lows_final_trim.npz")
RUNWAY_NPZ = os.path.join(_DATA, "c172x_lows_runway.npz")
# the trim of the sensor-fed landing, LANDING_NAV_S_TOGO m up the final
LANDING_NAV_NPZ = os.path.join(_DATA, "c172x_lows_final_nav_trim.npz")
LANDING_NAV_S_TOGO = 1500.0
# the legs of `lows_pattern`, from the runway's end back to the runway
LEG_NAMES = ("final", "base", "downwind", "crosswind", "departure")

# the descriptor kinds (csrc/c172x_msn.cuh): apply, done, systems
MA_HOLD, MA_LEG, MA_FLARE, MA_GROUND = range(4)
(MD_NEVER, MD_CLOCK, MD_ENGINE, MD_AIRBORNE, MD_ON_GND, MD_CAPTURED,
 MD_FINAL, MD_AGL) = range(8)
MS_NONE, MS_FLAPS, MS_GROUND, MS_START = range(4)


def lows_pattern():
    """Traffic-pattern legs around LOWS 15 (`c172_demos.py:240-269`), built
    in float64 on the CPU; altitudes ellipsoidal. {leg name: Segment,
    "h_rwy": the runway's ellipsoidal height}."""
    f = lambda v: torch.tensor(v, dtype=torch.float64)
    n_rwy = geo.nvector_from_latlon(f(LAT_LOWS15), f(LON_LOWS15))
    h_rwy = float(geo.ellip_from_orth(f(H_LOWS15), n_rwy))

    def leg_to(p_latlon_h, chi, s, gamma):
        lat, lon, h = p_latlon_h
        return GDC.reversed_segment(
            GDC.segment_from_vector(lat, lon, h, chi, s, gamma=gamma))

    def p1_of(seg):
        lat, lon = GDC.segment_latlon(seg.n_e1)
        return lat, lon, float(seg.h_e1)

    p_rwy = (LAT_LOWS15, LON_LOWS15, h_rwy)
    final_leg = leg_to(p_rwy, PSI_LOWS15 + np.pi, 3e3, np.deg2rad(3))
    base_leg = leg_to(p1_of(final_leg), PSI_LOWS15 - np.pi / 2, 1e3, 0.0)
    downwind_leg = leg_to(p1_of(base_leg), PSI_LOWS15, 6e3, 0.0)
    crosswind_leg = leg_to(p1_of(downwind_leg), PSI_LOWS15 + np.pi / 2, 1e3,
                           0.0)
    cw = p1_of(crosswind_leg)
    departure_leg = GDC.segment(LAT_LOWS15, LON_LOWS15, h_rwy, cw[0], cw[1],
                                cw[2])
    return {"final": final_leg, "base": base_leg, "downwind": downwind_leg,
            "crosswind": crosswind_leg, "departure": departure_leg,
            "h_rwy": h_rwy}


class _Step:
    """A phase function with its descriptor: `kind`, the float64 `leg`
    (a Segment) it reads, if any, and its numbers. The leg is cast once per
    device and dtype."""

    def __init__(self, kind, leg=None, **values):
        self.kind, self.leg, self.values = kind, leg, values
        self._legs = {}

    def leg_as(self, like):
        key = (like.device, like.dtype)
        if key not in self._legs:
            self._legs[key] = GDC.Segment(*(v.to(device=like.device,
                                                 dtype=like.dtype)
                                            for v in self.leg))
        return self._legs[key]


class MissionApply(_Step):
    """`apply(u, y, t)`: the overrides of the avionics' inputs while the
    phase is active (`c172_demos.py:282-332`)."""

    def __call__(self, u, y, t):
        if self.kind == MA_HOLD:
            return u
        full = torch.full_like
        gdc, lon, lat = u["gdc"], u["ctl"]["lon"], u["ctl"]["lat"]
        if self.kind == MA_GROUND:
            # idle, slight left rudder, direct modes
            gdc = dict(gdc, mode_req=full(gdc["mode_req"], GDC.GDC_DIRECT))
            lon = dict(lon, throttle_axis=full(lon["throttle_axis"], 0.0),
                       mode_req=full(lon["mode_req"], CTL.LON_DIRECT))
            lat = dict(lat, rudder_axis=full(lat["rudder_axis"],
                                             GROUND_RUDDER),
                       mode_req=full(lat["mode_req"], CTL.LAT_DIRECT))
            return dict(u, gdc=gdc, ctl=dict(lon=lon, lat=lat))
        leg = self.leg_as(lon["EAS_ref"])
        vrt = self.values["vrt"] if self.kind == MA_LEG else False
        gdc = dict(gdc, mode_req=full(gdc["mode_req"], GDC.GDC_SEGMENT),
                   target=GDC.Segment(*(v.expand_as(r) for v, r in zip(
                       leg, gdc["target"]))),
                   hor_gdc_req=full(gdc["hor_gdc_req"], True),
                   vrt_gdc_req=full(gdc["vrt_gdc_req"], vrt))
        if self.kind == MA_LEG:
            lon = dict(lon, EAS_ref=full(lon["EAS_ref"], self.values["EAS"]))
            if self.values["throttle"] is not None:
                lon["throttle_axis"] = full(lon["throttle_axis"],
                                            self.values["throttle"])
            return dict(u, gdc=gdc, ctl=dict(u["ctl"], lon=lon))
        # the flare: no vertical guidance, a shallow EAS + climb-rate
        # descent, decrab onto the runway-relative crab angle
        data = GDC.segment_data(leg, y.kinematics.n_e, y.kinematics.h_e)
        lon = dict(lon, mode_req=full(lon["mode_req"], CTL.LON_EAS_CLM),
                   clm_ref=full(lon["clm_ref"], FLARE_CLM),
                   EAS_ref=full(lon["EAS_ref"], self.values["EAS"]))
        lat = dict(lat, mode_req=full(lat["mode_req"], CTL.LAT_PHI_BETA),
                   beta_ref=wrap_to_pi(y.kinematics.e_nb[..., 0]
                                       - data.chi_12),
                   phi_ref=full(lat["phi_ref"], 0.0))
        return dict(u, gdc=gdc, ctl=dict(lon=lon, lat=lat))


class MissionDone(_Step):
    """`done(y, t)`: the phase's completion predicate (`c172_demos.py:
    296-352`)."""

    def __call__(self, y, t):
        k = self.kind
        if k == MD_CLOCK:
            return t >= self.values["value"]
        if k == MD_ENGINE:
            return y.systems.pwp.engine.state == ENG_RUNNING
        if k in (MD_AIRBORNE, MD_ON_GND):
            gnd = CTL.is_on_gnd(y)
            return gnd if k == MD_ON_GND else ~gnd
        if k == MD_CAPTURED:
            data = GDC.segment_data(self.leg_as(y.kinematics.h_e),
                                    y.kinematics.n_e, y.kinematics.h_e)
            return data.s_2b > CAPTURE_THRESHOLD
        if k in (MD_FINAL, MD_AGL):
            # the final leg's height over the runway's end; the radar
            # altimeter's flare gate on the orthometric height, which the
            # navigation avionics estimate from the radar return near the
            # ground (`c172_demos.py:450-453`)
            h = y.kinematics.h_e if k == MD_FINAL else y.kinematics.h_o
            return (h - torch.tensor(self.values["value"], dtype=h.dtype,
                                     device=h.device)) < FINAL_DH
        return torch.tensor(False)


class MissionSystems(_Step):
    """`systems(u_sys)`: the vehicle-systems overrides while the phase is
    active (`c172_demos.py:334-347`)."""

    def __call__(self, u_sys):
        act = u_sys["act"]
        full = torch.full_like
        if self.kind == MS_FLAPS:
            return dict(u_sys, act=dict(act, flaps=full(
                act["flaps"], self.values["flaps"])))
        if self.kind == MS_GROUND:
            return dict(u_sys, act=dict(
                act, flaps=full(act["flaps"], 0.0),
                brake_left=full(act["brake_left"], 1.0),
                brake_right=full(act["brake_right"], 1.0)))
        if self.kind == MS_START:
            pwp = u_sys["pwp"]
            eng = dict(pwp["engine"],
                       start=full(pwp["engine"]["start"], True))
            return dict(u_sys, pwp=dict(pwp, engine=eng))
        return u_sys


def mission_phase_lib(legs):
    """The shared phase bodies of the landing and pattern missions
    (`c172_demos.py:272-359`), each a callable with its descriptor, plus
    `hold`, `never` and `clock(c)` (`t >= c`), which the demos write as
    lambdas, and `final_done_agl`, the sensor-fed landing's radar gate
    (`c172_demos.py:450-453`)."""
    final_leg = legs["final"]
    h_rwy_end = float(final_leg.h_e2)

    def fly_leg(leg, EAS_ref, throttle=None, vrt=True):
        return MissionApply(MA_LEG, leg, EAS=float(EAS_ref),
                            throttle=(None if throttle is None
                                      else float(throttle)), vrt=bool(vrt))

    return dict(
        fly_leg=fly_leg,
        captured=lambda leg: MissionDone(MD_CAPTURED, leg),
        final_done=MissionDone(MD_FINAL, value=h_rwy_end),
        final_done_agl=MissionDone(MD_AGL, value=H_LOWS15),
        flare_apply=MissionApply(MA_FLARE, final_leg, EAS=FLARE_EAS),
        ground_apply=MissionApply(MA_GROUND),
        flaps=lambda setting: MissionSystems(MS_FLAPS, flaps=float(setting)),
        ground_systems=MissionSystems(MS_GROUND),
        engine_start=MissionSystems(MS_START),
        engine_running=MissionDone(MD_ENGINE),
        on_gnd=MissionDone(MD_ON_GND),
        airborne=MissionDone(MD_AIRBORNE),
        hold=MissionApply(MA_HOLD),
        never=MissionDone(MD_NEVER),
        clock=lambda c: MissionDone(MD_CLOCK, value=float(c)))


def crosswind_landing_phases(legs=None):
    """Final approach, flare and rollout (`c172_demos.py:387-394`)."""
    legs = lows_pattern() if legs is None else legs
    lib = mission_phase_lib(legs)
    return [
        Phase("final", lib["fly_leg"](legs["final"], 30.0),
              lib["final_done"], systems=lib["flaps"](1.0)),
        Phase("flare", lib["flare_apply"], lib["on_gnd"],
              systems=lib["flaps"](1.0)),
        Phase("ground", lib["ground_apply"], lib["never"],
              systems=lib["ground_systems"]),
    ]


def traffic_pattern_phases(legs=None):
    """The full circuit from a cold start (`c172_demos.py:548-570`):
    standby 5 s, engine start, full-throttle takeoff on the departure leg,
    crosswind, downwind (EAS 50), base (EAS 30, flaps), final, flare,
    braked rollout."""
    legs = lows_pattern() if legs is None else legs
    lib = mission_phase_lib(legs)
    fly, cap = lib["fly_leg"], lib["captured"]
    return [
        Phase("standby", lib["hold"], lib["clock"](5.0)),
        Phase("startup", lib["hold"], lib["engine_running"],
              systems=lib["engine_start"]),
        Phase("takeoff", fly(legs["departure"], 35.0, throttle=1.0),
              lib["airborne"]),
        Phase("departure", fly(legs["departure"], 35.0, throttle=1.0),
              cap(legs["departure"])),
        Phase("crosswind", fly(legs["crosswind"], 35.0, throttle=1.0),
              cap(legs["crosswind"])),
        Phase("downwind", fly(legs["downwind"], 50.0),
              cap(legs["downwind"])),
        Phase("base", fly(legs["base"], 30.0), cap(legs["base"]),
              systems=lib["flaps"](1.0)),
        Phase("final", fly(legs["final"], 30.0), lib["final_done"],
              systems=lib["flaps"](1.0)),
        Phase("flare", lib["flare_apply"], lib["on_gnd"],
              systems=lib["flaps"](1.0)),
        Phase("ground", lib["ground_apply"], lib["never"],
              systems=lib["ground_systems"]),
    ]


def crosswind_landing_nav_phases(legs=None):
    """The sensor-fed landing (`c172_demos.py:455-464`): the final leg
    until the estimated height over the runway falls under the radar gate,
    the flare, the braked rollout."""
    legs = lows_pattern() if legs is None else legs
    lib = mission_phase_lib(legs)
    return [
        Phase("final", lib["fly_leg"](legs["final"], 30.0),
              lib["final_done_agl"], systems=lib["flaps"](1.0)),
        Phase("flare", lib["flare_apply"], lib["on_gnd"],
              systems=lib["flaps"](1.0)),
        Phase("ground", lib["ground_apply"], lib["never"],
              systems=lib["ground_systems"]),
    ]


def takeoff_nav_phases(legs=None):
    """The sensor-fed takeoff from a cold start (`c172_demos.py:508-518`):
    standby 5 s, engine start, full-throttle takeoff and departure on the
    departure leg."""
    legs = lows_pattern() if legs is None else legs
    lib = mission_phase_lib(legs)
    fly = lib["fly_leg"]
    return [
        Phase("standby", lib["hold"], lib["clock"](5.0)),
        Phase("startup", lib["hold"], lib["engine_running"],
              systems=lib["engine_start"]),
        Phase("takeoff", fly(legs["departure"], 35.0, throttle=1.0),
              lib["airborne"]),
        Phase("departure", fly(legs["departure"], 35.0, throttle=1.0),
              lib["captured"](legs["departure"])),
    ]


# the index of each phase of the traffic pattern; the crosswind landing is
# its phases FINAL.. from a trim on the final leg
(STANDBY, STARTUP, TAKEOFF, DEPARTURE, CROSSWIND, DOWNWIND, BASE, FINAL,
 FLARE, GROUND) = range(10)


def mission_avionics(phases, gains=None, *, device, dtype):
    """The C172Xv2's guidance and control laws under the phase machine of
    `phases`."""
    return MissionAvionics(GDC.Avionics(gains, device=device, dtype=dtype),
                           phases)


def mission_aircraft(phases, gains=None, *, device, dtype, turbulence=None):
    """The C172Xv2 flying `phases` over flat terrain at LOWS's elevation
    (`c172_demos.py:362-371`), in Dryden `turbulence` if given (passed on
    to `c172x.build_vehicle`, as the JAX package's `build_vehicle(**kw)`
    takes it)."""
    vehicle = c172x.build_vehicle(device=device, dtype=dtype,
                                  terrain=HorizontalTerrain(
                                      H_LOWS15, device=device, dtype=dtype),
                                  turbulence=turbulence)
    return Aircraft(vehicle, avionics=mission_avionics(
        phases, gains, device=device, dtype=dtype))


def mission_world(phases, gains=None, *, device, dtype, turbulence=None):
    return SimpleWorld(mission_aircraft(phases, gains, device=device,
                                        dtype=dtype, turbulence=turbulence))


def mission_sim(phases, gains=None, *, device="cuda", dtype=torch.float32,
                turbulence=None):
    """The Simulation of the mission world as the demos fly it: dt =
    periodic_dt = 0.02 s, the geoid refreshed every 128 steps, the
    position Kahan-compensated in sub-float64 dtypes (`with_compensation`),
    in Dryden `turbulence` if given. The entry points default to the card,
    as the C172X's do."""
    return Simulation(mission_world(phases, gains, device=device,
                                    dtype=dtype, turbulence=turbulence),
                      dt=0.02, periodic_dt=0.02, geoid_every=128)


def landing_state(periodic_dt, dtype, device, phases=None):
    """One aircraft at the final-leg trim of the crosswind landing (EAS 30
    m/s, -3 deg, full flaps, half fuel; `c172_demos.py:398-401`, the state
    `tools/export_torch_c172x.py` writes) with the avionics started
    bumpless and the mission at clock 0 in its first phase; `phases`
    default `crosswind_landing_phases()`. The 6 m/s crosswind of the demo
    is the caller's."""
    phases = crosswind_landing_phases() if phases is None else phases
    return c172x.trimmed_xv1_state(
        periodic_dt, dtype, device, path=LANDING_NPZ,
        build=lambda **kw: mission_aircraft(phases, **kw))


def runway_state(dtype, device, phases=None):
    """One aircraft cold on the runway 15 threshold (engine off, half fuel;
    `c172_demos.py:574-579`, the state `tools/export_torch_c172x.py`
    writes) with the avionics' initial inputs and state, the mission at
    clock 0 in its first phase; `phases` default
    `traffic_pattern_phases()`."""
    phases = traffic_pattern_phases() if phases is None else phases
    x, u, s, _, _ = c172x.load_xv1_state(RUNWAY_NPZ)
    avionics = mission_avionics(phases, device="cpu", dtype=dtype)
    one = lambda tree: tree_from_numpy(tree, "cpu", dtype)
    state = SimState(
        t=torch.tensor(0.0, dtype=dtype),
        i=torch.tensor(0, dtype=torch.int32),
        x={"vehicle": one(x["vehicle"])},
        u={"vehicle": one(u["vehicle"]), "avionics": avionics.init_u()},
        s={"vehicle": one(s["vehicle"]), "avionics": avionics.init_s(),
           "terminated": torch.tensor(bool(s["terminated"]))})
    return tree_map(lambda l: l.to(device), state)


# ------------------------------------------------------------ on estimates

def mission_nav_avionics(phases, gains=None, *, dt=0.02, nav_kw=None,
                         device, dtype):
    """The navigation avionics around the mission's phase machine over the
    C172Xv2's guidance and control laws, the radar altimeter aiding
    (`c172_demos.py:413-429`): the phases, the guidance and the control
    laws read the filter's estimates; the weight on wheels and the engine's
    state stay the truth's. `nav_kw` more settings of `NavAvionics`."""
    from flightjax_torch.physics.navigation import NavAvionics
    kw = {"use_radar": True, **(nav_kw or {})}
    return NavAvionics(mission_avionics(phases, gains, device=device,
                                        dtype=dtype),
                       dt=dt, device=device, dtype=dtype, **kw)


def mission_nav_aircraft(phases, gains=None, *, dt=0.02, nav_kw=None,
                         device, dtype, turbulence=None):
    """The sensor-fed mission's aircraft over the runway-elevation terrain,
    in Dryden `turbulence` if given (as `mission_aircraft` takes it)."""
    vehicle = c172x.build_vehicle(device=device, dtype=dtype,
                                  terrain=HorizontalTerrain(
                                      H_LOWS15, device=device, dtype=dtype),
                                  turbulence=turbulence)
    return Aircraft(vehicle, avionics=mission_nav_avionics(
        phases, gains, dt=dt, nav_kw=nav_kw, device=device, dtype=dtype))


def mission_nav_world(phases, gains=None, *, dt=0.02, nav_kw=None, device,
                      dtype, turbulence=None):
    """`_mission_world_nav` (`c172_demos.py:413-429`), on
    `build_vehicle(turbulence=)` if `turbulence` is given."""
    return SimpleWorld(mission_nav_aircraft(phases, gains, dt=dt,
                                            nav_kw=nav_kw, device=device,
                                            dtype=dtype,
                                            turbulence=turbulence))


def mission_nav_sim(phases, gains=None, *, dt=0.02, nav_kw=None,
                    device="cuda", dtype=torch.float32, turbulence=None):
    """The Simulation of the sensor-fed mission world as the demos fly it:
    dt = periodic_dt (the sensors' and the filter's rate), the geoid
    refreshed every step (the Simulation's default), the position
    Kahan-compensated in sub-float64 dtypes (`with_compensation`), in
    Dryden `turbulence` if given. The entry points default to the card."""
    return Simulation(mission_nav_world(phases, gains, dt=dt, nav_kw=nav_kw,
                                        device=device, dtype=dtype,
                                        turbulence=turbulence),
                      dt=dt, periodic_dt=dt)


def _with_seed(state, seed):
    av = state.u["avionics"]
    sens = dict(av["sens"], seed=torch.as_tensor(
        seed, dtype=torch.int32, device=av["sens"]["seed"].device).expand_as(
            av["sens"]["seed"]).clone())
    return state._replace(u=dict(state.u, avionics=dict(av, sens=sens)))


def landing_nav_state(dtype, device, phases=None, *, s_togo=1500.0,
                      wind_E=6.0, seed=0, nav_kw=None, dt=0.02,
                      turbulence=None):
    """One aircraft of the sensor-fed landing (`c172_demos.py:467-482`):
    the trim `s_togo` m up the final leg (EAS 30 m/s, -3 deg, full flaps,
    half fuel; the state `tools/export_torch_c172x.py landing_nav` writes,
    at LANDING_NAV_S_TOGO), the avionics started by `NavAvionics.
    init_from_trim` (the phase machine in its first phase at clock 0, the
    filter aligned at the trim), an easterly wind of `wind_E` m/s, the
    sensors' stream seeded `seed`; `phases` default
    `crosswind_landing_nav_phases()`; in Dryden `turbulence` if given (the
    trim without the gusts, the turbulence's initial trees)."""
    if abs(float(s_togo) - LANDING_NAV_S_TOGO) > 1e-9:
        raise ValueError(f"the sensor-fed landing's trim is stored at "
                         f"s_togo = {LANDING_NAV_S_TOGO} m, not {s_togo}")
    phases = crosswind_landing_nav_phases() if phases is None else phases
    st = c172x.trimmed_xv1_state(
        dt, dtype, device, path=LANDING_NAV_NPZ,
        build=lambda **kw: mission_nav_aircraft(phases, dt=dt, nav_kw=nav_kw,
                                                **kw),
        turbulence=turbulence)
    uv = st.u["vehicle"]
    atm = dict(uv["atm"], wind=torch.tensor([0.0, float(wind_E), 0.0],
                                            dtype=dtype, device=device))
    st = st._replace(u=dict(st.u, vehicle=dict(uv, atm=atm)))
    return _with_seed(st, seed)


def runway_nav_state(dtype, device, phases=None, *, seed=0, nav_kw=None,
                     dt=0.02, turbulence=None):
    """One aircraft of the sensor-fed takeoff (`c172_demos.py:520-527`):
    cold on the runway 15 threshold (`runway_state`'s vehicle), the
    navigation avionics as built (the phase machine in its first phase at
    clock 0) and aligned on the parked truth (`NavAvionics.align_cold`),
    the sensors' stream seeded `seed`; `phases` default
    `takeoff_nav_phases()`. A fleet of such aircraft shares the parked
    truth, so one alignment serves every lane and `seed` may be a per-lane
    array after `fleet.broadcast_state` (the seed is the only input of the
    alignment that differs). In Dryden `turbulence` if given, the state
    holding its initial trees."""
    phases = takeoff_nav_phases() if phases is None else phases
    x, u, s, _, _ = c172x.load_xv1_state(RUNWAY_NPZ)
    air = mission_nav_aircraft(phases, dt=dt, nav_kw=nav_kw, device="cpu",
                               dtype=dtype, turbulence=turbulence)
    one = lambda tree: tree_from_numpy(
        tree_map(lambda l: np.asarray(l)[None], tree), "cpu", dtype)
    xv, uv, sv = (one(t["vehicle"]) for t in (x, u, s))
    if turbulence is not None:
        like = xv["kinematics"]["h_e"]
        xv["turb"] = turbulence.init_x(like)
        uv["turb"] = turbulence.init_u(like)
        sv["turb"] = turbulence.init_s(like)
    nav = air.avionics
    av_u, av_s = nav.align_cold(nav.init_u((1,)), nav.init_s((1,)),
                                air.vehicle.output(xv, uv, sv), seed=seed)
    state = SimState(
        t=torch.tensor([0.0], dtype=dtype),
        i=torch.tensor([0], dtype=torch.int32),
        x={"vehicle": xv}, u={"vehicle": uv, "avionics": av_u},
        s={"vehicle": sv, "avionics": av_s,
           "terminated": torch.tensor([bool(s["terminated"])])})
    return tree_map(lambda l: l[0].to(device), state)
