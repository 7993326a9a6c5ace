"""Vehicle / Aircraft / World scaffolding (port of
`flightjax/physics/aircraftbase.py:72-411`).

The update order kinematics -> air data -> systems -> dynamics of
`Vehicle.f_ode`, and the renorm -> systems step of `Vehicle.f_step`, are
carried out cluster by cluster in `parallel/clusterstep.py`. The carried
geoid undulation `s['geoid_N']` is refreshed by the fleet step on its
cadence (`refresh_geoid`, the `geoid` kernel on the card), the
deferred-geoid semantics of the JAX fleet step.

An aircraft's avionics run on the periodic pass (`Aircraft.f_periodic`):
they read the vehicle's outputs at the stepped state (`VehicleY`, which the
fleet step assembles from what its finish kernels store) and write the
systems' inputs.
"""

from typing import NamedTuple

from flightjax_torch.ops import geodesy as geo
from flightjax_torch.ops.quaternions import qrot_inv
from flightjax_torch.physics.atmosphere import SimpleAtmosphere, air_data
from flightjax_torch.physics.dynamics import VehicleDynamics


class VehicleY(NamedTuple):
    """Vehicle outputs (`aircraftbase.py:72-76`): `systems` a SystemsY,
    `kinematics` a KinData, `airflow` an AirData; `dynamics` is not
    assembled (None): no avionics of the port reads it."""
    systems: object
    kinematics: object
    dynamics: object
    airflow: object


class AircraftY(NamedTuple):
    """Aircraft outputs (`aircraftbase.py:296-298`)."""
    vehicle: VehicleY
    avionics: object


class Vehicle:
    """Systems + kinematics + dynamics, in an atmosphere over terrain;
    x = {kinematics, dynamics, systems}, u = {systems, atm, trn},
    s = {systems, geoid_N}. With a `turbulence` model (`physics/
    turbulence.py::DrydenTurbulence`) x, u and s also hold its trees under
    "turb" (`aircraftbase.py:121-165`)."""

    def __init__(self, systems, kinematics, terrain, *, device, dtype,
                 atmosphere=None, turbulence=None):
        self.systems = systems
        self.kinematics = kinematics
        self.dynamics = VehicleDynamics()
        self.atmosphere = atmosphere if atmosphere is not None \
            else SimpleAtmosphere()
        self.terrain = terrain
        self.turbulence = turbulence
        self.geoid = geo.geoid(device, dtype)

    def apply_disturbances(self, x_turb, u_turb, s_turb, t, kin, atm_data,
                           elevation, want_dot):
        """The atmospheric disturbance chain (`aircraftbase.py:167-192`):
        the mean wind shaped by the shear profile, then the Dryden and
        discrete gust superposed; the filters see the airspeed relative to
        the sheared mean wind and the height above the terrain's
        `elevation`. Returns (the disturbed AtmosphericData, the body-axes
        total wind for `air_data`, the filters' derivative or None)."""
        import torch

        from flightjax_torch.ops.quaternions import qrot
        from flightjax_torch.physics.atmosphere import norm3
        from flightjax_torch.physics.turbulence import shear_scale
        h_agl = kin.h_o - elevation
        k = shear_scale(u_turb, h_agl)
        v_mean = atm_data.v * torch.stack([k, k, torch.ones_like(k)], dim=-1)
        v_ew_b = qrot_inv(kin.q_nb, v_mean)
        V = norm3(kin.v_eb_b - v_ew_b)
        turb_dot = None
        if want_dot:
            turb_dot, gust_b = self.turbulence.f_ode(x_turb, u_turb, s_turb,
                                                     t, V, h_agl)
        else:
            gust_b = self.turbulence.gust(x_turb, u_turb, V, h_agl, t)
        atm2 = atm_data._replace(v=v_mean + qrot(kin.q_nb, gust_b))
        return atm2, v_ew_b + gust_b, turb_dot

    def refresh_geoid(self, x, s, plain=False):
        """The carried undulation refreshed under the WA position states:
        the `geoid` kernel on the card, `Geoid.height` on the CPU or with
        `plain`."""
        from flightjax_torch.parallel import kernels as K
        fn = K.geoid_plain if plain else K.geoid
        return dict(s, geoid_N=fn(self.geoid, x["kinematics"]["q_ew"]))

    def h_agl(self, x, u, s):
        """Ellipsoidal height of the body origin above the terrain."""
        trn = self.terrain.terrain_data(u["trn"])
        return x["kinematics"]["h_e"] - (trn.elevation + s["geoid_N"])

    def output(self, x, u, s, t=0.0):
        """VehicleY at the state (x, u, s) in plain PyTorch, the outputs of
        `Vehicle.f_ode` (`aircraftbase.py:215-241`) the avionics read: for
        set-up (the avionics' start from a trim) and the tests; the fleet
        step assembles it from its kernels' outputs. A turbulent vehicle's
        air data carries the gust at time `t`."""
        import torch

        from flightjax_torch.models.c172.common import (_alpha_gated,
                                                        systems_y)
        sys_ = self.systems
        _, kin = self.kinematics.f_ode(x["kinematics"], x["dynamics"],
                                       s["geoid_N"])
        atm_d = self.atmosphere.atmospheric_data(u["atm"], kin.n_e, kin.h_o)
        trn = self.terrain.terrain_data(u["trn"])
        v_ew_b = None
        if self.turbulence is not None:
            atm_d, v_ew_b, _ = self.apply_disturbances(
                x["turb"], u["turb"], s["turb"], t, kin, atm_d,
                trn.elevation, False)
        air = air_data(atm_d, kin, v_ew_b)
        alpha, beta, _ = _alpha_gated(air)
        steering = sys_.fin_act(u["systems"]["act"],
                                x["systems"].get("act"))["steering"]
        wow = torch.stack([sys_.ldg.strut_y_leg(j, steering[..., j], kin,
                                                trn).wow
                           for j in range(sys_.ldg.n)], dim=-1)
        return VehicleY(systems=systems_y(
            sys_, x["systems"], u["systems"], alpha, beta, wow,
            s["systems"]["pwp"]["engine"]["state"]),
                        kinematics=kin, dynamics=None, airflow=air)


class Aircraft:
    """Vehicle + avionics (`aircraftbase.py:301-365`); `avionics=None` is
    the reference's NoAvionics.

    Avionics protocol: `init_u()` / `init_s()`, `f_periodic(s_av, u_av,
    vehicle_y, dt) -> (s_av, av_y)` and `assign(u_systems, av_y) ->
    u_systems`; the avionics' trees are theirs (the C172Xv1's `ControlLaws`
    {lon, lat}, the C172Xv2's `c172x_gdc.Avionics` inputs {ctl: {lon,
    lat}, gdc: {...}} and state {ctl: {lon, lat}}). The avionics fly the
    fly-by-wire actuation, whose finish kernels store what they read.
    Avionics that read the terrain under the aircraft (`needs_terrain`, the
    navigation avionics' radar altimeter) also take its elevation, `h_trn`,
    and a VehicleY whose `dynamics` holds what the IMU reads
    (`aircraftbase.py:341-365`)."""

    def __init__(self, vehicle: Vehicle, avionics=None):
        if avionics is not None and not getattr(vehicle.systems.act,
                                                "stateful", False):
            raise NotImplementedError(
                "avionics fly the fly-by-wire actuation only")
        self.vehicle = vehicle
        self.avionics = avionics
        self.periodic_dt = 0.02  # set by Simulation

    def init_u(self, u_vehicle, shape=()):
        """The aircraft's inputs: the vehicle's (the port reads them from a
        trim point, `models/c172/*.npz`) and the avionics' initial ones for
        `shape` aircraft (`aircraftbase.py:319-323`)."""
        u = {"vehicle": u_vehicle}
        if self.avionics is not None:
            u["avionics"] = self.avionics.init_u(shape)
        return u

    def init_s(self, s_vehicle, shape=()):
        """The aircraft's discrete state, as `init_u` (`:325-330`)."""
        s = {"vehicle": s_vehicle}
        if self.avionics is not None:
            s["avionics"] = self.avionics.init_s(shape)
        return s

    def f_periodic(self, u, s, veh_y):
        """The avionics' periodic pass and its assignment
        (`aircraftbase.py:341-365`) on the vehicle outputs `veh_y` at the
        stepped state: returns the new (u, s); the continuous state is not
        touched."""
        if self.avionics is None:
            return u, s
        kw = {}
        if getattr(self.avionics, "needs_terrain", False):
            kw["h_trn"] = self.vehicle.terrain.terrain_data(
                u["vehicle"]["trn"]).elevation
        s_av, av_y = self.avionics.f_periodic(s["avionics"], u["avionics"],
                                              veh_y, self.periodic_dt, **kw)
        u_sys = self.avionics.assign(u["vehicle"]["systems"], av_y)
        return (dict(u, vehicle=dict(u["vehicle"], systems=u_sys)),
                dict(s, avionics=s_av))


class SimpleWorld:
    """Aircraft in an atmosphere over terrain plus the `terminated` latch
    (`aircraftbase.py:368-411`)."""

    def __init__(self, aircraft: Aircraft):
        self.aircraft = aircraft

    @property
    def periodic_dt(self):
        return self.aircraft.periodic_dt

    @periodic_dt.setter
    def periodic_dt(self, v):
        self.aircraft.periodic_dt = v

    def f_periodic(self, u, s, veh_y):
        """The aircraft's periodic pass; the `terminated` latch is kept
        (`aircraftbase.py:407-411`)."""
        u2, s2 = self.aircraft.f_periodic(u, s, veh_y)
        return u2, dict(s2, terminated=s["terminated"])
