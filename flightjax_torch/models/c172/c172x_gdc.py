"""C172X guidance laws: segment and loiter guidance commanding the control
laws (port of `flightjax/models/c172/c172x_gdc.py`, the whole of it).

- `Segment` between two geographic points and the segment-relative data
  (along- and cross-track distances, vertical deviation, course and slope);
- `Circle` and the circle-relative data of the loiter law;
- `GuidanceLaws`: the intercept laws dchi = -dchi_inf (2 / pi) atan(e /
  e_sf) onto the segment's course or the circle's tangent, the vertical
  reference from the segment or the circle, gated by the cross-track
  threshold, and the mode machine direct / segment / circular, which
  overrides the control laws' lateral and longitudinal requests;
- `Avionics`: the C172Xv2's avionics, the guidance run first and then
  `ControlLaws` on the requests it overrides.

Leaves are fleet-shaped (a leading batch axis) or unbatched for one
aircraft; `GuidanceLaws` works out both the segment and the circle branch on
every lane and selects, as the JAX package does. On the card the pass runs
as the `gdc_ctl_laws` kernel after the splits' steps and inside the
`megakernel_gdc` step (`csrc/c172x_gdc.cuh`).
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from flightjax_torch.core.modeling import divc
from flightjax_torch.models.c172 import c172x_ctl as CTL
from flightjax_torch.ops import geodesy as geo
from flightjax_torch.ops.attitude import wrap_to_pi
from flightjax_torch.ops.quaternions import qrot, qrot_inv

GDC_DIRECT, GDC_SEGMENT, GDC_CIRCULAR = 0, 1, 2


def _t(v, device, dtype):
    return torch.as_tensor(np.asarray(v, dtype=np.float64)).to(
        device=device, dtype=dtype)


class Segment(NamedTuple):
    """Two geographic endpoints (n-vector and ellipsoidal altitude)."""
    n_e1: torch.Tensor
    h_e1: torch.Tensor
    n_e2: torch.Tensor
    h_e2: torch.Tensor


def segment(lat1, lon1, h1, lat2, lon2, h2, *, device="cpu",
            dtype=torch.float64):
    """The segment between (lat1, lon1, h1) and (lat2, lon2, h2); numbers
    or arrays of one shape (a fleet of segments)."""
    t = lambda v: _t(v, device, dtype)
    return Segment(n_e1=geo.nvector_from_latlon(t(lat1), t(lon1)), h_e1=t(h1),
                   n_e2=geo.nvector_from_latlon(t(lat2), t(lon2)), h_e2=t(h2))


def segment_from_vector(lat1, lon1, h1, chi, s, gamma=None, dh=None, *,
                        device="cpu", dtype=torch.float64):
    """The segment from an origin along course chi over horizontal length
    s, rising by dh (or at slope gamma), `c172x_gdc.jl:62-88`. Worked out
    in float64 on the CPU, then made in `dtype` on `device`; numbers or
    arrays of one shape."""
    if dh is None:
        dh = np.asarray(s) * np.tan(gamma)
    f = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    n_e1 = geo.nvector_from_latlon(f(lat1), f(lon1))
    chi, s = f(chi), f(s)
    r_12_n = torch.stack([s * torch.cos(chi), s * torch.sin(chi),
                          torch.zeros_like(s)], dim=-1)
    r_e2_e = geo.cartesian_from_geographic(n_e1, f(h1)) + qrot(geo.ltf(n_e1),
                                                               r_12_n)
    n_e2, _ = geo.geographic_from_cartesian(r_e2_e)
    lat2, lon2 = geo.latlon_from_nvector(n_e2)
    return segment(lat1, lon1, h1, lat2.numpy(), lon2.numpy(),
                   np.asarray(h1, dtype=np.float64) + dh, device=device,
                   dtype=dtype)


def reversed_segment(seg: Segment) -> Segment:
    """The endpoints swapped: the reference's unary `-Segment`
    (`c172x_gdc.jl:92-94`), for approach legs that end at a point."""
    return Segment(n_e1=seg.n_e2, h_e1=seg.h_e2, n_e2=seg.n_e1,
                   h_e2=seg.h_e1)


def segment_latlon(n_e):
    """Host-side (lat, lon) floats of one segment endpoint's n-vector."""
    lat, lon = geo.latlon_from_nvector(n_e)
    return float(lat), float(lon)


class SegmentData(NamedTuple):
    """Segment-relative coordinates (`c172x_gdc.jl:102-148`)."""
    chi_12: torch.Tensor
    gamma_12: torch.Tensor
    s_12: torch.Tensor
    s_1b: torch.Tensor
    s_2b: torch.Tensor
    e_sb: torch.Tensor
    v_sb: torch.Tensor
    h_s: torch.Tensor


def _horizontal(q_en, r):
    """The north and east components of r (ECEF) in the NED frame q_en: the
    local horizontal, the down component dropped."""
    r_n = qrot_inv(q_en, r)
    return r_n[..., 0], r_n[..., 1]


def segment_data(seg: Segment, n_e_b, h_e_b) -> SegmentData:
    r_e1 = geo.cartesian_from_geographic(seg.n_e1, seg.h_e1)
    r_e2 = geo.cartesian_from_geographic(seg.n_e2, seg.h_e2)
    r_eb = geo.cartesian_from_geographic(n_e_b, h_e_b)
    q_en = geo.ltf(n_e_b)
    b_x, b_y = _horizontal(q_en, r_eb - r_e1)
    d_x, d_y = _horizontal(q_en, r_e2 - r_e1)

    s_12 = torch.sqrt(d_x * d_x + d_y * d_y + 1e-12)
    u_x, u_y = d_x / s_12, d_y / s_12
    s_1b = u_x * b_x + u_y * b_y
    s_2b = s_1b - s_12
    e_sb = u_x * b_y - u_y * b_x

    h_s = seg.h_e1 + (seg.h_e2 - seg.h_e1) * s_1b / s_12
    v_sb = h_e_b - h_s
    chi_12 = torch.atan2(u_y, u_x)
    gamma_12 = torch.atan2(seg.h_e2 - seg.h_e1, s_12)
    return SegmentData(chi_12=chi_12, gamma_12=gamma_12, s_12=s_12,
                       s_1b=s_1b, s_2b=s_2b, e_sb=e_sb, v_sb=v_sb, h_s=h_s)


class Circle(NamedTuple):
    """Loiter circle: geographic center, radius and turn direction (+1
    clockwise seen from above, a right-hand orbit; -1 counter-clockwise)."""
    n_e: torch.Tensor
    h_e: torch.Tensor
    radius: torch.Tensor
    turn_dir: torch.Tensor


def circle(lat, lon, h, radius, turn_dir=1.0, *, device="cpu",
           dtype=torch.float64):
    t = lambda v: _t(v, device, dtype)
    return Circle(n_e=geo.nvector_from_latlon(t(lat), t(lon)), h_e=t(h),
                  radius=t(radius), turn_dir=t(turn_dir))


class CircleData(NamedTuple):
    """Circle-relative coordinates: the bearing of the vehicle from the
    center `sigma`, the horizontal center distance `d_cb`, the radial
    (cross-track) error `e_cb = d_cb - radius` (positive outside), the
    vertical deviation `v_cb` and the local tangent course `chi_tan`."""
    sigma: torch.Tensor
    d_cb: torch.Tensor
    e_cb: torch.Tensor
    v_cb: torch.Tensor
    chi_tan: torch.Tensor


def circle_data(crc: Circle, n_e_b, h_e_b) -> CircleData:
    """The vehicle in circle coordinates, through the same local NED
    projection as `segment_data`."""
    r_ec = geo.cartesian_from_geographic(crc.n_e, crc.h_e)
    r_eb = geo.cartesian_from_geographic(n_e_b, h_e_b)
    c_x, c_y = _horizontal(geo.ltf(n_e_b), r_eb - r_ec)
    d_cb = torch.sqrt(c_x * c_x + c_y * c_y + 1e-12)
    sigma = torch.atan2(c_y, c_x)
    chi_tan = wrap_to_pi(sigma + crc.turn_dir * (math.pi / 2))
    return CircleData(sigma=sigma, d_cb=d_cb, e_cb=d_cb - crc.radius,
                      v_cb=h_e_b - crc.h_e, chi_tan=chi_tan)


class GdcY(NamedTuple):
    mode: torch.Tensor
    data: SegmentData
    crc_data: CircleData
    dchi: torch.Tensor
    chi_ref: torch.Tensor
    h_ref: torch.Tensor
    hor_gdc: torch.Tensor
    vrt_gdc: torch.Tensor


class GuidanceLaws:
    """The segment and circular guidance (`c172x_gdc.jl:226-338`; the
    reference's CircularGuidance is an empty stub, here it is a loiter
    law). `device` and `dtype` type the inputs it makes."""

    DCHI_INF = np.pi / 2  # intercept angle at infinite cross-track error
    E_SF = 250.0          # cross-track scaling (m)
    E_THR = 1000.0        # cross-track gate of the vertical guidance (m)

    def __init__(self, *, device, dtype):
        self.device, self.dtype = torch.device(device), dtype

    def init_u(self, shape=()):
        """The inputs of `shape` aircraft (`c172x_gdc.py:173-180`)."""
        kw = dict(device=self.device, dtype=self.dtype)
        seg = segment(0.0, 0.0, 0.0, 1e-3, 0.0, 0.0, **kw)
        crc = circle(0.0, 0.0, 0.0, 1000.0, **kw)
        grow = lambda tree: type(tree)(*(
            v.expand(shape + v.shape).clone() for v in tree))
        return {
            "mode_req": torch.full(shape, GDC_DIRECT, dtype=torch.int32,
                                   device=self.device),
            "target": grow(seg), "orbit": grow(crc),
            "hor_gdc_req": torch.zeros(shape, dtype=torch.bool,
                                       device=self.device),
            "vrt_gdc_req": torch.zeros(shape, dtype=torch.bool,
                                       device=self.device),
        }

    def f_periodic(self, u, veh_y) -> GdcY:
        """The guidance references and activity flags (`c172x_gdc.jl:
        258-283, 297-329`). The sections marked `# ---- ` are what the
        kernels run per lane: the segment branch where the lane's mode is
        not circular, the circle branch where it is."""
        kin = veh_y.kinematics
        # ---- mode
        mode = torch.where(CTL.is_on_gnd(veh_y),
                           torch.full_like(u["mode_req"], GDC_DIRECT),
                           u["mode_req"]).to(torch.int32)
        crc_on = mode == GDC_CIRCULAR
        law_on = (mode == GDC_SEGMENT) | crc_on

        # ---- segment
        data = segment_data(u["target"], kin.n_e, kin.h_e)
        dchi = (-self.DCHI_INF / (np.pi / 2)) * torch.atan(
            divc(data.e_sb, self.E_SF))
        chi_seg = wrap_to_pi(data.chi_12 + dchi)

        # ---- circle
        # the course is the local tangent turned toward the circle by an
        # atan capture term: at e -> +inf it saturates at turn_dir pi / 2,
        # so chi_ref = sigma + turn_dir pi points at the center; at e = 0 it
        # is the tangent
        crc = u["orbit"]
        cdata = circle_data(crc, kin.n_e, kin.h_e)
        dchi_crc = divc(crc.turn_dir * self.DCHI_INF, np.pi / 2) * torch.atan(
            divc(cdata.e_cb, self.E_SF))
        chi_crc = wrap_to_pi(cdata.chi_tan + dchi_crc)

        # ---- select
        chi_ref = torch.where(crc_on, chi_crc, chi_seg)
        h_ref = torch.where(crc_on, torch.broadcast_to(crc.h_e, mode.shape),
                            data.h_s)
        e_lat = torch.where(crc_on, cdata.e_cb, data.e_sb)
        hor = law_on & u["hor_gdc_req"]
        vrt = law_on & u["vrt_gdc_req"] & (torch.abs(e_lat) < self.E_THR)
        return GdcY(mode=mode, data=data, crc_data=cdata,
                    dchi=torch.where(crc_on, dchi_crc, dchi),
                    chi_ref=chi_ref, h_ref=h_ref, hor_gdc=hor, vrt_gdc=vrt)

    def override_ctl_u(self, ctl_u, gdc_y: GdcY):
        """The guidance commands the control laws (`c172x_gdc.jl:301-312`):
        where the lateral guidance is on, course hold onto its course;
        where the vertical guidance is on, the altitude mode onto its
        altitude."""
        lat, lon = dict(ctl_u["lat"]), dict(ctl_u["lon"])
        hor, vrt = gdc_y.hor_gdc, gdc_y.vrt_gdc
        lat["chi_ref"] = torch.where(hor, gdc_y.chi_ref, lat["chi_ref"])
        lat["mode_req"] = torch.where(
            hor, torch.full_like(lat["mode_req"], CTL.LAT_CHI_BETA),
            lat["mode_req"]).to(torch.int32)
        lon["h_ref"] = torch.where(vrt, gdc_y.h_ref, lon["h_ref"])
        lon["mode_req"] = torch.where(
            vrt, torch.full_like(lon["mode_req"], CTL.LON_EAS_ALT),
            lon["mode_req"]).to(torch.int32)
        return dict(ctl_u, lat=lat, lon=lon)


class Avionics:
    """The C172Xv2's avionics: `GuidanceLaws` and `ControlLaws`, the
    guidance run first, overriding the control laws' requests
    (`c172x2.jl:18-42`). Inputs {ctl: {lon, lat}, gdc: {...}}, state {ctl:
    {lon, lat}}."""

    def __init__(self, gains=None, *, device, dtype):
        self.ctl = CTL.ControlLaws(gains, device=device, dtype=dtype)
        self.gdc = GuidanceLaws(device=device, dtype=dtype)

    def init_u(self, shape=()):
        return {"ctl": self.ctl.init_u(shape), "gdc": self.gdc.init_u(shape)}

    def init_s(self, shape=()):
        return {"ctl": self.ctl.init_s(shape)}

    def f_periodic(self, s, u, veh_y, dt):
        gdc_y = self.gdc.f_periodic(u["gdc"], veh_y)
        ctl_u = self.gdc.override_ctl_u(u["ctl"], gdc_y)
        s_ctl, ctl_y = self.ctl.f_periodic(s["ctl"], ctl_u, veh_y, dt)
        return {"ctl": s_ctl}, {"ctl": ctl_y, "gdc": gdc_y}

    def assign(self, u_systems, av_y):
        return self.ctl.assign(u_systems, av_y["ctl"])

    def output(self, s, u, veh_y):
        return self.ctl.output(s["ctl"], u["ctl"], veh_y)

    def init_from_trim(self, veh_y, dt):
        """The control laws' bumpless start, the guidance's inputs at their
        defaults (direct, nothing engaged)."""
        ctl_u, ctl_s = self.ctl.init_from_trim(veh_y, dt)
        shape = tuple(veh_y.airflow.EAS.shape)
        return ({"ctl": ctl_u, "gdc": self.gdc.init_u(shape)},
                {"ctl": ctl_s})
