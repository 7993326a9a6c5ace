"""WGS84 geodesy on batched tensors (port of the parts of
`flightjax/ops/geodesy.py` the fleet step uses). Constants are the JAX
package's, evaluated in the same Python-float order."""

import os

import numpy as np
import torch

from flightjax_torch.core.modeling import rdiv
from flightjax_torch.ops.interp import RowLookup

GM = 3.986005e14
a = 6378137.0
f = 1 / 298.257223563
omega_ie = 7.292115e-05

b = a * (1 - f)
e2 = 2 * f - f**2
a2 = a**2
m_g = omega_ie**2 * a**2 * b / GM

g_a = 9.7803253359
g_b = 9.8321849378
k_g = b * g_b / (a * g_a) - 1

# the EGM96 15-arcmin grid shipped with the JAX package, read in place
EGM96_PATH = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                          "flightjax", "data", "egm96_ww15mgh.npz")


def latlon_from_nvector(n_e):
    lat = torch.atan2(n_e[..., 2], torch.sqrt(n_e[..., 0] * n_e[..., 0]
                                              + n_e[..., 1] * n_e[..., 1]))
    lon = torch.atan2(n_e[..., 1], n_e[..., 0])
    return lat, lon


def nvector_from_qew(q_ew):
    """Minus the third column of R_ew."""
    q1, q2, q3, q4 = q_ew[..., 0], q_ew[..., 1], q_ew[..., 2], q_ew[..., 3]
    dq12 = 2 * q1 * q2
    dq13 = 2 * q1 * q3
    dq24 = 2 * q2 * q4
    dq34 = 2 * q3 * q4
    return -torch.stack([dq24 + dq13, dq34 - dq12,
                         1 - 2 * (q2 * q2 + q3 * q3)], dim=-1)


def radii(n_e):
    den = torch.sqrt(1 - e2 * (n_e[..., 2] * n_e[..., 2]))
    M = rdiv(a * (1 - e2), den * den * den)
    N = rdiv(a, den)
    return M, N


def get_psi_nw_ab(q_ew):
    """(A, B) with the wander angle psi_nw = atan2(A, B)."""
    q1, q2, q3, q4 = q_ew[..., 0], q_ew[..., 1], q_ew[..., 2], q_ew[..., 3]
    dq12 = 2 * q1 * q2
    dq13 = 2 * q1 * q3
    dq24 = 2 * q2 * q4
    dq34 = 2 * q3 * q4
    return -(dq34 + dq12), dq24 - dq13


class Geoid:
    """EGM96 undulation over (lat, lon in [0, 2pi]), bilinear, flat at the
    grid edge (queries are always in range, where flat equals the
    reference's Line())."""

    def __init__(self, *, device, dtype):
        with np.load(EGM96_PATH) as z:
            data = z["geoid_height"].astype(np.float64)
        lat_ax = np.linspace(-np.pi / 2, np.pi / 2, data.shape[0])
        lon_ax = np.linspace(0.0, 2 * np.pi, data.shape[1])
        self.lookup = RowLookup((lat_ax, lon_ax), data, device=device,
                                dtype=dtype)

    def height(self, n_e):
        lat, lon = latlon_from_nvector(n_e)
        lon = torch.remainder(lon + 2 * np.pi, 2 * np.pi)
        return self.lookup(lat, lon)


_GEOIDS = {}


def geoid(device, dtype):
    """The EGM96 grid on `device` in `dtype`, loaded once per pair."""
    key = (torch.device(device), dtype)
    if key not in _GEOIDS:
        _GEOIDS[key] = Geoid(device=device, dtype=dtype)
    return _GEOIDS[key]


def geoid_height(n_e):
    return geoid(n_e.device, n_e.dtype).height(n_e)


def geop_from_orth(h_orth):
    return h_orth * a / (a + h_orth)


def orth_from_geop(h_geop):
    return h_geop * a / (a - h_geop)


def orth_from_ellip(h_ellip, n_e):
    return h_ellip - geoid_height(n_e)


def cartesian_from_geographic(n_e, h_ellip):
    _, N = radii(n_e)
    return torch.stack([(N + h_ellip) * n_e[..., 0],
                        (N + h_ellip) * n_e[..., 1],
                        (N * (1 - e2) + h_ellip) * n_e[..., 2]], dim=-1)


def geographic_from_cartesian(r_e):
    """(n-vector, ellipsoidal altitude) from ECEF position: Fukushima's
    closed form with a Halley step, in units of the semi-major axis."""
    inv_a = 1.0 / a
    x, y, z = r_e[..., 0] * inv_a, r_e[..., 1] * inv_a, r_e[..., 2] * inv_a
    p = torch.sqrt(x * x + y * y)

    c = e2
    ec2 = 1 - e2
    ec = float(np.sqrt(ec2))
    zc = ec * torch.abs(z)

    s0 = torch.abs(z)
    c0 = ec * p
    a0 = torch.sqrt(s0 * s0 + c0 * c0)
    a03 = a0 * (a0 * a0)
    b0 = 1.5 * c * s0 * c0 * ((p * s0 - zc * c0) * a0 - c * s0 * c0)
    s1 = (zc * a03 + c * (s0 * (s0 * s0))) * a03 - b0 * s0
    c1 = (p * a03 - c * (c0 * (c0 * c0))) * a03 - b0 * c0

    cc = ec * c1
    s1sq = s1 * s1
    ccsq = cc * cc
    h = a * (p * cc + s0 * s1 - torch.sqrt(ec2 * s1sq + ccsq)) \
        / torch.sqrt(s1sq + ccsq)

    safe_cc = torch.where(cc != 0, cc, torch.ones_like(cc))
    abs_tan = s1 / safe_cc
    cos_lo = 1.0 / torch.sqrt(1 + abs_tan * abs_tan)
    sin_lo = abs_tan * cos_lo * torch.sign(z)
    safe_s1 = torch.where(s1 != 0, s1, torch.ones_like(s1))
    abs_cot = cc / safe_s1
    abs_sin_hi = 1.0 / torch.sqrt(1 + abs_cot * abs_cot)
    cos_hi = abs_cot * abs_sin_hi
    sin_hi = abs_sin_hi * torch.sign(z)

    lo = s1 < cc
    cos_lat = torch.where(lo, cos_lo, cos_hi)
    sin_lat = torch.where(lo, sin_lo, sin_hi)

    pos = p > 0
    p_safe = torch.where(pos, p, torch.ones_like(p))
    cos_lon = torch.where(pos, x / p_safe, torch.ones_like(p))
    sin_lon = torch.where(pos, y / p_safe, torch.zeros_like(p))
    n_e = torch.stack([cos_lat * cos_lon, cos_lat * sin_lon, sin_lat], dim=-1)
    return n_e, h


def gravity(n_e, h_ellip):
    """Somigliana normal gravity with the second-order altitude term."""
    h = h_ellip
    sin2 = n_e[..., 2] * n_e[..., 2]
    g0 = g_a * (1 + k_g * sin2) / torch.sqrt(1 - e2 * sin2)
    return g0 * (1 - 2 / a * (1 + f + m_g - 2 * f * sin2) * h
                 + 3 / a2 * h * h)
