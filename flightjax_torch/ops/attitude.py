"""Attitude conversions on batched tensors (port of the parts of
`flightjax/ops/attitude.py` the fleet step uses)."""

import math

import torch

from flightjax_torch.core.modeling import divc
from flightjax_torch.ops.quaternions import dot, qmul


def quat_to_matrix(q):
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    q = q / n
    q1, q2, q3, q4 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sq = q * q
    dq12 = 2 * q1 * q2
    dq13 = 2 * q1 * q3
    dq14 = 2 * q1 * q4
    dq23 = 2 * q2 * q3
    dq24 = 2 * q2 * q4
    dq34 = 2 * q3 * q4
    r00 = 1 - 2 * (sq[..., 2] + sq[..., 3])
    r11 = 1 - 2 * (sq[..., 1] + sq[..., 3])
    r22 = 1 - 2 * (sq[..., 1] + sq[..., 2])
    return torch.stack([
        torch.stack([r00, dq23 - dq14, dq24 + dq13], dim=-1),
        torch.stack([dq23 + dq14, r11, dq34 - dq12], dim=-1),
        torch.stack([dq24 - dq13, dq34 + dq12, r22], dim=-1)], dim=-2)


def matrix_to_quat(R):
    """Shepperd's method, largest-candidate selection."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c0 = 1 + tr
    c1 = 1 + 2 * R[..., 0, 0] - tr
    c2 = 1 + 2 * R[..., 1, 1] - tr
    c3 = 1 + 2 * R[..., 2, 2] - tr
    i_max = torch.argmax(torch.stack([c0, c1, c2, c3], dim=-1), dim=-1)
    v0 = torch.stack([c0, R[..., 2, 1] - R[..., 1, 2],
                      R[..., 0, 2] - R[..., 2, 0],
                      R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    v1 = torch.stack([R[..., 2, 1] - R[..., 1, 2], c1,
                      R[..., 0, 1] + R[..., 1, 0],
                      R[..., 2, 0] + R[..., 0, 2]], dim=-1)
    v2 = torch.stack([R[..., 0, 2] - R[..., 2, 0],
                      R[..., 0, 1] + R[..., 1, 0], c2,
                      R[..., 1, 2] + R[..., 2, 1]], dim=-1)
    v3 = torch.stack([R[..., 1, 0] - R[..., 0, 1],
                      R[..., 2, 0] + R[..., 0, 2],
                      R[..., 1, 2] + R[..., 2, 1], c3], dim=-1)
    im = i_max[..., None]
    v = torch.where(im == 0, v0, torch.where(
        im == 1, v1, torch.where(im == 2, v2, v3)))
    return v / torch.sqrt(dot(v, v))[..., None]


def half_angle_cs(c, s):
    """(cos psi/2, sin psi/2) from (cos psi, sin psi) by half-angle square
    roots; (c, s) = (-1, 0) gives (0, +1) like atan2's psi = +pi."""
    cpos = c >= 0
    a1 = torch.sqrt(torch.clamp_min((1.0 + c) * 0.5, 1e-30))
    a2 = torch.sqrt(torch.clamp_min((1.0 - c) * 0.5, 1e-30))
    c2 = torch.where(cpos, a1, torch.abs(s) / (2.0 * a2))
    s2 = torch.where(cpos, s / (2.0 * a1), torch.where(s < 0, -a2, a2))
    return c2, s2


def rot_x(phi):
    z = torch.zeros_like(phi)
    return torch.stack([torch.cos(0.5 * phi), torch.sin(0.5 * phi), z, z],
                       dim=-1)


def rot_y(theta):
    z = torch.zeros_like(theta)
    return torch.stack([torch.cos(0.5 * theta), z, torch.sin(0.5 * theta),
                        z], dim=-1)


def rot_z(psi):
    z = torch.zeros_like(psi)
    return torch.stack([torch.cos(0.5 * psi), z, z, torch.sin(0.5 * psi)],
                       dim=-1)


def euler_to_quat(euler):
    """[psi, theta, phi] ZYX -> Rz(psi) ∘ Ry(theta) ∘ Rx(phi)."""
    psi, theta, phi = euler[..., 0], euler[..., 1], euler[..., 2]
    return qmul(rot_z(psi), qmul(rot_y(theta), rot_x(phi)))


def quat_to_euler(q):
    q1, q2, q3, q4 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    psi = torch.atan2(2 * (q1 * q4 + q2 * q3), 1 - 2 * (q3 * q3 + q4 * q4))
    theta = torch.asin(torch.clamp(2 * (q1 * q3 - q2 * q4), -1.0, 1.0))
    phi = torch.atan2(2 * (q1 * q2 + q3 * q4), 1 - 2 * (q2 * q2 + q3 * q3))
    return torch.stack([psi, theta, phi], dim=-1)


def azimuth(v):
    return torch.atan2(v[..., 1], v[..., 0])


def inclination(v):
    return torch.atan2(-v[..., 2], torch.sqrt(v[..., 0] * v[..., 0]
                                              + v[..., 1] * v[..., 1]))


def wrap_to_pi(x):
    """x shifted by a multiple of 2 pi into (-pi, pi] (`attitude.py:235`),
    the quotient a true one."""
    return x + 2 * math.pi * torch.floor(divc(math.pi - x, 2 * math.pi))


def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1),
                        torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)
