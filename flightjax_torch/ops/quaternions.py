"""Quaternion algebra on batched tensors (port of
`flightjax/ops/quaternions.py`). Quaternions are `[..., 4]` = [re, i, j, k];
every formula keeps the reference's association order."""

import torch


def cross(a, b):
    """a × b over the last axis (the `jnp.cross` formula)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def dot(a, b):
    """Sequential inner product over the last axis of a 3- or 4-vector."""
    out = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        out = out + a[..., k] * b[..., k]
    return out


def qmul(q1, q2):
    """Hamilton product q1 ∘ q2."""
    r1, v1 = q1[..., 0], q1[..., 1:]
    r2, v2 = q2[..., 0], q2[..., 1:]
    re = r1 * r2 - dot(v1, v2)
    im = r1[..., None] * v2 + r2[..., None] * v1 + cross(v1, v2)
    return torch.cat([re[..., None], im], dim=-1)


def qconj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qrot(q, v):
    """v + 2 q_im × (q_re v + q_im × v): rotate v by unit quaternion q."""
    q_re = q[..., 0:1]
    q_im = q[..., 1:4]
    return v + 2.0 * cross(q_im, q_re * v + cross(q_im, v))


def qrot_inv(q, v):
    return qrot(qconj(q), v)


def qdt(q_ab, omega_ab_b):
    """0.5 q ∘ (0, ω) with the zero real part folded out."""
    r, v = q_ab[..., 0:1], q_ab[..., 1:4]
    re = -0.5 * dot(v, omega_ab_b)[..., None]
    im = 0.5 * (r * omega_ab_b + cross(v, omega_ab_b))
    return torch.cat([re, im], dim=-1)


def qmul_zpre(c2, s2, q):
    """[c2, 0, 0, s2] ∘ q from the half-angle cosine/sine."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([c2 * w - s2 * z, c2 * x - s2 * y,
                        c2 * y + s2 * x, c2 * z + s2 * w], dim=-1)


def qmul_zpost(q, c2, s2):
    """q ∘ [c2, 0, 0, s2] from the half-angle cosine/sine."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([w * c2 - z * s2, x * c2 + y * s2,
                        y * c2 - x * s2, z * c2 + w * s2], dim=-1)


def rot2_z(c, s, v):
    """R_z(psi) · v from the full-angle cosine/sine."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)


def rot2_y(c, s, v):
    """R_y(theta) · v from the full-angle cosine/sine."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([x * c + z * s, y, -x * s + z * c], dim=-1)
