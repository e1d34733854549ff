"""SO(3) and SE(3) operations in torch float32.

Port of `orbslam2_nmi_tpu/geometry/se3.py` without Sim(3) (it comes with loop
closing). Rotations are 3x3 matrices or quaternions [w, x, y, z] (Hamilton);
poses Tcw are 4x4 world->camera transforms; SE(3) tangents are [rho, phi] =
[translation, rotation], as in g2o.

Pose math stays in full float32: no TF32, no bf16. The functions the
tracking front-end reaches (`so3_log`, the quaternions, `se3_exp`, `se3_log`,
`mm`) take their small matrix products as elementwise products and sums
(`mm`), which no global flag can send through TF32, so a caller who turns
TF32 on gets the same poses. `se3_log` solves with `solve_ex`, which does
not wait on the device for an error check.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matrix product [..., m, k] x [..., k, n] in plain float32,
    as an elementwise product summed over k (for small matrices only)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product [..., m, k] x [..., k] in plain float32."""
    return (a * v[..., None, :]).sum(-1)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched over leading dims)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle 3-vector -> 3x3 rotation. Safe at ||w|| -> 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * torch.matmul(W, W)


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 from 3x3 R and 3-vector t. Batched."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device: a copy from the host would wait on it
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_se3(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to 3-points ([..., 3])."""
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, B)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> axis-angle 3-vector. Safe near identity and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    # vee of the antisymmetric part; |v| = 2 sin(theta)
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    sin_theta = 0.5 * torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)
    # the atan2 form is well-conditioned over the whole range except theta ~ pi
    theta = torch.atan2(sin_theta, cos_theta)
    small = sin_theta < 1e-5
    near_pi = small & (cos_theta < 0.0)
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        0.5 * theta / torch.where(small, torch.ones_like(sin_theta), sin_theta))
    w_generic = v * scale[..., None]
    # near pi: the axis from the diagonal, its signs from the off-diagonals
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp(
        (diag - cos_theta[..., None]) / torch.clamp(1.0 - cos_theta[..., None], min=_EPS), min=0.0)
    axis = torch.sqrt(axis_sq + 1e-24)
    axis = axis * torch.where(v >= 0, 1.0, -1.0)
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=_EPS)
    return torch.where(near_pi[..., None], axis * theta[..., None], w_generic)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion [w, x, y, z], branchless (Shepperd's
    method), with the canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2

    s = root(tr + 1.0)
    c0 = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], dim=-1)
    s = root(1.0 + m00 - m11 - m22)
    c1 = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], dim=-1)
    s = root(1.0 + m11 - m00 - m22)
    c2 = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], dim=-1)
    s = root(1.0 + m22 - m00 - m11)
    c3 = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], dim=-1)
    use0 = tr > 0
    use1 = ~use0 & (m00 >= m11) & (m00 >= m22)
    use2 = ~use0 & ~use1 & (m11 >= m22)
    q = torch.where(use0[..., None], c0,
                    torch.where(use1[..., None], c1, torch.where(use2[..., None], c2, c3)))
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _exp_coefficients(theta2: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2, (1 - sin t / t) / t^2), Taylor-safe."""
    theta = torch.sqrt(theta2 + _EPS)
    big = theta2 > _EPS
    a = torch.where(big, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(theta)) / theta2, 0.5 - theta2 / 24.0)
    return theta, big, a, b


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent [rho, phi] -> 4x4 (g2o SE3Quat::exp ordering: trans first)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    theta2 = torch.sum(phi * phi, dim=-1)
    _, big, a, b = _exp_coefficients(theta2)
    c = torch.where(big, (1.0 - a) / theta2, 1.0 / 6.0 - theta2 / 120.0)
    W = hat(phi)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return make_se3(R, mv(V, rho))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 -> [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    theta2 = torch.sum(phi * phi, dim=-1)
    theta, big, _, b = _exp_coefficients(theta2)
    c = torch.where(big, (1.0 - torch.sin(theta) / theta) / theta2, 1.0 / 6.0)
    W = hat(phi)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    rho = torch.linalg.solve_ex(V, T[..., :3, 3:4])[0][..., 0]
    return torch.cat([rho, phi], dim=-1)
