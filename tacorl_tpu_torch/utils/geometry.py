"""SE(3) / frame helpers (a copy of tacorl_tpu/utils/geometry.py; reference:
utils/matrix_transforms.py:5-97), numpy only.

Used by the real-CALVIN adapter's ``rel_tcp`` action frame: a relative action
expressed in the TCP frame is rotated into the world frame before being
applied as a relative world action.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "euler_to_matrix",
    "matrix_to_euler",
    "quat_to_matrix",
    "to_world_frame",
]


def euler_to_matrix(euler: Sequence[float]) -> np.ndarray:
    """XYZ extrinsic Euler angles -> rotation matrix."""
    x, y, z = euler
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def matrix_to_euler(mat: np.ndarray) -> np.ndarray:
    """Rotation matrix -> XYZ extrinsic Euler angles."""
    sy = -mat[2, 0]
    cy = np.sqrt(max(0.0, 1.0 - sy * sy))
    if cy > 1e-6:
        x = np.arctan2(mat[2, 1], mat[2, 2])
        y = np.arcsin(np.clip(sy, -1.0, 1.0))
        z = np.arctan2(mat[1, 0], mat[0, 0])
    else:  # gimbal lock
        x = np.arctan2(-mat[1, 2], mat[1, 1])
        y = np.arcsin(np.clip(sy, -1.0, 1.0))
        z = 0.0
    return np.array([x, y, z])


def quat_to_matrix(quat: Sequence[float]) -> np.ndarray:
    """(x, y, z, w) quaternion -> rotation matrix."""
    x, y, z, w = quat
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def to_world_frame(
    rel_action_pos: np.ndarray,
    rel_action_orn: np.ndarray,
    tcp_orn: Sequence[float],
) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate a TCP-frame relative action into the world frame.

    ``tcp_orn`` may be an euler triple or an (x,y,z,w) quaternion."""
    tcp_orn = np.asarray(tcp_orn, dtype=np.float64)
    t_world_tcp = (
        quat_to_matrix(tcp_orn) if tcp_orn.shape[0] == 4 else euler_to_matrix(tcp_orn)
    )
    pos_w = t_world_tcp @ np.asarray(rel_action_pos, dtype=np.float64)
    rot = t_world_tcp @ euler_to_matrix(rel_action_orn) @ t_world_tcp.T
    orn_w = matrix_to_euler(rot)
    return pos_w, orn_w
