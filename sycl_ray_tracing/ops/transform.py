"""4x4 row-major homogeneous transforms.

Capability parity with the reference's gkit Transform (include/mat.h,
source/mat.cpp): identity, translation, rotations (X/Y/Z/axis), lookat,
composition, inverse, and application to points (homogeneous divide,
mat.cpp:94-111) and to directions (no translation, mat.cpp:113-126).

Everything is a plain [4,4] float32 jnp array so transforms are themselves
differentiable parameters (e.g. camera pose gradients).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sycl_ray_tracing.ops.safe_math import normalize


def identity() -> jnp.ndarray:
    return jnp.eye(4, dtype=jnp.float32)


def translation(x, y, z) -> jnp.ndarray:
    t = jnp.stack([jnp.asarray(x, jnp.float32),
                   jnp.asarray(y, jnp.float32),
                   jnp.asarray(z, jnp.float32)])
    m = jnp.eye(4, dtype=jnp.float32)
    return m.at[:3, 3].set(t)


def _rot(c, s, axis: int) -> jnp.ndarray:
    c = jnp.asarray(c, jnp.float32)
    s = jnp.asarray(s, jnp.float32)
    m = jnp.eye(4, dtype=jnp.float32)
    if axis == 0:    # X (mat.cpp:210-220)
        m = m.at[1, 1].set(c).at[1, 2].set(-s).at[2, 1].set(s).at[2, 2].set(c)
    elif axis == 1:  # Y (mat.cpp:222-232)
        m = m.at[0, 0].set(c).at[0, 2].set(s).at[2, 0].set(-s).at[2, 2].set(c)
    else:            # Z (mat.cpp:234-244)
        m = m.at[0, 0].set(c).at[0, 1].set(-s).at[1, 0].set(s).at[1, 1].set(c)
    return m


def rotation_x(deg) -> jnp.ndarray:
    r = jnp.deg2rad(jnp.asarray(deg, jnp.float32))
    return _rot(jnp.cos(r), jnp.sin(r), 0)


def rotation_y(deg) -> jnp.ndarray:
    r = jnp.deg2rad(jnp.asarray(deg, jnp.float32))
    return _rot(jnp.cos(r), jnp.sin(r), 1)


def rotation_z(deg) -> jnp.ndarray:
    r = jnp.deg2rad(jnp.asarray(deg, jnp.float32))
    return _rot(jnp.cos(r), jnp.sin(r), 2)


def rotation_axis(axis, deg) -> jnp.ndarray:
    """Rotation about an arbitrary axis (mat.cpp:246-276 semantics)."""
    a = normalize(jnp.asarray(axis, jnp.float32))
    r = jnp.deg2rad(jnp.asarray(deg, jnp.float32))
    c, s = jnp.cos(r), jnp.sin(r)
    x, y, z = a[0], a[1], a[2]
    m = jnp.array(
        [
            [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0.0],
            [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s, 0.0],
            [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=jnp.float32,
    )
    return m


def lookat(eye, target, up) -> jnp.ndarray:
    """Camera-to-world transform looking from eye to target (mat.cpp:349+)."""
    eye = jnp.asarray(eye, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    d = normalize(target - eye)          # forward
    r = normalize(jnp.cross(d, up))      # right
    u = normalize(jnp.cross(r, d))       # true up
    # columns: right, up, -forward, eye — standard camera frame
    cols = jnp.stack([r, u, -d, eye], axis=1)
    return jnp.eye(4, dtype=jnp.float32).at[:3, :4].set(cols)


def scale(x, y=None, z=None) -> jnp.ndarray:
    """Scale transform (mat.cpp Scale); scale(s) = uniform."""
    if y is None:
        y = x
    if z is None:
        z = x
    return jnp.diag(
        jnp.array(
            [float(x) if not hasattr(x, "shape") else x,
             float(y) if not hasattr(y, "shape") else y,
             float(z) if not hasattr(z, "shape") else z,
             1.0],
            jnp.float32,
        )
    )


def perspective(fov_degrees: float, aspect: float, znear: float,
                zfar: float) -> jnp.ndarray:
    """Perspective projection (mat.cpp Perspective, gkit convention)."""
    import math

    itan = 1.0 / math.tan(math.radians(fov_degrees) * 0.5)
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(itan / aspect)
    m = m.at[1, 1].set(itan)
    m = m.at[2, 2].set(-(zfar + znear) / (zfar - znear))
    m = m.at[2, 3].set(-2.0 * zfar * znear / (zfar - znear))
    m = m.at[3, 2].set(-1.0)
    return m


def orthographic(left: float, right: float, bottom: float, top: float,
                 znear: float, zfar: float) -> jnp.ndarray:
    """Orthographic projection (mat.cpp Ortho)."""
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, 0].set(2.0 / (right - left))
    m = m.at[1, 1].set(2.0 / (top - bottom))
    m = m.at[2, 2].set(-2.0 / (zfar - znear))
    m = m.at[0, 3].set(-(right + left) / (right - left))
    m = m.at[1, 3].set(-(top + bottom) / (top - bottom))
    m = m.at[2, 3].set(-(zfar + znear) / (zfar - znear))
    return m


def viewport(width: float, height: float) -> jnp.ndarray:
    """NDC -> pixel viewport transform (mat.cpp Viewport)."""
    w = width / 2.0
    h = height / 2.0
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, 0].set(w).at[0, 3].set(w)
    m = m.at[1, 1].set(h).at[1, 3].set(h)
    m = m.at[2, 2].set(0.5).at[2, 3].set(0.5)
    return m


# float32 products at full precision: GPUs may otherwise run them in TF32
# (~10 mantissa bits), which moves ray origins, directions and pose
# gradients away from the CPU results
_HIGHEST = jax.lax.Precision.HIGHEST


def compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a @ b: apply ``b`` first, then ``a`` (row-major like mat.h)."""
    return jnp.matmul(a, b, precision=_HIGHEST)


def inverse(m: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.inv(m).astype(jnp.float32)


def apply_point(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Transform points [...,3] with homogeneous divide (mat.cpp:94-111)."""
    xyz = jnp.matmul(p, m[:3, :3].T, precision=_HIGHEST) + m[:3, 3]
    w = jnp.matmul(p, m[3, :3], precision=_HIGHEST) + m[3, 3]
    return xyz / w[..., None]


def apply_vector(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Transform directions [...,3]: rotation/scale only (mat.cpp:113-126)."""
    return jnp.matmul(v, m[:3, :3].T, precision=_HIGHEST)
