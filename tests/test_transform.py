"""Transforms: parity with the reference gkit matrix semantics (mat.cpp)."""

import jax.numpy as jnp
import numpy as np

from sycl_ray_tracing.ops import transform as T


def test_identity_apply():
    p = jnp.array([[1.0, 2.0, 3.0]])
    np.testing.assert_allclose(T.apply_point(T.identity(), p), p)
    np.testing.assert_allclose(T.apply_vector(T.identity(), p), p)


def test_translation_moves_points_not_vectors():
    m = T.translation(1.0, -2.0, 3.0)
    p = jnp.array([[0.0, 0.0, 0.0]])
    np.testing.assert_allclose(T.apply_point(m, p), [[1.0, -2.0, 3.0]])
    np.testing.assert_allclose(T.apply_vector(m, p + 1.0), [[1.0, 1.0, 1.0]])


def test_rotation_x_90():
    # RotationX(90): y -> z (mat.cpp:210-220 row-major convention)
    m = T.rotation_x(90.0)
    v = jnp.array([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(
        T.apply_vector(m, v), [[0.0, 0.0, 1.0]], atol=1e-6
    )


def test_rotation_y_90():
    # RotationY(90): z -> x
    m = T.rotation_y(90.0)
    v = jnp.array([[0.0, 0.0, 1.0]])
    np.testing.assert_allclose(
        T.apply_vector(m, v), [[1.0, 0.0, 0.0]], atol=1e-6
    )


def test_rotation_z_90():
    # RotationZ(90): x -> y
    m = T.rotation_z(90.0)
    v = jnp.array([[1.0, 0.0, 0.0]])
    np.testing.assert_allclose(
        T.apply_vector(m, v), [[0.0, 1.0, 0.0]], atol=1e-6
    )


def test_rotation_axis_matches_rotation_z():
    np.testing.assert_allclose(
        T.rotation_axis([0.0, 0.0, 1.0], 37.0), T.rotation_z(37.0), atol=1e-6
    )


def test_compose_order():
    # compose(a, b) applies b first: RotationX(-15) * Translation matches
    # the reference camera recipe (camera.cpp:5)
    m = T.compose(T.rotation_x(90.0), T.translation(0.0, 1.0, 0.0))
    p = jnp.array([[0.0, 0.0, 0.0]])
    # translate to (0,1,0), then rotate: y->z
    np.testing.assert_allclose(
        T.apply_point(m, p), [[0.0, 0.0, 1.0]], atol=1e-6
    )


def test_inverse():
    m = T.compose(T.rotation_x(33.0), T.translation(1.0, 2.0, 3.0))
    p = jnp.array([[0.3, -0.7, 2.0]])
    q = T.apply_point(T.inverse(m), T.apply_point(m, p))
    np.testing.assert_allclose(q, p, atol=1e-5)


def test_lookat_points_at_target():
    m = T.lookat([0.0, 0.0, 5.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    # camera-frame -Z axis (third column negated) points at target
    fwd = -np.asarray(m)[:3, 2]
    np.testing.assert_allclose(fwd, [0.0, 0.0, -1.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(m)[:3, 3], [0.0, 0.0, 5.0])


def test_homogeneous_divide():
    m = T.identity().at[3, 3].set(2.0)
    p = jnp.array([[2.0, 4.0, 6.0]])
    np.testing.assert_allclose(T.apply_point(m, p), [[1.0, 2.0, 3.0]])


def test_perspective_ortho_viewport():
    # perspective maps a point on the near plane to z_ndc = -1
    m = T.perspective(90.0, 1.0, 1.0, 10.0)
    p = jnp.array([[0.0, 0.0, -1.0]])
    np.testing.assert_allclose(T.apply_point(m, p)[0, 2], -1.0, atol=1e-5)
    p_far = jnp.array([[0.0, 0.0, -10.0]])
    np.testing.assert_allclose(T.apply_point(m, p_far)[0, 2], 1.0, atol=1e-5)

    o = T.orthographic(-2.0, 2.0, -1.0, 1.0, 0.0, 10.0)
    np.testing.assert_allclose(
        T.apply_point(o, jnp.array([[2.0, 1.0, -10.0]])),
        [[1.0, 1.0, 1.0]], atol=1e-6,
    )

    v = T.viewport(640.0, 480.0)
    np.testing.assert_allclose(
        T.apply_point(v, jnp.array([[0.0, 0.0, 0.0]])),
        [[320.0, 240.0, 0.5]], atol=1e-5,
    )


def test_scale():
    m = T.scale(2.0, 3.0, 4.0)
    np.testing.assert_allclose(
        T.apply_point(m, jnp.array([[1.0, 1.0, 1.0]])), [[2.0, 3.0, 4.0]]
    )


def test_sphere_helper_lights_scene():
    from sycl_ray_tracing.models.scene import add_sphere, make_materials, make_scene

    tris = np.array([[[-1, 0, -1], [1, 0, 1], [1, 0, -1]]], np.float32)
    mats = make_materials([(1, 0, 1)], [(0, 0, 0)], [0.0], [1.0])
    scene = make_scene(tris, np.array([0], np.int32), mats)
    scene = add_sphere(scene, (0.0, 1.0, 0.0), 0.25, diffuse=(1, 0, 0))
    assert scene.num_spheres == 1
    assert scene.materials.count == 2
    assert int(scene.sphere_material[0]) == 1
