"""Egocentric view + laser parity against the oracle.

Laser hits, angular maps AND the traced view map must all be bit-exact:
the closed-form Bresenham visits the same cells as the C++ walk, and the
priority scatter-max trace reproduces the per-ray overwrite order
(255/0/200 with the minor-coordinate skip run) exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from img_env_tpu.ops.footprint import circle_points
from img_env_tpu.ops import raster
from img_env_tpu.ops.view import (
    LaserStatics,
    ViewParams,
    ViewStatics,
    own_view_cells,
    render_robot_view,
)
from img_env_tpu.oracle.np_oracle import oracle_compose_scene, oracle_view

from tests.test_raster import RES, _layers_from_scene, _random_scene

VP = ViewParams(
    hpx=60, wpx=60, resolution=RES, half=1.5,
    angle_begin=-1.570795, angle_end=1.570795,
    min_dist=0.0, max_dist=10.0, range_total=60, use_laser=True,
)


def _run_engine_views(static, obs, peds, robots, vp):
    layers = _layers_from_scene(static, obs, peds, robots)
    vs = ViewStatics.build(vp)
    rob_poses = np.stack([p for p, _ in robots])
    from tests.test_raster import _pad

    rob_pts, rob_msk = _pad([c for _, c in robots])
    out = []
    for i in range(len(robots)):
        vc, vm = own_view_cells(rob_pts[i], rob_msk[i], vp)
        view, hits, ang = render_robot_view(
            layers, RES, jnp.asarray(rob_poses[i]), jnp.int32(i + 1),
            jnp.asarray(vc), jnp.asarray(vm), vs, vp,
        )
        out.append((np.asarray(view), np.asarray(hits), np.asarray(ang)))
    return out


@pytest.mark.parametrize("trial", range(3))
def test_laser_parity(rng, trial):
    static, obs, peds, robots = _random_scene(rng, n_rob=3, n_ped=2, n_obs=2)
    got = _run_engine_views(static, obs, peds, robots, VP)

    _, _, robot_maps = oracle_compose_scene(static, RES, obs, peds, robots)
    for i, (pose, bbox) in enumerate(robots):
        want = oracle_view(
            robot_maps[i], pose, bbox,
            view_size_m=(3.0, 3.0), view_resolution=RES,
            range_total=VP.range_total,
        )
        view, hits, ang = got[i]
        np.testing.assert_allclose(hits, want.hits, atol=1e-9, err_msg=f"robot {i}")
        np.testing.assert_allclose(ang, want.angular_map, atol=1e-9)


@pytest.mark.parametrize("beams", [60, 240])
def test_view_map_exact(rng, beams):
    """The traced laser view map is bit-identical to the oracle's."""
    vp = VP._replace(range_total=beams)
    static, obs, peds, robots = _random_scene(rng, n_rob=2, n_ped=2, n_obs=2)
    got = _run_engine_views(static, obs, peds, robots, vp)
    _, _, robot_maps = oracle_compose_scene(static, RES, obs, peds, robots)
    for i, (pose, bbox) in enumerate(robots):
        want = oracle_view(
            robot_maps[i], pose, bbox,
            view_size_m=(3.0, 3.0), view_resolution=RES,
            range_total=vp.range_total,
        )
        np.testing.assert_array_equal(
            got[i][0], want.view_map, err_msg=f"robot {i}")


def test_view_no_laser_exact(rng):
    """Without the laser trace, the FOV fill must be bit-exact."""
    vp = VP._replace(use_laser=False)
    static, obs, peds, robots = _random_scene(rng, n_rob=2, n_ped=2, n_obs=2)
    got = _run_engine_views(static, obs, peds, robots, vp)
    _, _, robot_maps = oracle_compose_scene(static, RES, obs, peds, robots)
    for i, (pose, bbox) in enumerate(robots):
        want = oracle_view(
            robot_maps[i], pose, bbox,
            view_size_m=(3.0, 3.0), view_resolution=RES,
            range_total=vp.range_total, use_laser=False,
        )
        np.testing.assert_array_equal(got[i][0], want.view_map, err_msg=f"robot {i}")
