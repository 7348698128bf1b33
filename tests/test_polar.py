"""Matmul sensor pipeline vs the gather reference path: bit-exact lasers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from img_env_tpu.ops import polar, raster
from img_env_tpu.ops.resize import sensor_map_from_view
from img_env_tpu.ops.view import ViewParams, ViewStatics, own_view_cells, render_robot_view

from tests.test_raster import RES, _layers_from_scene, _random_scene, _pad

VP = ViewParams(
    hpx=60, wpx=60, resolution=RES, half=1.5,
    angle_begin=-1.570795, angle_end=1.570795,
    min_dist=0.0, max_dist=10.0, range_total=60, use_laser=True,
)


def _both_paths(rng, n_rob=3, n_ped=2, n_obs=2, vp=VP):
    static, obs, peds, robots = _random_scene(rng, n_rob=n_rob, n_ped=n_ped,
                                              n_obs=n_obs)
    layers = _layers_from_scene(static, obs, peds, robots)
    vs = ViewStatics.build(vp)
    ps = polar.PolarStatics.build(vp, image_size=(48, 48), n_chunks=16)
    rob_poses = jnp.asarray(np.stack([p for p, _ in robots]))
    rob_pts, rob_msk = _pad([c for _, c in robots])

    # reference gather path (validated bit-exact vs the NumPy oracle)
    ref = []
    for i in range(n_rob):
        vc, vm = own_view_cells(rob_pts[i], rob_msk[i], vp)
        view, hits, ang = render_robot_view(
            layers, RES, rob_poses[i], jnp.int32(i + 1),
            jnp.asarray(vc), jnp.asarray(vm), vs, vp)
        ref.append((np.asarray(view), np.asarray(hits), np.asarray(ang)))

    # new matmul path + exact painter decode
    from img_env_tpu.ops.painter import PainterStatics, hit_steps, paint_sorted
    pst = PainterStatics.build(ps)
    occ = polar.fill_sorted(ps, layers.packed, RES, rob_poses)
    hits, ang, aux = polar.raycast_batched(ps, occ, return_aux=True)
    s_hit, s_tail = hit_steps(pst, *aux)
    vals = paint_sorted(pst, s_hit, s_tail)
    own_slots = []
    own_ok = []
    for i in range(n_rob):
        vc, vm = own_view_cells(rob_pts[i], rob_msk[i], vp)
        sl, ok = polar.own_slots_from_cells(ps, vc, vm)
        own_slots.append(sl)
        own_ok.append(ok)
    vals = polar.stamp_self_sorted(
        ps, vals, jnp.asarray(np.stack(own_slots)),
        jnp.asarray(np.stack(own_ok)))
    sm = polar.sensor_maps_from_sorted(ps, vals, (48, 48))
    return ref, (np.asarray(hits), np.asarray(ang), np.asarray(vals),
                 np.asarray(sm)), ps, layers


@pytest.mark.parametrize("trial", range(3))
def test_hits_bit_exact(rng, trial):
    ref, new, ps, _ = _both_paths(rng)
    hits, ang = new[0], new[1]
    for i in range(len(ref)):
        np.testing.assert_allclose(hits[i], ref[i][1], atol=0, rtol=0,
                                   err_msg=f"robot {i}")
        np.testing.assert_allclose(ang[i], ref[i][2], atol=0, rtol=0)


def test_sorted_values_match_reference_view(rng):
    """Per-pixel shadow values in sorted order == reference view map pixels."""
    ref, new, ps, _ = _both_paths(rng, n_rob=2)
    vals = new[2]
    live = ps.perm >= 0
    for i in range(len(ref)):
        ref_flat = ref[i][0].reshape(-1).astype(np.float32)
        np.testing.assert_array_equal(
            vals[i][live], ref_flat[ps.perm[live]], err_msg=f"robot {i}")


def test_sensor_maps_match(rng):
    ref, new, ps, _ = _both_paths(rng, n_rob=2)
    sm_new = new[3]
    for i in range(len(ref)):
        want = np.asarray(sensor_map_from_view(
            jnp.asarray(ref[i][0]), (48, 48)))
        np.testing.assert_allclose(sm_new[i], want, atol=1.01 / 255,
                                   err_msg=f"robot {i}")


def test_no_laser_values(rng):
    vp = VP._replace(use_laser=False)
    static, obs, peds, robots = _random_scene(rng, n_rob=2, n_ped=1, n_obs=1)
    layers = _layers_from_scene(static, obs, peds, robots)
    ps = polar.PolarStatics.build(vp, n_chunks=16)
    vs = ViewStatics.build(vp)
    rob_poses = jnp.asarray(np.stack([p for p, _ in robots]))
    rob_pts, rob_msk = _pad([c for _, c in robots])
    occ = polar.fill_sorted(ps, layers.packed, RES, rob_poses)
    inside = polar.inside_sorted(ps, layers.packed.shape, RES, rob_poses)
    vals = polar.plain_values_sorted(ps, occ, inside)
    slots, oks = [], []
    for i in range(2):
        vc, vm = own_view_cells(rob_pts[i], rob_msk[i], vp)
        sl, ok = polar.own_slots_from_cells(ps, vc, vm)
        slots.append(sl)
        oks.append(ok)
    vals = polar.stamp_self_sorted(
        ps, vals, jnp.asarray(np.stack(slots)), jnp.asarray(np.stack(oks)))
    for i in range(2):
        vc, vm = own_view_cells(rob_pts[i], rob_msk[i], vp)
        view, _, _ = render_robot_view(
            layers, RES, rob_poses[i], jnp.int32(i + 1),
            jnp.asarray(vc), jnp.asarray(vm), vs, vp)
        live = ps.perm >= 0
        np.testing.assert_array_equal(
            np.asarray(vals[i])[live],
            np.asarray(view).reshape(-1).astype(np.float32)[ps.perm[live]])


def test_compact_painter_matches_full_resize(rng):
    """Masked (resize-subgrid) painter: the 48x48 sensor map is bit-equal
    to resizing the FULL painted view (the compact painter's contract)."""
    from img_env_tpu.ops.painter import PainterStatics, hit_steps, paint_sorted

    static, obs, peds, robots = _random_scene(rng, n_rob=2, n_ped=1, n_obs=2)
    layers = _layers_from_scene(static, obs, peds, robots)
    ps = polar.PolarStatics.build(VP, image_size=(48, 48), n_chunks=16)
    rob_poses = jnp.asarray(np.stack([p for p, _ in robots]))

    mask = np.zeros(ps.n_slots, bool)
    mask[ps.resize_pos[ps.resize_w != 0]] = True
    mask[ps.n_slots - 1] = False
    pst_full = PainterStatics.build(ps)
    pst_c = PainterStatics.build(ps, slot_mask=mask)

    occ = polar.fill_sorted(ps, layers.packed, RES, rob_poses)
    hits, ang, aux = polar.raycast_batched(ps, occ, return_aux=True)
    s_hit, s_tail = hit_steps(pst_full, *aux)
    vals_full = paint_sorted(pst_full, s_hit, s_tail)
    sm_full = polar.sensor_maps_from_sorted(ps, vals_full, (48, 48))

    vals_c = paint_sorted(pst_c, s_hit, s_tail)
    soc = pst_c.slots_of_compact
    # compact values agree with the full paint on every masked slot
    live = soc != ps.n_slots - 1
    np.testing.assert_array_equal(
        np.asarray(vals_c)[:, live], np.asarray(vals_full)[:, soc[live]])

    coc = np.full(ps.n_slots, pst_c.n_slots - 1, np.int64)
    coc[soc] = np.arange(len(soc))
    pos_c = np.where(ps.resize_w != 0, coc[ps.resize_pos],
                     pst_c.n_slots - 1).astype(np.int32)
    sm_c = polar.sensor_maps_from_values(
        vals_c, jnp.asarray(pos_c), jnp.asarray(ps.resize_w), (48, 48))
    np.testing.assert_array_equal(np.asarray(sm_c), np.asarray(sm_full))


def test_hit_steps_matches_gather_formulation(rng):
    """The gather-free hit_steps (chunk-base select + minor-run reduce)
    equals the direct globstep/nxt_flat table gathers for arbitrary
    raycast decodes — incl. sentinel no-hit beams."""
    from img_env_tpu.ops.painter import PainterStatics, _BIG, hit_steps

    ps = polar.PolarStatics.build(VP, image_size=(48, 48), n_chunks=16)
    pst = PainterStatics.build(ps)
    R, nc, K = pst.globstep.shape
    n = 4
    any_hit = jnp.asarray(rng.random((n, R)) < 0.8)
    first_c = jnp.asarray(rng.integers(0, nc, (n, R)), jnp.int32)
    first_k = jnp.asarray(rng.integers(0, K, (n, R)), jnp.int32)
    # keep (c, k) on valid samples when hit (the raycast always does)
    gs = np.asarray(pst.globstep)
    nv = (gs < _BIG).sum(-1)                       # [R, nc] valid prefix
    kmax = np.maximum(nv[np.arange(R)[None, :], np.asarray(first_c)], 1)
    first_k = jnp.minimum(first_k, jnp.asarray(kmax - 1, jnp.int32))

    got_h, got_t = hit_steps(pst, any_hit, first_c, first_k)

    flat = ((np.arange(R)[None, :] * nc + np.asarray(first_c)) * K
            + np.clip(np.asarray(first_k), 0, K - 1))
    want_h = np.where(np.asarray(any_hit), gs.reshape(-1)[flat], _BIG)
    nxt = np.asarray(pst.nxt_flat)
    sidx = (np.arange(R)[None, :] * pst.n_steps
            + np.clip(want_h, 0, pst.n_steps - 1))
    want_t = np.where(np.asarray(any_hit), nxt[sidx], _BIG)
    np.testing.assert_array_equal(np.asarray(got_h), want_h.astype(np.int16))
    np.testing.assert_array_equal(np.asarray(got_t), want_t.astype(np.int16))
