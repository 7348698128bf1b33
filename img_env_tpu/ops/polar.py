"""Matmul-form sensor pipeline: annulus-sorted fill, raycast as matmuls.

The per-robot sensor stage (agent.cpp:356-624) naively does ~160k
pose-dependent map gathers (FOV fill) plus ~543k static-index gathers
(Bresenham samples) per robot per step.  This module restructures the
whole stage around ONE gather and a stack of matmuls:

  1. **Sorted fill**: view pixels are statically reordered by radial annulus
     (distance band from the sensor).  The FOV fill gathers the packed world
     map once per robot, directly producing ``occ_sorted`` — same gather
     count as before, different output order (free).
  2. **Raycast = chunked matmuls**: a beam's Bresenham samples have strictly
     increasing distance, and a sample's distance is a function of its CELL
     alone — so annuli partition samples consistently with per-beam order.
     For each annulus c, a static incidence matrix B_c[p, r] (pixel p is the
     k-th visited sample of beam r, truncated at the beam's first out-of-map
     sample, agent.cpp:562) carries weight 2^-k, so ``occ[slice_c] @ B_c``
     sums DISTINCT powers of two (exact in f32 for K <= 24): nonzero means
     the band fired, and the float EXPONENT of the count is the first
     occupied sample's k — the exact first hit, bit-matching the sequential
     walk, with no per-sample gather.
  3. **Painter**: the exact per-ray view values are decoded from each
     beam's (hit, tail) steps (ops/painter.py).
  4. **48x48 resize = sparse gather-sum**: INTER_CUBIC touches 16 inputs per
     output; static (index, weight) tables evaluate it from the sorted
     layout in 2304x16 reads instead of materializing the image-ordered map.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from img_env_tpu.constants import (
    ANGULAR_MAP_SIZE,
    CELL_SELF_IN_VIEW,
    CELL_UNSEEN,
    CELL_VIEW_FREE,
    LASER_MISS_DIST,
)
from img_env_tpu.ops.resize import resize_matrix
from img_env_tpu.ops.view import (
    LaserStatics,
    ViewParams,
    ViewStatics,
    _pixel_base_coords,
)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class PolarTables(NamedTuple):
    """Device-resident tables, passed as jit ARGUMENTS (not closure
    constants — the incidence/one-hot matrices are hundreds of MB and would
    otherwise be baked into the HLO upload)."""

    pix_x: jnp.ndarray
    pix_y: jnp.ndarray
    gates: jnp.ndarray
    b_chunks: Tuple[jnp.ndarray, ...]  # per chunk [L_c^gated, R] bf16 2^-k
    refine_dist: jnp.ndarray
    angular_bin: jnp.ndarray
    resize_pos: jnp.ndarray
    resize_w: jnp.ndarray
    own_mask: jnp.ndarray = None      # [N, P'] per-robot self-stamp mask
    painter: object = None            # painter.PainterTables (laser decode)


class PolarStatics(NamedTuple):
    """Host-precomputed structure for the matmul sensor pipeline."""

    # sorted pixel layout ----------------------------------------------------
    perm: np.ndarray            # [P] image-flat index of sorted slot p
    slot_of_pixel: np.ndarray   # [hpx*wpx] int32 inverse of perm
    n_slots: int                # P' = padded sorted length (multiple of 128)
    pix_x_sorted: np.ndarray    # [P'] base-frame pixel coords (pad -> dead)
    pix_y_sorted: np.ndarray
    gates_sorted: np.ndarray    # [P'] bool
    # raycast chunks ---------------------------------------------------------
    chunk_lo: Tuple[int, ...]   # per chunk: [lo, hi) slice of sorted slots
    chunk_hi: Tuple[int, ...]
    b_chunks: Tuple[np.ndarray, ...]  # per chunk [L_c, R] bf16 2^-k weights
    refine_dist: np.ndarray     # [R, NC, K] f32 hit distance (pad 6.0)
    angular_bin: np.ndarray     # [R]
    # resize -----------------------------------------------------------------
    resize_pos: np.ndarray      # [48*48, 16] int32 sorted slots
    resize_w: np.ndarray        # [48*48, 16] f32 cubic weights
    fill_window: int            # slot alignment of gated arc segments
    params: ViewParams

    @staticmethod
    def build(p: ViewParams, sensor_base=(0.0, 0.0), image_size=(48, 48),
              n_chunks: int = None, fill_window: int = None) -> "PolarStatics":
        hpx, wpx = p.hpx, p.wpx
        P = hpx * wpx
        if fill_window is None:
            # each connected gated arc pads to a window boundary: small
            # views would drown in that padding with large windows
            fill_window = 512 if P >= 100_000 else 128
        if n_chunks is None:
            # the raycast is insensitive to the chunk count (total
            # incidence work is fixed, and first-hit decode is
            # per-chunk-exponent)
            n_chunks = 24 if P >= 100_000 else 16
        ls = LaserStatics.build(p, sensor_base)
        xb, yb = _pixel_base_coords(p)
        vs = ViewStatics.build(p, sensor_base)

        # --- radial band per pixel (distance from the sensor origin cell) ---
        ox, oy = ls.origin[0] * p.resolution, ls.origin[1] * p.resolution
        ii = np.arange(hpx)[:, None] * p.resolution
        jj = np.arange(wpx)[None, :] * p.resolution
        rho = np.hypot(ii - ox, jj - oy)
        max_range = math.hypot(p.half, p.half) + 2 * p.resolution
        band = max_range / n_chunks
        chunk_of_pixel = np.minimum((rho / band).astype(np.int64),
                                    n_chunks - 1).reshape(-1)

        # --- sorted layout, chunk slices padded to 128 -----------------------
        # Within a radial chunk, pixels are ordered by ANGLE around the
        # sensor: consecutive slots form a short arc of a thin ring (nearby
        # map cells for the fill gather whatever the robot's pose).
        ang_of_pixel = np.arctan2(jj - oy, ii - ox).reshape(-1)
        # ALL gated (in-FOV) pixels sort before all ungated ones: consumers
        # only ever read ``occ & gates`` (raycast/plain), so the chunk
        # slices used by the raycast incidence matmuls stay contiguous.
        gated_pix = vs.gates.reshape(-1)
        gap = max(2.0 * band, 8.0 * p.resolution)
        fw = max(fill_window, 128)
        xf, yf = xb.reshape(-1), yb.reshape(-1)
        lo_list, hi_list = [], []
        slot_of_pixel = np.full(P, -1, np.int64)
        pos = 0
        # The square view clips outer rings into several disconnected arcs.
        # Split each gated chunk at spatial gaps and pad every connected
        # segment to a ``fill_window``-slot boundary, so aligned windows
        # never cross a gap (a few % of dead slots).
        for c in range(n_chunks):
            sel = np.nonzero((chunk_of_pixel == c) & gated_pix)[0]
            idxs = sel[np.argsort(ang_of_pixel[sel], kind="stable")]
            lc = len(idxs)
            lo_list.append(pos)
            if lc:
                d = np.hypot(np.diff(xf[idxs]), np.diff(yf[idxs]))
                breaks = np.nonzero(d > gap)[0] + 1
                bounds = [0, *breaks.tolist(), lc]
            else:
                bounds = [0, 0]
            for a, b in zip(bounds[:-1], bounds[1:]):
                seg = idxs[a:b]
                slot_of_pixel[seg] = pos + np.arange(len(seg))
                pos += _round_up(max(len(seg), 1), fw)
            hi_list.append(pos)
        # ungated pixels: beams still WRITE a few of them (Bresenham wobble
        # at the FOV edges, and the laser trace paints any traversed cell).
        # Order them so the painter's per-block beam windows stay narrow:
        # beam-VISITED ungated slots first, grouped by (chunk, FOV edge,
        # nearest beam) with each group padded to a 128-slot boundary (a
        # block then never mixes the two angular edges -> small windows);
        # never-visited slots last (one constant-200 painter region).
        ls_cells, ls_valid = ls.cells, ls.valid
        inb_u = ((ls_cells[..., 0] >= 0) & (ls_cells[..., 0] < hpx)
                 & (ls_cells[..., 1] >= 0) & (ls_cells[..., 1] < wpx))
        oob_u = ls_valid & ~inb_u
        s_dim = ls_valid.shape[1]
        first_oob_u = np.where(oob_u.any(1), oob_u.argmax(1), s_dim)
        eff_u = ls_valid & inb_u & (
            np.arange(s_dim)[None, :] < first_oob_u[:, None])
        visited_pix = np.zeros(P, bool)
        visited_pix[(ls_cells[..., 0] * wpx + ls_cells[..., 1])[eff_u]] = True

        beam_of_pixel = vs.pix_beam.reshape(-1)
        un_mask = np.logical_not(gated_pix)
        uv = np.nonzero(un_mask & visited_pix)[0]
        edge = (beam_of_pixel[uv] >= p.range_total // 2).astype(np.int64)
        uv = uv[np.lexsort((ang_of_pixel[uv], beam_of_pixel[uv], edge,
                            chunk_of_pixel[uv]))]
        group = chunk_of_pixel[uv] * 2 + (beam_of_pixel[uv]
                                          >= p.range_total // 2)
        gpos = pos
        i0 = 0
        while i0 < len(uv):
            i1 = i0
            while i1 < len(uv) and group[i1] == group[i0]:
                i1 += 1
            seg = uv[i0:i1]
            slot_of_pixel[seg] = gpos + np.arange(len(seg))
            gpos += _round_up(len(seg), 128)
            i0 = i1
        pos = gpos
        un = np.nonzero(un_mask & np.logical_not(visited_pix))[0]
        un = un[np.lexsort((ang_of_pixel[un], chunk_of_pixel[un]))]
        slot_of_pixel[un] = pos + np.arange(len(un))
        pos += len(un)
        n_slots = _round_up(pos + 1, fw)  # +1 dead slot

        perm = np.full(n_slots, -1, np.int64)
        live_pix = np.nonzero(slot_of_pixel >= 0)[0]
        perm[slot_of_pixel[live_pix]] = live_pix
        dead = perm < 0
        slot_of_pixel = np.where(slot_of_pixel < 0, n_slots - 1, slot_of_pixel)

        flat = lambda a: a.reshape(-1)
        px = np.where(dead, 1e6, flat(xb)[np.maximum(perm, 0)])
        py = np.where(dead, 1e6, flat(yb)[np.maximum(perm, 0)])
        gates = np.where(dead, False, flat(vs.gates)[np.maximum(perm, 0)])

        # --- beam-sample incidence, truncated at first out-of-map ------------
        cells, valid = ls.cells, ls.valid            # [R,S,2], [R,S]
        inb = ((cells[..., 0] >= 0) & (cells[..., 0] < hpx)
               & (cells[..., 1] >= 0) & (cells[..., 1] < wpx))
        oob = valid & ~inb
        S = cells.shape[1]
        first_oob = np.where(oob.any(1), oob.argmax(1), S)
        s_idx = np.arange(S)[None, :]
        eff = valid & inb & (s_idx < first_oob[:, None])

        pix_flat = cells[..., 0] * wpx + cells[..., 1]      # [R,S]
        pix_flat = np.where(eff, pix_flat, 0)
        sample_slot = np.where(eff, slot_of_pixel[pix_flat], -1)
        sample_chunk = np.where(
            eff, chunk_of_pixel[pix_flat], n_chunks)        # [R,S]

        R = p.range_total
        b_chunks = []
        K = 1
        for c in range(n_chunks):
            sel = sample_chunk == c
            K = max(K, int(sel.sum(1).max(initial=1)))
        # float64 so x64 parity tests stay bit-exact (f32 on device)
        refine_dist = np.full((R, n_chunks, K), LASER_MISS_DIST, np.float64)
        # Rays only ever see gated occupancy (raycast applies occ & gates,
        # mirroring the gate test in the reference's view write,
        # agent.cpp:394-401), and gated slots sort first within each chunk —
        # so the incidence matmuls cover only the (chunk-contiguous) gated
        # slices [lo_c, hi_c) — ungated samples contribute exactly zero.
        assert K <= 24, "first-hit exponent trick needs K samples in f32 mantissa"
        for c in range(n_chunks):
            lc, hc = lo_list[c], hi_list[c]
            B = np.zeros((max(hc - lc, 128), R), np.float32)
            sel = sample_chunk == c                          # [R,S]
            rs, ss = np.nonzero(sel)
            # Weighted incidence: the k-th (in walk order) sample of a beam
            # in this chunk gets weight 2^-k.  occ @ B then sums DISTINCT
            # powers of two — exact in f32 for K <= 24 — and the leading
            # bit (the float exponent) IS the first occupied sample's k, so
            # the exact first hit needs no per-sample gather.
            for r in np.unique(rs):
                s_list = ss[rs == r]                          # walk-ordered
                kk = len(s_list)
                slot_in = sample_slot[r, s_list] - lc
                keep = (slot_in >= 0) & (slot_in < B.shape[0])
                B[slot_in[keep], r] = 2.0 ** -np.arange(kk)[keep]
                refine_dist[r, c, :kk] = ls.dists[r, s_list]
            b_chunks.append(B.astype(jnp.bfloat16))

        # --- sparse INTER_CUBIC resize ---------------------------------------
        oh, ow = image_size
        Wh = resize_matrix(oh, hpx)                          # [48, hpx]
        Ww = resize_matrix(ow, wpx)
        ridx = np.zeros((oh * ow, 16), np.int64)
        rw = np.zeros((oh * ow, 16), np.float64)
        hnz = [np.nonzero(Wh[a])[0] for a in range(oh)]
        wnz = [np.nonzero(Ww[b])[0] for b in range(ow)]
        for a in range(oh):
            for b in range(ow):
                o = a * ow + b
                k = 0
                for i in hnz[a]:
                    for j in wnz[b]:
                        ridx[o, k] = slot_of_pixel[i * wpx + j]
                        rw[o, k] = Wh[a, i] * Ww[b, j]
                        k += 1
                # unreferenced slots keep weight 0 on the dead slot
                ridx[o, k:] = n_slots - 1

        astep = abs(p.angle_end - p.angle_begin) / p.range_total
        ang_map_step = abs(p.angle_end - p.angle_begin) / ANGULAR_MAP_SIZE
        bins = np.clip((astep * np.arange(R) / ang_map_step).astype(np.int32),
                       0, ANGULAR_MAP_SIZE - 1)

        return PolarStatics(
            perm=perm, slot_of_pixel=slot_of_pixel.astype(np.int32),
            n_slots=n_slots,
            pix_x_sorted=px,
            pix_y_sorted=py,
            gates_sorted=gates,
            chunk_lo=tuple(lo_list), chunk_hi=tuple(hi_list),
            b_chunks=tuple(b_chunks),
            refine_dist=refine_dist,
            angular_bin=bins,
            resize_pos=ridx.astype(np.int32), resize_w=rw.astype(np.float32),
            fill_window=fw,
            params=p,
        )


# ---------------------------------------------------------------------------
# Batched runtime
# ---------------------------------------------------------------------------


def make_tables(ps: PolarStatics, device_put: bool = True) -> PolarTables:
    """Materialize the big arrays as device arrays (jit arguments)."""
    put = jax.device_put if device_put else jnp.asarray
    return PolarTables(
        pix_x=put(jnp.asarray(ps.pix_x_sorted)),
        pix_y=put(jnp.asarray(ps.pix_y_sorted)),
        gates=put(jnp.asarray(ps.gates_sorted)),
        b_chunks=tuple(put(jnp.asarray(b)) for b in ps.b_chunks),
        refine_dist=put(jnp.asarray(ps.refine_dist)),
        angular_bin=put(jnp.asarray(ps.angular_bin)),
        resize_pos=put(jnp.asarray(ps.resize_pos)),
        resize_w=put(jnp.asarray(ps.resize_w)),
    )


def decode_packed(v, rid1):
    """Occupancy from an id-packed cell value, excluding robot ``rid1``.

    v: int32 packed cells (raster.build_layers encoding); rid1: 1-based id
    of the viewing robot.  "Another robot covers the cell" is exact: a
    count >= 2 always includes someone else; count == 1 is someone else iff
    the stored id differs (the reference instead re-draws robots j != i
    into a per-robot map copy, img_env.cpp:620-629).
    """
    static_occ = (v & 1) > 0
    cnt = (v >> 1) & 3
    vid = (v >> 3) & 0xFFF
    other = (cnt >= 2) | ((cnt == 1) & (vid != rid1))
    return static_occ | other


def fill_sorted(ps: PolarStatics, packed_map, resolution, poses,
                t: PolarTables = None, rids=None):
    """[N, P'] occupancy in sorted order — ONE gather per robot.

    Mirrors ops/view.gather_world_occupancy (id-packed map, self-exclusion
    by robot id — no second gather), emitting the sorted slot layout.
    ``rids``: explicit in-scene robot ids (1-based) — heterogeneous sensor
    groups pass their member ids; default 1..N.
    """
    from img_env_tpu.ops.raster import round_half_away

    h, w = packed_map.shape
    n = poses.shape[0]
    bx = t.pix_x if t is not None else jnp.asarray(ps.pix_x_sorted)
    by = t.pix_y if t is not None else jnp.asarray(ps.pix_y_sorted)
    if rids is None:
        rids = jnp.arange(1, n + 1, dtype=jnp.int32)

    def one(pose, rid1):
        c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
        wx = c * bx - s * by + pose[0]
        wy = s * bx + c * by + pose[1]
        cm = round_half_away(wx / resolution).astype(jnp.int32)
        cn = round_half_away(wy / resolution).astype(jnp.int32)
        inside = (cm >= 0) & (cm < h) & (cn >= 0) & (cn < w)
        v = packed_map[jnp.clip(cm, 0, h - 1), jnp.clip(cn, 0, w - 1)]
        return inside & decode_packed(v, rid1)

    return jax.vmap(one)(poses, rids)


def raycast_batched(ps: PolarStatics, occ_sorted, t: PolarTables = None,
                    return_aux: bool = False):
    """Exact first-hit per beam for all robots at once.

    occ_sorted: [N, P'] raw fill occupancy, sorted layout.  The rays read
    the FOV-gated map (``source_occ`` in the reference, agent.cpp:394-401) —
    gating is applied here.  Returns (hits [N,R], angular [N,72]); with
    ``return_aux`` also (any_hit [N,R], first_c [N,R], first_k [N,R]) —
    the exact (chunk, within-chunk sample) of the hit, consumed by the
    painter decode (ops/painter.py).
    """
    gates = t.gates if t is not None else jnp.asarray(ps.gates_sorted)
    source_occ_sorted = occ_sorted & gates[None]
    n = source_occ_sorted.shape[0]
    R = ps.params.range_total
    nc = len(ps.b_chunks)
    occ_bf = source_occ_sorted.astype(jnp.bfloat16)

    counts = []
    for c in range(nc):
        B = (t.b_chunks[c] if t is not None
             else jnp.asarray(ps.b_chunks[c]))       # [L_c^gated, R]
        lo = ps.chunk_lo[c]
        seg = occ_bf[:, lo:lo + B.shape[0]]          # gated prefix only
        counts.append(jnp.dot(seg, B, preferred_element_type=jnp.float32))
    counts = jnp.stack(counts, axis=1)                        # [N, NC, R]
    fired = counts > 0
    any_hit = fired.any(axis=1)                               # [N, R]
    first_c = jnp.where(any_hit, jnp.argmax(fired, axis=1), nc - 1)

    # Exact first sample from the count's float exponent: the weighted
    # incidence makes counts a sum of distinct powers 2^-k (k = walk order),
    # so the leading bit — the f32 exponent — is the first occupied k.
    # No per-sample gather needed.
    w_first = jnp.take_along_axis(
        counts, first_c[:, None, :], axis=1)[:, 0]            # [N, R]
    e = (jax.lax.bitcast_convert_type(w_first.astype(jnp.float32), jnp.int32)
         >> 23) & 0xFF
    first_k = jnp.where(w_first > 0, 127 - e, 0)              # [N, R]

    rd = t.refine_dist if t is not None else jnp.asarray(ps.refine_dist)
    k = rd.shape[-1]
    flat = ((jnp.arange(R, dtype=jnp.int32)[None, :] * nc + first_c) * k
            + jnp.clip(first_k, 0, k - 1))
    hit_d = rd.reshape(-1)[flat]                              # [N, R]
    hits = jnp.where(any_hit, hit_d, LASER_MISS_DIST)

    bins = t.angular_bin if t is not None else jnp.asarray(ps.angular_bin)
    angular = jnp.full((n, ANGULAR_MAP_SIZE), ps.params.max_dist, hits.dtype)
    angular = angular.at[:, bins].min(hits)
    if return_aux:
        return hits, angular, (any_hit, first_c, first_k)
    return hits, angular


def inside_sorted(ps: PolarStatics, map_shape, resolution, poses,
                  t: PolarTables = None):
    """[N, P'] bool: the pixel's world cell lies inside the grid map.

    The reference's FOV fill only writes when ``grid_map.is_in_map`` holds
    (agent.cpp:392-401) — out-of-world pixels keep the 200 background in
    no-laser mode.  Same coordinate math as fill_sorted, no map gather.
    """
    from img_env_tpu.ops.raster import round_half_away

    h, w = map_shape
    bx = t.pix_x if t is not None else jnp.asarray(ps.pix_x_sorted)
    by = t.pix_y if t is not None else jnp.asarray(ps.pix_y_sorted)

    def one(pose):
        c, s = jnp.cos(pose[2]), jnp.sin(pose[2])
        wx = c * bx - s * by + pose[0]
        wy = s * bx + c * by + pose[1]
        cm = round_half_away(wx / resolution).astype(jnp.int32)
        cn = round_half_away(wy / resolution).astype(jnp.int32)
        return (cm >= 0) & (cm < h) & (cn >= 0) & (cn < w)

    return jax.vmap(one)(poses)


def plain_values_sorted(ps: PolarStatics, occ_sorted, inside=None,
                        t: PolarTables = None):
    """use_laser=False view values, sorted order.

    inside: [N, P'] bool — pixel's world cell in the grid (inside_sorted).
    Out-of-world pixels keep the 200 background: the reference's is_in_map
    gate wraps both FOV-fill writes (agent.cpp:392-401).
    """
    gates = (t.gates if t is not None else jnp.asarray(ps.gates_sorted))[None]
    source = gates & occ_sorted
    visible = gates & inside if inside is not None else gates
    return jnp.where(
        source, 0, jnp.where(visible, CELL_VIEW_FREE, CELL_UNSEEN)
    ).astype(jnp.float32)


def stamp_self_sorted(ps: PolarStatics, values, own_slots, own_valid):
    """Self footprint (value 100) into non-occupied slots (agent.cpp:315-322).

    own_slots: [N, Q] sorted-slot indices (precomputed per robot shape),
    own_valid: [N, Q].  Scatter formulation of ``stamp_self_mask``.
    """
    n = values.shape[0]

    def one(vals, slots, ok):
        cur = vals[slots]
        new = jnp.where(ok & (cur != 0), float(CELL_SELF_IN_VIEW), cur)
        return vals.at[slots].set(new)

    return jax.vmap(one)(values, own_slots, own_valid)


def own_mask_sorted(ps: PolarStatics, own_slots, own_valid) -> np.ndarray:
    """[N, P'] bool: precompute each robot's static footprint stamp mask so
    the runtime stamp is one elementwise select instead of a scatter."""
    slots = np.asarray(own_slots)
    ok = np.asarray(own_valid)
    n = slots.shape[0]
    mask = np.zeros((n, ps.n_slots), bool)
    for i in range(n):
        mask[i, slots[i][ok[i]]] = True
    mask[:, ps.n_slots - 1] = False          # dead slot never stamps
    return mask


def stamp_self_mask(values, own_mask):
    """Elementwise equivalent of stamp_self_sorted (own footprint static
    per robot, agent.cpp:315-322: write 100 only over non-occupied)."""
    return jnp.where(own_mask & (values != 0), float(CELL_SELF_IN_VIEW),
                     values)


def sensor_maps_from_values(values, pos, w, image_size, dtype=jnp.float32):
    """Sparse INTER_CUBIC resize + /255 from ANY value layout.

    values: [N, P] floats; pos: [oh*ow, 16] int32 indices into that layout
    (sorted slots or the painter's compact space); w: [oh*ow, 16] weights.
    """
    n = values.shape[0]
    gathered = values[:, pos.reshape(-1)].reshape(n, pos.shape[0], pos.shape[1])
    out = (gathered * w[None]).sum(-1)
    # cv2 saturates the cubic overshoot back into uint8 range and rounds
    # (same as ops/resize.sensor_map_from_view).
    out = jnp.clip(jnp.round(out), 0, 255) / 255.0
    oh, ow = image_size
    return out.astype(dtype).reshape(n, oh, ow)


def sensor_maps_from_sorted(ps: PolarStatics, values, image_size,
                            dtype=jnp.float32, t: PolarTables = None):
    """Sparse INTER_CUBIC resize + /255 from the sorted layout.

    values: [N, P'] floats (view map values).  Returns [N, 48, 48].
    """
    pos = t.resize_pos if t is not None else jnp.asarray(ps.resize_pos)
    w = t.resize_w if t is not None else jnp.asarray(ps.resize_w)
    return sensor_maps_from_values(values, pos, w, image_size, dtype)


def own_slots_from_cells(ps: PolarStatics, own_view_cells, own_view_valid):
    """Convert per-robot static view cells to sorted slots (host-side)."""
    p = ps.params
    cells = np.asarray(own_view_cells)
    valid = np.asarray(own_view_valid)
    inb = ((cells[..., 0] >= 0) & (cells[..., 0] < p.hpx)
           & (cells[..., 1] >= 0) & (cells[..., 1] < p.wpx))
    flat = np.where(inb, cells[..., 0] * p.wpx + cells[..., 1], 0)
    slots = np.where(inb & valid, ps.slot_of_pixel[flat], ps.n_slots - 1)
    return slots.astype(np.int32), (valid & inb)
