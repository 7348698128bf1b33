"""Exact laser-mode view-map decode ("painter") for the sorted pipeline.

The reference's laser trace (agent.cpp:356-509, 511-624) deep-copies the
view map right after ``empty_map()`` — BEFORE the FOV fill — so the final
laser-mode view map is an all-200 canvas painted only by the per-beam
Bresenham walks (the FOV-filled map is just the read-only ray source):

  * pre-hit samples write 255,
  * the first occupied sample writes 0 (the hit),
  * post-hit samples write 200 unless ``cx != end_x && cy != end_y`` fails.

Beams run in increasing index order and overwrite each other, so a pixel's
final value is the write of the HIGHEST-index beam that writes it.  Two
facts make this a dense, gather-free decode:

  1. The major coordinate strictly increases along a walk, so post-hit
     samples never share it with the hit cell — the skip condition is
     exactly "shares the MINOR coordinate", i.e. the contiguous run of
     steps right after the hit until the minor offset changes.  A beam's
     write at static step ``s`` therefore depends on two dynamic per-beam
     scalars only:  ``s_hit`` (first occupied sample, from the raycast's
     float-exponent decode) and ``s_tail`` (first step after ``s_hit``
     whose minor coordinate differs — a static table indexed at s_hit):

         s <  s_hit            -> 255
         s == s_hit            -> 0
         s_hit < s < s_tail    -> skip (no write)
         s >= s_tail           -> 200

  2. Which beams visit which pixel is static geometry.  In the
     (chunk, angle)-sorted slot layout (ops/polar.py) any block of
     consecutive slots is a short arc whose visitors lie in a NARROW
     contiguous beam window, so the decode is a dense
     [block, slot, window] integer compute + max-reduce: the per-entry
     key ``(window_pos << 2) | code`` makes one ``max`` pick the
     highest-index writing beam AND its value at once.

Everything is integer arithmetic — bit-identical on every platform.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from img_env_tpu.constants import CELL_UNSEEN, CELL_VIEW_FREE
from img_env_tpu.ops.view import LaserStatics, beam_walk_tables
from img_env_tpu.ops.polar import PolarStatics

_BIG = np.int32(2 ** 14)       # "no hit" sentinel step (any real s < this)
_BM = 64                       # slots per painter block: windows cover half
                               # the angular drift of 128-slot blocks; width
                               # CLASSES are shared per block PAIR


class PainterRegion(NamedTuple):
    lo: int                 # first slot covered
    nb: int                 # number of BM-slot blocks
    W: int                  # beam-window width (0 -> constant-200 region)
    rbase: np.ndarray       # [nb] int32 window start beam per block
    widx: np.ndarray        # [nb, W] int32 clipped beam index per window pos
    sstep: np.ndarray       # [nb, W, BM] int16: step+1 of the visit, 0=none
                            #   (BM minor: slots are the contiguous axis)


class PainterStatics(NamedTuple):
    regions: Tuple[PainterRegion, ...]
    globstep: np.ndarray    # [R, NC, K] int16 global step of chunk sample k
    nxt_flat: np.ndarray    # [R*S] int16 minor-run end lookup
    n_steps: int            # S
    n_slots: int            # painted slot count (compact when masked)
    # near-sensor slots are visited by beams spanning most of the range —
    # a dense per-slot row over ALL beams wastes far less than a 1024-wide
    # block window (their true incidence is dense anyway)
    wide_slots: np.ndarray = None   # [ns] int32 slot ids (painted space)
    wide_sstep: np.ndarray = None   # [ns, R] int16 step+1, 0 = none
    # masked build: compact painted space over a subset of sorted slots
    # (e.g. only the 192x192 subgrid the 48x48 cubic resize reads — 77% of
    # view pixels never reach the Observation).  None -> identity.
    slots_of_compact: np.ndarray = None  # [n_slots] int32 original slot ids

    @staticmethod
    def build(ps: PolarStatics, sensor_base=(0.0, 0.0),
              slot_mask: np.ndarray = None) -> "PainterStatics":
        """slot_mask: optional [P'] bool — paint only these sorted slots,
        into a COMPACT [n_masked_pad] value space ordered like the sorted
        layout (consumers remap indices via slots_of_compact)."""
        p = ps.params
        ls = LaserStatics.build(p, sensor_base)
        cells = ls.cells
        R, S = ls.valid.shape
        eff, nxt = beam_walk_tables(ls, p)

        # ---- global step of each (beam, chunk, k) raycast sample ----------
        # mirrors the b_chunks walk-order grouping in PolarStatics.build
        ox, oy = ls.origin[0] * p.resolution, ls.origin[1] * p.resolution
        ii = np.arange(p.hpx)[:, None] * p.resolution
        jj = np.arange(p.wpx)[None, :] * p.resolution
        rho = np.hypot(ii - ox, jj - oy)
        import math
        nc = len(ps.b_chunks)
        band = (math.hypot(p.half, p.half) + 2 * p.resolution) / nc
        chunk_of_pixel = np.minimum((rho.reshape(-1) / band).astype(np.int64),
                                    nc - 1)
        pix_flat = cells[..., 0] * p.wpx + cells[..., 1]
        pix_flat = np.where(eff, pix_flat, 0)
        sample_chunk = np.where(eff, chunk_of_pixel[pix_flat], nc)
        K = ps.refine_dist.shape[-1]
        globstep = np.full((R, nc, K), _BIG, np.int32)
        for c in range(nc):
            sel = sample_chunk == c
            rs, ss = np.nonzero(sel)
            for r in np.unique(rs):
                s_list = ss[rs == r]
                globstep[r, c, : len(s_list)] = s_list

        # ---- per-slot visitor lists -> blocked window tables --------------
        slot_of_pixel = ps.slot_of_pixel
        ent_r, ent_s = np.nonzero(eff)
        ent_slot = slot_of_pixel[
            cells[ent_r, ent_s, 0] * p.wpx + cells[ent_r, ent_s, 1]]
        if slot_mask is not None:
            masked = np.nonzero(slot_mask)[0].astype(np.int64)   # sorted
            pc = (len(masked) + 127) // 128 * 128    # whole block PAIRS
            slots_of_compact = np.full(pc, ps.n_slots - 1, np.int32)
            slots_of_compact[: len(masked)] = masked
            compact_of_slot = np.full(ps.n_slots, -1, np.int64)
            compact_of_slot[masked] = np.arange(len(masked))
            keep_m = compact_of_slot[ent_slot] >= 0
            ent_r, ent_s = ent_r[keep_m], ent_s[keep_m]
            ent_slot = compact_of_slot[ent_slot[keep_m]]
            P = pc
        else:
            slots_of_compact = None
            P = ps.n_slots
        nb_total = P // _BM
        assert nb_total * _BM == P, "sorted layout must be 128-aligned"

        # ---- wide (near-sensor) slots: dense per-slot rows over all beams
        smin = np.full(P, np.iinfo(np.int32).max, np.int64)
        smax = np.full(P, -1, np.int64)
        np.minimum.at(smin, ent_slot, ent_r)
        np.maximum.at(smax, ent_slot, ent_r)
        span = np.where(smax >= 0, smax - np.minimum(smin, smax) + 1, 0)
        wide = span > 256
        wide_slots = np.nonzero(wide)[0].astype(np.int32)
        wid_of_slot = np.full(P, -1, np.int64)
        wid_of_slot[wide_slots] = np.arange(len(wide_slots))
        wide_sstep = np.zeros((max(len(wide_slots), 1), R), np.int16)
        is_wide_ent = wide[ent_slot]
        wide_sstep[wid_of_slot[ent_slot[is_wide_ent]],
                   ent_r[is_wide_ent]] = (ent_s[is_wide_ent] + 1).astype(
                       np.int16)
        keep = np.logical_not(is_wide_ent)
        ent_r, ent_s, ent_slot = ent_r[keep], ent_s[keep], ent_slot[keep]

        ent_blk = ent_slot // _BM
        # per-block beam range
        bmin = np.full(nb_total, np.iinfo(np.int32).max, np.int64)
        bmax = np.full(nb_total, -1, np.int64)
        np.minimum.at(bmin, ent_blk, ent_r)
        np.maximum.at(bmax, ent_blk, ent_r)
        wblk = np.where(bmax >= 0, bmax - np.minimum(bmin, bmax) + 1, 0)

        # Window start per block: aligned DOWN to 8; the width class covers
        # [rbase8, bmax] rounded up (fine classes of 16 up to 128 beams,
        # powers of two above), so few distinct region shapes compile.
        r_pad = (R + 127) // 128 * 128
        rb16 = np.maximum(np.minimum(bmin, bmax), 0) // 8 * 8
        w_need = np.where(bmax >= 0, bmax - rb16 + 1, 0)
        wcls = np.zeros(nb_total, np.int64)
        nzb = wblk > 0
        fine = (w_need + 15) // 16 * 16
        coarse = np.maximum(
            2 ** np.ceil(np.log2(np.maximum(w_need, 1))).astype(int), 128)
        wcls[nzb] = np.where(w_need[nzb] <= 128, fine[nzb], coarse[nzb])
        wcls = np.minimum(wcls, r_pad)
        # width class shared per block PAIR (fewer, longer regions)
        wpair = np.maximum(wcls[0::2], wcls[1::2])
        wcls = np.repeat(wpair, 2)
        rb16 = np.minimum(rb16, np.maximum(r_pad - wcls, 0))
        # fold short zero-runs into the wider neighbour class so regions
        # stay few; long zero runs become free constant-200 regions
        cls = wcls.copy()
        i = 0
        while i < nb_total:
            j = i
            while j < nb_total and cls[j] == cls[i]:
                j += 1
            if cls[i] == 0 and (j - i) < 4 and (i > 0 or j < nb_total):
                left = cls[i - 1] if i > 0 else 0
                right = cls[j] if j < nb_total else 0
                cls[i:j] = max(left, right)
            i = j
        # merge micro-regions (< 4 blocks) into the wider neighbour class to
        # bound the number of XLA ops without inflating entries much
        i = 0
        while i < nb_total:
            j = i
            while j < nb_total and cls[j] == cls[i]:
                j += 1
            if 0 < cls[i] and (j - i) < 4:
                left = cls[i - 1] if i > 0 else 0
                right = cls[j] if j < nb_total else 0
                m = max(left, right)
                if m > cls[i]:
                    cls[i:j] = m
            i = j

        # entries grouped by block for table fill
        order = np.argsort(ent_blk, kind="stable")
        ent_blk_o = ent_blk[order]
        ent_r_o = ent_r[order]
        ent_s_o = ent_s[order]
        ent_slot_o = ent_slot[order]
        blk_start = np.searchsorted(ent_blk_o, np.arange(nb_total))
        blk_end = np.searchsorted(ent_blk_o, np.arange(nb_total) + 1)

        regions = []
        i = 0
        while i < nb_total:
            j = i
            while j < nb_total and cls[j] == cls[i]:
                j += 1
            W = int(cls[i])
            nb = j - i
            if W == 0:
                regions.append(PainterRegion(
                    lo=i * _BM, nb=nb, W=0,
                    rbase=np.zeros(nb, np.int32),
                    widx=np.zeros((nb, 0), np.int32),
                    sstep=np.zeros((nb, _BM, 0), np.int16)))
                i = j
                continue
            rbase = np.zeros(nb, np.int32)
            sstep = np.zeros((nb, W, _BM), np.int16)
            for b in range(i, j):
                lo_e, hi_e = blk_start[b], blk_end[b]
                if hi_e <= lo_e:
                    continue
                rb = int(rb16[b])
                rbase[b - i] = rb
                rr = ent_r_o[lo_e:hi_e] - rb
                mm = ent_slot_o[lo_e:hi_e] - b * _BM
                assert (rr >= 0).all() and (rr < W).all(), (rb, W)
                sstep[b - i, rr, mm] = (ent_s_o[lo_e:hi_e] + 1).astype(np.int16)
            widx = np.clip(rbase[:, None] + np.arange(W)[None, :], 0, R - 1)
            regions.append(PainterRegion(
                lo=i * _BM, nb=nb, W=W, rbase=rbase,
                widx=widx.astype(np.int32), sstep=sstep))
            i = j

        nxt_flat = np.minimum(nxt, _BIG).astype(np.int16).reshape(-1)
        return PainterStatics(
            regions=tuple(regions),
            globstep=np.minimum(globstep, _BIG).astype(np.int16),
            nxt_flat=nxt_flat, n_steps=S, n_slots=P,
            wide_slots=wide_slots, wide_sstep=wide_sstep,
            slots_of_compact=slots_of_compact,
        )


class PainterTables(NamedTuple):
    """Device-resident painter tables (jit arguments, never HLO constants)."""

    globstep: jnp.ndarray
    nxt_flat: jnp.ndarray
    region_widx: Tuple[jnp.ndarray, ...]
    region_sstep: Tuple[jnp.ndarray, ...]
    wide_slots: jnp.ndarray = None
    wide_sstep: jnp.ndarray = None


def make_painter_tables(pst: PainterStatics, device_put=True) -> PainterTables:
    import jax
    put = jax.device_put if device_put else jnp.asarray
    return PainterTables(
        globstep=put(jnp.asarray(pst.globstep)),
        nxt_flat=put(jnp.asarray(pst.nxt_flat)),
        region_widx=tuple(put(jnp.asarray(r.widx)) for r in pst.regions),
        region_sstep=tuple(put(jnp.asarray(r.sstep)) for r in pst.regions),
        wide_slots=put(jnp.asarray(pst.wide_slots)),
        wide_sstep=put(jnp.asarray(pst.wide_sstep)),
    )


def hit_steps(pst: PainterStatics, any_hit, first_c, first_k,
              t: PainterTables = None):
    """Per-beam (s_hit, s_tail) int16 from the raycast decode. [N,R] each.

    Gather-free: ``globstep[r, c, k] == globstep[r, c, 0] + k`` wherever the
    sample is valid (samples in a chunk are consecutive ray steps, and a
    real first hit is always a valid sample), so the chunk-base select runs
    as a [N, R, NC] masked reduce and the minor-run-end (``nxt``) lookup as
    a [N, R, S] masked reduce instead of two per-beam gathers.
    """
    gs = t.globstep if t is not None else jnp.asarray(pst.globstep)
    nxt = t.nxt_flat if t is not None else jnp.asarray(pst.nxt_flat)
    R, nc, K = pst.globstep.shape
    base = gs[:, :, 0].astype(jnp.int32)                     # [R, NC]
    c_iota = jnp.arange(nc, dtype=jnp.int32)
    hit_base = jnp.sum(
        jnp.where(first_c[..., None] == c_iota, base[None], 0), axis=-1)
    s_hit32 = hit_base + jnp.clip(first_k, 0, K - 1)
    s_hit = jnp.where(any_hit, s_hit32, _BIG)                # [N, R] i32
    s_iota = jnp.arange(pst.n_steps, dtype=jnp.int32)
    nxt2 = nxt.reshape(R, pst.n_steps).astype(jnp.int32)
    sel = (jnp.clip(s_hit, 0, pst.n_steps - 1)[..., None] == s_iota)
    s_tail32 = jnp.sum(jnp.where(sel, nxt2[None], 0), axis=-1)
    s_tail = jnp.where(any_hit, s_tail32, _BIG)
    return s_hit.astype(jnp.int16), s_tail.astype(jnp.int16)


def paint_sorted(pst: PainterStatics, s_hit, s_tail,
                 t: PainterTables = None):
    """Exact laser-mode view values [N, P'] f32 in {0, 200, 255}.

    s_hit/s_tail: [N, R] int16 per-beam thresholds (see hit_steps).
    """
    n = s_hit.shape[0]
    outs = []
    for ridx, reg in enumerate(pst.regions):
        if reg.W == 0:
            outs.append(jnp.full((n, reg.nb * _BM), float(CELL_UNSEEN),
                                 jnp.float32))
            continue
        widx = (t.region_widx[ridx] if t is not None
                else jnp.asarray(reg.widx))                  # [nb, W]
        tbl = (t.region_sstep[ridx] if t is not None
               else jnp.asarray(reg.sstep))                  # [nb, W, BM]
        sh = s_hit[:, widx.reshape(-1)].reshape(n, reg.nb, reg.W, 1)
        st = s_tail[:, widx.reshape(-1)].reshape(n, reg.nb, reg.W, 1)
        T = tbl[None].astype(jnp.int16)                      # [1, nb, W, BM]
        vis = T > 0
        # codes: 2 -> 255 (pre-hit), 3 -> 0 (the hit), 1 -> 200 (post-run),
        # 0 -> skip;   T = s+1
        code = jnp.where(
            T <= sh, jnp.int16(2),
            jnp.where(T == sh + 1, jnp.int16(3),
                      jnp.where(T > st, jnp.int16(1), jnp.int16(0))))
        w_pos = jnp.arange(reg.W, dtype=jnp.int16)[None, None, :, None]
        key = jnp.where(vis & (code > 0),
                        (w_pos << 2) | code, jnp.int16(-1))
        win = key.max(axis=2)                                # [n, nb, BM]
        c = win & 3
        val = jnp.where(
            win < 0, float(CELL_UNSEEN),
            jnp.where(c == 2, float(CELL_VIEW_FREE),
                      jnp.where(c == 3, 0.0, float(CELL_UNSEEN))))
        outs.append(val.reshape(n, reg.nb * _BM).astype(jnp.float32))
    vals = jnp.concatenate(outs, axis=1)[:, : pst.n_slots]

    # ---- wide near-sensor slots: dense rows over all beams --------------
    if pst.wide_slots is not None and pst.wide_slots.size:
        wt = (t.wide_sstep if t is not None
              else jnp.asarray(pst.wide_sstep))              # [ns, R]
        T = wt[None].astype(jnp.int16)                       # [1, ns, R]
        sh = s_hit[:, None, :]
        st = s_tail[:, None, :]
        code = jnp.where(
            (T > 0) & (T <= sh), jnp.int16(2),
            jnp.where((T > 0) & (T == sh + 1), jnp.int16(3),
                      jnp.where((T > 0) & (T > st), jnp.int16(1),
                                jnp.int16(0))))
        beam = jnp.arange(wt.shape[1], dtype=jnp.int16)[None, None, :]
        key = jnp.where(code > 0, (beam << 2) | code, jnp.int16(-1))
        win = key.max(axis=-1)
        c = win & 3
        wvals = jnp.where(
            win < 0, float(CELL_UNSEEN),
            jnp.where(c == 2, float(CELL_VIEW_FREE),
                      jnp.where(c == 3, 0.0, float(CELL_UNSEEN))))
        ws = (t.wide_slots if t is not None
              else jnp.asarray(pst.wide_slots))
        vals = vals.at[:, ws].set(wvals.astype(jnp.float32))
    return vals
