"""Device-resident P-frame encode pipeline (jnp/XLA).

The production device path of the encoder: one jitted program per P frame
performs the full macroblock layer as batched tensor ops —

  integer full-search ME (quadrant-SAD sweep over every MB at once)
  -> two-stage quarter-pel SATD refinement of all 9 partition jobs
  -> partition-mode / skip / intra-16 decision
  -> motion-compensated prediction at decoder granularity (per 4x4)
  -> 4x4 transform / quant / dequant / inverse / reconstruction
  -> chroma residual with 2x2 DC Hadamard
  -> zig-zag coefficient scan, nnz, cbp

The reference runs all of this as a serial per-MB loop
(lencod/src/slice.c:486 MB loop, md_low.c:104 encode_one_macroblock_low,
mv_search.c PartitionMotionSearch, block.c residual_transform_quant_*);
here every stage is one batched tensor program over all MBs (SURVEY §2.5
TP axis), integer-exact so every backend produces the same bits.

Approximations relative to the serial host path (decisions only — the
produced bitstream is exact and self-consistent by construction, because
residual coding and reconstruction mirror decoder semantics):
  - ME rate term uses an approximate MV predictor (zero during the
    integer sweep, a median of the integer-MV field during subpel)
    instead of the serial median of final neighbor MVs;
  - the skip candidate evaluates a skip MV approximated from the
    integer-MV field (the serializer later derives true P_Skip flags
    from the final committed motion, spec 8.4.1.1);
  - the intra-16 fallback cost uses source-plane neighbors; MBs that
    choose intra are re-encoded exactly on the host with reconstructed
    neighbors (they are rare in P pictures).

JM cost model mirrored from md_low: SAD + lambda*bits(integer stage),
Hadamard SATD + lambda*bits (fractional stage), mode bit penalties from
encoder.py MODE_BITS.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..common.tables import ZIGZAG_4x4
from . import quant as Q
from . import transform as T
from .interp import PAD, QPEL_TAB

# ---------------------------------------------------------------------------
# static tables
# ---------------------------------------------------------------------------

_ZZ = np.asarray(ZIGZAG_4x4, np.int32)

# se(v) bit length, indexed by |v| (symmetric: bitlen(2v) == bitlen(2v+1))
_SE_BITS = np.array([1] + [2 * int(2 * a).bit_length() - 1
                           for a in range(1, 4096)], np.int32)

# quarter-pel plane selection (interp.QPEL_TAB) as dense arrays [yf][xf]
_QP_P1 = np.zeros((4, 4), np.int32)
_QP_DX1 = np.zeros((4, 4), np.int32)
_QP_DY1 = np.zeros((4, 4), np.int32)
_QP_P2 = np.zeros((4, 4), np.int32)
_QP_DX2 = np.zeros((4, 4), np.int32)
_QP_DY2 = np.zeros((4, 4), np.int32)
for (xf, yf), (p1, dx1, dy1, p2, dx2, dy2) in QPEL_TAB.items():
    _QP_P1[yf, xf] = p1
    _QP_DX1[yf, xf] = dx1
    _QP_DY1[yf, xf] = dy1
    _QP_P2[yf, xf] = p2
    _QP_DX2[yf, xf] = dx2
    _QP_DY2[yf, xf] = dy2

# partition jobs: 0=16x16, 1/2=16x8 top/bottom, 3/4=8x16 left/right,
# 5..8 = 8x8 quadrants. QMASK[q, j] = quadrant q belongs to job j.
QMASK = np.zeros((4, 9), np.int32)
_JOB_QUADS = [(0, 1, 2, 3), (0, 1), (2, 3), (0, 2), (1, 3),
              (0,), (1,), (2,), (3,)]
for j, qs in enumerate(_JOB_QUADS):
    for q in qs:
        QMASK[q, j] = 1

# quadrant-level subpel jobs: each (parent job, quadrant)
QJ_PARENT = np.array([j for j, qs in enumerate(_JOB_QUADS) for _ in qs],
                     np.int32)                       # (16,)
QJ_QUAD = np.array([q for qs in _JOB_QUADS for q in qs], np.int32)
_JOB_QJOBS = [tuple(np.flatnonzero(QJ_PARENT == j)) for j in range(9)]


def _group_sums(x, groups):
    """Sum x's axis-1 entries per group: (N, K, ...) -> (N, len(groups),
    ...) as int adds (exact on every backend; a float matmul could run at
    an accelerator's reduced default precision)."""
    return jnp.stack([sum(x[:, i] for i in g) for g in groups], axis=1)

# mb_type / ref header bits per partition mode (encoder.py MODE_BITS)
MODE_BITS = np.array([1, 3, 3, 9], np.int32)
# partition geometry per mode: list of (job indices)
MODE_JOBS = [(0,), (1, 2), (3, 4), (5, 6, 7, 8)]
# per 4x4 block (raster), which job serves it under each mode
_BLK_JOB = np.zeros((4, 16), np.int32)
for m, jobs in enumerate(MODE_JOBS):
    for blk in range(16):
        by, bx = divmod(blk, 4)
        q = (by // 2) * 2 + (bx // 2)
        _BLK_JOB[m, blk] = next(j for j in jobs if QMASK[q, j])

_H4 = np.array([[1, 1, 1, 1],
                [1, 1, -1, -1],
                [1, -1, -1, 1],
                [1, -1, 1, -1]], np.int32)

# search candidate offsets for one refinement stage (8 neighbors + center
# first so ties keep the center, matching me.subpel_refine)
_DELTAS = [(0, 0)] + [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                      if (dx, dy) != (0, 0)]

# cbp quadrant membership for 4x4 luma blocks
_QB = np.array([[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13], [10, 11, 14, 15]],
               np.int32)


def _se_bits(v):
    return jnp.asarray(_SE_BITS)[jnp.clip(jnp.abs(v), 0, 4095)]


def _mvd_bits(mvx, mvy, px, py):
    return _se_bits(mvx - px) + _se_bits(mvy - py)


# ---------------------------------------------------------------------------
# reference preparation (device twin of interp.make_luma_planes / pad_plane)
# ---------------------------------------------------------------------------

def _conv6_h(x):
    x = x.astype(jnp.int32)
    return (x[:, 0:-5] - 5 * x[:, 1:-4] + 20 * x[:, 2:-3]
            + 20 * x[:, 3:-2] - 5 * x[:, 4:-1] + x[:, 5:])


def _conv6_v(x):
    x = x.astype(jnp.int32)
    return (x[0:-5, :] - 5 * x[1:-4, :] + 20 * x[2:-3, :]
            + 20 * x[3:-2, :] - 5 * x[4:-1, :] + x[5:, :])


def make_luma_planes_dev(plane: jnp.ndarray, pad: int = PAD) -> jnp.ndarray:
    """(H, W) uint8 -> (4, H+2p, W+2p) uint8 stacked [INT, B, H, J] planes,
    bit-identical to interp.make_luma_planes."""
    h, w = plane.shape
    ext = jnp.pad(plane, pad + 3, mode="edge").astype(jnp.int32)
    b1 = _conv6_h(ext)
    h1 = _conv6_v(ext)
    B = jnp.clip((b1 + 16) >> 5, 0, 255)
    H = jnp.clip((h1 + 16) >> 5, 0, 255)
    j1 = _conv6_v(b1)
    J = jnp.clip((j1 + 512) >> 10, 0, 255)
    p = pad
    INT = ext[3:3 + h + 2 * p, 3:3 + w + 2 * p]
    Bc = B[3:3 + h + 2 * p, 1:1 + w + 2 * p]
    Hc = H[1:1 + h + 2 * p, 3:3 + w + 2 * p]
    Jc = J[1:1 + h + 2 * p, 1:1 + w + 2 * p]
    return jnp.stack([INT, Bc, Hc, Jc]).astype(jnp.uint8)


@jax.jit
def prep_ref(Y: jnp.ndarray, U: jnp.ndarray, V: jnp.ndarray):
    """Device reference-picture prep: quarter-pel luma planes + padded
    chroma (encoder twin of lencod img_luma.c getSubImagesLuma:611)."""
    return (make_luma_planes_dev(Y),
            jnp.pad(U, PAD, mode="edge"),
            jnp.pad(V, PAD, mode="edge"))


# ---------------------------------------------------------------------------
# integer full-search sweep (all MBs, all partitions, one scan)
# ---------------------------------------------------------------------------

def me_int_sweep(origY, ref_int, mb_w: int, mb_h: int, sr: int, lam,
                 y0: int = -PAD, band_y0: int = 0):
    """Integer-pel full search over all 9 partition jobs at once.

    origY: (H, W) uint8 source plane (or an MB-row band of it).
    ref_int: padded integer plane (pad >= sr); row 0 = picture row y0.
    band_y0: picture row of origY's first row (0 for a full frame).
    Returns best integer MVs (N, 9, 2) int32.

    The (2*sr+1)^2 displacement sweep is a lax.scan whose step computes
    the whole frame's quadrant SADs for one displacement (the batched
    twin of lencod me_fullfast.c setup_fast_full_search:269); partition
    SADs are int32 sums of quadrant SADs in QMASK's job layout. Rate
    term: lambda * se_bits(4*d) (zero predictor approximation).
    """
    side = 2 * sr + 1
    h, w = mb_h * 16, mb_w * 16
    n = mb_w * mb_h
    # abs-diffs and quadrant sums are f32 adds of integers < 2^24 (exact
    # in any order); the 4 -> 9 partition sums are int32 adds
    # (_group_sums). Reductions stay on the minor axis (reshape-sum over
    # 8 lanes, then strided row adds) instead of one multi-axis reduce.
    region = lax.dynamic_slice(ref_int, (band_y0 - sr - y0, PAD - sr),
                               (h + 2 * sr, w + 2 * sr)).astype(jnp.float32)
    se_tab = jnp.asarray(_SE_BITS)
    o_frame = origY.astype(jnp.float32)
    bits_x = lam * se_tab[np.abs(4 * (np.arange(side) - sr))]  # (side,)

    def step(carry, dy):
        best_cost, best_idx = carry
        row = lax.dynamic_slice(region, (dy, 0), (h, w + 2 * sr))
        bits_y = lam * se_tab[jnp.abs(4 * (dy - sr))]
        # all horizontal displacements of this row are static slices
        for dx in range(side):
            d = jnp.abs(o_frame - row[:, dx:dx + w])
            d2 = d.reshape(h, w // 8, 8).sum(-1)          # (H, W/8)
            q8 = (d2[0::8] + d2[1::8] + d2[2::8] + d2[3::8]
                  + d2[4::8] + d2[5::8] + d2[6::8] + d2[7::8])
            sad_q = q8.reshape(mb_h, 2, mb_w, 2).transpose(0, 2, 1, 3) \
                .reshape(n, 4).astype(jnp.int32)
            cost = _group_sums(sad_q, _JOB_QUADS) + (bits_y + bits_x[dx])
            upd = cost < best_cost
            best_cost = jnp.where(upd, cost, best_cost)
            best_idx = jnp.where(upd, dy * side + dx, best_idx)
        return (best_cost, best_idx), None

    init = (jnp.full((n, 9), 2**30, jnp.int32), jnp.zeros((n, 9), jnp.int32))
    (cost, idx), _ = lax.scan(step, init, jnp.arange(side, dtype=jnp.int32))
    mv = jnp.stack([idx % side - sr, idx // side - sr], axis=-1)
    return mv, cost


# ---------------------------------------------------------------------------
# quarter-pel gather + SATD
# ---------------------------------------------------------------------------

def _gather_qpel(planes, x4, y4, bs: int, w: int, h: int, y0: int = -PAD):
    """One (bs, bs) block at quarter-pel (x4, y4) from the stacked plane
    set — device twin of interp.mc_luma_block.

    y0 is the picture row that plane-array row 0 corresponds to (-PAD for
    a full-frame plane set; band_start - HALO for an MB-row shard's local
    band, see parallel/sp_pipeline.py). x stays full-width."""
    xi, yi = x4 >> 2, y4 >> 2
    xf, yf = x4 & 3, y4 & 3
    xi = jnp.clip(xi, -PAD, w + PAD - bs - 1)
    yi = jnp.clip(yi, -PAD, h + PAD - bs - 1)
    p1 = jnp.asarray(_QP_P1)[yf, xf]
    a = lax.dynamic_slice(
        planes, (p1, yi - y0 + jnp.asarray(_QP_DY1)[yf, xf],
                 PAD + xi + jnp.asarray(_QP_DX1)[yf, xf]),
        (1, bs, bs))[0].astype(jnp.int32)
    p2 = jnp.asarray(_QP_P2)[yf, xf]
    b = lax.dynamic_slice(
        planes, (jnp.maximum(p2, 0),
                 yi - y0 + jnp.asarray(_QP_DY2)[yf, xf],
                 PAD + xi + jnp.asarray(_QP_DX2)[yf, xf]),
        (1, bs, bs))[0].astype(jnp.int32)
    return jnp.where(p2 < 0, a, (a + b + 1) >> 1)


def _satd8_raw(diff):
    """(..., 8, 8) int32 -> (...,) sum over the 4 4x4 tiles of
    sum|H d H^T| (no final >>1; applied by the caller after summing a
    partition's quadrants, me.satd semantics).

    Hadamard as two butterfly passes of int32 adds: exact on every
    backend. A float matmul form would be exact only at full f32
    precision, which the default matmul precision of an accelerator
    (bf16 or TF32 operands) does not give for these magnitudes."""
    d = diff.reshape(*diff.shape[:-2], 2, 4, 2, 4).swapaxes(-3, -2)
    d0, d1, d2, d3 = d[..., 0, :], d[..., 1, :], d[..., 2, :], d[..., 3, :]
    p0, p1, m0, m1 = d0 + d3, d1 + d2, d0 - d3, d1 - d2
    a = jnp.stack([p0 + p1, m0 + m1, p0 - p1, m0 - m1], axis=-2)
    e0, e1, e2, e3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    q0, q1, n0, n1 = e0 + e3, e1 + e2, e0 - e3, e1 - e2
    b = jnp.stack([q0 + q1, n0 + n1, q0 - q1, n0 - n1], axis=-1)
    return jnp.abs(b).sum(axis=(-4, -3, -2, -1))


def _gather_windows(planes, ax, ay, size: int, y0: int = -PAD):
    """One (4, size, size) all-planes window per qjob at integer plane
    coords (ax, ay) (top-left, relative to the unpadded picture)."""
    def one(x, y):
        return lax.dynamic_slice(planes, (0, y - y0, PAD + x),
                                 (4, size, size))
    return jax.vmap(jax.vmap(one))(ax, ay)


# stage-1 (half-pel) candidate -> (plane, ox, oy) window slice, for a
# window anchored 1 px up-left of the integer position. Candidate order
# follows _DELTAS.
_S1_SEL = []
for _dx, _dy in _DELTAS:
    if _dx == 0 and _dy == 0:
        _S1_SEL.append((0, 1, 1))
    elif _dy == 0:
        _S1_SEL.append((1, 0 if _dx < 0 else 1, 1))
    elif _dx == 0:
        _S1_SEL.append((2, 1, 0 if _dy < 0 else 1))
    else:
        _S1_SEL.append((3, 0 if _dx < 0 else 1, 0 if _dy < 0 else 1))


def subpel_refine_jobs(planes, orig_q, int_mv, pred, lam, mb_xy,
                       w: int, h: int, y0: int = -PAD):
    """Two-stage (half then quarter pel) 3x3 refinement of all 9 partition
    jobs of every MB, Hadamard SATD + lambda*bits cost.

    One (4-plane, 10x10) window gather per qjob per stage; every
    candidate block is then a static slice of the window (stage 1:
    single plane, since the stage-1 center is integer-pel; stage 2:
    two-plane average selected by the half-pel parity of the stage-1
    winner). This keeps the whole refinement in dense elementwise math
    instead of per-candidate gathers.

    orig_q: (N, 4, 8, 8); int_mv: (N, 9, 2) integer-pel; pred: (N, 2)
    approximate qpel MV predictor; mb_xy: (N, 2) MB pixel origin.
    Returns (mv_q (N, 9, 2) qpel, cost (N, 9)).
    """
    oq = orig_q[:, QJ_QUAD].astype(jnp.int32)          # (N, 16, 8, 8)
    qoff_x = jnp.asarray((QJ_QUAD % 2) * 8)
    qoff_y = jnp.asarray((QJ_QUAD // 2) * 8)
    bx_pix = mb_xy[:, 0:1] + qoff_x[None, :]           # (N, 16)
    by_pix = mb_xy[:, 1:2] + qoff_y[None, :]

    def mvd_cost(cand):
        bits = _mvd_bits(cand[..., 0], cand[..., 1],
                         pred[:, None, 0], pred[:, None, 1])
        return lam * bits

    def pick(best, cand_mv, cost, k):
        if k == 0:
            return cand_mv, cost
        best_mv, best_cost = best
        upd = cost < best_cost
        return (jnp.where(upd[..., None], cand_mv, best_mv),
                jnp.where(upd, cost, best_cost))

    # ---- stage 1: half-pel around the integer winner -------------------
    cmx = int_mv[:, QJ_PARENT, 0]
    cmy = int_mv[:, QJ_PARENT, 1]
    win = _gather_windows(planes, bx_pix + cmx - 1, by_pix + cmy - 1, 10,
                          y0).astype(jnp.int32)        # (N, 16, 4, 10, 10)
    center = int_mv * 4
    best = None
    for k, (dx, dy) in enumerate(_DELTAS):
        p, ox, oy = _S1_SEL[k]
        blk = win[:, :, p, oy:oy + 8, ox:ox + 8]
        satd_p = _group_sums(_satd8_raw(oq - blk), _JOB_QJOBS) >> 1
        cand = center + jnp.asarray([dx * 2, dy * 2], jnp.int32)
        best = pick(best, cand, satd_p + mvd_cost(cand), k)
    mv_h, cost_h = best

    # ---- stage 2: quarter-pel around the half-pel winner ---------------
    # window anchored at ((cx>>2)-1, (cy>>2)-1) covers the 3x3 qpel
    # neighborhood for either parity of the center component
    chx = mv_h[:, QJ_PARENT, 0]                        # (N, 16) qpel, even
    chy = mv_h[:, QJ_PARENT, 1]
    ax = bx_pix + (chx >> 2) - 1
    ay = by_pix + (chy >> 2) - 1
    win = _gather_windows(planes, ax, ay, 10, y0).astype(jnp.int32)
    px_even = (chx & 3) == 0                           # parity masks
    py_even = (chy & 3) == 0
    pxm = px_even[:, :, None, None]
    pym = py_even[:, :, None, None]

    def cand_block(dx, dy):
        """Quarter-pel candidate block at center+(dx,dy), built from the
        window by parity-selected static slices (interp.QPEL_TAB logic
        inlined for the four (cx&3, cy&3) in {0,2}^2 cases)."""
        # Per-axis tap descriptors: (use_pair, a_is_half, int_off,
        # half_off) — window-relative offsets of the integer-grid and
        # half-grid taps. Window rel coords: the center integer sample
        # sits at index 1.
        # parity even (c%4==0): d=-1 -> frac 3 (pair INT@1 + HALF@0);
        #   d=0 -> frac 0 (single INT@1); d=+1 -> frac 1 (INT@1+HALF@1).
        # parity odd (c%4==2): d=-1 -> frac 1 (INT@1+HALF@1);
        #   d=0 -> frac 2 (single HALF@1); d=+1 -> frac 3 (INT@2+HALF@1).
        def taps(d, even):
            if even:
                if d == -1:
                    return (1, 0, 1, 0)    # pair: INT@1 + HALF@0
                if d == 0:
                    return (0, 0, 1, 1)    # single INT@1
                return (1, 0, 1, 1)        # pair: INT@1 + HALF@1
            else:
                if d == -1:
                    return (1, 0, 1, 1)    # pair: INT@1 + HALF@1
                if d == 0:
                    return (0, 1, 1, 1)    # single HALF@1
                return (1, 0, 2, 1)        # pair: INT@2 + HALF@1
        # The 2-D QPEL_TAB structure: position (xf, yf) averages two
        # samples chosen per table; for the 3x3 neighborhood of an
        # even-parity center every candidate is either a plane sample or
        # the average of two plane samples whose plane ids follow from
        # the per-axis taps:
        #   frac (0,0)->INT, (2,0)->B, (0,2)->H, (2,2)->J (single)
        #   odd xf, even yf -> avg(INT/H row plane, B/J) etc.
        out = None
        for even_x in (False, True):
            for even_y in (False, True):
                ux, ax_is_h, ax_a, ax_b = taps(dx, even_x)
                uy, ay_is_h, ay_a, ay_b = taps(dy, even_y)
                # sample grid ids: plane = [INT,B,H,J][hx + 2*hy]
                if not ux and not uy:      # single sample
                    pl = (1 if ax_is_h else 0) + 2 * (1 if ay_is_h else 0)
                    ox = ax_b if ax_is_h else ax_a
                    oy = ay_b if ay_is_h else ay_a
                    b = win[:, :, pl, oy:oy + 8, ox:ox + 8]
                elif ux and not uy:        # horizontal pair
                    ph = 1 + 2 * (1 if ay_is_h else 0)   # B or J
                    pi = 0 + 2 * (1 if ay_is_h else 0)   # INT or H
                    oy = ay_b if ay_is_h else ay_a
                    a = win[:, :, pi, oy:oy + 8, ax_a:ax_a + 8]
                    b2 = win[:, :, ph, oy:oy + 8, ax_b:ax_b + 8]
                    b = (a + b2 + 1) >> 1
                elif uy and not ux:        # vertical pair
                    pv = 2 + (1 if ax_is_h else 0)       # H or J
                    pi = 0 + (1 if ax_is_h else 0)       # INT or B
                    ox = ax_b if ax_is_h else ax_a
                    a = win[:, :, pi, ay_a:ay_a + 8, ox:ox + 8]
                    b2 = win[:, :, pv, ay_b:ay_b + 8, ox:ox + 8]
                    b = (a + b2 + 1) >> 1
                else:                      # diagonal pair: avg(B, H)
                    a = win[:, :, 1, ay_a:ay_a + 8, ax_b:ax_b + 8]
                    b2 = win[:, :, 2, ay_b:ay_b + 8, ax_a:ax_a + 8]
                    b = (a + b2 + 1) >> 1
                m = (pxm if even_x else ~pxm) & (pym if even_y else ~pym)
                out = b if out is None else jnp.where(m, b, out)
        return out

    best = None
    for k, (dx, dy) in enumerate(_DELTAS):
        blk = cand_block(dx, dy)
        satd_p = _group_sums(_satd8_raw(oq - blk), _JOB_QJOBS) >> 1
        cand = mv_h + jnp.asarray([dx, dy], jnp.int32)
        best = pick(best, cand, satd_p + mvd_cost(cand), k)
    mv_q, cost_q = best
    # the stage-2 center must win ties exactly like the sequential search
    keep = cost_h <= cost_q
    return (jnp.where(keep[..., None], mv_h, mv_q),
            jnp.where(keep, cost_h, cost_q))


# ---------------------------------------------------------------------------
# approximate predictors from the integer 16x16 MV field
# ---------------------------------------------------------------------------

def approx_pred_field(mv16, mb_w: int, mb_h: int, up_halo=None,
                      is_first=True):
    """Median of (left, up, up-right) 16x16 integer MVs as an approximate
    per-MB predictor, in qpel units. Border MBs fall back per spec-ish
    rules (missing neighbors treated as zero, like out-of-picture).

    up_halo: optional (mb_w, 2) integer-MV row of the MB row just above
    this band (an MB-row shard's ppermute'd neighbor row; zeros for the
    topmost shard, which matches the full-frame zero row). is_first may
    be a traced bool: whether this band contains picture MB row 0."""
    f = (mv16 * 4).reshape(mb_h, mb_w, 2)
    z = jnp.zeros_like(f)
    if up_halo is None:
        up0 = z[:1]
        upr0 = z[:1]
    else:
        u = (up_halo * 4).reshape(1, mb_w, 2)
        up0 = u
        upr0 = jnp.concatenate([u[:, 1:], u[:, -1:]], axis=1)
    left = jnp.concatenate([z[:, :1], f[:, :-1]], axis=1)
    up = jnp.concatenate([up0, f[:-1]], axis=0)
    upr = jnp.concatenate([upr0, jnp.concatenate(
        [f[:-1, 1:], f[:-1, -1:]], axis=1)], axis=0)
    med = jnp.median(jnp.stack([left, up, upr]), axis=0).astype(jnp.int32)
    # only-A rule approximation: the picture's first MB row uses left
    row0 = (jnp.arange(mb_h) == 0)[:, None, None] & is_first
    med = jnp.where(row0, left, med)
    return med.reshape(mb_h * mb_w, 2)


# ---------------------------------------------------------------------------
# intra-16 source-neighbor cost (P-frame fallback decision)
# ---------------------------------------------------------------------------

def i16_source_cost(origY, mb_w: int, mb_h: int, top_halo=None,
                    is_first=True):
    """Per-MB best-of-4 Intra16x16 SAD using SOURCE neighbors (decision
    only; chosen MBs are re-coded exactly on the host).

    top_halo: optional (W,) source pixel row just above this band (for an
    MB-row shard); is_first (may be traced): band holds picture row 0,
    whose MBs have no top neighbor."""
    h, w = origY.shape
    o = origY.astype(jnp.int32)
    mbs = o.reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3)  # (mh,mw,16,16)
    # neighbor rows/cols from the source plane
    if top_halo is None:
        top_idx = jnp.maximum(jnp.arange(mb_h) * 16 - 1, 0)
        top_rows = o[top_idx]                                  # (mh, W)
    else:
        top_idx = jnp.arange(mb_h) * 16 - 1
        top_rows = jnp.concatenate(
            [top_halo[None].astype(jnp.int32), o], axis=0)[top_idx + 1]
    top = top_rows.reshape(mb_h, mb_w, 16)                     # (mh,mw,16)
    left_idx = jnp.maximum(jnp.arange(mb_w) * 16 - 1, 0)
    left = o[:, left_idx].reshape(mb_h, 16, mb_w).transpose(0, 2, 1)
    corner = top_rows[:, left_idx]                             # (mh, mw)
    row_has_top = (jnp.arange(mb_h) > 0) | jnp.logical_not(is_first)
    avail_t = row_has_top[:, None] & jnp.ones((1, mb_w), bool)
    avail_l = jnp.ones((mb_h, 1), bool) & (jnp.arange(mb_w) > 0)[None, :]

    sad = lambda p: jnp.abs(mbs - p).sum(axis=(2, 3))
    big = jnp.int32(2**28)
    # DC
    s_t = top.sum(axis=2)
    s_l = left.sum(axis=2)
    dc = jnp.where(avail_t & avail_l, (s_t + s_l + 16) >> 5,
                   jnp.where(avail_t, (s_t + 8) >> 4,
                             jnp.where(avail_l, (s_l + 8) >> 4, 128)))
    c_dc = sad(dc[:, :, None, None])
    # V / H
    c_v = jnp.where(avail_t, sad(top[:, :, None, :]), big)
    c_h = jnp.where(avail_l, sad(left[:, :, :, None]), big)
    # plane (spec 8.3.3.4): H = sum i*(p[7+i] - p[7-i]), p[-1] = corner
    iw = jnp.arange(1, 9, dtype=jnp.int32)
    top_ext = jnp.concatenate([corner[:, :, None], top], axis=2)  # p[-1..15]
    left_ext = jnp.concatenate([corner[:, :, None], left], axis=2)
    Hs = (iw[None, None] * (top_ext[:, :, 8 + iw] - top_ext[:, :, 8 - iw])).sum(axis=2)
    Vs = (iw[None, None] * (left_ext[:, :, 8 + iw] - left_ext[:, :, 8 - iw])).sum(axis=2)
    b = (5 * Hs + 32) >> 6
    c = (5 * Vs + 32) >> 6
    a = 16 * (top[:, :, 15] + left[:, :, 15])
    yy, xx = jnp.meshgrid(jnp.arange(16), jnp.arange(16), indexing="ij")
    pl = (a[:, :, None, None] + b[:, :, None, None] * (xx - 7)
          + c[:, :, None, None] * (yy - 7) + 16) >> 5
    pl = jnp.clip(pl, 0, 255)
    c_p = jnp.where(avail_t & avail_l, sad(pl), big)
    cost = jnp.minimum(jnp.minimum(c_dc, c_v), jnp.minimum(c_h, c_p))
    return cost.reshape(mb_h * mb_w)


# ---------------------------------------------------------------------------
# final MC at decoder granularity
# ---------------------------------------------------------------------------

def mc_luma_blocks(planes, mv4, mb_xy, w: int, h: int, y0: int = -PAD):
    """(N, 16, 2) qpel MVs -> (N, 16, 4, 4) int32 prediction blocks."""
    bx = (jnp.arange(16) % 4) * 4
    by = (jnp.arange(16) // 4) * 4
    x4 = (mb_xy[:, 0:1] + bx[None]) * 4 + mv4[..., 0]
    y4 = (mb_xy[:, 1:2] + by[None]) * 4 + mv4[..., 1]
    g = jax.vmap(jax.vmap(
        lambda a, b: _gather_qpel(planes, a, b, 4, w, h, y0)))
    return g(x4, y4)


def mc_luma_quads(planes, mv_quad, mb_xy, w: int, h: int, y0: int = -PAD):
    """Quadrant-granular luma MC (one MV per 8x8, the device decision
    granularity): (N, 4, 2) qpel MVs -> (N, 16, 16) int32 prediction.
    Bit-identical to mc_luma_blocks with the MV replicated per 4x4."""
    n = mv_quad.shape[0]
    qx = jnp.asarray([0, 8, 0, 8])
    qy = jnp.asarray([0, 0, 8, 8])
    x4 = (mb_xy[:, 0:1] + qx[None]) * 4 + mv_quad[..., 0]
    y4 = (mb_xy[:, 1:2] + qy[None]) * 4 + mv_quad[..., 1]
    g = jax.vmap(jax.vmap(
        lambda a, b: _gather_qpel(planes, a, b, 8, w, h, y0)))
    q = g(x4, y4)                                        # (N, 4, 8, 8)
    return q.reshape(n, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)


def mc_chroma_quads(padU, padV, mv_quad, mb_xy, w: int, h: int,
                    y0c: int = -PAD):
    """Quadrant-granular chroma MC: one 4x4 chroma block per 8x8 luma
    quadrant (same eighth-pel bilinear as mc_chroma_blocks). Returns
    (predU, predV) each (N, 8, 8) int32. y0c: chroma picture row of
    plane-array row 0 (-PAD full frame)."""
    n = mv_quad.shape[0]
    cw, chh = w // 2, h // 2
    qx = jnp.asarray([0, 4, 0, 4])
    qy = jnp.asarray([0, 0, 4, 4])
    x8 = (mb_xy[:, 0:1] // 2 + qx[None]) * 8 + mv_quad[..., 0]
    y8 = (mb_xy[:, 1:2] // 2 + qy[None]) * 8 + mv_quad[..., 1]

    def one(plane, x, y):
        xi, yi = x >> 3, y >> 3
        xf, yf = x & 7, y & 7
        xi = jnp.clip(xi, -PAD, cw + PAD - 4 - 1)
        yi = jnp.clip(yi, -PAD, chh + PAD - 4 - 1)
        R = lax.dynamic_slice(plane, (yi - y0c, PAD + xi), (5, 5)) \
            .astype(jnp.int32)
        a, b = R[:4, :4], R[:4, 1:]
        c, d = R[1:, :4], R[1:, 1:]
        return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b
                + (8 - xf) * yf * c + xf * yf * d + 32) >> 6

    gu = jax.vmap(jax.vmap(lambda a, b: one(padU, a, b)))
    gv = jax.vmap(jax.vmap(lambda a, b: one(padV, a, b)))
    u = gu(x8, y8).reshape(n, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 8, 8)
    v = gv(x8, y8).reshape(n, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 8, 8)
    return u, v


def mc_chroma_blocks(padU, padV, mv4, mb_xy, w: int, h: int):
    """Per luma-4x4 chroma MC (2x2 blocks, eighth-pel bilinear); returns
    (predU, predV) each (N, 16, 2, 2) int32. 4:2:0."""
    cw, chh = w // 2, h // 2
    bx = (jnp.arange(16) % 4) * 2
    by = (jnp.arange(16) // 4) * 2
    x8 = (mb_xy[:, 0:1] // 2 + bx[None]) * 8 + mv4[..., 0]
    y8 = (mb_xy[:, 1:2] // 2 + by[None]) * 8 + mv4[..., 1]

    def one(plane, x, y):
        xi, yi = x >> 3, y >> 3
        xf, yf = x & 7, y & 7
        xi = jnp.clip(xi, -PAD, cw + PAD - 2 - 1)
        yi = jnp.clip(yi, -PAD, chh + PAD - 2 - 1)
        R = lax.dynamic_slice(plane, (PAD + yi, PAD + xi), (3, 3)) \
            .astype(jnp.int32)
        a, b = R[:2, :2], R[:2, 1:]
        c, d = R[1:, :2], R[1:, 1:]
        return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b
                + (8 - xf) * yf * c + xf * yf * d + 32) >> 6

    gu = jax.vmap(jax.vmap(lambda a, b: one(padU, a, b)))
    gv = jax.vmap(jax.vmap(lambda a, b: one(padV, a, b)))
    return gu(x8, y8), gv(x8, y8)


# ---------------------------------------------------------------------------
# residual coding (decode-mirror, residual_np twins)
# ---------------------------------------------------------------------------

def _to_scan(blocks):
    """(..., 4, 4) -> (..., 16) zig-zag."""
    return blocks.reshape(*blocks.shape[:-2], 16)[..., jnp.asarray(_ZZ)]


def _from_scan(scan):
    out = jnp.zeros_like(scan)
    out = out.at[..., jnp.asarray(_ZZ)].set(scan)
    return out.reshape(*scan.shape[:-1], 4, 4)


# JM coefficient-thresholding tables (lencod block.c COEFF_COST4x4:72)
_CC4 = np.array([3, 2, 2, 1, 1, 1] + [0] * 10, np.int32)
_CC_BIG = 1 << 20


def _coeff_cost(scan, start: int = 0):
    """Vectorized run-weighted coefficient cost per scan array
    (..., 16) -> (...,); twin of residual_np.coeff_cost_scan."""
    s = scan[..., start:].astype(jnp.int32)
    k = s.shape[-1]
    nz = s != 0
    idx = jnp.broadcast_to(jnp.arange(k), s.shape)
    prev = lax.associative_scan(jnp.maximum, jnp.where(nz, idx, -1),
                                axis=-1)
    prev = jnp.concatenate(
        [jnp.full((*s.shape[:-1], 1), -1, prev.dtype), prev[..., :-1]],
        axis=-1)
    run = idx - prev - 1
    c = jnp.where(jnp.abs(s) > 1, _CC_BIG,
                  jnp.asarray(_CC4)[jnp.clip(run, 0, 15)])
    return jnp.where(nz, c, 0).sum(axis=-1)


def luma_residual_inter(orig, pred, qp):
    """orig/pred: (N, 16, 16) -> (scan (N,16,16) i32, nnz (N,16),
    cbp_luma (N,), recon (N,16,16) u8). Applies JM's inter coefficient
    thresholding (macroblock.c:901,1248) before reconstruction."""
    n = orig.shape[0]
    res = orig.astype(jnp.int32) - pred.astype(jnp.int32)
    blocks = res.reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 16, 4, 4)
    wt = T.forward4x4(blocks)
    qpv = jnp.broadcast_to(qp, (n, 16))
    lev = Q.quant_4x4(wt, qpv, False)
    scan = _to_scan(lev)
    # thresholding: per 8x8 quadrant <= 4, then whole MB <= 5
    cost_blk = _coeff_cost(scan)                       # (N, 16)
    cost_q = cost_blk[:, jnp.asarray(_QB)].sum(axis=2)  # (N, 4)
    keep_q = cost_q > 4
    total = jnp.where(keep_q, cost_q, 0).sum(axis=1)
    keep_mb = total > 5
    blk_q = jnp.asarray([(b // 8) * 2 + ((b % 4) // 2) for b in range(16)])
    keep_blk = jnp.take_along_axis(
        keep_q, jnp.broadcast_to(blk_q, (n, 16)), axis=1) \
        & keep_mb[:, None]
    scan = jnp.where(keep_blk[..., None], scan, 0)
    d = Q.dequant_4x4(_from_scan(scan), qpv)
    r = T.inverse4x4_round(d)
    pred_b = pred.astype(jnp.int32).reshape(n, 4, 4, 4, 4) \
        .transpose(0, 1, 3, 2, 4).reshape(n, 16, 4, 4)
    rec = jnp.clip(pred_b + r, 0, 255)
    rec = rec.reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16).astype(jnp.uint8)
    nnz = (scan != 0).sum(axis=2).astype(jnp.int32)
    qnnz = nnz[:, jnp.asarray(_QB)].sum(axis=2)        # (N, 4)
    cbp = ((qnnz > 0).astype(jnp.int32)
           * jnp.asarray([1, 2, 4, 8], jnp.int32)[None]).sum(axis=1)
    return scan, nnz, cbp, rec


def chroma_residual_inter(origU, origV, predU, predV, qpc):
    """4:2:0 chroma residual for all MBs; origU/V (N, 8, 8), predU/V
    (N, 8, 8) int32. Returns (dc (N,2,4), ac_scan (N,2,4,16), nnz (N,2,4),
    cbp_chroma (N,), recU, recV (N,8,8) u8). Mirrors encoder
    _code_chroma_residual + residual_np.recon_chroma exactly."""
    n = origU.shape[0]
    o = jnp.stack([origU, origV], axis=1).astype(jnp.int32)   # (N,2,8,8)
    p = jnp.stack([predU, predV], axis=1).astype(jnp.int32)
    res = o - p
    blocks = res.reshape(n, 2, 2, 4, 2, 4).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(n, 2, 4, 4, 4)
    wt = T.forward4x4(blocks)
    dcs = wt[..., 0, 0]                                        # (N,2,4)
    dc_t = T.hadamard2x2(dcs.reshape(n, 2, 2, 2))
    qpv = jnp.broadcast_to(qpc, (n, 2))
    dc_lev = Q.quant_chroma_dc(dc_t, qpv[..., None, None], False) \
        .reshape(n, 2, 4)
    ac = Q.quant_4x4(wt, qpv[..., None], False)
    ac_scan = _to_scan(ac)
    ac_scan = ac_scan.at[..., 0].set(0)
    # per-component chroma AC thresholding (block.c:1141, strict <)
    cost_c = _coeff_cost(ac_scan, start=1).sum(axis=2)         # (N, 2)
    ac_scan = jnp.where((cost_c >= 4)[..., None, None], ac_scan, 0)
    any_ac = (ac_scan[..., 1:] != 0).any(axis=(1, 2, 3))       # (N,)
    any_dc = (dc_lev != 0).any(axis=(1, 2))
    cbp_c = jnp.where(any_ac, 2, jnp.where(any_dc, 1, 0)).astype(jnp.int32)
    ac_scan = jnp.where((cbp_c < 2)[:, None, None, None],
                        jnp.zeros_like(ac_scan), ac_scan)
    dc_lev = jnp.where((cbp_c == 0)[:, None, None],
                       jnp.zeros_like(dc_lev), dc_lev)
    nnz = (ac_scan[..., 1:] != 0).sum(axis=3).astype(jnp.int32)
    # recon (recon_chroma twin)
    d4 = Q.dequant_4x4(_from_scan(ac_scan), qpv[..., None])
    f = T.hadamard2x2(dc_lev.reshape(n, 2, 2, 2).astype(jnp.int32))
    scale = jnp.asarray(Q.FLAT_INV_SCALE_4x4)[qpv, 0, 0][..., None, None]
    dc_s = ((f * scale) << (qpv[..., None, None] // 6)) >> 5   # (N,2,2,2)
    d4 = d4.at[..., 0, 0].set(dc_s.reshape(n, 2, 4))
    r = T.inverse4x4_round(d4)                                 # (N,2,4,4,4)
    pred_b = p.reshape(n, 2, 2, 4, 2, 4).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(n, 2, 4, 4, 4)
    rec = jnp.clip(pred_b + r, 0, 255)
    rec = rec.reshape(n, 2, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(n, 2, 8, 8).astype(jnp.uint8)
    return dc_lev, ac_scan, nnz, cbp_c, rec[:, 0], rec[:, 1]


# ---------------------------------------------------------------------------
# band-window machinery (gather-free data-dependent window extraction)
#
# Instead of vmapped multi-axis dynamic_slice gathers (one per window):
# (1) a dense per-MB-column "band" rearrangement of the reference planes
# (pure slices/reshapes), so every window's columns live inside its MB's
# band; (2) a row gather whose slices are full contiguous band rows;
# (3) column extraction as a one-hot dot_general (exact on any backend
# and at any matmul precision: u8 values and one-hot weights are exactly
# representable in bf16, and each output sums exactly one nonzero
# product, accumulated in f32).
# ---------------------------------------------------------------------------

def band_geometry(sr: int):
    """(offset, width) of the per-MB-column luma band for search range sr:
    band m spans picture columns [16m - off, 16m - off + width)."""
    off = sr + 8
    width = -(-(16 + 2 * off) // 32) * 32
    off = (width - 16) // 2
    if off > PAD:
        raise ValueError(f"search range {sr} exceeds plane padding")
    return off, width


def cband_geometry(sr: int):
    off = (4 * sr + 6) // 8 + 3
    width = -(-(8 + 2 * off) // 16) * 16
    off = (width - 8) // 2
    if off > PAD:
        raise ValueError(f"search range {sr} exceeds chroma padding")
    return off, width


def build_band(planes, mb_w: int, sr: int):
    """(4, Hp, Wp) u8 -> (mb_w, 4, Hp, BW) u8 per-MB-column bands."""
    off, bw = band_geometry(sr)
    hp = planes.shape[1]
    chunks = []
    for k in range(bw // 16):
        s = PAD - off + 16 * k
        c = lax.slice_in_dim(planes, s, s + 16 * mb_w, axis=2)
        c = c.reshape(4, hp, mb_w, 16).transpose(2, 0, 1, 3)
        chunks.append(c)
    return jnp.concatenate(chunks, axis=3)


def build_cband(padU, padV, mb_w: int, sr: int):
    """padded U/V -> (mb_w, 2, Hc+2P, BWC) u8 chroma bands."""
    off, bw = cband_geometry(sr)
    uv = jnp.stack([padU, padV])                   # (2, Hcp, Wcp)
    hp = uv.shape[1]
    chunks = []
    for k in range(bw // 8):
        s = PAD - off + 8 * k
        c = lax.slice_in_dim(uv, s, s + 8 * mb_w, axis=2)
        c = c.reshape(2, hp, mb_w, 8).transpose(2, 0, 1, 3)
        chunks.append(c)
    return jnp.concatenate(chunks, axis=3)


def _band_rows(band, mb_idx, r0, nrows: int):
    """Row gather: (Q,) mb_idx, (Q,) r0 (plane-array row of window top)
    -> (Q, P, nrows, BW). Slices are contiguous full band rows."""
    p, bw = band.shape[1], band.shape[3]

    def one(m, r):
        return lax.dynamic_slice(band, (m, 0, r, 0), (1, p, nrows, bw))[0]
    return jax.vmap(one)(mb_idx, r0)


def _col_extract(w_rows, c0, ncols: int):
    """One-hot column extraction: (Q, P, R, BW) x (Q,) c0 ->
    (Q, P, R, ncols) int16. Exact (see module note)."""
    q, p, r, bw = w_rows.shape
    C = (c0[:, None, None] + jnp.arange(ncols)[None, None, :]
         == jnp.arange(bw)[None, :, None]).astype(jnp.bfloat16)
    w = jax.lax.dot_general(
        w_rows.astype(jnp.bfloat16).reshape(q, p * r, bw), C,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    return w.astype(jnp.int16).reshape(q, p, r, ncols)


# dense quarter-pel tap table: position t in [1, 7] relative to a window
# anchored one integer sample up-left of the integer MV. For (tx, ty):
# sample = plane[p1][yi+dy1, xi+dx1] (+ plane[p2][...] avg) with all
# offsets static per grid position (QPEL_TAB inlined).
def _qpel_block_at(win, tx: int, ty: int, bs: int = 8):
    xi, xf = tx >> 2, tx & 3
    yi, yf = ty >> 2, ty & 3
    p1, dx1, dy1, p2, dx2, dy2 = QPEL_TAB[(xf, yf)]
    a = win[:, p1, yi + dy1:yi + dy1 + bs, xi + dx1:xi + dx1 + bs] \
        .astype(jnp.int32)
    if p2 < 0:
        return a
    b = win[:, p2, yi + dy2:yi + dy2 + bs, xi + dx2:xi + dx2 + bs] \
        .astype(jnp.int32)
    return (a + b + 1) >> 1


def qpel_refine_dense(band, orig_q, int_mv, pred, lam, mb_xy, sr: int,
                      y0: int = 0):
    """Two-stage (half, then quarter) 3x3 refinement of all 9 partition
    jobs per MB, evaluated DENSELY: SATD at every position of the 7x7
    quarter-pel grid around each job's integer MV (all static slices of
    one 10x10 4-plane window per qjob), then the exact sequential
    two-stage argmin (center-first tie order of the serial search)
    applied to the cost grid. Bit-identical decisions to
    subpel_refine_jobs, ~10x faster.

    y0: picture row of band-array row 0 (-PAD handled internally; pass 0
    for full-frame bands built by build_band).
    Returns (mv_q (N, 9, 2) qpel, cost (N, 9))."""
    n = int_mv.shape[0]
    off, _bw = band_geometry(sr)
    oq = orig_q[:, QJ_QUAD].astype(jnp.int32)            # (N, 16, 8, 8)
    qoff_x = jnp.asarray((QJ_QUAD % 2) * 8)
    qoff_y = jnp.asarray((QJ_QUAD // 2) * 8)
    cmx = int_mv[:, QJ_PARENT, 0]                        # (N, 16)
    cmy = int_mv[:, QJ_PARENT, 1]
    mb_idx = jnp.broadcast_to((mb_xy[:, 0:1] // 16), cmx.shape)
    r0 = (mb_xy[:, 1:2] - y0) + qoff_y[None, :] + cmy - 1 + PAD
    c0 = qoff_x[None, :] + cmx - 1 + off
    rows = _band_rows(band, mb_idx.reshape(-1), r0.reshape(-1), 10)
    win = _col_extract(rows, c0.reshape(-1), 10)         # (NQ,4,10,10) i16

    # SATD at every 7x7 grid position, accumulated to job level
    grid = []
    for ty in range(1, 8):
        for tx in range(1, 8):
            blk = _qpel_block_at(win, tx, ty)
            grid.append(_satd8_raw(oq.reshape(-1, 8, 8) - blk)
                        .reshape(n, 16))
    grid = _group_sums(jnp.stack(grid, axis=-1), _JOB_QJOBS) >> 1
    grid = grid.reshape(n, 9, 7, 7)                      # [.., ty-1, tx-1]

    # rate term: lambda * se_bits(mv - pred) per axis, outer-added
    se = jnp.asarray(_SE_BITS)
    tj = jnp.arange(1, 8)
    mvx_all = 4 * int_mv[..., 0:1] + (tj - 4)[None, None]   # (N, 9, 7)
    mvy_all = 4 * int_mv[..., 1:2] + (tj - 4)[None, None]
    bits_x = se[jnp.clip(jnp.abs(mvx_all - pred[:, None, 0:1]), 0, 4095)]
    bits_y = se[jnp.clip(jnp.abs(mvy_all - pred[:, None, 1:2]), 0, 4095)]
    cost = grid + lam * (bits_y[..., :, None] + bits_x[..., None, :])

    # stage 1: strict-< scan over the 9 half-pel positions in _DELTAS
    # order (center first) — exact tie semantics of the serial search
    best = None
    for (dx, dy) in _DELTAS:
        c = cost[..., 3 + 2 * dy, 3 + 2 * dx]
        if best is None:
            best = (c, jnp.zeros_like(c), jnp.zeros_like(c))
        else:
            bc, bdx, bdy = best
            upd = c < bc
            best = (jnp.where(upd, c, bc),
                    jnp.where(upd, dx, bdx), jnp.where(upd, dy, bdy))
    cost_h, hdx, hdy = best

    # stage 2: strict-< scan over the 3x3 quarter neighborhood of the
    # half winner (center = the half winner itself, kept on ties)
    best = None
    for (dx, dy) in _DELTAS:
        c = jnp.zeros_like(cost_h)
        for sx in (-1, 0, 1):
            for sy in (-1, 0, 1):
                sel = (hdx == sx) & (hdy == sy)
                c = jnp.where(sel, cost[..., 3 + 2 * sy + dy,
                                        3 + 2 * sx + dx], c)
        if best is None:
            best = (c, jnp.zeros_like(c), jnp.zeros_like(c))
        else:
            bc, bdx, bdy = best
            upd = c < bc
            best = (jnp.where(upd, c, bc),
                    jnp.where(upd, dx, bdx), jnp.where(upd, dy, bdy))
    cost_q, qdx, qdy = best
    mvq = jnp.stack([4 * int_mv[..., 0] + 2 * hdx + qdx,
                     4 * int_mv[..., 1] + 2 * hdy + qdy], axis=-1)
    return mvq.astype(jnp.int32), cost_q, win


def qjob_pred_blocks(win, mv_q, int_mv):
    """Extract each qjob's final 8x8 prediction block from the refine
    windows by a 49-way static select at its chosen sub-pel offset.

    win: (N*16, 4, 10, 10) int16 windows from qpel_refine_dense;
    mv_q: (N, 9, 2) chosen qpel MVs; int_mv: (N, 9, 2) integer MVs.
    Returns (N, 16, 8, 8) int32 predictions (QJ order)."""
    n = mv_q.shape[0]
    tx = (mv_q[..., 0] - 4 * int_mv[..., 0] + 4)[:, QJ_PARENT]   # (N, 16)
    ty = (mv_q[..., 1] - 4 * int_mv[..., 1] + 4)[:, QJ_PARENT]
    txf = tx.reshape(-1)
    tyf = ty.reshape(-1)
    out = jnp.zeros((n * 16, 8, 8), jnp.int32)
    for t_y in range(1, 8):
        for t_x in range(1, 8):
            blk = _qpel_block_at(win, t_x, t_y)
            sel = ((txf == t_x) & (tyf == t_y))[:, None, None]
            out = jnp.where(sel, blk, out)
    return out.reshape(n, 16, 8, 8)


def mc_luma_quads_band(band, mv_quad, mb_xy, sr: int, y0: int = 0):
    """Quadrant-granular luma MC from bands: (N, 4, 2) qpel MVs ->
    (N, 16, 16) int32 prediction; bit-identical to mc_luma_quads."""
    n = mv_quad.shape[0]
    off, _bw = band_geometry(sr)
    qx = jnp.asarray([0, 8, 0, 8])
    qy = jnp.asarray([0, 0, 8, 8])
    x4 = mv_quad[..., 0]
    y4 = mv_quad[..., 1]
    xi, xf = x4 >> 2, x4 & 3                              # (N, 4)
    yi, yf = y4 >> 2, y4 & 3
    mb_idx = jnp.broadcast_to(mb_xy[:, 0:1] // 16, xi.shape)
    r0 = (mb_xy[:, 1:2] - y0) + qy[None] + yi + PAD
    c0 = qx[None] + xi + off
    rows = _band_rows(band, mb_idx.reshape(-1), r0.reshape(-1), 9)
    win = _col_extract(rows, c0.reshape(-1), 9)           # (N4,4,9,9) i16

    # runtime (xf, yf) -> 16-combo select of static tap blocks
    xf = xf.reshape(-1)
    yf = yf.reshape(-1)
    out = None
    for fy in range(4):
        for fx in range(4):
            p1, dx1, dy1, p2, dx2, dy2 = QPEL_TAB[(fx, fy)]
            a = win[:, p1, dy1:dy1 + 8, dx1:dx1 + 8].astype(jnp.int32)
            blk = a if p2 < 0 else \
                (a + win[:, p2, dy2:dy2 + 8, dx2:dx2 + 8]
                 .astype(jnp.int32) + 1) >> 1
            m = ((xf == fx) & (yf == fy))[:, None, None]
            out = blk if out is None else jnp.where(m, blk, out)
    q = out.reshape(n, 2, 2, 8, 8)
    return q.transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)


def mc_chroma_quads_band(cband, mv_quad, mb_xy, sr: int, y0c: int = 0):
    """Quadrant-granular chroma MC from chroma bands; bit-identical to
    mc_chroma_quads. Returns (predU, predV) each (N, 8, 8) int32."""
    n = mv_quad.shape[0]
    off, _bw = cband_geometry(sr)
    qx = jnp.asarray([0, 4, 0, 4])
    qy = jnp.asarray([0, 0, 4, 4])
    x8 = qx[None] * 8 + mv_quad[..., 0]                   # rel MB, eighth
    y8 = qy[None] * 8 + mv_quad[..., 1]
    xi, xf = x8 >> 3, x8 & 7
    yi, yf = y8 >> 3, y8 & 7
    mb_idx = jnp.broadcast_to(mb_xy[:, 0:1] // 16, xi.shape)
    r0 = (mb_xy[:, 1:2] // 2 - y0c) + yi + PAD
    c0 = xi + off
    rows = _band_rows(cband, mb_idx.reshape(-1), r0.reshape(-1), 5)
    win = _col_extract(rows, c0.reshape(-1), 5).astype(jnp.int32)
    a = win[:, :, :4, :4]
    b = win[:, :, :4, 1:]
    c = win[:, :, 1:, :4]
    d = win[:, :, 1:, 1:]
    xfq = xf.reshape(-1)[:, None, None, None]
    yfq = yf.reshape(-1)[:, None, None, None]
    blk = ((8 - xfq) * (8 - yfq) * a + xfq * (8 - yfq) * b
           + (8 - xfq) * yfq * c + xfq * yfq * d + 32) >> 6  # (N4,2,4,4)
    uv = blk.reshape(n, 2, 2, 2, 4, 4).transpose(0, 3, 1, 4, 2, 5) \
        .reshape(n, 2, 8, 8)
    return uv[:, 0], uv[:, 1]


def skip_cost_band(band, skip_mv, mb_xy, orig_q, sr: int, y0: int = 0):
    """SAD of the whole MB predicted at the (approximate) skip MV, via
    band windows; bit-identical to the former per-quadrant gather."""
    n = skip_mv.shape[0]
    mv4 = jnp.broadcast_to(skip_mv[:, None, :], (n, 4, 2))
    pred16 = mc_luma_quads_band(band, mv4, mb_xy, sr, y0)
    o = orig_q.astype(jnp.int32).reshape(n, 2, 2, 8, 8) \
        .transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
    return jnp.abs(o - pred16).sum(axis=(1, 2))


# ---------------------------------------------------------------------------
# the full P-frame step
# ---------------------------------------------------------------------------

def _p_frame_core(origY, origU, origV, planes, padU, padV,
                  qp, qpc, lam, lam4, *, mb_w: int, mb_h: int, sr: int,
                  rd: bool = False):
    """Shared body of the whole-picture P encode (single reference):
    ME/subpel/mode/skip/MC/residual/recon as batched tensor ops.
    rd=True swaps the md_low cost-based decisions for the batched
    md_high trial-encode RD of ops/enc_rd.py (exact bits + SSD)."""
    n = mb_w * mb_h
    h, w = mb_h * 16, mb_w * 16
    mb_xy = jnp.stack([(jnp.arange(n) % mb_w) * 16,
                       (jnp.arange(n) // mb_w) * 16], axis=1).astype(jnp.int32)
    orig_mbs = origY.reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3) \
        .reshape(n, 16, 16)
    orig_q = orig_mbs.reshape(n, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 4, 8, 8).astype(jnp.int16)

    # 0. per-MB-column bands (gather-free window source; see band-window
    #    machinery above)
    band = build_band(planes, mb_w, sr)
    cband = build_cband(padU, padV, mb_w, sr)

    # 1. integer sweep (zero-predictor rate term)
    int_mv, _ = me_int_sweep(origY, planes[0], mb_w, mb_h, sr, lam)

    # 2. approximate qpel predictor from the integer 16x16 field
    pred = approx_pred_field(int_mv[:, 0], mb_w, mb_h)

    # 3. subpel refinement of all 9 jobs (dense 7x7 qpel cost grid)
    mv_q, cost_q, _win = qpel_refine_dense(band, orig_q, int_mv, pred,
                                           lam, mb_xy, sr)

    # 4. partition mode decision (SATD-scale; also the intra trigger)
    mode_costs = jnp.stack(
        [cost_q[:, list(jobs)].sum(axis=1) + lam * int(MODE_BITS[m])
         for m, jobs in enumerate(MODE_JOBS)], axis=1)        # (N, 4)
    best_mode = jnp.argmin(mode_costs, axis=1).astype(jnp.int32)
    cost_inter = jnp.min(mode_costs, axis=1)

    # 5. skip candidate: SAD at the approximate skip MV (plain SAD,
    #    md_low twin); serializer derives true P_Skip from final motion
    skip_mv = pred                                             # (N, 2)
    cost_skip = skip_cost_band(band, skip_mv, mb_xy, orig_q, sr)
    take_skip = cost_skip <= cost_inter
    cost_inter = jnp.minimum(cost_inter, cost_skip)

    # 6. intra-16 fallback decision (source neighbors)
    cost_i16 = i16_source_cost(origY, mb_w, mb_h)
    intra_mask = cost_i16 + 2 * lam4 < cost_inter

    orig_u = origU.reshape(mb_h, 8, mb_w, 8).transpose(0, 2, 1, 3).reshape(n, 8, 8)
    orig_v = origV.reshape(mb_h, 8, mb_w, 8).transpose(0, 2, 1, 3).reshape(n, 8, 8)

    if rd:
        # md_high tier on device: exact trial-encode RD (ops/enc_rd.py),
        # pruned per MB to the top-2 SATD-ranked partition modes (the
        # md_highfast-style preselection; P_Skip always survives)
        from .enc_rd import p_mode_rd_device
        r = p_mode_rd_device(band, cband, _win, mv_q, int_mv, pred,
                             orig_q, orig_u, orig_v, mb_xy, qp, qpc,
                             mb_w=mb_w, mb_h=mb_h, sr=sr,
                             mode_satd=mode_costs, top_modes=2)
        best_mode = r["inter_mode"]
        mv_quad = r["mv_quad"]
        scan = r["luma_scan"]
        nnz = r["luma_nnz"]
        cbp_full = r["cbp"]
        cdc = r["chroma_dc"]
        cac = r["chroma_scan"]
        cnnz = r["chroma_nnz"]
        recY_mbs = r["recY_mbs"]
        recU_mbs = r["recU_mbs"]
        recV_mbs = r["recV_mbs"]
        blk_quad = jnp.asarray(
            [(b // 8) * 2 + ((b % 4) // 2) for b in range(16)])
        mv4 = mv_quad[:, blk_quad]
    else:
        # 7. final motion field (quadrant-granular: one MV per 8x8 is
        #    the decision granularity of the 9-job search)
        quad_job = jnp.asarray(_BLK_JOB[:, [0, 2, 8, 10]])[best_mode]
        mv_quad = jnp.take_along_axis(mv_q, quad_job[..., None], axis=1)
        mv_quad = jnp.where(
            take_skip[:, None, None],
            jnp.broadcast_to(skip_mv[:, None, :], mv_quad.shape),
            mv_quad)
        best_mode = jnp.where(take_skip, 0, best_mode)
        blk_quad = jnp.asarray(
            [(b // 8) * 2 + ((b % 4) // 2) for b in range(16)])
        mv4 = mv_quad[:, blk_quad]                             # (N, 16, 2)

        # 8. prediction + residual + recon
        pred_y16 = mc_luma_quads_band(band, mv_quad, mb_xy, sr)
        scan, nnz, cbp_l, recY_mbs = luma_residual_inter(
            orig_mbs, pred_y16, qp)
        pred_u, pred_v = mc_chroma_quads_band(cband, mv_quad, mb_xy, sr)
        cdc, cac, cnnz, cbp_c, recU_mbs, recV_mbs = chroma_residual_inter(
            orig_u, orig_v, pred_u, pred_v, qpc)
        cbp_full = (cbp_c << 4) | cbp_l

    recY = recY_mbs.reshape(mb_h, mb_w, 16, 16).transpose(0, 2, 1, 3) \
        .reshape(h, w)
    recU = recU_mbs.reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(h // 2, w // 2)
    recV = recV_mbs.reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(h // 2, w // 2)

    return {
        "inter_mode": best_mode,
        "mv4": mv4,
        "luma_scan": scan.astype(jnp.int16),
        "luma_nnz": nnz,
        "cbp": cbp_full,
        "chroma_dc": cdc.astype(jnp.int16),
        "chroma_scan": cac.astype(jnp.int16),
        "chroma_nnz": cnnz,
        "intra_mask": intra_mask,
        "recY": recY, "recU": recU, "recV": recV,
    }


@functools.partial(jax.jit,
                   static_argnames=("mb_w", "mb_h", "sr", "rd"))
def p_frame_step(origY, origU, origV, planes, padU, padV,
                 qp, qpc, lam, lam4, *, mb_w: int, mb_h: int, sr: int,
                 rd: bool = False):
    """One device dispatch encoding a whole P picture (single reference).

    Returns a dict of decision + coefficient + reconstruction tensors the
    host commits into PictureData (see encoder._encode_p_frame_device).
    rd=True: batched md_high trial-encode decisions (enc_rd.py).
    """
    return _p_frame_core(origY, origU, origV, planes, padU, padV,
                         qp, qpc, lam, lam4, mb_w=mb_w, mb_h=mb_h,
                         sr=sr, rd=rd)


@functools.partial(jax.jit, static_argnames=("mb_w", "mb_h"))
def p_frame_bs(luma_nnz, mv4, *, mb_w: int, mb_h: int):
    """Boundary strengths of the committed all-inter single-ref P
    picture (pipelined path)."""
    from .deblock_jax import compute_bs_jax
    n = mb_w * mb_h
    zeros = jnp.zeros(n, jnp.int32)
    ref0 = jnp.full((n, 4), 7, jnp.int32)
    refm1 = jnp.full((n, 4), -1, jnp.int32)
    return compute_bs_jax(zeros.astype(jnp.int8), luma_nnz, zeros,
                          mv4, jnp.zeros_like(mv4), ref0, refm1,
                          mb_w, mb_h)


@jax.jit
def pack_syntax(inter_mode, mv4, luma_scan, luma_nnz, cbp, chroma_dc,
                chroma_scan, chroma_nnz, intra_mask):
    """int8-pack the syntax tensors for the host download; `ovf` flags
    any |level| > 127 (caller falls back to the wide tensors)."""
    ovf = ((jnp.abs(luma_scan) > 127).any()
           | (jnp.abs(chroma_scan) > 127).any())
    return {
        "inter_mode": inter_mode.astype(jnp.int8),
        "mv_quad": mv4[:, jnp.asarray([0, 2, 8, 10])].astype(jnp.int8),
        "luma8": luma_scan.astype(jnp.int8),
        "luma_nnz8": luma_nnz.astype(jnp.int8),
        "cbp8": cbp.astype(jnp.uint8),
        "chroma_dc": chroma_dc,
        "chroma8": chroma_scan.astype(jnp.int8),
        "chroma_nnz8": chroma_nnz.astype(jnp.int8),
        "intra_any": intra_mask.any(),
        "ovf": ovf,
    }


@functools.partial(jax.jit,
                   static_argnames=("mb_w", "mb_h", "sr", "max_words"))
def p_frame_rd_pipe(packed_in, planes, padU, padV, qp, qpc, lam, lam4,
                    qpc_cb_tab, qpc_cr_tab, *, mb_w: int, mb_h: int,
                    sr: int, max_words: int):
    """The WHOLE pipelined RD P frame as ONE device program: source
    unpack -> RD encode -> boundary strengths -> deblock -> next-ref
    prep -> CAVLC slice pack -> flags/words concat.

    The composed alternative dispatches ~8 separately-jitted programs
    per frame; one program pays the per-dispatch overhead once.

    packed_in: (16*mb_h * 3 // 2, 16*mb_w) uint8 — Y on top, U|V below
    (the single-leaf upload layout of Encoder.encode_stream).
    Returns (out dict, next-ref state)."""
    from .deblock_jax import compute_bs_jax, deblock_jax
    h, w = mb_h * 16, mb_w * 16
    origY = packed_in[:h]
    origU = packed_in[h:, :w // 2]
    origV = packed_in[h:, w // 2:]
    n = mb_w * mb_h
    core = _p_frame_core(origY, origU, origV, planes, padU, padV,
                         qp, qpc, lam, lam4, mb_w=mb_w, mb_h=mb_h,
                         sr=sr, rd=True)
    zeros = jnp.zeros(n, jnp.int32)
    ref0 = jnp.full((n, 4), 7, jnp.int32)
    refm1 = jnp.full((n, 4), -1, jnp.int32)
    bs_v, bs_h = compute_bs_jax(
        zeros.astype(jnp.int8), core["luma_nnz"], zeros,
        core["mv4"], jnp.zeros_like(core["mv4"]), ref0, refm1,
        mb_w, mb_h)
    qp_arr = jnp.broadcast_to(jnp.asarray(qp, jnp.int32), (n,))
    dY, dU, dV = deblock_jax(
        core["recY"], core["recU"], core["recV"], bs_v, bs_h, qp_arr,
        zeros, zeros, zeros, zeros, zeros, qpc_cb_tab, qpc_cr_tab,
        mb_w=mb_w, mb_h=mb_h)
    state = (make_luma_planes_dev(dY),
             jnp.pad(dU, PAD, mode="edge"),
             jnp.pad(dV, PAD, mode="edge"))
    from . import cavlc_jax as CJX
    skip = CJX.skip_field(core["inter_mode"], core["cbp"], core["mv4"],
                          mb_w, mb_h)
    packed = CJX._pack_p_body(
        skip, core["inter_mode"], core["mv4"], core["cbp"],
        core["luma_scan"], core["luma_nnz"], core["chroma_dc"],
        core["chroma_scan"], core["chroma_nnz"],
        mb_w, mb_h, max_words)
    flags = jnp.stack([
        packed["nbits"].astype(jnp.int32),
        packed["ovf"].astype(jnp.int32),
        core["intra_mask"].any().astype(jnp.int32)])
    words_ext = jnp.concatenate(
        [flags.astype(jnp.uint32), packed["words"]])
    out = {"words_ext": words_ext, "core": core, "skip": skip}
    return out, state


@functools.partial(jax.jit, static_argnames=("mb_w", "mb_h", "sr"))
def p_frame_pipe(origY, origU, origV, planes, padU, padV,
                 qp, qpc, lam, lam4, qpc_cb_tab, qpc_cr_tab,
                 *, mb_w: int, mb_h: int, sr: int):
    """Fully-resident pipelined P step: encode + boundary strengths +
    in-loop deblock + next-frame reference prep, one device program.

    The reconstruction never crosses the PCIe/host boundary: the deblocked
    picture becomes the returned next-reference state (planes/padU/padV),
    and the host only downloads the compact syntax tensors (int8-packed;
    `ovf` flags any |level| > 127, in which case the caller falls back to
    the wide `luma_scan`/`chroma_scan`/`chroma_dc` leaves of
    p_frame_step). Speculative on intra: if `intra_mask` has any set bit
    the caller must re-encode the frame on the fallback path (the state
    returned here assumed all-inter reconstruction).

    Replaces a per-frame host round trip (recon download -> host deblock
    (native C) -> upload -> prep_ref)."""
    from .deblock_jax import compute_bs_jax, deblock_jax

    n = mb_w * mb_h
    out = _p_frame_core(origY, origU, origV, planes, padU, padV,
                        qp, qpc, lam, lam4, mb_w=mb_w, mb_h=mb_h, sr=sr)

    # boundary strengths from the committed (all-inter, single-ref) state
    zeros = jnp.zeros(n, jnp.int32)
    ref0 = jnp.full((n, 4), 7, jnp.int32)
    refm1 = jnp.full((n, 4), -1, jnp.int32)
    bs_v, bs_h = compute_bs_jax(
        zeros.astype(jnp.int8), out["luma_nnz"], zeros,
        out["mv4"], jnp.zeros_like(out["mv4"]), ref0, refm1, mb_w, mb_h)
    qp_arr = jnp.broadcast_to(jnp.asarray(qp, jnp.int32), (n,))
    dY, dU, dV = deblock_jax(
        out["recY"], out["recU"], out["recV"], bs_v, bs_h, qp_arr,
        zeros, zeros, zeros, zeros, zeros, qpc_cb_tab, qpc_cr_tab,
        mb_w=mb_w, mb_h=mb_h)

    state = (make_luma_planes_dev(dY),
             jnp.pad(dU, PAD, mode="edge"),
             jnp.pad(dV, PAD, mode="edge"))

    ovf = ((jnp.abs(out["luma_scan"]) > 127).any()
           | (jnp.abs(out["chroma_scan"]) > 127).any())
    return {
        "inter_mode": out["inter_mode"].astype(jnp.int8),
        "mv_quad": out["mv4"][:, jnp.asarray([0, 2, 8, 10])]
        .astype(jnp.int8),
        "luma8": out["luma_scan"].astype(jnp.int8),
        "luma_nnz8": out["luma_nnz"].astype(jnp.int8),
        "cbp8": out["cbp"].astype(jnp.uint8),
        "chroma_dc": out["chroma_dc"],
        "chroma8": out["chroma_scan"].astype(jnp.int8),
        "chroma_nnz8": out["chroma_nnz"].astype(jnp.int8),
        "intra_any": out["intra_mask"].any(),
        "ovf": ovf,
        "state": state,
    }
