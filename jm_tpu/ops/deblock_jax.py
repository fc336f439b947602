"""Device (jnp/XLA) in-loop deblocking filter — bit-exact twin of
ops/deblock.py (spec 8.7; capability parity with ldecod/src/
loop_filter_normal.c and lencod/src/loopFilter.c).

Device restructuring: the reference itself proves the dependency analysis —
its parallel build filters macroblocks along 2:1 diagonals
(lencod/src/loopFilter.c:112 DeblockFrame, wave i holds MBs with
col = i - 2*row). Here the frame is stored *sheared* so each wave is a
contiguous slab: tile S[b, w] = MB(row=b, col=w-2b). A lax.scan walks the
waves; every step deblocks one full wave of MBs (all edge filters
vectorized over the wave's lanes and 16 filter lines), touching only
static-offset dynamic slices of the sheared planes — no gather/scatter.

Per-MB edge order inside a wave step matches DeblockMb exactly: four
vertical edges left-to-right (each reading the previous edge's output),
then four horizontal edges top-to-bottom. MB-edge filters read the left
tile S[b, w-1] (deblocked at wave w-1) and top tile S[b-1, w-2] (wave
w-2) and write back their 3-sample fringes, reproducing the raster-order
semantics bit-for-bit.

Scope: frame pictures, 4:2:0, per-MB QP / disable_idc / alpha-beta
offsets / slice ids / 8x8-transform flags (the full frame feature set of
the host filter)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..common.tables import ALPHA_TABLE, BETA_TABLE, TC0_TABLE

_ALPHA = np.asarray(ALPHA_TABLE, np.int32)
_BETA = np.asarray(BETA_TABLE, np.int32)
_TC0 = np.asarray(TC0_TABLE, np.int32)          # (3, 52)


# ---------------------------------------------------------------------------
# boundary strengths (device twin of deblock.compute_bs)
# ---------------------------------------------------------------------------

def compute_bs_jax(mb_class, luma_nnz, transform8x8, mv, mv_l1,
                   ref_pic_id, ref_pic_id_l1, mb_w: int, mb_h: int):
    """jnp twin of deblock.compute_bs. All inputs per-MB SoA tensors;
    returns (bs_v, bs_h) each (4*mb_h, 4*mb_w) int8."""
    H, W = 4 * mb_h, 4 * mb_w
    mc = mb_class.reshape(mb_h, mb_w)
    intra = jnp.repeat(jnp.repeat(mc != 0, 4, 0), 4, 1)
    nnz_mb = luma_nnz
    t8 = transform8x8.astype(bool)
    q = nnz_mb.reshape(-1, 2, 2, 2, 2)
    qa = jnp.broadcast_to(q.sum(axis=(2, 4), keepdims=True), q.shape)
    nnz_mb = jnp.where(t8[:, None, None, None, None], qa, q).reshape(-1, 16)
    nnz = nnz_mb.reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(H, W)
    mv0 = mv.reshape(mb_h, mb_w, 4, 4, 2).transpose(0, 2, 1, 3, 4) \
        .reshape(H, W, 2)
    mv1 = mv_l1.reshape(mb_h, mb_w, 4, 4, 2).transpose(0, 2, 1, 3, 4) \
        .reshape(H, W, 2)

    def expand_q(a8):
        return jnp.repeat(jnp.repeat(
            a8.reshape(mb_h, mb_w, 2, 2).transpose(0, 2, 1, 3)
            .reshape(2 * mb_h, 2 * mb_w), 2, 0), 2, 1)

    r0 = expand_q(ref_pic_id.astype(jnp.int32))
    r1 = expand_q(ref_pic_id_l1.astype(jnp.int32))

    def cmp_mv(a, b):
        return (jnp.abs(a - b) >= 4).any(axis=-1)

    def edge_bs(sl_p, sl_q, is_mb_edge):
        (ip, nn_p, m0p, m1p, r0p, r1p) = sl_p
        (iq, nn_q, m0q, m1q, r0q, r1q) = sl_q
        either_intra = ip | iq
        coef = (nn_p > 0) | (nn_q > 0)
        pair_straight = (r0p == r0q) & (r1p == r1q)
        pair_cross = (r0p == r1q) & (r1p == r0q)
        c00 = cmp_mv(m0p, m0q)
        c11 = cmp_mv(m1p, m1q)
        c01 = cmp_mv(m0p, m1q)
        c10 = cmp_mv(m1p, m0q)
        strv_same = (c00 | c11) & (c01 | c10)
        strv = jnp.where(~(pair_straight | pair_cross), 1,
                         jnp.where(r0p != r1p,
                                   jnp.where(r0p == r0q, c00 | c11,
                                             c01 | c10),
                                   strv_same)).astype(jnp.int8)
        bs = jnp.where(either_intra,
                       jnp.where(is_mb_edge, 4, 3).astype(jnp.int8),
                       jnp.where(coef, jnp.int8(2), strv))
        return bs

    def sl(arrs, s):
        return tuple(a[s] for a in arrs)

    fields = (intra, nnz, mv0, mv1, r0, r1)
    is_mb_v = jnp.zeros((H, W - 1), bool).at[:, 3::4].set(True)
    bs_v = jnp.zeros((H, W), jnp.int8).at[:, 1:].set(
        edge_bs(sl(fields, np.s_[:, :-1]), sl(fields, np.s_[:, 1:]),
                is_mb_v))
    is_mb_h = jnp.zeros((H - 1, W), bool).at[3::4, :].set(True)
    bs_h = jnp.zeros((H, W), jnp.int8).at[1:, :].set(
        edge_bs(sl(fields, np.s_[:-1, :]), sl(fields, np.s_[1:, :]),
                is_mb_h))
    return bs_v, bs_h


# ---------------------------------------------------------------------------
# edge filters (elementwise twins of deblock._filter_luma_edge etc.)
# ---------------------------------------------------------------------------

def _clip3(lo, hi, x):
    return jnp.minimum(hi, jnp.maximum(lo, x))


def _luma_edge(cols, bs, alpha, beta, tc0, enable):
    """cols: (..., 8) int32 = [p3 p2 p1 p0 q0 q1 q2 q3] along the last
    axis; bs/tc0 broadcastable per line; alpha/beta per lane. Returns the
    filtered (..., 8) (p3/q3 passthrough)."""
    p3, p2, p1, p0 = cols[..., 0], cols[..., 1], cols[..., 2], cols[..., 3]
    q0, q1, q2, q3 = cols[..., 4], cols[..., 5], cols[..., 6], cols[..., 7]
    fflag = ((jnp.abs(p0 - q0) < alpha) & (jnp.abs(p1 - p0) < beta)
             & (jnp.abs(q1 - q0) < beta) & (bs > 0) & enable)
    ap = jnp.abs(p2 - p0) < beta
    aq = jnp.abs(q2 - q0) < beta

    tc = tc0 + ap.astype(jnp.int32) + aq.astype(jnp.int32)
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
    np0 = jnp.clip(p0 + delta, 0, 255)
    nq0 = jnp.clip(q0 - delta, 0, 255)
    np1 = p1 + _clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1)
    nq1 = q1 + _clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1)
    np1 = jnp.where(ap, np1, p1)
    nq1 = jnp.where(aq, nq1, q1)

    strong = jnp.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp0 = jnp.where(strong & ap,
                    (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                    (2 * p1 + p0 + q1 + 2) >> 2)
    sp1 = jnp.where(strong & ap, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = jnp.where(strong & ap,
                    (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = jnp.where(strong & aq,
                    (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                    (2 * q1 + q0 + p1 + 2) >> 2)
    sq1 = jnp.where(strong & aq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = jnp.where(strong & aq,
                    (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    rp0 = jnp.where(is4, sp0, np0)
    rp1 = jnp.where(is4, sp1, np1)
    rp2 = jnp.where(is4, sp2, p2)
    rq0 = jnp.where(is4, sq0, nq0)
    rq1 = jnp.where(is4, sq1, nq1)
    rq2 = jnp.where(is4, sq2, q2)

    rp0 = jnp.where(fflag, rp0, p0)
    rp1 = jnp.where(fflag, rp1, p1)
    rp2 = jnp.where(fflag, rp2, p2)
    rq0 = jnp.where(fflag, rq0, q0)
    rq1 = jnp.where(fflag, rq1, q1)
    rq2 = jnp.where(fflag, rq2, q2)
    return jnp.stack([p3, rp2, rp1, rp0, rq0, rq1, rq2, q3], axis=-1)


def _chroma_edge(cols, bs, alpha, beta, tc0, enable):
    """cols: (..., 4) = [p1 p0 q0 q1]."""
    p1, p0, q0, q1 = cols[..., 0], cols[..., 1], cols[..., 2], cols[..., 3]
    fflag = ((jnp.abs(p0 - q0) < alpha) & (jnp.abs(p1 - p0) < beta)
             & (jnp.abs(q1 - q0) < beta) & (bs > 0) & enable)
    tc = tc0 + 1
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
    np0 = jnp.clip(p0 + delta, 0, 255)
    nq0 = jnp.clip(q0 - delta, 0, 255)
    sp0 = (2 * p1 + p0 + q1 + 2) >> 2
    sq0 = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    rp0 = jnp.where(fflag, jnp.where(is4, sp0, np0), p0)
    rq0 = jnp.where(fflag, jnp.where(is4, sq0, nq0), q0)
    return jnp.stack([p1, rp0, rq0, q1], axis=-1)


# ---------------------------------------------------------------------------
# shear helpers
# ---------------------------------------------------------------------------

def _shear(tiles, mb_w: int, mb_h: int, n_w: int):
    """tiles (mb_h, mb_w, ...) -> sheared (mb_h, n_w, ...):
    S[b, w] = tiles[b, w - 2b] (zeros outside)."""
    b = jnp.arange(mb_h)[:, None]
    w = jnp.arange(n_w)[None, :]
    c = w - 2 * b
    valid = (c >= 0) & (c < mb_w)
    idx = jnp.clip(c, 0, mb_w - 1)
    ext = tuple([slice(None)] * 2 + [None] * (tiles.ndim - 2))
    g = jnp.take_along_axis(
        tiles, idx.reshape(mb_h, n_w, *([1] * (tiles.ndim - 2))), axis=1)
    return jnp.where(valid[ext], g, jnp.zeros_like(g))


def _unshear(S, mb_w: int, mb_h: int):
    """sheared (mb_h, n_w, ...) -> tiles (mb_h, mb_w, ...)."""
    b = jnp.arange(mb_h)[:, None]
    c = jnp.arange(mb_w)[None, :]
    idx = c + 2 * b
    return jnp.take_along_axis(
        S, idx.reshape(mb_h, mb_w, *([1] * (S.ndim - 2))), axis=1)


def _tiles(plane, mb_h: int, mb_w: int, ts: int):
    return plane.reshape(mb_h, ts, mb_w, ts).transpose(0, 2, 1, 3)


def _untile(tiles, mb_h: int, mb_w: int, ts: int):
    return tiles.transpose(0, 2, 1, 3).reshape(mb_h * ts, mb_w * ts)


# ---------------------------------------------------------------------------
# the wavefront scan
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("mb_w", "mb_h"))
def deblock_jax(Y, U, V, bs_v, bs_h, qp, disable, a_off, b_off,
                slice_id, transform8x8, qpc_cb, qpc_cr, *,
                mb_w: int, mb_h: int):
    """Deblock a 4:2:0 frame picture on device. Y (16mh, 16mw) uint8,
    U/V (8mh, 8mw) uint8; bs_v/bs_h (4mh, 4mw) int8; qp/disable/a_off/
    b_off/slice_id (N,) int32; transform8x8 (N,) bool-ish;
    qpc_cb/qpc_cr (52,) int32 QP->QPc tables. Returns filtered (Y, U, V).
    """
    n_w = mb_w + 2 * (mb_h - 1) if mb_h > 1 else mb_w
    alpha_t = jnp.asarray(_ALPHA)
    beta_t = jnp.asarray(_BETA)
    tc0_t = jnp.asarray(_TC0.reshape(-1))          # flat (3*52,)

    SY = _shear(_tiles(Y.astype(jnp.int32), mb_h, mb_w, 16), mb_w, mb_h, n_w)
    SU = _shear(_tiles(U.astype(jnp.int32), mb_h, mb_w, 8), mb_w, mb_h, n_w)
    SV = _shear(_tiles(V.astype(jnp.int32), mb_h, mb_w, 8), mb_w, mb_h, n_w)

    def shear_mb(a):
        return _shear(a.reshape(mb_h, mb_w, -1), mb_w, mb_h, n_w)

    SQP = shear_mb(qp.astype(jnp.int32))[..., 0]
    SDIS = shear_mb(disable.astype(jnp.int32))[..., 0]
    SAO = shear_mb(a_off.astype(jnp.int32))[..., 0]
    SBO = shear_mb(b_off.astype(jnp.int32))[..., 0]
    SSID = shear_mb(slice_id.astype(jnp.int32))[..., 0]
    ST8 = shear_mb(transform8x8.astype(jnp.int32))[..., 0].astype(bool)
    # sheared bs: (mb_h, n_w, 4 rows, 4 edges)
    bsv_t = bs_v.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3)
    bsh_t = bs_h.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3)
    SBSV = _shear(bsv_t.astype(jnp.int32), mb_w, mb_h, n_w)
    SBSH = _shear(bsh_t.astype(jnp.int32), mb_w, mb_h, n_w)

    b_idx = jnp.arange(mb_h)

    def col1(S, w):
        """S[:, w] with w clamped to >= 0 (callers mask)."""
        wc = jnp.maximum(w, 0)
        return lax.dynamic_slice_in_dim(S, wc, 1, axis=1)[:, 0]

    def params(qp_p, qp_q, ao, bo, bs4):
        """alpha/beta/tc0 for one edge. qp_*/ao/bo per lane (mh,);
        bs4 (mh, 4). Returns alpha, beta (mh, 1) and tc0 (mh, 16)."""
        qav = (qp_p + qp_q + 1) >> 1
        ia = jnp.clip(qav + 2 * ao, 0, 51)
        ib = jnp.clip(qav + 2 * bo, 0, 51)
        alpha = alpha_t[ia][:, None]
        beta = beta_t[ib][:, None]
        bs_line = jnp.repeat(bs4, 4, axis=1)               # (mh, 16)
        tc0 = tc0_t[(jnp.clip(bs_line, 1, 3) - 1) * 52 + ia[:, None]]
        return alpha, beta, tc0, bs_line

    def cparams(qp_p, qp_q, ao, bo, bs4, ctab, rep):
        qpc_p = ctab[jnp.clip(qp_p, 0, 51)]
        qpc_q = ctab[jnp.clip(qp_q, 0, 51)]
        qav = (qpc_p + qpc_q + 1) >> 1
        ia = jnp.clip(qav + 2 * ao, 0, 51)
        ib = jnp.clip(qav + 2 * bo, 0, 51)
        alpha = alpha_t[ia][:, None]
        beta = beta_t[ib][:, None]
        bs_line = jnp.repeat(bs4, rep, axis=1)             # (mh, 8)
        tc0 = tc0_t[(jnp.clip(bs_line, 1, 3) - 1) * 52 + ia[:, None]]
        return alpha, beta, tc0, bs_line

    def step(carry, w):
        SY, SU, SV = carry
        c = w - 2 * b_idx                                   # (mh,)
        valid = (c >= 0) & (c < mb_w)
        has_left = valid & (c > 0)
        has_top = valid & (b_idx > 0)

        qp_q = col1(SQP, w)
        qp_l = col1(SQP, w - 1)
        qp_t = jnp.concatenate([col1(SQP, w - 2)[:1],
                                col1(SQP, w - 2)[:-1]])     # lane b-1
        dis = col1(SDIS, w)
        ao = col1(SAO, w)
        bo = col1(SBO, w)
        sid = col1(SSID, w)
        sid_l = col1(SSID, w - 1)
        sid_t = jnp.concatenate([col1(SSID, w - 2)[:1],
                                 col1(SSID, w - 2)[:-1]])
        t8 = col1(ST8, w)
        bsv = col1(SBSV, w)                                 # (mh, 4, 4)
        bsh = col1(SBSH, w)
        mb_on = valid & (dis != 1)
        left_ok = has_left & ~((dis == 2) & (sid_l != sid))
        top_ok = has_top & ~((dis == 2) & (sid_t != sid))

        cur = col1(SY, w)                                   # (mh, 16, 16)
        left = col1(SY, w - 1)
        topw = col1(SY, w - 2)
        top = jnp.concatenate([topw[:1], topw[:-1]], axis=0)
        curU, leftU, topwU = col1(SU, w), col1(SU, w - 1), col1(SU, w - 2)
        topU = jnp.concatenate([topwU[:1], topwU[:-1]], axis=0)
        curV, leftV, topwV = col1(SV, w), col1(SV, w - 1), col1(SV, w - 2)
        topV = jnp.concatenate([topwV[:1], topwV[:-1]], axis=0)

        # ---- vertical edges ------------------------------------------
        wk = jnp.concatenate([left[:, :, 12:16], cur], axis=2)  # (mh,16,20)
        wkU = jnp.concatenate([leftU[:, :, 4:8], curU], axis=2)  # (mh,8,12)
        wkV = jnp.concatenate([leftV[:, :, 4:8], curV], axis=2)
        for ex in range(4):
            en = mb_on & (left_ok if ex == 0 else
                          jnp.broadcast_to(True, mb_on.shape))
            if ex in (1, 3):
                en = en & ~t8
            qp_p = qp_l if ex == 0 else qp_q
            al, be, tc0, bsl = params(qp_p, qp_q, ao, bo, bsv[:, :, ex])
            x = 4 * ex + 4
            cols = lax.dynamic_slice_in_dim(wk, x - 4, 8, axis=2)
            out = _luma_edge(cols, bsl, al, be, tc0, en[:, None])
            wk = lax.dynamic_update_slice_in_dim(wk, out, x - 4, axis=2)
            if ex in (0, 2):
                cx = 2 * ex + 4                 # chroma work col of edge
                alc, bec, tc0c, bslc = cparams(
                    qp_p, qp_q, ao, bo, bsv[:, :, ex], qpc_cb, 2)
                colsU = lax.dynamic_slice_in_dim(wkU, cx - 2, 4, axis=2)
                outU = _chroma_edge(colsU, bslc, alc, bec, tc0c, en[:, None])
                wkU = lax.dynamic_update_slice_in_dim(wkU, outU, cx - 2,
                                                      axis=2)
                alc, bec, tc0c, bslc = cparams(
                    qp_p, qp_q, ao, bo, bsv[:, :, ex], qpc_cr, 2)
                colsV = lax.dynamic_slice_in_dim(wkV, cx - 2, 4, axis=2)
                outV = _chroma_edge(colsV, bslc, alc, bec, tc0c, en[:, None])
                wkV = lax.dynamic_update_slice_in_dim(wkV, outV, cx - 2,
                                                      axis=2)
        new_left_cols = wk[:, :, 1:4]
        cur = wk[:, :, 4:20]
        new_left_colsU = wkU[:, :, 1:4]
        curU = wkU[:, :, 4:12]
        new_left_colsV = wkV[:, :, 1:4]
        curV = wkV[:, :, 4:12]

        # ---- horizontal edges ----------------------------------------
        wk = jnp.concatenate([top[:, 12:16, :], cur], axis=1)  # (mh,20,16)
        wkU = jnp.concatenate([topU[:, 4:8, :], curU], axis=1)  # (mh,12,8)
        wkV = jnp.concatenate([topV[:, 4:8, :], curV], axis=1)
        for ey in range(4):
            en = mb_on & (top_ok if ey == 0 else
                          jnp.broadcast_to(True, mb_on.shape))
            en_l = en & (~t8 if ey in (1, 3) else
                         jnp.broadcast_to(True, en.shape))
            qp_p = qp_t if ey == 0 else qp_q
            al, be, tc0, bsl = params(qp_p, qp_q, ao, bo, bsh[:, ey, :])
            y = 4 * ey + 4
            rows = lax.dynamic_slice_in_dim(wk, y - 4, 8, axis=1)
            out = _luma_edge(rows.swapaxes(1, 2), bsl, al, be, tc0,
                             en_l[:, None]).swapaxes(1, 2)
            wk = lax.dynamic_update_slice_in_dim(wk, out, y - 4, axis=1)
            if ey in (0, 2):
                cy = 2 * ey + 4
                alc, bec, tc0c, bslc = cparams(
                    qp_p, qp_q, ao, bo, bsh[:, ey, :], qpc_cb, 2)
                rowsU = lax.dynamic_slice_in_dim(wkU, cy - 2, 4, axis=1)
                outU = _chroma_edge(rowsU.swapaxes(1, 2), bslc, alc, bec,
                                    tc0c, en[:, None]).swapaxes(1, 2)
                wkU = lax.dynamic_update_slice_in_dim(wkU, outU, cy - 2,
                                                      axis=1)
                alc, bec, tc0c, bslc = cparams(
                    qp_p, qp_q, ao, bo, bsh[:, ey, :], qpc_cr, 2)
                rowsV = lax.dynamic_slice_in_dim(wkV, cy - 2, 4, axis=1)
                outV = _chroma_edge(rowsV.swapaxes(1, 2), bslc, alc, bec,
                                    tc0c, en[:, None]).swapaxes(1, 2)
                wkV = lax.dynamic_update_slice_in_dim(wkV, outV, cy - 2,
                                                      axis=1)
        new_top_rows = wk[:, 1:4, :]
        cur = wk[:, 4:20, :]
        new_top_rowsU = wkU[:, 1:4, :]
        curU = wkU[:, 4:12, :]
        new_top_rowsV = wkV[:, 1:4, :]
        curV = wkV[:, 4:12, :]

        def commit(S, cur, orig_cur, new_left, orig_left, left_sl,
                   new_top, orig_top, top_sl, w):
            vmask = valid[:, None, None]
            S = lax.dynamic_update_slice(
                S, jnp.where(vmask, cur, orig_cur)[:, None], (0, w, 0, 0))
            # left fringe (cols left_sl of tile w-1). Lanes with no left
            # keep the CURRENT values; these must be re-read after the
            # cur commit because the clamped index at w==0 aliases the
            # current wave (a stale pre-filter read would clobber it).
            lm = (valid & has_left)[:, None, None]
            old_left = lax.dynamic_slice_in_dim(
                S, jnp.maximum(w - 1, 0), 1, axis=1)[:, 0][:, :,
                                                           left_sl]
            lv = jnp.where(lm, new_left, old_left)
            S = lax.dynamic_update_slice(
                S, lv[:, None], (0, jnp.maximum(w - 1, 0), 0, left_sl.start))
            # top fringe (rows of tile (b-1, w-2)): shift lanes up by one
            tm = (valid & has_top)[:, None, None]
            tv = jnp.where(tm, new_top, 0)
            tv_sh = jnp.concatenate([tv[1:], tv[-1:] * 0], axis=0)
            keep = jnp.concatenate([tm[1:], tm[-1:] * False], axis=0)
            old_top = col1(S, w - 2)[:, top_sl.start:top_sl.stop, :]
            tv_fin = jnp.where(keep, tv_sh, old_top)
            S = lax.dynamic_update_slice(
                S, tv_fin[:, None], (0, jnp.maximum(w - 2, 0),
                                     top_sl.start, 0))
            return S

        SY = commit(SY, cur, col1(SY, w), new_left_cols, left,
                    slice(13, 16), new_top_rows, top, slice(13, 16), w)
        SU = commit(SU, curU, col1(SU, w), new_left_colsU, leftU,
                    slice(5, 8), new_top_rowsU, topU, slice(5, 8), w)
        SV = commit(SV, curV, col1(SV, w), new_left_colsV, leftV,
                    slice(5, 8), new_top_rowsV, topV, slice(5, 8), w)
        return (SY, SU, SV), None

    # UNROLL waves per scan step (the dependency chain between
    # consecutive waves is preserved by the inner order). More waves per
    # step cut per-iteration loop overhead but multiply the program, and
    # GPU compile time grows with it: at 8 this function lowers to ~37k
    # ops instead of ~5k (PERF.md, PR 1)
    UNROLL = 1

    def step_u(carry, w0):
        for k in range(UNROLL):
            carry, _ = step(carry, w0 + k)
        return carry, None

    n_pad = -(-n_w // UNROLL) * UNROLL
    # waves beyond n_w are harmless: every lane is invalid there (the
    # shear leaves c = w - 2b >= mb_w for all b), so commits are no-ops.
    (SY, SU, SV), _ = lax.scan(step_u, (SY, SU, SV),
                               jnp.arange(0, n_pad, UNROLL,
                                          dtype=jnp.int32))
    Yf = _untile(_unshear(SY, mb_w, mb_h), mb_h, mb_w, 16)
    Uf = _untile(_unshear(SU, mb_w, mb_h), mb_h, mb_w, 8)
    Vf = _untile(_unshear(SV, mb_w, mb_h), mb_h, mb_w, 8)
    return (Yf.astype(jnp.uint8), Uf.astype(jnp.uint8),
            Vf.astype(jnp.uint8))


def deblock_picture_jax(Y, U, V, pic, mb_w: int, mb_h: int, qp_arr,
                        slice_params):
    """Drop-in device twin of deblock.deblock_picture (4:2:0 frame).
    Returns new (Y, U, V) numpy arrays (the host version filters
    in-place)."""
    from ..common.tables import chroma_qp
    bs_v, bs_h = compute_bs_jax(
        jnp.asarray(pic.mb_class), jnp.asarray(pic.luma_nnz),
        jnp.asarray(np.asarray(pic.transform8x8, np.int32)),
        jnp.asarray(pic.mv), jnp.asarray(pic.mv_l1),
        jnp.asarray(pic.ref_pic_id), jnp.asarray(pic.ref_pic_id_l1),
        mb_w, mb_h)
    cb_off = slice_params["cb_qp_off"]
    cr_off = slice_params["cr_qp_off"]
    qpc_cb = np.array([chroma_qp(q, int(cb_off[0])) for q in range(52)],
                      np.int32)
    qpc_cr = np.array([chroma_qp(q, int(cr_off[0])) for q in range(52)],
                      np.int32)
    Yf, Uf, Vf = deblock_jax(
        jnp.asarray(Y), jnp.asarray(U), jnp.asarray(V), bs_v, bs_h,
        jnp.asarray(np.asarray(qp_arr, np.int32)),
        jnp.asarray(np.asarray(slice_params["disable_idc"], np.int32)),
        jnp.asarray(np.asarray(slice_params["alpha_off"], np.int32)),
        jnp.asarray(np.asarray(slice_params["beta_off"], np.int32)),
        jnp.asarray(np.asarray(slice_params["slice_id"], np.int32)),
        jnp.asarray(np.asarray(pic.transform8x8, np.int32)),
        jnp.asarray(qpc_cb), jnp.asarray(qpc_cr),
        mb_w=mb_w, mb_h=mb_h)
    return np.asarray(Yf), np.asarray(Uf), np.asarray(Vf)
