"""Device-resident I-frame encode: wavefront-batched intra coding.

The serial dependency of intra prediction (each MB predicts from the
reconstruction of its left/up/up-left/up-right neighbors) is broken by
processing anti-diagonals d = mbx + 2*mby: every MB on a diagonal only
depends on MBs of earlier diagonals, so each wave is one batched tensor
step and the whole picture is ONE jitted lax.fori_loop over waves
(SURVEY §1 / §2.5 SP axis — the restructuring of lencod's
serial slice.c:486 MB loop for the I-slice path).

Per wave, for every MB in the wave simultaneously:
  - all 9 Intra4x4 predictions of each 4x4 block evaluated as one
    tap-table tensor contraction (16 blocks sequential in coding order
    inside the MB, as the spec requires, but batched across the wave);
  - Intra16x16 (4 modes) + chroma (4 modes) candidates;
  - mode decision (md_low cost model: SAD + 4*lam penalty for
    non-most-probable I4 modes, I16 chosen when cost16 + 24*lam wins);
  - exact residual coding + reconstruction (shared quant/transform
    kernels), scattered back into the padded recon planes.

Integer-only math: every backend gives the same bits. Decisions mirror the host
md_low path's cost model; the coded state is decode-exact by
construction (same residual/recon kernels as the decoder).
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

_ZZ = np.asarray(ZIGZAG_4x4, np.int32)
CODE2RASTER = [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]
RASTER2CODE = [CODE2RASTER.index(i) for i in range(16)]

# ---------------------------------------------------------------------------
# I4 predictor tap tables: every mode except DC is, per output pixel, a
# (w0*r[i0] + w1*r[i1] + w2*r[i2] + rnd) >> sh over the 13-sample
# reference vector rr = [l3, l2, l1, l0, m, t0..t7]
# ---------------------------------------------------------------------------

_I4_MODES_LIN = [0, 1, 3, 4, 5, 6, 7, 8]     # VERT HOR DDL DDR VR HD VL HU


def _li(k):      # l[k] index in rr
    return 3 - k


def _ti(k):      # t[k] index in rr
    return 5 + k


_MI = 4          # m index


def _build_i4_taps():
    """(8, 16, 3) indices, (8, 16, 3) weights, (8, 16) rnd, (8, 16) shift,
    mirroring ops/intra.py predict_i4 exactly."""
    idx = np.zeros((8, 16, 3), np.int32)
    wgt = np.zeros((8, 16, 3), np.int32)
    rnd = np.zeros((8, 16), np.int32)
    sh = np.zeros((8, 16), np.int32)

    def put(mi, y, x, taps, r, s):
        for k, (i, w) in enumerate(taps):
            idx[mi, y * 4 + x, k] = i
            wgt[mi, y * 4 + x, k] = w
        rnd[mi, y * 4 + x] = r
        sh[mi, y * 4 + x] = s

    for y in range(4):
        for x in range(4):
            # VERT
            put(0, y, x, [(_ti(x), 1)], 0, 0)
            # HOR
            put(1, y, x, [(_li(y), 1)], 0, 0)
            # DDL (with the (3,3) clamp: t6 + 3*t7)
            i = x + y
            put(2, y, x, [(_ti(i), 1), (_ti(min(i + 1, 7)), 2),
                          (_ti(min(i + 2, 7)), 1)], 2, 2)
            # DDR: rr diagonal at 4 + x - y
            j = 4 + x - y
            put(3, y, x, [(j - 1, 1), (j, 2), (j + 1, 1)], 2, 2)
            # VR
            z = 2 * x - y
            k = x - (y >> 1)
            if z >= 0 and z % 2 == 0:
                # tt = [m, t...]: tt[k] = rr[4 + k]
                put(4, y, x, [(4 + k - 1 + 1, 1), (4 + k + 1, 1)], 1, 1)
            elif z >= 0:
                put(4, y, x, [(4 + k - 1, 1), (4 + k, 2), (4 + k + 1, 1)],
                    2, 2)
            elif z == -1:
                put(4, y, x, [(_li(0), 1), (_MI, 2), (_ti(0), 1)], 2, 2)
            else:
                # ll = [m, l...]: ll[k] = rr[4 - k]
                put(4, y, x, [(4 - y, 1), (4 - (y - 1), 2),
                              (4 - (y - 2), 1)], 2, 2)
            # HD
            z = 2 * y - x
            k = y - (x >> 1)
            if z >= 0 and z % 2 == 0:
                put(5, y, x, [(4 - k, 1), (4 - (k + 1), 1)], 1, 1)
            elif z >= 0:
                put(5, y, x, [(4 - (k - 1), 1), (4 - k, 2),
                              (4 - (k + 1), 1)], 2, 2)
            elif z == -1:
                put(5, y, x, [(_ti(0), 1), (_MI, 2), (_li(0), 1)], 2, 2)
            else:
                # tt2 = [m, t...]: tt2[k] = rr[4 + k]
                put(5, y, x, [(4 + x, 1), (4 + x - 1, 2), (4 + x - 2, 1)],
                    2, 2)
            # VL
            k = x + (y >> 1)
            if y % 2 == 0:
                put(6, y, x, [(_ti(k), 1), (_ti(k + 1), 1)], 1, 1)
            else:
                put(6, y, x, [(_ti(k), 1), (_ti(k + 1), 2), (_ti(k + 2), 1)],
                    2, 2)
            # HU
            z = x + 2 * y
            if z > 5:
                put(7, y, x, [(_li(3), 1)], 0, 0)
            elif z == 5:
                put(7, y, x, [(_li(2), 1), (_li(3), 3)], 2, 2)
            elif z % 2 == 0:
                kk = y + (x >> 1)
                put(7, y, x, [(_li(kk), 1), (_li(kk + 1), 1)], 1, 1)
            else:
                kk = y + (x >> 1)
                put(7, y, x, [(_li(kk), 1), (_li(kk + 1), 2),
                              (_li(kk + 2), 1)], 2, 2)
    return idx, wgt, rnd, sh


_I4_IDX, _I4_WGT, _I4_RND, _I4_SH = _build_i4_taps()

# fix VR even-z taps: the builder wrote (4+k-1+1) for the first tap which
# equals 4+k — encode (tt[k] + tt[k+1] + 1) >> 1 correctly
for _y in range(4):
    for _x in range(4):
        _z = 2 * _x - _y
        if _z >= 0 and _z % 2 == 0:
            _k = _x - (_y >> 1)
            _I4_IDX[4, _y * 4 + _x, 0] = 4 + _k
            _I4_WGT[4, _y * 4 + _x, 0] = 1
            _I4_IDX[4, _y * 4 + _x, 1] = 4 + _k + 1
            _I4_WGT[4, _y * 4 + _x, 1] = 1
            _I4_IDX[4, _y * 4 + _x, 2] = 0
            _I4_WGT[4, _y * 4 + _x, 2] = 0


def i4_predict_all(rr, avail_t, avail_l, avail_tl):
    """rr: (B, 13) int32 reference vectors -> (B, 9, 16) predictions in
    mode-id order (VERT HOR DC DDL DDR VR HD VL HU), invalid modes
    garbage (masked by cost)."""
    g = rr[:, _I4_IDX.reshape(-1)].reshape(-1, 8, 16, 3)
    lin = ((g * _I4_WGT[None]).sum(-1) + _I4_RND[None]) >> _I4_SH[None]
    t = rr[:, 5:9]
    l = rr[:, 3::-1]                     # l0..l3 = rr[3],rr[2],rr[1],rr[0]
    st = t.sum(1)
    sl = l.sum(1)
    dc = jnp.where(avail_t & avail_l, (st + sl + 4) >> 3,
                   jnp.where(avail_t, (st + 2) >> 2,
                             jnp.where(avail_l, (sl + 2) >> 2, 128)))
    dc = jnp.broadcast_to(dc[:, None], (rr.shape[0], 16))
    # reorder into mode-id order with DC at index 2
    return jnp.stack([lin[:, 0], lin[:, 1], dc, lin[:, 2], lin[:, 3],
                      lin[:, 4], lin[:, 5], lin[:, 6], lin[:, 7]], axis=1)


# ---------------------------------------------------------------------------
# residual helpers (decode-mirror, single 4x4 / batched)
# ---------------------------------------------------------------------------

def _to_scan(blocks):
    return blocks.reshape(*blocks.shape[:-2], 16)[..., jnp.asarray(_ZZ)]


def _from_scan(scan):
    out = jnp.zeros_like(scan)
    out = out.at[..., jnp.asarray(_ZZ)].set(scan)
    return out.reshape(*scan.shape[:-1], 4, 4)


def _code_i4_block(o, pred, qp):
    """(B,4,4) orig/pred -> (scan (B,16), nnz (B,), recon (B,4,4))."""
    w = T.forward4x4(o - pred)
    lev = Q.quant_4x4(w, qp, True)
    scan = _to_scan(lev)
    d = Q.dequant_4x4(lev, qp)
    r = T.inverse4x4_round(d)
    rec = jnp.clip(pred + r, 0, 255)
    return scan, (scan != 0).sum(-1).astype(jnp.int32), rec


# ---------------------------------------------------------------------------
# the wavefront I-frame step
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("mb_w", "mb_h"))
def i_frame_step(origY, origU, origV, qp, qpc, lam, lam4,
                 *, mb_w: int, mb_h: int):
    """Encode a whole I picture on device. Returns the decided SoA
    tensors + recon planes (see encoder._encode_i_device)."""
    n = mb_w * mb_h
    h, w = mb_h * 16, mb_w * 16
    ch, cw = h // 2, w // 2
    wmax = min(mb_h, (mb_w + 1 + 1) // 2)
    n_waves = (mb_w - 1) + 2 * (mb_h - 1) + 1

    o32 = origY.astype(jnp.int32)
    oU = origU.astype(jnp.int32)
    oV = origV.astype(jnp.int32)
    qpv = jnp.asarray(qp, jnp.int32)
    qpcv = jnp.asarray(qpc, jnp.int32)

    bufs = {
        "recY": jnp.zeros((1 + h, 1 + w + 16), jnp.int32),
        "recU": jnp.zeros((1 + ch, 1 + cw), jnp.int32),
        "recV": jnp.zeros((1 + ch, 1 + cw), jnp.int32),
        "cls": jnp.zeros(n, jnp.int32),            # 1=I4, 2=I16
        "i4m": jnp.full((n, 16), -1, jnp.int32),
        "i16m": jnp.full(n, -1, jnp.int32),
        "cmode": jnp.zeros(n, jnp.int32),
        "cbp": jnp.zeros(n, jnp.int32),
        "lcoef": jnp.zeros((n, 16, 16), jnp.int32),
        "ldc": jnp.zeros((n, 16), jnp.int32),
        "lnnz": jnp.zeros((n, 16), jnp.int32),
        "cdc": jnp.zeros((n, 2, 4), jnp.int32),
        "cac": jnp.zeros((n, 2, 4, 16), jnp.int32),
        "cnnz": jnp.zeros((n, 2, 4), jnp.int32),
    }

    def wave(d, bufs):
        y0 = jnp.maximum(0, (d - (mb_w - 1) + 1) // 2)
        ys = y0 + jnp.arange(wmax, dtype=jnp.int32)
        xs = d - 2 * ys
        valid = (xs >= 0) & (xs < mb_w) & (ys < mb_h)
        addr = ys * mb_w + xs
        px = xs * 16
        py = ys * 16
        av_l = valid & (xs > 0)
        av_t = valid & (ys > 0)
        av_tl = av_l & av_t
        av_tr = av_t & (xs < mb_w - 1)

        B = wmax
        recY = bufs["recY"]

        # ---- gather luma neighborhood: ext top row (corner+16+4) + left
        top_ext = jax.vmap(lambda x, y: lax.dynamic_slice(
            recY, (y, x), (1, 21))[0])(px, py)          # (B, 21)
        left_col = jax.vmap(lambda x, y: lax.dynamic_slice(
            recY, (y + 1, x), (16, 1))[:, 0])(px, py)   # (B, 16)
        omb = jax.vmap(lambda x, y: lax.dynamic_slice(
            o32, (y, x), (16, 16)))(
                jnp.clip(px, 0, w - 16), jnp.clip(py, 0, h - 16))

        # neighbor-MB I4 modes for most-probable-mode prediction
        i4m, cls = bufs["i4m"], bufs["cls"]
        l_addr = jnp.where(av_l, addr - 1, 0)
        t_addr = jnp.where(av_t, addr - mb_w, 0)
        lmb_modes = jnp.where((cls[l_addr] == 1)[:, None],
                              i4m[l_addr], 2)            # (B, 16)
        lmb_modes = jnp.where(av_l[:, None], lmb_modes, -1)
        tmb_modes = jnp.where((cls[t_addr] == 1)[:, None],
                              i4m[t_addr], 2)
        tmb_modes = jnp.where(av_t[:, None], tmb_modes, -1)

        # local working tile: L[j+1, i+1] = recon pixel (j, i) of the MB
        L = jnp.zeros((B, 17, 21), jnp.int32)
        L = L.at[:, 0, :].set(top_ext)
        L = L.at[:, 1:, 0].set(left_col)

        modes_loc = jnp.full((B, 16), -1, jnp.int32)
        scans_loc = jnp.zeros((B, 16, 16), jnp.int32)
        nnz_loc = jnp.zeros((B, 16), jnp.int32)
        cost4_tot = jnp.zeros(B, jnp.int32)
        big = jnp.int32(1 << 28)

        for ci in range(16):
            blk = CODE2RASTER[ci]
            by, bx = blk // 4, blk % 4
            x0, y0b = bx * 4, by * 4
            # availability (host _blk_avail twin)
            a_l = jnp.ones(B, bool) if bx > 0 else av_l
            a_t = jnp.ones(B, bool) if by > 0 else av_t
            if bx > 0 and by > 0:
                a_tl = jnp.ones(B, bool)
            elif bx == 0 and by > 0:
                a_tl = av_l
            elif by == 0 and bx > 0:
                a_tl = av_t
            else:
                a_tl = av_tl
            if by == 0:
                a_tr = av_t if bx < 3 else av_tr
            elif bx == 3:
                a_tr = jnp.zeros(B, bool)
            else:
                a_tr = jnp.full(
                    (B,), RASTER2CODE[(by - 1) * 4 + bx + 1] < ci)

            top8 = L[:, y0b, x0 + 1:x0 + 9]
            top8 = jnp.where(a_tr[:, None],
                             top8, jnp.concatenate(
                                 [top8[:, :4],
                                  jnp.broadcast_to(top8[:, 3:4], (B, 4))],
                                 axis=1))
            top8 = jnp.where(a_t[:, None], top8, 0)
            left4 = L[:, y0b + 1:y0b + 5, x0]
            left4 = jnp.where(a_l[:, None], left4, 0)
            corner = jnp.where(a_tl, L[:, y0b, x0], 0)
            rr = jnp.concatenate([left4[:, ::-1], corner[:, None], top8],
                                 axis=1)                 # (B, 13)
            preds = i4_predict_all(rr, a_t, a_l, a_tl)   # (B, 9, 16)
            ob = omb[:, y0b:y0b + 4, x0:x0 + 4].reshape(B, 1, 16)
            sad = jnp.abs(ob - preds).sum(-1)            # (B, 9)
            # most probable mode
            if bx > 0:
                ma = modes_loc[:, blk - 1]
            else:
                ma = lmb_modes[:, blk + 3]
            if by > 0:
                mb_ = modes_loc[:, blk - 4]
            else:
                mb_ = tmb_modes[:, blk + 12]
            mpm = jnp.where((ma < 0) | (mb_ < 0), 2, jnp.minimum(ma, mb_))
            cost = sad + lam4 * (jnp.arange(9) != mpm[:, None])
            # mode availability (host candidate set)
            allow = np.zeros(9, bool)
            allow[2] = True                              # DC
            m_t = jnp.asarray([True, False, False, True, False, False,
                               False, True, False])      # VERT DDL VL
            m_l = jnp.asarray([False, True, False, False, False, False,
                               False, False, True])      # HOR HU
            m_3 = jnp.asarray([False, False, False, False, True, True,
                               True, False, False])      # DDR VR HD
            ok = (jnp.asarray([False, False, True, False, False, False,
                               False, False, False])[None]
                  | (m_t[None] & a_t[:, None])
                  | (m_l[None] & a_l[:, None])
                  | (m_3[None] & (a_t & a_l & a_tl)[:, None]))
            cost = jnp.where(ok, cost, big)
            best_m = jnp.argmin(cost, axis=1).astype(jnp.int32)
            cost4_tot += jnp.min(cost, axis=1)
            pred = jnp.take_along_axis(
                preds, best_m[:, None, None], axis=1)[:, 0].reshape(B, 4, 4)
            scan, nnz, rec = _code_i4_block(
                omb[:, y0b:y0b + 4, x0:x0 + 4], pred, qpv)
            modes_loc = modes_loc.at[:, blk].set(best_m)
            scans_loc = scans_loc.at[:, blk].set(scan)
            nnz_loc = nnz_loc.at[:, blk].set(nnz)
            L = L.at[:, y0b + 1:y0b + 5, x0 + 1:x0 + 5].set(rec)

        # ---- I16 candidate --------------------------------------------
        t16 = top_ext[:, 1:17]
        l16 = left_col
        cnr = top_ext[:, 0]
        st = t16.sum(1)
        sl = l16.sum(1)
        dc16 = jnp.where(av_t & av_l, (st + sl + 16) >> 5,
                         jnp.where(av_t, (st + 8) >> 4,
                                   jnp.where(av_l, (sl + 8) >> 4, 128)))
        iw = jnp.arange(1, 9, dtype=jnp.int32)
        tt = jnp.concatenate([cnr[:, None], t16], axis=1)
        ll = jnp.concatenate([cnr[:, None], l16], axis=1)
        hh = (iw[None] * (tt[:, 8 + iw] - tt[:, 8 - iw])).sum(1)
        vv = (iw[None] * (ll[:, 8 + iw] - ll[:, 8 - iw])).sum(1)
        a_ = 16 * (l16[:, 15] + t16[:, 15])
        b_ = (5 * hh + 32) >> 6
        c_ = (5 * vv + 32) >> 6
        yy, xx = jnp.meshgrid(jnp.arange(16), jnp.arange(16), indexing="ij")
        p_pl = jnp.clip((a_[:, None, None] + b_[:, None, None] * (xx - 7)
                         + c_[:, None, None] * (yy - 7) + 16) >> 5, 0, 255)
        p_v = jnp.broadcast_to(t16[:, None, :], (B, 16, 16))
        p_h = jnp.broadcast_to(l16[:, :, None], (B, 16, 16))
        p_dc = jnp.broadcast_to(dc16[:, None, None], (B, 16, 16))
        cands = jnp.stack([p_v, p_h, p_dc, p_pl], axis=1)   # mode order 0..3
        sad16 = jnp.abs(omb[:, None] - cands).sum((-2, -1))
        okm = jnp.stack([av_t, av_l, jnp.ones(B, bool), av_t & av_l & av_tl],
                        axis=1)
        sad16 = jnp.where(okm, sad16, big)
        m16 = jnp.argmin(sad16, axis=1).astype(jnp.int32)
        cost16 = jnp.min(sad16, axis=1)
        pred16 = jnp.take_along_axis(
            cands, m16[:, None, None, None], axis=1)[:, 0]

        # I16 residual coding (decode-mirror of encoder _encode_i16)
        res16 = omb - pred16
        blocks16 = res16.reshape(B, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4) \
            .reshape(B, 16, 4, 4)
        w16 = T.forward4x4(blocks16)
        qpb = jnp.broadcast_to(qpv, (B, 16))
        dc_t = T.hadamard4x4(w16[:, :, 0, 0].reshape(B, 4, 4)) >> 1
        dc_lev = Q.quant_luma_dc(dc_t, jnp.broadcast_to(qpv, (B,)))
        dc_scan = dc_lev.reshape(B, 16)[:, jnp.asarray(_ZZ)]
        ac = Q.quant_4x4(w16, qpb, True)
        ac_scan = _to_scan(ac)
        ac_scan = ac_scan.at[..., 0].set(0)
        nnz16 = (ac_scan[..., 1:] != 0).sum(-1).astype(jnp.int32)
        has_ac = nnz16.sum(1) > 0
        ac_scan = jnp.where(has_ac[:, None, None], ac_scan, 0)
        nnz16 = jnp.where(has_ac[:, None], nnz16, 0)
        cbp16_luma = jnp.where(has_ac, 15, 0)
        d16 = Q.dequant_4x4(_from_scan(ac_scan), qpb)
        dc_r = _from_scan(dc_scan.reshape(B, 1, 16))[:, 0]
        dc_it = T.hadamard4x4(dc_r)
        scale = jnp.asarray(Q.FLAT_INV_SCALE_4x4)[qpv, 0, 0]
        dc_s = Q.rshift_rnd_sf((dc_it * scale) << (qpv // 6), 6)
        d16 = d16.at[:, :, 0, 0].set(dc_s.reshape(B, 16))
        r16 = T.inverse4x4_round(d16)
        pred_b16 = pred16.reshape(B, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4) \
            .reshape(B, 16, 4, 4)
        rec16 = jnp.clip(pred_b16 + r16, 0, 255)
        rec16 = rec16.reshape(B, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4) \
            .reshape(B, 16, 16)

        # ---- choose I16 vs I4 (md_low rule) ----------------------------
        use16 = cost16 + 24 * lam < cost4_tot
        recL = jnp.where(use16[:, None, None], rec16, L[:, 1:, 1:17])
        qb = jnp.asarray([[0, 1, 4, 5], [2, 3, 6, 7],
                          [8, 9, 12, 13], [10, 11, 14, 15]])
        nnzq = nnz_loc[:, qb].sum(-1)
        cbp4_luma = ((nnzq > 0) * jnp.asarray([1, 2, 4, 8])[None]).sum(1)
        cls_out = jnp.where(use16, 2, 1)
        cbp_luma = jnp.where(use16, cbp16_luma, cbp4_luma)
        modes_out = jnp.where(use16[:, None], -1, modes_loc)
        lcoef_out = jnp.where(use16[:, None, None],
                              ac_scan, scans_loc)
        lnnz_out = jnp.where(use16[:, None], nnz16, nnz_loc)
        ldc_out = jnp.where(use16[:, None], dc_scan, 0)
        i16_out = jnp.where(use16, m16, -1)

        # ---- chroma intra ----------------------------------------------
        recU, recV = bufs["recU"], bufs["recV"]
        cx = xs * 8
        cy = ys * 8
        ctopU = jax.vmap(lambda x, y: lax.dynamic_slice(
            recU, (y, x), (1, 9))[0])(cx, cy)
        ctopV = jax.vmap(lambda x, y: lax.dynamic_slice(
            recV, (y, x), (1, 9))[0])(cx, cy)
        cleftU = jax.vmap(lambda x, y: lax.dynamic_slice(
            recU, (y + 1, x), (8, 1))[:, 0])(cx, cy)
        cleftV = jax.vmap(lambda x, y: lax.dynamic_slice(
            recV, (y + 1, x), (8, 1))[:, 0])(cx, cy)
        cmbU = jax.vmap(lambda x, y: lax.dynamic_slice(oU, (y, x), (8, 8)))(
            jnp.clip(cx, 0, cw - 8), jnp.clip(cy, 0, ch - 8))
        cmbV = jax.vmap(lambda x, y: lax.dynamic_slice(oV, (y, x), (8, 8)))(
            jnp.clip(cx, 0, cw - 8), jnp.clip(cy, 0, ch - 8))

        def chroma_cands(ctop, cleft, corner):
            t8 = ctop[:, 1:]
            l8 = cleft
            # DC per 4x4 block with position rules (4:2:0)
            ts = t8.reshape(B, 2, 4).sum(-1)             # (B, 2) x-halves
            ls = l8.reshape(B, 2, 4).sum(-1)             # (B, 2) y-halves
            both = av_t & av_l

            def dcv(pos, tsv, lsv):
                if pos in (0, 3):
                    return jnp.where(both, (tsv + lsv + 4) >> 3,
                                     jnp.where(av_t, (tsv + 2) >> 2,
                                               jnp.where(av_l, (lsv + 2) >> 2,
                                                         128)))
                if pos == 1:
                    return jnp.where(av_t, (tsv + 2) >> 2,
                                     jnp.where(av_l, (lsv + 2) >> 2, 128))
                return jnp.where(av_l, (lsv + 2) >> 2,
                                 jnp.where(av_t, (tsv + 2) >> 2, 128))

            p_dc = jnp.zeros((B, 8, 8), jnp.int32)
            for byy in range(2):
                for bxx in range(2):
                    pos = (0 if bxx == 0 else 1) if byy == 0 \
                        else (2 if bxx == 0 else 3)
                    v = dcv(pos, ts[:, bxx], ls[:, byy])
                    p_dc = p_dc.at[:, byy * 4:byy * 4 + 4,
                                   bxx * 4:bxx * 4 + 4].set(
                        v[:, None, None])
            p_h = jnp.broadcast_to(l8[:, :, None], (B, 8, 8))
            p_v = jnp.broadcast_to(t8[:, None, :], (B, 8, 8))
            m = corner
            tt = ctop
            ll = jnp.concatenate([corner[:, None], l8], axis=1)
            iw4 = jnp.arange(1, 5, dtype=jnp.int32)
            hh = (iw4[None] * (tt[:, 4 + iw4] - tt[:, 4 - iw4])).sum(1)
            vv = (iw4[None] * (ll[:, 4 + iw4] - ll[:, 4 - iw4])).sum(1)
            a_c = 16 * (l8[:, 7] + t8[:, 7])
            b_c = (34 * hh + 32) >> 6
            c_c = (17 * vv + 16) >> 5
            yy8, xx8 = jnp.meshgrid(jnp.arange(8), jnp.arange(8),
                                    indexing="ij")
            p_pl = jnp.clip((a_c[:, None, None]
                             + b_c[:, None, None] * (xx8 - 3)
                             + c_c[:, None, None] * (yy8 - 3) + 16) >> 5,
                            0, 255)
            return jnp.stack([p_dc, p_h, p_v, p_pl], axis=1)

        candU = chroma_cands(ctopU, cleftU, ctopU[:, 0])
        candV = chroma_cands(ctopV, cleftV, ctopV[:, 0])
        csad = (jnp.abs(cmbU[:, None] - candU).sum((-2, -1))
                + jnp.abs(cmbV[:, None] - candV).sum((-2, -1)))
        okc = jnp.stack([jnp.ones(B, bool), av_l, av_t,
                         av_t & av_l & av_tl], axis=1)
        csad = jnp.where(okc, csad, big)
        cmode = jnp.argmin(csad, axis=1).astype(jnp.int32)
        predU = jnp.take_along_axis(candU, cmode[:, None, None, None],
                                    axis=1)[:, 0]
        predV = jnp.take_along_axis(candV, cmode[:, None, None, None],
                                    axis=1)[:, 0]

        # chroma residual, intra deadzone (chroma_residual_inter twin
        # with intra=True)
        o2 = jnp.stack([cmbU, cmbV], axis=1)
        p2 = jnp.stack([predU, predV], axis=1)
        res = o2 - p2
        blocks = res.reshape(B, 2, 2, 4, 2, 4).transpose(0, 1, 2, 4, 3, 5) \
            .reshape(B, 2, 4, 4, 4)
        wt = T.forward4x4(blocks)
        dcs = wt[..., 0, 0]
        dc_tc = T.hadamard2x2(dcs.reshape(B, 2, 2, 2))
        qpc2 = jnp.broadcast_to(qpcv, (B, 2))
        cdc_lev = Q.quant_chroma_dc(dc_tc, qpc2[..., None, None], True) \
            .reshape(B, 2, 4)
        cac_q = Q.quant_4x4(wt, qpc2[..., None], True)
        cac_scan = _to_scan(cac_q)
        cac_scan = cac_scan.at[..., 0].set(0)
        # per-component chroma AC thresholding (block.c:1141, strict <;
        # JM applies it to intra chroma as well)
        from .enc_jax import _coeff_cost
        cost_c = _coeff_cost(cac_scan, start=1).sum(axis=2)
        cac_scan = jnp.where((cost_c >= 4)[..., None, None], cac_scan, 0)
        any_ac = (cac_scan[..., 1:] != 0).any((1, 2, 3))
        any_dc = (cdc_lev != 0).any((1, 2))
        cbp_c = jnp.where(any_ac, 2, jnp.where(any_dc, 1, 0))
        cac_scan = jnp.where((cbp_c < 2)[:, None, None, None], 0, cac_scan)
        cdc_lev = jnp.where((cbp_c == 0)[:, None, None], 0, cdc_lev)
        cnnz_out = (cac_scan[..., 1:] != 0).sum(-1).astype(jnp.int32)
        d4c = Q.dequant_4x4(_from_scan(cac_scan), qpc2[..., None])
        fc = T.hadamard2x2(cdc_lev.reshape(B, 2, 2, 2))
        scale_c = jnp.asarray(Q.FLAT_INV_SCALE_4x4)[qpc2, 0, 0]
        dc_sc = ((fc * scale_c[..., None, None]) <<
                 (qpc2[..., None, None] // 6)) >> 5
        d4c = d4c.at[..., 0, 0].set(dc_sc.reshape(B, 2, 4))
        rc = T.inverse4x4_round(d4c)
        pred_bc = p2.reshape(B, 2, 2, 4, 2, 4).transpose(0, 1, 2, 4, 3, 5) \
            .reshape(B, 2, 4, 4, 4)
        rec_c = jnp.clip(pred_bc + rc, 0, 255)
        rec_c = rec_c.reshape(B, 2, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5) \
            .reshape(B, 2, 8, 8)

        # ---- scatter everything back ------------------------------------
        drop_addr = jnp.where(valid, addr, n)
        yy16 = jnp.where(valid, py + 1, 1 + h)[:, None, None] \
            + jnp.arange(16)[None, :, None]
        xx16 = (px + 1)[:, None, None] + jnp.arange(16)[None, None, :]
        bufs = dict(bufs)
        bufs["recY"] = bufs["recY"].at[yy16, xx16].set(recL, mode="drop")
        yy8 = jnp.where(valid, cy + 1, 1 + ch)[:, None, None] \
            + jnp.arange(8)[None, :, None]
        xx8 = (cx + 1)[:, None, None] + jnp.arange(8)[None, None, :]
        bufs["recU"] = bufs["recU"].at[yy8, xx8].set(rec_c[:, 0],
                                                     mode="drop")
        bufs["recV"] = bufs["recV"].at[yy8, xx8].set(rec_c[:, 1],
                                                     mode="drop")
        bufs["cls"] = bufs["cls"].at[drop_addr].set(cls_out, mode="drop")
        bufs["i4m"] = bufs["i4m"].at[drop_addr].set(modes_out, mode="drop")
        bufs["i16m"] = bufs["i16m"].at[drop_addr].set(i16_out, mode="drop")
        bufs["cmode"] = bufs["cmode"].at[drop_addr].set(cmode, mode="drop")
        bufs["cbp"] = bufs["cbp"].at[drop_addr].set(
            (cbp_c << 4) | cbp_luma, mode="drop")
        bufs["lcoef"] = bufs["lcoef"].at[drop_addr].set(lcoef_out,
                                                        mode="drop")
        bufs["ldc"] = bufs["ldc"].at[drop_addr].set(ldc_out, mode="drop")
        bufs["lnnz"] = bufs["lnnz"].at[drop_addr].set(lnnz_out, mode="drop")
        bufs["cdc"] = bufs["cdc"].at[drop_addr].set(cdc_lev, mode="drop")
        bufs["cac"] = bufs["cac"].at[drop_addr].set(cac_scan, mode="drop")
        bufs["cnnz"] = bufs["cnnz"].at[drop_addr].set(cnnz_out, mode="drop")
        return bufs

    bufs = lax.fori_loop(0, n_waves, wave, bufs)
    out = dict(bufs)
    out["recY"] = bufs["recY"][1:1 + h, 1:1 + w].astype(jnp.uint8)
    out["recU"] = bufs["recU"][1:1 + ch, 1:1 + cw].astype(jnp.uint8)
    out["recV"] = bufs["recV"][1:1 + ch, 1:1 + cw].astype(jnp.uint8)
    return out
