"""Device RD mode decision for the P fast path (md_high twin, E8).

The round-3 gap analysis showed the +19%-bits distance between the
device pipeline and the JM fast anchor is the DECISION TIER, not the
device approximations: host md_low lands within 2% of the device path
while host md_high (exact-bit trial encode) reaches JM parity. This
module brings the md_high trial-encode structure onto the device
(reference lencod/src/md_high.c:38 encode_one_macroblock_high,
rdopt.c:1810 RDCost_for_macroblocks), batched over all MBs:

  - every (partition-job, quadrant) pair is trial-encoded once:
    MC prediction (reusing the sub-pel refine windows), exact
    transform/quant/recon, SSD, JM coefficient-cost thresholding;
  - per-block CAVLC bit lengths are computed EXACTLY (level/run/
    total_zeros parts shared across modes; the nC-dependent
    coeff_token length is resolved per mode from its own in-MB
    nnz field — MB-external context approximated as unavailable,
    the one documented deviation from the serial reference);
  - chroma is trial-encoded per mode (the 2x2 DC Hadamard couples a
    whole MB) and the 16x16 P_Skip candidate is priced as prediction
    SSD + ~1 bit, like the reference's forced-skip trial;
  - J = SSD + lambda_mode * bits picks the winner per MB; the final
    coefficient/recon tensors are gathered from the winning trials, so
    the committed state is exactly what a serial encoder would commit.

Decisions only — bitstream legality is unchanged (the serializer reads
the committed SoA); enabled by EncoderConfig.device_rd.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import enc_jax as EJ
from . import quant as Q
from . import transform as T
from .cavlc_jax import _CBP_INTER_INV, _CT_LEN_D, block_slots

# qjob index of (mode, quad): the qjob whose parent job serves quad q
# under partition mode m
QJOB_OF = np.zeros((4, 4), np.int32)
for _m in range(4):
    for _q in range(4):
        _j = EJ._BLK_JOB[_m, (_q // 2) * 8 + (_q % 2) * 2]
        for _k in range(16):
            if EJ.QJ_PARENT[_k] == _j and EJ.QJ_QUAD[_k] == _q:
                QJOB_OF[_m, _q] = _k

# raster 4x4 block id of (quad, sub-block): sub-blocks are 2x2 raster
# within the quad
RASTER_OF = np.zeros((4, 4), np.int32)
for _q in range(4):
    for _s in range(4):
        RASTER_OF[_q, _s] = ((_q // 2) * 2 + _s // 2) * 4 \
            + (_q % 2) * 2 + (_s % 2)
# inverse: raster block -> (quad, sub)
QUAD_OF_BLK = np.zeros(16, np.int32)
SUB_OF_BLK = np.zeros(16, np.int32)
for _q in range(4):
    for _s in range(4):
        QUAD_OF_BLK[RASTER_OF[_q, _s]] = _q
        SUB_OF_BLK[RASTER_OF[_q, _s]] = _s

_SE_BITS_NP = EJ._SE_BITS      # converted lazily (a module-level
                               # jnp.asarray would leak a tracer when the
                               # first import happens inside a jit trace)

# mb_type ue(v) length for P modes 0..3 + sub_mb_type overhead (mode 3:
# four ue(0) = 4 bits)
_MODE_HDR_BITS = np.array([1 + 0, 3 + 0, 3 + 0, 5 + 4], np.int32)

# per (mode, quad): the parent partition job, whether this quad is the
# job's FIRST quad (mvd is written once per job), and the job's index
# within MODE_JOBS[mode] (the mv_pred_parts partition slot)
PARENT_OF = np.zeros((4, 4), np.int32)
FIRSTQ = np.zeros((4, 4), np.int32)
PART_OF = np.zeros((4, 4), np.int32)
for _m in range(4):
    seen = set()
    for _q in range(4):
        _j = int(EJ.QJ_PARENT[QJOB_OF[_m, _q]])
        PARENT_OF[_m, _q] = _j
        PART_OF[_m, _q] = EJ.MODE_JOBS[_m].index(_j)
        if _j not in seen:
            FIRSTQ[_m, _q] = 1
            seen.add(_j)


def lambda_mode_f(qp: int) -> float:
    """md_high lambda (rdo.lambda_mode twin): 0.85 * 2^((qp-12)/3)."""
    return 0.85 * 2.0 ** ((qp - 12) / 3.0)


def _ue_len_arr(v):
    r = jnp.zeros_like(v)
    x = v + 1
    for s in (16, 8, 4, 2, 1):
        hit = x >= (1 << s)
        r = r + jnp.where(hit, s, 0)
        x = jnp.where(hit, x >> s, x)
    return 2 * r + 1


def luma_quad_tq(oq, pred8, qp):
    """Trial-encode 8x8 luma quads: oq/pred8 (B, 8, 8) int32.

    Returns (scan (B, 4, 16) i32 [post quad-threshold], costq (B,),
    nnz (B, 4), ssd_coded (B,), ssd_zero (B,), rec (B, 8, 8) u8).
    Mirrors enc_jax.luma_residual_inter per-quad (the MB-level <=5
    threshold is applied by the caller per mode)."""
    b = oq.shape[0]
    res = oq - pred8
    blocks = res.reshape(b, 2, 4, 2, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(b, 4, 4, 4)
    wt = T.forward4x4(blocks)
    qpv = jnp.broadcast_to(qp, (b, 4))
    lev = Q.quant_4x4(wt, qpv, False)
    scan = EJ._to_scan(lev)
    cost_blk = EJ._coeff_cost(scan)                    # (B, 4)
    costq = cost_blk.sum(axis=1)
    keep = (costq > 4)[:, None, None]
    scan = jnp.where(keep, scan, 0)
    d = Q.dequant_4x4(EJ._from_scan(scan), qpv)
    r = T.inverse4x4_round(d)
    pred_b = pred8.reshape(b, 2, 4, 2, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(b, 4, 4, 4)
    rec_b = jnp.clip(pred_b + r, 0, 255)
    rec = rec_b.reshape(b, 2, 2, 4, 4).transpose(0, 1, 3, 2, 4) \
        .reshape(b, 8, 8)
    ssd_coded = ((oq - rec) ** 2).sum(axis=(1, 2))
    ssd_zero = ((oq - jnp.clip(pred8, 0, 255)) ** 2).sum(axis=(1, 2))
    nnz = (scan != 0).sum(axis=2).astype(jnp.int32)
    return scan, costq, nnz, ssd_coded, ssd_zero, rec.astype(jnp.uint8)


def block_len_parts(scan, max_coeff: int):
    """nC-independent CAVLC length parts of batched blocks — a lens-only
    specialization of cavlc_jax.block_slots (no codeword math).

    scan: (B, L). Returns (tc (B,), t1 (B,), rest_len (B,)) where
    rest = t1 signs + levels + total_zeros + run_before bits; the
    caller adds the nC-dependent coeff_token length.

    Implemented as ONE descending-position walk carrying (B,)-shaped
    state (rank, suffix-length, zeros-left, previous position) instead
    of materializing per-rank level/position tensors (16 masked selects
    over (B, 16)); this form reads one (B,) column per step."""
    from .cavlc_jax import _RUN_LEN_D, _TZ_DC420_LEN_D, _TZ_LEN_D
    B, L = scan.shape
    c = scan.astype(jnp.int32)
    mask = c != 0
    tc = mask.sum(axis=1)
    # trailing ones: rank-j (from the high-frequency end) is a +-1
    rfe = jnp.cumsum(mask[:, ::-1], axis=1)[:, ::-1]
    is1 = (jnp.abs(c) == 1) & mask
    o0 = ((rfe == 1) & is1).any(axis=1)
    o1 = ((rfe == 2) & is1).any(axis=1)
    o2 = ((rfe == 3) & is1).any(axis=1)
    a0 = o0 & (tc >= 1)
    a1 = a0 & o1 & (tc >= 2)
    a2 = a1 & o2 & (tc >= 3)
    t1 = a0.astype(jnp.int32) + a1 + a2

    # total_zeros from the highest nonzero position
    hi = (L - 1) - jnp.argmax(mask[:, ::-1], axis=1).astype(jnp.int32)
    tz = hi + 1 - tc
    rest = t1                                 # trailing-one sign bits
    tzc = jnp.clip(tz, 0, max_coeff - 1)
    vi = jnp.clip(tc - 1, 0, max_coeff - 2)
    if max_coeff == 4:
        tzl = jnp.asarray(_TZ_DC420_LEN_D)[vi, tzc]
    else:
        tzl = jnp.asarray(_TZ_LEN_D)[vi, tzc]
    rest = rest + jnp.where((tc > 0) & (tc < max_coeff), tzl, 0)

    run_tab = jnp.asarray(_RUN_LEN_D)
    sl = jnp.where((tc > 10) & (t1 < 3), 1, 0)
    j = jnp.zeros(B, jnp.int32)               # rank of the next nonzero
    zl = jnp.where(tc > 0, tz, 0)
    prev = hi
    for p in range(L - 1, -1, -1):
        lv = c[:, p]
        nz = mask[:, p]
        # level bits (ranks >= t1)
        lvl_act = nz & (j >= t1)
        lc = jnp.where(lv > 0, 2 * lv - 2, -2 * lv - 1)
        lc = lc - jnp.where((j == t1) & (t1 < 3), 2, 0)
        l0 = jnp.where(lc < 14, lc + 1, jnp.where(lc < 30, 19, 28))
        pre = lc >> jnp.maximum(sl, 1).astype(jnp.int32)
        lN = jnp.where(pre < 15, pre + 1 + sl, 28)
        ln = jnp.where(sl == 0, l0, lN)
        rest = rest + jnp.where(lvl_act, ln, 0)
        sl_next = jnp.maximum(sl, 1)
        sl_next = jnp.where((jnp.abs(lv) > (3 << (sl_next - 1)))
                            & (sl_next < 6), sl_next + 1, sl_next)
        sl = jnp.where(lvl_act, sl_next, sl)
        # run_before bits (ranks >= 1, while zeros remain)
        run = prev - p - 1
        run_act = nz & (j >= 1) & (zl > 0)
        vlc = jnp.clip(jnp.minimum(zl, 7) - 1, 0, 6)
        rl = run_tab[vlc, jnp.clip(run, 0, 14)]
        rest = rest + jnp.where(run_act, rl, 0)
        zl = jnp.where(run_act, zl - run, zl)
        prev = jnp.where(nz, p, prev)
        j = j + nz
    return tc, t1, rest


def _ct_len(nc_cat, t1, tc):
    """coeff_token length from category (0..2 tables, 3=FLC nc>=8)."""
    tab = jnp.asarray(_CT_LEN_D)[jnp.clip(nc_cat, 0, 2), t1, tc]
    return jnp.where(nc_cat >= 3, 6, tab)


def _nc_cat(nc):
    return jnp.where(nc < 2, 0, jnp.where(nc < 4, 1,
                                          jnp.where(nc < 8, 2, 3)))


def _luma_nc_inmb(nnz16):
    """In-MB nC per raster block (MB-external neighbors treated as
    unavailable — the batched-RD approximation). nnz16: (N, 16)."""
    n = nnz16.shape[0]
    g = nnz16.reshape(n, 4, 4)
    za = jnp.zeros((n, 4, 1), jnp.int32)
    na = jnp.concatenate([za, g[:, :, :-1]], axis=2)
    nb = jnp.concatenate([jnp.zeros((n, 1, 4), jnp.int32), g[:, :-1]],
                         axis=1)
    bx = jnp.arange(4)[None, None, :]
    by = jnp.arange(4)[None, :, None]
    ha = bx > 0
    hb = by > 0
    nc = jnp.where(ha & hb, (na + nb + 1) >> 1,
                   jnp.where(ha, na, jnp.where(hb, nb, 0)))
    return nc.reshape(n, 16)


def _chroma_nc_inmb(cnnz):
    """In-MB chroma nC (2x2 blocks per comp). cnnz: (N, 2, 4)."""
    n = cnnz.shape[0]
    g = cnnz.reshape(n, 2, 2, 2)
    na = jnp.concatenate([jnp.zeros((n, 2, 2, 1), jnp.int32),
                          g[..., :-1]], axis=3)
    nb = jnp.concatenate([jnp.zeros((n, 2, 1, 2), jnp.int32),
                          g[:, :, :-1]], axis=2)
    bx = jnp.arange(2)[None, None, None, :]
    by = jnp.arange(2)[None, None, :, None]
    ha = bx > 0
    hb = by > 0
    nc = jnp.where(ha & hb, (na + nb + 1) >> 1,
                   jnp.where(ha, na, jnp.where(hb, nb, 0)))
    return nc.reshape(n, 2, 4)


def _chroma_trial(cband, mv_quad, mb_xy, orig_u, orig_v, qpc, sr):
    """Chroma trial-encode for one motion hypothesis set."""
    pu, pv = EJ.mc_chroma_quads_band(cband, mv_quad, mb_xy, sr)
    dc, ac, cnnz, cbp_c, recU, recV = EJ.chroma_residual_inter(
        orig_u, orig_v, pu, pv, qpc)
    ssd = (((orig_u.astype(jnp.int32) - recU) ** 2).sum(axis=(1, 2))
           + ((orig_v.astype(jnp.int32) - recV) ** 2).sum(axis=(1, 2)))
    n = orig_u.shape[0]
    # chroma DC bits (nc = -1 fixed)
    _dv, dl, _do = block_slots(dc.reshape(n * 2, 4),
                               jnp.full(n * 2, -1, jnp.int32), 4)
    dc_bits = dl.sum(axis=1).reshape(n, 2).sum(axis=1)
    # chroma AC bits with in-MB nC
    tc_a, t1_a, rest_a = block_len_parts(
        ac.reshape(n * 8, 16)[:, 1:], 15)
    ncc = _nc_cat(_chroma_nc_inmb(cnnz).reshape(n * 8))
    ac_bits = (_ct_len(ncc, t1_a, tc_a) + rest_a).reshape(n, 8) \
        .sum(axis=1)
    bits = jnp.where(cbp_c >= 1, dc_bits, 0) \
        + jnp.where(cbp_c >= 2, ac_bits, 0)
    return dict(dc=dc, ac=ac, cnnz=cnnz, cbp_c=cbp_c, recU=recU,
                recV=recV, ssd=ssd, bits=bits)


def p_mode_rd_device(band, cband, win, mv_q, int_mv, pred, orig_q,
                     orig_u, orig_v, mb_xy, qp, qpc, *,
                     mb_w: int, mb_h: int, sr: int,
                     mode_satd=None, top_modes: int = 4):
    """Batched md_high: pick per-MB among {P_Skip, 16x16, 16x8, 8x16,
    8x8} by J = SSD + lambda_mode * exact bits. Returns the committed
    fields (inter_mode, mv_quad, luma scan16/nnz/cbp, chroma set,
    recY/recU/recV as MB tensors).

    top_modes=2 (with mode_satd, the SATD+rate mode costs of the
    subpel stage) prunes the trial set per MB to the two best
    SATD-ranked partition modes before trial encoding — the batched
    twin of the reference's fast-tier mode preselection
    (lencod/src/md_highfast.c:95 mode skip heuristics): the trial
    encode, bit pricing and chroma RD all run on 8 qjobs/MB instead
    of 16. P_Skip is always kept as a candidate."""
    if top_modes < 4 and mode_satd is not None:
        return _p_mode_rd_pruned(band, cband, win, mv_q, int_mv, pred,
                                 orig_q, orig_u, orig_v, mb_xy, qp, qpc,
                                 mode_satd, mb_w=mb_w, mb_h=mb_h, sr=sr)
    return _p_mode_rd_full(band, cband, win, mv_q, int_mv, pred,
                           orig_q, orig_u, orig_v, mb_xy, qp, qpc,
                           mb_w=mb_w, mb_h=mb_h, sr=sr)


def _p_mode_rd_full(band, cband, win, mv_q, int_mv, pred, orig_q,
                    orig_u, orig_v, mb_xy, qp, qpc, *,
                    mb_w: int, mb_h: int, sr: int):
    """All-modes trial encode (md_high twin, the top_modes=4 tier)."""
    n = mb_w * mb_h
    lam_f = jnp.float32(lambda_mode_f(qp))
    cbp_inv = jnp.asarray(_CBP_INTER_INV)

    # ---- per-qjob luma trials ----------------------------------------
    blk_pred = EJ.qjob_pred_blocks(win, mv_q, int_mv)     # (N,16,8,8)
    oq = orig_q[:, jnp.asarray(EJ.QJ_QUAD)].astype(jnp.int32)
    scan4, costq, nnz4, ssd_c, ssd_z, rec8 = luma_quad_tq(
        oq.reshape(n * 16, 8, 8), blk_pred.reshape(n * 16, 8, 8), qp)
    scan4 = scan4.reshape(n, 16, 4, 16)
    costq = costq.reshape(n, 16)
    nnz4 = nnz4.reshape(n, 16, 4)
    ssd_c = ssd_c.reshape(n, 16)
    ssd_z = ssd_z.reshape(n, 16)
    rec8 = rec8.reshape(n, 16, 8, 8)
    tc_b, t1_b, rest_b = block_len_parts(
        scan4.reshape(n * 16 * 4, 16), 16)
    tc_b = tc_b.reshape(n, 16, 4)
    t1_b = t1_b.reshape(n, 16, 4)
    rest_b = rest_b.reshape(n, 16, 4)

    # ---- per-mode luma cost ------------------------------------------
    qj = jnp.asarray(QJOB_OF)                             # (4 modes, 4)
    mode_fields = []
    for m in range(4):
        sel = qj[m]
        cq = costq[:, sel]                                # (N, 4)
        keep_q = cq > 4
        total = jnp.where(keep_q, cq, 0).sum(axis=1)
        kept = keep_q & (total > 5)[:, None]
        luma_ssd = jnp.where(kept, ssd_c[:, sel], ssd_z[:, sel]) \
            .sum(axis=1)
        nnz_m = jnp.where(kept[..., None], nnz4[:, sel], 0)  # (N,4,4)
        # raster nnz field for nC
        nnz16 = jnp.zeros((n, 16), jnp.int32)
        nnz16 = nnz16.at[:, jnp.asarray(RASTER_OF).reshape(-1)].set(
            nnz_m.reshape(n, 16))
        nc16 = _nc_cat(_luma_nc_inmb(nnz16))
        # block bits (only kept quads' blocks are written)
        ct = _ct_len(nc16[:, jnp.asarray(RASTER_OF).reshape(-1)]
                     .reshape(n, 4, 4),
                     t1_b[:, sel], tc_b[:, sel])
        bl = (ct + rest_b[:, sel]).sum(axis=2)            # (N, 4)
        luma_bits = jnp.where(kept, bl, 0).sum(axis=1)
        cbp_l = ((nnz_m.sum(axis=2) > 0).astype(jnp.int32)
                 * jnp.asarray([1, 2, 4, 8])[None]).sum(axis=1)
        # mvd bits vs the approximate predictor (decision rate term)
        jobs = EJ.MODE_JOBS[m]
        mvb = jnp.zeros(n, jnp.int32)
        for j in jobs:
            d = mv_q[:, j] - pred
            mvb = mvb + jnp.asarray(_SE_BITS_NP)[jnp.clip(jnp.abs(d[:, 0]), 0, 4095)] \
                + jnp.asarray(_SE_BITS_NP)[jnp.clip(jnp.abs(d[:, 1]), 0, 4095)]
        mode_fields.append(dict(kept=kept, luma_ssd=luma_ssd,
                                luma_bits=luma_bits, cbp_l=cbp_l,
                                mvb=mvb, nnz16=nnz16))

    # ---- per-mode chroma trials --------------------------------------
    quad_js = [jnp.asarray(QJOB_OF[m]) for m in range(4)]
    chroma = []
    for m in range(4):
        mvq_m = jnp.take_along_axis(
            mv_q, jnp.asarray(EJ.QJ_PARENT)[quad_js[m]][:, None]
            .T[None].repeat(n, 0), axis=1) if False else \
            mv_q[:, jnp.asarray([int(EJ.QJ_PARENT[int(k)])
                                 for k in QJOB_OF[m]])]
        chroma.append(_chroma_trial(cband, mvq_m, mb_xy, orig_u,
                                    orig_v, qpc, sr))

    orig16 = orig_q.astype(jnp.int32).reshape(n, 2, 2, 8, 8) \
        .transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
    blk_quad = jnp.asarray(
        [(b // 8) * 2 + ((b % 4) // 2) for b in range(16)])

    def skip_trial(smv):
        s4 = jnp.broadcast_to(smv[:, None, :], (n, 4, 2))
        p16 = EJ.mc_luma_quads_band(band, s4, mb_xy, sr)
        ssd_l = ((orig16 - p16) ** 2).sum(axis=(1, 2))
        pu, pv = EJ.mc_chroma_quads_band(cband, s4, mb_xy, sr)
        ssd_c = (((orig_u.astype(jnp.int32) - pu) ** 2).sum(axis=(1, 2))
                 + ((orig_v.astype(jnp.int32) - pv) ** 2).sum(axis=(1, 2)))
        return s4, p16, pu, pv, (ssd_l + ssd_c).astype(jnp.float32)

    def decide(mvb_by_mode, j_skip):
        js = [j_skip]
        for m in range(4):
            mf = mode_fields[m]
            ch = chroma[m]
            cbp_full = mf["cbp_l"] | (ch["cbp_c"] << 4)
            cbp_bits = _ue_len_arr(cbp_inv[jnp.clip(cbp_full, 0, 47)])
            dqp_bits = (cbp_full != 0).astype(jnp.int32)
            bits = (int(_MODE_HDR_BITS[m]) + mvb_by_mode[m] + cbp_bits
                    + dqp_bits + mf["luma_bits"] + ch["bits"])
            js.append((mf["luma_ssd"] + ch["ssd"]).astype(jnp.float32)
                      + lam_f * bits.astype(jnp.float32))
        jstack = jnp.stack(js, axis=1)                    # (N, 5)
        win_i = jnp.argmin(jstack, axis=1).astype(jnp.int32)
        return win_i, jstack

    # ---- pass 1: approximate (per-MB) predictor rate ------------------
    skip4, pred16_skip, pu_s, pv_s, ssd_skip = skip_trial(pred)
    mvb_p1 = [mode_fields[m]["mvb"] for m in range(4)]
    win_p1, _ = decide(mvb_p1, ssd_skip + lam_f)
    best_p1 = jnp.clip(win_p1 - 1, 0, 3)
    mvq_modes_p = jnp.stack(
        [mv_q[:, jnp.asarray([int(EJ.QJ_PARENT[int(k)])
                              for k in QJOB_OF[m]])] for m in range(4)],
        axis=0)
    mv_quad_p1 = jnp.take_along_axis(
        mvq_modes_p, best_p1[None, :, None, None], axis=0)[0]
    mv_quad_p1 = jnp.where((win_p1 == 0)[:, None, None],
                           skip4, mv_quad_p1)
    mode_p1 = jnp.where(win_p1 == 0, 0, best_p1)

    # ---- pass 2: exact median predictors from the pass-1 field --------
    from .cavlc_jax import mv_pred_parts, skip_mv_field
    mv4_p1 = mv_quad_p1[:, blk_quad]
    allpred = mv_pred_parts(mv4_p1, mode_p1, mb_w, mb_h,
                            all_modes=True)               # (N, 4m, 4p, 2)
    mvb_p2 = []
    for m in range(4):
        jobs = EJ.MODE_JOBS[m]
        mvb = jnp.zeros(n, jnp.int32)
        for pi, j in enumerate(jobs):
            d = mv_q[:, j] - allpred[:, m, pi]
            mvb = mvb + jnp.asarray(_SE_BITS_NP)[jnp.clip(jnp.abs(d[:, 0]), 0, 4095)] \
                + jnp.asarray(_SE_BITS_NP)[jnp.clip(jnp.abs(d[:, 1]), 0, 4095)]
        mvb_p2.append(mvb)
    smv_exact = skip_mv_field(mv4_p1, mb_w, mb_h)
    skip4, pred16_skip, pu_s, pv_s, ssd_skip2 = skip_trial(smv_exact)
    win_i, jstack = decide(mvb_p2, ssd_skip2)             # true skip ~0 bits
    is_skip = win_i == 0
    best_m = jnp.clip(win_i - 1, 0, 3)

    # ---- gather final fields -----------------------------------------
    sel_q = qj[best_m]                                    # (N, 4)
    kept_all = jnp.stack([mode_fields[m]["kept"] for m in range(4)],
                         axis=0)                          # (4, N, 4)
    kept_w = jnp.take_along_axis(
        kept_all, best_m[None, :, None], axis=0)[0]       # (N, 4)
    kept_w = kept_w & ~is_skip[:, None]

    def take_qjob(arr):
        """arr (N, 16, ...) -> (N, 4, ...) at the winner's qjobs."""
        idx = sel_q.reshape(n, 4, *([1] * (arr.ndim - 2)))
        return jnp.take_along_axis(arr, idx, axis=1)

    scan_q = jnp.where(kept_w[..., None, None], take_qjob(scan4), 0)
    nnz_q = jnp.where(kept_w[..., None], take_qjob(nnz4), 0)
    rec_q = jnp.where(kept_w[..., None, None], take_qjob(rec8),
                      jnp.clip(take_qjob(blk_pred.reshape(n, 16, 8, 8)),
                               0, 255).astype(jnp.uint8))
    # skip: recon = skip prediction
    skip_rec = pred16_skip.reshape(n, 2, 8, 2, 8) \
        .transpose(0, 1, 3, 2, 4).reshape(n, 4, 8, 8).astype(jnp.uint8)
    rec_q = jnp.where(is_skip[:, None, None, None], skip_rec, rec_q)

    # raster-order luma fields
    qb = jnp.asarray(QUAD_OF_BLK)
    sb = jnp.asarray(SUB_OF_BLK)
    scan16 = scan_q[:, qb, sb]                            # (N, 16, 16)
    nnz16 = nnz_q[:, qb, sb]
    cbp_l = ((nnz_q.sum(axis=2) > 0).astype(jnp.int32)
             * jnp.asarray([1, 2, 4, 8])[None]).sum(axis=1)
    recY = rec_q.reshape(n, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)

    # chroma gather (5-way)
    def ch_sel(key, zero_like):
        outs = jnp.stack([chroma[m][key] for m in range(4)], axis=0)
        v = jnp.take_along_axis(
            outs, best_m.reshape(1, n, *([1] * (outs.ndim - 2))),
            axis=0)[0]
        zl = jnp.zeros_like(v) if zero_like is None else zero_like
        ex = is_skip.reshape(n, *([1] * (v.ndim - 1)))
        return jnp.where(ex, zl, v)

    dc_f = ch_sel("dc", None)
    ac_f = ch_sel("ac", None)
    cnnz_f = ch_sel("cnnz", None)
    cbp_c_f = ch_sel("cbp_c", None)
    recU_f = ch_sel("recU", jnp.clip(pu_s, 0, 255).astype(jnp.uint8))
    recV_f = ch_sel("recV", jnp.clip(pv_s, 0, 255).astype(jnp.uint8))

    mv_quad = jnp.take_along_axis(
        mvq_modes_p, best_m[None, :, None, None], axis=0)[0]
    mv_quad = jnp.where(is_skip[:, None, None], skip4, mv_quad)
    inter_mode = jnp.where(is_skip, 0, best_m)

    # SATD-scale inter cost for the intra trigger (md_low scale)
    return dict(inter_mode=inter_mode.astype(jnp.int32),
                mv_quad=mv_quad,
                luma_scan=scan16, luma_nnz=nnz16,
                cbp=(cbp_c_f << 4) | cbp_l,
                chroma_dc=dc_f, chroma_scan=ac_f, chroma_nnz=cnnz_f,
                recY_mbs=recY, recU_mbs=recU_f, recV_mbs=recV_f,
                j_win=jnp.min(jstack, axis=1))


def _p_mode_rd_pruned(band, cband, win, mv_q, int_mv, pred, orig_q,
                      orig_u, orig_v, mb_xy, qp, qpc, mode_satd, *,
                      mb_w: int, mb_h: int, sr: int):
    """Trial-encode RD restricted per MB to the top-2 SATD-ranked
    partition modes (P_Skip always stays a candidate). Identical cost
    model to _p_mode_rd_full on the surviving candidates; the only
    difference is the md_highfast-style preselection."""
    n = mb_w * mb_h
    ns = 2
    lam_f = jnp.float32(lambda_mode_f(qp))
    cbp_inv = jnp.asarray(_CBP_INTER_INV)
    se = jnp.asarray(_SE_BITS_NP)

    # ---- candidate modes by SATD + rate cost --------------------------
    m1 = jnp.argmin(mode_satd, axis=1).astype(jnp.int32)
    masked = jnp.where(jnp.arange(4)[None] == m1[:, None],
                       jnp.asarray(np.float32(np.inf)),
                       mode_satd.astype(jnp.float32))
    m2 = jnp.argmin(masked, axis=1).astype(jnp.int32)
    cand = jnp.stack([m1, m2], axis=1)                    # (N, 2)

    sel_qjob = jnp.asarray(QJOB_OF)[cand]                 # (N, 2, 4)
    parent = jnp.asarray(PARENT_OF)[cand]                 # (N, 2, 4)
    firstq = jnp.asarray(FIRSTQ)[cand]                    # (N, 2, 4)
    partof = jnp.asarray(PART_OF)[cand]                   # (N, 2, 4)
    hdr_bits = jnp.asarray(_MODE_HDR_BITS)[cand]          # (N, 2)
    flat_sel = sel_qjob.reshape(n, ns * 4)                # (N, 8)

    # ---- gather trial inputs at the surviving qjobs -------------------
    # extract all 16 qjob predictions first (49-way static select over
    # the refine windows), then gather the surviving (8, 8) blocks: a
    # take_along_axis on the (N, 16, 4, 10, 10) window tensor itself
    # costs more than the halved select saves (large-slice gathers)
    blk_all = EJ.qjob_pred_blocks(win, mv_q, int_mv)      # (N, 16, 8, 8)
    blk_pred = jnp.take_along_axis(
        blk_all, flat_sel[:, :, None, None], axis=1) \
        .reshape(n * ns * 4, 8, 8)                        # (N8, 8, 8)
    # slot-local trial order IS quad order (QJOB_OF rows are per-quad)
    oq_sub = orig_q.astype(jnp.int32)[
        jnp.arange(n)[:, None],
        jnp.asarray(EJ.QJ_QUAD)[flat_sel]]                # (N, 8, 8, 8)
    mv_sel = jnp.take_along_axis(
        mv_q, parent.reshape(n, ns * 4)[..., None], axis=1) \
        .reshape(n, ns, 4, 2)                             # (N, 2, 4, 2)

    scan4, costq, nnz4, ssd_c, ssd_z, rec8 = luma_quad_tq(
        oq_sub.reshape(n * ns * 4, 8, 8), blk_pred, qp)
    scan4 = scan4.reshape(n, ns, 4, 4, 16)
    costq = costq.reshape(n, ns, 4)
    nnz4 = nnz4.reshape(n, ns, 4, 4)
    ssd_c = ssd_c.reshape(n, ns, 4)
    ssd_z = ssd_z.reshape(n, ns, 4)
    rec8 = rec8.reshape(n, ns, 4, 8, 8)
    tc_b, t1_b, rest_b = block_len_parts(
        scan4.reshape(n * ns * 4 * 4, 16), 16)
    tc_b = tc_b.reshape(n, ns, 4, 4)
    t1_b = t1_b.reshape(n, ns, 4, 4)
    rest_b = rest_b.reshape(n, ns, 4, 4)

    # ---- per-slot luma cost ------------------------------------------
    keep_q = costq > 4
    total = jnp.where(keep_q, costq, 0).sum(axis=2)       # (N, 2)
    kept = keep_q & (total > 5)[..., None]                # (N, 2, 4)
    luma_ssd = jnp.where(kept, ssd_c, ssd_z).sum(axis=2)  # (N, 2)
    nnz_m = jnp.where(kept[..., None], nnz4, 0)           # (N, 2, 4, 4)
    nnz16 = jnp.zeros((n, ns, 16), jnp.int32)
    nnz16 = nnz16.at[:, :, jnp.asarray(RASTER_OF).reshape(-1)].set(
        nnz_m.reshape(n, ns, 16))
    nc16 = _nc_cat(_luma_nc_inmb(nnz16.reshape(n * ns, 16))) \
        .reshape(n, ns, 16)
    ct = _ct_len(nc16[:, :, jnp.asarray(RASTER_OF).reshape(-1)]
                 .reshape(n, ns, 4, 4), t1_b, tc_b)
    bl = (ct + rest_b).sum(axis=3)                        # (N, 2, 4)
    luma_bits = jnp.where(kept, bl, 0).sum(axis=2)        # (N, 2)
    cbp_l = ((nnz_m.sum(axis=3) > 0).astype(jnp.int32)
             * jnp.asarray([1, 2, 4, 8])[None, None]).sum(axis=2)

    # ---- per-slot chroma trials --------------------------------------
    chroma = [_chroma_trial(cband, mv_sel[:, s], mb_xy, orig_u,
                            orig_v, qpc, sr) for s in range(ns)]

    orig16 = orig_q.astype(jnp.int32).reshape(n, 2, 2, 8, 8) \
        .transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
    blk_quad = jnp.asarray(
        [(b // 8) * 2 + ((b % 4) // 2) for b in range(16)])

    def skip_trial(smv):
        s4 = jnp.broadcast_to(smv[:, None, :], (n, 4, 2))
        p16 = EJ.mc_luma_quads_band(band, s4, mb_xy, sr)
        ssd_l = ((orig16 - p16) ** 2).sum(axis=(1, 2))
        pu, pv = EJ.mc_chroma_quads_band(cband, s4, mb_xy, sr)
        sc = (((orig_u.astype(jnp.int32) - pu) ** 2).sum(axis=(1, 2))
              + ((orig_v.astype(jnp.int32) - pv) ** 2).sum(axis=(1, 2)))
        return s4, p16, pu, pv, (ssd_l + sc).astype(jnp.float32)

    def mvb_of(predq):
        """predq (N, 2, 4, 2): predictor per slot per quad."""
        d = mv_sel - predq
        bits = (se[jnp.clip(jnp.abs(d[..., 0]), 0, 4095)]
                + se[jnp.clip(jnp.abs(d[..., 1]), 0, 4095)])
        return (firstq * bits).sum(axis=2)                # (N, 2)

    def decide(mvb, j_skip):
        js = [j_skip]
        for s in range(ns):
            ch = chroma[s]
            cbp_full = cbp_l[:, s] | (ch["cbp_c"] << 4)
            cbp_bits = _ue_len_arr(cbp_inv[jnp.clip(cbp_full, 0, 47)])
            dqp_bits = (cbp_full != 0).astype(jnp.int32)
            bits = (hdr_bits[:, s] + mvb[:, s] + cbp_bits + dqp_bits
                    + luma_bits[:, s] + ch["bits"])
            js.append((luma_ssd[:, s] + ch["ssd"]).astype(jnp.float32)
                      + lam_f * bits.astype(jnp.float32))
        jstack = jnp.stack(js, axis=1)                    # (N, 3)
        return jnp.argmin(jstack, axis=1).astype(jnp.int32), jstack

    # ---- pass 1: approximate (per-MB) predictor rate ------------------
    skip4, pred16_skip, pu_s, pv_s, ssd_skip = skip_trial(pred)
    win_p1, _ = decide(mvb_of(jnp.broadcast_to(
        pred[:, None, None, :], (n, ns, 4, 2))), ssd_skip + lam_f)
    slot_p1 = jnp.clip(win_p1 - 1, 0, ns - 1)
    mode_p1 = jnp.take_along_axis(cand, slot_p1[:, None], axis=1)[:, 0]
    mv_quad_p1 = jnp.take_along_axis(
        mv_sel, slot_p1[:, None, None, None], axis=1)[:, 0]
    mv_quad_p1 = jnp.where((win_p1 == 0)[:, None, None],
                           skip4, mv_quad_p1)
    mode_p1 = jnp.where(win_p1 == 0, 0, mode_p1)

    # ---- pass 2: exact median predictors from the pass-1 field --------
    from .cavlc_jax import mv_pred_parts, skip_mv_field
    mv4_p1 = mv_quad_p1[:, blk_quad]
    allpred = mv_pred_parts(mv4_p1, mode_p1, mb_w, mb_h,
                            all_modes=True)               # (N, 4m, 4p, 2)
    allpred_s = jnp.take_along_axis(
        allpred, cand[:, :, None, None], axis=1)          # (N, 2, 4p, 2)
    predq = jnp.take_along_axis(allpred_s, partof[..., None], axis=2)
    smv_exact = skip_mv_field(mv4_p1, mb_w, mb_h)
    skip4, pred16_skip, pu_s, pv_s, ssd_skip2 = skip_trial(smv_exact)
    win_i, jstack = decide(mvb_of(predq), ssd_skip2)      # true skip ~0 bits
    is_skip = win_i == 0
    best_slot = jnp.clip(win_i - 1, 0, ns - 1)
    best_m = jnp.take_along_axis(cand, best_slot[:, None], axis=1)[:, 0]

    # ---- gather final fields (winner slot) ----------------------------
    def take_slot(arr):
        """arr (N, 2, ...) -> (N, ...) at the winning slot."""
        idx = best_slot.reshape(n, 1, *([1] * (arr.ndim - 2)))
        return jnp.take_along_axis(arr, idx, axis=1)[:, 0]

    kept_w = take_slot(kept) & ~is_skip[:, None]          # (N, 4)
    scan_q = jnp.where(kept_w[..., None, None], take_slot(scan4), 0)
    nnz_q = jnp.where(kept_w[..., None], take_slot(nnz4), 0)
    rec_q = jnp.where(
        kept_w[..., None, None], take_slot(rec8),
        jnp.clip(take_slot(blk_pred.reshape(n, ns, 4, 8, 8)),
                 0, 255).astype(jnp.uint8))
    skip_rec = pred16_skip.reshape(n, 2, 8, 2, 8) \
        .transpose(0, 1, 3, 2, 4).reshape(n, 4, 8, 8).astype(jnp.uint8)
    rec_q = jnp.where(is_skip[:, None, None, None], skip_rec, rec_q)

    # slot-local trial order is quad order -> RASTER/QUAD maps apply
    qb = jnp.asarray(QUAD_OF_BLK)
    sb = jnp.asarray(SUB_OF_BLK)
    scan16 = scan_q[:, qb, sb]                            # (N, 16, 16)
    nnz16f = nnz_q[:, qb, sb]
    cbp_lw = ((nnz_q.sum(axis=2) > 0).astype(jnp.int32)
              * jnp.asarray([1, 2, 4, 8])[None]).sum(axis=1)
    recY = rec_q.reshape(n, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4) \
        .reshape(n, 16, 16)

    def ch_sel(key, zero_like):
        outs = jnp.stack([chroma[s][key] for s in range(ns)], axis=0)
        v = jnp.take_along_axis(
            outs, best_slot.reshape(1, n, *([1] * (outs.ndim - 2))),
            axis=0)[0]
        zl = jnp.zeros_like(v) if zero_like is None else zero_like
        ex = is_skip.reshape(n, *([1] * (v.ndim - 1)))
        return jnp.where(ex, zl, v)

    dc_f = ch_sel("dc", None)
    ac_f = ch_sel("ac", None)
    cnnz_f = ch_sel("cnnz", None)
    cbp_c_f = ch_sel("cbp_c", None)
    recU_f = ch_sel("recU", jnp.clip(pu_s, 0, 255).astype(jnp.uint8))
    recV_f = ch_sel("recV", jnp.clip(pv_s, 0, 255).astype(jnp.uint8))

    mv_quad = jnp.take_along_axis(
        mv_sel, best_slot[:, None, None, None], axis=1)[:, 0]
    mv_quad = jnp.where(is_skip[:, None, None], skip4, mv_quad)
    inter_mode = jnp.where(is_skip, 0, best_m)

    return dict(inter_mode=inter_mode.astype(jnp.int32),
                mv_quad=mv_quad,
                luma_scan=scan16, luma_nnz=nnz16f,
                cbp=(cbp_c_f << 4) | cbp_lw,
                chroma_dc=dc_f, chroma_scan=ac_f, chroma_nnz=cnnz_f,
                recY_mbs=recY, recU_mbs=recU_f, recV_mbs=recV_f,
                j_win=jnp.min(jstack, axis=1))
