"""Device-side CAVLC slice-data packing (spec 9.2 + 7.3.5 write side).

Batched device redesign of the bit-serial CAVLC serializer (reference
lencod/src/vlc.c writeSyntaxElement_NumCoeffTrailingOnes:820,
writeCoeff4x4_CAVLC level loop; lencod/src/macroblock.c
write_p_slice_MB_layer:2298): every syntax element of every macroblock is
computed as a (codeword, bitlength) pair in parallel; variable-length
concatenation happens in three batched stages —

  1. per-block/-header SE slots -> fixed-size word buffers (a static
     fold over <=34 slots, each OR-ed into a 64-bit window);
  2. per-MB "pieces" (1 header + 16 luma + 2 chroma-DC + 8 chroma-AC
     buffers) with exact bit lengths; skip MBs and cbp-gated blocks
     contribute zero-length pieces;
  3. a gather-based stream assembly: global piece bit offsets by
     prefix sum, then every OUTPUT 32-bit word gathers the <=K pieces
     overlapping it (binary search on the offset table) — the
     segmented-prefix-sum bit packer SURVEY §7 planned, with no scatter.

The host receives ~bitstream-sized bytes (the actual coded slice data)
instead of the raw coefficient tensors, prepends the slice header with a
numpy bit shift, and EBSP-escapes. Bit-exact against encoder/syntax.py
MBWriter (tests/test_cavlc_jax.py).

Scope: the device fast path — P slices, all-inter (modes 0-3, 8x8 subs),
single reference, 4:2:0, single slice, fixed QP, CAVLC. The exact bit
LENGTHS (used alone) also power rate-aware mode decisions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..common.predict_ctx import CODE2RASTER
from ..decoder.cavlc import (_CT_COD, _CT_DC_COD, _CT_DC_LEN, _CT_LEN,
                             _RUN_COD, _RUN_LEN, _TZ_COD, _TZ_DC_COD,
                             _TZ_DC_LEN, _TZ_LEN)
from ..decoder.mb_parse import CBP_MAP_CHROMA

# ---------------------------------------------------------------------------
# dense tables
# ---------------------------------------------------------------------------


def _dense(ragged, shape):
    out = np.zeros(shape, np.int32)

    def fill(dst, src):
        if isinstance(src[0], (list, tuple)):
            for i, row in enumerate(src):
                fill(dst[i], row)
        else:
            dst[:len(src)] = src
    fill(out, ragged)
    return out


# coeff_token tables: cat 0..2 = nc<2/<4/<8; 3 = chroma DC 4:2:0 (nc=-1);
# 4 = chroma DC 4:2:2 (nc=-2). nc>=8 handled by formula.
_CT_LEN_D = np.zeros((5, 4, 17), np.int32)
_CT_COD_D = np.zeros((5, 4, 17), np.int32)
_CT_LEN_D[:3] = _dense(_CT_LEN, (3, 4, 17))
_CT_COD_D[:3] = _dense(_CT_COD, (3, 4, 17))
_CT_LEN_D[3:, :, :9] = _dense(_CT_DC_LEN, (2, 4, 9))
_CT_COD_D[3:, :, :9] = _dense(_CT_DC_COD, (2, 4, 9))

_TZ_LEN_D = _dense(_TZ_LEN, (15, 16))
_TZ_COD_D = _dense(_TZ_COD, (15, 16))
_TZ_DC420_LEN_D = _dense(_TZ_DC_LEN[0], (3, 4))
_TZ_DC420_COD_D = _dense(_TZ_DC_COD[0], (3, 4))
_RUN_LEN_D = _dense(_RUN_LEN, (7, 15))
_RUN_COD_D = _dense(_RUN_COD, (7, 15))

# cbp -> inter codeNum (Table 9-4 inverse, chroma present)
_CBP_INTER_INV = np.zeros(48, np.int32)
for _i, (_cbp_intra, _cbp_inter) in enumerate(CBP_MAP_CHROMA):
    _CBP_INTER_INV[int(_cbp_inter)] = _i

_C2R = np.asarray(CODE2RASTER)

BLOCK_SLOTS = 34                      # ct, t1signs, 16 levels, tz, 15 runs
BLOCK_WORDS = 9                       # 288 bits: covers every realistic
                                      # coded block (worst natural ~200
                                      # bits); beyond-288-bit blocks set
                                      # ovf -> host serializer fallback.
                                      # fold_slots is O(S*B*W), so the
                                      # r4 worst-case budget of 21 words
                                      # cost ~2.3x the entropy-pack time
HEADER_WORDS = 9                      # 288 bits > worst-case header
                                      # (8 mvd x 25 + skiprun 27 + ...)
PIECES_PER_MB = 27                    # header + 16 luma + 2 dc + 8 ac


def _u32(x):
    """Force uint32 (mixed uint32/int32 ops promote to int32 under JAX
    numpy promotion, turning >> into an arithmetic shift — fatal for bit
    packing)."""
    return x.astype(jnp.uint32) if hasattr(x, "astype") else jnp.uint32(x)


def _ue_len(v):
    """ue(v) bit length; codeword value is v+1 in that many bits."""
    return 2 * _bitlen(v + 1) - 1


def _bitlen(v):
    """floor(log2(v)) + 1 for v >= 1, vectorized (v < 2^30)."""
    r = jnp.zeros_like(v)
    x = v
    for s in (16, 8, 4, 2, 1):
        hit = x >= (1 << s)
        r = r + jnp.where(hit, s, 0)
        x = jnp.where(hit, x >> s, x)
    return r + 1


def _se_to_ue(v):
    """se(v) -> ue codeNum (spec 9.1.1)."""
    return jnp.where(v > 0, 2 * v - 1, -2 * v)


# ---------------------------------------------------------------------------
# per-block CAVLC slots
# ---------------------------------------------------------------------------

def block_slots(coeffs, nc, max_coeff: int):
    """CAVLC-encode batched residual blocks into SE slots.

    coeffs: (B, L) int32 scan-order (L = max_coeff); nc: (B,) int32
    (>=0 luma/chroma-AC context, -1 chroma DC 4:2:0).
    Returns (vals (B, S) u32, lens (B, S) i32, ovf (B,) bool).

    Slots are POSITION-indexed (one level slot and one run slot per
    scan position, visited high->low frequency) rather than
    rank-indexed: fold_slots only cares about slot ORDER and zero-length
    slots vanish, and the per-rank level/position extraction (16 masked
    selects over (B, L)) this replaces was the hottest op of the
    1080p device entropy pack (see enc_rd.block_len_parts, same walk).
    S = 2 + L (levels) + 1 + (L-1) (runs); 34 for L=16."""
    B, L = coeffs.shape
    assert L == max_coeff
    c = coeffs.astype(jnp.int32)
    mask = c != 0
    tc = mask.sum(axis=1)

    # trailing ones (<= 3): rank-j-from-the-end is a +-1
    rfe = jnp.cumsum(mask[:, ::-1], axis=1)[:, ::-1]     # rank from end
    is1 = (jnp.abs(c) == 1) & mask
    neg = (c < 0) & mask
    o = [((rfe == j + 1) & is1).any(axis=1) for j in range(3)]
    s_j = [((rfe == j + 1) & neg).any(axis=1).astype(jnp.int32)
           for j in range(3)]
    a0 = o[0] & (tc >= 1)
    a1 = a0 & o[1] & (tc >= 2)
    a2 = a1 & o[2] & (tc >= 3)
    t1 = a0.astype(jnp.int32) + a1 + a2

    # highest nonzero position -> total_zeros
    hi = (L - 1) - jnp.argmax(mask[:, ::-1], axis=1).astype(jnp.int32)
    tz = hi + 1 - tc

    vals = []
    lens = []
    ovf = jnp.zeros(B, bool)

    # coeff_token
    cat = jnp.where(nc < -1, 4,
                    jnp.where(nc < 0, 3,
                              jnp.where(nc < 2, 0,
                                        jnp.where(nc < 4, 1, 2))))
    ctl = jnp.asarray(_CT_LEN_D)[cat, t1, tc]
    ctv = jnp.asarray(_CT_COD_D)[cat, t1, tc]
    flc_v = jnp.where(tc == 0, 3, ((tc - 1) << 2) | t1)
    is_flc = nc >= 8
    vals.append(jnp.where(is_flc, flc_v, ctv))
    lens.append(jnp.where(is_flc, 6, ctl))

    # trailing one signs (one combined slot, high frequency first)
    t1v = jnp.zeros(B, jnp.int32)
    for j in range(3):
        t1v = jnp.where(t1 > j, (t1v << 1) | s_j[j], t1v)
    vals.append(t1v)
    lens.append(t1)

    # one descending-position walk: level slot per position (rank >= t1
    # emits), run slot per position (rank >= 1 while zeros remain)
    sl = jnp.where((tc > 10) & (t1 < 3), 1, 0)
    j = jnp.zeros(B, jnp.int32)
    zl = jnp.where(tc > 0, tz, 0)
    prev = hi
    run_vals = []
    run_lens = []
    for p in range(L - 1, -1, -1):
        lv = c[:, p]
        nz = mask[:, p]
        active = nz & (j >= t1)
        lc = jnp.where(lv > 0, 2 * lv - 2, -2 * lv - 1)
        lc = lc - jnp.where((j == t1) & (t1 < 3), 2, 0)
        # suffix_len == 0 branch
        v0 = jnp.where(lc < 14, 1,
                       jnp.where(lc < 30, (1 << 4) | (lc - 14),
                                 (1 << 12) | jnp.clip(lc - 30, 0, 4095)))
        l0 = jnp.where(lc < 14, lc + 1, jnp.where(lc < 30, 19, 28))
        o0 = lc >= 30 + 4096
        # suffix_len > 0 branch
        pre = lc >> jnp.maximum(sl, 1).astype(jnp.int32)
        sfx = lc & ((1 << jnp.maximum(sl, 1)) - 1)
        esc = lc - (15 << jnp.maximum(sl, 1))
        vN = jnp.where(pre < 15, (1 << jnp.maximum(sl, 1)) | sfx,
                       (1 << 12) | jnp.clip(esc, 0, 4095))
        lN = jnp.where(pre < 15, pre + 1 + sl, 28)
        oN = (pre >= 15) & (esc >= 4096)
        v = jnp.where(sl == 0, v0, vN)
        ln = jnp.where(sl == 0, l0, lN)
        ob = jnp.where(sl == 0, o0, oN)
        vals.append(jnp.where(active, v, 0))
        lens.append(jnp.where(active, ln, 0))
        ovf = ovf | (active & ob)
        sl_next = jnp.maximum(sl, 1)
        sl_next = jnp.where((jnp.abs(lv) > (3 << (sl_next - 1)))
                            & (sl_next < 6), sl_next + 1, sl_next)
        sl = jnp.where(active, sl_next, sl)
        # run_before at this position (rank >= 1, zeros remain)
        if p < L - 1:
            run = prev - p - 1
            run_act = nz & (j >= 1) & (zl > 0)
            vlc = jnp.clip(jnp.minimum(zl, 7) - 1, 0, 6)
            runc = jnp.clip(run, 0, 14)
            run_lens.append(jnp.where(
                run_act, jnp.asarray(_RUN_LEN_D)[vlc, runc], 0))
            run_vals.append(jnp.where(
                run_act, jnp.asarray(_RUN_COD_D)[vlc, runc], 0))
            zl = jnp.where(run_act, zl - run, zl)
        prev = jnp.where(nz, p, prev)
        j = j + nz

    # total_zeros (between the level slots and the run slots)
    tzc = jnp.clip(tz, 0, max_coeff - 1)
    vi = jnp.clip(tc - 1, 0, max_coeff - 2)
    if max_coeff == 4:
        tzl = jnp.asarray(_TZ_DC420_LEN_D)[vi, tzc]
        tzv = jnp.asarray(_TZ_DC420_COD_D)[vi, tzc]
    else:
        tzl = jnp.asarray(_TZ_LEN_D)[vi, tzc]
        tzv = jnp.asarray(_TZ_COD_D)[vi, tzc]
    tz_on = (tc > 0) & (tc < max_coeff)
    vals.append(jnp.where(tz_on, tzv, 0))
    lens.append(jnp.where(tz_on, tzl, 0))
    vals.extend(run_vals)
    lens.extend(run_lens)
    return (jnp.stack(vals, axis=1).astype(jnp.uint32),
            jnp.stack(lens, axis=1), ovf)


# ---------------------------------------------------------------------------
# slot fold -> fixed word buffers
# ---------------------------------------------------------------------------

def fold_slots(vals, lens, n_words: int):
    """OR each SE into a (B, n_words) big-endian u32 buffer at its
    running bit position. Returns (words, total_bits)."""
    B, S = vals.shape
    pos = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(lens, axis=1)], axis=1)
    words = jnp.zeros((B, n_words), jnp.uint32)
    widx = jnp.arange(n_words, dtype=jnp.int32)
    zero = jnp.uint32(0)
    for s in range(S):
        v = _u32(vals[:, s])
        ln = lens[:, s]
        p = pos[:, s]
        d = p >> 5
        r = p & 31
        # value occupies bits [r, r+ln) of the 64-bit window at word d
        sh_hi = 32 - r - ln                   # may be negative
        hi = jnp.where(sh_hi >= 0,
                       v << _u32(jnp.clip(sh_hi, 0, 31)),
                       v >> _u32(jnp.clip(-sh_hi, 0, 31)))
        lo_sh = 64 - r - ln
        lo = jnp.where(sh_hi < 0,
                       v << _u32(jnp.clip(lo_sh, 0, 31)), zero)
        hi = jnp.where(ln > 0, hi, zero)
        lo = jnp.where(ln > 0, lo, zero)
        words = words | jnp.where(widx[None, :] == d[:, None],
                                  hi[:, None], zero)
        words = words | jnp.where(widx[None, :] == d[:, None] + 1,
                                  lo[:, None], zero)
    return words, pos[:, -1]


# ---------------------------------------------------------------------------
# exact MV predictor field (spec 8.4.1.3, all-inter single-ref fast path)
# ---------------------------------------------------------------------------

def _gather_blk(mvg, gy, gx, avail):
    """mvg: (4mh, 4mw, 2) padded field; per-lane gather with 0 fill."""
    H, W = mvg.shape[0], mvg.shape[1]
    gyc = jnp.clip(gy, 0, H - 1)
    gxc = jnp.clip(gx, 0, W - 1)
    v = mvg[gyc, gxc]
    return jnp.where(avail[..., None], v, 0)


def _median3(a, b, c):
    return jnp.minimum(jnp.maximum(jnp.minimum(a, b), c),
                       jnp.maximum(a, b))


def mv_pred_parts(mv4, inter_mode, mb_w: int, mb_h: int,
                  all_modes: bool = False):
    """Exact median MV predictors for every partition of every MB under
    the all-inter/ref-0/single-slice fast path.

    mv4: (N, 16, 2) final committed per-4x4 MVs; inter_mode: (N,).
    Returns pred (N, 4, 2): predictor for partition p of the MB's coded
    mode (p indexes PARTS[mode]; unused partitions = 0).
    all_modes=True instead returns (N, 4 modes, 4 parts, 2): the
    predictor each partition of each CANDIDATE mode would see if that
    mode were chosen, given the surrounding committed field (the
    second-pass rate model of ops/enc_rd.py)."""
    n = mb_w * mb_h
    mvg = mv4.reshape(mb_h, mb_w, 4, 4, 2).transpose(0, 2, 1, 3, 4) \
        .reshape(4 * mb_h, 4 * mb_w, 2).astype(jnp.int32)
    mby, mbx = jnp.divmod(jnp.arange(n, dtype=jnp.int32), mb_w)
    mbx = mbx.reshape(mb_h, mb_w)
    mby = mby.reshape(mb_h, mb_w)

    # partition tables: for each mode, list of (bx, by, bw, bh)
    PARTS = {0: [(0, 0, 4, 4)],
             1: [(0, 0, 4, 2), (0, 2, 4, 2)],
             2: [(0, 0, 2, 4), (2, 0, 2, 4)],
             3: [(0, 0, 2, 2), (2, 0, 2, 2), (0, 2, 2, 2), (2, 2, 2, 2)]}

    H, W = 4 * mb_h, 4 * mb_w

    def nbr(bx, by):
        """availability + mv of neighbor 4x4 block at MB-relative block
        coords (bx, by) — valid for the fast path where every earlier
        (decode-order) block is inter ref 0. In-MB neighbors the callers
        ask for are always earlier in coding order; a query that lands in
        the MB to the RIGHT within the current MB's rows (C of a
        right-side partition) is a later MB in raster order and therefore
        unavailable (predict_ctx.mv_neighbor naddr > addr)."""
        gx = mbx * 4 + bx
        gy = mby * 4 + by
        avail = (gx >= 0) & (gy >= 0) & (gx < W) & (gy < H)
        avail = avail & ~((gy >= mby * 4) & (gx >= mbx * 4 + 4))
        return avail, _gather_blk(mvg, gy, gx, avail)

    preds = jnp.zeros((mb_h, mb_w, 4, 2), jnp.int32)
    allp = jnp.zeros((mb_h, mb_w, 4, 4, 2), jnp.int32)
    mode = inter_mode.reshape(mb_h, mb_w)
    for m, parts in PARTS.items():
        sel_m = mode == m
        for pi, (bx, by, bw, bh) in enumerate(parts):
            ha, mva = nbr(bx - 1, by)
            hb, mvb = nbr(bx, by - 1)
            hc, mvc = nbr(bx + bw, by - 1)
            hd, mvd_ = nbr(bx - 1, by - 1)
            # C -> D fallback
            mvc = jnp.where(hc[..., None], mvc, mvd_)
            hce = hc | hd

            cnt = ha.astype(jnp.int32) + hb + hce
            only_a = ha & ~hb & ~hce
            single = (jnp.where(ha[..., None], mva, 0)
                      + jnp.where(hb[..., None], mvb, 0)
                      + jnp.where(hce[..., None], mvc, 0))
            med = _median3(jnp.where(ha[..., None], mva, 0),
                           jnp.where(hb[..., None], mvb, 0),
                           jnp.where(hce[..., None], mvc, 0))
            p = jnp.where(only_a[..., None] | (cnt == 1)[..., None],
                          single, med)
            p = jnp.where(only_a[..., None], mva, p)
            # directional overrides (all refs match when available)
            if (bw, bh) == (4, 2):
                if by == 0:
                    p = jnp.where(hb[..., None], mvb, p)
                else:
                    p = jnp.where(ha[..., None], mva, p)
            elif (bw, bh) == (2, 4):
                if bx == 0:
                    p = jnp.where(ha[..., None], mva, p)
                else:
                    p = jnp.where(hce[..., None], mvc, p)
            preds = jnp.where((sel_m[..., None, None]
                               & (jnp.arange(4) == pi)[None, None, :, None]),
                              p[:, :, None, :], preds)
            if all_modes:
                allp = allp.at[:, :, m, pi].set(p)
    if all_modes:
        return allp.reshape(n, 4, 4, 2)
    return preds.reshape(n, 4, 2)


def skip_mv_field(mv4, mb_w: int, mb_h: int):
    """The exact P_Skip motion vector per MB (spec 8.4.1.1) given the
    committed all-inter/ref-0 field — the (mv == skip_mv) half of
    skip_field, returned as the vector itself. (N, 2) int32."""
    mw, mh = mb_w, mb_h
    mv = mv4.reshape(mh, mw, 16, 2).astype(jnp.int32)
    z2 = jnp.zeros((mh, 1, 2), jnp.int32)
    mva = jnp.concatenate([z2, mv[:, :-1, 3]], axis=1)
    mvb = jnp.concatenate([jnp.zeros((1, mw, 2), jnp.int32),
                           mv[:-1, :, 12]], axis=0)
    mvc = jnp.zeros((mh, mw, 2), jnp.int32)
    if mh > 1 and mw > 1:
        mvc = mvc.at[1:, :-1].set(mv[:-1, 1:, 12])
    mvd_ = jnp.zeros((mh, mw, 2), jnp.int32)
    if mh > 1 and mw > 1:
        mvd_ = mvd_.at[1:, 1:].set(mv[:-1, :-1, 15])
    has_a = np.zeros((mh, mw), bool)
    has_a[:, 1:] = True
    has_b = np.zeros((mh, mw), bool)
    has_b[1:] = True
    has_c = np.zeros((mh, mw), bool)
    has_c[1:, :-1] = True
    has_d = np.zeros((mh, mw), bool)
    has_d[1:, 1:] = True
    has_a = jnp.asarray(has_a)
    has_b = jnp.asarray(has_b)
    has_c = jnp.asarray(has_c)
    has_d = jnp.asarray(has_d)
    mvc = jnp.where(has_c[..., None], mvc, mvd_)
    has_c_eff = has_c | has_d
    cnt = (has_a.astype(jnp.int32) + has_b.astype(jnp.int32)
           + has_c_eff.astype(jnp.int32))
    mva_e = jnp.where(has_a[..., None], mva, 0)
    mvb_e = jnp.where(has_b[..., None], mvb, 0)
    mvc_e = jnp.where(has_c_eff[..., None], mvc, 0)
    single = mva_e + mvb_e + mvc_e
    med = _median3(mva_e, mvb_e, mvc_e)
    pred = jnp.where((cnt == 1)[..., None], single, med)
    a_zero = ~has_a | (mva == 0).all(-1)
    b_zero = ~has_b | (mvb == 0).all(-1)
    return jnp.where((a_zero | b_zero)[..., None], 0, pred) \
        .reshape(mw * mh, 2)


def skip_field(inter_mode, cbp, mv4, mb_w: int, mb_h: int):
    """Device twin of encoder._derive_skip_fast: vectorized P_Skip
    derivation (spec 8.4.1.1) for the all-inter single-slice fast path.
    Returns skip (N,) bool."""
    mw, mh = mb_w, mb_h
    mv = mv4.reshape(mh, mw, 16, 2).astype(jnp.int32)
    z2 = jnp.zeros((mh, 1, 2), jnp.int32)

    mva = jnp.concatenate([z2, mv[:, :-1, 3]], axis=1)
    mvb = jnp.concatenate([jnp.zeros((1, mw, 2), jnp.int32),
                           mv[:-1, :, 12]], axis=0)
    mvc = jnp.zeros((mh, mw, 2), jnp.int32)
    if mh > 1 and mw > 1:
        mvc = mvc.at[1:, :-1].set(mv[:-1, 1:, 12])
    mvd_ = jnp.zeros((mh, mw, 2), jnp.int32)
    if mh > 1 and mw > 1:
        mvd_ = mvd_.at[1:, 1:].set(mv[:-1, :-1, 15])
    has_a = np.zeros((mh, mw), bool)
    has_a[:, 1:] = True
    has_b = np.zeros((mh, mw), bool)
    has_b[1:] = True
    has_c = np.zeros((mh, mw), bool)
    has_c[1:, :-1] = True
    has_d = np.zeros((mh, mw), bool)
    has_d[1:, 1:] = True
    has_a = jnp.asarray(has_a)
    has_b = jnp.asarray(has_b)
    has_c = jnp.asarray(has_c)
    has_d = jnp.asarray(has_d)
    mvc = jnp.where(has_c[..., None], mvc, mvd_)
    has_c_eff = has_c | has_d
    cnt = (has_a.astype(jnp.int32) + has_b.astype(jnp.int32)
           + has_c_eff.astype(jnp.int32))
    mva_e = jnp.where(has_a[..., None], mva, 0)
    mvb_e = jnp.where(has_b[..., None], mvb, 0)
    mvc_e = jnp.where(has_c_eff[..., None], mvc, 0)
    single = mva_e + mvb_e + mvc_e
    med = _median3(mva_e, mvb_e, mvc_e)
    pred = jnp.where((cnt == 1)[..., None], single, med)
    a_zero = ~has_a | (mva == 0).all(-1)
    b_zero = ~has_b | (mvb == 0).all(-1)
    skip_mv = jnp.where((a_zero | b_zero)[..., None], 0, pred)
    cand = ((cbp == 0) & (inter_mode == 0)).reshape(mh, mw)
    eq = (mv[:, :, 0] == skip_mv).all(-1)
    return (cand & eq).reshape(-1)


# ---------------------------------------------------------------------------
# nC context fields
# ---------------------------------------------------------------------------

def nc_luma_field(luma_nnz, mb_w: int, mb_h: int):
    """(N, 16) -> (N, 16) nC per raster 4x4 block (single slice)."""
    g = luma_nnz.reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3) \
        .reshape(4 * mb_h, 4 * mb_w).astype(jnp.int32)
    za = jnp.zeros_like(g[:, :1])
    na = jnp.concatenate([za, g[:, :-1]], axis=1)
    ha = jnp.concatenate([jnp.zeros_like(za, bool),
                          jnp.ones_like(g[:, :-1], bool)], axis=1)
    zb = jnp.zeros_like(g[:1])
    nb = jnp.concatenate([zb, g[:-1]], axis=0)
    hb = jnp.concatenate([jnp.zeros_like(zb, bool),
                          jnp.ones_like(g[:-1], bool)], axis=0)
    nc = jnp.where(ha & hb, (na + nb + 1) >> 1,
                   jnp.where(ha, na, jnp.where(hb, nb, 0)))
    return nc.reshape(mb_h, 4, mb_w, 4).transpose(0, 2, 1, 3) \
        .reshape(mb_h * mb_w, 16)


def nc_chroma_field(chroma_nnz, mb_w: int, mb_h: int):
    """(N, 2, 4) -> (N, 2, 4) nC per chroma 4x4 block (4:2:0)."""
    out = []
    for comp in range(2):
        g = chroma_nnz[:, comp].reshape(mb_h, mb_w, 2, 2) \
            .transpose(0, 2, 1, 3).reshape(2 * mb_h, 2 * mb_w) \
            .astype(jnp.int32)
        za = jnp.zeros_like(g[:, :1])
        na = jnp.concatenate([za, g[:, :-1]], axis=1)
        ha = jnp.concatenate([jnp.zeros_like(za, bool),
                              jnp.ones_like(g[:, :-1], bool)], axis=1)
        zb = jnp.zeros_like(g[:1])
        nb = jnp.concatenate([zb, g[:-1]], axis=0)
        hb = jnp.concatenate([jnp.zeros_like(zb, bool),
                              jnp.ones_like(g[:-1], bool)], axis=0)
        nc = jnp.where(ha & hb, (na + nb + 1) >> 1,
                       jnp.where(ha, na, jnp.where(hb, nb, 0)))
        out.append(nc.reshape(mb_h, 2, mb_w, 2).transpose(0, 2, 1, 3)
                   .reshape(mb_h * mb_w, 4))
    return jnp.stack(out, axis=1)


# ---------------------------------------------------------------------------
# MB header slots
# ---------------------------------------------------------------------------

def header_slots(skip, inter_mode, mv4, pred, cbp):
    """P-slice MB header SEs (skip_run, mb_type, sub types, mvd, cbp,
    dqp=0) for the fast path. Returns (vals (N, 16) u32, lens (N, 16))."""
    n = skip.shape[0]
    coded = ~skip
    idx = jnp.arange(n, dtype=jnp.int32)
    # previous coded MB index via cummax; skip_run = gap size
    prev = lax.cummax(jnp.where(coded, idx, -1), axis=0)
    prev_before = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                                   prev[:-1]])
    skip_run = idx - prev_before - 1

    vals = []
    lens = []
    # skip_run ue
    vals.append(skip_run + 1)
    lens.append(jnp.where(coded, _ue_len(skip_run), 0))
    # mb_type ue(mode)
    mode = inter_mode.astype(jnp.int32)
    vals.append(mode + 1)
    lens.append(jnp.where(coded, _ue_len(mode), 0))
    # sub_mb_type x4 (mode 3 only): ue(0) = '1'
    for q in range(4):
        vals.append(jnp.ones(n, jnp.int32))
        lens.append(jnp.where(coded & (mode == 3), 1, 0))
    # mvds: partition p of PARTS[mode]; first block of each partition
    first_blk = jnp.asarray([[0, 0, 0, 0],      # mode 0: part 0 only
                             [0, 8, 0, 0],      # mode 1: rows 0, 2
                             [0, 2, 0, 0],      # mode 2: cols 0, 2
                             [0, 2, 8, 10]])    # mode 3: quads
    nparts = jnp.asarray([1, 2, 2, 4])
    fb = first_blk[mode]                         # (N, 4)
    npts = nparts[mode]
    for p in range(4):
        blk = fb[:, p]
        mv = jnp.take_along_axis(
            mv4.astype(jnp.int32), blk[:, None, None].repeat(2, 2),
            axis=1)[:, 0]
        mvd = mv - pred[:, p]
        on = coded & (p < npts)
        for ax in range(2):
            k = _se_to_ue(mvd[:, ax])
            vals.append(k + 1)
            lens.append(jnp.where(on, _ue_len(k), 0))
    # cbp
    cbpc = jnp.asarray(_CBP_INTER_INV)[jnp.clip(cbp, 0, 47)]
    vals.append(cbpc + 1)
    lens.append(jnp.where(coded, _ue_len(cbpc), 0))
    # dqp: se(0) = '1' when cbp != 0
    vals.append(jnp.ones(n, jnp.int32))
    lens.append(jnp.where(coded & (cbp != 0), 1, 0))
    return (jnp.stack(vals, axis=1).astype(jnp.uint32),
            jnp.stack(lens, axis=1))


# ---------------------------------------------------------------------------
# stream assembly
# ---------------------------------------------------------------------------

def assemble(piece_words, piece_lens, max_words: int, k_overlap: int = 8):
    """Concatenate variable-length pieces into one bit stream.

    piece_words: (P, W) u32 big-endian buffers; piece_lens: (P,) bits.
    Returns (out (max_words,) u32, total_bits, ovf) — ovf set when some
    output word overlaps more than k_overlap non-empty pieces (caller
    falls back to the host serializer)."""
    P, W = piece_words.shape
    ends = jnp.cumsum(piece_lens)
    starts = ends - piece_lens
    total = ends[-1]

    # compact to non-empty pieces by SCATTER (one pass): slot j holds the
    # j-th non-empty piece's start/end and its original index (instead
    # of an 18-iteration searchsorted binary search over all P pieces).
    nz = piece_lens > 0
    cnz = jnp.cumsum(nz.astype(jnp.int32))
    big = jnp.int32(2 ** 30)
    idx = jnp.arange(P, dtype=jnp.int32)
    tgt = jnp.where(nz, cnz - 1, P)               # P = dropped
    pidx = jnp.zeros(P, jnp.int32).at[tgt].set(idx, mode="drop")
    cs = jnp.full(P, big, jnp.int32).at[tgt].set(
        starts.astype(jnp.int32), mode="drop")
    ce = jnp.full(P, big, jnp.int32).at[tgt].set(
        ends.astype(jnp.int32), mode="drop")

    w = jnp.arange(max_words, dtype=jnp.int32)
    bit0 = w * 32
    # first piece whose end > bit0
    first = jnp.searchsorted(ce, bit0, side="right")
    zero = jnp.uint32(0)
    ones = jnp.uint32(0xFFFFFFFF)
    one = jnp.uint32(1)
    out = jnp.zeros(max_words, jnp.uint32)
    flat = piece_words.reshape(-1)
    for k in range(k_overlap):
        ci = jnp.clip(first + k, 0, P - 1)
        pi = pidx[ci]
        s = cs[ci]
        e = ce[ci]
        # piece bits [s, e) intersect word bits [bit0, bit0+32)
        live = (s < bit0 + 32) & (e > bit0) & (w * 32 < total)
        # local bit offset of output-word start within the piece
        off = bit0 - s                            # may be negative
        l0 = off >> 5
        r = off & 31                              # 0..31
        i0 = jnp.clip(pi * W + jnp.clip(l0, 0, W - 1), 0, P * W - 1)
        i1 = jnp.clip(pi * W + jnp.clip(l0 + 1, 0, W - 1), 0, P * W - 1)
        w0 = jnp.where((l0 >= 0) & (l0 < W), flat[i0], zero)
        w1 = jnp.where((l0 + 1 >= 0) & (l0 + 1 < W), flat[i1], zero)
        # off < 0 (piece starts inside the word) falls out of the same
        # formula: l0 = -1 makes w0 = 0 and w1 = piece word 0, and
        # r = off & 31 = 32 + off, so seg = w1 >> -off.
        seg = jnp.where(r == 0, w0,
                        (w0 << _u32(jnp.clip(r, 0, 31)))
                        | (w1 >> _u32(jnp.clip(32 - r, 1, 31))))
        # mask to the piece's bit range within this word
        startb = jnp.clip(s - bit0, 0, 32)        # first bit in word
        endb = jnp.clip(e - bit0, 0, 32)
        nbits = endb - startb
        msk = jnp.where(
            nbits >= 32, ones,
            ((one << _u32(jnp.clip(nbits, 0, 31))) - one)
            << _u32(jnp.clip(32 - endb, 0, 31)))
        msk = jnp.where(nbits > 0, msk, zero)
        out = out | jnp.where(live, seg & msk, zero)

    # overflow: more than k_overlap pieces end inside some output word
    lastp = jnp.searchsorted(ce, bit0 + 32, side="left")
    ovf = ((lastp - first) > k_overlap - 1).any() \
        | (total > max_words * 32)
    return out, total, ovf


# ---------------------------------------------------------------------------
# the full fast-path P slice packer
# ---------------------------------------------------------------------------

def _pack_p_body(skip, inter_mode, mv4, cbp, luma_scan, luma_nnz,
                 chroma_dc, chroma_scan, chroma_nnz,
                 mb_w: int, mb_h: int, max_words: int):
    n = mb_w * mb_h
    pred = mv_pred_parts(mv4, inter_mode, mb_w, mb_h)
    hv, hl = header_slots(skip, inter_mode, mv4, pred, cbp)
    hw, hbits = fold_slots(hv, hl, HEADER_WORDS)

    ncl = nc_luma_field(luma_nnz, mb_w, mb_h)
    lv, ll, lovf = block_slots(
        luma_scan.reshape(n * 16, 16).astype(jnp.int32),
        ncl.reshape(n * 16), 16)
    lw, lbits = fold_slots(lv, ll, BLOCK_WORDS)

    dv, dl, dovf = block_slots(
        chroma_dc.reshape(n * 2, 4).astype(jnp.int32),
        jnp.full(n * 2, -1, jnp.int32), 4)
    dw, dbits = fold_slots(dv, dl, BLOCK_WORDS)

    ncc = nc_chroma_field(chroma_nnz, mb_w, mb_h)
    av, al, aovf = block_slots(
        chroma_scan.reshape(n * 8, 16)[:, 1:].astype(jnp.int32),
        ncc.reshape(n * 8), 15)
    aw, abits = fold_slots(av, al, BLOCK_WORDS)

    # gates: per MB [header, luma x16 (write order), dc x2, ac x8]
    coded = ~skip
    cbp_l = cbp & 15
    cbp_c = cbp >> 4
    # luma write order: blk8-major, sub-minor -> raster block id
    wo = jnp.asarray([int(_C2R[b8 * 4 + sub])
                      for b8 in range(4) for sub in range(4)])
    luma_gate = coded[:, None] & \
        ((cbp_l[:, None] >> (jnp.arange(16) // 4)) & 1).astype(bool)
    lw_mb = lw.reshape(n, 16, BLOCK_WORDS)[:, wo]
    lb_mb = lbits.reshape(n, 16)[:, wo]
    dc_gate = coded[:, None] & ((cbp_c >= 1)[:, None]
                                & jnp.ones((1, 2), bool))
    ac_gate = coded[:, None] & ((cbp_c >= 2)[:, None]
                                & jnp.ones((1, 8), bool))

    # piece table: per MB [header, luma x16 (write order), dc x2, ac x8].
    # k_overlap=16: real content packs 12+ 1-bit pieces (empty coded
    # blocks) into one output word, which overflowed the r4 bound of 8;
    # pathological content beyond 16 still flags ovf -> host serializer.
    piece_words = jnp.concatenate([
        hw[:, None], lw_mb, dw.reshape(n, 2, BLOCK_WORDS),
        aw.reshape(n, 8, BLOCK_WORDS)], axis=1)     # (N, 27, W)
    piece_lens = jnp.concatenate([
        jnp.where(coded, hbits, 0)[:, None],
        jnp.where(luma_gate, lb_mb, 0),
        jnp.where(dc_gate, dbits.reshape(n, 2), 0),
        jnp.where(ac_gate, abits.reshape(n, 8), 0)], axis=1)

    # trailing skip_run piece (MBWriter.finish)
    idx = jnp.arange(n, dtype=jnp.int32)
    last_coded = jnp.max(jnp.where(coded, idx, -1))
    tail_run = n - 1 - last_coded
    tail_len = jnp.where(tail_run > 0, _ue_len(tail_run), 0)
    tail_val = _u32(tail_run + 1)
    tail_words = jnp.zeros((1, BLOCK_WORDS), jnp.uint32)
    tail_words = tail_words.at[0, 0].set(
        jnp.where(tail_len > 0,
                  tail_val << _u32(jnp.clip(32 - tail_len, 0, 31)),
                  jnp.uint32(0)))
    bits_per_mb = piece_lens.sum(axis=1)
    piece_words = jnp.concatenate(
        [piece_words.reshape(n * PIECES_PER_MB, BLOCK_WORDS),
         tail_words], axis=0)
    piece_lens = jnp.concatenate(
        [piece_lens.reshape(n * PIECES_PER_MB),
         tail_len[None]], axis=0)

    words, nbits, aovf2 = assemble(piece_words, piece_lens, max_words,
                                   k_overlap=16)
    # fold-capacity overflow: any piece longer than its word buffer
    # (BLOCK_WORDS/HEADER_WORDS are sized for realistic content; the
    # host serializer handles the pathological tail)
    cap_ovf = ((lbits > 32 * BLOCK_WORDS).any()
               | (abits > 32 * BLOCK_WORDS).any()
               | (hbits > 32 * HEADER_WORDS).any())
    return {
        "words": words,
        "nbits": nbits,
        "ovf": lovf.any() | dovf.any() | aovf.any() | aovf2 | cap_ovf,
        "bits_per_mb": bits_per_mb,
    }


@functools.partial(jax.jit, static_argnames=("mb_w", "mb_h", "max_words"))
def pack_p_slice(skip, inter_mode, mv4, cbp, luma_scan, luma_nnz,
                 chroma_dc, chroma_scan, chroma_nnz, *,
                 mb_w: int, mb_h: int, max_words: int):
    """Device CAVLC slice_data for the all-inter P fast path.

    Returns dict(words (max_words,) u32, nbits, ovf, bits_per_mb (N,)).
    The caller prepends the slice header bits and EBSP-escapes on host
    (encoder._pipe_finalize)."""
    return _pack_p_body(skip, inter_mode, mv4, cbp, luma_scan, luma_nnz,
                        chroma_dc, chroma_scan, chroma_nnz,
                        mb_w, mb_h, max_words)


@functools.partial(jax.jit, static_argnames=("mb_w", "mb_h", "max_words"))
def pack_p_slice_full(inter_mode, mv4, cbp, luma_scan, luma_nnz,
                      chroma_dc, chroma_scan, chroma_nnz, *,
                      mb_w: int, mb_h: int, max_words: int):
    """pack_p_slice with the P_Skip derivation (skip_field) fused into
    the same device program (one dispatch on the pipelined path); the
    derived skip mask is returned under "skip"."""
    skip = skip_field(inter_mode, cbp, mv4, mb_w, mb_h)
    out = _pack_p_body(skip, inter_mode, mv4, cbp, luma_scan, luma_nnz,
                       chroma_dc, chroma_scan, chroma_nnz,
                       mb_w, mb_h, max_words)
    out["skip"] = skip
    return out
