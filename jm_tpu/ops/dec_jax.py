"""Device (jnp/XLA) decoder reconstruction — the batched inter-recon
phase of the two-phase decode (SURVEY §7 P1, D11-D15; r2/r3 verdict item
"put the decoder on the device").

Reference shape: ldecod/src/macroblock.c decode_one_macroblock:1402 /
mc_prediction.c get_block_luma:902 run per MB in decode order. Device
redesign: inter prediction has NO dependency on the current picture, so
every inter 4x4 block of the whole picture is reconstructed in one
batched program — a single fancy-index gather pulls every block's
5x5 all-plane window from the stacked padded reference pyramids
(arbitrary refs and unbounded conforming MV ranges — no band limits),
a 16-way static select applies the quarter-pel taps (interp.QPEL_TAB),
chroma gets 3x3 windows + 1/8-pel bilinear weights, and the dequantized
residuals (decoder/recon.decode_residuals, already batched) are added
and clipped. Intra/IPCM macroblocks keep the host wavefront (they read
current-picture neighbors); the merged picture then deblocks with the
shared device filter.

Scope: P pictures (list0, pdir 0), 4:2:0 frame decoding, no weighted
prediction, no SP requant — the gate decoder._device_recon_ok. Exactness
is asserted block-for-block against the host Reconstructor on the JM
golden streams (tests/test_dec_jax.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..common.tables import ZIGZAG_4x4
from . import quant as Q
from . import transform as T
from .interp import PAD, QPEL_TAB

_ZZ = np.asarray(ZIGZAG_4x4, np.int32)


@functools.partial(jax.jit, static_argnames=("mb_w", "mb_h"))
def p_dec_residuals(luma_coef, chroma_dc, chroma_coef, qp,
                    tabY, tabU, tabV, qpc_cb, qpc_cr, *,
                    mb_w: int, mb_h: int):
    """Device residual decode for all-inter 4x4-transform 4:2:0 frame P
    pictures — the dec twin of decoder/recon.decode_residuals (inverse
    zigzag -> dequant (ldecod block.c itrans4x4 scaling) -> rounded
    inverse transform; chroma 2x2 DC Hadamard, spec 8.5.11).

    luma_coef (N,16,16) int scan order; chroma_dc (N,2,4);
    chroma_coef (N,2,4,16); qp (N,); tabY/tabU/tabV (52,4,4) int32
    InvLevelScale tables (inter lists 3/4/5 of recon.build_inv_scale);
    qpc_cb/qpc_cr (52,) QP->QPc maps with the pps offsets applied.
    Returns (res_l (N,16,4,4) i32, res_c (N,2,4,4,4) i32)."""
    n = mb_w * mb_h
    zz = jnp.asarray(_ZZ)
    qp = qp.astype(jnp.int32)

    raster = jnp.zeros((n, 16, 16), jnp.int32) \
        .at[:, :, zz].set(luma_coef.astype(jnp.int32)) \
        .reshape(n, 16, 4, 4)
    deq = Q.dequant_4x4(raster, qp[:, None], tabY)
    res_l = T.inverse4x4_round(deq).astype(jnp.int32)

    qpu = qpc_cb[jnp.clip(qp, 0, 51)]
    qpv = qpc_cr[jnp.clip(qp, 0, 51)]
    craster = jnp.zeros((n, 2, 4, 16), jnp.int32) \
        .at[:, :, :, zz].set(chroma_coef.astype(jnp.int32)) \
        .reshape(n, 2, 4, 4, 4)
    dequ = Q.dequant_4x4(craster[:, 0], qpu[:, None], tabU)
    deqv = Q.dequant_4x4(craster[:, 1], qpv[:, None], tabV)

    # chroma DC: 2x2 Hadamard then scale (floor >>5)
    dc = chroma_dc.astype(jnp.int32).reshape(n, 2, 2, 2)
    a, b = dc[..., 0, 0], dc[..., 0, 1]
    c, d = dc[..., 1, 0], dc[..., 1, 1]
    f = jnp.stack([
        jnp.stack([a + b + c + d, a - b + c - d], axis=-1),
        jnp.stack([a + b - c - d, a - b - c + d], axis=-1)], axis=-2)
    dcu = Q.dequant_chroma_dc(f[:, 0], qpu, tabU)      # (N, 2, 2)
    dcv = Q.dequant_chroma_dc(f[:, 1], qpv, tabV)
    blk = jnp.arange(4)
    dequ = dequ.at[:, blk, 0, 0].set(dcu[:, blk // 2, blk % 2])
    deqv = deqv.at[:, blk, 0, 0].set(dcv[:, blk // 2, blk % 2])
    res_c = jnp.stack([T.inverse4x4_round(dequ),
                       T.inverse4x4_round(deqv)], axis=1).astype(jnp.int32)
    return res_l, res_c


@functools.partial(jax.jit, static_argnames=("mb_w", "mb_h"))
def inter_recon_p(mv, ref_idx, res_l, res_c, planes_stack, padU_stack,
                  padV_stack, inter_mask, *, mb_w: int, mb_h: int):
    """Batched inter reconstruction of every inter-coded block.

    mv (N, 16, 2) i32; ref_idx (N, 4) i8 (list0, >=0 for inter quads);
    res_l (N, 16, 4, 4) i32; res_c (N, 2, 4, 4, 4) i32 (comp, blk);
    planes_stack (R, 4, Hp, Wp) u8 (per-ref interp.luma planes);
    padU/padV_stack (R, Hcp, Wcp) u8; inter_mask (N,) bool.

    Returns (Y, U, V) uint8 full planes with non-inter MBs zeroed."""
    n = mb_w * mb_h
    w, h = 16 * mb_w, 16 * mb_h
    R = planes_stack.shape[0]
    blk = jnp.arange(16, dtype=jnp.int32)
    bx = blk % 4
    by = blk // 4
    quad = (by // 2) * 2 + bx // 2
    mbi = jnp.arange(n, dtype=jnp.int32)
    px = (mbi % mb_w)[:, None] * 16 + bx[None] * 4       # (N, 16)
    py = (mbi // mb_w)[:, None] * 16 + by[None] * 4
    ref_b = jnp.clip(ref_idx.astype(jnp.int32)[:, quad], 0, R - 1)

    mvx = mv[..., 0].astype(jnp.int32)
    mvy = mv[..., 1].astype(jnp.int32)
    x4 = px * 4 + mvx
    y4 = py * 4 + mvy
    xi = jnp.clip(x4 >> 2, -PAD, w + PAD - 5)
    yi = jnp.clip(y4 >> 2, -PAD, h + PAD - 5)
    xf = x4 & 3
    yf = y4 & 3

    # one gather: (N, 16, 4 planes, 5, 5) all-plane windows
    ii = jnp.arange(5, dtype=jnp.int32)
    rows = (yi + PAD)[..., None, None, None] + ii[None, None, None, :, None]
    cols = (xi + PAD)[..., None, None, None] + ii[None, None, None, None, :]
    pidx = jnp.arange(4, dtype=jnp.int32)[None, None, :, None, None]
    win = planes_stack[ref_b[..., None, None, None], pidx, rows, cols] \
        .astype(jnp.int32)                               # (N,16,4,5,5)

    pred = jnp.zeros((n, 16, 4, 4), jnp.int32)
    for fy in range(4):
        for fx in range(4):
            p1, dx1, dy1, p2, dx2, dy2 = QPEL_TAB[(fx, fy)]
            a = win[:, :, p1, dy1:dy1 + 4, dx1:dx1 + 4]
            b = a if p2 < 0 else \
                (a + win[:, :, p2, dy2:dy2 + 4, dx2:dx2 + 4] + 1) >> 1
            sel = ((xf == fx) & (yf == fy))[..., None, None]
            pred = jnp.where(sel, b, pred)

    recb = jnp.clip(pred + res_l, 0, 255).astype(jnp.uint8)
    recb = jnp.where(inter_mask[:, None, None, None], recb, 0)
    Y = recb.reshape(mb_h, mb_w, 4, 4, 4, 4) \
        .transpose(0, 2, 4, 1, 3, 5).reshape(h, w)

    # ---- chroma (4:2:0): 2x2 blocks per luma 4x4 block ---------------
    cw, ch = w // 2, h // 2
    cx8 = (px // 2) * 8 + mvx                            # eighth-pel
    cy8 = (py // 2) * 8 + mvy
    cxi = jnp.clip(cx8 >> 3, -PAD, cw + PAD - 3)
    cyi = jnp.clip(cy8 >> 3, -PAD, ch + PAD - 3)
    cxf = cx8 & 7
    cyf = cy8 & 7
    jj = jnp.arange(3, dtype=jnp.int32)
    crows = (cyi + PAD)[..., None, None] + jj[None, None, :, None]
    ccols = (cxi + PAD)[..., None, None] + jj[None, None, None, :]
    uvs = jnp.stack([padU_stack, padV_stack], axis=1)     # (R, 2, ...)
    cwin = uvs[ref_b[..., None, None, None],
               jnp.arange(2)[None, None, :, None, None],
               crows[:, :, None], ccols[:, :, None]] \
        .astype(jnp.int32)                                # (N,16,2,3,3)
    a = cwin[..., :2, :2]
    b = cwin[..., :2, 1:]
    c = cwin[..., 1:, :2]
    d = cwin[..., 1:, 1:]
    wx = cxf[..., None, None, None]
    wy = cyf[..., None, None, None]
    cpred = ((8 - wx) * (8 - wy) * a + wx * (8 - wy) * b
             + (8 - wx) * wy * c + wx * wy * d + 32) >> 6  # (N,16,2,2,2)

    # map luma-block-granular 2x2 chroma preds onto the chroma 4x4-block
    # residual layout: chroma 4x4 block cb covers luma blocks
    # (2*(cb//2)+dy, 2*(cb%2)+dx) sub-2x2s
    res_cc = res_c                                        # (N,2,4,4,4)
    rec_c = []
    for comp in range(2):
        comp_pred = jnp.zeros((n, 4, 4, 4), jnp.int32)
        for cb in range(4):
            qy, qx = cb // 2, cb % 2
            quadrant = jnp.zeros((n, 4, 4), jnp.int32)
            for dy in range(2):
                for dx in range(2):
                    lb = (2 * qy + dy) * 4 + (2 * qx + dx)
                    quadrant = quadrant.at[:, 2 * dy:2 * dy + 2,
                                           2 * dx:2 * dx + 2].set(
                        cpred[:, lb, comp])
            comp_pred = comp_pred.at[:, cb].set(quadrant)
        rc = jnp.clip(comp_pred + res_cc[:, comp], 0, 255) \
            .astype(jnp.uint8)
        rc = jnp.where(inter_mask[:, None, None, None], rc, 0)
        rec_c.append(rc.reshape(mb_h, mb_w, 2, 2, 4, 4)
                     .transpose(0, 2, 4, 1, 3, 5).reshape(ch, cw))
    return Y, rec_c[0], rec_c[1]
