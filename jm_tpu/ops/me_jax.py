"""Device-side (jnp/XLA) motion estimation and encode compute step.

The device twin of encoder/me.py: full-search SAD over all MBs evaluated as
one batched tensor program (reference loops candidates serially:
lencod/src/me_fullsearch.c). Patch extraction maps the (2*SR+1)^2 candidate
sweep onto dense tensor ops; the residual path reuses the bit-exact integer
transform/quant kernels (ops/transform.py, ops/quant.py).

This is the "flagship forward step" exposed via __graft_entry__:
ME -> MC(int-pel) -> residual -> forward4x4 -> quant -> dequant ->
inverse4x4 -> recon, all int32, jit-compiled once for static shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from . import quant as Q
from . import transform as T


def gather_regions(plane_pad: jnp.ndarray, xy: jnp.ndarray, size: int) -> jnp.ndarray:
    """Gather (size, size) windows at per-MB coords (N, 2) [x, y]."""
    def one(p):
        return lax.dynamic_slice(plane_pad, (p[1], p[0]), (size, size))
    return jax.vmap(one)(xy)


def sad_full_search(orig_mbs: jnp.ndarray, regions: jnp.ndarray,
                    sr: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched 16x16 full-search SAD.

    orig_mbs: (N, 16, 16) uint8/int; regions: (N, 16+2sr, 16+2sr).
    Returns (mvs (N, 2) int32 [dx, dy] integer-pel, best_sad (N,)).
    Argmin tie-break = first flat index in (dy, dx) row-major order,
    matching the numpy reference (encoder/me.py full_search_int).
    """
    side = 2 * sr + 1
    n = orig_mbs.shape[0]
    # patches: (N, 256, side, side) — channel dim = flattened 16x16 patch
    patches = lax.conv_general_dilated_patches(
        regions[:, None].astype(jnp.int16),
        filter_shape=(16, 16), window_strides=(1, 1), padding="VALID")
    o = orig_mbs.reshape(n, 256, 1, 1).astype(jnp.int16)
    sads = jnp.abs(patches - o).astype(jnp.int32).sum(axis=1)   # (N, side, side)
    flat = sads.reshape(n, side * side)
    idx = jnp.argmin(flat, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    mv = jnp.stack([idx % side - sr, idx // side - sr], axis=1)
    return mv, best


def regions_grid(ref_pad: jnp.ndarray, mb_w: int, mb_h: int,
                 sr: int, pad: int) -> jnp.ndarray:
    """All MB search regions as static slices (no gather).

    Requires sr % 16 == 0 and pad >= sr so every region is tile-aligned:
    region(r, c) = the (2*sr/16 + 1)^2 block of 16x16 tiles around MB
    (r, c). Returns (mb_h*mb_w, 16+2sr, 16+2sr).
    """
    assert sr % 16 == 0 and pad >= sr
    t = sr // 16                   # tiles of margin each side
    k = 2 * t + 1                  # tiles per region side
    y0 = pad - sr
    x0 = pad - sr
    h = mb_h * 16 + 2 * sr
    w = mb_w * 16 + 2 * sr
    a = ref_pad[y0:y0 + h, x0:x0 + w]
    tiles = a.reshape(h // 16, 16, w // 16, 16).transpose(0, 2, 1, 3)
    parts = []
    for i in range(k):
        row = []
        for j in range(k):
            row.append(tiles[i:i + mb_h, j:j + mb_w])   # (mb_h, mb_w,16,16)
        parts.append(jnp.stack(row, axis=2))            # (mb_h, mb_w, k,16,16)
    g = jnp.stack(parts, axis=2)                        # (mb_h, mb_w, k, k,16,16)
    g = g.transpose(0, 1, 2, 4, 3, 5).reshape(mb_h, mb_w, k * 16, k * 16)
    return g.reshape(mb_h * mb_w, k * 16, k * 16)


def ssd_full_search(orig_mbs: jnp.ndarray, regions: jnp.ndarray,
                    sr: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched 16x16 full-search with the SSE metric, as convolutions.

    SSD(dy,dx) = sum(r^2) - 2*sum(r*o) + sum(o^2): the cross term is a
    per-example correlation — exactly XLA's filter-gradient convolution
    pattern (batch_group_count = N) — and the window energy term is a
    plain conv with a ones filter, so the whole (2*sr+1)^2 sweep runs as
    two convolutions instead of an abs-diff reduction. All sums
    stay below 2^24 so f32 accumulation is exact; final combine in int32.

    SSE is a reference-supported ME distortion (lencod MEDistortionFPel=2
    semantics aside, me_distortion.c select_distortion SSE path); MV
    choice differs from SAD but the streams remain conforming.
    """
    n = orig_mbs.shape[0]
    side = 2 * sr + 1
    r = regions[:, None].astype(jnp.float32)           # (N, 1, R, R)
    o = orig_mbs[:, None].astype(jnp.float32)          # (N, 1, 16, 16)
    dn = lax.conv_dimension_numbers(r.shape, o.shape,
                                    ("NCHW", "OIHW", "NCHW"))
    # bf16/TF32 single-pass is EXACT here: every operand is an integer
    # <= 255 (8-bit, bf16-representable), products are <= 16 bits (f32-
    # exact), and the f32 accumulator stays below 2^24.
    cross = lax.conv_general_dilated(
        r, o, window_strides=(1, 1), padding="VALID",
        dimension_numbers=dn, batch_group_count=n)     # (1, N, side, side)
    cross = cross[0].astype(jnp.int32)                 # (N, side, side)
    # window energy: r^2 <= 65025 would be rounded by the bf16 operand
    # path, so split into hi/lo bytes (each <= 255, exact) and recombine.
    ones = jnp.ones((1, 1, 16, 16), jnp.float32)
    sq = (regions.astype(jnp.int32) ** 2)[:, None]
    hi = (sq >> 8).astype(jnp.float32)
    lo = (sq & 0xFF).astype(jnp.float32)
    r2 = (lax.conv_general_dilated(
        hi, ones, window_strides=(1, 1), padding="VALID",
        dimension_numbers=dn)[:, 0].astype(jnp.int32) << 8) + \
        lax.conv_general_dilated(
        lo, ones, window_strides=(1, 1), padding="VALID",
        dimension_numbers=dn)[:, 0].astype(jnp.int32)  # (N, side, side)
    o2 = jnp.sum(orig_mbs.astype(jnp.int32) ** 2, axis=(1, 2))
    ssd = r2 - 2 * cross + o2[:, None, None]
    flat = ssd.reshape(n, side * side)
    idx = jnp.argmin(flat, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    mv = jnp.stack([idx % side - sr, idx // side - sr], axis=1)
    return mv, best


def mc_intpel(regions: jnp.ndarray, mvs: jnp.ndarray, sr: int) -> jnp.ndarray:
    """Fetch the 16x16 predictor at the chosen integer MV from each region."""
    def one(region, mv):
        return lax.dynamic_slice(region, (mv[1] + sr, mv[0] + sr), (16, 16))
    return jax.vmap(one)(regions, mvs)


def residual_code(orig_mbs: jnp.ndarray, pred: jnp.ndarray, qp: int,
                  intra: bool) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Transform->quant->dequant->inverse->recon for 16x16 luma residual.

    Returns (levels (N, 16, 4, 4) int32, recon (N, 16, 16) uint8).
    """
    n = orig_mbs.shape[0]
    res = orig_mbs.astype(jnp.int32) - pred.astype(jnp.int32)
    blocks = res.reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 16, 4, 4)
    w = T.forward4x4(blocks)
    qp_v = jnp.full((n, 16), qp, jnp.int32)
    lev = Q.quant_4x4(w, qp_v, intra)
    d = Q.dequant_4x4(lev, qp_v)
    r = T.inverse4x4_round(d)
    pred_b = pred.astype(jnp.int32).reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 16, 4, 4)
    rec = jnp.clip(pred_b + r, 0, 255)
    rec = rec.reshape(n, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
    return lev, rec.astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("sr", "qp", "metric"))
def encode_step(orig_mbs: jnp.ndarray, ref_pad: jnp.ndarray,
                mb_xy: jnp.ndarray, *, sr: int = 16, qp: int = 28,
                metric: str = "sad"):
    """One device encode step over a batch of macroblocks.

    orig_mbs: (N, 16, 16) uint8 — current-frame MBs.
    ref_pad: (H + 2*pad, W + 2*pad) uint8 padded reference plane.
    mb_xy: (N, 2) int32 MB top-left coords in PADDED plane coordinates.
    Returns dict(mv, sad, levels, recon).
    """
    regions = gather_regions(ref_pad, mb_xy - sr, 16 + 2 * sr)
    search = ssd_full_search if metric == "ssd" else sad_full_search
    mv, sad = search(orig_mbs, regions, sr)
    pred = mc_intpel(regions, mv, sr)
    lev, rec = residual_code(orig_mbs, pred, qp, intra=False)
    return {"mv": mv, "sad": sad, "levels": lev, "recon": rec}
