"""Sub-pel interpolation (spec 8.4.2.2): luma quarter-pel via precomputed
half-pel planes + bilinear quarter averaging; chroma eighth-pel bilinear.

Design: like the reference's plane precompute (lencod/src/img_luma.c
getSubImagesLuma:611, getHorSubImageSixTap:151; decoder twin
ldecod/src/mc_prediction.c get_luma_10..33:194-846) but organized as four
whole-frame planes [integer, half-horiz (b), half-vert (h), center (j)]
computed once per stored reference picture. Any quarter-pel sample is then
either a plane sample or the rounded average of two plane samples at unit
offsets — turning per-block MC into pure gathers + one average, ideal for
batched device execution.

Host numpy implementation (bit-exact oracle); jnp twins in interp_jax.
"""

from __future__ import annotations

import numpy as np

PAD = 32  # replicated edge padding, >= max practical MV excursion handled by clamping


def pad_plane(plane: np.ndarray, pad: int = PAD) -> np.ndarray:
    """Edge-replicate pad. Per-tap coordinate clamping in the spec equals
    interpolating a replication-padded plane (for excursions <= pad, which
    MV clamping at MC time guarantees)."""
    return np.pad(plane, pad, mode="edge")


def _conv6_h(x: np.ndarray) -> np.ndarray:
    """6-tap (1,-5,20,20,-5,1) horizontal at half positions; unclipped int32.

    Output[y][i] = filter centered between x[y][i+2] and x[y][i+3] of a
    5-extended input; callers slice accordingly. Shape (H, W-5).
    """
    x = x.astype(np.int32)
    return (x[:, 0:-5] - 5 * x[:, 1:-4] + 20 * x[:, 2:-3]
            + 20 * x[:, 3:-2] - 5 * x[:, 4:-1] + x[:, 5:])


def _conv6_v(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.int32)
    return (x[0:-5, :] - 5 * x[1:-4, :] + 20 * x[2:-3, :]
            + 20 * x[3:-2, :] - 5 * x[4:-1, :] + x[5:, :])


def make_luma_planes(plane: np.ndarray, pad: int = PAD, cmax: int = 255):
    """Returns (INT, B, H, J) planes, each (h+2*pad, w+2*pad); uint8 for
    8-bit samples, uint16 for the >8-bit profiles (cmax = (1<<bd)-1).

    B[y][x] = half-pel between INT[y][x] and INT[y][x+1]
    H[y][x] = half-pel between INT[y][x] and INT[y+1][x]
    J[y][x] = center half-pel (diagonal).
    """
    # work on a plane padded by pad+3 so 6-tap support exists everywhere
    ext = np.pad(plane, pad + 3, mode="edge").astype(np.int32)
    # b1: horizontal 6-tap, aligned so b1[y, x] is between ext[y, x+2], ext[y, x+3]
    b1 = _conv6_h(ext)                       # (H+2p+6, W+2p+1)
    h1 = _conv6_v(ext)                       # (H+2p+1, W+2p+6)
    B = np.clip((b1 + 16) >> 5, 0, cmax)
    H = np.clip((h1 + 16) >> 5, 0, cmax)
    # j: 6-tap vertically over b1 columns (spec: from intermediate values)
    j1 = _conv6_v(b1)                        # (H+2p+1, W+2p+1)
    J = np.clip((j1 + 512) >> 10, 0, cmax)
    p = pad
    dt = np.uint8 if cmax <= 255 else np.uint16
    INT = ext[3 + 0:, 3 + 0:][: plane.shape[0] + 2 * p, : plane.shape[1] + 2 * p]
    Bc = B[3:, 1:][: plane.shape[0] + 2 * p, : plane.shape[1] + 2 * p]
    Hc = H[1:, 3:][: plane.shape[0] + 2 * p, : plane.shape[1] + 2 * p]
    Jc = J[1:, 1:][: plane.shape[0] + 2 * p, : plane.shape[1] + 2 * p]
    return (INT.astype(dt), Bc.astype(dt), Hc.astype(dt), Jc.astype(dt))


# quarter-pel selection table: for (xf, yf) -> (plane1, dx1, dy1, plane2, dx2, dy2)
# plane ids: 0=INT, 1=B, 2=H, 3=J; single-plane positions have plane2 = -1
QPEL_TAB = {
    (0, 0): (0, 0, 0, -1, 0, 0),
    (2, 0): (1, 0, 0, -1, 0, 0),
    (0, 2): (2, 0, 0, -1, 0, 0),
    (2, 2): (3, 0, 0, -1, 0, 0),
    (1, 0): (0, 0, 0, 1, 0, 0),
    (3, 0): (0, 1, 0, 1, 0, 0),
    (0, 1): (0, 0, 0, 2, 0, 0),
    (0, 3): (0, 0, 1, 2, 0, 0),
    (2, 1): (1, 0, 0, 3, 0, 0),
    (2, 3): (1, 0, 1, 3, 0, 0),
    (1, 2): (2, 0, 0, 3, 0, 0),
    (3, 2): (2, 1, 0, 3, 0, 0),
    (1, 1): (1, 0, 0, 2, 0, 0),
    (3, 1): (1, 0, 0, 2, 1, 0),
    (1, 3): (1, 0, 1, 2, 0, 0),
    (3, 3): (1, 0, 1, 2, 1, 0),
}


def mc_luma_block(planes, x4: int, y4: int, bw: int, bh: int,
                  w: int, h: int, pad: int = PAD) -> np.ndarray:
    """Fetch a (bh, bw) luma prediction block at quarter-pel position
    (x4, y4) (top-left corner, quarter-pel units) from the plane set."""
    xi, yi = x4 >> 2, y4 >> 2
    xf, yf = x4 & 3, y4 & 3
    # clamp integer position into padded area (spec edge clamping)
    xi = max(-pad, min(w + pad - bw - 1, xi))
    yi = max(-pad, min(h + pad - bh - 1, yi))
    p1, dx1, dy1, p2, dx2, dy2 = QPEL_TAB[(xf, yf)]
    P = planes
    a = P[p1][pad + yi + dy1: pad + yi + dy1 + bh,
              pad + xi + dx1: pad + xi + dx1 + bw].astype(np.int32)
    if p2 < 0:
        return a
    b = P[p2][pad + yi + dy2: pad + yi + dy2 + bh,
              pad + xi + dx2: pad + xi + dx2 + bw].astype(np.int32)
    return (a + b + 1) >> 1


def mc_chroma_block(plane: np.ndarray, x8: int, y8: int, bw: int, bh: int,
                    w: int, h: int, pad: int = PAD) -> np.ndarray:
    """Chroma eighth-pel bilinear MC (spec 8.4.2.2.2) from a padded plane."""
    xi, yi = x8 >> 3, y8 >> 3
    xf, yf = x8 & 7, y8 & 7
    xi = max(-pad, min(w + pad - bw - 1, xi))
    yi = max(-pad, min(h + pad - bh - 1, yi))
    A = plane[pad + yi: pad + yi + bh + 1, pad + xi: pad + xi + bw + 1].astype(np.int32)
    a = A[:bh, :bw]
    b = A[:bh, 1:bw + 1]
    c = A[1:bh + 1, :bw]
    d = A[1:bh + 1, 1:bw + 1]
    return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b
            + (8 - xf) * yf * c + xf * yf * d + 32) >> 6
