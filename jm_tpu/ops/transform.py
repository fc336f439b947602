"""Bit-exact H.264 integer transforms, batched over leading dims.

All functions take int32 arrays whose trailing two dims are the block
(…, 4, 4) / (…, 2, 2) / (…, 8, 8) and vectorize over any leading batch
shape — the batched replacement for the reference's per-block butterflies
(lcommon/src/transform.c: forward4x4:20, inverse4x4:70, hadamard4x4:121,
hadamard2x2:xx, forward8x8:353, inverse8x8:450). Math follows the spec
(ISO/IEC 14496-10 sections 8.5.10-8.5.12); integer ops only, so results are
identical on every backend.

Convention: "rows" are the last-but-one axis (vertical index j), "cols" the
last axis (horizontal index i), matching the spec's d[j][i].
"""

from __future__ import annotations

import jax.numpy as jnp


def _rows(x):
    """Split last-but-one axis of a 4x4 block into components."""
    return x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]


# ---------------------------------------------------------------------------
# 4x4 core transform
# ---------------------------------------------------------------------------

def _fwd4_1d(d0, d1, d2, d3):
    """One 1-D stage of the forward core transform (factors 1,2,1,1)."""
    p0, p1 = d0 + d3, d1 + d2
    m0, m1 = d0 - d3, d1 - d2
    return p0 + p1, 2 * m0 + m1, p0 - p1, m0 - 2 * m1


def forward4x4(x: jnp.ndarray) -> jnp.ndarray:
    """Forward 4x4 core transform W = Cf X Cf^T (no scaling)."""
    x = x.astype(jnp.int32)
    a0, a1, a2, a3 = _fwd4_1d(*_rows(x))            # vertical pass
    t = jnp.stack([a0, a1, a2, a3], axis=-2)
    b0, b1, b2, b3 = _fwd4_1d(
        t[..., :, 0], t[..., :, 1], t[..., :, 2], t[..., :, 3])  # horizontal
    return jnp.stack([b0, b1, b2, b3], axis=-1)


def _inv4_1d(d0, d1, d2, d3):
    """One 1-D stage of the inverse core transform (spec 8.5.12.2)."""
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def inverse4x4(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse 4x4 core transform WITHOUT the final (r+32)>>6 rounding."""
    x = x.astype(jnp.int32)
    # horizontal pass (over i), then vertical (over j), per spec order
    h0, h1, h2, h3 = _inv4_1d(
        x[..., :, 0], x[..., :, 1], x[..., :, 2], x[..., :, 3])
    t = jnp.stack([h0, h1, h2, h3], axis=-1)
    v0, v1, v2, v3 = _inv4_1d(*_rows(t))
    return jnp.stack([v0, v1, v2, v3], axis=-2)


def inverse4x4_round(x: jnp.ndarray) -> jnp.ndarray:
    """Full inverse transform with normative rounding r = (f + 32) >> 6."""
    return (inverse4x4(x) + 32) >> 6


# ---------------------------------------------------------------------------
# Hadamard transforms (DC coefficient handling)
# ---------------------------------------------------------------------------

def _had4_1d(d0, d1, d2, d3):
    p0, p1 = d0 + d3, d1 + d2
    m0, m1 = d0 - d3, d1 - d2
    return p0 + p1, m0 + m1, p0 - p1, m0 - m1


def hadamard4x4(x: jnp.ndarray) -> jnp.ndarray:
    """4x4 Hadamard (self-inverse up to scale). Used for Intra16x16 luma DC.

    Forward (encoder) applies an additional (y+1)>>1; this is the raw
    butterfly shared by both directions.
    """
    x = x.astype(jnp.int32)
    a = _had4_1d(*_rows(x))
    t = jnp.stack(a, axis=-2)
    b = _had4_1d(t[..., :, 0], t[..., :, 1], t[..., :, 2], t[..., :, 3])
    return jnp.stack(b, axis=-1)


def hadamard2x2(x: jnp.ndarray) -> jnp.ndarray:
    """2x2 Hadamard for chroma DC (4:2:0). Self-inverse up to scale 4."""
    x = x.astype(jnp.int32)
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    r0 = jnp.stack([a + b + c + d, a - b + c - d], axis=-1)
    r1 = jnp.stack([a + b - c - d, a - b - c + d], axis=-1)
    return jnp.stack([r0, r1], axis=-2)


def hadamard2x4(x: jnp.ndarray) -> jnp.ndarray:
    """2x4 chroma-DC transform for 4:2:2 (spec 8.5.11.1): rows Hadamard-2,
    cols Hadamard-4. Input (..., 4, 2): 4 rows x 2 cols."""
    x = x.astype(jnp.int32)
    c0, c1, c2, c3 = _had4_1d(x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :])
    t = jnp.stack([c0, c1, c2, c3], axis=-2)        # (..., 4, 2)
    s, d = t[..., :, 0] + t[..., :, 1], t[..., :, 0] - t[..., :, 1]
    return jnp.stack([s, d], axis=-1)


# ---------------------------------------------------------------------------
# 8x8 transform (FRExt, High profile)
# ---------------------------------------------------------------------------

def _fwd8_1d(d):
    """1-D forward 8x8 stage; d is a tuple of 8 arrays."""
    a0 = d[0] + d[7]
    a1 = d[1] + d[6]
    a2 = d[2] + d[5]
    a3 = d[3] + d[4]
    a4 = d[0] - d[7]
    a5 = d[1] - d[6]
    a6 = d[2] - d[5]
    a7 = d[3] - d[4]
    b0 = a0 + a3
    b1 = a1 + a2
    b2 = a0 - a3
    b3 = a1 - a2
    b4 = a5 + a6 + ((a4 >> 1) + a4)
    b5 = a4 - a7 - ((a6 >> 1) + a6)
    b6 = a4 + a7 - ((a5 >> 1) + a5)
    b7 = a5 - a6 + ((a7 >> 1) + a7)
    return (
        b0 + b1,
        b4 + (b7 >> 2),
        b2 + (b3 >> 1),
        b5 + (b6 >> 2),
        b0 - b1,
        b6 - (b5 >> 2),
        (b2 >> 1) - b3,
        -(b4 >> 2) + b7,
    )


def forward8x8(x: jnp.ndarray) -> jnp.ndarray:
    x = x.astype(jnp.int32)
    v = _fwd8_1d(tuple(x[..., j, :] for j in range(8)))      # vertical
    t = jnp.stack(v, axis=-2)
    h = _fwd8_1d(tuple(t[..., :, i] for i in range(8)))      # horizontal
    return jnp.stack(h, axis=-1)


def _inv8_1d(d):
    """1-D inverse 8x8 stage (spec 8.5.12.3)."""
    a0 = d[0] + d[4]
    a4 = d[0] - d[4]
    a2 = (d[2] >> 1) - d[6]
    a6 = d[2] + (d[6] >> 1)
    b0 = a0 + a6
    b2 = a4 + a2
    b4 = a4 - a2
    b6 = a0 - a6
    a1 = -d[3] + d[5] - d[7] - (d[7] >> 1)
    a3 = d[1] + d[7] - d[3] - (d[3] >> 1)
    a5 = -d[1] + d[7] + d[5] + (d[5] >> 1)
    a7 = d[3] + d[5] + d[1] + (d[1] >> 1)
    b1 = a1 + (a7 >> 2)
    b7 = a7 - (a1 >> 2)
    b3 = a3 + (a5 >> 2)
    b5 = (a3 >> 2) - a5
    return (
        b0 + b7,
        b2 + b5,
        b4 + b3,
        b6 + b1,
        b6 - b1,
        b4 - b3,
        b2 - b5,
        b0 - b7,
    )


def inverse8x8(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse 8x8 WITHOUT the final (r+32)>>6 rounding."""
    x = x.astype(jnp.int32)
    h = _inv8_1d(tuple(x[..., :, i] for i in range(8)))      # horizontal
    t = jnp.stack(h, axis=-1)
    v = _inv8_1d(tuple(t[..., j, :] for j in range(8)))      # vertical
    return jnp.stack(v, axis=-2)


def inverse8x8_round(x: jnp.ndarray) -> jnp.ndarray:
    return (inverse8x8(x) + 32) >> 6
