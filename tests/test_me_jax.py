"""Device (jnp) encode step vs numpy reference equivalence."""

import numpy as np
import pytest

from jm_tpu.encoder import me as ME_np
from jm_tpu.ops import interp as ip


def test_sad_search_matches_numpy():
    import jax.numpy as jnp

    from jm_tpu.ops.me_jax import encode_step

    rng = np.random.default_rng(7)
    w, h, sr, pad = 64, 64, 8, 16
    mb_w, mb_h = w // 16, h // 16
    orig = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    # correlated content so the search has structure
    ref[8:, :] = orig[:-8, :]
    ref_pad = np.pad(ref, pad, mode="edge")

    np_mvs = ME_np.full_search_int(orig, ref_pad, mb_w, mb_h, sr, pad)

    n = mb_w * mb_h
    mbs = orig.reshape(mb_h, 16, mb_w, 16).transpose(0, 2, 1, 3).reshape(n, 16, 16)
    xy = np.stack([(np.arange(n) % mb_w) * 16 + pad,
                   (np.arange(n) // mb_w) * 16 + pad], axis=1).astype(np.int32)
    out = encode_step(jnp.asarray(mbs), jnp.asarray(ref_pad),
                      jnp.asarray(xy), sr=sr, qp=28)
    np.testing.assert_array_equal(np.asarray(out["mv"]), np_mvs)

    # recon equals the numpy closed-loop path at the same MVs
    from jm_tpu.encoder import residual_np as RN
    for i in range(n):
        mv = np_mvs[i]
        px, py = (i % mb_w) * 16, (i // mb_w) * 16
        pred = ref_pad[pad + py + mv[1]: pad + py + mv[1] + 16,
                       pad + px + mv[0]: pad + px + mv[0] + 16].astype(np.int64)
        res = mbs[i].astype(np.int64) - pred
        blocks = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
        wv = RN.np_forward4x4(blocks)
        lev = RN.np_quant_4x4(wv, 28, False)
        scan = RN.to_scan(lev)
        pred_b = pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
        rec = RN.recon_luma_4x4(pred_b, scan, 28)
        rec16 = rec.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        np.testing.assert_array_equal(np.asarray(out["recon"][i]), rec16,
                                      err_msg=f"mb {i}")


def test_ssd_full_search_matches_exhaustive():
    """Convolution-formulated SSD sweep (conv cross-term + hi/lo energy split)
    equals the exhaustive integer SSD argmin."""
    import jax.numpy as jnp
    from numpy.lib.stride_tricks import sliding_window_view

    from jm_tpu.ops.me_jax import ssd_full_search
    rng = np.random.default_rng(11)
    sr = 8
    side = 2 * sr + 1
    n = 24
    regions = rng.integers(0, 256, (n, 16 + 2 * sr, 16 + 2 * sr), np.uint8)
    mbs = rng.integers(0, 256, (n, 16, 16), np.uint8)
    mv, best = ssd_full_search(jnp.asarray(mbs), jnp.asarray(regions), sr)
    mv, best = np.asarray(mv), np.asarray(best)
    for i in range(n):
        wins = sliding_window_view(regions[i].astype(np.int64), (16, 16))
        ssds = ((wins - mbs[i].astype(np.int64)) ** 2).sum((2, 3))
        k = int(ssds.argmin())
        dy, dx = divmod(k, side)
        assert (mv[i][0], mv[i][1]) == (dx - sr, dy - sr)
        assert best[i] == ssds.min()


def test_regions_grid_matches_gather():
    import jax.numpy as jnp

    from jm_tpu.ops.me_jax import regions_grid
    rng = np.random.default_rng(5)
    pad, sr = 32, 16
    w, h = 128, 96
    ref = np.pad(rng.integers(0, 256, (h, w), np.uint8), pad, mode="edge")
    g = np.asarray(regions_grid(jnp.asarray(ref), w // 16, h // 16, sr, pad))
    i = 0
    for my in range(h // 16):
        for mx in range(w // 16):
            x, y = mx * 16 + pad - sr, my * 16 + pad - sr
            np.testing.assert_array_equal(g[i], ref[y:y + 48, x:x + 48])
            i += 1


def _extreme_contrast(w, h, seed):
    """0/255 content: random 4x4 tiles of black and white, and a
    reference that is the source moved by (3, -2) with a fifth of its
    tiles inverted, so partition SADs span 0 .. 64*255 per quadrant."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, 2, (h // 4 + 2, w // 4 + 2), np.uint8) * 255
    big = np.kron(tiles, np.ones((4, 4), np.uint8))
    orig = big[4:4 + h, 4:4 + w]
    ref = big[6:6 + h, 1:1 + w].copy()
    flip = np.kron(rng.random((h // 4, w // 4)) < 0.2,
                   np.ones((4, 4), bool))
    ref[flip] = 255 - ref[flip]
    return orig, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_me_int_sweep_extreme_contrast_matches_numpy(seed):
    """The device integer sweep (all 9 partition jobs) equals the numpy
    full search with the same zero-predictor rate term, MVs and costs,
    on content whose SADs reach the top of their range."""
    import jax.numpy as jnp

    from jm_tpu.encoder.encoder import lambda_me
    from jm_tpu.ops.enc_jax import _JOB_QUADS, me_int_sweep
    w, h, sr, lam = 64, 48, 8, lambda_me(28)
    mb_w, mb_h = w // 16, h // 16
    orig, ref = _extreme_contrast(w, h, seed)
    ref_pad = np.pad(ref, ip.PAD, mode="edge")

    q = ME_np.full_search_quadrant_sads(orig, ref_pad, mb_w, mb_h, sr,
                                        ip.PAD)            # (n, d, 4)
    assert q.max() >= 60 * 255
    rate = ME_np.int_rate_tab((0, 0), sr, lam)
    want = [ME_np.best_int_mv(q[:, :, list(qs)].sum(axis=2) + rate, sr)
            for qs in _JOB_QUADS]
    mv, cost = me_int_sweep(jnp.asarray(orig), jnp.asarray(ref_pad),
                            mb_w, mb_h, sr, lam)
    np.testing.assert_array_equal(np.asarray(mv),
                                  np.stack([m for m, _ in want], axis=1))
    np.testing.assert_array_equal(np.asarray(cost),
                                  np.stack([c for _, c in want], axis=1))


def _dot_operand_dtypes(jaxpr):
    """Operand dtypes of every dot_general in a jaxpr, nested bodies
    (scan, cond, pjit) included."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(tuple(v.aval.dtype for v in eqn.invars))
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    found += _dot_operand_dtypes(sub)
    return found


def test_me_int_sweep_has_no_float_dot():
    """Integer ME must not rest on a float matmul: at an accelerator's
    default matmul precision (TF32 or bf16 operands) its SAD costs would
    be rounded and the chosen MVs would depend on the backend."""
    import functools

    import jax

    from jm_tpu.ops.enc_jax import me_int_sweep
    w, h, sr = 64, 48, 8
    orig = np.zeros((h, w), np.uint8)
    ref_pad = np.zeros((h + 2 * ip.PAD, w + 2 * ip.PAD), np.uint8)
    fn = functools.partial(me_int_sweep, mb_w=w // 16, mb_h=h // 16, sr=sr)
    jaxpr = jax.make_jaxpr(lambda o, r, lam: fn(o, r, lam=lam))(
        orig, ref_pad, 92).jaxpr
    dots = _dot_operand_dtypes(jaxpr)
    assert not [d for d in dots
                if any(jax.numpy.issubdtype(t, jax.numpy.floating)
                       for t in d)], dots
