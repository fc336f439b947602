"""BD-rate guardrail: encoder quality as a tested number (SURVEY §6
"PSNR >= JM at equal bitrate" target).

The JM anchor points are recorded from real .refbuild lencod runs
(encoder_baseline.cfg, foreman QCIF, 3 frames, QP 24/28/32/36); they are
deterministic for a fixed JM build. Regenerate with:
    python -m jm_tpu.tools.bdrate --preset best

Current state (round 2): best preset = +9.9% BD-rate vs JM. The bound
asserts we never regress past that; tighten it as RDOQ/adaptive-rounding
land (target: <= +5%, then parity).
"""

import numpy as np
import pytest

from jm_tpu.tools.bdrate import bd_rate, read_yuv, run_ours

# (bits, psnr_y) from JM lencod 19.0, foreman QCIF 3 frames, QP 24/28/32/36
# "best": encoder_baseline.cfg verbatim (RDO=1, 5 refs, SR32)
JM_ANCHOR_BEST = [(51432, 39.666), (34232, 37.009), (22432, 34.288),
                  (14832, 31.615)]
# "fast": same cfg with RDOptimization=0, 1 ref, SR16 (the md_low twin)
JM_ANCHOR_FAST = [(53736, 39.541), (35672, 36.938), (22952, 34.169),
                  (14808, 31.506)]
QPS = [24, 28, 32, 36]

# round-3 actuals: best -2.04% (BEATS JM), fast (device pipeline)
# +31.9%; the bounds assert no regression and get tightened as quality
# features land (history: r2 start +9.9% -> RDOQ +6.4% -> r3 integer-ME
# rate term, per-partition predictors, JM coefficient thresholding, true
# sub-block ME +1.57% -> full-RD per-block I4 mode decision -2.04%).
# round 4: fast_rd = the device md_high trial-encode tier (enc_rd.py,
# 2-pass exact-predictor rate) measured +4.90% — the r3 verdict's
# "<= +5% on the benchmarked config" target.
BD_RATE_BOUND_BEST = -1.0
BD_RATE_BOUND_FAST = 33.0
BD_RATE_BOUND_FAST_RD = 6.0


@pytest.mark.parametrize("preset,anchor,bound",
                         [("best", JM_ANCHOR_BEST, BD_RATE_BOUND_BEST),
                          ("fast", JM_ANCHOR_FAST, BD_RATE_BOUND_FAST),
                          ("fast_rd", JM_ANCHOR_FAST,
                           BD_RATE_BOUND_FAST_RD)])
def test_bd_rate_vs_jm(foreman_qcif, preset, anchor, bound):
    frames = read_yuv(foreman_qcif, 176, 144, 3)
    ours = [run_ours(frames, 176, 144, qp, preset) for qp in QPS]
    bdr = bd_rate([b for b, _ in anchor], [p for _, p in anchor],
                  [b for b, _ in ours], [p for _, p in ours])
    assert bdr < bound, f"BD-rate {bdr:+.2f}% exceeds bound {bound}%"


# CIF 30-frame ladder (the round-5 evidence scale, tools/bd_ladders.py):
# JM anchor = encoder_baseline.cfg RDO=0/1ref/SR16 on .refbuild cif30.yuv
# (regenerable via tools/gen_clips.py), recorded from live runs
# 2026-08-21. Over a realistic GOP the device fast_rd preset BEATS the
# matched anchor by a wide margin (-18.46% / +0.85 dB measured with the
# top-2 SATD mode pruning; the QCIF/3f ladder above is dominated by its
# single I frame).
JM_ANCHOR_FAST_CIF30 = [(1685304, 38.659), (815840, 35.948),
                        (441368, 33.225), (249720, 31.114)]
BD_RATE_BOUND_FAST_RD_CIF30 = -12.0


def test_bd_rate_fast_rd_cif30():
    import os
    yuv = os.path.join(os.path.dirname(__file__), "..",
                       ".refbuild", "run", "cif30.yuv")
    if not os.path.exists(yuv):
        pytest.skip("cif30.yuv scratch clip not present")
    frames = read_yuv(yuv, 352, 288, 30)
    assert len(frames) == 30
    ours = [run_ours(frames, 352, 288, qp, "fast_rd") for qp in QPS]
    a = JM_ANCHOR_FAST_CIF30
    bdr = bd_rate([b for b, _ in a], [p for _, p in a],
                  [b for b, _ in ours], [p for _, p in ours])
    assert bdr < BD_RATE_BOUND_FAST_RD_CIF30, \
        f"CIF30 BD-rate {bdr:+.2f}% exceeds {BD_RATE_BOUND_FAST_RD_CIF30}%"
