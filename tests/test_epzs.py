"""EPZS fast ME (E15) + HME pyramid (E17): quality parity with full
search, candidate-count reduction, config plumbing, stream validity.

Model: lencod/src/me_epzs.c + me_epzs_common.c (predictors -> adaptive
stop -> pattern refine), me_hme.c:68 (pyramid predictors).
"""

import numpy as np
import pytest

from jm_tpu.config import EncoderParams
from jm_tpu.decoder.decoder import H264Decoder
from jm_tpu.encoder.encoder import Encoder, EncoderConfig

W, H = 176, 144
FRAME = W * H * 3 // 2


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255 ** 2 / mse) if mse else 99.0


@pytest.fixture(scope="module")
def clip(foreman_qcif):
    data = np.fromfile(foreman_qcif, np.uint8)
    base = []
    for i in range(3):
        r = data[i * FRAME:(i + 1) * FRAME]
        base.append((r[:W * H].reshape(H, W),
                     r[W * H:W * H + W * H // 4].reshape(H // 2, W // 2),
                     r[W * H + W * H // 4:].reshape(H // 2, W // 2)))
    # ping-pong to synthesize real motion beyond the 3 shipped frames
    return [base[i] for i in (0, 1, 2, 1, 0, 1)]


def _encode(clip, **kw):
    enc = Encoder(EncoderConfig(qp=28, **kw))
    stream = b""
    for (Y, U, V) in clip:
        stream += enc.encode_frame(Y, U, V)
    return stream + enc.flush()


def test_epzs_quality_parity_and_fewer_evals(clip):
    s_fs = _encode(clip, search_mode=0)
    s_ep = _encode(clip, search_mode=3, hme=True)
    dec_fs = H264Decoder().decode_annexb(s_fs)
    dec_ep = H264Decoder().decode_annexb(s_ep)
    p_fs = np.mean([_psnr(clip[i][0], dec_fs[i].Y) for i in range(len(clip))])
    p_ep = np.mean([_psnr(clip[i][0], dec_ep[i].Y) for i in range(len(clip))])
    # quality bar: within 0.05 dB of full search
    assert p_ep >= p_fs - 0.05
    assert len(s_ep) <= len(s_fs) * 1.05


def test_epzs_candidate_reduction(clip):
    """EPZS must evaluate a small fraction of the (2*sr+1)^2 window."""
    from jm_tpu.encoder import me_epzs as MEP
    cfg = EncoderConfig(qp=28, search_mode=3, search_range=16)
    enc = Encoder(cfg)
    evals = []
    orig_cls = MEP.EPZSearcher.search

    def counting(self, *a, **k):
        r = orig_cls(self, *a, **k)
        evals.append(self.n_evals)
        return r

    MEP.EPZSearcher.search = counting
    try:
        for (Y, U, V) in clip[:3]:
            enc.encode_frame(Y, U, V)
    finally:
        MEP.EPZSearcher.search = orig_cls
    n_mb = (W // 16) * (H // 16)
    full = (2 * 16 + 1) ** 2 * n_mb
    assert evals and evals[-1] < full / 10  # >10x fewer SAD evaluations


def test_epzs_b_frames_decode(clip):
    s = _encode(clip, search_mode=3, num_b=2, entropy="cabac")
    out = sorted(H264Decoder().decode_annexb(s), key=lambda f: f.poc)
    assert len(out) == len(clip)
    p = np.mean([_psnr(clip[i][0], out[i].Y) for i in range(len(clip))])
    assert p > 33.0


def test_epzs_multiref(clip):
    s = _encode(clip, search_mode=3, num_ref=4)
    out = H264Decoder().decode_annexb(s)
    assert len(out) == len(clip)


def test_searchmode_cfg_plumbing(tmp_path):
    cfg = tmp_path / "e.cfg"
    cfg.write_text("SearchMode = 3\nHMEEnable = 1\nEPZSPattern = 2\n"
                   "EPZSTemporal = 1\nEPZSMinThresScale = 0\n")
    p = EncoderParams()
    from jm_tpu.config import parse_cfg_text
    p.apply(parse_cfg_text(cfg.read_text()))
    ec = p.to_encoder_config()
    assert ec.search_mode == 3 and ec.hme
    # EPZS tuning params are accepted (JM names), not errors
    assert "EPZSPattern" in p.ignored


def test_hme_sweep_finds_global_motion():
    """Pure translation: the pyramid must recover the shift."""
    from jm_tpu.encoder.me_epzs import hme_sweep
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 255, (96, 128), np.uint8)
    # orig = ref shifted right 8, down 4  =>  mv points (-8, -4) into ref
    orig = np.roll(np.roll(ref, 4, axis=0), 8, axis=1)
    mv = hme_sweep(orig, ref, 128 // 16, 96 // 16, sr=16)
    inner = mv.reshape(6, 8, 2)[2:-2, 2:-2]
    assert (inner[..., 0] == -8).mean() > 0.8
    assert (inner[..., 1] == -4).mean() > 0.8
