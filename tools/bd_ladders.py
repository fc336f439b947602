"""Round-5 BD-rate evidence: multi-config ladders vs LIVE JM anchors.

Produces bd_cif.json with three ladders:
  - fast_rd: CIF 30 frames, IPPP CAVLC (the bench.py preset) vs
    encoder_baseline.cfg RDO=0/1ref/SR16
  - best:    CIF 10 frames vs encoder_baseline.cfg verbatim (RDO=1,
    5 refs, SR32)
  - main:    QCIF 9 frames CABAC + 2 B + 2 refs vs encoder_main.cfg
    under matched settings

Run on host CPU:  JAX_PLATFORMS=cpu python tools/bd_ladders.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jm_tpu.tools.bdrate import bd_rate, bd_psnr, psnr_y, read_yuv  # noqa: E402

RUN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".refbuild", "run")
JM = os.path.join(os.path.dirname(RUN), "bin", "lencod.exe")
QPS = [24, 28, 32, 36]


def run_ours(frames, w, h, qp, cfg_kw):
    from jm_tpu.encoder.encoder import Encoder, EncoderConfig
    enc = Encoder(EncoderConfig(width=w, height=h, qp=qp, **cfg_kw))
    bs = b"".join(enc.encode_frame(*f) for f in frames) + enc.flush()
    recs = sorted(enc.results, key=lambda r: r["disp"])
    p = np.mean([psnr_y(f[0], r["frame"].Y) for f, r in zip(frames, recs)])
    return len(bs) * 8, float(p)


def run_jm(yuv, frames, w, h, qp, base_cfg, extra):
    with tempfile.TemporaryDirectory() as td:
        out264 = os.path.join(td, "jm.264")
        rec = os.path.join(td, "jm_rec.yuv")
        cmd = [JM, "-d", base_cfg,
               "-p", f"InputFile={os.path.abspath(yuv)}",
               "-p", f"SourceWidth={w}", "-p", f"SourceHeight={h}",
               "-p", f"FramesToBeEncoded={len(frames)}",
               "-p", f"QPISlice={qp}", "-p", f"QPPSlice={qp}",
               "-p", f"QPBSlice={qp}",
               "-p", f"OutputFile={out264}", "-p", f"ReconFile={rec}",
               ] + extra
        subprocess.run(cmd, cwd=RUN, check=True, stdout=subprocess.DEVNULL)
        bits = os.path.getsize(out264) * 8
        recf = read_yuv(rec, w, h, len(frames))
        p = np.mean([psnr_y(f[0], r[0]) for f, r in zip(frames, recf)])
    return bits, float(p)


LADDERS = {
    "fast_rd_cif30": dict(
        yuv=os.path.join(RUN, "cif30.yuv"), w=352, h=288, n=30,
        ours=dict(num_ref=1, search_range=16, rdo=0, pipeline="device",
                  device_rd=True),
        jm_cfg="encoder_baseline.cfg",
        jm_extra=["-p", "RDOptimization=0", "-p", "NumberReferenceFrames=1",
                  "-p", "SearchRange=16"]),
    "best_cif10": dict(
        yuv=os.path.join(RUN, "cif30.yuv"), w=352, h=288, n=10,
        ours=dict(num_ref=5, search_range=32, rdo=1, sub8x8=True, rdoq=1),
        jm_cfg="encoder_baseline.cfg", jm_extra=[]),
    "main_qcif9": dict(
        yuv=os.path.join(RUN, "qcif10.yuv"), w=176, h=144, n=9,
        ours=dict(num_ref=2, search_range=16, rdo=1, sub8x8=True, rdoq=1,
                  entropy="cabac", num_b=2),
        jm_cfg="encoder_main.cfg",
        jm_extra=["-p", "NumberBFrames=2", "-p", "NumberReferenceFrames=2",
                  "-p", "SearchRange=16"]),
}


def main():
    which = sys.argv[1:] or list(LADDERS)
    out = {}
    if os.path.exists("bd_cif.json"):
        out = json.load(open("bd_cif.json"))
    for name in which:
        cfg = LADDERS[name]
        frames = read_yuv(cfg["yuv"], cfg["w"], cfg["h"], cfg["n"])
        assert len(frames) == cfg["n"], (name, len(frames))
        ours, jm = [], []
        for qp in QPS:
            t0 = time.time()
            ob, op = run_ours(frames, cfg["w"], cfg["h"], qp, cfg["ours"])
            t1 = time.time()
            jb, jp = run_jm(cfg["yuv"], frames, cfg["w"], cfg["h"], qp,
                            cfg["jm_cfg"], cfg["jm_extra"])
            ours.append((ob, op))
            jm.append((jb, jp))
            print(f"{name} QP{qp}: ours {ob:8d} {op:6.3f} dB "
                  f"({t1 - t0:.0f}s) | JM {jb:8d} {jp:6.3f} dB", flush=True)
        bdr = bd_rate([b for b, _ in jm], [p for _, p in jm],
                      [b for b, _ in ours], [p for _, p in ours])
        bdp = bd_psnr([b for b, _ in jm], [p for _, p in jm],
                      [b for b, _ in ours], [p for _, p in ours])
        out[name] = {"qps": QPS, "ours": ours, "jm": jm,
                     "bd_rate_pct": round(bdr, 2),
                     "bd_psnr_db": round(bdp, 3)}
        print(f"== {name}: BD-rate {bdr:+.2f}%  BD-PSNR {bdp:+.3f} dB",
              flush=True)
        with open("bd_cif.json", "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
