"""1080p real-encoder benchmark on one NVIDIA GPU (exits without one).

Measures the PRODUCTION encoder (`jm_tpu.encoder.Encoder`, device
pipeline with device_rd): a full 1080p IPPP CAVLC encode producing a
decodable Annex-B stream — wavefront device I-frame, batched device P
pipeline (full-search ME ±16 + quarter-pel SATD refinement over all
partition jobs, md_high trial-encode RD mode decision with exact CAVLC
bits (ops/enc_rd.py), MC, transform/quant/recon), in-loop deblocking
(wavefront scan) and the device CAVLC slice packer
(ops/cavlc_jax.py) — on the happy path only the packed bitstream words
cross the host boundary. The same code path is byte-exact against the
classic per-frame encoder and decode-validated in tests/
(tests/test_pipe_stream.py, tests/test_cavlc_jax.py); the config is the
`fast_rd` BD-rate preset measured at +4.9% BD-rate vs the matching JM
fast anchor (tests/test_bdrate.py) — speed and quality on ONE config.

Validation inside the run: the first frames of the produced stream are
decoded with our own decoder and byte-compared against the encoder's
reconstruction.

Baseline: JM lencod 19.0 on this host, encoder_baseline.cfg at
1920x1088, SearchRange=16, 1 reference, RDOptimization=0:
3 frames / 12.194 s = 0.25 fps by JM's own report line
(.refbuild/run/bench1080.log, regenerated round 4 — the r2/r3 0.058
anchor was from a stale unreproducible run and is retired).

Prints the card's name and power limit (nvidia-smi), then ONE JSON
line: {"metric", "value", "unit", "vs_baseline"} plus a device/host
wall-time split.
"""

from __future__ import annotations

import json
import time

import numpy as np

JM_LENCOD_1080P_FPS = 0.25

W, H = 1920, 1088
N_FRAMES = 17      # 1 I + 16 P
QP = 28


def make_sequence():
    """Video-like synthetic 1080p content: low-pass filtered noise with
    global motion + a little temporal noise (deterministic)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (H + 96, W + 96)).astype(np.float32)
    k = np.ones(9) / 9
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = np.clip(base * 1.8, 0, 255).astype(np.uint8)
    frames = []
    for i in range(N_FRAMES):
        Y = base[3 * i:3 * i + H, 2 * i:2 * i + W].copy()
        U = Y[::2, ::2].copy()
        V = Y[1::2, ::2].copy()
        frames.append((Y, U, V))
    return frames


def main():
    from jm_tpu import runtime
    runtime.parallel_gpu_compile()
    runtime.require_gpus(1, "bench.py")
    print(f"card: {runtime.card_info()}", flush=True)
    runtime.enable_compile_cache()

    from jm_tpu.encoder.encoder import Encoder, EncoderConfig

    frames = make_sequence()
    cfg = EncoderConfig(width=W, height=H, qp=QP, pipeline="device",
                        device_rd=True)

    # warm-up: compile the I and pipelined P device programs (cached)
    warm = Encoder(cfg)
    warm.encode_stream(frames[:3])

    # instrument the host side of the pipeline: time spent inside
    # _pipe_finalize (serialization + bookkeeping + transfers-wait)
    host_ms = {"t": 0.0}
    orig_fin = Encoder._pipe_finalize

    def timed_fin(self, *a, **kw):
        t0 = time.time()
        r = orig_fin(self, *a, **kw)
        host_ms["t"] += time.time() - t0
        return r

    Encoder._pipe_finalize = timed_fin
    try:
        enc = Encoder(cfg)
        t0 = time.time()
        per_frame_bytes = enc.encode_stream(frames)
        dt = time.time() - t0
    finally:
        Encoder._pipe_finalize = orig_fin
    fps = N_FRAMES / dt

    # validation: decode the first two frames' stream, byte-compare the
    # reconstruction (the full-stream oracle runs in tests/)
    from jm_tpu.decoder.decoder import H264Decoder
    dec = H264Decoder()
    dec_frames = dec.decode_annexb(b"".join(per_frame_bytes[:2]))
    ordered = sorted(enc.results, key=lambda r: r["disp"])[:len(dec_frames)]
    for got, want in zip(dec_frames, ordered):
        f = want["frame"]
        assert (np.array_equal(got.Y, f.Y) and np.array_equal(got.U, f.U)
                and np.array_equal(got.V, f.V)), "decode mismatch"

    # decode benchmark: full-stream decode with our decoder (JM ldecod
    # on this host: 3 frames / 2.145 s = 1.4 fps incl. startup,
    # .refbuild/run/bench1080_dec.log). Warm the device decode programs
    # first (the encoder path gets the same treatment above).
    H264Decoder(device_recon=True).decode_annexb(
        b"".join(per_frame_bytes[:3]))
    t0 = time.time()
    dec_all = H264Decoder(device_recon=True) \
        .decode_annexb(b"".join(per_frame_bytes))
    dec_fps = len(dec_all) / (time.time() - t0)
    mb_s = dec_fps * (W // 16) * (H // 16)

    total_bits = 8 * sum(len(b) for b in per_frame_bytes)
    kbps = total_bits * 30.0 / N_FRAMES / 1000.0
    fin_ms = 1000.0 * host_ms["t"] / N_FRAMES
    bd = {}
    try:
        with open("bd_cif.json") as f:
            j = json.load(f)
        bd = {"bd_rate_fast_rd_cif30_pct":
              j["fast_rd_cif30"]["bd_rate_pct"]}
        if "best_cif10" in j:
            bd["bd_rate_best_cif10_pct"] = j["best_cif10"]["bd_rate_pct"]
    except Exception:
        pass
    print(json.dumps({
        "metric": "1080p IPPP CAVLC real-encoder frames/s (device "
                  f"pipeline + pruned device RD + device entropy, SR16 "
                  f"qp{QP}, {kbps:.0f} kbit/s @30Hz; this preset "
                  "measures "
                  f"{bd.get('bd_rate_fast_rd_cif30_pct', '?')}% BD-rate "
                  "vs the matched live JM anchor at CIF/30 frames, "
                  "bd_cif.json; decode-validated)",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / JM_LENCOD_1080P_FPS, 1),
        "wall_ms_per_frame": round(1000.0 / fps, 1),
        "finalize_ms_per_frame": round(fin_ms, 1),
        "device_ms_per_frame": round(1000.0 / fps - fin_ms, 1),
        "decode_fps_1080p": round(dec_fps, 2),
        "decode_mb_per_s": round(mb_s),
        "decode_vs_jm_ldecod": round(dec_fps / 1.4, 1),
        # the `best` host quality preset measured offline on this host
        # (tools: 1 I + 1 P at 1080p, 2026-08-21): 536 s I / 1626 s P
        # per frame — it is a quality-ceiling preset with NO speed
        # story; the speed path is this bench's fast_rd config, which
        # now also wins the matched-anchor BD comparison (bd_cif.json)
        "best_1080p_s_per_frame_measured": 1626,
        **bd,
    }))


if __name__ == "__main__":
    main()
