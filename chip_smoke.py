#!/usr/bin/env python3
"""Bring-up smoke run of the production encode/decode path on NVIDIA GPUs.

    python chip_smoke.py                 one GPU: phases 0-5 at 1920x1088
    python chip_smoke.py --four-cards    four GPUs: phase 0, then phase 6

Phases (each an importable function taking its size, frames and devices,
so tests/test_chip_smoke.py runs the same code on the CPU at tiny sizes):

  0  environment: a GPU is required; card name and power limit, JAX
     versions, device kind and count, compile cache, native runtime
  1  encode: Encoder(fast_rd).encode_stream over 1 I + 8 P frames
  2  encoder self-consistency: host decode == encoder reconstruction
  3  device decode (H264Decoder(device_recon=True)) == host decode
  4  cross-backend: the first 3 frames encoded again on the CPU backend
     give the GPU's Annex-B bytes exactly (the codec is integer-exact)
  5  deblock_jax alone at full size, timed
  6  (--four-cards) the MB-row-sharded encode and the dp x sp GOP-parallel
     encode give the one-card bytes, with the GOPs on separate cards

Every check raises on failure, so the process exits non-zero; the last
line of stdout is the JSON result, printed only when every phase passed.
Times printed here are bring-up observations on the named card, not
benchmark results.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time

import numpy as np

from jm_tpu import runtime

W, H = 1920, 1088
QP = 28
N_FRAMES = 9            # 1 I + 8 P
N_CROSS = 3             # frames re-encoded on the CPU backend (phase 4)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_frames(w: int, h: int, n: int, seed: int = 0):
    """Seeded video-like content (bench.py's generator): box-filtered
    noise under a global pan of (2, 3) px per frame, chroma subsampled
    from luma. Returns n (Y, U, V) uint8 tuples."""
    rng = np.random.default_rng(seed)
    hb, wb = h + 3 * n + 8, w + 2 * n + 8
    base = rng.integers(0, 256, (hb, wb)).astype(np.float32)
    k = np.ones(9) / 9
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = np.clip(base * 1.8, 0, 255).astype(np.uint8)
    frames = []
    for i in range(n):
        Y = base[3 * i:3 * i + h, 2 * i:2 * i + w].copy()
        frames.append((Y, Y[::2, ::2].copy(), Y[1::2, ::2].copy()))
    return frames


def fast_rd_config(w: int, h: int, **overrides):
    """The production `fast_rd` preset (the configuration bench.py runs),
    with optional field overrides."""
    from jm_tpu.encoder.encoder import EncoderConfig
    fields = {"qp": QP, "pipeline": "device", "device_rd": True}
    fields.update(overrides)
    return EncoderConfig(width=w, height=h, **fields)


# ---------------------------------------------------------------------------
# phase 0: environment
# ---------------------------------------------------------------------------

def phase_environment(devices) -> None:
    import jax
    import jaxlib

    from jm_tpu import native
    cache = runtime.enable_compile_cache()
    d = devices[0]
    log(f"[0] jax {jax.__version__}  jaxlib {jaxlib.__version__}  "
        f"device_kind={d.device_kind!r}  devices={len(devices)}  "
        f"compile cache={cache}")
    if not native.available:
        raise RuntimeError(f"native runtime unavailable: "
                           f"{native.load_error!r}")
    log("[0] native runtime: loaded")


def result_line(devices) -> str:
    """The contract's last line: the devices as JAX reports them."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


# ---------------------------------------------------------------------------
# phases 1-5: one card
# ---------------------------------------------------------------------------

def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_encode(frames, w: int, h: int, device) -> tuple[list, object, dict]:
    """Encode `frames` (1 I + P...) on `device` through
    Encoder.encode_stream.

    The I frame, the first P frame and the remaining P frames go through
    three encode_stream calls on one encoder (the stream is the same as
    one call's). A second encoder then repeats the first two frames with
    the programs compiled, so first-call minus warm-call time is the
    compile (and cache-load) cost of each program. encode_stream returns
    host bytes, so every interval ends with the device work done.
    Returns (payloads, encoder, stats)."""
    import jax

    from jm_tpu.encoder.encoder import Encoder
    cfg = fast_rd_config(w, h)
    with jax.default_device(device):
        enc = Encoder(cfg)
        p_i, t_i = _timed(lambda: enc.encode_stream(frames[:1]))
        p_p, t_p = _timed(lambda: enc.encode_stream(frames[1:2]))
        p_rest, t_rest = _timed(lambda: enc.encode_stream(frames[2:]))
        payloads = p_i + p_p + p_rest
        warm = Encoder(cfg)
        _, t_i_warm = _timed(lambda: warm.encode_stream(frames[:1]))
        _, t_p_warm = _timed(lambda: warm.encode_stream(frames[1:2]))
    mem = device.memory_stats() or {}
    stats = {
        "i_first_s": t_i, "i_warm_s": t_i_warm,
        "p_first_s": t_p, "p_warm_s": t_p_warm,
        "p_steady_frames": len(frames) - 2,
        "p_steady_fps": (len(frames) - 2) / t_rest if t_rest else None,
        "fallbacks": dict(enc.pipe_fallbacks),
        "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
        "stream_bytes": sum(len(p) for p in payloads),
    }
    if len(payloads) != len(frames):
        raise RuntimeError(f"encode returned {len(payloads)} payloads for "
                           f"{len(frames)} frames")
    return payloads, enc, stats


def check_same_frames(got, want, what: str) -> None:
    """Byte-for-byte equality of two frame lists (objects with Y/U/V)."""
    if len(got) != len(want):
        raise RuntimeError(f"{what}: {len(got)} frames vs {len(want)}")
    for i, (g, r) in enumerate(zip(got, want)):
        for name in ("Y", "U", "V"):
            a = np.asarray(getattr(g, name))
            b = np.asarray(getattr(r, name))
            if a.shape != b.shape or not np.array_equal(a, b):
                bad = (int(np.count_nonzero(a != b)) if a.shape == b.shape
                       else f"shape {a.shape} vs {b.shape}")
                raise RuntimeError(f"{what}: frame {i} plane {name} "
                                   f"differs ({bad} samples)")


def phase_host_decode(payloads, enc) -> list:
    """Decode the stream with the host decoder; it must equal the
    encoder's reconstruction on every plane of every frame."""
    from jm_tpu.decoder.decoder import H264Decoder
    got = H264Decoder().decode_annexb(b"".join(payloads))
    want = [r["frame"] for r in sorted(enc.results, key=lambda r: r["disp"])]
    check_same_frames(got, want, "host decode vs encoder reconstruction")
    return got


def phase_device_decode(payloads, host_frames, n_warm: int = 3) -> dict:
    """Decode with the device P pipe: first a short prefix (compiles the
    decode programs), then the whole stream, which must equal the host
    decode byte for byte."""
    from jm_tpu.decoder.decoder import H264Decoder
    stream = b"".join(payloads)
    _, t_first = _timed(lambda: H264Decoder(device_recon=True)
                        .decode_annexb(b"".join(payloads[:n_warm])))
    got, t_all = _timed(lambda: H264Decoder(device_recon=True)
                        .decode_annexb(stream))
    check_same_frames(got, host_frames, "device decode vs host decode")
    return {"prefix_first_s": t_first, "prefix_frames": n_warm,
            "steady_fps": len(got) / t_all}


def phase_cross_backend(frames, want_payloads, w: int, h: int,
                        device) -> float:
    """Encode `frames` again on `device` (the CPU backend on the card's
    host) in this process; the Annex-B bytes must equal the first
    len(frames) payloads of the reference encode exactly. Returns the
    encode seconds."""
    import jax

    from jm_tpu.encoder.encoder import Encoder
    with jax.default_device(device):
        got, secs = _timed(
            lambda: Encoder(fast_rd_config(w, h)).encode_stream(frames))
    want = want_payloads[:len(frames)]
    if len(got) != len(want):
        raise RuntimeError(f"cross-backend: {len(got)} payloads vs "
                           f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            n = min(len(a), len(b))
            diff = next((k for k in range(n) if a[k] != b[k]), n)
            raise RuntimeError(
                f"cross-backend: frame {i} differs from byte {diff} "
                f"({len(a)} vs {len(b)} bytes)")
    return secs


def phase_deblock(frame, qp: int, device, n_calls: int = 10,
                  seed: int = 0) -> dict:
    """deblock_jax alone on one reconstructed picture with seeded P-like
    boundary strengths (0..2): one warm call, then n_calls timed calls,
    each ended by block_until_ready. Returns per-call seconds."""
    import jax

    from jm_tpu.common.tables import chroma_qp
    from jm_tpu.ops.deblock_jax import deblock_jax
    Y, U, V = (np.asarray(p) for p in (frame.Y, frame.U, frame.V))
    mb_h, mb_w = Y.shape[0] // 16, Y.shape[1] // 16
    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    bs = rng.integers(0, 3, (2, 4 * mb_h, 4 * mb_w)).astype(np.int8)
    qpc = np.array([chroma_qp(q, 0) for q in range(52)], np.int32)
    zeros = np.zeros(n, np.int32)
    args = jax.device_put((Y, U, V, bs[0], bs[1], np.full(n, qp, np.int32),
                           zeros, zeros, zeros, zeros, zeros, qpc, qpc),
                          device)

    def call():
        return jax.block_until_ready(
            deblock_jax(*args, mb_w=mb_w, mb_h=mb_h))

    _, t_first = _timed(call)
    times = [_timed(call)[1] for _ in range(n_calls)]
    return {"first_s": t_first, "median_s": statistics.median(times),
            "min_s": min(times), "calls": n_calls}


# ---------------------------------------------------------------------------
# phase 6: four cards
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def record_placement():
    """Record, for every device encode step called inside the block (the
    I step, the one-device P step and the MB-row-sharded P step), the
    ids of the devices that hold its output. Yields the list of
    (step name, sorted device ids) in call order."""
    import jax

    from jm_tpu.ops import enc_jax as EJ
    from jm_tpu.ops import intra_jax as IJ
    from jm_tpu.parallel import sp_pipeline as SP
    steps = [(IJ, "i_frame_step"), (EJ, "p_frame_step"),
             (SP, "p_frame_step_sharded")]
    saved = [(m, name, getattr(m, name)) for m, name in steps]
    seen = []

    def spy(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            leaf = jax.tree_util.tree_leaves(out)[0]
            seen.append((name, sorted(d.id for d in leaf.devices())))
            return out
        return call

    try:
        for m, name, fn in saved:
            setattr(m, name, spy(name, fn))
        yield seen
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def _encode_frames(cfg, frames) -> bytes:
    from jm_tpu.encoder.encoder import Encoder
    enc = Encoder(cfg)
    return b"".join(enc.encode_frame(*f) for f in frames) + enc.flush()


def phase_sp_sharded(frames, w: int, h: int, devices) -> list:
    """The MB-row-sharded P step over len(devices) cards (md_low, the
    sharded path's condition) must give the one-card bytes. Returns the
    recorded placement of the sharded encode."""
    import jax
    cfg = fast_rd_config(w, h, device_rd=False)
    with jax.default_device(devices[0]):
        want = _encode_frames(cfg, frames)
        with record_placement() as seen:
            got = _encode_frames(
                dataclasses.replace(cfg, sp_shards=len(devices)), frames)
    if got != want:
        raise RuntimeError("sp-sharded bitstream != one-card bitstream")
    ids = sorted(d.id for d in devices)
    sharded = [s for s in seen if s[0] == "p_frame_step_sharded"]
    if len(sharded) != len(frames) - 1 or any(s[1] != ids for s in sharded):
        raise RuntimeError(f"sharded P steps did not span devices {ids}: "
                           f"{seen}")
    return seen


def phase_dp_sp(frames, w: int, h: int, devices, n_dp: int = 2,
                n_sp: int = 2, intra_period: int = 3) -> list:
    """encode_gops_parallel over an (n_dp, n_sp) mesh must give the
    serial one-card bytes, and the GOPs of different mesh rows must run
    on disjoint devices. Returns the device ids used by each GOP."""
    import jax

    from jm_tpu.parallel.gop_pipeline import encode_gops_parallel
    cfg = fast_rd_config(w, h, device_rd=False, intra_period=intra_period,
                         sp_shards=n_sp)
    with jax.default_device(devices[0]):
        want = _encode_frames(dataclasses.replace(cfg, sp_shards=1), frames)
    with record_placement() as seen:
        got, _ = encode_gops_parallel(frames, cfg, n_dp=n_dp, n_sp=n_sp,
                                      devices=devices)
    if got != want:
        raise RuntimeError("dp x sp bitstream != serial bitstream")
    gops = []                     # every GOP opens with its I step
    for name, ids in seen:
        if name == "i_frame_step":
            gops.append(set())
        gops[-1].update(ids)
    n_gops = -(-len(frames) // intra_period)
    if len(gops) != n_gops:
        raise RuntimeError(f"expected {n_gops} GOPs, saw {len(gops)}")
    rows = np.asarray(devices[:n_dp * n_sp]).reshape(n_dp, n_sp)
    for g, used in enumerate(gops):
        row = {d.id for d in rows[g % n_dp]}
        if not used <= row:
            raise RuntimeError(f"GOP {g} ran on {sorted(used)}, outside "
                               f"its mesh row {sorted(row)}")
    if n_dp > 1 and len(gops) > 1 and gops[0] & gops[1]:
        raise RuntimeError(f"GOPs 0 and 1 share devices: {gops}")
    return [sorted(g) for g in gops]


# ---------------------------------------------------------------------------

def run_one_card(devices) -> None:
    import jax
    dev = devices[0]
    frames = make_frames(W, H, N_FRAMES)

    payloads, enc, st = phase_encode(frames, W, H, dev)
    log(f"[1] encode {W}x{H} fast_rd qp{QP}, 1 I + {N_FRAMES - 1} P: "
        f"I first call {st['i_first_s']:.3f} s, warm {st['i_warm_s']:.3f} s;"
        f" P first call {st['p_first_s']:.3f} s, warm "
        f"{st['p_warm_s']:.3f} s")
    log(f"[1] steady P: {st['p_steady_fps']:.3f} frames/s over "
        f"{st['p_steady_frames']} frames (bring-up observation, not a "
        f"benchmark); fallbacks {st['fallbacks']}; peak_bytes_in_use "
        f"{st['peak_bytes_in_use']}; stream {st['stream_bytes']} bytes")

    host = phase_host_decode(payloads, enc)
    log(f"[2] host decode == encoder reconstruction: {len(host)} frames, "
        f"every plane byte-identical")

    dd = phase_device_decode(payloads, host)
    log(f"[3] device decode == host decode: {len(host)} frames; "
        f"{dd['prefix_frames']}-frame first call {dd['prefix_first_s']:.3f}"
        f" s; steady {dd['steady_fps']:.3f} frames/s (whole stream)")

    secs = phase_cross_backend(frames[:N_CROSS], payloads, W, H,
                               jax.devices("cpu")[0])
    log(f"[4] CPU-backend encode of the first {N_CROSS} frames == GPU "
        f"bytes (zero tolerance); CPU encode {secs:.1f} s")

    db = phase_deblock(host[-1], QP, dev)
    log(f"[5] deblock_jax {W}x{H}: median {db['median_s'] * 1e3:.3f} ms, "
        f"min {db['min_s'] * 1e3:.3f} ms over {db['calls']} calls "
        f"(first call {db['first_s']:.3f} s)")


def run_four_cards(devices) -> None:
    frames = make_frames(W, H, 6)
    seen = phase_sp_sharded(frames[:4], W, H, devices)
    log(f"[6] sp_shards={len(devices)} encode (1 I + 3 P) == one-card "
        f"bytes; step placement {seen}")
    gops = phase_dp_sp(frames, W, H, devices)
    log(f"[6] dp=2 x sp=2 GOP-parallel encode (6 frames, IntraPeriod 3) =="
        f" serial one-card bytes; devices per GOP {gops}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)
    n = 4 if args.four_cards else 1
    xla_flags = runtime.parallel_gpu_compile()
    devices = runtime.require_gpus(n, "chip_smoke")
    log(f"[0] card: {runtime.card_info()}")
    phase_environment(devices)
    log(f"[0] XLA_FLAGS={xla_flags}")
    if args.four_cards:
        run_four_cards(devices)
    else:
        run_one_card(devices)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
