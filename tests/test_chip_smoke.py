"""chip_smoke.py's phases, run on the CPU at tiny sizes.

The script itself refuses to run without a GPU; these tests import its
phase functions and drive them on host devices (4 of the conftest's 8
virtual CPU devices stand in for the four cards), so the comparison and
placement code the card run relies on is exercised here."""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

W, H = 96, 64


def _load_chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()


@pytest.fixture(scope="module")
def encoded():
    """Phase 1 on the first CPU device: (frames, payloads, encoder, stats)."""
    import jax
    frames = CS.make_frames(W, H, 5, seed=1)
    payloads, enc, stats = CS.phase_encode(frames, W, H,
                                           jax.devices("cpu")[0])
    return frames, payloads, enc, stats


@pytest.fixture(scope="module")
def host_frames(encoded):
    _frames, payloads, enc, _stats = encoded
    return CS.phase_host_decode(payloads, enc)


def test_encode_phase_matches_host_decode(encoded, host_frames):
    frames, payloads, _enc, stats = encoded
    assert len(payloads) == len(host_frames) == len(frames)
    assert stats["p_steady_frames"] == len(frames) - 2
    assert stats["p_steady_fps"] > 0
    assert set(stats["fallbacks"]) == {"intra_speculation",
                                       "entropy_overflow"}
    assert stats["stream_bytes"] == sum(len(p) for p in payloads)


def test_device_decode_phase_matches_host_decode(encoded, host_frames):
    _frames, payloads, _enc, _stats = encoded
    out = CS.phase_device_decode(payloads, host_frames)
    assert out["steady_fps"] > 0


def test_cross_backend_phase_cpu_vs_cpu(encoded):
    import jax
    frames, payloads, _enc, _stats = encoded
    secs = CS.phase_cross_backend(frames[:3], payloads, W, H,
                                  jax.devices("cpu")[0])
    assert secs > 0


def test_cross_backend_phase_reports_a_difference(encoded):
    import jax
    frames, payloads, _enc, _stats = encoded
    tampered = list(payloads)
    p = bytearray(tampered[1])
    p[-1] ^= 1
    tampered[1] = bytes(p)
    with pytest.raises(RuntimeError, match="frame 1 differs"):
        CS.phase_cross_backend(frames[:2], tampered, W, H,
                               jax.devices("cpu")[0])


def test_check_same_frames_names_the_plane(host_frames):
    class F:
        def __init__(self, f, dv):
            self.Y, self.U = f.Y, f.U
            self.V = np.asarray(f.V).copy()
            self.V[0, 0] ^= dv

    same = [F(f, 0) for f in host_frames]
    CS.check_same_frames(same, host_frames, "copy")
    bad = same[:1] + [F(host_frames[1], 1)] + same[2:]
    with pytest.raises(RuntimeError, match="frame 1 plane V"):
        CS.check_same_frames(bad, host_frames, "copy")


def test_deblock_phase_runs(host_frames):
    import jax
    out = CS.phase_deblock(host_frames[-1], CS.QP, jax.devices()[0],
                           n_calls=2)
    assert out["calls"] == 2 and 0 < out["min_s"] <= out["median_s"]


def test_sp_sharded_phase_on_four_devices():
    import jax
    frames = CS.make_frames(W, H, 3, seed=2)
    seen = CS.phase_sp_sharded(frames, W, H, jax.devices()[:4])
    assert [name for name, _ in seen] == ["i_frame_step"] + \
        ["p_frame_step_sharded"] * 2


def test_dp_sp_phase_on_four_devices():
    import jax
    devices = jax.devices()[:4]
    frames = CS.make_frames(W, H, 6, seed=3)
    gops = CS.phase_dp_sp(frames, W, H, devices)
    ids = [d.id for d in devices]
    assert gops == [ids[:2], ids[2:]]


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_exits_nonzero_without_gpu(argv, capsys, monkeypatch):
    # main() appends GPU compile flags; restore XLA_FLAGS afterwards
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    with pytest.raises(SystemExit) as e:
        CS.main(argv)
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_has_the_contract_keys(count):
    import jax
    devices = jax.devices()[:count]
    line = json.loads(CS.result_line(devices))
    assert line == {"ok": True, "device": {
        "platform": "cpu", "kind": devices[0].device_kind,
        "count": count}}
