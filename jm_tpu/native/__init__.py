"""Native (C++) runtime layer: loads jm_native, building it on first use.

Exposes `available`, and when available: `BitReader`, `CabacEngine`,
`ebsp_to_rbsp`, `rbsp_to_ebsp`, plus the encoder runtime
`cavlc_slice_data` (CAVLC MB-layer serializer) and `deblock_frame`
(in-loop filter edge loops). All normative tables (CABAC state machine,
CAVLC code tables) are installed from the Python tables so both
implementations share one source of truth. When the library can be
neither loaded nor built, `available` is False and `load_error` holds the
exception that stopped it (callers then take the Python paths).
"""

from __future__ import annotations

available = False
load_error: Exception | None = None
BitReader = None
CabacEngine = None
ebsp_to_rbsp = None
rbsp_to_ebsp = None
cavlc_slice_data = None
deblock_frame = None
parse_slice_cavlc = None


def _pad2(rows, width, dtype):
    import numpy as np
    out = np.zeros((len(rows), width), dtype)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _install_cavlc_tables(jm_native):
    import numpy as np

    from ..decoder import cavlc as C
    from ..decoder.mb_parse import CBP_MAP_CHROMA
    cbp_inv = np.zeros((2, 48), np.uint8)
    for i, (ci, cp) in enumerate(CBP_MAP_CHROMA):
        cbp_inv[0, int(ci)] = i
        cbp_inv[1, int(cp)] = i
    tz_len = _pad2(C._TZ_LEN, 16, np.uint8)
    tz_cod = _pad2(C._TZ_COD, 16, np.uint16)
    jm_native.set_cavlc_tables({
        "ct_len": np.ascontiguousarray(C._CT_LEN, np.uint8),
        "ct_cod": np.ascontiguousarray(C._CT_COD, np.uint16),
        "ctdc_len": np.ascontiguousarray(C._CT_DC_LEN, np.uint8),
        "ctdc_cod": np.ascontiguousarray(C._CT_DC_COD, np.uint16),
        "tz_len": tz_len, "tz_cod": tz_cod,
        "tzdc0_len": _pad2(C._TZ_DC_LEN[0], 4, np.uint8),
        "tzdc0_cod": _pad2(C._TZ_DC_COD[0], 4, np.uint16),
        "tzdc1_len": _pad2(C._TZ_DC_LEN[1], 8, np.uint8),
        "tzdc1_cod": _pad2(C._TZ_DC_COD[1], 8, np.uint16),
        "run_len": _pad2(C._RUN_LEN, 15, np.uint8),
        "run_cod": _pad2(C._RUN_COD, 15, np.uint16),
        "cbp_inv_chroma": cbp_inv,
    })


def _load():
    global available, BitReader, CabacEngine, ebsp_to_rbsp, rbsp_to_ebsp
    global cavlc_slice_data, deblock_frame, parse_slice_cavlc, load_error
    try:
        try:
            from . import jm_native  # type: ignore
        except ImportError:
            import importlib
            import pathlib
            import sys
            sys.path.insert(0, str(pathlib.Path(__file__).resolve()
                                   .parents[2] / "native"))
            try:
                import build as _b  # native/build.py
                _b.build()
            finally:
                sys.path.pop(0)
            importlib.invalidate_caches()
            from . import jm_native  # type: ignore
        import numpy as np

        from ..decoder import cabac_tables as CT
        jm_native.set_cabac_tables(
            np.ascontiguousarray(CT.RANGE_LPS, np.uint8),
            np.ascontiguousarray(CT.NEXT_STATE_MPS, np.uint8),
            np.ascontiguousarray(CT.NEXT_STATE_LPS, np.uint8))
        BitReader = jm_native.BitReader
        CabacEngine = jm_native.CabacEngine
        ebsp_to_rbsp = jm_native.ebsp_to_rbsp
        rbsp_to_ebsp = jm_native.rbsp_to_ebsp

        # the CAVLC tables live in jm_tpu.decoder.cavlc, whose import
        # chain circles back here — install them lazily on first use
        _state = {"installed": False}

        def _cavlc_slice_data(*args):
            if not _state["installed"]:
                _install_cavlc_tables(jm_native)
                _state["installed"] = True
            return jm_native.cavlc_slice_data(*args)

        cavlc_slice_data = _cavlc_slice_data
        deblock_frame = jm_native.deblock_frame

        # decode-side CAVLC slice parser: install the peek-LUTs compiled
        # by decoder/cavlc.py (single source of truth) lazily, same
        # import-cycle reason as above
        _dec_state = {"installed": False}

        def _parse_slice_cavlc(*args):
            if not _dec_state["installed"]:
                from ..decoder import cavlc as C
                jm_native.set_cavlc_dec_tables(
                    [np.ascontiguousarray(t, np.int32) for t in C.CT_LUT],
                    [np.ascontiguousarray(C.CT_DC_LUT[0], np.int32)],
                    [np.ascontiguousarray(t, np.int32) for t in C.TZ_LUT],
                    [np.ascontiguousarray(t, np.int32)
                     for t in C.TZ_DC_LUT[0]],
                    [np.ascontiguousarray(t, np.int32) for t in C.RUN_LUT])
                _dec_state["installed"] = True
            return jm_native.parse_slice_cavlc(*args)

        parse_slice_cavlc = _parse_slice_cavlc
        available = True
    except Exception as e:      # no compiler, headers or loadable library
        available = False
        load_error = e


_load()
