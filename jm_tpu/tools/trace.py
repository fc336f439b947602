"""Syntax-element trace tool (SURVEY §4.3/§5; JM TRACE facility).

The reference, built with -DTRACE (lencod/inc/defines.h:25, trace strings
emitted in vlc.c:72 and ldecod's equivalents), writes `trace_dec.txt`
lines of the form

    @<bitpos>  <label>  <bit pattern> ( <value>)

This module reproduces the decoder-side trace for our parser WITHOUT
instrumenting any parse code: during a traced decode, the `BitReader`
bound inside decoder/parset.py, decoder/header.py and decoder/sei.py is
swapped for `TraceBitReader`, which logs every primitive read
(u/ue/se/te/flag) with its bit offset, width, value and the calling parse
function (the element label). Because the CAVLC slice-data parser keeps
reading from the header's reader, whole-slice CAVLC element streams are
traced too. CABAC slice payloads trace the slice header only (arithmetic
decode does not map 1:1 to bit reads).

`diff_traces` aligns two traces — ours vs ours across versions, or ours
vs a JM trace_dec.txt — on bit position/value and reports the first
divergence: the entropy-debug workflow for bitstream mismatches.

CLI:
    python -m jm_tpu.tools.trace stream.264 > trace_ours.txt
    python -m jm_tpu.tools.trace --diff trace_ours.txt trace_dec.txt
"""

from __future__ import annotations

import re
import sys

from ..bitstream.bitreader import PyBitReader


class TraceBitReader(PyBitReader):
    """BitReader logging every primitive read as
    (bitpos, width, kind, label, value). The label is the nearest
    parse-layer caller function name, which matches the element grouping
    of the JM trace (parse_sps -> SPS fields, _read_rplm -> reorder
    commands, ...). Subclasses the pure-Python reader (the native C
    BitReader is not subclassable; tracing trades speed for
    observability)."""

    _log: list = []          # class-level sink installed by trace_stream

    def __init__(self, data) -> None:
        super().__init__(data)
        self._depth = 0

    def _label(self) -> str:
        f = sys._getframe(3)
        while f is not None and f.f_code.co_filename.endswith(
                ("bitreader.py", "trace.py")):
            f = f.f_back
        return f.f_code.co_name if f is not None else "?"

    def _traced(self, kind, parent, *a):
        pos = self.pos
        self._depth += 1
        try:
            v = parent(*a)
        finally:
            self._depth -= 1
        if self._depth == 0:
            TraceBitReader._log.append(
                (pos, self.pos - pos, kind, self._label(), v))
        return v

    def u(self, n: int) -> int:
        return self._traced("u", super().u, n)

    def flag(self) -> int:
        return self._traced("flag", super().flag)

    def ue(self) -> int:
        return self._traced("ue", super().ue)

    def se(self) -> int:
        return self._traced("se", super().se)

    def te(self, rng: int) -> int:
        return self._traced("te", super().te, rng)


def _patch_modules(cls):
    import jm_tpu.decoder.header as h
    import jm_tpu.decoder.parset as ps
    import jm_tpu.decoder.sei as sei
    saved = (ps.BitReader, h.BitReader, sei.BitReader)
    ps.BitReader = h.BitReader = sei.BitReader = cls
    return saved


def _restore_modules(saved):
    import jm_tpu.decoder.header as h
    import jm_tpu.decoder.parset as ps
    import jm_tpu.decoder.sei as sei
    ps.BitReader, h.BitReader, sei.BitReader = saved


def trace_stream(data: bytes, max_nalus: int | None = None) -> str:
    """Decode an Annex-B stream with the tracing reader installed and
    render one JM-style line per primitive read, grouped per NALU."""
    from ..bitstream.nal import split_annexb
    from ..decoder.decoder import H264Decoder
    nal_types = {1: "slice", 5: "IDR", 6: "SEI", 7: "SPS", 8: "PPS",
                 9: "AUD", 15: "subsetSPS", 20: "sliceExt"}
    nalus = split_annexb(data)
    if max_nalus is not None:
        nalus = nalus[:max_nalus]
    out = []
    saved = _patch_modules(TraceBitReader)
    # the native C slice parser consumes whole slices without per-element
    # reads; tracing needs the Python parse loop
    from ..decoder.mb_parse import MBParser
    saved_native = MBParser._parse_native
    MBParser._parse_native = lambda self: False
    try:
        dec = H264Decoder()
        for k, nal in enumerate(nalus):
            out.append(f"== NALU {k}: type {nal.nal_unit_type} "
                       f"({nal_types.get(nal.nal_unit_type, '?')}), "
                       f"len {len(nal.rbsp) + 1}, nri {nal.nal_ref_idc}")
            TraceBitReader._log = log = []
            try:
                dec._handle_nal(nal)
            except Exception as e:          # truncated / unsupported tail
                out.append(f"!! parse stopped: {type(e).__name__}: {e}")
            for (pos, width, kind, fn, val) in log:
                out.append(f"@{pos:<7d}{fn}:{kind:<5s} "
                           f"{'x' * min(width, 24):>24s} ({val:7d})")
    finally:
        _restore_modules(saved)
        MBParser._parse_native = saved_native
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# trace diffing
# ---------------------------------------------------------------------------

# JM: "@24    SPS: seq_parameter_set_id    1 (  0)"
# ours: "@24     parse_sps:ue        x (      0)"
_LINE_RE = re.compile(r"^@(\d+)\s+(\S.*?)\s+([01x]+)\s+\(\s*(-?\d+)\)")


def parse_trace(text: str) -> list:
    """(bitpos, label, value) triples from either trace dialect."""
    out = []
    for line in text.splitlines():
        m = _LINE_RE.match(line.strip())
        if m:
            out.append((int(m.group(1)), m.group(2).strip(),
                        int(m.group(4))))
    return out


def diff_traces(a: str, b: str, context: int = 4) -> str:
    """First divergence between two traces aligned element-by-element on
    (bit position, value) — exactly where an entropy desync begins."""
    ta, tb = parse_trace(a), parse_trace(b)
    n = min(len(ta), len(tb))
    for i in range(n):
        pa, la, va = ta[i]
        pb, lb, vb = tb[i]
        if pa != pb or va != vb:
            lines = [f"DIVERGE at element #{i}:",
                     f"  A: @{pa} {la} = {va}",
                     f"  B: @{pb} {lb} = {vb}",
                     "  context:"]
            for j in range(max(0, i - context), min(n, i + context)):
                mark = ">>" if j == i else "  "
                lines.append(
                    f"  {mark} A @{ta[j][0]:<6d} {ta[j][1][:36]:36s}"
                    f" {ta[j][2]:6d} | B @{tb[j][0]:<6d} "
                    f"{tb[j][1][:36]:36s} {tb[j][2]:6d}")
            return "\n".join(lines)
    if len(ta) != len(tb):
        return (f"traces agree for {n} elements, lengths differ "
                f"({len(ta)} vs {len(tb)})")
    return f"IDENTICAL ({n} elements)"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--diff":
        a = open(argv[1], encoding="latin-1").read()
        b = open(argv[2], encoding="latin-1").read()
        print(diff_traces(a, b))
        return 0
    if not argv:
        print(__doc__)
        return 2
    data = open(argv[0], "rb").read()
    limit = int(argv[1]) if len(argv) > 1 else None
    sys.stdout.write(trace_stream(data, max_nalus=limit))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
