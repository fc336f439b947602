"""Top-level H.264 decoder: Annex-B in, YUV frames out.

Mirrors the reference's 4-call decoder-library lifecycle
(ldecod/inc/h264decoder.h:43-47 OpenDecoder/DecodeOneFrame/FinitDecoder/
CloseDecoder; driver ldecod/src/ldecod.c:1126-1297) as a Python class, with
the two-phase parse->reconstruct pipeline replacing ldecod's per-MB
parse+decode loop (ldecod/src/image.c decode_one_frame:809).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.bitreader import BitReader
from ..bitstream.nal import NalUnit, NalUnitType, split_annexb
from ..common.types import SliceType
from ..ops.deblock import deblock_picture
from .dpb import DPB, Frame
from .header import PocContext, parse_slice_header
from .mb_parse import MBParser, PictureData, SliceContext
from .parset import parse_pps, parse_sps
from .recon import Reconstructor


@dataclass
class DecodedFrame:
    poc: int
    Y: np.ndarray
    U: np.ndarray
    V: np.ndarray
    view_id: int = 0


class H264Decoder:
    def __init__(self, conceal_mode: int = 0,
                 device_recon: bool = False) -> None:
        """conceal_mode: 0 = strict (raise on loss), 1 = frame copy,
        2 = motion copy (ldecod ConcealMode, configfile.h:44).
        device_recon: batch the inter reconstruction of qualifying P
        pictures on the accelerator (ops/dec_jax.py; bit-exact twin of
        the host Reconstructor, tests/test_dec_jax.py)."""
        self.device_recon = device_recon
        self.sps_map: dict[int, object] = {}
        self.subset_sps_map: dict[int, object] = {}   # MVC (NAL 15)
        self.pps_map: dict[int, object] = {}
        self.dpb: DPB | None = None
        self.dpb1: DPB | None = None                  # dependent view DPB
        self.poc_ctx = PocContext()
        self.poc_ctx1 = PocContext()
        self._last_v0 = None        # view-0 frame of the current AU
        self._cur = None       # in-flight picture state
        self._outputs: list[DecodedFrame] = []
        self.sei_messages = []  # parsed SEI (jm_tpu.decoder.sei)
        self.conceal_mode = conceal_mode
        self.concealed_count = 0
        self._prev_ref_frame_num = None
        self._prev_poc = 0
        # field (PAFF) decoding state (D21/E42)
        self._field_refs: list = []     # reference fields, newest first
        self._dp_pending = None         # data-partitioned slice (D3)
        self._pending_field = None      # first field awaiting its pair
        self._uid_next = 1 << 20        # field uids, disjoint from DPB's
        # D20 decoder statistics (ldecod/src/dec_statistics.c twin):
        # bits per NAL type, MB class / skip histograms, slice counts
        self.stats = {
            "nal_bits": {}, "nal_count": {},
            "mb_intra4": 0, "mb_intra16": 0, "mb_intra8": 0, "mb_ipcm": 0,
            "mb_inter": 0, "mb_skip": 0, "slices": 0, "pictures": 0,
        }

    # ------------------------------------------------------------------

    def decode_annexb(self, data: bytes) -> list[DecodedFrame]:
        """Decode an Annex-B chunk; returns frames completed by THIS call
        (decode order). Decoder state (SPS/PPS/DPB) persists across calls so
        a stream may be fed incrementally."""
        start = len(self._outputs)
        for nal in split_annexb(data):
            t = int(nal.nal_unit_type)
            self.stats["nal_bits"][t] = (self.stats["nal_bits"].get(t, 0)
                                         + 8 * (len(nal.rbsp) + 1))
            self.stats["nal_count"][t] = self.stats["nal_count"].get(t, 0) + 1
            try:
                self._handle_nal(nal)
            except EOFError as e:
                # truncated NAL payload (ldecod prints "incomplete NALU"
                # and aborts the picture; we fail the call cleanly)
                raise ValueError(f"truncated NAL unit: {e}") from e
        self._flush_dp()
        self._finish_picture()
        self._materialize_pending()
        return self._outputs[start:]

    # ------------------------------------------------------------------

    def _handle_nal(self, nal: NalUnit) -> None:
        t = nal.nal_unit_type
        if t == NalUnitType.DPA:
            self._flush_dp()
            self._dp_pending = {"a": nal, "b": None, "c": None}
            return
        if t in (NalUnitType.DPB, NalUnitType.DPC):
            if self._dp_pending is None:
                # ldecod: "found data partition B/C without matching DP A,
                # discarding" (image.c)
                return
            self._dp_pending["b" if t == NalUnitType.DPB else "c"] = nal
            return
        self._flush_dp()
        if t == NalUnitType.SPS:
            sps = parse_sps(nal.rbsp)
            self.sps_map[sps.seq_parameter_set_id] = sps
        elif t == NalUnitType.PPS:
            pps = parse_pps(nal.rbsp, self.sps_map)
            self.pps_map[pps.pic_parameter_set_id] = pps
        elif t in (NalUnitType.SLICE, NalUnitType.IDR):
            self._handle_slice(nal)
        elif t == NalUnitType.SEI:
            from .sei import parse_sei_rbsp
            sps = next(iter(self.sps_map.values()), None)
            self.sei_messages.extend(parse_sei_rbsp(nal.rbsp, sps))
        elif t == NalUnitType.SUBSET_SPS:
            from .parset import parse_subset_sps
            sub = parse_subset_sps(nal.rbsp)
            self.subset_sps_map[sub.seq_parameter_set_id] = sub
        elif t == NalUnitType.SLICE_EXT:
            if nal.mvc_ext is None:
                raise ValueError("SVC slice extensions not supported")
            self._handle_slice(nal)
        elif t == NalUnitType.PREFIX:
            pass  # base-view MVC info; base decode is self-contained
        elif t in (NalUnitType.AUD, NalUnitType.FILLER,
                   NalUnitType.EOSEQ, NalUnitType.EOSTREAM):
            pass
        else:
            pass  # aux NALs handled in later phases

    def _handle_slice(self, nal: NalUnit, dp_readers=None) -> None:
        view = (nal.mvc_ext["view_id"]
                if nal.nal_unit_type == NalUnitType.SLICE_EXT else 0)
        smap = self.sps_map if view == 0 else (
            self.subset_sps_map or self.sps_map)
        hdr, br = parse_slice_header(nal, smap, self.pps_map)
        hdr.view_id = view
        pps = self.pps_map[hdr.pic_parameter_set_id]
        sps = smap[pps.seq_parameter_set_id]

        if view == 0:
            if self.dpb is None:
                self.dpb = DPB(sps)
            dpb = self.dpb
        else:
            if self.dpb1 is None:
                self.dpb1 = DPB(sps)
            dpb = self.dpb1

        rpc = int(getattr(hdr, "redundant_pic_cnt", 0) or 0)
        if rpc > 0:
            # redundant coded picture (spec 7.4.3, ldecod image.c): when
            # the primary coding of this (frame_num, poc_lsb) decoded
            # fine, discard; otherwise fall through and decode the
            # redundant coding as the picture (loss fallback)
            self._finish_picture()
            key = (hdr.frame_num, getattr(hdr, "pic_order_cnt_lsb", 0))
            if key in getattr(self, "_primary_keys", ()):
                return

        fld = int(getattr(hdr, "field_pic_flag", 0))
        if sps.bit_depth_luma_minus8 > 6 or sps.bit_depth_chroma_minus8 > 6:
            raise NotImplementedError(
                "bit depth > 14 is not a conforming profile")
        if sps.mb_adaptive_frame_field_flag and not fld:
            raise NotImplementedError(
                "MBAFF frames are not supported yet (E42)")
        if fld:
            if pps.entropy_coding_mode_flag:
                raise NotImplementedError(
                    "CABAC field pictures not supported yet (E42)")
            if hdr.slice_type == SliceType.B:
                raise NotImplementedError(
                    "B field pictures not supported yet (E42)")
        elif view == 0 and self._field_refs and not hdr.is_idr:
            # mixed field->frame streams (PicInterlace=2 adaptive): the
            # decoded fields live in _field_refs, not the frame DPB, so a
            # frame P picture here would predict from a DPB missing them —
            # reject loudly like the other E42 gaps instead of drifting
            raise NotImplementedError(
                "mixed field/frame (adaptive PAFF) streams not supported "
                "yet (E42)")
        if self._is_new_picture(hdr):
            self._finish_picture()
            pctx = self.poc_ctx if view == 0 else self.poc_ctx1
            poc = pctx.compute(hdr, sps)
            if (view == 0 and self.conceal_mode and not hdr.is_idr
                    and self._prev_ref_frame_num is not None
                    and self.dpb is not None and self.dpb.frames):
                self._conceal_frame_num_gap(hdr, sps, poc)
            mb_h = sps.frame_height_in_mbs // 2 if fld \
                else sps.frame_height_in_mbs
            pic = PictureData(sps.pic_width_in_mbs, mb_h,
                              sps.chroma_format_idc)
            pic.field_mode = bool(fld)
            self._cur = {
                "pic": pic, "sps": sps, "pps": pps, "poc": poc,
                "headers": [], "slice_params": [], "n_slices": 0,
                "mb_succ": None, "view": view, "hdr0": hdr,
                "parity": (int(hdr.bottom_field_flag) if fld else None),
            }
            if pps.num_slice_groups_minus1 > 0:
                from ..common.fmo import mb_to_slice_group_map, next_mb_arrays
                gmap = mb_to_slice_group_map(pps, sps,
                                             hdr.slice_group_change_cycle)
                self._cur["mb_succ"] = next_mb_arrays(gmap)
        cur = self._cur
        pic = cur["pic"]

        # build reference lists for this slice; for the dependent view
        # the inter-view reference (the view-0 picture of the SAME access
        # unit) is appended after the temporal refs (H.8.2.1 initial list
        # construction; ldecod mbuffer_mvc.c init_lists_p/b_slice_mvc)
        iv = self._last_v0 if view > 0 else None
        lst, lst1 = [], []
        if cur.get("parity") is not None and \
                hdr.slice_type in (SliceType.P, SliceType.SP):
            if hdr.ref_pic_list_mod_l0:
                raise NotImplementedError(
                    "field ref list modification not supported yet")
            nact = hdr.num_ref_idx_l0_active_minus1 + 1
            lst = self._field_ref_list_p(hdr, sps, cur["parity"])[:nact]
            if len(lst) < nact:
                raise ValueError("insufficient reference fields")
            lst1 = []
        elif hdr.slice_type in (SliceType.P, SliceType.SP):
            if view > 0 and hdr.is_idr:
                # MVC anchor picture: inter-view prediction only (H.8.2;
                # the view-1 DPB flushes when this picture is stored)
                base = [iv]
            else:
                base = dpb.ref_list_p(hdr.frame_num)
                if iv is not None:
                    base = base + [iv]
            nact = hdr.num_ref_idx_l0_active_minus1 + 1
            lst = dpb.reorder_list(base, hdr.ref_pic_list_mod_l0,
                                   hdr.frame_num, nact, inter_view=iv)
            if len(lst) < nact:
                raise ValueError("insufficient reference frames")
        elif hdr.slice_type == SliceType.B:
            from .b_slice import ColMotion, ref_lists_b
            b0, b1 = ref_lists_b(dpb.frames, cur["poc"])
            if iv is not None:
                b0 = b0 + [iv]
                b1 = b1 + [iv]
            nact0 = hdr.num_ref_idx_l0_active_minus1 + 1
            nact1 = hdr.num_ref_idx_l1_active_minus1 + 1
            lst = dpb.reorder_list(b0, hdr.ref_pic_list_mod_l0,
                                   hdr.frame_num, nact0, inter_view=iv)
            lst1 = dpb.reorder_list(b1, hdr.ref_pic_list_mod_l1,
                                    hdr.frame_num, nact1, inter_view=iv)

        sid = cur["n_slices"]
        cur["n_slices"] += 1
        ctx = SliceContext(hdr, sps, pps, sid, mb_succ=cur["mb_succ"])
        if hdr.slice_type == SliceType.B:
            from .b_slice import compute_mvscale
            col = lst1[0]
            if col.motion is None:
                raise ValueError("colocated picture has no stored motion")
            mv0, r0, mv1, r1, rp0, rp1 = col.motion
            ctx.b_col = ColMotion(mv0, r0, mv1, r1, pic.mb_w,
                                  col.is_long_term, rp0, rp1)
            ctx.b_tdirect = ({f.uid: i for i, f in enumerate(lst)},
                             [f.is_long_term for f in lst],
                             compute_mvscale(cur["poc"], lst, col.poc))
        if pps.entropy_coding_mode_flag:
            if dp_readers is not None:
                raise ValueError("data partitioning is CAVLC-only")
            from .mb_parse_cabac import MBParserCABAC
            parser = MBParserCABAC(pic, ctx, br)
        else:
            if dp_readers is not None:
                br.ue()     # DP_A slice_id (ldecod image.c:1628)
            parser = MBParser(pic, ctx, br)
            if dp_readers is not None:
                parser.dp_mode = True
                parser.br_b = dp_readers.get("b")
                parser.br_c = dp_readers.get("c")
        if self.conceal_mode:
            try:
                parser.parse_slice_data()
            except Exception:
                # corrupted slice payload: abandon THIS slice; its MBs are
                # concealed per-MB at picture completion (ldecod ei_flag +
                # erc_do_i/erc_do_p). If nothing of the picture survives,
                # _finish_picture falls back to whole-frame concealment.
                cur.setdefault("failed_sids", []).append(sid)
                return
        else:
            parser.parse_slice_data()
        cur["headers"].append((hdr, lst, lst1))

        # record per-MB ref uids for deblock strength
        mask = pic.slice_id == sid
        for frames_l, ridx_arr, pid_arr in (
                (lst, pic.ref_idx, pic.ref_pic_id),
                (lst1, pic.ref_idx_l1, pic.ref_pic_id_l1)):
            if frames_l:
                uid = np.array([f.uid for f in frames_l], np.int64)
                ridx = ridx_arr[mask]
                pid = np.where(ridx >= 0,
                               uid[np.clip(ridx, 0, len(frames_l) - 1)], -1)
                pid_arr[mask] = pid

    def _device_recon_ok(self, pic, cur, wp, lst0) -> bool:
        """Batched device inter-recon covers: 4:2:0 frame P pictures,
        list0-only prediction (pdir 0), no weighted prediction, no SP
        requant, no 8x8 transform on inter MBs, no concealment in
        flight (everything else keeps the host path MB-exact)."""
        from .mb_parse import MB_INTER
        if cur.get("parity") is not None or pic.n_crows != 2:
            return False
        sps = cur["sps"]
        if sps.bit_depth_luma_minus8 or sps.bit_depth_chroma_minus8:
            return False          # device recon is uint8-only
        if getattr(sps, "qpprime_y_zero_transform_bypass_flag", 0) \
                and (pic.qp == 0).any():
            return False          # lossless bypass stays on the host path
        if wp is not None and getattr(wp, "mode", 0):
            return False
        if not lst0:
            return False
        inter = pic.mb_class == MB_INTER
        if not inter.any():
            return False
        # pdir < 0 means "not set" on the P-slice parse paths and recon
        # treats it as list0 (_recon_inter); only real list1/bi use
        # (pdir 1/2) disqualifies
        if (pic.pdir[inter] > 0).any() or (pic.ref_idx[inter] < 0).any():
            return False
        if pic.transform8x8[inter].any():
            return False
        if getattr(pic, "sp_mb", None) is not None and pic.sp_mb.any():
            return False
        return True

    def _device_pipe_ok(self, pic, cur, wp, lst0, hdr0, pps, lost) -> bool:
        """The fully device-resident P decode pipe (residual decode ->
        inter recon -> bS -> deblock -> next-ref plane prep, one
        composed device round; mirror of the encoder's pipelined
        dispatch). Needs, beyond _device_recon_ok: no intra/IPCM MBs at
        all (intra prediction reads current-picture neighbors on host),
        no 8x8 transform, 4:4:4-free scaling already implied, no lost
        MBs, frame picture, default deblock (per-slice offsets carried
        as arrays, so any idc/offsets are fine)."""
        from .mb_parse import MB_INTER
        if not self._device_recon_ok(pic, cur, wp, lst0):
            return False
        if (pic.mb_class != MB_INTER).any():
            return False
        if pic.transform8x8.any() or lost.any():
            return False
        if getattr(pic, "sp_slice", None) is not None \
                and pic.sp_slice.any():
            return False
        # levels ride to the device as int16
        if abs(int(pic.luma_coef.max())) > 32000 \
                or abs(int(pic.luma_coef.min())) > 32000 \
                or abs(int(pic.chroma_coef.max())) > 32000 \
                or abs(int(pic.chroma_coef.min())) > 32000 \
                or abs(int(pic.chroma_dc.max())) > 32000 \
                or abs(int(pic.chroma_dc.min())) > 32000:
            return False
        return True

    def _dev_ref_state(self, frame):
        """Device (planes, padU, padV) of a decoded reference frame,
        computed once on device and cached — decoded frames that came
        off the device pipe already hold it resident (no host 6-tap
        interpolation, no per-frame re-upload)."""
        st = getattr(frame, "_dev_state", None)
        if st is None:
            import jax

            from ..ops import enc_jax as EJ
            st = EJ.prep_ref(jax.device_put(np.asarray(frame.Y)),
                             jax.device_put(np.asarray(frame.U)),
                             jax.device_put(np.asarray(frame.V)))
            frame._dev_state = st
        return st

    def _pps_dev_tabs(self, pps):
        """Per-PPS device constants for the decode pipe: inter
        InvLevelScale tables (lists 3/4/5) and QP->QPc maps with the
        pps chroma offsets."""
        cache = getattr(self, "_dev_tab_cache", None)
        if cache is None:
            cache = self._dev_tab_cache = {}
        key = id(pps)
        if key not in cache:
            import jax

            from ..common.tables import chroma_qp
            from .recon import build_inv_scale
            tab4, _tab8 = build_inv_scale(pps)
            cb = np.array([chroma_qp(q, pps.cb_qp_offset)
                           for q in range(52)], np.int32)
            cr = np.array([chroma_qp(q, pps.cr_qp_offset)
                           for q in range(52)], np.int32)
            cache[key] = tuple(jax.device_put(x) for x in (
                np.asarray(tab4[3], np.int32), np.asarray(tab4[4], np.int32),
                np.asarray(tab4[5], np.int32), cb, cr))
        return cache[key]

    def _decode_p_device_pipe(self, pic, cur, hdr0, pps, lst0):
        """Run the resident device decode pipe; returns (Y, U, V, state)
        with Y/U/V the deblocked host planes and state the device
        reference prep for future pictures."""
        import jax
        import jax.numpy as jnp

        from ..ops import dec_jax as DX
        from ..ops import enc_jax as EJ
        from ..ops.deblock_jax import compute_bs_jax, deblock_jax
        n = pic.n_mbs
        tabY, tabU, tabV, d_cb, d_cr = self._pps_dev_tabs(pps)
        states = [self._dev_ref_state(f) for f in lst0]
        planes = jnp.stack([s[0] for s in states])
        padU = jnp.stack([s[1] for s in states])
        padV = jnp.stack([s[2] for s in states])

        # minimize upload bytes: levels ship as int8 when they fit (the
        # common case at normal QPs — 2.1 MB instead of 4.2 MB luma at
        # 1080p), mv as int16; the device kernels cast to int32
        # internally either way
        small8 = (abs(int(pic.luma_coef.max())) <= 127
                  and abs(int(pic.luma_coef.min())) <= 127
                  and abs(int(pic.chroma_coef.max())) <= 127
                  and abs(int(pic.chroma_coef.min())) <= 127
                  and abs(int(pic.chroma_dc.max())) <= 127
                  and abs(int(pic.chroma_dc.min())) <= 127)
        cdt = np.int8 if small8 else np.int16
        mv = jnp.asarray(pic.mv.astype(np.int16))
        ref_idx = jnp.asarray(pic.ref_idx.astype(np.int8))
        qp = jnp.asarray(pic.qp.astype(np.int32))
        nnz = jnp.asarray(pic.luma_nnz.astype(np.int8))
        res_l, res_c = DX.p_dec_residuals(
            jnp.asarray(pic.luma_coef.astype(cdt)),
            jnp.asarray(pic.chroma_dc.astype(cdt)),
            jnp.asarray(pic.chroma_coef.astype(cdt)),
            qp, tabY, tabU, tabV, d_cb, d_cr,
            mb_w=pic.mb_w, mb_h=pic.mb_h)
        Y, U, V = DX.inter_recon_p(
            mv, ref_idx, res_l, res_c, planes, padU, padV,
            jnp.ones(n, bool), mb_w=pic.mb_w, mb_h=pic.mb_h)

        zeros = jnp.zeros(n, jnp.int32)
        # compute_bs_jax is a plain traced function (its other callers
        # are already inside jit); jit it here or every op dispatches
        # eagerly
        bs_fn = getattr(H264Decoder, "_bs_jit", None)
        if bs_fn is None:
            import functools
            bs_fn = functools.partial(jax.jit, static_argnums=(7, 8))(
                compute_bs_jax)
            H264Decoder._bs_jit = bs_fn
        bs_v, bs_h = bs_fn(
            zeros.astype(jnp.int8), nnz, zeros, mv, jnp.zeros_like(mv),
            jnp.asarray(pic.ref_pic_id.astype(np.int32)),
            jnp.asarray(pic.ref_pic_id_l1.astype(np.int32)),
            pic.mb_w, pic.mb_h)
        disable = np.zeros(n, np.int32)
        a_off = np.zeros(n, np.int32)
        b_off = np.zeros(n, np.int32)
        for sid, (hdr, _l0, _l1) in enumerate(cur["headers"]):
            m = pic.slice_id == sid
            disable[m] = hdr.disable_deblocking_filter_idc
            a_off[m] = hdr.slice_alpha_c0_offset_div2
            b_off[m] = hdr.slice_beta_offset_div2
        dY, dU, dV = deblock_jax(
            Y, U, V, bs_v, bs_h, qp, jnp.asarray(disable),
            jnp.asarray(a_off), jnp.asarray(b_off),
            jnp.asarray(pic.slice_id.astype(np.int32)), zeros,
            d_cb, d_cr, mb_w=pic.mb_w, mb_h=pic.mb_h)
        state = EJ.prep_ref(dY, dU, dV)
        # DEFERRED single-leaf fetch: the host returns placeholder
        # arrays now and pulls the pixels at the start of the NEXT
        # picture's _finish_picture — i.e. after the next slice's native
        # parse has overlapped this picture's device execution, but
        # BEFORE the next dispatch is enqueued (a fetch waits for the
        # queued compute it depends on, so fetch-then-dispatch keeps the
        # next picture off the critical path). Everything downstream holds
        # views of the placeholders, which the fetch fills in place.
        Y = np.empty(dY.shape, np.uint8)
        U = np.empty(dU.shape, np.uint8)
        V = np.empty(dV.shape, np.uint8)
        self._pend_fetch = {
            "dev": jnp.concatenate([dY.ravel(), dU.ravel(), dV.ravel()]),
            "Y": Y, "U": U, "V": V,
        }
        return Y, U, V, state

    def _materialize_pending(self) -> None:
        """Complete the deferred device->host pixel fetch of the last
        device-pipe picture (no-op when nothing is pending)."""
        p = getattr(self, "_pend_fetch", None)
        if p is None:
            return
        self._pend_fetch = None
        import jax
        flat = np.asarray(jax.device_get(p["dev"]))
        ny = p["Y"].size
        nc = p["U"].size
        p["Y"][...] = flat[:ny].reshape(p["Y"].shape)
        p["U"][...] = flat[ny:ny + nc].reshape(p["U"].shape)
        p["V"][...] = flat[ny + nc:].reshape(p["V"].shape)

    def _inter_recon_device(self, pic, pps, lst0):
        """Run ops/dec_jax.inter_recon_p over the picture's inter MBs;
        returns the (Y, U, V) seed planes for Reconstructor.run."""
        import jax.numpy as jnp

        from ..ops import dec_jax as DX
        from .mb_parse import MB_INTER
        from .recon import decode_residuals
        res_l, res_c = decode_residuals(pic, pps)
        planes = np.stack([np.asarray(f.luma_planes) for f in lst0])
        padU = np.stack([np.asarray(f.chroma_pad[0]) for f in lst0])
        padV = np.stack([np.asarray(f.chroma_pad[1]) for f in lst0])
        Y, U, V = DX.inter_recon_p(
            jnp.asarray(pic.mv.astype(np.int32)),
            jnp.asarray(pic.ref_idx.astype(np.int32)),
            jnp.asarray(res_l), jnp.asarray(res_c),
            jnp.asarray(planes), jnp.asarray(padU), jnp.asarray(padV),
            jnp.asarray(pic.mb_class == MB_INTER),
            mb_w=pic.mb_w, mb_h=pic.mb_h)
        return np.asarray(Y), np.asarray(U), np.asarray(V)

    def _is_new_picture(self, hdr) -> bool:
        """ldecod/src/image.c:2276 is_new_picture: a slice opens a new
        picture when the header's picture-identifying fields differ from
        the in-flight picture's first slice (FMO slices need not start at
        MB 0, so first_mb_in_slice == 0 is not the boundary test)."""
        if self._cur is None:
            return True
        h0 = (self._cur["headers"][0][0] if self._cur["headers"]
              else self._cur.get("hdr0"))
        if h0 is None:
            return False

        def poc_key(h):
            return (getattr(h, "pic_order_cnt_lsb", 0),
                    getattr(h, "delta_pic_order_cnt_bottom", 0),
                    tuple(getattr(h, "delta_pic_order_cnt", ()) or ()))

        return (hdr.frame_num != h0.frame_num
                or getattr(hdr, "field_pic_flag", 0) !=
                getattr(h0, "field_pic_flag", 0)
                or getattr(hdr, "bottom_field_flag", 0) !=
                getattr(h0, "bottom_field_flag", 0)
                or hdr.pic_parameter_set_id != h0.pic_parameter_set_id
                or hdr.is_idr != h0.is_idr
                or (hdr.is_idr and hdr.idr_pic_id != h0.idr_pic_id)
                or poc_key(hdr) != poc_key(h0)
                or (hdr.nal_ref_idc == 0) != (h0.nal_ref_idc == 0)
                or getattr(hdr, "view_id", 0) != self._cur.get("view", 0))

    # ---- error concealment (D17) -------------------------------------

    def _conceal_frame_num_gap(self, hdr, sps, cur_poc: int) -> None:
        """Gap in frame_num (spec 7.4.3 gaps_in_frame_num; ldecod
        conceal_lost_frames mbuffer.c:1837): synthesize the missing
        reference frames so later pictures keep decoding."""
        self._materialize_pending()   # concealment copies real pixels
        max_fn = sps.max_frame_num
        prev = self._prev_ref_frame_num
        gap = (hdr.frame_num - prev - 1) % max_fn
        if hdr.frame_num == prev or gap == 0 or gap > 16:
            return
        # POC interpolation between the last decoded and current picture
        step = (cur_poc - self._prev_poc) / (gap + 1)
        for k in range(1, gap + 1):
            fn = (prev + k) % max_fn
            poc = int(round(self._prev_poc + step * k))
            self._store_concealed(fn, poc)

    def _store_concealed(self, frame_num: int, poc: int) -> None:
        from .conceal import conceal_lost_frame
        f = conceal_lost_frame(self.dpb.frames, frame_num, poc,
                               self.conceal_mode)
        self.dpb.store(f)
        self.concealed_count += 1
        self._prev_ref_frame_num = frame_num
        self._prev_poc = poc
        self._outputs.append(DecodedFrame(poc, f.Y, f.U, f.V))

    # ------------------------------------------------------------------

    def _finish_picture(self) -> None:
        # complete the previous device-pipe picture's deferred pixel
        # fetch first: its device work overlapped this picture's parse,
        # and the fetch must precede the next dispatch
        self._materialize_pending()
        if self._cur is None:
            return
        cur, self._cur = self._cur, None
        pic, sps, pps = cur["pic"], cur["sps"], cur["pps"]
        if not cur["headers"]:
            # every slice of the picture was corrupt: whole-frame conceal
            if self.dpb is not None and self.dpb.frames:
                h0 = cur.get("hdr0")
                self._store_concealed(
                    h0.frame_num if h0 is not None else 0, cur["poc"])
            return
        hdr0, lst0, lst1 = cur["headers"][0]

        # per-MB concealment (D17): MBs of failed slices + never-covered
        # MBs get neutral parse state now and pixel concealment after
        # reconstruction (erc_do_i.c:544 spatial / erc_do_p.c:74 inter)
        lost = pic.slice_id < 0
        for sid_f in cur.get("failed_sids", ()):
            lost |= pic.slice_id == sid_f
        if lost.any() and self.conceal_mode:
            from .mb_parse import MB_I16 as _I16
            la = np.flatnonzero(lost)
            pic.mb_class[la] = _I16
            pic.i16_mode[la] = 2              # DC
            pic.luma_dc[la] = 0
            pic.luma_coef[la] = 0
            pic.luma_nnz[la] = 0
            pic.chroma_dc[la] = 0
            pic.chroma_coef[la] = 0
            pic.chroma_nnz[la] = 0
            pic.cbp[la] = 0
            pic.transform8x8[la] = False
            pic.skip[la] = False
            pic.mv[la] = 0
            pic.ref_idx[la] = -1
            pic.ref_idx_l1[la] = -1
            pic.slice_id[la] = 0
        elif lost.any():
            raise ValueError("slice data missing for some macroblocks")

        from .wp import WPParams
        wp = WPParams(hdr0, pps, lst0, lst1, cur["poc"],
                      bd=(sps.bit_depth_luma_minus8 + 8,
                          sps.bit_depth_chroma_minus8 + 8))
        dev_state = None
        if self.device_recon and self._device_pipe_ok(pic, cur, wp, lst0,
                                                      hdr0, pps, lost):
            Y, U, V, dev_state = self._decode_p_device_pipe(
                pic, cur, hdr0, pps, lst0)
        else:
            rec = Reconstructor(pic, sps, pps, lst0, lst1, wp,
                                cur_parity=cur.get("parity"))
            seed = None
            if self.device_recon and self._device_recon_ok(pic, cur, wp,
                                                           lst0):
                seed = self._inter_recon_device(pic, pps, lst0)
            Y, U, V = rec.run(seed=seed)

            # deblock (per-MB slice params)
            n = pic.n_mbs
            disable = np.zeros(n, np.int32)
            a_off = np.zeros(n, np.int32)
            b_off = np.zeros(n, np.int32)
            cb_off = np.full(n, pps.cb_qp_offset, np.int32)
            cr_off = np.full(n, pps.cr_qp_offset, np.int32)
            for sid, (hdr, _lst, _lst1) in enumerate(cur["headers"]):
                m = pic.slice_id == sid
                disable[m] = hdr.disable_deblocking_filter_idc
                a_off[m] = hdr.slice_alpha_c0_offset_div2
                b_off[m] = hdr.slice_beta_offset_div2
            deblock_picture(Y, U, V, pic, pic.mb_w, pic.mb_h, pic.qp, {
                "disable_idc": disable, "alpha_off": a_off,
                "beta_off": b_off,
                "cb_qp_off": cb_off, "cr_qp_off": cr_off,
                "slice_id": pic.slice_id,
            }, bd=(sps.bit_depth_luma_minus8 + 8,
                   sps.bit_depth_chroma_minus8 + 8))

        view = cur.get("view", 0)
        if lost.any() and self.conceal_mode:
            from .conceal import _closest_ref, conceal_mbs
            dpb_v = self.dpb if cur.get("view", 0) == 0 else self.dpb1
            ref = None
            if hdr0.slice_type != SliceType.I and lst0:
                ref = lst0[0]
            elif dpb_v is not None and dpb_v.frames:
                ref = _closest_ref(dpb_v.frames, cur["poc"])
            self.concealed_count += conceal_mbs(
                Y, U, V, pic, lost, ref, pic.mb_w, pic.mb_h)

        # record the primary key so later redundant codings are discarded
        if int(getattr(hdr0, "redundant_pic_cnt", 0) or 0) == 0:
            keys = getattr(self, "_primary_keys", None)
            if keys is None:
                keys = self._primary_keys = []
            keys.append((hdr0.frame_num,
                         getattr(hdr0, "pic_order_cnt_lsb", 0)))
            del keys[:-32]
        frame = Frame(poc=cur["poc"], frame_num=hdr0.frame_num,
                      Y=Y, U=U, V=V, is_ref=hdr0.nal_ref_idc != 0,
                      bit_depth=sps.bit_depth_luma_minus8 + 8)
        if dev_state is not None:
            frame._dev_state = dev_state
        frame.motion = (pic.mv.copy(), pic.ref_idx.copy(),
                        pic.mv_l1.copy(), pic.ref_idx_l1.copy(),
                        pic.ref_pic_id.copy(), pic.ref_pic_id_l1.copy())
        if cur.get("parity") is not None:
            self._finish_field(cur, frame, hdr0, pic)
            return
        dpb = self.dpb if view == 0 else self.dpb1
        dpb.store(frame,
                  mmco_ops=(hdr0.mmco_ops
                            if hdr0.adaptive_ref_pic_marking_mode_flag
                            else None),
                  idr=hdr0.is_idr,
                  long_term_flag=hdr0.long_term_reference_flag)
        if view == 0:
            self._last_v0 = frame
            if frame.is_ref:
                self._prev_ref_frame_num = hdr0.frame_num
            self._prev_poc = cur["poc"]
        st = self.stats
        st["pictures"] += 1
        st["slices"] += cur["n_slices"]
        from .mb_parse import MB_I4, MB_I16, MB_INTER, MB_IPCM
        cls = pic.mb_class
        i4 = cls == MB_I4      # intra 8x8 = I4 class + 8x8 transform flag
        st["mb_intra4"] += int((i4 & ~pic.transform8x8).sum())
        st["mb_intra8"] += int((i4 & pic.transform8x8).sum())
        st["mb_intra16"] += int((cls == MB_I16).sum())
        st["mb_ipcm"] += int((cls == MB_IPCM).sum())
        st["mb_inter"] += int((cls == MB_INTER).sum())
        st["mb_skip"] += int(pic.skip.sum())
        Yc, Uc, Vc = _crop_output(sps, Y, U, V)
        self._outputs.append(DecodedFrame(cur["poc"], Yc, Uc, Vc,
                                          view_id=view))


    def _flush_dp(self) -> None:
        """Complete a pending data-partitioned slice (NAL 2/3/4): the
        DPA carries the slice header + MB headers, DPB/DPC the intra/
        inter residual SEs behind a slice_id partition header
        (ldecod read_new_slice DP assembly, image.c)."""
        if self._dp_pending is None:
            return
        dp, self._dp_pending = self._dp_pending, None
        readers = {}
        # the PPS governing redundant_pic_cnt_present_flag is the one the
        # DPA slice header references (multi-PPS streams may differ); peek
        # first_mb/slice_type/pic_parameter_set_id from partition A
        pps0 = None
        try:
            peek = BitReader(dp["a"].rbsp)
            peek.ue()                       # first_mb_in_slice
            peek.ue()                       # slice_type
            pps0 = self.pps_map.get(peek.ue())
        except Exception:
            pass
        if pps0 is None and self.pps_map:
            pps0 = next(iter(self.pps_map.values()))
        for key in ("b", "c"):
            n = dp[key]
            if n is None:
                continue
            br = BitReader(n.rbsp)
            br.ue()                         # slice_id
            if pps0 is not None and getattr(
                    pps0, "redundant_pic_cnt_present_flag", 0):
                br.ue()                     # redundant_pic_cnt
            readers[key] = br
        self._handle_slice(dp["a"], dp_readers=readers)

    # ---- field (PAFF) decoding: D21/E42 ------------------------------

    def _field_ref_list_p(self, hdr, sps, parity) -> list:
        """Initial P-field list0 (spec 8.2.4.2.2 + 8.2.4.2.5): frame
        units ordered by FrameNumWrap descending, fields taken
        alternately starting with the current parity."""
        max_fn = sps.max_frame_num
        cur_fn = hdr.frame_num

        def fnw(f):
            return (f.frame_num - max_fn if f.frame_num > cur_fn
                    else f.frame_num)
        units: dict = {}
        for f in self._field_refs:
            if not f.is_long_term:
                units.setdefault(fnw(f), []).append(f)
        order = [units[k] for k in sorted(units, reverse=True)]
        same = [f for u in order for f in u if f.parity == parity]
        opp = [f for u in order for f in u if f.parity != parity]
        out, i, j = [], 0, 0
        while i < len(same) or j < len(opp):
            if i < len(same):
                out.append(same[i])
                i += 1
            if j < len(opp):
                out.append(opp[j])
                j += 1
        return out

    def _finish_field(self, cur, frame, hdr0, pic) -> None:
        """Store a decoded field as a reference (frame-unit sliding
        window, mbuffer.c) and weave complementary pairs into display
        frames."""
        frame.parity = cur["parity"]
        frame.uid = self._uid_next
        self._uid_next += 1
        if hdr0.is_idr:
            self._field_refs = []
        if hdr0.adaptive_ref_pic_marking_mode_flag:
            raise NotImplementedError("field MMCO not supported yet")
        if frame.is_ref:
            self._field_refs.insert(0, frame)
            # sliding window over frame units (a complementary pair or an
            # unpaired field counts one unit; spec 8.2.5.3, mbuffer.c)
            units = []
            for f in self._field_refs:       # newest first
                if units and f.frame_num == units[-1][0].frame_num \
                        and len(units[-1]) == 1 \
                        and f.parity != units[-1][0].parity:
                    units[-1].append(f)
                else:
                    units.append([f])
            cap = max(1, cur["sps"].max_num_ref_frames)
            while len(units) > cap:
                for f in units.pop():        # oldest unit
                    self._field_refs.remove(f)
        # output weaving
        pend = self._pending_field
        if (pend is not None and pend.frame_num == frame.frame_num
                and pend.parity != frame.parity):
            top, bot = ((pend, frame) if pend.parity == 0
                        else (frame, pend))
            H2, W = top.Y.shape
            Y = np.empty((H2 * 2, W), top.Y.dtype)
            Y[0::2], Y[1::2] = top.Y, bot.Y
            ch, cw = top.U.shape
            U = np.empty((ch * 2, cw), top.U.dtype)
            U[0::2], U[1::2] = top.U, bot.U
            V = np.empty((ch * 2, cw), top.V.dtype)
            V[0::2], V[1::2] = top.V, bot.V
            Y, U, V = _crop_output(cur["sps"], Y, U, V)
            self._outputs.append(DecodedFrame(
                min(top.poc, bot.poc), Y, U, V,
                view_id=cur.get("view", 0)))
            self._pending_field = None
        else:
            self._pending_field = frame
        self.stats["pictures"] += 1
        self.stats["slices"] += cur["n_slices"]


def _crop_output(sps, Y, U, V):
    """Apply SPS frame cropping (spec 7.4.2.1.1): CropUnitX/Y scale by
    chroma subsampling and (2 - frame_mbs_only_flag)."""
    if not sps.frame_cropping_flag:
        return Y, U, V
    sub_w = 2 if sps.chroma_format_idc in (1, 2) else 1
    sub_h = 2 if sps.chroma_format_idc == 1 else 1
    ux = sub_w * 1
    uy = sub_h * (2 - sps.frame_mbs_only_flag)
    l, r = sps.frame_crop_left_offset * ux, sps.frame_crop_right_offset * ux
    t, b = sps.frame_crop_top_offset * uy, sps.frame_crop_bottom_offset * uy
    H, W = Y.shape
    Y = Y[t:H - b, l:W - r]
    cs_h, cs_w = H // U.shape[0], W // U.shape[1]
    U = U[t // cs_h:(H - b) // cs_h, l // cs_w:(W - r) // cs_w]
    V = V[t // cs_h:(H - b) // cs_h, l // cs_w:(W - r) // cs_w]
    return Y, U, V


def decode_file(path: str) -> list[DecodedFrame]:
    with open(path, "rb") as f:
        data = f.read()
    return H264Decoder().decode_annexb(data)
