"""Baseline-profile H.264 encoder: IPPP, CAVLC, closed-loop recon.

Pipeline (per frame): [P] batched full-search ME sweep -> serial MB loop
(mode decision + residual coding + incremental recon, the wavefront-batch
device twin lands next) -> deblock (shared with decoder) -> DPB -> slice
serialization (pure function of PictureData).

Capability parity with lencod's driver/mode-decision stack
(lencod/src/lencod.c encode_sequence:885, image.c encode_one_frame:1183,
slice.c encode_one_slice:431, md_low.c encode_one_macroblock_low:104) —
new architecture: decision state lives in the same PictureData SoA the
decoder uses, so encoder recon is decode-exact by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream.nal import NalUnitType, annexb_bytes
from ..common.predict_ctx import CODE2RASTER, PredCtx
from ..common.tables import chroma_qp
from ..common.types import PPS, SPS, SliceType
from ..decoder.dpb import Frame
from ..decoder.mb_parse import MB_I4, MB_I16, MB_INTER, PictureData
from ..ops import interp as ip
from ..ops import intra as it
from ..ops.deblock import deblock_picture
from . import me as ME
from . import residual_np as RN
from .syntax import serialize_slice, write_pps, write_sps

# JM-style lambda (md_low): lambda_mode = 0.85 * 2^((QP-12)/3); ME cost uses
# its square root (SAD domain).
def lambda_me(qp: int) -> int:
    return max(1, int(round((0.85 * 2.0 ** ((qp - 12) / 3.0)) ** 0.5)))


def lambda_mode4(qp: int) -> int:
    """Penalty unit for non-most-probable intra-4x4 modes (JM md_low uses
    4 * lambda_me)."""
    return 4 * lambda_me(qp)


class DeviceFrame(Frame):
    """A DPB Frame whose reconstruction lives on the device (the
    pipelined encoder's resident reference state). Pixel planes are
    materialized lazily on first host access, so the fast IPPP loop never
    pays the device->host transfer."""

    def __init__(self, poc: int, frame_num: int, state):
        self._state = state            # (planes, padU, padV) device arrays
        self._dev = state              # classic device path's plane cache
        super().__init__(poc=poc, frame_num=frame_num, Y=None, U=None,
                         V=None)

    def _materialize(self):
        if self._Y is None and self._state is not None:
            import jax
            planes, padU, padV = self._state
            P = ip.PAD
            self._Y = np.asarray(jax.device_get(planes[0]))[P:-P, P:-P]
            self._U = np.asarray(jax.device_get(padU))[P:-P, P:-P]
            self._V = np.asarray(jax.device_get(padV))[P:-P, P:-P]

    @property
    def Y(self):
        self._materialize()
        return self._Y

    @Y.setter
    def Y(self, v):
        self._Y = v

    @property
    def U(self):
        self._materialize()
        return self._U

    @U.setter
    def U(self, v):
        self._U = v

    @property
    def V(self):
        self._materialize()
        return self._V

    @V.setter
    def V(self, v):
        self._V = v


@dataclass
class EncoderConfig:
    width: int = 176
    height: int = 144
    qp: int = 28
    intra_period: int = 0        # 0: only first frame is I
    search_range: int = 16
    num_ref: int = 1             # list0 size (P2: single reference)
    level_idc: int = 30
    deblock: bool = True
    entropy: str = "cavlc"       # "cavlc" | "cabac" (cabac => Main profile)
    cabac_adapt_init: bool = False   # per-slice cabac_init_idc selection
                                 # (lencod ContextInitMethod=1 adaptive,
                                 # context_ini.c; here: exact 3-way trial)
    poc_type: int = 0            # PicOrderCntType 0/1/2 (E28; type 1
                                 # writes a 1-entry expected cycle)
    redundant_period: int = 0    # emit a redundant coded picture after
                                 # every Nth P primary (E34; lencod.c
                                 # 2225-2352 RedundantPicture/
                                 # NumRedundantHierarchy — loss
                                 # resilience: decoders fall back to it
                                 # when the primary is lost)
    redundant_qp_off: int = 4    # redundant picture QP delta
    pic_interlace: int = 0       # 1: field coding always (E42 encode;
                                 # lencod PicInterlace=1,
                                 # image.c:751 perform_encode_field) —
                                 # every frame coded as top+bottom field
                                 # pictures with parity-alternating
                                 # reference lists (spec 8.2.4.2.5)
    device_rd: bool = False      # device md_high: batched trial-encode RD
                                 # with exact CAVLC bits on the fast path
                                 # (ops/enc_rd.py; md_high.c:38 twin)
    rdoq: int = 0                # trellis quantization (E11, lencod
                                 # UseRDOQuant; rdoq.py)
    rdoq_dc: int = 0             # trellis the luma DC blocks (RDOQ_DC)
    rdoq_cr: int = 0             # trellis chroma AC (RDOQ_CR)
    rdoq_dc_cr: int = 0          # trellis chroma DC (RDOQ_DC_CR)
    chroma_format: int = 1       # 1 = 4:2:0, 2 = 4:2:2 (High 4:2:2 profile)
    num_b: int = 0               # B pictures between anchors (IbbP..)
    hierarchical: int = 0        # dyadic B pyramid with reference Bs (E3,
                                 # lencod HierarchicalCoding/explicit_gop.c)
    explicit_gop: str = ""       # ExplicitHierarchyFormat string (overrides
                                 # the dyadic order; encoder/gop.py)
    qp_b: int | None = None      # B-picture QP (default qp + 2)
    qp_p: int | None = None      # P-anchor QP (default qp)
    rc_enable: bool = False      # JVT-G012 rate control (jm_tpu.ratectl)
    rc_bitrate: float = 0.0      # target bits/s when rc_enable
    frame_rate: float = 30.0
    rc_initial_qp: int = 0       # 0: derive from bpp
    rc_basic_unit: int = 0       # BasicUnit: MBs per within-frame RC unit
                                 # (E29, rc_quadratic.c basic-unit branch;
                                 # 0 = frame-level QP only)
    transform8x8: bool = False   # High-profile adaptive 8x8 transform
    sei_user_data: bytes | None = None   # user_data_unregistered on IDR
    sei_recovery_point: bool = False     # recovery point on open-GOP I
    # multi-slice (lencod SliceMode/SliceArgument) and FMO (fmo.c)
    intra_mb_refresh: int = 0    # forced-intra MBs per P picture (E34,
                                 # lencod RandomIntraMBRefresh/intrarefresh.c)
    weighted_pred: int = 0       # P explicit WP (lencod WeightedPrediction)
    wp_method: int = 0           # 0 = DC-ratio alg0, 1 = LMS (wp_lms.c)
    wp_iter_mc: int = 0          # >0: iterative MC-based WP estimation
                                 # rounds (WPIterMC; wp_mciter.c:1-874)
    wp_mcprec: int = 0           # WPMCPrecision (wp_mcprec.c
                                 # wpxInitWPXPasses): trial the picture
                                 # with {estimated WP, offset-only WP,
                                 # no WP} and keep the min-J coding
    weighted_bipred: int = 0     # B WP: 0 off, 1 explicit, 2 implicit
    enable_vui: bool = False     # write VUI timing info into the SPS (E26)
    rdo: int = 0                 # RDOptimization tier (rdopt.c:242):
                                 # 0 = cost-based (md_low), 1 = trial-
                                 # encode md_high, 2 = md_highfast,
                                 # 3 = md_highloss (+ errdo), 4 =
                                 # md_high_updated; 1 = trial-encode
                                 # RD with exact bit counting (md_high, E8)
    enable_ipcm: int = 0         # 1: IPCM as RD candidate, 2: force IPCM
                                 # (lencod EnableIPCM, mode_decision.c:132)
    rd_picture_decision: bool = False  # multi-pass QP+-1 picture RD (E4,
                                       # lencod RDPictureDecision/image_mp.c)
    long_term_period: int = 0    # mark every Nth anchor long-term via MMCO
    ref_reorder: int = 0         # ReferenceReorder=1: POC-distance list0
                                 # order + explicit modification commands
                                 # (lencod list_reorder.c
                                 # poc_ref_pic_reorder_frame_default:82)
    mmco_policy: str = ""        # "cra": clean-random-access marking
                                 # (mmco.c:151 cra_ref_management —
                                 # after each open-GOP I, the next
                                 # anchor emits MMCO 1 for every
                                 # short-term reference older than that
                                 # I, so decoding can start at the I)
    poc_mem_mgmt: int = 0        # PocMemoryManagement=1: MMCO 1 unmarks the
                                 # min-POC short-term ref when the DPB is
                                 # full (lencod mmco.c
                                 # poc_based_ref_management_frame_pic:300)
    sp_periodicity: int = 0      # SPPicturePeriodicity: every Nth non-I
                                 # picture is an SP switching picture (E35)
    data_partition: int = 0      # PartitionMode=1: 3-partition slices
                                 # (D3/E-side; NAL 2/3/4, CAVLC only)
    qp_sp: int = 24              # QPSPSlice: slice QP of SP pictures
    qp_sp2: int = 24             # QPSP2Slice: switching QP QS
                                 # (E24, lencod mmco.c adaptive marking)
    num_decoders: int = 0        # errdo: simulated lossy decoders (E32,
    loss_rate_a: int = 0         # lencod NumberOfDecoders / LossRateA)
    sub8x8: bool = False         # P8x8 sub-partitions 8x4/4x8/4x4 (E7)
    subpel_satd: bool = True     # Hadamard SATD in fractional ME (E16,
                                 # JM MEDistortionHPel/QPel=2 default)
    search_mode: int = 0         # JM SearchMode (types.h:128): -1/0 full
                                 # search tables; 1/2/3 (UMHex/UMHexSimple/
                                 # EPZS) -> predictive zonal search
                                 # (encoder/me_epzs.py, E15)
    hme: bool = False            # HMEEnable: pyramid ME feeding EPZS
                                 # predictors (me_hme.c:68, E17)
    # custom quantization (E10/E12, encoder/qmatrix.py):
    scaling_matrix: int = 0      # ScalingMatrixPresentFlag: 1 SPS, 2 PPS,
                                 # 3 both (q_matrix.c)
    scaling_lists4: tuple = ()   # 6 raster 16-entry lists (QmatrixFile)
    scaling_lists8: tuple = ()   # 2 raster 64-entry lists
    scaling_present: tuple = ()  # 8 per-list flags (ScalingListPresentFlagN)
    offset_matrix: tuple = ()    # (off4 (15,16), off8 (5,64)) explicit
                                 # quant offsets (QOffsetMatrixFile)
    adaptive_rounding: bool = False   # JVT-N011 (q_around.c, AdaptiveRounding)
    adapt_rnd_period: int = 16   # offset-list fold period in MBs
    adapt_rnd_w: int = 4         # AdaptRndWFactor* (all six default 4)
    num_views: int = 1           # 2 = MVC stereo (E40, Annex H): base view
                                 # AVC NALUs + NAL-20 dependent view with
                                 # inter-view prediction (lencod.c:894-952)
    view1_qp_offset: int = 0     # QP delta for the dependent view
    pipeline: str = "host"       # "host" (serial numpy reference path) |
                                 # "device" (batched jnp/XLA pipeline,
                                 # ops/enc_jax.py; falls back per-frame
                                 # when a feature needs the host path)
    sp_shards: int = 1           # >1: shard the device P pipeline over
                                 # this many devices by MB rows with halo
                                 # exchange (parallel/sp_pipeline.py);
                                 # bitstream is byte-identical to 1 device
                                 # (tests/test_multichip.py)
    slice_mode: int = 0          # 0 one slice/picture, 1 fixed MBs/slice
    slice_argument: int = 0      # MBs per slice for slice_mode 1
    num_slice_groups: int = 1    # >1 enables FMO (Baseline/Extended only)
    slice_group_map_type: int = 0
    sg_run_length: tuple = ()            # type 0 (run_length_minus1 + 1)
    sg_top_left: tuple = ()              # type 2
    sg_bottom_right: tuple = ()          # type 2
    sg_ids: tuple = ()                   # type 6 explicit map
    sg_change_direction: int = 0         # types 3-5
    sg_change_rate_minus1: int = 0       # types 3-5
    sg_change_cycle: int = 1             # types 3-5 (written per slice)


class Encoder:
    """IPPP Baseline encoder with the 4-call lifecycle of the reference
    decoder library mirrored on the encode side: construct, encode_frame()
    per picture, flush() (no-op for IPPP), close."""

    def __init__(self, cfg: EncoderConfig):
        if cfg.width % 16 or cfg.height % 16:
            raise NotImplementedError("cropping: later phase")
        self.cfg = cfg
        self.mb_w = cfg.width // 16
        self.mb_h = cfg.height // 16
        self.coded_height = cfg.height   # per-picture height (field: H/2)
        if cfg.pic_interlace:
            # field coding always (PicInterlace=1): every coded picture
            # is one field at half height; the SPS advertises the frame
            # geometry with frame_mbs_only_flag=0
            if cfg.height % 32:
                raise NotImplementedError(
                    "field coding needs height % 32 == 0 (cropping later)")
            unsupported = (cfg.num_b or cfg.entropy != "cavlc"
                           or cfg.chroma_format != 1 or cfg.num_views != 1
                           or cfg.data_partition or cfg.sp_periodicity
                           or cfg.slice_mode or cfg.num_slice_groups > 1
                           or cfg.weighted_pred or cfg.rc_enable
                           or cfg.transform8x8 or cfg.rdoq
                           or cfg.long_term_period or cfg.poc_type)
            if unsupported:
                raise NotImplementedError(
                    "field coding v1 covers CAVLC 4:2:0 IPPP single-slice "
                    "(no B/WP/RC/8x8/RDOQ/DP/SP/FMO)")
            self.mb_h = cfg.height // 32
            self.coded_height = cfg.height // 2
        use_b = cfg.num_b > 0
        use_wp = cfg.weighted_pred or cfg.weighted_bipred
        profile = 100 if (cfg.transform8x8 or cfg.scaling_matrix) else \
            (77 if (cfg.entropy == "cabac" or use_b or use_wp) else 66)
        if cfg.sp_periodicity > 0 or cfg.data_partition:
            profile = 88               # SP/DP: Extended profile (A.2.3)
        if cfg.num_views == 2:
            profile = 100              # MVC stereo: High-compatible base
                                       # view (lencod writes profile 100
                                       # for the base SPS, parset.c)
        if cfg.chroma_format == 2:
            profile = 122              # High 4:2:2
        # B pictures need both anchors resident in the decoder DPB, so the
        # sliding window must hold at least two references; a dyadic
        # pyramid keeps one reference B per level alive as well
        self.dpb_size = max(cfg.num_ref, 2) if use_b else cfg.num_ref
        if use_b and cfg.hierarchical:
            import math
            levels = max(1, math.ceil(math.log2(cfg.num_b + 1)))
            # both mini-GOP anchors + one reference B per pyramid level
            # must survive the sliding window until the leaves are coded
            self.dpb_size = max(self.dpb_size, levels + 2)
        if use_b and cfg.explicit_gop:
            from .gop import parse_explicit_hierarchy
            entries = parse_explicit_hierarchy(cfg.explicit_gop)
            # lencod rejects inconsistent GOP strings (explicit_gop.c
            # interpret_gop_structure): entries must name each B position
            # 0..NumberBFrames-1 exactly once, else frames would silently
            # drop from the bitstream
            positions = sorted(e.display_no for e in entries)
            if positions != list(range(cfg.num_b)):
                raise ValueError(
                    f"explicit_gop names positions {positions}, expected "
                    f"exactly 0..{cfg.num_b - 1} (NumberBFrames={cfg.num_b})")
            n_ref_b = sum(e.as_ref for e in entries)
            # both anchors + every reference B of the enhancement GOP
            self.dpb_size = max(self.dpb_size, 2 + n_ref_b)
        if cfg.long_term_period > 0:
            self.dpb_size = min(16, self.dpb_size + 1)  # LT anchor slot
        # Annex-A conformance (E39): auto-upgrade the level when the
        # configured one cannot carry this frame size / rate / DPB
        from ..common.conformance import level_check, minimum_level
        level = cfg.level_idc
        try:
            level_check(self.mb_w, self.mb_h, cfg.frame_rate, level,
                        max(cfg.num_ref, 2 if use_b else 1))
        except ValueError:
            level = minimum_level(self.mb_w, self.mb_h, cfg.frame_rate,
                                  max(cfg.num_ref, 2 if use_b else 1))
        # POC mode (E28, lencod header.c / PicOrderCntType): type 0 is
        # the default (explicit lsb, needed whenever display order !=
        # decode order); types 1 and 2 are valid for IPPP streams and
        # cost zero slice-header bits (type 1 here uses a 1-entry
        # expected cycle with delta_pic_order_always_zero_flag=1)
        if cfg.poc_type and cfg.num_b:
            raise ValueError("PicOrderCntType 1/2 requires decode order "
                             "== display order (no B pictures)")
        self.sps = SPS(
            profile_idc=profile,
            level_idc=level,
            log2_max_frame_num_minus4=4,
            pic_order_cnt_type=cfg.poc_type,
            delta_pic_order_always_zero_flag=1 if cfg.poc_type == 1 else 0,
            offset_for_ref_frame=[2] if cfg.poc_type == 1 else [],
            log2_max_pic_order_cnt_lsb_minus4=4,
            max_num_ref_frames=self.dpb_size,
            pic_width_in_mbs_minus1=self.mb_w - 1,
            pic_height_in_map_units_minus1=self.mb_h - 1,
            chroma_format_idc=cfg.chroma_format,
            frame_mbs_only_flag=0 if cfg.pic_interlace else 1,
            direct_8x8_inference_flag=1)
        if cfg.pic_interlace:
            self.sps.mb_adaptive_frame_field_flag = 0
        if cfg.enable_vui:
            # timing info (lencod GenerateVUI_parameters_rbsp:1048): frame
            # rate as time_scale / (2 * num_units_in_tick)
            self.sps.vui_parameters_present_flag = 1
            self.sps.vui = {
                "num_units_in_tick": 1000,
                "time_scale": int(round(cfg.frame_rate * 2000)),
                "fixed_frame_rate": 1,
                "pic_struct_present": 0,
            }
        self.pps = PPS(num_ref_idx_l0_default_active_minus1=cfg.num_ref - 1,
                       entropy_coding_mode_flag=1 if cfg.entropy == "cabac" else 0,
                       transform_8x8_mode_flag=1 if cfg.transform8x8 else 0,
                       weighted_pred_flag=1 if cfg.weighted_pred else 0,
                       weighted_bipred_idc=cfg.weighted_bipred,
                       redundant_pic_cnt_present_flag=
                       1 if cfg.redundant_period else 0,
                       deblocking_filter_control_present_flag=
                       0 if cfg.deblock else 1)
        if cfg.redundant_period and (cfg.num_b or cfg.num_views != 1
                                     or cfg.pic_interlace
                                     or cfg.data_partition):
            raise NotImplementedError(
                "redundant pictures: IPPP single-view frame coding only")
        # custom quant matrices / offsets / adaptive rounding (E10/E12,
        # q_matrix.c + q_offsets.c + q_around.c; encoder/qmatrix.py)
        self.quant_custom = bool(cfg.scaling_matrix or cfg.offset_matrix
                                 or cfg.adaptive_rounding)
        self._ar_state = None
        if self.quant_custom:
            from . import qmatrix as QM
            l4 = [list(x) for x in cfg.scaling_lists4] or \
                [[16] * 16 for _ in range(6)]
            l8 = [list(x) for x in cfg.scaling_lists8] or \
                [[16] * 64 for _ in range(2)]
            self.qm_lists4, self.qm_lists8 = l4, l8
            if cfg.offset_matrix:
                self._ar_state = (np.array(cfg.offset_matrix[0], np.int32),
                                  np.array(cfg.offset_matrix[1], np.int32))
            else:
                self._ar_state = QM.default_offsets()
            if cfg.scaling_matrix:
                if profile not in (100, 122):
                    raise ValueError("scaling matrices need a High profile")
                pres = list(cfg.scaling_present) or [3] * 8
                pres += [0] * (8 - len(pres))
                # every list is transmitted wherever the matrix flag says:
                # the spec's absent-list fall-back chains (rule A/B) would
                # otherwise replace a configured matrix with the default
                pres = [(p & cfg.scaling_matrix) or cfg.scaling_matrix
                        for p in pres]
                n8 = 2 if cfg.transform8x8 else 0
                zz4 = [QM.to_zigzag4(l) for l in l4]
                zz8 = [QM.to_zigzag8(l) for l in l8]
                # effective lists for our own recon mirror + the SPS/PPS
                # transmission sets (decoder resolves identically)
                if cfg.scaling_matrix & 1:
                    self.sps.seq_scaling_matrix_present_flag = 1
                    self.sps.scaling_list_4x4 = [list(x) for x in zz4]
                    self.sps.scaling_list_8x8 = \
                        [list(x) for x in zz8] + [[16] * 64] * 4
                    self.sps.tx_scaling = (
                        [p & 1 for p in pres[:6]] + [p & 1 for p in
                                                     pres[6:6 + n8]],
                        zz4 + zz8[:n8])
                if cfg.scaling_matrix & 2:
                    self.pps.pic_scaling_matrix_present_flag = 1
                    self.pps.tx_scaling = (
                        [(p >> 1) & 1 for p in pres[:6]]
                        + [(p >> 1) & 1 for p in pres[6:6 + n8]],
                        zz4 + zz8[:n8])
                self.pps.scaling_list_4x4 = [list(x) for x in zz4]
                self.pps.scaling_list_8x8 = \
                    [list(x) for x in zz8] + [[16] * 64] * 4
        else:
            self.qm_lists4 = [[16] * 16 for _ in range(6)]
            self.qm_lists8 = [[16] * 64 for _ in range(2)]
        # FMO slice groups (lencod/src/fmo.c FmoInit; Baseline/Extended only)
        self.group_map = None
        if cfg.num_slice_groups > 1:
            if profile not in (66, 88):
                raise ValueError(
                    f"FMO is not allowed in profile {profile} "
                    "(lencod: Baseline/Extended only)")
            p = self.pps
            p.num_slice_groups_minus1 = cfg.num_slice_groups - 1
            t = p.slice_group_map_type = cfg.slice_group_map_type
            if t == 0:
                runs = cfg.sg_run_length or (1,) * cfg.num_slice_groups
                p.run_length_minus1 = [r - 1 for r in runs]
            elif t == 2:
                p.top_left = list(cfg.sg_top_left)
                p.bottom_right = list(cfg.sg_bottom_right)
            elif t in (3, 4, 5):
                p.slice_group_change_direction_flag = cfg.sg_change_direction
                p.slice_group_change_rate_minus1 = cfg.sg_change_rate_minus1
            elif t == 6:
                p.slice_group_id = list(cfg.sg_ids)
            from ..common.fmo import mb_to_slice_group_map
            self.group_map = mb_to_slice_group_map(p, self.sps,
                                                   cfg.sg_change_cycle)
        self.slice_plan = self._build_slice_plan()
        self.frame_idx = 0            # anchors encoded (coding order)
        self.frame_num = 0
        self.idr_pic_id = 0
        self.refs: list[Frame] = []   # most recent first
        self._cur_poc = None          # POC of the picture being coded
        self._uid = 0
        self.stats = []
        self.results = []             # per-picture {disp, type, bits, frame}
        # pipelined P frames finished off the fast path (_pipe_finalize)
        self.pipe_fallbacks = {"intra_speculation": 0,
                               "entropy_overflow": 0}
        self.rc = None
        if cfg.rc_enable:
            from ..ratectl import RateControl
            self.rc = RateControl(cfg.rc_bitrate, cfg.frame_rate,
                                  cfg.width, cfg.height, num_b=cfg.num_b,
                                  initial_qp=cfg.rc_initial_qp)
        self._pending = []            # (disp, Y, U, V) awaiting next anchor
        # MVC stereo (E40): dependent-view inputs keyed by display index,
        # view-1 reference list (most recent first), and the map from a
        # view-0 frame uid to its view-1 companion (B anchors)
        self._v1_pending: dict = {}
        self.refs_v1: list[Frame] = []
        self._v1_of: dict = {}
        self.display_idx = 0          # next display index (absolute)
        self._idr_disp = 0            # display index of last IDR (poc base)
        # cyclic pseudo-random intra refresh (lencod/src/intrarefresh.c:34
        # RandomIntraInit): a seeded permutation of MB addresses consumed
        # intra_mb_refresh at a time, reshuffled each cycle
        self._refresh_perm = []
        self._refresh_pos = 0
        self._refresh_rng = np.random.default_rng(1)
        self.errdo = None
        if cfg.num_decoders > 0 and cfg.loss_rate_a > 0:
            from .errdo import ErrdoState
            self.errdo = ErrdoState(cfg.num_decoders, cfg.loss_rate_a,
                                    cfg.height, cfg.width)

    def _refresh_set(self) -> set:
        k = self.cfg.intra_mb_refresh
        if k <= 0:
            return set()
        out = set()
        while len(out) < min(k, self.mb_w * self.mb_h):
            if self._refresh_pos >= len(self._refresh_perm):
                self._refresh_perm = list(
                    self._refresh_rng.permutation(self.mb_w * self.mb_h))
                self._refresh_pos = 0
            out.add(int(self._refresh_perm[self._refresh_pos]))
            self._refresh_pos += 1
        return out

    # ------------------------------------------------------------------

    def _ref_list_p(self) -> list:
        """List-0 mirror of the decoder's ref_list_p (dpb.py): short-term
        by PicNum descending (== insertion order here), long-term tail by
        index. With ReferenceReorder=1 the short-term run is re-sorted by
        absolute POC distance to the current picture and the slice header
        carries matching modification commands (_poc_reorder_cmds)."""
        st = [f for f in self.refs if not f.is_long_term]
        if self.cfg.ref_reorder == 1 and self._cur_poc is not None:
            cp = self._cur_poc
            st = sorted(st, key=lambda f: (abs(f.poc - cp),
                                           0 if f.poc > cp else 1))
        lt = sorted((f for f in self.refs if f.is_long_term),
                    key=lambda f: f.long_term_frame_idx)
        return (st + lt)[:self.num_ref_active]

    def _picnum(self, f) -> int:
        """PicNum of a short-term ref relative to the current frame_num
        (spec 8.2.4.1 wrap)."""
        return (f.frame_num if f.frame_num <= self.frame_num
                else f.frame_num - self.sps.max_frame_num)

    def _poc_reorder_cmds(self):
        """ref_pic_list_modification commands reproducing `_ref_list_p`'s
        POC order from the decoder's default PicNum order — the emission
        loop of lencod/src/list_reorder.c:196-238 (abs_diff_pic_num
        commands, early stop once the remainder already matches)."""
        default = [f for f in self.refs if not f.is_long_term]
        default = default[:self.num_ref_active]
        target = [f for f in self._ref_list_p() if not f.is_long_term]
        n = len(target)
        if target == default[:n]:
            return None
        max_fn = self.sps.max_frame_num
        cmds = []
        pred = self.frame_num
        cur = [self._picnum(f) for f in default]
        want = [self._picnum(f) for f in target]
        for i, pn in enumerate(want):
            diff = pn - pred
            if diff <= 0:
                amp = -diff - 1
                cmds.append((0, max_fn - 1 if amp < 0 else amp))
            else:
                cmds.append((1, diff - 1))
            pred = pn
            # simulate the list state to allow early termination
            rest = [x for x in cur[i:] if x != pn]
            cur = cur[:i] + [pn] + rest
            if cur[i + 1:n] == want[i + 1:]:
                break
        return cmds

    def _poc_mmco(self):
        """PocMemoryManagement=1: when the DPB holds exactly
        sps.num_ref_frames short-term refs, unmark the min-POC one via
        MMCO op 1 (mmco.c poc_based_ref_management_frame_pic:300).
        Returns (mmco_ops, victim_frame) or (None, None)."""
        st = [f for f in self.refs if not f.is_long_term]
        if len(st) + sum(f.is_long_term for f in self.refs) \
                != self.sps.max_num_ref_frames or not st:
            return None, None
        victim = min(st, key=lambda f: f.poc)
        return ((1, self.frame_num - self._picnum(victim) - 1),), victim

    def _store_ref(self, frame: Frame, long_term: bool = False) -> None:
        """Mirror of DPB.store bookkeeping (sliding window spares
        long-term frames; a new long-term index evicts its old holder)."""
        if long_term:
            for f in list(self.refs):
                if f.is_long_term and f.long_term_frame_idx == 0:
                    self.refs.remove(f)
            frame.is_long_term = True
            frame.long_term_frame_idx = 0
        self.refs.insert(0, frame)
        st = [f for f in self.refs if not f.is_long_term]
        while len(self.refs) > self.dpb_size and st:
            oldest = st.pop()
            self.refs.remove(oldest)

    def _build_slice_plan(self) -> list[list[int]]:
        """Decode-order MB address lists, one per slice: slice groups in
        group order (each in raster-restricted order), optionally split
        into fixed-size slices (SliceMode 1, slice.c:524 size check
        replaced by an up-front partition)."""
        cfg = self.cfg
        n = self.mb_w * self.mb_h
        if self.group_map is None:
            groups = [list(range(n))]
        else:
            groups = [
                [int(a) for a in np.flatnonzero(self.group_map == g)]
                for g in range(cfg.num_slice_groups)]
        slices = []
        for addrs in groups:
            if not addrs:
                continue
            if cfg.slice_mode == 1 and cfg.slice_argument > 0:
                k = cfg.slice_argument
                slices.extend(addrs[i:i + k] for i in range(0, len(addrs), k))
            else:
                slices.append(addrs)
        return slices

    def encode_frame(self, Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                     view1=None) -> bytes:
        """Push one display-order frame. With num_b == 0 the coded picture
        is returned immediately; with B pictures the mini-GOP buffers until
        its next anchor arrives (call flush() at end of sequence). Mirrors
        the reference frame re-ordering of lencod.c prepare_frame_params/
        SetImageType. view1: (Y, U, V) of the dependent view when
        cfg.num_views == 2 (MVC stereo, E40)."""
        cfg = self.cfg
        if cfg.pic_interlace:
            disp = self.display_idx
            self.display_idx += 1
            return self._encode_field_pair(Y, U, V, disp)
        disp = self.display_idx
        self.display_idx += 1
        if cfg.num_views == 2:
            if view1 is None:
                raise ValueError("num_views=2 needs the view1 planes")
            self._v1_pending[disp] = tuple(
                np.asarray(p, np.uint8) for p in view1)
        if cfg.num_b == 0 or not self.refs:
            return self._emit_anchor(Y, U, V, disp)
        self._pending.append((disp, np.asarray(Y, np.uint8),
                              np.asarray(U, np.uint8),
                              np.asarray(V, np.uint8)))
        if len(self._pending) == cfg.num_b + 1:
            return self._emit_group()
        return b""

    def flush(self) -> bytes:
        """Encode any buffered trailing frames (last becomes a P anchor)."""
        if self._pending:
            return self._emit_group()
        return b""

    # ---- pipelined device IPPP driver ---------------------------------

    def _pipe_ok(self) -> bool:
        """The fully-resident pipelined path covers single-slice IPPP
        CAVLC 4:2:0 with fixed QP (the md_low P fast path of
        ops/enc_jax.p_frame_pipe); everything else goes through
        encode_frame."""
        cfg = self.cfg
        return (cfg.pipeline == "device" and cfg.num_b == 0
                and cfg.pic_interlace == 0
                and cfg.sp_periodicity == 0 and cfg.data_partition == 0
                and cfg.num_views == 1 and self.rc is None
                and self.errdo is None and not cfg.rdo
                and not cfg.transform8x8 and not cfg.sub8x8
                and cfg.enable_ipcm == 0 and cfg.num_ref == 1
                and not cfg.weighted_pred and not cfg.rd_picture_decision
                and cfg.entropy == "cavlc" and cfg.chroma_format == 1
                and cfg.slice_mode == 0 and cfg.num_slice_groups == 1
                and cfg.intra_mb_refresh == 0 and cfg.long_term_period == 0
                and not self.quant_custom and not cfg.rdoq
                and cfg.deblock and cfg.search_range <= 24
                and cfg.qp_p is None)

    def encode_stream(self, frames) -> list:
        """Encode an iterable of (Y, U, V) display-order frames; returns
        the per-frame Annex-B payloads. On the covered fast path
        (``_pipe_ok``) P frames run through ``p_frame_pipe``: one device
        program per frame (ME..recon + deblock + next-ref prep, all
        resident), double-buffered so the host serializes frame N while
        the device encodes frame N+1 (the pipelining lencod cannot do —
        its frame loop is strictly serial, lencod.c:911)."""
        if not self._pipe_ok():
            return [self.encode_frame(*f) for f in frames]
        import jax

        from ..ops import enc_jax as EJ
        cfg = self.cfg
        qpc_cb = np.array([chroma_qp(q, self.pps.cb_qp_offset)
                           for q in range(52)], np.int32)
        qpc_cr = np.array([chroma_qp(q, self.pps.cr_qp_offset)
                           for q in range(52)], np.int32)
        qp = cfg.qp
        qpc = chroma_qp(qp, self.pps.chroma_qp_index_offset)

        def ref_state():
            """Device reference state of the DPB head (used only when no
            dispatch is in flight)."""
            ref = self.refs[0]
            state = getattr(ref, "_state", None)
            if state is None:
                state = getattr(ref, "_dev", None)
            if state is None:
                state = EJ.prep_ref(ref.Y, ref.U, ref.V)
                ref._dev = state
            return state

        from ..ops import cavlc_jax as CJX
        from ..ops.deblock_jax import deblock_jax
        n = self.mb_w * self.mb_h
        qp_arr = jax.device_put(np.full(n, qp, np.int32))
        zeros = jax.device_put(np.zeros(n, np.int32))
        d_cb = jax.device_put(qpc_cb)
        d_cr = jax.device_put(qpc_cr)
        # device-entropy output budget: the gather-based assembler costs
        # O(max_words), so budget ~96 bits/MB on average (~3x the fast
        # path's qp28 rate); rare hotter frames raise the packer's ovf
        # flag and take the host-serializer fallback instead
        max_words = max(4096, n * 2) + 64

        # ONE fused device program per frame for device RD; the composed
        # path below serves md_low (rd=False)
        use_fused = cfg.device_rd

        def dispatch_fused(packed_in, s):
            return EJ.p_frame_rd_pipe(
                packed_in, s[0], s[1], s[2], qp, qpc,
                lambda_me(qp), lambda_mode4(qp), d_cb, d_cr,
                mb_w=self.mb_w, mb_h=self.mb_h, sr=cfg.search_range,
                max_words=max_words)

        def dispatch(Y, U, V, s):
            # composed from separately-jitted (persistently cached)
            # programs: core encode -> bS -> in-loop deblock -> next-ref
            # prep -> device CAVLC slice pack. All
            # dispatches are async; on the happy path only the packed
            # bitstream words ever cross the host boundary.
            core = EJ.p_frame_step(
                Y, U, V, s[0], s[1], s[2], qp, qpc,
                lambda_me(qp), lambda_mode4(qp),
                mb_w=self.mb_w, mb_h=self.mb_h, sr=cfg.search_range,
                rd=cfg.device_rd)
            bs_v, bs_h = EJ.p_frame_bs(core["luma_nnz"], core["mv4"],
                                       mb_w=self.mb_w, mb_h=self.mb_h)
            dY, dU, dV = deblock_jax(
                core["recY"], core["recU"], core["recV"], bs_v, bs_h,
                qp_arr, zeros, zeros, zeros, zeros, zeros, d_cb, d_cr,
                mb_w=self.mb_w, mb_h=self.mb_h)
            state = EJ.prep_ref(dY, dU, dV)
            packed = CJX.pack_p_slice_full(
                core["inter_mode"], core["mv4"], core["cbp"],
                core["luma_scan"], core["luma_nnz"], core["chroma_dc"],
                core["chroma_scan"], core["chroma_nnz"],
                mb_w=self.mb_w, mb_h=self.mb_h, max_words=max_words)
            # flags PREPENDED to the words buffer -> ONE transfer leaf at
            # finalize
            import jax.numpy as jnp
            flags = jnp.stack([
                packed["nbits"].astype(jnp.int32),
                packed["ovf"].astype(jnp.int32),
                core["intra_mask"].any().astype(jnp.int32)])
            words_ext = jnp.concatenate(
                [flags.astype(jnp.uint32), packed["words"]])
            out = {"words_ext": words_ext,
                   "core": core, "skip": packed["skip"]}
            return out, state

        payloads = []
        pending = None      # (out-dict, disp, orig, new_state)
        dev_state = None    # reference state for the NEXT dispatch (the
                            # in-flight frame's deblocked recon)
        frames = list(frames)
        dev_in = [None] * len(frames)

        def _pack_host(fY, fU, fV):
            """Y + side-by-side U|V in ONE buffer: a single H2D leaf
            instead of three device_puts."""
            Y = np.asarray(fY, np.uint8)
            U = np.asarray(fU, np.uint8)
            V = np.asarray(fV, np.uint8)
            buf = np.empty((Y.shape[0] + U.shape[0], Y.shape[1]), np.uint8)
            buf[:Y.shape[0]] = Y
            buf[Y.shape[0]:, :U.shape[1]] = U
            buf[Y.shape[0]:, U.shape[1]:] = V
            return buf

        def _prefetch(k):
            if 0 <= k < len(frames) and dev_in[k] is None:
                # async H2D: overlaps with the in-flight frame's compute
                dev_in[k] = jax.device_put(_pack_host(*frames[k]))
        _prefetch(0)
        _prefetch(1)
        h_pix, w_pix = self.mb_h * 16, self.mb_w * 16
        for fi, f in enumerate(frames):
            _prefetch(fi + 1)
            packed_in = dev_in[fi] if dev_in[fi] is not None else \
                jax.device_put(_pack_host(*f))
            Y = packed_in[:h_pix]
            U = packed_in[h_pix:, :w_pix // 2]
            V = packed_in[h_pix:, w_pix // 2:]
            dev_in[fi] = None
            # coding index of THIS frame (the in-flight frame hasn't
            # bumped frame_idx yet)
            idx = self.frame_idx + (1 if pending is not None else 0)
            intra_due = (cfg.intra_period > 0 and
                         idx % cfg.intra_period == 0)
            if idx == 0 or intra_due or (not self.refs
                                         and pending is None):
                if pending is not None:
                    payloads.append(self._pipe_finalize(*pending)[0])
                    pending = None
                payloads.append(self.encode_frame(
                    *(np.asarray(p, np.uint8) for p in f)))
                dev_state = None
                continue
            disp = self.display_idx
            self.display_idx += 1

            def _go(s):
                if use_fused:
                    return dispatch_fused(packed_in, s)
                return dispatch(Y, U, V, s)

            out, new_state = _go(dev_state if dev_state is not None
                                 else ref_state())
            if pending is not None:
                payload, fell_back = self._pipe_finalize(*pending)
                payloads.append(payload)
                if fell_back:
                    # the speculated reference state was wrong: redo this
                    # frame's dispatch against the corrected DPB head
                    out, new_state = _go(ref_state())
            pending = (out, disp, f, new_state)
            dev_state = new_state
        if pending is not None:
            payloads.append(self._pipe_finalize(*pending)[0])
        return payloads

    def _pipe_finalize(self, out, disp, orig, new_state) -> bytes:
        """Complete a dispatched pipelined P frame. Happy path: download
        ONLY the device-packed CAVLC slice words (ops/cavlc_jax), prepend
        the slice header, EBSP-frame. Fallbacks: intra speculation failed
        -> classic re-encode; entropy-pack overflow -> download the wide
        coefficient tensors and serialize on host."""
        import jax
        # ONE transfer leaf: flags live in the first 3 words of the
        # fixed-shape words buffer. Fetching `words[:k]` instead would
        # build a new XLA slice program per distinct k (a compile per
        # frame); a second flags leaf would be a second transfer.
        ext = jax.device_get(out["words_ext"])
        flags = ext[:3].astype(np.int64)
        words_full = ext[3:]
        small = {"nbits": int(flags[0]), "ovf": bool(flags[1]),
                 "intra_any": bool(flags[2])}
        if bool(small["intra_any"]):
            # rare: finish the frame via the classic path, but REUSE the
            # already-computed device core (no second p_frame_step
            # dispatch): _encode_p_device downloads it, patches the
            # intra-chosen MBs per-MB with recon neighbors and
            # serializes. Restore this frame's own display index (later
            # frames may already have claimed theirs).
            self.pipe_fallbacks["intra_speculation"] += 1
            saved = self.display_idx
            self.display_idx = disp
            self._reuse_core = out["core"]
            try:
                payload = self.encode_frame(*orig)
            finally:
                self._reuse_core = None
            self.display_idx = saved
            return payload, True

        cfg = self.cfg
        qp = cfg.qp
        poc = 2 * (disp - self._idr_disp)
        mv_host = None
        if bool(small["ovf"]):
            self.pipe_fallbacks["entropy_overflow"] += 1
            core = out["core"]
            o = jax.device_get({k: core[k] for k in (
                "inter_mode", "mv4", "luma_scan", "luma_nnz", "cbp",
                "chroma_dc", "chroma_scan", "chroma_nnz")})
            skip = jax.device_get(out["skip"])
            pic = PictureData(self.mb_w, self.mb_h)
            pic.mb_class[:] = MB_INTER
            pic.inter_mode[:] = o["inter_mode"]
            pic.mv[:] = o["mv4"]
            pic.ref_idx[:] = 0
            pic.ref_pic_id[:] = self.refs[0].uid
            pic.pdir[:] = 0
            pic.luma_coef[:] = o["luma_scan"]
            pic.luma_nnz[:] = o["luma_nnz"]
            pic.chroma_dc[:] = o["chroma_dc"]
            pic.chroma_coef[:] = o["chroma_scan"]
            pic.chroma_nnz[:] = o["chroma_nnz"]
            pic.cbp[:] = o["cbp"]
            pic.qp[:] = qp
            pic.slice_id[:] = 0
            pic.skip[:] = skip
            self._last_pipe_pic = pic
            mv_host = (pic.mv.copy(), pic.ref_idx.copy(),
                       pic.mv_l1.copy(), pic.ref_idx_l1.copy(),
                       pic.ref_pic_id.copy(), pic.ref_pic_id_l1.copy())
            slice_bytes = self._serialize_anchor_slices(
                pic, SliceType.P, qp, poc, False, None)
        else:
            from ..bitstream.bitwriter import BitWriter
            from .syntax import write_slice_header
            nbits = int(small["nbits"])
            k = (nbits + 31) // 32
            words = np.asarray(words_full[:k])
            bw = BitWriter()
            write_slice_header(
                bw, self.sps, self.pps, slice_type=SliceType.P,
                frame_num=self.frame_num, idr=False,
                idr_pic_id=self.idr_pic_id, qp=qp, first_mb=0,
                poc_lsb=poc % 256,
                num_ref_idx_l0=self.num_ref_active,
                slice_group_change_cycle=cfg.sg_change_cycle)
            bw.append_bitstream(words.astype(">u4").tobytes(), nbits)
            bw.rbsp_trailing_bits()
            slice_bytes = annexb_bytes(3, NalUnitType.SLICE,
                                       bw.get_bytes())
            self._last_pipe_pic = None

        frame = DeviceFrame(poc=poc, frame_num=self.frame_num,
                            state=new_state)
        frame.uid = self._uid
        self._uid += 1
        if mv_host is not None:
            frame.motion = mv_host
        self._store_ref(frame)
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        self.stats.append({"type": "P", "bits": len(slice_bytes) * 8})
        self.results.append({"disp": disp, "type": "P",
                             "bits": len(slice_bytes) * 8, "frame": frame,
                             "qp": qp})
        return slice_bytes, False

    def _derive_skip_fast(self, pic) -> None:
        """Vectorized P_Skip derivation (spec 8.4.1.1) for the all-inter
        single-slice fast path; identical to the per-MB PredCtx loop
        (tests/test_pipe_stream.py asserts this)."""
        mw, mh = self.mb_w, self.mb_h
        mv = pic.mv.reshape(mh, mw, 16, 2).astype(np.int32)
        # neighbor 4x4 blocks of the MB's (0,0) block: A = left MB blk 3,
        # B = up MB blk 12, C = up-right MB blk 12, D = up-left MB blk 15
        mva = np.zeros((mh, mw, 2), np.int32)
        mva[:, 1:] = mv[:, :-1, 3]
        mvb = np.zeros((mh, mw, 2), np.int32)
        mvb[1:] = mv[:-1, :, 12]
        mvc = np.zeros((mh, mw, 2), np.int32)
        if mh > 1:
            mvc[1:, :-1] = mv[:-1, 1:, 12]
        mvd_ = np.zeros((mh, mw, 2), np.int32)
        if mh > 1 and mw > 1:
            mvd_[1:, 1:] = mv[:-1, :-1, 15]
        has_a = np.zeros((mh, mw), bool)
        has_a[:, 1:] = True
        has_b = np.zeros((mh, mw), bool)
        has_b[1:] = True
        has_c = np.zeros((mh, mw), bool)
        has_c[1:, :-1] = True
        has_d = np.zeros((mh, mw), bool)
        has_d[1:, 1:] = True
        # C unavailable -> D (mv_neighbor fallback in mv_pred)
        mvc = np.where(has_c[..., None], mvc, mvd_)
        has_c_eff = has_c | has_d
        # all refs equal (0) on this path: the directional single-match
        # rule fires iff exactly one neighbor is available
        cnt = (has_a.astype(np.int32) + has_b.astype(np.int32)
               + has_c_eff.astype(np.int32))
        mva_e = np.where(has_a[..., None], mva, 0)
        mvb_e = np.where(has_b[..., None], mvb, 0)
        mvc_e = np.where(has_c_eff[..., None], mvc, 0)
        single = mva_e + mvb_e + mvc_e          # exactly one is nonzero-mask
        med = np.median(np.stack([mva_e, mvb_e, mvc_e]), axis=0) \
            .astype(np.int32)
        pred = np.where((cnt == 1)[..., None], single, med)
        # skip MV = 0 when A/B missing or zero-motion with ref 0 (8.4.1.1)
        a_zero = ~has_a | ((mva == 0).all(-1))
        b_zero = ~has_b | ((mvb == 0).all(-1))
        skip_mv = np.where((a_zero | b_zero)[..., None], 0, pred)
        cand = ((pic.cbp == 0) & (pic.inter_mode == 0)
                & (pic.mb_class == MB_INTER)
                & (pic.ref_idx[:, 0] == 0)).reshape(mh, mw)
        eq = (mv[:, :, 0] == skip_mv).all(-1)
        pic.skip[:] = (cand & eq).reshape(-1)

    def _emit_group(self) -> bytes:
        disp, Y, U, V = self._pending[-1]
        bs = self._pending[:-1]
        self._pending = []
        prev_anchor = self.refs[0]
        out = self._emit_anchor(Y, U, V, disp)
        next_anchor = self.refs[0]
        if self.cfg.explicit_gop and bs:
            out += self._emit_b_explicit(bs)
        elif self.cfg.hierarchical and bs:
            out += self._emit_b_pyramid(bs, 0, len(bs) - 1, 1)
        else:
            for bdisp, bY, bU, bV in bs:
                out += self._emit_b(bY, bU, bV, bdisp, prev_anchor,
                                    next_anchor)
        return out

    def _emit_b_explicit(self, bs) -> bytes:
        """ExplicitHierarchyFormat coding order (explicit_gop.c twin):
        entries name the B positions, reference-ness and QP offsets."""
        from .gop import parse_explicit_hierarchy
        out = b""
        for e in parse_explicit_hierarchy(self.cfg.explicit_gop):
            if e.display_no >= len(bs):
                continue                 # trailing partial mini-GOP
            disp, Y, U, V = bs[e.display_no]
            poc = 2 * (disp - self._idr_disp)
            lower = [f for f in self.refs if f.poc < poc]
            higher = [f for f in self.refs if f.poc > poc]
            l0 = max(lower, key=lambda f: f.poc)
            l1 = min(higher, key=lambda f: f.poc) if higher \
                else max(lower, key=lambda f: f.poc)
            out += self._emit_b(Y, U, V, disp, l0, l1, as_ref=e.as_ref,
                                qp_offset=e.qp_offset)
        return out

    def _emit_b_pyramid(self, bs, lo: int, hi: int, layer: int) -> bytes:
        """Dyadic B pyramid (lencod pred_struct.c temporal layers /
        explicit_gop.c B-strings): the middle picture of each interval is
        coded first as a *reference* B; leaves are non-reference. L0/L1
        references are the nearest DPB entries by POC, matching the
        decoder's default ref_lists_b order so no reorder commands are
        needed."""
        if lo > hi:
            return b""
        mid = (lo + hi) // 2
        disp, Y, U, V = bs[mid]
        poc = 2 * (disp - self._idr_disp)
        # nearest references by POC (long-term anchors allowed: _emit_b
        # emits reorder commands when the pick is not at default index 0)
        l0 = max((f for f in self.refs if f.poc < poc),
                 key=lambda f: f.poc)
        l1 = min((f for f in self.refs if f.poc > poc),
                 key=lambda f: f.poc)
        out = self._emit_b(Y, U, V, disp, l0, l1,
                           as_ref=(hi > lo), layer=layer)
        out += self._emit_b_pyramid(bs, lo, mid - 1, layer + 1)
        out += self._emit_b_pyramid(bs, mid + 1, hi, layer + 1)
        return out

    # ---- field (PAFF) encoding: E42 encode side -----------------------

    def _field_ref_list(self, parity: int) -> list:
        """Initial P-field list0 (spec 8.2.4.2.2 + 8.2.4.2.5), the
        encoder twin of decoder._field_ref_list_p: short-term fields in
        frame units by FrameNumWrap descending, parities interleaved
        starting with the current parity."""
        max_fn = self.sps.max_frame_num
        cur_fn = self.frame_num

        def fnw(f):
            return (f.frame_num - max_fn if f.frame_num > cur_fn
                    else f.frame_num)
        units: dict = {}
        for f in self.refs:
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

    def _encode_field_pair(self, Y, U, V, disp: int) -> bytes:
        """Code one display frame as two field pictures (top then
        bottom), the E42 encode path (lencod image.c:751
        perform_encode_field; field splitting frame_picture_*
        imagedata.c)."""
        Y = np.asarray(Y, np.uint8)
        U = np.asarray(U, np.uint8)
        V = np.asarray(V, np.uint8)
        out = b""
        for parity in (0, 1):
            out += self._encode_field(Y[parity::2], U[parity::2],
                                      V[parity::2], disp, parity)
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        return out

    def _encode_field(self, Y, U, V, disp: int, parity: int) -> bytes:
        from . import residual_np as RN
        cfg = self.cfg
        intra_due = (cfg.intra_period > 0 and
                     self.frame_idx % cfg.intra_period == 0)
        is_idr = parity == 0 and (self.frame_idx == 0 or intra_due)
        stype = SliceType.I if is_idr else SliceType.P
        if is_idr:
            self.frame_num = 0
            self._idr_disp = disp
            self.refs = []
        poc = 2 * (disp - self._idr_disp) + parity
        qp = cfg.qp

        refs_list = None
        if stype == SliceType.P:
            full = self._field_ref_list(parity)
            self.num_ref_active = max(1, min(2 * cfg.num_ref, len(full)))
            refs_list = full[:self.num_ref_active]

        fe = _FrameEncoder(self, stype, Y, U, V)
        fe.cur_parity = parity
        fe.refs_list = refs_list
        fe.qp = qp
        fe.qpc = chroma_qp(qp, self.pps.chroma_qp_index_offset)
        fe.lam = lambda_me(qp)
        fe.lam4 = lambda_mode4(qp)
        RN.set_field_scan(True)
        try:
            pic = fe.encode()
        finally:
            RN.set_field_scan(False)
        pic.field_mode = True            # field scan + field deblock rules
        recY, recU, recV = fe.recY.copy(), fe.recU.copy(), fe.recV.copy()
        if cfg.deblock:
            self._deblock(recY, recU, recV, pic)
        RN.set_field_scan(True)
        try:
            slice_bytes = self._serialize_field_slice(
                pic, stype, qp, poc, is_idr, parity)
        finally:
            RN.set_field_scan(False)
        self._last_fe = fe

        frame = Frame(poc=poc, frame_num=self.frame_num,
                      Y=recY, U=recU, V=recV)
        frame.parity = parity
        frame.uid = self._uid
        self._uid += 1
        frame.motion = (pic.mv.copy(), pic.ref_idx.copy(),
                        pic.mv_l1.copy(), pic.ref_idx_l1.copy(),
                        pic.ref_pic_id.copy(), pic.ref_pic_id_l1.copy())
        # store the field; sliding window over FRAME units (a
        # complementary pair counts one unit — the exact mirror of the
        # decoder's _finish_field / mbuffer.c, so encoder and decoder
        # agree on which fields remain referenceable)
        self.refs.insert(0, frame)
        units = []
        for f in self.refs:                  # newest first
            if units and f.frame_num == units[-1][0].frame_num \
                    and len(units[-1]) == 1 \
                    and f.parity != units[-1][0].parity:
                units[-1].append(f)
            else:
                units.append([f])
        cap = max(1, self.sps.max_num_ref_frames)
        while len(units) > cap:
            for f in units.pop():            # oldest unit
                self.refs.remove(f)

        payload = b""
        if is_idr:
            payload += annexb_bytes(3, NalUnitType.SPS, write_sps(self.sps))
            payload += annexb_bytes(3, NalUnitType.PPS, write_pps(self.pps))
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        payload += slice_bytes
        label = "I" if is_idr else "P"
        self.stats.append({"type": label, "bits": len(payload) * 8})
        self.results.append({"disp": disp, "type": label, "parity": parity,
                             "bits": len(payload) * 8, "frame": frame,
                             "qp": qp})
        return payload

    def _serialize_field_slice(self, pic, stype, qp, poc, is_idr,
                               parity) -> bytes:
        idr_id = (self.idr_pic_id - 0) % 65536
        rbsp = serialize_slice(
            pic, self.sps, self.pps, slice_type=stype,
            frame_num=self.frame_num, idr=is_idr, qp=qp,
            idr_pic_id=idr_id,
            poc_lsb=poc % (1 << (self.sps.log2_max_pic_order_cnt_lsb_minus4
                                 + 4)),
            num_ref_idx_l0=getattr(self, "num_ref_active", 1),
            field_pic=1, bottom_field=parity)
        nal_type = NalUnitType.IDR if is_idr else NalUnitType.SLICE
        return annexb_bytes(3, nal_type, rbsp)

    def _emit_anchor(self, Y, U, V, disp: int, force=None) -> bytes:
        cfg = self.cfg
        intra_due = (cfg.intra_period > 0 and
                     self.frame_idx % cfg.intra_period == 0)
        is_first = self.frame_idx == 0
        is_intra = is_first or intra_due
        # with B pictures, periodic intra anchors are open-GOP I slices
        # (IDR would invalidate list-0 references of preceding-in-display Bs)
        is_idr = is_first or (cfg.num_b == 0 and intra_due)
        if force is not None:
            # explicit sequence scripting (gop.encode_explicit_seq)
            is_intra = bool(force.get("intra", is_intra))
            is_idr = bool(force.get("idr", is_idr)) and is_intra
        stype = SliceType.I if is_intra else SliceType.P
        if (cfg.sp_periodicity > 0 and stype == SliceType.P
                and self.frame_idx % cfg.sp_periodicity == 0):
            stype = SliceType.SP     # I-P-..-SP cadence (lencod.c SP cycle)
        if is_idr:
            self.frame_num = 0  # spec 7.4.3: IDR pictures have frame_num 0
            self._idr_disp = disp
        poc = 2 * (disp - self._idr_disp)
        self._cur_poc = poc
        if self.rc is not None:
            if is_intra:
                # nominal GOP horizon for streaming allocation
                gop_anchors = cfg.intra_period if cfg.intra_period > 0 else 32
                self.rc.init_gop(gop_anchors - 1,
                                 gop_anchors * cfg.num_b)
            qp = self.rc.pict_qp("I" if is_intra else "P")
        else:
            qp = cfg.qp if (is_intra or cfg.qp_p is None) else cfg.qp_p
        if stype == SliceType.SP:
            qp = cfg.qp_sp

        self.num_ref_active = max(1, min(cfg.num_ref, len(self.refs)))
        wp_l0 = None
        wp = None
        forced_intra = set()
        if stype in (SliceType.P, SliceType.SP):
            forced_intra = self._refresh_set()
            if cfg.weighted_pred:
                from .wp_est import (build_wp_params, estimate_explicit,
                                     estimate_lms, estimate_mc_iter)
                refs = self._ref_list_p()
                if cfg.wp_iter_mc > 0:
                    wp_l0 = estimate_mc_iter(Y, U, V, refs,
                                             iters=cfg.wp_iter_mc)
                else:
                    est = estimate_lms if cfg.wp_method == 1 \
                        else estimate_explicit
                    wp_l0 = est(Y, U, V, refs)
                wp = build_wp_params(SliceType.P, self.pps, refs, [],
                                     poc, wp_l0=wp_l0)
        # long-term marking policy (E24): every Nth anchor becomes the
        # long-term anchor (IDR via long_term_reference_flag, P via MMCO
        # op 4 (cap index) + op 6 (current -> long-term idx 0))
        lt_mark = (cfg.long_term_period > 0
                   and self.frame_idx % cfg.long_term_period == 0)
        long_term_flag = 1 if (lt_mark and is_idr) else 0
        mmco_ops = ((4, 1), (6, 0)) if (lt_mark and not is_idr) else None
        poc_victim = None
        if cfg.poc_mem_mgmt == 1 and not is_idr and mmco_ops is None:
            mmco_ops, poc_victim = self._poc_mmco()
        cra_victims = []
        if (cfg.mmco_policy == "cra" and mmco_ops is None and not is_idr
                and stype != SliceType.I
                and getattr(self, "_cra_poc", None) is not None):
            # cra_ref_management_frame_pic (mmco.c:151): unmark every
            # short-term reference from before the last open-GOP I
            max_fn = self.sps.max_frame_num
            ops = []
            for f in self.refs:
                if f.is_long_term or f.poc >= self._cra_poc:
                    continue
                t = f.frame_num if f.frame_num <= self.frame_num \
                    else f.frame_num - max_fn
                ops.append((1, self.frame_num - t - 1))
                cra_victims.append(f)
            if ops:
                mmco_ops = tuple(ops)
                self._cra_poc = None
        if is_intra and not is_idr:
            self._cra_poc = poc      # open-GOP random access point
        ref_mod_l0 = (self._poc_reorder_cmds()
                      if cfg.ref_reorder == 1
                      and stype in (SliceType.P, SliceType.SP)
                      else None)

        # multi-pass RD picture decision (E4, lencod image_mp.c
        # frame_picture_mp_* + rdpicdecision.c rd_pic_decision): trial the
        # picture at QP and QP+-1, keep the minimum frame-level J
        qps = [qp]
        if cfg.rd_picture_decision and self.frame_idx > 0 \
                and self.rc is None:
            qps = [qp, max(0, qp - 1), min(51, qp + 1)]
        trials = [(q, wp_l0, wp) for q in qps]
        if (cfg.wp_mcprec and cfg.weighted_pred and wp is not None
                and stype == SliceType.P and self.rc is None):
            # WPMCPrecision passes (wp_mcprec.c wpxInitWPXPasses via
            # RDPictureDecision, image.c:1281-1286): also trial the
            # offset-only table and the default (no-op) weights; the
            # frame-level J decides which coding ships
            from .wp_est import build_wp_params as _bwp
            from .wp_est import estimate_lms as _elms
            refs_w = self._ref_list_p()
            wp_off = _elms(Y, U, V, refs_w, select_offset=1)
            trials.append((qp, wp_off,
                           _bwp(SliceType.P, self.pps, refs_w, [], poc,
                                wp_l0=wp_off)))
            dflt = [{"luma": (32, 0), "chroma": ((32, 0), (32, 0))}
                    for _ in refs_w]
            trials.append((qp, dflt,
                           _bwp(SliceType.P, self.pps, refs_w, [], poc,
                                wp_l0=dflt)))
        best = None
        for q, wp_l0, wp in trials:
            def _encode_once(q=q, wp=wp):
                fe = _FrameEncoder(self, stype, Y, U, V)
                fe.forced_intra = forced_intra
                fe.wp = wp
                fe.qp = q
                fe.qpc = chroma_qp(q, self.pps.chroma_qp_index_offset)
                fe.lam = lambda_me(q)
                fe.lam4 = lambda_mode4(q)
                if (self.rc is not None and cfg.rc_basic_unit > 0
                        and stype == SliceType.P and self.rc.target > 0):
                    from ..ratectl import BasicUnitRC
                    fe.burc = BasicUnitRC(q, self.rc.target,
                                          self.mb_w * self.mb_h,
                                          cfg.rc_basic_unit)
                return fe, fe.encode()

            if cfg.slice_mode == 2 and cfg.slice_argument > 0:
                fe, pic, slice_bytes = self._fit_byte_slices(
                    _encode_once,
                    lambda fe_, pic_, sizes, q=q: self._serialize_anchor_slices(
                        pic_, stype, q, poc, is_idr, wp_l0,
                        long_term_flag=long_term_flag, mmco_ops=mmco_ops,
                        ref_mod_l0=ref_mod_l0, sizes_out=sizes))
                recY, recU, recV = fe.recY.copy(), fe.recU.copy(), fe.recV.copy()
                if cfg.deblock:
                    self._deblock(recY, recU, recV, pic)
            else:
                fe, pic = _encode_once()
                recY, recU, recV = fe.recY.copy(), fe.recU.copy(), fe.recV.copy()
                if cfg.deblock:
                    self._deblock(recY, recU, recV, pic)
                slice_bytes = self._serialize_anchor_slices(
                    pic, stype, q, poc, is_idr, wp_l0,
                    long_term_flag=long_term_flag, mmco_ops=mmco_ops,
                    ref_mod_l0=ref_mod_l0)
            if len(trials) == 1:
                best = (0.0, q, pic, recY, recU, recV, slice_bytes)
                break
            from .rdo import lambda_mode
            ssd = (np.square(np.asarray(Y, np.int64) - recY).sum()
                   + np.square(np.asarray(U, np.int64) - recU).sum()
                   + np.square(np.asarray(V, np.int64) - recV).sum())
            j = float(ssd) + lambda_mode(qp) * 8 * len(slice_bytes)
            if best is None or j < best[0]:
                best = (j, q, pic, recY, recU, recV, slice_bytes)
        _j, qp, pic, recY, recU, recV, slice_bytes = best
        self._last_fe = fe     # introspection (tests, trace tooling)

        frame = Frame(poc=poc, frame_num=self.frame_num,
                      Y=recY, U=recU, V=recV)
        frame.uid = self._uid
        self._uid += 1
        # motion field for direct modes of dependent B pictures (mirrors
        # the decoder's Frame.motion tuple)
        frame.motion = (pic.mv.copy(), pic.ref_idx.copy(),
                        pic.mv_l1.copy(), pic.ref_idx_l1.copy(),
                        pic.ref_pic_id.copy(), pic.ref_pic_id_l1.copy())
        # the redundant coding references what the primary referenced
        # (the decoder's DPB state when the primary is LOST)
        redundant_refs = (self._ref_list_p()[:1]
                          if cfg.redundant_period
                          and stype == SliceType.P else [])
        if is_idr:
            self.refs = []
        if poc_victim is not None:
            # the decoder executes the MMCO before storing the current
            # picture (spec 8.2.5.4.1); mirror that marking here
            self.refs.remove(poc_victim)
        for f in cra_victims:
            self.refs.remove(f)
        self._store_ref(frame, long_term=lt_mark)
        if self.errdo is not None:   # advance the simulated lossy decoders
            self.errdo.update(pic, recY, self.mb_w, is_ref=True)

        # serialize
        payload = b""
        if is_idr:
            payload += annexb_bytes(3, NalUnitType.SPS, write_sps(self.sps))
            if cfg.num_views == 2:
                from .syntax import write_subset_sps
                payload += annexb_bytes(3, NalUnitType.SUBSET_SPS,
                                        write_subset_sps(self.sps))
            payload += annexb_bytes(3, NalUnitType.PPS, write_pps(self.pps))
        sei_msgs = []
        if is_idr and cfg.sei_user_data is not None:
            from .sei_write import user_data_unregistered
            sei_msgs.append(user_data_unregistered(cfg.sei_user_data))
        if is_intra and not is_idr and cfg.sei_recovery_point:
            # open-GOP random access point (lencod.c:999 EnableOpenGOP)
            from .sei_write import recovery_point
            sei_msgs.append(recovery_point(0, exact_match=True))
        if sei_msgs:
            from .sei_write import build_sei_rbsp
            payload += annexb_bytes(0, NalUnitType.SEI,
                                    build_sei_rbsp(sei_msgs))
        if cfg.num_views == 2:
            # prefix NAL (type 14) announcing the base view (H.7.4.1;
            # lencod.c writes one per base VCL NALU)
            from ..bitstream.nal import mvc_ext_bytes
            payload += annexb_bytes(
                3, NalUnitType.PREFIX, b"",
                mvc_ext=mvc_ext_bytes(0 if is_idr else 1, 0,
                                      1 if is_idr else 0, 1))
        payload += slice_bytes
        if (cfg.redundant_period and stype == SliceType.P
                and self.frame_idx % cfg.redundant_period == 0):
            payload += self._emit_redundant(Y, U, V, poc, qp,
                                            redundant_refs)
        if cfg.num_views == 2:
            payload += self._emit_view1(disp, frame, poc, self.frame_num,
                                        anchor=is_idr)

        if is_idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        self.frame_idx += 1
        label = "I" if is_intra else "P"
        if self.rc is not None:
            mad = float(np.abs(np.asarray(Y, np.int32) -
                               recY.astype(np.int32)).mean())
            self.rc.update(label, qp, len(payload) * 8, mad)
        self.stats.append({"type": label, "bits": len(payload) * 8})
        self.results.append({"disp": disp, "type": label,
                             "bits": len(payload) * 8, "frame": frame,
                             "qp": qp})
        return payload

    def _emit_redundant(self, Y, U, V, poc: int, qp_primary: int,
                        refs) -> bytes:
        """Redundant coded picture (E34; lencod.c:2225-2352): an
        independent P coding of the SAME frame at a coarser QP against
        the pre-primary references, emitted with redundant_pic_cnt=1.
        Decoders that received the primary discard it; on primary loss
        they decode this instead (loss resilience, tested through the
        RTP fault injector)."""
        cfg = self.cfg
        qp_r = min(51, qp_primary + cfg.redundant_qp_off)
        if not refs:
            return b""
        fe = _FrameEncoder(self, SliceType.P, Y, U, V)
        fe.refs_list = refs[:1]
        fe.qp = qp_r
        fe.qpc = chroma_qp(qp_r, self.pps.chroma_qp_index_offset)
        fe.lam = lambda_me(qp_r)
        fe.lam4 = lambda_mode4(qp_r)
        pic = fe.encode()
        # nal_ref_idc=0 + no dec_ref_pic_marking: the non-reference
        # marking is what lets is_new_picture (ldecod image.c:2276)
        # close the primary picture before the redundant slices arrive
        rbsp = serialize_slice(
            pic, self.sps, self.pps, slice_type=SliceType.P,
            frame_num=self.frame_num, idr=False, qp=qp_r,
            poc_lsb=poc % (1 << (self.sps.log2_max_pic_order_cnt_lsb_minus4
                                 + 4)),
            num_ref_idx_l0=1, redundant_pic_cnt=1, is_ref=False)
        return annexb_bytes(0, NalUnitType.SLICE, rbsp)

    def _ref_mod_ops(self, default_list, target):
        """One ref_pic_list_modification command putting `target` at
        index 0 (spec 8.2.4.3), or None when it already is."""
        if default_list and default_list[0] is target:
            return None
        if target.is_long_term:
            return [(2, target.long_term_frame_idx)]
        max_fn = self.sps.max_frame_num
        cur = self.frame_num
        t = target.frame_num if target.frame_num <= cur \
            else target.frame_num - max_fn
        diff = cur - t
        return [(0, diff - 1)] if diff > 0 else [(1, -diff - 1)]

    def _serialize_anchor_slices(self, pic, stype, qp, poc, is_idr,
                                 wp_l0, long_term_flag=0,
                                 mmco_ops=None, ref_mod_l0=None,
                                 sizes_out=None) -> bytes:
        cfg = self.cfg
        common = dict(slice_type=stype, frame_num=self.frame_num, idr=is_idr,
                      qp=qp, idr_pic_id=self.idr_pic_id,
                      qs=cfg.qp_sp2 if stype == SliceType.SP else 0,
                      num_ref_idx_l0=self.num_ref_active,
                      poc_lsb=poc % 256, wp_l0=wp_l0,
                      long_term_flag=long_term_flag, mmco_ops=mmco_ops,
                      ref_mod_l0=ref_mod_l0,
                      slice_group_change_cycle=cfg.sg_change_cycle)
        nal_type = NalUnitType.IDR if is_idr else NalUnitType.SLICE
        use_dp = (cfg.data_partition and not is_idr
                  and cfg.entropy == "cavlc")
        out = b""
        pic_bins = 0
        for sid, addrs in enumerate(self.slice_plan):
            if use_dp:
                from .syntax import serialize_slice_dp
                parts = serialize_slice_dp(pic, self.sps, self.pps,
                                           slice_id=sid, mb_addrs=addrs,
                                           **common)
                unit = b""
                for ptype, rbsp in zip((NalUnitType.DPA, NalUnitType.DPB,
                                        NalUnitType.DPC), parts):
                    if rbsp:
                        unit += annexb_bytes(3, ptype, rbsp)
                if sizes_out is not None:
                    sizes_out.append(len(unit) - 4)
                out += unit
                continue
            if cfg.entropy == "cabac":
                rbsp, bins = self._serialize_cabac_best_init(
                    pic, stype, mb_addrs=addrs, **common)
                pic_bins += bins
            else:
                rbsp = serialize_slice(pic, self.sps, self.pps,
                                       mb_addrs=addrs, **common)
            unit = annexb_bytes(3, nal_type, rbsp)
            if sizes_out is not None:
                # JM's size check counts NALU bytes without the startcode
                # (slice.c:524 len_in_bytes)
                sizes_out.append(len(unit) - 4)
            out += unit
        if cfg.entropy == "cabac":
            out += self._cabac_zero_words(out, pic_bins)
        return out

    def _fit_byte_slices(self, encode_once, serialize_once):
        """SliceMode 2: byte-budgeted slices with recode-on-overflow
        (lencod slice.c:524-547). The reference recodes one MB into a
        fresh slice when the running slice exceeds SliceArgument bytes;
        in the two-phase design the whole picture is cheap to re-encode,
        so the slice plan is re-derived from actual serialized sizes and
        the picture re-coded until every slice fits (or is a single MB —
        a slice can never be smaller). Slice boundaries feed back into
        prediction availability / entropy restarts exactly as a decoder
        will see them."""
        limit = self.cfg.slice_argument
        saved_plan = self.slice_plan
        # mode-2 starts from whole slice groups
        plan = [list(a) for a in self._build_slice_plan()]
        fe = pic = payload = None
        for _ in range(12):
            self.slice_plan = plan
            fe, pic = encode_once()
            sizes = []
            payload = serialize_once(fe, pic, sizes)
            new_plan, changed = [], False
            for addrs, sz in zip(plan, sizes):
                if sz <= limit or len(addrs) == 1:
                    new_plan.append(addrs)
                    continue
                changed = True
                k = max(1, int(len(addrs) * limit / sz * 0.92))
                new_plan.extend(addrs[i:i + k]
                                for i in range(0, len(addrs), k))
            if not changed:
                break
            plan = new_plan
        self.slice_plan = saved_plan
        return fe, pic, payload

    def _cabac_zero_words(self, vcl_payload: bytes, pic_bins: int) -> bytes:
        """Clause 7.4.2.10 bin-to-byte constraint: append cabac_zero_word
        (EBSP 00 00 03) stuffing after the picture's last VCL NALU when
        the arithmetic coder processed more bins than 96/1024 per coded
        byte allows (lencod/src/nal.c:116 addCabacZeroWords)."""
        # RawMbBits for 8-bit video: 256*8 luma + chroma samples * 8
        crows = 16 if self.sps.chroma_format_idc == 2 else 8
        raw_mb_bits = 256 * 8 + 2 * 8 * crows * 8
        n_mbs = self.mb_w * self.mb_h
        min_bytes = (96 * pic_bins - raw_mb_bits * n_mbs * 3 + 1023) // 1024
        # NumBytesInVclNALunits: NAL header + EBSP, no startcodes (JM
        # nalu->len + 1, slice.c:390); our payload uses 4-byte startcodes
        vcl_bytes = len(vcl_payload) - 3 * len(self.slice_plan)
        if min_bytes <= vcl_bytes:
            return b""
        return b"\x00\x00\x03" * ((min_bytes - vcl_bytes + 2) // 3)

    def _serialize_cabac_best_init(self, pic, stype, **kw):
        """CABAC slice serialization with per-slice context-init model
        selection (lencod ContextInitMethod=1, context_ini.c
        GetCtxModelNumber:245). JM estimates the best of the 3 P/B init
        models from the previous picture's final context states; here the
        slice is a pure function of the SoA, so the exact answer is
        affordable: serialize under each model and keep the shortest."""
        from .syntax_cabac import serialize_slice_cabac
        stats = {}
        if stype == SliceType.I or not self.cfg.cabac_adapt_init:
            rbsp = serialize_slice_cabac(pic, self.sps, self.pps,
                                         stats=stats, **kw)
            return rbsp, stats["bins"]
        best = None
        best_bins = 0
        for idc in range(3):
            rbsp = serialize_slice_cabac(pic, self.sps, self.pps,
                                         cabac_init_idc=idc, stats=stats,
                                         **kw)
            if best is None or len(rbsp) < len(best):
                best = rbsp
                best_bins = stats["bins"]
        return best, best_bins

    def _emit_view1(self, disp: int, v0_frame: Frame, poc: int,
                    frame_num: int, anchor: bool, b_anchors=None,
                    as_ref: bool = True, qp_view=None) -> bytes:
        """Encode + serialize the dependent-view picture of the current
        access unit (E40; lencod.c:894-952 view-interleaved loop).

        Anchor AUs (base IDR): P slice predicting ONLY from the view-0
        picture (inter-view, H.8.2); the view-1 ref list flushes.
        Non-anchor P AUs: temporal view-1 refs + the view-0 picture
        appended (the decoder's default MVC list order). B AUs: temporal
        view-1 anchors only (inter_view_flag=0 conformant choice)."""
        from ..bitstream.nal import mvc_ext_bytes
        cfg = self.cfg
        Y1, U1, V1 = self._v1_pending.pop(disp)
        qp1 = max(0, min(51, (qp_view if qp_view is not None else cfg.qp)
                         + cfg.view1_qp_offset))
        stype = SliceType.B if b_anchors else SliceType.P
        fe = _FrameEncoder(self, stype, Y1, U1, V1)
        fe.is_view1 = True
        fe.qp = qp1
        fe.qpc = chroma_qp(qp1, self.pps.chroma_qp_index_offset)
        fe.lam = lambda_me(qp1)
        fe.lam4 = lambda_mode4(qp1)
        ref_mod_l0 = ref_mod_l1 = None
        if stype == SliceType.B:
            from ..decoder.b_slice import ColMotion, ref_lists_b
            v1_prev = self._v1_of[b_anchors[0].uid]
            v1_next = self._v1_of[b_anchors[1].uid]
            fe.refs_list = [v1_prev]
            fe.refs_list1 = [v1_next]
            mv0, r0, mv1, r1, rp0, rp1 = v1_next.motion
            fe.b_col = ColMotion(mv0, r0, mv1, r1, self.mb_w,
                                 v1_next.is_long_term, rp0, rp1)
            nref = 1
        elif anchor:
            self.refs_v1 = []                  # IDR flush for the view
            fe.refs_list = [v0_frame]
            nref = 1
        else:
            # non-anchor: inter-view ref FIRST via a reorder command
            # (modification_of_pic_nums_idc 5, H.8.2.2.3) so the decoder's
            # list matches regardless of its DPB depth, then temporal refs
            nact = max(1, min(cfg.num_ref, len(self.refs_v1)))
            fe.refs_list = [v0_frame] + list(self.refs_v1[:nact])
            nref = len(fe.refs_list)
            ref_mod_l0 = [(5, 0)]          # abs_diff_view_idx_minus1 = 0
        save_nact = self.num_ref_active
        self.num_ref_active = nref
        try:
            pic = fe.encode()
        finally:
            self.num_ref_active = save_nact
        recY, recU, recV = fe.recY.copy(), fe.recU.copy(), fe.recV.copy()
        if cfg.deblock:
            self._deblock(recY, recU, recV, pic)
        v1f = Frame(poc=poc, frame_num=frame_num, Y=recY, U=recU, V=recV,
                    is_ref=as_ref)
        if as_ref:
            v1f.uid = self._uid
            self._uid += 1
            v1f.motion = (pic.mv.copy(), pic.ref_idx.copy(),
                          pic.mv_l1.copy(), pic.ref_idx_l1.copy(),
                          pic.ref_pic_id.copy(), pic.ref_pic_id_l1.copy())
            # mirror the decoder's dpb1 sliding window exactly
            # (reference Bs enter the window too)
            self.refs_v1.insert(0, v1f)
            del self.refs_v1[self.dpb_size:]
            self._v1_of[v0_frame.uid] = v1f
        if stype == SliceType.B:
            from ..decoder.b_slice import ref_lists_b
            d0, d1 = ref_lists_b(self.refs_v1, poc)
            ref_mod_l0 = self._ref_mod_ops(d0, fe.refs_list[0])
            ref_mod_l1 = self._ref_mod_ops(d1, fe.refs_list1[0])
        common = dict(slice_type=stype, frame_num=frame_num,
                      idr=anchor, qp=qp1, idr_pic_id=self.idr_pic_id,
                      poc_lsb=poc % 256, ref_mod_l0=ref_mod_l0,
                      num_ref_idx_l0=nref, wp_l0=None,
                      slice_group_change_cycle=cfg.sg_change_cycle)
        if stype == SliceType.B:
            common["ref_mod_l0"] = ref_mod_l0
            common.update(num_ref_idx_l1=1, is_ref=as_ref,
                          ref_mod_l1=ref_mod_l1)
        ext = mvc_ext_bytes(0 if anchor else 1, 1,
                            1 if anchor else 0, 0)
        nri = 3 if (as_ref and stype != SliceType.B) else (2 if as_ref
                                                           else 0)
        out = b""
        pic_bins = 0
        for addrs in self.slice_plan:
            if cfg.entropy == "cabac":
                rbsp, bins = self._serialize_cabac_best_init(
                    pic, stype, mb_addrs=addrs, **common)
                pic_bins += bins
            else:
                rbsp = serialize_slice(pic, self.sps, self.pps,
                                       mb_addrs=addrs, **common)
            out += annexb_bytes(nri, NalUnitType.SLICE_EXT, rbsp,
                                mvc_ext=ext)
        if cfg.entropy == "cabac":
            out += self._cabac_zero_words(out, pic_bins)
        return out

    def _emit_b(self, Y, U, V, disp: int, prev_anchor: Frame,
                next_anchor: Frame, as_ref: bool = False,
                layer: int = 1, qp_offset: int | None = None) -> bytes:
        """Encode one B picture between two references (non-reference by
        default; reference B inside a hierarchical pyramid)."""
        from ..decoder.b_slice import ColMotion
        cfg = self.cfg
        poc = 2 * (disp - self._idr_disp)
        self._cur_poc = poc
        if self.rc is not None:
            qp_b = self.rc.pict_qp("B")
        elif qp_offset is not None:      # explicit GOP per-entry offset
            qp_b = max(0, min(51, cfg.qp + qp_offset))
        else:
            qp_b = cfg.qp_b if cfg.qp_b is not None else cfg.qp + 2
            qp_b = min(51, qp_b + max(0, layer - 1))  # temporal-layer offset

        wp_l0 = wp_l1 = None
        wp_params = None
        if cfg.weighted_bipred:
            from .wp_est import (build_wp_params, estimate_explicit,
                                 estimate_lms)
            est_b = estimate_lms if cfg.wp_method == 1 \
                else estimate_explicit
            if cfg.weighted_bipred == 1:
                wp_l0 = est_b(Y, U, V, [prev_anchor])
                wp_l1 = est_b(Y, U, V, [next_anchor])
            wp_params = build_wp_params(SliceType.B, self.pps, [prev_anchor],
                                        [next_anchor], poc,
                                        wp_l0=wp_l0, wp_l1=wp_l1)

        def _encode_once():
            fe = _FrameEncoder(self, SliceType.B, Y, U, V)
            fe.qp = qp_b
            fe.qpc = chroma_qp(qp_b, self.pps.chroma_qp_index_offset)
            fe.lam = lambda_me(qp_b)
            fe.lam4 = lambda_mode4(qp_b)
            fe.refs_list = [prev_anchor]
            fe.refs_list1 = [next_anchor]
            fe.wp = wp_params
            mv0, r0, mv1, r1, rp0, rp1 = next_anchor.motion
            fe.b_col = ColMotion(mv0, r0, mv1, r1, self.mb_w,
                                 next_anchor.is_long_term, rp0, rp1)
            return fe, fe.encode()

        def _finalize(fe, pic):
            """deblock + DPB store + B ref-list modification commands;
            yields the slice-header fields for serialization."""
            recY, recU, recV = fe.recY.copy(), fe.recU.copy(), fe.recV.copy()
            if cfg.deblock:
                self._deblock(recY, recU, recV, pic)
            frame = Frame(poc=poc, frame_num=self.frame_num,
                          Y=recY, U=recU, V=recV, is_ref=as_ref)
            if as_ref:
                frame.uid = self._uid
                self._uid += 1
                frame.motion = (pic.mv.copy(), pic.ref_idx.copy(),
                                pic.mv_l1.copy(), pic.ref_idx_l1.copy(),
                                pic.ref_pic_id.copy(),
                                pic.ref_pic_id_l1.copy())
                self._store_ref(frame)
            # the decoder's default B lists are POC-ordered short-term + LT
            # tail (ref_lists_b); when our chosen anchors are not at index
            # 0 (a long-term anchor dropped out of the short-term
            # ordering), emit ref_pic_list_modification commands
            from ..decoder.b_slice import ref_lists_b
            d0, d1 = ref_lists_b(self.refs, poc)
            ref_mod_l0 = self._ref_mod_ops(d0, prev_anchor)
            ref_mod_l1 = self._ref_mod_ops(d1, next_anchor)
            common = dict(slice_type=SliceType.B, frame_num=self.frame_num,
                          idr=False, qp=qp_b, poc_lsb=poc % 256,
                          num_ref_idx_l0=1, num_ref_idx_l1=1, is_ref=as_ref,
                          wp_l0=wp_l0, wp_l1=wp_l1,
                          ref_mod_l0=ref_mod_l0, ref_mod_l1=ref_mod_l1,
                          slice_group_change_cycle=cfg.sg_change_cycle)
            return frame, common, (recY, recU, recV)

        def _serialize_once(pic_, common, sizes=None):
            payload = b""
            pic_bins = 0
            for addrs in self.slice_plan:
                if cfg.entropy == "cabac":
                    rbsp, bins = self._serialize_cabac_best_init(
                        pic_, SliceType.B, mb_addrs=addrs, **common)
                    pic_bins += bins
                else:
                    rbsp = serialize_slice(pic_, self.sps, self.pps,
                                           mb_addrs=addrs, **common)
                unit = annexb_bytes(2 if as_ref else 0,
                                    NalUnitType.SLICE, rbsp)
                if sizes is not None:
                    sizes.append(len(unit) - 4)
                payload += unit
            if cfg.entropy == "cabac":
                payload += self._cabac_zero_words(payload, pic_bins)
            return payload

        if cfg.slice_mode == 2 and cfg.slice_argument > 0:
            # SliceMode 2 for B pictures: same byte-fit re-encode loop as
            # anchors (slice.c:524-547), with the DPB store rolled back
            # between iterations
            limit = cfg.slice_argument
            saved_plan = self.slice_plan
            plan = [list(a) for a in self._build_slice_plan()]
            for _ in range(12):
                self.slice_plan = plan
                refs_snap, uid_snap = list(self.refs), self._uid
                fe, pic = _encode_once()
                frame, common, rec = _finalize(fe, pic)
                sizes = []
                payload = _serialize_once(pic, common, sizes)
                new_plan, changed = [], False
                for addrs, sz in zip(plan, sizes):
                    if sz <= limit or len(addrs) == 1:
                        new_plan.append(addrs)
                        continue
                    changed = True
                    k = max(1, int(len(addrs) * limit / sz * 0.92))
                    new_plan.extend(addrs[i:i + k]
                                    for i in range(0, len(addrs), k))
                if not changed:
                    break
                self.refs, self._uid = refs_snap, uid_snap
                plan = new_plan
            self.slice_plan = saved_plan
            recY, recU, recV = rec
        else:
            fe, pic = _encode_once()
            frame, common, (recY, recU, recV) = _finalize(fe, pic)
            payload = _serialize_once(pic, common)
        if cfg.num_views == 2:
            from ..bitstream.nal import mvc_ext_bytes
            payload = annexb_bytes(
                2 if as_ref else 0, NalUnitType.PREFIX, b"",
                mvc_ext=mvc_ext_bytes(1, 0, 0, 1)) + payload
            payload += self._emit_view1(
                disp, frame, poc, self.frame_num, anchor=False,
                b_anchors=(prev_anchor, next_anchor), as_ref=as_ref,
                qp_view=qp_b)
        if as_ref:
            self.frame_num = (self.frame_num + 1) % self.sps.max_frame_num
        if self.rc is not None:
            mad = float(np.abs(np.asarray(Y, np.int32) -
                               recY.astype(np.int32)).mean())
            self.rc.update("B", qp_b, len(payload) * 8, mad)
        self.stats.append({"type": "B", "bits": len(payload) * 8})
        self.results.append({"disp": disp, "type": "B",
                             "bits": len(payload) * 8, "frame": frame,
                             "qp": qp_b})
        return payload

    def _deblock(self, recY, recU, recV, pic) -> None:
        n = pic.n_mbs
        deblock_picture(recY, recU, recV, pic, self.mb_w, self.mb_h,
                        pic.qp, {
            "disable_idc": np.zeros(n, np.int32),
            "alpha_off": np.zeros(n, np.int32),
            "beta_off": np.zeros(n, np.int32),
            "cb_qp_off": np.full(n, self.pps.cb_qp_offset, np.int32),
            "cr_qp_off": np.full(n, self.pps.cr_qp_offset, np.int32),
            "slice_id": pic.slice_id,
        })

    @property
    def recon_frames(self):
        return self.refs


class _FrameEncoder:
    """Encodes one frame: mode decision + residual coding + recon."""

    def __init__(self, enc: Encoder, stype: SliceType, Y, U, V):
        self.enc = enc
        self.stype = stype
        self.origY = np.asarray(Y, np.uint8)
        self.origU = np.asarray(U, np.uint8)
        self.origV = np.asarray(V, np.uint8)
        self.mb_w, self.mb_h = enc.mb_w, enc.mb_h
        self.w, self.h = enc.cfg.width, enc.coded_height
        self.cur_parity = None           # field pictures: 0 top, 1 bottom
        self.refs_list = None            # preset by the field driver
        self.qp = enc.cfg.qp
        self.qpc = chroma_qp(self.qp, enc.pps.chroma_qp_index_offset)
        self.lam = lambda_me(self.qp)
        self.lam4 = lambda_mode4(self.qp)
        self.qs = enc.cfg.qp_sp2 if stype == SliceType.SP else 0
        self.cfi = enc.sps.chroma_format_idc
        self.crows = 4 if self.cfi == 2 else 2   # chroma 4x4 rows per MB
        self.ch_mb = self.crows * 4              # chroma MB height
        self.pic = PictureData(self.mb_w, self.mb_h, self.cfi)
        self.pctx = PredCtx(self.pic)
        self.recY = np.zeros_like(self.origY)
        self.recU = np.zeros_like(self.origU)
        self.recV = np.zeros_like(self.origV)
        self.ref = enc.refs[0] \
            if (stype in (SliceType.P, SliceType.SP) and enc.refs) else None
        self.is_view1 = False            # MVC dependent view (E40)
        self.forced_intra: set = set()   # intra refresh (E34)
        self.wp = None                   # decoder-exact WPParams (E31)
        self.cabac_rate = None           # exact CABAC RDO rate (rdo.CabacRate)
        self.epzs = None                 # EPZS searcher (search_mode >= 1)
        self.epzs1 = None                # ... for list 1 (B slices)
        self.qsads = None                # fast-full SAD tables (full search)
        self.qsads1 = None
        # custom quant (scaling matrices / explicit offsets / adaptive
        # rounding, E10/E12); None selects the legacy flat fast path
        self.burc = None                 # within-frame basic-unit RC (E29)
        self.qctx = None
        if enc.quant_custom:
            from .qmatrix import QuantCtx
            st = {SliceType.I: "I", SliceType.P: "P",
                  SliceType.B: "B"}[stype]
            self.qctx = QuantCtx(
                enc.qm_lists4, enc.qm_lists8, st, off_state=enc._ar_state,
                ar_weight=enc.cfg.adapt_rnd_w
                if enc.cfg.adaptive_rounding else 0)

    # ---- quant dispatch (flat fast path vs qmatrix.QuantCtx) --------------

    def _q4(self, w, qp, intra, plane=0):
        if self.qctx is None:
            return RN.np_quant_4x4(w, qp, intra)
        return self.qctx.quant_4x4(w, qp, plane, intra)

    def _qdc(self, dc, qp, intra, plane=0):
        if self.qctx is None:
            return RN.np_quant_dc(dc, qp, intra)
        return self.qctx.quant_dc(dc, qp, plane, intra)

    def _q8(self, w, qp, intra):
        if self.qctx is None:
            return RN.np_quant_8x8(w, qp, intra)
        return self.qctx.quant_8x8(w, qp, intra)

    def _itab4(self, intra, plane=0):
        return None if self.qctx is None else self.qctx.inv_tab4(plane, intra)

    def _itab8(self, intra):
        return None if self.qctx is None else self.qctx.inv_tab8(intra)

    # ---- helpers ----------------------------------------------------------

    def _mb_orig(self, addr):
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        cy, ch = mby * self.ch_mb, self.ch_mb
        cx = px // 2
        return (self.origY[py:py + 16, px:px + 16],
                self.origU[cy:cy + ch, cx:cx + 8],
                self.origV[cy:cy + ch, cx:cx + 8])

    def _mb_avail(self, naddr, addr):
        return self.pctx.avail(naddr, addr)

    # ---- RDOQ (E11) dispatch -----------------------------------------------

    @property
    def _rdoq_on(self) -> bool:
        cfg = self.enc.cfg
        if not cfg.rdoq:
            return False
        if self.qctx is not None:
            # trellis tables assume flat scaling; custom-quant frames use
            # the QuantCtx path (JM couples rdoq with q_params; deferred)
            return False
        # CABAC trellis needs the running slice engine's context states
        return not (cfg.entropy == "cabac" and self.cabac_rate is None)

    def _rdoq_lam(self) -> float:
        from .rdo import lambda_mode
        return lambda_mode(self.qp, intra_rdoq=(
            self._rdoq_on and self.stype == SliceType.I))

    def _rdoq_ctxs(self):
        """Live CABAC context states for the trellis bit estimates (the
        running slice engine's models)."""
        return self.cabac_rate.w.ctxs if self.cabac_rate is not None \
            else None

    def _trellis_luma4(self, addr, w_raster, blk, intra, i16ac=False):
        """Trellis-quantize one luma 4x4 (or I16 AC) block; returns scan-
        order signed levels, length 16 (position 0 zeroed for AC)."""
        from . import rdoq as RQ
        w_scan = RN.to_scan(w_raster[None])[0]
        lam = self._rdoq_lam()
        out = np.zeros(16, np.int32)
        by, bx = blk // 4, blk % 4
        if self.enc.cfg.entropy == "cavlc":
            nc = self.pctx.nc_luma(addr, blk)
            if i16ac:
                out[1:] = RQ.trellis_4x4(
                    w_scan[1:], self.qp, intra, lam, entropy="cavlc",
                    block_type=1, nc=nc, max_coeff=15, start=1)
            else:
                out[:] = RQ.trellis_4x4(
                    w_scan, self.qp, intra, lam, entropy="cavlc",
                    block_type=5, nc=nc, max_coeff=16)
            return out
        w = self.cabac_rate.w
        if i16ac:
            ctx, _ = w.cbf_ctx(addr, 1, bx, by)
            out[1:] = RQ.trellis_4x4(
                w_scan[1:], self.qp, intra, lam, entropy="cabac",
                block_type=1, ctxs=w.ctxs, cbf_ctx=ctx, start=1)
        else:
            ctx, _ = w.cbf_ctx(addr, 5, bx, by)
            out[:] = RQ.trellis_4x4(
                w_scan, self.qp, intra, lam, entropy="cabac",
                block_type=5, ctxs=w.ctxs, cbf_ctx=ctx)
        return out

    def _trellis_luma_dc(self, addr, dc_t):
        """I16 luma DC (Hadamard domain, (4,4) raster in); returns scan-
        order signed levels (16,)."""
        from . import rdoq as RQ
        w_scan = RN.to_scan(dc_t[None].astype(np.int64))[0]
        lam = self._rdoq_lam()
        if self.enc.cfg.entropy == "cavlc":
            nc = self.pctx.nc_luma(addr, 0)
            return RQ.trellis_4x4(w_scan, self.qp, True, lam,
                                  entropy="cavlc", block_type=0, nc=nc,
                                  max_coeff=16, dc=True)
        w = self.cabac_rate.w
        ctx, _ = w.cbf_ctx(addr, 0)
        return RQ.trellis_4x4(w_scan, self.qp, True, lam, entropy="cabac",
                              block_type=0, ctxs=w.ctxs, cbf_ctx=ctx,
                              dc=True)

    def _trellis_chroma_dc(self, addr, dc_t_flat, comp, intra):
        """Chroma DC (4:2:0: 4 Hadamard-domain values in raster order).
        Returns signed levels (4,)."""
        from . import rdoq as RQ
        lam = self._rdoq_lam()
        if self.enc.cfg.entropy == "cavlc":
            return RQ.trellis_4x4(dc_t_flat, self.qpc, intra, lam,
                                  entropy="cavlc", block_type=6, nc=-1,
                                  max_coeff=4, dc=True)
        w = self.cabac_rate.w
        ctx, _ = w.cbf_ctx(addr, 6, comp=comp)
        return RQ.trellis_4x4(dc_t_flat, self.qpc, intra, lam,
                              entropy="cabac", block_type=6, ctxs=w.ctxs,
                              cbf_ctx=ctx, dc=True)

    def _trellis_chroma_ac(self, addr, w_raster, comp, blk, intra):
        """Chroma AC 4x4 (positions 1..15); returns scan levels (16,)."""
        from . import rdoq as RQ
        w_scan = RN.to_scan(w_raster[None])[0]
        lam = self._rdoq_lam()
        out = np.zeros(16, np.int32)
        if self.enc.cfg.entropy == "cavlc":
            nc = self.pctx.nc_chroma(addr, comp, blk)
            out[1:] = RQ.trellis_4x4(w_scan[1:], self.qpc, intra, lam,
                                     entropy="cavlc", block_type=7, nc=nc,
                                     max_coeff=15, start=1)
            return out
        w = self.cabac_rate.w
        ctx, _ = w.cbf_ctx(addr, 7, blk % 2, blk // 2, comp)
        out[1:] = RQ.trellis_4x4(w_scan[1:], self.qpc, intra, lam,
                                 entropy="cabac", block_type=7,
                                 ctxs=w.ctxs, cbf_ctx=ctx, start=1)
        return out

    # ---- frame loop -------------------------------------------------------

    def _device_path_ok(self) -> bool:
        """The batched device pipeline covers the md_low P path for 4:2:0
        single-reference frames; everything else falls back to the serial
        host reference path."""
        cfg = self.enc.cfg
        return (cfg.pipeline == "device"
                and not cfg.pic_interlace   # field pics: field scan +
                                            # parity chroma MC, host path
                and self.qctx is None
                and self.burc is None
                and not self.is_view1
                and self.stype == SliceType.P
                and self.cfi == 1
                and self.enc.num_ref_active == 1
                and self.wp is None
                and self.enc.errdo is None
                and not cfg.rdo
                and not cfg.transform8x8
                and not cfg.sub8x8
                and cfg.enable_ipcm == 0)

    def _device_i_path_ok(self) -> bool:
        cfg = self.enc.cfg
        return (cfg.pipeline == "device"
                and not cfg.pic_interlace
                and self.qctx is None
                and self.stype == SliceType.I
                and self.cfi == 1
                and len(self.enc.slice_plan) == 1
                and not cfg.rdo
                and not cfg.transform8x8
                and cfg.enable_ipcm == 0)

    def encode(self) -> PictureData:
        if self._device_path_ok():
            for sid, addrs in enumerate(self.enc.slice_plan):
                for addr in addrs:
                    self.pic.slice_id[addr] = sid
            self.pic.qp[:] = self.qp
            if self.refs_list is None:
                self.refs_list = self.enc._ref_list_p()
            self._encode_p_device()
            return self.pic
        if self._device_i_path_ok():
            self.pic.slice_id[:] = 0
            self.pic.qp[:] = self.qp
            self._encode_i_device()
            return self.pic
        sr = self.enc.cfg.search_range
        fast_me = self.enc.cfg.search_mode >= 1   # UMHex/UMHexSimple/EPZS
        if self.stype == SliceType.SP:
            # SP pictures: the whole slice takes the requantizing path
            # (deblock forces bS 4/3 via sp_slice; loop_filter_normal.c:100)
            self.pic.sp_slice[:] = True
            self.pic.sp_qs[:] = self.qs
        if self.stype in (SliceType.P, SliceType.SP):
            if not self.is_view1 and self.refs_list is None:
                self.refs_list = self.enc._ref_list_p()
            if fast_me:
                from .me_epzs import EPZSearcher
                from .me_umhex import UMHexSearcher, UMHexSmpSearcher
                _ENG = {1: UMHexSearcher, 2: UMHexSmpSearcher}
                EPZSearcher = _ENG.get(self.enc.cfg.search_mode,
                                       EPZSearcher)
                self.epzs = EPZSearcher(
                    self.origY, self.refs_list, self.mb_w, self.mb_h,
                    sr, self.lam, self.pic.mv, use_hme=self.enc.cfg.hme)
            else:
                # fast-full-search tables: per-reference per-quadrant SADs
                # over the whole displacement window (me_fullfast analog)
                self.qsads = [
                    ME.full_search_blk4_sads(
                        self.origY, f.luma_planes[0], self.mb_w, self.mb_h,
                        sr, ip.PAD)
                    for f in self.refs_list]
        elif self.stype == SliceType.B:
            # refs_list / refs_list1 / b_col set by the driver (_emit_b)
            if fast_me:
                from .me_epzs import EPZSearcher
                from .me_umhex import UMHexSearcher, UMHexSmpSearcher
                _ENG = {1: UMHexSearcher, 2: UMHexSmpSearcher}
                EPZSearcher = _ENG.get(self.enc.cfg.search_mode,
                                       EPZSearcher)
                self.epzs = EPZSearcher(
                    self.origY, self.refs_list[:1], self.mb_w, self.mb_h,
                    sr, self.lam, self.pic.mv, use_hme=self.enc.cfg.hme)
                self.epzs1 = EPZSearcher(
                    self.origY, self.refs_list1[:1], self.mb_w, self.mb_h,
                    sr, self.lam, self.pic.mv_l1, use_hme=self.enc.cfg.hme)
            else:
                self.qsads = [ME.full_search_blk4_sads(
                    self.origY, self.refs_list[0].luma_planes[0],
                    self.mb_w, self.mb_h, sr, ip.PAD)]
                self.qsads1 = [ME.full_search_blk4_sads(
                    self.origY, self.refs_list1[0].luma_planes[0],
                    self.mb_w, self.mb_h, sr, ip.PAD)]
        use_cabac_rate = (self.enc.cfg.entropy == "cabac"
                          and (self.enc.cfg.rdo or self.enc.cfg.rdoq)
                          and self.stype in (SliceType.I, SliceType.P))
        for sid, addrs in enumerate(self.enc.slice_plan):
            if use_cabac_rate:
                # fresh engine/contexts per slice: RDO rates are exact
                # marginal arithmetic-coded bits (rdopt_coding_state.c)
                from .rdo import CabacRate
                self.cabac_rate = CabacRate(self, self.stype)
            for mb_i, addr in enumerate(addrs):
                if self.qctx is not None:
                    self.qctx.maybe_refresh(mb_i,
                                            self.enc.cfg.adapt_rnd_period)
                if self.burc is not None:
                    # basic-unit QP for this MB (rc_quadratic.c
                    # updateQPRC basic-unit branch)
                    q = self.burc.mb_qp()
                    if q != self.qp:
                        self.qp = q
                        self.qpc = chroma_qp(
                            q, self.enc.pps.chroma_qp_index_offset)
                        self.lam = lambda_me(q)
                        self.lam4 = lambda_mode4(q)
                self.pic.slice_id[addr] = sid
                self.pic.qp[addr] = self.qp
                if self.stype == SliceType.I:
                    self._encode_intra_mb(addr)
                elif self.stype == SliceType.B:
                    self._encode_b_mb(addr)
                else:
                    self._encode_p_mb(addr)
                if use_cabac_rate:
                    self.cabac_rate.commit(addr)
                if self.qctx is not None:
                    self.qctx.ar_commit_mb()
                if self.burc is not None:
                    from .rdo import count_mb_bits
                    self.burc.report(count_mb_bits(self, addr, self.stype))
            self.cabac_rate = None
        return self.pic

    # ---- device pipeline (ops/enc_jax.py) ----------------------------------

    def _encode_p_device(self) -> None:
        """Batched device P-frame encode: one jitted dispatch performs
        ME/subpel/mode-decision/MC/residual/recon for every MB (the batched
        restructuring of lencod slice.c:486 + md_low.c:104); the host
        commits the SoA state, exactly re-encodes the rare intra-chosen
        MBs with reconstructed neighbors, and derives P_Skip flags from
        the final motion field."""
        import jax

        from ..ops import enc_jax as EJ
        enc, cfg, pic = self.enc, self.enc.cfg, self.pic
        ref = self.refs_list[0]
        if (cfg.sp_shards > 1 and self.mb_h % cfg.sp_shards == 0
                and cfg.search_range <= 16 and not cfg.device_rd):
            # MB-row-sharded step (recon/MV/source halo exchange over the
            # 'sp' mesh); bit-identical to the 1-device path by design
            from ..parallel import sp_pipeline as SP
            mesh = getattr(enc, "_sp_mesh", None)
            if mesh is None or mesh.devices.size != cfg.sp_shards:
                mesh = SP.make_sp_mesh(cfg.sp_shards)
                enc._sp_mesh = mesh
            out = jax.device_get(SP.p_frame_step_sharded(
                mesh, self.origY, self.origU, self.origV,
                ref.Y, ref.U, ref.V,
                self.qp, self.qpc, self.lam, self.lam4,
                mb_w=self.mb_w, mb_h=self.mb_h, sr=cfg.search_range))
        elif getattr(enc, "_reuse_core", None) is not None:
            # pipelined-path intra fallback: the dispatch already ran
            # p_frame_step for this exact frame/reference — download its
            # results instead of recomputing (encoder.py _pipe_finalize)
            out = jax.device_get(enc._reuse_core)
        else:
            dev = getattr(ref, "_dev", None)
            if dev is None:
                dev = EJ.prep_ref(ref.Y, ref.U, ref.V)
                ref._dev = dev
            planes, padU, padV = dev
            out = jax.device_get(EJ.p_frame_step(
                self.origY, self.origU, self.origV, planes, padU, padV,
                self.qp, self.qpc, self.lam, self.lam4,
                mb_w=self.mb_w, mb_h=self.mb_h, sr=cfg.search_range,
                rd=cfg.device_rd))

        intra = np.asarray(out["intra_mask"]).copy()
        if self.forced_intra:
            intra[list(self.forced_intra)] = True
        pic.mb_class[:] = MB_INTER
        pic.inter_mode[:] = out["inter_mode"]
        pic.mv[:] = out["mv4"]
        pic.ref_idx[:] = 0
        pic.ref_pic_id[:] = ref.uid
        pic.pdir[:] = 0
        pic.sub_mode[:] = 0
        pic.luma_coef[:] = out["luma_scan"]
        pic.luma_nnz[:] = out["luma_nnz"]
        pic.chroma_dc[:] = out["chroma_dc"]
        pic.chroma_coef[:] = out["chroma_scan"]
        pic.chroma_nnz[:] = out["chroma_nnz"]
        pic.cbp[:] = out["cbp"]
        self.recY[:] = out["recY"]
        self.recU[:] = out["recU"]
        self.recV[:] = out["recV"]

        # exact host re-encode of intra-chosen MBs (recon neighbors are
        # final: inter recon never reads the current frame)
        for addr in np.flatnonzero(intra):
            addr = int(addr)
            pic.ref_idx[addr] = -1
            pic.ref_pic_id[addr] = -1
            pic.mv[addr] = 0
            origY_mb = self._mb_orig(addr)[0]
            _c, m16, p16 = self._eval_i16(addr, origY_mb)
            cbp_luma = self._encode_i16(addr, origY_mb, m16, p16)
            cbp_chroma = self._encode_chroma_intra(addr)
            pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma

        # P_Skip: 16x16 / ref 0 / no coefficients / mv == skip predictor
        # (spec 8.4.1.1), derived from the final committed state
        cand = np.flatnonzero((pic.cbp == 0) & (pic.inter_mode == 0)
                              & (pic.mb_class == MB_INTER)
                              & (pic.ref_idx[:, 0] == 0))
        for addr in cand:
            addr = int(addr)
            if (pic.mv[addr, 0] == self.pctx.skip_mv(addr)).all():
                pic.skip[addr] = True

    def _encode_i_device(self) -> None:
        """Wavefront-batched device I-frame (ops/intra_jax.py): anti-
        diagonal waves of MBs coded together; I4 (9 modes) + I16 + chroma
        decisions on device, exact residual/recon, committed to the SoA
        state for serialization."""
        import jax

        from ..ops import intra_jax as IJ
        pic = self.pic
        out = jax.device_get(IJ.i_frame_step(
            self.origY, self.origU, self.origV,
            self.qp, self.qpc, self.lam, self.lam4,
            mb_w=self.mb_w, mb_h=self.mb_h))
        pic.mb_class[:] = out["cls"]
        pic.i4_modes[:] = out["i4m"]
        pic.i16_mode[:] = out["i16m"]
        pic.chroma_mode[:] = out["cmode"]
        pic.cbp[:] = out["cbp"]
        pic.luma_coef[:] = out["lcoef"]
        pic.luma_dc[:] = out["ldc"]
        pic.luma_nnz[:] = out["lnnz"]
        pic.chroma_dc[:] = out["cdc"]
        pic.chroma_coef[:] = out["cac"]
        pic.chroma_nnz[:] = out["cnnz"]
        pic.ref_idx[:] = -1
        pic.ref_pic_id[:] = -1
        self.recY[:] = out["recY"]
        self.recU[:] = out["recU"]
        self.recV[:] = out["recV"]

    # ---- intra ------------------------------------------------------------

    def _i16_candidates(self, addr):
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        avail_l = mbx > 0 and self._mb_avail(addr - 1, addr)
        avail_t = self._mb_avail(addr - self.mb_w, addr)
        avail_tl = mbx > 0 and self._mb_avail(addr - self.mb_w - 1, addr)
        top = self.recY[py - 1, px:px + 16].astype(np.int32) if avail_t \
            else np.zeros(16, np.int32)
        left = self.recY[py:py + 16, px - 1].astype(np.int32) if avail_l \
            else np.zeros(16, np.int32)
        corner = int(self.recY[py - 1, px - 1]) if avail_tl else 0
        modes = [it.I16_DC]
        if avail_t:
            modes.append(it.I16_VERT)
        if avail_l:
            modes.append(it.I16_HOR)
        if avail_t and avail_l and avail_tl:
            modes.append(it.I16_PLANE)
        return modes, top, left, corner, avail_t, avail_l

    def _eval_i16(self, addr, origY_mb):
        modes, top, left, corner, avail_t, avail_l = self._i16_candidates(addr)
        best = None
        o = origY_mb.astype(np.int32)
        for m in modes:
            pred = it.predict_i16(m, top, left, corner, avail_t, avail_l)
            sad = int(np.abs(o - pred).sum())
            if best is None or sad < best[0]:
                best = (sad, m, pred)
        return best  # (cost, mode, pred)

    def _encode_i16(self, addr, origY_mb, mode, pred):
        pic, qp = self.pic, self.qp
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        res = origY_mb.astype(np.int64) - pred
        blocks = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
        w = RN.np_forward4x4(blocks)
        from ..decoder.recon import _np_hadamard4
        dc = w[:, 0, 0].reshape(4, 4)
        # JM forward hadamard carries a >>1 (lcommon/src/transform.c:163)
        dc_t = _np_hadamard4(dc) >> 1
        if self._rdoq_on:
            if self.enc.cfg.rdoq_dc:
                dc_scan = self._trellis_luma_dc(addr, dc_t).astype(np.int64)
            else:
                dc_lev = self._qdc(dc_t, qp, True)
                dc_scan = RN.to_scan(dc_lev.reshape(1, 4, 4))[0]
            ac_scan = np.zeros((16, 16), np.int64)
            for code in range(16):
                blk = int(CODE2RASTER[code])
                ac_scan[blk] = self._trellis_luma4(addr, w[blk], blk,
                                                   True, i16ac=True)
                pic.luma_nnz[addr, blk] = int((ac_scan[blk] != 0).sum())
        else:
            dc_lev = self._qdc(dc_t, qp, True)
            ac = self._q4(w, qp, True)
            ac_scan = RN.to_scan(ac)
            ac_scan[:, 0] = 0
            dc_scan = RN.to_scan(dc_lev.reshape(1, 4, 4))[0]
        pic.mb_class[addr] = MB_I16
        pic.i16_mode[addr] = mode
        pic.luma_dc[addr] = dc_scan
        pic.luma_coef[addr, :, :] = 0
        pic.luma_coef[addr, :, 1:] = ac_scan[:, 1:]
        nnz = (ac_scan[:, 1:] != 0).sum(axis=1)
        cbp_luma = 15 if nnz.any() else 0
        if not cbp_luma:
            pic.luma_coef[addr, :, :] = 0
            nnz = np.zeros(16, np.int64)
            ac_scan[:, :] = 0
        pic.luma_nnz[addr] = nnz
        pred_blocks = pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
        rec = RN.recon_luma_i16(pred_blocks, ac_scan if cbp_luma else
                                np.zeros((16, 16), np.int32), dc_scan, qp,
                                tab=self._itab4(True))
        rec16 = rec.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        self.recY[py:py + 16, px:px + 16] = rec16
        return cbp_luma

    def _encode_i4_mb(self, addr, origY_mb):
        """Sequential 4x4 intra coding; returns (total_cost, cbp_luma).
        Commits recon and coefficients directly."""
        pic, qp = self.pic, self.qp
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        pic.mb_class[addr] = MB_I4
        total_cost = 0
        nnz_any_quad = [False] * 4
        for code in range(16):
            blk = int(CODE2RASTER[code])
            by, bx = divmod(blk, 4)
            gx, gy = mbx * 4 + bx, mby * 4 + by
            x, y = gx * 4, gy * 4
            avail_l, avail_t, avail_tl, avail_tr = self._blk_avail(addr, gx, gy, code)
            top = np.zeros(8, np.int32)
            left = np.zeros(4, np.int32)
            corner = 0
            Y = self.recY
            if avail_t:
                top[0:4] = Y[y - 1, x:x + 4]
                top[4:8] = Y[y - 1, x + 4:x + 8] if avail_tr else Y[y - 1, x + 3]
            if avail_l:
                left[:] = Y[y:y + 4, x - 1]
            if avail_tl:
                corner = int(Y[y - 1, x - 1])
            mpm = self.pctx.pred_intra4_mode(addr, blk)
            o = origY_mb[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4].astype(np.int32)
            cand = [it.I4_DC]
            if avail_t:
                cand += [it.I4_VERT, it.I4_VL]
                cand += [it.I4_DDL]
            if avail_l:
                cand += [it.I4_HOR, it.I4_HU]
            if avail_t and avail_l and avail_tl:
                cand += [it.I4_DDR, it.I4_VR, it.I4_HD]
            if self.enc.cfg.rdo:
                # full per-mode RD (lencod rdopt.c
                # rdcost_for_4x4_intra_blocks:523): trial-quantize and
                # reconstruct every candidate, J = SSD + lam*(mode bits +
                # exact CAVLC block bits)
                from .cavlc_write import write_residual_block
                from .rdo import lambda_mode
                from ..bitstream.bitwriter import BitWriter
                lam_md = lambda_mode(qp, intra_rdoq=(
                    self._rdoq_on and self.stype == SliceType.I))
                nc = self.pctx.nc_luma(addr, blk)
                best = None
                for m in cand:
                    pred = it.predict_i4(m, top, left, corner,
                                         avail_t, avail_l)
                    w = RN.np_forward4x4((o - pred)[None])[0]
                    if self._rdoq_on:
                        scan_m = self._trellis_luma4(addr, w, blk,
                                                     intra=True)
                    else:
                        lev = self._q4(w[None], qp, True)[0]
                        scan_m = RN.to_scan(lev[None])[0]
                    rec_m = RN.recon_luma_4x4(pred[None], scan_m[None], qp,
                                              tab=self._itab4(True))[0]
                    ssd = int(((o - rec_m.astype(np.int64)) ** 2).sum())
                    bits = 1 if m == mpm else 4
                    bw = BitWriter()
                    write_residual_block(bw, scan_m, nc, 16)
                    bits += bw.bitpos
                    j = ssd + lam_md * bits
                    if best is None or j < best[0]:
                        best = (j, m, pred, scan_m, rec_m)
                _j, m, pred, scan, rec_pre = best
                cost = int(_j)
            else:
                best = None
                for m in cand:
                    pred = it.predict_i4(m, top, left, corner,
                                         avail_t, avail_l)
                    cost = int(np.abs(o - pred).sum())
                    if m != mpm:
                        cost += self.lam4
                    if best is None or cost < best[0]:
                        best = (cost, m, pred)
                cost, m, pred = best
                scan = None
            total_cost += cost
            pic.i4_modes[addr, blk] = m
            # residual
            if scan is None:
                w = RN.np_forward4x4((o - pred)[None])[0]
                if self._rdoq_on:
                    scan = self._trellis_luma4(addr, w, blk, intra=True)
                else:
                    lev = self._q4(w[None], qp, True)[0]
                    scan = RN.to_scan(lev[None])[0]
            pic.luma_coef[addr, blk] = scan
            tc = int((scan != 0).sum())
            pic.luma_nnz[addr, blk] = tc
            if tc:
                nnz_any_quad[(by // 2) * 2 + bx // 2] = True
            rec = RN.recon_luma_4x4(pred[None], scan[None], qp,
                                    tab=self._itab4(True))[0]
            self.recY[y:y + 4, x:x + 4] = rec
        cbp_luma = sum(1 << q for q in range(4) if nnz_any_quad[q])
        return total_cost, cbp_luma

    def _blk_avail(self, addr, gx, gy, code):
        from ..common.predict_ctx import RASTER2CODE

        def ok(nx, ny):
            if nx < 0 or ny < 0 or nx >= self.mb_w * 4:
                return False
            naddr = (ny // 4) * self.mb_w + (nx // 4)
            if naddr == addr:
                nblk = (ny % 4) * 4 + (nx % 4)
                return RASTER2CODE[nblk] < code
            if naddr > addr:
                return False
            return self._mb_avail(naddr, addr)
        return ok(gx - 1, gy), ok(gx, gy - 1), ok(gx - 1, gy - 1), ok(gx + 1, gy - 1)

    def _encode_chroma_intra(self, addr):
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        cx, cy = mbx * 8, mby * self.ch_mb
        ch = self.ch_mb
        avail_l = mbx > 0 and self._mb_avail(addr - 1, addr)
        avail_t = self._mb_avail(addr - self.mb_w, addr)
        avail_tl = mbx > 0 and self._mb_avail(addr - self.mb_w - 1, addr)
        origU, origV = self._mb_orig(addr)[1:]
        modes = [it.C_DC]
        if avail_l:
            modes.append(it.C_HOR)
        if avail_t:
            modes.append(it.C_VERT)
        if avail_t and avail_l and avail_tl:
            modes.append(it.C_PLANE)
        best = None
        for m in modes:
            sad = 0
            preds = []
            for comp, plane, orig in ((0, self.recU, origU), (1, self.recV, origV)):
                top = plane[cy - 1, cx:cx + 8].astype(np.int32) if avail_t \
                    else np.zeros(8, np.int32)
                left = plane[cy:cy + ch, cx - 1].astype(np.int32) if avail_l \
                    else np.zeros(ch, np.int32)
                corner = int(plane[cy - 1, cx - 1]) if avail_tl else 0
                pred = it.predict_chroma(m, top, left, corner, avail_t, avail_l)
                sad += int(np.abs(orig.astype(np.int32) - pred).sum())
                preds.append(pred)
            if best is None or sad < best[0]:
                best = (sad, m, preds)
        _sad, mode, preds = best
        pic.chroma_mode[addr] = mode
        return self._code_chroma_residual(addr, preds[0], preds[1], intra=True)

    def _code_chroma_residual(self, addr, predU, predV, intra):
        """Quantize and commit chroma residual; returns cbp_chroma (0/1/2).
        4:2:0: 2x2 DC hadamard; 4:2:2: 2x4 DC hadamard at QPc+3
        (lencod/src/block.c:954-1160)."""
        pic, qpc = self.pic, self.qpc
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        crows, ch = self.crows, self.ch_mb
        nb = 2 * crows
        cx, cy = mbx * 8, mby * ch
        origU, origV = self._mb_orig(addr)[1:]
        any_ac = False
        any_dc = False
        store = []
        for comp, pred, orig in ((0, predU, origU), (1, predV, origV)):
            res = orig.astype(np.int64) - pred
            blocks = res.reshape(crows, 4, 2, 4).transpose(0, 2, 1, 3) \
                .reshape(nb, 4, 4)
            w = RN.np_forward4x4(blocks)
            dcs = w[:, 0, 0]
            cfg = self.enc.cfg
            rdoq = self._rdoq_on
            if crows == 2:
                dc_t = RN.np_hadamard2x2(dcs.reshape(2, 2))
                if rdoq and cfg.rdoq_dc_cr:
                    dc_lev = self._trellis_chroma_dc(
                        addr, dc_t.reshape(4), comp, intra).astype(np.int64)
                else:
                    dc_lev = self._qdc(dc_t, qpc, intra,
                                       plane=comp + 1).reshape(4)
            else:
                qfn = None if self.qctx is None else (
                    lambda f, q, i, _c=comp: self.qctx.quant_dc(
                        f, q, _c + 1, i))
                dc_lev = RN.quant_dc422(dcs, qpc, intra, qfn=qfn)
            if rdoq and cfg.rdoq_cr:
                ac_scan = np.zeros((nb, 16), np.int64)
                for blk in range(nb):
                    ac_scan[blk] = self._trellis_chroma_ac(
                        addr, w[blk], comp, blk, intra)
                    pic.chroma_nnz[addr, comp, blk] = int(
                        (ac_scan[blk] != 0).sum())
            else:
                ac = self._q4(w, qpc, intra, plane=comp + 1)
                ac_scan = RN.to_scan(ac)
                ac_scan[:, 0] = 0
            # per-component chroma AC thresholding (block.c:1141, strict <)
            cost_c = sum(RN.coeff_cost_scan(ac_scan[b], start=1)
                         for b in range(nb))
            if cost_c < RN.CHROMA_COEFF_COST:
                ac_scan[:, :] = 0
            store.append((dc_lev, ac_scan, pred))
            if (ac_scan[:, 1:] != 0).any():
                any_ac = True
            if (dc_lev != 0).any():
                any_dc = True
        cbp_chroma = 2 if any_ac else (1 if any_dc else 0)
        for comp, (dc_lev, ac_scan, pred) in enumerate(store):
            if cbp_chroma < 2:
                ac_scan[:, :] = 0
            if cbp_chroma == 0:
                dc_lev[:] = 0
            pic.chroma_dc[addr, comp] = dc_lev
            pic.chroma_coef[addr, comp, :, :] = 0
            pic.chroma_coef[addr, comp, :, 1:] = ac_scan[:, 1:]
            pic.chroma_nnz[addr, comp] = (ac_scan[:, 1:] != 0).sum(axis=1)
            pred_blocks = pred.reshape(crows, 4, 2, 4).transpose(0, 2, 1, 3) \
                .reshape(nb, 4, 4)
            ctab = self._itab4(intra, plane=comp + 1)
            if crows == 2:
                rec = RN.recon_chroma(pred_blocks, ac_scan, dc_lev, qpc,
                                      tab=ctab)
            else:
                rec = RN.recon_chroma422(pred_blocks, ac_scan, dc_lev, qpc,
                                         tab=ctab)
            rec8 = rec.reshape(crows, 2, 4, 4).transpose(0, 2, 1, 3) \
                .reshape(ch, 8)
            plane = self.recU if comp == 0 else self.recV
            plane[cy:cy + ch, cx:cx + 8] = rec8
        return cbp_chroma

    def _encode_intra_mb(self, addr):
        pic = self.pic
        origY_mb = self._mb_orig(addr)[0]
        if self.enc.cfg.enable_ipcm >= 2:        # forced IPCM (EnableIPCM=2)
            self._commit_ipcm(addr)
            return
        if self.enc.cfg.rdo:
            from .rdo import MBState, count_mb_bits, lambda_mode, mb_ssd
            lam = lambda_mode(self.qp, intra_rdoq=(
                self._rdoq_on and self.stype == SliceType.I))
            base = MBState(self, addr)
            _c, cbp_luma4 = self._encode_i4_mb(addr, origY_mb)
            cbp_chroma = self._encode_chroma_intra(addr)
            pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma4
            j4 = mb_ssd(self, addr) + lam * count_mb_bits(
                self, addr, self.stype)
            s4 = MBState(self, addr)
            base.restore()
            _c16, m16, p16 = self._eval_i16(addr, origY_mb)
            pic.i4_modes[addr] = -1
            cbp_luma = self._encode_i16(addr, origY_mb, m16, p16)
            cbp_chroma = self._encode_chroma_intra(addr)
            pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma
            j16 = mb_ssd(self, addr) + lam * count_mb_bits(
                self, addr, self.stype)
            if j4 <= j16:
                s4.restore()
            if self.enc.cfg.enable_ipcm:
                j_best = min(j4, j16)
                s_best = MBState(self, addr)
                base.restore()
                self._commit_ipcm(addr)
                j_pcm = mb_ssd(self, addr) + lam * count_mb_bits(
                    self, addr, self.stype)
                if j_pcm >= j_best:
                    s_best.restore()
            pic.qp[addr] = self.qp
            return
        cost16, mode16, pred16 = self._eval_i16(addr, origY_mb)
        # try I4 on a scratch state; to avoid state snapshots, decide with a
        # cheap estimate first: run I4 fully only if its lower bound can win.
        # v1: always run I4 (it is the JM default winner at most QPs), then
        # compare against I16 by reconstruction SSD + bit-ish penalty.
        save = _MBSnapshot(self, addr)
        cost4, cbp_luma4 = self._encode_i4_mb(addr, origY_mb)
        if cost16 + 24 * self.lam < cost4:
            save.restore()
            pic.i4_modes[addr] = -1
            cbp_luma = self._encode_i16(addr, origY_mb, mode16, pred16)
        else:
            cbp_luma = cbp_luma4
        cbp_chroma = self._encode_chroma_intra(addr)
        pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma
        pic.qp[addr] = self.qp

    # ---- inter ------------------------------------------------------------

    # partition table: mode -> [(bx, by, bw, bh, quadrants)]
    PART_TABLE = {
        0: [(0, 0, 4, 4, (0, 1, 2, 3))],
        1: [(0, 0, 4, 2, (0, 1)), (0, 2, 4, 2, (2, 3))],
        2: [(0, 0, 2, 4, (0, 2)), (2, 0, 2, 4, (1, 3))],
        3: [(0, 0, 2, 2, (0,)), (2, 0, 2, 2, (1,)),
            (0, 2, 2, 2, (2,)), (2, 2, 2, 2, (3,))],
    }
    MODE_BITS = {0: 1, 1: 3, 2: 3, 3: 5 + 4}

    def _encode_p_mb(self, addr):
        pic = self.pic
        cfg = self.enc.cfg
        sr = cfg.search_range
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        origY_mb, origU_mb, origV_mb = self._mb_orig(addr)
        if cfg.enable_ipcm >= 2:           # forced IPCM (EnableIPCM=2)
            self._commit_ipcm(addr)
            return
        if addr in self.forced_intra:      # intra refresh (E34)
            _c, mode16, predi16 = self._eval_i16(addr, origY_mb)
            pic.ref_idx[addr] = -1
            cbp_luma = self._encode_i16(addr, origY_mb, mode16, predi16)
            cbp_chroma = self._encode_chroma_intra(addr)
            pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma
            return
        o = origY_mb.astype(np.int32)
        nref = len(self.refs_list)
        pred16 = self.pctx.mv_pred(addr, 0, 0, 4, 4, 0)

        # ---- partition mode decision over fast-full tables ----
        # Per-partition/per-ref MV predictors with incremental intra-MB
        # commits, like the reference's PartitionMotionSearch (each
        # partition's predictor sees the mode's earlier partitions in
        # all_mv; mv_search.c) — the search's rate term then prices mvd
        # against the predictor the serializer will actually use.
        candidates = {}
        for mode, parts in self.PART_TABLE.items():
            total = self.lam * self.MODE_BITS[mode]
            commit = []
            pic.mv[addr] = 0
            pic.ref_idx[addr] = -1
            for (bx, by, bw, bh, quads) in parts:
                best = None
                blk = self.origY[py + by * 4: py + by * 4 + bh * 4,
                                 px + bx * 4: px + bx * 4 + bw * 4]
                seed = None
                for r in range(nref):
                    pred = self.pctx.mv_pred(addr, bx, by, bw, bh, r)
                    if self.epzs is not None:
                        imv0 = self.epzs.search(addr, r, quads, pred,
                                                seed=seed)
                        if r == 0:
                            seed = imv0
                    else:
                        blks = ME.QUAD_BLKS[list(quads)].ravel()
                        csum = (self.qsads[r][addr][:, blks]
                                .sum(axis=1, dtype=np.int64)
                                + ME.int_rate_tab(pred, sr, self.lam))
                        imv0 = ME.best_int_mv_tiebreak(
                            csum, ME.spiral_rank_tab(pred, sr), sr)
                    # te(v) length of ref_idx_l0 (1 bit when the list has
                    # two entries, ue(v) otherwise; vlc.c refbits)
                    ref_bits = (1 if nref == 2 else ME.ue_len(r)) \
                        if nref > 1 else 0
                    qmv, cost = ME.subpel_refine(
                        blk, self.refs_list[r].luma_planes,
                        px + bx * 4, py + by * 4, imv0, self.w, self.h,
                        pred, self.lam, extra_bits=ref_bits,
                        use_satd=cfg.subpel_satd)
                    if best is None or cost < best[0]:
                        best = (cost, r, qmv)
                total += best[0]
                commit.append((bx, by, bw, bh, quads, best[1], best[2]))
                # provisional commit: later partitions of this mode (and
                # their predictors) see this partition's motion
                for yy in range(by, by + bh):
                    for xx in range(bx, bx + bw):
                        pic.mv[addr, yy * 4 + xx] = best[2]
                for q in quads:
                    pic.ref_idx[addr, q] = best[1]
            candidates[mode] = (total, commit)
        pic.mv[addr] = 0
        pic.ref_idx[addr] = -1

        # ---- P8x8 sub-partition refinement (E7, mode_decision_P8x8.c) ----
        sub_commit = None
        if cfg.sub8x8:
            total3 = self.lam * self.MODE_BITS[3]
            sub_commit = []
            # quadrants see earlier quadrants' chosen sub-motion, like
            # submacroblock_mode_decision's sequential quadrant loop
            pic.mv[addr] = 0
            pic.ref_idx[addr] = -1
            for (bx, by, _bw, _bh, quads, r, qmv8) in candidates[3][1]:
                planes = self.refs_list[r].luma_planes
                pic.ref_idx[addr, quads[0]] = r
                best_q = None
                for sm, parts in ME.SUB_PARTS.items():
                    mvs, cost_q = [], self.lam * ME.SUB_MODE_BITS[sm]
                    for (sx, sy, sw, sh) in parts:
                        pred = self.pctx.mv_pred(addr, bx + sx, by + sy,
                                                 sw, sh, r)
                        blk = self.origY[py + (by + sy) * 4:
                                         py + (by + sy + sh) * 4,
                                         px + (bx + sx) * 4:
                                         px + (bx + sx + sw) * 4]
                        if self.qsads is not None:
                            # dedicated integer search per sub-block from
                            # the 4x4 SAD tables (BlockMotionSearch per
                            # 8x4/4x8/4x4; mv_search.c) — a seeded-only
                            # refinement cannot capture sub-8x8 motion
                            # divergence
                            ids = [(by + sy + yy) * 4 + bx + sx + xx
                                   for yy in range(sh) for xx in range(sw)]
                            csum = (self.qsads[r][addr][:, ids]
                                    .sum(axis=1, dtype=np.int64)
                                    + ME.int_rate_tab(pred, sr, self.lam))
                            simv = ME.best_int_mv_tiebreak(
                                csum, ME.spiral_rank_tab(pred, sr), sr)
                            qmv, c = ME.subpel_refine(
                                blk, planes, px + (bx + sx) * 4,
                                py + (by + sy) * 4, simv, self.w, self.h,
                                pred, self.lam, use_satd=cfg.subpel_satd)
                        else:
                            qmv, c = ME.subpel_refine(
                                blk, planes, px + (bx + sx) * 4,
                                py + (by + sy) * 4, qmv8, self.w, self.h,
                                pred, self.lam, use_satd=cfg.subpel_satd,
                                qpel_start=True)
                        mvs.append(qmv)
                        cost_q += c
                        for yy in range(by + sy, by + sy + sh):
                            for xx in range(bx + sx, bx + sx + sw):
                                pic.mv[addr, yy * 4 + xx] = qmv
                    if best_q is None or cost_q < best_q[0]:
                        best_q = (cost_q, sm, mvs)
                # leave the winning sub-mode's motion committed for the
                # next quadrant's predictors
                for k, (sx, sy, sw, sh) in enumerate(
                        ME.SUB_PARTS[best_q[1]]):
                    for yy in range(by + sy, by + sy + sh):
                        for xx in range(bx + sx, bx + sx + sw):
                            pic.mv[addr, yy * 4 + xx] = best_q[2][k]
                total3 += best_q[0]
                sub_commit.append((bx, by, quads[0], r, best_q[1], best_q[2]))
            pic.mv[addr] = 0
            pic.ref_idx[addr] = -1
            if total3 < candidates[3][0]:
                candidates[3] = (total3, candidates[3][1])
            else:
                sub_commit = None
        skip_mv = self.pctx.skip_mv(addr)
        if self.enc.cfg.rdo:
            self._p_mode_rd(addr, candidates, sub_commit, skip_mv)
            return
        best_mode = min(candidates, key=lambda m: candidates[m][0])
        cost_inter, commit = candidates[best_mode]

        # skip candidate (16x16, ref 0, predicted mv, zero bits)
        planes0 = self.refs_list[0].luma_planes
        skip_pred = ip.mc_luma_block(planes0, px * 4 + int(skip_mv[0]),
                                     py * 4 + int(skip_mv[1]), 16, 16,
                                     self.w, self.h)
        if self.wp is not None:
            skip_pred = self.wp.uni(skip_pred, 0, 0, 0)
        cost_skip = int(np.abs(o - skip_pred).sum())
        if cost_skip <= cost_inter:
            best_mode = 0
            cost_inter = cost_skip
            commit = [(0, 0, 4, 4, (0, 1, 2, 3), 0, skip_mv.copy())]

        # intra-16 fallback for scene changes / uncovered areas
        cost16, mode16, predi16 = self._eval_i16(addr, origY_mb)
        if cost16 + 2 * self.lam4 < cost_inter:
            pic.ref_idx[addr] = -1
            cbp_luma = self._encode_i16(addr, origY_mb, mode16, predi16)
            cbp_chroma = self._encode_chroma_intra(addr)
            pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma
            return

        self._commit_inter_p(addr, best_mode, commit, sub_commit, skip_mv)

    def _commit_ipcm(self, addr):
        """I_PCM commit: raw samples, recon == samples (clamped to the
        pre-FRExt minimum of 1, lencod.c:1146 min_IPCM_value)."""
        from ..decoder.mb_parse import MB_IPCM
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        oY, oU, oV = self._mb_orig(addr)
        minv = 1 if self.enc.sps.profile_idc < 100 else 0
        Y = np.maximum(oY, minv).astype(np.uint8)
        U = np.maximum(oU, minv).astype(np.uint8)
        V = np.maximum(oV, minv).astype(np.uint8)
        pic.mb_class[addr] = MB_IPCM
        pic.ipcm_luma[addr] = Y
        pic.ipcm_chroma[addr] = np.stack([U, V])
        pic.luma_nnz[addr] = 16
        pic.chroma_nnz[addr] = 16
        pic.qp[addr] = self.qp
        pic.ref_idx[addr] = -1
        pic.cbp[addr] = 0
        self.recY[py:py + 16, px:px + 16] = Y
        cy, cx, ch = mby * self.ch_mb, px // 2, self.ch_mb
        self.recU[cy:cy + ch, cx:cx + 8] = U
        self.recV[cy:cy + ch, cx:cx + 8] = V

    def _p_mode_rd(self, addr, candidates, sub_commit, skip_mv):
        """md_high-family tiers (E6/E8): trial-encode the candidates and
        pick by J = SSD + lambda_mode * bits (exact CAVLC marginal bits;
        rdopt.c RDCost_for_macroblocks twin over the SoA state).

        cfg.rdo selects the tier exactly like the reference's
        RDOptimization switch (lencod/src/rdopt.c:242):
          1 = md_high; 2 = md_highfast (early-skip + selective-intra
          termination, md_highfast.c:95); 3 = md_highloss (the errdo
          expected-drift distortion term, md_highloss.c:38 — driven by
          NumberOfDecoders); 4 = md_high_updated (the reversed
          mb_mode_table_updated trial order, md_high_updated.c:40 +
          mode_decision.h:24)."""
        from .rdo import MBState, count_mb_bits, lambda_mode, mb_ssd
        pic = self.pic
        tier = self.enc.cfg.rdo
        lam = lambda_mode(self.qp)
        base = MBState(self, addr)
        best = None
        best_bits = 0

        errdo = self.enc.errdo

        def consider():
            nonlocal best, best_bits
            bits = count_mb_bits(self, addr, SliceType.P)
            j = mb_ssd(self, addr) + lam * bits
            if errdo is not None:   # expected drift of lossy decoders (E32)
                j += errdo.mb_error_energy(pic, addr, self.mb_w)
            if best is None or j < best[0]:
                best = (j, MBState(self, addr))
                best_bits = bits

        # inter partitions: md_high trials every enabled inter mode;
        # high_updated walks mb_mode_table_updated (P8x8 first)
        if tier == 4:
            order = [m for m in (3, 2, 1, 0) if m in candidates]
        else:
            order = sorted(candidates, key=lambda k: candidates[k][0])
        inter_skip = False
        for m in order:
            base.restore()
            self._commit_inter_p(addr, m, candidates[m][1],
                                 sub_commit if m == 3 else None, skip_mv)
            consider()
            if (tier == 2 and m == 0 and pic.cbp[addr] == 0
                    and pic.ref_idx[addr, 0] == 0
                    and (pic.mv[addr, 0] == skip_mv).all()):
                # md_highfast EarlySkipEnable: the 16x16 coding IS the
                # skip coding — stop trialing anything else
                inter_skip = True
                break
        if inter_skip:
            best[1].restore()
            return
        # forced P_SKIP (prediction only, zero residual)
        base.restore()
        self._commit_inter_p(addr, 0,
                             [(0, 0, 4, 4, (0, 1, 2, 3), 0, skip_mv.copy())],
                             None, skip_mv, no_residual=True)
        consider()
        if tier == 2 and self._highfast_intra_skip(addr, best_bits):
            best[1].restore()
            return
        # intra trials
        origY_mb = self._mb_orig(addr)[0]
        base.restore()
        _c, m16, p16 = self._eval_i16(addr, origY_mb)
        pic.ref_idx[addr] = -1
        cbp_luma = self._encode_i16(addr, origY_mb, m16, p16)
        cbp_chroma = self._encode_chroma_intra(addr)
        pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma
        consider()
        base.restore()
        pic.ref_idx[addr] = -1
        _c4, cbp_luma4 = self._encode_i4_mb(addr, origY_mb)
        cbp_chroma = self._encode_chroma_intra(addr)
        pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma4
        consider()
        if self.enc.cfg.enable_ipcm:
            base.restore()
            self._commit_ipcm(addr)
            if self.enc.cfg.enable_ipcm >= 2:
                return
            consider()
        best[1].restore()

    def _highfast_intra_skip(self, addr, best_bits: int) -> bool:
        """md_highfast SelectiveIntraEnable (fast_mode_intra_decision,
        md_highfast.c:40): skip the intra trials when the best inter
        coding's average rate AR = bits/384 is at most the average
        boundary error ABE (SAD of the source's top/left rows against
        the reconstructed neighbors, luma + both chroma, /64).
        Boundary MBs always keep the intra trials (ABE = 0 rule)."""
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        if (mbx == 0 or mby == 0 or mbx == self.mb_w - 1
                or mby == self.mb_h - 1):
            return False
        px, py = mbx * 16, mby * 16
        o = self._mb_orig(addr)[0].astype(np.int32)
        sbe = int(np.abs(o[0] - self.recY[py - 1, px:px + 16]
                         .astype(np.int32)).sum())
        sbe += int(np.abs(o[:, 0] - self.recY[py:py + 16, px - 1]
                          .astype(np.int32)).sum())
        mh = self.ch_mb
        cx, cy = mbx * 8, mby * mh
        for plane, orig in ((self.recU, self.origU), (self.recV, self.origV)):
            oc = orig[cy:cy + mh, cx:cx + 8].astype(np.int32)
            sbe += int(np.abs(oc[0] - plane[cy - 1, cx:cx + 8]
                              .astype(np.int32)).sum())
            sbe += int(np.abs(oc[:, 0] - plane[cy:cy + mh, cx - 1]
                              .astype(np.int32)).sum())
        return best_bits / 384.0 <= sbe / 64.0

    def _commit_inter_p(self, addr, best_mode, commit, sub_commit, skip_mv,
                        no_residual=False):
        """Commit chosen P motion, assemble prediction, code residual."""
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        o = self._mb_orig(addr)[0].astype(np.int32)
        pic.mb_class[addr] = MB_INTER
        pic.inter_mode[addr] = best_mode
        if best_mode == 3 and sub_commit is not None:
            for (bx, by, q, r, sm, mvs) in sub_commit:
                pic.sub_mode[addr, q] = sm
                pic.ref_idx[addr, q] = r
                pic.ref_pic_id[addr, q] = self.refs_list[r].uid
                pic.pdir[addr, q] = 0
                for (sx, sy, sw, sh), qmv in zip(ME.SUB_PARTS[sm], mvs):
                    for yy in range(by + sy, by + sy + sh):
                        for xx in range(bx + sx, bx + sx + sw):
                            pic.mv[addr, yy * 4 + xx] = qmv
        else:
            for (bx, by, bw, bh, quads, r, qmv) in commit:
                for yy in range(by, by + bh):
                    for xx in range(bx, bx + bw):
                        pic.mv[addr, yy * 4 + xx] = qmv
                for q in quads:
                    pic.ref_idx[addr, q] = r
                    pic.ref_pic_id[addr, q] = self.refs_list[r].uid
                    pic.pdir[addr, q] = 0

        # ---- prediction assembly (mirrors decoder recon granularity) ----
        cbh = self.ch_mb // 4                # chroma rows per luma 4x4 row
        pred_y = np.zeros((16, 16), np.int64)
        pred_u = np.zeros((self.ch_mb, 8), np.int64)
        pred_v = np.zeros((self.ch_mb, 8), np.int64)
        for blk in range(16):
            byy, bxx = divmod(blk, 4)
            q = (byy // 2) * 2 + (bxx // 2)
            r = int(pic.ref_idx[addr, q])
            rf = self.refs_list[r]
            mvx, mvy = int(pic.mv[addr, blk, 0]), int(pic.mv[addr, blk, 1])
            x4 = (px + bxx * 4) * 4 + mvx
            y4 = (py + byy * 4) * 4 + mvy
            yb = ip.mc_luma_block(rf.luma_planes, x4, y4, 4, 4,
                                  self.w, self.h)
            ub, vb = self._mc_chroma(rf, px, py, bxx, byy, mvx, mvy)
            if self.wp is not None:
                yb = self.wp.uni(yb, 0, r, 0)
                ub = self.wp.uni(ub, 0, r, 1)
                vb = self.wp.uni(vb, 0, r, 2)
            pred_y[byy * 4:byy * 4 + 4, bxx * 4:bxx * 4 + 4] = yb
            pred_u[byy * cbh:(byy + 1) * cbh, bxx * 2:bxx * 2 + 2] = ub
            pred_v[byy * cbh:(byy + 1) * cbh, bxx * 2:bxx * 2 + 2] = vb

        is_sp = self.stype == SliceType.SP
        if is_sp:
            pic.sp_mb[addr] = True
            pic.sp_slice[addr] = True
            pic.sp_qs[addr] = self.qs
        if no_residual:
            # forced P_SKIP trial: reconstruction is the prediction (SP:
            # the QS-requantized prediction, zero levels)
            cy, cx, ch = mby * self.ch_mb, px // 2, self.ch_mb
            if is_sp:
                recy, recu, recv = self._sp_recon(addr, pred_y, pred_u,
                                                  pred_v)
                self.recY[py:py + 16, px:px + 16] = recy
                self.recU[cy:cy + ch, cx:cx + 8] = recu
                self.recV[cy:cy + ch, cx:cx + 8] = recv
            else:
                self.recY[py:py + 16, px:px + 16] = np.clip(pred_y, 0, 255)
                self.recU[cy:cy + ch, cx:cx + 8] = np.clip(pred_u, 0, 255)
                self.recV[cy:cy + ch, cx:cx + 8] = np.clip(pred_v, 0, 255)
            pic.cbp[addr] = 0
            if (best_mode == 0 and pic.ref_idx[addr, 0] == 0
                    and (pic.mv[addr, 0] == skip_mv).all()):
                pic.skip[addr] = True
            return

        # ---- residual ----
        if is_sp:
            cbp_luma = self._code_luma_inter_sp(addr, o, pred_y)
            cbp_chroma = self._code_chroma_sp(addr, pred_u, pred_v)
        else:
            cbp_luma = self._code_luma_inter(addr, o, pred_y)
            cbp_chroma = self._code_chroma_residual(addr, pred_u, pred_v,
                                                    intra=False)
        pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma

        # skip: 16x16, ref 0, mv == skip mv, no coefficients
        if (best_mode == 0 and pic.cbp[addr] == 0
                and pic.ref_idx[addr, 0] == 0
                and (pic.mv[addr, 0] == skip_mv).all()):
            pic.skip[addr] = True


    def _code_luma_inter(self, addr, o, pred_y):
        """Inter luma residual: adaptive 4x4 / 8x8 transform (High profile,
        lencod md_low transform-size decision folded to an SSD + coefficient
        -count cost). Commits coeffs, nnz, recon; returns cbp_luma."""
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        res = o.astype(np.int64) - pred_y
        blocks = res.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
        w4 = RN.np_forward4x4(blocks)
        if self._rdoq_on:
            scan4 = np.zeros((16, 16), np.int64)
            for code in range(16):
                blk = int(CODE2RASTER[code])
                scan4[blk] = self._trellis_luma4(addr, w4[blk], blk,
                                                 intra=False)
                pic.luma_nnz[addr, blk] = int((scan4[blk] != 0).sum())
        else:
            lev4 = self._q4(w4, self.qp, False)
            scan4 = RN.to_scan(lev4)
        # JM coefficient thresholding (macroblock.c:901,1248): zero inter
        # 8x8 quadrants whose run-weighted cost is negligible, then the
        # whole MB if the surviving total still is
        qb_map = [[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13],
                  [10, 11, 14, 15]]
        total_cost = 0
        for qb in qb_map:
            cq = sum(RN.coeff_cost_scan(scan4[b]) for b in qb)
            if cq <= RN.LUMA_COEFF_COST:
                scan4[qb] = 0
            else:
                total_cost += cq
        if total_cost <= RN.LUMA_MB_COEFF_COST:
            scan4[:] = 0
        if self._rdoq_on:
            for blk in range(16):
                pic.luma_nnz[addr, blk] = int((scan4[blk] != 0).sum())
        pred_blocks = pred_y.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(16, 4, 4)
        rec4 = RN.recon_luma_4x4(pred_blocks, scan4, self.qp,
                                 tab=self._itab4(False))
        rec4_16 = rec4.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        use8 = False
        # 8x8 transform needs every partition >= 8x8 (spec 7.4.5.1)
        allow8 = (int(pic.inter_mode[addr]) != 3
                  or not pic.sub_mode[addr].any())
        if self.enc.cfg.transform8x8 and allow8:
            q8 = res.reshape(2, 8, 2, 8).transpose(0, 2, 1, 3).reshape(4, 8, 8)
            w8 = RN.np_forward8x8(q8)
            if self._rdoq_on and self.enc.cfg.entropy == "cabac":
                from . import rdoq as RQ
                scan8 = np.zeros((4, 64), np.int64)
                for qb in range(4):
                    scan8[qb] = RQ.trellis_8x8(
                        RN.to_scan8(w8[qb][None])[0], self.qp, False,
                        self._rdoq_lam(), ctxs=self.cabac_rate.w.ctxs)
            else:
                lev8 = self._q8(w8, self.qp, False)
                scan8 = RN.to_scan8(lev8)                 # (4, 64)
            # thresholding, 8x8-transform twin (COEFF_COST8x8)
            total8 = 0
            for qb in range(4):
                c8 = RN.coeff_cost_scan(scan8[qb], tab=RN.COEFF_COST8)
                if c8 <= RN.LUMA_COEFF_COST:
                    scan8[qb] = 0
                else:
                    total8 += c8
            if total8 <= RN.LUMA_MB_COEFF_COST:
                scan8[:] = 0
            n8 = int((scan8 != 0).sum())
            if n8:
                pred8 = pred_y.reshape(2, 8, 2, 8).transpose(0, 2, 1, 3) \
                    .reshape(4, 8, 8)
                rec8q = RN.recon_luma_8x8(pred8, scan8, self.qp,
                                          tab=self._itab8(False))
                rec8_16 = rec8q.reshape(2, 2, 8, 8).transpose(0, 2, 1, 3) \
                    .reshape(16, 16)
                o64 = o.astype(np.int64)
                d4 = int(((o64 - rec4_16) ** 2).sum())
                d8 = int(((o64 - rec8_16) ** 2).sum())
                n4 = int((scan4 != 0).sum())
                use8 = d8 + self.lam4 * n8 < d4 + self.lam4 * n4
        if use8:
            pic.transform8x8[addr] = True
            pic.luma_coef8[addr] = scan8
            cbp_luma = 0
            for q in range(4):
                if scan8[q].any():
                    cbp_luma |= 1 << q
                # CAVLC interleave: sub-block k-th coeff = scan8[q, 4k+sub]
                by0, bx0 = (q // 2) * 2, (q % 2) * 2
                for sub in range(4):
                    blk = (by0 + sub // 2) * 4 + bx0 + sub % 2
                    pic.luma_nnz[addr, blk] = int(
                        (scan8[q, sub::4] != 0).sum())
            self.recY[py:py + 16, px:px + 16] = rec8_16
            return cbp_luma
        pic.luma_coef[addr] = scan4
        nnz = (scan4 != 0).sum(axis=1)
        pic.luma_nnz[addr] = nnz
        cbp_luma = 0
        for q in range(4):
            qb = [0, 1, 4, 5] if q == 0 else [2, 3, 6, 7] if q == 1 \
                else [8, 9, 12, 13] if q == 2 else [10, 11, 14, 15]
            if nnz[qb].any():
                cbp_luma |= 1 << q
        self.recY[py:py + 16, px:px + 16] = rec4_16
        return cbp_luma

    # ---- B slices ---------------------------------------------------------

    # ---- SP switching slices (E35) ------------------------------------

    def _sp_lam(self) -> float:
        # lencod block.c:1551 lambda_mode = 0.85 * 2^((qp-12)/3) * 4
        return 0.85 * 2.0 ** ((self.qp - 12) / 3.0) * 4.0

    def _code_luma_inter_sp(self, addr, o, pred_y) -> int:
        """SP inter luma: levels via the JM two-candidate RD quantizer
        (residual_transform_quant_luma_4x4_sp, block.c:1518), JM quadrant/
        MB coefficient thresholding applied to the LEVELS before the
        decoder-twin requantized reconstruction (self-consistent)."""
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        lam = self._sp_lam()
        ob = o.astype(np.int64).reshape(4, 4, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(16, 4, 4)
        pb = pred_y.astype(np.int64).reshape(4, 4, 4, 4) \
            .transpose(0, 2, 1, 3).reshape(16, 4, 4)
        scan4 = np.zeros((16, 16), np.int64)
        Ps = np.zeros((16, 4, 4), np.int64)
        for blk in range(16):
            scan4[blk], Ps[blk] = RN.sp_luma_levels(ob[blk], pb[blk],
                                                    self.qp, self.qs, lam)
        qb_map = [[0, 1, 4, 5], [2, 3, 6, 7], [8, 9, 12, 13],
                  [10, 11, 14, 15]]
        total_cost = 0
        for qb in qb_map:
            cq = sum(RN.coeff_cost_scan(scan4[b]) for b in qb)
            if cq <= RN.LUMA_COEFF_COST:
                scan4[qb] = 0
            else:
                total_cost += cq
        if total_cost <= RN.LUMA_MB_COEFF_COST:
            scan4[:] = 0
        rec4 = RN.sp_luma_recon(Ps, scan4, self.qp, self.qs)
        self.recY[py:py + 16, px:px + 16] = \
            rec4.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        cbp_luma = 0
        for q, qb in enumerate(qb_map):
            nz = False
            for b in qb:
                tc = int((scan4[b] != 0).sum())
                pic.luma_coef[addr, b] = scan4[b]
                pic.luma_nnz[addr, b] = tc
                nz = nz or tc > 0
            if nz:
                cbp_luma |= 1 << q
        return cbp_luma

    def _code_chroma_sp(self, addr, pred_u, pred_v) -> int:
        """SP chroma (residual_transform_quant_chroma_4x4_sp,
        block.c:1700): DC through the prediction's 2x2 Hadamard, AC like
        luma; decoder-twin requantized recon."""
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        cx, cy = mbx * 8, mby * self.ch_mb
        lam = self._sp_lam()
        pps = self.enc.pps
        qpc = chroma_qp(self.qp, pps.chroma_qp_index_offset)
        qsc = chroma_qp(self.qs, pps.chroma_qp_index_offset)
        ou = self.origU[cy:cy + 8, cx:cx + 8].astype(np.int64)
        ov = self.origV[cy:cy + 8, cx:cx + 8].astype(np.int64)
        any_dc = any_ac = False
        for comp, (orig8, pred8, plane) in enumerate(
                ((ou, pred_u, self.recU), (ov, pred_v, self.recV))):
            dc, ac, P, mp1 = RN.sp_chroma_levels(orig8, pred8, qpc, qsc,
                                                 lam)
            pic.chroma_dc[addr, comp] = dc
            pic.chroma_coef[addr, comp] = ac
            for b in range(4):
                pic.chroma_nnz[addr, comp, b] = int((ac[b, 1:] != 0).sum())
            any_dc = any_dc or bool((dc != 0).any())
            any_ac = any_ac or bool((ac != 0).any())
            plane[cy:cy + 8, cx:cx + 8] = RN.sp_chroma_recon(
                P, mp1, dc, ac, qpc, qsc)
        return 2 if any_ac else (1 if any_dc else 0)

    def _sp_recon(self, addr, pred_y, pred_u, pred_v):
        """SP reconstruction with zero levels (forced-skip path): the
        QS-requantized prediction."""
        pb = pred_y.astype(np.int64).reshape(4, 4, 4, 4) \
            .transpose(0, 2, 1, 3).reshape(16, 4, 4)
        Ps = RN.np_forward4x4(pb)
        rec4 = RN.sp_luma_recon(Ps, np.zeros((16, 16), np.int64),
                                self.qp, self.qs)
        recy = rec4.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
        pps = self.enc.pps
        qpc = chroma_qp(self.qp, pps.chroma_qp_index_offset)
        qsc = chroma_qp(self.qs, pps.chroma_qp_index_offset)
        outc = []
        for pred8 in (pred_u, pred_v):
            pbc = pred8.astype(np.int64).reshape(2, 4, 2, 4) \
                .transpose(0, 2, 1, 3)
            P = RN.np_forward4x4(pbc.reshape(4, 4, 4)).reshape(2, 2, 4, 4)
            mp1 = np.array(RN._h2(P))
            outc.append(RN.sp_chroma_recon(
                P, mp1, np.zeros(4, np.int64), np.zeros((4, 16), np.int64),
                qpc, qsc))
        return recy, outc[0], outc[1]

    def _mc_chroma(self, ref, px, py, bx, by, mvx, mvy):
        """Chroma MC for one luma 4x4 (2x2 in 4:2:0, 2x4 in 4:2:2 where the
        luma quarter-pel vector doubles into eighth-pel — decoder _mc_4x4
        recon.py twin)."""
        cx8 = (px // 2 + bx * 2) * 8 + mvx
        # field pictures: opposite-parity references shift the chroma
        # vector by -/+2 quarter-pel (spec 8.4.1.4.1; the decoder's
        # recon._mc_4x4 cadj twin)
        cadj = 0
        if self.cur_parity is not None:
            rpar = getattr(ref, "parity", None)
            if rpar is not None and rpar != self.cur_parity:
                cadj = -2 if self.cur_parity == 0 else 2
        if self.crows == 2:
            cy8 = (py // 2 + by * 2) * 8 + mvy + cadj
            cbh, chh = 2, self.h // 2
        else:
            cy8 = (py + by * 4) * 8 + mvy * 2
            cbh, chh = 4, self.h
        ub = ip.mc_chroma_block(ref.chroma_pad[0], cx8, cy8, 2, cbh,
                                self.w // 2, chh)
        vb = ip.mc_chroma_block(ref.chroma_pad[1], cx8, cy8, 2, cbh,
                                self.w // 2, chh)
        return ub, vb

    def _mc_blk_b(self, ref, px, py, bx, by, mv):
        """4x4 luma + chroma MC from one reference (decoder's _mc_4x4)."""
        mvx, mvy = int(mv[0]), int(mv[1])
        x4 = (px + bx * 4) * 4 + mvx
        y4 = (py + by * 4) * 4 + mvy
        yb = ip.mc_luma_block(ref.luma_planes, x4, y4, 4, 4, self.w, self.h)
        ub, vb = self._mc_chroma(ref, px, py, bx, by, mvx, mvy)
        return yb, ub, vb

    def _b_pred_assemble(self, addr):
        """Prediction from the pic motion rows of addr, exactly mirroring
        the decoder's Reconstructor._recon_inter granularity (per-4x4 MC,
        bi average (p0+p1+1)>>1)."""
        pic = self.pic
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        pred_y = np.zeros((16, 16), np.int32)
        pred_u = np.zeros((self.ch_mb, 8), np.int32)
        pred_v = np.zeros((self.ch_mb, 8), np.int32)
        wp = self.wp
        cbh = self.ch_mb // 4
        for blk in range(16):
            byy, bxx = divmod(blk, 4)
            q = (byy // 2) * 2 + (bxx // 2)
            pd = int(pic.pdir[addr, q])
            r0 = int(pic.ref_idx[addr, q])
            r1 = int(pic.ref_idx_l1[addr, q])
            if pd in (0, 2):
                y0, u0, v0 = self._mc_blk_b(
                    self.refs_list[r0], px, py, bxx, byy,
                    pic.mv[addr, blk])
            if pd in (1, 2):
                y1, u1, v1 = self._mc_blk_b(
                    self.refs_list1[r1], px, py,
                    bxx, byy, pic.mv_l1[addr, blk])
            if pd == 0:
                yb, ub, vb = y0, u0, v0
                if wp is not None:
                    yb, ub, vb = (wp.uni(yb, 0, r0, 0), wp.uni(ub, 0, r0, 1),
                                  wp.uni(vb, 0, r0, 2))
            elif pd == 1:
                yb, ub, vb = y1, u1, v1
                if wp is not None:
                    yb, ub, vb = (wp.uni(yb, 1, r1, 0), wp.uni(ub, 1, r1, 1),
                                  wp.uni(vb, 1, r1, 2))
            elif wp is not None:
                yb = wp.bi(y0, y1, r0, r1, 0)
                ub = wp.bi(u0, u1, r0, r1, 1)
                vb = wp.bi(v0, v1, r0, r1, 2)
            else:
                yb = (y0 + y1 + 1) >> 1
                ub = (u0 + u1 + 1) >> 1
                vb = (v0 + v1 + 1) >> 1
            pred_y[byy * 4:byy * 4 + 4, bxx * 4:bxx * 4 + 4] = yb
            pred_u[byy * cbh:(byy + 1) * cbh, bxx * 2:bxx * 2 + 2] = ub
            pred_v[byy * cbh:(byy + 1) * cbh, bxx * 2:bxx * 2 + 2] = vb
        return pred_y, pred_u, pred_v

    def _commit_inter_residual(self, addr, o, pred_y, pred_u, pred_v):
        """Luma+chroma inter residual coding + recon; sets pic.cbp."""
        pic = self.pic
        cbp_luma = self._code_luma_inter(addr, o, pred_y)
        cbp_chroma = self._code_chroma_residual(addr, pred_u.astype(np.int64),
                                                pred_v.astype(np.int64),
                                                intra=False)
        pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma

    def _encode_b_mb(self, addr):
        """B MB mode decision: spatial direct vs 16x16 {L0, L1, BI} vs I16
        (the md_low B subset; finer partitions follow in a later phase)."""
        from ..decoder.b_slice import (PD_BI, PD_L0, PD_L1,
                                       prepare_direct_params,
                                       spatial_direct_quadrant)
        pic = self.pic
        if self.enc.cfg.enable_ipcm >= 2:  # forced IPCM (EnableIPCM=2)
            self._commit_ipcm(addr)
            pic.pdir[addr] = -1
            pic.ref_idx_l1[addr] = -1
            return
        sr = self.enc.cfg.search_range
        mbx, mby = addr % self.mb_w, addr // self.mb_w
        px, py = mbx * 16, mby * 16
        origY_mb, _origU_mb, _origV_mb = self._mb_orig(addr)
        o = origY_mb.astype(np.int32)
        f0, f1 = self.refs_list[0], self.refs_list1[0]

        # ---- spatial direct trial (writes motion rows; every other
        # candidate fully overwrites them on commit)
        dp = prepare_direct_params(self.pctx, addr)
        for q in range(4):
            spatial_direct_quadrant(pic, addr, q, dp[0], dp[1], dp[2], dp[3],
                                    self.b_col)
        dpred_y, dpred_u, dpred_v = self._b_pred_assemble(addr)
        cost_direct = int(np.abs(o - dpred_y).sum()) + self.lam

        # ---- 16x16 single-list candidates (fast-full tables + subpel)
        def best16(qs, epzs, planes, lst):
            pred_mv = self.pctx.mv_pred(addr, 0, 0, 4, 4, 0, lst)
            if epzs is not None:
                imv0 = epzs.search(addr, 0, (0, 1, 2, 3), pred_mv)
            else:
                csum = (qs[0][addr].sum(axis=1, dtype=np.int64)
                        + ME.int_rate_tab(pred_mv, sr, self.lam))
                imv0 = ME.best_int_mv_tiebreak(
                    csum, ME.spiral_rank_tab(pred_mv, sr), sr)
            qmv, cost = ME.subpel_refine(origY_mb, planes, px, py, imv0,
                                         self.w, self.h, pred_mv, self.lam,
                                         use_satd=self.enc.cfg.subpel_satd)
            return qmv, cost, pred_mv

        mv0, cost_l0, pm0 = best16(self.qsads, self.epzs, f0.luma_planes, 0)
        mv1, cost_l1, pm1 = best16(self.qsads1, self.epzs1, f1.luma_planes, 1)
        cost_l0 += 3 * self.lam
        cost_l1 += 3 * self.lam

        # ---- bidirectional average of the two best single-list MVs
        p0 = ip.mc_luma_block(f0.luma_planes, px * 4 + int(mv0[0]),
                              py * 4 + int(mv0[1]), 16, 16, self.w, self.h)
        p1 = ip.mc_luma_block(f1.luma_planes, px * 4 + int(mv1[0]),
                              py * 4 + int(mv1[1]), 16, 16, self.w, self.h)
        bi = (p0 + p1 + 1) >> 1
        cost_bi = int(np.abs(o - bi).sum()) + self.lam * (
            5 + ME.mv_bits(int(mv0[0] - pm0[0]), int(mv0[1] - pm0[1])) +
            ME.mv_bits(int(mv1[0] - pm1[0]), int(mv1[1] - pm1[1])))

        best = min(cost_direct, cost_l0, cost_l1, cost_bi)

        # ---- intra-16 fallback
        cost16, mode16, predi16 = self._eval_i16(addr, origY_mb)
        if cost16 + 2 * self.lam4 < best:
            pic.mb_class[addr] = MB_I16
            pic.pdir[addr] = -1
            pic.ref_idx[addr] = -1
            pic.ref_idx_l1[addr] = -1
            pic.ref_pic_id[addr] = -1
            pic.ref_pic_id_l1[addr] = -1
            pic.mv[addr] = 0
            pic.mv_l1[addr] = 0
            cbp_luma = self._encode_i16(addr, origY_mb, mode16, predi16)
            cbp_chroma = self._encode_chroma_intra(addr)
            pic.cbp[addr] = (cbp_chroma << 4) | cbp_luma
            return

        pic.mb_class[addr] = MB_INTER
        if best == cost_direct:
            # rows already hold direct motion
            pic.b_direct[addr] = True
            for q in range(4):
                pic.ref_pic_id[addr, q] = \
                    f0.uid if pic.ref_idx[addr, q] >= 0 else -1
                pic.ref_pic_id_l1[addr, q] = \
                    f1.uid if pic.ref_idx_l1[addr, q] >= 0 else -1
            pred_y, pred_u, pred_v = dpred_y, dpred_u, dpred_v
        else:
            if best == cost_l0:
                pd, r0, r1, mva, mvb = PD_L0, 0, -1, mv0, (0, 0)
            elif best == cost_l1:
                pd, r0, r1, mva, mvb = PD_L1, -1, 0, (0, 0), mv1
            else:
                pd, r0, r1, mva, mvb = PD_BI, 0, 0, mv0, mv1
            pic.b_direct[addr] = False
            pic.pdir[addr] = pd
            pic.ref_idx[addr] = r0
            pic.ref_idx_l1[addr] = r1
            pic.ref_pic_id[addr] = f0.uid if r0 >= 0 else -1
            pic.ref_pic_id_l1[addr] = f1.uid if r1 >= 0 else -1
            pic.mv[addr] = np.asarray(mva, np.int32)
            pic.mv_l1[addr] = np.asarray(mvb, np.int32)
            pred_y, pred_u, pred_v = self._b_pred_assemble(addr)

        self._commit_inter_residual(addr, o, pred_y, pred_u, pred_v)

        # B skip: direct prediction with no coded residual
        if pic.b_direct[addr] and pic.cbp[addr] == 0:
            pic.skip[addr] = True


class _MBSnapshot:
    """Save/restore of per-MB mutable state for candidate trials (the
    moral equivalent of lencod/src/rdopt_coding_state.c)."""

    def __init__(self, fe: _FrameEncoder, addr: int):
        self.fe = fe
        self.addr = addr
        mbx, mby = addr % fe.mb_w, addr // fe.mb_w
        self.px, self.py = mbx * 16, mby * 16
        self.recY = fe.recY[self.py:self.py + 16, self.px:self.px + 16].copy()
        p = fe.pic
        self.coef = p.luma_coef[addr].copy()
        self.nnz = p.luma_nnz[addr].copy()
        self.modes = p.i4_modes[addr].copy()
        self.cls = p.mb_class[addr]
        # adaptive-rounding pending fadjust (q_around.c store/update dance)
        self.ar = fe.qctx.ar_snapshot() if fe.qctx is not None else None

    def restore(self):
        fe, addr = self.fe, self.addr
        fe.recY[self.py:self.py + 16, self.px:self.px + 16] = self.recY
        p = fe.pic
        p.luma_coef[addr] = self.coef
        p.luma_nnz[addr] = self.nnz
        p.i4_modes[addr] = self.modes
        p.mb_class[addr] = self.cls
        if self.ar is not None:
            fe.qctx.ar_restore(self.ar)
