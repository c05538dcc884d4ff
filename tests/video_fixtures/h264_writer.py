"""An H.264 writer of the tests' own: nothing in cv2's wheel encodes H.264,
so the port's decoder is held to cv2's decoder on streams written here.

Two kinds of stream, of frame pictures:

* :func:`syntax_clip` makes seeded random choices over every tool the
  port's decoder names in ``native.H264_TALLY``: CAVLC or CABAC (an
  arithmetic coder and context selection written from clause 9.3), I, P and
  B slices, macroblock and sub-macroblock types, Intra 4x4 / 8x8 / 16x16 /
  chroma modes (only those whose neighbouring samples are available,
  ``constrained_intra_pred`` respected), the 8x8 transform, residual levels
  of every CAVLC suffix length and escape and CABAC's escapes, motion vector
  differences and reference indices of both lists, spatial and temporal
  direct prediction (temporal only where the co-located picture's references
  are all in the current list 0), B pictures in display order after their
  anchor and as references (a pyramid), explicit weights (one picture twice
  in a P list with its own weights, as x264's weightp) and implicit ones,
  scaling lists in the SPS and PPS with both fall-back rules, several slices
  a picture with their own QP and deblocking control, multiple and long-term
  references, reference list modifications of both lists, MMCO 1-6, non-
  reference pictures, the three POC types, frame cropping and the VUI's
  range and reordering. The pictures are noise; libavcodec's reconstruction
  of them is the oracle.
* :func:`encode` codes real frames in the Baseline profile: an IDR picture
  of Intra 16x16 macroblocks (the writer reconstructs them as a decoder
  does, for the next macroblocks' prediction), then P pictures of
  zero-vector 16x16 partitions and skipped macroblocks against the decoded
  previous frame, which ``reference`` (libavcodec through ctypes) hands
  back, so the writer needs no deblocking filter of its own.
  :func:`encode_high` codes them in the High profile as x264's defaults do:
  CABAC, the 8x8 transform, P pictures and a pyramid of B pictures whose
  macroblocks are direct with implicit weights.

Each returns access units: lists of NAL units (bytes, without start codes).
:func:`annex_b`, :func:`length_prefixed` and :func:`avcc` lay them out
for AVI (start codes), and MP4 / Matroska (lengths and an avcC record).
The tables are ITU-T H.264's (Tables 7-3, 7-4, 9-4, 9-5, 9-7 to 9-10, and
CABAC's in ``h264_cabac_tables``).
"""

from __future__ import annotations

import numpy as np

from tests.video_fixtures import h264_cabac_tables as T

COEFF_TOKEN_LEN = [
    [1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13,
     13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16,
     16, 16, 16, 16, 16, 16],
    [2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7,
     12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13,
     14, 14, 14, 14],
    [4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8,
     7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10],
    [6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0] + [6] * 56,
]
COEFF_TOKEN_BITS = [
    [1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4,
     15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5,
     8],
    [3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4,
     15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4],
    [15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9,
     8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11, 10, 5,
     8, 7, 6, 1, 4, 3, 2],
    [3, 0, 0, 0, 0, 1, 0, 0, 4, 5, 6, 0] + list(range(8, 64)),
]
CHROMA_DC_LEN = [2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7]
CHROMA_DC_BITS = [1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0]
TOTAL_ZEROS_LEN = [[1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9], [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
                   [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6], [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
                   [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5], [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6], [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
                   [6, 4, 5, 3, 2, 2, 3, 3, 6], [6, 6, 4, 2, 2, 3, 2, 5], [5, 5, 3, 2, 2, 2, 4], [4, 4, 3, 3, 1, 3],
                   [4, 4, 2, 1, 3], [3, 3, 1, 2], [2, 2, 1], [1, 1]]
TOTAL_ZEROS_BITS = [[1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1], [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
                    [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0], [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
                    [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0], [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0], [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
                    [1, 1, 1, 3, 3, 2, 2, 1, 0], [1, 0, 1, 3, 2, 1, 1, 1], [1, 0, 1, 3, 2, 1, 1], [0, 1, 1, 2, 1, 3],
                    [0, 1, 1, 1, 1], [0, 1, 1, 1], [0, 1, 1], [0, 1]]
CDC_TOTAL_ZEROS_LEN = [[1, 2, 3, 3], [1, 2, 2], [1, 1]]
CDC_TOTAL_ZEROS_BITS = [[1, 1, 1, 0], [1, 1, 0], [1, 0]]
RUN_LEN = [[1, 1], [1, 2, 2], [2, 2, 2, 2], [2, 2, 2, 3, 3], [2, 2, 3, 3, 3, 3], [2, 3, 3, 3, 3, 3, 3],
           [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11]]
RUN_BITS = [[1, 0], [1, 1, 0], [3, 2, 1, 0], [3, 2, 1, 1, 0], [3, 2, 3, 2, 1, 0], [3, 0, 1, 3, 2, 5, 4],
            [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1]]
INTRA_CBP = [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46, 16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37,
             42, 44, 1, 2, 4, 8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41]
INTER_CBP = [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39,
             43, 45, 46, 17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41]
INTRA_CBP_CODE = {c: i for i, c in enumerate(INTRA_CBP)}
INTER_CBP_CODE = {c: i for i, c in enumerate(INTER_CBP)}
ZIGZAG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]  # scan index -> raster x + 4 y
ZIGZAG8 = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
           21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
           60, 61, 54, 47, 55, 62, 63]  # scan index -> raster x + 8 y
NORM8 = [[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26], [26, 23, 42, 24, 33, 31], [28, 25, 45, 26, 35, 33],
         [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]]  # normAdjust8x8 by qP % 6 and class
BLOCK_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 2),
               (3, 2), (2, 3), (3, 3)]  # luma4x4BlkIdx -> (x, y)
DEQUANT = [[10, 16, 13], [11, 18, 14], [13, 20, 16], [14, 23, 18], [16, 25, 20], [18, 29, 23]]
QUANT = [[13107, 5243, 8066], [11916, 4660, 7490], [10082, 4194, 6554], [9362, 3647, 5825], [8192, 3355, 5243],
         [7282, 2893, 4559]]
CHROMA_QP = list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39]
SUB_SIZES = [(2, 2), (2, 1), (1, 2), (1, 1)]  # sub_mb_type -> (width, height) in 4x4 blocks


class Bits:
    """An RBSP written bit by bit."""

    def __init__(self):
        self.parts: list = []
        self.n = 0

    def u(self, n: int, v: int) -> None:
        if n:
            assert 0 <= v < (1 << n), (n, v)
            self.parts.append(format(v, f"0{n}b"))
            self.n += n

    def ue(self, v: int) -> None:
        v1 = v + 1
        k = v1.bit_length()
        self.u(k - 1, 0)
        self.u(k, v1)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, cmax: int, v: int) -> None:
        if cmax == 1:
            self.u(1, 1 - v)
        else:
            self.ue(v)

    def align_zero(self) -> None:
        self.u(-self.n % 8, 0)

    def rbsp(self, stop: bool = True) -> bytes:
        """The bytes, ended by the rbsp_stop_one_bit (a CABAC slice's last flush wrote its own) and zeros."""
        if stop:
            self.u(1, 1)
        self.align_zero()
        s = "".join(self.parts)
        return int(s, 2).to_bytes(len(s) // 8, "big")


def nal(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    """A NAL unit: its header and the RBSP with emulation prevention bytes."""
    out = bytearray([ref_idc << 5 | kind])
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def annex_b(unit: list, long_codes: bool = True) -> bytes:
    """An access unit with start codes (four bytes for parameter sets and the first slice, else three, or all
    four with ``long_codes``)."""
    out = b""
    for i, n in enumerate(unit):
        out += (b"\0\0\0\1" if long_codes or i == 0 or n[0] & 0x1F in (7, 8) else b"\0\0\1") + n
    return out


def length_prefixed(unit: list, size: int = 4) -> bytes:
    return b"".join(len(n).to_bytes(size, "big") + n for n in unit)


def avcc(sps: list, pps: list, size: int = 4) -> bytes:
    """An AVCDecoderConfigurationRecord (avcC) of the parameter sets, NAL lengths of ``size`` bytes."""
    s0 = sps[0]
    out = bytes([1, s0[1], s0[2], s0[3], 0xFC | (size - 1), 0xE0 | len(sps)])
    out += b"".join(len(s).to_bytes(2, "big") + s for s in sps)
    out += bytes([len(pps)]) + b"".join(len(p).to_bytes(2, "big") + p for p in pps)
    return out


def avc1_entry(w: int, h: int, config: bytes) -> bytes:
    """An MP4 avc1 sample entry of a w x h picture with its avcC record."""
    import struct

    def box(t: bytes, payload: bytes) -> bytes:
        return struct.pack(">I4s", 8 + len(payload), t) + payload
    return box(b"avc1", b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16 +
               struct.pack(">HHIIIH", w, h, 0x480000, 0x480000, 0, 1) + b"\0" * 32 + struct.pack(">Hh", 24, -1) +
               box(b"avcC", config))


# ------------------------------------------------------------------ parameter sets

def scaling_list(b: Bits, values) -> None:
    """A scaling_list(): values in zigzag order (16 or 64 of 1-255), "default" (useDefaultScalingMatrixFlag), and
    a tail equal to its last value sent as one delta to 0 (the list's own shorthand)."""
    if values == "default":
        b.se(-8)  # nextScale 0 at the first place
        return
    last = 8
    for j, v in enumerate(values):
        if j and all(w == last for w in values[j:]):
            b.se((-last + 128) % 256 - 128)
            return
        b.se((v - last + 128) % 256 - 128)
        last = v


def scaling_matrix(b: Bits, lists: list) -> None:
    """The scaling_list_present flags and lists of an SPS or PPS: each entry None (absent: a fall-back rule), a
    list or "default"."""
    for v in lists:
        b.u(1, v is not None)
        if v is not None:
            scaling_list(b, v)


def sps_nal(o: dict) -> bytes:
    """An SPS from options: mb_w, mb_h and the optional profile (66, 77, 100), sps_id, log2_max_frame_num,
    poc_type, log2_max_poc_lsb, poc1 ((always_zero, non_ref, top_to_bottom, offsets)), refs, crop ((l, r, t, b) in
    2-sample units), full_range, timing ((units, scale)), reorder (num_reorder_frames), direct8x8
    (direct_8x8_inference_flag, 1 unless given), scaling (the 8 lists of :func:`scaling_matrix`, or 1 for none
    sent: every list by fall-back rule A); and, for the refusals, chroma_format, bit_depth, lossless,
    frame_mbs_only 0."""
    b = Bits()
    profile = o.get("profile", 66)
    b.u(8, profile)
    b.u(8, {66: 0xC0, 77: 0x40}.get(profile, 0))
    b.u(8, o.get("level", 30))
    b.ue(o.get("sps_id", 0))
    if profile in (100, 110, 122, 244):
        b.ue(o.get("chroma_format", 1))
        if o.get("chroma_format", 1) == 3:
            b.u(1, 0)
        b.ue(o.get("bit_depth", 8) - 8)
        b.ue(o.get("bit_depth", 8) - 8)
        b.u(1, o.get("lossless", 0))
        b.u(1, bool(o.get("scaling", 0)))
        if o.get("scaling") == 1:
            b.u(8, 0)  # no list sent: the fall-back rule
        elif o.get("scaling"):
            scaling_matrix(b, o["scaling"])
    b.ue(o.get("log2_max_frame_num", 4) - 4)
    poc = o.get("poc_type", 0)
    b.ue(poc)
    if poc == 0:
        b.ue(o.get("log2_max_poc_lsb", 5) - 4)
    elif poc == 1:
        always_zero, non_ref, t2b, offsets = o["poc1"]
        b.u(1, always_zero)
        b.se(non_ref)
        b.se(t2b)
        b.ue(len(offsets))
        for v in offsets:
            b.se(v)
    b.ue(o.get("refs", 1))
    b.u(1, 0)  # gaps_in_frame_num_value_allowed_flag
    b.ue(o["mb_w"] - 1)
    b.ue(o["mb_h"] - 1)
    b.u(1, o.get("frame_mbs_only", 1))
    if not o.get("frame_mbs_only", 1):
        b.u(1, 0)
    b.u(1, o.get("direct8x8", 1))  # direct_8x8_inference_flag
    crop = o.get("crop")
    b.u(1, crop is not None)
    if crop is not None:
        for v in crop:
            b.ue(v)
    vui = "full_range" in o or "timing" in o or "reorder" in o
    b.u(1, vui)
    if vui:
        b.u(1, 0)  # aspect ratio
        b.u(1, 0)  # overscan
        b.u(1, "full_range" in o)
        if "full_range" in o:
            b.u(3, 5)
            b.u(1, o["full_range"])
            b.u(1, 0)
        b.u(1, 0)  # chroma location
        b.u(1, "timing" in o)
        if "timing" in o:
            b.u(32, o["timing"][0])
            b.u(32, o["timing"][1])
            b.u(1, 1)
        b.u(1, 0)
        b.u(1, 0)
        b.u(1, 0)  # pic_struct_present_flag
        b.u(1, "reorder" in o)
        if "reorder" in o:
            b.u(1, 1)
            for v in (2, 1, 16, 16):
                b.ue(v)
            b.ue(o["reorder"])
            b.ue(o.get("refs", 1))
    return nal(3, 7, b.rbsp())


def pps_nal(o: dict) -> bytes:
    """A PPS from options: pps_id, sps_id, refs and refs1 (num_ref_idx_l0 / l1_default_active), qp (pic_init_qp),
    cqp (chroma_qp_index_offset), cqp2 (second_chroma_qp_index_offset: writes the High profile's tail), deblock
    (deblocking_filter_control_present_flag), constrained, bottom_poc, cabac (entropy_coding_mode_flag), weighted
    (weighted_pred_flag), bipred (weighted_bipred_idc), t8x8 (transform_8x8_mode_flag), scaling (the 6 or 8 lists
    of :func:`scaling_matrix`, or 1 for none sent); and, for the refusals, slice_groups, redundant."""
    b = Bits()
    b.ue(o.get("pps_id", 0))
    b.ue(o.get("sps_id", 0))
    b.u(1, o.get("cabac", 0))
    b.u(1, o.get("bottom_poc", 0))
    b.ue(o.get("slice_groups", 1) - 1)
    if o.get("slice_groups", 1) > 1:
        b.ue(0)  # slice_group_map_type 0: interleaved
        for _ in range(o["slice_groups"]):
            b.ue(0)
    b.ue(o.get("refs", 1) - 1)
    b.ue(o.get("refs1", 1) - 1)
    b.u(1, o.get("weighted", 0))
    b.u(2, o.get("bipred", 0))
    b.se(o.get("qp", 26) - 26)
    b.se(0)
    b.se(o.get("cqp", 0))
    b.u(1, o.get("deblock", 1))
    b.u(1, o.get("constrained", 0))
    b.u(1, o.get("redundant", 0))
    if "cqp2" in o or o.get("t8x8") or o.get("scaling"):
        b.u(1, o.get("t8x8", 0))
        b.u(1, bool(o.get("scaling", 0)))
        if o.get("scaling") == 1:
            b.u(6 + 2 * o.get("t8x8", 0), 0)
        elif o.get("scaling"):
            scaling_matrix(b, o["scaling"])
        b.se(o.get("cqp2", o.get("cqp", 0)))
    return nal(3, 8, b.rbsp())


# ------------------------------------------------------------------ CAVLC

def cavlc(b: Bits, levels: list, nc: int) -> int:
    """Writes one residual block (levels in scan order, maxNumCoeff of them) at nC (-1: chroma DC); returns
    TotalCoeff."""
    max_coeff = len(levels)
    nz = [i for i, v in enumerate(levels) if v]
    total = len(nz)
    coded = [levels[i] for i in reversed(nz)]  # from the highest frequency down
    t1 = 0
    while t1 < min(3, total) and abs(coded[t1]) == 1:
        t1 += 1
    idx = total * 4 + t1
    if nc == -1:
        b.u(CHROMA_DC_LEN[idx], CHROMA_DC_BITS[idx])
    else:
        t = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
        b.u(COEFF_TOKEN_LEN[t][idx], COEFF_TOKEN_BITS[t][idx])
    if not total:
        return 0
    for v in coded[:t1]:
        b.u(1, v < 0)
    sl = 1 if total > 10 and t1 < 3 else 0
    for i in range(t1, total):
        v = coded[i]
        code = 2 * v - 2 if v > 0 else -2 * v - 1
        if i == t1 and t1 < 3:
            code -= 2
        if sl == 0:
            if code < 14:
                b.u(code + 1, 1)
            elif code < 30:
                b.u(15, 1)
                b.u(4, code - 14)
            else:
                assert code - 30 < 4096, v
                b.u(16, 1)
                b.u(12, code - 30)
        else:
            if code < (15 << sl):
                b.u((code >> sl) + 1, 1)
                b.u(sl, code & ((1 << sl) - 1))
            else:
                assert code - (15 << sl) < 4096, v
                b.u(16, 1)
                b.u(12, code - (15 << sl))
        if sl == 0:
            sl = 1
        if abs(v) > (3 << (sl - 1)) and sl < 6:
            sl += 1
    if total < max_coeff:
        zeros = nz[-1] + 1 - total
        if nc == -1:
            b.u(CDC_TOTAL_ZEROS_LEN[total - 1][zeros], CDC_TOTAL_ZEROS_BITS[total - 1][zeros])
        else:
            b.u(TOTAL_ZEROS_LEN[total - 1][zeros], TOTAL_ZEROS_BITS[total - 1][zeros])
    else:
        zeros = 0
    pos = list(reversed(nz))
    for i in range(total - 1):
        if zeros <= 0:
            break
        run = pos[i] - pos[i + 1] - 1
        k = min(zeros, 7) - 1
        b.u(RUN_LEN[k][run], RUN_BITS[k][run])
        zeros -= run
    return total


# ------------------------------------------------------------------ CABAC

class Cabac:
    """CABAC's arithmetic encoder (9.3.4.2) into a Bits, its contexts initialised for the slice (9.3.1.1): table 0
    for I slices, 1 + cabac_init_idc else."""

    def __init__(self, b: Bits, table: int, qp: int):
        self.b = b
        init, q = T.INIT[table], max(0, min(51, qp))
        self.st = []
        for i in range(460):
            pre = max(1, min(126, ((init[2 * i] * q) >> 4) + init[2 * i + 1]))
            self.st.append([63 - pre, 0] if pre <= 63 else [pre - 64, 1])
        self.start()

    def start(self) -> None:
        self.low, self.range, self.outstanding, self.first = 0, 510, 0, True

    def put(self, bit: int) -> None:
        if self.first:
            self.first = False
        else:
            self.b.u(1, bit)
        if self.outstanding:
            self.b.u(self.outstanding, (1 - bit) * ((1 << self.outstanding) - 1))
            self.outstanding = 0

    def renorm(self) -> None:
        while self.range < 256:
            if self.low < 256:
                self.put(0)
            elif self.low >= 512:
                self.low -= 512
                self.put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx: int, bin_: int) -> None:
        s = self.st[ctx]
        lps = T.RANGE_LPS[s[0]][(self.range >> 6) & 3]
        self.range -= lps
        if bin_ != s[1]:
            self.low += self.range
            self.range = lps
            if s[0] == 0:
                s[1] = 1 - s[1]
            s[0] = T.TRANS_LPS[s[0]]
        elif s[0] < 62:
            s[0] += 1
        self.renorm()

    def bypass(self, bin_: int) -> None:
        self.low <<= 1
        if bin_:
            self.low += self.range
        if self.low >= 1024:
            self.put(1)
            self.low -= 1024
        elif self.low < 512:
            self.put(0)
        else:
            self.low -= 512
            self.outstanding += 1

    def terminate(self, bin_: int) -> None:
        self.range -= 2
        if bin_:
            self.low += self.range
            self.range = 2
            self.renorm()
            self.put((self.low >> 9) & 1)
            self.b.u(2, ((self.low >> 7) & 3) | 1)  # its last bit the rbsp_stop_one_bit (or before I_PCM samples)
        else:
            self.renorm()

    def exp_golomb(self, v: int, k: int) -> None:
        """A suffix of v, Exp-Golomb of order k in bypass bins (9.3.2.3)."""
        while v >= 1 << k:
            self.bypass(1)
            v -= 1 << k
            k += 1
        self.bypass(0)
        while k:
            k -= 1
            self.bypass((v >> k) & 1)


# ------------------------------------------------------------------ macroblocks

B_TYPES = [(0, 0, 0), (0, 1, 0), (0, 2, 0), (0, 3, 0), (1, 1, 1), (2, 1, 1), (1, 2, 2), (2, 2, 2), (1, 1, 2),
           (2, 1, 2), (1, 2, 1), (2, 2, 1), (1, 1, 3), (2, 1, 3), (1, 2, 3), (2, 2, 3), (1, 3, 1), (2, 3, 1),
           (1, 3, 2), (2, 3, 2), (1, 3, 3), (2, 3, 3)]  # B mb_type 0-21: shape (16x16, 16x8, 8x16), predictions
B_SUBS = [(0, 2, 2), (1, 2, 2), (2, 2, 2), (3, 2, 2), (1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 1, 2), (3, 2, 1), (3, 1, 2),
          (1, 1, 1), (2, 1, 1), (3, 1, 1)]  # B sub_mb_type: prediction (bit 0 L0, bit 1 L1; 0 direct), w, h
SHAPES = [[(0, 0, 4, 4)], [(0, 0, 4, 2), (0, 2, 4, 2)], [(0, 0, 2, 4), (2, 0, 2, 4)]]
INTRA_KINDS = ("I4", "I8", "I16", "PCM")


class Mb:
    """What one macroblock codes. kind: "I4", "I8", "I16", "PCM", "P", "B", "SKIP"."""

    def __init__(self, kind: str):
        self.kind = kind
        self.modes = [2] * 16  # I4: the modes in luma4x4BlkIdx order (I8: the first four, by 8x8 block)
        self.i16_mode = 2
        self.chroma_mode = 0
        self.cbp = 0
        self.qp_delta = 0
        self.ptype = 0  # P: 0 16x16, 1 16x8, 2 8x16, 3 8x8, 4 8x8ref0; B: mb_type 0-22
        self.sub = [0, 0, 0, 0]
        self.t8 = False
        self.refs: list = []  # ref_idx_l0 by partition or 8x8 block
        self.mvds: list = []  # mvd_l0 by (sub-)partition predicted from L0
        self.refs1: list = []
        self.mvds1: list = []
        self.luma = [[0] * 16 for _ in range(16)]  # by raster block, scan order (an I16 block's AC at 1..15)
        self.luma8 = [[0] * 64 for _ in range(4)]  # by 8x8 block under the 8x8 transform, scan order
        self.dc = [0] * 16  # I16 DC, scan order
        self.cdc = [[0] * 4, [0] * 4]
        self.cac = [[[0] * 15 for _ in range(4)] for _ in range(2)]
        self.pcm = b""


def parts_of(mb: Mb) -> list:
    """(x4, y4, w4, h4, prediction, unit) of each (sub-)partition of a P or B macroblock in decoding order: the
    unit is the partition's, or the 8x8 block's, index (which ref_idx it takes); a B_Direct_16x16 has none."""
    if mb.kind == "P":
        if mb.ptype < 3:
            return [(*s, 1, i) for i, s in enumerate(SHAPES[mb.ptype])]
        sizes = [SUB_SIZES[s] for s in mb.sub]
        preds = [1] * 4
    else:
        if mb.ptype == 0:
            return []
        if mb.ptype < 22:
            shape, *preds = B_TYPES[mb.ptype]
            return [(*s, preds[i], i) for i, s in enumerate(SHAPES[shape])]
        sizes = [B_SUBS[s][1:] for s in mb.sub]
        preds = [B_SUBS[s][0] for s in mb.sub]
    out = []
    for k in range(4):
        w, h = sizes[k]
        for s in range(4 // (w * h)):
            out.append(((k & 1) * 2 + (s & 1 if w == 1 else 0), (k >> 1) * 2 + ((s >> 1 if w == 1 else s) if h == 1
                                                                                else 0), w, h, preds[k], k))
    return out


class Picture:
    """The writer's view of the picture being written: each macroblock's slice, kind and what neighbouring
    macroblocks' syntax depends on: Intra 4x4 / 8x8 modes and total_coeff counts (CAVLC), and for CABAC the
    skip and direct flags, coded_block_pattern, chroma mode, transform size, coded_block_flags, ref_idx and
    |mvd| by list."""

    def __init__(self, mb_w: int, mb_h: int, constrained: bool, direct8x8: bool = True):
        n = mb_w * mb_h
        self.mb_w, self.mb_h, self.constrained, self.direct8x8 = mb_w, mb_h, constrained, direct8x8
        self.slice = [-1] * n
        self.kind = [""] * n
        self.modes = [[-1] * 16 for _ in range(n)]
        self.nz = [[0] * 16 for _ in range(n)]
        self.nzc = [[[0] * 4, [0] * 4] for _ in range(n)]
        self.skip = [False] * n
        self.bdirect = [False] * n
        self.cbp = [0] * n
        self.cmode = [0] * n
        self.t8 = [False] * n
        self.cbf = [0] * n
        self.ref = [[[-1] * 4, [-1] * 4] for _ in range(n)]
        self.direct8 = [[False] * 4 for _ in range(n)]
        self.mvd = [[[(0, 0)] * 16, [(0, 0)] * 16] for _ in range(n)]

    def mb(self, x: int, y: int, s: int):
        """The address of the macroblock at (x, y) when it lies in slice s, else None."""
        if 0 <= x < self.mb_w and 0 <= y < self.mb_h and self.slice[y * self.mb_w + x] == s:
            return y * self.mb_w + x
        return None

    def intra_ok(self, x: int, y: int, s: int) -> bool:
        a = self.mb(x, y, s)
        return a is not None and (not self.constrained or self.kind[a] in INTRA_KINDS)

    def skipped(self, addr: int, kind: str) -> None:
        """A P_Skip ("SKIP") or B_Skip ("BSKIP") macroblock."""
        self.kind[addr] = kind
        self.nz[addr] = [0] * 16
        self.nzc[addr] = [[0] * 4, [0] * 4]
        self.modes[addr] = [-1] * 16
        self.skip[addr] = True
        self.bdirect[addr] = kind == "BSKIP"
        self.direct8[addr] = [kind == "BSKIP"] * 4
        self.ref[addr] = [[0 if kind == "SKIP" else -1] * 4, [-1] * 4]


def _nc(a, b) -> int:
    if a is not None and b is not None:
        return (a + b + 1) >> 1
    return a if a is not None else b if b is not None else 0


class MbContext:
    """Neighbour lookups for the macroblock at addr of slice s."""

    def __init__(self, pic: Picture, addr: int, s: int):
        self.p, self.addr, self.s = pic, addr, s
        self.x, self.y = addr % pic.mb_w, addr // pic.mb_w

    def luma_nz(self, x4, y4):
        if x4 >= 0 and y4 >= 0:
            return self.p.nz[self.addr][y4 * 4 + x4]
        a = self.p.mb(self.x + (x4 < 0) * -1, self.y + (y4 < 0) * -1, self.s)
        return None if a is None else self.p.nz[a][(y4 % 4) * 4 + x4 % 4]

    def chroma_nz(self, c, x2, y2):
        if x2 >= 0 and y2 >= 0:
            return self.p.nzc[self.addr][c][y2 * 2 + x2]
        a = self.p.mb(self.x + (x2 < 0) * -1, self.y + (y2 < 0) * -1, self.s)
        return None if a is None else self.p.nzc[a][c][(y2 % 2) * 2 + x2 % 2]

    def pred_mode(self, bx, by):
        dc = False
        vals = []
        for x4, y4 in ((bx - 1, by), (bx, by - 1)):
            if x4 >= 0 and y4 >= 0:
                vals.append(self.p.modes[self.addr][y4 * 4 + x4])
                continue
            a = self.p.mb(self.x + (x4 < 0) * -1, self.y + (y4 < 0) * -1, self.s)
            if a is None or (self.p.constrained and self.p.kind[a] not in INTRA_KINDS):
                dc = True
                vals.append(2)
            else:
                vals.append(self.p.modes[a][(y4 % 4) * 4 + x4 % 4] if self.p.kind[a] in ("I4", "I8") else 2)
        return 2 if dc else min(vals)

    def avail4x4(self, bx, by):
        """(left, top, top-left) samples of the 4x4 block available for intra prediction."""
        p, x, y, s = self.p, self.x, self.y, self.s
        left = bx > 0 or p.intra_ok(x - 1, y, s)
        top = by > 0 or p.intra_ok(x, y - 1, s)
        if bx > 0 and by > 0:
            tl = True
        elif bx > 0:
            tl = p.intra_ok(x, y - 1, s)
        elif by > 0:
            tl = p.intra_ok(x - 1, y, s)
        else:
            tl = p.intra_ok(x - 1, y - 1, s)
        return left, top, tl

    def avail_mb(self):
        p, x, y, s = self.p, self.x, self.y, self.s
        return p.intra_ok(x - 1, y, s), p.intra_ok(x, y - 1, s), p.intra_ok(x - 1, y - 1, s)

    # what CABAC's context selection reads (9.3.3.1.1)

    def nb(self, dx: int, dy: int):
        """The neighbouring macroblock A (-1, 0) or B (0, -1): its address, or None."""
        return self.p.mb(self.x + dx, self.y + dy, self.s)

    def block(self, x4: int, y4: int):
        """(address or None, raster 4x4 index) of the 4x4 block at (x4, y4) from this macroblock's corner."""
        if x4 >= 0 and y4 >= 0:
            return self.addr, y4 * 4 + x4
        return self.p.mb(self.x - (x4 < 0), self.y - (y4 < 0), self.s), (y4 % 4) * 4 + x4 % 4

    def cbf(self, addr, bit: int) -> int:
        if addr is None:
            return 1 if self.p.kind[self.addr] in INTRA_KINDS else 0
        return (self.p.cbf[addr] >> bit) & 1


def i4_modes_allowed(left: bool, top: bool, tl: bool) -> list:
    out = [2]
    if top:
        out += [0, 3, 7]
    if left:
        out += [1, 8]
    if top and left and tl:
        out += [4, 5, 6]
    return sorted(out)


def i16_modes_allowed(left: bool, top: bool, tl: bool) -> list:  # luma numbering: V 0, H 1, DC 2, plane 3
    return [2] + [0] * top + [1] * left + [3] * (top and left and tl)


def chroma_modes_allowed(left: bool, top: bool, tl: bool) -> list:  # DC 0, H 1, V 2, plane 3
    return [0] + [1] * left + [2] * top + [3] * (top and left and tl)


class Cavlc:
    """The syntax elements of a macroblock in CAVLC's codes (Exp-Golomb and 9.2)."""

    cabac = False

    def __init__(self, b: Bits):
        self.b = b

    def mb_type(self, ctx, stype, v):
        self.b.ue(v)

    def sub_type(self, stype, v):
        self.b.ue(v)

    def ref(self, ctx, x, x4, y4, nref, v):
        self.b.te(nref - 1, v)

    def mvd(self, ctx, x, part, d):
        self.b.se(d[0])
        self.b.se(d[1])

    def cbp(self, ctx, intra, v):
        self.b.ue((INTRA_CBP_CODE if intra else INTER_CBP_CODE)[v])

    def t8(self, ctx, v):
        self.b.u(1, v)

    def intra_mode(self, pred, mode):
        if mode == pred:
            self.b.u(1, 1)
        else:
            self.b.u(1, 0)
            self.b.u(3, mode if mode < pred else mode - 1)

    def chroma_mode(self, ctx, v):
        self.b.ue(v)

    def qp_delta(self, v):
        self.b.se(v)

    def pcm(self, data):
        self.b.align_zero()
        for v in data:
            self.b.u(8, v)


class CabacSyntax:
    """The syntax elements of a macroblock in CABAC's bins (9.3.2) and contexts (9.3.3.1.1)."""

    cabac = True

    def __init__(self, c: Cabac):
        self.c = c
        self.last_dqp = 0  # the previous macroblock's mb_qp_delta was not 0

    def intra_type(self, ctx, base: int, prefix: bool, t: int):
        """I mb_type t (0 I_NxN, 1-24 I_16x16, 25 I_PCM) with its prefix's (I slices) or suffix's ctxIdxOffset."""
        d = self.c.decision
        if prefix:
            inc = sum(a is not None and ctx.p.kind[a] not in ("I4", "I8") for a in (ctx.nb(-1, 0), ctx.nb(0, -1)))
            d(base + inc, t > 0)
        else:
            d(base, t > 0)
        if t == 0:
            return
        self.c.terminate(t == 25)
        if t == 25:
            return
        s, k = (base + 2 if prefix else base), t - 1
        chroma = k // 4 % 3
        d(s + 1, k >= 12)
        d(s + 2, chroma > 0)
        if chroma:
            d(s + 2 + prefix, chroma == 2)
        d(s + 3 + prefix, (k % 4) >> 1)
        d(s + 3 + 2 * prefix, k % 2)

    def mb_type(self, ctx, stype, v):
        d = self.c.decision
        if stype == "I":
            self.intra_type(ctx, 3, True, v)
        elif stype == "P":
            if v >= 5:
                d(14, 1)
                self.intra_type(ctx, 17, False, v - 5)
                return
            d(14, 0)
            d(15, v in (1, 2))
            d(16 if v in (0, 3) else 17, v in (3, 1))
        else:
            inc = sum(a is not None and not ctx.p.bdirect[a] for a in (ctx.nb(-1, 0), ctx.nb(0, -1)))
            d(27 + inc, v > 0)
            if v == 0:
                return
            d(27 + 3, v > 2)
            if v <= 2:
                d(27 + 5, v - 1)
                return
            if v >= 23:
                bits, n = 13, 4
            elif v == 11:
                bits, n = 14, 4
            elif v == 22:
                bits, n = 15, 4
            elif v < 11:
                bits, n = v - 3, 4
            else:
                bits, n = v + 4, 5
            for i in range(n):
                d(27 + (4 if i == 0 else 5), (bits >> (n - 1 - i)) & 1)
            if v >= 23:
                self.intra_type(ctx, 32, False, v - 23)

    def sub_type(self, stype, v):
        d = self.c.decision
        if stype == "P":
            d(21, v == 0)
            if v:
                d(22, v > 1)
                if v > 1:
                    d(23, v == 2)
            return
        d(36, v > 0)
        if v == 0:
            return
        d(37, v > 2)
        if v <= 2:
            d(39, v - 1)
            return
        d(38, v > 6)
        if v <= 6:
            d(39, (v - 3) >> 1)
            d(39, (v - 3) & 1)
        else:
            d(39, v > 10)
            if v > 10:
                d(39, v - 11)
            else:
                d(39, (v - 7) >> 1)
                d(39, (v - 7) & 1)

    def ref(self, ctx, x, x4, y4, nref, v):
        inc = 0
        for k, (ax, ay) in enumerate(((x4 - 1, y4), (x4, y4 - 1))):
            a, blk = ctx.block(ax, ay)
            b8 = (blk >> 3) * 2 + ((blk & 3) >> 1)
            if a is not None and not ctx.p.direct8[a][b8] and ctx.p.ref[a][x][b8] > 0:
                inc += k + 1
        for i in range(v):
            self.c.decision(54 + inc, 1)
            inc = 4 if inc < 4 else 5
        self.c.decision(54 + inc, 0)

    def mvd(self, ctx, x, part, d):
        x4, y4 = part[0], part[1]
        for comp in range(2):
            s = 0
            for ax, ay in ((x4 - 1, y4), (x4, y4 - 1)):
                a, blk = ctx.block(ax, ay)
                if a is not None:
                    s += ctx.p.mvd[a][x][blk][comp]
            base, v = (47 if comp else 40), abs(d[comp])
            self.c.decision(base + (0 if s < 3 else 1 if s <= 32 else 2), v > 0)
            if v == 0:
                continue
            ctxs = [base + 3, base + 4, base + 5, base + 6, base + 6, base + 6, base + 6, base + 6]
            for i in range(1, min(v, 9)):
                self.c.decision(ctxs[i - 1], 1)
            if v < 9:
                self.c.decision(ctxs[v - 1], 0)
            else:
                self.c.exp_golomb(v - 9, 3)
            self.c.bypass(d[comp] < 0)

    def cbp(self, ctx, intra, v):
        a, b = ctx.nb(-1, 0), ctx.nb(0, -1)
        ca = ctx.p.cbp[a] if a is not None else 0x0F
        cb = ctx.p.cbp[b] if b is not None else 0x0F
        for k in range(4):
            ba = (v >> (k - 1)) & 1 if k & 1 else (ca >> (k + 1)) & 1
            bb = (v >> (k - 2)) & 1 if k & 2 else (cb >> (k + 2)) & 1
            self.c.decision(73 + (not ba) + 2 * (not bb), (v >> k) & 1)
        ach = ctx.p.cbp[a] >> 4 if a is not None else 0
        bch = ctx.p.cbp[b] >> 4 if b is not None else 0
        self.c.decision(77 + (ach > 0) + 2 * (bch > 0), v >> 4 > 0)
        if v >> 4:
            self.c.decision(77 + 4 + (ach == 2) + 2 * (bch == 2), v >> 4 == 2)

    def t8(self, ctx, v):
        inc = sum(a is not None and ctx.p.t8[a] for a in (ctx.nb(-1, 0), ctx.nb(0, -1)))
        self.c.decision(399 + inc, v)

    def intra_mode(self, pred, mode):
        self.c.decision(68, mode == pred)
        if mode != pred:
            rem = mode if mode < pred else mode - 1
            for i in range(3):
                self.c.decision(69, (rem >> i) & 1)

    def chroma_mode(self, ctx, v):
        inc = sum(a is not None and ctx.p.kind[a] in ("I4", "I8", "I16") and ctx.p.cmode[a] != 0
                  for a in (ctx.nb(-1, 0), ctx.nb(0, -1)))
        self.c.decision(64 + inc, v > 0)
        for i in range(1, 3):
            if v >= i:
                self.c.decision(67, v > i)

    def qp_delta(self, v):
        k = 2 * v - 1 if v > 0 else -2 * v
        for i in range(k + 1):
            self.c.decision(60 + self.last_dqp if i == 0 else 62 if i == 1 else 63, i < k)
        self.last_dqp = int(v != 0)

    def pcm(self, data):
        self.c.b.align_zero()
        for v in data:
            self.c.b.u(8, v)
        self.c.start()

    def residual(self, cat: int, inc: int, levels: list) -> int:
        """One residual block of ctxBlockCat cat (levels in scan order) with its coded_block_flag's ctxIdxInc;
        returns the levels coded."""
        nz = [i for i, v in enumerate(levels) if v]
        n = len(levels)
        d = self.c.decision
        if cat != 5:
            d(85 + (0, 4, 8, 12, 16)[cat] + inc, bool(nz))
            if not nz:
                return 0
        sig = 402 if cat == 5 else 105 + (0, 15, 29, 44, 47)[cat]
        last = 417 if cat == 5 else 166 + (0, 15, 29, 44, 47)[cat]
        absb = 426 if cat == 5 else 227 + (0, 10, 20, 30, 39)[cat]
        for i in range(n - 1):
            si = T.SIG_8X8[i] if cat == 5 else min(i, 2) if cat == 3 else i
            d(sig + si, bool(levels[i]))
            if levels[i]:
                li = T.LAST_8X8[i] if cat == 5 else min(i, 2) if cat == 3 else i
                d(last + li, i == nz[-1])
                if i == nz[-1]:
                    break
        gt1 = eq1 = 0
        for i in reversed(nz):
            a = abs(levels[i]) - 1
            d(absb + (0 if gt1 else min(4, 1 + eq1)), a > 0)
            if a:
                c1 = absb + 5 + min(4 - (cat == 3), gt1)
                for _ in range(1, min(a, 14)):
                    d(c1, 1)
                if a < 14:
                    d(c1, 0)
                else:
                    self.c.exp_golomb(a - 14, 0)
                gt1 += 1
            else:
                eq1 += 1
            self.c.bypass(levels[i] < 0)
        return len(nz)


def write_residual(sx, ctx: MbContext, mb: Mb) -> None:
    """The residual() of mb (7.3.5.3), in either entropy mode; records each reader's counts."""
    pic, addr = ctx.p, ctx.addr
    i16 = mb.kind == "I16"
    if i16:
        if sx.cabac:
            if sx.residual(0, ctx.cbf(ctx.nb(-1, 0), 16) + 2 * ctx.cbf(ctx.nb(0, -1), 16), mb.dc):
                pic.cbf[addr] |= 1 << 16
        else:
            cavlc(sx.b, mb.dc, _nc(ctx.luma_nz(-1, 0), ctx.luma_nz(0, -1)))
    for k8 in range(4):
        if not mb.cbp >> k8 & 1:
            continue
        if mb.t8 and sx.cabac:
            sx.residual(5, 0, mb.luma8[k8])
            for j in range(4):
                bx, by = BLOCK_ORDER[k8 * 4 + j]
                pic.cbf[addr] |= 1 << (by * 4 + bx)
            continue
        for j in range(4):
            bx, by = BLOCK_ORDER[k8 * 4 + j]
            lv = [mb.luma8[k8][4 * i + j] for i in range(16)] if mb.t8 else mb.luma[by * 4 + bx]
            lv = lv[1:] if i16 else lv
            if sx.cabac:
                (a, ba), (b, bb) = ctx.block(bx - 1, by), ctx.block(bx, by - 1)
                n = sx.residual(1 if i16 else 2, ctx.cbf(a, ba) + 2 * ctx.cbf(b, bb), lv)
                if n:
                    pic.cbf[addr] |= 1 << (by * 4 + bx)
            else:
                n = cavlc(sx.b, lv, _nc(ctx.luma_nz(bx - 1, by), ctx.luma_nz(bx, by - 1)))
            pic.nz[addr][by * 4 + bx] = n
    if mb.cbp >> 4:
        for c in range(2):
            if sx.cabac:
                bit = 17 + c
                if sx.residual(3, ctx.cbf(ctx.nb(-1, 0), bit) + 2 * ctx.cbf(ctx.nb(0, -1), bit), mb.cdc[c]):
                    pic.cbf[addr] |= 1 << bit
            else:
                cavlc(sx.b, mb.cdc[c], -1)
    if mb.cbp >> 4 == 2:
        for c in range(2):
            for k in range(4):
                bx, by = k & 1, k >> 1
                if sx.cabac:
                    base = 19 + 4 * c
                    a = addr if bx else ctx.nb(-1, 0)
                    b = addr if by else ctx.nb(0, -1)
                    n = sx.residual(4, ctx.cbf(a, base + by * 2 + (bx ^ 1)) + 2 * ctx.cbf(b, base + (by ^ 1) * 2 + bx),
                                    mb.cac[c][k])
                    if n:
                        pic.cbf[addr] |= 1 << (base + k)
                else:
                    n = cavlc(sx.b, mb.cac[c][k], _nc(ctx.chroma_nz(c, bx - 1, by), ctx.chroma_nz(c, bx, by - 1)))
                pic.nzc[addr][c][k] = n


def write_mb(sx, ctx: MbContext, mb: Mb, stype: str, nref: tuple, t8_mode: bool = False) -> None:
    """Writes the macroblock_layer() of mb (not a skipped one) with the syntax writer sx (:class:`Cavlc` or
    :class:`CabacSyntax`) in a slice of type stype ("I", "P" or "B"), nref the active entries of both lists,
    t8_mode the PPS's transform_8x8_mode_flag; records what its neighbours read."""
    pic, addr = ctx.p, ctx.addr
    pic.kind[addr] = mb.kind
    pic.nz[addr] = [0] * 16
    pic.nzc[addr] = [[0] * 4, [0] * 4]
    pic.skip[addr] = pic.bdirect[addr] = False
    pic.cbf[addr] = 0
    pic.cmode[addr] = 0
    pic.t8[addr] = mb.t8
    pic.direct8[addr] = [False] * 4
    pic.ref[addr] = [[-1] * 4, [-1] * 4]
    pic.mvd[addr] = [[(0, 0)] * 16, [(0, 0)] * 16]
    off = {"I": 0, "P": 5, "B": 23}[stype]
    if mb.kind == "PCM":
        sx.mb_type(ctx, stype, off + 25)
        sx.pcm(mb.pcm)
        pic.nz[addr] = [16] * 16
        pic.nzc[addr] = [[16] * 4, [16] * 4]
        pic.cbf[addr] = (1 << 27) - 1
        pic.cbp[addr] = 0x2F
        if sx.cabac:
            sx.last_dqp = 0
        return
    if mb.kind in ("P", "B"):
        sx.mb_type(ctx, stype, mb.ptype)
        parts = parts_of(mb)
        if mb.kind == "P" and mb.ptype >= 3 or mb.kind == "B" and mb.ptype == 22:
            for s in mb.sub:
                sx.sub_type(stype, s)
        if mb.kind == "B" and mb.ptype == 0:
            pic.direct8[addr] = [True] * 4
            pic.bdirect[addr] = True
        for p in parts:
            if p[4] == 0:
                pic.direct8[addr][p[5]] = True
        for x, refs in ((0, mb.refs), (1, mb.refs1)):
            units = [p for i, p in enumerate(parts) if p[4] >> x & 1 and (i == 0 or parts[i - 1][5] != p[5])]
            for p, r in zip(units, refs):
                eight = len(parts) > 2 or mb.kind == "P" and mb.ptype >= 3 or mb.kind == "B" and mb.ptype == 22
                x8, y8, w8, h8 = ((p[5] & 1) * 2, (p[5] >> 1) * 2, 2, 2) if eight else p[:4]
                if nref[x] > 1 and not (mb.kind == "P" and mb.ptype == 4):
                    sx.ref(ctx, x, x8, y8, nref[x], r)
                for yy in range(y8, y8 + h8, 2):
                    for xx in range(x8, x8 + w8, 2):
                        pic.ref[addr][x][(yy >> 1) * 2 + (xx >> 1)] = r
        for x, mvds in ((0, mb.mvds), (1, mb.mvds1)):
            for p, d in zip([p for p in parts if p[4] >> x & 1], mvds):
                sx.mvd(ctx, x, p, d)
                for yy in range(p[1], p[1] + p[3]):
                    for xx in range(p[0], p[0] + p[2]):
                        pic.mvd[addr][x][yy * 4 + xx] = (min(abs(d[0]), 127), min(abs(d[1]), 127))
        sx.cbp(ctx, False, mb.cbp)
        if mb.cbp & 15 and t8_mode and inter_t8_ok(mb, ctx):
            sx.t8(ctx, mb.t8)
    elif mb.kind in ("I4", "I8"):
        sx.mb_type(ctx, stype, off)
        if t8_mode:
            sx.t8(ctx, mb.kind == "I8")
        if mb.kind == "I8":
            for k in range(4):
                bx, by = (k & 1) * 2, (k >> 1) * 2
                pred = ctx.pred_mode(bx, by)
                sx.intra_mode(pred, mb.modes[k])
                for j in range(4):
                    pic.modes[addr][(by + (j >> 1)) * 4 + bx + (j & 1)] = mb.modes[k]
        else:
            for k, (bx, by) in enumerate(BLOCK_ORDER):
                pred = ctx.pred_mode(bx, by)
                pic.modes[addr][by * 4 + bx] = mb.modes[k]
                sx.intra_mode(pred, mb.modes[k])
        sx.chroma_mode(ctx, mb.chroma_mode)
        pic.cmode[addr] = mb.chroma_mode
        sx.cbp(ctx, True, mb.cbp)
    else:  # I16
        ac = mb.cbp & 15
        assert ac in (0, 15)
        sx.mb_type(ctx, stype, off + 1 + mb.i16_mode + 4 * (mb.cbp >> 4) + (12 if ac else 0))
        sx.chroma_mode(ctx, mb.chroma_mode)
        pic.cmode[addr] = mb.chroma_mode
    pic.cbp[addr] = mb.cbp
    if mb.kind not in ("I4", "I8"):
        pic.modes[addr] = [-1] * 16
    if mb.cbp or mb.kind == "I16":
        sx.qp_delta(mb.qp_delta)
    elif sx.cabac:
        sx.last_dqp = 0
    write_residual(sx, ctx, mb)


def inter_t8_ok(mb: Mb, ctx: MbContext) -> bool:
    """transform_size_8x8_flag may be sent: no partition below 8x8, and a direct one only with
    direct_8x8_inference_flag (the Picture's ``direct8x8``)."""
    inference = ctx.p.direct8x8
    if mb.kind == "B" and mb.ptype == 0:
        return inference
    if mb.kind == "P" and mb.ptype >= 3:
        return all(s == 0 for s in mb.sub)
    if mb.kind == "B" and mb.ptype == 22:
        return all(B_SUBS[s][1:] == (2, 2) and (s or inference) for s in mb.sub)
    return True


# ------------------------------------------------------------------ the reference buffer

class Ref:
    def __init__(self, frame_num: int, poc: int = 0, uid: int = 0):
        self.frame_num, self.long_idx, self.poc, self.uid = frame_num, None, poc, uid
        self.col_refs: set = set()  # the pictures its slices' lists hold (temporal direct's co-located picture)
        self.col_ok = True  # every slice with the same lists


class Dpb:
    """The reference frames as a decoder marks them (8.2.4, 8.2.5), for choosing valid list modifications and
    memory management operations."""

    def __init__(self, max_frame_num: int, max_refs: int):
        self.max_frame_num, self.max_refs = max_frame_num, max_refs
        self.refs: list = []
        self.max_long = None

    def pic_num(self, r: Ref, cur: int) -> int:
        return r.frame_num - self.max_frame_num if r.frame_num > cur else r.frame_num

    def shorts(self):
        return [r for r in self.refs if r.long_idx is None]

    def longs(self):
        return [r for r in self.refs if r.long_idx is not None]

    def initial_list(self, cur: int) -> list:
        return sorted(self.shorts(), key=lambda r: -self.pic_num(r, cur)) + sorted(self.longs(),
                                                                                    key=lambda r: r.long_idx)

    def initial_b_lists(self, poc: int) -> tuple:
        """RefPicList0 and RefPicList1 of a B slice (8.2.4.2.3, 8.2.4.2.4)."""
        longs = sorted(self.longs(), key=lambda r: r.long_idx)
        before = sorted((r for r in self.shorts() if r.poc <= poc), key=lambda r: -r.poc)
        after = sorted((r for r in self.shorts() if r.poc > poc), key=lambda r: r.poc)
        l0, l1 = before + after + longs, after + before + longs
        if len(l1) > 1 and l1 == l0:
            l1[0], l1[1] = l1[1], l1[0]
        return l0, l1

    def modified(self, init: list, cur: int, n: int, cmds) -> list:
        """The list after the modification commands (8.2.4.3), n entries."""
        out = (list(init[:n]) + [None] * n)[:n]
        pred = cur
        for i, (idc, v) in enumerate(cmds or []):
            if idc == 2:
                pic = next(r for r in self.longs() if r.long_idx == v)
            else:
                pred = (pred - (v + 1) if idc == 0 else pred + v + 1) % self.max_frame_num
                num = pred - self.max_frame_num if pred > cur else pred
                pic = next(r for r in self.shorts() if self.pic_num(r, cur) == num)
            out = (out[:i] + [pic] + [r for r in out[i:] if r is not pic] + [None] * n)[:n]
        return out


def list_mods(dpb: Dpb, cur: int, n: int, rng, init: list | None = None, dup: bool = False) -> list:
    """Random ref_pic_list_modification commands for a list of n entries (of ``init``, the P list unless given;
    ``dup``: its first picture twice, as x264's weightp writes)."""
    init = dpb.initial_list(cur) if init is None else init
    if dup:
        chosen = [init[0], init[0]]
    else:
        k = int(rng.integers(1, n + 1))
        chosen = [init[i] for i in rng.permutation(len(init))[:k]]
    cmds, pred = [], cur
    for r in chosen:
        if r.long_idx is not None:
            cmds.append((2, r.long_idx))
        else:
            num = dpb.pic_num(r, cur)
            no_wrap = num + dpb.max_frame_num if num < 0 else num
            if rng.random() < 0.5:
                d = (pred - no_wrap) % dpb.max_frame_num or dpb.max_frame_num
                cmds.append((0, d - 1))
            else:
                d = (no_wrap - pred) % dpb.max_frame_num or dpb.max_frame_num
                cmds.append((1, d - 1))
            pred = no_wrap
    return cmds


# ------------------------------------------------------------------ random syntax

def random_levels(rng, n: int, qp: int, dense: float = 0.3, gain: float = 1.0) -> list:
    """n levels (scan order) of a random block: mostly zeros and ones, sometimes a ramp to large levels (every
    suffix length), bounded so that the dequantised block stays inside 16 bits (``gain``: its scaling lists' and
    transform's factor over a flat 4x4 block's)."""
    cap = max(2, 3000 // (25 << (qp // 6)))
    if gain != 1.0:
        cap = max(2, int(cap / gain))
    out = [0] * n
    r = rng.random()
    if r < 0.35:
        return out
    if r < 0.45 and cap >= 60 and n >= 8:  # a ramp: the coded levels grow through every suffix length
        vals = [1, -2, 5, -9, 15, 30, -55, cap]
        pos = sorted(rng.choice(n, len(vals), replace=False))
        for p, v in zip(pos, reversed(vals)):
            out[p] = int(v) if abs(v) <= cap else int(np.sign(v) * cap)
        return out
    count = int(rng.integers(1, n + 1)) if rng.random() < dense else int(rng.integers(1, min(n, 5) + 1))
    big = 0
    for p in rng.choice(n, count, replace=False):
        if rng.random() < 0.6:
            v = 1
        elif rng.random() < 0.7 or big >= 2:
            v = int(rng.integers(2, max(3, cap // 4 + 1)))
        else:
            v = int(rng.integers(2, cap + 1))
            big += 1
        out[p] = v if rng.random() < 0.5 else -v
    # a conforming stream keeps the inverse transform inside 16 bits: at high QP, fewer and smaller levels
    weight = (29 << (qp // 6)) * gain
    while sum(abs(v) for v in out) * weight > 20000:
        k = max(range(n), key=lambda i: abs(out[i]))
        out[k] -= int(np.sign(out[k]))
    return out


def random_mb(rng, ctx: MbContext, stype: str, nref: tuple, qp: int, o: dict) -> Mb:
    """A random macroblock (not skipped) at ctx, its intra modes among those its neighbours allow; stype the
    slice type ("I", "P", "B"), nref the active entries of both lists."""
    t8_mode, gain = o.get("t8x8", 0), o.get("gain", 1.0)
    intra_p = o.get("intra_in_p", 0.2)
    big = o.get("big_mvd", 0.1)

    def mvd():
        if rng.random() < 0.25:
            return 0
        return int(rng.integers(-64, 65)) if rng.random() < big else int(rng.integers(-9, 10))
    if stype == "P" and rng.random() >= intra_p:
        mb = Mb("P")
        mb.ptype = int(rng.choice(5, p=o.get("ptypes", [0.3, 0.2, 0.2, 0.2, 0.1])))
        if o.get("cabac") and mb.ptype == 4:  # CABAC has no P_8x8ref0
            mb.ptype = 3
        if mb.ptype >= 3:
            mb.sub = [int(s) for s in rng.integers(0, 4, 4)]
            parts = sum(4 // (SUB_SIZES[s][0] * SUB_SIZES[s][1]) for s in mb.sub)
            mb.refs = [int(rng.integers(0, nref[0])) for _ in range(4)] if mb.ptype == 3 else []
        else:
            parts = 1 if mb.ptype == 0 else 2
            mb.refs = [int(rng.integers(0, nref[0])) for _ in range(parts)]
        mb.mvds = [(mvd(), mvd()) for _ in range(parts)]
        mb.cbp = int(rng.integers(0, 48))
    elif stype == "B" and rng.random() >= o.get("intra_in_b", 0.15):
        mb = Mb("B")
        mb.ptype = int(rng.choice(23, p=o.get("btypes", [0.12] + [0.08] * 3 + [0.3 / 18] * 18 + [0.34])))
        if mb.ptype == 22:
            mb.sub = [int(s) for s in rng.choice(13, 4, p=o.get("bsubs", [0.2] + [0.8 / 12] * 12))]
        parts = parts_of(mb)
        for x in range(2):
            units = sorted({p[5] for p in parts if p[4] >> x & 1})
            refs = [int(rng.integers(0, nref[x])) for _ in units]
            mvds = [(mvd(), mvd()) for p in parts if p[4] >> x & 1]
            if x:
                mb.refs1, mb.mvds1 = refs, mvds
            else:
                mb.refs, mb.mvds = refs, mvds
        mb.cbp = int(rng.integers(0, 48))
    else:
        r = rng.random()
        pcm = o.get("pcm", 0.04)
        kind = "PCM" if r < pcm else "I4" if r < pcm + (1 - pcm) * o.get("i4", 0.5) else "I16"
        if kind == "I4" and t8_mode and rng.random() < o.get("i8", 0.5):
            kind = "I8"
        mb = Mb(kind)
        if kind == "PCM":  # now and then samples of 0-3 only, whose zero bytes take emulation prevention
            mb.pcm = bytes(rng.integers(0, 4 if rng.random() < 0.3 else 256, 384, dtype=np.uint8))
            return mb
        left, top, tl = ctx.avail_mb()
        mb.chroma_mode = int(rng.choice(chroma_modes_allowed(left, top, tl)))
        if kind == "I4":
            for k, (bx, by) in enumerate(BLOCK_ORDER):
                mb.modes[k] = int(rng.choice(i4_modes_allowed(*ctx.avail4x4(bx, by))))
            mb.cbp = int(rng.integers(0, 48))
        elif kind == "I8":
            for k in range(4):
                mb.modes[k] = int(rng.choice(i4_modes_allowed(*ctx.avail4x4((k & 1) * 2, (k >> 1) * 2))))
            mb.t8 = True
            mb.cbp = int(rng.integers(0, 48))
        else:
            mb.i16_mode = int(rng.choice(i16_modes_allowed(left, top, tl)))
            mb.cbp = int(rng.integers(0, 3)) << 4 | (15 if rng.random() < 0.5 else 0)
    if mb.kind in ("P", "B") and t8_mode and mb.cbp & 15 and inter_t8_ok(mb, ctx):
        mb.t8 = rng.random() < o.get("t8", 0.6)
    if mb.cbp or mb.kind == "I16":
        d = o.get("qp_delta", 0.3)
        mb.qp_delta = int(rng.integers(-4, 5)) if rng.random() < d else 0
        lo, hi = o.get("qp_range", (0, 40))
        mb.qp_delta = max(lo - qp, min(hi - qp, mb.qp_delta))
    q = qp + mb.qp_delta
    i16 = mb.kind == "I16"
    if i16:
        mb.dc = random_levels(rng, 16, q, gain=gain)
    for k, (bx, by) in enumerate(BLOCK_ORDER):
        if mb.cbp >> (k // 4) & 1 and not mb.t8:
            lv = random_levels(rng, 15 if i16 else 16, q, gain=gain)
            mb.luma[by * 4 + bx] = [0] + lv if i16 else lv
    if mb.t8:
        for k in range(4):
            if mb.cbp >> k & 1:
                lv = random_levels(rng, 64, q, gain=2 * gain)
                if not any(lv) and o.get("cabac"):  # CABAC's 8x8 block has no coded_block_flag: one level at least
                    lv[int(rng.integers(0, 64))] = 1
                mb.luma8[k] = lv
    qc = CHROMA_QP[max(0, min(51, q + o.get("cqp", 0)))]
    if mb.cbp >> 4:
        mb.cdc = [random_levels(rng, 4, qc, gain=gain) for _ in range(2)]
    if mb.cbp >> 4 == 2:
        mb.cac = [[random_levels(rng, 15, qc, gain=gain) for _ in range(4)] for _ in range(2)]
    return mb


def pred_weight_table(b: Bits, rng, nref: tuple, b_slice: bool) -> None:
    """A random pred_weight_table(): denominators, and weights and offsets by list and index (a B slice's kept
    to sums a biweight may take)."""
    top = 5 if b_slice else 7
    luma, chroma = int(rng.integers(0, top + 1)), int(rng.integers(0, top + 1))
    b.ue(luma)
    b.ue(chroma)
    for x in range(2 if b_slice else 1):
        for _ in range(nref[x]):
            for denom, n in ((luma, 1), (chroma, 2)):
                flag = rng.random() < 0.7
                b.u(1, flag)
                if flag:
                    for _ in range(n):
                        w = (1 << denom) + int(rng.integers(-(1 << denom), (1 << denom) + 1))
                        b.se(max(-32, min(63, w)) if b_slice else max(-128, min(127, w)))
                        b.se(int(rng.integers(-20, 21)))


def slice_header(b: Bits, o: dict, sps: dict, pps: dict, first_mb: int, stype: str, idr: bool, ref_idc: int,
                 frame_num: int, poc: dict, nref_override, mods, marking, qp_delta: int, deblock, extra=None) -> None:
    """A slice header of slice type stype ("I", "P", "B"). For a B slice nref_override and mods hold both
    lists'; ``extra``: direct_spatial, weights (a callable writing the pred_weight_table), cabac_init_idc."""
    extra = extra or {}
    b.ue(first_mb)
    b.ue({"P": 0, "B": 1, "I": 2}[stype])
    b.ue(pps.get("pps_id", 0))
    b.u(sps.get("log2_max_frame_num", 4), frame_num)
    if idr:
        b.ue(o.get("idr_pic_id", 0))
    if sps.get("poc_type", 0) == 0:
        b.u(sps.get("log2_max_poc_lsb", 5), poc["lsb"])
        if pps.get("bottom_poc"):
            b.se(poc.get("bottom", 0))
    elif sps.get("poc_type", 0) == 1 and not sps["poc1"][0]:
        b.se(poc.get("delta0", 0))
        if pps.get("bottom_poc"):
            b.se(poc.get("delta1", 0))
    if stype == "B":
        b.u(1, extra.get("direct_spatial", 1))
    if stype != "I":
        lists = 2 if stype == "B" else 1
        overrides = (nref_override if stype == "B" else (nref_override,)) or (None,)
        b.u(1, overrides[0] is not None)
        if overrides[0] is not None:
            for n in overrides:
                b.ue(n - 1)
        for m in (mods if stype == "B" else (mods,))[:lists]:
            b.u(1, bool(m))
            if m:
                for idc, v in m:
                    b.ue(idc)
                    b.ue(v)
                b.ue(3)
    if "weights" in extra:
        extra["weights"](b)
    if ref_idc:
        if idr:
            b.u(1, 0)
            b.u(1, marking == "long")
        else:
            b.u(1, marking is not None)
            if marking is not None:
                for op in marking:
                    b.ue(op[0])
                    for v in op[1:]:
                        b.ue(v)
                b.ue(0)
    if pps.get("cabac") and stype != "I":
        b.ue(extra.get("cabac_init_idc", 0))
    b.se(qp_delta)
    if pps.get("deblock", 1):
        idc, alpha, beta = deblock
        b.ue(idc)
        if idc != 1:
            b.se(alpha)
            b.se(beta)


def plan_pictures(rng, frames: int, o: dict) -> list:
    """(IDR, type "I" / "P" / "B", display index from the IDR picture, reference) of each picture in decoding
    order: an anchor (P, sometimes I) after up to ``b_max`` B pictures in display order, decoded before them;
    with ``pyramid``, the middle B picture of three or more first and used for reference."""
    out, base = [], 0
    while len(out) < frames:
        if not out or o.get("idr_every") and len(out) % o["idr_every"] == 0:
            out.append((True, "I", 0, True))
            base = 0
            continue
        nb = min(int(rng.integers(0, o.get("b_max", 3) + 1)), frames - len(out) - 1)
        anchor = base + nb + 1
        out.append((False, "P" if rng.random() < o.get("p", 0.85) else "I", anchor, True))
        shown = list(range(base + 1, anchor))
        if o.get("pyramid") and nb >= 3:
            mid = shown[len(shown) // 2]
            out.append((False, "B", mid, True))
            shown.remove(mid)
        for d in shown:
            out.append((False, "B", d, rng.random() < o.get("b_ref", 0.3)))
        base = anchor
    return out[:frames]


def syntax_clip(seed: int, mb_w: int, mb_h: int, frames: int, sps: dict, pps: dict, o: dict,
                info: dict | None = None) -> tuple:
    """(access units, SPS NAL, PPS NAL) of a stream of seeded random choices (see the top). ``o`` sets the
    probabilities: idr_every, p (a P picture), non_ref, slices (the most a picture), long_term, mods, mmco,
    mmco5, qp_range, deblock_idc (choices), skip (the chance a P or B macroblock is skipped), intra_in_p,
    intra_in_b, pcm, i4, i8, t8, ptypes, btypes, bsubs, big_mvd, qp_delta, poc_step; with B pictures
    (:func:`plan_pictures`: b, b_max, pyramid, b_ref) spatial (the chance of spatial direct prediction; temporal
    where the co-located picture allows it), dup (a P list holding its first picture twice), and the display
    order: ``info["poc"]`` and ``info["idr"]``, each access unit's POC and whether it is an IDR picture."""
    rng = np.random.default_rng(seed)
    sps = dict(sps, mb_w=mb_w, mb_h=mb_h)
    sps_b, pps_b = sps_nal(sps), pps_nal(pps)
    max_frame_num = 1 << sps.get("log2_max_frame_num", 4)
    max_refs = max(1, sps.get("refs", 1))
    dpb = Dpb(max_frame_num, max_refs)
    units = []
    prev_ref_frame_num, poc_counter = 0, 0
    last_non_ref = False
    # the dequantised levels' bound: the largest weight a scaling list may apply (the defaults' up to 42)
    sent = [v for lst in (sps.get("scaling"), pps.get("scaling")) if isinstance(lst, list) for x in lst
            if isinstance(x, list) for v in x]
    gain = max([42, *sent]) / 16 if sps.get("scaling") or pps.get("scaling") else 1.0
    o = dict(o, cqp=pps.get("cqp", 0), t8x8=pps.get("t8x8", 0), cabac=pps.get("cabac", 0), gain=gain)
    plan = plan_pictures(rng, frames, o) if o.get("b") else None
    shown = []
    for f in range(frames):
        poc_type = sps.get("poc_type", 0)
        if plan is None:
            idr = f == 0 or (o.get("idr_every") and f % o["idr_every"] == 0)
            p_pic = not idr and rng.random() < o.get("p", 0.85)
            stype = "P" if p_pic else "I"
            ref = idr or rng.random() >= o.get("non_ref", 0.15) or (poc_type == 2 and last_non_ref)
        else:
            idr, stype, disp, ref = plan[f]
            p_pic = stype != "I"
        ref_idc = int(rng.integers(1, 4)) if ref else 0
        last_non_ref = ref_idc == 0
        if idr:
            frame_num = 0
            dpb.refs, dpb.max_long = [], None
            poc_counter = 0
        else:
            frame_num = (prev_ref_frame_num + 1) % max_frame_num
            poc_counter = 2 * disp if plan is not None else poc_counter + o.get("poc_step", 2)
        shown.append(poc_counter)
        # the POC fields
        poc = {}
        if poc_type == 0:
            poc["lsb"] = poc_counter % (1 << sps.get("log2_max_poc_lsb", 5))
        units_nals = [nal(0, 9, bytes([0x30 if p_pic else 0x10]))] if o.get("aud") else []  # access unit delimiters
        units_nals += [sps_b, pps_b] if idr else []
        if o.get("sei") and f == 0:  # user data unregistered: a UUID and text
            units_nals.append(nal(0, 6, bytes([5, 24]) + bytes(range(16)) + b"h264wrtr" + b"\x80"))
        # the marking
        marking = None
        mmco5 = False
        if ref_idc and idr:
            marking = "long" if rng.random() < o.get("idr_long", 0.0) else None
        elif ref_idc and (rng.random() < o.get("mmco", 0.0) or len(dpb.refs) >= max_refs and not dpb.shorts()):
            # (with every reference long-term the sliding window cannot make room: the operations must)
            marking = choose_mmcos(rng, dpb, frame_num, o)
            mmco5 = any(op[0] == 5 for op in marking)
        nslices = int(rng.integers(1, o.get("slices", 1) + 1))
        n_mbs = mb_w * mb_h
        cuts = sorted(set(int(c) for c in rng.choice(np.arange(1, n_mbs), min(nslices - 1, n_mbs - 1),
                                                     replace=False))) if nslices > 1 else []
        starts = [0] + cuts
        pic = Picture(mb_w, mb_h, bool(pps.get("constrained")), bool(sps.get("direct8x8", 1)))
        nrefs_avail = len(dpb.refs)
        pic_lists = []
        for si, first in enumerate(starts):
            end = starts[si + 1] if si + 1 < len(starts) else n_mbs
            b = Bits()
            extra = {}
            if stype == "B":
                init = dpb.initial_b_lists(poc_counter)
                defaults = (pps.get("refs", 1), pps.get("refs1", 1))
                nref = [min(d, nrefs_avail) for d in defaults]
                override = None
                if any(d > nrefs_avail for d in defaults) or rng.random() < o.get("override", 0.3):
                    nref = [int(rng.integers(1, nrefs_avail + 1)) for _ in range(2)]
                    override = tuple(nref)
                mods = tuple(list_mods(dpb, frame_num, nref[x], rng, init[x]) if rng.random() < o.get("mods", 0.0)
                             else None for x in range(2))
                lists = [dpb.modified(init[x], frame_num, nref[x], mods[x]) for x in range(2)]
                col = lists[1][0]
                temporal_ok = col.col_ok and col.col_refs <= {r.uid for r in lists[0]}
                extra["direct_spatial"] = int(rng.random() < o.get("spatial", 0.5) or not temporal_ok)
                nref = tuple(nref)
            else:
                default = pps.get("refs", 1)
                nref = min(default, nrefs_avail) if p_pic else 0
                override = None
                if p_pic and (default > nrefs_avail or rng.random() < o.get("override", 0.3)):
                    nref = int(rng.integers(1, nrefs_avail + 1))
                    override = nref
                mods = None
                dup = bool(p_pic and o.get("dup") and nref >= 2 and rng.random() < o["dup"])
                if p_pic and (dup or rng.random() < o.get("mods", 0.0)):
                    mods = list_mods(dpb, frame_num, nref, rng, dup=dup)
                lists = [dpb.modified(dpb.initial_list(frame_num), frame_num, nref, mods) if p_pic else [], []]
            if (pps.get("weighted") and stype == "P") or (pps.get("bipred") == 1 and stype == "B"):
                wrng = np.random.default_rng(rng.integers(1 << 30))
                counts = nref if stype == "B" else (nref, 0)
                extra["weights"] = lambda bb, wrng=wrng, counts=counts: pred_weight_table(bb, wrng, counts,
                                                                                          stype == "B")
            if pps.get("cabac") and stype != "I":
                extra["cabac_init_idc"] = int(rng.integers(0, 3))
            pic_lists.append(tuple(tuple(r.uid for r in lst if r is not None) for lst in lists))
            lo, hi = o.get("qp_range", (0, 40))
            slice_qp = int(rng.integers(lo, hi + 1))
            idcs = o.get("deblock_idc", [0])
            idc = int(rng.choice(idcs))
            deblock = (idc, int(rng.integers(-6, 7)), int(rng.integers(-6, 7))) if rng.random() < 0.5 else (idc, 0, 0)
            slice_header(b, o, sps, pps, first, stype, idr, ref_idc, frame_num, poc, override, mods, marking,
                         slice_qp - pps.get("qp", 26), deblock, extra)
            qp = slice_qp
            if pps.get("cabac"):
                while b.n % 8:
                    b.u(1, 1)  # cabac_alignment_one_bit
                sx = CabacSyntax(Cabac(b, 0 if stype == "I" else 1 + extra["cabac_init_idc"], slice_qp))
            else:
                sx = Cavlc(b)
            skip = 0
            for addr in range(first, end):
                pic.slice[addr] = si
                ctx = MbContext(pic, addr, si)
                skipped = p_pic and rng.random() < o.get("skip", 0.25)
                if sx.cabac and stype != "I":
                    inc = sum(a is not None and not pic.skip[a] for a in (ctx.nb(-1, 0), ctx.nb(0, -1)))
                    sx.c.decision((24 if stype == "B" else 11) + inc, skipped)
                if skipped:
                    skip += 1
                    pic.skipped(addr, "BSKIP" if stype == "B" else "SKIP")
                    if sx.cabac:
                        sx.last_dqp = 0
                        sx.c.terminate(addr == end - 1)
                    continue
                if p_pic and not sx.cabac:
                    b.ue(skip)
                    skip = 0
                mb = random_mb(rng, ctx, stype, nref if stype == "B" else (nref, 0), qp, o)
                write_mb(sx, ctx, mb, stype, nref if stype == "B" else (nref, 0), bool(pps.get("t8x8")))
                if mb.kind != "PCM" and (mb.cbp or mb.kind == "I16"):
                    qp += mb.qp_delta
                if sx.cabac:
                    sx.c.terminate(addr == end - 1)
            if skip and not sx.cabac:
                b.ue(skip)
            units_nals.append(nal(ref_idc, 5 if idr else 1, b.rbsp(stop=not sx.cabac)))
        units.append(units_nals)
        # the decoder's state after the picture
        if ref_idc:
            cur = Ref(frame_num, poc_counter, f + 1)
            cur.col_refs = {u for lsts in pic_lists for lst in lsts for u in lst}
            cur.col_ok = len(set(pic_lists)) == 1
            if idr:
                if marking == "long":
                    cur.long_idx, dpb.max_long = 0, 0
                dpb.refs = [cur]
            else:
                if marking is None:
                    if len(dpb.refs) >= max_refs and dpb.shorts():
                        dpb.refs.remove(min(dpb.shorts(), key=lambda r: dpb.pic_num(r, frame_num)))
                else:
                    apply_mmcos(dpb, marking, frame_num, cur)
                dpb.refs.append(cur)
                assert len(dpb.refs) <= max_refs
            prev_ref_frame_num = frame_num
            if mmco5:
                prev_ref_frame_num = cur.frame_num = 0
                poc_counter = 0
    if info is not None:
        info["poc"] = shown
        info["idr"] = [bool(u) and any(n[0] & 0x1F == 5 for n in u) for u in units]
    return units, sps_b, pps_b


def choose_mmcos(rng, dpb: Dpb, cur: int, o: dict) -> list:
    """Valid memory management operations for the reference picture with frame_num cur (ops as (op, args...))."""
    ops = []
    sim = Dpb(dpb.max_frame_num, dpb.max_refs)
    sim.refs = [Ref(r.frame_num) for r in dpb.refs]
    for a, r in zip(sim.refs, dpb.refs):
        a.long_idx = r.long_idx
    sim.max_long = dpb.max_long
    if rng.random() < o.get("mmco5", 0.0):
        return [(5,)]
    cur_long = False
    for _ in range(int(rng.integers(1, 4))):
        choices = []
        if sim.shorts():
            choices += [1, 3] if sim.max_long is not None else [1]
        if sim.longs():
            choices.append(2)
        choices.append(4)
        if sim.max_long is not None and not cur_long:
            choices.append(6)
        op = int(rng.choice(choices))
        if op in (1, 3):
            r = sim.shorts()[int(rng.integers(0, len(sim.shorts())))]
            diff = cur - sim.pic_num(r, cur) - 1
            if op == 1:
                ops.append((1, diff))
            else:
                idx = int(rng.integers(0, sim.max_long + 1))
                ops.append((3, diff, idx))
        elif op == 2:
            r = sim.longs()[int(rng.integers(0, len(sim.longs())))]
            ops.append((2, r.long_idx))
        elif op == 4:
            ops.append((4, int(rng.integers(0, dpb.max_refs + 1))))
        else:  # the current picture to long-term ends the list (an operation 4 after it would unmark it)
            ops.append((6, int(rng.integers(0, sim.max_long + 1))))
            cur_long = True
        apply_mmcos(sim, ops[-1:], cur, None)
        if cur_long:
            break
    # room for the current picture
    while len(sim.refs) + 1 > sim.max_refs:
        if sim.shorts():
            r = sim.shorts()[0]
            ops.append((1, cur - sim.pic_num(r, cur) - 1))
        else:
            r = sim.longs()[0]
            ops.append((2, r.long_idx))
        sim.refs.remove(r)
    return ops


def apply_mmcos(dpb: Dpb, ops: list, cur: int, cur_ref) -> None:
    for op in ops:
        if op[0] == 1:
            r = next(r for r in dpb.shorts() if dpb.pic_num(r, cur) == cur - op[1] - 1)
            dpb.refs.remove(r)
        elif op[0] == 2:
            dpb.refs.remove(next(r for r in dpb.longs() if r.long_idx == op[1]))
        elif op[0] == 3:
            r = next(r for r in dpb.shorts() if dpb.pic_num(r, cur) == cur - op[1] - 1)
            for x in dpb.longs():
                if x.long_idx == op[2]:
                    dpb.refs.remove(x)
            r.long_idx = op[2]
        elif op[0] == 4:
            dpb.max_long = op[1] - 1 if op[1] else None
            dpb.refs = [r for r in dpb.refs if r.long_idx is None or (dpb.max_long is not None and
                                                                        r.long_idx <= dpb.max_long)]
        elif op[0] == 5:
            dpb.refs, dpb.max_long = [], None
        elif op[0] == 6:
            for x in dpb.longs():
                if x.long_idx == op[1]:
                    dpb.refs.remove(x)
            if cur_ref is not None:
                cur_ref.long_idx = op[1]


# ------------------------------------------------------------------ coding real frames

CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]])
H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]])
CLS = np.array([[0, 2, 0, 2], [2, 1, 2, 1], [0, 2, 0, 2], [2, 1, 2, 1]])  # raster (y, x) -> dequant class


def _quant(w: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """Levels of forward-transformed blocks (..., 4, 4), as the reference encoder quantises them."""
    mf = np.array(QUANT[qp % 6])[CLS]
    bits = 15 + qp // 6
    f = (1 << bits) // (3 if intra else 6)
    return np.sign(w) * ((np.abs(w) * mf + f) >> bits)


def _dequant(lv: np.ndarray, qp: int) -> np.ndarray:
    return lv * np.array(DEQUANT[qp % 6])[CLS] << (qp // 6)


def _idct(c: np.ndarray) -> np.ndarray:
    """The decoder's inverse transform of (..., 4, 4) coefficients, with its rounding: the residual."""
    def one(d):  # along the last axis
        e0, e1 = d[..., 0] + d[..., 2], d[..., 0] - d[..., 2]
        e2, e3 = (d[..., 1] >> 1) - d[..., 3], d[..., 1] + (d[..., 3] >> 1)
        return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)
    rows = one(c)
    return (np.swapaxes(one(np.swapaxes(rows, -1, -2)), -1, -2) + 32) >> 6


def _blocks(a: np.ndarray) -> np.ndarray:
    """(16, 16) -> (4, 4, 4, 4): [by, bx, y, x]."""
    n = a.shape[0] // 4
    return a.reshape(n, 4, -1, 4).swapaxes(1, 2)


def _unblocks(b: np.ndarray) -> np.ndarray:
    return b.swapaxes(1, 2).reshape(b.shape[0] * 4, -1)


def _scan(block: np.ndarray) -> list:
    flat = block.reshape(16)
    return [int(flat[z]) for z in ZIGZAG]


def _pred16(rec: np.ndarray, x0: int, y0: int, n: int, mode: int, left: bool, top: bool, chroma: bool) -> np.ndarray:
    """Intra 16x16 (luma numbering: V 0, H 1, DC 2, plane 3) or chroma (DC 0, H 1, V 2, plane 3) prediction."""
    if chroma:
        mode = {0: 2, 1: 1, 2: 0, 3: 3}[mode]
    t = rec[y0 - 1, x0:x0 + n].astype(int) if top else None
    l_ = rec[y0:y0 + n, x0 - 1].astype(int) if left else None
    if mode == 0:
        return np.tile(t, (n, 1))
    if mode == 1:
        return np.tile(l_[:, None], (1, n))
    if mode == 3:
        half = n // 2
        corner = int(rec[y0 - 1, x0 - 1])
        tt, ll = np.concatenate([[corner], t]), np.concatenate([[corner], l_])
        hh = sum((i + 1) * (tt[half + i + 1] - tt[half - 1 - i]) for i in range(half))
        vv = sum((i + 1) * (ll[half + i + 1] - ll[half - 1 - i]) for i in range(half))
        a = 16 * (ll[n] + tt[n])
        b, c = ((34 * hh + 32) >> 6, (34 * vv + 32) >> 6) if chroma else ((5 * hh + 32) >> 6, (5 * vv + 32) >> 6)
        yy, xx = np.mgrid[0:n, 0:n]
        return np.clip((a + b * (xx - half + 1) + c * (yy - half + 1) + 16) >> 5, 0, 255)
    if not chroma:
        if top and left:
            s = (t.sum() + l_.sum() + 16) >> 5
        elif top or left:
            s = ((t if top else l_).sum() + 8) >> 4
        else:
            s = 128
        return np.full((n, n), s)
    out = np.zeros((n, n), int)
    for by in range(2):
        for bx in range(2):
            st = t[bx * 4:bx * 4 + 4].sum() if top else 0
            sl = l_[by * 4:by * 4 + 4].sum() if left else 0
            if bx == by:
                s = (st + sl + 4) >> 3 if top and left else (sl + 2) >> 2 if left else (st + 2) >> 2 if top else 128
            elif bx:
                s = (st + 2) >> 2 if top else (sl + 2) >> 2 if left else 128
            else:
                s = (sl + 2) >> 2 if left else (st + 2) >> 2 if top else 128
            out[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = s
    return out


def _code_chroma(mb: Mb, res_u: np.ndarray, res_v: np.ndarray, qpc: int, intra: bool) -> list:
    """Fills mb's chroma levels and chroma cbp from the residuals (8, 8); returns the reconstructed residuals."""
    out = []
    cc = 0
    for c, res in enumerate((res_u, res_v)):
        w = CF @ _blocks(res) @ CF.T  # (2, 2, 4, 4)
        dc = w[:, :, 0, 0]
        hd = np.array([[1, 1], [1, -1]]) @ dc @ np.array([[1, 1], [1, -1]])
        mf, bits = QUANT[qpc % 6][0], 15 + qpc // 6
        f = (1 << bits) // (3 if intra else 6)
        dcl = np.sign(hd) * ((np.abs(hd) * mf + 2 * f) >> (bits + 1))
        ac = _quant(w, qpc, intra)
        ac[:, :, 0, 0] = 0
        mb.cdc[c] = [int(v) for v in dcl.reshape(4)]
        mb.cac[c] = [_scan(ac[k >> 1, k & 1])[1:] for k in range(4)]
        if np.any(ac):
            cc = 2
        elif np.any(dcl):
            cc = max(cc, 1)
        out.append((dcl, ac))
    recs = []
    for dcl, ac in out:
        if cc == 0:
            dcl = dcl * 0
        if cc < 2:
            ac = ac * 0
        f2 = np.array([[1, 1], [1, -1]]) @ dcl @ np.array([[1, 1], [1, -1]])
        d = _dequant(ac, qpc)
        d[:, :, 0, 0] = ((f2 * 16 * DEQUANT[qpc % 6][0]) << (qpc // 6)) >> 5
        recs.append(_unblocks(_idct(d)))
    mb.cbp |= cc << 4
    return recs


def _code_i16(mb: Mb, res: np.ndarray, qp: int) -> np.ndarray:
    """Fills an Intra 16x16 macroblock's luma levels from the residual (16, 16); returns the decoded residual."""
    w = CF @ _blocks(res) @ CF.T
    dc = w[:, :, 0, 0]
    hd = (H4 @ dc @ H4) // 2
    mf, bits = QUANT[qp % 6][0], 15 + qp // 6
    dcl = np.sign(hd) * ((np.abs(hd) * mf + 2 * ((1 << bits) // 3)) >> (bits + 1))
    ac = _quant(w, qp, True)
    ac[:, :, 0, 0] = 0
    mb.dc = _scan(dcl)
    mb.cbp = 15 if np.any(ac) else 0
    for by in range(4):
        for bx in range(4):
            mb.luma[by * 4 + bx] = _scan(ac[by, bx])
    if not mb.cbp:
        ac = ac * 0
    f = H4 @ dcl @ H4
    scale = 16 * DEQUANT[qp % 6][0]
    dcy = (f * scale) << (qp // 6 - 6) if qp >= 36 else (f * scale + (1 << (5 - qp // 6))) >> (6 - qp // 6)
    d = _dequant(ac, qp)
    d[:, :, 0, 0] = dcy
    return _unblocks(_idct(d))


def _intra16_mb(rec: list, y, u, v, mx: int, my: int, ctx: MbContext, qp: int) -> Mb:
    """The Intra 16x16 macroblock at (mx, my) of the best prediction mode by SAD, its levels coded and its
    samples reconstructed into rec (y, u, v) as a decoder does."""
    left, top, tl = ctx.avail_mb()
    src = y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16].astype(int)
    best = None
    for mode in i16_modes_allowed(left, top, tl):
        pred = _pred16(rec[0], mx * 16, my * 16, 16, mode, left, top, False)
        sad = np.abs(src - pred).sum()
        if best is None or sad < best[0]:
            best = (sad, mode, pred)
    mb = Mb("I16")
    mb.i16_mode, pred = best[1], best[2]
    res = _code_i16(mb, src - pred, qp)
    rec[0][my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] = np.clip(pred + res, 0, 255)
    mb.chroma_mode = 0
    cres = []
    cpred = []
    for k, plane in enumerate((u, v)):
        p = _pred16(rec[k + 1], mx * 8, my * 8, 8, 0, left, top, True)
        cpred.append(p)
        cres.append(plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8].astype(int) - p)
    crec = _code_chroma(mb, cres[0], cres[1], CHROMA_QP[qp], True)
    for k in range(2):
        rec[k + 1][my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.clip(cpred[k] + crec[k], 0, 255)
    return mb


def encode(frames_yuv: list, qp: int, reference) -> list:
    """Access units of real frames (see the top): frames_yuv are (y, u, v) planes of a size in whole
    macroblocks; ``reference(units)`` gives the decoded planes of the last frame of the units so far."""
    h, w = frames_yuv[0][0].shape
    mb_w, mb_h = w // 16, h // 16
    sps = {"mb_w": mb_w, "mb_h": mb_h, "refs": 1, "log2_max_poc_lsb": 8}
    pps = {"qp": qp}
    sps_b, pps_b = sps_nal(sps), pps_nal(pps)
    units = []
    for f, (y, u, v) in enumerate(frames_yuv):
        b = Bits()
        idr = f == 0
        slice_header(b, {}, sps, pps, 0, "I" if idr else "P", idr, 3, f % 16, {"lsb": (2 * f) % 256}, None, None,
                     None, 0, (0, 0, 0))
        pic = Picture(mb_w, mb_h, False)
        if idr:
            rec = [np.zeros((h, w), int), np.zeros((h // 2, w // 2), int), np.zeros((h // 2, w // 2), int)]
            for addr in range(mb_w * mb_h):
                pic.slice[addr] = 0
                ctx = MbContext(pic, addr, 0)
                write_mb(Cavlc(b), ctx, _intra16_mb(rec, y, u, v, addr % mb_w, addr // mb_w, ctx, qp), "I", (0, 0))
            units.append([sps_b, pps_b, nal(3, 5, b.rbsp())])
            continue
        ry, ru, rv = (p.astype(int) for p in reference(units))
        skip = 0
        for addr in range(mb_w * mb_h):
            mx, my = addr % mb_w, addr // mb_w
            pic.slice[addr] = 0
            ctx = MbContext(pic, addr, 0)
            mb = Mb("P")
            mb.refs, mb.mvds = [0], [(0, 0)]
            res = y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16].astype(int) - ry[my * 16:my * 16 + 16,
                                                                                  mx * 16:mx * 16 + 16]
            lv = _quant(CF @ _blocks(res) @ CF.T, qp, False)
            for k, (bx, by) in enumerate(BLOCK_ORDER):
                if np.any(lv[by, bx]):
                    mb.cbp |= 1 << (k // 4)
            for by in range(4):
                for bx in range(4):
                    mb.luma[by * 4 + bx] = _scan(lv[by, bx])
            for k in range(4):  # a luma 8x8 with nothing but a lone 1 goes uncoded
                bx, by = (k & 1) * 2, (k >> 1) * 2
                if np.abs(lv[by:by + 2, bx:bx + 2]).sum() <= 1:
                    mb.cbp &= ~(1 << k)
            cres = [p[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8].astype(int) - r[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8]
                    for p, r in ((u, ru), (v, rv))]
            _code_chroma(mb, cres[0], cres[1], CHROMA_QP[qp], False)
            if not mb.cbp:
                skip += 1
                pic.kind[addr] = "SKIP"
                continue
            b.ue(skip)
            skip = 0
            write_mb(Cavlc(b), ctx, mb, "P", (1, 0))
        if skip:
            b.ue(skip)
        units.append([nal(2, 1, b.rbsp())])
    return units


def _idct8_float(d):
    """The 8x8 inverse transform's one-dimensional stage (8.5.13.2) without its roundings."""
    a0, a4, a2, a6 = d[0] + d[4], d[0] - d[4], d[2] / 2 - d[6], d[2] + d[6] / 2
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1 = -d[3] + d[5] - d[7] - d[7] / 2
    a3 = d[1] + d[7] - d[3] - d[3] / 2
    a5 = -d[1] + d[7] + d[5] + d[5] / 2
    a7 = d[3] + d[5] + d[1] + d[1] / 2
    b1, b7, b3, b5 = a1 + a7 / 4, a7 - a1 / 4, a3 + a5 / 4, a3 / 4 - a5
    return [b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7]


M8_INV = np.linalg.inv(np.array([_idct8_float(np.eye(8)[k]) for k in range(8)]).T)
CLS8 = np.array([[0 if x % 4 == 0 and y % 4 == 0 else 1 if x % 2 and y % 2 else 2 if x % 4 == 2 and y % 4 == 2 else
                  3 if (x % 4 == 0 and y % 2) or (x % 2 and y % 4 == 0) else
                  4 if (x % 4 == 0 and y % 4 == 2) or (x % 4 == 2 and y % 4 == 0) else 5 for x in range(8)]
                 for y in range(8)])


def _quant8(res: np.ndarray, qp: int) -> list:
    """Levels (scan order) of each 8x8 block of a 16x16 inter residual under flat scaling lists: the transform
    the decoder's inverts, quantised with an inter dead zone."""
    out = []
    step = np.array(NORM8[qp % 6])[CLS8] * 2.0 ** (qp // 6) / 4  # LevelScale8x8 * 2^(qP/6) / 64, flat lists
    for k in range(4):
        blk = res[(k >> 1) * 8:(k >> 1) * 8 + 8, (k & 1) * 8:(k & 1) * 8 + 8]
        d = M8_INV @ (64.0 * blk) @ M8_INV.T
        lv = (np.sign(d) * np.floor(np.abs(d) / step + 1 / 6)).astype(int).reshape(64)
        out.append([int(lv[z]) for z in ZIGZAG8])
    return out


HIGH_GOP = [(0, "I", True), (4, "P", True), (2, "B", True), (1, "B", False), (3, "B", False), (7, "P", True),
            (5, "B", True), (6, "B", False)]  # display index, type, reference; in decoding order


def encode_high(frames_yuv: list, qp: int, reference) -> tuple:
    """(access units, each one's display index) of 8 real frames in the High profile as x264's defaults code
    them: CABAC, the 8x8 transform, and ``HIGH_GOP``'s pyramid of B pictures between P pictures. The IDR
    picture is Intra 16x16 macroblocks; a P picture's are one zero-vector 16x16 partition, or P_Skip, against
    the last anchor (moved to the head of list 0 by a list modification); a B picture's are B_Direct_16x16 or
    B_Skip: spatial direct over neighbours of reference index 0, so every vector is 0 and each sample the
    implicitly weighted mean of both lists' first pictures. ``reference(units)`` gives the frames libavcodec
    decodes from the units so far, in display order."""
    h, w = frames_yuv[0][0].shape
    mb_w, mb_h = w // 16, h // 16
    sps = {"mb_w": mb_w, "mb_h": mb_h, "profile": 100, "level": 40, "refs": 3, "log2_max_poc_lsb": 8,
           "reorder": 2}
    pps = {"qp": qp, "cabac": 1, "t8x8": 1, "bipred": 2, "cqp2": 0}
    sps_b, pps_b = sps_nal(sps), pps_nal(pps)
    dpb = Dpb(16, 3)
    units, shown, decoded = [], [], []
    prev_ref_frame_num = 0
    for disp, typ, is_ref in HIGH_GOP[:len(frames_yuv)]:
        y, u, v = (p.astype(int) for p in frames_yuv[disp])
        idr = disp == 0
        frame_num = 0 if idr else (prev_ref_frame_num + 1) % 16
        poc = 2 * disp
        b = Bits()
        mods, extra = None, {"cabac_init_idc": 0}
        if typ == "P":
            init = dpb.initial_list(frame_num)
            anchor = max((r for r in dpb.refs), key=lambda r: r.poc)
            if init[0] is not anchor:
                num = dpb.pic_num(anchor, frame_num)
                mods = [(0, frame_num - num - 1)]
            lists = [dpb.modified(init, frame_num, 1, mods), []]
        elif typ == "B":
            lists = [lst[:1] for lst in dpb.initial_b_lists(poc)]
            extra["direct_spatial"] = 1
        slice_header(b, {}, sps, pps, 0, typ, idr, 3 if is_ref else 0, frame_num, {"lsb": poc % 256}, None,
                     (None, None) if typ == "B" else mods, None, 0, (0, 0, 0), extra)
        while b.n % 8:
            b.u(1, 1)
        sx = CabacSyntax(Cabac(b, 0 if typ == "I" else 1, qp))
        pic = Picture(mb_w, mb_h, False)
        if typ == "I":
            rec = [np.zeros((h, w), int), np.zeros((h // 2, w // 2), int), np.zeros((h // 2, w // 2), int)]
        else:
            frames = reference(units)
            planes = dict(zip(sorted(decoded), frames))
            refs = [[p.astype(int) for p in planes[lst[0].poc]] for lst in lists if lst]
            if typ == "B":
                p0, p1 = lists[0][0], lists[1][0]
                td, tb = max(-128, min(127, p1.poc - p0.poc)), max(-128, min(127, poc - p0.poc))
                w1 = 32
                if td:
                    tx = (16384 + abs(td) // 2) // td if td > 0 else -((16384 + abs(td) // 2) // -td)
                    scale = max(-1024, min(1023, (tb * tx + 32) >> 6)) >> 2
                    w1 = scale if -64 <= scale <= 128 else 32
                pred = [np.clip((a * (64 - w1) + c * w1 + 32) >> 6, 0, 255) for a, c in zip(*refs)]
            else:
                pred = refs[0]
        for addr in range(mb_w * mb_h):
            mx, my = addr % mb_w, addr // mb_w
            pic.slice[addr] = 0
            ctx = MbContext(pic, addr, 0)
            if typ == "I":
                write_mb(sx, ctx, _intra16_mb(rec, y, u, v, mx, my, ctx, qp), "I", (0, 0), True)
                sx.c.terminate(addr == mb_w * mb_h - 1)
                continue
            mb = Mb(typ)
            if typ == "P":
                mb.refs, mb.mvds = [0], [(0, 0)]
            mb.luma8 = _quant8(y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16] -
                               pred[0][my * 16:my * 16 + 16, mx * 16:mx * 16 + 16], qp)
            mb.cbp = sum(1 << k for k in range(4) if any(mb.luma8[k]))
            mb.t8 = mb.cbp > 0
            cres = [p[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] - r[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8]
                    for p, r in ((u, pred[1]), (v, pred[2]))]
            _code_chroma(mb, cres[0], cres[1], CHROMA_QP[qp], False)
            skip = mb.cbp == 0
            inc = sum(a is not None and not pic.skip[a] for a in (ctx.nb(-1, 0), ctx.nb(0, -1)))
            sx.c.decision((24 if typ == "B" else 11) + inc, skip)
            if skip:
                pic.skipped(addr, "BSKIP" if typ == "B" else "SKIP")
                sx.last_dqp = 0
            else:
                write_mb(sx, ctx, mb, typ, (1, 1 if typ == "B" else 0), True)
            sx.c.terminate(addr == mb_w * mb_h - 1)
        unit = [sps_b, pps_b] if idr else []
        units.append(unit + [nal(3 if is_ref else 0, 5 if idr else 1, b.rbsp(stop=False))])
        shown.append(disp)
        decoded.append(poc)
        if is_ref:
            cur = Ref(frame_num, poc, len(units))
            if idr:
                dpb.refs = [cur]
            else:
                if len(dpb.refs) >= dpb.max_refs:
                    dpb.refs.remove(min(dpb.shorts(), key=lambda r: dpb.pic_num(r, frame_num)))
                dpb.refs.append(cur)
            prev_ref_frame_num = frame_num
    return units, shown
