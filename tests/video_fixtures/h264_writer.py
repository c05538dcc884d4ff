"""An H.264 writer of the tests' own: nothing in cv2's wheel encodes H.264,
so the port's decoder is held to cv2's decoder on streams written here.

Two kinds of stream, both CAVLC I and P slices of frame pictures:

* :func:`syntax_clip` makes seeded random choices over every tool the
  port's decoder names in ``native.H264_TALLY``: macroblock types, Intra
  4x4 / 16x16 / chroma modes (only those whose neighbouring samples are
  available, ``constrained_intra_pred`` respected), residual levels of
  every CAVLC suffix length and escape, motion vector differences, several
  slices a picture with their own QP and deblocking control, multiple and
  long-term references, reference list modifications, MMCO 1-6, non-
  reference pictures, the three POC types, frame cropping and the VUI's
  range flag. The pictures are noise; libavcodec's reconstruction of them
  is the oracle.
* :func:`encode` codes real frames: an IDR picture of Intra 16x16
  macroblocks (the writer reconstructs them as a decoder does, for the
  next macroblocks' prediction), then P pictures of zero-vector 16x16
  partitions and skipped macroblocks against the decoded previous frame,
  which ``reference`` (libavcodec through ctypes) hands back, so the writer
  needs no deblocking filter of its own.

Each returns access units: lists of NAL units (bytes, without start codes).
:func:`annex_b`, :func:`length_prefixed` and :func:`avcc` lay them out
for AVI (start codes), and MP4 / Matroska (lengths and an avcC record).
The tables are ITU-T H.264's (Tables 9-4, 9-5, 9-7 to 9-10).
"""

from __future__ import annotations

import numpy as np

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

    def rbsp(self) -> bytes:
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

def sps_nal(o: dict) -> bytes:
    """An SPS from options: mb_w, mb_h and the optional profile (66, 77, 100), sps_id, log2_max_frame_num,
    poc_type, log2_max_poc_lsb, poc1 ((always_zero, non_ref, top_to_bottom, offsets)), refs, crop ((l, r, t, b) in
    2-sample units), full_range, timing ((units, scale)), reorder (num_reorder_frames); and, for the refusals,
    chroma_format, bit_depth, frame_mbs_only 0, scaling."""
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
        b.u(1, 0)
        b.u(1, o.get("scaling", 0))
        if o.get("scaling"):
            b.u(8, 0)  # no list sent: the fall-back rule
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
    b.u(1, 1)  # direct_8x8_inference_flag
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
    """A PPS from options: pps_id, sps_id, refs (num_ref_idx_l0_default_active), qp (pic_init_qp), cqp
    (chroma_qp_index_offset), cqp2 (second_chroma_qp_index_offset: writes the High profile's tail), deblock
    (deblocking_filter_control_present_flag), constrained, bottom_poc; and, for the refusals, cabac, slice_groups,
    weighted, redundant, t8x8, scaling."""
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
    b.ue(0)
    b.u(1, o.get("weighted", 0))
    b.u(2, 0)
    b.se(o.get("qp", 26) - 26)
    b.se(0)
    b.se(o.get("cqp", 0))
    b.u(1, o.get("deblock", 1))
    b.u(1, o.get("constrained", 0))
    b.u(1, o.get("redundant", 0))
    if "cqp2" in o or o.get("t8x8") or o.get("scaling"):
        b.u(1, o.get("t8x8", 0))
        b.u(1, o.get("scaling", 0))
        if o.get("scaling"):
            b.u(6, 0)
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


# ------------------------------------------------------------------ macroblocks

class Mb:
    """What one macroblock codes. kind: "I4", "I16", "PCM", "P", "SKIP"."""

    def __init__(self, kind: str):
        self.kind = kind
        self.modes = [2] * 16  # I4: the modes in luma4x4BlkIdx order
        self.i16_mode = 2
        self.chroma_mode = 0
        self.cbp = 0
        self.qp_delta = 0
        self.ptype = 0  # P: 0 16x16, 1 16x8, 2 8x16, 3 8x8, 4 8x8ref0
        self.sub = [0, 0, 0, 0]
        self.refs: list = []
        self.mvds: list = []
        self.luma = [[0] * 16 for _ in range(16)]  # by raster block, scan order (an I16 block's AC at 1..15)
        self.dc = [0] * 16  # I16 DC, scan order
        self.cdc = [[0] * 4, [0] * 4]
        self.cac = [[[0] * 15 for _ in range(4)] for _ in range(2)]
        self.pcm = b""


class Picture:
    """The writer's view of the picture being written: each macroblock's slice, kind, Intra 4x4 modes and
    total_coeff counts (what neighbouring macroblocks' syntax depends on)."""

    def __init__(self, mb_w: int, mb_h: int, constrained: bool):
        n = mb_w * mb_h
        self.mb_w, self.mb_h, self.constrained = mb_w, mb_h, constrained
        self.slice = [-1] * n
        self.kind = [""] * n
        self.modes = [[-1] * 16 for _ in range(n)]
        self.nz = [[0] * 16 for _ in range(n)]
        self.nzc = [[[0] * 4, [0] * 4] for _ in range(n)]

    def mb(self, x: int, y: int, s: int):
        """The address of the macroblock at (x, y) when it lies in slice s, else None."""
        if 0 <= x < self.mb_w and 0 <= y < self.mb_h and self.slice[y * self.mb_w + x] == s:
            return y * self.mb_w + x
        return None

    def intra_ok(self, x: int, y: int, s: int) -> bool:
        a = self.mb(x, y, s)
        return a is not None and (not self.constrained or self.kind[a] in ("I4", "I16", "PCM"))


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
            if a is None or (self.p.constrained and self.p.kind[a] not in ("I4", "I16", "PCM")):
                dc = True
                vals.append(2)
            else:
                vals.append(self.p.modes[a][(y4 % 4) * 4 + x4 % 4] if self.p.kind[a] == "I4" else 2)
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


def write_mb(b: Bits, ctx: MbContext, mb: Mb, p_slice: bool, nref: int) -> None:
    """Writes the macroblock_layer() of mb (not a skipped one) and records what its neighbours read."""
    pic, addr = ctx.p, ctx.addr
    pic.kind[addr] = mb.kind
    pic.nz[addr] = [0] * 16
    pic.nzc[addr] = [[0] * 4, [0] * 4]
    off = 5 if p_slice else 0
    if mb.kind == "PCM":
        b.ue(off + 25)
        b.align_zero()
        for v in mb.pcm:
            b.u(8, v)
        pic.nz[addr] = [16] * 16
        pic.nzc[addr] = [[16] * 4, [16] * 4]
        return
    if mb.kind == "P":
        b.ue(mb.ptype)
        if mb.ptype >= 3:
            for s in mb.sub:
                b.ue(s)
            if mb.ptype == 3 and nref > 1:
                for r in mb.refs:
                    b.te(nref - 1, r)
        elif nref > 1:
            for r in mb.refs:
                b.te(nref - 1, r)
        for dx, dy in mb.mvds:
            b.se(dx)
            b.se(dy)
        b.ue(INTER_CBP_CODE[mb.cbp])
    elif mb.kind == "I4":
        b.ue(off)
        for k, (bx, by) in enumerate(BLOCK_ORDER):
            pred = ctx.pred_mode(bx, by)
            mode = mb.modes[k]
            pic.modes[addr][by * 4 + bx] = mode
            if mode == pred:
                b.u(1, 1)
            else:
                b.u(1, 0)
                b.u(3, mode if mode < pred else mode - 1)
        b.ue(mb.chroma_mode)
        b.ue(INTRA_CBP_CODE[mb.cbp])
    else:  # I16
        ac = mb.cbp & 15
        assert ac in (0, 15)
        b.ue(off + 1 + mb.i16_mode + 4 * (mb.cbp >> 4) + (12 if ac else 0))
        b.ue(mb.chroma_mode)
    if mb.kind != "I4":
        pic.modes[addr] = [-1] * 16
    if mb.cbp or mb.kind == "I16":
        b.se(mb.qp_delta)
    i16 = mb.kind == "I16"
    if i16:
        cavlc(b, mb.dc, _nc(ctx.luma_nz(-1, 0), ctx.luma_nz(0, -1)))
    for k, (bx, by) in enumerate(BLOCK_ORDER):
        if not mb.cbp >> (k // 4) & 1:
            continue
        nc = _nc(ctx.luma_nz(bx - 1, by), ctx.luma_nz(bx, by - 1))
        lv = mb.luma[by * 4 + bx]
        pic.nz[addr][by * 4 + bx] = cavlc(b, lv[1:] if i16 else lv, nc)
    if mb.cbp >> 4:
        for c in range(2):
            cavlc(b, mb.cdc[c], -1)
    if mb.cbp >> 4 == 2:
        for c in range(2):
            for k in range(4):
                bx, by = k & 1, k >> 1
                nc = _nc(ctx.chroma_nz(c, bx - 1, by), ctx.chroma_nz(c, bx, by - 1))
                pic.nzc[addr][c][k] = cavlc(b, mb.cac[c][k], nc)


# ------------------------------------------------------------------ the reference buffer

class Ref:
    def __init__(self, frame_num: int):
        self.frame_num, self.long_idx = frame_num, None


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


def list_mods(dpb: Dpb, cur: int, n: int, rng) -> list:
    """Random ref_pic_list_modification commands for a list of n entries."""
    init = dpb.initial_list(cur)
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

def random_levels(rng, n: int, qp: int, dense: float = 0.3) -> list:
    """n levels (scan order) of a random block: mostly zeros and ones, sometimes a ramp to large levels (every
    suffix length), bounded so that the dequantised block stays inside 16 bits."""
    cap = max(2, 3000 // (25 << (qp // 6)))
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
    weight = 29 << (qp // 6)
    while sum(abs(v) for v in out) * weight > 20000:
        k = max(range(n), key=lambda i: abs(out[i]))
        out[k] -= int(np.sign(out[k]))
    return out


def random_mb(rng, ctx: MbContext, p_slice: bool, nref: int, qp: int, o: dict) -> Mb:
    """A random macroblock (not skipped) at ctx, its intra modes among those its neighbours allow."""
    intra_p = o.get("intra_in_p", 0.2)
    if p_slice and rng.random() >= intra_p:
        mb = Mb("P")
        mb.ptype = int(rng.choice(5, p=o.get("ptypes", [0.3, 0.2, 0.2, 0.2, 0.1])))
        if mb.ptype >= 3:
            mb.sub = [int(s) for s in rng.integers(0, 4, 4)]
            parts = sum(4 // (SUB_SIZES[s][0] * SUB_SIZES[s][1]) for s in mb.sub)
            mb.refs = [int(rng.integers(0, nref)) for _ in range(4)] if mb.ptype == 3 else []
        else:
            parts = 1 if mb.ptype == 0 else 2
            mb.refs = [int(rng.integers(0, nref)) for _ in range(parts)]
        big = o.get("big_mvd", 0.1)

        def mvd():
            if rng.random() < 0.25:
                return 0
            return int(rng.integers(-64, 65)) if rng.random() < big else int(rng.integers(-9, 10))
        mb.mvds = [(mvd(), mvd()) for _ in range(parts)]
        mb.cbp = int(rng.integers(0, 48))
    else:
        r = rng.random()
        pcm = o.get("pcm", 0.04)
        kind = "PCM" if r < pcm else "I4" if r < pcm + (1 - pcm) * o.get("i4", 0.5) else "I16"
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
        else:
            mb.i16_mode = int(rng.choice(i16_modes_allowed(left, top, tl)))
            mb.cbp = int(rng.integers(0, 3)) << 4 | (15 if rng.random() < 0.5 else 0)
    if mb.cbp or mb.kind == "I16":
        d = o.get("qp_delta", 0.3)
        mb.qp_delta = int(rng.integers(-4, 5)) if rng.random() < d else 0
        lo, hi = o.get("qp_range", (0, 40))
        mb.qp_delta = max(lo - qp, min(hi - qp, mb.qp_delta))
    q = qp + mb.qp_delta
    i16 = mb.kind == "I16"
    if i16:
        mb.dc = random_levels(rng, 16, q)
    for k, (bx, by) in enumerate(BLOCK_ORDER):
        if mb.cbp >> (k // 4) & 1:
            lv = random_levels(rng, 15 if i16 else 16, q)
            mb.luma[by * 4 + bx] = [0] + lv if i16 else lv
    qc = CHROMA_QP[max(0, min(51, q + o.get("cqp", 0)))]
    if mb.cbp >> 4:
        mb.cdc = [random_levels(rng, 4, qc) for _ in range(2)]
    if mb.cbp >> 4 == 2:
        mb.cac = [[random_levels(rng, 15, qc) for _ in range(4)] for _ in range(2)]
    return mb


def slice_header(b: Bits, o: dict, sps: dict, pps: dict, first_mb: int, p_slice: bool, idr: bool, ref_idc: int,
                 frame_num: int, poc: dict, nref_override, mods, marking, qp_delta: int, deblock) -> None:
    b.ue(first_mb)
    b.ue(0 if p_slice else 2)
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
    if p_slice:
        b.u(1, nref_override is not None)
        if nref_override is not None:
            b.ue(nref_override - 1)
        b.u(1, bool(mods))
        if mods:
            for idc, v in mods:
                b.ue(idc)
                b.ue(v)
            b.ue(3)
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
    b.se(qp_delta)
    if pps.get("deblock", 1):
        idc, alpha, beta = deblock
        b.ue(idc)
        if idc != 1:
            b.se(alpha)
            b.se(beta)


def syntax_clip(seed: int, mb_w: int, mb_h: int, frames: int, sps: dict, pps: dict, o: dict) -> tuple:
    """(access units, SPS NAL, PPS NAL) of a stream of seeded random choices (see the top). ``o`` sets the
    probabilities: idr_every, p (a P picture), non_ref, slices (the most a picture), long_term, mods, mmco,
    mmco5, qp_range, deblock_idc (choices), skip (the chance a P macroblock is skipped), intra_in_p, pcm, i4,
    ptypes, big_mvd, qp_delta, poc_step."""
    rng = np.random.default_rng(seed)
    sps = dict(sps, mb_w=mb_w, mb_h=mb_h)
    sps_b, pps_b = sps_nal(sps), pps_nal(pps)
    max_frame_num = 1 << sps.get("log2_max_frame_num", 4)
    max_refs = max(1, sps.get("refs", 1))
    dpb = Dpb(max_frame_num, max_refs)
    units = []
    prev_ref_frame_num, poc_counter = 0, 0
    last_non_ref = False
    o = dict(o, cqp=pps.get("cqp", 0))
    for f in range(frames):
        idr = f == 0 or (o.get("idr_every") and f % o["idr_every"] == 0)
        p_pic = not idr and rng.random() < o.get("p", 0.85)
        poc_type = sps.get("poc_type", 0)
        ref = idr or rng.random() >= o.get("non_ref", 0.15) or (poc_type == 2 and last_non_ref)
        ref_idc = int(rng.integers(1, 4)) if ref else 0
        last_non_ref = ref_idc == 0
        if idr:
            frame_num = 0
            dpb.refs, dpb.max_long = [], None
            poc_counter = 0
        else:
            frame_num = (prev_ref_frame_num + 1) % max_frame_num
            poc_counter += o.get("poc_step", 2)
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
        pic = Picture(mb_w, mb_h, bool(pps.get("constrained")))
        nrefs_avail = len(dpb.refs)
        for si, first in enumerate(starts):
            end = starts[si + 1] if si + 1 < len(starts) else n_mbs
            b = Bits()
            default = pps.get("refs", 1)
            nref = min(default, nrefs_avail) if p_pic else 0
            override = None
            if p_pic and (default > nrefs_avail or rng.random() < o.get("override", 0.3)):
                nref = int(rng.integers(1, nrefs_avail + 1))
                override = nref
            mods = None
            if p_pic and rng.random() < o.get("mods", 0.0):
                mods = list_mods(dpb, frame_num, nref, rng)
            lo, hi = o.get("qp_range", (0, 40))
            slice_qp = int(rng.integers(lo, hi + 1))
            idcs = o.get("deblock_idc", [0])
            idc = int(rng.choice(idcs))
            deblock = (idc, int(rng.integers(-6, 7)), int(rng.integers(-6, 7))) if rng.random() < 0.5 else (idc, 0, 0)
            slice_header(b, o, sps, pps, first, p_pic, idr, ref_idc, frame_num, poc, override, mods, marking,
                         slice_qp - pps.get("qp", 26), deblock)
            qp = slice_qp
            skip = 0
            for addr in range(first, end):
                pic.slice[addr] = si
                ctx = MbContext(pic, addr, si)
                if p_pic and rng.random() < o.get("skip", 0.25):
                    skip += 1
                    pic.kind[addr] = "SKIP"
                    pic.nz[addr] = [0] * 16
                    pic.nzc[addr] = [[0] * 4, [0] * 4]
                    pic.modes[addr] = [-1] * 16
                    continue
                if p_pic:
                    b.ue(skip)
                    skip = 0
                mb = random_mb(rng, ctx, p_pic, nref, qp, o)
                write_mb(b, ctx, mb, p_pic, nref)
                if mb.kind != "PCM" and (mb.cbp or mb.kind == "I16"):
                    qp += mb.qp_delta
            if skip:
                b.ue(skip)
            units_nals.append(nal(ref_idc, 5 if idr else 1, b.rbsp()))
        units.append(units_nals)
        # the decoder's state after the picture
        if ref_idc:
            cur = Ref(frame_num)
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
        slice_header(b, {}, sps, pps, 0, not idr, idr, 3, f % 16, {"lsb": (2 * f) % 256}, None, None, None, 0,
                     (0, 0, 0))
        pic = Picture(mb_w, mb_h, False)
        if idr:
            rec = [np.zeros((h, w), int), np.zeros((h // 2, w // 2), int), np.zeros((h // 2, w // 2), int)]
            for addr in range(mb_w * mb_h):
                mx, my = addr % mb_w, addr // mb_w
                pic.slice[addr] = 0
                ctx = MbContext(pic, addr, 0)
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
                write_mb(b, ctx, mb, False, 0)
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
            write_mb(b, ctx, mb, True, 1)
        if skip:
            b.ue(skip)
        units.append([nal(2, 1, b.rbsp())])
    return units
