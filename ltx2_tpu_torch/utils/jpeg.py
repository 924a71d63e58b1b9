"""JPEG decoding without PIL (the counterpart of what the JAX package gets
from `Image.open(...).convert("RGB")` on a JPEG: libjpeg-turbo's decode at
PIL's defaults).

What it decodes: SOF0, SOF1 and SOF2 (progressive) frames, 8-bit,
Huffman-coded, with one or three components, in interleaved or
single-component scans; any integer sampling (4:4:4, 4:2:2, 4:2:0 and 4:4:0
through libjpeg's fancy upsamplers, other integer ratios by replication as
libjpeg's `int_upsample`); DRI restart intervals with RST0-7, DHT and DRI
between scans; APPn (EXIF orientation too, which PIL's `open` does not
apply) and COM are skipped; frames without DHT segments (as many MJPEG
streams are) take the standard tables of ITU T.81 Annex K.3, as
libjpeg-turbo's `jinit_huff_decoder` does; RGB-coded files (libjpeg's
guess: no JFIF marker and an Adobe transform of 0, or R, G, B component
ids) skip the colour conversion. Lossless, hierarchical, arithmetic-coded
and 12-bit files, CMYK and other 4-component files (PIL's mode CMYK, which
the JAX package refuses), and a progressive file whose scans leave
coefficient bits unsent (libjpeg then smooths its blocks) raise a
ValueError naming what they are.

The steps reproduce libjpeg-turbo's, so the output equals PIL's bit for bit:
- entropy decoding, sequential by nature: each restart interval's bytes
  unstuffed, read through 40-bit windows at every byte offset, each
  Huffman code found by one lookup of the next 16 bits in a 65536-entry
  table (code length, symbol);
- progressive scans (`jdphuff.c`) into one coefficient array a component:
  DC first scans (the predictor shifted by Al) and refinements (one bit a
  block, in array code), AC first scans (a band Ss..Se, EOB runs skipped
  whole), AC refinements, whose correction bits are only counted while
  the symbols are walked (a block's non-zero set as a 64-bit mask) and are
  read and applied afterwards in array code; then the sequential path
  below, unchanged;
- dequantization and the islow integer IDCT (`jidctint.c`: CONST_BITS 13,
  PASS1_BITS 2, the IDCT range-limit table with its & 1023 wrap), in int64
  over all blocks at once;
- the fancy upsampling PIL leaves on (`jdsample.c`: `h2v1_fancy_upsample`
  and `h2v2_fancy_upsample` with their +1/+2 and +8/+7 rounding,
  `h1v2_fancy_upsample`; replication when the downsampled width is 2 or
  less), over each component plane cropped to its downsampled size, the
  edge column and row repeated as libjpeg's context rows repeat them;
- the fixed-point YCbCr -> RGB tables of `jdcolor.c` (SCALEBITS 16);
grayscale comes out as three equal channels, as `convert("RGB")` makes it.

`encode_jpeg` writes what PIL's `Image.fromarray(rgb).save(buf, "JPEG",
quality=q)` writes through libjpeg-turbo, byte for byte (the MJPEG writers'
frames): SOI, a JFIF 1.01 APP0, the Annex K tables scaled by
`jpeg_quality_scaling` (baseline, clamped to 1-255), SOF0 at 4:2:0, the
four standard Huffman tables, one interleaved scan, EOI. Its steps are
libjpeg-turbo's, in array code over every block at once:
- `jccolor.c`'s fixed-point RGB -> YCbCr (SCALEBITS 16, the 0.5 - epsilon
  chroma rounding);
- the edge replication of `jcprepct.c` and `expand_right_edge` (rows paired
  for the chroma, each plane padded to whole MCUs or blocks), then
  `jcsample.c`'s h2v2 downsampling with its alternating bias of 1 and 2;
- `jfdctint.c`'s islow DCT (int32 is wide enough), `jcdctmgr.c`'s
  quantization through 16-bit reciprocals (`compute_reciprocal`);
- `jccoefct.c`'s dummy blocks past the image in the last MCUs (zero, with
  the DC of the block before them);
- `jchuff.c`'s codes: every DC difference and every non-zero AC with its
  run (ZRL codes folded in) and EOB, sorted into stream order, packed into
  64-bit words, the last byte filled with 1-bits, 0xFF bytes stuffed.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

EOI, SOS, DHT, DQT, DRI, APP14 = 0xD9, 0xDA, 0xC4, 0xDB, 0xDD, 0xEE
_FRAME_KINDS = {
    0xC0: None, 0xC1: None, 0xC2: None,
    0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)", 0xC7: "hierarchical (differential lossless)",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded hierarchical", 0xCE: "arithmetic-coded hierarchical progressive",
    0xCF: "arithmetic-coded hierarchical lossless",
}

# jpeg_natural_order: the natural (row-major) index of the k-th zigzag coefficient.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
# ITU T.81 Annex K.3 (libjpeg's jstdhuff.c): (code counts by length 1-16, symbols)
# for table slot 0 (luminance) and 1 (chrominance).
STANDARD_TABLES = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), bytes(range(12))),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _AC_LUMA),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _AC_CHROMA),
}

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172


def _idct_range_limit() -> np.ndarray:
    """libjpeg's IDCT_range_limit indexed by x & 1023: x + 128 for x in
    [-128, 127], 255 up to 511, 0 from 512 to 895 (i.e. -384 to -129),
    then x + 128 again for -128 ... -1 (896 ... 1023)."""
    table = np.empty(1024, np.uint8)
    table[:128] = np.arange(128, 256)
    table[128:512] = 255
    table[512:896] = 0
    table[896:] = np.arange(0, 128)
    return table


RANGE_LIMIT = _idct_range_limit()


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16), indexed by the sample."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v: float) -> int:
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


CR_R, CB_B, CR_G, CB_G = _ycc_tables()


class _Huffman:
    """One Huffman table as a 65536-entry lookup of the next 16 bits:
    (code length << 8) | symbol, 0 where no code matches."""

    def __init__(self, counts, symbols: bytes):
        lut = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if k >= len(symbols):
                    raise ValueError("JPEG: a Huffman table lists more codes than symbols")
                span = 1 << (16 - length)
                lut[code * span:(code + 1) * span] = (length << 8) | symbols[k]
                code += 1
                k += 1
            code <<= 1
        self.lut = lut.tolist()


PAD_BYTES = 256  # past a segment's end: more than one block's bits (64 x 27)


def _windows(segment: bytes) -> list:
    """The 40-bit big-endian window at every byte offset of an unstuffed
    segment (zeros past its end, as libjpeg inserts zeros at the end of
    data)."""
    b = np.frombuffer(segment + bytes(PAD_BYTES + 4), np.uint8).astype(np.int64)
    n = len(segment) + PAD_BYTES
    w = (b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16) | (b[3:n + 3] << 8) | b[4:n + 4]
    return w.tolist()


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.quant: Optional[np.ndarray] = None
        self.coef = None  # a list (sequential) or (blocks, 64) int32 (progressive), zigzag order
        self.coef_bits = np.full(64, -1)  # the Al of each coefficient's last scan, -1 before any


class JPEGFrame:
    """A parsed baseline frame: geometry, components, tables and scans."""

    def __init__(self, data: bytes, name: str = "JPEG"):
        self.name = name
        if not data.startswith(b"\xff\xd8"):
            raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
        self.data = data
        self.quant: Dict[int, np.ndarray] = {}
        self.huff: Dict[Tuple[int, int], _Huffman] = {}
        self.restart = 0
        self.components: List[_Component] = []
        self.width = self.height = 0
        self.jfif = False
        self.adobe_transform: Optional[int] = None
        self.progressive = False
        self._parse()

    def _fail(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    def _parse(self) -> None:
        data, pos, frame_seen = self.data, 2, False
        while True:
            while pos < len(data) and data[pos] != 0xFF:
                pos += 1  # garbage between segments, as libjpeg skips it
            while pos < len(data) and data[pos] == 0xFF:
                pos += 1  # fill bytes
            if pos >= len(data):
                self._fail("truncated JPEG (no EOI marker)")
            marker = data[pos]
            pos += 1
            if marker == EOI:
                break
            if 0xD0 <= marker <= 0xD7 or marker == 0x01:
                continue
            if pos + 2 > len(data):
                self._fail("truncated JPEG segment")
            (length,) = struct.unpack_from(">H", data, pos)
            if pos + length > len(data):
                self._fail(f"truncated JPEG: segment 0xFF{marker:02X} runs past the end of the data")
            if length < 2:
                self._fail(f"JPEG segment 0xFF{marker:02X} of bad length {length}")
            body = data[pos + 2:pos + length]
            pos += length
            if marker in _FRAME_KINDS:
                kind = _FRAME_KINDS[marker]
                if kind is not None:
                    self._fail(f"unsupported JPEG: {kind} (SOF{marker - 0xC0}); the port decodes baseline, "
                               "extended sequential and progressive Huffman JPEGs")
                self.progressive = marker == 0xC2
                self._frame(body)
                frame_seen = True
            elif marker == DHT:
                self._dht(body)
            elif marker == DQT:
                self._dqt(body)
            elif marker == DRI:
                (self.restart,) = struct.unpack_from(">H", body, 0)
            elif marker == SOS:
                if not frame_seen:
                    self._fail("JPEG scan before its frame header")
                pos = self._scan(body, pos)
            elif marker == 0xE0 and body.startswith(b"JFIF\x00") and len(body) >= 14:
                self.jfif = True
            elif marker == APP14 and body.startswith(b"Adobe") and len(body) >= 12:
                self.adobe_transform = body[11]
            elif marker == 0xCC:
                self._fail("unsupported JPEG: arithmetic-coded (DAC segment)")
            # other APPn, COM, DNL...: skipped
        if not frame_seen:
            self._fail("JPEG without a frame header")
        if any(c.coef is None for c in self.components):
            self._fail("JPEG ended before every component was scanned")
        if self.progressive and self._smoothing_applies():
            self._fail("unsupported JPEG: a progressive file whose scans leave coefficient bits unsent, which "
                       "libjpeg decodes with block smoothing (not ported)")

    def _frame(self, body: bytes) -> None:
        precision, self.height, self.width, n = struct.unpack_from(">BHHB", body, 0)
        if precision != 8:
            self._fail(f"unsupported JPEG: {precision}-bit samples; the port decodes 8-bit JPEGs")
        if n == 4:
            self._fail("Unsupported image format: CMYK. Supported formats: RGB, RGBA, L (a 4-component JPEG: "
                       "CMYK or YCCK)")
        if n not in (1, 3):
            self._fail(f"unsupported JPEG: {n} components")
        if self.height == 0 or self.width == 0:
            self._fail("unsupported JPEG: zero height or width (DNL)")
        for i in range(n):
            cid, hv, tq = struct.unpack_from(">BBB", body, 6 + 3 * i)
            h, v = hv >> 4, hv & 15
            if not (1 <= h <= 4 and 1 <= v <= 4):
                self._fail(f"JPEG sampling factors {h}x{v}")
            self.components.append(_Component(cid, h, v, tq))
        self.hmax = max(c.h for c in self.components)
        self.vmax = max(c.v for c in self.components)
        for c in self.components:
            if self.hmax % c.h or self.vmax % c.v:
                self._fail(f"unsupported JPEG: non-integer sampling ratio {self.hmax}/{c.h} x {self.vmax}/{c.v}")
        self.mcus_x = -(-self.width // (8 * self.hmax))
        self.mcus_y = -(-self.height // (8 * self.vmax))
        for c in self.components:
            # The downsampled size, and the block grid padded to whole MCUs.
            c.width = -(-self.width * c.h // self.hmax)
            c.height = -(-self.height * c.v // self.vmax)
            c.bx, c.by = self.mcus_x * c.h, self.mcus_y * c.v

    def _dht(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            tc_th = body[pos]
            counts = body[pos + 1:pos + 17]
            n = sum(counts)
            symbols = body[pos + 17:pos + 17 + n]
            if len(counts) != 16 or len(symbols) != n:
                self._fail("truncated JPEG DHT segment")
            self.huff[(tc_th >> 4, tc_th & 15)] = _Huffman(counts, symbols)
            pos += 17 + n

    def _dqt(self, body: bytes) -> None:
        pos = 0
        while pos < len(body):
            pq, tq = body[pos] >> 4, body[pos] & 15
            if pq:
                values = np.array(struct.unpack_from(">64H", body, pos + 1), np.int64)
                pos += 129
            else:
                values = np.frombuffer(body, np.uint8, 64, pos + 1).astype(np.int64)
                pos += 65
            natural = np.empty(64, np.int64)
            natural[ZIGZAG] = values
            self.quant[tq] = natural

    def _table(self, cls: int, slot: int) -> _Huffman:
        if (cls, slot) not in self.huff:
            if (cls, slot) not in STANDARD_TABLES:
                self._fail(f"JPEG scan uses undefined Huffman table {('DC', 'AC')[cls]} {slot}")
            self.huff[(cls, slot)] = _Huffman(*STANDARD_TABLES[(cls, slot)])
        return self.huff[(cls, slot)]

    def _scan(self, body: bytes, pos: int) -> int:
        n = body[0]
        by_id = {c.id: c for c in self.components}
        comps, slots = [], []
        for i in range(n):
            cid, tdta = body[1 + 2 * i], body[2 + 2 * i]
            if cid not in by_id:
                self._fail(f"JPEG scan names unknown component {cid}")
            comps.append(by_id[cid])
            slots.append((tdta >> 4, tdta & 15))
        ss, se, ah, al = body[1 + 2 * n], body[2 + 2 * n], body[3 + 2 * n] >> 4, body[3 + 2 * n] & 15
        if not self.progressive and (ss != 0 or se != 63 or ah or al):
            self._fail("unsupported JPEG: a sequential scan with spectral selection or successive approximation")
        if self.progressive and (ss > se or se > 63 or (ss == 0) != (se == 0) or (ss and n != 1) or al > 13):
            self._fail(f"corrupt progressive JPEG: a scan with Ss={ss}, Se={se}, Ah={ah}, Al={al} over {n} components")
        for c in comps:
            if c.quant is None:  # latched at the component's first scan, as libjpeg does
                if c.tq not in self.quant:
                    self._fail(f"JPEG component {c.id} uses undefined quantization table {c.tq}")
                c.quant = self.quant[c.tq]
            if c.coef is None:
                c.coef = np.zeros((c.by * c.bx, 64), np.int32) if self.progressive else [0] * (c.by * c.bx * 64)
            c.coef_bits[ss:se + 1] = al
        # The entropy-coded data runs to the first marker that is not RSTn.
        end = _END_OF_SCAN.search(self.data, pos)
        stop = end.start() if end else len(self.data)
        segments = [seg.replace(b"\xff\x00", b"\xff") for seg in _RST.split(self.data[pos:stop])]
        if n == 1:  # non-interleaved: the component's own blocks, in raster order
            c = comps[0]
            plan = [(0, 1, 1, 0, 0)]
            cols, rows = -(-c.width // 8), -(-c.height // 8)
        else:  # interleaved: each MCU holds h x v blocks of each component
            plan = [(i, c.v, c.h, v, h) for i, c in enumerate(comps) for v in range(c.v) for h in range(c.h)]
            cols, rows = self.mcus_x, self.mcus_y
        total = cols * rows
        interval = self.restart or total
        if self.progressive:
            self._progressive_scan(segments, comps, slots, plan, cols, total, interval, ss, se, ah, al)
            return stop
        tables = [(self._table(0, dc).lut, self._table(1, ac).lut) for dc, ac in slots]
        mcu = 0
        for segment in segments:
            if mcu >= total:
                break
            count = min(interval, total - mcu)
            self._decode_segment(segment, comps, tables, plan, cols, mcu, count)
            mcu += count
        return stop

    # ---- progressive scans (libjpeg's jdphuff.c) ----

    def _progressive_scan(self, segments, comps, slots, plan, cols: int, total: int, interval: int,
                          ss: int, se: int, ah: int, al: int) -> None:
        """One scan of a progressive frame into the components' coefficient
        arrays ((blocks, 64) int32 in zigzag order): the blocks in the
        scan's order (each MCU's plan for an interleaved DC scan, else the
        component's ceil(w / 8) x ceil(h / 8) blocks in raster order), the
        restart intervals each with its own predictors and EOB run."""
        m = np.arange(total)
        my, mx = m // cols, m % cols
        order_ci = np.array([ci for ci, *_ in plan] * total, np.int64)
        order_b = np.stack([(my * rv + dv) * comps[ci].bx + mx * rh + dh for ci, rv, rh, dv, dh in plan],
                           axis=1).reshape(-1)
        per = len(plan) * interval  # blocks a restart interval
        spans = [(seg, j, min(per, len(order_b) - j)) for seg, j in zip(segments, range(0, len(order_b), per))]
        if ss == 0 and ah:  # DC refinement: one bit a block
            for seg, j, count in spans:
                bits = np.unpackbits(np.frombuffer(seg + bytes(-(-count // 8)), np.uint8))[:count].astype(np.int32)
                for ci, c in enumerate(comps):
                    sel = order_ci[j:j + count] == ci
                    c.coef[order_b[j:j + count][sel], 0] |= bits[sel] << al
            return
        if ss == 0:
            luts = [self._table(0, dc).lut for dc, _ in slots]
            for seg, j, count in spans:
                values = self._dc_first(seg, luts, order_ci[j:j + count].tolist(), len(comps), al)
                for ci, c in enumerate(comps):
                    sel = order_ci[j:j + count] == ci
                    c.coef[order_b[j:j + count][sel], 0] = np.asarray(values, np.int64)[sel]
            return
        lut = self._table(1, slots[0][1]).lut
        coef = comps[0].coef
        if not ah:
            for seg, j, count in spans:
                idx, vals = self._ac_first(seg, lut, (order_b[j:j + count] * 64).tolist(), ss, se, al)
                coef.reshape(-1)[idx] = vals
            return
        self._ac_refine(spans, lut, coef, order_b, ss, se, al)

    def _dc_first(self, seg: bytes, luts, order_ci: list, ncomp: int, al: int) -> list:
        """A DC first scan's restart interval: each block's DC difference
        added to its component's predictor, the sum shifted left by Al."""
        win, limit = _windows(seg), 8 * len(seg) + 64
        p, preds, out = 0, [0] * ncomp, []
        for ci in order_ci:
            w, o = win[p >> 3], p & 7
            e = luts[ci][(w >> (24 - o)) & 0xFFFF]
            if not e:
                raise ValueError("JPEG: corrupt data (no Huffman code matches)")
            length, s = e >> 8, e & 0xFF
            diff = 0
            if s:
                diff = (w >> (40 - o - length - s)) & ((1 << s) - 1)
                if diff < (1 << (s - 1)):
                    diff -= (1 << s) - 1
            p += length + s
            preds[ci] += diff
            out.append(preds[ci] << al)
        if p > limit:
            raise ValueError("JPEG: truncated or corrupt data (the scan ran past its end)")
        return out

    def _ac_first(self, seg: bytes, lut, bases: list, ss: int, se: int, al: int) -> tuple:
        """An AC first scan's restart interval over one component: each
        block's band Ss..Se as run/size symbols, each value shifted left by
        Al; EOBn ends this block and the next 2^n - 1 + (n bits) ones.
        Returns the flat coefficient indices and their values."""
        win, limit = _windows(seg), 8 * len(seg) + 64
        p, m, idx, vals = 0, 0, [], []
        while m < len(bases):
            base, k = bases[m], ss
            m += 1
            while k <= se:
                w, o = win[p >> 3], p & 7
                e = lut[(w >> (24 - o)) & 0xFFFF]
                if not e:
                    raise ValueError("JPEG: corrupt data (no Huffman code matches)")
                length, rs = e >> 8, e & 0xFF
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    val = (w >> (40 - o - length - s)) & ((1 << s) - 1)
                    if val < (1 << (s - 1)):
                        val -= (1 << s) - 1
                    if k > se:
                        raise ValueError("JPEG: corrupt data (a coefficient past the scan's band)")
                    idx.append(base + k)
                    vals.append(val << al)
                    k += 1
                    p += length + s
                elif r == 15:
                    k += 16
                    p += length
                else:
                    run = 1 << r
                    if r:
                        run += (w >> (40 - o - length - r)) & ((1 << r) - 1)
                    p += length + r
                    m += run - 1  # the blocks the EOB run covers hold nothing in this band
                    break
            if p > limit:
                raise ValueError("JPEG: truncated or corrupt data (the scan ran past its end)")
        return idx, vals

    def _ac_refine(self, spans, lut, coef: np.ndarray, order_b: np.ndarray, ss: int, se: int, al: int) -> None:
        """AC refinement scans over one component (`decode_mcu_AC_refine`).
        Every coefficient of the band that was non-zero before the scan gets
        exactly one correction bit, in block and zigzag order; new
        coefficients (+-2^Al) land on the (r + 1)-th zero at or after the
        current position. So the loop below walks the symbols only: a
        block's non-zero set is a 64-bit mask, the zeros a symbol skips are
        found by dropping set bits, and the correction bits it passes are
        only counted (their stream positions kept as runs); an EOB run's
        blocks are skipped whole, their bits counted from prefix sums. The
        bits are read and applied afterwards in array code."""
        band = np.zeros(64, bool)
        band[ss:se + 1] = True
        nzb = (coef[order_b] != 0) & band
        masks = (nzb.astype(np.uint64) << np.arange(64, dtype=np.uint64)).sum(axis=1, dtype=np.uint64).tolist()
        prefix = np.concatenate([[0], np.cumsum(nzb.sum(axis=1))]).tolist()
        bases = (order_b * 64).tolist()
        band_mask = ((1 << (se + 1)) - 1) ^ ((1 << ss) - 1)
        p1 = 1 << al
        starts, lengths, new_idx, new_val, chunks = [], [], [], [], []
        gp, m = 0, 0
        for seg, j, count in spans:
            win, limit = _windows(seg), 8 * len(seg) + 64
            chunks.append(np.unpackbits(np.frombuffer(seg + bytes(PAD_BYTES), np.uint8)))
            p, eobrun, m, end = 0, 0, j, j + count
            while m < end:
                if eobrun:
                    take = min(eobrun, end - m)
                    nbits = prefix[m + take] - prefix[m]
                    if nbits:
                        starts.append(gp + p)
                        lengths.append(nbits)
                        p += nbits
                    eobrun -= take
                    m += take
                    if p > limit:
                        raise ValueError("JPEG: truncated or corrupt data (the scan ran past its end)")
                    continue
                nz, base, k = masks[m], bases[m], ss
                while k <= se:
                    w, o = win[p >> 3], p & 7
                    e = lut[(w >> (24 - o)) & 0xFFFF]
                    if not e:
                        raise ValueError("JPEG: corrupt data (no Huffman code matches)")
                    length, rs = e >> 8, e & 0xFF
                    r, s = rs >> 4, rs & 15
                    if s:
                        val = p1 if (w >> (39 - o - length)) & 1 else -p1
                        p += length + 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (w >> (40 - o - length - r)) & ((1 << r) - 1)
                        p += length + r
                        break
                    else:
                        p += length
                    zeros = ~nz & band_mask & -(1 << k)
                    for _ in range(r):
                        zeros &= zeros - 1
                    if zeros:
                        target = (zeros & -zeros).bit_length() - 1
                    elif s:
                        raise ValueError("JPEG: corrupt data (a coefficient past the scan's band)")
                    else:
                        target = se + 1
                    nbits = (nz & ((1 << target) - (1 << k))).bit_count()
                    if nbits:
                        starts.append(gp + p)
                        lengths.append(nbits)
                        p += nbits
                    if s:
                        new_idx.append(base + target)
                        new_val.append(val)
                    k = target + 1
                if eobrun:  # the rest of this block's band: correction bits only
                    nbits = (nz & -(1 << k)).bit_count()
                    if nbits:
                        starts.append(gp + p)
                        lengths.append(nbits)
                        p += nbits
                    eobrun -= 1
                m += 1
                if p > limit:
                    raise ValueError("JPEG: truncated or corrupt data (the scan ran past its end)")
            gp += chunks[-1].size
        if starts:
            lengths_a = np.asarray(lengths)
            offsets = np.repeat(np.asarray(starts) - np.concatenate([[0], np.cumsum(lengths_a)[:-1]]), lengths_a)
            bits = np.concatenate(chunks)[offsets + np.arange(offsets.size)]
            rows, ks = np.nonzero(nzb)
            blocks, ks = order_b[rows[:bits.size]], ks[:bits.size]
            current = coef[blocks, ks]
            fix = (bits == 1) & ((current & p1) == 0)
            coef[blocks[fix], ks[fix]] += np.where(current[fix] >= 0, p1, -p1).astype(np.int32)
        coef.reshape(-1)[new_idx] = new_val

    def _smoothing_applies(self) -> bool:
        """libjpeg-turbo's `smoothing_ok` (jdcoefct.c, SAVED_COEFS 10) over
        the final coefficient bits: block smoothing runs when every
        component's DC is known and some component's first nine AC
        coefficients (zigzag 1-9) are not fully refined."""
        useful = False
        for c in self.components:
            if c.quant is None or not all(c.quant[pos] for pos in (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)):
                return False
            if c.coef_bits[0] < 0:
                return False
            useful = useful or bool((c.coef_bits[1:10] != 0).any())
        return useful

    def _decode_segment(self, segment: bytes, comps, tables, plan, cols: int, first: int, count: int) -> None:
        win = _windows(segment)
        limit = 8 * len(segment) + 64  # zeros past the end, as libjpeg pads
        p = 0
        preds = [0] * len(comps)
        coefs = [c.coef for c in comps]
        strides = [c.bx for c in comps]
        for m in range(first, first + count):
            my, mx = divmod(m, cols)
            for ci, rv, rh, dv, dh in plan:
                base = ((my * rv + dv) * strides[ci] + mx * rh + dh) * 64
                coef = coefs[ci]
                dc_lut, ac_lut = tables[ci]
                # DC: a category, then that many bits of the difference.
                w = win[p >> 3]
                o = p & 7
                e = dc_lut[(w >> (24 - o)) & 0xFFFF]
                if not e:
                    raise ValueError("JPEG: corrupt data (no Huffman code matches)")
                length, s = e >> 8, e & 0xFF
                diff = 0
                if s:
                    diff = (w >> (40 - o - length - s)) & ((1 << s) - 1)  # length + s + o <= 38
                    if diff < (1 << (s - 1)):
                        diff -= (1 << s) - 1
                p += length + s
                preds[ci] += diff
                coef[base] = preds[ci]
                k = 1
                while k < 64:
                    w = win[p >> 3]
                    o = p & 7
                    e = ac_lut[(w >> (24 - o)) & 0xFFFF]
                    if not e:
                        raise ValueError("JPEG: corrupt data (no Huffman code matches)")
                    length, rs = e >> 8, e & 0xFF
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        val = (w >> (40 - o - length - s)) & ((1 << s) - 1)
                        if val < (1 << (s - 1)):
                            val -= (1 << s) - 1
                        if k < 64:
                            coef[base + k] = val
                        k += 1
                        p += length + s
                    else:
                        p += length
                        if r != 15:
                            break  # EOB
                        k += 16
                if p > limit:
                    raise ValueError("JPEG: truncated or corrupt data (the scan ran past its end)")

    def planes(self) -> List[np.ndarray]:
        """Each component's samples, uint8 (by * 8, bx * 8): dequantized,
        islow IDCT, range-limited."""
        out = []
        for c in self.components:
            zz = np.asarray(c.coef, np.int64).reshape(-1, 64)
            natural = np.empty_like(zz)
            natural[:, ZIGZAG] = zz
            blocks = _idct_islow(natural * c.quant)
            out.append(blocks.reshape(c.by, c.bx, 8, 8).transpose(0, 2, 1, 3).reshape(c.by * 8, c.bx * 8))
        return out

    def rgb(self) -> np.ndarray:
        planes = self.planes()
        if len(self.components) == 1:
            y = planes[0][:self.height, :self.width]
            return np.repeat(y[..., None], 3, axis=2)
        full = [self._upsample(plane, c) for plane, c in zip(planes, self.components)]
        if self.color_space() == "RGB":
            return np.stack(full, axis=-1).astype(np.uint8)
        y, cb, cr = (f.astype(np.int64) for f in full)
        r = np.clip(y + CR_R[cr], 0, 255)
        g = np.clip(y + ((CB_G[cb] + CR_G[cr]) >> 16), 0, 255)
        b = np.clip(y + CB_B[cb], 0, 255)
        return np.stack([r, g, b], axis=-1).astype(np.uint8)

    def color_space(self) -> str:
        """libjpeg's guess (jdapimin.c `default_decompress_parms`) for three
        components: a JFIF marker means YCbCr; else an Adobe marker's
        transform (0 RGB, any other YCbCr); else component ids R, G, B mean
        RGB; else YCbCr."""
        if len(self.components) == 1:
            return "L"
        if self.jfif:
            return "YCbCr"
        if self.adobe_transform is not None:
            return "RGB" if self.adobe_transform == 0 else "YCbCr"
        return "RGB" if tuple(c.id for c in self.components) == (82, 71, 66) else "YCbCr"

    def _upsample(self, plane: np.ndarray, c: _Component) -> np.ndarray:
        """A component plane at the image's size, as jdsample.c upsamples it."""
        x = plane[:c.height, :c.width].astype(np.int32)
        fh, fv = self.hmax // c.h, self.vmax // c.v
        fancy_h2 = fh == 2 and c.width > 2
        if (fh, fv) == (1, 1):
            pass
        elif (fh, fv) == (2, 1) and fancy_h2:
            x = _h2v1_fancy(x)
        elif (fh, fv) == (1, 2):
            x = _h1v2_fancy(x)
        elif (fh, fv) == (2, 2) and fancy_h2:
            x = _h2v2_fancy(x)
        else:
            x = np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)
        return x[:self.height, :self.width]


_END_OF_SCAN = re.compile(rb"\xff(?![\x00\xd0-\xd7])")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


def _idct_islow(c: np.ndarray) -> np.ndarray:
    """jidctint.c's jpeg_idct_islow on (N, 64) dequantized coefficients in
    natural order -> (N, 8, 8) uint8 samples."""
    x = c.reshape(-1, 8, 8).astype(np.int64)

    def one_pass(rows, shift, fold_in=None):
        # rows[i] is input index i along the transformed axis.
        z2, z3 = rows[2], rows[6]
        z1 = (z2 + z3) * FIX_0_541196100
        tmp2 = z1 + z3 * -FIX_1_847759065
        tmp3 = z1 + z2 * FIX_0_765366865
        z2, z3 = rows[0], rows[4]
        tmp0 = (z2 + z3) << CONST_BITS
        tmp1 = (z2 - z3) << CONST_BITS
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        tmp0, tmp1, tmp2, tmp3 = rows[7], rows[5], rows[3], rows[1]
        z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
        z5 = (z3 + z4) * FIX_1_175875602
        tmp0 = tmp0 * FIX_0_298631336
        tmp1 = tmp1 * FIX_2_053119869
        tmp2 = tmp2 * FIX_3_072711026
        tmp3 = tmp3 * FIX_1_501321110
        z1 = z1 * -FIX_0_899976223
        z2 = z2 * -FIX_2_562915447
        z3 = z3 * -FIX_1_961570560 + z5
        z4 = z4 * -FIX_0_390180644 + z5
        tmp0 += z1 + z3
        tmp1 += z2 + z4
        tmp2 += z2 + z3
        tmp3 += z1 + z4
        half = 1 << (shift - 1)
        return [(tmp10 + tmp3 + half) >> shift, (tmp11 + tmp2 + half) >> shift, (tmp12 + tmp1 + half) >> shift,
                (tmp13 + tmp0 + half) >> shift, (tmp13 - tmp0 + half) >> shift, (tmp12 - tmp1 + half) >> shift,
                (tmp11 - tmp2 + half) >> shift, (tmp10 - tmp3 + half) >> shift]

    # Pass 1: columns (x[:, row, col], transform along rows) into the workspace.
    ws = np.stack(one_pass([x[:, i, :] for i in range(8)], CONST_BITS - PASS1_BITS), axis=1)
    # Pass 2: rows, descaled by CONST_BITS + PASS1_BITS + 3, range-limited.
    out = np.stack(one_pass([ws[:, :, i] for i in range(8)], CONST_BITS + PASS1_BITS + 3), axis=2)
    return RANGE_LIMIT[out & 1023]


def _h2v1_fancy(x: np.ndarray) -> np.ndarray:
    """h2v1_fancy_upsample: out[2i] = (3 x[i] + x[i-1] + 1) >> 2, out[2i+1]
    = (3 x[i] + x[i+1] + 2) >> 2, the edge samples repeated."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _h1v2_fancy(x: np.ndarray) -> np.ndarray:
    """h1v2_fancy_upsample: each row against the row above (bias 1) and
    below (bias 2), the edge rows repeated."""
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2] = (3 * x + above + 1) >> 2
    out[1::2] = (3 * x + below + 2) >> 2
    return out


def _h2v2_fancy(x: np.ndarray) -> np.ndarray:
    """h2v2_fancy_upsample: column sums 3 x[row] + x[row -+ 1], then
    out[2i] = (3 s[i] + s[i-1] + 8) >> 4, out[2i+1] = (3 s[i] + s[i+1] + 7)
    >> 4, the edge rows and columns repeated."""
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for v, near in ((0, above), (1, below)):
        s = 3 * x + near
        left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
        right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * s + left + 8) >> 4
        out[v::2, 1::2] = (3 * s + right + 7) >> 4
    return out


def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """A JPEG's bytes (baseline, extended or progressive) -> uint8 (H, W, 3)
    RGB, as PIL's `Image.open(...).convert("RGB")` gives it."""
    return JPEGFrame(data, name).rgb()


# ---- encoding ----------------------------------------------------------------

# ITU T.81 Annex K.1's quantization tables in natural order (jcparam.c's
# std_luminance_quant_tbl and std_chrominance_quant_tbl).
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)


def quant_tables(quality: int) -> np.ndarray:
    """jpeg_set_quality(quality, force_baseline=TRUE): the Annex K tables
    scaled by jpeg_quality_scaling, rounded, clamped to [1, 255]; (2, 64)
    in natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    tables = (np.stack([STD_LUMA_QUANT, STD_CHROMA_QUANT]) * scale + 50) // 100
    return np.clip(tables, 1, 255)


def _fix16(v: float) -> int:
    return int(v * (1 << 16) + 0.5)


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) RGB -> int32 (3, H, W) Y, Cb, Cr as jccolor.c's
    rgb_ycc_convert computes them: its rgb_ycc_tab entries are FIX(c) x
    sample (SCALEBITS 16) plus ONE_HALF, or CBCR_OFFSET + ONE_HALF - 1 for
    the 0.5 terms (the B=>Cb table doubles as R=>Cr)."""
    r, g, b = (rgb[..., c].astype(np.int32) for c in range(3))
    half, chroma = 1 << 15, (128 << 16) + (1 << 15) - 1
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b + half) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.50000) * b + chroma) >> 16
    cr = (_fix16(0.50000) * r - _fix16(0.41869) * g - _fix16(0.08131) * b + chroma) >> 16
    return np.stack([y, cb, cr])


def _h2v2_downsample(plane: np.ndarray) -> np.ndarray:
    """jcsample.c's h2v2_downsample over an even-sized plane: each 2x2 sum
    plus a bias of 1, 2, 1, 2, ... along the row, shifted right by 2."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return (s + bias) >> 2


def _fdct_pass(rows, first: bool):
    """One pass of jfdctint.c's jpeg_fdct_islow over rows[0..7] (the eight
    samples along the transformed axis): outputs 0 and 4 shifted left by
    PASS1_BITS in the first pass and descaled by it in the second, the rest
    descaled by CONST_BITS -+ PASS1_BITS."""
    shift = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    tmp0, tmp7 = rows[0] + rows[7], rows[0] - rows[7]
    tmp1, tmp6 = rows[1] + rows[6], rows[1] - rows[6]
    tmp2, tmp5 = rows[2] + rows[5], rows[2] - rows[5]
    tmp3, tmp4 = rows[3] + rows[4], rows[3] - rows[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    half = 1 << (shift - 1)
    if first:
        out0, out4 = (tmp10 + tmp11) << PASS1_BITS, (tmp10 - tmp11) << PASS1_BITS
    else:
        dc_half = 1 << (PASS1_BITS - 1)
        out0, out4 = (tmp10 + tmp11 + dc_half) >> PASS1_BITS, (tmp10 - tmp11 + dc_half) >> PASS1_BITS
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out2 = (z1 + tmp13 * FIX_0_765366865 + half) >> shift
    out6 = (z1 - tmp12 * FIX_1_847759065 + half) >> shift
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    return [out0, (tmp7 + z1 + z4 + half) >> shift, out2, (tmp6 + z2 + z3 + half) >> shift,
            out4, (tmp5 + z2 + z4 + half) >> shift, out6, (tmp4 + z1 + z3 + half) >> shift]


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jpeg_fdct_islow on int32 (N, 8, 8) samples less 128 -> (N, 64)
    coefficients in natural order, scaled up by 8: the rows, then the
    columns (every intermediate stays under 2^31)."""
    ws = np.stack(_fdct_pass([blocks[:, :, i] for i in range(8)], True), axis=2)
    out = np.stack(_fdct_pass([ws[:, i, :] for i in range(8)], False), axis=1)
    return out.reshape(-1, 64)


def _reciprocals(divisors: np.ndarray):
    """jcdctmgr.c's compute_reciprocal for 16-bit DCTELEMs: (reciprocal,
    correction, total shift) per divisor, so that q = ((|x| + c) * r) >>
    shift with the sign restored."""
    recip, corr, shift = [], [], []
    for d in divisors.tolist():
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:  # a power of two
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip, np.int64), np.array(corr, np.int64), np.array(shift, np.int64)


def _quantize(coef: np.ndarray, qtables: np.ndarray, which: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantize: (N, 64) islow coefficients divided by 8 x
    the table `which` picks for each block (of `qtables`, (T, 64) in the
    coefficients' order) through the reciprocals, rounded half away from
    zero. |x| + c and the reciprocal are both under 2^16, so their product
    fits in uint32."""
    recip, corr, shift = (np.stack(v).astype(np.uint32) for v in zip(*(_reciprocals(t << 3) for t in qtables)))
    mag = ((np.abs(coef).astype(np.uint32) + corr[which]) * recip[which]) >> shift[which]
    mag = mag.astype(np.int32)
    return np.where(coef < 0, -mag, mag)


def _code_table(counts, symbols: bytes):
    """jpeg_make_c_derived_tbl: (code, length) per symbol, 0-length for
    symbols the table lacks."""
    code_of, len_of = np.zeros(256, np.uint64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_DC_CODES = [_code_table(*STANDARD_TABLES[(0, slot)]) for slot in (0, 1)]
_AC_CODES = [_code_table(*STANDARD_TABLES[(1, slot)]) for slot in (0, 1)]


# The number of bits of each value in [0, 65535] (0 for 0): a code's category.
_BIT_LENGTH = np.array([0] + [int(v).bit_length() for v in range(1, 1 << 16)], np.int64)


def _zrl_prefixes(ac_codes):
    """The value and length of 0-3 ZRL codes in a row, for one AC table."""
    code, length = int(ac_codes[0][0xF0]), int(ac_codes[1][0xF0])
    values = [0, code, (code << length) | code, (((code << length) | code) << length) | code]
    return np.array(values, np.uint64), np.arange(4, dtype=np.int64) * length


_ZRL = [_zrl_prefixes(codes) for codes in _AC_CODES]


def _extra_bits(v: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """The `nbits` low bits that follow a Huffman code: v, or v - 1 when
    negative (the one's complement of |v|)."""
    return (np.where(v < 0, v - 1, v) & ((np.int64(1) << nbits) - 1)).astype(np.uint64)


# Both tables of a class side by side, indexed by table * 256 + symbol.
_DC_CODE = np.concatenate([_DC_CODES[0][0], _DC_CODES[1][0]])
_DC_LEN = np.concatenate([_DC_CODES[0][1], _DC_CODES[1][1]])
_AC_CODE = np.concatenate([_AC_CODES[0][0], _AC_CODES[1][0]])
_AC_LEN = np.concatenate([_AC_CODES[0][1], _AC_CODES[1][1]])
_ZRL_CODE = np.concatenate([_ZRL[0][0], _ZRL[1][0]])  # indexed by table * 4 + ZRL count
_ZRL_LEN = np.concatenate([_ZRL[0][1], _ZRL[1][1]])


def _entropy_events(zz: np.ndarray, comp: np.ndarray):
    """encode_one_block (jchuff.c) over quantized blocks in zigzag order,
    in scan order, with each block's component (0 Y, 1 Cb, 2 Cr): the value
    and bit count of every DC, AC and EOB code with its extra bits, in the
    order they are written. Runs of 16 zeros (ZRL codes) before an AC code
    are folded into its value (at most 3 x 11 + 16 + 10 bits)."""
    n = zz.shape[0]
    table = (comp > 0).astype(np.int64)
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for c in range(3):
        idx = np.flatnonzero(comp == c)
        diff[idx] = dc[idx] - np.concatenate([[0], dc[idx][:-1]])
    nbits = _BIT_LENGTH[np.abs(diff)]
    dc_sym = table * 256 + nbits
    dc_val = (_DC_CODE[dc_sym] << nbits.astype(np.uint64)) | _extra_bits(diff, nbits)
    dc_len = _DC_LEN[dc_sym] + nbits

    bi, ki = np.nonzero(zz[:, 1:])
    k = ki + 1
    prev = np.empty_like(k)
    prev[0:1] = 0
    prev[1:] = np.where(bi[1:] == bi[:-1], k[:-1], 0)
    run = k - prev - 1
    v = zz[bi, k]
    vbits = _BIT_LENGTH[np.abs(v)]
    t = table[bi]
    sym = t * 256 + (((run & 15) << 4) | vbits)
    zrl = t * 4 + (run >> 4)
    clen = _AC_LEN[sym]
    ac_val = (((_ZRL_CODE[zrl] << clen.astype(np.uint64)) | _AC_CODE[sym]) << vbits.astype(np.uint64)) \
        | _extra_bits(v, vbits)
    ac_len = _ZRL_LEN[zrl] + clen + vbits

    last = np.zeros(n, np.int64)
    last[bi] = k  # k rises within a block: the last write is its last nonzero
    eob_blocks = np.flatnonzero(last < 63)
    eob_sym = table[eob_blocks] * 256
    key = np.concatenate([np.arange(n) * 65, bi * 65 + k, eob_blocks * 65 + 64])
    order = np.argsort(key)
    values = np.concatenate([dc_val, ac_val, _AC_CODE[eob_sym]])[order]
    lengths = np.concatenate([dc_len, ac_len, _AC_LEN[eob_sym]])[order]
    return values, lengths


def pack_bits(values: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Codes of 1 to 64 bits (uint64 values, most significant bit first)
    written back to back -> uint8 bytes, the last byte padded with 1-bits
    (jchuff.c's flush_bits). Each code lands in one 64-bit word or
    straddles two; a word's codes do not overlap, so their sum is their OR."""
    total = int(lengths.sum())
    end = np.cumsum(lengths)
    start = end - lengths
    word, off = start >> 6, start & 63
    spill = off + lengths - 64  # > 0: the bits that run into the next word
    head = np.where(spill > 0, values >> np.clip(spill, 0, 63).astype(np.uint64),
                    values << np.clip(-spill, 0, 63).astype(np.uint64))
    nwords = (total + 63) // 64 + 1
    words = np.zeros(nwords, np.uint64)
    firsts = np.flatnonzero(np.concatenate([[True], word[1:] != word[:-1]]))
    words[word[firsts]] = np.add.reduceat(head, firsts)
    cross = np.flatnonzero(spill > 0)
    words[word[cross] + 1] += values[cross] << (64 - spill[cross]).astype(np.uint64)
    pad = (-total) % 8
    if pad:  # flush_bits: the last byte filled with 1-bits
        words[total >> 6] |= np.uint64((1 << pad) - 1) << np.uint64(64 - (total & 63) - pad)
    return np.frombuffer(words.astype(">u8").tobytes(), np.uint8)[:(total + pad) // 8]


def _stuff(data: np.ndarray) -> bytes:
    """0xFF byte stuffing: a 0x00 after every 0xFF of entropy-coded data."""
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes() if ff.size else data.tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _pad_edge(plane: np.ndarray, height: int, width: int) -> np.ndarray:
    """A plane grown to (height, width) by repeating its last row and
    column (expand_right_edge, expand_bottom_edge)."""
    return np.pad(plane, ((0, height - plane.shape[0]), (0, width - plane.shape[1])), mode="edge")


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8 by, 8 bx) samples -> (by, bx, 8, 8) int32 blocks less
    CENTERJSAMPLE."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3).astype(np.int32) - 128


def encode_jpeg(rgb_u8: np.ndarray, quality: int = 92) -> bytes:
    """uint8 (H, W, 3) RGB -> the baseline JPEG that PIL's
    `Image.fromarray(rgb).save(buf, "JPEG", quality=quality)` writes through
    libjpeg-turbo, byte for byte: JFIF 1.01, the Annex K tables at
    `quality` (baseline), 4:2:0, the standard Huffman tables, one
    interleaved scan."""
    rgb = np.ascontiguousarray(rgb_u8, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 (H, W, 3), got {rgb.shape}")
    h, w = rgb.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a JPEG frame is 1 to 65535 pixels a side, got {w}x{h}")
    qt = quant_tables(quality)
    mcux, mcuy = -(-w // 16), -(-h // 16)
    bw, bh = -(-w // 8), -(-h // 8)
    ycc = rgb_to_ycc(rgb)
    # Luma edge-padded to whole MCUs; chroma with its rows paired (the last
    # repeated when the height is odd) and its columns repeated out to whole
    # MCUs, downsampled 2x2, then its last row repeated down to whole
    # blocks (jcprepct.c, jcsample.c).
    luma = _blocks(_pad_edge(ycc[0], 16 * mcuy, 16 * mcux))
    luma = luma.reshape(mcuy, 2, mcux, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5).reshape(mcuy, mcux, 4, 8, 8)
    chroma = [_blocks(_pad_edge(_h2v2_downsample(_pad_edge(plane, 2 * (-(-h // 2)), 16 * mcux)), 8 * mcuy,
                                8 * mcux)).reshape(mcuy, mcux, 1, 8, 8) for plane in ycc[1:]]
    # Scan order: per MCU, Y00 Y01 Y10 Y11 Cb Cr.
    scan = np.concatenate([luma] + chroma, axis=2).reshape(-1, 8, 8)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mcuy * mcux)
    zz = _quantize(_fdct_islow(scan)[:, ZIGZAG], qt[:, ZIGZAG], (comp > 0).astype(np.int64))
    # The MCUs' luma blocks past the image's blocks (jccoefct.c's dummy
    # blocks) are zero but for a DC copied from the block before them: the
    # one to the left, or for a bottom row the MCU's upper right block.
    if bw % 2 or bh % 2:
        y = zz.reshape(mcuy, mcux, 6, 64)
        if bw % 2:
            y[:, -1, 1] = 0
            y[:, -1, 3] = 0
            y[:, -1, 1, 0] = y[:, -1, 0, 0]
            y[:, -1, 3, 0] = y[:, -1, 2, 0]
        if bh % 2:
            y[-1, :, 2:4] = 0
            y[-1, :, 2, 0] = y[-1, :, 1, 0]
            y[-1, :, 3, 0] = y[-1, :, 1, 0]
    values, lengths = _entropy_events(zz, comp)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in (0, 1):
        out.append(_segment(0xDB, bytes([t]) + qt[t][ZIGZAG].astype(np.uint8).tobytes()))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls, slot in ((0, 0), (1, 0), (0, 1), (1, 1)):
        counts, symbols = STANDARD_TABLES[(cls, slot)]
        out.append(_segment(0xC4, bytes([(cls << 4) | slot]) + bytes(counts) + symbols))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(_stuff(pack_bits(values, lengths)))
    out.append(b"\xff\xd9")
    return b"".join(out)


def encode_jpegs(frames, quality: int = 92) -> List[bytes]:
    """`encode_jpeg` of each (H, W, 3) uint8 frame, on a pool of threads
    (numpy releases the GIL in its array operations)."""
    from concurrent.futures import ThreadPoolExecutor

    frames = list(frames)
    workers = min(len(frames), os.cpu_count() or 1, 8)
    if workers <= 1:
        return [encode_jpeg(f, quality) for f in frames]
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(lambda f: encode_jpeg(f, quality), frames))
