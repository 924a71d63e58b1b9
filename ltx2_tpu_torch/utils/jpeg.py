"""Baseline JPEG decoding without PIL (the counterpart of what the JAX
package gets from `Image.open(...).convert("RGB")` on a JPEG: libjpeg-turbo's
decode at PIL's defaults).

What it decodes: SOF0 and SOF1 frames, 8-bit, Huffman-coded, with one or
three components, in interleaved or single-component scans; any integer
sampling (4:4:4, 4:2:2, 4:2:0 and 4:4:0 through libjpeg's fancy upsamplers,
other integer ratios by replication as libjpeg's `int_upsample`); DRI
restart intervals with RST0-7; APPn and COM are skipped; frames without DHT
segments (as many MJPEG streams are) take the standard tables of ITU T.81
Annex K.3, as libjpeg-turbo's `jinit_huff_decoder` does. Progressive,
lossless, hierarchical, arithmetic-coded and 12-bit files, CMYK and other
4-component files, and RGB-coded files (an Adobe transform of 0, or R, G, B
component ids without a JFIF marker) raise a ValueError naming what they
are.

The steps reproduce libjpeg-turbo's, so the output equals PIL's bit for bit:
- entropy decoding, sequential by nature: each restart interval's bytes
  unstuffed, read through 40-bit windows at every byte offset, each
  Huffman code found by one lookup of the next 16 bits in a 65536-entry
  table (code length, symbol);
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
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

EOI, SOS, DHT, DQT, DRI, APP14 = 0xD9, 0xDA, 0xC4, 0xDB, 0xDD, 0xEE
_FRAME_KINDS = {
    0xC0: None, 0xC1: None,
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical (differential sequential)",
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
        self.coef: Optional[list] = None


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
                    self._fail(f"unsupported JPEG: {kind} (SOF{marker - 0xC0}); the port decodes baseline and "
                               "extended sequential Huffman JPEGs")
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
            elif marker == 0xE0 and body.startswith(b"JFIF\x00"):
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

    def _frame(self, body: bytes) -> None:
        precision, self.height, self.width, n = struct.unpack_from(">BHHB", body, 0)
        if precision != 8:
            self._fail(f"unsupported JPEG: {precision}-bit samples; the port decodes 8-bit JPEGs")
        if n == 4:
            self._fail("unsupported JPEG: CMYK / YCCK (4 components)")
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
        comps, tables = [], []
        for i in range(n):
            cid, tdta = body[1 + 2 * i], body[2 + 2 * i]
            if cid not in by_id:
                self._fail(f"JPEG scan names unknown component {cid}")
            comps.append(by_id[cid])
            tables.append((self._table(0, tdta >> 4).lut, self._table(1, tdta & 15).lut))
        ss, se, ahal = body[1 + 2 * n], body[2 + 2 * n], body[3 + 2 * n]
        if ss != 0 or se != 63 or ahal != 0:
            self._fail("unsupported JPEG: a scan with spectral selection or successive approximation")
        for c in comps:
            if c.tq not in self.quant:
                self._fail(f"JPEG component {c.id} uses undefined quantization table {c.tq}")
            c.quant = self.quant[c.tq]  # latched at the component's scan, as libjpeg does
            if c.coef is None:
                c.coef = [0] * (c.by * c.bx * 64)
        # The entropy-coded data runs to the first marker that is not RSTn.
        end = _END_OF_SCAN.search(self.data, pos)
        stop = end.start() if end else len(self.data)
        segments = _RST.split(self.data[pos:stop])
        if n == 1:  # non-interleaved: the component's own blocks, in raster order
            c = comps[0]
            plan = [(0, 1, 1, 0, 0)]
            cols, rows = -(-c.width // 8), -(-c.height // 8)
        else:  # interleaved: each MCU holds h x v blocks of each component
            plan = [(i, c.v, c.h, v, h) for i, c in enumerate(comps) for v in range(c.v) for h in range(c.h)]
            cols, rows = self.mcus_x, self.mcus_y
        total = cols * rows
        interval = self.restart or total
        mcu = 0
        for segment in segments:
            if mcu >= total:
                break
            count = min(interval, total - mcu)
            self._decode_segment(segment.replace(b"\xff\x00", b"\xff"), comps, tables, plan, cols, mcu, count)
            mcu += count
        return stop

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
        if not self.jfif:
            ids = tuple(c.id for c in self.components)
            if self.adobe_transform == 0 or (self.adobe_transform is None and ids == (82, 71, 66)):
                self._fail("unsupported JPEG: RGB-coded (Adobe transform 0 or R, G, B component ids); the port "
                           "decodes YCbCr")
        full = [self._upsample(plane, c) for plane, c in zip(planes, self.components)]
        y, cb, cr = (f.astype(np.int64) for f in full)
        r = np.clip(y + CR_R[cr], 0, 255)
        g = np.clip(y + ((CB_G[cb] + CR_G[cr]) >> 16), 0, 255)
        b = np.clip(y + CB_B[cb], 0, 255)
        return np.stack([r, g, b], axis=-1).astype(np.uint8)

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
    """A baseline JPEG's bytes -> uint8 (H, W, 3) RGB, as PIL's
    `Image.open(...).convert("RGB")` gives it."""
    return JPEGFrame(data, name).rgb()
