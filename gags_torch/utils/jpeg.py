"""JPEG files without PIL: a decoder that gives libjpeg-turbo's pixels bit
for bit (the pixels of PIL's ``Image.open(p).convert("RGB")``) and a
baseline writer at Pillow's save defaults.

Decoding runs in two stages.

1. The markers are parsed here (SOI, APPn, COM, DQT, DHT, SOF0/1/2, DRI,
   SOS, RSTn, EOI; fill bytes and 0xFF00 stuffing), and the entropy-coded
   segments are Huffman-decoded into int16 coefficients in natural order,
   one (blocks, 64) plane a component: baseline scans, and progressive DC
   first / refine and AC first / refine scans with EOBRUN and the
   correction bits of successive approximation (jdhuff.c, jdphuff.c).
   For a CPU tensor that is `entropy_decode` in Python; on the card it is
   the host C++ decoder of ``csrc/jpeg_decode.cu`` (Python takes seconds
   an image there).
2. `jpeg_pixels` turns the coefficients into (H, W, 3) uint8: dequantise,
   libjpeg's integer ISLOW IDCT (jidctint.c, the masked range-limit table),
   libjpeg-turbo's fancy upsampling (h2v1, h2v2, h1v2 with replicated
   edge columns and context rows; box replication for the other ratios and
   for components at most 2 samples wide) and the YCbCr → RGB tables of
   jdcolor.c (grey replicated, an Adobe transform-0 file passed through as
   RGB). On a CPU tensor it runs `jpeg_pixels_plain`, integer torch ops; on
   a CUDA tensor it launches the J1 kernels of ``csrc/jpeg_decode.cu``, the
   same integer arithmetic, so the two agree bit for bit.

Arithmetic coding, 12-bit samples, lossless and hierarchical files,
CMYK / YCCK, truncated files and progressive files that leave libjpeg's
block smoothing a coefficient to estimate raise ValueError naming the file
and the reason. Where an IDCT output leaves [-512, 511] (coefficients no
encoder of 8-bit samples writes), libjpeg-turbo's x86 SIMD IDCT saturates
while its C IDCT, which this follows, wraps through the range-limit table.

`encode_jpeg` writes what Pillow's ``save(..., "JPEG")`` writes at its
defaults (quality 75 IJG tables, 4:2:0, the standard Huffman tables, a JFIF
APP0): jccolor.c's RGB → YCbCr tables, jcsample.c's downsampling, the
ISLOW forward DCT of jfdctint.c and jcdctmgr.c's reciprocal quantisation,
entropy coding vectorised in numpy.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gags_torch import resolve_device

CSRC = Path(__file__).resolve().parent / "csrc"
JPEG_DECODE_SRC = CSRC / "jpeg_decode.cu"

launch_counts = {"jpeg_decode": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _zigzag() -> np.ndarray:
    """jpeg_natural_order: the natural (row-major) index of each zigzag
    position."""
    order = []
    for s in range(15):
        rows = range(max(0, s - 7), min(s, 7) + 1)
        for r in (reversed(rows) if s % 2 == 0 else rows):
            order.append(r * 8 + s - r)
    return np.array(order, np.int64)


NATURAL = _zigzag()
# libjpeg pads the table with 16 entries of 63, so a corrupt run cannot
# index past a block
_NATURAL_PADDED = NATURAL.tolist() + [63] * 16

# Annex K: the base quantisation tables (zigzag order) and the standard
# Huffman tables (16 code counts, then the symbols)
_STD_QUANT = (
    bytes.fromhex("100b0c0e0c0a100e0d0e1211101318281a181616183123251d283a333d3c3933"
                  "383740485c4e404457453738506d51575f626768673e4d71797064785c656763"),
    bytes.fromhex("1112121815182f1a1a2f63423842636363636363636363636363636363636363"
                  "6363636363636363636363636363636363636363636363636363636363636363"),
)
_STD_HUFF = {  # (class, id): table; class 0 DC, 1 AC
    (0, 0): bytes.fromhex("00010501010101010100000000000000000102030405060708090a0b"),
    (1, 0): bytes.fromhex(
        "0002010303020403050504040000017d01020300041105122131410613516107227114328191a108"
        "2342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a838485868788898a92939495969798"
        "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (0, 1): bytes.fromhex("00030101010101010101010000000000000102030405060708090a0b"),
    (1, 1): bytes.fromhex(
        "00020102040403040705040400010277000102031104052131061241510761711322328108144291"
        "a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a82838485868788898a9293949596"
        "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int
    bw: int = 0  # coefficient plane, in blocks (MCU-padded)
    bh: int = 0
    dw: int = 0  # samples of the component (libjpeg's downsampled_width / _height)
    dh: int = 0
    offset: int = 0  # first block of the plane in the coefficient array
    quant: Optional[np.ndarray] = None  # (64,) natural order, latched at its first scan


@dataclasses.dataclass
class Scan:
    comps: List[int]  # component indices
    ss: int
    se: int
    ah: int
    al: int
    dc: List[bytes]  # the Huffman table of each component of the scan (counts + symbols)
    ac: List[bytes]
    restart: int  # MCUs a restart interval, 0: none
    segments: List[bytes]  # the unstuffed entropy-coded data of each restart interval


@dataclasses.dataclass
class JpegFile:
    name: str
    width: int
    height: int
    progressive: bool
    colour: str  # "grey", "ycc" or "rgb"
    comps: List[Component]
    scans: List[Scan]
    max_h: int
    max_v: int
    blocks: int  # blocks of all planes

    def scan_blocks(self, scan: Scan) -> np.ndarray:
        """The coefficient-array block of every block of `scan`, in the order
        the scan codes them, as (MCUs, blocks an MCU): an interleaved scan
        walks MCUs of h x v blocks a component over the MCU-padded planes;
        a scan of one component walks its ceil(dw/8) x ceil(dh/8) blocks,
        one an MCU."""
        if len(scan.comps) == 1:
            c = self.comps[scan.comps[0]]
            rows, cols = -(-c.dh // 8), -(-c.dw // 8)
            r, q = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
            return (c.offset + r * c.bw + q).reshape(-1, 1)
        mcu_x = -(-self.width // (8 * self.max_h))
        mcu_y = -(-self.height // (8 * self.max_v))
        my, mx = np.meshgrid(np.arange(mcu_y), np.arange(mcu_x), indexing="ij")
        my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
        parts = []
        for ci in scan.comps:
            c = self.comps[ci]
            by, bx = np.meshgrid(np.arange(c.v), np.arange(c.h), indexing="ij")
            by, bx = by.reshape(1, -1), bx.reshape(1, -1)
            parts.append(c.offset + (my * c.v + by) * c.bw + mx * c.h + bx)
        return np.concatenate(parts, axis=1)

    def scan_plan(self, scan: Scan):
        """(blocks of `scan_blocks`, MCUs a restart interval, intervals, the
        scan component of each block of an MCU); raises if the scan holds
        fewer restart intervals than its MCUs need."""
        blocks = self.scan_blocks(scan)
        per = scan.restart or blocks.shape[0]
        n_seg = -(-blocks.shape[0] // per)
        if len(scan.segments) < n_seg:
            _fail(self.name, f"a scan holds {len(scan.segments)} restart intervals, "
                             f"{n_seg} expected")
        owner = []
        for k, ci in enumerate(scan.comps):
            c = self.comps[ci]
            owner += [k] * (1 if len(scan.comps) == 1 else c.h * c.v)
        return blocks, per, n_seg, owner

    def layout(self) -> np.ndarray:
        """The int32 parameter block the pixel stage reads (plain version
        and kernel alike): width, height, colour code, component count,
        max_h, max_v, then per component h, v, bw, bh, dw, dh, offset,
        then the components' quantisation tables (64 each)."""
        head = [self.width, self.height, {"grey": 0, "ycc": 1, "rgb": 2}[self.colour],
                len(self.comps), self.max_h, self.max_v]
        per = []
        for c in self.comps:
            per += [c.h, c.v, c.bw, c.bh, c.dw, c.dh, c.offset]
        qs = [c.quant if c.quant is not None else np.zeros(64, np.int64) for c in self.comps]
        return np.concatenate([np.array(head + per, np.int64), *qs]).astype(np.int32)


def _fail(name: str, why: str):
    raise ValueError(f"{name}: {why}")


def _check_huff_table(name: str, table: bytes, dc: bool) -> None:
    """Check a Huffman table (counts + symbols) as jpeg_make_d_derived_tbl
    does when a scan first uses it: the codes of each length leave the
    all-ones code free, and a DC table's symbols (bit counts) are 0..15."""
    code = 0
    for length in range(1, 17):
        code += table[length - 1]
        if code >= (1 << length):
            _fail(name, "bad Huffman table (its codes overflow their lengths)")
        code <<= 1
    if dc and max(table[16:], default=0) > 15:
        _fail(name, "bad Huffman table (a DC symbol above 15)")


def _entropy_segments(data: bytes, arr: np.ndarray, ffpos: np.ndarray, pos: int,
                      name: str) -> Tuple[List[bytes], int]:
    """The entropy-coded data of the scan starting at `pos`, split at its
    RST markers and unstuffed (a run of 0xFF bytes before 0x00 is one
    0xFF byte; 0xFF fill bytes before a marker are dropped). Returns the
    segments and the position of the marker that ends the scan."""
    n = len(data)
    i = int(np.searchsorted(ffpos, pos))
    start, keep = pos, np.ones(0, bool)
    drops: list = []
    segments = []
    expect = 0
    while True:
        if i >= len(ffpos):
            _fail(name, "file truncated inside entropy-coded data")
        q = int(ffpos[i])
        r = q
        while r + 1 < n and arr[r + 1] == 0xFF:
            r += 1
        if r + 1 >= n:
            _fail(name, "file truncated inside entropy-coded data")
        nxt = data[r + 1]
        i = int(np.searchsorted(ffpos, r + 1, side="right"))
        if nxt == 0x00:
            drops.append((q + 1, r + 2))
            continue
        seg = arr[start:q]
        if drops:
            keep = np.ones(q - start, bool)
            for a, b in drops:
                keep[a - start:b - start] = False
            seg = seg[keep]
        segments.append(seg.tobytes())
        drops = []
        if 0xD0 <= nxt <= 0xD7:
            if nxt - 0xD0 != expect:
                _fail(name, f"restart marker RST{nxt - 0xD0} out of sequence (RST{expect} expected)")
            expect = (expect + 1) % 8
            start = r + 2
            continue
        return segments, q


def parse_jpeg(data: bytes, name: str = "<bytes>") -> JpegFile:
    """Parse a JPEG file's markers into its frame, tables and scans."""
    if data[:2] != b"\xff\xd8":
        _fail(name, "not a JPEG file (no SOI marker)")
    arr = np.frombuffer(data, np.uint8)
    ffpos = np.flatnonzero(arr == 0xFF)
    n = len(data)
    quant: dict = {}
    huff: dict = {}
    restart = 0
    comps: List[Component] = []
    scans: List[Scan] = []
    frame = None
    jfif = adobe = False
    transform = -1
    pos = 2
    eoi = False
    while pos < n:
        if data[pos] != 0xFF:
            _fail(name, f"marker expected at byte {pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            eoi = True
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue  # a stray RST or TEM carries no length
        if pos + 2 > n:
            _fail(name, "file truncated inside a marker")
        length = int.from_bytes(data[pos:pos + 2], "big")
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            _fail(name, "file truncated inside a marker")
        pos += length
        if m == 0xDB:  # DQT
            j = 0
            while j < len(body):
                pq, tq = body[j] >> 4, body[j] & 15
                size = 128 if pq else 64
                raw = np.frombuffer(body[j + 1:j + 1 + size], ">u2" if pq else np.uint8)
                if raw.size != 64 or tq > 3:
                    _fail(name, "bad DQT marker")
                t = np.zeros(64, np.int64)
                t[NATURAL] = raw
                quant[tq] = t
                j += 1 + size
        elif m == 0xC4:  # DHT
            j = 0
            while j < len(body):
                tc, th = body[j] >> 4, body[j] & 15
                counts = body[j + 1:j + 17]
                total = sum(counts)
                if (len(counts) != 16 or total > 256 or len(body) < j + 17 + total
                        or tc > 1 or th > 3):
                    _fail(name, "bad DHT marker")
                huff[(tc, th)] = bytes(counts) + bytes(body[j + 17:j + 17 + total])
                j += 17 + total
        elif m == 0xDD:  # DRI
            restart = int.from_bytes(body[:2], "big")
        elif m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                _fail(name, "more than one frame header")
            if body[0] != 8:
                _fail(name, f"{body[0]}-bit samples are not supported (8-bit only)")
            h, w, nc = int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big"), body[5]
            if h == 0 or w == 0:
                _fail(name, f"image size {w}x{h} (a DNL marker is not supported)")
            if nc == 4:
                _fail(name, "CMYK / YCCK JPEG files are not supported")
            if nc not in (1, 3):
                _fail(name, f"{nc} components are not supported (1 or 3)")
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
                    _fail(name, "bad sampling factors or table in the frame header")
                comps.append(Component(cid, hv >> 4, hv & 15, tq))
            frame = (w, h, m == 0xC2)
        elif m in (0xC3, 0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF):
            _fail(name, "lossless or hierarchical JPEG is not supported")
        elif m in (0xC9, 0xCA, 0xCC):
            _fail(name, "arithmetic-coded JPEG is not supported")
        elif m == 0xDC:
            _fail(name, "a DNL marker is not supported")
        elif m == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
            adobe, transform = True, body[11]
        elif m == 0xDA:  # SOS
            if frame is None:
                _fail(name, "scan before the frame header")
            if not scans:
                _plan(frame, comps)
            ns = body[0]
            idx, dcs, acs = [], [], []
            for k in range(ns):
                cid, t = body[1 + 2 * k:3 + 2 * k]
                ci = next((i for i, c in enumerate(comps) if c.cid == cid), None)
                if ci is None:
                    _fail(name, f"scan names component {cid}, which the frame lacks")
                idx.append(ci)
                dcs.append(huff.get((0, t >> 4)))
                acs.append(huff.get((1, t & 15)))
                if comps[ci].quant is None:  # latch_quant_tables: at its first scan
                    if comps[ci].tq not in quant:
                        _fail(name, f"quantisation table {comps[ci].tq} is missing")
                    comps[ci].quant = quant[comps[ci].tq].copy()
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            prog = frame[2]
            if not prog and (ss, se, ah, al) != (0, 63, 0, 0):
                _fail(name, "bad sequential scan parameters")
            if prog and (ss > se or se > 63 or al > 13 or (ss == 0) != (se == 0)
                         or (ss > 0 and ns != 1)):
                _fail(name, "bad progressive scan parameters")
            need_dc = ss == 0 and ah == 0
            need_ac = se > 0
            for k in range(ns):
                if (need_dc and dcs[k] is None) or (need_ac and acs[k] is None):
                    _fail(name, "scan uses a Huffman table that is not defined")
                if need_dc:
                    _check_huff_table(name, dcs[k], dc=True)
                if need_ac:
                    _check_huff_table(name, acs[k], dc=False)
            segments, pos = _entropy_segments(data, arr, ffpos, pos, name)
            scans.append(Scan(idx, ss, se, ah, al, dcs, acs, restart, segments))
        # APPn, COM and any other marker: skipped
    if frame is None:
        _fail(name, "no frame header")
    if not eoi:
        _fail(name, "file truncated (no EOI marker)")
    if not scans:
        _fail(name, "no scan")
    w, h, prog = frame
    if len(comps) == 1:
        colour = "grey"
    elif jfif:
        colour = "ycc"
    elif adobe:
        colour = "rgb" if transform == 0 else "ycc"
    else:
        ids = tuple(c.cid for c in comps)
        colour = "rgb" if ids == (82, 71, 66) else "ycc"
    max_h, max_v = max(c.h for c in comps), max(c.v for c in comps)
    for c in comps:
        if max_h % c.h or max_v % c.v:
            _fail(name, "fractional sampling factors are not supported")
    jf = JpegFile(name, w, h, prog, colour, comps, scans, max_h, max_v,
                  sum(c.bw * c.bh for c in comps))
    if prog:
        _check_smoothing(jf)
    return jf


def _plan(frame, comps: List[Component]) -> None:
    """Each component's sample size and MCU-padded coefficient plane."""
    w, h, _ = frame
    max_h, max_v = max(c.h for c in comps), max(c.v for c in comps)
    if len(comps) == 1:  # one component: an MCU is one block whatever its factors
        c = comps[0]
        c.h = c.v = 1
        max_h = max_v = 1
    mcu_x, mcu_y = -(-w // (8 * max_h)), -(-h // (8 * max_v))
    off = 0
    for c in comps:
        c.dw, c.dh = -(-w * c.h // max_h), -(-h * c.v // max_v)
        c.bw, c.bh = mcu_x * c.h, mcu_y * c.v
        c.offset = off
        off += c.bw * c.bh


def _check_smoothing(jf: JpegFile) -> None:
    """libjpeg smooths the blocks of a progressive file (jdcoefct.c
    smoothing_ok) when, after its last scan, a component's DC is known
    and one of its first nine AC coefficients is still approximate or
    missing: this decoder does not, so such a file raises."""
    bits = {ci: [-1] * 64 for ci in range(len(jf.comps))}
    for s in jf.scans:
        for ci in s.comps:
            for k in range(s.ss, s.se + 1):
                bits[ci][k] = s.al
    for ci, c in enumerate(jf.comps):
        q = c.quant
        if q is None or bits[ci][0] < 0 or not all(q[NATURAL[:10]]):
            return
    if any(any(b[k] != 0 for k in range(1, 10)) for b in bits.values()):
        _fail(jf.name, "progressive scans leave coefficients for libjpeg's block smoothing, "
                       "which is not supported")


# ---------------------------------------------------------------------------
# stage 1 in Python: Huffman decoding
# ---------------------------------------------------------------------------


def _lut(table: bytes) -> list:
    """65536 entries, (code length << 8) | symbol for every 16-bit window
    that starts with a code; 0 where none does."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 16
    for length in range(1, 17):
        for _ in range(table[length - 1]):
            lut[code << (16 - length):(code + 1) << (16 - length)] = (length << 8) | table[k]
            k += 1
            code += 1
        code <<= 1
    return lut.tolist()


def _windows(seg: bytes) -> list:
    """The 32-bit big-endian window at each byte of a segment; reads past
    its end see zero bits, as libjpeg inserts zeros there."""
    a = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.int64)
    return (a[:-3] << 24 | a[1:-2] << 16 | a[2:-1] << 8 | a[3:]).tolist()


def entropy_decode(jf: JpegFile) -> np.ndarray:
    """Huffman-decode every scan: (blocks, 64) int16 coefficients in
    natural order, the components' planes one after another."""
    coef = [0] * (jf.blocks * 64)
    nat = _NATURAL_PADDED
    luts: dict = {}

    def lut(t):
        if t not in luts:
            luts[t] = _lut(t)
        return luts[t]

    for scan in jf.scans:
        blocks, per, n_seg, owner = jf.scan_plan(scan)
        dcl = [lut(t) if t is not None else None for t in scan.dc]
        acl = [lut(t) if t is not None else None for t in scan.ac]
        for s in range(n_seg):
            seg = scan.segments[s]
            win = _windows(seg)
            mcus = (blocks[s * per:(s + 1) * per] * 64).tolist()
            try:
                if not jf.progressive:
                    p = _baseline(win, mcus, owner, dcl, acl, coef, nat, len(scan.comps))
                elif scan.ss == 0:
                    p = _dc_scan(win, mcus, owner, dcl, coef, scan.ah, scan.al,
                                 len(scan.comps))
                elif scan.ah == 0:
                    p = _ac_first(win, mcus, acl[0], coef, nat, scan.ss, scan.se, scan.al)
                else:
                    p = _ac_refine(win, mcus, acl[0], coef, nat, scan.ss, scan.se, scan.al)
            except _BadCode:
                _fail(jf.name, "bad Huffman code in entropy-coded data")
            if p > 8 * len(seg):
                _fail(jf.name, "entropy-coded data ends before its last block (corrupt)")
    return np.array(coef, np.int64).astype(np.int16).reshape(jf.blocks, 64)


class _BadCode(Exception):
    pass


def _bad(_):
    raise _BadCode


def _baseline(win, mcus, owner, dcl, acl, coef, nat, ncomp) -> int:
    p = 0
    pred = [0] * ncomp
    for mcu in mcus:
        for j, base in enumerate(mcu):
            k = owner[j]
            e = dcl[k][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF] or _bad(0)
            p += e >> 8
            s = e & 255
            if s:
                r = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if r < (1 << (s - 1)):
                    r += (-1 << s) + 1
                pred[k] += r
            coef[base] = pred[k]
            ac = acl[k]
            i = 1
            while i < 64:
                e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF] or _bad(0)
                p += e >> 8
                s = e & 15
                if s:
                    i += (e >> 4) & 15
                    r = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    if r < (1 << (s - 1)):
                        r += (-1 << s) + 1
                    coef[base + nat[i]] = r
                    i += 1
                elif (e >> 4) & 15 == 15:
                    i += 16
                else:
                    break
    return p


def _dc_scan(win, mcus, owner, dcl, coef, ah, al, ncomp) -> int:
    p = 0
    pred = [0] * ncomp
    for mcu in mcus:
        for j, base in enumerate(mcu):
            if ah:  # refine: one bit
                if (win[p >> 3] >> (31 - (p & 7))) & 1:
                    coef[base] |= 1 << al
                p += 1
                continue
            k = owner[j]
            e = dcl[k][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF] or _bad(0)
            p += e >> 8
            s = e & 255
            if s:
                r = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if r < (1 << (s - 1)):
                    r += (-1 << s) + 1
                pred[k] += r
            coef[base] = pred[k] * (1 << al)
    return p


def _ac_first(win, mcus, ac, coef, nat, ss, se, al) -> int:
    p = 0
    eobrun = 0
    for (base,) in mcus:
        if eobrun:
            eobrun -= 1
            continue
        i = ss
        while i <= se:
            e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF] or _bad(0)
            p += e >> 8
            s = e & 15
            r = (e >> 4) & 15
            if s:
                i += r
                v = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if v < (1 << (s - 1)):
                    v += (-1 << s) + 1
                coef[base + nat[i]] = v * (1 << al)
            elif r == 15:
                i += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (win[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                    p += r
                eobrun -= 1
                break
            i += 1
    return p


def _ac_refine(win, mcus, ac, coef, nat, ss, se, al) -> int:
    p = 0
    eobrun = 0
    p1, m1 = 1 << al, -1 << al
    for (base,) in mcus:
        i = ss
        if eobrun == 0:
            while i <= se:
                e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF] or _bad(0)
                p += e >> 8
                s = e & 15
                r = (e >> 4) & 15
                if s:
                    s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                        p += r
                    break
                # advance over nonzero coefficients (a correction bit each)
                # and r zero ones
                while True:
                    at = base + nat[i]
                    c = coef[at]
                    if c:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                            coef[at] = c + (p1 if c >= 0 else m1)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    i += 1
                    if i > se:
                        break
                if s:
                    coef[base + nat[i]] = s
                i += 1
        if eobrun:
            while i <= se:
                at = base + nat[i]
                c = coef[at]
                if c:
                    if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                        coef[at] = c + (p1 if c >= 0 else m1)
                    p += 1
                i += 1
            eobrun -= 1
    return p


# ---------------------------------------------------------------------------
# stage 2: dequantise, IDCT, upsample, colour (plain version and kernel)
# ---------------------------------------------------------------------------

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _range_limit() -> torch.Tensor:
    """libjpeg's post-IDCT range-limit table, indexed by the descaled
    output & 1023: x + 128 clamped for x in [-512, 511], wrapping past it."""
    m = torch.arange(1024)
    return torch.where(m < 128, m + 128, torch.where(m < 512, 255, torch.where(
        m < 896, 0, m - 896))).to(torch.uint8)


def _idct_1d(x):
    """jidctint.c's 1-D pass over 8 int64 tensors (the 8 inputs of a
    column or row); returns the 8 outputs before the descale."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow_plain(coef: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """(N, 64) int16 coefficients (natural order) times (N, 64) quantisers
    (each taken as a 16-bit ISLOW_MULT_TYPE) → (N, 8, 8) uint8 samples:
    jpeg_idct_islow, columns then rows, in int64 (libjpeg's JLONG)."""
    x = (coef.to(torch.int64) * quant.to(torch.int16).to(torch.int64)).reshape(-1, 8, 8)
    n1 = CONST_BITS - PASS1_BITS
    ws = torch.stack([(v + (1 << (n1 - 1))) >> n1
                      for v in _idct_1d([x[:, r, :] for r in range(8)])], dim=1)
    ws = ws.to(torch.int32).to(torch.int64)  # the workspace is C's int
    n2 = CONST_BITS + PASS1_BITS + 3
    out = torch.stack([(v + (1 << (n2 - 1))) >> n2
                       for v in _idct_1d([ws[:, :, k] for k in range(8)])], dim=2)
    return _range_limit().to(out.device)[out & 1023]


def _upsample(p: torch.Tensor, hr: int, vr: int, h: int, w: int) -> torch.Tensor:
    """A component's (dh, dw) samples at the image's (h, w) grid, as
    libjpeg-turbo's jdsample.c upsamples them (int32)."""
    dh, dw = p.shape
    dev = p.device
    p = p.to(torch.int32)
    ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)
    if hr == 1 and vr == 1:
        return p[:h, :w]
    if hr == 2 and vr in (1, 2) and dw > 2 or hr == 1 and vr == 2:
        if vr == 2:  # vertical: 3 x nearer row + farther row (context rows replicated)
            iy = ys // 2
            ny = torch.where(ys % 2 == 0, iy - 1, iy + 1).clamp(0, dh - 1)
            p = 3 * p[iy] + p[ny]
        else:
            p = p[:h]
        if hr == 1:  # h1v2: biases 1 (row above) and 2 (row below)
            return (p[:, :w] + torch.where(ys % 2 == 0, 1, 2)[:, None]) >> 2
        ix = xs // 2
        nx = torch.where(xs % 2 == 0, ix - 1, ix + 1).clamp(0, dw - 1)
        even = (xs % 2 == 0)[None, :]
        if vr == 2:  # h2v2: biases 8 and 7 over the column sums
            return (3 * p[:, ix] + p[:, nx] + torch.where(even, 8, 7)) >> 4
        return (3 * p[:, ix] + p[:, nx] + torch.where(even, 1, 2)) >> 2
    return p[ys // vr][:, xs // hr]  # box replication


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _ycc_to_rgb(y, cb, cr) -> torch.Tensor:
    """jdcolor.c ycc_rgb_convert (SCALEBITS 16) on int32 planes."""
    cb, cr = cb.to(torch.int64) - 128, cr.to(torch.int64) - 128
    half = 1 << 15
    r = y + ((_fix(1.40200) * cr + half) >> 16)
    g = y + ((-_fix(0.34414) * cb + half - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.77200) * cb + half) >> 16)
    return torch.stack([r, g, b], -1).clamp(0, 255)


def jpeg_pixels_plain(coef: torch.Tensor, layout: np.ndarray) -> torch.Tensor:
    """The plain version of J1: (blocks, 64) int16 coefficients and the
    int32 layout of `JpegFile.layout` → (H, W, 3) uint8 on coef's device."""
    lay = np.asarray(layout).tolist()
    w, h, colour, nc, max_h, max_v = lay[:6]
    comps = [lay[6 + 7 * k:13 + 7 * k] for k in range(nc)]
    qs = torch.as_tensor(np.asarray(layout[6 + 7 * nc:]).reshape(nc, 64), device=coef.device)
    planes = []
    for k, (ch, cv, bw, bh, dw, dh, off) in enumerate(comps):
        blk = coef[off:off + bw * bh]
        s = idct_islow_plain(blk, qs[k].expand(blk.shape[0], 64))
        s = s.reshape(bh, bw, 8, 8).permute(0, 2, 1, 3).reshape(bh * 8, bw * 8)[:dh, :dw]
        planes.append(_upsample(s, max_h // ch, max_v // cv, h, w))
    if colour == 0:
        out = planes[0][..., None].expand(h, w, 3)
    elif colour == 2:
        out = torch.stack(planes, -1)
    else:
        out = _ycc_to_rgb(*planes)
    return out.to(torch.uint8).contiguous()


def jpeg_pixels(coef: torch.Tensor, layout: np.ndarray) -> torch.Tensor:
    """J1: (blocks, 64) int16 coefficients → (H, W, 3) uint8 on coef's
    device: the plain version for a CPU tensor, the CUDA kernels (dequant +
    IDCT into the sample planes, then upsampling + colour) for a CUDA
    tensor."""
    from gags_torch.splat.kernels import _dispatch, _ptr, _stream

    layout = np.ascontiguousarray(layout, np.int32)
    if not _dispatch(coef):
        return jpeg_pixels_plain(coef, layout)
    from gags_torch import _kernels

    if coef.dtype != torch.int16 or coef.dim() != 2 or coef.shape[1] != 64:
        raise ValueError(f"jpeg_pixels: (blocks, 64) int16, got {coef.dtype} {tuple(coef.shape)}")
    coef = coef.contiguous()
    w, h, nc = int(layout[0]), int(layout[1]), int(layout[3])
    if coef.shape[0] != sum(int(layout[8 + 7 * k]) * int(layout[9 + 7 * k]) for k in range(nc)):
        raise ValueError("jpeg_pixels: the coefficient count does not match the layout")
    samples = torch.empty((coef.shape[0] * 64,), dtype=torch.uint8, device=coef.device)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=coef.device)
    lib = _kernels.load(JPEG_DECODE_SRC)
    fn = lib.gags_jpeg_pixels
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_ptr(coef), layout.ctypes.data_as(ctypes.c_void_p), _ptr(samples), _ptr(out),
             _stream(coef))
    _kernels.check(lib, err, "jpeg_pixels")
    launch_counts["jpeg_decode"] += 1
    return out


def entropy_decode_host(jf: JpegFile) -> np.ndarray:
    """`entropy_decode` by the host C++ decoder of csrc/jpeg_decode.cu
    (built with the kernels): the same (blocks, 64) int16 coefficients."""
    from gags_torch import _kernels

    lib = _kernels.load(JPEG_DECODE_SRC)
    fn = lib.gags_jpeg_entropy_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    coef = np.zeros((jf.blocks, 64), np.int16)
    for scan in jf.scans:
        blocks, per, n_seg, owner = jf.scan_plan(scan)
        blocks = np.ascontiguousarray(blocks, np.int32)
        data = b"".join(scan.segments[:n_seg])
        offs = np.cumsum([0] + [len(s) for s in scan.segments[:n_seg]]).astype(np.int64)
        params = np.array([len(scan.comps), blocks.shape[1], blocks.shape[0], per,
                           int(jf.progressive),
                           scan.ss, scan.se, scan.ah, scan.al] + owner, np.int32)
        tables = np.zeros((2, 4, 16 + 256), np.uint8)
        for k in range(len(scan.comps)):
            for cls, t in ((0, scan.dc[k]), (1, scan.ac[k])):
                if t is not None:
                    tables[cls, k, :len(t)] = np.frombuffer(t, np.uint8)
        buf = np.frombuffer(data + b"\0" * 8, np.uint8)
        err = fn(buf.ctypes.data_as(ctypes.c_void_p), offs.ctypes.data_as(ctypes.c_void_p),
                 n_seg, params.ctypes.data_as(ctypes.c_void_p),
                 tables.ctypes.data_as(ctypes.c_void_p), blocks.ctypes.data_as(ctypes.c_void_p),
                 coef.ctypes.data_as(ctypes.c_void_p))
        if err == 1:
            _fail(jf.name, "bad Huffman code in entropy-coded data")
        if err == 2:
            _fail(jf.name, "entropy-coded data ends before its last block (corrupt)")
        if err:
            _fail(jf.name, f"entropy decoding failed ({err})")
    return coef


def is_jpeg(head: bytes) -> bool:
    return head[:3] == b"\xff\xd8\xff"


def decode_jpeg(data: bytes, device="cuda", name: str = "<bytes>") -> torch.Tensor:
    """A JPEG file's bytes → (H, W, 3) uint8 on `device`: on a CUDA device
    the host C++ entropy decoder, one copy of the coefficients to the card
    and J1; on the CPU (only when asked for) the Python entropy decoder and
    J1's plain version."""
    dev = resolve_device(device)
    jf = parse_jpeg(data, name)
    if dev.type == "cuda":
        coef = torch.from_numpy(entropy_decode_host(jf)).to(dev)
    else:
        coef = torch.from_numpy(entropy_decode(jf))
    return jpeg_pixels(coef, jf.layout())



# ---------------------------------------------------------------------------
# encoding: a baseline file as Pillow saves one
# ---------------------------------------------------------------------------


def quality_tables(quality: int = 75) -> Tuple[np.ndarray, np.ndarray]:
    """jpeg_set_quality(quality, force_baseline=TRUE): the luminance and
    chrominance tables, (64,) natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = []
    for base in _STD_QUANT:
        t = np.zeros(64, np.int64)
        t[NATURAL] = np.frombuffer(base, np.uint8)
        out.append(np.clip((t * scale + 50) // 100, 1, 255))
    return out[0], out[1]


def _rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """jccolor.c rgb_ycc_convert: (H, W, 3) uint8 → (3, H, W) int64."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + (128 << 16) + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + (128 << 16) + half - 1) >> 16
    return np.stack([y, cb, cr])


def _downsample(x: np.ndarray, hx: int, vx: int, bw: int, group: int) -> np.ndarray:
    """jcsample.c (with jcprepct.c's bottom padding) for one component:
    the (H, W) plane, its right edge replicated to bw * 8 * hx columns and
    its last row to a whole row group of `group` (max_v) rows, downsampled
    by (hx, vx) to bw * 8 columns."""
    h, w = x.shape
    rows = -(-h // group) * group
    x = np.pad(x, ((0, rows - h), (0, bw * 8 * hx - w)), mode="edge")
    if hx == 1 and vx == 1:
        return x
    if hx == 2 and vx == 1:  # h2v1: biases 0, 1, 0, 1, ...
        bias = np.arange(bw * 8) % 2
        return (x[:, 0::2] + x[:, 1::2] + bias) >> 1
    if hx == 2 and vx == 2:  # h2v2: biases 1, 2, 1, 2, ...
        bias = 1 + np.arange(bw * 8) % 2
        return (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + bias) >> 2
    n = hx * vx  # int_downsample: a box average, rounded half up
    s = x.reshape(rows // vx, vx, bw * 8, hx).sum(axis=(1, 3))
    return (s + n // 2) // n


def _fdct_islow(x: np.ndarray) -> np.ndarray:
    """jfdctint.c jpeg_fdct_islow over (N, 8, 8) int64 samples minus 128:
    rows, then columns; the output is scaled up by 8."""
    def pass_(d, first):
        t0, t7 = d[0] + d[7], d[0] - d[7]
        t1, t6 = d[1] + d[6], d[1] - d[6]
        t2, t5 = d[2] + d[5], d[2] - d[5]
        t3, t4 = d[3] + d[4], d[3] - d[4]
        t10, t13 = t0 + t3, t0 - t3
        t11, t12 = t1 + t2, t1 - t2
        n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS

        def desc(v):
            return (v + (1 << (n - 1))) >> n

        out = [None] * 8
        if first:
            out[0], out[4] = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
        else:
            p = PASS1_BITS
            out[0], out[4] = (t10 + t11 + (1 << (p - 1))) >> p, (t10 - t11 + (1 << (p - 1))) >> p
        z1 = (t12 + t13) * FIX_0_541196100
        out[2] = desc(z1 + t13 * FIX_0_765366865)
        out[6] = desc(z1 + t12 * -FIX_1_847759065)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * FIX_1_175875602
        t4, t5 = t4 * FIX_0_298631336, t5 * FIX_2_053119869
        t6, t7 = t6 * FIX_3_072711026, t7 * FIX_1_501321110
        z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
        z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
        out[7] = desc(t4 + z1 + z3)
        out[5] = desc(t5 + z2 + z4)
        out[3] = desc(t6 + z2 + z3)
        out[1] = desc(t7 + z1 + z4)
        return out

    rows = np.stack(pass_([x[:, :, k] for k in range(8)], True), axis=2)
    return np.stack(pass_([rows[:, k, :] for k in range(8)], False), axis=1)


def _quantize(d: np.ndarray, qtab: np.ndarray) -> np.ndarray:
    """jcdctmgr.c quantize with compute_reciprocal's divisors (16-bit
    DCTELEM): (N, 64) int64 DCT outputs → quantised coefficients."""
    div = qtab.astype(np.int64) << 3
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq, fr = (np.int64(1) << r) // div, (np.int64(1) << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > div // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    a = np.abs(d)
    q = ((a + c) * fq) >> r
    return np.where(d < 0, -q, q)


def _codes(table: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Code and length of each symbol of a Huffman table (256 entries)."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c, k = 0, 16
    for length in range(1, 17):
        for _ in range(table[length - 1]):
            code[table[k]], size[table[k]] = c, length
            c += 1
            k += 1
        c <<= 1
    return code, size


def _nbits(v: np.ndarray) -> np.ndarray:
    a = np.abs(v)
    n = np.zeros(v.shape, np.int64)
    while True:
        m = a >> n > 0
        if not m.any():
            return n
        n += m


def _marker(m: int, body: bytes) -> bytes:
    return bytes([0xFF, m]) + (len(body) + 2).to_bytes(2, "big") + body


def encode_jpeg(rgb, quality: int = 75,
                sampling: Sequence[Tuple[int, int]] = ((2, 2), (1, 1), (1, 1))) -> bytes:
    """(H, W, 3) uint8 → the baseline JPEG file Pillow's ``save(f, "JPEG",
    quality=quality)`` writes for it at the default sampling (4:2:0): SOI,
    JFIF APP0, two DQT, SOF0, four DHT, SOS, the scan, EOI, byte for byte;
    (H, W) uint8 → the grey file it writes for an "L" image. `sampling`
    gives each colour component's (h, v) factors; factors Pillow does not
    offer (h1v2, h4v1) make files that test a decoder."""
    rgb = np.ascontiguousarray(rgb.cpu().numpy() if isinstance(rgb, torch.Tensor) else rgb)
    grey = rgb.ndim == 2
    if rgb.dtype != np.uint8 or not (grey or rgb.ndim == 3 and rgb.shape[2] == 3):
        raise ValueError(f"encode_jpeg: (H, W, 3) or (H, W) uint8, got {rgb.dtype} {rgb.shape}")
    if grey:
        sampling = ((1, 1),)
    h, w = rgb.shape[:2]
    if not 0 < h <= 65535 or not 0 < w <= 65535:
        raise ValueError(f"encode_jpeg: image size {w}x{h}")
    max_h, max_v = max(s[0] for s in sampling), max(s[1] for s in sampling)
    if sum(ch * cv for ch, cv in sampling) > 10:
        raise ValueError(f"encode_jpeg: sampling {sampling} puts more than 10 blocks in an MCU")
    qt = quality_tables(quality)
    ycc = rgb[None].astype(np.int64) if grey else _rgb_to_ycc(rgb)
    mcu_x, mcu_y = -(-w // (8 * max_h)), -(-h // (8 * max_v))
    planes = []
    for ci, (ch, cv) in enumerate(sampling):
        if max_h % ch or max_v % cv:
            raise ValueError(f"encode_jpeg: sampling {sampling} is not integral")
        dw, dh = -(-w * ch // max_h), -(-h * cv // max_v)
        bw, bh = -(-dw // 8), -(-dh // 8)
        ds = _downsample(ycc[ci], max_h // ch, max_v // cv, bw, max_v)
        # jcprepct.c: the last row replicated to the MCU rows' height
        ds = np.pad(ds, ((0, mcu_y * cv * 8 - ds.shape[0]), (0, 0)), mode="edge")[:, :bw * 8]
        blocks = (ds - 128).reshape(mcu_y * cv, 8, bw, 8).transpose(0, 2, 1, 3)
        coefs = _quantize(_fdct_islow(blocks.reshape(-1, 8, 8)).reshape(-1, 64),
                          qt[min(ci, 1)]).reshape(mcu_y * cv, bw, 64)
        # jccoefct.c's dummy blocks: past the right edge a copy of the DC
        # of the block to their left, rows past the bottom that of the block
        # before them in the MCU, AC zero
        full = np.zeros((mcu_y * cv, mcu_x * ch, 64), np.int64)
        full[:bh, :bw] = coefs[:bh]
        planes.append((full, bw, bh, ch, cv))
    # the blocks in scan order: MCU by MCU, each component's h x v blocks
    seq = []  # (component, block row, block column, column within the MCU)
    for my in range(mcu_y):
        for mx in range(mcu_x):
            for ci, (_, _, _, ch, cv) in enumerate(planes):
                for by in range(cv):
                    for bx in range(ch):
                        seq.append((ci, my * cv + by, mx * ch + bx, bx))
    comp = np.array([t[0] for t in seq])
    coef = np.stack([planes[ci][0][r, q] for ci, r, q, _ in seq])
    for j, (ci, r, q, bx) in enumerate(seq):  # dummy DCs, as compress_data copies them
        bw, bh = planes[ci][1], planes[ci][2]
        if r >= bh:  # a row past the bottom: the block before the row
            coef[j, 0] = coef[j - 1 - bx, 0]
        elif q >= bw:  # right of the edge: the block to its left
            coef[j, 0] = coef[j - 1, 0]
    zz = coef[:, NATURAL]
    scan = _entropy_code(zz, comp)
    body = [b"\xff\xd8",
            _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in range(2 if len(sampling) > 1 else 1):
        body.append(_marker(0xDB, bytes([t]) + qt[t][NATURAL].astype(np.uint8).tobytes()))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(sampling)])
    for ci, (ch, cv) in enumerate(sampling):
        sof += bytes([ci + 1, (ch << 4) | cv, min(ci, 1)])
    body.append(_marker(0xC0, sof))
    for t in range(2 if len(sampling) > 1 else 1):
        body.append(_marker(0xC4, bytes([0x00 | t]) + _STD_HUFF[(0, t)]))
        body.append(_marker(0xC4, bytes([0x10 | t]) + _STD_HUFF[(1, t)]))
    sos = bytes([len(sampling)])
    for ci in range(len(sampling)):
        sos += bytes([ci + 1, min(ci, 1) * 0x11])
    body.append(_marker(0xDA, sos + b"\x00\x3f\x00"))
    body.append(scan)
    body.append(b"\xff\xd9")
    return b"".join(body)


def _entropy_code(zz: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-code (blocks, 64) zigzag coefficients in scan order with the
    standard tables (component 0 the luminance tables, the others the
    chrominance ones): every code and its extra bits packed at cumulative
    bit offsets, padded with 1-bits, 0xFF stuffed."""
    nb = zz.shape[0]
    tab = np.minimum(comp, 1)
    dcc = [_codes(_STD_HUFF[(0, t)]) for t in (0, 1)]
    acc = [_codes(_STD_HUFF[(1, t)]) for t in (0, 1)]
    # DC: the difference from the previous block of the same component
    diff = np.zeros(nb, np.int64)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        d = zz[idx, 0]
        diff[idx] = np.diff(d, prepend=0)
    keys, vals, lens = [], [], []

    def emit(key, sym_code, sym_len, v, nbits):
        extra = np.where(v < 0, v - 1, v) & ((np.int64(1) << nbits) - 1)
        keys.append(key)
        vals.append((sym_code << nbits) | extra)
        lens.append(sym_len + nbits)

    s = _nbits(diff)
    code = np.where(tab == 0, dcc[0][0][s], dcc[1][0][s])
    size = np.where(tab == 0, dcc[0][1][s], dcc[1][1][s])
    emit(np.arange(nb) * 1024, code, size, diff, s)
    # AC: each nonzero with its run of zeros before it (ZRL per 16)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[b, k]
    first = np.r_[True, b[1:] != b[:-1]]
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    for z in range(3):  # at most 3 ZRLs: a run of 62 zeros
        m = run >= 16 * (z + 1)
        t = tab[b[m]]
        emit(b[m] * 1024 + k[m] * 8 + z, np.where(t == 0, acc[0][0][0xF0], acc[1][0][0xF0]),
             np.where(t == 0, acc[0][1][0xF0], acc[1][1][0xF0]), np.zeros(m.sum(), np.int64),
             np.zeros(m.sum(), np.int64))
    sym = ((run % 16) << 4) | _nbits(v)
    t = tab[b]
    emit(b * 1024 + k * 8 + 4, np.where(t == 0, acc[0][0][sym], acc[1][0][sym]),
         np.where(t == 0, acc[0][1][sym], acc[1][1][sym]), v, _nbits(v))
    # EOB where the last nonzero is before position 63
    last = np.zeros(nb, np.int64)
    np.maximum.at(last, b, k)
    m = last < 63
    t = tab[m]
    emit(np.flatnonzero(m) * 1024 + 1000, np.where(t == 0, acc[0][0][0], acc[1][0][0]),
         np.where(t == 0, acc[0][1][0], acc[1][1][0]), np.zeros(m.sum(), np.int64),
         np.zeros(m.sum(), np.int64))
    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    # pack: every bit of every code, most significant first
    total = int(ln.sum())
    pad = (-total) % 8
    starts = np.repeat(np.cumsum(ln) - ln, ln)
    within = np.arange(total) - starts
    bits = (np.repeat(val, ln) >> (np.repeat(ln, ln) - 1 - within)) & 1
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    data = np.packbits(bits)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()
