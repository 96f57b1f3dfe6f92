"""ctypes bridge to the native JPEG scan decoder (leptonc.c).

The port's own copy of the parts of lepton_tpu/_native/__init__.py that the
encode and decode paths need: build_hscan, build_huff_tables,
native_decode_baseline_scan (Huffman scan decode), native_recode_rows
(Huffman re-emit, :300-332), and for progressive and multi-scan JPEGs
native_decode_progressive_scan and native_recode_any_scan (:362-430).  The
library is built with gcc at first use into the build/ directory beside the
package (git ignores it).  It keeps a 12 MP scan decode far below the
pure-Python loop's time.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "leptonc.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
_SO = os.path.join(BUILD_DIR, "libleptonc_torch.so")

_lib = None
_lock = threading.Lock()


class NativeUnavailable(Exception):
    pass


def _build() -> None:
    """Compile into a temporary file, then rename: concurrent first uses
    (test workers) never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for flags in (["-O3", "-march=native"], ["-O2"]):
            r = subprocess.run(["gcc", *flags, "-fPIC", "-shared", "-o", tmp,
                                _SRC], capture_output=True, text=True)
            if r.returncode == 0:
                os.replace(tmp, _SO)
                return
        raise NativeUnavailable(f"gcc failed: {r.stderr[-2000:]}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                try:
                    _build()
                except (OSError, NativeUnavailable) as e:
                    raise NativeUnavailable(f"cannot build leptonc: {e}")
            lib = ctypes.CDLL(_SO)
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.lepton_huff_table_size.argtypes = []
            lib.lepton_huff_table_size.restype = i
            lib.lepton_build_huff.argtypes = [p, p, p, i]
            lib.lepton_build_huff.restype = None
            lib.lepton_decode_baseline_scan.argtypes = [
                p, ctypes.c_int64, p, p, p, p, p, p, i, p, p, p, p]
            lib.lepton_decode_baseline_scan.restype = i
            i64 = ctypes.c_int64
            lib.lepton_recode_rows.argtypes = [
                p, p, p, i, i, i, i, p, i, p, i, i, p, i64, i64, p]
            lib.lepton_recode_rows.restype = i64
            lib.lepton_decode_progressive_scan.argtypes = [
                p, i64, p, p, p, p, p, p, p, i, p, p, p, p, p]
            lib.lepton_decode_progressive_scan.restype = i
            lib.lepton_recode_any_scan.argtypes = [
                p, p, i, p, p, i, p, i64, i64, p, p, p]
            lib.lepton_recode_any_scan.restype = i64
            _lib = lib
    return _lib


def available() -> bool:
    try:
        get_lib()
        return True
    except Exception:
        return False


class _HScan(ctypes.Structure):
    _fields_ = [
        ("comps", (ctypes.c_int32 * 11) * 4),
        ("ncomp", ctypes.c_int),
        ("cs_cmpc", ctypes.c_int),
        ("cs_cmp", ctypes.c_int * 4),
        ("rsti", ctypes.c_int),
        ("mcuh", ctypes.c_int),
        ("mcuv", ctypes.c_int),
        ("mcuc", ctypes.c_int),
    ]


def build_hscan(info) -> "_HScan":
    sc = _HScan()
    sc.ncomp = info.cmpc
    sc.cs_cmpc = info.scan.cs_cmpc
    for i, c in enumerate(info.scan.cs_cmp):
        sc.cs_cmp[i] = c
    sc.rsti = info.rsti
    sc.mcuh = info.mcuh
    sc.mcuv = info.mcuv
    sc.mcuc = info.mcuc
    for c in range(info.cmpc):
        ci = info.cmpnfo[c]
        vals = [ci.bch, ci.bcv, ci.bc, ci.nch, ci.ncv, ci.mbs,
                ci.sfv, ci.sfh, ci.huffdc, ci.huffac, 0x7fffffff]
        for j, v in enumerate(vals):
            sc.comps[c][j] = v
    return sc


def build_huff_tables(info):
    """ctypes buffer of 8 HuffTables: [dc0..dc3, ac0..ac3]."""
    lib = get_lib()
    size = lib.lepton_huff_table_size()
    buf = ctypes.create_string_buffer(size * 8)
    for cls in range(2):
        for tid in range(4):
            hc = info.hcodes[cls][tid]
            if hc is None:
                continue
            # rebuild the DHT counts/values from the code lengths
            cnt = [0] * 16
            syms_by_len = {}
            for sym in range(256):
                ln = hc.clen[sym]
                if ln:
                    syms_by_len.setdefault(ln, []).append(
                        (hc.cval[sym], sym))
            values = []
            for ln in range(1, 17):
                pairs = sorted(syms_by_len.get(ln, []))
                cnt[ln - 1] = len(pairs)
                values.extend(sym for _, sym in pairs)
            counts = bytes(cnt)
            vals = bytes(values)
            off = (cls * 4 + tid) * size
            lib.lepton_build_huff(
                ctypes.byref(buf, off), counts, vals, len(vals))
    return buf


def native_decode_baseline_scan(info, huffdata: bytes, bitpos: int,
                                offsets, planes, padbit: int):
    """Returns (status, new_bitpos, handoffs_list, padbit, max_dpos)."""
    lib = get_lib()
    sc = build_hscan(info)
    tables = build_huff_tables(info)
    n = len(planes)
    plane_ptrs = (ctypes.POINTER(ctypes.c_int16) * n)(*[
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for p in planes])
    hpos = np.ascontiguousarray([o[0] for o in offsets], dtype=np.uint32)
    fpos = np.ascontiguousarray([o[1] for o in offsets], dtype=np.uint32)
    max_handoffs = info.mcuv * max(1, info.cmpnfo[0].bcv // info.mcuv) + 16
    handoffs = np.zeros((max_handoffs, 8), dtype=np.int32)
    nhandoffs = ctypes.c_int32(0)
    padbit_c = ctypes.c_int32(padbit)
    bitpos_c = ctypes.c_int64(bitpos)
    max_dpos = np.zeros(4, dtype=np.int32)
    hbuf = np.frombuffer(huffdata, dtype=np.uint8)
    status = lib.lepton_decode_baseline_scan(
        hbuf.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(huffdata)),
        ctypes.byref(bitpos_c), ctypes.byref(sc), tables, plane_ptrs,
        hpos.ctypes.data_as(ctypes.c_void_p),
        fpos.ctypes.data_as(ctypes.c_void_p), len(offsets),
        handoffs.ctypes.data_as(ctypes.c_void_p), ctypes.byref(nhandoffs),
        ctypes.byref(padbit_c), max_dpos.ctypes.data_as(ctypes.c_void_p))
    return (status, bitpos_c.value, handoffs[:nhandoffs.value],
            padbit_c.value, max_dpos.tolist())


def native_recode_rows(info, planes, start_row: int, end_row: int,
                       overhang_byte: int, num_overhang_bits: int,
                       lastdc, padbit: int, rst_cnt, rst_cnt_set: bool,
                       out: np.ndarray, out_bound: int, out_pos: int,
                       tables=None, sc=None):
    """Re-emit MCU rows [start_row, end_row) of `planes` (int16 [H, W*64]
    each) as Huffman scan bytes into `out` from out_pos, bounded by
    out_bound.  Returns (new_out_pos, overhang_byte, num_overhang_bits,
    lastdc)."""
    lib = get_lib()
    if sc is None:
        sc = build_hscan(info)
    if tables is None:
        tables = build_huff_tables(info)
    n = len(planes)
    plane_ptrs = (ctypes.POINTER(ctypes.c_int16) * n)(*[
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for p in planes])
    lastdc_c = np.asarray(list(lastdc) + [0] * (4 - len(lastdc)),
                          dtype=np.int32)
    rst = np.ascontiguousarray(rst_cnt or [0], dtype=np.uint32)
    overhang_out = np.zeros(2, dtype=np.int32)
    newpos = lib.lepton_recode_rows(
        ctypes.byref(sc), tables, plane_ptrs, start_row, end_row,
        overhang_byte, num_overhang_bits,
        lastdc_c.ctypes.data_as(ctypes.c_void_p), padbit,
        rst.ctypes.data_as(ctypes.c_void_p), len(rst_cnt or []),
        int(rst_cnt_set), out.ctypes.data_as(ctypes.c_void_p),
        out_bound, out_pos, overhang_out.ctypes.data_as(ctypes.c_void_p))
    if newpos < 0:
        raise RuntimeError("native recode failed")
    return (int(newpos), int(overhang_out[0]), int(overhang_out[1]),
            lastdc_c.tolist())


class _HScanPrg(ctypes.Structure):
    _fields_ = [("cs_from", ctypes.c_int), ("cs_to", ctypes.c_int),
                ("cs_sah", ctypes.c_int), ("cs_sal", ctypes.c_int)]


def _prg_of(info) -> "_HScanPrg":
    sc = info.scan
    return _HScanPrg(sc.cs_from, sc.cs_to, sc.cs_sah, sc.cs_sal)


def native_decode_progressive_scan(info, huffdata: bytes, bitpos: int,
                                   offsets, planes, padbit: int, state,
                                   max_dpos, tables=None):
    """One progressive scan in C.  state: int32[5] = [mcu, dc0..3] (io).
    Returns (status, new_bitpos, handoff_records, padbit)."""
    lib = get_lib()
    sc = build_hscan(info)
    prg = _prg_of(info)
    if tables is None:
        tables = build_huff_tables(info)
    n = len(planes)
    plane_ptrs = (ctypes.POINTER(ctypes.c_int16) * n)(*[
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for p in planes])
    hpos = np.ascontiguousarray([o[0] for o in offsets], dtype=np.uint32)
    fpos = np.ascontiguousarray([o[1] for o in offsets], dtype=np.uint32)
    max_handoffs = info.cmpnfo[0].bcv + 16
    handoffs = np.zeros((max_handoffs, 8), dtype=np.int32)
    nhandoffs = ctypes.c_int32(0)
    padbit_c = ctypes.c_int32(padbit)
    bitpos_c = ctypes.c_int64(bitpos)
    md = np.asarray(max_dpos, dtype=np.int32)
    hbuf = np.frombuffer(huffdata, dtype=np.uint8)
    status = lib.lepton_decode_progressive_scan(
        hbuf.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(huffdata)),
        ctypes.byref(bitpos_c), ctypes.byref(sc), ctypes.byref(prg), tables,
        plane_ptrs,
        hpos.ctypes.data_as(ctypes.c_void_p),
        fpos.ctypes.data_as(ctypes.c_void_p), len(offsets),
        handoffs.ctypes.data_as(ctypes.c_void_p), ctypes.byref(nhandoffs),
        ctypes.byref(padbit_c), md.ctypes.data_as(ctypes.c_void_p),
        state.ctypes.data_as(ctypes.c_void_p))
    for i in range(4):
        max_dpos[i] = int(md[i])
    return status, bitpos_c.value, handoffs[:nhandoffs.value], padbit_c.value


def native_recode_any_scan(info, planes, jpegtype: int, padbit: int,
                           out_base: int, tables=None, sc=None):
    """Re-emit one scan; returns (scan_bytes, rstp_positions)."""
    lib = get_lib()
    if sc is None:
        sc = build_hscan(info)
    prg = _prg_of(info)
    if tables is None:
        tables = build_huff_tables(info)
    n = len(planes)
    plane_ptrs = (ctypes.POINTER(ctypes.c_int16) * n)(*[
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for p in planes])
    cap = sum(p.nbytes for p in planes) + (1 << 20)
    out = np.empty(cap, dtype=np.uint8)
    rstp_cap = ctypes.c_int32(1 << 20)
    rstp = np.zeros(1 << 20, dtype=np.uint32)
    n_rstp = ctypes.c_int32(0)
    nbytes = lib.lepton_recode_any_scan(
        ctypes.byref(sc), ctypes.byref(prg), jpegtype, tables, plane_ptrs,
        padbit, out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(cap),
        ctypes.c_int64(out_base),
        rstp.ctypes.data_as(ctypes.c_void_p), ctypes.byref(rstp_cap),
        ctypes.byref(n_rstp))
    if nbytes < 0:
        raise RuntimeError("native progressive recode failed")
    return out[:nbytes].tobytes(), rstp[:n_rstp.value].tolist()
