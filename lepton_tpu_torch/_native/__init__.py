"""ctypes bridge to the native host library (leptonc.c).

The port's own copy of the parts of lepton_tpu/_native/__init__.py that it
needs: build_hscan, build_huff_tables, native_decode_baseline_scan (Huffman
scan decode), native_recode_rows (Huffman re-emit, :300-332), and for
progressive and multi-scan JPEGs native_decode_progressive_scan and
native_recode_any_scan (:362-430); the host segment codec NativeImage
(:96-203: lepton_encode_segment, lepton_decode_segment and their _ans
forms), set_model_template (:483-500) and thread_arena_snapshot, which the
host codec (host.py) runs, the stream decoder StreamDecoder (:436-480) of
its O(width) decode, and native_symbolize_segment (:334-354) for -v2
billing; and the declarations of the seccomp jail's entry
points (leptonc.c:2912-3049), which util/sandbox.py calls.  The library is
built with gcc at first use into the build/ directory beside the package
(git ignores it); a library that cannot be built raises NativeUnavailable,
and the build is not tried again in this process.  LEPTONC_TORCH_SO names
another build of leptonc.c to load instead (the sanitizer build of
sanitize.py): it is loaded as it is, never built or checked against the
source's mtime.  The JAX package's LEPTONC_SO is not read, so a process
that holds both packages keeps the JAX library as the reference.  Where it cannot be
built, the host codec's compress and decompress code segments in Python
(host.py, codec/driver.py); every other caller raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..util import timing

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "leptonc.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
_SO = os.path.join(BUILD_DIR, "libleptonc_torch.so")
SO_ENV = "LEPTONC_TORCH_SO"

_lib = None
_failed = None        # the NativeUnavailable of a build that failed
_lock = threading.Lock()

# -injectsyscall= fault-injection points 2/4: issue a jail-banned syscall
# from inside the next segment encode/decode (jpgcoder.cc:1324)
inject_on_encode = False
inject_on_decode = False


class NativeUnavailable(Exception):
    pass


def _build() -> None:
    """Compile into a temporary file, then rename: concurrent first uses
    (test workers) never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with timing.span("build.leptonc"):
            for flags in (["-O3", "-march=native"], ["-O2"]):
                r = subprocess.run(["gcc", *flags, "-fPIC", "-shared", "-o",
                                    tmp, _SRC], capture_output=True,
                                   text=True)
                if r.returncode == 0:
                    os.replace(tmp, _SO)
                    return
        raise NativeUnavailable(f"gcc failed: {r.stderr[-2000:]}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    global _lib, _failed
    if _lib is not None:
        return _lib
    with _lock:
        if _failed is not None:
            raise _failed
        if _lib is None:
            so = os.environ.get(SO_ENV)
            if not so and (not os.path.exists(_SO)
                           or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                try:
                    _build()
                except (OSError, NativeUnavailable) as e:
                    _failed = NativeUnavailable(f"cannot build leptonc: {e}")
                    raise _failed
            lib = ctypes.CDLL(so or _SO)
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
            # the host segment codec (leptonc.c:1274-1546)
            lib.lepton_arena_size.argtypes = []
            lib.lepton_arena_size.restype = i
            lib.lepton_color_tables_size.argtypes = []
            lib.lepton_color_tables_size.restype = i
            lib.lepton_init_color.argtypes = [p, p]
            lib.lepton_init_color.restype = None
            lib.lepton_arena_template.argtypes = []
            lib.lepton_arena_template.restype = ctypes.POINTER(
                ctypes.c_uint8)
            seg = [p, p, p, p, p, i, i, p, p, i, i, i, p, i64]
            for name in ("lepton_encode_segment", "lepton_encode_segment_ans"):
                getattr(lib, name).argtypes = seg
                getattr(lib, name).restype = i64
            for name in ("lepton_decode_segment", "lepton_decode_segment_ans"):
                getattr(lib, name).argtypes = seg
                getattr(lib, name).restype = i
            # the host symbolizer, for -v2 billing (leptonc.c:2232)
            lib.lepton_symbolize_segment.argtypes = [
                p, p, p, p, p, i, i, p, p, i, i, i, p, p, i64]
            lib.lepton_symbolize_segment.restype = i64
            # the stream decoder (leptonc.c:1548-1604)
            lib.lepton_stream_decoder_create.argtypes = [
                p, p, p, p, p, i, i, p, p, i, i, i, p, i64]
            lib.lepton_stream_decoder_create.restype = p
            lib.lepton_stream_decoder_run.argtypes = [p, i]
            lib.lepton_stream_decoder_run.restype = i
            lib.lepton_stream_decoder_destroy.argtypes = [p]
            lib.lepton_stream_decoder_destroy.restype = None
            # the jail (leptonc.c:2912-3049)
            for name in ("lepton_install_jail", "lepton_install_jail_trap",
                         "lepton_install_jail_stage2",
                         "lepton_jail_supported"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            lib.lepton_prejail_heap.argtypes = [i64]
            lib.lepton_prejail_heap.restype = i
            for name in ("lepton_inject_syscall",
                         "lepton_inject_syscall_mmap"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = ctypes.c_long
            from ..model.tables import ARENA_SIZE
            if lib.lepton_arena_size() != ARENA_SIZE:
                raise NativeUnavailable("arena layout differs between "
                                        "leptonc.c and model/tables.py")
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


def build_hscan(info, row_masks=None) -> "_HScan":
    """The scan geometry for the C Huffman layer; row_masks (one a
    component) index ring-sized planes, as the streaming re-emit's are."""
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
        mask = row_masks[c] if row_masks else 0x7fffffff
        vals = [ci.bch, ci.bcv, ci.bc, ci.nch, ci.ncv, ci.mbs,
                ci.sfv, ci.sfh, ci.huffdc, ci.huffac, mask]
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


_tls = threading.local()


def _thread_arena() -> np.ndarray:
    """This thread's model arena, reused: the C codec sets it to the
    template at every segment start."""
    arena = getattr(_tls, "arena", None)
    if arena is None:
        from ..model.tables import ARENA_SIZE
        arena = np.empty(ARENA_SIZE * 3, dtype=np.uint8)
        _tls.arena = arena
    return arena


class NativeImage:
    """One image's planes and colour tables as the C segment codec's
    arguments (lepton_tpu/_native/__init__.py:96-203).  The planes are
    int16 [rows, blocks, 64] per component; encode reads them and decode
    fills the segment's rows of them in place."""

    def __init__(self, planes, qtables_raster, mcuv: int,
                 max_coded_heights, comp_sizes, heights=None):
        # heights: the components' logical heights, where the planes are
        # ring-sized windows (the streaming decode)
        lib = get_lib()
        self.lib = lib
        self.planes = [np.ascontiguousarray(pl, dtype=np.int16)
                       for pl in planes]
        n = len(self.planes)
        self.plane_ptrs = (ctypes.POINTER(ctypes.c_int16) * n)(*[
            pl.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))
            for pl in self.planes])
        self.widths = (ctypes.c_int32 * n)(*[pl.shape[1]
                                             for pl in self.planes])
        if heights is None:
            heights = [pl.shape[0] for pl in self.planes]
        self.heights = (ctypes.c_int32 * n)(*heights)
        self.comp_sizes = (ctypes.c_int32 * n)(*comp_sizes)
        self.max_heights = (ctypes.c_int32 * n)(*max_coded_heights)
        self.ncomp = n
        self.mcuv = mcuv
        ct_size = lib.lepton_color_tables_size()
        self.color_bufs = [ctypes.create_string_buffer(ct_size)
                           for _ in range(n)]
        for buf, q in zip(self.color_bufs, qtables_raster):
            qarr = np.ascontiguousarray(q, dtype=np.uint16)
            lib.lepton_init_color(buf, qarr.ctypes.data_as(ctypes.c_void_p))
        self.color_ptrs = (ctypes.c_void_p * n)(*[
            ctypes.cast(b, ctypes.c_void_p) for b in self.color_bufs])

    def _args(self):
        return (self.plane_ptrs, self.widths, self.heights, self.comp_sizes,
                self.max_heights, self.ncomp, self.mcuv, self.color_ptrs,
                _thread_arena().ctypes.data_as(ctypes.c_void_p))

    def _encode(self, fn, min_y: int, max_y: int, is_last: bool) -> bytes:
        global inject_on_encode
        if inject_on_encode:
            inject_on_encode = False
            self.lib.lepton_inject_syscall()
        cap = sum(pl.nbytes for pl in self.planes) + (1 << 20)
        out = np.empty(cap, dtype=np.uint8)
        n = fn(*self._args(), min_y, max_y, int(is_last),
               out.ctypes.data_as(ctypes.c_void_p), cap)
        if n == -3:
            raise ValueError("coefficient out of range")
        if n < 0:
            raise RuntimeError(f"native encode failed: {n}")
        return out[:n].tobytes()

    def _decode(self, fn, data: bytes, min_y: int, max_y: int,
                is_last: bool) -> None:
        global inject_on_decode
        if inject_on_decode:
            inject_on_decode = False
            self.lib.lepton_inject_syscall()
        buf = np.frombuffer(data, dtype=np.uint8)
        if fn(*self._args(), min_y, max_y, int(is_last),
              buf.ctypes.data_as(ctypes.c_void_p), len(data)):
            raise RuntimeError("native decode: stream inconsistent")

    def encode_segment(self, min_y: int, max_y: int, is_last: bool) -> bytes:
        """The VPX stream of luma rows [min_y, max_y) (containers v1, v2)."""
        return self._encode(self.lib.lepton_encode_segment, min_y, max_y,
                            is_last)

    def encode_segment_ans(self, min_y: int, max_y: int,
                           is_last: bool) -> bytes:
        """The rANS stream of luma rows [min_y, max_y) (container v3)."""
        return self._encode(self.lib.lepton_encode_segment_ans, min_y,
                            max_y, is_last)

    def decode_segment(self, data: bytes, min_y: int, max_y: int,
                       is_last: bool) -> None:
        self._decode(self.lib.lepton_decode_segment, data, min_y, max_y,
                     is_last)

    def decode_segment_ans(self, data: bytes, min_y: int, max_y: int,
                           is_last: bool) -> None:
        self._decode(self.lib.lepton_decode_segment_ans, data, min_y, max_y,
                     is_last)


def native_symbolize_segment(img: NativeImage, min_y: int, max_y: int,
                             is_last: bool):
    """(branch index, bit) symbol stream of one segment, as the segment
    coder would code it (lepton_tpu/_native/__init__.py:334-354)."""
    cap = 1 << 20
    while True:
        idx = np.empty(cap, dtype=np.int32)
        bit = np.empty(cap, dtype=np.uint8)
        n = img.lib.lepton_symbolize_segment(
            *img._args(), min_y, max_y, int(is_last),
            idx.ctypes.data_as(ctypes.c_void_p),
            bit.ctypes.data_as(ctypes.c_void_p), cap)
        if n < 0:
            raise RuntimeError("symbolize failed")
        if n <= cap:
            return idx[:n].copy(), bit[:n].copy()
        cap = int(n) + 1024


class StreamDecoder:
    """Resumable token decoder of one segment over ring-indexed planes
    (lepton_tpu/_native/__init__.py:436-480; the reference's 2-row
    memory-optimized decode, block_based_image.hh:52-121).  The caller
    owns the ring planes (through `img`) and the stream bytes; both must
    outlive the decoder."""

    def __init__(self, img: NativeImage, row_masks, min_y: int, max_y: int,
                 is_last: bool, data: bytes):
        lib = get_lib()
        self._lib = lib
        self._data = np.frombuffer(data, dtype=np.uint8)  # kept alive
        masks = np.asarray(list(row_masks) + [0x7FFFFFFF] * 4,
                           dtype=np.int32)[:4]
        self._masks = masks
        self._handle = lib.lepton_stream_decoder_create(
            img.plane_ptrs, img.widths, img.heights, img.comp_sizes,
            img.max_heights, img.ncomp, img.mcuv, img.color_ptrs,
            masks.ctypes.data_as(ctypes.c_void_p),
            min_y, max_y, int(is_last),
            self._data.ctypes.data_as(ctypes.c_void_p), len(data))
        if not self._handle:
            raise MemoryError("stream decoder alloc failed")

    def run(self, until_luma_y: int) -> int:
        """0: paused at until_luma_y; 1: the segment is done.  Raises on
        a corrupt stream (STREAM_INCONSISTENT)."""
        r = self._lib.lepton_stream_decoder_run(self._handle, until_luma_y)
        if r < 0:
            raise RuntimeError("native decode: stream inconsistent")
        return r

    def close(self) -> None:
        if self._handle:
            self._lib.lepton_stream_decoder_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def set_model_template(data) -> None:
    """Overwrite the start model of every host segment codec: ARENA_SIZE x
    (false count, true count, prob) bytes, or None for the identity model
    (lepton_tpu/_native/__init__.py:483-500; the process-global
    LEPTON_COMPRESSION_MODEL of the reference)."""
    from ..model.tables import ARENA_SIZE
    n = ARENA_SIZE * 3
    if data is None:
        ident = np.empty((ARENA_SIZE, 3), dtype=np.uint8)
        ident[:] = (1, 1, 128)
        data = ident.tobytes()
    if len(data) != n:
        raise ValueError(f"a model template is {n} bytes")
    ctypes.memmove(get_lib().lepton_arena_template(), data, n)


def thread_arena_snapshot() -> np.ndarray:
    """A copy of this thread's codec arena (the model after its last
    segment encode)."""
    return _thread_arena().copy()
