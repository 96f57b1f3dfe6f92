"""Minimal ctypes binding to the system brotli libraries.

Copy of lepton_tpu/container/brotli_ffi.py (:1-110), for the compressed
header blocks of containers v2 and above.  The reference links a vendored
brotli; this binds the system's libbrotlienc / libbrotlidec.  A host
library, not a kernel: nothing here runs on the card.
"""
from __future__ import annotations

import ctypes
import ctypes.util

_enc = None
_dec = None


def _load():
    global _enc, _dec
    if _dec is None:
        dec_name = ctypes.util.find_library("brotlidec") or "libbrotlidec.so.1"
        enc_name = ctypes.util.find_library("brotlienc") or "libbrotlienc.so.1"
        dec = ctypes.CDLL(dec_name)
        enc = ctypes.CDLL(enc_name)
        dec.BrotliDecoderDecompress.restype = ctypes.c_int
        enc.BrotliEncoderCompress.restype = ctypes.c_int
        enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
        enc.BrotliEncoderCreateInstance.restype = ctypes.c_void_p
        enc.BrotliEncoderCreateInstance.argtypes = [ctypes.c_void_p] * 3
        enc.BrotliEncoderSetParameter.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32]
        enc.BrotliEncoderCompressStream.restype = ctypes.c_int
        enc.BrotliEncoderCompressStream.argtypes = [ctypes.c_void_p,
            ctypes.c_int] + [ctypes.c_void_p] * 5
        enc.BrotliEncoderIsFinished.restype = ctypes.c_int
        enc.BrotliEncoderIsFinished.argtypes = [ctypes.c_void_p]
        enc.BrotliEncoderDestroyInstance.argtypes = [ctypes.c_void_p]
        _enc, _dec = enc, dec
    return _enc, _dec


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def decompress(data: bytes, max_size: int = 1 << 28) -> bytes:
    _, dec = _load()
    size = min(max(len(data) * 8, 1 << 20), max_size)
    while True:
        out = ctypes.create_string_buffer(size)
        out_len = ctypes.c_size_t(size)
        # 1 == BROTLI_DECODER_RESULT_SUCCESS
        rc = dec.BrotliDecoderDecompress(
            ctypes.c_size_t(len(data)), data, ctypes.byref(out_len), out)
        if rc == 1:
            return out.raw[:out_len.value]
        if size >= max_size:
            raise ValueError("brotli decompress failed")
        size *= 4


# BrotliEncoderParameter values (brotli/encode.h)
_PARAM_QUALITY = 1
_PARAM_LGWIN = 2
_PARAM_LGBLOCK = 3
_PARAM_SIZE_HINT = 5
_OP_PROCESS = 0
_OP_FINISH = 2


_QUALITY = 10


def compress(data: bytes, quality: int = _QUALITY) -> bytes:
    """Streaming encode with the reference's parameters, byte for byte:
    SIZE_HINT = len, quality 10 (11 for a -lepcat mega header,
    concat.cc:28-139), lgwin = bit_length(size) + 1 clamped to [10, 24],
    and LGBLOCK pinned to lgwin (BrotliCompression.cc:45-99; the one-shot
    BrotliEncoderCompress picks its own lgblock, which diverges on large
    headers).  Any other value gives a different container."""
    lgwin = max(10, min(24, len(data).bit_length() + 1))
    enc, _ = _load()
    st = enc.BrotliEncoderCreateInstance(None, None, None)
    if not st:
        raise ValueError("brotli encoder alloc failed")
    try:
        for param, value in ((_PARAM_SIZE_HINT, len(data)),
                             (_PARAM_QUALITY, quality),
                             (_PARAM_LGWIN, lgwin),
                             (_PARAM_LGBLOCK, lgwin)):
            enc.BrotliEncoderSetParameter(st, ctypes.c_int(param),
                                          ctypes.c_uint32(value))
        max_size = enc.BrotliEncoderMaxCompressedSize(
            ctypes.c_size_t(len(data))) or len(data) + 1024
        out = ctypes.create_string_buffer(max_size)
        avail_in = ctypes.c_size_t(len(data))
        next_in = ctypes.c_char_p(data)
        avail_out = ctypes.c_size_t(max_size)
        next_out = ctypes.cast(out, ctypes.c_void_p)
        total_out = ctypes.c_size_t(0)
        while True:
            op = _OP_FINISH if avail_in.value == 0 else _OP_PROCESS
            rc = enc.BrotliEncoderCompressStream(
                st, ctypes.c_int(op), ctypes.byref(avail_in),
                ctypes.byref(next_in), ctypes.byref(avail_out),
                ctypes.byref(next_out), ctypes.byref(total_out))
            if not rc:
                raise ValueError("brotli compress failed")
            if avail_in.value == 0 and enc.BrotliEncoderIsFinished(st):
                break
        return out.raw[:total_out.value]
    finally:
        enc.BrotliEncoderDestroyInstance(st)
