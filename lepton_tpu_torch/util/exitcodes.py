"""Process exit-code vocabulary, mirroring the reference's ExitCode enum
(src/vp8/util/memory.hh:13-40) so scripted callers observing exit statuses
see the same contract.  On any failure the CLI writes ZERO output bytes and
returns one of these codes (README.md:62-64).

Copy of lepton_tpu/util/exitcodes.py (83 lines), classify included."""
from __future__ import annotations

import enum


class ExitCode(enum.IntEnum):
    SUCCESS = 0
    ASSERTION_FAILURE = 1
    CODING_ERROR = 2
    SHORT_READ = 3
    UNSUPPORTED_4_COLORS = 4
    THREAD_PROTOCOL_ERROR = 5
    COEFFICIENT_OUT_OF_RANGE = 6
    STREAM_INCONSISTENT = 7
    PROGRESSIVE_UNSUPPORTED = 8
    FILE_NOT_FOUND = 9
    SAMPLING_BEYOND_TWO_UNSUPPORTED = 10
    SAMPLING_BEYOND_FOUR_UNSUPPORTED = 11
    THREADING_PARTIAL_MCU = 12
    VERSION_UNSUPPORTED = 13
    ONLY_GARBAGE_NO_JPEG = 14
    OS_ERROR = 33
    HEADER_TOO_LARGE = 34
    DIMENSIONS_TOO_LARGE = 35
    MALLOCED_NULL = 36
    OOM = 37
    TOO_MUCH_MEMORY_NEEDED = 38
    EARLY_EXIT = 40
    ROUNDTRIP_FAILURE = 41
    UNSUPPORTED_JPEG = 42
    UNSUPPORTED_JPEG_WITH_ZERO_IDCT_0 = 43
    COULD_NOT_BIND_PORT = 127


def classify(exc: BaseException) -> ExitCode:
    """Map an exception from the codec stack to the reference exit code."""
    msg = str(exc).lower()
    name = type(exc).__name__
    if isinstance(exc, FileNotFoundError):
        return ExitCode.FILE_NOT_FOUND
    if isinstance(exc, MemoryError):
        return ExitCode.OOM
    if isinstance(exc, OSError):
        return ExitCode.OS_ERROR
    if name == "UnsupportedJpeg":
        if "progressive" in msg:
            return ExitCode.PROGRESSIVE_UNSUPPORTED
        if "sampling factor beyond 2" in msg:
            return ExitCode.SAMPLING_BEYOND_TWO_UNSUPPORTED
        if "sampling factor beyond 4" in msg:
            return ExitCode.SAMPLING_BEYOND_FOUR_UNSUPPORTED
        if "4 colors" in msg or "four colors" in msg:
            return ExitCode.UNSUPPORTED_4_COLORS
        return ExitCode.UNSUPPORTED_JPEG
    if name == "JpegParseError":
        return ExitCode.UNSUPPORTED_JPEG
    if "roundtrip" in msg:
        return ExitCode.ROUNDTRIP_FAILURE
    if "progressive" in msg:
        return ExitCode.PROGRESSIVE_UNSUPPORTED
    if "stream" in msg and "inconsistent" in msg:
        return ExitCode.STREAM_INCONSISTENT
    if "coefficient" in msg and "range" in msg:
        return ExitCode.COEFFICIENT_OUT_OF_RANGE
    if "memory bound" in msg:
        return ExitCode.TOO_MUCH_MEMORY_NEEDED
    if "only garbage" in msg:
        return ExitCode.ONLY_GARBAGE_NO_JPEG
    if "unknown file type" in msg:
        # non-JPEG/non-lepton input without -permissive: the reference
        # fails its header parse and exits UNSUPPORTED_JPEG (measured on
        # empty and garbage inputs)
        return ExitCode.UNSUPPORTED_JPEG
    if "version" in msg:
        return ExitCode.VERSION_UNSUPPORTED
    if "short read" in msg or "truncated container" in msg or \
            "unexpected end" in msg:
        return ExitCode.SHORT_READ
    return ExitCode.CODING_ERROR
