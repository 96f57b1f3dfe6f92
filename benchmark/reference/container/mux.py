"""Stream multiplexing: interleave per-segment arithmetic streams.

Byte-exact reimplementation of Sirikata::MuxWriter / MuxReader
(reference src/io/MuxReader.hh): 3-byte headers (stream-id nibble +
LE16(len-1)) or 1-byte continuation codes for 4K/16K/64K blocks, with the
writer's lag-bounded flush scheduling, plus the encoder's priming schedule
(256B -> 4KB -> 64KB per stream, vp8_encoder.cc:576-594).

Verbatim copy of lepton_tpu/container/mux.py: the port keeps its own host layers.
"""
from __future__ import annotations

from typing import List

from ..constants import MUX_EOF_MARKER, MUX_MAX_STREAM_ID

MIN_OFFSET = 3
MAX_BUFFER_LAG = 65537


class MuxWriter:
    def __init__(self, version: int = 1):
        self.out = bytearray()
        self.version = version
        self.buffers: List[bytearray] = [bytearray()
                                         for _ in range(MUX_MAX_STREAM_ID)]
        self.offsets = [0] * MUX_MAX_STREAM_ID
        self.flushed = [0] * MUX_MAX_STREAM_ID
        self.total_written = 0
        self.low_water_mark = [0] * MUX_MAX_STREAM_ID

    @staticmethod
    def _high_water_mark(flushed: int) -> int:
        if flushed & 0xFFFFC000:
            return 65536
        if flushed & 0xFFFFF000:
            return 16384
        return 4096

    def _flush_full(self, sid: int, to_flush: int) -> None:
        if to_flush == 0:
            return
        buf = self.buffers[sid]
        while to_flush > 0:
            offset = self.offsets[sid]
            to_write = min(to_flush, 65536)
            self.out.append(sid)
            self.out += (to_write - 1).to_bytes(2, "little")
            self.out += buf[offset: offset + to_write]
            self.total_written += to_write
            self.flushed[sid] += to_write
            self.offsets[sid] = offset + to_write
            to_flush -= to_write
        self.offsets[sid] = MIN_OFFSET
        del buf[MIN_OFFSET:]
        self.low_water_mark[sid] = self.total_written

    def _flush_partial(self, sid: int, to_flush: int) -> None:
        if to_flush < 4096:
            return self._flush_full(sid, to_flush)
        if to_flush < 16384:
            if to_flush > 8192:
                return self._flush_full(sid, to_flush)
            length = 4096
            code = sid | (1 << 4)
        elif to_flush < 65536:
            if to_flush > 32768:
                return self._flush_full(sid, to_flush)
            length = 16384
            code = sid | (2 << 4)
        else:
            if to_flush > 131072:
                return self._flush_full(sid, to_flush)
            length = 65536
            code = sid | (3 << 4)
        buf = self.buffers[sid]
        to_write = 0
        while to_write + length <= to_flush:
            offset = self.offsets[sid]
            if offset == len(buf):
                to_write += length
                continue
            self.out.append(code)
            self.out += buf[offset: offset + length]
            self.total_written += length
            self.flushed[sid] += length
            self.offsets[sid] = offset + length
            if self.offsets[sid] > 65539:
                del buf[MIN_OFFSET:self.offsets[sid]]
                self.offsets[sid] = MIN_OFFSET
            to_write += length
        delta = len(buf) - self.offsets[sid]
        if delta > self.total_written:
            self.low_water_mark[sid] = 0
        else:
            self.low_water_mark[sid] = self.total_written - delta

    def _flush(self, stream_id: int) -> None:
        for i in range(MUX_MAX_STREAM_ID):
            to_flush = len(self.buffers[i]) - self.offsets[i]
            if i == stream_id or not to_flush:
                continue
            urgent = self.total_written - self.low_water_mark[i] \
                > MAX_BUFFER_LAG
            if to_flush < 4096:
                if urgent:
                    self._flush_full(i, to_flush)
            else:
                if urgent and to_flush < 16384:
                    self._flush_full(i, to_flush)
                else:
                    self._flush_partial(i, to_flush)
        self._flush_partial(stream_id,
                            len(self.buffers[stream_id])
                            - self.offsets[stream_id])

    def write(self, sid: int, data) -> int:
        buf = self.buffers[sid]
        if len(buf) == 0:
            buf += b"\x00" * MIN_OFFSET
            self.offsets[sid] = MIN_OFFSET
        buf += data
        hwm = self._high_water_mark(self.flushed[sid])
        if len(buf) >= self.offsets[sid] + hwm:
            self._flush(sid)
        return len(data)

    def close(self) -> bytes:
        for i in range(MUX_MAX_STREAM_ID):
            pending = len(self.buffers[i]) - self.offsets[i]
            if pending:
                self._flush_full(i, pending)
        if self.version > 1:
            self.out += MUX_EOF_MARKER
        return bytes(self.out)


def mux_streams(streams: List[bytes], version: int = 1) -> bytes:
    """The encoder's priming interleave (vp8_encoder.cc:576-594):
    256B, then 4KB, then 64KB round-robin per stream."""
    w = MuxWriter(version)
    offsets = [0] * len(streams)
    any_written = True
    while any_written:
        any_written = False
        for i, s in enumerate(streams):
            if len(s) > offsets[i]:
                any_written = True
                if offsets[i] == 0:
                    max_written = 256
                elif offsets[i] == 256:
                    max_written = 4096
                else:
                    max_written = 65536
                n = min(max_written, len(s) - offsets[i])
                offsets[i] += w.write(i, s[offsets[i]: offsets[i] + n])
    return w.close()


class MuxReader:
    """Demultiplex a mux stream back into per-stream byte buffers."""

    def __init__(self, data: bytes, num_streams: int = MUX_MAX_STREAM_ID):
        self.buffers = [bytearray() for _ in range(MUX_MAX_STREAM_ID)]
        pos = 0
        n = len(data)
        while pos + 3 <= n:
            header = data[pos: pos + 3]
            if header == MUX_EOF_MARKER:
                pos += 3
                break
            sid = header[0] & 0xF
            flags = (header[0] >> 4) & 3
            if flags == 0:
                length = header[2] * 0x100 + header[1] + 1
                pos += 3
                self.buffers[sid] += data[pos: pos + length]
                pos += length
            else:
                length = 1024 << (2 * flags)
                pos += 1
                self.buffers[sid] += data[pos: pos + length]
                pos += length
        self.end_pos = pos
