"""ISO/IEC 10918-1 (ITU-T T.81) Annex D binary arithmetic coder ("QM coder").

The reference ships this as a third, dormant entropy backend
(src/vp8/model/JpegArithmeticCoder.{hh,cc}, adapted there from
libjpeg-turbo's j[cd]arith.c; its BoolEncoder wiring in
src/vp8/encoder/bool_encoder.hh:33-37 is commented out and no container
format selects it).  We implement it from the T.81 Annex D flowcharts for
backend parity: same dormancy, same byte streams.

Each coding context is one byte of state: bits 0-6 index the probability
estimation state machine (Table D.3), bit 7 is the current MPS.  The
encoder performs the ENCODE / RENORME / BYTEOUT procedures (D.1.4-D.1.6)
with "Pacman" termination (shortest spec-compliant stream, trailing zeros
discarded); the decoder performs DECODE / RENORMD (D.2.4-D.2.6) with the
JPEG marker convention (an 0xFF followed by a non-zero byte stops the
stream and supplies zero data thereafter).

Copy of lepton_tpu/coder/jpeg_arith.py (:1-271), which is cross-validated
byte for byte against the reference's own (dormant) implementation
compiled as an oracle (tests/test_jpeg_arith.py); the port's copy is held
against it (tests/test_torch_jpeg_arith.py).  Nothing in the port calls
it: like the reference's, it is dormant.
"""
from __future__ import annotations

# Table D.3 probability estimation state machine: Qe value, next state
# after an LPS, next state after an MPS, and whether an LPS toggles the
# MPS sense.  Entry 113 is the fixed ~0.5 estimate recommended by
# ITU-T T.851 section 10.3 (no adaptation).  Format-mandated constants.
_D3 = (
    # (qe, next_lps, next_mps, switch)
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080B, 18, 4, 0), (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0),
    (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 36, 16, 0), (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0),
    (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0CEF, 43, 21, 0),
    (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01B1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0),
    (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0),
    (0x2EF1, 67, 40, 0), (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0),
    (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0),
    (0x04DE, 50, 52, 0), (0x040F, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0), (0x01F8, 54, 57, 0),
    (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0),
    (0x008F, 61, 32, 0), (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0),
    (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0), (0x2FE8, 83, 69, 0),
    (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119C, 74, 76, 0), (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0),
    (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0),
    (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0),
    (0x3C3D, 104, 100, 0), (0x375E, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0), (0x415E, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)

NUM_STATES = len(_D3)  # 114: Table D.3 plus the T.851 fixed state


class JpegBoolWriter:
    """QM-coder encoder over a growable byte buffer.

    `put_bit(bit, states, idx)` codes one binary decision against the
    context byte `states[idx]` (mutating it per the estimation state
    machine).  `finish()` terminates per D.1.8 and returns the stream.
    """

    __slots__ = ("c", "a", "ct", "_pending", "_stacked_ff", "_zeros", "buf")

    def __init__(self):
        self.c = 0
        self.a = 0x10000
        self.ct = 11           # 3 spacer bits + 8 before the first BYTEOUT
        self._pending = -1     # last byte withheld for carry resolution
        self._stacked_ff = 0   # run of 0xFF bytes awaiting carry resolution
        self._zeros = 0        # run of 0x00 bytes withheld (Pacman)
        self.buf = bytearray()

    # -- byte output ---------------------------------------------------

    def _flush_zeros(self) -> None:
        if self._zeros:
            self.buf.extend(b"\x00" * self._zeros)
            self._zeros = 0

    def _emit_pending_plus_carry(self) -> None:
        """A carry rippled out of the C register: bump the withheld byte,
        convert any stacked 0xFF bytes to 0x00."""
        if self._pending >= 0:
            self._flush_zeros()
            b = self._pending + 1
            self.buf.append(b)
            if b == 0xFF:
                self.buf.append(0x00)  # JPEG 0xFF stuffing
        self._zeros += self._stacked_ff
        self._stacked_ff = 0

    def _emit_pending(self) -> None:
        """No carry possible any more: release the withheld byte and any
        stacked 0xFF bytes (each stuffed with 0x00)."""
        if self._pending == 0:
            self._zeros += 1
        elif self._pending >= 0:
            self._flush_zeros()
            self.buf.append(self._pending)
        if self._stacked_ff:
            self._flush_zeros()
            self.buf.extend(b"\xff\x00" * self._stacked_ff)
            self._stacked_ff = 0

    def _byteout(self) -> None:
        t = self.c >> 19
        if t > 0xFF:
            self._emit_pending_plus_carry()
            self._pending = t & 0xFF
        elif t == 0xFF:
            self._stacked_ff += 1
        else:
            self._emit_pending()
            self._pending = t
        self.c &= 0x7FFFF
        self.ct += 8

    # -- coding --------------------------------------------------------

    def put_bit(self, bit: int, states: bytearray, idx: int) -> None:
        sv = states[idx]
        qe, nl, nm, switch = _D3[sv & 0x7F]
        mps = sv >> 7
        self.a -= qe
        if bool(bit) != bool(mps):
            # LPS path (with conditional MPS/LPS exchange)
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            states[idx] = ((mps ^ switch) << 7) | nl
        else:
            # MPS path
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            states[idx] = (mps << 7) | nm
        while True:  # RENORME
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        """FLUSH per D.1.8 + Discard_final_zeros (D.15)."""
        t = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = t + 0x8000 if t < self.c else t
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._emit_pending_plus_carry()
        else:
            self._emit_pending()
        self._pending = -1
        if self.c & 0x7FFF800:       # final bytes, unless all zero
            self._flush_zeros()
            b = (self.c >> 19) & 0xFF
            self.buf.append(b)
            if b == 0xFF:
                self.buf.append(0x00)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self.buf.append(b)
                if b == 0xFF:
                    self.buf.append(0x00)
        return bytes(self.buf)


class JpegBoolReader:
    """QM-coder decoder over an in-memory stream.

    Reading past the end of the data (or into a JPEG marker) supplies
    zero bytes, per the T.81 convention for arithmetic scans.
    """

    __slots__ = ("data", "pos", "c", "a", "ct", "_marker")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.c = 0
        self.a = 0
        self.ct = -16          # prime two bytes before the first decision
        self._marker = False

    def _next_byte(self) -> int:
        if self._marker:
            return 0
        n = len(self.data)
        if self.pos >= n:
            self._marker = True
            return 0
        b = self.data[self.pos]
        self.pos += 1
        if b != 0xFF:
            return b
        # 0xFF: swallow fill bytes, then either a stuffed zero (data is
        # a literal 0xFF) or a marker (zero data from here on)
        while self.pos < n and self.data[self.pos] == 0xFF:
            self.pos += 1
        if self.pos < n and self.data[self.pos] == 0x00:
            self.pos += 1
            return 0xFF
        self._marker = True
        return 0

    def get_bit(self, states: bytearray, idx: int) -> int:
        # RENORMD / BYTEIN (D.2.6).  C is never shifted during renorm;
        # `ct` tracks how far the interval registers have outrun it, and
        # the DECODE comparison aligns with `temp << ct` (the jdarith.c
        # register scheme, after Kuhn's JBIG implementation).
        while self.a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                self.c = ((self.c << 8) | self._next_byte()) & 0xFFFFFFFF
                self.ct += 8
                if self.ct < 0:        # still priming the register
                    self.ct += 1
                    if self.ct == 0:   # two bytes in: interval goes live
                        self.a = 0x8000
            self.a <<= 1

        # DECODE with conditional MPS/LPS exchange (D.2.4, D.2.5)
        sv = states[idx]
        qe, nl, nm, switch = _D3[sv & 0x7F]
        mps = sv >> 7
        self.a -= qe
        aligned = self.a << self.ct
        if self.c >= aligned:
            self.c -= aligned
            # upper subinterval: LPS, unless the exchange applies
            if self.a < qe:
                self.a = qe
                states[idx] = (mps << 7) | nm
                return mps
            self.a = qe
            states[idx] = ((mps ^ switch) << 7) | nl
            return mps ^ 1
        if self.a < 0x8000:
            # lower subinterval with renorm pending: MPS, unless exchanged
            if self.a < qe:
                states[idx] = ((mps ^ switch) << 7) | nl
                return mps ^ 1
            states[idx] = (mps << 7) | nm
        return mps


def initial_states(n: int) -> bytearray:
    """Fresh context bank: state 0, MPS 0 for every context."""
    return bytearray(n)
