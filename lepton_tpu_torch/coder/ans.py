"""rANS entropy backend (format v3): the lane-friendly alternate coder.

Bit-exact port of the reference's experimental ANS backend:
  - 64-bit ryg rANS core (src/ans/rans64.hh)
  - two interleaved states over buffered (prob, bit) symbol pairs, encoded
    in reverse (src/vp8/encoder/ans_bool_writer.hh)
  - forward streaming decoder (src/vp8/decoder/ans_bool_reader.hh)

Key property (SURVEY.md section 2.4): rANS decouples modeling from
serialization -- the symbol stream with probabilities is computed first,
then serialized in a tight reverse pass, which is what makes the coder
batchable over a card's lanes (kernels/ans_coder.py).

The branch adaptation rule differs from the VPX path: ANS uses
adv_record_obs_and_update (branch.hh:66-80), which always ORs the
probability with 1 (a zero probability would break the rANS interval);
its one home in the port is model/branch.adv_update_branch, re-exported
here.

Copy of lepton_tpu/coder/ans.py (:1-141).  ANS_PARITY_TAIL lives here
alone; the card's rANS finalize (kernels/ans_coder.py) imports it.
"""
from __future__ import annotations

from typing import List

from ..model.branch import adv_update_branch  # noqa: F401

RANS64_L = 1 << 31
MASK32 = (1 << 32) - 1

# The reference's finish copies one word PAST what its encoder wrote
# (finish - pptr + 1, ans_bool_writer.hh:108-109), landing on the last
# nop pair's raw bytes -- every v3 encoder implementation (this one, the
# card's finalize in kernels/ans_coder.py, and ans_finish in leptonc.c)
# must append this same tail or interop silently diverges per backend.
ANS_PARITY_TAIL = b"\x00\x80\x00\x80"
MASK64 = (1 << 64) - 1
SCALE_BITS = 8


class ANSWriter:
    """Buffers (prob, bit) symbols; serializes in reverse on finish()."""

    __slots__ = ("pairs", "odd")

    def __init__(self):
        # each entry: [first_bit, first_prob, second_bit, second_prob]
        self.pairs: List[List[int]] = []
        self.odd = False

    def put_bit(self, bit: int, probability: int) -> None:
        if self.odd:
            self.pairs[-1][0] = bit
            self.pairs[-1][1] = probability
        else:
            # sentinel first symbol (True, prob 1) until the pair fills
            self.pairs.append([1, 1, bit, probability])
        self.odd = not self.odd

    def finish(self) -> bytes:
        pairs = self.pairs + [[0, 128, 0, 128]] * 8
        words: List[int] = []  # emitted backward; reversed at the end
        s1 = RANS64_L  # rans_pair.first
        s2 = RANS64_L  # rans_pair.second

        def enc_put(x: int, start: int, freq: int) -> int:
            x_max = ((RANS64_L >> SCALE_BITS) << 32) * freq
            if x >= x_max:
                words.append(x & MASK32)
                x >>= 32
            return ((x // freq) << SCALE_BITS) + (x % freq) + start

        # skip the last 4 nop pairs (ans_bool_writer.hh:83-88)
        for k in range(len(pairs) - 5, -1, -1):
            fb, fp, sb, sp = pairs[k]
            f_start = fp if fb else 0
            f_freq = (256 - fp) if fb else fp
            s_start = sp if sb else 0
            s_freq = (256 - sp) if sb else sp
            s1 = enc_put(s1, f_start, f_freq)
            s2 = enc_put(s2, s_start, s_freq)
        # flush first then second; each writes [hi, lo] moving backward
        words.append(s1 >> 32)
        words.append(s1 & MASK32)
        words.append(s2 >> 32)
        words.append(s2 & MASK32)
        out = bytearray()
        for w in reversed(words):
            out += int(w).to_bytes(4, "little")
        out += ANS_PARITY_TAIL
        return bytes(out)


class ANSReader:
    """Forward streaming decoder over a fully-buffered v3 stream."""

    __slots__ = ("words", "pos", "r0", "r1")

    def __init__(self, data: bytes):
        if len(data) % 4:
            data = data + b"\x00" * (4 - len(data) % 4)
        self.words = [int.from_bytes(data[i:i + 4], "little")
                      for i in range(0, len(data), 4)]
        # zero-fill like the reference's fill() on EOF
        self.words += [0] * 16
        self.pos = 0
        self.r0 = self._read_state()
        self.r1 = self._read_state()

    def _read_state(self) -> int:
        x = self.words[self.pos] | (self.words[self.pos + 1] << 32)
        self.pos += 2
        return x

    def get_bit(self, prob: int) -> int:
        x = self.r0
        self.r0 = self.r1
        cumulative = x & ((1 << SCALE_BITS) - 1)
        bit = 1 if cumulative >= prob else 0
        start = prob if bit else 0
        freq = (256 - prob) if bit else prob
        x = freq * (x >> SCALE_BITS) + cumulative - start
        if x < RANS64_L:
            if self.pos >= len(self.words):
                self.words.append(0)
            x = ((x << 32) | self.words[self.pos]) & MASK64
            self.pos += 1
        self.r1 = x
        return bit
