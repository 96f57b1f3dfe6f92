"""Randomized soak of the port on the card, and hostile inputs straight
into its kernels.

Port of tools/soak.py.  Seeded random JPEGs sweep the encoder's parameter
space (gen_case: RGB, L and CMYK, 1 to 400 px a side, quality 1 to 100,
subsampling, optimized tables, restart intervals 1 to 8, progressive, 1
to 16 threads, even splits, container versions 1 to 3, 16-bit DQTs), and
each case is checked:

1. the card's encode (batch_compress_device with the case's version,
   segments, allow_progressive and allow_four_colors) writes the .lep
   bytes of the host codec's compress on the same settings, and the
   card's decode gives the JPEG back (a case drawn with even_split also
   decodes the host's even-split .lep on the card);
2. three random truncations of the .lep (tools/soak.py:155-171) decode
   on the card (batch_decompress_device(per_request=True)) to the host
   decompress's outcome: the same failure, or the same bytes.  The full
   original comes back from a cut container only where the host's decode
   of the same cut gives it too: a cut that drops only the trailing size
   field and stream bytes that the readers reproduce at end of stream
   (tools/soak.py:160-165); such cuts are counted (full_from_cut);
3. three random bit flips past the fixed header (:172-187), held to the
   same rule, and any output at most len(jpeg) + 65536 bytes;
4. one sampled auxiliary path (:244-300) through the host layer and,
   where it has one, the card's entry point: streaming decode,
   concatenated decode, UJG, the permissive wrapper (host and card), a
   truncated JPEG (host and card, both ways) and a -startbyte slice (the
   card refuses the mode-Y container it makes, by design).

Cases are batched as a server sees them: every case of one container
version goes through one batch_compress_device call, and every .lep with
its hostile variants through one batch_decompress_device(per_request=True)
call, so mixed geometries and corrupt lanes sit side by side in one
launch of each kernel.  A seeded tenth of the cases also goes through
compress_device and decompress_device alone.  Every case is rebuilt from
(seed, index): its draws come from random.Random(seed * 1000003 + index)
in tools/soak.py's order.

The oracle is the port's own C host codec (host.compress,
host.decompress; no torch).  tools/soak.py's check_reference (:188-243),
a byte comparison with the reference C++ binary, is not ported: the port
has no reference binary.

Each check has an outcome class: ok (the card and the host agree on the
bytes), inconsistent (both refuse a stream the decoder flags), handoff_
mismatch_shared (both re-emits fail with "handoff mismatch", which a
corrupt stream gives; the JAX package gives it on a truncated
multi-segment JPEG too, which the port decodes: host._reemit_handoffs),
rejected_parse (both refuse the input before any segment decodes or
codes: the container, its header or the JPEG), rejected_recode (both
re-emits refuse what a corrupt stream decoded to, for another reason)
and failed (anything else, or any
disagreement with the host codec).  A failed case's JPEG, params.json and
a repro command go under --out.

Hostile inputs (hostile_readers, hostile_coders), for phase 17 of
chip_smoke.py and the tests: random VPX bytes and rANS words of lengths
0, 1, 7 and LMAX, an empty lane beside full ones and a lane cut
mid-block, through vpx_decoder.decode_lanes; lanes of 0 and 1 symbols
beside long ones and lanes of one branch, at 1, 64 and 2048 lanes,
through both coders.  On the card each is held against its plain version
and launched twice for bitwise equality; a good file decodes afterwards.

Run: python -m lepton_tpu_torch.soak --n N --seed S [--device cuda|cpu]
[--out DIR] [--hostile-only].  It soaks the --n cases, then, on the
card, the MULTI_SEGMENTS cases (gen_multi_case: JPEGs sized to code 2 to
8 segments; every case above is one segment, a JPEG under 125,000 bytes
of scan data codes one).  It runs on the card unless --device cpu is
given (and raises without one), and exits 0 when every check passes, 1
otherwise.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import random
import sys
import time

import numpy as np

from . import host
from .container.format import read_container
from .host import REQUEST_ERRORS
from .jpeg.progressive import ProgressiveError
from .jpeg.recoder import RecodeError

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "soak_failures")
CLASSES = ("ok", "inconsistent", "handoff_mismatch_shared", "rejected_parse",
           "rejected_recode", "failed")
FLIP_FROM = 30              # past the fixed header (tools/soak.py:176)
FLIP_SLACK = 1 << 16        # bound on a flipped container's output growth
LMAX = 96                   # the longest hostile reader stream, bytes/words
MULTI_SEGMENTS = (2, 4, 6, 8)   # the multi-segment cases, by segments


# ---------------------------------------------------------------------------
# Case generation: copies of tools/soak.py:52-145
# ---------------------------------------------------------------------------


def gen_image(rng: random.Random, w: int, h: int, mode: str, kind=None):
    """kind: None draws it (tools/soak.py's draws), else that kind."""
    from PIL import Image
    nrng = np.random.default_rng(rng.randrange(1 << 31))
    if kind is None:
        kind = rng.choice(["gradient", "noise", "flat", "blocks", "mixed"])
    if kind == "flat":
        ch = np.full((h, w), rng.randrange(256), np.uint8)
    elif kind == "noise":
        ch = nrng.integers(0, 256, size=(h, w), dtype=np.uint8)
    elif kind == "blocks":
        bs = rng.choice([4, 8, 16])
        small = nrng.integers(0, 256,
                              size=(h // bs + 1, w // bs + 1), dtype=np.uint8)
        ch = np.kron(small, np.ones((bs, bs), np.uint8))[:h, :w]
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        base = (xx * 255 / max(w, 1) + yy * 255 / max(h, 1)) / 2
        noise = nrng.normal(0, rng.uniform(0, 48), size=(h, w))
        ch = np.clip(base + noise, 0, 255).astype(np.uint8)
    if mode == "L":
        return Image.fromarray(ch, "L")
    arr = np.stack([ch, np.roll(ch, 7, 0), np.roll(ch, 13, 1)], axis=-1)
    img = Image.fromarray(arr, "RGB")
    return img.convert(mode) if mode != "RGB" else img


def gen_case(rng: random.Random, max_side=None) -> dict:
    """Draw one (image params, save params, codec params) triple.
    max_side caps each side after the draw (the tests' small soak); the
    draws stay those of tools/soak.py."""
    mode = rng.choices(["RGB", "L", "CMYK"], weights=[6, 2, 1])[0]
    w = rng.choice([1, 2, 7, 8, 9, 15, 16, 17, 31, 64, 65,
                    rng.randrange(1, 400), rng.randrange(1, 400)])
    h = rng.choice([1, 2, 7, 8, 9, 15, 16, 17, 31, 64, 65,
                    rng.randrange(1, 400), rng.randrange(1, 400)])
    if max_side:
        w, h = min(w, max_side), min(h, max_side)
    save = {"quality": rng.choice([1, 5, 25, 50, 75, 85, 95, 100,
                                   rng.randrange(1, 101)])}
    if mode == "RGB":
        save["subsampling"] = rng.randrange(3)
    if rng.random() < 0.4:
        save["optimize"] = True
    if rng.random() < 0.3:
        save["restart_marker_blocks"] = rng.randrange(1, 9)
    progressive = rng.random() < 0.3 and mode != "CMYK"
    if progressive:
        save["progressive"] = True
    codec = {
        "max_threads": rng.choice([1, 2, 4, 8, 16]),
        "even_split": rng.random() < 0.2,
        "version": rng.choices([1, 2, 3], weights=[5, 2, 3])[0],
        "allow_progressive": progressive,
        "allow_four_colors": mode == "CMYK",
    }
    return {"mode": mode, "w": w, "h": h, "save": save, "codec": codec,
            "dqt16": rng.random() < 0.1}


def segment_bytes(segments: int) -> int:
    """The scan bytes from which choose_num_threads (container/handoff.py,
    jpgcoder.cc:3898-3916) lets a JPEG code `segments` segments."""
    return 125_000 if segments <= 2 else 250_000 if segments <= 4 \
        else 500_000


def gen_multi_case(rng: random.Random, segments: int) -> dict:
    """Draw a baseline case that codes `segments` (2 to 8) segments:
    RGB or L noise, quality 85 to 100, subsampling, optimized tables,
    restarts, versions 1 to 3, even splits; its side is found by
    make_multi_jpeg.  (A progressive file takes its handoffs from its DC
    scans, whose few bytes code one segment.)"""
    if not 2 <= segments <= 8:
        raise ValueError(f"{segments} segments: 2 to 8")
    mode = rng.choice(["RGB", "L"])
    save = {"quality": rng.choice([85, 90, 95, 100])}
    if mode == "RGB":
        save["subsampling"] = rng.randrange(3)
    if rng.random() < 0.4:
        save["optimize"] = True
    if rng.random() < 0.3:
        save["restart_marker_blocks"] = rng.randrange(1, 9)
    codec = {
        "max_threads": segments,
        "even_split": rng.random() < 0.2,
        "version": rng.choices([1, 2, 3], weights=[5, 2, 3])[0],
        "allow_progressive": False,
        "allow_four_colors": False,
    }
    return {"mode": mode, "w": 0, "h": 0, "save": save, "codec": codec,
            "dqt16": False, "kind": "noise", "segments": segments}


def _codes_segments(data: bytes, segments: int) -> int:
    """The segments host.compress(max_threads=segments) cuts data into."""
    from .container.handoff import choose_num_threads
    _, _, dec = host._parse(data)
    fb = dec.handoffs[-1].segment_size - dec.handoffs[0].segment_size
    return choose_num_threads(len(dec.handoffs), fb, segments, 1)


def make_multi_jpeg(case: dict, rng: random.Random) -> bytes:
    """The JPEG of a gen_multi_case case at the smallest square side, a
    multiple of 16, at which it codes case["segments"] segments, searched
    in steps of 16 from an estimate made at 128 px; sets w and h.  Every
    try draws its pixels from the same seed."""
    seed = rng.randrange(1 << 31)
    want = case["segments"]

    def make(side):
        case["w"] = case["h"] = side
        return make_jpeg(case, random.Random(seed))

    side = 128 * (segment_bytes(want) / len(make(128))) ** 0.5
    side = max(16, int(side) // 16 * 16)
    while _codes_segments(make(side), want) != want:
        side += 16
    while side > 16 and _codes_segments(make(side - 16), want) == want:
        side -= 16
    return make(side)


def rewrite_dqt_16bit(data: bytes) -> bytes:
    """Re-encode every 8-bit DQT segment as 16-bit (same values, so scan
    data stays valid): the Pq=1 parse, which PIL never emits."""
    out = bytearray()
    pos = 0
    while pos < len(data) - 1:
        if data[pos] == 0xFF and data[pos + 1] == 0xDB:
            ln = (data[pos + 2] << 8) | data[pos + 3]
            seg = data[pos + 4:pos + 2 + ln]
            new = bytearray()
            i = 0
            while i < len(seg):
                pq_tq = seg[i]
                if pq_tq >> 4 != 0:   # already 16-bit; keep as-is
                    new += seg[i:i + 129]
                    i += 129
                    continue
                new.append(0x10 | (pq_tq & 0x0F))
                for v in seg[i + 1:i + 65]:
                    new += bytes([0, v])
                i += 65
            out += b"\xff\xdb" + (len(new) + 2).to_bytes(2, "big") + new
            pos += 2 + ln
        else:
            out.append(data[pos])
            pos += 1
    out.append(data[-1])
    return bytes(out)


def make_jpeg(case: dict, rng: random.Random) -> bytes:
    img = gen_image(rng, case["w"], case["h"], case["mode"],
                    case.get("kind"))
    buf = io.BytesIO()
    img.save(buf, "JPEG", **case["save"])
    data = buf.getvalue()
    if case.get("dqt16"):
        data = rewrite_dqt_16bit(data)
    return data


class Case:
    """One soak case, rebuilt from (base seed, index): its params, its
    JPEG (None where PIL refused the combination) and the Random that
    draws its truncations, flips and auxiliary path, in that order.
    segments: a multi-segment case of that many segments
    (gen_multi_case), drawn from the same Random."""

    def __init__(self, base_seed: int, index: int, max_side=None,
                 segments=None):
        self.index = index
        self.seed = base_seed * 1_000_003 + index
        self.rng = random.Random(self.seed)
        if segments:
            self.params = gen_multi_case(self.rng, segments)
            self.jpeg = make_multi_jpeg(self.params, self.rng)
            return
        self.params = gen_case(self.rng, max_side)
        try:
            self.jpeg = make_jpeg(self.params, self.rng)
        except (OSError, ValueError):
            self.jpeg = None

    @property
    def codec(self) -> dict:
        return self.params["codec"]

    def host_kw(self, even_split: bool = False) -> dict:
        """host.compress's settings of the card's encode of this case."""
        return dict(self.codec, even_split=even_split)

    def device_kw(self) -> dict:
        c = self.codec
        return dict(num_segments=c["max_threads"], version=c["version"],
                    allow_progressive=c["allow_progressive"],
                    allow_four_colors=c["allow_four_colors"])


# ---------------------------------------------------------------------------
# Outcomes
# ---------------------------------------------------------------------------


def attempt(fn, *args, errors=Exception, **kw):
    """fn's bytes, or the exception it raised (one of `errors`).  The host
    codec's outcome on a corrupt input may be any exception: it is the
    oracle's answer.  The card's entry points are asked only for
    REQUEST_ERRORS; anything else they raise is a fault of the card and
    goes through."""
    try:
        return fn(*args, **kw)
    except errors as e:
        return e


def describe(r) -> str:
    if isinstance(r, (bytes, bytearray)):
        return f"{len(r)} bytes"
    return f"{type(r).__name__}: {str(r)[:160]}"


def _failure_kind(e: Exception):
    msg = str(e)
    if "inconsistent" in msg:
        return "inconsistent"
    if "handoff mismatch" in msg:
        return "handoff_mismatch_shared"
    return None


def judge(card, oracle) -> tuple:
    """(class, detail) of the card's outcome against the host's: bytes and
    equal, or both failures of one kind.  A failure of no named kind is
    rejected_recode where the host's re-emit raised it, else
    rejected_parse."""
    cb, ob = (isinstance(r, (bytes, bytearray)) for r in (card, oracle))
    if cb and ob:
        if bytes(card) == bytes(oracle):
            return "ok", ""
        return "failed", (f"bytes differ: card {len(card)}, host "
                          f"{len(oracle)}")
    if cb or ob:
        return "failed", f"card {describe(card)}; host {describe(oracle)}"
    kc, ko = _failure_kind(card), _failure_kind(oracle)
    if kc != ko:
        return "failed", f"card {describe(card)}; host {describe(oracle)}"
    if kc:
        return kc, describe(card)
    recode = isinstance(oracle, (RecodeError, ProgressiveError))
    return ("rejected_recode" if recode else "rejected_parse"), describe(card)


class Report:
    """Outcome counts by class and by check, the failures, and timings."""

    def __init__(self):
        self.counts = dict.fromkeys(CLASSES, 0)
        self.by_check = {}
        self.failures = []          # (case index, check, detail)
        self.cases = 0
        self.skipped = 0
        self.full_from_cut = 0      # cut containers that gave the original
        self.segments = {}          # segments of a card .lep: cases
        self.kinds = {}             # version / mode / components: cases
        self.seconds = {}
        self.launches = {}
        self.leps = {}              # case index: the card's .lep

    def add(self, case, check: str, cls: str, detail: str = "") -> None:
        self.counts[cls] += 1
        per = self.by_check.setdefault(check, {})
        per[cls] = per.get(cls, 0) + 1
        if cls == "failed":
            self.failures.append((case.index, check, detail))

    @property
    def failed(self) -> int:
        return self.counts["failed"]

    def summary(self) -> dict:
        return dict(cases=self.cases, skipped=self.skipped,
                    counts=self.counts, full_from_cut=self.full_from_cut,
                    by_check=self.by_check, segments=self.segments,
                    kinds=self.kinds, seconds=self.seconds,
                    launches=self.launches)


# ---------------------------------------------------------------------------
# The soak
# ---------------------------------------------------------------------------


def _launches() -> dict:
    from .serve import _launches as launches
    return launches()


def _encode_all(cases, dev, report, log) -> dict:
    """Step 1's encodes: the host's .lep of each case (the oracle), then
    the card's, one batch_compress_device call a container version.
    Returns {case index: .lep} of the cases both encoded equally."""
    from . import api
    want = {c.index: attempt(host.compress, c.jpeg, **c.host_kw())
            for c in cases}
    leps = {}
    for version in (1, 2, 3):
        group = [c for c in cases if c.codec["version"] == version]
        good = [c for c in group
                if isinstance(want[c.index], (bytes, bytearray))]
        for c in group:
            if c not in good:
                # the host refuses it: the card must refuse it alone too
                got = attempt(api.compress_device, c.jpeg, device=dev,
                              errors=REQUEST_ERRORS, **c.device_kw())
                report.add(c, "encode", *judge(got, want[c.index]))
        if not good:
            continue
        try:
            outs = api.batch_compress_device(
                [c.jpeg for c in good],
                num_segments=[c.codec["max_threads"] for c in good],
                device=dev, version=version,
                allow_progressive=any(c.codec["allow_progressive"]
                                      for c in good),
                allow_four_colors=any(c.codec["allow_four_colors"]
                                      for c in good))
        except REQUEST_ERRORS as e:
            log(f"soak: the v{version} batch refused a JPEG the host "
                f"encodes ({describe(e)}); encoding its cases one at a time")
            outs = [attempt(api.compress_device, c.jpeg, device=dev,
                            errors=REQUEST_ERRORS, **c.device_kw())
                    for c in good]
        for c, got in zip(good, outs):
            cls, detail = judge(got, want[c.index])
            report.add(c, "encode", cls, detail)
            if cls == "ok":
                leps[c.index] = bytes(got)
    return leps


def _hostile_variants(case, lep: bytes) -> list:
    """tools/soak.py's three truncations, then its three bit flips, drawn
    from the case's Random in its order: [(check, blob, detail)]."""
    out = []
    for _ in range(3):
        cut = case.rng.randrange(1, len(lep))
        out.append(("truncate", lep[:cut], f"cut at {cut}"))
    for _ in range(3):
        pos = case.rng.randrange(FLIP_FROM, len(lep))
        bit = case.rng.randrange(8)
        flipped = bytearray(lep)
        flipped[pos] ^= 1 << bit
        out.append(("bitflip", bytes(flipped), f"bit {bit} of byte {pos}"))
    return out


def _decode_all(cases, leps, dev, report) -> None:
    """Steps 1 to 3's decodes: every .lep, each case's even-split .lep
    and every hostile variant in one batch_decompress_device(per_request=
    True) call, each held to the host decompress."""
    from . import api
    jobs = []           # (case, check, blob, detail)
    for c in cases:
        if c.index not in leps:
            continue
        lep = leps[c.index]
        jobs.append((c, "roundtrip", lep, ""))
        if c.codec["even_split"]:
            even = host.compress(c.jpeg, **c.host_kw(even_split=True))
            jobs.append((c, "even_split", even, ""))
        jobs += [(c, check, blob, detail)
                 for check, blob, detail in _hostile_variants(c, lep)]
    if not jobs:
        return
    outs = api.batch_decompress_device([b for _, _, b, _ in jobs],
                                       device=dev, per_request=True)
    for (c, check, blob, detail), got in zip(jobs, outs):
        if check in ("roundtrip", "even_split"):
            ok = isinstance(got, (bytes, bytearray)) and got == c.jpeg
            report.add(c, check, "ok" if ok else "failed",
                       "" if ok else f"card {describe(got)}")
            continue
        want = attempt(host.decompress, blob)
        cls, why = judge(got, want)
        if cls == "ok" and check == "truncate" and got == c.jpeg:
            # the readers zero-fill at the end of a stream, as the
            # reference's do, so a cut that drops only the trailing size
            # field and stream bytes that end of stream reproduces gives
            # the original back (tools/soak.py:160-165); the host's
            # independent decode of the same cut has given it too
            report.full_from_cut += 1
        if cls == "ok" and check == "bitflip" \
                and len(got) > len(c.jpeg) + FLIP_SLACK:
            cls, why = "failed", f"unbounded output, {len(got)} bytes"
        report.add(c, check, cls, f"{detail}: {why}" if why else detail)


def _singles(cases, leps, dev, report, seed: int) -> None:
    """A seeded tenth of the encoded cases through compress_device and
    decompress_device alone: the batch's bytes and the JPEG back."""
    from . import api
    done = sorted(leps)
    pick = random.Random(seed).sample(done, max(1, len(done) // 10)) \
        if done else []
    by_index = {c.index: c for c in cases}
    for i in pick:
        c = by_index[i]
        lep = attempt(api.compress_device, c.jpeg, device=dev,
                      errors=REQUEST_ERRORS, **c.device_kw())
        report.add(c, "single", *judge(lep, leps[i]))
        back = attempt(api.decompress_device, leps[i], device=dev,
                       errors=REQUEST_ERRORS)
        report.add(c, "single", *judge(back, c.jpeg))


def _aux(case, lep: bytes, dev, report) -> None:
    """One sampled auxiliary path (tools/soak.py:244-300)."""
    from . import api
    data, rng = case.jpeg, case.rng
    draw = rng.random()
    if draw < 0.25:
        got = attempt(host.decompress_streaming, lep)
        report.add(case, "aux_streaming", *judge(got, data))
    elif draw < 0.40:
        got = attempt(host.decompress_all, lep + lep)
        report.add(case, "aux_concatenated", *judge(got, data + data))
    elif draw < 0.55:
        ujg = attempt(host.ujg_compress, data,
                      allow_progressive=case.codec["allow_progressive"])
        got = ujg if isinstance(ujg, Exception) else attempt(
            host.ujg_decompress, ujg)
        report.add(case, "aux_ujg", *judge(got, data))
    elif draw < 0.70:
        blob = bytes(rng.randrange(256)
                     for _ in range(rng.randrange(0, 2048)))
        wrapped = host.compress_any(blob, permissive=True, verify=True)
        card = attempt(host.compress_any, blob, permissive=True, verify=True,
                       engine="device", device=dev, errors=REQUEST_ERRORS)
        cls, why = judge(card, wrapped)
        if cls == "ok":
            cls, why = judge(attempt(host.decompress, wrapped), blob)
        report.add(case, "aux_permissive", cls, why)
    elif draw < 0.85:
        # a truncated JPEG: where the cut still encodes, the early-EOF
        # bookkeeping gives the cut bytes back, on the card and the host
        cut = rng.randrange(len(data) // 2, len(data))
        trunc = data[:cut]
        want = attempt(host.compress, trunc, **case.host_kw())
        card = attempt(api.compress_device, trunc, device=dev,
                       errors=REQUEST_ERRORS, **case.device_kw())
        cls, why = judge(card, want)
        if cls == "ok":
            back = attempt(api.decompress_device, card, device=dev,
                           errors=REQUEST_ERRORS)
            cls, why = judge(back, attempt(host.decompress, want))
            if cls == "ok" and back != trunc:
                cls, why = "failed", "the cut JPEG does not come back"
        report.add(case, "aux_truncated_jpeg", cls,
                   f"cut at {cut}: {why}" if why else "")
    else:
        # a -startbyte slice through the verifying wrapper: a verified
        # slice decodes to the tail; the card refuses its mode-Y container
        sb = rng.randrange(1, len(data))
        slep = attempt(host.compress_any, data, verify=True, start_byte=sb,
                       **case.codec)
        if isinstance(slep, Exception):
            report.add(case, "aux_startbyte", "rejected_parse", describe(slep))
            return
        cls, why = judge(attempt(host.decompress, slep), data[sb:])
        card = attempt(api.decompress_device, slep, device=dev,
                       errors=REQUEST_ERRORS)
        if cls == "ok" and not (isinstance(card, host.LeptonError)
                                and "mode-Y" in str(card)):
            cls, why = "failed", f"the card's mode-Y decode: {describe(card)}"
        report.add(case, "aux_startbyte", cls,
                   f"start byte {sb}: {why}" if why else "")


def hostile_containers(leps, jpegs, device="cuda", seed: int = 0) -> Report:
    """Steps 2 and 3 on given containers and their JPEGs (chip_smoke.py
    gives the main path's 16-segment files): each .lep and its three
    truncations and three bit flips, drawn as run() draws a case's from
    random.Random(seed * 1000003 + index), in one batch_decompress_device(
    per_request=True) call, held to the host decompress.  Returns the
    Report."""
    from types import SimpleNamespace

    from . import api
    report = Report()
    cases = [SimpleNamespace(index=i, jpeg=jpeg, codec={"even_split": False},
                             rng=random.Random(seed * 1_000_003 + i))
             for i, jpeg in enumerate(jpegs)]
    report.cases = len(cases)
    _decode_all(cases, dict(enumerate(leps)), api._device(device), report)
    return report


def _save(case, report, out: str, argv: str) -> str:
    stem = os.path.join(out, f"case_{case.seed}")
    os.makedirs(stem, exist_ok=True)
    with open(os.path.join(stem, "source.jpg"), "wb") as f:
        f.write(case.jpeg or b"")
    fails = [(chk, d) for i, chk, d in report.failures if i == case.index]
    with open(os.path.join(stem, "params.json"), "w") as f:
        json.dump({"index": case.index, "seed": case.seed,
                   "params": case.params, "failures": fails}, f, indent=1)
    with open(os.path.join(stem, "repro.txt"), "w") as f:
        f.write(f"python -m lepton_tpu_torch.soak {argv}  # case "
                f"{case.index}\n")
    return stem


def run(n: int, seed: int = 0, device="cuda", out=DEFAULT_OUT,
        max_side=None, log=print, multi=()) -> Report:
    """Soak n cases from `seed` on `device` (the card unless "cpu"), then
    one multi-segment case for each segment count in `multi` (indices n,
    n + 1, ...; each must code exactly that many segments, on the card as
    on the host); returns the Report.  A failed case is saved under `out`
    (None: not saved).  Raises what the card raises that no request
    causes."""
    from . import api
    dev = api._device(device)
    report = Report()
    before = _launches()
    t = time.perf_counter()
    cases = [Case(seed, i, max_side) for i in range(n)] + [
        Case(seed, n + k, segments=m) for k, m in enumerate(multi)]
    report.skipped = sum(c.jpeg is None for c in cases)
    cases = [c for c in cases if c.jpeg is not None]
    report.cases = len(cases)
    for c in cases:
        key = (f"v{c.codec['version']} "
               f"{'X' if c.codec['allow_progressive'] else 'Z'} "
               f"{c.params['mode']}")
        report.kinds[key] = report.kinds.get(key, 0) + 1
    report.seconds["make"] = time.perf_counter() - t
    t = time.perf_counter()
    leps = report.leps = _encode_all(cases, dev, report, log)
    report.seconds["encode"] = time.perf_counter() - t
    for c in cases:
        if c.index not in leps:
            continue
        k = len(read_container(leps[c.index])[0].handoffs)
        report.segments[k] = report.segments.get(k, 0) + 1
        want = c.params.get("segments")
        if want:
            report.add(c, "segments", "ok" if k == want else "failed",
                       "" if k == want else f"{k} segments, not {want}")
    t = time.perf_counter()
    _decode_all(cases, leps, dev, report)
    report.seconds["decode"] = time.perf_counter() - t
    t = time.perf_counter()
    _singles(cases, leps, dev, report, seed)
    for c in cases:
        if c.index in leps:
            _aux(c, leps[c.index], dev, report)
    report.seconds["singles_aux"] = time.perf_counter() - t
    after = _launches()
    report.launches = {k: after[k] - before[k] for k in after}
    if out and report.failures:
        argv = f"--n {n} --seed {seed} --device {dev.type}"
        for c in cases:
            if any(i == c.index for i, _, _ in report.failures):
                stem = _save(c, report, out, argv)
                log(f"soak: FAIL case {c.index} saved in {stem}")
    return report


# ---------------------------------------------------------------------------
# Hostile inputs straight into the kernels
# ---------------------------------------------------------------------------


def tiny_container(version: int) -> bytes:
    """A 16x64 grayscale JPEG in four segments of two block rows, each
    two blocks wide, encoded by the plain coders: the geometry of the
    hostile reader batches."""
    from PIL import Image

    from . import api
    from .kernels import batch_encode
    rng = np.random.default_rng(5)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (64, 16), dtype=np.uint8),
                    "L").save(buf, "JPEG", quality=90)
    parsed, info, dec = api._parse(buf.getvalue())
    splits = [dec.handoffs[y] for y in (0, 2, 4, 6)]
    desc = api._describe(info, dec, splits)
    streams = batch_encode.encode_images_device([desc], version,
                                                device="cpu")[0]
    return api._container(parsed, dec, splits, len(splits), streams, version)


def hostile_requests(coder: str, seed: int = 0) -> list:
    """Two (container, request) pairs of tiny_container's geometry, eight
    lanes of at most two rows: random streams of 0, 1, 7 and LMAX bytes
    (VPX) or words (rANS), and the container's own streams with lane 1
    empty and lane 3 cut mid-block."""
    from . import api
    rng = np.random.default_rng(seed)
    lep = tiny_container(3 if coder == "ans" else 1)
    req = api._decode_request(lep)[0]
    unit = 4 if coder == "ans" else 1
    noise = dict(req, streams=[rng.integers(0, 256, n * unit, np.uint8)
                               .tobytes() for n in (0, 1, 7, LMAX)])
    s = req["streams"]
    own = dict(req, streams=[s[0], b"", s[2], s[3][:len(s[3]) // 2]])
    return [(lep, noise), (lep, own)]


def noise_requests(leps, coder: str, seed: int = 0) -> list:
    """(container, request) pairs of the given containers (of `coder`'s
    versions) with every stream replaced by random bytes, lane lengths
    cycling through 0, 1, 7, LMAX and the stream's own: the soak's mixed
    geometries with hostile lanes."""
    from . import api
    rng = np.random.default_rng(seed)
    unit = 4 if coder == "ans" else 1
    out, k = [], 0
    for lep in leps:
        req = api._decode_request(lep)[0]
        streams = []
        for s in req["streams"]:
            n = (0, 1, 7, LMAX, len(s) // unit)[k % 5] * unit
            streams.append(rng.integers(0, 256, n, np.uint8).tobytes())
            k += 1
        out.append((lep, dict(req, streams=streams)))
    return out


def host_lanes(lep: bytes, streams) -> tuple:
    """The host codec's C segment decoder (leptonc.c) on `streams` in
    place of the container's segments: (coef int16 [S, blocks, 64], the
    request's planes flattened in component order, one copy a lane; err
    int32 [S]).  Each lane decodes into zeroed planes of its own: the C
    decoder stops at a lane's first inconsistency, the kernel flags it and
    goes on, so only lanes that both decode whole compare block by
    block."""
    from .jpeg.imageinfo import image_info_from_header
    hdr, mux = read_container(lep)
    info = image_info_from_header(hdr.hdrdata, allow_34=True)
    heights, comp_sizes = host._truncation_geometry(info, hdr)
    handoffs, _ = host._handoffs(hdr, mux, info)
    shapes = [(info.cmpnfo[c].bcv, info.cmpnfo[c].bch)
              for c in range(info.cmpc)]
    coef = np.zeros((len(streams), sum(h * w for h, w in shapes), 64),
                    np.int16)
    err = np.zeros(len(streams), np.int32)
    for k, data in enumerate(streams):
        planes = [np.zeros((h, w, 64), np.int16) for h, w in shapes]
        img = host._native_image(info, planes, heights, comp_sizes)
        last = k == len(handoffs) - 1
        end = info.cmpnfo[0].bcv if last else handoffs[k + 1].luma_y_start
        decode = img.decode_segment_ans if hdr.version == 3 \
            else img.decode_segment
        try:
            decode(data, handoffs[k].luma_y_start, end, last)
        except RuntimeError:        # "native decode: stream inconsistent"
            err[k] = 1
        coef[k] = np.concatenate([p.reshape(-1, 64) for p in img.planes])
    return coef, err


def past_cut_lanes(version: int = 1) -> tuple:
    """An early-EOF container whose cut leaves rows inside the coded
    height but past their component's size limit, with streams coded by
    the host's C segment coder from its planes after block 0 of each such
    row was made non-zero: (lep, the decode request with those streams,
    [(component, row)] of the rows past the limit).  The host codes and
    decodes block 0 of such a row (leptonc.c process_row); a reader must
    do the same.  A 64x64 4:2:0 JPEG cut to three fifths of its bytes, in
    two segments, as container `version`."""
    from PIL import Image

    from . import api
    rng = np.random.default_rng(3)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
        buf, "JPEG", quality=80, subsampling=2)
    cut = buf.getvalue()[:len(buf.getvalue()) * 3 // 5]
    lep = host.compress(cut, max_threads=2, min_threads=2, version=version)
    hdr, mux = read_container(lep)
    _, info, dec = host._parse(cut)
    heights, sizes = host._truncation_geometry(info, hdr)
    handoffs, _ = host._handoffs(hdr, mux, info)
    planes = [p.copy() for p in dec.planes]
    past = []
    for c in range(info.cmpc):
        W = info.cmpnfo[c].bch
        for y in range(heights[c]):
            if sizes[c] <= y * W:
                planes[c][y, 0, :3] = (5 + y, -2, 1)
                past.append((c, y))
    img = host._native_image(info, planes, heights, sizes)
    enc = img.encode_segment_ans if version == 3 else img.encode_segment
    bounds = [th.luma_y_start for th in handoffs] + [info.cmpnfo[0].bcv]
    req = api._decode_request(lep)[0]
    req["streams"] = [enc(bounds[k], bounds[k + 1], k == len(handoffs) - 1)
                      for k in range(len(handoffs))]
    return lep, req, past


def host_diffs(plan, pairs, coef, err) -> list:
    """Lanes of `plan` (made from `pairs`' requests, in order) whose err
    flag differs from the host's C segment decoder's on the same stream,
    or, where neither flags, whose blocks differ."""
    bad = []
    lane_request = np.asarray(plan.lane_request)
    for r, (lep, req) in enumerate(pairs):
        lanes = np.flatnonzero(lane_request == r)
        hcoef, herr = host_lanes(lep, req["streams"])
        base = plan.planes[r][0][0]
        for k, s in enumerate(lanes.tolist()):
            blocks = plan.owned_blocks(s, s + 1)
            if int(err[s] != 0) != int(herr[k]) or (
                    not herr[k] and not np.array_equal(
                        coef[blocks], hcoef[k][blocks - base])):
                bad.append(s)
    return bad


def _decode_twice(plan, dev):
    """Two launches of one plan on `dev`, on the host: ((coef, err),
    equal bitwise)."""
    from .kernels import vpx_decoder
    a = [t.cpu().numpy() for t in vpx_decoder.decode_lanes(**plan.to(dev))]
    b = [t.cpu().numpy() for t in vpx_decoder.decode_lanes(**plan.to(dev))]
    return a, all(np.array_equal(x, y) for x, y in zip(a, b))


def _lane_diffs(plan, coef, err, want_coef, want_err) -> list:
    """Lanes whose err flag or blocks differ from the plain reader's."""
    bad = []
    for s in range(len(plan.lanes)):
        blocks = plan.owned_blocks(s, s + 1)
        if int(err[s]) != int(want_err[s]) or not np.array_equal(
                coef[blocks], want_coef[blocks]):
            bad.append(s)
    return bad


def hostile_readers(device="cuda", soak_leps=(), seed: int = 0) -> dict:
    """Item 2's reader batches on `device`, for each reader: the tiny
    hostile requests, held against the plain reader on the CPU lane by
    lane; the soak's containers with noise streams; each batch launched
    twice and held bitwise equal, and held against the host's C segment
    decoder lane by lane.  Then a synchronise, and a good file decoded
    back.  Raises AssertionError on any difference.  Returns {reader:
    {tiny_lanes, tiny_flagged, wide_lanes, wide_flagged}}: each batch's
    lanes and the lanes it flagged inconsistent."""
    import torch

    from . import api
    from .kernels import vpx_decoder
    dev = api._device(device)
    out = {}
    for coder in ("vpx", "ans"):
        stats = {}
        wide = [lep for lep in soak_leps if (lep[2] == 3) == (coder == "ans")]
        for name, pairs in (("tiny", hostile_requests(coder, seed)),
                            ("wide", noise_requests(wide, coder, seed))):
            if not pairs:
                stats.update({f"{name}_lanes": 0, f"{name}_flagged": 0})
                continue
            plan = vpx_decoder.plan_decode([r for _, r in pairs], coder)
            (coef, err), same = _decode_twice(plan, dev)
            if not same:
                raise AssertionError(f"{coder} reader, {name} hostile batch: "
                                     "two launches differ")
            if name == "tiny":
                want_coef, want_err = (t.numpy() for t in
                                       vpx_decoder.decode_lanes(
                                           **plan.to("cpu")))
                bad = _lane_diffs(plan, coef, err, want_coef, want_err)
                if bad:
                    raise AssertionError(
                        f"{coder} reader: lanes {bad} of the tiny hostile "
                        "batch differ from the plain reader")
            bad = host_diffs(plan, pairs, coef, err)
            if bad:
                raise AssertionError(
                    f"{coder} reader: lanes {bad[:8]} of the {name} hostile "
                    "batch differ from the host's C segment decoder")
            stats.update({f"{name}_lanes": len(err),
                          f"{name}_flagged": int((err != 0).sum())})
        out[coder] = stats
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    good = tiny_container(1)
    if api.decompress_device(good, device=dev) != host.decompress(good):
        raise AssertionError("a good file does not decode after the "
                             "hostile batches")
    return out


def hostile_segments(lanes: int, long: int, seed: int = 0) -> list:
    """(idx, bit) lists of `lanes` coder lanes, in turn: a long lane of
    random branches with heavy reuse, an empty lane, one symbol, and a
    long lane whose every symbol uses one branch."""
    from .model.tables import ARENA_SIZE
    rng = np.random.default_rng(seed)
    out = []
    for s in range(lanes):
        kind = s % 4
        if kind == 0:
            idx = rng.integers(0, ARENA_SIZE, long)
            reuse = rng.random(long) < 0.7
            idx[reuse] = idx[rng.integers(0, 32, int(reuse.sum()))]
        elif kind == 1:
            idx = np.zeros(0, np.int64)
        elif kind == 2:
            idx = rng.integers(0, ARENA_SIZE, 1)
        else:
            idx = np.full(long, int(rng.integers(0, ARENA_SIZE)))
        out.append((idx.tolist(), rng.integers(0, 2, len(idx)).tolist()))
    return out


def coder_lanes(segments, framed: bool):
    """(idx int32 [S, L], bit uint8 [S, L], nsyms int32 [S]) numpy lanes:
    framed VPX lanes (marker bit, 32 stop bits) or unframed rANS lanes."""
    from .kernels import vpx_coder
    if framed:
        idx, bit = vpx_coder.build_symbol_streams(segments)
        return idx, bit, np.full(len(idx), idx.shape[1], np.int32)
    L = max([len(i) for i, _ in segments] + [1])
    idx = np.full((len(segments), L), vpx_coder.PAD, np.int32)
    bit = np.zeros((len(segments), L), np.uint8)
    for s, (i, b) in enumerate(segments):
        idx[s, :len(i)] = i
        bit[s, :len(b)] = b
    return idx, bit, np.asarray([len(i) for i, _ in segments], np.int32)


CODER_SHAPES = ((1, 3000), (64, 3000), (2048, 300))   # (lanes, long lane)


def hostile_coders(device="cuda", seed: int = 0) -> dict:
    """The hostile coder lanes on `device` at each (lanes, long lane) of
    CODER_SHAPES (1, 64 and 2048 lanes): the wrappers' streams (the
    kernels on the card) against the plain stages chained
    (branch_probs_plain, then the plain walk), and the wrappers run
    twice, bitwise equal.  Raises AssertionError on any difference.
    Returns {"vpx S" / "ans S": most stream bytes of a lane}."""
    import torch

    from . import api
    from .kernels import ans_coder, vpx_coder
    from .kernels import branch_probs as bp
    dev = api._device(device)
    out = {}
    for lanes, long in CODER_SHAPES:
        segments = hostile_segments(lanes, long, seed)
        for name, framed in (("vpx", True), ("ans", False)):
            idx, bit, nsyms = (torch.as_tensor(a, device=dev)
                               for a in coder_lanes(segments, framed))
            if framed:
                got = [vpx_coder.finalize(*vpx_coder.encode_streams(idx, bit))
                       for _ in range(2)]
                want = vpx_coder.finalize(*vpx_coder.vpx_walk_plain(
                    idx, bit, bp.branch_probs_plain(idx, bit)[0]))
            else:
                got = [ans_coder.finalize_ans(*ans_coder.encode_streams_ans(
                    idx, bit, nsyms)) for _ in range(2)]
                want = ans_coder.finalize_ans(*ans_coder.ans_walk_plain(
                    bp.branch_probs_plain(idx, bit, rule="adv",
                                          nsyms=nsyms)[0], bit, nsyms))
            if got[0] != got[1]:
                raise AssertionError(f"{name} coder, {lanes} lanes: two "
                                     "launches differ")
            if got[0] != want:
                bad = [s for s, (a, b) in enumerate(zip(got[0], want))
                       if a != b]
                raise AssertionError(f"{name} coder, {lanes} lanes: lanes "
                                     f"{bad[:8]} differ from the plain "
                                     "stages")
            out[f"{name} {lanes}"] = max(len(b) for b in got[0])
    return out


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, the plain versions")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="where failed cases are saved")
    ap.add_argument("--hostile-only", action="store_true",
                    help="only the hostile kernel batches, over the first "
                         "--n cases' containers")
    args = ap.parse_args(argv)
    t = time.perf_counter()
    if args.hostile_only:
        leps = []
        for i in range(args.n):
            c = Case(args.seed, i)
            lep = c.jpeg and attempt(host.compress, c.jpeg, **c.host_kw())
            if isinstance(lep, (bytes, bytearray)):
                leps.append(bytes(lep))
        readers = hostile_readers(args.device, leps, args.seed)
        coders = hostile_coders(args.device, args.seed)
        print(f"soak: hostile readers {readers}; coders {coders} in "
              f"{time.perf_counter() - t:.1f} s")
        return 0
    # the plain coder and reader take minutes on a multi-segment case's
    # scan, so the CPU soaks the --n cases alone
    report = run(args.n, args.seed, args.device, args.out,
                 multi=MULTI_SEGMENTS if args.device != "cpu" else ())
    print(f"soak: {json.dumps(report.summary())}")
    for i, check, detail in report.failures:
        print(f"soak: FAIL case {i} {check}: {detail}", file=sys.stderr)
    print(f"soak: {report.cases} cases, {report.skipped} skipped, "
          f"{report.failed} failed checks in {time.perf_counter() - t:.1f} s")
    return 1 if report.failed else 0


if __name__ == "__main__":
    sys.exit(main())
