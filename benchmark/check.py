"""Whether what the window's calls produced is right.

Run after the window has closed and the program's state is freed.  Every
number compared is a count with the limit 0:

  raised         outputs of calls that raised
  host_route     outputs of calls that took the host's Python segment codec
  plain          outputs of calls on the card in which a kernel that the
                 configuration's path needs (its "kernels", by what the
                 call makes) did not launch
  wrong_jpeg     decoded JPEGs that differ from the JPEG the benchmark made
                 (every one the window returned)
  bad_container  .lep outputs that do not read as a container of their
                 JPEG in the configuration's version and in the mode the
                 JPEG calls for (size, header segments, trailer, one
                 stream a segment; every one; container_problem)
  unstable_lep   .lep outputs of an image that differ from its first
  wrong_lep      .lep outputs that differ, byte for byte, from the plain
                 reference's .lep (reference/encode.py) with its sampled
                 lanes: every image is parsed and Huffman-decoded by the
                 reference (its progressive scans too, where the
                 configuration allows them), which writes the container's
                 header, and
                 `reference_lanes` of its segments, drawn from the seed,
                 are coded by the reference; the output's other segments
                 are muxed in as they are.  `reference_images`, where the
                 traffic sets it, draws that many images (the largest
                 among them) in place of every one.  The reference runs on
                 a pool of processes.

control=True puts the control in the program's place before the
comparison: in each .lep the sampled segments coded by the reference with
7-bit probabilities, and for each decoded JPEG the lossy transcode of it
(PIL, the configuration's quality), which break the lossless guarantee of
the configuration.
"""
from __future__ import annotations

import io
import multiprocessing
import os
import random
import sys
from typing import Dict, List

from .reference import encode as ref
from .reference.container.format import read_container
from .reference.container.mux import MuxReader
from .spec import allow_progressive

LIMITS = {"raised": 0, "host_route": 0, "plain": 0, "wrong_jpeg": 0,
          "bad_container": 0, "unstable_lep": 0, "wrong_lep": 0}


def _segments(jpeg: bytes):
    """(marker, bytes) of each marker segment of a JPEG after its SOI, in
    order, up to its EOI or its end.  An SOS segment's bytes are its
    header alone: the scan's entropy-coded bytes after it run to the next
    0xFF that is followed by neither 0x00 (a stuffed byte) nor a restart
    marker, and are cut out."""
    pos, n = 2, len(jpeg)
    while pos + 4 <= n and jpeg[pos] == 0xFF and jpeg[pos + 1] != 0xD9:
        end = pos + 2 + int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        yield jpeg[pos + 1], jpeg[pos:end]
        if jpeg[pos + 1] == 0xDA:
            end = jpeg.find(b"\xff", end)
            while 0 <= end < n - 1 and (jpeg[end + 1] == 0
                                        or 0xD0 <= jpeg[end + 1] <= 0xD7):
                end = jpeg.find(b"\xff", end + 2)
            if end < 0:
                return
        pos = end


def header_segments(jpeg: bytes) -> bytes:
    """The marker segments of a JPEG after its SOI, in order, with each
    scan's entropy-coded bytes cut out (_segments)."""
    return b"".join(seg for _, seg in _segments(jpeg))


def jpeg_mode(jpeg: bytes) -> str:
    """The container mode that a JPEG's .lep has, by the rule of the
    reference's decode_scans (is_baseline, as the port's): "Z" where the
    frame is not progressive (SOF2) and every scan holds all the frame's
    components (at most 4), "X" otherwise: a progressive file, or a
    baseline one of more than one scan."""
    frame, scans = None, []
    for marker, seg in _segments(jpeg):
        if 0xC0 <= marker <= 0xC2 and frame is None:
            frame = seg
        elif marker == 0xDA:
            scans.append(seg[4])
    if frame is None or frame[1] == 0xC2:
        return "X"
    return "Z" if all(ns == min(frame[9], 4) for ns in scans) else "X"


def container_problem(lep: bytes, jpeg: bytes, num_segments: int,
                      version: int = 1) -> str:
    """Why `lep` is not a container of `jpeg` of this version, in the mode
    the JPEG calls for (jpeg_mode), cut into at most num_segments
    segments, or "" where it is.

    The header segments: in mode Z (one baseline scan) the container's
    are the JPEG's bytes from after its SOI, as a prefix; in mode X
    (progressive or multi-scan) they are every marker segment of the JPEG
    with each scan's entropy-coded bytes cut out (header_segments), as the
    parse stores them (jpeg/parser.py keeps every segment up to the EOI,
    the SOS of each scan and the tables between scans among them)."""
    try:
        hdr, mux = read_container(lep)
        streams = [b for b in MuxReader(mux).buffers if b]
    except Exception as e:
        return f"does not read: {type(e).__name__}: {e}"
    mode = jpeg_mode(jpeg)
    if hdr.version != version or hdr.mode != ord(mode):
        return (f"version {hdr.version} mode {chr(hdr.mode)!r}, not "
                f"{version} {mode!r}")
    if hdr.original_size != len(jpeg):
        return f"original size {hdr.original_size}, not {len(jpeg)}"
    if not (jpeg[2:].startswith(hdr.hdrdata) if mode == "Z"
            else hdr.hdrdata == header_segments(jpeg)):
        return "header segments differ from the JPEG's"
    if not jpeg.endswith(hdr.garbage):
        return "trailer differs from the JPEG's"
    if not (1 <= hdr.num_threads <= num_segments
            and len(hdr.handoffs) == hdr.num_threads == len(streams)):
        return (f"{hdr.num_threads} threads, {len(hdr.handoffs)} handoffs, "
                f"{len(streams)} streams")
    return ""


def lanes_of(lep: bytes) -> list:
    """The coded streams (lanes) of a .lep, in segment order, by its mux;
    None where it does not read."""
    try:
        hdr, mux = read_container(lep)
        return MuxReader(mux).buffers[:hdr.num_threads]
    except Exception:
        return None


def pick_lanes(num_lanes: int, n: int, seed: int, image: int) -> list:
    """n of an image's segments, drawn from the seed."""
    rng = random.Random(f"{seed}/{image}")
    return sorted(rng.sample(range(num_lanes), min(n, num_lanes)))


def reference_lanes(jpegs: Dict[int, bytes], num_segments: int,
                    lanes: int, seed: int, masks=(ref.FULL_PRECISION,),
                    workers: int = None,
                    allow_progressive: bool = False) -> dict:
    """{image: (analysis, {(segment, mask): stream})} from the plain
    reference, on a pool of spawned processes: one job an image (parse,
    Huffman decode, the container's header; progressive scans with
    allow_progressive), then one a sampled segment and mask."""
    workers = workers or os.cpu_count() or 1
    keys = sorted(jpegs)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, max(len(keys), 1) * max(lanes, 1))) as pool:
        analyses = pool.map(ref.analyse_job,
                            [(jpegs[i], num_segments, allow_progressive)
                             for i in keys],
                            chunksize=1)
        jobs = [(i, a, k, m) for i, a in zip(keys, analyses)
                for k in pick_lanes(len(a["jobs"]), lanes, seed, i)
                for m in masks]
        streams = pool.map(ref.lane_job, [j[1:] for j in jobs], chunksize=1)
    out = {i: (a, {}) for i, a in zip(keys, analyses)}
    for (i, _, k, m), stream in zip(jobs, streams):
        out[i][1][(k, m)] = stream
    return out


def expected_lep(analysis: dict, coded: dict, out: bytes,
                 mask: int = ref.FULL_PRECISION):
    """The reference's .lep with its coded segments (`coded`, of `mask`)
    and the other segments as `out` has them; None where `out`'s streams
    do not read or are not one a segment."""
    theirs = lanes_of(out)
    if theirs is None or len(theirs) != len(analysis["jobs"]):
        return None
    return ref.assemble(analysis, [coded.get((k, mask), theirs[k])
                                   for k in range(len(theirs))])


def lossy(jpeg: bytes, quality: int) -> bytes:
    """The control of a decode: the JPEG decoded to pixels and encoded
    again (4:2:0, `quality`), which is not the file that was stored."""
    from PIL import Image
    buf = io.BytesIO()
    Image.open(io.BytesIO(jpeg)).save(buf, "JPEG", quality=quality,
                                      subsampling=2)
    return buf.getvalue()


def sample(candidates: List[int], sizes: Dict[int, int], n: int,
           seed: int) -> List[int]:
    """n of the candidates drawn from the seed, the largest among them."""
    if n <= 0 or not candidates:
        return []
    largest = max(candidates, key=lambda i: (sizes[i], -i))
    rest = [i for i in candidates if i != largest]
    rng = random.Random(seed)
    return sorted([largest] + rng.sample(rest, min(n - 1, len(rest))))


def judge(images: List[bytes], window: list, made: list, config: dict,
          traffic: dict, seed: int, on_card: bool, control: bool = False,
          workers: int = None) -> tuple:
    """({name: (value, limit)}, the window's outputs judged failed) for the
    window's requests (calls.Request) and the set-up's calls that made the
    window's inputs (`made`), whose outputs are judged alike."""
    requests = list(window) + list(made)
    num_segments = config["container"]["num_segments"]
    version = config["container"]["version"]
    kernels = config["kernels"]
    counts = dict.fromkeys(LIMITS, 0)
    bad = set()          # (request index, output index) judged failed
    notes = []
    leps: Dict[int, list] = {}
    for r, req in enumerate(requests):
        n = len(req.images)
        if req.error:
            counts["raised"] += n
            bad.update((r, j) for j in range(n))
            continue
        if req.host_routes:
            counts["host_route"] += n
            bad.update((r, j) for j in range(n))
        idle = [k for k in kernels.get(req.makes, ())
                 if not req.launched.get(k)]
        if on_card and idle:
            counts["plain"] += n
            bad.update((r, j) for j in range(n))
            if len(notes) < 8:
                notes.append(f"{req.label}: no launch of {', '.join(idle)}")
        if len(req.outputs) != n:
            counts["raised"] += n
            bad.update((r, j) for j in range(n))
            notes.append(f"{req.label}: {len(req.outputs)} outputs for "
                         f"{n} inputs")
            continue
        for j, (i, out) in enumerate(zip(req.images, req.outputs)):
            if req.makes == "lep":
                leps.setdefault(i, []).append((r, j, out))
    # decoded JPEGs: every one against the JPEG the benchmark made
    transcoded = {}
    for r, req in enumerate(requests):
        if req.makes != "jpeg" or req.error or len(req.outputs) != len(
                req.images):
            continue
        for j, (i, out) in enumerate(zip(req.images, req.outputs)):
            if control:
                if i not in transcoded:
                    transcoded[i] = lossy(images[i],
                                          config["images"]["quality"])
                out = transcoded[i]
            if out != images[i]:
                counts["wrong_jpeg"] += 1
                bad.add((r, j))
    # .lep outputs: the container of each, each against the image's first
    for i, outs in leps.items():
        first = outs[0][2]
        why = container_problem(first, images[i], num_segments, version)
        for r, j, out in outs:
            if out is not first and out != first:
                counts["unstable_lep"] += 1
                bad.add((r, j))
                why_here = container_problem(out, images[i], num_segments,
                                             version)
            else:
                why_here = why
            if why_here:
                counts["bad_container"] += 1
                bad.add((r, j))
                if len(notes) < 8:
                    notes.append(f"image {i}: {why_here}")
    # .lep outputs against the reference with its sampled segments
    sizes = {i: len(images[i]) for i in leps}
    n = traffic.get("reference_images")
    picked = sorted(leps) if n is None else sample(sorted(leps), sizes, n,
                                                   seed)
    if picked and traffic.get("reference_lanes", 0) > 0:
        masks = (ref.FULL_PRECISION, ref.SEVEN_BITS) if control else (
            ref.FULL_PRECISION,)
        want = reference_lanes({i: images[i] for i in picked}, num_segments,
                               traffic["reference_lanes"], seed, masks,
                               workers, allow_progressive(config))
        for i in picked:
            analysis, coded = want[i]
            verdicts = {}        # an image's outputs are as a rule alike
            for r, j, out in leps[i]:
                if out not in verdicts:
                    lep = out
                    if control:
                        lep = expected_lep(analysis, coded, out,
                                           ref.SEVEN_BITS) or b""
                    verdicts[out] = lep != expected_lep(analysis, coded, lep)
                if verdicts[out]:
                    counts["wrong_lep"] += 1
                    bad.add((r, j))
        notes.append("reference: images " + ", ".join(
            f"{i} segments {sorted(k for k, _ in want[i][1])}"
            for i in picked))
    checks = {k: (counts[k], LIMITS[k]) for k in LIMITS}
    for note in notes:
        print(f"check: {note}", file=sys.stderr)
    return checks, sum(1 for r, _ in bad if r < len(window))
