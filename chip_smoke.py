#!/usr/bin/env python3
"""Smoke run of lepton_tpu_torch on one CUDA card.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
  1. build the five kernel sources with nvcc into build/, each twice (the
     default build and the bounds-checked one of phase 19), one nvcc a
     build, all started together: the encode coders' probability stage
     (csrc/branch_probs.cu: run_heads and walk_runs) and their walks,
     VPX (csrc/vpx_coder.cu) and rANS (csrc/ans_coder.cu, phase 8), the
     token decoder with its VPX and rANS readers (csrc/vpx_decoder.cu,
     phase 5) and the roofline probe (csrc/decode_roofline.cu, phase 12);
  2. hold the VPX coder's kernels against their plain PyTorch versions on
     CUDA tensors, kernel by kernel (run_heads and walk_runs on the
     grouped keys, then the walk on their probabilities) and whole:
     adversarial streams (branch reuse, a long carry chain), the same
     under a trained-template start arena, the stage lanes (empty,
     one-symbol, odd and even lanes, FIXED_PROB and PAD slots, one branch
     past both count overflows, a template's prob-0 branch), and a framed
     10k-symbol prefix of every lane of the full-size batch of phase 4;
  3. encode small images on cuda and on cpu: equal .lep bytes;
  4. the main path: batch_compress_device on four synthetic 12 MP
     4032x3024 4:2:0 q90 JPEGs, 16 segments each (64 coder lanes), with the
     launch counts of the probability stage's two kernels and the VPX walk
     read around it; image 0 alone must give the same bytes.  Then the
     coder is timed again on all 64 lanes and on the longest lane alone,
     each split into sort, probability stage (run_heads, walk_runs) and
     walk, with the longest run;
  5. (the decoder's build is part of phase 1)
  6. hold the decoder against its plain PyTorch version on CUDA tensors:
     small JPEGs encoded on the card with 1, 2 and 4 segments, from the
     identity arena and from phase 2's trained template, and one
     two-request call of different geometry and quality; planes and err
     flags must be equal, and the planes those of the JPEG's own parse;
  7. the main decode path: batch_decompress_device on phase 4's four .lep
     files, with the decoder's launch count read around it; each result
     must be its original JPEG byte for byte, the device planes those of
     the parse, and image 0 alone must give the same bytes.  The launch's
     branch-cache counters (inserts, fall-through reads a lane) must equal
     their replay from the encode lanes, printed with the distinct
     branches a lane.  Then the
     decoder is timed again on all 64 lanes and on the longest lane alone,
     and held against its plain version on all 64 lanes of the main path,
     each cut to its first two rows a component of at most a dozen
     blocks, with plane widths,
     output offsets, ring and plane sizes as the main path gives them;
  8. hold the ANS coder's kernels against their plain versions on CUDA
     tensors, kernel by kernel (run_heads and walk_runs under the adv rule,
     then the reverse walk on their probabilities) and whole: adversarial
     lanes (empty, one symbol, odd and even counts, one branch past both
     count overflows, a long lane), the same from the template, the stage
     lanes, a template's prob-0 branch (a 1 bit there codes; a 0 bit,
     freq 0, raises as in the plain version), and an unframed 10k-symbol
     prefix of all 64 v3 lanes of phase 9;
  9. the v3 main path: batch_compress_device(version=3) on phase 4's four
     JPEGs, with the launches of the probability stage's two kernels and
     the rANS walk read around it (one each); image 0 alone gives the
     same bytes; small images give equal v2 and v3 bytes on cuda and cpu;
     then batch_decompress_device on the four v3 files, with the readers'
     launches read around it (one of the rANS reader), gives back every
     original JPEG byte for byte, with its branch-cache counters held
     against the same replay.  Then the ANS coder (split into sort,
     probability stage and walk) and the rANS reader are timed again on
     all 64 lanes and on the longest lane alone;
 10. hold the rANS reader against its plain version: small v3 files with
     1, 2 and 4 segments, one from the template, and phase 9's 64 lanes
     cut to one row a component of a dozen blocks;
 11. one batch_decompress_device call with v1, v2 and v3 requests, a
     mode-X (progressive) and a CMYK one among them: one launch of each
     reader, and every original JPEG back;
 12. the roofline probe: each chain's checksum equal to its plain loop,
     then ns a step of each chain with the arena in device memory and in
     shared memory;
 13. mode X and 4 colours (fails if the native JPEG library did not
     build): phase 4's four photos made again as progressive JPEGs, encoded
     with allow_progressive as v1 and as v3 (one launch of each coder
     kernel, every file mode X, image 0 alone equal) and decoded back (one
     reader launch, every original byte for byte, the device planes those
     of the progressive parse), with the stage times printed beside phase
     4's, 7's and 9's for the same pictures; small files (a multi-scan
     baseline, a progressive one cut in its scan data, a q100 grayscale
     progressive one, a CMYK one) give equal v1 and v3 bytes on cuda and
     cpu and decode to the original (or, on a file that hits the
     reference's q100 quirk, to the host re-emit of its parse); one
     4032x3024 CMYK photo encodes and decodes as v1, one launch each;
 14. the -tpu batch server and the CLI, as a user starts them: `python -m
     lepton_tpu_torch -tpu -socket=... -zliblisten=...` in a subprocess.
     Wave A sends phase 4's four photos and their four v1 .lep files on
     eight connections before reading any reply: one wave, each JPEG
     reply equal to batch_compress_device(num_segments=8) in this process
     (32 coder lanes), each .lep reply its photo, every host-route
     counter 0, every JPEG reply verified by the host decoder, one launch
     of each coder kernel and of the VPX reader.  Wave B: phase 9's v3
     .lep (one rANS reader launch), a mode-Y .lep (host, mode_y), a
     160x96 JPEG (its cpu device bytes, whichever path), a corrupt JPEG
     and an unknown payload (zero bytes; host_kind), with
     encode_batch_failed 2 if both JPEGs shared a wave, else 1.  Wave C:
     a 160x96 JPEG over the zlib port, served by the card.  Then the
     one-shot CLI encodes photo 0 with -tpu and decodes it back with no
     device flag (the card is the default), and with a time budget of
     0.05 s exits 1 with no output (a device call over its budget is a
     card fault).  The server must leave no child and exit 0 on SIGTERM.
 15. more than one device and more than one process, every mesh made of
     the one card's cuda:0 repeated: make_mesh() (the card's own devices);
     sharded_phase_a over a (2, 2) mesh on phase 4's luma planes in two
     row bands, [4, 2, 189, 504, 64], each key equal to phase_a on its
     shard alone; decompress_device(mesh=) on phase 4's v1 and phase 9's
     v3 files over cuda:0 x 2 and x 4 (one reader launch a share, each
     share's ms beside the unsplit launch's, the merged planes equal to
     the unsplit launch's, every original back); batch_compress over the
     (2, 2) mesh at max_threads=8 (one launch of each coder kernel a
     device; bytes equal to its device="host" route and to one
     batch_compress_device(num_segments=8)) and batch_decompress back
     through both routes; distributed_compress of photo 0 in 16 segments
     by two processes on the card (run_ranks: gloo on 127.0.0.1, 8 lanes
     and one launch of each coder kernel a rank), both ranks' bytes equal
     to the world-1 call with either engine and decoding to the photo.
 16. the host symbolizer and the host codec's Python route: phase 4's four
     photos through compress_device(symbolizer="native") as v1 and as v3
     (symbols from the C library, coded on the card: one launch of
     run_heads, walk_runs and the walk a call, each .lep equal to phase
     4's or phase 9's), with the host symbolize_s, the coder's ms and the
     wall beside the card symbolizer's; on a 256x192 photo in 2 segments,
     the port's pure-Python encode_segment (VPX and ANS) equal to the card
     coder's streams, host.compress on the Python route equal to the
     card's .lep and decoded back by decompress_device, and decode_segment
     of the card's streams equal to the parse's planes; a seeded round
     trip of the QM coder (coder/jpeg_arith.py).  Phases 1 to 15 must not
     have taken the Python segment codec, in this process or in the
     server's waves.
 17. hostile, truncated and odd-sized input through the kernels: the
     randomized soak (lepton_tpu_torch/soak.py) on the card, SOAK_CASES
     cases from SOAK_SEED over versions 1 to 3, modes Z and X, 1, 3 and
     4 components (at most 400 px a side: one segment each, whatever the
     case's thread count), then soak.MULTI_SEGMENTS' cases sized to code
     2, 4, 6 and 8 segments (each held to its count), each case's .lep
     equal to the host codec's,
     decoded back, and its truncated and bit-flipped containers decoding
     to the host codec's outcome, in one batch_compress_device call a
     version and one batch_decompress_device call, with the outcome
     counts by class (no case may fail); phase 4's and phase 9's
     16-segment files cut and bit-flipped the same way, in one call, held
     to the host codec; the hostile kernel batches (soak.hostile_readers:
     random and cut streams, empty lanes, against the plain reader and
     the host's C segment decoder, two launches bitwise equal, a good
     file decoded after; soak.hostile_coders: 0- and 1-symbol lanes
     beside long and one-branch lanes at 1, 64 and 2048 lanes against the
     plain stages); and a -tpu server wave of good, bit-flipped and
     truncated .lep files: each bad request gets the empty reply, each
     good one its JPEG, the server stays on the card and serves the next
     wave; both readers on streams whose row past an early-EOF cut codes
     block 0 (soak.past_cut_lanes), equal to the plain reader and the
     host's C segment decoder.
 18. the port's bench runner (lepton_tpu_torch/bench.py, python -m
     lepton_tpu_torch.bench) in this process on phase 4's photos: every
     section (host codec, symbolize, coders, one photo's encode and decode
     latency, the batch both ways, the 128-image knee corpus and its lane
     sweep, the one-device mesh, the -tpu server), each run held to its
     gates; the runner's object on a line of its own, and each kernel's
     launches in it (launches_bench in the kernels line).
 19. the bounds-checked builds (csrc/checked.cuh, -DLEPTON_CHECKED): the
     default builds' ptxas reports equal PTXAS_BASELINE, the report from
     before the checks were written (they compile away); then `python -m
     lepton_tpu_torch.sanitize card` in a subprocess with
     LEPTON_TORCH_CHECKED_KERNELS=1 on phase 4's photos: its negative
     checks (hand-made plans and lanes whose indices leave their buffers)
     each raise KernelBoundsError at their site, and the hostile batches
     (soak --hostile-only), a 12-case soak and the main batch both ways
     (v1 and v3) run clean; their outputs (.lep digests, planes, err
     flags, the hostile batches' counts) equal the default build's on
     the same inputs in this process, and the soak's .lep files phase
     17's; each kernel's checked time beside its default time, and its
     check sites.
It prints stage times, sizes, rates and peak memory, then the card's name
and power limit, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""
import contextlib
import io
import json
import os
import random
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 20240601
PREFIX = 20000                 # symbols per lane in the phase-2 prefix cut
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_SCALAR_OPS_PER_S = 67e12  # fp32 outside the tensor cores
WALK_OPS_PER_SYMBOL = 15       # integer ops of one VPX-coded symbol, roughly
PROBS_OPS_PER_SYMBOL = 15      # integer ops of one branch update, roughly
HEADS_OPS_PER_KEY = 4          # integer ops of one key's run-start test
DECODER_OPS_PER_READ = 40      # integer ops of one decoded read, roughly
STOP_BITS = 32                 # coded after each lane's last symbol
CUT_ROWS, CUT_WIDTH = 2, 12    # phase-7 cut of the main path's lanes
ANS_PREFIX = 10000             # symbols per lane in the phase-8 prefix cut
ANS_CUT_ROWS, ANS_CUT_WIDTH = 1, 12   # phase-10 cut of the v3 lanes
ANS_WALK_OPS_PER_SYMBOL = 20   # integer ops of one rANS-coded symbol
PROBE_CHECK_ITERS = 2000       # steps of the probe's checksum holds
PROBE_STEPS = 1 << 20          # steps of each timed probe chain
SOAK_CASES, SOAK_SEED = 72, 0  # phase 17's soak
# ptxas -v of the default builds, functions in PTX order (registers,
# barriers, shared memory, stack and spills; nvcc 12.8 for sm_90a), from
# before the bounds checks of csrc/checked.cuh were written: the checks
# compile away, so phase 19 holds every default build to it
_NO_SPILL = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
PTXAS_BASELINE = {
    "branch_probs": [
        _NO_SPILL, "Used 32 registers, used 1 barriers, 2080 bytes smem",
        _NO_SPILL, "Used 32 registers, used 1 barriers, 2080 bytes smem",
        _NO_SPILL, "Used 18 registers, used 0 barriers"],
    "vpx_coder": [
        _NO_SPILL, "Used 37 registers, used 1 barriers, 32776 bytes smem"],
    "vpx_decoder": [
        "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "Used 64 registers, used 1 barriers, 8 bytes cumulative stack size",
        "24 bytes stack frame, 44 bytes spill stores, 24 bytes spill loads",
        "Used 48 registers, used 1 barriers, 24 bytes cumulative stack "
        "size"],
    "ans_coder": [
        _NO_SPILL, "Used 63 registers, used 1 barriers, 45056 bytes smem"],
    "decode_roofline": [
        line for regs in (18, 15, 9, 31, 32, 24, 30, 18, 24, 16, 22)
        for line in (_NO_SPILL, f"Used {regs} registers, used 1 barriers")],
}
QUIRK_SEED = 146               # gray_q100(QUIRK_SEED, 160, 96) hits the q100
                               # quirk with PIL's libjpeg-turbo 3.1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_photo(*args, **kw) -> bytes:
    """lepton_tpu_torch.bench.make_photo: a phone-photo-like JPEG from a
    numpy seed (phase 4's photos are the runner's main batch)."""
    from lepton_tpu_torch.bench import make_photo as make
    return make(*args, **kw)


def multi_scan_jpeg(jpeg: bytes) -> bytes:
    """A baseline JPEG with one scan a component, made from a baseline file
    (PIL cannot write one): its single SOS becomes one SOS a component (Ns
    1, Ss 0, Se 63, AhAl 0), and the port's progressive re-emit, which
    writes sequential scans too, regenerates the scans from its planes."""
    from lepton_tpu_torch.jpeg.decoder import decode_scans
    from lepton_tpu_torch.jpeg.imageinfo import image_info_from_header
    from lepton_tpu_torch.jpeg.parser import parse_jpeg
    from lepton_tpu_torch.jpeg.recode_progressive import (
        recode_progressive_jpeg)
    parsed = parse_jpeg(jpeg)
    hdr = parsed.hdrdata
    dec = decode_scans(parsed, image_info_from_header(hdr))
    at = hdr.rfind(b"\xff\xda")
    comps = [hdr[at + 5 + 2 * k:at + 7 + 2 * k] for k in range(hdr[at + 4])]
    new = hdr[:at] + b"".join(b"\xff\xda\x00\x08\x01" + c + b"\x00\x3f\x00"
                              for c in comps)
    return recode_progressive_jpeg(new, dec.planes,
                                   image_info_from_header(new), dec.padbit,
                                   [], False, [], b"\xff\xd9", 1 << 30)


def adversarial_segments():
    """The streams of tests/test_pallas_coder.py: random branches with 70%
    reuse, and 1500 symbols hammering one branch (long carry chains)."""
    from lepton_tpu_torch.model.tables import ARENA_SIZE
    rng = random.Random(9)
    segments = []
    for s in range(2):
        n = 900 - 100 * s
        idx = [rng.randrange(ARENA_SIZE) for _ in range(n)]
        for k in range(1, n):
            if rng.random() < 0.7:
                idx[k] = idx[rng.randrange(k)]
        segments.append((idx, [rng.randrange(2) for _ in range(n)]))
    rng = random.Random(4)
    idx, bit = [7] * 1500, [1] * 1500
    for _ in range(64):
        idx.append(rng.randrange(ARENA_SIZE))
        bit.append(rng.randrange(2))
    segments.append((idx, bit))
    return segments


def ans_adversarial_segments(long_lane: int = 32000):
    """Unframed v3 lanes that stress the ANS coder: empty, one symbol, odd
    and even counts with 70% branch reuse, one branch hammered until both
    of its counts overflow, and a long random lane of many emitted words."""
    from lepton_tpu_torch.model.tables import ARENA_SIZE
    rng = random.Random(11)
    segments = [([], []), ([5], [1])]
    for n in (901, 900):
        idx = [rng.randrange(ARENA_SIZE) for _ in range(n)]
        for k in range(1, n):
            if rng.random() < 0.7:
                idx[k] = idx[rng.randrange(k)]
        segments.append((idx, [rng.randrange(2) for _ in range(n)]))
    segments.append(([7] * 3001, [1] * 1000 + [0] * 1000
                     + [rng.randrange(2) for _ in range(1001)]))
    segments.append(([rng.randrange(64) for _ in range(long_lane)],
                     [rng.randrange(2) for _ in range(long_lane)]))
    return segments


PROB0_BRANCH = 7               # stage_template's branch of prob byte 0


def stage_segments(long_lane: int = 3000):
    """Segments that stress the probability stage and both walks: empty,
    one symbol (PROB0_BRANCH first met by a 1 bit), odd and even counts
    with heavy branch reuse and FIXED_PROB and PAD slots among them, one
    branch driven past both count overflows (through the never-seen
    saturation from the identity), and a longer lane of many branches."""
    from lepton_tpu_torch.kernels.vpx_coder import FIXED_PROB, PAD
    from lepton_tpu_torch.model.tables import ARENA_SIZE
    rng = np.random.default_rng(SEED + 1)
    segments = [([], []), ([PROB0_BRANCH], [1])]
    for n in (1201, 1200):
        idx = rng.integers(10, 50, n)
        idx[rng.random(n) < 0.1] = FIXED_PROB
        idx[rng.random(n) < 0.05] = PAD
        segments.append((idx.tolist(), rng.integers(0, 2, n).tolist()))
    segments.append(([9] * 1400, [1] * 300 + [0] * 300
                     + rng.integers(0, 2, 800).tolist()))
    idx = rng.integers(10, ARENA_SIZE, long_lane)
    reuse = rng.random(long_lane) < 0.7
    idx[reuse] = idx[rng.integers(0, 64, int(reuse.sum()))]
    segments.append((idx.tolist(), rng.integers(0, 2, long_lane).tolist()))
    return segments


def stage_template(packed: np.ndarray) -> np.ndarray:
    """A copy of a packed template (c0 << 16 | c1 << 8 | prob) whose
    PROB0_BRANCH stores prob byte 0, as a VPX-trained model does for a
    branch it never saw."""
    packed = np.array(packed, dtype=np.uint32)
    packed[PROB0_BRANCH] &= ~np.uint32(0xFF)
    return packed


def unframed_lanes(segments):
    """(idx int32 [S, L], bit uint8 [S, L], nsyms int32 [S]) numpy arrays of
    unframed lanes, PAD after each lane's symbols."""
    from lepton_tpu_torch.kernels.vpx_coder import PAD
    L = max([len(i) for i, _ in segments] + [1])
    idx = np.full((len(segments), L), PAD, np.int32)
    bit = np.zeros((len(segments), L), np.uint8)
    for s, (i, b) in enumerate(segments):
        idx[s, :len(i)] = i
        bit[s, :len(b)] = b
    return idx, bit, np.asarray([len(i) for i, _ in segments], np.int32)


def prob0_lanes():
    """A template whose branch 7 stores prob byte 0, as a VPX-trained model
    does for a branch it never saw, and unframed lanes on it.  The first
    use of branch 7 codes at probability 0: a 1 bit there is freq 256 and
    codes; a 0 bit is freq 0 and has no code.  Returns (packed template,
    segments that code, segments of which lane 1 cannot)."""
    from lepton_tpu_torch.model.tables import ARENA_SIZE
    packed = np.full(ARENA_SIZE, 0x010180, np.uint32)
    packed[7] = 0x010100
    return (packed, [([7, 7, 3], [1, 0, 1]), ([3, 7], [0, 1])],
            [([3], [0]), ([7, 7], [0, 1])])


def coder_kernels():
    """The encode coders' kernel wrappers, each with its launch counter:
    the probability stage's two, then the VPX and rANS walks."""
    from lepton_tpu_torch.kernels import ans_coder, vpx_coder
    from lepton_tpu_torch.kernels import branch_probs as bp
    return (bp.run_heads, bp.walk_runs, vpx_coder.vpx_walk,
            ans_coder.ans_walk)


@contextlib.contextmanager
def uncounted():
    """Launches of the coders' kernels made inside do not count toward the
    main path: they compare a kernel with its plain version."""
    fns = coder_kernels()
    saved = [f.launches for f in fns]
    try:
        yield
    finally:
        for f, n in zip(fns, saved):
            f.launches = n


def check_ans_zero_freq(dev) -> None:
    """The ANS coder kernel codes a 1 bit at probability 0 as the plain
    version does, and refuses a 0 bit there (freq 0) with the plain
    version's ValueError instead of writing a stream nothing decodes."""
    import torch
    from lepton_tpu_torch.kernels import ans_coder
    from lepton_tpu_torch.model.tables import arena_from_template
    packed, ok, bad = prob0_lanes()
    tpl = arena_from_template(packed).to(dev)
    compare_ans_coder(*(torch.as_tensor(a, device=dev)
                        for a in unframed_lanes(ok)), tpl)
    for fn in (ans_coder.encode_streams_ans,
               ans_coder.encode_streams_ans_plain):
        try:
            with uncounted():
                fn(*(torch.as_tensor(a, device=dev)
                     for a in unframed_lanes(bad)), tpl)
        except ValueError as e:
            if "lanes [1]" not in str(e):
                fail(f"{fn.__name__} refused the wrong lanes: {e}")
        else:
            fail(f"{fn.__name__} coded a 0 bit at probability 0")


def timed_cuda(fn, *args):
    """(result, ms) of one call, CUDA events around it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    r = fn(*args)
    end.record()
    end.synchronize()
    return r, start.elapsed_time(end)


def _byte_err(a: list, b: list) -> int:
    """Largest absolute difference between two lists of byte strings."""
    return max((int(np.abs(np.frombuffer(x, np.uint8).astype(np.int16)
                           - np.frombuffer(y, np.uint8)).max())
                for x, y in zip(a, b) if x and len(x) == len(y)), default=0)


def compare_probs(idx, bit, template, rule, nsyms=None):
    """The probability stage's two kernels, each against its plain version
    on the same CUDA tensors: run_heads on the grouped keys (its list
    sorted first: the kernel's has no fixed order), then walk_runs on
    those heads.  Returns (probs, max_abs_err, {kernel: (kernel ms, plain
    ms)})."""
    import torch
    from lepton_tpu_torch.kernels import branch_probs as bp
    bp.check(idx, bit, template, rule, nsyms)
    keys, shift = bp.group(idx, bit, nsyms)
    with uncounted():
        heads, heads_k = timed_cuda(bp.run_heads, keys, shift)
        want_heads, heads_p = timed_cuda(bp.run_heads_plain, keys, shift)
        (probs, zero, longest), runs_k = timed_cuda(
            bp.walk_runs, keys, shift, heads, idx.shape, template, rule)
        (want, wzero, wlongest), runs_p = timed_cuda(
            bp.walk_runs_plain, keys, shift, want_heads, idx.shape, template,
            rule)
    if not torch.equal(torch.sort(heads).values, want_heads):
        fail(f"run_heads kernel differs from its plain version ({rule})")
    err = int((probs.int() - want.int()).abs().max()) if probs.numel() else 0
    if err or not torch.equal(zero, wzero) or longest != wlongest:
        fail(f"walk_runs kernel ({rule}) differs from its plain version "
             f"(max err {err}, longest run {longest} vs {wlongest})")
    return probs, err, {"heads": (heads_k, heads_p), "runs": (runs_k, runs_p)}


def compare_coder(idx, bit, template=None):
    """The VPX coder's kernels against their plain versions on the same
    CUDA tensors: the probability stage's two kernels, the walk on its
    probabilities, and the whole coder (encode_streams against the
    arena-walk encode_streams_plain).  Returns (max_abs_err over
    probabilities and stream bytes, {kernel or "coder": (kernel ms, plain
    ms)})."""
    from lepton_tpu_torch.kernels import vpx_coder
    probs, perr, ms = compare_probs(idx, bit, template, "vpx")
    with uncounted():
        (out_k, nb_k), walk_k = timed_cuda(vpx_coder.vpx_walk, idx, bit,
                                           probs)
        (out_p, nb_p), walk_p = timed_cuda(vpx_coder.vpx_walk_plain, idx,
                                           bit, probs)
        (out_w, nb_w), ms_k = timed_cuda(vpx_coder.encode_streams, idx, bit,
                                         template)
        (out_q, nb_q), ms_p = timed_cuda(vpx_coder.encode_streams_plain, idx,
                                         bit, template)
    errs = [perr]
    for what, k, p in (("walk", (out_k, nb_k), (out_p, nb_p)),
                       ("coder", (out_w, nb_w), (out_q, nb_q))):
        sk, sp = vpx_coder.finalize(*k), vpx_coder.finalize(*p)
        errs.append(_byte_err(sk, sp))
        if sk != sp:
            fail(f"VPX {what} kernel differs from its plain version (max "
                 f"err {errs[-1]})")
    return max(errs), dict(ms, walk=(walk_k, walk_p), coder=(ms_k, ms_p))


def compare_ans_coder(idx, bit, nsyms, template=None):
    """The ANS coder's kernels against their plain versions on the same
    CUDA tensors, as compare_coder does for the VPX coder.  Returns
    (max_abs_err, {stage: (kernel ms, plain ms)}, most words of a lane)."""
    from lepton_tpu_torch.kernels import ans_coder
    probs, perr, ms = compare_probs(idx, bit, template, "adv", nsyms)
    with uncounted():
        (out_k, nw_k), walk_k = timed_cuda(ans_coder.ans_walk, probs, bit,
                                           nsyms)
        (out_p, nw_p), walk_p = timed_cuda(ans_coder.ans_walk_plain, probs,
                                           bit, nsyms)
        (out_w, nw_w), ms_k = timed_cuda(ans_coder.encode_streams_ans, idx,
                                         bit, nsyms, template)
        (out_q, nw_q), ms_p = timed_cuda(ans_coder.encode_streams_ans_plain,
                                         idx, bit, nsyms, template)
    errs = [perr]
    for what, k, p in (("walk", (out_k, nw_k), (out_p, nw_p)),
                       ("coder", (out_w, nw_w), (out_q, nw_q))):
        sk, sp = ans_coder.finalize_ans(*k), ans_coder.finalize_ans(*p)
        errs.append(_byte_err(sk, sp))
        if sk != sp:
            fail(f"ANS {what} kernel differs from its plain version (max "
                 f"err {errs[-1]})")
    return (max(errs), dict(ms, walk=(walk_k, walk_p), coder=(ms_k, ms_p)),
            int(nw_k.max()))


def stage_lanes(framed: bool):
    """(idx, bit, nsyms) numpy arrays of stage_segments: framed VPX lanes
    (marker bit, 32 stop bits) or unframed rANS lanes."""
    from lepton_tpu_torch.kernels import vpx_coder
    segments = stage_segments()
    if not framed:
        return unframed_lanes(segments)
    idx, bit = vpx_coder.build_symbol_streams(segments)
    return idx, bit, np.full(len(idx), idx.shape[1], np.int32)


def stage_inputs(dev, framed: bool):
    """stage_lanes as tensors on `dev`, and the stage template (a random
    trained model with a prob-0 branch) in the coder layout."""
    import torch
    from lepton_tpu_torch import api
    from lepton_tpu_torch.model.tables import ARENA_SIZE, arena_from_template
    raw = np.random.default_rng(SEED + 2).integers(0, 256, (ARENA_SIZE, 3),
                                                   dtype=np.uint8)
    raw[:, 2] = 1 + raw[:, 2] % 254
    tpl = arena_from_template(stage_template(api.pack_model(raw)))
    return (tuple(torch.as_tensor(a, device=dev) for a in stage_lanes(framed)),
            tpl.to(dev))


def bound_ms(moved: int, ops: int) -> tuple:
    """(ms to move `moved` bytes, ms to do `ops` scalar operations) at the
    H100's peak rates."""
    return (moved / H100_BYTES_PER_S * 1e3,
            ops / H100_SCALAR_OPS_PER_S * 1e3)


def fmt_ms(ms: dict) -> str:
    return "; ".join(f"{k} kernel {a:.2f} ms, plain {b:.0f} ms"
                     for k, (a, b) in ms.items())


def stage_split(stats: dict) -> str:
    """A coder's stage times from its stats dict."""
    return (f"(sort {stats['sort_ms']:.2f}, probability stage "
            f"{stats['probs_ms']:.2f} = run_heads {stats['heads_ms']:.2f} + "
            f"walk_runs {stats['runs_ms']:.2f}, walk {stats['walk_ms']:.2f} "
            f"ms; {stats['live']} live symbols in {stats['runs']} runs, "
            f"longest run {stats['longest_run']})")


def encode_in_segments(jpeg: bytes, nseg: int, template=None,
                       version: int = 1) -> bytes:
    """The container `version` .lep of a JPEG, encoded on the card in nseg
    segments from `template` (a packed trained model, or None)."""
    import torch
    from lepton_tpu_torch import api
    from lepton_tpu_torch.container.handoff import (choose_num_threads,
                                                    select_splits)
    from lepton_tpu_torch.kernels import batch_encode
    parsed, info, dec = api._parse(jpeg)
    hs = dec.handoffs
    nt = choose_num_threads(len(hs), hs[-1].segment_size - hs[0].segment_size,
                            nseg, nseg)
    splits = select_splits(hs, nt)
    if len(splits) != nseg:
        fail(f"{len(splits)} segments, not {nseg}")
    streams = batch_encode.encode_images_device(
        [api._describe(info, dec, splits)], version, template=template,
        device=torch.device("cuda"))[0]
    return api._container(parsed, dec, splits, nt, streams, version)


def small_lep(seed: int, w: int, h: int, quality: int, nseg: int,
              template=None, version: int = 1) -> tuple:
    """(JPEG, .lep) of a small photo, encoded on the card in nseg segments."""
    jpeg = make_photo(seed, w, h, quality)
    return jpeg, encode_in_segments(jpeg, nseg, template, version)


def compare_lanes(inputs: dict, template=None):
    """Decoder kernel vs plain version on the same CUDA tensors (the
    inputs of decode_lanes).  Returns (coef, err flags, max_abs_err over
    the planes, kernel ms, plain ms)."""
    import torch
    from lepton_tpu_torch.kernels import vpx_decoder
    dl = vpx_decoder.decode_lanes
    counted = dl.launches, dl.ans_launches
    (coef_k, err_k), ms_k = timed_cuda(
        lambda: vpx_decoder.decode_lanes(**inputs, template=template))
    (coef_p, err_p), ms_p = timed_cuda(
        lambda: vpx_decoder.decode_lanes_plain(**inputs, template=template))
    # launches made to compare do not count toward the main path
    dl.launches, dl.ans_launches = counted
    err = int((coef_k.int() - coef_p.int()).abs().max()) if len(coef_k) \
        else 0
    if err or not torch.equal(err_k, err_p):
        fail(f"decoder kernel differs from plain version (max err {err}, "
             f"err flags {err_k.tolist()} vs {err_p.tolist()})")
    return coef_k, err_k, err, ms_k, ms_p


def compare_decoder(leps, jpegs, template=None, coder="vpx"):
    """compare_lanes for the requests of `leps` (all of one coder) in one
    call; the planes must also be the JPEGs' own.  Returns (max_abs_err
    over the planes, kernel ms, plain ms)."""
    from lepton_tpu_torch import api
    from lepton_tpu_torch.kernels import vpx_decoder
    plan = vpx_decoder.plan_decode([api._decode_request(lep, i)[0]
                                    for i, lep in enumerate(leps)], coder)
    coef_k, err_k, err, ms_k, ms_p = compare_lanes(plan.to("cuda"), template)
    if err_k.any():
        fail("decoder flagged a stream inconsistency on a valid .lep")
    coef = coef_k.cpu().numpy()
    for (planes, _), jpeg in zip(vpx_decoder.split_planes(
            plan, coef, np.zeros(len(plan.lane_request), bool)), jpegs):
        want = api._parse(jpeg)[2].planes
        if not all(np.array_equal(a, b) for a, b in zip(planes, want)):
            fail("decoded planes differ from the JPEG's parse")
    return err, ms_k, ms_p


def one_lane(inputs: dict, k: int) -> dict:
    """The decode inputs of lane k alone."""
    lane = inputs["lanes"][k:k + 1].clone()
    r0, n = int(lane[0, 0]), int(lane[0, 1])
    lane[0, 0] = 0
    return dict(inputs, data=inputs["data"][k:k + 1].contiguous(),
                dlen=inputs["dlen"][k:k + 1].contiguous(), lanes=lane,
                rows=inputs["rows"][r0:r0 + n].contiguous())


def cut_lanes(inputs: dict, rows_per_comp: int, width: int) -> dict:
    """The decode inputs with every lane cut to its first rows_per_comp
    rows of each component, each row to its first `width` blocks.  Plane
    widths, output offsets, the ring and the planes keep their sizes, and
    every lane keeps its whole stream (past the cut it decodes the bits of
    the blocks left out)."""
    import torch
    from lepton_tpu_torch.kernels.vpx_decoder import ROW_FIELDS
    rows = inputs["rows"].cpu().numpy()
    keep, lanes = [], []
    for row0, nrows, tab0, ntab in inputs["lanes"].cpu().numpy().tolist():
        seen = {}
        start = len(keep)
        for r in range(row0, row0 + nrows):
            comp = int(rows[r, 0])
            seen[comp] = seen.get(comp, 0) + 1
            if seen[comp] <= rows_per_comp:
                keep.append(r)
        lanes.append((start, len(keep) - start, tab0, ntab))
    cut = rows[keep].copy()
    w = ROW_FIELDS.index("width")
    cut[:, w] = np.minimum(cut[:, w], width)
    dev = inputs["rows"].device
    return dict(inputs, lanes=torch.as_tensor(np.asarray(lanes, np.int32),
                                              device=dev),
                rows=torch.as_tensor(cut, device=dev))


def cache_replay(descs, dev, slots: int) -> np.ndarray:
    """int64 [S, 3]: each lane's (inserts, fall-through reads, distinct
    branches) of the decoder's branch cache of `slots` entries, replayed
    from the unframed encode lanes of `descs`, which are the decoder's
    reads in order (a VPX lane's marker bit reads no branch)."""
    from lepton_tpu_torch.kernels import batch_encode, vpx_coder, vpx_decoder
    idx, _, _ = batch_encode.assemble_lanes(descs, dev, framed=False)
    idx = idx.cpu().numpy()
    return np.asarray([vpx_decoder.cache_fill(row[row != vpx_coder.PAD],
                                              slots) for row in idx])


def check_cache(counts, replay, what: str) -> str:
    """The kernel's cache counters (int32 [S, 2] on the card) against their
    replay; returns a line that describes both."""
    got = counts.cpu().numpy()
    if not np.array_equal(got, replay[:, :2]):
        bad = np.flatnonzero((got != replay[:, :2]).any(1)).tolist()
        fail(f"{what}: branch cache counters differ from their replay on "
             f"lanes {bad[:8]}")
    return (f"inserts {got[:, 0].min()}-{got[:, 0].max()} a lane, "
            f"fall-through reads {int(got[:, 1].sum())} in all, distinct "
            f"branches {replay[:, 2].min()}-{replay[:, 2].max()} a lane "
            f"(equal to the replay from the encode lanes)")


def cut_in_scan(jpeg: bytes) -> bytes:
    """The JPEG cut in the middle of the entropy-coded data of its longest
    scan, so that it ends early inside scan data and not inside a header."""
    best = (0, 0)
    at = jpeg.find(b"\xff\xda")
    while at >= 0:
        start = end = at + 2 + int.from_bytes(jpeg[at + 2:at + 4], "big")
        while True:
            end = jpeg.find(b"\xff", end)
            if end < 0 or end + 1 >= len(jpeg):
                end = len(jpeg)
                break
            if jpeg[end + 1] != 0 and not 0xD0 <= jpeg[end + 1] <= 0xD7:
                break
            end += 2
        best = max(best, (end - start, start))
        at = jpeg.find(b"\xff\xda", end)
    n, start = best
    return jpeg[:start + n // 2]


def gray_q100(seed: int, w: int, h: int) -> bytes:
    """A grayscale noise JPEG, q100 progressive: the kind of file on which
    the reference encoder's q100 quirk shows (tests/test_torch_progressive
    .py holds the port to the JAX package on one that hits it)."""
    from PIL import Image
    arr = np.random.default_rng(seed).integers(0, 256, (h, w))
    buf = io.BytesIO()
    Image.fromarray(arr.astype(np.uint8), "L").save(
        buf, "JPEG", quality=100, progressive=True)
    return buf.getvalue()


def reemit_of_parse(jpeg: bytes) -> bytes:
    """The port's host re-emit of the planes of a mode-X JPEG's own parse:
    what a decode of its .lep gives back.  The JPEG itself, except on a
    file that hits the reference encoder's q100 quirk, where the JAX
    package gives the same other bytes."""
    from lepton_tpu_torch import api
    from lepton_tpu_torch.jpeg.imageinfo import image_info_from_header
    from lepton_tpu_torch.jpeg.recode_progressive import (
        recode_progressive_jpeg)
    parsed, _, dec = api._parse(jpeg, allow_progressive=True)
    return recode_progressive_jpeg(
        parsed.hdrdata, dec.planes, image_info_from_header(parsed.hdrdata),
        dec.padbit, parsed.rst_cnt, False, parsed.rst_err,
        parsed.garbage or b"\xff\xd9", parsed.jpgfilesize,
        truncated=dec.early_eof)


def ptxas_lines(report: str) -> list:
    """The register, barrier, shared-memory and spill lines of a ptxas -v
    report, as PTXAS_BASELINE holds them."""
    return [line.replace("ptxas info    :", "").strip()
            for line in report.splitlines()
            if "registers" in line or "spill" in line]


def launch_counts() -> dict:
    """The launch counters of every kernel on an encode or decode path."""
    from lepton_tpu_torch.kernels import vpx_decoder
    counts = {fn.__name__: fn.launches for fn in coder_kernels()}
    counts["vpx_reader"] = vpx_decoder.decode_lanes.launches
    counts["ans_reader"] = vpx_decoder.decode_lanes.ans_launches
    return counts


def reset_launches() -> None:
    from lepton_tpu_torch.kernels import vpx_decoder
    for fn in coder_kernels():
        fn.launches = 0
    vpx_decoder.decode_lanes.launches = 0
    vpx_decoder.decode_lanes.ans_launches = 0


def expect_launches(what: str, **want) -> dict:
    """The counts since reset_launches(); fails unless each kernel named
    in `want` ran that many times and every other kernel never."""
    counts = launch_counts()
    if counts != {k: want.get(k, 0) for k in counts}:
        fail(f"{what}: launches {counts}, expected {want}")
    return counts


def phase_mode_x(dev, base: dict) -> dict:
    """Phase 13: progressive photos through the main path as v1 and v3,
    small mode-X and CMYK files on cuda against cpu, and a 12 MP CMYK
    photo.  `base` holds phase 4/7 (v1) and phase 9 (v3) numbers of the
    same pictures as baseline files.  Returns {version: (launches on the
    encode and decode main paths, their stats merged)}."""
    import torch
    from lepton_tpu_torch import _native, api
    from lepton_tpu_torch.kernels import (ans_coder, batch_encode,
                                          vpx_coder, vpx_decoder)
    if not _native.available():
        fail("the native JPEG library did not build: the progressive parse "
             "and re-emit would run in Python")
    t = time.perf_counter()
    blobs = [make_photo(SEED + k, 4032, 3024, progressive=True)
             for k in range(4)]
    parses = [api._parse(b, allow_progressive=True)[1:] for b in blobs]
    descs = [api._describe(info, dec, api._plan(dec, 16)[0])
             for info, dec in parses]
    nscans = [b.count(b"\xff\xda") for b in blobs]
    log(f"[13] made the 4 photos of phase 4 as progressive JPEGs "
        f"({sum(map(len, blobs))} bytes, {nscans} scans) and parsed them "
        f"in {time.perf_counter() - t:.1f} s")
    out = {}
    for version, walk, reader in ((1, "vpx_walk", "vpx_reader"),
                                  (3, "ans_walk", "ans_reader")):
        (bprof, bdprof, bwall, bdwall, bpeak, bdpeak, bin_, bout,
         (bagain_ms, bagain), bdagain_ms) = base[version]
        coder_key = "coder_ms" if version == 1 else "ans_coder_ms"
        reader_key = f"{'vpx' if version == 1 else 'ans'}_decoder_ms"
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        prof = {}
        leps = api.batch_compress_device(blobs, num_segments=16, stats=prof,
                                         version=version,
                                         allow_progressive=True)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev)
        enc = expect_launches(f"v{version} mode-X encode", run_heads=1,
                              walk_runs=1, **{walk: 1})
        if prof["lanes"] != 64:
            fail(f"expected 64 mode-X lanes, got {prof['lanes']}")
        for b, lep in zip(blobs, leps):
            if lep[:4] != b"\xcf\x84" + bytes([version]) + b"X" \
                    or int.from_bytes(lep[-4:], "little") != len(lep) \
                    or not len(lep) < len(b):
                fail(f"malformed, non-shrinking or not mode-X v{version} "
                     ".lep")
        if api.compress_device(blobs[0], version=version,
                               allow_progressive=True) != leps[0]:
            fail(f"v{version} mode X image 0: batch output differs from "
                 "compress_device alone")
        # the coder again on the same lanes, as phases 4 and 9 time it
        idx, bit, _ = batch_encode.assemble_lanes(descs, dev,
                                                  framed=version != 3)
        again = {}
        if version == 3:
            nsyms = (idx != vpx_coder.PAD).sum(1).to(torch.int32)
            _, again_ms = timed_cuda(ans_coder.encode_streams_ans, idx, bit,
                                     nsyms, None, again)
        else:
            _, again_ms = timed_cuda(vpx_coder.encode_streams, idx, bit,
                                     None, again)
        del idx, bit
        torch.cuda.empty_cache()
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        dprof = {}
        outs = api.batch_decompress_device(leps, stats=dprof)
        torch.cuda.synchronize(dev)
        dwall = time.perf_counter() - t
        dpeak = torch.cuda.max_memory_allocated(dev)
        dec = expect_launches(f"v{version} mode-X decode", **{reader: 1})
        if outs != blobs:
            fail(f"v{version} mode X: batch_decompress_device did not give "
                 "back the original progressive JPEGs")
        plan = vpx_decoder.plan_decode(
            [api._decode_request(lep, i)[0] for i, lep in enumerate(leps)],
            "ans" if version == 3 else "vpx")
        inputs = plan.to(dev)
        (coef, derr), dagain_ms = timed_cuda(
            lambda: vpx_decoder.decode_lanes(**inputs))
        for (planes, _), (_, parsed) in zip(
                vpx_decoder.split_planes(plan, coef, derr), parses):
            if not all(torch.equal(a, torch.as_tensor(b, device=dev))
                       for a, b in zip(planes, parsed.planes)):
                fail(f"v{version} mode X: device planes differ from the "
                     "progressive parse's")
        del coef, planes, inputs
        torch.cuda.empty_cache()
        bytes_out = sum(map(len, leps))
        log(f"[13] v{version} mode X: batch_compress_device on the 4 "
            f"progressive photos, {prof['lanes']} lanes, launches "
            f"{ {k: v for k, v in enc.items() if v} }, every file mode X, "
            f"image 0 alone gives equal bytes; batch_decompress_device: "
            f"{dec[reader]} {reader} launch, every JPEG back byte for byte, "
            f"device planes equal the progressive parse's")
        log(f"[13] v{version} encode s, mode X (baseline of the same "
            f"pictures): parse+huffman {prof['parse_s']:.3f} "
            f"({bprof['parse_s']:.3f}), symbolize {prof['symbolize_s']:.3f} "
            f"({bprof['symbolize_s']:.3f}), coder {prof[coder_key]:.2f} ms "
            f"({bprof[coder_key]:.2f}), finalize+mux "
            f"{prof['finalize_s'] + prof['mux_s']:.3f} "
            f"({bprof['finalize_s'] + bprof['mux_s']:.3f}), wall {wall:.3f} "
            f"({bwall:.3f}); peak max_memory_allocated "
            f"{peak / 2**30:.2f} GiB ({bpeak / 2**30:.2f}); symbols "
            f"{prof['symbols']} ({bprof['symbols']})")
        log(f"[13] v{version} decode s, mode X (baseline): read+demux "
            f"{dprof['read_s']:.3f} ({bdprof['read_s']:.3f}), plan+upload "
            f"{dprof['plan_s']:.3f} ({bdprof['plan_s']:.3f}), reader "
            f"{dprof[reader_key]:.2f} ms ({bdprof[reader_key]:.2f}), d2h "
            f"{dprof['d2h_s']:.3f} ({bdprof['d2h_s']:.3f}), recode "
            f"{dprof['recode_s']:.3f} ({bdprof['recode_s']:.3f}), wall "
            f"{dwall:.3f} ({bdwall:.3f}); peak max_memory_allocated "
            f"{dpeak / 2**30:.2f} GiB ({bdpeak / 2**30:.2f})")
        log(f"[13] v{version} coder again, mode X: all 64 lanes "
            f"{again_ms:.2f} ms {stage_split(again)}, longest lane "
            f"{prof['max_lane_symbols']} symbols; baseline: {bagain_ms:.2f} "
            f"ms {stage_split(bagain)}, longest lane "
            f"{bprof['max_lane_symbols']} symbols")
        log(f"[13] v{version} reader again, mode X: all 64 lanes "
            f"{dagain_ms:.2f} ms, longest lane {dprof['max_lane_blocks']} "
            f"blocks; baseline: {bdagain_ms:.2f} ms, "
            f"{bdprof['max_lane_blocks']} blocks")
        log(f"[13] v{version} JPEG bytes in {sum(map(len, blobs))} "
            f"({bin_}), .lep bytes out {bytes_out} ({bout}), ratio "
            f"{bytes_out / sum(map(len, blobs)):.4f} ({bout / bin_:.4f})")
        out[version] = ({**enc, **{k: v for k, v in dec.items() if v}},
                        {**prof, **dprof})

    # small files on cuda against cpu
    small = {
        "multi-scan baseline 64x48": multi_scan_jpeg(
            make_photo(SEED + 50, 64, 48)),
        "progressive 64x48 cut in its scan data": cut_in_scan(
            make_photo(SEED + 51, 64, 48, progressive=True)),
        "progressive q100 grayscale 160x96": gray_q100(QUIRK_SEED, 160, 96),
        "CMYK 64x48": make_photo(SEED + 53, 64, 48, mode="CMYK"),
    }
    for what, data in small.items():
        want = data if what.startswith("CMYK") else reemit_of_parse(data)
        for version in (1, 3):
            kw = dict(num_segments=4, version=version,
                      allow_progressive=True, allow_four_colors=True)
            lep = api.compress_device(data, **kw)
            if lep != api.compress_device(data, device="cpu", **kw):
                fail(f"{what} v{version}: cuda and cpu .lep bytes differ")
            if api.decompress_device(lep) != want:
                fail(f"{what} v{version}: the decode differs from the "
                     "host re-emit of its parse")
        log(f"[13] {what} ({len(data)} bytes, mode {chr(lep[3])}"
            f"{', early EOF' if 'cut' in what else ''}): v1 and v3 bytes "
            f"equal on cuda and cpu; decoded to "
            + ("the original" if want == data
               else "the host re-emit of its parse (the q100 quirk)"))

    # one 12 MP CMYK photo, v1
    cmyk = make_photo(SEED + 60, 4032, 3024, mode="CMYK")
    reset_launches()
    t = time.perf_counter()
    cprof = {}
    lep = api.batch_compress_device([cmyk], stats=cprof,
                                    allow_four_colors=True)[0]
    torch.cuda.synchronize(dev)
    cwall = time.perf_counter() - t
    expect_launches("CMYK encode", run_heads=1, walk_runs=1, vpx_walk=1)
    reset_launches()
    t = time.perf_counter()
    cdprof = {}
    back = api.batch_decompress_device([lep], stats=cdprof)[0]
    torch.cuda.synchronize(dev)
    cdwall = time.perf_counter() - t
    expect_launches("CMYK decode", vpx_reader=1)
    if back != cmyk:
        fail("the 12 MP CMYK photo did not come back byte for byte")
    log(f"[13] CMYK 4032x3024 q90 ({len(cmyk)} bytes, .lep {len(lep)}, "
        f"ratio {len(lep) / len(cmyk):.4f}), v1, {cprof['lanes']} lanes: "
        f"one launch of each coder kernel and of the VPX reader, the "
        f"original back; encode wall {cwall:.3f} s (coder "
        f"{cprof['coder_ms']:.2f} ms), decode wall {cdwall:.3f} s (reader "
        f"{cdprof['vpx_decoder_ms']:.2f} ms, recode "
        f"{cdprof['recode_s']:.3f} s)")
    return out


SERVE_ROUTES = ("mode_y", "encode_batch_failed", "verify_failed",
                "decode_failed", "host_kind")


class Server:
    """The -tpu batch server as a user starts it (python -m
    lepton_tpu_torch -tpu -socket=... -zliblisten=...), its stderr in a
    file, and clients that open every connection and send every payload
    before they read any reply."""

    def __init__(self, tmp: str, phase: str = "14"):
        import socket
        self.phase = phase
        self.sock = os.path.join(tmp, "serve.sock")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            self.port = s.getsockname()[1]
        self.err_path = os.path.join(tmp, "serve.err")
        self.err = open(self.err_path, "w")
        t = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "lepton_tpu_torch", "-tpu",
             f"-socket={self.sock}", f"-zliblisten={self.port}"],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            stdout=subprocess.DEVNULL, stderr=self.err)
        while "tpu batch serving enabled" not in self.stderr():
            if self.proc.poll() is not None or time.perf_counter() - t > 300:
                fail(f"[{phase}] the server did not start: "
                     f"{self.stderr()}")
            time.sleep(0.2)
        self.start_s = time.perf_counter() - t
        self.seen = 0

    def stderr(self) -> str:
        if not self.err.closed:
            self.err.flush()
        with open(self.err_path) as f:
            return f.read()

    def ask(self, payloads, zlib_port: bool = False):
        """(replies, wall s, the records of the waves that served them)."""
        import socket
        import zlib
        t = time.perf_counter()
        conns = []
        for _ in payloads:
            if zlib_port:
                c = socket.create_connection(("localhost", self.port))
            else:
                c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                c.connect(self.sock)
            c.settimeout(600)
            conns.append(c)
        for c, p in zip(conns, payloads):
            c.sendall(zlib.compress(p) if zlib_port else p)
            c.shutdown(socket.SHUT_WR)
        replies = []
        for c in conns:
            chunks = []
            while True:
                b = c.recv(1 << 20)
                if not b:
                    break
                chunks.append(b)
            c.close()
            r = b"".join(chunks)
            replies.append(zlib.decompress(r) if zlib_port and r else r)
        wall = time.perf_counter() - t
        waves = []
        deadline = time.perf_counter() + 60
        while sum(w["n"] for w in waves) < len(payloads):
            if time.perf_counter() > deadline:
                fail(f"[{self.phase}] the server's wave lines are missing: "
                     f"{self.stderr()[-3000:]}")
            lines = [ln for ln in self.stderr().splitlines()
                     if ln.startswith("tpu batch served ")]
            for ln in lines[self.seen:]:
                wave = json.loads(ln.split(" wave=", 1)[1])
                wave["n"] = int(ln.split(" n=", 1)[1].split()[0])
                waves.append(wave)
            self.seen = len(lines)
            time.sleep(0.05)
        return replies, wall, waves

    def children(self) -> list:
        path = f"/proc/{self.proc.pid}/task/{self.proc.pid}/children"
        with open(path) as f:
            return f.read().split()

    def stop(self) -> int:
        import signal
        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            rc = None
        self.err.close()
        return rc


def total(waves, key: str) -> dict:
    """The sum over waves of a dict-valued field of their records."""
    out = {}
    for w in waves:
        for k, v in w[key].items():
            out[k] = out.get(k, 0) + v
    return out


def wave_split(w: dict) -> str:
    """A wave's stage times, s: request reads, then the encode's stages,
    the verification, the decode's stages and the replies."""
    e, d = w["encode"], w["decode"]
    parts = [("read", w.get("read_s", 0.0)),
             ("parse", e.get("parse_s", 0.0)),
             ("symbolize", e.get("symbolize_s", 0.0)
              + e.get("assemble_s", 0.0)),
             ("coder", e.get("coder_ms", 0.0) / 1e3),
             ("mux", e.get("finalize_s", 0.0) + e.get("mux_s", 0.0)),
             ("verify", w["verify_s"]),
             ("reader", d.get("decoder_ms", 0.0) / 1e3),
             ("re-emit", d.get("recode_s", 0.0)),
             ("reply", w.get("reply_s", 0.0))]
    return ", ".join(f"{k} {v:.3f}" for k, v in parts)


def phase_serve(dev, blobs, leps, leps3) -> dict:
    """Phase 14: the CLI and the -tpu batch server through the real entry
    point, on phase 4's four photos and .lep files and phase 9's v3 file.
    Returns the server's launches by kernel and the path of each."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        return _phase_serve(dev, blobs, leps, leps3, tmp)


def _phase_serve(dev, blobs, leps, leps3, tmp: str) -> dict:
    import torch
    from lepton_tpu_torch import api
    t = time.perf_counter()
    want = api.batch_compress_device(blobs, num_segments=8)
    torch.cuda.synchronize(dev)
    want_s = time.perf_counter() - t
    srv = Server(tmp)
    log(f"[14] server up in {srv.start_s:.1f} s (python -m lepton_tpu_torch "
        f"-tpu -socket -zliblisten={srv.port}); the four photos in one "
        f"in-process batch_compress_device(num_segments=8): {want_s:.3f} s")
    try:
        # wave A: the four photos and their v1 .lep files, one wave, the
        # server's first
        replies, wall_a, waves = srv.ask(blobs + leps)
        if len(waves) != 1:
            fail(f"[14] wave A was served in {len(waves)} "
                 "waves, not one")
        a = waves[0]
        if replies[:4] != want:
            fail("[14] wave A: a JPEG reply differs from "
                 "batch_compress_device(num_segments=8)")
        if replies[4:] != blobs:
            fail("[14] wave A: a .lep reply is not its "
                 "original photo")
        if any(a["host"].values()):
            fail("[14] wave A went to the host path: "
                 f"{a['host']}")
        if a["verified"] != 4:
            fail(f"[14] wave A verified {a['verified']} JPEG "
                 "replies, not 4")
        want_l = dict(run_heads=1, walk_runs=1, vpx_walk=1, ans_walk=0,
                      vpx_reader=1, ans_reader=0)
        if a["launches"] != want_l:
            fail(f"[14] wave A launches {a['launches']}, "
                 f"expected {want_l}")
        if a["encode"]["lanes"] != 32 or a["decode"]["lanes"] != 64:
            fail(f"[14] wave A: {a['encode']['lanes']} coder "
                 f"lanes and {a['decode']['lanes']} reader lanes, not 32 "
                 "and 64")
        log("[14] wave A: 4 JPEGs + 4 v1 .lep in one wave of "
            f"8, every reply right, host routes all 0, {a['verified']} "
            "replies verified by the host decoder, launches "
            f"{a['launches']}, {a['encode']['lanes']} coder lanes, "
            f"longest {a['encode']['max_lane_symbols']} symbols; client "
            f"wall {wall_a:.3f} s, wave wall {a['wall_s']:.3f} s "
            f"(transcode {a['transcode_s']:.3f}), peak "
            f"{a['peak_bytes'] / 2**30:.2f} GiB")
        log(f"[14] wave A stage s: {wave_split(a)}; coder ms "
            f"{stage_split(a['encode'])}, reader ms "
            f"{a['decode']['vpx_decoder_ms']:.2f}")

        # wave B: the edges, after wave A's replies are in
        small = make_photo(SEED + 40, 160, 96)
        corrupt = bytearray(make_photo(SEED + 41, 160, 96))
        corrupt[2:6] = b"\xff\xc4\x00\x01"    # a DHT of impossible length
        payload = np.random.default_rng(SEED + 42).integers(
            0, 256, 5000, dtype=np.uint8).tobytes()
        mode_y = api.generic_compress(payload)
        unknown = b"neither a JPEG nor a lepton container"
        small_cpu = api.compress_device(small, num_segments=8, device="cpu")
        replies, wall_b, waves_b = srv.ask(
            [leps3[0], mode_y, small, bytes(corrupt), unknown])
        host_b = total(waves_b, "host")
        together = any(w["jpeg"] == 2 for w in waves_b)
        want_h = dict.fromkeys(SERVE_ROUTES, 0)
        want_h.update(mode_y=1, host_kind=1,
                      encode_batch_failed=2 if together else 1)
        if host_b != want_h:
            fail(f"[14] wave B host routes {host_b}, expected {want_h}")
        if replies != [blobs[0], payload, small_cpu, b"", b""]:
            fail("[14] wave B: a reply is wrong (v3 photo, mode-Y payload, "
                 "small JPEG, or a non-empty reply to the corrupt JPEG or "
                 "the unknown payload)")
        launches_b = total(waves_b, "launches")
        if launches_b["ans_reader"] != 1:
            fail(f"[14] wave B: {launches_b['ans_reader']} rANS reader "
                 "launches, not 1")
        log(f"[14] wave B: v3 .lep, mode-Y .lep, 160x96 JPEG, corrupt JPEG, "
            f"unknown payload in {len(waves_b)} wave(s) of "
            f"{[w['n'] for w in waves_b]}; every reply right; host routes "
            f"{ {k: v for k, v in host_b.items() if v} }; launches "
            f"{launches_b}; client wall {wall_b:.3f} s, wave walls "
            f"{[round(w['wall_s'], 3) for w in waves_b]} s")
        for k, w in enumerate(waves_b):
            log(f"[14] wave B.{k} stage s: {wave_split(w)}")

        # wave C: one small JPEG alone, over the zlib port
        small_c = make_photo(SEED + 43, 160, 96)
        want_c = api.compress_device(small_c, num_segments=8)
        replies, wall_c, waves_c = srv.ask([small_c], zlib_port=True)
        c = waves_c[0]
        if replies != [want_c]:
            fail("[14] wave C: the zlib port's reply differs from "
                 "compress_device(num_segments=8)")
        if any(c["host"].values()) or c["launches"]["vpx_walk"] != 1:
            fail(f"[14] wave C: host routes {c['host']}, launches "
                 f"{c['launches']}")
        log(f"[14] wave C: a 160x96 JPEG over the zlib port, served by the "
            f"card (launches {c['launches']}), host routes unchanged; "
            f"client wall {wall_c:.3f} s")
        python_codec = sum(w["python_codec"] for w in [a] + waves_b + [c])
        if python_codec:
            fail(f"[14] the server's waves took the Python segment codec "
                 f"{python_codec} times")
        kids = srv.children()
        if kids:
            fail(f"[14] the server left children {kids}")
    finally:
        rc = srv.stop()
    if rc != 0:
        fail(f"[14] the server exited with {rc}: {srv.stderr()[-3000:]}")

    # the one-shot CLI, encode then decode, through the card
    src = os.path.join(tmp, "photo0.jpg")
    lep, back = os.path.join(tmp, "photo0.lep"), os.path.join(tmp, "back.jpg")
    with open(src, "wb") as f:
        f.write(blobs[0])
    walls = []
    # the encode as JAX scripts call it, the decode with the port's default
    for flags, a_in, a_out in ((["-tpu"], src, lep), ([], lep, back)):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "lepton_tpu_torch", *flags,
                            a_in, a_out], cwd=HERE, capture_output=True,
                           text=True, env=dict(os.environ, PYTHONPATH=HERE),
                           timeout=600)
        walls.append(time.perf_counter() - t)
        if r.returncode != 0 or "falling back" in r.stderr \
                or "host codec" in r.stderr:
            fail(f"[14] the CLI {flags} on {a_in}: rc {r.returncode}, "
                 f"{r.stderr[-2000:]}")
    with open(lep, "rb") as f:
        cli_lep = f.read()
    with open(back, "rb") as f:
        cli_back = f.read()
    if cli_lep != want[0] or cli_back != blobs[0]:
        fail("[14] the -tpu CLI: .lep differs from the server's, or the "
             "decode is not the original")
    log(f"[14] one-shot CLI on the card: photo 0 encode (-tpu) "
        f"{walls[0]:.2f} s, decode (no device flag) {walls[1]:.2f} s "
        f"(process start included); .lep equal to the server's, the "
        f"original back; server exited 0")
    # a device call over its time budget is a card fault: exit 1 at once,
    # a message naming CUDA, no output, no host fallback
    hung = os.path.join(tmp, "hung.lep")
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lepton_tpu_torch", src, hung],
                       cwd=HERE, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=HERE,
                                LEPTON_TPU_TIMEOUT_S="0.05"))
    hung_wall = time.perf_counter() - t
    if r.returncode != 1 or "CUDA card failure" not in r.stderr \
            or "falling back" in r.stderr \
            or (os.path.exists(hung) and os.path.getsize(hung)):
        fail(f"[14] the CLI past LEPTON_TPU_TIMEOUT_S=0.05: rc "
             f"{r.returncode}, {r.stderr[-2000:]}")
    log(f"[14] the CLI with LEPTON_TPU_TIMEOUT_S=0.05: exit 1 in "
        f"{hung_wall:.2f} s, no output, no host fallback "
        f"({r.stderr.strip().splitlines()[-1]})")
    launched = total([a] + waves_b + waves_c, "launches")
    paths = dict(
        run_heads="phase 14 waves A and C (and B when the small "
                  "JPEG is served alone): -tpu server, 8 segments a photo",
        walk_runs="as run_heads", vpx_walk="as run_heads",
        ans_walk="none: the -tpu server encodes v1, as lepton -tpu does",
        vpx_reader="phase 14 wave A: four v1 .lep of 16 segments",
        ans_reader="phase 14 wave B: one v3 .lep of 16 segments")
    return {k: (launched[k], paths[k]) for k in paths}


RANK_TIMEOUT_S = 600           # each rank of run_ranks, and its gloo group
RANK_SCRIPT = r"""
import json, sys, time
repo, rank, coord, src, out, nseg, device, timeout = sys.argv[1:9]
sys.path.insert(0, repo)
rank, nseg = int(rank), int(nseg)
import torch.distributed as dist
from lepton_tpu_torch.kernels import branch_probs, vpx_coder
from lepton_tpu_torch.parallel import multihost
multihost.init_distributed(coord, 2, rank, timeout_s=float(timeout))
stats = {}
t = time.perf_counter()
lep = multihost.distributed_compress(
    open(src, "rb").read(), num_segments=nseg,
    device=None if device == "default" else device, stats=stats)
stats["wall_s"] = time.perf_counter() - t
stats["launches"] = {fn.__name__: fn.launches for fn in (
    branch_probs.run_heads, branch_probs.walk_runs, vpx_coder.vpx_walk)}
with open(out + str(rank), "wb") as f:
    f.write(lep)
print("rank " + json.dumps(stats), flush=True)
dist.destroy_process_group()
"""


def run_ranks(jpeg: bytes, nseg: int, device: str, tmp: str,
              timeout: float = RANK_TIMEOUT_S) -> list:
    """distributed_compress of `jpeg` in nseg segments by two processes,
    ranks 0 and 1 of a gloo group on a free port of 127.0.0.1, each a
    `python -c` child on `device` ("default" for distributed_compress's
    own choice, cuda:<rank mod cards>).  Returns [(.lep bytes, the rank's
    stats with its wall_s and its coder launches)] a rank.  Raises
    RuntimeError with both ranks' stderr unless both exit 0 within
    `timeout` seconds; no child outlives the call."""
    import socket
    src = os.path.join(tmp, "ranks.jpg")
    out = os.path.join(tmp, "ranks.lep")
    with open(src, "wb") as f:
        f.write(jpeg)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, HERE, str(rank), coord, src, out,
         str(nseg), device, str(timeout)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    deadline = time.perf_counter() + timeout
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.perf_counter())))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs += [p.communicate() for p in procs[len(outs):]]
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("distributed_compress ranks exited "
                           f"{[p.returncode for p in procs]}:\n" + "\n".join(
                               f"rank {r} stderr: {e[-3000:]}"
                               for r, (_, e) in enumerate(outs)))
    res = []
    for rank, (so, _) in enumerate(outs):
        line = [ln for ln in so.splitlines() if ln.startswith("rank ")][-1]
        with open(out + str(rank), "rb") as f:
            res.append((f.read(), json.loads(line[5:])))
    return res


def phase_parallel(dev, blobs, leps, leps3, descs) -> dict:
    """Phase 15: the parallel layer on the card, with every mesh made of
    cuda:0 repeated (one card): make_mesh, sharded_phase_a, the
    lane-sharded decode of phase 4's v1 and phase 9's v3 files, the card
    routes of batch_compress and batch_decompress, and distributed_compress
    in two processes.  Returns {counter: (launches, path)} of its routes."""
    import tempfile
    import torch
    from lepton_tpu_torch import api
    from lepton_tpu_torch.kernels import contexts, vpx_decoder
    from lepton_tpu_torch.parallel import mesh as pmesh
    from lepton_tpu_torch.parallel import multihost
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    launched = dict.fromkeys(launch_counts(), 0)

    m = pmesh.make_mesh()
    log(f"[15] make_mesh(): shape {m.shape}, devices "
        f"{[str(d) for d in m.devices.flat]}")
    if m.size != torch.cuda.device_count():
        fail(f"[15] make_mesh() holds {m.size} devices of "
             f"{torch.cuda.device_count()}")
    grid = pmesh.Mesh(np.array([dev] * 4, dtype=object).reshape(2, 2),
                      ("data", "seg"))

    # sharded phase A: the luma planes in two row bands each
    ct = descs[0]["color_tables"][0]
    tabs = [np.asarray(a, np.int32) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y)]
    if any(not np.array_equal(d["color_tables"][0].quant, ct.quant)
           for d in descs):
        fail("[15] the photos' luma tables differ")
    H, W = descs[0]["planes"][0].shape[:2]
    batch = np.stack([d["planes"][0][:H // 2 * 2] for d in descs]).reshape(
        len(descs), 2, H // 2, W, 64)
    t = time.perf_counter()
    bundle = pmesh.sharded_phase_a(batch, *tabs, grid)
    torch.cuda.synchronize(dev)
    sharded_s = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(batch.shape[0]):
        for j in range(2):
            ref = contexts.phase_a(torch.as_tensor(batch[i, j], device=dev),
                                   *(torch.as_tensor(a, device=dev)
                                     for a in tabs))
            for key, v in ref.items():
                if not torch.equal(bundle[key][i, j], v):
                    fail(f"[15] sharded_phase_a {key} of shard ({i}, {j}) "
                         "differs from phase_a on it alone")
    torch.cuda.synchronize(dev)
    alone_s = time.perf_counter() - t
    log(f"[15] sharded_phase_a on a (2, 2) mesh of {dev}: "
        f"{list(batch.shape)} in {sharded_s:.3f} s, its {len(bundle)} keys "
        f"equal to phase_a on each of the 8 shards alone ({alone_s:.3f} s)")
    del bundle, ref

    # the lane-sharded decode: 16 lanes over cuda:0 x 2 and x 4
    share_ms = {}
    for version, files in ((1, leps), (3, leps3)):
        coder = "ans" if version == 3 else "vpx"
        counter = f"{coder}_reader"
        for f, (lep, blob) in enumerate(zip(files, blobs)):
            plan = vpx_decoder.plan_decode([api._decode_request(lep)[0]],
                                           coder)
            inputs = plan.to(dev)
            (coef_u, err_u), ms_u = timed_cuda(
                lambda: vpx_decoder.decode_lanes(**inputs))
            del inputs
            for n in (2, 4):
                seg = pmesh.Mesh([dev] * n, ("seg",))
                reset_launches()
                st = {}
                t = time.perf_counter()
                out = api.batch_decompress_device([lep], stats=st,
                                                  mesh=seg)[0]
                wall = time.perf_counter() - t
                launched[counter] += expect_launches(
                    f"[15] v{version} file {f} over {dev} x{n}",
                    **{counter: n})[counter]
                if out != blob:
                    fail(f"[15] v{version} file {f} over {dev} x{n}: not "
                         "the original JPEG")
                coef, err, *_ = pmesh.decode_shares(plan, seg, None, dev)
                if not (torch.equal(coef, coef_u)
                        and torch.equal(err, err_u)):
                    fail(f"[15] v{version} file {f} over {dev} x{n}: merged "
                         "planes differ from the unsplit launch's")
                del coef, err
                ms = st[f"{coder}_decoder_ms"]
                share_ms.setdefault((version, n), []).append(max(ms) / ms_u)
                log(f"[15] v{version} file {f} over {dev} x{n}: {n} "
                    f"{coder} reader launches of {16 // n} lanes, ms "
                    f"{[round(x, 2) for x in ms]} against {ms_u:.2f} "
                    f"unsplit; merge {st['merge_s']:.3f} s, wall "
                    f"{wall:.3f} s; planes equal, JPEG back")
            del coef_u, err_u
    log("[15] longest share / unsplit launch, mean of the 4 files: " + ", ".join(
        f"v{v} x{n} {np.mean(r):.2f}" for (v, n), r in share_ms.items()))

    # batch_compress and batch_decompress over the (2, 2) mesh, v1 and v3
    for version, counter in ((1, "vpx_walk"), (3, "ans_walk")):
        t = time.perf_counter()
        host = pmesh.batch_compress(blobs, device="host", max_threads=8,
                                    version=version)
        host_s = time.perf_counter() - t
        one_call = api.batch_compress_device(blobs, num_segments=8,
                                             version=version)
        reset_launches()
        st = {}
        t = time.perf_counter()
        card = pmesh.batch_compress(blobs, mesh=grid, max_threads=8,
                                    version=version, stats=st)
        torch.cuda.synchronize(dev)
        card_s = time.perf_counter() - t
        got = expect_launches(f"[15] batch_compress v{version} over (2, 2)",
                              run_heads=4, walk_runs=4, **{counter: 4})
        for k in ("run_heads", "walk_runs", counter):
            launched[k] += got[k]
        if card != host or card != one_call:
            fail(f"[15] batch_compress v{version}: the card route differs "
                 "from its host route or from batch_compress_device("
                 "num_segments=8)")
        log(f"[15] batch_compress v{version} over a (2, 2) mesh of {dev}, "
            f"max_threads=8: launches {got}; bytes equal to device='host' "
            f"({host_s:.3f} s) and to one batch_compress_device call; wall "
            f"{card_s:.3f} s (parse {st['parse_s']:.3f}, symbolize "
            f"{st['symbolize_s']:.3f}, code {st['code_s']:.3f}, mux "
            f"{st['mux_s']:.3f})")
        for row in st["rows"]:
            log(f"[15]   row {row['data']}: images {row['images']}, "
                f"symbolize {row['symbolize_s']:.3f} s")
        coder_ms = "ans_coder_ms" if version == 3 else "coder_ms"
        for sh in st["shares"]:
            coded = (f"coder {sh[coder_ms]:.2f} ms "
                     f"{stage_split(sh) if 'walk_ms' in sh else ''}"
                     if coder_ms in sh else "no coder launch")
            log(f"[15]   share data {sh['data']} seg {sh['seg']}: "
                f"{sh['lanes']} lanes, assembly {sh['assemble_s']:.3f} s, "
                f"{coded}")
        if version == 1:
            leps_mesh = card
    reset_launches()
    st = {}
    t = time.perf_counter()
    back = pmesh.batch_decompress(leps_mesh, mesh=grid, stats=st)
    card_s = time.perf_counter() - t
    launched["vpx_reader"] += expect_launches(
        "[15] batch_decompress over (2, 2)", vpx_reader=4)["vpx_reader"]
    t = time.perf_counter()
    hback = pmesh.batch_decompress(leps_mesh, device="host")
    host_s = time.perf_counter() - t
    if back != blobs or hback != blobs:
        fail("[15] batch_decompress did not give back the originals")
    log(f"[15] batch_decompress over the (2, 2) mesh: 4 VPX reader "
        f"launches; every JPEG back, card route {card_s:.3f} s, host route "
        f"{host_s:.3f} s")
    for r, row in enumerate(st["rows"]):
        log(f"[15]   row {r}: requests {row['requests']}, {row['lanes']} "
            f"lanes, reader ms {[round(x, 2) for x in row['vpx_decoder_ms']]}"
            f", merge {row['merge_s']:.3f} s, d2h {row['d2h_s']:.3f} s, "
            f"recode {row['recode_s']:.3f} s")
    # lane counts the 'seg' axis does not divide: three v1 files (48 lanes)
    # and a v3 file (16) over a (1, 5) mesh, uneven shares of each coder
    row5 = pmesh.Mesh(np.array([dev] * 5, dtype=object).reshape(1, 5),
                      ("data", "seg"))
    reset_launches()
    st = {}
    t = time.perf_counter()
    back = pmesh.batch_decompress(leps[:3] + leps3[3:], mesh=row5, stats=st)
    card_s = time.perf_counter() - t
    got = expect_launches("[15] batch_decompress over (1, 5)", vpx_reader=5,
                          ans_reader=5)
    launched["vpx_reader"] += got["vpx_reader"]
    launched["ans_reader"] += got["ans_reader"]
    if back != blobs:
        fail("[15] batch_decompress over (1, 5) did not give back the "
             "originals")
    row = st["rows"][0]
    log(f"[15] batch_decompress of 3 v1 + 1 v3 .lep over a (1, 5) mesh of "
        f"{dev}: {row['lanes']} lanes (48 VPX, 16 rANS) in uneven shares, "
        f"5 launches of each "
        f"reader, reader ms vpx "
        f"{[round(x, 2) for x in row['vpx_decoder_ms']]} ans "
        f"{[round(x, 2) for x in row['ans_decoder_ms']]}; every JPEG back "
        f"in {card_s:.3f} s")

    # distributed_compress: world 1 here, then two processes on the card
    t = time.perf_counter()
    world1 = multihost.distributed_compress(blobs[0], num_segments=16)
    world1_s = time.perf_counter() - t
    if multihost.distributed_compress(blobs[0], num_segments=16,
                                      engine="host") != world1:
        fail("[15] distributed_compress: device and host engines differ")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        t = time.perf_counter()
        ranks = run_ranks(blobs[0], 16, "default", tmp)
        ranks_s = time.perf_counter() - t
    for rank, (lep, rs) in enumerate(ranks):
        if lep != world1:
            fail(f"[15] rank {rank}'s .lep differs from the world-1 call")
        if rs["launches"] != dict(run_heads=1, walk_runs=1, vpx_walk=1) \
                or rs["lanes"] != 8:
            fail(f"[15] rank {rank}: lanes {rs['lanes']}, launches "
                 f"{rs['launches']}")
        for k, v in rs["launches"].items():
            launched[k] += v
        log(f"[15] rank {rank} of 2 on {dev}: {rs['lanes']} lanes, launches "
            f"{rs['launches']}; parse {rs['parse_s']:.3f} s, symbolize "
            f"{rs['symbolize_s']:.3f} s, assembly {rs['assemble_s']:.3f} s, "
            f"coder {rs['coder_ms']:.2f} ms "
            f"{stage_split(rs) if 'walk_ms' in rs else ''}, gather "
            f"{rs['gather_s']:.3f} s; distributed_compress "
            f"{rs['wall_s']:.3f} s")
    reset_launches()
    if api.decompress_device(world1) != blobs[0]:
        fail("[15] the cooperative .lep does not decode to photo 0")
    expect_launches("[15] decode of the cooperative .lep", vpx_reader=1)
    log(f"[15] distributed_compress of photo 0 in 16 segments: both ranks' "
        f"bytes equal, equal to the world-1 call ({world1_s:.3f} s) with "
        f"either engine, and decode to the photo; two ranks in "
        f"{ranks_s:.1f} s, process starts included")
    log(f"[15] peak max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
        f"(this process); phase 15 took {time.perf_counter() - t_phase:.1f} s")
    paths = dict(
        run_heads="phase 15: batch_compress v1 and v3 over a (2, 2) mesh "
                  "of cuda:0 (4 each, one a device) and "
                  "distributed_compress's two ranks (1 each)",
        walk_runs="as run_heads",
        vpx_walk="phase 15: batch_compress v1 over (2, 2) (4) and "
                 "distributed_compress's two ranks (1 each)",
        ans_walk="phase 15: batch_compress v3 over (2, 2) (4); "
                 "distributed_compress writes v1",
        vpx_reader="phase 15: the four v1 .lep over cuda:0 x2 and x4 (one "
                   "launch a share), batch_decompress over (2, 2) (4) and "
                   "over (1, 5) (5)",
        ans_reader="phase 15: the four v3 .lep over cuda:0 x2 and x4, and "
                   "one over (1, 5) (5)")
    return {k: (launched[k], paths[k]) for k in paths}


SMALL_W, SMALL_H, SMALL_SEGMENTS = 256, 192, 2   # phase 16 (b)
QM_BITS, QM_CONTEXTS = 20000, 64                 # phase 16 (c)


@contextlib.contextmanager
def python_segment_codec():
    """The host codec's compress and decompress take the pure-Python
    segment codec inside, as where the C library cannot be built."""
    from lepton_tpu_torch import _native
    saved = _native.available
    _native.available = lambda: False
    try:
        yield
    finally:
        _native.available = saved


def phase_native_symbolizer(dev, blobs, leps, leps3, prof, prof3) -> dict:
    """Phase 16: (a) compress_device(symbolizer="native") on phase 4's four
    photos, v1 and v3, each call one launch of run_heads, walk_runs and
    the walk, each .lep equal to phase 4's or phase 9's; (b) the port's
    pure-Python segment codec against the card on a small photo; (c) a
    seeded round trip of the QM coder.  Returns {counter: (launches,
    path)} of (a)."""
    import torch
    from lepton_tpu_torch import api, host
    from lepton_tpu_torch.codec import driver
    from lepton_tpu_torch.coder import jpeg_arith
    from lepton_tpu_torch.container.format import read_container
    from lepton_tpu_torch.container.handoff import (choose_num_threads,
                                                    select_splits)
    from lepton_tpu_torch.container.mux import MuxReader
    from lepton_tpu_torch.kernels import batch_encode
    t_phase = time.perf_counter()
    launched = dict.fromkeys(launch_counts(), 0)

    # (a) the host symbolizer, the card's coder, at full width
    for version, want, walk, ms_key, base in (
            (1, leps, "vpx_walk", "coder_ms", prof),
            (3, leps3, "ans_walk", "ans_coder_ms", prof3)):
        phase = 4 if version == 1 else 9
        for i, b in enumerate(blobs):
            reset_launches()
            st = {}
            t = time.perf_counter()
            lep = api.compress_device(b, num_segments=16, device=dev,
                                      version=version, symbolizer="native",
                                      stats=st)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t
            counts = expect_launches(
                f"[16] native symbolizer, v{version}, photo {i}",
                run_heads=1, walk_runs=1, **{walk: 1})
            for k, v in counts.items():
                launched[k] += v
            if lep != want[i]:
                fail(f"[16] v{version} photo {i}: the native symbolizer's "
                     f".lep differs from phase {phase}'s")
            log(f"[16] v{version} photo {i}: symbolizer=\"native\" .lep "
                f"equal to phase {phase}'s; host symbolize_s "
                f"{st['symbolize_s']:.3f}, assembly {st['assemble_s']:.3f}, "
                f"{ms_key} {st[ms_key]:.2f} {stage_split(st)}, "
                f"{st['lanes']} lanes, longest {st['max_lane_symbols']} "
                f"symbols; wall {wall:.3f} s (parse {st['parse_s']:.3f}); "
                f"phase {phase}'s card symbolize_s for all four photos "
                f"{base['symbolize_s']:.3f}")

    # (b) the Python segment codec against the card, a small photo
    jpeg = make_photo(SEED + 160, SMALL_W, SMALL_H)
    parsed, info, dec = api._parse(jpeg)
    hs = dec.handoffs
    nt = choose_num_threads(len(hs), hs[-1].segment_size
                            - hs[0].segment_size, SMALL_SEGMENTS,
                            SMALL_SEGMENTS)
    splits = select_splits(hs, nt)
    if len(splits) != SMALL_SEGMENTS:
        fail(f"[16] {len(splits)} segments, not {SMALL_SEGMENTS}")
    desc = api._describe(info, dec, splits)
    bounds = desc["splits_y"] + [info.cmpnfo[0].bcv]
    jobs = [(bounds[k], bounds[k + 1], k == len(splits) - 1)
            for k in range(len(splits))]
    mh, cs = host._truncation_geometry(info, dec)
    image = host._python_image(info, dec.planes, mh, cs)
    card = {}
    for version in (1, 3):
        with uncounted():
            card[version] = batch_encode.encode_images_device(
                [desc], version, device=dev)[0]
        t = time.perf_counter()
        py = [driver.encode_segment(image, *j, ans=version == 3)
              for j in jobs]
        py_s = time.perf_counter() - t
        if py != card[version]:
            fail(f"[16] v{version}: the Python encode_segment's streams "
                 "differ from the card coder's")
        log(f"[16] {SMALL_W}x{SMALL_H} in {SMALL_SEGMENTS} segments, "
            f"{'ANS' if version == 3 else 'VPX'}: the Python "
            f"encode_segment's {sum(map(len, py))} stream bytes equal the "
            f"card coder's ({py_s:.2f} s in Python)")
    card_lep = api._container(parsed, dec, splits, nt, card[1], 1)
    python_before = host.SEGMENT_CODEC_ROUTES["python"]
    t = time.perf_counter()
    with python_segment_codec():
        py_lep = host.compress(jpeg, max_threads=SMALL_SEGMENTS,
                               min_threads=SMALL_SEGMENTS)
    py_s = time.perf_counter() - t
    if host.SEGMENT_CODEC_ROUTES["python"] != python_before + 1:
        fail("[16] host.compress did not take the Python route")
    if py_lep != card_lep:
        fail("[16] host.compress on the Python route differs from the "
             "card's .lep")
    if api.decompress_device(py_lep, device=dev) != jpeg:
        fail("[16] decompress_device does not give the photo back from "
             "the Python route's .lep")
    hdr, mux_region = read_container(card_lep)
    demux = MuxReader(mux_region)
    planes = [np.zeros_like(p) for p in dec.planes]
    back = host._python_image(info, planes, mh, cs)
    t = time.perf_counter()
    for k, j in enumerate(jobs):
        driver.decode_segment(back, bytes(demux.buffers[k]), *j)
    dec_s = time.perf_counter() - t
    if not all(np.array_equal(a, b) for a, b in zip(planes, dec.planes)):
        fail("[16] decode_segment of the card's streams differs from the "
             "parse's planes")
    log(f"[16] host.compress on the Python route ({py_s:.2f} s): the "
        f"card's .lep byte for byte, decompress_device gives the photo "
        f"back; decode_segment of the card's streams gives the parse's "
        f"planes ({dec_s:.2f} s)")

    # (c) the QM coder, host only
    rng = random.Random(SEED + 161)
    bits = [int(rng.random() < 0.2) for _ in range(QM_BITS)]
    ctxs = [rng.randrange(QM_CONTEXTS) for _ in range(QM_BITS)]
    w = jpeg_arith.JpegBoolWriter()
    st = jpeg_arith.initial_states(QM_CONTEXTS)
    for b, c in zip(bits, ctxs):
        w.put_bit(b, st, c)
    stream = w.finish()
    r = jpeg_arith.JpegBoolReader(stream)
    st2 = jpeg_arith.initial_states(QM_CONTEXTS)
    if [r.get_bit(st2, c) for c in ctxs] != bits or st2 != st:
        fail("[16] the QM coder's reader does not give its bits back")
    log(f"[16] QM coder: {QM_BITS} bits over {QM_CONTEXTS} contexts in "
        f"{len(stream)} bytes, read back; phase 16 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    path = ("phase 16: compress_device(symbolizer=\"native\") of the four "
            "12 MP photos at 16 segments, v1 and v3, one launch each a call")
    return {k: (v, path) for k, v in launched.items()}


def bad_leps(leps: dict, want: int) -> list:
    """Up to `want` (.lep, kind) pairs of phase 17's soak cases whose
    truncated or bit-flipped container the host codec refuses, each kind
    in turn: the hostile requests of the server wave."""
    from lepton_tpu_torch import host, soak
    out = {"truncate": [], "bitflip": []}
    for i, lep in sorted(leps.items()):
        if i >= SOAK_CASES:         # a multi-segment case
            continue
        case = soak.Case(SOAK_SEED, i)
        for check, blob, _ in soak._hostile_variants(case, lep):
            try:
                host.decompress(blob)
            except Exception:
                out[check].append(blob)
    pairs = [(b, k) for k in out for b in out[k][:want // 2]]
    if len(pairs) < want:
        fail(f"[17] only {len(pairs)} refused hostile containers, not {want}")
    return pairs


def past_cut_lanes(dev) -> None:
    """Both readers on soak.past_cut_lanes' streams, whose row past an
    early-EOF cut codes a non-zero block 0: the kernel's planes and flags
    equal the plain reader's and the host's C segment decoder's, and that
    block is decoded."""
    from lepton_tpu_torch import soak
    from lepton_tpu_torch.kernels import vpx_decoder
    for version, coder in ((1, "vpx"), (3, "ans")):
        lep, req, past = soak.past_cut_lanes(version)
        plan = vpx_decoder.plan_decode([req], coder)
        got = [t.cpu().numpy() for t in vpx_decoder.decode_lanes(
            **plan.to(dev))]
        want = [t.numpy() for t in vpx_decoder.decode_lanes(
            **plan.to("cpu"))]
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail(f"[17] {coder} reader: a row past the cut differs from the "
                 f"plain reader")
        if soak.host_diffs(plan, [(lep, req)], *got):
            fail(f"[17] {coder} reader: a row past the cut differs from the "
                 f"host's C segment decoder")
        for c, y in past:
            o, _, w = plan.planes[0][c]
            if not got[0][o + y * w].any():
                fail(f"[17] {coder} reader: block 0 of row {y} of component "
                     f"{c}, past the cut, not decoded")


def phase_soak(dev, smi: str, blobs, leps, leps3) -> dict:
    """Phase 17: the soak on the card, the main path's 16-segment files
    truncated and bit-flipped, the hostile kernel batches and a server
    wave of corrupt .lep files.  Returns each kernel's launches in the
    soak and its path."""
    import tempfile

    import torch
    from lepton_tpu_torch import soak
    t_phase = time.perf_counter()
    reset_launches()
    report = soak.run(SOAK_CASES, SOAK_SEED, dev, log=log,
                      multi=soak.MULTI_SEGMENTS)
    torch.cuda.synchronize(dev)
    launched = launch_counts()
    s = report.summary()
    log(f"[17] soak: {report.cases} cases of seed {SOAK_SEED} "
        f"({report.skipped} that PIL refused), kinds {s['kinds']}, .lep "
        f"segments {s['segments']}")
    log(f"[17] soak outcome counts {json.dumps(s['counts'])}; full "
        f"original from a cut container {report.full_from_cut}")
    log(f"[17] soak by check {json.dumps(s['by_check'])}")
    log(f"[17] soak stage s {json.dumps(s['seconds'])}; launches "
        f"{launched}; "
        f"{report.cases / sum(s['seconds'].values()):.2f} cases a second")
    if report.failed:
        for i, check, detail in report.failures:
            log(f"[17] FAIL case {i} {check}: {detail}")
        fail(f"[17] {report.failed} soak checks failed")
    kinds = set(s["kinds"])
    for need in ("v1", "v2", "v3", " Z ", " X ", "L", "RGB", "CMYK"):
        if not any(need in k for k in kinds):
            fail(f"[17] the soak drew no case of {need.strip()}: {kinds}")
    if min(launched.values()) < 1:
        fail(f"[17] the soak left a kernel unlaunched: {launched}")
    multi = sum(n for k, n in s["segments"].items() if 2 <= k <= 8)
    held = s["by_check"].get("segments", {}).get("ok", 0)
    if held != len(soak.MULTI_SEGMENTS) or multi < len(soak.MULTI_SEGMENTS):
        fail(f"[17] multi-segment cases: {held} held their segment counts "
             f"{soak.MULTI_SEGMENTS}; .lep segments {s['segments']}")
    log(f"[17] the {len(soak.MULTI_SEGMENTS)} multi-segment cases coded "
        f"{list(soak.MULTI_SEGMENTS)} segments on the card, as on the "
        f"host, and passed every check")

    t = time.perf_counter()
    past_cut_lanes(dev)
    log(f"[17] rows past an early-EOF cut: the VPX and rANS readers decode "
        f"block 0, equal to the plain reader and the host's C segment "
        f"decoder ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    big = soak.hostile_containers(leps + leps3, blobs + blobs, dev)
    torch.cuda.synchronize(dev)
    log(f"[17] phase 4's and phase 9's 16-segment .lep files, each cut "
        f"and bit-flipped three times, in one batch_decompress_device "
        f"call: outcome counts {json.dumps(big.counts)}, by check "
        f"{json.dumps(big.by_check)} ({time.perf_counter() - t:.1f} s)")
    if big.failed:
        for i, check, detail in big.failures:
            log(f"[17] FAIL 12 MP file {i} {check}: {detail}")
        fail(f"[17] {big.failed} checks of the 16-segment files failed")
    t = time.perf_counter()
    with uncounted():
        readers = soak.hostile_readers(dev, list(report.leps.values()))
        torch.cuda.synchronize(dev)
        log(f"[17] hostile reader batches (random, empty and cut streams) "
            f"equal to the plain reader and the host's C segment decoder, "
            f"two launches bitwise equal, a good file decoded after: "
            f"{readers} ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        coders = soak.hostile_coders(dev)
        torch.cuda.synchronize(dev)
    log(f"[17] hostile coder lanes at {[n for n, _ in soak.CODER_SHAPES]} "
        f"lanes equal to the plain stages, twice: longest stream bytes "
        f"{coders} ({time.perf_counter() - t:.1f} s)")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_soak_") as tmp:
        served = _soak_wave(report, tmp)
    log(f"[17] phase 17 took {time.perf_counter() - t_phase:.1f} s on "
        f"{smi}")
    path = (f"phase 17: the soak's {report.cases} cases, one "
            "batch_compress_device call a version, one "
            "batch_decompress_device(per_request=True) call of every .lep "
            "and its truncated and bit-flipped variants, the single and "
            "auxiliary calls")
    return {k: (v, path) for k, v in launched.items()} | {
        "served": served, "leps": report.leps}


def _soak_wave(report, tmp: str) -> dict:
    """Phase 17's server waves: good .lep files beside bit-flipped and
    truncated ones that the host codec refuses, then a wave of good
    requests alone.  Returns the host routes of the hostile wave."""
    from lepton_tpu_torch import soak
    good = sorted(report.leps)[:4]
    blobs = [report.leps[i] for i in good]
    wants = [soak.Case(SOAK_SEED, i).jpeg for i in good]
    bad = bad_leps(report.leps, 4)
    srv = Server(tmp, "17")
    try:
        replies, wall, waves = srv.ask(blobs + [b for b, _ in bad])
        routes = total(waves, "host")
        if replies[:4] != wants:
            fail("[17] a good .lep beside hostile ones did not come back")
        if any(replies[4:]):
            fail("[17] a hostile .lep got a non-empty reply")
        if routes["decode_failed"] != len(bad) or sum(routes.values()) \
                != len(bad):
            fail(f"[17] host routes {routes}, expected decode_failed "
                 f"{len(bad)}")
        launches = total(waves, "launches")
        log(f"[17] server wave of {len(blobs)} good and {len(bad)} hostile "
            f".lep ({', '.join(k for _, k in bad)}) in {len(waves)} "
            f"wave(s): good replies right, hostile replies empty, host "
            f"routes {routes}, launches {launches}, client wall "
            f"{wall:.3f} s")
        replies, wall, waves = srv.ask(blobs[:2])
        if replies != wants[:2] or any(total(waves, "host").values()):
            fail("[17] the wave after the hostile one was not served by "
                 "the card")
        if srv.proc.poll() is not None:
            fail(f"[17] the server stopped: {srv.stderr()[-2000:]}")
        log(f"[17] next wave served by the card in {wall:.3f} s; server "
            "still up, no card fault")
    finally:
        rc = srv.stop()
    if rc != 0 or "CUDA card failure" in srv.stderr():
        fail(f"[17] the server exited with {rc}: {srv.stderr()[-3000:]}")
    return routes


CHECKED_TIMEOUT_S = 600        # phase 19's sanitize card subprocess


def phase_checked(dev, smi: str, blobs, leps, leps3, soak_leps) -> dict:
    """Phase 19: the default builds' ptxas reports against PTXAS_BASELINE,
    then sanitize card with the checked builds in a subprocess, its
    outputs held to the default build's on the same inputs.  Returns
    {"sites": check sites a source, "ms": {kernel row: (checked ms,
    default ms)}}."""
    import tempfile

    import torch
    from lepton_tpu_torch import sanitize, soak
    from lepton_tpu_torch.kernels import cuda_build
    t_phase = time.perf_counter()
    for name in cuda_build.SOURCES:
        got = ptxas_lines(cuda_build.ptxas_report[name])
        if got != PTXAS_BASELINE[name]:
            fail(f"[19] the default build of {name} is not what it was "
                 f"before the checks: ptxas {got}, before "
                 f"{PTXAS_BASELINE[name]}")
    log(f"[19] ptxas reports of the {len(cuda_build.SOURCES)} default "
        f"builds equal their reports from before the bounds checks "
        f"(registers, barriers, shared memory, stack and spills)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_checked_") as tmp:
        for k, b in enumerate(blobs):
            with open(os.path.join(tmp, f"photo{k}.jpg"), "wb") as f:
                f.write(b)
        out = os.path.join(tmp, "checked.json")
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "lepton_tpu_torch.sanitize", "card",
             "--photos", tmp, "--out", out], cwd=HERE,
            env=dict(os.environ, **{cuda_build.CHECKED_ENV: "1"}),
            capture_output=True, text=True, timeout=CHECKED_TIMEOUT_S)
        child_s = time.perf_counter() - t
        for line in r.stderr.splitlines():
            if line.startswith("sanitize card") or line.startswith(
                    sanitize.CLEAN_CARD):
                log(f"[19] {line}")
        if r.returncode != 0 or not os.path.exists(out):
            fail(f"[19] sanitize card exited {r.returncode}: "
                 f"{r.stderr[-4000:]}")
        with open(out) as f:
            res = json.load(f)
    if len(res["negative"]) != 6:
        fail(f"[19] {len(res['negative'])} negative checks, not 6")
    # the default build on the same inputs, in this process
    t = time.perf_counter()
    with uncounted():
        # this process's kernels are loaded: one run, timed as it is
        main = sanitize.main_batch(dev, blobs, runs=1)
        readers, coders = soak.hostile_only(sanitize.HOSTILE_CASES, 0, dev)
        torch.cuda.synchronize(dev)
    default_s = time.perf_counter() - t
    for v, files in (("v1", leps), ("v3", leps3)):
        if main[v]["lep"] != [sanitize.digest(b) for b in files]:
            fail(f"[19] {v}: the default build's main batch differs from "
                 f"phase 4's and 9's .lep files")
        for key in ("lep", "lep_bytes", "planes", "err", "lanes"):
            if res["main"][v][key] != main[v][key]:
                fail(f"[19] {v} main batch: the checked build's {key} "
                     f"{res['main'][v][key]} differs from the default "
                     f"build's {main[v][key]}")
    hostile = json.loads(json.dumps({"readers": readers, "coders": coders}))
    if res["hostile"] != hostile:
        fail(f"[19] hostile batches: checked {res['hostile']}, default "
             f"{hostile}")
    for i, d in res["soak"]["leps"].items():
        if sanitize.digest(soak_leps[int(i)]) != d:
            fail(f"[19] soak case {i}: the checked build's .lep differs "
                 f"from phase 17's")
    log(f"[19] checked == default: the main batch's 64 lanes both ways "
        f"(.lep digests, planes and err flags, v1 and v3), the hostile "
        f"batches {hostile}, the soak's {len(res['soak']['leps'])} case "
        f".lep files (outcome counts {res['soak']['counts']}); checked "
        f"run {child_s:.1f} s ({json.dumps(res['seconds'])}), default "
        f"run {default_s:.1f} s")
    # a row's ms: v1's for the probability stage's kernels, as phase 4's
    ms = {}
    for v in ("v3", "v1"):
        pairs = {k: (got, main[v]["ms"][k])
                 for k, got in res["main"][v]["ms"].items()}
        ms.update(pairs)
        log(f"[19] {v} kernel ms on the main batch, checked / default "
            f"build: " + ", ".join(f"{k} {a:.2f} / {b:.2f} ({a / b:.2f}x)"
                                   for k, (a, b) in pairs.items()))
    log(f"[19] check sites a source: {res['sites']}")
    log(f"[19] phase 19 took {time.perf_counter() - t_phase:.1f} s on "
        f"{smi}")
    return {"sites": res["sites"], "ms": ms}


BENCH_COUNTERS = {"vpx_coder": "vpx_walk", "run_heads": "run_heads",
                  "walk_runs": "walk_runs", "ans_coder": "ans_walk",
                  "vpx_decoder": "vpx_reader", "ans_reader": "ans_reader"}


def phase_bench(dev, smi: str, blobs) -> dict:
    """Phase 18: the port's bench runner (lepton_tpu_torch/bench.py,
    python -m lepton_tpu_torch.bench) in this process, on phase 4's
    photos: every section, each run held to its gates.  Logs the runner's
    object on a line of its own; returns each kernel's launches in the
    run and its path."""
    import torch
    from lepton_tpu_torch import bench
    t = time.perf_counter()
    torch.cuda.empty_cache()
    reset_launches()
    res = bench.run(dev, blobs=blobs, log=lambda m: log(f"[18] {m}"))
    torch.cuda.synchronize(dev)
    launched = launch_counts()
    log(json.dumps(res))
    if res.get("ok") is not True:
        fail(f"[18] the runner's line says ok {res.get('ok')}")
    if min(launched.values()) < 1:
        fail(f"[18] the bench left a kernel unlaunched: {launched}")
    for v in ("v1", "v3"):
        e, d = res["batch_encode"][v], res["batch_decode"][v]
        enc = res["encode_latency"][v]["encode_latency_s"]["median"]
        dec = res["decode_latency"][v]["decode_latency_s"]["median"]
        log(f"[18] batch_encode {v}: {e['encode_mbps']['median']:.2f} MB/s "
            f"(min {e['encode_mbps']['min']:.2f}, max "
            f"{e['encode_mbps']['max']:.2f}), peak "
            f"{e['peak_bytes'] / 2**30:.2f} GiB; batch_decode "
            f"{d['decode_mbps']['median']:.2f} MB/s; encode_latency "
            f"{enc:.3f} s, decode_latency {dec:.3f} s")
    for n, row in res["knee"]["sweep"].items():
        log(f"[18] knee, {n} images, {row['lanes']} lanes: encode "
            f"{row['encode']['encode_mbps']['median']:.2f} MB/s, coder "
            f"{row['encode']['coder_msym_per_s']['median']:.1f} Msym/s, "
            f"decode {row['decode']['decode_mbps']['median']:.2f} MB/s, "
            f"peak {row['encode']['peak_bytes'] / 2**30:.2f} GiB, key "
            f"shift "
            f"{row['key_shift']}")
    log(f"[18] launches {launched}; phase 18 took "
        f"{time.perf_counter() - t:.1f} s on {smi}")
    path = ("phase 18: bench.run, every section of python -m "
            "lepton_tpu_torch.bench on phase 4's photos and the knee "
            "corpus")
    return {k: (v, path) for k, v in launched.items()}


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    try:
        from lepton_tpu_torch import api
        from lepton_tpu_torch.kernels import (ans_coder, batch_encode,
                                              cuda_build, vpx_coder,
                                              vpx_decoder)
        from lepton_tpu_torch.model.tables import (ARENA_SIZE,
                                                   arena_from_template)
        from lepton_tpu_torch.probes import decode_roofline
    except ImportError as e:
        fail(f"lepton_tpu_torch is not beside chip_smoke.py: {e}")
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"card: {card} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---- phase 1: build the kernels, one nvcc each, together
    builds = (("1", "branch_probs"), ("1", "vpx_coder"), ("5", "vpx_decoder"),
              ("8", "ans_coder"), ("12", "decode_roofline"))
    took = cuda_build.build([kname for _, kname in builds], (False, True))
    for is_checked in (False, True):
        for phase, kname in builds:
            stem = cuda_build.variant(kname, is_checked)
            phase = "19" if is_checked else phase
            log(f"[{phase}] built "
                f"{os.path.relpath(cuda_build.so_path(kname, is_checked), HERE)}"
                f" for sm_90a in {took[stem]:.1f} s")
            for line in ptxas_lines(cuda_build.ptxas_report[stem]):
                log(f"[{phase}]   ptxas: {line}")

    # ---- phase 2: kernels against plain on adversarial streams
    idxs, bits = vpx_coder.build_symbol_streams(adversarial_segments())
    idx_a = torch.as_tensor(idxs, device=dev)
    bit_a = torch.as_tensor(bits, device=dev)
    raw = np.random.default_rng(SEED).integers(0, 256, (ARENA_SIZE, 3),
                                               dtype=np.uint8)
    raw[:, 2] = 1 + raw[:, 2] % 254
    tpl = arena_from_template(api.pack_model(raw)).to(dev)
    errs = []
    for label, template in (("identity", None), ("template", tpl)):
        err, ms = compare_coder(idx_a, bit_a, template)
        errs.append(err)
        log(f"[2] adversarial streams {tuple(idx_a.shape)}, {label} start: "
            f"kernels == plain ({fmt_ms(ms)})")
    (idx_s, bit_s, _), stpl = stage_inputs(dev, framed=True)
    for label, template in (("identity", None), ("prob-0 template", stpl)):
        err, ms = compare_coder(idx_s, bit_s, template)
        errs.append(err)
        log(f"[2] stage lanes {tuple(idx_s.shape)}, {label} start: kernels "
            f"== plain ({fmt_ms(ms)})")

    # ---- phase 3: small images, cuda against cpu
    small = make_photo(SEED + 10, 160, 120)
    if api.compress_device(small, device=dev) \
            != api.compress_device(small, device="cpu"):
        fail("compress_device: cuda and cpu .lep bytes differ")
    small4 = make_photo(SEED + 11, 320, 240)
    parsed, info, dec = api._parse(small4)
    desc = api._describe(info, dec, dec.handoffs[:1])
    desc["splits_y"] = [0, 4, 8, 12]
    if (batch_encode.encode_images_device([desc], device=dev)
            != batch_encode.encode_images_device([desc], device="cpu")):
        fail("4-segment encode: cuda and cpu streams differ")
    log("[3] small images: compress_device 160x120 and a 4-segment "
        "320x240 encode give equal bytes on cuda and cpu")

    # ---- phase 4 inputs, and phase 2 on their framed prefixes
    t = time.perf_counter()
    blobs = [make_photo(SEED + k, 4032, 3024) for k in range(4)]
    log(f"[4] made 4 JPEGs 4032x3024 q90 4:2:0 "
        f"({sum(map(len, blobs))} bytes) in {time.perf_counter() - t:.1f} s")
    descs = []
    for b in blobs:
        parsed, info, dec = api._parse(b)
        splits, _ = api._plan(dec, 16)
        descs.append(api._describe(info, dec, splits))
    idx_f, bit_f, _ = batch_encode.assemble_lanes(descs, dev)
    stop = torch.full((idx_f.shape[0], 32), vpx_coder.FIXED_PROB,
                      dtype=torch.int32, device=dev)
    idx_p = torch.cat([idx_f[:, :PREFIX], stop], 1).contiguous()
    bit_p = torch.cat([bit_f[:, :PREFIX], torch.zeros_like(stop,
                      dtype=torch.uint8)], 1).contiguous()
    del idx_f, bit_f
    err, prefix = compare_coder(idx_p, bit_p)
    errs.append(err)
    log(f"[2] framed {PREFIX}-symbol prefix of all {idx_p.shape[0]} lanes: "
        f"kernels == plain ({fmt_ms(prefix)})")
    del idx_p, bit_p
    torch.cuda.empty_cache()

    # ---- phase 4: the main path
    for fn in coder_kernels():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    prof = {}
    leps = api.batch_compress_device(blobs, num_segments=16, stats=prof)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    launches = {fn.__name__: fn.launches for fn in coder_kernels()[:3]}
    peak = torch.cuda.max_memory_allocated(dev)
    if min(launches.values()) < 1:
        fail(f"the main path left a coder kernel unlaunched: {launches}")
    if prof["lanes"] != 64:
        fail(f"expected 64 coder lanes, got {prof['lanes']}")
    for b, lep in zip(blobs, leps):
        if lep[:2] != b"\xcf\x84" or int.from_bytes(lep[-4:], "little") \
                != len(lep) or not len(lep) < len(b):
            fail("malformed or non-shrinking .lep")
    t = time.perf_counter()
    alone = api.compress_device(blobs[0])
    torch.cuda.synchronize(dev)
    single_s = time.perf_counter() - t
    if alone != leps[0]:
        fail("image 0: batch output differs from compress_device alone")
    bytes_in, bytes_out = sum(map(len, blobs)), sum(map(len, leps))
    mp = 4 * 4032 * 3024 / 1e6
    log(f"[4] batch_compress_device: 4 images, {prof['lanes']} lanes, "
        f"launches {launches}; image 0 alone gives equal bytes")
    log(f"[4] stage s: parse+huffman {prof['parse_s']:.3f}, symbolize "
        f"{prof['symbolize_s']:.3f}, assembly {prof['assemble_s']:.3f}, "
        f"coder {prof['coder_ms'] / 1e3:.3f} (CUDA events: "
        f"{stage_split(prof)[1:-1]}), finalize+mux "
        f"{prof['finalize_s'] + prof['mux_s']:.3f}; wall {wall:.3f}")
    log(f"[4] JPEG bytes in {bytes_in}, .lep bytes out {bytes_out}, ratio "
        f"{bytes_out / bytes_in:.4f}; {bytes_in / 1e6 / wall:.2f} MB/s, "
        f"{mp / wall:.2f} MP/s")
    log(f"[4] symbols coded {prof['symbols']}, longest lane "
        f"{prof['max_lane_symbols']}; peak max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; compress_device on image 0 alone "
        f"{single_s:.3f} s")

    # the coder again on the whole batch, and on its longest lane alone:
    # each lane's walk is one serial chain, so the longest bounds it
    idx_f, bit_f, _ = batch_encode.assemble_lanes(descs, dev)
    lane_symbols = (idx_f != vpx_coder.PAD).sum(1).cpu()
    k = int(lane_symbols.argmax())
    again, alone = {}, {}
    _, again_ms = timed_cuda(vpx_coder.encode_streams, idx_f, bit_f, None,
                             again)
    _, alone_ms = timed_cuda(vpx_coder.encode_streams,
                             idx_f[k:k + 1].contiguous(),
                             bit_f[k:k + 1].contiguous(), None, alone)
    log(f"[4] coder again: all {prof['lanes']} lanes {again_ms:.2f} ms "
        f"{stage_split(again)}; longest lane only {alone_ms:.2f} ms "
        f"{stage_split(alone)}, "
        f"{alone['walk_ms'] * 1e6 / prof['max_lane_symbols']:.1f} ns a "
        f"symbol in its walk")

    # least time for the whole coder's work on this run's data: each
    # symbol's int32 index and uint8 bit read once, each stream byte and
    # lane count written once; and for its walk alone, which also reads
    # each symbol's uint8 probability
    t_bytes, t_ops = bound_ms(prof["symbols"] * 5 + bytes_out
                              + 4 * prof["lanes"], prof["symbols"]
                              * (WALK_OPS_PER_SYMBOL + PROBS_OPS_PER_SYMBOL))
    w_bytes, w_ops = bound_ms(prof["symbols"] * 6 + bytes_out
                              + 4 * prof["lanes"],
                              prof["symbols"] * WALK_OPS_PER_SYMBOL)
    kernels = [{
        "name": "vpx_coder", "route": "cuda",
        "source": "lepton_tpu_torch/csrc/vpx_coder.cu",
        "replaces": "lepton_tpu/kernels/pallas_coder.py:44",
        "stage": "the whole VPX coder (encode_streams): the sort, run_heads "
                 "and walk_runs (csrc/branch_probs.cu), then this file's "
                 "walk; ms, plain_ms and bound_ms are the whole coder's, "
                 "walk_* the walk kernel's alone",
        "launches": launches["vpx_walk"], "max_abs_err": max(errs),
        "ms": prof["coder_ms"], "plain_ms": prefix["coder"][1],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "equal_to_plain": True,
        "plain_inputs": f"{PREFIX}-symbol framed prefix of 64 lanes",
        "kernel_ms_on_plain_inputs": prefix["coder"][0],
        "sort_ms": prof["sort_ms"], "probs_ms": prof["probs_ms"],
        "walk_ms": prof["walk_ms"], "walk_plain_ms": prefix["walk"][1],
        "walk_bound_ms": max(w_bytes, w_ops),
        "walk_bound_by": "bytes" if w_bytes >= w_ops else "operations",
        "walk_kernel_ms_on_plain_inputs": prefix["walk"][0],
    }]
    del idx_f, bit_f
    torch.cuda.empty_cache()

    # ---- phase 6: decoder kernel against plain on small images
    derrs = []
    for nseg, w, h in ((1, 64, 48), (2, 96, 64), (4, 96, 64)):
        jpeg, lep = small_lep(SEED + 20 + nseg, w, h, 85, nseg)
        err, ms_k, ms_p = compare_decoder([lep], [jpeg])
        derrs.append(err)
        log(f"[6] {w}x{h}, {nseg} segment(s), identity start: kernel == "
            f"plain (kernel {ms_k:.2f} ms, plain {ms_p:.0f} ms)")
    packed = api.pack_model(raw)
    jpeg, lep = small_lep(SEED + 30, 96, 64, 85, 2, template=packed)
    err, ms_k, ms_p = compare_decoder([lep], [jpeg], template=tpl)
    derrs.append(err)
    log(f"[6] 96x64, 2 segments, template start: kernel == plain (kernel "
        f"{ms_k:.2f} ms, plain {ms_p:.0f} ms)")
    pair = [small_lep(SEED + 31, 96, 64, 90, 2),
            small_lep(SEED + 32, 48, 32, 60, 1)]
    err, ms_k, ms_p = compare_decoder(
        [lep for _, lep in pair], [jpeg for jpeg, _ in pair])
    derrs.append(err)
    log(f"[6] two requests (96x64 q90 in 2 segments, 48x32 q60) in one "
        f"call: kernel == plain (kernel {ms_k:.2f} ms, plain {ms_p:.0f} ms)")

    # ---- phase 7: the main decode path
    vpx_decoder.decode_lanes.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    dprof = {}
    outs = api.batch_decompress_device(leps, stats=dprof)
    torch.cuda.synchronize(dev)
    dwall = time.perf_counter() - t
    dlaunches = vpx_decoder.decode_lanes.launches
    main_counts = vpx_decoder.decode_lanes.cache_counts
    dpeak = torch.cuda.max_memory_allocated(dev)
    if dlaunches < 1:
        fail("the main decode path launched no decoder kernel")
    if dprof["lanes"] != 64:
        fail(f"expected 64 decoder lanes, got {dprof['lanes']}")
    if outs != blobs:
        fail("batch_decompress_device did not give back the original JPEGs")
    t = time.perf_counter()
    alone = api.decompress_device(leps[0])
    torch.cuda.synchronize(dev)
    dsingle_s = time.perf_counter() - t
    if alone != blobs[0]:
        fail("image 0: decompress_device alone differs from the original")
    log(f"[7] batch_decompress_device: 4 images, {dprof['lanes']} lanes, "
        f"{dlaunches} decoder launch(es); every JPEG back byte for byte; "
        f"image 0 alone gives equal bytes")
    log(f"[7] stage s: read+demux {dprof['read_s']:.3f}, plan+upload "
        f"{dprof['plan_s']:.3f}, decoder kernel "
        f"{dprof['decoder_ms'] / 1e3:.3f} (CUDA events), d2h "
        f"{dprof['d2h_s']:.3f}, recode {dprof['recode_s']:.3f}; wall "
        f"{dwall:.3f}")
    log(f"[7] JPEG bytes out {bytes_in} from .lep bytes {bytes_out}; "
        f"{bytes_in / 1e6 / dwall:.2f} MB/s, {mp / dwall:.2f} MP/s; longest "
        f"lane {dprof['max_lane_blocks']} blocks; peak max_memory_allocated "
        f"{dpeak / 2**30:.2f} GiB; decompress_device on image 0 alone "
        f"{dsingle_s:.3f} s")

    # the device planes against the parse's, with the decoder timed again
    # on the whole batch, then on its longest lane alone
    plan = vpx_decoder.plan_decode([api._decode_request(lep, i)[0]
                                    for i, lep in enumerate(leps)])
    inputs = plan.to(dev)
    (coef, derr), dagain_ms = timed_cuda(
        lambda: vpx_decoder.decode_lanes(**inputs))
    for (planes, _), desc in zip(vpx_decoder.split_planes(plan, coef, derr),
                                 descs):
        if not all(torch.equal(a, torch.as_tensor(b, device=dev))
                   for a, b in zip(planes, desc["planes"])):
            fail("device planes differ from the parse's planes")
    del coef, planes        # planes are views of coef
    # the longest lane by the decode plan's blocks; its reads are the coder's
    # symbols of the same segment (lanes are segments in request order on
    # both sides), the marker bit, then one read per coded symbol
    lane_blocks = np.bincount(np.repeat(np.arange(len(plan.lanes)),
                                        plan.lanes[:, 1]),
                              weights=plan.rows[:, 2],
                              minlength=len(plan.lanes)).astype(np.int64)
    kd = int(lane_blocks.argmax())
    if lane_blocks[kd] != dprof["max_lane_blocks"]:
        fail("the decode plan's longest lane differs from the stats'")
    reads = lane_symbols - STOP_BITS
    _, dalone_ms = timed_cuda(
        lambda: vpx_decoder.decode_lanes(**one_lane(inputs, kd)))
    slots = vpx_decoder.cache_slots()
    replay = cache_replay(descs, dev, slots)
    cache_line = check_cache(main_counts, replay, "v1 main path")
    log(f"[7] branch cache of {slots} slots "
        f"({vpx_decoder.smem_bytes(slots)} B of shared memory a CTA) on the "
        f"main path: {cache_line}")
    log(f"[7] device planes equal the parse's; decoder kernel alone: all "
        f"{len(reads)} lanes {dagain_ms:.2f} ms; longest lane ({kd}, "
        f"{lane_blocks[kd]} blocks) only {dalone_ms:.2f} ms, "
        f"{dalone_ms * 1e6 / int(reads[kd]):.1f} ns a read ({int(reads[kd])} "
        f"reads, {int(reads.sum())} in the batch, from the coder's symbol "
        f"counts)")

    # the kernel against its plain version at the main path's shapes: all
    # 64 lanes, cut to a few rows of a few dozen blocks so that the plain
    # version ends in seconds
    cut = cut_lanes(inputs, CUT_ROWS, CUT_WIDTH)
    _, cut_flags, err, cut_k_ms, cut_p_ms = compare_lanes(cut)
    derrs.append(err)
    cut_blocks = int(cut["rows"][:, 2].sum())
    cut_input = (f"the 64 main-path lanes cut to {CUT_ROWS} rows a "
                 f"component of at most {CUT_WIDTH} blocks ({cut_blocks} "
                 f"blocks; plane widths, offsets, ring width "
                 f"{inputs['ring_width']} and {plan.n_blocks} plane blocks "
                 f"as on the main path)")
    log(f"[7] {cut_input}: kernel == plain, planes and err flags ("
        f"{int(cut_flags.count_nonzero())} lanes flagged past the cut); "
        f"kernel {cut_k_ms:.2f} ms, plain {cut_p_ms:.0f} ms")

    # least time for the decoder's work on this run's data: the streams
    # read once, the planes written once, every lane's arena filled once
    dmoved = (int(plan.dlen.sum()) + plan.n_blocks * 64 * 2
              + len(reads) * ARENA_SIZE * 4)
    d_bytes = dmoved / H100_BYTES_PER_S * 1e3
    d_ops = int(reads.sum()) * DECODER_OPS_PER_READ \
        / H100_SCALAR_OPS_PER_S * 1e3
    kernels.append({
        "name": "vpx_decoder", "route": "cuda",
        "source": "lepton_tpu_torch/csrc/vpx_decoder.cu",
        "replaces": "lepton_tpu/kernels/pallas_decode.py:270",
        "launches": dlaunches, "max_abs_err": max(derrs),
        "ms": dprof["decoder_ms"], "plain_ms": cut_p_ms,
        "bound_ms": max(d_bytes, d_ops),
        "bound_by": "bytes" if d_bytes >= d_ops else "operations",
        "library_ms": None,
        "equal_to_plain": True,
        "plain_inputs": cut_input,
        "kernel_ms_on_plain_inputs": cut_k_ms,
        "longest_lane_ms": dalone_ms,
        "ns_a_read_longest_lane": dalone_ms * 1e6 / int(reads[kd]),
        "cache_slots": slots,
        "cache_inserts_max": int(replay[:, 0].max()),
        "cache_fall_throughs": int(replay[:, 1].sum()),
        "distinct_branches_max": int(replay[:, 2].max()),
    })

    # ---- phase 8: the ANS coder against plain on adversarial lanes
    idx_a, bit_a, ns_a = (torch.as_tensor(a, device=dev) for a in
                          unframed_lanes(ans_adversarial_segments()))
    aerrs = []
    for label, template in (("identity", None), ("template", tpl)):
        err, ms, nw = compare_ans_coder(idx_a, bit_a, ns_a, template)
        aerrs.append(err)
        log(f"[8] adversarial lanes {tuple(idx_a.shape)} (symbols "
            f"{ns_a.tolist()}, up to {nw} words), {label} start: kernels "
            f"== plain ({fmt_ms(ms)})")
    del idx_a, bit_a, ns_a
    (idx_s, bit_s, ns_s), stpl = stage_inputs(dev, framed=False)
    for label, template in (("identity", None), ("prob-0 template", stpl)):
        err, ms, nw = compare_ans_coder(idx_s, bit_s, ns_s, template)
        aerrs.append(err)
        log(f"[8] stage lanes {tuple(idx_s.shape)} (symbols "
            f"{ns_s.tolist()}), {label} start: kernels == plain "
            f"({fmt_ms(ms)})")
    check_ans_zero_freq(dev)
    log("[8] a template's prob-0 branch: a 1 bit codes as in plain, a 0 "
        "bit (freq 0) raises on the card as in plain")
    idx3, bit3, _ = batch_encode.assemble_lanes(descs, dev, framed=False)
    lane_syms3 = (idx3 != vpx_coder.PAD).sum(1).cpu().numpy()
    ns_p = torch.as_tensor(np.minimum(lane_syms3, ANS_PREFIX),
                           dtype=torch.int32, device=dev)
    err, aprefix, _ = compare_ans_coder(
        idx3[:, :ANS_PREFIX].contiguous(), bit3[:, :ANS_PREFIX].contiguous(),
        ns_p)
    aerrs.append(err)
    log(f"[8] unframed {ANS_PREFIX}-symbol prefix of all {idx3.shape[0]} v3 "
        f"lanes: kernels == plain ({fmt_ms(aprefix)})")
    del idx3, bit3
    torch.cuda.empty_cache()

    # ---- phase 9: the v3 main path, encode then decode
    for fn in coder_kernels():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    prof3 = {}
    leps3 = api.batch_compress_device(blobs, num_segments=16, stats=prof3,
                                      version=3)
    torch.cuda.synchronize(dev)
    wall3 = time.perf_counter() - t
    alaunches = {fn.__name__: fn.launches
                 for fn in coder_kernels()[:2] + coder_kernels()[3:]}
    peak3 = torch.cuda.max_memory_allocated(dev)
    if set(alaunches.values()) != {1}:
        fail(f"the v3 encode made coder launches {alaunches}, not one each")
    if prof3["lanes"] != 64:
        fail(f"expected 64 v3 lanes, got {prof3['lanes']}")
    for b, lep in zip(blobs, leps3):
        if lep[:3] != b"\xcf\x84\x03" or int.from_bytes(
                lep[-4:], "little") != len(lep) or not len(lep) < len(b):
            fail("malformed or non-shrinking v3 .lep")
    t = time.perf_counter()
    alone = api.compress_device(blobs[0], version=3)
    torch.cuda.synchronize(dev)
    single3_s = time.perf_counter() - t
    if alone != leps3[0]:
        fail("v3 image 0: batch output differs from compress_device alone")
    for version in (2, 3):
        if api.compress_device(small, num_segments=4, version=version) \
                != api.compress_device(small, num_segments=4, device="cpu",
                                       version=version):
            fail(f"v{version} compress_device: cuda and cpu bytes differ")
    bytes_out3 = sum(map(len, leps3))
    log(f"[9] batch_compress_device(version=3): 4 images, {prof3['lanes']} "
        f"lanes, launches {alaunches}; image 0 alone gives equal "
        f"bytes; 160x120 in 4 segments gives equal v2 and v3 bytes on cuda "
        f"and cpu")
    log(f"[9] v3 stage s: parse+huffman {prof3['parse_s']:.3f}, symbolize "
        f"{prof3['symbolize_s']:.3f}, assembly {prof3['assemble_s']:.3f}, "
        f"ANS coder {prof3['ans_coder_ms'] / 1e3:.3f} (CUDA events: "
        f"{stage_split(prof3)[1:-1]}), "
        f"finalize+mux {prof3['finalize_s'] + prof3['mux_s']:.3f}; wall "
        f"{wall3:.3f}; {bytes_in / 1e6 / wall3:.2f} MB/s; peak "
        f"max_memory_allocated {peak3 / 2**30:.2f} GiB; compress_device on "
        f"image 0 alone {single3_s:.3f} s")
    log(f"[9] v3 symbols coded {prof3['symbols']}, longest lane "
        f"{prof3['max_lane_symbols']}")
    log(f"[9] .lep bytes: v3 {bytes_out3} (ratio "
        f"{bytes_out3 / bytes_in:.4f}), v1 {bytes_out} (ratio "
        f"{bytes_out / bytes_in:.4f}); v3/v1 {bytes_out3 / bytes_out:.4f}")

    # the ANS coder again on the whole batch and on its longest lane alone
    idx3, bit3, _ = batch_encode.assemble_lanes(descs, dev, framed=False)
    ns3 = torch.as_tensor(lane_syms3, dtype=torch.int32, device=dev)
    k3 = int(lane_syms3.argmax())
    again3, alone3 = {}, {}
    _, aagain_ms = timed_cuda(ans_coder.encode_streams_ans, idx3, bit3, ns3,
                              None, again3)
    _, aalone_ms = timed_cuda(ans_coder.encode_streams_ans,
                              idx3[k3:k3 + 1].contiguous(),
                              bit3[k3:k3 + 1].contiguous(), ns3[k3:k3 + 1],
                              None, alone3)
    log(f"[9] ANS coder again: all {len(lane_syms3)} lanes {aagain_ms:.2f} "
        f"ms {stage_split(again3)}; longest lane ({k3}, {lane_syms3[k3]} "
        f"symbols) only {aalone_ms:.2f} ms {stage_split(alone3)}, "
        f"{alone3['walk_ms'] * 1e6 / lane_syms3[k3]:.1f} ns a symbol in its "
        f"walk")
    del idx3, bit3
    torch.cuda.empty_cache()

    decode_lanes = vpx_decoder.decode_lanes
    decode_lanes.launches = decode_lanes.ans_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    dprof3 = {}
    outs = api.batch_decompress_device(leps3, stats=dprof3)
    torch.cuda.synchronize(dev)
    dwall3 = time.perf_counter() - t
    rlaunches = (decode_lanes.launches, decode_lanes.ans_launches)
    main_counts3 = decode_lanes.cache_counts
    dpeak3 = torch.cuda.max_memory_allocated(dev)
    if rlaunches != (0, 1):
        fail(f"the v3 decode made (VPX, rANS) reader launches {rlaunches}, "
             "not (0, 1)")
    if outs != blobs:
        fail("batch_decompress_device did not give back the original JPEGs "
             "from the v3 files")
    log(f"[9] batch_decompress_device on the v3 files: {dprof3['lanes']} "
        f"lanes, {rlaunches[1]} rANS reader launch; every JPEG back byte "
        f"for byte")
    log(f"[9] v3 decode stage s: read+demux {dprof3['read_s']:.3f}, "
        f"plan+upload {dprof3['plan_s']:.3f}, rANS reader kernel "
        f"{dprof3['ans_decoder_ms'] / 1e3:.3f} (CUDA events), d2h "
        f"{dprof3['d2h_s']:.3f}, recode {dprof3['recode_s']:.3f}; wall "
        f"{dwall3:.3f}; {bytes_in / 1e6 / dwall3:.2f} MB/s; peak "
        f"max_memory_allocated {dpeak3 / 2**30:.2f} GiB")
    plan3 = vpx_decoder.plan_decode([api._decode_request(lep, i)[0]
                                     for i, lep in enumerate(leps3)], "ans")
    inputs3 = plan3.to(dev)
    (coef, derr), ragain_ms = timed_cuda(
        lambda: vpx_decoder.decode_lanes(**inputs3))
    for (planes, _), desc in zip(vpx_decoder.split_planes(plan3, coef, derr),
                                 descs):
        if not all(torch.equal(a, torch.as_tensor(b, device=dev))
                   for a, b in zip(planes, desc["planes"])):
            fail("v3 device planes differ from the parse's planes")
    del coef, planes
    _, ralone_ms = timed_cuda(
        lambda: vpx_decoder.decode_lanes(**one_lane(inputs3, k3)))
    log(f"[9] branch cache of {slots} slots on the v3 main path: "
        f"{check_cache(main_counts3, replay, 'v3 main path')}")
    log(f"[9] v3 device planes equal the parse's; rANS reader alone: all "
        f"{len(lane_syms3)} lanes {ragain_ms:.2f} ms; lane {k3} "
        f"({lane_syms3[k3]} reads, one a coded symbol) only "
        f"{ralone_ms:.2f} ms, {ralone_ms * 1e6 / lane_syms3[k3]:.1f} ns a "
        f"read")

    # ---- phase 10: the rANS reader against plain
    rerrs = []
    for nseg, w, h, template in ((1, 64, 48, None), (2, 96, 64, tpl),
                                 (4, 96, 64, None)):
        jpeg, lep = small_lep(SEED + 40 + nseg, w, h, 85, nseg,
                              None if template is None else packed,
                              version=3)
        err, ms_k, ms_p = compare_decoder([lep], [jpeg], template, "ans")
        rerrs.append(err)
        log(f"[10] v3 {w}x{h}, {nseg} segment(s), "
            f"{'template' if template is not None else 'identity'} start: "
            f"rANS reader == plain (kernel {ms_k:.2f} ms, plain "
            f"{ms_p:.0f} ms)")
    cut3 = cut_lanes(inputs3, ANS_CUT_ROWS, ANS_CUT_WIDTH)
    _, cut_flags, err, rcut_k_ms, rcut_p_ms = compare_lanes(cut3)
    rerrs.append(err)
    rcut_blocks = int(cut3["rows"][:, 2].sum())
    rcut_input = (f"the 64 v3 main-path lanes cut to {ANS_CUT_ROWS} row a "
                  f"component of at most {ANS_CUT_WIDTH} blocks "
                  f"({rcut_blocks} blocks; plane widths, offsets, ring and "
                  f"planes as on the main path)")
    log(f"[10] {rcut_input}: rANS reader == plain, planes and err flags "
        f"({int(cut_flags.count_nonzero())} lanes flagged past the cut); "
        f"kernel {rcut_k_ms:.2f} ms, plain {rcut_p_ms:.0f} ms")

    # ---- phase 11: one call with v1, v2 and v3 requests, mode Z and X
    small2 = api.compress_device(small, num_segments=4, version=2)
    small_x = make_photo(SEED + 12, 160, 120, progressive=True)
    small_c = make_photo(SEED + 13, 160, 120, mode="CMYK")
    lep_x = api.compress_device(small_x, num_segments=4,
                                allow_progressive=True)
    lep_c = api.compress_device(small_c, num_segments=4, version=3,
                                allow_four_colors=True)
    decode_lanes.launches = decode_lanes.ans_launches = 0
    mixed = [leps[0], small2, leps3[1], lep_x, lep_c]
    if api.batch_decompress_device(mixed) \
            != [blobs[0], small, blobs[1], small_x, small_c]:
        fail("the mixed v1/v2/v3, mode Z/X, CMYK call did not give back "
             "every original")
    if (decode_lanes.launches, decode_lanes.ans_launches) != (1, 1):
        fail("the mixed call did not launch each reader once")
    log("[11] one batch_decompress_device call with a v1, a v2 and a v3 "
        "request, a v1 mode-X (progressive 160x120) and a v3 CMYK request: "
        "one VPX reader launch, one rANS reader launch, every JPEG back "
        "byte for byte")

    # ---- phase 12: the roofline probe
    chains = [("rmw", 1), ("rmw", 2), ("rmw", 4), ("rmw", 8), ("alu", 1),
              ("mixed", 1)]
    decode_roofline.probe.launches = 0
    t = time.perf_counter()
    plain_sums = {(kind, K, sh): decode_roofline.probe_plain(
        kind, PROBE_CHECK_ITERS, K, sh)
        for kind, K in chains for sh in (False, True)
        if not (kind == "alu" and sh)}
    probe_plain_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    for (kind, K, sh), want in plain_sums.items():
        got = int(decode_roofline.probe(kind, PROBE_CHECK_ITERS, K, sh))
        if got != want:
            fail(f"probe {kind} K={K} shared={sh}: checksum {got}, plain "
                 f"{want}")
    probe_check_ms = (time.perf_counter() - t) * 1e3
    log(f"[12] probe checksums equal to the plain loop for "
        f"{len(plain_sums)} chains of {PROBE_CHECK_ITERS} steps (plain "
        f"{probe_plain_ms:.0f} ms, kernels {probe_check_ms:.1f} ms with "
        f"their syncs)")
    probe_ns = {}
    for sh in (False, True):
        for kind, K in chains:
            if kind == "alu" and sh:
                continue
            decode_roofline.probe(kind, 1000, K, sh)        # warm
            _, ms = timed_cuda(decode_roofline.probe, kind, PROBE_STEPS // K,
                               K, sh)
            probe_ns[kind, K, sh] = ms * 1e6 / (PROBE_STEPS // K * K)
        where = ("shared memory (256 rows)" if sh
                 else "device memory (4096 rows)")
        base = probe_ns["rmw", 1, sh]
        log(f"[12] arena in {where}: dependent RMW {base:.1f} ns a step; "
            + ", ".join(f"K={K} {probe_ns['rmw', K, sh]:.1f} ns "
                        f"({base / probe_ns['rmw', K, sh]:.2f}x)"
                        for K in (2, 4, 8))
            + f"; mixed RMW+12 ALU {probe_ns['mixed', 1, sh]:.1f} ns"
            + ("" if sh else f"; 12-op ALU chain {probe_ns['alu', 1, sh]:.1f}"
               " ns an iteration"))
    plaunches = decode_roofline.probe.launches
    mixed_ms = probe_ns["mixed", 1, False] * PROBE_STEPS / 1e6

    # least time of the whole ANS coder's work on this run's data: each
    # symbol's index and bit read once, each lane's words written once; and
    # of its walk alone, which reads each symbol's probability and bit
    a_syms = int(lane_syms3.sum())
    a_bytes, a_ops = bound_ms(a_syms * 5 + bytes_out3 + 4 * len(lane_syms3),
                              a_syms * (ANS_WALK_OPS_PER_SYMBOL
                                        + PROBS_OPS_PER_SYMBOL))
    aw_bytes, aw_ops = bound_ms(a_syms * 2 + bytes_out3
                                + 4 * len(lane_syms3),
                                a_syms * ANS_WALK_OPS_PER_SYMBOL)
    kernels.append({
        "name": "ans_coder", "route": "cuda",
        "source": "lepton_tpu_torch/csrc/ans_coder.cu",
        "replaces": "lepton_tpu/kernels/batch_encode.py:378",
        "stage": "the whole v3 phase B (encode_streams_ans): the sort, "
                 "run_heads and walk_runs under the adv rule, then this "
                 "file's reverse walk; ms, plain_ms and bound_ms are the "
                 "whole coder's, walk_* the walk kernel's alone",
        "launches": alaunches["ans_walk"], "max_abs_err": max(aerrs),
        "ms": prof3["ans_coder_ms"], "plain_ms": aprefix["coder"][1],
        "bound_ms": max(a_bytes, a_ops),
        "bound_by": "bytes" if a_bytes >= a_ops else "operations",
        "library_ms": None,
        "equal_to_plain": True,
        "plain_inputs": f"{ANS_PREFIX}-symbol unframed prefix of 64 lanes",
        "kernel_ms_on_plain_inputs": aprefix["coder"][0],
        "sort_ms": prof3["sort_ms"], "probs_ms": prof3["probs_ms"],
        "walk_ms": prof3["walk_ms"], "walk_plain_ms": aprefix["walk"][1],
        "walk_bound_ms": max(aw_bytes, aw_ops),
        "walk_bound_by": "bytes" if aw_bytes >= aw_ops else "operations",
        "walk_kernel_ms_on_plain_inputs": aprefix["walk"][0],
    })
    # the probability stage's two kernels on the v1 path's data (the v3
    # path's in the *_v3 keys): run_heads reads each live symbol's sorted
    # key once and writes each run's start; walk_runs reads the keys and
    # the starts and writes one probability byte a live symbol
    h_bytes, h_ops = bound_ms(prof["live"] * 8 + prof["runs"] * 8,
                              prof["live"] * HEADS_OPS_PER_KEY)
    b_bytes, b_ops = bound_ms(prof["live"] * 9 + prof["runs"] * 8,
                              prof["live"] * PROBS_OPS_PER_SYMBOL)
    for kern, key, at, ms_key, (x_bytes, x_ops), what in (
            ("run_heads", "heads", 560, "heads_ms", (h_bytes, h_ops),
             "the first key of each (lane, branch) run"),
            ("walk_runs", "runs", 573, "runs_ms", (b_bytes, b_ops),
             "each run's probabilities, a thread a run")):
        kernels.append({
            "name": kern, "route": "cuda",
            "source": "lepton_tpu_torch/csrc/branch_probs.cu",
            "replaces": f"lepton_tpu/kernels/vpx_scan.py:{at}",
            "stage": f"probability stage of both coders (model_probs_sorted "
                     f"at vpx_scan.py:525): {what}",
            "launches": launches[kern], "launches_v3": alaunches[kern],
            "max_abs_err": max(errs + aerrs),
            "ms": prof[ms_key], "ms_v3": prof3[ms_key],
            "plain_ms": prefix[key][1],
            "bound_ms": max(x_bytes, x_ops),
            "bound_by": "bytes" if x_bytes >= x_ops else "operations",
            "library_ms": None,
            "equal_to_plain": True,
            "plain_inputs": f"{PREFIX}-symbol framed prefix of 64 lanes, vpx "
                            "rule",
            "kernel_ms_on_plain_inputs": prefix[key][0],
            "live": prof["live"], "runs": prof["runs"],
            "longest_run": prof["longest_run"],
            "longest_run_v3": prof3["longest_run"],
        })
    r_moved = (int(plan3.dlen.sum()) * 4 + plan3.n_blocks * 64 * 2
               + len(lane_syms3) * ARENA_SIZE * 4)
    r_bytes = r_moved / H100_BYTES_PER_S * 1e3
    r_ops = int(lane_syms3.sum()) * DECODER_OPS_PER_READ \
        / H100_SCALAR_OPS_PER_S * 1e3
    kernels.append({
        "name": "ans_reader", "route": "cuda",
        "source": "lepton_tpu_torch/csrc/vpx_decoder.cu",
        "replaces": "lepton_tpu/kernels/pallas_decode.py:330",
        "launches": rlaunches[1], "max_abs_err": max(rerrs),
        "ms": dprof3["ans_decoder_ms"], "plain_ms": rcut_p_ms,
        "bound_ms": max(r_bytes, r_ops),
        "bound_by": "bytes" if r_bytes >= r_ops else "operations",
        "library_ms": None,
        "equal_to_plain": True,
        "plain_inputs": rcut_input,
        "kernel_ms_on_plain_inputs": rcut_k_ms,
        "longest_lane_ms": ralone_ms,
        "ns_a_read_longest_lane": ralone_ms * 1e6 / int(lane_syms3[k3]),
        "cache_slots": slots,
        "cache_inserts_max": int(replay[:, 0].max()),
        "cache_fall_throughs": int(replay[:, 1].sum()),
        "distinct_branches_max": int(replay[:, 2].max()),
    })
    # the timed mixed chain: 4 bytes out after a 2 MB arena fill, and about
    # 5 + 3 * 12 integer ops a step
    p_bytes = (decode_roofline.ROWS * decode_roofline.LANES * 4 + 4) \
        / H100_BYTES_PER_S * 1e3
    p_ops = PROBE_STEPS * 41 / H100_SCALAR_OPS_PER_S * 1e3
    kernels.append({
        "name": "decode_roofline", "route": "cuda",
        "source": "lepton_tpu_torch/csrc/decode_roofline.cu",
        "replaces": "tools/decode_roofline.py:36",
        "launches": plaunches, "path": "phase 12, the probe's own",
        "max_abs_err": 0, "ms": mixed_ms, "plain_ms": probe_plain_ms,
        "bound_ms": max(p_bytes, p_ops),
        "bound_by": "bytes" if p_bytes >= p_ops else "operations",
        "library_ms": None,
        "equal_to_plain": True,
        "what": f"mixed chain, {PROBE_STEPS} steps, arena in device memory",
        "plain_inputs": f"all {len(plain_sums)} chains of "
                        f"{PROBE_CHECK_ITERS} steps",
        "kernel_ms_on_plain_inputs": probe_check_ms,
        "ns_a_step": {f"{kind} K={K} {'shared' if sh else 'device'}": v
                      for (kind, K, sh), v in probe_ns.items()},
    })

    # ---- phase 13: mode X and 4 colours on the card
    base = {1: (prof, dprof, wall, dwall, peak, dpeak, bytes_in, bytes_out,
                (again_ms, again), dagain_ms),
            3: (prof3, dprof3, wall3, dwall3, peak3, dpeak3, bytes_in,
                bytes_out3, (aagain_ms, again3), ragain_ms)}
    mode_x = phase_mode_x(dev, base)
    rows = {row["name"]: row for row in kernels}
    for name, version, counter, ms_key in (
            ("vpx_coder", 1, "vpx_walk", "coder_ms"),
            ("run_heads", 1, "run_heads", "heads_ms"),
            ("walk_runs", 1, "walk_runs", "runs_ms"),
            ("ans_coder", 3, "ans_walk", "ans_coder_ms"),
            ("vpx_decoder", 1, "vpx_reader", "vpx_decoder_ms"),
            ("ans_reader", 3, "ans_reader", "ans_decoder_ms")):
        launched, stats = mode_x[version]
        rows[name]["launches_mode_x"] = launched[counter]
        rows[name]["ms_mode_x"] = stats[ms_key]
        rows[name]["mode_x_path"] = (f"phase 13, v{version}: 4 progressive "
                                     "4032x3024 q90 photos, 64 lanes")

    # ---- phase 14: the -tpu batch server and the one-shot CLI
    served = phase_serve(dev, blobs, leps, leps3)
    for name, counter in (("vpx_coder", "vpx_walk"),
                          ("run_heads", "run_heads"),
                          ("walk_runs", "walk_runs"),
                          ("ans_coder", "ans_walk"),
                          ("vpx_decoder", "vpx_reader"),
                          ("ans_reader", "ans_reader")):
        rows[name]["launches_serve"], rows[name]["serve_path"] = \
            served[counter]
    # ---- phase 15: more than one device and more than one process
    parallel = phase_parallel(dev, blobs, leps, leps3, descs)
    for name, counter in (("vpx_coder", "vpx_walk"),
                          ("run_heads", "run_heads"),
                          ("walk_runs", "walk_runs"),
                          ("ans_coder", "ans_walk"),
                          ("vpx_decoder", "vpx_reader"),
                          ("ans_reader", "ans_reader")):
        rows[name]["launches_parallel"], rows[name]["parallel_path"] = \
            parallel[counter]
    # no card path of phases 1 to 15 took the Python segment codec
    from lepton_tpu_torch import host
    if host.SEGMENT_CODEC_ROUTES["python"]:
        fail(f"phases 1 to 15 took the Python segment codec: "
             f"{host.SEGMENT_CODEC_ROUTES}")
    log(f"[16] segment codec routes of phases 1 to 15 in this process: "
        f"{host.SEGMENT_CODEC_ROUTES}")
    # ---- phase 16: the host symbolizer on the card, the Python codec
    native = phase_native_symbolizer(dev, blobs, leps, leps3, prof, prof3)
    for name, counter in (("vpx_coder", "vpx_walk"),
                          ("run_heads", "run_heads"),
                          ("walk_runs", "walk_runs"),
                          ("ans_coder", "ans_walk")):
        (rows[name]["launches_native_symbolizer"],
         rows[name]["native_symbolizer_path"]) = native[counter]
    # ---- phase 17: hostile, truncated and odd-sized input
    soaked = phase_soak(dev, smi, blobs, leps, leps3)
    for name, counter in (("vpx_coder", "vpx_walk"),
                          ("run_heads", "run_heads"),
                          ("walk_runs", "walk_runs"),
                          ("ans_coder", "ans_walk"),
                          ("vpx_decoder", "vpx_reader"),
                          ("ans_reader", "ans_reader")):
        rows[name]["launches_soak"], rows[name]["soak_path"] = \
            soaked[counter]
    # ---- phase 18: the bench runner
    benched = phase_bench(dev, smi, blobs)
    for row in kernels:
        counter = BENCH_COUNTERS.get(row["name"])
        row["launches_bench"], row["bench_path"] = benched[counter] \
            if counter else (0, "on no section of the bench (phase 12's "
                                "probe)")
    # ---- phase 19: the bounds-checked builds
    checked = phase_checked(dev, smi, blobs, leps, leps3, soaked["leps"])
    for row in kernels:
        source = os.path.splitext(os.path.basename(row["source"]))[0]
        row["check_sites"] = checked["sites"][source]
        row["ms_checked"], row["ms_default_phase19"] = checked["ms"].get(
            row["name"], (None, None))
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
