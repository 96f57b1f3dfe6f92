#!/usr/bin/env python3
"""Smoke run of lepton_tpu_torch on one CUDA card.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the result line):
  1. build the VPX coder kernel (csrc/vpx_coder.cu) with nvcc into build/,
     in parallel with phase 5's build;
  2. hold the kernel against its plain PyTorch version on CUDA tensors:
     adversarial streams (branch reuse, a long carry chain), the same under
     a trained-template start arena, and a framed 20k-symbol prefix of
     every lane of the full-size batch of phase 4;
  3. encode small images on cuda and on cpu: equal .lep bytes;
  4. the main path: batch_compress_device on four synthetic 12 MP
     4032x3024 4:2:0 q90 JPEGs, 16 segments each (64 coder lanes), with the
     kernel's launch count read around it; image 0 alone must give the
     same bytes.  Then the coder kernel is timed again on all 64 lanes and
     on the longest lane alone.
  5. build the VPX token decoder kernel (csrc/vpx_decoder.cu);
  6. hold the decoder against its plain PyTorch version on CUDA tensors:
     small JPEGs encoded on the card with 1, 2 and 4 segments, from the
     identity arena and from phase 2's trained template, and one
     two-request call of different geometry and quality; planes and err
     flags must be equal, and the planes those of the JPEG's own parse;
  7. the main decode path: batch_decompress_device on phase 4's four .lep
     files, with the decoder's launch count read around it; each result
     must be its original JPEG byte for byte, the device planes those of
     the parse, and image 0 alone must give the same bytes.  Then the
     decoder is timed again on all 64 lanes and on the longest lane alone,
     and held against its plain version on all 64 lanes of the main path,
     each cut to its first rows of a few dozen blocks, with plane widths,
     output offsets, ring and plane sizes as the main path gives them.
It prints stage times, sizes, rates and peak memory, then the card's name
and power limit, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}.  Without CUDA, or without the package
beside it, it exits non-zero and prints no result.
"""
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
CODER_OPS_PER_SYMBOL = 30      # integer ops of one coded symbol, roughly
DECODER_OPS_PER_READ = 40      # integer ops of one decoded read, roughly
STOP_BITS = 32                 # coded after each lane's last symbol
CUT_ROWS, CUT_WIDTH = 2, 24    # phase-7 cut of the main path's lanes


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_photo(seed: int, w: int, h: int, quality: int = 90) -> bytes:
    """A phone-photo-like JPEG (q90, 4:2:0): smooth gradients and shading,
    hard-edged patches, mild sensor noise, all from a numpy seed."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    s = w / 4032.0
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        gx, gy, amp = rng.uniform(-70, 70, 3)
        fx, fy = rng.uniform(150, 700, 2) * s
        px, py = rng.uniform(0, 6.28, 2)
        img[..., c] = (128 + gx * xx / w + gy * yy / h
                       + amp * np.sin(xx / fx + px) * np.cos(yy / fy + py))
    for _ in range(60):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        ww, hh = (rng.integers(40, 900, 2) * s).astype(int) + 1
        img[y0:y0 + hh, x0:x0 + ww] += rng.uniform(-45, 45, 3).astype(
            np.float32)
    img += rng.normal(0, 5.0, (h, w, 3)).astype(np.float32)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB").save(
        buf, "JPEG", quality=quality, subsampling=2)
    return buf.getvalue()


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


def compare_coder(idx, bit, template=None):
    """Kernel vs plain version on the same CUDA tensors.  Returns
    (max_abs_err over stream bytes, kernel ms, plain ms)."""
    import torch
    from lepton_tpu_torch.kernels import vpx_coder
    counted = vpx_coder.encode_streams.launches
    (out_k, nb_k), ms_k = timed_cuda(vpx_coder.encode_streams, idx, bit,
                                     template)
    (out_p, nb_p), ms_p = timed_cuda(vpx_coder.encode_streams_plain, idx,
                                     bit, template)
    # launches made to compare do not count toward the main path
    vpx_coder.encode_streams.launches = counted
    if not torch.equal(nb_k.cpu(), nb_p.cpu()):
        fail("coder kernel and plain version differ in stream lengths")
    sk = vpx_coder.finalize(out_k, nb_k)
    sp = vpx_coder.finalize(out_p, nb_p)
    err = max((int(np.abs(np.frombuffer(a, np.uint8).astype(np.int16)
                          - np.frombuffer(b, np.uint8)).max())
               for a, b in zip(sk, sp) if a), default=0)
    if sk != sp:
        fail(f"coder kernel differs from plain version (max err {err})")
    return err, ms_k, ms_p


def encode_in_segments(jpeg: bytes, nseg: int, template=None) -> bytes:
    """The .lep of a JPEG, encoded on the card in nseg segments from
    `template` (a packed trained model, or None)."""
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
        [api._describe(info, dec, splits)], template=template,
        device=torch.device("cuda"))[0]
    return api._container(parsed, dec, splits, nt, streams)


def small_lep(seed: int, w: int, h: int, quality: int, nseg: int,
              template=None) -> tuple:
    """(JPEG, .lep) of a small photo, encoded on the card in nseg segments."""
    jpeg = make_photo(seed, w, h, quality)
    return jpeg, encode_in_segments(jpeg, nseg, template)


def compare_lanes(inputs: dict, template=None):
    """Decoder kernel vs plain version on the same CUDA tensors (the
    inputs of decode_lanes).  Returns (coef, err flags, max_abs_err over
    the planes, kernel ms, plain ms)."""
    import torch
    from lepton_tpu_torch.kernels import vpx_decoder
    counted = vpx_decoder.decode_lanes.launches
    (coef_k, err_k), ms_k = timed_cuda(
        lambda: vpx_decoder.decode_lanes(**inputs, template=template))
    (coef_p, err_p), ms_p = timed_cuda(
        lambda: vpx_decoder.decode_lanes_plain(**inputs, template=template))
    # launches made to compare do not count toward the main path
    vpx_decoder.decode_lanes.launches = counted
    err = int((coef_k.int() - coef_p.int()).abs().max()) if len(coef_k) \
        else 0
    if err or not torch.equal(err_k, err_p):
        fail(f"decoder kernel differs from plain version (max err {err}, "
             f"err flags {err_k.tolist()} vs {err_p.tolist()})")
    return coef_k, err_k, err, ms_k, ms_p


def compare_decoder(leps, jpegs, template=None):
    """compare_lanes for the requests of `leps` in one call; the planes
    must also be the JPEGs' own.  Returns (max_abs_err over the planes,
    kernel ms, plain ms)."""
    from lepton_tpu_torch import api
    from lepton_tpu_torch.kernels import vpx_decoder
    plan = vpx_decoder.plan_decode([api._decode_request(lep, i)[0]
                                    for i, lep in enumerate(leps)])
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)
    try:
        from lepton_tpu_torch import api
        from lepton_tpu_torch.kernels import (batch_encode, cuda_build,
                                              vpx_coder, vpx_decoder)
        from lepton_tpu_torch.model.tables import (ARENA_SIZE,
                                                   arena_from_template)
    except ImportError as e:
        fail(f"lepton_tpu_torch is not beside chip_smoke.py: {e}")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    log(f"card: {name} ({smi}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---- phases 1 and 5: build both kernels, one nvcc each, together
    took = cuda_build.build(["vpx_coder", "vpx_decoder"])
    for phase, kname in (("1", "vpx_coder"), ("5", "vpx_decoder")):
        log(f"[{phase}] built "
            f"{os.path.relpath(cuda_build.so_path(kname), HERE)} for sm_90a "
            f"in {took[kname]:.1f} s")
        for line in cuda_build.ptxas_report[kname].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[{phase}]   ptxas: {line.strip()}")

    # ---- phase 2: kernel against plain on adversarial streams
    idxs, bits = vpx_coder.build_symbol_streams(adversarial_segments())
    idx_a = torch.as_tensor(idxs, device=dev)
    bit_a = torch.as_tensor(bits, device=dev)
    raw = np.random.default_rng(SEED).integers(0, 256, (ARENA_SIZE, 3),
                                               dtype=np.uint8)
    raw[:, 2] = 1 + raw[:, 2] % 254
    tpl = arena_from_template(api.pack_model(raw)).to(dev)
    errs = []
    for label, template in (("identity", None), ("template", tpl)):
        err, ms_k, ms_p = compare_coder(idx_a, bit_a, template)
        errs.append(err)
        log(f"[2] adversarial streams {tuple(idx_a.shape)}, {label} start: "
            f"kernel == plain (kernel {ms_k:.2f} ms, plain {ms_p:.0f} ms)")

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
    err, prefix_ms, plain_ms = compare_coder(idx_p, bit_p)
    errs.append(err)
    log(f"[2] framed {PREFIX}-symbol prefix of all {idx_p.shape[0]} lanes: "
        f"kernel == plain (kernel {prefix_ms:.2f} ms, plain "
        f"{plain_ms:.0f} ms)")
    del idx_p, bit_p
    torch.cuda.empty_cache()

    # ---- phase 4: the main path
    vpx_coder.encode_streams.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    prof = {}
    leps = api.batch_compress_device(blobs, num_segments=16, stats=prof)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t
    launches = vpx_coder.encode_streams.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if launches < 1:
        fail("the main path launched no coder kernel")
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
        f"{launches} coder launch(es); image 0 alone gives equal bytes")
    log(f"[4] stage s: parse+huffman {prof['parse_s']:.3f}, symbolize "
        f"{prof['symbolize_s']:.3f}, assembly {prof['assemble_s']:.3f}, "
        f"coder kernel {prof['coder_ms'] / 1e3:.3f} (CUDA events), "
        f"finalize+mux {prof['finalize_s'] + prof['mux_s']:.3f}; "
        f"wall {wall:.3f}")
    log(f"[4] JPEG bytes in {bytes_in}, .lep bytes out {bytes_out}, ratio "
        f"{bytes_out / bytes_in:.4f}; {bytes_in / 1e6 / wall:.2f} MB/s, "
        f"{mp / wall:.2f} MP/s")
    log(f"[4] symbols coded {prof['symbols']}, longest lane "
        f"{prof['max_lane_symbols']}; peak max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; compress_device on image 0 alone "
        f"{single_s:.3f} s")

    # the coder again on the whole batch, and on its longest lane alone:
    # each lane is one serial chain, so the longest bounds the launch
    idx_f, bit_f, _ = batch_encode.assemble_lanes(descs, dev)
    lane_symbols = (idx_f != vpx_coder.PAD).sum(1).cpu()
    k = int(lane_symbols.argmax())
    _, again_ms = timed_cuda(vpx_coder.encode_streams, idx_f, bit_f)
    _, alone_ms = timed_cuda(vpx_coder.encode_streams,
                             idx_f[k:k + 1].contiguous(),
                             bit_f[k:k + 1].contiguous())
    log(f"[4] coder kernel alone: all {prof['lanes']} lanes {again_ms:.2f} "
        f"ms; longest lane only {alone_ms:.2f} ms, "
        f"{alone_ms * 1e6 / prof['max_lane_symbols']:.1f} ns a symbol")

    # least time for the coder's work on this run's data: each live symbol
    # (int32 index + uint8 bit) read once, each stream byte written once
    moved = prof["symbols"] * 5 + bytes_out + 4 * prof["lanes"]
    t_bytes = moved / H100_BYTES_PER_S * 1e3
    t_ops = prof["symbols"] * CODER_OPS_PER_SYMBOL \
        / H100_SCALAR_OPS_PER_S * 1e3
    kernels = [{
        "name": "vpx_coder", "route": "cuda",
        "source": "lepton_tpu_torch/csrc/vpx_coder.cu",
        "replaces": "lepton_tpu/kernels/pallas_coder.py:44",
        "launches": launches, "max_abs_err": max(errs),
        "ms": prof["coder_ms"], "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "equal_to_plain": True,
        "plain_inputs": f"{PREFIX}-symbol framed prefix of 64 lanes",
        "kernel_ms_on_plain_inputs": prefix_ms,
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
    del coef
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
    })
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
