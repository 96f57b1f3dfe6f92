"""Leave-one-out ablations of the token decoder kernel, timed on the card.

Each ablation is csrc/vpx_decoder.cu with one design step of the kernel
undone by a text edit (ABLATIONS), built with nvcc into build/, and
swapped in as kernels.vpx_decoder's library.  Every build decodes the
same lanes, one 4032x3024 photo (chip_smoke.make_photo) in 16 segments as
container v1 (VPX reader) and v3 (rANS reader); its planes must equal the
unedited kernel's.  Run from the repository root, with one card:

    python -m lepton_tpu_torch.probes.decoder_ablation

It prints one JSON line a (build, reader): the 16-lane launch and the
longest lane alone in ms (CUDA events, twice each), and ns a read of that
lane.  The edits are exploration, not options of the kernel: nothing else
builds or loads them.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from ..kernels import cuda_build, vpx_decoder

# the unedited kernel's read: lookup, deferred store, reciprocals loaded
# before the bit, update after it
_READ_TAIL = """        const vpx::Next next = vpx::next_counts(packed, rcp);
        const int b = r.bit(vpx::branch_prob(packed));
        const int32_t nv = R::update(next, b);"""
_FORWARD = """        cache[pslot].x = static_cast<uint32_t>(pval);
        int32_t packed = static_cast<int>(h) == pslot
                             ? pval : static_cast<int32_t>(e.x);"""
_PENDING = """            pslot = slot;
            pval = nv;"""
# the update with C division, as before the reciprocal table
_DIVIDE = """__device__ int32_t divide_update(const VpxReader*, int32_t packed,
                                 int obs) {
    const int fc = packed & 0xFF, tc = (packed >> 8) & 0xFF;
    int nfc, ntc, nprob;
    if (obs) {
        if (tc == 0xFF) {
            if (fc == 1) return 1 | (0xFF << 8);
            nfc = (1 + fc) >> 1; ntc = 129;
        } else {
            nfc = fc; ntc = tc + 1;
        }
    } else {
        if (fc == 0xFF) {
            if (tc == 1) return 0xFF | (1 << 8) | (255 << 16);
            ntc = (1 + tc) >> 1; nfc = 129;
        } else {
            nfc = fc + 1; ntc = tc;
        }
    }
    nprob = (nfc << 8) / (nfc + ntc);
    return nfc | (ntc << 8) | ((nprob & 0xFF) << 16);
}
__device__ int32_t divide_update(const AnsReader*, int32_t packed,
                                 int obs) {
    int fc = packed & 0xFF, tc = (packed >> 8) & 0xFF;
    if (obs) {
        if (tc == 0xFF) { fc = (fc + 1) >> 1; tc = 129; } else { ++tc; }
    } else {
        if (fc == 0xFF) { tc = (tc + 1) >> 1; fc = 129; } else { ++fc; }
    }
    const int prob = (((fc << 8) / (fc + tc)) & 0xFF) | 1;
    return fc | (tc << 8) | (prob << 16);
}

// Adaptive reads through reader R"""
_REFILL_STEP = re.compile(
    r"        if \(count < 0\) \{\n            // the byte-wise refill.*?"
    r"count \+= 8 \* take \+ \(take < want \? kLotsOfBits : 0\);\n"
    r"        \}\n", re.S)
_REFILL_LOOP = """        if (count < 0) {
            int shift = 16 - count;
            while (shift >= 0) {
                if (pos < len) {
                    value |= static_cast<uint32_t>(p[pos]) << shift;
                    ++pos;
                    count += 8;
                    shift -= 8;
                } else {
                    count += kLotsOfBits;
                    break;
                }
            }
        }
"""

# name -> [(pattern, replacement)], each applied once to the kernel source
ABLATIONS = {
    "kernel": [],
    "lane 0 reads alone": [
        (re.compile(r"(// ---- reads:[^\n]*\n(?:\s*//[^\n]*\n)?)(\s*)\{"),
         r"\1\2if (threadIdx.x == 0) {")],
    "miss path out of line": [
        ("__device__ __forceinline__ int2 cache_miss(",
         "__device__ __noinline__ int2 cache_miss(")],
    "store at once": [
        (_FORWARD, "        int32_t packed = static_cast<int32_t>(e.x);"),
        (_PENDING, "            cache[slot].x = static_cast<uint32_t>(nv);")],
    "reciprocals after the bit": [
        (_READ_TAIL, """        const int b = r.bit(vpx::branch_prob(packed));
        const vpx::Next next = vpx::next_counts(packed, rcp);
        const int32_t nv = R::update(next, b);""")],
    "division after the bit": [
        ("// Adaptive reads through reader R", _DIVIDE),
        (_READ_TAIL, """        const int b = r.bit(vpx::branch_prob(packed));
        const int32_t nv = divide_update(static_cast<const R*>(nullptr),
                                         packed, b);""")],
    "byte-loop refill": [(_REFILL_STEP, _REFILL_LOOP)],
}


def variant_source(edits) -> str:
    """The kernel source with `edits` applied, each exactly once."""
    src = open(cuda_build.source("vpx_decoder")).read()
    for pat, rep in edits:
        if isinstance(pat, str):
            if src.count(pat) != 1:
                raise ValueError(f"edit anchor not found once: {pat[:60]!r}")
            src = src.replace(pat, rep)
        else:
            src, n = pat.subn(rep, src)
            if n < 1:
                raise ValueError(f"edit pattern not found: {pat.pattern!r}")
    return src


def build_all() -> dict:
    """Build every ablation, one nvcc each, all at once; returns name ->
    bound library."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    jobs = {}
    for k, (name, edits) in enumerate(ABLATIONS.items()):
        cu = os.path.join(cuda_build.BUILD_DIR, f"ablation_{k}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(edits))
        so = cu[:-3] + ".so"
        jobs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name!r}:\n{err[-3000:]}")
        libs[name] = vpx_decoder.bind(ctypes.CDLL(so))
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("decoder_ablation: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from .. import api
    from ..kernels import batch_encode, vpx_coder
    dev = torch.device("cuda")
    libs = build_all()
    blob = chip_smoke.make_photo(chip_smoke.SEED, 4032, 3024)
    _, info, dec = api._parse(blob)
    splits, _ = api._plan(dec, 16)
    idx, _, _ = batch_encode.assemble_lanes(
        [api._describe(info, dec, splits)], dev, framed=False)
    reads = (idx != vpx_coder.PAD).sum(1).cpu().numpy()
    del idx
    k = int(reads.argmax())
    inputs = {}
    for version, coder in ((1, "vpx"), (3, "ans")):
        lep = api.batch_compress_device([blob], num_segments=16,
                                        version=version)[0]
        inputs[coder] = vpx_decoder.plan_decode(
            [api._decode_request(lep, 0)[0]], coder).to(dev)
    want = {}
    for name, lib in libs.items():
        vpx_decoder._lib = lib
        for coder, inp in inputs.items():
            coef, err = vpx_decoder.decode_lanes(**inp)      # warm
            if name == "kernel":
                want[coder] = coef
            elif not torch.equal(coef, want[coder]):
                sys.exit(f"decoder_ablation: {name!r} decodes other planes")
            # the reader's launch as the decode times it (timing.timed)
            batch = [api._timed_decode(inp, None, dev)[2] for _ in "ab"]
            lane = [api._timed_decode(chip_smoke.one_lane(inp, k), None,
                                      dev)[2] for _ in "ab"]
            print(json.dumps({
                "build": name, "reader": coder, "batch_ms": batch,
                "lane_ms": lane, "lane_reads": int(reads[k]),
                "ns_a_read": [t * 1e6 / int(reads[k]) for t in lane],
                "err_flags": int(err.sum())}), flush=True)
    print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
