"""The symbol kernels' plain versions and the two-pass route of
kernels/batch_encode.py on the CPU (csrc/symbolize.cu runs only on a card:
tests/test_torch_cuda.py holds it to these).

- symbol_counts_plain against symbolize_slice's live slots, block by block;
- walk_block, the kernels' walk in Python, against the same slab, so that
  the CUDA walk's arithmetic, which it follows line by line, is checked
  here;
- the parameter block the wrappers pass: model/tables.py's offsets and
  strides, in the order of the source's Tab, and its constants;
- _symbolize_plane (counts, offsets, one total, emission) against the
  mask compaction of the slab it replaces, against the JAX package's
  symbolize_slice, and, where the two packages differ on purpose (the
  tenth residual bit of an 11-bit coefficient, block 0 of a row past an
  early-EOF cut), against the host's C symbolizer; on the CPU it makes
  the slab once a chunk;
- chip_smoke.py's count of the bytes the walk reads (the kernels' bound)
  and its trace, which lets a kernel's failure through.

The planes are seeded numpy planes shaped like a JPEG's; every comparison
is exact (idx, bit, counts, flags).
"""
import ctypes
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from lepton_tpu.kernels import symbolize as jsym  # noqa: E402
from lepton_tpu.model.context import ColorTables as JColorTables  # noqa: E402
from lepton_tpu_torch import _native, api, constants as C, host  # noqa: E402
from lepton_tpu_torch.kernels import batch_encode, cuda_build  # noqa: E402
from lepton_tpu_torch.kernels import symbolize as S  # noqa: E402
from lepton_tpu_torch.kernels.vpx_coder import PAD  # noqa: E402
from lepton_tpu_torch.model.context import ColorTables  # noqa: E402
from lepton_tpu_torch.model.tables import (TABLE_OFFSETS,  # noqa: E402
                                           TABLE_STRIDES)


def _plane(seed, H, W):
    """Coefficients shaped like a JPEG's: large DC, AC decaying with
    frequency, mostly zero at high frequencies, all within 10 bits."""
    rng = np.random.default_rng(seed)
    freq = np.add.outer(np.arange(8), np.arange(8)).reshape(64)
    scale = 60.0 / (1 + freq) ** 1.3
    coefs = np.round(rng.laplace(0, scale, (H, W, 64))).astype(np.int64)
    coefs[rng.random((H, W, 64)) < 0.02 * freq] = 0
    coefs[..., 0] = rng.integers(-1000, 1000, (H, W))
    return np.clip(coefs, -1023, 1023).astype(np.int16)


def _tables(seed):
    return np.random.default_rng(seed).integers(1, 60, 64)


# name: (seed, H, W, ci, segment-top rows, blocks cut off the end,
#        {(row, col, raster position): value})
CASES = {
    "luma": (1, 6, 7, 0, [0], 0, {}),
    "chroma": (2, 5, 6, 1, [0], 0, {}),
    "segment_tops": (3, 7, 5, 0, [0, 2, 5], 0, {}),
    "past_cut": (4, 6, 6, 1, [0, 3], 13, {}),
    "eleven_bits": (5, 4, 6, 0, [0], 0,
                    {(1, 2, 9): 1500, (2, 3, 3): -2047, (3, 0, 0): 1023}),
    "past_eleven_bits": (6, 4, 5, 1, [0], 0,
                         {(2, 1, 20): 3000, (0, 4, 8): -2048}),
}


def _case(name):
    seed, H, W, ci, tops, cut, plant = CASES[name]
    coefs = _plane(seed, H, W)
    for (r, c, k), v in plant.items():
        coefs[r, c, k] = v
    rha = np.ones(H, bool)
    rha[tops] = False
    return coefs, ci, ColorTables(_tables(seed)), rha, H * W - cut


def _slab(coefs, ci, ct, rha, size_limit):
    """symbolize_slice's slab of the whole plane, as numpy [N, slots]."""
    args = [torch.as_tensor(np.asarray(a, np.int32)) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y, ct.min_noise_threshold)]
    idx, bit = S.symbolize_slice(torch.as_tensor(coefs), ci, *args, 0,
                                 size_limit, torch.as_tensor(rha))
    H, W = coefs.shape[:2]
    return idx.numpy().reshape(H * W, -1), bit.numpy().reshape(H * W, -1)


@pytest.mark.parametrize("name", list(CASES))
def test_counts_plain_are_the_slabs_live_slots(name):
    """Each block's count is its live slots in symbolize_slice's slab, and
    its flag is set exactly where the slab's first slot carries
    COEF_OUT_OF_RANGE (a coded value past 11 bits)."""
    coefs, ci, ct, rha, size_limit = _case(name)
    idx, _ = _slab(coefs, ci, ct, rha, size_limit)
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    counts, over = S.symbol_counts_plain(plane)
    assert counts.dtype == torch.int32 and over.dtype == torch.bool
    assert np.array_equal(counts.numpy().reshape(-1), (idx != PAD).sum(-1))
    flags = idx[:, 0] == S.COEF_OUT_OF_RANGE
    assert np.array_equal(over.numpy().reshape(-1), flags)
    assert flags.any() == (name == "past_eleven_bits")
    if name == "past_cut":
        H, W = coefs.shape[:2]
        dead = ~((np.arange(H * W) < size_limit) | (np.arange(H * W) % W
                                                    == 0))
        assert dead.any() and not counts.numpy().reshape(-1)[dead].any()


def _host(plane: S.Plane) -> dict:
    """A Plane's tensors as walk_block takes them."""
    H, W = plane.coefs.shape[:2]
    out = {k: getattr(plane, k).numpy().reshape(
        (H * W,) + tuple(getattr(plane, k).shape[2:]))
        for k in ("coefs", "nz7x7", "aavrg", "lak", "dc_pred",
                  "uncertainty", "uncertainty2")}
    out.update(row_has_above=plane.row_has_above.numpy(), width=W,
               ci=plane.ci, row_block_offset=plane.row_block_offset,
               size_limit=plane.size_limit)
    return out


def test_walk_block_matches_the_slab():
    """The kernels' walk, block by block in Python, emits each block's
    live slots of the slab in order, and flags what the slab flags: every
    case above, and two larger seeded planes (a few hundred blocks in
    all)."""
    planes = [_case(name) for name in CASES]
    for seed, ci in ((7, 0), (8, 1)):
        coefs = _plane(seed, 9, 11)
        rng = np.random.default_rng(seed)
        for _ in range(4):      # 11- and 12-bit coefficients anywhere
            r, c, k = rng.integers(0, (9, 11, 64))
            coefs[r, c, k] = rng.choice([1500, -1800, 2500, -4000])
        rha = np.ones(9, bool)
        rha[[0, 4]] = False
        planes.append((coefs, ci, ColorTables(_tables(seed)), rha,
                       9 * 11 - 20))
    blocks = 0
    for coefs, ci, ct, rha, size_limit in planes:
        idx, bit = _slab(coefs, ci, ct, rha, size_limit)
        plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha,
                               size_limit)
        host_plane, prm = _host(plane), S.params(plane.min_noise_threshold)
        for b in range(len(idx)):
            got_i, got_b, over = S.walk_block(host_plane, prm, b)
            live = idx[b] != PAD
            assert got_i == idx[b][live].tolist(), b
            assert got_b == bit[b][live].tolist(), b
            assert over == (idx[b, 0] == S.COEF_OUT_OF_RANGE), b
        blocks += len(idx)
    assert blocks > 300


def test_parameter_block_is_the_tables():
    """The parameter block the wrappers pass: each table's offset and its
    strides but the last, as model/tables.py has them, in the order of
    csrc/symbolize.cu's Tab, then the nonzero bins, the zigzag order and
    the plane's noise thresholds; and the source's constants are the
    package's."""
    want = []
    for t in S.PARAM_TABLES:
        assert TABLE_STRIDES[t][-1] == 1
        want += [TABLE_OFFSETS[t]] + list(TABLE_STRIDES[t][:-1])
    ct = ColorTables(_tables(3))
    prm = S.params(ct.min_noise_threshold)
    assert prm.dtype == np.int32
    assert prm.tolist() == want + list(C.NONZERO_TO_BIN) + list(
        C.UNZIGZAG49) + list(ct.min_noise_threshold)
    assert set(S.PARAM_TABLES) == set(TABLE_OFFSETS)
    src = open(cuda_build.source("symbolize")).read()
    enum = re.search(r"enum Tab \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names == list(S.PARAM_NAMES) + ["kTabs"]
    for name, value in (("kMaxExponent", C.MAX_EXPONENT),
                        ("kCoefBits", C.COEF_BITS),
                        ("kNoiseFloor", C.RESIDUAL_NOISE_FLOOR),
                        ("kNumericLengthMax", C.NUMERIC_LENGTH_MAX),
                        ("kOutOfRange", S.COEF_OUT_OF_RANGE),
                        ("kLakLanes", S.LAK_LANES)):
        m = re.search(rf"constexpr int {name} = (-?\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert f"kUnzig = kNzBin + {len(C.NONZERO_TO_BIN)};" in src
    assert f"kNoise = kUnzig + {len(C.UNZIGZAG49)};" in src
    assert "kParams = kNoise + 64;" in src
    # the launch functions get exactly this block
    plane = S.plane_inputs(torch.as_tensor(_plane(3, 2, 3)), 0, ct,
                           np.array([False, True]), 6)
    args = S._plane_args(plane)
    n = args[-1]
    got = (ctypes.c_int32 * n).from_address(args[-2].value)
    assert list(got) == prm.tolist()


def _mask_route(coefs, ci, ct, rha, size_limit, rows=2):
    """The route the kernels replace: the slab in chunks of `rows` rows
    (with the row above as context), its live slots kept by a boolean
    mask, the rows counted, -1 for a row with a flagged block."""
    t = torch.as_tensor(coefs)
    H, W = coefs.shape[:2]
    args = [torch.as_tensor(np.asarray(a, np.int32)) for a in (
        ct.quant, ct.icos_idct_edge_8192_dequantized_x,
        ct.icos_idct_edge_8192_dequantized_y, ct.min_noise_threshold)]
    r_ha = torch.as_tensor(rha)
    parts_i, parts_b, counts = [], [], []
    for r0 in range(0, H, rows):
        r1 = min(H, r0 + rows)
        lo = max(r0 - 1, 0)
        idx, bit = S.symbolize_slice(t[lo:r1], ci, *args, lo * W,
                                     size_limit, r_ha[lo:r1])
        idx, bit = idx[r0 - lo:], bit[r0 - lo:]
        live = idx != PAD
        over = (idx[..., 0] == S.COEF_OUT_OF_RANGE).any(dim=1)
        counts.append(torch.where(over, -1, live.sum(dim=(1, 2))))
        parts_i.append(idx[live])
        parts_b.append(bit[live])
    return torch.cat(parts_i), torch.cat(parts_b), torch.cat(counts)


@pytest.mark.parametrize("slab_blocks", [S.SLAB_BLOCKS, 7],
                         ids=["whole", "chunked"])
@pytest.mark.parametrize("name", list(CASES))
def test_route_equals_the_mask_route(name, slab_blocks, monkeypatch):
    """_symbolize_plane on the CPU (phase A once, symbol_counts_plain,
    offsets, the total, emit_symbols_plain) gives the idx, bit and row
    counts of the mask route, with the plain slab taken whole or in
    chunks of one row."""
    monkeypatch.setattr(S, "SLAB_BLOCKS", slab_blocks)
    coefs, ci, ct, rha, size_limit = _case(name)
    got = batch_encode._symbolize_plane(torch.as_tensor(coefs), ci, ct, rha,
                                        size_limit)
    want = _mask_route(coefs, ci, ct, rha, size_limit)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.uint8
    assert got[2].dtype == torch.int64
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[2] < 0).any() == (name == "past_eleven_bits")


def test_emit_plain_places_runs_at_their_offsets():
    """emit_symbols_plain puts block (r, c)'s run at offsets[r, c], for
    offsets that are not the packed ones (a gap after every block), and
    refuses offsets of the wrong type or shape."""
    coefs, ci, ct, rha, size_limit = _case("segment_tops")
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    counts, _ = S.symbol_counts(plane)
    n = counts.reshape(-1).to(torch.int64)
    offsets = (torch.cumsum(n + 3, 0) - n - 3).reshape(counts.shape)
    idx, bit = S.emit_symbols(plane, offsets, int((n + 3).sum()))
    slab_i, slab_b = _slab(coefs, ci, ct, rha, size_limit)
    for b, (o, k) in enumerate(zip(offsets.reshape(-1).tolist(),
                                   n.tolist())):
        live = slab_i[b] != PAD
        assert idx[o:o + k].tolist() == slab_i[b][live].tolist()
        assert bit[o:o + k].tolist() == slab_b[b][live].tolist()
    with pytest.raises(ValueError, match="offsets"):
        S.emit_symbols(plane, offsets.to(torch.int32), 10)
    with pytest.raises(ValueError, match="offsets"):
        S.emit_symbols(plane, offsets.reshape(-1), 10)


def test_wrappers_check_their_inputs_and_count_no_cpu_launch():
    """A CPU plane runs the plain versions and counts no launch; a plane
    of the wrong dtype, shape or model is refused."""
    coefs, ci, ct, rha, size_limit = _case("luma")
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    before = (S.symbol_counts.launches, S.emit_symbols.launches)
    batch_encode._symbolize_plane(torch.as_tensor(coefs), ci, ct, rha,
                                  size_limit)
    assert (S.symbol_counts.launches, S.emit_symbols.launches) == before
    for bad in (plane._replace(aavrg=plane.aavrg.to(torch.int64)),
                plane._replace(lak=plane.lak[..., :7].contiguous()),
                plane._replace(row_has_above=plane.row_has_above[1:]),
                plane._replace(nz7x7=plane.nz7x7.t()),
                plane._replace(ci=2),
                plane._replace(min_noise_threshold=np.zeros(63, np.int32))):
        with pytest.raises(ValueError):
            S.symbol_counts(bad)


def _jax_slab(coefs, ci, q, rha, size_limit):
    jct = JColorTables(q)
    jargs = [jnp.asarray(np.asarray(a, np.int32)) for a in (
        jct.quant, jct.icos_idct_edge_8192_dequantized_x,
        jct.icos_idct_edge_8192_dequantized_y, jct.min_noise_threshold)]
    ji, jb = jsym.symbolize_slice(
        jnp.asarray(coefs), ci, *jargs, jnp.int32(0), jnp.int32(size_limit),
        jnp.asarray(rha))
    H, W = coefs.shape[:2]
    return (np.asarray(ji).reshape(H * W, -1),
            np.asarray(jb).reshape(H * W, -1))


@pytest.mark.parametrize("name", ["luma", "chroma", "segment_tops",
                                  "past_cut"])
def test_route_matches_jax(name):
    """The route's symbols of every block the JAX slab codes are that
    slab's live slots in order; the blocks it leaves out are block 0 of
    the rows past an early-EOF cut, which the port codes as the host does
    (test_route_matches_the_host_symbolizer)."""
    seed = CASES[name][0]
    coefs, ci, ct, rha, size_limit = _case(name)
    idx, bit, rows = batch_encode._symbolize_plane(
        torch.as_tensor(coefs), ci, ct, rha, size_limit)
    ji, jb = _jax_slab(coefs, ci, _tables(seed), rha, size_limit)
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    counts = S.symbol_counts_plain(plane)[0].numpy().reshape(-1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    jlive = ji != PAD
    H, W = coefs.shape[:2]
    extra = 0
    for b in range(H * W):
        got_i = idx[starts[b]:starts[b + 1]].numpy()
        got_b = bit[starts[b]:starts[b + 1]].numpy()
        if not jlive[b].any() and len(got_i):
            assert b % W == 0 and b >= size_limit
            extra += 1
            continue
        assert np.array_equal(got_i, ji[b][jlive[b]]), b
        assert np.array_equal(got_b, jb[b][jlive[b]]), b
    assert extra == (H - -(-size_limit // W) if name == "past_cut" else 0)
    assert rows.sum() == len(idx)


def _desc(data: bytes, k: int):
    """The encode description of a JPEG in k segments and its host jobs."""
    parsed, info, dec = api._parse(data, allow_four_colors=True)
    splits, _ = api._plan(dec, k)
    desc = api._describe(info, dec, splits)
    bounds = [th.luma_y_start for th in splits] + [info.cmpnfo[0].bcv]
    jobs = [(bounds[i], bounds[i + 1], i == len(splits) - 1)
            for i in range(len(splits))]
    return info, dec, desc, jobs


FILES = {
    "segments": (lambda: chip_smoke.make_photo(81, 96, 64), 4, None),
    "eleven_bits": (lambda: chip_smoke.make_photo(82, 48, 32), 1,
                    {(0, 1, 2, 9): 1500, (0, 0, 1, 3): -2047}),
    "past_cut": (lambda: (lambda d: d[:len(d) * 3 // 5])(
        chip_smoke.make_photo(83, 64, 48)), 1, None),
    "cmyk": (lambda: chip_smoke.make_photo(84, 48, 32, mode="CMYK"), 2,
             None),
}


@pytest.mark.skipif(not _native.available(), reason="needs the C library")
@pytest.mark.parametrize("name", list(FILES))
def test_route_matches_the_host_symbolizer(name):
    """Each segment's symbols from symbolize_images on the CPU (unframed
    lanes) are the host C symbolizer's for that segment: in several
    segments, with 11-bit AC coefficients (all 10 residual bits, the first
    pinned difference from the JAX slab), past an early-EOF cut (block 0
    of each row past it, the second) and for a 4-component JPEG (its
    fourth plane on the chroma model)."""
    make, k, plant = FILES[name]
    info, dec, desc, jobs = _desc(make(), k)
    if plant:
        desc["planes"] = [p.copy() for p in desc["planes"]]
        for (c, r, x, pos), v in plant.items():
            desc["planes"][c][r, x, pos] = v
    if name == "past_cut":
        assert dec.early_eof
    assert len(desc["planes"]) == (4 if name == "cmyk" else 3)
    img = host._native_image(info, desc["planes"], desc["max_coded_heights"],
                             desc["component_sizes"])
    idx, bit, owners = batch_encode.lanes(
        batch_encode.symbolize_images([desc], "cpu"), framed=False)
    assert [s for _, s in owners] == list(range(len(jobs)))
    for s, job in enumerate(jobs):
        want_i, want_b = _native.native_symbolize_segment(img, *job)
        n = len(want_i)
        assert np.array_equal(idx[s, :n].numpy(), want_i), s
        assert np.array_equal(bit[s, :n].numpy(), want_b), s
        assert (idx[s, n:] == PAD).all()


def test_past_eleven_bits_refuses_the_request():
    """A coded value past 11 bits: the route's row counts -1 and
    symbolize_images raises LeptonError naming the request."""
    _, _, desc, _ = _desc(chip_smoke.make_photo(85, 32, 16), 1)
    desc["planes"] = [p.copy() for p in desc["planes"]]
    desc["planes"][1][0, 1, 20] = 3000
    with pytest.raises(host.LeptonError, match="request 1: coefficient out "
                       "of range"):
        batch_encode.symbolize_images([_desc(chip_smoke.make_photo(
            86, 32, 16), 1)[2], desc], "cpu")


@pytest.mark.parametrize("slab_blocks", [S.SLAB_BLOCKS, 7],
                         ids=["whole", "chunked"])
def test_cpu_route_makes_the_slab_once(slab_blocks, monkeypatch):
    """On a CPU plane the route's count and emission share one pass of the
    slab: one _slab call a chunk, as the mask route made."""
    monkeypatch.setattr(S, "SLAB_BLOCKS", slab_blocks)
    calls = []
    real = S._slab

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(S, "_slab", counted)
    coefs, ci, ct, rha, size_limit = _case("segment_tops")
    batch_encode._symbolize_plane(torch.as_tensor(coefs), ci, ct, rha,
                                  size_limit)
    H, W = coefs.shape[:2]
    assert len(calls) == (1 if slab_blocks >= H * W else H)


def _walk_reads(plane: S.Plane):
    """(bytes, live blocks) the walk of csrc/symbolize.cu reads, counted
    loop step by loop step as walk_block takes them."""
    H, W = plane.coefs.shape[:2]
    co = plane.coefs.reshape(-1, 64).numpy()
    nz = plane.nz7x7.reshape(-1).numpy()
    total = live = 0
    for b in range(H * W):
        if not (plane.row_block_offset + b < plane.size_limit or b % W == 0):
            continue
        live += 1
        n = 1 + 15 * 2 + 3 * 4          # nz7x7, edges and DC, DC contexts
        left, k = int(nz[b]), 0
        while k < 49 and left > 0:
            n += 2 + 4                  # the coefficient and its aavrg
            left -= co[b, C.UNZIGZAG49[k]] != 0
            k += 1
        for step in (1, 8):
            remaining = sum(co[b, l * step] != 0 for l in range(1, 8))
            l = 0
            while l < 7 and remaining > 0:
                n += 4                  # its lak
                remaining -= co[b, (l + 1) * step] != 0
                l += 1
        total += n
    return int(total), live


@pytest.mark.parametrize("name", list(CASES))
def test_bound_counts_the_walks_reads(name):
    """chip_smoke.symbol_reads, the bytes behind the symbol kernels'
    bound, counts what the walk reads of this data: the interior and
    edge contexts only up to each loop's last nonzero coefficient, and
    nothing of a block past size_limit."""
    coefs, ci, ct, rha, size_limit = _case(name)
    plane = S.plane_inputs(torch.as_tensor(coefs), ci, ct, rha, size_limit)
    assert chip_smoke.symbol_reads(plane) == _walk_reads(plane)


@pytest.mark.parametrize("kind", ["launch", "bounds"])
def test_trace_lets_a_kernel_failure_through(kind):
    """chip_smoke.trace_device reports "not measured" only for the
    profiler's own failures: a failure of the call it traces (a failed
    launch, a checked build's KernelBoundsError) ends the phase."""
    error = (RuntimeError("symbol_emit_launch failed") if kind == "launch"
             else cuda_build.KernelBoundsError("symbolize", 129, 0, 5, 78,
                                               78, per_lane=False))

    def call():
        raise error

    with pytest.raises(type(error)) as got:
        chip_smoke.trace_device(call)
    assert got.value is error
