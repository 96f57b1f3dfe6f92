"""The port's parallel layer on the CPU against the JAX package's:
lepton_tpu_torch.parallel.mesh (Mesh, make_mesh, sharded_phase_a,
gather_streams_in_file_order, batch_compress, batch_decompress),
parallel.multihost (init_distributed, gather_streams_to_host0,
distributed_compress, in one process and in two over gloo), the
segment_range of the batch encode and the lane-sharded decode
(decompress_device(mesh=)).

A mesh of "cpu" entries runs each device's share with the kernels' plain
versions.  Inputs are PIL-made JPEGs and numpy arrays from seeds; streams,
planes, phase-A values and JPEGs are compared exactly.
"""
import ast
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.model.context import ColorTables as JColorTables  # noqa: E402
from lepton_tpu.parallel import mesh as jmesh  # noqa: E402
from lepton_tpu.parallel import multihost as jmulti  # noqa: E402
from lepton_tpu_torch import api  # noqa: E402
from lepton_tpu_torch.kernels import batch_encode, cuda_build, vpx_decoder  # noqa: E402,E501
from lepton_tpu_torch.parallel import mesh as M  # noqa: E402
from lepton_tpu_torch.parallel import multihost as MH  # noqa: E402
from lepton_tpu_torch.util import timing  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402

import chip_smoke  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


def _cpu_mesh(n: int) -> M.Mesh:
    return M.Mesh(["cpu"] * n, ("seg",))


# ---------------------------------------------------------------------------
# make_mesh, sharded_phase_a, gather_streams_in_file_order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_matches_jax(n):
    if len(jax.devices()) < n:
        pytest.skip("needs the suite's 8 virtual CPU devices")
    want = jmesh.make_mesh(n)
    got = M.make_mesh(n, device="cpu")
    assert got.devices.shape == want.devices.shape
    assert got.axis_names == tuple(want.axis_names) == ("data", "seg")
    assert got.shape == dict(want.shape)
    assert got.size == want.size == n


def test_mesh_axes():
    """A 1-D ('seg',) mesh gives its 'seg' devices; a 2-D one its
    (data, seg) grid in either axis order; wrong names raise."""
    m = M.Mesh(["cpu", "cpu", "cpu"], ("seg",))
    assert m.shape == {"seg": 3} and m.size == 3
    assert m.axis_devices("seg") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="not a"):
        m.grid()
    m2 = M.Mesh(np.array(["cpu"] * 6, dtype=object).reshape(3, 2),
                ("seg", "data"))
    assert m2.grid().shape == (2, 3)
    with pytest.raises(ValueError):
        M.Mesh(["cpu", "cpu"], ("data", "seg"))


def test_sharded_phase_a_matches_jax():
    """The input of tests/test_graft_entry.py's sharded phase A, over the
    (2, 4) meshes of 8 devices: every key exactly equal."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the suite's 8 virtual CPU devices")
    colors = JColorTables(np.arange(1, 65, dtype=np.int64))
    tabs = [np.asarray(t, np.int32) for t in (
        colors.quant, colors.icos_idct_edge_8192_dequantized_x,
        colors.icos_idct_edge_8192_dequantized_y)]
    coefs = np.random.default_rng(5).integers(
        -32, 33, size=(2, 4, 8, 16, 64)).astype(np.int16)
    want = jmesh.sharded_phase_a(jnp.asarray(coefs),
                                 *map(jnp.asarray, tabs), jmesh.make_mesh(8))
    got = M.sharded_phase_a(coefs, *tabs, M.make_mesh(8, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert np.array_equal(got[k].numpy().astype(np.int64),
                              np.asarray(want[k]).astype(np.int64)), k
    with pytest.raises(ValueError, match="does not split"):
        M.sharded_phase_a(coefs, *tabs, M.make_mesh(3, device="cpu"))


def test_gather_streams_in_file_order_matches_jax():
    rng = np.random.default_rng(7)
    streams = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for n in (300, 0, 5000, 70000, 1)]
    assert M.gather_streams_in_file_order(iter(streams)) \
        == jmesh.gather_streams_in_file_order(streams)


# ---------------------------------------------------------------------------
# segment_range of the batch encode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def four_segments():
    """A 64x64 4:2:0 JPEG described in 4 segments, and its whole encode
    (v1 and v3 streams)."""
    data = _jpeg(64, 64, seed=3, quality=80, subsampling=2)
    _, info, dec = api._parse(data)
    desc = api._describe(info, dec, dec.handoffs[:1])
    desc["splits_y"] = [0, 2, 4, 6]
    whole = {v: batch_encode.encode_images_device([desc], v, device="cpu")[0]
             for v in (1, 3)}
    return desc, whole


@pytest.mark.parametrize("lo,hi,version", [
    (0, 4, 1), (0, 2, 1), (1, 3, 1), (3, 4, 1), (2, 2, 1), (1, 4, 3)])
def test_segment_range_streams(four_segments, lo, hi, version):
    """Streams lo..hi-1 of the whole call, in segment order; an empty range
    codes nothing."""
    desc, whole = four_segments
    stats = {}
    with timing.part(stats):
        got = batch_encode.encode_images_device([desc], version,
                                                device="cpu",
                                                segment_range=[(lo, hi)])
    assert got == [whole[version][lo:hi]]
    assert stats.get("lanes", 0) == hi - lo


def test_segment_range_per_image(four_segments):
    """One range an image; owners keep the image's own segment numbers."""
    desc, whole = four_segments
    got = batch_encode.encode_images_device([desc, desc], device="cpu",
                                            segment_range=[(3, 4), (0, 2)])
    assert got == [whole[1][3:4], whole[1][0:2]]
    _, _, owners = batch_encode.assemble_lanes(
        [desc, desc], "cpu", segment_range=[(3, 4), (0, 2)])
    assert owners == [(0, 3), (1, 0), (1, 1)]
    with pytest.raises(ValueError, match="outside"):
        batch_encode.encode_images_device([desc], device="cpu",
                                          segment_range=[(2, 5)])
    with pytest.raises(ValueError, match="2 segment ranges for 1 images"):
        batch_encode.encode_images_device([desc], device="cpu",
                                          segment_range=(0, 2))


# ---------------------------------------------------------------------------
# The lane-sharded decode
# ---------------------------------------------------------------------------


def _mesh_files():
    """name -> (JPEG, its .lep in 4 segments of one 4:4:4 MCU row each)."""
    data = _jpeg(32, 32, seed=5, quality=80, subsampling=0)
    short = _jpeg(32, 48, seed=5, quality=80, subsampling=0)
    short = short[:int(len(short) * 0.7)]
    return {"v1": (data, japi.compress(data, max_threads=4, min_threads=4)),
            "v3": (data, japi.compress(data, max_threads=4, min_threads=4,
                                       version=3)),
            # cut in its scan: luma row 3 of the last segment decodes 1 of
            # its 4 blocks, rows 4 and 5 none
            "cut": (short, japi.compress(short, max_threads=4,
                                         min_threads=4))}


@pytest.fixture(scope="module")
def jax_mesh_decodes():
    """Each file through decompress_tpu over a ('seg',) mesh of 4 devices
    (one compile each)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the suite's 8 virtual CPU devices")
    mesh = JMesh(np.array(jax.devices()[:4]), ("seg",))
    files = _mesh_files()
    return {name: (jpeg, lep, japi.decompress_tpu(lep, mesh=mesh))
            for name, (jpeg, lep) in files.items()}


@pytest.mark.parametrize("name", ["v1", "v3", "cut"])
def test_mesh_decode_matches_jax(jax_mesh_decodes, name):
    """Over 2 and 4 "cpu" devices: equal to JAX decompress_tpu(mesh=) and
    to the original, one launch a share."""
    jpeg, lep, want = jax_mesh_decodes[name]
    assert want == jpeg
    for n in (2, 4):
        stats = {}
        got = api.decompress_device(lep, device="cpu", mesh=_cpu_mesh(n)) \
            if n == 2 else api.batch_decompress_device(
                [lep], device="cpu", mesh=_cpu_mesh(n), stats=stats)[0]
        assert got == jpeg
    ms = stats["ans_decoder_ms" if name == "v3" else "vpx_decoder_ms"]
    assert len(ms) == 4 and stats["merge_s"] >= 0 and stats["lanes"] == 4


def test_mesh_decode_indivisible_raises():
    data = _jpeg(48, 32, seed=9, quality=75, subsampling=2)
    lep = japi.compress(data, max_threads=2, min_threads=2)
    with pytest.raises(ValueError, match="2 lanes .* 3 devices"):
        api.decompress_device(lep, device="cpu", mesh=_cpu_mesh(3))


def test_merge_takes_rows_by_owner():
    """A block is taken from the share that owns its row, whatever another
    share holds there; shares must cover the lanes in order."""
    data = _jpeg(48, 32, seed=9, quality=75, subsampling=2)
    lep = japi.compress(data, max_threads=2, min_threads=2)
    plan = vpx_decoder.plan_decode([api._decode_request(lep)[0]])
    shares = [(lo, lo + 1) + vpx_decoder.decode_lanes(
        **plan.share(lo, lo + 1).to("cpu")) for lo in (0, 1)]
    whole = vpx_decoder.decode_lanes(**plan.to("cpu"))
    mine = torch.as_tensor(plan.owned_blocks(0, 1))
    theirs = torch.as_tensor(plan.owned_blocks(1, 2))
    assert len(mine) + len(theirs) == plan.n_blocks
    assert not set(mine.tolist()) & set(theirs.tolist())
    shares[0][2][theirs] = 7          # junk where share 0 owns nothing
    coef, err = vpx_decoder.merge_shares(plan, shares, "cpu")
    assert torch.equal(coef, whole[0]) and torch.equal(err, whole[1])
    with pytest.raises(ValueError, match="cover"):
        vpx_decoder.merge_shares(plan, shares[::-1], "cpu")


# ---------------------------------------------------------------------------
# batch_compress / batch_decompress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"max_threads": 4, "version": 3}])
def test_batch_compress_matches_jax(kw):
    """The card route over a (2, 2) mesh of "cpu" entries and the host
    route: the bytes of JAX parallel.mesh.batch_compress with the same kw;
    back through the host route of batch_decompress and, for v1, its card
    route."""
    blobs = [_jpeg(48, 32, seed=s, quality=80, subsampling=2)
             for s in range(3)] + [_jpeg(32, 24, seed=4, mode="L")]
    want = jmesh.batch_compress(blobs, **kw)
    stats = {}
    card = M.batch_compress(blobs, mesh=M.make_mesh(4, device="cpu"),
                            stats=stats, **kw)
    assert card == want
    assert M.batch_compress(blobs, device="host", **kw) == want
    assert [s["images"] for s in stats["shares"]] \
        == [(0, 2), (0, 2), (2, 4), (2, 4)]
    # each row symbolizes its images once; its devices only code lanes
    assert [r["images"] for r in stats["rows"]] == [(0, 2), (2, 4)]
    assert all("symbolize_s" in r for r in stats["rows"])
    assert not any("symbolize_s" in s for s in stats["shares"])
    assert M.batch_decompress(card, device="host") \
        == jmesh.batch_decompress(want) == blobs
    if not kw:
        # one segment a file: lanes 1 a request, so a (data, 1) mesh
        mesh = M.Mesh(np.array(["cpu"] * 2, dtype=object).reshape(2, 1),
                      ("data", "seg"))
        assert M.batch_decompress(card, mesh=mesh) == blobs


def test_batch_decompress_mesh_rows():
    """Requests over the 'data' rows, each row's lanes over its 'seg'
    devices; a mode-Y file raises as batch_decompress_device does."""
    blobs = [_jpeg(48, 32, seed=s, quality=70, subsampling=2)
             for s in range(3)]
    leps = [japi.compress(b, max_threads=2, min_threads=2) for b in blobs]
    stats = {}
    assert M.batch_decompress(leps, mesh=M.make_mesh(4, device="cpu"),
                              stats=stats) == blobs
    assert [r["requests"] for r in stats["rows"]] == [(0, 1), (1, 3)]
    assert [len(r["vpx_decoder_ms"]) for r in stats["rows"]] == [2, 2]
    mode_y = japi.generic_compress(b"not a jpeg")
    with pytest.raises(api.LeptonError, match="mode-Y"):
        M.batch_decompress([mode_y], device="cpu")


@pytest.mark.parametrize("n", [2, 4])
def test_batch_decompress_any_lane_count_matches_jax(n):
    """The card route over make_mesh(n, "cpu") ((1, 2) and (2, 2)) takes
    lane counts its 'seg' axis does not divide, as JAX batch_decompress
    does: three 1-segment files (3 VPX lanes), and a v1 file beside a v3
    file (1 lane a coder), where decompress_device(mesh=) would raise."""
    blobs = [_jpeg(16, 16, seed=s, quality=75, subsampling=2)
             for s in (21, 22, 23)]
    ones = [japi.compress(b) for b in blobs]
    mixed = [japi.compress(blobs[0]), japi.compress(blobs[1], version=3)]
    mesh = M.make_mesh(n, device="cpu")
    ns = mesh.shape["seg"]
    for leps, want in ((ones, blobs), (mixed, blobs[:2])):
        assert jmesh.batch_decompress(leps) == want
        stats = {}
        assert M.batch_decompress(leps, mesh=mesh, stats=stats) == want
        # one launch a share, and no more shares than a coder has lanes
        launches = [len(r[f"{c}_decoder_ms"]) for r in stats["rows"]
                    for c in ("vpx", "ans") if f"{c}_decoder_ms" in r]
        if leps is ones:
            assert launches == [min(ns, r["lanes"]) for r in stats["rows"]]
        else:
            assert launches == [1, 1]
    with pytest.raises(ValueError, match="1 lanes .* 2 devices"):
        api.decompress_device(ones[0], device="cpu", mesh=_cpu_mesh(2))


@pytest.mark.parametrize("kw", [{"start_byte": 10}, {"min_threads": 2},
                                {"even_split": True}, {"embedding": 4},
                                {"allow_34_sampling": True}])
def test_batch_compress_host_only_kw_raises(kw):
    blob = _jpeg(32, 24, seed=1)
    with pytest.raises(ValueError, match="device='host'"):
        M.batch_compress([blob], device="cpu", **kw)


def test_card_routes_raise_without_cuda(monkeypatch):
    """device=None means the CUDA devices: without them every new entry
    point raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _jpeg(32, 24, seed=1)
    lep = japi.compress(data)
    for call in (M.make_mesh, lambda: M.batch_compress([data]),
                 lambda: M.batch_decompress([lep]),
                 lambda: api.decompress_device(lep, mesh=_cpu_mesh(1)),
                 lambda: MH.distributed_compress(data)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_count_launch_under_threads():
    """The launch counters hold every add of many threads at once."""
    def wrapper():
        pass
    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            cuda_build.count_launch(wrapper) for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 2000


# ---------------------------------------------------------------------------
# distributed_compress: one process, and two over gloo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cooperative():
    """A 64x64 JPEG, and JAX distributed_compress(engine='host') of it in 4
    segments."""
    data = _jpeg(64, 64, seed=11, quality=85, subsampling=2)
    return data, jmulti.distributed_compress(data, num_segments=4,
                                             engine="host")


@pytest.mark.parametrize("engine", ["device", "host"])
def test_distributed_compress_world_1(cooperative, engine):
    data, want = cooperative
    stats = {}
    got = MH.distributed_compress(data, num_segments=4, engine=engine,
                                  device="cpu", stats=stats)
    assert got == want
    assert (stats["rank"], stats["world"], stats["lanes"]) == (0, 1, 4)
    assert MH.gather_streams_to_host0([b"a", b""]) == [b"a", b""]


GATHER_WORKER = r"""
import sys
sys.path.insert(0, %(repo)r)
import torch.distributed as dist
from lepton_tpu_torch.parallel import multihost as MH
rank = int(sys.argv[1])
MH.init_distributed(%(coord)r, 2, rank, timeout_s=%(timeout)d)
MH.init_distributed(%(coord)r, 2, rank)          # a second call: no-op
mine = [b"first", b"", b"x" * 3000] if rank == 0 else []
print(repr(MH.gather_streams_to_host0(mine)))
dist.destroy_process_group()
"""


def test_two_process_cooperative_encode(tmp_path, cooperative):
    """Two ranks (chip_smoke.run_ranks: python -c children, gloo on a free
    port) code 2 segments each on their "cpu" device, gather, and write
    the same bytes as JAX distributed_compress(engine='host') in one
    process; they decode to the original."""
    data, want = cooperative
    ranks = chip_smoke.run_ranks(data, 4, "cpu", str(tmp_path),
                                 timeout=CHILD_TIMEOUT_S)
    assert [lep for lep, _ in ranks] == [want, want]
    assert [(st["rank"], st["world"], st["lanes"]) for _, st in ranks] \
        == [(0, 2, 2), (1, 2, 2)]
    assert api.decompress(want) == data


def test_two_process_uneven_gather():
    """Shares of 3 streams (one empty) and of none: both ranks get the
    three in order, after a second init_distributed that does nothing.
    Each child has CHILD_TIMEOUT_S; a failure shows both stderrs."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sk.getsockname()[1]}"
    script = GATHER_WORKER % dict(repo=REPO, coord=coord,
                                  timeout=CHILD_TIMEOUT_S)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(rank)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CHILD_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], \
        "\n".join(err[-3000:] for _, err in outs)
    want = [b"first", b"", b"x" * 3000]
    assert [ast.literal_eval(out.strip().splitlines()[-1])
            for out, _ in outs] == [want, want]
