"""A row that an early-EOF cut leaves past its component's size limit
decodes block 0 in the port's readers, as the host codec's C segment
decoder does (leptonc.c process_row tests the limit after each block);
the JAX readers decode no block of it (pallas_decode.py:874, vpx_decode's
plan the same), a known difference pinned here.

soak.past_cut_lanes codes, with the host's C segment coder, streams of a
64x64 JPEG cut to three fifths in two segments whose past-the-limit row
holds a non-zero block 0.  The plain reader (device="cpu") must decode
them to the C decoder's planes, block for block, in v1 and v3; the JAX
reader must agree everywhere but on that block, which it leaves zero.
The shared-lane merge must give that block to its own lane.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.kernels.vpx_decode import decode_segments_tpu  # noqa: E402
from lepton_tpu_torch import api, host, soak  # noqa: E402
from lepton_tpu_torch.kernels import vpx_decoder  # noqa: E402


def _ci(c):
    return 0 if c == 0 else 1


@pytest.mark.parametrize("version", [1, 3])
def test_past_cut_row_decodes_block_zero(version):
    lep, req, past = soak.past_cut_lanes(version)
    coder = "ans" if version == 3 else "vpx"
    assert past == [(0, 5)] and len(req["streams"]) == 2
    plan = vpx_decoder.plan_decode([req], coder)
    offset, _, W = plan.planes[0][0]
    rows = {(int(r[0]), int((r[6] - plan.planes[0][r[0]][0]) // r[3])): r
            for r in plan.rows}
    assert rows[0, 5][2] == 1 and rows[0, 4][2] >= 1
    coef, err = vpx_decoder.decode_lanes(**plan.to("cpu"))
    coef, err = coef.numpy(), err.numpy()
    assert not err.any()
    # the host's C segment decoder on the same streams, block for block
    assert soak.host_diffs(plan, [(lep, req)], coef, err) == []
    block = offset + 5 * W
    assert coef[block, :3].tolist() == [10, -2, 1]
    # each lane's share gives that block back to its owner
    lane = int(np.searchsorted(np.cumsum(plan.lanes[:, 1]),
                               next(i for i, r in enumerate(plan.rows)
                                    if r[6] == block), side="right"))
    assert block in plan.owned_blocks(lane, lane + 1)
    shares = [(k, k + 1, *vpx_decoder.decode_lanes(**plan.share(k, k + 1)
                                                    .to("cpu")))
              for k in range(len(plan.lanes))]
    merged, _ = vpx_decoder.merge_shares(plan, shares, "cpu")
    assert np.array_equal(merged.numpy(), coef)
    # the JAX reader: everything equal but block 0 of the row past the cut
    jreq = japi._tpu_decode_request(lep)[0]
    jargs = [req["streams"]] + [jreq[k] for k in (
        "plane_shapes", "color_tables", "mcuv", "max_coded_heights",
        "component_sizes", "splits_y")]
    want, werr = decode_segments_tpu(*jargs, color_index=_ci, coder=coder)
    assert not np.asarray(werr).any()
    luma = coef[offset:offset + W * want[0].shape[0]].reshape(want[0].shape)
    jl = np.asarray(want[0])
    assert not jl[5, 0].any() and luma[5, 0, 0] == 10
    luma[5, 0] = 0
    assert np.array_equal(luma, jl)


def test_device_decode_of_a_past_cut_file():
    """decompress_device of the host's own cut file (block 0 of the row
    past the cut coded as zeros): the bytes the host codec and the JAX
    package give back."""
    lep, _, _ = soak.past_cut_lanes(1)
    assert api.decompress_device(lep, device="cpu") == host.decompress(lep) \
        == japi.decompress(lep)
