"""A truncated JPEG coded in several segments round-trips through the
port's decode, where the JAX package's re-emit refuses it.

The scan decode files its last handoff, taken where the data ends, under
the next MCU row, so a segment that starts past the rows the cut left
coded carries the state of the cut, and a re-emit that checks it raises
"handoff mismatch".  The port's re-emit folds such segments into the one
before them (host._reemit_handoffs): every byte they would re-emit lies
past the output bound.  The .lep bytes do not change: they stay equal to
the JAX package's compress.  Pinned on a 64x64 4:2:0 JPEG cut to 60-75%
of its bytes in 4 segments: the JAX package's decompress raises, the
port's host decompress, streaming decompress and device decode (the
plain reader) give the cut bytes back.
"""
import pytest

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.jpeg.recoder import RecodeError as JRecodeError  # noqa: E402
from lepton_tpu_torch import api, host  # noqa: E402
from lepton_tpu_torch.container.format import read_container  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402


@pytest.mark.parametrize("cut", [0.6, 0.65, 0.7, 0.75])
def test_truncated_multi_segment_round_trip(cut):
    data = _jpeg(64, 64, seed=3, quality=80, subsampling=2)
    short = data[:int(len(data) * cut)]
    lep = host.compress(short, max_threads=4, min_threads=4)
    assert lep == japi.compress(short, max_threads=4, min_threads=4)
    hdr = read_container(lep)[0]
    assert hdr.early_eof and len(hdr.handoffs) == 4
    with pytest.raises(JRecodeError, match="handoff mismatch"):
        japi.decompress(lep)
    assert host.decompress(lep) == short
    assert host.decompress_streaming(lep) == short
    assert api.decompress_device(lep, device="cpu") == short


def test_untruncated_segments_keep_their_handoffs():
    """A whole file and a cut that leaves every segment inside the coded
    rows re-emit from every handoff as before."""
    data = _jpeg(64, 64, seed=3, quality=80, subsampling=2)
    for blob in (data, data[:int(len(data) * 0.9)]):
        lep = host.compress(blob, max_threads=4, min_threads=4)
        hdr, mux = read_container(lep)
        info = host.image_info_from_header(hdr.hdrdata, allow_34=True)
        handoffs, _ = host._handoffs(hdr, mux, info)
        assert host._reemit_handoffs(hdr, handoffs, info) == handoffs
        assert host.decompress(lep) == japi.decompress(lep) == blob
