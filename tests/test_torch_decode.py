"""The port's decode kernel and its host layers on the CPU against the JAX
package: the container reader, the demux, the plain version of the VPX
token decoder (lepton_tpu_torch.kernels.vpx_decoder) and the Huffman
re-emit.

The decoder's planes must equal lepton_tpu's vpx_decode.decode_segments_tpu
and pallas_decode.decode_segments_pallas(interpret=True) exactly: the
tolerance is zero.  Inputs are PIL-made JPEGs from numpy seeds.  Each JAX
decode compiles once per geometry, so the cases share geometries.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.container.format import read_container as jread  # noqa: E402
from lepton_tpu.container.mux import MuxReader as JMuxReader  # noqa: E402
from lepton_tpu.jpeg.imageinfo import image_info_from_header as jinfo  # noqa: E402,E501
from lepton_tpu.jpeg.recoder import recode_baseline_jpeg as jrecode  # noqa: E402,E501
from lepton_tpu.kernels.pallas_decode import (  # noqa: E402
    decode_segments_pallas, decode_segments_pallas_multi)
from lepton_tpu.kernels.vpx_decode import decode_segments_tpu  # noqa: E402
from lepton_tpu_torch import api, host  # noqa: E402
from lepton_tpu_torch.container.format import read_container  # noqa: E402
from lepton_tpu_torch.container.mux import MuxReader  # noqa: E402
from lepton_tpu_torch.jpeg.imageinfo import image_info_from_header  # noqa: E402,E501
from lepton_tpu_torch.jpeg.recoder import recode_baseline_jpeg  # noqa: E402
from lepton_tpu_torch.kernels import vpx_decoder  # noqa: E402
from lepton_tpu_torch.model.tables import arena_from_template  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402


def _ci(c):
    return 0 if c == 0 else 1


def _request(lep):
    """The port's decode request of a container, and its JAX twin built by
    lepton_tpu.api._tpu_decode_request."""
    req, _, _ = api._decode_request(lep)
    jreq, _, _, _ = japi._tpu_decode_request(lep)
    return req, jreq


def _decode(requests, template=None):
    """Every request in one plain-version call on the CPU: per request
    (planes, err bool [segments]).  template: a packed uint32 trained
    model, as _model_template_packed gives it."""
    plan = vpx_decoder.plan_decode(requests)
    tpl = None if template is None else arena_from_template(template)
    coef, err = vpx_decoder.decode_lanes(**plan.to("cpu"), template=tpl)
    return vpx_decoder.split_planes(plan, coef, err != 0)


def _jargs(jreq):
    return [jreq[k] for k in ("streams", "plane_shapes", "color_tables",
                              "mcuv", "max_coded_heights", "component_sizes",
                              "splits_y")]


def _assert_planes(got, want):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.int16 and g.shape == w.shape
        assert np.array_equal(g, w), (c, np.argwhere(g != w)[:5])


def _header_fields(hdr):
    d = dict(vars(hdr))
    d["handoffs"] = [vars(h) for h in hdr.handoffs]
    return d


@pytest.mark.parametrize("case", ["two_segments", "restarts", "truncated"])
def test_read_container_matches_jax(case):
    """Every header field and the mux region, and the demuxed streams."""
    if case == "two_segments":
        lep = japi.compress(_jpeg(48, 32, seed=2, quality=80, subsampling=2),
                            max_threads=2, min_threads=2)
    elif case == "restarts":
        lep = japi.compress(_jpeg(48, 48, seed=4, quality=80,
                                  restart_marker_blocks=4, subsampling=2))
    else:
        data = _jpeg(64, 64, seed=3, quality=80, subsampling=2)
        lep = japi.compress(data[:len(data) * 3 // 5])
    hdr, mux = read_container(lep)
    jhdr, jmux = jread(lep)
    assert _header_fields(hdr) == _header_fields(jhdr)
    assert mux == jmux
    assert ([bytes(b) for b in MuxReader(mux).buffers]
            == [bytes(b) for b in JMuxReader(jmux).buffers])
    if case == "truncated":
        assert hdr.early_eof
    if case == "restarts":
        assert hdr.rst_cnt_set


@pytest.mark.parametrize("nseg", [1, 2])
def test_plain_matches_jax_decoders(nseg):
    """The plain version on the CPU against the XLA scan and the Pallas
    kernel in interpret mode, on one geometry."""
    lep = japi.compress(_jpeg(32, 24, seed=3, quality=85, subsampling=2),
                        max_threads=nseg, min_threads=nseg)
    req, jreq = _request(lep)
    (planes, err), = _decode([req])
    want, err_w = decode_segments_tpu(*_jargs(jreq), color_index=_ci)
    got_p, err_p = decode_segments_pallas(*_jargs(jreq), color_index=_ci,
                                          interpret=True)
    assert len(err) == nseg and not err.any()
    assert not err_w.any() and not err_p.any()
    _assert_planes(planes, want)
    _assert_planes(planes, got_p)


def test_template_start_matches_jax(synth_model, monkeypatch):
    """LEPTON_COMPRESSION_MODEL: every lane starts from the trained arena."""
    monkeypatch.setenv("LEPTON_COMPRESSION_MODEL", synth_model)
    monkeypatch.delenv("LEPTON_COMPRESSION_MODEL_OUT", raising=False)
    data = _jpeg(32, 24, seed=11, quality=85, subsampling=2)
    lep = japi.compress(data, max_threads=2, min_threads=2)
    tpl = japi._model_template_packed()
    assert np.array_equal(tpl, host._model_template_packed())
    req, jreq = _request(lep)
    (planes, err), = _decode([req], tpl)
    want, _ = decode_segments_tpu(*_jargs(jreq), color_index=_ci,
                                  template=tpl)
    got_p, _ = decode_segments_pallas(*_jargs(jreq), color_index=_ci,
                                      interpret=True, template=tpl)
    assert not err.any()
    _assert_planes(planes, want)
    _assert_planes(planes, got_p)
    assert api.decompress_device(lep, device="cpu") == data


def test_multi_request_matches_jax():
    """Two requests of different geometry and quality in one call, each
    lane routed to its own request's colour tables, against
    decode_segments_pallas_multi."""
    leps = [japi.compress(_jpeg(32, 24, seed=5, quality=85, subsampling=2),
                          max_threads=2, min_threads=2),
            japi.compress(_jpeg(48, 16, seed=7, quality=70, subsampling=2))]
    reqs = [_request(lep) for lep in leps]
    got = _decode([r for r, _ in reqs])
    want = decode_segments_pallas_multi([j for _, j in reqs],
                                        interpret=True)
    for (planes, err), (wplanes, werr) in zip(got, want):
        assert not err.any() and not werr.any()
        _assert_planes(planes, wplanes)


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_recoder_matches_jax(use_native):
    """The port's re-emit, native and Python, gives the JAX recoder's bytes
    on the same planes (restart markers, three segments)."""
    data = _jpeg(48, 48, seed=6, quality=80, restart_marker_blocks=4,
                 subsampling=2)
    lep = japi.compress(data, max_threads=3, min_threads=3)
    req, hdr, handoffs = api._decode_request(lep)
    plan = vpx_decoder.plan_decode([req])
    coef, err = vpx_decoder.decode_lanes(**plan.to("cpu"))
    (planes, _), = vpx_decoder.split_planes(plan, coef.numpy(),
                                            err.numpy() != 0)

    def run(recode, info_of):
        return recode(hdr.hdrdata, planes, handoffs,
                      info_of(hdr.hdrdata, allow_34=True), hdr.padbit,
                      hdr.rst_cnt, hdr.rst_cnt_set, hdr.rst_err, hdr.garbage,
                      hdr.original_size, hdr.prefix_garbage,
                      hdr.embedded_jpeg, use_native=use_native)

    out = run(recode_baseline_jpeg, image_info_from_header)
    assert out == run(jrecode, jinfo) == data


def test_luts_match_pallas():
    from lepton_tpu.kernels.pallas_decode import _build_luts
    luts = vpx_decoder.build_luts()
    assert np.array_equal(luts[:192], _build_luts())


@pytest.mark.parametrize("row,field,value", [
    (2, "has_above", 1), (0, "ctab", 5), (0, "width", 99),
    (0, "out_block", -1), (0, "comp", 3), (0, "row0", 1)])
def test_decode_lanes_rejects_bad_descriptors(row, field, value):
    """The kernel indexes its buffers unchecked: the wrapper refuses row
    and lane descriptors that would reach outside them.  (Row 2 of this
    4:2:0 image is the first luma row, at block 0 of the planes.)"""
    lep = japi.compress(_jpeg(16, 16, seed=1, quality=80, subsampling=2))
    plan = vpx_decoder.plan_decode([api._decode_request(lep)[0]])
    assert plan.rows[2, :2].tolist() == [0, 0]
    if field in vpx_decoder.LANE_FIELDS:
        plan.lanes[0, vpx_decoder.LANE_FIELDS.index(field)] = value
    else:
        plan.rows[row, vpx_decoder.ROW_FIELDS.index(field)] = value
    with pytest.raises(ValueError, match="out of range"):
        vpx_decoder.decode_lanes(**plan.to("cpu"))
