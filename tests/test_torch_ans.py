"""The port's rANS lanes (container v3) and brotli headers (v2 and v3) on
the CPU against the JAX package.

The plain versions stand in for the kernels here: the ANS coder's
(lepton_tpu_torch.kernels.ans_coder.encode_streams_ans_plain) bytes must
equal vpx_scan.encode_streams_ans and a loop over coder.ans.ANSWriter; the
rANS reader's (vpx_decoder.decode_lanes_plain, coder="ans") planes must
equal decode_segments_tpu and the Pallas kernel in interpret mode; v2 and
v3 .lep bytes must equal batch_compress_tpu (here) and compress_tpu and the
host compress (tests/test_torch_versions.py, a file of its own because each
compress_tpu compiles once per geometry), and decode back to the original
JPEG.  The tolerance is zero.

Where the two versions are most likely to differ from the JAX package, and
the test that holds each:
  1. framing: v3 lanes carry no marker and no stop bits
     (test_batch_compress_v3_matches_jax, and test_torch_versions.py);
  2. the pair layout and the odd count's sentinel, and
  3. the 4 nop pairs, 4. the word order (s1's word before s2's, flush h1,
     l1, h2, l2), 5. the parity tail, 6. a lane of no symbols, 7. the
     template's first-use probability (test_ans_coder_plain_matches_jax);
  8. the adv rule's & 0xFF | 1 (test_adv_update_full_domain);
  9. words past a stream's end read as zero, and 10. the unsigned
     renormalisation test (test_ans_reader_plain_matches_jax, and
     test_ans_reader_reads_zeros_past_the_end).
Inputs are PIL-made JPEGs and symbol lanes from seeds.
"""
import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu.coder.ans import ANSWriter  # noqa: E402
from lepton_tpu.coder.ans import adv_update_branch as jadv  # noqa: E402
from lepton_tpu.kernels import vpx_scan  # noqa: E402
from lepton_tpu.kernels.pallas_decode import decode_segments_pallas  # noqa: E402,E501
from lepton_tpu.kernels.vpx_decode import decode_segments_tpu  # noqa: E402
from lepton_tpu.model.branch import next_state_lut_adv  # noqa: E402

import chip_smoke  # noqa: E402
from lepton_tpu_torch import api, soak  # noqa: E402
from lepton_tpu_torch.kernels import ans_coder, vpx_decoder  # noqa: E402
from lepton_tpu_torch.model.branch import adv_update_branch  # noqa: E402
from lepton_tpu_torch.model.tables import arena_from_template  # noqa: E402
from test_torch_encode import _jpeg  # noqa: E402


def _ci(c):
    return 0 if c == 0 else 1


def _writer_bytes(idx, bits, packed=None):
    """ANSWriter over a lane, each branch from the identity or from the
    packed template (c0 << 16 | c1 << 8 | prob), the adv rule after each
    symbol."""
    state = {}
    w = ANSWriter()
    for i, b in zip(idx, bits):
        if i not in state:
            p = 0x010180 if packed is None else int(packed[i])
            state[i] = ((p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF)
        fc, tc, prob = state[i]
        w.put_bit(int(b), prob)
        state[i] = adv_update_branch(fc, tc, bool(b))
    return w.finish()


def _port_lanes(segments, template=None):
    idx, bit, nsyms = (torch.as_tensor(a) for a in
                       chip_smoke.unframed_lanes(segments))
    out, nw = ans_coder.encode_streams_ans(idx, bit, nsyms, template)
    return ans_coder.finalize_ans(out, nw)


@pytest.mark.parametrize("start", ["identity", "template"])
def test_ans_coder_plain_matches_jax(start, synth_model, monkeypatch):
    """Empty and one-symbol lanes, odd and even counts with branch reuse,
    one branch past both count overflows, and a longer random lane."""
    packed = None
    if start == "template":
        monkeypatch.setenv("LEPTON_COMPRESSION_MODEL", synth_model)
        packed = japi._model_template_packed()
    segments = chip_smoke.ans_adversarial_segments(3000)
    tpl = None if packed is None else arena_from_template(packed)
    port = _port_lanes(segments, tpl)
    ref = vpx_scan.encode_streams_ans(
        segments, template=None if packed is None
        else jax.numpy.asarray(packed, jax.numpy.uint32))
    assert port == ref
    assert port == [_writer_bytes(i, b, packed) for i, b in segments]
    # a lane of no symbols still codes the 4 nop pairs and the flush
    assert len(port[0]) == 4 * 4 + len(ans_coder.ANS_PARITY_TAIL)
    assert all(p.endswith(ans_coder.ANS_PARITY_TAIL) for p in port)


def test_ans_coder_plain_probability_zero():
    """A template's prob-0 branch (VPX-trained models store 0 for a branch
    they never saw): a 1 bit there codes as ANSWriter and vpx_scan code it;
    a 0 bit there is freq 0 and raises ValueError naming the lane."""
    packed, ok, bad = chip_smoke.prob0_lanes()
    tpl = arena_from_template(packed)
    port = _port_lanes(ok, tpl)
    assert port == [_writer_bytes(i, b, packed) for i, b in ok]
    assert port == vpx_scan.encode_streams_ans(
        ok, template=jax.numpy.asarray(packed, jax.numpy.uint32))
    with pytest.raises(ValueError, match=r"lanes \[1\].*probability 0"):
        _port_lanes(bad, tpl)


def test_adv_update_full_domain():
    """The vectorised adv rule and the next-state table equal the JAX
    package's scalar rule and LUT on every (fc, tc, bit), the prob
    wrapped to 8 bits and ORed with 1."""
    fc, tc, obs = np.meshgrid(np.arange(256), np.arange(256), [0, 1],
                              indexing="ij")
    got = ans_coder.branch_update_adv(
        torch.as_tensor(fc.ravel()), torch.as_tensor(tc.ravel()),
        torch.as_tensor(obs.ravel() != 0)).numpy()
    lut = next_state_lut_adv().astype(np.int64)      # [fc, tc, obs, 3]
    want = (lut[..., 0] | (lut[..., 1] << 8) | (lut[..., 2] << 16)).ravel()
    assert np.array_equal(got, want)
    for f, t, o in ((255, 3, 0), (0, 255, 1), (0, 0, 0), (254, 0, 0),
                    (200, 255, 1)):
        nf, nt, p = jadv(f, t, bool(o))
        assert adv_update_branch(f, t, bool(o)) == (nf, nt, (p & 0xFF) | 1)
    table = ans_coder.next_state_adv("cpu")
    state = (tc.ravel() << 9) | (fc.ravel() << 1) | obs.ravel()
    assert np.array_equal(table[torch.as_tensor(state)].numpy(), got)


def test_encode_streams_ans_rejects_bad_inputs():
    idx = torch.zeros((2, 4), dtype=torch.int32)
    bit = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(TypeError):
        ans_coder.encode_streams_ans(idx, bit, torch.zeros(2))
    with pytest.raises(ValueError, match="nsyms"):
        ans_coder.encode_streams_ans(idx, bit,
                                     torch.full((2,), 5, dtype=torch.int32))
    with pytest.raises(ValueError, match="idx must lie"):
        ans_coder.encode_streams_ans(idx - 3, bit,
                                     torch.zeros(2, dtype=torch.int32))


def _jargs(jreq):
    return [jreq[k] for k in ("streams", "plane_shapes", "color_tables",
                              "mcuv", "max_coded_heights", "component_sizes",
                              "splits_y")]


def _plain_planes(lep, template=None):
    req, hdr, _ = api._decode_request(lep)
    assert hdr.version == 3
    plan = vpx_decoder.plan_decode([req], coder="ans")
    tpl = None if template is None else arena_from_template(template)
    coef, err = vpx_decoder.decode_lanes(**plan.to("cpu"), template=tpl)
    (planes, bad), = vpx_decoder.split_planes(plan, coef.numpy(),
                                              err.numpy() != 0)
    return planes, bad


def _assert_planes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and np.array_equal(g, w)


@pytest.mark.parametrize("nseg", [1, 2, 4])
def test_ans_reader_plain_matches_jax(nseg):
    """Host compress(version=3) files: the plain rANS reader against the
    XLA scan and the Pallas kernel in interpret mode."""
    lep = japi.compress(_jpeg(32, 32, seed=3, quality=85, subsampling=2),
                        max_threads=nseg, min_threads=nseg, version=3)
    planes, bad = _plain_planes(lep)
    jreq = japi._tpu_decode_request(lep)[0]
    want, werr = decode_segments_tpu(*_jargs(jreq), color_index=_ci,
                                     coder="ans")
    got_p, perr = decode_segments_pallas(*_jargs(jreq), color_index=_ci,
                                         interpret=True, coder="ans")
    assert len(bad) == nseg and not bad.any()
    assert not werr.any() and not perr.any()
    _assert_planes(planes, want)
    _assert_planes(planes, got_p)


def test_ans_reader_template_matches_jax(synth_model, monkeypatch):
    monkeypatch.setenv("LEPTON_COMPRESSION_MODEL", synth_model)
    monkeypatch.delenv("LEPTON_COMPRESSION_MODEL_OUT", raising=False)
    data = _jpeg(32, 24, seed=11, quality=85, subsampling=2)
    lep = japi.compress(data, max_threads=2, min_threads=2, version=3)
    tpl = japi._model_template_packed()
    planes, bad = _plain_planes(lep, tpl)
    jreq = japi._tpu_decode_request(lep)[0]
    want, _ = decode_segments_tpu(*_jargs(jreq), color_index=_ci,
                                  coder="ans", template=tpl)
    assert not bad.any()
    _assert_planes(planes, want)
    assert api.decompress_device(lep, device="cpu") == data


def test_ans_reader_reads_zeros_past_the_end():
    """A stream cut short decodes as if zero words followed it, as the host
    codec's C reader (leptonc.c, the reference's reader) decodes it: the
    same stream-inconsistency flag, and the same planes where neither
    flags; the reader's states stay exact where the top bit of a 64-bit
    state is set (the unsigned renormalisation test).  Both streams reach
    11-bit coefficients, whose 10 residual bits the port reads as the host
    codec does; the JAX package's device reader reads 9 and parts from
    both here (ROADMAP Queue 3)."""
    lep = japi.compress(_jpeg(32, 24, seed=5, quality=85, subsampling=2),
                        version=3)
    req, _, _ = api._decode_request(lep)
    short = req["streams"][0][:len(req["streams"][0]) // 3]
    # the cut stream, then a first state word with its top bit set
    for stream in (short, b"\xff" * 16 + short[16:]):
        pair = (lep, dict(req, streams=[stream]))
        plan = vpx_decoder.plan_decode([pair[1]], coder="ans")
        coef, err = (t.numpy() for t in vpx_decoder.decode_lanes(
            **plan.to("cpu")))
        assert soak.host_diffs(plan, [pair], coef, err) == []


def test_batch_compress_v3_matches_jax():
    blobs = [_jpeg(40, 32, seed=s, quality=q, subsampling=sub)
             for s, q, sub in ((1, 90, 2), (2, 60, 0))]
    blobs.append(_jpeg(24, 16, seed=3, mode="L", quality=75))
    stats = {}
    leps = api.batch_compress_device(blobs, num_segments=4, device="cpu",
                                     stats=stats, version=3)
    assert leps == japi.batch_compress_tpu(blobs, num_segments=4, version=3)
    assert "ans_coder_ms" in stats and "coder_ms" not in stats
    assert api.batch_decompress_device(leps, device="cpu") == blobs


def test_mixed_versions_one_call_per_coder(monkeypatch):
    """One call with v1, v2 and v3 requests runs the VPX reader once and
    the rANS reader once, and gives back every JPEG."""
    blobs = [_jpeg(32, 24, seed=s, quality=80, subsampling=2)
             for s in (1, 2, 3, 4)]
    leps = [japi.compress(b, version=v)
            for b, v in zip(blobs, (1, 3, 2, 3))]
    calls = []
    plain = vpx_decoder.decode_lanes_plain

    def counted(*args, **kw):
        calls.append((kw.get("coder", args[9] if len(args) > 9 else "vpx"),
                      args[0].shape[0]))
        return plain(*args, **kw)

    monkeypatch.setattr(vpx_decoder, "decode_lanes_plain", counted)
    assert api.batch_decompress_device(leps, device="cpu") == blobs
    assert sorted(calls) == [("ans", 2), ("vpx", 2)]


def test_roofline_probe_plain_matches_jax():
    """The probe's plain loop == tools/decode_roofline._mk_kernel in
    interpret mode, on every chain of a few dozen steps."""
    import importlib.util
    import os
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from lepton_tpu_torch.probes import decode_roofline
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "decode_roofline.py")
    spec = importlib.util.spec_from_file_location("_jax_roofline", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert (tool.ROWS, tool.LANES) == (decode_roofline.ROWS,
                                       decode_roofline.LANES)
    for kind, K in (("rmw", 1), ("rmw", 4), ("alu", 1), ("mixed", 1)):
        fn = pl.pallas_call(
            tool._mk_kernel(40, kind, K), grid=(1,),
            out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
            out_shape=jax.ShapeDtypeStruct((1,), jax.numpy.int32),
            scratch_shapes=[pltpu.VMEM((tool.ROWS, tool.LANES),
                                       jax.numpy.int32)],
            interpret=True)
        want = int(np.asarray(fn())[0])
        assert decode_roofline.probe_plain(kind, 40, K) == want
        assert int(decode_roofline.probe(kind, 40, K, device="cpu")) == want


def test_random_lanes_round_trip_through_the_reader():
    """Random branch lanes coded by the plain ANS coder read back bit for
    bit by the JAX package's ANSReader at the same probabilities."""
    from lepton_tpu.coder.ans import ANSReader
    rng = random.Random(17)
    n = 2001
    idx = [rng.randrange(40) for _ in range(n)]
    bits = [rng.randrange(2) for _ in range(n)]
    data, = _port_lanes([(idx, bits)])
    r = ANSReader(data)
    state = {}
    for i, b in zip(idx, bits):
        fc, tc, prob = state.get(i, (1, 1, 128))
        assert r.get_bit(prob) == b
        state[i] = adv_update_branch(fc, tc, bool(b))
