"""The soak's multi-segment cases (soak.MULTI_SEGMENTS, gen_multi_case):
a JPEG under 125,000 bytes of scan data codes one segment, so the soak
draws a few cases sized to code 2 to 8 segments, from the same seed as
its other cases, each at the smallest side (a multiple of 16) that codes
its count; run(multi=) holds each to that count on the card and the host.

On the CPU the one case checked is the smallest, 2 segments; the plain
coder and reader would take minutes on a scan that size (about 1.5 ms a
scan byte each way on a CPU), so the card's part of it runs in
chip_smoke.py phase 17.  Here: the case is rebuilt alike from (seed,
index) and codes exactly 2 segments, 16 px less codes 1; its .lep
equals the JAX package's compress on the soak's settings; its three
truncations and three bit flips decode on the port's host codec to the
JAX package's outcome, except a cut that the JAX re-emit refuses with
"handoff mismatch", which the port decodes (host._reemit_handoffs); and
its decode plan has one lane a segment, whose owned blocks cover every
block of the planes once.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import lepton_tpu.api as japi  # noqa: E402
from lepton_tpu_torch import api, host, soak  # noqa: E402
from lepton_tpu_torch.kernels import vpx_decoder  # noqa: E402

SEED, INDEX = 0, 6      # after test_torch_robustness.py's 6-case soak


def _outcome(fn, blob):
    try:
        return fn(blob)
    except Exception as e:      # the outcome is the failure itself
        return e


def test_two_segment_case():
    case = soak.Case(SEED, INDEX, segments=2)
    again = soak.Case(SEED, INDEX, segments=2)
    assert case.jpeg == again.jpeg and case.params == again.params
    assert case.params["segments"] == case.codec["max_threads"] == 2
    assert soak._codes_segments(case.jpeg, 2) == 2
    smaller = dict(case.params)
    rng = soak.random.Random(case.seed)
    soak.gen_multi_case(rng, 2)
    seed = rng.randrange(1 << 31)
    smaller["w"] = smaller["h"] = case.params["w"] - 16
    assert soak._codes_segments(
        soak.make_jpeg(smaller, soak.random.Random(seed)), 2) == 1

    lep = host.compress(case.jpeg, **case.host_kw())
    assert lep == japi.compress(case.jpeg, **case.host_kw())
    assert host.decompress(lep) == case.jpeg
    for check, blob, detail in soak._hostile_variants(case, lep):
        mine, theirs = (_outcome(host.decompress, blob),
                        _outcome(japi.decompress, blob))
        if isinstance(theirs, Exception) and "handoff mismatch" in \
                str(theirs):
            assert isinstance(mine, bytes), (check, detail, mine)
        elif isinstance(theirs, bytes):
            assert mine == theirs, (check, detail)
        else:
            assert isinstance(mine, Exception), (check, detail)

    req = api._decode_request(lep)[0]
    plan = vpx_decoder.plan_decode([req], "ans" if case.codec["version"]
                                   == 3 else "vpx")
    assert len(plan.lanes) == 2
    owned = np.concatenate([plan.owned_blocks(k, k + 1) for k in range(2)])
    assert np.array_equal(np.sort(owned), np.arange(plan.n_blocks))


def test_multi_segment_cases_code_their_counts():
    """Every case of MULTI_SEGMENTS at index 72 on, as chip_smoke.py's
    phase 17 draws them, codes its count on the host."""
    for k, m in enumerate(soak.MULTI_SEGMENTS):
        case = soak.Case(SEED, 72 + k, segments=m)
        assert 2 <= m <= 8 and soak._codes_segments(case.jpeg, m) == m
        assert not case.codec["allow_progressive"]
