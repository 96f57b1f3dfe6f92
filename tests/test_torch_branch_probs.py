"""The encode coders' two stages on the CPU against the JAX package.

The plain versions stand in for the kernels here: the probability stage's
(lepton_tpu_torch.kernels.branch_probs.branch_probs_plain) probabilities
must equal vpx_scan.model_probs_sorted under both rules and the arena walk
(arena_probs_plain); the VPX walk's (vpx_coder.vpx_walk_plain) bytes must
equal vpx_scan.arith_pass with the host carry resolution and a BoolWriter
fed the same probabilities; the rANS walk's (ans_coder.ans_walk_plain)
words must equal vpx_scan.ans_pass with finalize_ans_streams, and the
kernel's reciprocal arithmetic (ans_coder.enc_table) must give the same
words.  Each coder's two stages, chained, must give the bytes of its
whole-function plain version.  The tolerance is zero.

Lanes (chip_smoke.stage_segments): empty, one symbol, odd and even counts
with heavy branch reuse and FIXED_PROB and PAD slots, one branch past both
count overflows, a longer lane; templates from _model_template_packed with
one prob-0 branch (chip_smoke.stage_template).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from lepton_tpu.api import _model_template_packed  # noqa: E402
from lepton_tpu.coder.vpx import BoolWriter  # noqa: E402
from lepton_tpu.kernels import vpx_scan  # noqa: E402

import chip_smoke  # noqa: E402
from lepton_tpu_torch.kernels import ans_coder, vpx_coder  # noqa: E402
from lepton_tpu_torch.kernels import branch_probs as bp  # noqa: E402
from lepton_tpu_torch.model.tables import (ARENA_SIZE,  # noqa: E402
                                           arena_from_template)

MASK64 = (1 << 64) - 1
# the JAX scans' unroll: results do not depend on it, compile time does
WINDOW = 4


@pytest.fixture
def start(request, synth_model, monkeypatch):
    """(packed template or None, coder-layout template or None)."""
    if request.param == "identity":
        return None, None
    monkeypatch.setenv("LEPTON_COMPRESSION_MODEL", synth_model)
    packed = chip_smoke.stage_template(_model_template_packed())
    return packed, arena_from_template(packed)


def _lanes(framed: bool):
    """chip_smoke.stage_lanes as torch tensors: (idx, bit, nsyms)."""
    return tuple(torch.as_tensor(a) for a in chip_smoke.stage_lanes(framed))


def _jax_probs(idx, bit, rule, packed):
    return np.asarray(vpx_scan.model_probs_sorted(
        jnp.asarray(idx.numpy()), jnp.asarray(bit.numpy()), WINDOW,
        update=rule, template=None if packed is None else jnp.asarray(packed,
                                                         jnp.uint32)))


@pytest.mark.parametrize("start", ["identity", "template"], indirect=True)
@pytest.mark.parametrize("rule", ["vpx", "adv"])
def test_branch_probs_plain_matches_jax(rule, start):
    packed, tpl = start
    idx, bit, nsyms = _lanes(framed=rule == "vpx")
    probs, zero = bp.branch_probs(idx, bit, tpl, rule,
                                  None if rule == "vpx" else nsyms)
    assert probs.dtype == torch.uint8 and probs.shape == idx.shape
    assert np.array_equal(probs.numpy(), _jax_probs(idx, bit, rule, packed))
    assert torch.equal(probs, bp.arena_probs_plain(idx, bit, tpl, rule))
    # PROB0_BRANCH is first met by a 1 bit: it codes under both rules
    assert not zero.any()
    if packed is not None:
        assert int(probs[1, int(rule == "vpx")]) == 0
        assert not torch.equal(probs, bp.branch_probs(idx, bit, None,
                                                      rule)[0])


def test_branch_probs_flags_zero_freq():
    """A 0 bit at a prob-0 branch: flagged under the adv rule (freq 0 has no
    rANS code), a valid symbol under the VPX rule."""
    packed, _, bad = chip_smoke.prob0_lanes()
    idx, bit, nsyms = (torch.as_tensor(a)
                       for a in chip_smoke.unframed_lanes(bad))
    tpl = arena_from_template(packed)
    _, zero = bp.branch_probs(idx, bit, tpl, "adv", nsyms)
    assert zero.tolist() == [False, True]
    _, zero = bp.branch_probs(idx, bit, tpl, "vpx")
    assert not zero.any()


def test_branch_probs_rejects_bad_inputs():
    idx = torch.zeros((2, 4), dtype=torch.int32)
    bit = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="rule"):
        bp.branch_probs(idx, bit, rule="arith")
    with pytest.raises(TypeError):
        bp.branch_probs(idx.long(), bit)
    with pytest.raises(ValueError, match="idx must lie"):
        bp.branch_probs(idx + ARENA_SIZE, bit)
    with pytest.raises(ValueError, match="nsyms"):
        bp.branch_probs(idx, bit, nsyms=torch.full((2,), 5,
                                                   dtype=torch.int32))
    # the packed sort key would need more than 63 bits
    big = torch.empty((1 << 20, 1 << 30), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="overflow"):
        bp.group(big, big.to(torch.uint8))


def test_stage_kernels_plain_on_a_small_batch():
    """run_heads_plain finds each (lane, branch) run's first key;
    walk_runs_plain gives the arena walk's probabilities from its runs in
    any order (the kernel's list has none) and the longest run; on CPU
    tensors the wrappers give the same."""
    idx = torch.tensor([[5, 3, 5, -2, 5, -1], [3, 3, 7, -1, -1, -1]],
                       dtype=torch.int32)
    bit = torch.tensor([[1, 0, 1, 0, 0, 0], [0, 1, 1, 0, 0, 0]],
                       dtype=torch.uint8)
    keys, shift = bp.group(idx, bit)
    heads = bp.run_heads_plain(keys, shift)
    # lane 0: branch 3 (1 key), branch 5 (3); lane 1: branch 3 (2), 7 (1)
    assert heads.tolist() == [0, 1, 4, 6]
    probs, zero, longest = bp.walk_runs_plain(keys, shift, heads.flip(0),
                                              idx.shape)
    assert longest == 3 and not zero.any()
    assert torch.equal(probs, bp.arena_probs_plain(idx, bit))
    assert torch.equal(bp.run_heads(keys, shift), heads)
    assert torch.equal(bp.walk_runs(keys, shift, heads, idx.shape)[0], probs)


@pytest.mark.parametrize("start", ["identity", "template"], indirect=True)
def test_vpx_walk_plain_matches_jax(start):
    packed, tpl = start
    idx, bit, _ = _lanes(framed=True)
    probs, _ = bp.branch_probs(idx, bit, tpl, "vpx")
    port = vpx_coder.finalize(*vpx_coder.vpx_walk_plain(idx, bit, probs))
    emit, byte, carry, nbytes = (np.asarray(x) for x in vpx_scan.arith_pass(
        jnp.asarray(idx.numpy()), jnp.asarray(bit.numpy()),
        jnp.asarray(probs.numpy().astype(np.int32)), WINDOW))
    assert port == vpx_scan.finalize_streams(emit, byte, carry, nbytes)
    # a BoolWriter (marker bit and stop bits its own) at the same
    # probabilities, PAD skipped
    for s, (i, b) in enumerate(chip_smoke.stage_segments()):
        w = BoolWriter()
        for k, (ik, bk) in enumerate(zip(i, b)):
            if ik != vpx_coder.PAD:
                w.put_bit(bk, int(probs[s, 1 + k]))
        assert port[s] == w.finish()


def _walk_by_table(probs, bits, n):
    """The ANS walk kernel's arithmetic in Python integers: the reciprocal
    table's entry of each pair value, q = (mulhi(m, x) + x) >> l, then
    x + q * (256 - freq) + start.  Returns the words in emission order."""
    table = [tuple(int(v) for v in e) for e in ans_coder.enc_table()]
    words = []

    def put(x, v):
        m, x_max, rest = table[v]
        if x >= x_max:
            words.append(x & 0xFFFFFFFF)
            x >>= 32
        lg, start_inv = rest & 0xFF, rest >> 32
        # the 65-bit sum in a 64-bit word and its carry, as on the card
        total = (((m * x) >> 64) + x) & MASK64
        carry = int(total < x)
        q = (total >> lg) | ((carry << (63 - lg)) << 1) & MASK64
        return (x + q * (start_inv >> 16) + (start_inv & 0xFFFF)) & MASK64

    sym = [int(p) | (int(b) != 0) << 8 for p, b in zip(probs[:n], bits[:n])]
    if n % 2:
        sym.append(0x101)                     # the odd count's sentinel
    x1 = x2 = ans_coder.RANS64_L
    pairs = [(128, 128)] * ans_coder.NOP_PAIRS + [
        (sym[2 * k + 1], sym[2 * k]) for k in reversed(range(len(sym) // 2))]
    for first, second in pairs:
        x1 = put(x1, first)
        x2 = put(x2, second)
    return words + [x1 >> 32, x1 & 0xFFFFFFFF, x2 >> 32, x2 & 0xFFFFFFFF]


@pytest.mark.parametrize("start", ["identity", "template"], indirect=True)
def test_ans_walk_plain_matches_jax(start):
    packed, tpl = start
    idx, bit, nsyms = _lanes(framed=False)
    probs, _ = bp.branch_probs(idx, bit, tpl, "adv", nsyms)
    words, nwords = ans_coder.ans_walk_plain(probs, bit, nsyms)
    port = ans_coder.finalize_ans(words, nwords)
    ys, flush, pad = vpx_scan.ans_pass(
        jnp.asarray(probs.numpy().astype(np.int32)),
        jnp.asarray(bit.numpy()), jnp.asarray(nsyms.numpy()), WINDOW)
    assert port == vpx_scan.finalize_ans_streams(ys, flush, pad)
    for s, n in enumerate(nsyms.tolist()):
        got = words[s, :int(nwords[s])].numpy().view(np.uint32).tolist()
        assert got == _walk_by_table(probs[s].numpy(), bit[s].numpy(), n)


def test_enc_table_divides_exactly():
    """(mulhi(m, x) + x) >> l == x // freq for every freq 1..256, at the
    edges of the renormalised state's range and between them."""
    rng = np.random.default_rng(5)
    table = ans_coder.enc_table()
    for freq in range(1, 257):
        m, x_max, rest = (int(v) for v in table[freq])   # bit 0, prob freq
        if freq == 256:
            m, x_max, rest = (int(v) for v in table[0x100])  # bit 1, prob 0
        assert x_max == freq << 55
        lg = rest & 0xFF
        xs = {0, 1, freq - 1, freq, freq + 1, x_max - 1, (1 << 32) - 1,
              1 << 32, MASK64}
        xs.update(int(v) for v in rng.integers(0, 1 << 63, 64,
                                               dtype=np.uint64))
        xs.update(freq * int(v) + d for v in rng.integers(0, 1 << 55, 16)
                  for d in (-1, 0, 1))
        for x in xs:
            if 0 <= x <= MASK64:
                assert (((m * x) >> 64) + x) >> lg == x // freq, (freq, x)


@pytest.mark.parametrize("start", ["identity", "template"], indirect=True)
@pytest.mark.parametrize("coder", ["vpx", "ans"])
def test_stages_chain_to_the_whole_coder(coder, start):
    """Probability stage, then walk (what encode_streams and
    encode_streams_ans run) == the arena-walk plain version of the whole
    coder."""
    _, tpl = start
    idx, bit, nsyms = _lanes(framed=coder == "vpx")
    if coder == "vpx":
        got = vpx_coder.finalize(*vpx_coder.encode_streams(idx, bit, tpl))
        want = vpx_coder.finalize(*vpx_coder.encode_streams_plain(idx, bit,
                                                                  tpl))
    else:
        got = ans_coder.finalize_ans(*ans_coder.encode_streams_ans(
            idx, bit, nsyms, tpl))
        want = ans_coder.finalize_ans(*ans_coder.encode_streams_ans_plain(
            idx, bit, nsyms, tpl))
    assert got == want


@pytest.mark.parametrize("coder", ["vpx", "ans"])
def test_overflow_reruns_the_walk_alone(coder, monkeypatch):
    """A tiny initial output cap: the walk runs twice, the probability
    stage's walk of runs once, and the streams are those of a roomy first
    run."""
    idx, bit, nsyms = _lanes(framed=coder == "vpx")
    mod = vpx_coder if coder == "vpx" else ans_coder
    walk_name = "vpx_walk_plain" if coder == "vpx" else "ans_walk_plain"

    def run():
        if coder == "vpx":
            return vpx_coder.finalize(*vpx_coder.encode_streams(idx, bit))
        return ans_coder.finalize_ans(*ans_coder.encode_streams_ans(
            idx, bit, nsyms))

    want = run()
    calls = {"probs": 0, "walk": []}
    probs_plain, walk_plain = bp.walk_runs_plain, getattr(mod, walk_name)

    def counted_probs(*a, **k):
        calls["probs"] += 1
        return probs_plain(*a, **k)

    def counted_walk(*a):
        calls["walk"].append(a[-1])
        return walk_plain(*a)

    monkeypatch.setattr(bp, "walk_runs_plain", counted_probs)
    monkeypatch.setattr(mod, walk_name, counted_walk)
    monkeypatch.setattr(mod, "default_cap", lambda L: 4)
    assert run() == want
    assert calls["probs"] == 1
    # the rerun's cap is the longest lane's count
    assert len(calls["walk"]) == 2 and calls["walk"][0] == 4 < calls["walk"][1]


def _one_branch_lanes(framed: bool):
    """Lanes that pin the probability stage's order: empty, one symbol,
    every symbol on one branch (long enough to pass both count overflows),
    one lane on the arena's last branch, and a lane that revisits the
    first lane's branch (a run per lane, never across lanes)."""
    rng = np.random.default_rng(21)
    segments = [([], []), ([5], [1]),
                ([9] * 700, rng.integers(0, 2, 700).tolist()),
                ([ARENA_SIZE - 1] * 300, [1] * 200 + [0] * 100), ([], []),
                ([9] * 3, [0, 1, 0])]
    if framed:
        idx, bit = vpx_coder.build_symbol_streams(segments)
        return torch.as_tensor(idx), torch.as_tensor(bit), None
    return tuple(torch.as_tensor(a) for a in chip_smoke.unframed_lanes(
        segments))


@pytest.mark.parametrize("rule", ["vpx", "adv"])
def test_sort_order_matches_model_probs_sorted(rule):
    """The packed-key sort (branch_probs.group) codes each lane's symbols
    in the order of model_probs_sorted's stable sort on the branch
    (vpx_scan.py:556-557), on lanes of 0 and 1 symbols and lanes whose
    symbols all hit one branch; the keys unpack to their (lane, branch,
    position, bit) and stay non-negative."""
    idx, bit, nsyms = _one_branch_lanes(framed=rule == "vpx")
    probs, _ = bp.branch_probs(idx, bit, None, rule, nsyms)
    assert np.array_equal(probs.numpy(), _jax_probs(idx, bit, rule, None))
    assert torch.equal(probs, bp.arena_probs_plain(idx, bit, None, rule,
                                                   nsyms))
    keys, shift = bp.group(idx, bit, nsyms)
    assert bool((keys >= 0).all()) and bool((keys[1:] > keys[:-1]).all())
    S, L = idx.shape
    lane, branch = (keys >> shift) // ARENA_SIZE, (keys >> shift) % ARENA_SIZE
    pos = (keys >> 1) & ((1 << (shift - 1)) - 1)
    assert torch.equal(idx[lane, pos].long(), branch)
    assert torch.equal(bit[lane, pos].long(), keys & 1)


@pytest.mark.parametrize("L", [1, 2, 3, 1 << 10, (1 << 10) + 1, 1 << 20,
                               (1 << 26) + 1, 1 << 40])
def test_sort_key_guard_at_its_edge(L):
    """key_shift takes the most lanes whose largest key, ((S *
    ARENA_SIZE - 1) << shift) | (L - 1) << 1 | 1, still fits in 63 bits,
    and raises at one lane more: a key never wraps into the sign bit."""
    shift = max(L - 1, 1).bit_length() + 1
    most = (1 << (63 - shift)) // ARENA_SIZE
    assert bp.key_shift(most, L) == shift
    largest = ((most * ARENA_SIZE - 1) << shift) | (L - 1) << 1 | 1
    assert largest < 1 << 63
    with pytest.raises(ValueError, match="overflow"):
        bp.key_shift(most + 1, L)


def _wide_edges():
    """(n, d) on _exact_div_f32's wide domain edges: n < 2^31 with
    n / d < 2^24, for d = 1 and 2 up to 2^10, n at the top of its range
    and around multiples of d there, and small n."""
    pairs = set()
    for d in (1, 2, 3, 7, 127, 128, 129, 255, 256, 257, 511, 1023, 1024):
        top = min((1 << 31) - 1, d * (1 << 24) - 1)
        k = top // d * d
        for n in (top, top - 1, top - d, k, k - 1, k + 1, k - d, 0, 1,
                  d - 1, d, d + 1, 1 << 16, (1 << 16) - 1):
            if 0 <= n <= top:
                pairs.add((n, d))
    return sorted(pairs)


def _freq_entry(freq: int) -> int:
    """The enc_table entry of a 1 bit coded with frequency freq (1 to
    256): bit 1 << 8 | prob, freq = 256 - prob."""
    return 0x100 | (256 - freq) & 0xFF


def test_reciprocal_division_matches_exact_div_f32():
    """The reciprocal divisions of the port's kernels against the JAX
    division they replaced, vpx_scan._exact_div_f32 (:451-472), on its
    wide=True domain edges: the walk's 64-bit reciprocal
    (ans_coder.enc_table, q = (mulhi(m, x) + x) >> l, freq 1 to 256; the
    JAX _div64_small on (hi, lo) with hi up to 2^31 - 1) and the branch
    update's ceil(2^32 / d) with __umulhi (vpx_branch.cuh, d below 512,
    n below 2^16).  d = 2^10, past every divisor the port's kernels take,
    pins the JAX function alone."""
    pairs = _wide_edges()
    n = jnp.asarray([p[0] for p in pairs], jnp.int32)
    d = jnp.asarray([p[1] for p in pairs], jnp.int32)
    jwide = np.asarray(vpx_scan._exact_div_f32(n, d, wide=True))
    assert jwide.tolist() == [a // b for a, b in pairs]
    table = ans_coder.enc_table()
    for (a, b), q in zip(pairs, jwide.tolist()):
        if b <= 256:
            m, _, rest = (int(v) for v in table[_freq_entry(b)])
            assert (((m * a) >> 64) + a) >> (rest & 0xFF) == q, (a, b)
        if 2 <= b < 512 and a < 1 << 16:
            assert (a * (((1 << 32) + b - 1) // b)) >> 32 == q, (a, b)
    # the 64-bit rANS division: hi < 2^31 at its top, freq 1 to 256
    his = [(1 << 31) - 1, (1 << 31) - 2, 1 << 30, 255, 0]
    los = [0, 1, (1 << 32) - 1, 0x80000000]
    for f in (1, 2, 3, 127, 128, 255, 256):
        hi = jnp.asarray([h for h in his for _ in los], jnp.int32)
        lo = jnp.asarray([x for _ in his for x in los], jnp.uint32)
        qh, ql, rem = (np.asarray(a) for a in vpx_scan._div64_small(
            hi, lo, jnp.full(hi.shape, f, jnp.int32)))
        m, _, rest = (int(v) for v in table[_freq_entry(f)])
        for k, (h, x) in enumerate((h, x) for h in his for x in los):
            full = h << 32 | x
            q = (((m * full) >> 64) + full) >> (rest & 0xFF)
            assert q == full // f
            assert (int(qh[k]) << 32 | int(ql[k])) == q, (h, x, f)
            assert int(rem[k]) == full - q * f
