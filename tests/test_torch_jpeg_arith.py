"""The port's T.81 QM coder (lepton_tpu_torch/coder/jpeg_arith.py) against
the JAX package's, on the CPU.

The JAX copy is held against the reference's own coder in
tests/test_jpeg_arith.py, which needs the reference sources; here the two
Python implementations are compared: equal writer bytes on seeded
streams, carries and 0xFF stuffing among them, equal context states, and
the port's reader giving the bits back, also when a marker and other
bytes follow the stream.  Every comparison is exact.
"""
import random

import pytest

from lepton_tpu.coder import jpeg_arith as jqm
from lepton_tpu_torch.coder import jpeg_arith as qm


def _case(seed: int):
    """(contexts, bits, context indices) from a seed: context counts,
    lengths and skews as tests/test_jpeg_arith.py draws them."""
    rng = random.Random(seed)
    n_ctx = rng.choice([1, 3, 64, 300])
    nbits = rng.choice([0, 1, 7, 500, 30000])
    skew = rng.choice([0.01, 0.35, 0.5, 0.97])
    bits = [int(rng.random() < skew) for _ in range(nbits)]
    idxs = [rng.randrange(n_ctx) for _ in range(nbits)]
    return n_ctx, bits, idxs


def _encode(mod, bits, idxs, n_ctx):
    w = mod.JpegBoolWriter()
    st = mod.initial_states(n_ctx)
    for b, i in zip(bits, idxs):
        w.put_bit(b, st, i)
    return w.finish(), st


def test_writer_matches_jax(monkeypatch):
    carries = []
    emit = qm.JpegBoolWriter._emit_pending_plus_carry

    def counted(self):
        carries.append(self._pending >= 0)
        emit(self)

    monkeypatch.setattr(qm.JpegBoolWriter, "_emit_pending_plus_carry",
                        counted)
    stuffed = 0
    for seed in range(30):
        n_ctx, bits, idxs = _case(seed)
        ours, st = _encode(qm, bits, idxs, n_ctx)
        theirs, jst = _encode(jqm, bits, idxs, n_ctx)
        assert ours == theirs, f"seed {seed}"
        assert st == jst, f"seed {seed}"
        stuffed += ours.count(b"\xff\x00")
    # the streams reach both byte-output paths
    assert any(carries) and stuffed


@pytest.mark.parametrize("seed", range(8))
def test_reader_round_trips_and_stops_at_marker(seed):
    n_ctx, bits, idxs = _case(100 + seed)
    stream, enc_states = _encode(qm, bits, idxs, n_ctx)
    for tail in (b"", b"\xff\xd9" + bytes(range(64))):
        r = qm.JpegBoolReader(stream + tail)
        st = qm.initial_states(n_ctx)
        assert [r.get_bit(st, i) for i in idxs] == bits
        assert st == enc_states
        # never reads past the marker's first byte
        assert r.pos <= len(stream) + 1
        jr = jqm.JpegBoolReader(stream + tail)
        jst = jqm.initial_states(n_ctx)
        assert [jr.get_bit(jst, i) for i in idxs] == bits


def test_states_are_table_d3():
    assert qm.NUM_STATES == jqm.NUM_STATES == 114
    assert qm._D3 == jqm._D3
    assert qm.initial_states(5) == bytearray(5)
