"""Progressive JPEG scan decoding (DC/AC, first/refine, EOB runs).

Port of the progressive paths of decode_jpeg (reference jpgcoder.cc:
2990-3260) plus decode_dc_prg_fs/sa, decode_ac_prg_fs/sa, decode_eobrun_sa
(jpgcoder.cc:4968-5235) and skip_eobrun (jpgcoder.cc:5462-5505).

Coefficients accumulate into raster planes with successive-approximation
shifts applied exactly as the reference does (uint16 shift semantics).

Verbatim copy of lepton_tpu/jpeg/progressive.py: the port keeps its own host
layers.
"""
from __future__ import annotations


from ..constants import ZIGZAG_TO_RASTER
from .huffman import devli
from .imageinfo import ImageInfo

_ZIG2RAST = [int(v) for v in ZIGZAG_TO_RASTER]


class ProgressiveError(Exception):
    pass


def decode_dc_prg_fs(reader, dctree, block) -> int:
    hc = dctree.decode(reader)
    if hc < 0:
        return -1
    n = reader.read(hc)
    block[0] = devli(hc, n)
    return 0


def decode_ac_prg_fs(reader, actree, block, eobrun_box, cs_from, cs_to) -> int:
    eobrun = eobrun_box[0]
    if eobrun > 0:
        for bpos in range(cs_from, cs_to + 1):
            block[bpos] = 0
        eobrun_box[0] = eobrun - 1
        return cs_from
    eob = cs_to + 1
    bpos = cs_from
    while bpos <= cs_to:
        hc = actree.decode(reader)
        if hc < 0:
            return -1
        l = hc >> 4
        r = hc & 15
        if l == 15 or r > 0:
            n = reader.read(r)
            if l + bpos > cs_to:
                return -1
            for _ in range(l):
                block[bpos] = 0
                bpos += 1
            block[bpos] = devli(r, n)
            bpos += 1
        else:
            eob = bpos
            n = reader.read(l)
            eobrun_box[0] = (n + (1 << l)) - 1  # E_DEVLI minus this one
            break
    return eob


def decode_dc_prg_sa(reader, block) -> int:
    block[0] = reader.read(1)
    return 0


def decode_ac_prg_sa(reader, actree, block, eobrun_box, cs_from, cs_to) -> int:
    bpos = cs_from
    eob = cs_to
    if eobrun_box[0] == 0:
        while bpos <= cs_to:
            hc = actree.decode(reader)
            if hc < 0:
                return -1
            l = hc >> 4
            r = hc & 15
            if l == 15 or r > 0:
                z = l
                if r == 0:
                    v = 0
                elif r == 1:
                    v = 1 if reader.read(1) else -1
                else:
                    return -1
                while True:
                    if block[bpos] == 0:
                        if z > 0:
                            z -= 1
                        else:
                            block[bpos] = v
                            bpos += 1
                            break
                    else:
                        n = reader.read(1)
                        block[bpos] = n if block[bpos] > 0 else -n
                    if bpos >= cs_to:
                        return -1
                    bpos += 1
            else:
                eob = bpos
                n = reader.read(l)
                eobrun_box[0] = n + (1 << l)  # E_DEVLI
                break
    if eobrun_box[0] > 0:
        while bpos <= cs_to:
            if block[bpos] != 0:
                n = reader.read(1)
                block[bpos] = n if block[bpos] > 0 else -n
            bpos += 1
        eobrun_box[0] -= 1
    return eob


def decode_eobrun_sa(reader, block, eobrun_box, cs_from, cs_to) -> int:
    for bpos in range(cs_from, cs_to + 1):
        if block[bpos] != 0:
            n = reader.read(1)
            block[bpos] = n if block[bpos] > 0 else -n
    eobrun_box[0] -= 1
    return 0


def skip_eobrun(info: ImageInfo, cmp: int, dpos: int, rstw: int,
                eobrun_box) -> tuple:
    """Port of skip_eobrun (jpgcoder.cc:5462-5505)."""
    eobrun = eobrun_box[0]
    if eobrun <= 0:
        return 0, dpos, rstw
    ci = info.cmpnfo[cmp]
    if info.rsti > 0:
        if eobrun > rstw:
            return -1, dpos, rstw
        rstw -= eobrun
    if ci.bch != ci.nch:
        dpos += (((dpos % ci.bch) + eobrun) // ci.nch) * (ci.bch - ci.nch)
    if ci.bcv != ci.ncv:
        if dpos // ci.bch >= ci.ncv:
            dpos += (ci.bcv - ci.ncv) * ci.bch
    dpos += eobrun
    eobrun_box[0] = 0
    if dpos == ci.bc:
        return 2, dpos, rstw
    if dpos > ci.bc:
        return -1, dpos, rstw
    if info.rsti > 0 and rstw == 0:
        return 1, dpos, rstw
    return 0, dpos, rstw
