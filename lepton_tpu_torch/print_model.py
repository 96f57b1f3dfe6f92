"""Human-readable adaptive-model dump: the twin of tools/print_model.py.

Reads a raw model file (LEPTON_COMPRESSION_MODEL_OUT's format: the flat
branch arena, ARENA_SIZE x (false count, true count, prob), byte-compatible
with the reference's struct Model) and prints the interesting branches,
one a line:

    TABLE::dim[v]dim[v]... = (true_count, false_count-1)

Printability mirrors Model::debug_print (reference model.cc:230-380): by
default the branches that are CLOSE_TO_50 or (with a second model)
CLOSE_TO_ONE_ANOTHER within -t, having at least -s observations; -ok
inverts the test and prints the confidently skewed branches.  The layout
comes from the port's own model/tables.py.

Its output equals the JAX tool's line for line but one: on a two-model
line the JAX tool closes the second pair with '}' (tools/print_model.py
:106), this one with ')'.

Run: python -m lepton_tpu_torch.print_model [-t<tol>] [-s<min>] [-ok]
MODEL [OTHER_MODEL]
"""
import signal
import sys

import numpy as np

from .model.tables import ARENA_SIZE, TABLE_OFFSETS, TABLE_SHAPES

# (arena key, display name, dimension labels) in debug_print order
DISPLAY = [
    ("nz_7x7", "NONZERO 7x7", ["cmp", "nbr", "bit", "prevbits"]),
    ("nz_1x8", "NONZERO_1x8", ["cmp", "eobx", "num_nonzeros", "bit",
                               "prevbits"]),
    ("nz_8x1", "NONZERO_8x1", ["cmp", "eobx", "num_nonzeros", "bit",
                               "prevbits"]),
    ("exp_dc", "EXP_DC", ["len_abs_mxm", "len_abs_off", "bit"]),
    ("exp_7x7", "EXP7x7", ["cmp", "num_nonzeros", "coef", "neigh_exp",
                           "bit"]),
    ("exp_x", "EXP_8x1", ["cmp", "num_nonzeros", "coef", "neigh_exp",
                          "bit"]),
    ("residual_noise", "NOISE", ["cmp", "coef", "num_nonzeros", "bit"]),
    ("residual_noise_dc", "NOISE_DC", ["len_abs_mxm", "bit"]),
    ("residual_thresh", "THRESH8", ["cmp", "max", "exp", "prevbits"]),
    ("sign", "SIGN", ["cmp", "lakh", "exp"]),
]


def load(path):
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size != ARENA_SIZE * 3:
        sys.exit(f"{path}: expected {ARENA_SIZE * 3} bytes, "
                 f"got {raw.size}")
    return raw.reshape(ARENA_SIZE, 3)


def lines(arena, other=None, tol: float = 0.25, min_samples: int = 25,
          mode: str = "close"):
    """The printable branches of `arena` (and `other`), one line each."""
    shapes = dict(TABLE_SHAPES)
    for key, name, labels in DISPLAY:
        shape = shapes[key]
        off = TABLE_OFFSETS[key]
        n = int(np.prod(shape))
        fc = arena[off:off + n, 0].astype(np.int64)
        tc = arena[off:off + n, 1].astype(np.int64)
        total = tc + fc
        ratio = (tc + 1) / (total + 2)
        if other is not None:
            ofc = other[off:off + n, 0].astype(np.int64)
            otc = other[off:off + n, 1].astype(np.int64)
            close = np.abs(ratio - (otc + 1) / (otc + ofc + 2)) < tol
        else:
            # (model.cc:246's >300 filter is dead code with uint8 counts;
            # the live gate is the nontrivial + min_samples pair below)
            close = np.abs(ratio - 0.5) < tol
        nontrivial = (tc > 0) | (fc > 1)
        significant = total >= min_samples
        printable = nontrivial & significant & \
            (close if mode == "close" else ~close)
        for flat in np.nonzero(printable)[0]:
            idx = np.unravel_index(flat, shape)
            dims = "".join(f"{lb}[{v}]" for lb, v in
                           zip(labels, idx[:len(labels)]))
            extra = "".join(f"[{v}]" for v in idx[len(labels):])
            line = f"{name}::{dims}{extra} = ({tc[flat]}, {fc[flat] - 1})"
            if other is not None:
                line += f" = ({otc[flat]}, {ofc[flat] - 1})"
            yield line


def main(argv=None) -> int:
    tol = 0.25
    min_samples = 25
    mode = "close"
    paths = []
    for a in sys.argv[1:] if argv is None else argv:
        if a.startswith("-t"):
            tol = float(a[2:])
        elif a == "-ok":
            mode = "ok"
        elif a.startswith("-s"):
            min_samples = int(float(a[2:]))
        else:
            paths.append(a)
    if not 1 <= len(paths) <= 2:
        sys.exit(__doc__)
    arena = load(paths[0])
    other = load(paths[1]) if len(paths) == 2 else None
    for line in lines(arena, other, tol, min_samples, mode):
        print(line)
    return 0


if __name__ == "__main__":
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)  # head-friendly
    sys.exit(main())
