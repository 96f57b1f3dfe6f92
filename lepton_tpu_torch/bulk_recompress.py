"""Bulk lossless JPEG recompression: the twin of examples/bulk_recompress.py.

Walks a directory and recompresses every JPEG (*.jpg, *.jpeg) to a .lep
beside it, each verified before it is kept, then prints the aggregate
ratio and throughput.  By default on the card: api.compress_device, each
.lep decoded back by the host codec (host.decompress_all) and compared
with its JPEG.  --host takes the JAX example's default route,
host.compress_any(verify=True, permissive=False, allow_progressive=True),
the host codec alone.  --decode also takes every .lep back to a JPEG
(x.lep to x.jpg; decompress_device, or host.decompress_all with --host),
as the example does.

A file whose own bytes the codec refuses (host.REQUEST_ERRORS, or a
failed verification) is skipped with a SKIP line; the JAX example skips
on any Exception.  Any other error on the card's route is a fault of the
card and ends the run: no fallback hides the device.

Run: python -m lepton_tpu_torch.bulk_recompress DIR [--decode] [--host]
[--device cuda|cpu]
"""
import argparse
import os
import sys
import time

from . import host


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def run(root: str, decode: bool = False, use_host: bool = False,
        device=None, log=print) -> dict:
    """Recompress (and with `decode`, decode) every file under `root`;
    returns the counts and sizes of the summary line."""
    if not use_host:
        from . import api
    total_in = total_out = 0
    n = failures = 0
    t0 = time.perf_counter()
    for dirpath, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            if decode and fn.lower().endswith(".lep"):
                data = _read(path)
                out = host.decompress_all(data) if use_host else \
                    api.decompress_device(data, device=device)
                _write(path[:-4] + ".jpg", out)
                n += 1
                continue
            if not fn.lower().endswith((".jpg", ".jpeg")):
                continue
            data = _read(path)
            try:
                if use_host:
                    lep = host.compress_any(data, verify=True,
                                            permissive=False,
                                            allow_progressive=True)
                else:
                    lep = api.compress_device(data, device=device)
                    if host.decompress_all(lep) != data:
                        raise host.LeptonError("verification failed")
            except host.REQUEST_ERRORS as e:
                log(f"SKIP {path}: {type(e).__name__}: {e}")
                failures += 1
                continue
            _write(path + ".lep", lep)
            total_in += len(data)
            total_out += len(lep)
            n += 1
    return dict(files=n, bytes_in=total_in, bytes_out=total_out,
                skipped=failures, seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--host", action="store_true",
                    help="the host codec alone (the JAX example's route)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu, the plain versions")
    args = ap.parse_args(argv)
    r = run(args.root, args.decode, args.host, args.device)
    if r["bytes_in"]:
        mb_in, mb_out = r["bytes_in"] / 1e6, r["bytes_out"] / 1e6
        print(f"{r['files']} files, {mb_in:.1f} MB -> {mb_out:.1f} MB "
              f"({100 * r['bytes_out'] / r['bytes_in']:.1f}%), "
              f"{mb_in / r['seconds']:.2f} MB/s, {r['skipped']} skipped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
