"""python -m lepton_tpu_torch: the port's command line (cli.main).

The stage-2 seccomp filter bans mmap/brk outright; CPython's default
pymalloc allocates arenas via direct mmap, so jailed runs must route every
allocation through the (pre-grown, pinned) glibc heap.  PYTHONMALLOC only
takes effect at interpreter start, so a jailed run (the host codec,
-device=host, without -unjailed) re-execs once with PYTHONMALLOC=malloc, as
the JAX package's `lepton` launcher does (lepton:6-15).  The device path
runs unjailed and needs no re-exec.  An explicitly set PYTHONMALLOC (e.g.
=debug) is respected: stage 2 then skips itself
(cli._install_jail_and_inject).
"""
import os
import sys

if __name__ == "__main__":
    devices = [a for a in sys.argv[1:] if a.startswith("-device=")]
    if ("PYTHONMALLOC" not in os.environ and devices[-1:] == ["-device=host"]
            and "-unjailed" not in sys.argv):
        os.environ["PYTHONMALLOC"] = "malloc"
        os.execv(sys.executable,
                 [sys.executable, "-m", "lepton_tpu_torch"] + sys.argv[1:])
    from lepton_tpu_torch.cli import main
    sys.exit(main())
