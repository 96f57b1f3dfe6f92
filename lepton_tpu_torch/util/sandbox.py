"""Process hardening: memory envelope + privilege limits.

Copy of lepton_tpu/util/sandbox.py (99 lines) over the port's own native
library; the filters are leptonc.c:2912-3049 of the port's copy.

The reference runs under a strict seccomp jail with a preallocated arena so
workers can only read/write/exit (Seccomp.cc:67-138, MemMgrAllocator).  A
Python runtime cannot survive *strict-mode* seccomp (the interpreter
allocates continuously), so this build ships a seccomp-BPF filter instead
-- default-on, installed by the CLI after fds are open and the codec is
pre-warmed (cli._prepare_for_jail):

  - install_jail() -> lepton_install_jail (leptonc.c): a BPF allowlist of
    read/write/memory/thread/time syscalls; anything else (openat, exec,
    connect, ...) kills the process with SIGSYS
    (SECCOMP_RET_KILL_PROCESS).  Fault injection -injectsyscall=1..4
    proves the kill (tests/test_torch_cli.py).
  - a hard address-space ceiling (the -memory= contract,
    jpgcoder.cc:829-894): the process is killed by the kernel rather than
    exceeding its declared footprint
  - PR_SET_NO_NEW_PRIVS: no privilege escalation past this point
  - the serving layer forks per connection, so a misbehaving request only
    takes down its own worker (socket_serve.cc fork isolation)
"""
from __future__ import annotations

import ctypes
import resource

PR_SET_NO_NEW_PRIVS = 38


def apply_memory_limit(max_bytes: int) -> None:
    """Hard RLIMIT_AS ceiling (the -memory= / -threadmemory= contract)."""
    soft, hard = resource.getrlimit(resource.RLIMIT_AS)
    limit = max_bytes
    if hard != resource.RLIM_INFINITY:
        limit = min(limit, hard)
    resource.setrlimit(resource.RLIMIT_AS, (limit, hard))


def no_new_privs() -> bool:
    """prctl(PR_SET_NO_NEW_PRIVS, 1): irreversible privilege ceiling."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        return libc.prctl(PR_SET_NO_NEW_PRIVS, 1, 0, 0, 0) == 0
    except Exception:
        return False


def install_jail() -> bool:
    """seccomp-BPF allow-list jail (leptonc.c lepton_install_jail; the
    reference's Seccomp.cc:67-138 equivalent).  Irreversible: after this the
    process can compute and pump already-open fds but cannot open files,
    exec, fork processes, or touch the network.  Banned syscalls KILL the
    process (SIGSYS), matching the reference's strict-mode contract."""
    import os
    try:
        from .._native import get_lib
        lib = get_lib()
        if os.environ.get("LEPTON_JAIL_MODE") == "trap":
            return lib.lepton_install_jail_trap() == 0
        return lib.lepton_install_jail() == 0
    except Exception:
        return False


def inject_syscall() -> int:
    """Issue a jail-banned syscall (fault injection, -injectsyscall=)."""
    from .._native import get_lib
    return int(get_lib().lepton_inject_syscall())


def inject_syscall_mmap() -> int:
    """Issue a direct anonymous mmap (-injectsyscall=5): banned by the
    stage-2 memory filter."""
    from .._native import get_lib
    return int(get_lib().lepton_inject_syscall_mmap())


def prejail_heap(max_bytes: int) -> bool:
    """Pre-grow and pin the allocator heap so a stage-2-jailed transcode
    never asks the kernel for memory (the reference preallocates its
    arena for the same reason, MemMgrAllocator.cc:159)."""
    try:
        from .._native import get_lib
        lib = get_lib()
        return lib.lepton_prejail_heap(ctypes.c_int64(max_bytes)) == 0
    except Exception:
        return False


def install_jail_stage2() -> bool:
    """Second-stage seccomp filter dropping brk/mmap/mremap (KILL).
    Only meaningful after prejail_heap and with PYTHONMALLOC=malloc (the
    launcher re-execs to set it); composes with the stage-1 allowlist.
    Banned-memory-syscall fault injection: -injectsyscall=5."""
    try:
        from .._native import get_lib
        return get_lib().lepton_install_jail_stage2() == 0
    except Exception:
        return False
