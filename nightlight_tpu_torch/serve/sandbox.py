"""Serving sandbox: chroot + setuid privilege drop, mirror of
nightlight_tpu/serve/sandbox.py (reference: internal/rest/sandbox_unix.go:
32-47). When serving HTTP as root, chroot into the working directory and
drop to an unprivileged uid.

The kernels must be built and loaded before the sandbox is applied
(serve.rest.warm_device): after a chroot the build directory and nvcc are
out of reach.
"""

from __future__ import annotations

import os
import sys


def make_sandbox(chroot_dir: str, setuid: int, log=None) -> None:
    """Apply the requested sandbox or die: when chroot/setuid were explicitly
    requested and cannot be applied, running unsandboxed (possibly as root)
    would silently void the operator's security intent, so this fails hard
    like the reference's panic (sandbox_unix.go:36-45)."""
    log = log or sys.stdout
    if chroot_dir:
        try:
            os.chroot(chroot_dir)
            os.chdir("/")
            print(f"chrooted into {chroot_dir}", file=log)
        except (OSError, AttributeError) as e:
            raise SystemExit(f"Fatal: unable to chroot to {chroot_dir}: {e}")
    if setuid >= 0:
        try:
            os.setuid(setuid)
            print(f"setuid to {setuid}", file=log)
        except (OSError, AttributeError) as e:
            raise SystemExit(f"Fatal: unable to setuid to {setuid}: {e}")
