"""Controller for the native filesystem failure injector.

Port of `ozone_tpu/testing/fault_injection.py`. The reference ships a
standalone C++ gRPC service that interposes a filesystem and corrupts,
fails or delays operations under a datanode
(tools/fault-injection-service). The port's equivalent is an LD_PRELOAD
interposer (`csrc/failure_injector.cpp`) plus this controller: rules are
written to a file the shim reads again when its mtime changes, so faults
are planted, retargeted and cleared on a live process with no native RPC
stack. Inject into any subprocess by merging `env()` into its
environment. The rules file's format is the reference's, so either
package's controller drives either package's shim.

The shim is built by `cuda_build.build("failure_injector")` with g++ into
the port's `_build/`; without g++, `build_injector()` returns None and
callers (the tests) skip. This module imports no torch.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)


def build_injector() -> Optional[Path]:
    """Compile (once) and return the interposer's .so; None when no
    toolchain can build it."""
    from ozone_tpu_torch import cuda_build

    try:
        return cuda_build.build("failure_injector")
    except (OSError, RuntimeError) as e:
        log.warning("building the failure injector failed: %s", e)
        return None


class FaultInjector:
    """Plant filesystem faults for child processes.

    >>> fi = FaultInjector(tmp_path)
    >>> fi.fail("write", dn_root / "chunks", "EIO")
    >>> subprocess.run([...], env={**os.environ, **fi.env()})
    """

    def __init__(self, workdir: Path):
        self.rules_path = Path(workdir) / "fi_rules.txt"
        self.rules_path.write_text("")
        self._rules: list[str] = []
        self._last_mtime = int(self.rules_path.stat().st_mtime)

    # ------------------------------------------------------------- rules
    def _flush(self) -> None:
        self.rules_path.write_text("".join(self._rules))
        # the shim compares whole-second mtimes: every flush lands on a
        # strictly newer time_t, or a same-second update would be missed
        st = self.rules_path.stat()
        self._last_mtime = max(int(st.st_mtime), self._last_mtime + 1)
        os.utime(self.rules_path, (st.st_atime, self._last_mtime))

    def fail(self, op: str, path_prefix, err: str = "EIO") -> None:
        self._rules.append(f"{op} {path_prefix} fail {err}\n")
        self._flush()

    def delay(self, op: str, path_prefix, millis: int) -> None:
        self._rules.append(f"{op} {path_prefix} delay {millis}\n")
        self._flush()

    def corrupt_writes(self, path_prefix) -> None:
        """Flip one bit of the first byte of every matched write (the
        scanner's and the checksums' test hook)."""
        self._rules.append(f"write {path_prefix} corrupt\n")
        self._flush()

    def clear(self) -> None:
        self._rules = []
        self._flush()

    # ------------------------------------------------------------- env
    def env(self) -> dict[str, str]:
        so = build_injector()
        if so is None:
            raise RuntimeError("native toolchain unavailable")
        return {
            "LD_PRELOAD": str(so),
            "OZONE_FI_CONFIG": str(self.rules_path),
        }
