"""Sanitizer builds of the port's host coder (`tests/test_native_sanitizers.py`
on the port's sources): `csrc/gf_coder_selftest.cpp` drives every entry
point of `csrc/gf_coder.cpp` and `csrc/host_crc32c.cpp`, the
multithreaded batch path included, under AddressSanitizer+UBSan and
ThreadSanitizer. A sanitizer finding aborts the binary and fails the
test; only a missing sanitizer runtime skips."""

import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "ozone_tpu_torch" / "csrc"
SRC = [str(CSRC / "gf_coder.cpp"), str(CSRC / "host_crc32c.cpp"),
       str(CSRC / "gf_coder_selftest.cpp")]


def _build_and_run(tmp_path, label, san_flags):
    exe = tmp_path / f"selftest-{label}"

    def compile_with(flags, out):
        return subprocess.run(
            ["g++", "-O1", "-g", "-march=native", "-msse4.2",
             "-fno-omit-frame-pointer", *flags, "-o", str(out), *SRC,
             "-lpthread"],
            capture_output=True, text=True, timeout=180)

    build = compile_with(san_flags, exe)
    if build.returncode != 0:
        # a plain build failing means the sources are broken: that fails
        plain = compile_with([], tmp_path / f"selftest-{label}-plain")
        assert plain.returncode == 0, (
            f"the port's native sources fail to compile:\n{plain.stderr[-1000:]}")
        pytest.skip(f"{label} runtime unavailable: {build.stderr[-300:]}")
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=180)
    assert run.returncode == 0, (
        f"{label} selftest failed (rc={run.returncode}):\n"
        f"{run.stdout}\n{run.stderr}")
    assert "selftest ok" in run.stdout


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")
def test_native_coder_under_asan_ubsan(tmp_path):
    _build_and_run(tmp_path, "asan", ["-fsanitize=address,undefined",
                                      "-fno-sanitize-recover=all"])


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")
def test_native_coder_under_tsan(tmp_path):
    """The multithreaded batch coder's one-shot thread pool is free of
    data races over disjoint stripe ranges."""
    _build_and_run(tmp_path, "tsan", ["-fsanitize=thread"])
