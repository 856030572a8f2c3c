"""Build the port's native C++ core (the featurizer's periodic kNN and the
collate) with g++ into one library named by hash.

    g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread \\
        -o build/torch_native/libcgat_native-<hash>.so neighbors.cc collate.cc

The hash covers the sources, the flags and the host CPU's model and feature
flags: ``-march=native`` code runs only on a CPU like the one that built it,
so a checkout copied to another machine builds its own library there rather
than loading one that may hold instructions that CPU lacks. Nothing is built
when this module is imported. ``python -m cgat_tpu_torch.native.build``
builds it ahead of use.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRCS = (HERE / "neighbors.cc", HERE / "collate.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX = "g++"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _cpu_identity() -> bytes:
    """The host CPU's model name and feature flags (Linux), else nothing."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def library_path() -> Path:
    """Where the library for the current sources, flags and CPU lives."""
    h = hashlib.sha256(" ".join((CXX, *FLAGS)).encode())
    for src in SRCS:
        h.update(src.read_bytes())
    h.update(_cpu_identity())
    return BUILD_DIR / f"libcgat_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing and return its path. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [CXX, *FLAGS, "-o", str(tmp), *map(str, SRCS)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native build failed: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build failed ({' '.join(cmd)}, exit "
            f"{res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)    # atomic: concurrent builds see whole files
    return lib


if __name__ == "__main__":
    print(build())
