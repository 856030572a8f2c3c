"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``cgat_tpu_torch/csrc/<name>.cu`` is compiled, at first use, into its
own shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/lib<name>-<hash>.so

The library name carries a hash of the source, of every header in
``csrc/`` and of the flags (include paths among them), so an edited source
or header is rebuilt and a stale library is never loaded. ``build()`` starts
one ``nvcc`` per source, all at once, and keeps each compiler log (with
ptxas' register and spill report) beside its library. Nothing is built or
loaded when this module is imported. ``run`` makes each launch on its
tensors' device.

The launch record, for readers of a profile that must tell one kernel's
launches apart by what they ran on (the benchmark tells a hypernetwork's
edge-row launches from its node-row ones by their order in a replayed
step): ``record_launches(True)`` switches it on; a ``recording(list)``
scope then collects (C entry, rows, scope) of each launch, the scope the
innermost open ``launch_scope(name)`` (a ``GATConvEdges`` live update
opens ``"edge_update"``). ``training.dispatch.StepGraphs`` opens one
around each capture while the record is on and keeps it by the graph's
key. Off, ``run`` and ``launch_scope`` each cost one check.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

KERNELS = ("segment_attention", "mh_network", "hyper_apply", "segment_sum",
           "dropout")

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}

# the launch record: while a list is open (``recording``), each launch
# adds (C entry, rows, the innermost launch scope's name or None) to it
_record: list | None = None
_scopes: list[str] = []
_recording_on = False
_NO_SCOPE = contextlib.nullcontext()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every kernel in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together. Returns, per kernel, the
    seconds its build took (0 if it was already built) and its compiler
    log. Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    result = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            result[name] = {"seconds": 0.0,
                            "log": log.read_text() if log.exists() else ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, lib, log)
    failed = []
    for name, (proc, tmp, lib, log) in running.items():
        out, _ = proc.communicate()
        result[name] = {"seconds": time.perf_counter() - t0, "log": out}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        log.write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.cgat_error_string.argtypes = [ctypes.c_int]
        lib.cgat_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel ``name`` with its argument types
    declared (``c_void_p`` for every pointer and the stream)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def stream(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``device``, which
    every launch uses. ``torch.cuda.current_stream(device).cuda_stream``
    gives the same handle but builds a Stream object on the way: ~9 us of
    host time a call on the H100's host, more than a small kernel runs."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


@functools.cache
def sm_count(index: int) -> int:
    """SM count of card ``index``: the kernels that plan their work on the
    host aim at one wave."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def run(fn, device, *args, rows: int | None = None) -> int:
    """Call the C entry ``fn(*args, stream)`` on ``device``'s current
    stream with ``device`` the current CUDA device, as the kernel's launch
    and its per-device settings need, and return its code. The device is
    switched only when it is not the current one, and switched back after;
    on one card this costs one ``current_device`` call and nothing else.
    A device without an index (no card named) is left as it is. ``rows``:
    the rows the launch runs on, for the launch record (:func:`recording`;
    while none is open, one check)."""
    if _record is not None:
        _record.append((fn.__name__, rows, _scopes[-1] if _scopes else None))
    index = device.index
    current = None if index is None else torch.cuda.current_device()
    if current == index:
        return fn(*args, stream(device))
    torch.cuda.set_device(index)
    try:
        return fn(*args, stream(device))
    finally:
        torch.cuda.set_device(current)


def check(name: str, code: int) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = load(name).cgat_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


def record_launches(on: bool = True) -> None:
    """Switch the launch record on or off: while it is on, a
    ``StepGraphs`` keeps the launches of each capture."""
    global _recording_on
    _recording_on = bool(on)


def recording_launches() -> bool:
    """Whether the launch record is switched on."""
    return _recording_on


@contextlib.contextmanager
def recording(out: list):
    """Append each launch of the scope to ``out`` as (C entry, rows,
    launch scope or None)."""
    global _record
    outer, _record = _record, out
    try:
        yield out
    finally:
        _record = outer


def launch_scope(name: str):
    """A scope whose launches the open record marks with ``name``; a
    shared empty context where none is open (one check)."""
    return _NO_SCOPE if _record is None else _scope(name)


@contextlib.contextmanager
def _scope(name: str):
    _scopes.append(name)
    try:
        yield
    finally:
        _scopes.pop()
