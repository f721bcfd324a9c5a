"""The port's hand-written CUDA kernels: build, load, launch bookkeeping.

Each source in ``repro_torch/csrc/*.cu`` is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into its own shared library with a plain C interface under
``build/repro_torch/`` at the root of the checkout (git-ignored), named by a
hash of its sources so an edited kernel is rebuilt, and loaded with ctypes.
`build` starts one nvcc per source, all at once.

Dispatch is by device, with no backend knob: every ``ops`` function sends a
CPU tensor to its plain PyTorch version (``ref.py``) and a CUDA tensor to
its kernel (``kernel.py``), whose wrapper validates the inputs, launches on
the current stream and raises if the launch fails; there is no fallback from
a CUDA tensor to the plain version.

`LAUNCHES` counts, per kernel, the kernel executions on the card -- one per
call that reached the kernel, nothing else -- so a run can show that its
path went through the kernels (reset it with `reset_launches`).  Wrappers
count through `count_launch`, which holds a lock around the increment, so
the counts stay exact while a serving thread and the training loop launch
at once.  A launch made while a CUDA graph is captured executes nothing:
inside `record_launches` the calling thread's counts, and those made on the
capture stream it names (the autograd engine's device thread runs a
backward there), go to the graph's own record instead, and each replay of
the graph adds the record to `LAUNCHES` (`add_launches`).  Other threads
go on counting into `LAUNCHES` meanwhile.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("hash_encode", "fused_mlp", "composite", "fused_step", "bum_scatter",
           "bum_sort", "fused_encode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: dict[str, int] = {
    "hash_encode": 0, "fused_mlp2": 0, "fused_mlp3": 0, "composite": 0, "composite_bwd": 0,
    "fused_step_fwd": 0, "fused_step_bwd": 0, "bum_scatter": 0, "bum_sort": 0,
    "fused_encode": 0,
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()          # loading the libraries
_launch_lock = threading.Lock()   # the launch counts


_tls = threading.local()                # the record this thread counts into
_stream_records: dict[int, dict] = {}   # capture stream handle -> its record


def count_launch(name: str) -> None:
    """Add one to `name`'s launch count (a read-modify-write under a lock):
    in `LAUNCHES`, or in the record of a capture underway in this thread
    or on the current stream (`record_launches`)."""
    record = getattr(_tls, "record", None)
    if record is None and _stream_records:
        record = _stream_records.get(torch.cuda.current_stream().cuda_stream)
    with _launch_lock:
        if record is None:
            LAUNCHES[name] += 1
        else:
            record[name] = record.get(name, 0) + 1


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextlib.contextmanager
def record_launches(stream: torch.cuda.Stream | None = None):
    """Count this thread's launches, and any thread's launches on `stream`,
    into a fresh record (yielded: {kernel: launches}) in place of
    `LAUNCHES`, until the block ends: a CUDA graph's capture, whose
    launches execute only when the graph is replayed."""
    record: dict[str, int] = {}
    outer = getattr(_tls, "record", None)
    key = None if stream is None else stream.cuda_stream
    _tls.record = record
    if key is not None:
        _stream_records[key] = record
    try:
        yield record
    finally:
        _tls.record = outer
        if key is not None:
            del _stream_records[key]


def add_launches(record: dict) -> None:
    """Add a record's counts to `LAUNCHES`: one replay of its graph."""
    with _launch_lock:
        for name, n in record.items():
            LAUNCHES[name] += n


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
            "port's kernels build only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of `names` that is not built yet, one nvcc per
    source, all started together.  Returns {name: compiler log} for the ones
    compiled (the log holds ptxas's register and shared-memory report);
    raises with the log of every source that failed."""
    todo = [(n, library_path(n)) for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    try:
        for name, out in todo:
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = {}, []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}.cu: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)   # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return logs
    finally:
        for _name, _out, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `fn_name` of library `lib_name` (built on first
    use), with its argument types declared and an int status result."""
    with _lock:
        so = _libs.get(lib_name)
        if so is None:
            build((lib_name,))
            so = ctypes.CDLL(str(library_path(lib_name)))
            so.repro_error_string.argtypes = [ctypes.c_int]
            so.repro_error_string.restype = ctypes.c_char_p
            _libs[lib_name] = so
    fn = getattr(so, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_status(lib_name: str, status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its cudaGetLastError
    after the launch): a refused launch never runs, and no later
    synchronize would report it."""
    if status != 0:
        msg = _libs[lib_name].repro_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def require_cuda(what: str, device: torch.device, dtype: torch.dtype, **tensors) -> None:
    """The kernels take contiguous tensors of one dtype on one CUDA device."""
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def require_cuda_f32(what: str, device: torch.device, **tensors) -> None:
    """The kernels take f32, contiguous tensors on one CUDA device."""
    require_cuda(what, device, torch.float32, **tensors)


# The table element types the gathers of #1, #5, #6 and #8 take
# (`FieldConfig.grid_dtype`), by the code their C entry points take
# (`TableType` in csrc/common.cuh).
TABLE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def table_type(what: str, device: torch.device, **tables) -> int:
    """The C code of the tables' one element type: contiguous tensors on one
    CUDA device, all f32, all bf16 or all f16; raises on anything else."""
    dtypes = {t.dtype for t in tables.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in TABLE_TYPES:
        raise ValueError(f"{what}: tables are {sorted(map(str, dtypes))}, expected one of "
                         f"{sorted(map(str, TABLE_TYPES))}")
    dtype = dtypes.pop()
    require_cuda(what, device, dtype, **tables)
    return TABLE_TYPES[dtype]


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# the reference's package-level kernel modules (importing them builds nothing)
from . import hash_encode, grid_update, fused_mlp, volume_render, fused_path  # noqa: F401,E402
