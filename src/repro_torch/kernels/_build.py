"""Build and load the CUDA kernels; count their launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Builds happen at first use —
importing the package never needs a compiler — into
``build/repro_torch/<hash>/`` under the repository root, keyed by a hash of
every source in ``csrc/`` and of the compiler flags; delete ``build/`` to
force a rebuild.  ``build_all`` starts one ``nvcc`` per source at once.

``COUNTS`` holds one plain integer per kernel.  A wrapper adds one exactly
where it launches its kernel, so a run can show that it went through the
kernel; ``host_reads`` counts the device-to-host reads of the sort loop.

``RECORDER`` is the launch recorder of ``repro_torch.analysis.trace`` while
one is recording, else None: every wrapper tests it once, where it has
picked its kernel or its plain version, and reports the launch to it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

COUNTS = {"histogram": 0, "fused_pass": 0, "local_sort": 0, "merge_rows": 0,
          "merge": 0, "bitonic_rows": 0, "bitonic_rows_kv": 0,
          "multisplit": 0, "multisplit_kv": 0, "assigned_hist": 0,
          "host_reads": 0}

#: kernel library name -> source file under csrc/ (the library-surface
#: counters are one per wrapper: ``*_kv`` count the same libraries' value
#: launches, ``assigned_hist`` the histogram library's second entry point)
SOURCES = {"histogram": "histogram.cu", "fused_pass": "fused_pass.cu",
           "local_sort": "local_sort.cu", "merge_rows": "merge_rows.cu",
           "merge": "merge.cu", "bitonic_rows": "bitonic_rows.cu",
           "multisplit": "multisplit.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: the active ``analysis.trace.Recorder``, or None (the default: no cost
#: beyond one ``is None`` test per launch)
RECORDER = None

_CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[3]
_LIBS: dict = {}
_FUNCS: dict = {}
#: cudaErrorInvalidValue: what a launcher returns for arguments it refuses
_INVALID_VALUE = 1


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return _ROOT / "build" / "repro_torch" / _source_hash()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_all(names=None) -> dict:
    """Build the named kernels' libraries (all by default) that are not yet
    built, one ``nvcc`` process per source, all started together.

    Returns ``{name: ptxas report}`` for what was built; raises with the
    compiler's output if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not (out_dir / f"{n}.so").exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out_dir / f"{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out_dir / f"{name}.so")
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_dir() / f"{name}.so"
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """A C entry point of kernel ``name`` with its ctypes signature set
    (launchers return a CUDA error code; sizing queries a byte count)."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _FUNCS[key] = fn
    return fn


def check(name: str, rc: int, refused: str | None = None) -> None:
    """Raise if a launch returned a CUDA error code; ``refused`` says what
    the launcher refuses with cudaErrorInvalidValue."""
    if rc != 0:
        msg = library(name).repro_error_string(rc).decode()
        why = f": {refused}" if refused and rc == _INVALID_VALUE else ""
        raise RuntimeError(f"CUDA kernel {name!r} failed: error {rc} "
                           f"({msg}){why}")


def stream_handle(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); False for CUDA (kernel)."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")
