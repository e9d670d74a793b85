"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface and include no PyTorch
header, so a build takes seconds.  Each ``.cu`` is compiled to an object file
by its own ``nvcc`` process (all started together), then one link makes
``librepro_torch_kernels.so``.  The library goes to ``build/`` at the
repository root, in a directory named by a hash of the sources and flags, so a
library built from other sources is never loaded.

Nothing here runs when the package is imported: ``load_library`` is called by
a kernel launcher at its first launch on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["KernelBuildError", "NVCC_FLAGS", "build_root", "csrc_dir",
           "load_library", "source_files"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
_LIB_NAME = "librepro_torch_kernels.so"

# name -> (restype, argtypes).  Pointers and the stream are c_void_p (a bare
# Python int would be cut to 32 bits), row and column counts are 64-bit.
_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# (in, out, rows, n, radix, inverse, rows_per_cta, threads, stream)
_COMPLEX_ROWS = (_INT, [_PTR, _PTR, _LL, _INT, _INT, _INT, _INT, _INT, _PTR])
# (in, out, rows, n, radix, rows_per_cta, threads, stream): forward only
_REAL_ROWS = (_INT, [_PTR, _PTR, _LL, _INT, _INT, _INT, _INT, _PTR])
_REAL_ROWS_LARGE = (_INT, [_PTR, _PTR, _PTR, _LL, _INT, _INT, _LL, _INT, _INT, _PTR])
_FUNCTIONS = {"repro_fft_rows": _COMPLEX_ROWS,
              "repro_fft_rows_transpose": _COMPLEX_ROWS,
              "repro_rfft_rows": _REAL_ROWS,
              "repro_rfft_rows_transpose": _REAL_ROWS,
              # (in, out, rows, n, inverse, stream): K1b at n <= 65536, one
              # launch over clusters
              "repro_fft_rows_cluster": (_INT, [_PTR, _PTR, _LL, _INT, _INT, _PTR]),
              # (in, out, scratch, rows, n1, n2, inverse, rows_per_cta,
              # threads, stream): K1b above 65536, two launches
              "repro_fft_rows_large": (_INT, [_PTR, _PTR, _PTR, _LL, _INT, _INT, _INT,
                                              _INT, _INT, _PTR]),
              # (in, out, rows, n, inverse, out_stride, stream): K2 at n =
              # 16384 and K2b at 32768 and 65536, one launch over clusters
              "repro_fft_rows_transpose_cluster": (_INT, [_PTR, _PTR, _LL, _INT, _INT,
                                                          _LL, _PTR]),
              # (in, out, rows, n, stream): K3 at n = 16384, one launch of
              # min(pairs, SMs) persistent CTAs
              "repro_rfft_rows_16k": (_INT, [_PTR, _PTR, _LL, _INT, _PTR]),
              # (in, out, rows, n, stream): K4 at n = 16384, one launch over
              # clusters of 16 CTAs
              "repro_rfft_rows_transpose_16k": (_INT, [_PTR, _PTR, _LL, _INT, _PTR]),
              # (in, out, scratch, rows, n1, n2, inverse, out_stride,
              # rows_per_cta, threads, stream): K2b above 65536, two launches
              "repro_fft_rows_transpose_large": (_INT, [_PTR, _PTR, _PTR, _LL, _INT, _INT,
                                                        _INT, _LL, _INT, _INT, _PTR]),
              # (in, out, scratch, rows, n1, n2, out_stride, rows_per_cta,
              # threads, stream): K3b and K4b, two launches
              "repro_rfft_rows_large": _REAL_ROWS_LARGE,
              "repro_rfft_rows_transpose_large": _REAL_ROWS_LARGE,
              # (in, out, r, c, elem_bytes, stream)
              "repro_transpose": (_INT, [_PTR, _PTR, _LL, _LL, _INT, _PTR])}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be compiled, linked or loaded."""


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent / "csrc"


def build_root() -> Path:
    """``build/`` at the repository root (``src/repro_torch/kernels`` -> up 3)."""
    return Path(__file__).resolve().parents[3] / "build"


def source_files() -> list[Path]:
    """Every file the library is made from, in a fixed order."""
    return sorted(p for p in csrc_dir().iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "cannot be built on this machine")


def _compile(out_dir: Path) -> Path:
    """Compile every ``.cu`` in parallel, link, and return the library path."""
    nvcc = _find_nvcc()
    units = [p for p in source_files() if p.suffix == ".cu"]
    procs = []
    for src in units:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for cmd, _, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{output}")
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    lib = out_dir / _LIB_NAME
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
           *(str(obj) for _, obj, _ in procs)]
    done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if done.returncode != 0:
        raise KernelBuildError(f"link failed:\n$ {' '.join(cmd)}\n{done.stdout}")
    return lib


def _build() -> Path:
    """Return the path of the library for the current sources, building it
    first when it is not there.  The build happens in a scratch directory
    that is renamed into place, so a concurrent or interrupted build never
    leaves a half-written library under the final name."""
    final_dir = build_root() / f"repro_torch_kernels-{_source_hash()}"
    lib = final_dir / _LIB_NAME
    if lib.is_file():
        return lib
    build_root().mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-kernels-", dir=build_root()))
    try:
        _compile(tmp)
        try:
            os.replace(tmp, final_dir)
        except OSError:
            if not lib.is_file():  # not merely beaten to it by another process
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def load_library() -> ctypes.CDLL:
    """The bound kernel library; built at the first call, then cached."""
    global _library
    with _lock:
        if _library is None:
            path = _build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                raise KernelBuildError(f"cannot load {path}: {exc}") from exc
            for name, (restype, argtypes) in _FUNCTIONS.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _library = lib
        return _library
