"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources are ``hla_la_tpu_torch/csrc/*.cu`` (and the headers beside
them), each with a plain C entry point that launches on the caller's stream
and returns ``cudaGetLastError()``.  They are compiled for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library under ``build/hla_la_tpu_torch/`` at the
repository root (a per-user cache when the package is installed, see
``build_dir``), on first use, keyed on a hash of the sources, headers and
flags, so an edit rebuilds and an unchanged tree reuses the library.  There
is no fallback: a missing ``nvcc`` or a failed build raises with the
compiler's output.

No ``--use_fast_math``: K1 and K2 are held bit for bit to IEEE float32
arithmetic, and K3 names its two approximate instructions itself and relies
on its compensated sums not being reassociated.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
# -Xptxas -v: the build log lists each kernel's registers, shared memory
# and spills
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_i64 = ctypes.c_longlong
# argtypes of every C entry point; they return int unless _RESTYPES says so
_RESTYPES = {"hla_pair_ll_scratch_floats": _i64}
# inputs, B, L, W, the four scores, outputs, the launch plan's six ints
# (ops/cuda_nw.py::NWPlan), the stream
_NW_FORWARD = [_vp, _vp, _vp, _int, _int, _int,
               _float, _float, _float, _float,
               _vp, _vp, _vp, _vp,
               _int, _int, _int, _int, _int, _int, _vp]
_ENTRY_POINTS = {
    "hla_banded_nw_forward": _NW_FORWARD,
    "hla_banded_nw_long_forward": _NW_FORWARD,
    "hla_pair_ll_diff": [_vp, _int, _int, _vp, _vp, _i64, _vp],
    "hla_pair_ll_scratch_floats": [_int, _int],
    "hla_pair_ll_read_chunk": [],
}


class KernelLibrary:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_s: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_s = build_s      # 0.0 when an existing build was reused
        self.log = log

    def check(self, name: str, rc: int) -> None:
        """Raise if a C entry point returned a CUDA error code."""
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return nvcc


def _sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def _digest(csrc: Path = CSRC) -> str:
    """Hash of the flags, the sources and the headers they may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = [p for pat in ("*.cuh", "*.h") for p in csrc.glob(pat)]
    for src in _sources(csrc) + sorted(headers):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir(pkg_dir: Path = PKG_DIR) -> Path:
    """``build/hla_la_tpu_torch/`` at the root of a source checkout (the
    directory with ``pyproject.toml`` beside the package).  An installed
    package builds into a per-user cache instead,
    ``$XDG_CACHE_HOME/hla_la_tpu_torch`` (default ``~/.cache``): its
    site-packages may be read-only and is shared by every environment."""
    root = pkg_dir.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "hla_la_tpu_torch"
    cache = (os.environ.get("XDG_CACHE_HOME")
             or os.path.join(os.path.expanduser("~"), ".cache"))
    return Path(cache) / "hla_la_tpu_torch"


def _run_all(cmds: list[list[str]]) -> str:
    """Run `cmds` all at once and wait for every one; their joined output,
    or raise with the output of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{text}")
    return "".join(outs)


def build() -> KernelLibrary:
    """Compile (if needed) and load the kernel library."""
    out_dir = build_dir()
    out = out_dir / f"libhla_la_tpu_torch_{_digest()}.so"
    log = ""
    build_s = 0.0
    if not out.exists():
        nvcc = find_nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = f"{out.with_suffix('')}.{os.getpid()}"
        objs = [f"{stem}.{src.stem}.o" for src in _sources()]
        t0 = time.perf_counter()
        try:
            log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                            for obj, src in zip(objs, _sources())])
            log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o",
                              f"{stem}.tmp", *objs]])
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        build_s = time.perf_counter() - t0
        os.replace(f"{stem}.tmp", out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return KernelLibrary(lib, out, build_s, log)


_LIBRARY: KernelLibrary | None = None


def library() -> KernelLibrary:
    """The process's kernel library, built on first use."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build()
    return _LIBRARY
