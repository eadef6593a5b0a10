"""Build and load the port's CUDA kernels.

The sources under ``kernels/csrc`` are compiled with ``nvcc`` for
``sm_90a`` at first use, one ``nvcc`` per source started together, then
linked into ``build/repro_torch_kernels/libkernels.so`` at the repository
root (a git-ignored directory).  The library has a plain C interface and
is loaded with ``ctypes``; nothing here includes PyTorch's headers, so a
full build takes seconds.  The sources share three headers beside them:
``common.cuh`` (the C interface), ``mma.cuh`` (``mma.sync``, ``cp.async``
and the 3xTF32 split) and ``wgmma.cuh`` (mbarriers, TMA and ``wgmma``,
for ``gram.cu``, ``eigproject.cu`` and the scan in
``recurrent_scan.cu``).  A stamp holding the hash of every
file under ``csrc`` and the flags lets a second process reuse a finished
build.

Importing this module builds nothing: ``library()`` does, once per
process, and raises if ``nvcc`` is missing or a source does not compile.
``add_build_listener`` registers a callable run after every finished
build (never on a stamp hit); telemetry counts builds through it
(``retrace_count``, ``repro_torch.obs.metrics``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library", "build", "check",
           "ensure_built", "add_build_listener"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libkernels.so"

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64
#: C entry point -> argtypes (every entry returns its cudaError_t).
_SIGNATURES = {
    "repro_gram": (_P, _P, _P, _I, _I, _I, _P),
    "repro_gram_plan": (_I, _P, _P),
    "repro_project_norms": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_project_norms_grouped": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_eigproject_split": (_P, _P, _I, _I, _I, _P),
    "repro_eigproject_plan": (_I, _P, _P),
    "repro_linkage_step": (_P, _P, _F, _F, _P, _P, _P, _P, _I, _I, _P),
    "repro_nn_chain": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    "repro_nn_chain_plan": (_I, _P, _P),
    "repro_featurize_gram": (_P, _L, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                             _I, _P),
    "repro_featurize_gram_smem": (_I, _I, _I, _I),
    "repro_gram_project": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_gram_project_smem": (_I, _I, _I),
    "repro_assign_wave": (_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _P),
    "repro_assign_wave_tc": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _P),
    "repro_assign_one": (_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P),
    "repro_assign_one_smem": (_I, _I, _I, _I),
    "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                              _P),
    "repro_flash_attention_tc": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                 _I, _I, _P),
    "repro_wkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                  _P),
    "repro_linear_scan": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "repro_linear_scan_plan": (_I, _I, _I, _I, _P, _P, _P),
    "repro_error_string": (_I,),
}
_RESTYPES = {"repro_nn_chain_plan": ctypes.c_int64,
             "repro_gram_plan": ctypes.c_int64,
             "repro_linear_scan_plan": ctypes.c_int64,
             "repro_eigproject_plan": ctypes.c_int64,
             "repro_featurize_gram_smem": ctypes.c_int64,
             "repro_gram_project_smem": ctypes.c_int64,
             "repro_assign_one_smem": ctypes.c_int64,
             "repro_error_string": ctypes.c_char_p}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels are built from source at first use")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


#: Callables run with the library's path after every finished build.
_BUILD_LISTENERS: list[Callable[[Path], None]] = []


def add_build_listener(fn: Callable[[Path], None]) -> None:
    """Run ``fn(path)`` after every finished build (idempotent)."""
    if fn not in _BUILD_LISTENERS:
        _BUILD_LISTENERS.append(fn)


def build(out_dir: Path = BUILD_DIR) -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link the library.

    Returns the library's path; raises ``RuntimeError`` with the
    compiler's output when a step fails.  The compiler's ``-Xptxas -v``
    report (registers, shared memory, spills) goes to ``build.log``.
    Every registered build listener runs after a finished build.
    """
    path = _compile(out_dir)
    for fn in tuple(_BUILD_LISTENERS):
        fn(path)
    return path


def _compile(out_dir: Path) -> Path:
    """The ``nvcc`` steps of ``build``: compile and link into
    ``out_dir``."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib_tmp = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib_tmp),
             *[str(obj) for _, obj, _ in procs]],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(lib_tmp, out_dir / LIB_NAME)
    return out_dir / LIB_NAME


def ensure_built(out_dir: Path = BUILD_DIR) -> Path:
    """The library's path in ``out_dir``, built first if its stamp is
    stale (a stamp hit reuses the finished build)."""
    stamp = out_dir / "stamp"
    digest = _digest()
    lib_path = out_dir / LIB_NAME
    if not (lib_path.is_file() and stamp.is_file()
            and stamp.read_text() == digest):
        lib_path = build(out_dir)
        stamp.write_text(digest)
    return lib_path


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its stamp is stale."""
    lib = ctypes.CDLL(str(ensure_built(BUILD_DIR)))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if rc:
        text = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({text}) at launch")
