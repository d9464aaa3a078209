"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``.cu`` file under a package's ``csrc/`` compiles on its own into a
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so <name>.cu

The library's name carries a hash of every file in ``csrc/`` and of the
flags, so an edited source builds anew and an unchanged one is reused.  The
build happens at first use, into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), or into ``$REPRO_TORCH_BUILD_DIR``.
The ``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside each library as ``<name>-<hash>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return found


def _library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(source.parent.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return build_dir() / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[Path]) -> Dict[Path, Path]:
    """Compile every source whose library is missing, all ``nvcc``
    processes started together; returns ``{source: library}``.  Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    libs = {Path(s): _library_path(Path(s)) for s in sources}
    todo = {s: lib for s, lib in libs.items() if not lib.is_file()}
    if not todo:
        return libs
    build_dir().mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs: List[tuple] = []
    try:
        for src, lib in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, lib, tmp, proc in procs:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            lib.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n"
                              f"{out}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    finally:
        for _, _, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return libs


def build_log(source: Path) -> str:
    """The ``-Xptxas -v`` report of the source's current library."""
    log = _library_path(Path(source)).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load one source's library, once per process."""
    lib = build([Path(source)])[Path(source)]
    return ctypes.CDLL(str(lib))
