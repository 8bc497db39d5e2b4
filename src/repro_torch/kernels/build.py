"""Build and load the port's CUDA kernels (nvcc by hand, bound with ctypes).

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface; :func:`load` opens it with
``ctypes``.  Nothing here runs at import: the first launch of a kernel
builds what it needs, and :func:`build_all` builds every source at once,
one ``nvcc`` process per source, all started together.  Libraries land in
``build/`` beside this file, named by a hash of the source and the flags,
so an edited source is rebuilt and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("segscan", "pointer_jump", "edge_hash", "flash_attention",
           "decode_attention", "wkv6", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    place, or ``nvcc`` on the PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every named source that has no library yet, in parallel.
    Returns ``{name: compiler output}`` — the ``-Xptxas -v`` report, kept
    beside each library so that a library built earlier reports it too.
    Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            target.with_suffix(".log").write_text(out)
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


def ptxas_resources(report: str, kernel: str) -> dict:
    """Each instance of the kernel ``kernel`` in a ``-Xptxas -v`` report:
    ``{(D, type): {"registers", "spill_bytes", "stack_bytes",
    "smem_bytes"}}`` for a symbol ``kernel<D>`` or ``kernel<D, type>``, type
    "bf16", "f32" or "" (none), and ``(0, "")`` for a kernel that is no
    template; the figures the report gives."""
    out, key = {}, None
    for line in report.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            m = re.search(r"\d" + kernel + r"(?:ILi(\d+)E(\w*?)EEv|E)",
                          m.group(1))
            key = None if m is None else (0, "") if m[1] is None else (
                int(m[1]), "bf16" if "bfloat16" in m[2] else "f32"
                if m[2] == "f" else "")
            continue
        if key is None:
            continue
        r = out.setdefault(key, {})
        for field, pattern in (
                ("stack_bytes", r"(\d+) bytes stack frame"),
                ("spill_bytes", r"(\d+) bytes spill stores, (\d+) bytes "
                                r"spill loads"),
                ("registers", r"Used (\d+) registers"),
                ("smem_bytes", r"(\d+) bytes smem")):
            m = re.search(pattern, line)
            if m:
                r[field] = sum(int(g) for g in m.groups())
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
