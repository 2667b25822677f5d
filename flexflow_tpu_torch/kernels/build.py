"""Build and load the port's CUDA kernels.

Each source under `csrc/` compiles with nvcc into its own shared library
with a plain C interface, loaded with ctypes. The build runs at first use
(never at import), writes into `flexflow_tpu_torch/_build/`, and names each
library after a hash of its source, the shared headers and the flags, so an
edited source builds anew and an unchanged one is reused. Several sources
build in parallel, one nvcc process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Sequence, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("flash_attention.cu", "ring_flash.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    ptxas_log: str


def library_path(source: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    text = (CSRC_DIR / source).read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed"
    )


def build(sources: Sequence[str] = SOURCES) -> Dict[str, BuildInfo]:
    """Compile every source whose library is missing, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    infos: Dict[str, BuildInfo] = {}
    running = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            log = out.with_suffix(".log")
            infos[src] = BuildInfo(out, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[src] = (proc, tmp, out, time.perf_counter())
    for src, (proc, tmp, out, start) in running.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{text}")
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
        infos[src] = BuildInfo(out, seconds, text)
    return infos


_LOADED: Dict[str, ctypes.CDLL] = {}


def load(source: str, signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """The ctypes handle of `source`'s library, built first if missing, with
    `signatures` ({name: (argtypes, restype)}) declared on its functions."""
    if source not in _LOADED:
        info = build([source])[source]
        lib = ctypes.CDLL(str(info.path))
        for name, (argtypes, restype) in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LOADED[source] = lib
    return _LOADED[source]


def launch(lib: ctypes.CDLL, name: str, *args) -> None:
    """Call the C entry `name` of `lib`, which launches a kernel and returns
    cudaGetLastError(); raise if that is not 0."""
    code = getattr(lib, name)(*args)
    if code != 0:
        raise RuntimeError(
            f"{name} failed: CUDA error {code} ({lib.ff_error_string(code).decode()})"
        )


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?(\w+)'?")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel: registers, static shared memory and spills, from the
    `-Xptxas -v` report."""
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m.group(1)
            out.setdefault(current, {})
            continue
        if current is None:
            continue
        m = _SPILL.search(line)
        if m:
            out[current].update(
                stack_bytes=int(m.group(1)),
                spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)),
            )
        m = _USED.search(line)
        if m:
            out[current]["registers"] = int(m.group(1))
            out[current]["static_smem_bytes"] = int(m.group(2) or 0)
    return out
