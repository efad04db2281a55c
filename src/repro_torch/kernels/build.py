"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled for Hopper (`sm_90a`) at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

`--fmad=false` keeps nvcc from contracting `a*b + c` into a fused
multiply-add, which would change the last bit of the squared-L2 FPS
distance against the plain version.  The file name carries a hash of the
sources, the flags and the compiler path, so an edited kernel is rebuilt
and a stale library is never loaded.  `build()` starts one nvcc per source,
all at once, and waits for every one of them.  ptxas's report (registers,
shared memory, spills) is kept beside each library as `<name>-<hash>.log`.

Nothing here runs at import time: the CPU-only test host has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

import torch

SRC_DIR = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fps", "lattice", "sc_matmul", "knn3")
N_SMS = 132  # SMs of the card the kernels are built and planned for (H100 SXM)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then $PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "$PATH): the CUDA kernels can only be built on a host with the CUDA "
            "toolkit"
        )
    return found


def library_path(name: str, nvcc: str) -> pathlib.Path:
    """Where the library of `csrc/<name>.cu` lives for these sources and flags."""
    digest = hashlib.sha256()
    digest.update((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(nvcc.encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_command(name: str, nvcc: str, out: pathlib.Path) -> list[str]:
    """The nvcc command line that builds `csrc/<name>.cu` into `out`."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(SRC_DIR / f"{name}.cu")]


def build(names=SOURCES) -> dict[str, pathlib.Path]:
    """Compile every library in `names` that is not built yet, in parallel.

    Returns {name: library path}.  Raises RuntimeError with nvcc's output if
    any compile fails (after every started nvcc has ended).
    """
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name, nvcc) for name in names}
    jobs = []
    try:
        for name, path in paths.items():
            if path.is_file():
                continue
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen(
                compile_command(name, nvcc, tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((name, path, tmp, proc))
    finally:
        failures = []
        for name, path, tmp, proc in jobs:
            output, _ = proc.communicate()
            path.with_suffix(".log").write_text(output)
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu:\n{output}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """ptxas/nvcc output of the current build of `csrc/<name>.cu` ('' if none)."""
    log = library_path(name, nvcc_path()).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def kernel_label(mangled: str) -> str:
    """`sc_matmul_kernel<4,1,1>` for a mangled kernel of this package's sources
    (a function in an anonymous namespace, with int and bool template
    arguments); any other name comes back as it is."""
    names, pos = [], 3  # after "_ZN": length-prefixed names
    while mangled.startswith("_ZN") and (m := re.match(r"\d+", mangled[pos:])):
        pos += m.end()
        names.append(mangled[pos:pos + int(m.group())])
        pos += int(m.group())
    names = [n for n in names if not n.startswith("_GLOBAL__N")]
    if not names:
        return mangled
    rest = mangled[pos:]
    if not rest.startswith("I"):
        return names[-1]
    args = re.findall(r"L[ib](\d+)E", rest[:rest.find("EE") + 2])
    return f"{names[-1]}<{','.join(args)}>"


def ptxas_report(log: str) -> list[dict]:
    """Per-kernel registers, static shared memory, stack and spills from ptxas -v output."""
    entries: list[dict] = []
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": kernel_label(m.group(1)), "registers": None, "smem_bytes": 0,
                   "stack_bytes": None, "spill_stores": None, "spill_loads": None}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem_bytes"] = int(m.group(1))
    return entries


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            lib.pc2im_error_string.argtypes = [ctypes.c_int]
            lib.pc2im_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def launch(entry, device, *args) -> int:
    """entry(device.index, *args) with `device` made current, the caller's restored after.

    Each C entry point makes its device current (`cudaSetDevice`), and that
    is the calling thread's current device for PyTorch too (both runtimes
    set the thread's current CUDA context): without this guard, a kernel on
    another card would leave that card current for the caller, and a later
    "cuda" would resolve to it.  Returns the entry point's status.
    """
    with torch.cuda.device(device):
        return entry(device.index, *args)


def check(status: int, name: str) -> None:
    """Raise if a C entry point of library `name` returned a CUDA error."""
    if status != 0:
        text = load(name).pc2im_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status} ({text})")
