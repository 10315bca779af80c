"""Device choice and the toolchain that builds the port's CUDA kernels.

Entry points take ``device=None`` and then run on ``DEFAULT_DEVICE``
("cuda"); the CPU is used only when the caller asks for it. Kernels live in
``csrc/`` as CUDA C++ with a plain C interface. At first use each source is
compiled by nvcc for sm_90a into a shared library under ``_build/`` (named by
a hash of the sources, so an edit rebuilds it) and loaded with ctypes.
``build()`` starts one nvcc per source, all at once, and waits for them;
``BUILD_SECONDS`` keeps each source's wall seconds and
``ptxas_report`` reads the registers and spills ptxas printed per kernel.
The host code in ``csrc/`` (``HOST_SOURCES``: the Poseidon sponge,
``poseidon.cpp``) is plain C++ built the same way by the host compiler,
with no nvcc, so it builds on a machine without the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

DEFAULT_DEVICE = "cuda"

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("ff", "ec_g1", "ec_g2", "ec_ed", "digit_sort", "ntt", "blake2s")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_SOURCES = ("poseidon",)  # csrc/<name>.cpp, built by the host compiler
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIBS: dict = {}
BUILD_SECONDS: dict = {}  # source -> wall seconds of its build in this process


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: the caller's, else cuda."""
    return torch.device(DEFAULT_DEVICE if device is None else device)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def cxx_path() -> str:
    """The host C++ compiler (nvcc's host compiler on a CUDA machine)."""
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++, g++) found: the host code cannot be built")


def toolchain() -> dict:
    """torch and CUDA versions, whether triton imports, nvcc's version."""
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                             text=True, check=True).stdout
        nvcc = out.strip().splitlines()[-1]
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        nvcc = None
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "triton": triton_version, "nvcc": nvcc}


def library_path(name: str) -> Path:
    """Where the library of source ``name`` is (or will be) built: named by a
    hash of the flags and the sources it is built from (every CUDA source
    for a kernel library, its own file for host code), so an edit rebuilds
    it."""
    if name in HOST_SOURCES:
        h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
        h.update((CSRC / f"{name}.cpp").read_bytes())
    else:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC.iterdir()):
            if f.suffix in (".cu", ".cuh"):
                h.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build_command(name: str, out: Path) -> list:
    if name in HOST_SOURCES:
        return [cxx_path(), *HOST_FLAGS, "-o", str(out), str(CSRC / f"{name}.cpp")]
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> float:
    """Compile the named sources that are not built yet, in parallel.

    Returns the wall seconds spent; raises with the compiler's output on
    failure.
    Each library is written under a temporary name and renamed, so a
    concurrent reader never loads a half-written file.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = _build_command(name, tmp)
        log = open(BUILD_DIR / f"{name}.log", "w")
        procs.append((name, out, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    pending = list(procs)
    while pending:
        for item in list(pending):
            name, out, tmp, log, proc = item
            rc = proc.poll()
            if rc is None:
                continue
            pending.remove(item)
            BUILD_SECONDS[name] = time.perf_counter() - t0
            log.close()
            if rc == 0:
                os.replace(tmp, out)
            else:
                failed.append(name)
        if pending:
            time.sleep(0.05)
    if failed:
        msgs = [(BUILD_DIR / f"{n}.log").read_text()[-4000:] for n in failed]
        raise RuntimeError(f"build failed for {failed}:\n" + "\n".join(msgs))
    return time.perf_counter() - t0


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _demangle(names: list) -> list:
    """C++ names through the toolkit's cu++filt, where there is one."""
    try:
        filt = Path(nvcc_path()).with_name("cu++filt")
        out = subprocess.run([str(filt)], input="\n".join(names), capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return names
    return out if len(out) == len(names) else names


def kernel_names(names: list) -> list:
    """Mangled kernel names made readable: demangled where the toolkit can,
    without the parameter list, namespaces and the casts on template
    arguments."""
    out = []
    for name in _demangle(names) if names else []:
        for cast, plain in (("(int)", ""), ("(bool)1", "true"), ("(bool)0", "false"),
                            ("(anonymous namespace)::", ""), ("<unnamed>::", "")):
            name = name.replace(cast, plain)
        out.append(name.split("(")[0].removeprefix("void "))
    return out


def ptxas_report(log: str) -> list:
    """Per kernel entry in an nvcc -Xptxas -v log, and per device function
    compiled as a call (``"call": True``): its name (demangled, without the
    parameter list, where the toolkit can), the registers a kernel's thread
    uses, and the stack frame and spill bytes."""
    records, by_name, entry, current = [], {}, None, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = by_name[m.group(1)] = {"entry": m.group(1)}
            records.append(entry)
            continue
        m = _PROPS.search(line)
        if m:
            current = by_name.get(m.group(1))
            if current is None:  # a device function compiled as a call
                current = by_name[m.group(1)] = {"entry": m.group(1), "call": True}
                records.append(current)
            continue
        m = _FRAME.search(line)
        if m and current is not None:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            continue
        m = _REGS.search(line)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
    for r, name in zip(records, kernel_names([r["entry"] for r in records])):
        r["entry"] = name
    return records


def build_log(name: str) -> str:
    """nvcc's output for source ``name`` from its last build here."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors) -> None:
    """Kernels run on CUDA tensors only; anything else is refused."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected cuda")
