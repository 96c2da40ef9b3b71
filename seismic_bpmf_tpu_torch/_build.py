"""Builds the package's CUDA kernels and its host library at first use and
loads them.

Each ``csrc/<name>.cu`` has a plain C interface (the ``csrc/*.cuh`` headers
are what the sources share; ``bp.cu`` also includes a header that
`_bp_items.py` writes for its sizes) and is compiled by ``nvcc``
into ``build/seismic_bpmf_tpu_torch/lib<name>-<hash>.so`` beside the
package, then loaded with ctypes.  Nothing is compiled when this module is
imported: a kernel's library is built when a CUDA tensor first reaches its
wrapper (or when `build_all` is called).  A failed build raises with
nvcc's stderr.

``csrc/host_ops.cpp`` and ``csrc/peaks.cpp``, the host scans of
`ops.host_ops`, are compiled the same way by the C++ compiler (``c++``,
else ``g++``) into ``build/seismic_bpmf_tpu_torch/lib<name>-<hash>.so``
(`load_host`); the hash also covers the compiler's version, so a library
built by another toolchain is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "seismic_bpmf_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# no -march=native: the library may be loaded on another machine than the
# one that built it; -ffp-contract=off: no fused multiply-adds where a
# target has them, so the scans round as their NumPy versions do
CXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off"]

_LIBS: dict = {}
_LOCK = threading.Lock()
build_seconds: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++ or g++) found: the host "
                       "library cannot be built")


def _generated(name: str, src: str, defines) -> tuple:
    """Writes the header that ``csrc/<name>.cu`` has generated for its
    sizes, if it has one (bp: the item loop's PTX, `_bp_items.py`), from
    the source's ``#define`` defaults under `defines`; returns nvcc's flags
    for it and the header's text."""
    if name != "bp":
        return (), ""
    from . import _bp_items

    with open(src) as f:
        sizes = dict(re.findall(r"^#define (BP_[RD]) (\d+)", f.read(),
                                re.M))
    sizes.update(d.split("=") for d in defines if "=" in d)
    r, d = int(sizes["BP_R"]), int(sizes["BP_D"])
    text = _bp_items.header(r, d)
    gen = os.path.join(BUILD_DIR, f"bp_items-{r}-{d}")
    os.makedirs(gen, exist_ok=True)
    path = os.path.join(gen, "bp_items.cuh")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return ("-I", gen), text


def _target(name: str, defines=(), extra_flags=()) -> tuple:
    src = os.path.join(CSRC, f"{name}.cu")
    include, generated = _generated(name, src, defines)
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines), *include,
             *extra_flags]
    digest = hashlib.sha1((" ".join(flags) + generated).encode())
    headers = sorted(os.path.join(CSRC, fn) for fn in os.listdir(CSRC)
                     if fn.endswith(".cuh"))
    for path in (src, *headers):
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")
    return src, so, flags


def _start(name: str, defines=(), extra_flags=()):
    """Start nvcc for `name` unless its library is already built; returns
    (so_path, Popen or None, tmp_path, t0)."""
    src, so, flags = _target(name, defines, extra_flags)
    if os.path.isfile(so):
        return so, None, None, time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return so, proc, tmp, time.perf_counter()


def _finish(name: str, so: str, proc, tmp: str, t0: float,
            tool: str = "nvcc") -> str:
    """Wait for the compiler; returns its stderr ('' when nothing was
    built)."""
    if proc is None:
        return ""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} failed to build {name}:\n{err}")
    os.replace(tmp, so)
    build_seconds[name] = time.perf_counter() - t0
    return err


# the builds of a source that the package loads besides its default one:
# name -> tuples of -D defines (csrc/mf.cu's 'highest' build, `ops.mf`'s
# HIGHEST_BUILD; the tools' sweeps build variants of their own,
# `build_variants`)
VARIANTS: dict = {"mf": [("MF_ACC_OUT=1",)]}


def key(name: str, defines=()) -> str:
    """The name a build of `name` with -D `defines` is known by: the
    source's name for its default build, else e.g. 'mf[MF_STAGES=2]'."""
    return f"{name}[{','.join(defines)}]" if defines else name


def sources() -> list:
    return sorted(fn[:-3] for fn in os.listdir(CSRC) if fn.endswith(".cu"))


def builds() -> list:
    """(name, defines) of every build the package loads: each source's
    default build and its VARIANTS."""
    return [(n, d) for n in sources() for d in [(), *VARIANTS.get(n, [])]]


def build_all() -> dict:
    """Compile every build at once (one nvcc each, all started together)
    and load them; returns {key: seconds spent building}."""
    with _LOCK:
        todo = [(n, d) for n, d in builds() if key(n, d) not in _LIBS]
        started = [(key(n, d), *_start(n, d)) for n, d in todo]
        for k, so, proc, tmp, t0 in started:
            _finish(k, so, proc, tmp, t0)
            _LIBS[k] = ctypes.CDLL(so)
    return dict(build_seconds)


def build_variants(name: str, variants, extra_flags=()) -> list:
    """Compile `name` once per tuple of -D defines in `variants`, all
    nvcc processes at once, with `extra_flags` added (``-Xptxas -v`` for
    the register report); returns [(library path, nvcc's stderr)], the
    libraries not loaded into the package.  For tuning runs that compare a
    kernel's tile choices."""
    started = [_start(name, defines, extra_flags) for defines in variants]
    return [(so, _finish(name, so, proc, tmp, t0))
            for so, proc, tmp, t0 in started]


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with -D `defines`,
    built on first use."""
    k = key(name, defines)
    lib = _LIBS.get(k)
    if lib is not None:
        return lib
    with _LOCK:
        if k not in _LIBS:
            so, proc, tmp, t0 = _start(name, defines)
            _finish(k, so, proc, tmp, t0)
            _LIBS[k] = ctypes.CDLL(so)
    return _LIBS[k]


def load_host(name: str = "host_ops") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, compiled by the C++
    compiler (`CXX_FLAGS`) on first use; raises RuntimeError naming the
    compiler when it is missing or fails."""
    k = f"{name}.cpp"
    lib = _LIBS.get(k)
    if lib is not None:
        return lib
    with _LOCK:
        if k not in _LIBS:
            cxx = _cxx()
            src = os.path.join(CSRC, f"{name}.cpp")
            version = subprocess.run([cxx, "--version"], capture_output=True,
                                     text=True).stdout
            digest = hashlib.sha1(" ".join([version, *CXX_FLAGS]).encode())
            with open(src, "rb") as f:
                digest.update(f.read())
            so = os.path.join(BUILD_DIR,
                              f"lib{name}-{digest.hexdigest()[:12]}.so")
            proc = tmp = None
            t0 = time.perf_counter()
            if not os.path.isfile(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                proc = subprocess.Popen([cxx, *CXX_FLAGS, "-o", tmp, src],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
            _finish(k, so, proc, tmp, t0, tool=os.path.basename(cxx))
            _LIBS[k] = ctypes.CDLL(so)
    return _LIBS[k]
