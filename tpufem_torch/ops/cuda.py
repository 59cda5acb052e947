"""Build, load and launch the hand-written CUDA kernels of tpufem_torch.

Each kernel lives in one source under ``tpufem_torch/csrc/`` with a plain C
entry point.  At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``tpufem_torch/_build/`` and
loaded with ctypes; tensors are passed as raw device pointers and the
kernel runs on PyTorch's current stream.  The library is named after its
source and carries a hash of the sources and flags, so an edited source is
rebuilt.  ``build()`` starts one ``nvcc`` per source, all at once.

``Graph`` captures a callable once as a CUDA graph and replays it, and
keeps the kernels' launch counts: a replay adds what the capture launched.

Nothing here imports or compiles anything when the module is imported: the
CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, List, Optional

import torch

from ..utils.profiling import span

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "_build")
# -fmad=false: no a*b+c contraction, so a kernel does the same roundings as
# its plain PyTorch version and the two agree bitwise on the card
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

VP = ctypes.c_void_p
I32 = ctypes.c_int32
I64 = ctypes.c_int64
F64 = ctypes.c_double


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of tpufem_torch "
                       "are built at first use on a machine with the CUDA "
                       "toolkit (set NVCC to its path)")


# every CudaKernel, in the order they were made (Graph counts over these)
REGISTRY: List["CudaKernel"] = []


class CudaKernel:
    """One kernel: its source, its build, its C entry points and a launch
    count.

    ``launches`` is a plain integer that the kernel's wrapper raises by one
    at each launch (and a Graph by its captured launches at each replay),
    and nowhere else; ``replayed`` counts the launches of graph replays
    alone."""

    def __init__(self, name: str, source: str, replaces: str,
                 entry_points: Dict[str, list]):
        self.name = name
        self.source = source                  # file name under csrc/
        self.replaces = replaces              # tpufem file:line of the TPU kernel
        self.entry_points = entry_points      # C name -> ctypes argtypes
        self.launches = 0
        self.replayed = 0
        self._lib: Optional[ctypes.CDLL] = None
        REGISTRY.append(self)

    @property
    def source_path(self) -> str:
        return os.path.join(CSRC, self.source)

    def so_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for fn in sorted(os.listdir(CSRC)):
            if fn == self.source or fn.endswith(".cuh"):
                with open(os.path.join(CSRC, fn), "rb") as f:
                    h.update(fn.encode() + f.read())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD, f"{stem}-{h.hexdigest()[:16]}.so")

    def log_path(self) -> str:
        return self.so_path()[:-3] + ".log"

    def _start(self) -> Optional[tuple]:
        so = self.so_path()
        if os.path.exists(so):
            return None
        os.makedirs(BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               self.source_path]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, so

    @staticmethod
    def _finish(kernel: "CudaKernel", job) -> None:
        proc, tmp, so = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"nvcc failed for {kernel.source}:\n{out}")
        with open(so[:-3] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, so)              # atomic: no half-written library

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(self.so_path())
            for fn, argtypes in self.entry_points.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.tpufem_cuda_error_string.argtypes = [ctypes.c_int]
            lib.tpufem_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call C entry point `fn`; raise if the launch reports an error."""
        lib = self.lib()
        rc = getattr(lib, fn)(*args)
        if rc != 0:
            msg = lib.tpufem_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc}: {msg}")
        self.launches += 1


def build(kernels: Iterable[CudaKernel]) -> List[str]:
    """Compile every missing library, one nvcc process per source (kernels
    that share a source share its library), all started together; returns
    the sources that were compiled."""
    jobs, started = [], set()
    for k in kernels:
        if k.so_path() in started:
            continue
        started.add(k.so_path())
        job = k._start()
        if job is not None:
            jobs.append((k, job))
    errors = []
    for k, job in jobs:
        try:
            CudaKernel._finish(k, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [k.source for k, _ in jobs]


def ptr(t: torch.Tensor) -> VP:
    return VP(t.data_ptr())


def int_array(vals) -> VP:
    """Host int32 array argument (the cast keeps the array alive)."""
    arr = (I32 * max(len(vals), 1))(*vals)
    return ctypes.cast(arr, VP)


def stream(t: torch.Tensor) -> VP:
    return VP(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda_args(name: str, device: torch.device, float_dtype,
                    floats=(), ints=()) -> None:
    """Device, type and contiguity checks shared by the kernel wrappers."""
    if float_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 only, got {float_dtype}")
    for t in floats:
        if t.device != device or t.dtype != float_dtype:
            raise TypeError(f"{name}: expected {float_dtype} on {device}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: float operand not contiguous")
    for t in ints:
        if t.device != device or t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 on {device}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: int operand not contiguous")


class Graph:
    """`fn` captured once as a CUDA graph (torch.cuda.graph, on the current
    device; `pool` shares another graph's memory pool) and replayed.

    Capturing runs nothing, so the launches that the kernels' wrappers
    counted during the capture are taken back and kept as the graph's
    own counts; each replay adds them to the kernels' counts.  A capture
    that fails raises."""

    def __init__(self, fn, pool=None):
        before = [k.launches for k in REGISTRY]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with span("graph.capture"), torch.cuda.graph(self.graph,
                                                         pool=pool):
                fn()
        finally:
            self.counts = [(k, k.launches - n)
                           for k, n in zip(REGISTRY, before)
                           if k.launches != n]
            for k, n in zip(REGISTRY, before):
                k.launches = n

    def pool(self):
        return self.graph.pool()

    def replay(self) -> None:
        self.graph.replay()
        for k, n in self.counts:
            k.launches += n
            k.replayed += n
