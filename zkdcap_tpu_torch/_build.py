"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc`` (all
started together), and the objects are linked into one shared library with
a plain C interface, ``build/kernels/libzkdcap_kernels.so`` at the root of
the checkout, loaded with ctypes. The build runs at first use and again only
when a source or a flag changes (a hash of both sits beside the library).

Each kernel wrapper counts its launches in :data:`launches`, so that a run
can show that its main path went through the kernels.

The host witness evaluator (``csrc_host/witness_eval.cpp``, the C++ replay
of a recorded witness tape) is built the same way by ``g++`` into
``build/host/libwitness_eval.so``: :func:`witness_lib`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
CSRC_HOST = Path(__file__).resolve().parent / "csrc_host"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
# The JAX package's native/Makefile adds -fopenmp; the card's machine has no
# libgomp to link, so the evaluator's one OpenMP loop (the output encode) runs
# on one thread here.
HOST_CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
LIB_NAME = "libzkdcap_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, sizes as c_int or c_long); each returns cudaGetLastError() after
# its launch.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
SIGNATURES = {
    # a, b, out, n, b_rows, b_inner, field (0 Fr, 1 Fq), stream
    "zk_mont_mul": [_P, _P, _P, _L, _L, _L, _I, _P],
    # x, out, tw, ptw, batches, rows, log_size, ptw_period, the strides of x
    # and of out (batch, row, element; int32 words), rows_rev, stream
    "zk_ntt_pass": [_P, _P, _P, _P, _L, _L, _I, _L] + [_L] * 6 + [_I, _P],
    # rows, masks, ox, oy, oz, steps, lanes, stream
    "zk_madd_scan": [_P, _P, _P, _P, _P, _I, _I, _P],
    # x1, y1, z1, x2, y2, z2, mask, ox, oy, oz, n, fallback_q, stream
    "zk_ec_add_select": [_P] * 10 + [_I, _I, _P],
    # tx, ty, tz, ox, oy, oz, windows, window_bits, stream
    "zk_window_join": [_P] * 6 + [_I, _I, _P],
    # in_ptrs, out_ptrs, in_ws, in_ss, out_ws, out_ss (host arrays), n_ops,
    # batches, segments, log_n, scratch (the row sort's positions), stream
    "zk_bitonic_sort": [_P] * 6 + [_I, _I, _I, _I, _P, _P],
    # x, out, tw, rows, log_n, s, tw_stride, stream
    "zk_butterfly": [_P, _P, _P, _L, _I, _I, _L, _P],
}

launches = {"ntt_pass": 0, "madd_scan": 0, "ec_add_select": 0, "window_join": 0,
            "mont_mul": 0, "bitonic_sort": 0, "butterfly": 0}

_lib = None
_witness_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()  # exact counts when a caller launches from several threads
build_log = ""  # nvcc's output (-Xptxas -v: registers, spills) of the current library


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile csrc/ into the shared library unless it is current; returns its path."""
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _digest()
    log_path = BUILD_DIR / "build.log"
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        build_log = log_path.read_text() if log_path.exists() else ""
        return lib_path
    nvcc = _nvcc()
    # objects and the library go to per-process names first, so that
    # concurrent first uses (test workers) never clash; the rename is atomic
    work = Path(tempfile.mkdtemp(prefix="obj-", dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode:
                failed.append(obj.stem)
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        tmp = work / LIB_NAME
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                *(str(obj) for obj, _ in procs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
        log_path.write_text(build_log)
        stamp.write_text(digest)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, *args, device: torch.device) -> None:
    """Call C entry ``zk_<name>`` on `device`'s current stream, with `device`
    the current CUDA device while it runs (the entries keep their one-time
    setup per device); raise on a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib(), "zk_" + name)(*args, stream)
    if err:
        raise RuntimeError(f"CUDA kernel {name} failed on {device}: error {err}")
    with _count_lock:
        launches[name] += 1


def ptxas_report(log: str) -> dict:
    """Registers, stack frame and spills of each kernel function in nvcc's
    ``-Xptxas -v`` output, by mangled name."""
    funcs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            funcs.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            funcs[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            funcs[cur]["registers"] = int(m.group(1))
    return funcs


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Kernel inputs must be contiguous, 16-byte aligned int32 tensors on one
    CUDA device, which is returned."""
    dev = tensors[0].device
    for t in tensors:
        if (t.device.type != "cuda" or t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: expects contiguous aligned int32 tensors on one CUDA "
                             f"device ({dev}), got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    return dev


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (Linux), or the machine name."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        import platform

        return platform.machine().encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(dict.fromkeys(keep)).encode()


def build_witness_eval() -> Path:
    """Compile csrc_host/witness_eval.cpp with g++ unless the library is
    current; returns its path."""
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = CSRC_HOST / "witness_eval.cpp"
    lib_path = HOST_BUILD_DIR / "libwitness_eval.so"
    stamp = HOST_BUILD_DIR / "witness_eval.sha256"
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    h.update(src.read_bytes())
    h.update(_host_cpu())  # -march=native: a library built on another CPU is rebuilt
    digest = h.hexdigest()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the witness evaluator is built at first use")
    fd, tmp = tempfile.mkstemp(prefix="libwitness_eval-", suffix=".so", dir=HOST_BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *HOST_CXX_FLAGS, "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"g++ failed for {src.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
        stamp.write_text(digest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def witness_lib() -> ctypes.CDLL:
    """The loaded witness evaluator (built on first call)."""
    global _witness_lib
    with _lock:
        if _witness_lib is None:
            handle = ctypes.CDLL(str(build_witness_eval()))
            handle.witness_eval.restype = ctypes.c_int
            _witness_lib = handle
    return _witness_lib
