"""Build the CUDA sources in csrc/ at first use and load them with ctypes.

Each `.cu` file is compiled by its own `nvcc -c` (all started together),
then linked into one shared library with a plain C interface:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
       -Xcompiler -fPIC -c csrc/<name>.cu      (one per source, in parallel)
  nvcc -shared -o libcassnat_kernels.so *.o

The library lands in build/torch_kernels/<hash of the sources>/ beside the
package (a directory git ignores), so an edited source rebuilds and an
unchanged one is loaded from the cache. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH = "arch=compute_90a,code=sm_90a"
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_IA = ctypes.POINTER(ctypes.c_int)
_PA = ctypes.POINTER(ctypes.c_uint64)
# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    **{f"cassnat_flash_attention_{t}": [_P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I,
                                        _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                        _L, _L, _L, _P]
       for t in ("f32", "bf16")},
    "cassnat_fused_conv_frontend": [_P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _P],
    "cassnat_fused_frontend_plan": [_I, _I, _I, _I, _IA],
    "cassnat_conformer_ptr_names": [],
    "cassnat_conformer_scratch_bytes": [_I, _IA, _I],
    "cassnat_conformer_smem_bytes": [_I, _IA, _I],
    "cassnat_conformer_plan": [_I, _IA, _IA],
    "cassnat_conformer_half_a": [_PA, _IA, _I, _P],
    "cassnat_conformer_half_b": [_PA, _IA, _I, _P],
    "cassnat_conformer_half_a_kv": [_PA, _IA, _I, _P],
    "cassnat_conformer_half_a_qblock": [_PA, _IA, _I, _P],
    "cassnat_ctc_viterbi": [_P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _P, _P, _P],
    "cassnat_ctc_dp_scratch": [_I, _I, _P],
    "cassnat_ctc_viterbi_step_probe": [_P, _I, _P, _P, _P],
    "cassnat_ctc_alpha": [_P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P, _P, _P],
    "cassnat_ctc_beta_grad": [_P, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _P, _P, _P, _P, _P, _P],
    "cassnat_ctc_beta_step_probe": [_P, _I, _P, _P, _P],
    "cassnat_ctc_grad_scatter": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _P, _P],
}
# return types other than a cudaError_t int
RESTYPES = {
    "cassnat_conformer_ptr_names": ctypes.c_char_p,
    "cassnat_conformer_scratch_bytes": ctypes.c_uint64,
    "cassnat_conformer_smem_bytes": ctypes.c_uint64,
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _digest(srcs):
    h = hashlib.sha256(ARCH.encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the cached library; returns its path."""
    srcs = _sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(srcs))
    lib_path = os.path.join(out_dir, "libcassnat_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=out_dir)
    flags = ["-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-I", CSRC]
    if verbose:
        flags += ["-Xptxas", "-v"]
    procs, objs = [], []
    for s in (s for s in srcs if s.endswith(".cu")):
        obj = os.path.join(work, os.path.basename(s) + ".o")
        objs.append(obj)
        procs.append((s, subprocess.Popen(
            [nvcc, *flags, "-c", s, "-o", obj], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for s, p in procs:
        log = p.communicate()[0]
        if verbose and log:
            print(log, flush=True)
        if p.returncode != 0:
            failed.append(f"{os.path.basename(s)}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp_lib = os.path.join(work, "lib.so")
    res = subprocess.run([nvcc, "-shared", "-o", tmp_lib, *objs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(work, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _LIB = handle
    return _LIB


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
