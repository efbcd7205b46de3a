"""Build the hand-written kernels with nvcc and bind them with ctypes.

``load()`` compiles every ``csrc/*.cu`` for ``sm_90a`` — one ``nvcc -c`` per
source, all started together — links the objects into one shared library
with a plain C interface, and loads it.  The build goes to
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed on a
hash of the sources and flags, so a source change rebuilds and an unchanged
tree reuses the library.  Nothing is compiled at import: the first wrapper
launch on a CUDA tensor calls ``load()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"
PTXAS_REPORT = "ptxas.json"   # each source's -Xptxas -v output, by name

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (argtypes); every one returns a cudaError_t as int
SIGNATURES = {
    # q, k_pages, v_pages, block_tables, q_offset, q_len, kv_len, out,
    # part_o, part_ml, B, sq, nq, nkv, hd, hdv, page, nb, n_pages, rows,
    # n_split, scale, dtype, stream
    "rt_flash_chunk_paged": [_P] * 10 + [_I] * 11 + [_F, _I, _P],
    # q, k, v, q_offset, q_len, kv_len, out, part_o, part_ml,
    # B, sq, nq, nkv, hd, hdv, S, rows, n_split, scale, dtype, stream
    "rt_flash_chunk": [_P] * 9 + [_I] * 9 + [_F, _I, _P],
    # logits, weights, idx, n_rows, E, k, renorm, dtype, stream
    "rt_topk_gate": [_P] * 3 + [_I] * 5 + [_P],
    # x, w, offsets, out, N, H, D, E, visit bound, dtype, stream
    "rt_grouped_gemm": [_P] * 4 + [_I] * 6 + [_P],
    # x, w, out, E, C, H, D, dtype, stream
    "rt_moe_gemm": [_P] * 3 + [_I] * 5 + [_P],
    # x, src, out, N, T, h, element bytes, grid x, grid y, stream
    "rt_permute_tokens": [_P] * 3 + [_I] * 6 + [_P],
    # x, src, total, out, N, T, h, element bytes, seg_stride, grid x,
    # grid y, stream
    "rt_permute_tokens_ragged": [_P] * 4 + [_I] * 7 + [_P],
    # buf, slot, weights, out, T, k, h, M, dtype, stream
    "rt_unpermute_tokens": [_P] * 4 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None
# the loaded library: seconds to build or load it, its directory, and each
# source's ptxas summary (read back from the cache on a cache hit)
build_info: dict = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the kernels build only where the "
                           "CUDA toolkit is installed")
    return found


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: pathlib.Path) -> dict:
    """Compile each source in parallel, link, return the ptxas reports."""
    cc = nvcc()
    procs = {}
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        procs[src.name] = subprocess.Popen(
            [cc, *FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    reports, failed = {}, []
    for name, p in procs.items():
        out, _ = p.communicate()
        reports[name] = out
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(reports[n] for n in failed))
    objs = [str(out_dir / (s.stem + ".o")) for s in sources()]
    link = subprocess.run([cc, *ARCH, "-shared", "-o",
                           str(out_dir / LIB_NAME), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    return reports


def load():
    """The loaded kernel library (built on first call).  Once loaded it is
    returned without taking the lock, so launches pay no build check."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        final = BUILD_ROOT / source_hash()
        if not (final / LIB_NAME).exists():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT,
                                                prefix=".build-"))
            try:
                reports = _compile(tmp)
                # kept beside the library so a cached build still reports
                (tmp / PTXAS_REPORT).write_text(json.dumps(reports))
                try:
                    tmp.rename(final)          # atomic publish
                except OSError:                # another process won the race
                    shutil.rmtree(tmp, ignore_errors=True)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
        lib = ctypes.CDLL(str(final / LIB_NAME))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        report = final / PTXAS_REPORT
        reports = json.loads(report.read_text()) if report.exists() else {}
        build_info.update(seconds=time.perf_counter() - t0, dir=str(final),
                          ptxas=reports)
        _lib = lib
        return lib


__all__ = ["load", "build_info", "source_hash", "sources", "nvcc"]
