"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by nvcc for Hopper (`sm_90a`) into one shared
library with a plain C interface, loaded with `ctypes`.  The library is
built at first use, cached under `build/paddle_tpu_torch/` at the repository
root (an installed copy, outside a checkout, uses
`~/.cache/paddle_tpu_torch/build`), named by a hash of the sources and
flags so an edited kernel builds anew.  The sources compile in parallel,
one nvcc per file, and link once; the build raises with nvcc's stderr when
it fails.

This is a plain nvcc build on purpose: `torch.utils.cpp_extension.load`
compiles PyTorch's headers and takes minutes per build; a file with a C
interface takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
BUILD_DIR = (
    _CHECKOUT / "build" / "paddle_tpu_torch"
    if (_CHECKOUT / "pyproject.toml").is_file()
    else pathlib.Path.home() / ".cache" / "paddle_tpu_torch" / "build"
)

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the exported functions: (argtypes, restype)
SIGNATURES = {
    # q, k, v, out, lse, b, s, h, hk, d, causal, scale, dtype, path,
    # segments, kbias, stream
    "ptt_flash_fwd": ([_P] * 5 + [_I] * 6 + [_F, _I, _I, _P, _P, _P], _I),
    # q, k, v, out, lse, g, dq, dk, dv, delta, b, s, h, hk, d, causal,
    # scale, dtype, path, segments, kbias, stream
    "ptt_flash_bwd": ([_P] * 10 + [_I] * 6 + [_F, _I, _I, _P, _P, _P], _I),
    # q, k, v, out, lse, q_offset, carry_out, carry_lse, b, s, lk, h, hk, d,
    # bq, causal, scale, dtype, path, out_f32, stream
    "ptt_flash_fwd_ring": ([_P] * 8 + [_I] * 8 + [_F, _I, _I, _I, _P], _I),
    # q, k, v, out, lse, g, dq, dk, dv, delta, q_offset, b, s, lk, h, hk, d,
    # bq, causal, scale, dtype, path, delta_given, stream
    "ptt_flash_bwd_ring": ([_P] * 11 + [_I] * 8 + [_F, _I, _I, _I, _P], _I),
    # q, ak, av, tables, pos, out, ws, splits, path, b, sq, h, hk, d, ps, P,
    # max_len, scale, dtype, stream
    "ptt_paged_decode": ([_P] * 7 + [_I] * 10 + [_F, _I, _P], _I),
    # q, ak, av, k_scale, v_scale, tables, pos, out, ws, splits, path, b, sq,
    # h, hk, d, ps, P, max_len, scale, dtype, stream
    "ptt_paged_decode_q8": ([_P] * 9 + [_I] * 10 + [_F, _I, _P], _I),
    # q, ak, av, tables, page_base, pos, acc, m, l, ws, splits, path, b, sq,
    # h, hk, d, ps, P, max_len, scale, dtype, stream
    "ptt_paged_decode_partials": ([_P] * 10 + [_I] * 10 + [_F, _I, _P], _I),
    # q, ak, av, k_scale, v_scale, tables, page_base, pos, acc, m, l, ws,
    # splits, path, b, sq, h, hk, d, ps, P, max_len, scale, dtype, stream
    "ptt_paged_decode_partials_q8": ([_P] * 12 + [_I] * 10 + [_F, _I, _P], _I),
    # q, ak, av, tables, page_base, pos, out, ws, cp, per_shard, splits,
    # path, b, sq, h, hk, d, ps, P, max_len, scale, dtype, stream
    "ptt_paged_decode_cp": ([_P] * 8 + [_I] * 12 + [_F, _I, _P], _I),
    # q, ak, av, k_scale, v_scale, tables, page_base, pos, out, ws, cp,
    # per_shard, splits, path, b, sq, h, hk, d, ps, P, max_len, scale,
    # dtype, stream
    "ptt_paged_decode_cp_q8": ([_P] * 10 + [_I] * 12 + [_F, _I, _P], _I),
    # q, k, v, out, pos, b, sq, h, hk, d, L, scale, dtype, path, stream
    "ptt_dense_decode": ([_P] * 5 + [_I] * 6 + [_F, _I, _I, _P], _I),
    # tensors, chunks, n_tensors, n_chunks, chunk_size, lr, b1, b2, 1 - b1,
    # 1 - b2, eps, found_inf, stream
    "ptt_adam_multi": ([_P, _P, _I, _I, _I, _P] + [_F] * 5 + [_P, _P], _I),
    # tensors, chunks, n_chunks, chunk_size, scale, found_inf, stream
    "ptt_unscale_multi": ([_P, _P, _I, _I, _P, _P, _P], _I),
    "ptt_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME to the CUDA toolkit that builds the "
            "paddle_tpu_torch kernels"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"kernel build failed ({' '.join(cmd)}):\n{proc.stderr}{proc.stdout}"
        )
    return proc


def build(verbose=False):
    """Compile every csrc/*.cu into one .so (skipped when the hashed library
    exists) and return its path.  `verbose` adds `-Xptxas -v` and returns
    ptxas' report of registers and shared memory through `ptxas_report`."""
    lib_path = BUILD_DIR / f"libpaddle_tpu_torch_{_digest()}.so"
    if lib_path.exists() and not verbose:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (src.stem + ".o") for src in sources()]
        procs = [
            (src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
            for src, obj in zip(sources(), objs)
        ]
        reports, failures = [], []
        for src, proc in procs:
            out, err = proc.communicate()
            reports.append(err + out)
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{err}{out}")
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        tmp_lib = pathlib.Path(tmp) / lib_path.name
        _run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)])
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent loader sees all or nothing
    build.ptxas_report = "\n".join(reports)
    return lib_path


build.ptxas_report = ""


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:  # every launch after the first: no lock
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
        return _lib


def check(code, what):
    """Raise when a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib().ptt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
