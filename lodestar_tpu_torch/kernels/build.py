"""Build and load the CUDA kernels (the port's counterpart of
`lodestar_tpu/kernels/launch.py`).

Each kernel source `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into
a shared library with a plain C interface and loaded with `ctypes`; no
source includes PyTorch's headers, so a build takes seconds.  All sources
are compiled at once, one `nvcc` process each, at the first launch of any
kernel.  Libraries are cached in `lodestar_tpu_torch/_build/` under a
hash of every file in `csrc/`, the generated headers and the flags, so an
edit to any header or to a generator rebuilds everything and an unchanged
tree reuses the libraries.

Generated headers: `warp_prog.cuh`, the warp-per-lane kernels' programs,
and `kv_prog.cuh`, KeyValidate's lane program, are written by
`kernels/warp_schedule.py cuda_programs()` and `kernels/kv_program.py
cuda_program()` into `_build/gen-<hash>/` at build time and found there
through `-I`.

`ptxas -v` output (registers, spills, stack frame) is kept beside each
library as `<name>-<hash>.ptxas.txt`.

`build_host` compiles the same sources with the host C++ compiler
instead (every PTX carry instruction emulated); the tests use it to hold
the CUDA engine's arithmetic against the plain torch engine on a machine
without a GPU.

`build_native` compiles the port's host libraries, `native/<name>.cpp`
(the KV store of `db/controller.py`), with the host C++ compiler into the
same directory, cached by a hash of the source and the flags.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = (
    "subgroup", "miller", "final", "randmul", "reduce", "tail", "ingest", "aggpk", "keyvalidate", "segsum", "sha256", "spans",
)

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HOST_FLAGS = ["-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC", "-w"]
NATIVE_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class LaunchRefused(RuntimeError):
    """A kernel's C entry point returned a CUDA error: the card did not take
    the launch (a cluster it cannot place, more shared memory than it has,
    no image for the card).  A fault of the build or of the card's setup,
    not of one call's data, so the seams that degrade to the host on a
    device fault let this one propagate."""


@functools.lru_cache(maxsize=None)
def generated_headers() -> Dict[str, str]:
    """Name -> text of the headers the generators write (once per process)."""
    from . import kv_program, warp_schedule

    return {"warp_prog.cuh": warp_schedule.cuda_programs(), "kv_prog.cuh": kv_program.cuda_program()}


def include_dir() -> Path:
    """The directory of the generated headers, written on first use."""
    h = hashlib.sha256()
    for name, text in sorted(generated_headers().items()):
        h.update(name.encode())
        h.update(text.encode())
    out = BUILD_DIR / f"gen-{h.hexdigest()[:16]}"
    out.mkdir(parents=True, exist_ok=True)
    for name, text in generated_headers().items():
        if not (out / name).exists():
            tmp = out / f"{name}.{os.getpid()}.tmp"
            tmp.write_text(text)
            os.replace(tmp, out / name)
    return out


def source_hash(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(include_dir().name.encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a CUDA host")
    return path


def _compile_all(cmd_for, out_for, names=SOURCES, log_suffix=".ptxas.txt") -> None:
    """Start one compiler process per source of `names`, all together; wait
    for all; raise with the compiler's output if any failed.  Each
    compiler's output is kept beside its library under `log_suffix`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if out_for(name).exists():
            continue
        tmp = out_for(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                cmd_for(name, tmp),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        out = out_for(name)
        out.with_suffix(log_suffix).write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def build_all() -> Dict[str, Path]:
    """Compile every kernel source for sm_90a (cached by source hash)."""
    digest = source_hash(NVCC_FLAGS)
    out_for = lambda name: BUILD_DIR / f"{name}-{digest}.so"  # noqa: E731
    cc = nvcc()
    _compile_all(
        lambda name, tmp: [cc, *NVCC_FLAGS, "-I", str(include_dir()), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        out_for,
    )
    return {name: out_for(name) for name in SOURCES}


def build_host(names=SOURCES) -> Dict[str, Path]:
    """Compile the kernel sources `names` (default: all) with the host C++
    compiler (tests)."""
    digest = source_hash(HOST_FLAGS)
    out_for = lambda name: BUILD_DIR / f"host-{name}-{digest}.so"  # noqa: E731
    cxx = host_cxx()
    _compile_all(
        lambda name, tmp: [cxx, *HOST_FLAGS, "-I", str(include_dir()), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        out_for,
        names,
    )
    return {name: out_for(name) for name in names}


def host_cxx() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler")
    return cxx


def build_native(name: str) -> Path:
    """Compile the host library `native/<name>.cpp` with the host C++
    compiler (cached by a hash of the source and the flags)."""
    src = NATIVE / f"{name}.cpp"
    h = hashlib.sha256(" ".join(NATIVE_FLAGS).encode())
    h.update(src.read_bytes())
    out = BUILD_DIR / f"native-{name}-{h.hexdigest()[:16]}.so"
    cxx = host_cxx()
    _compile_all(lambda _n, tmp: [cxx, *NATIVE_FLAGS, "-o", str(tmp), str(src)], lambda _n: out, (name,), ".log")
    return out


def ptxas_report() -> Dict[str, str]:
    """`ptxas -v` lines of the current build, per source."""
    digest = source_hash(NVCC_FLAGS)
    out = {}
    for name in SOURCES:
        p = BUILD_DIR / f"{name}-{digest}.ptxas.txt"
        out[name] = p.read_text() if p.exists() else ""
    return out


_VP, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "lt_g2_subgroup_check": [_VP, _VP, _VP, _VP, _VP, _INT, _VP],
    "lt_miller_loop": [_VP, _VP, _VP, _INT, _VP],
    "lt_each_final": [_VP, _VP, _VP, _VP, _INT, _VP],
    "lt_g1_rpk": [_VP, _VP, _VP, _VP, _VP, _INT, _VP],
    "lt_g2_rsig_sub": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP],
    "lt_sum_g2": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP, _VP],
    "lt_tree_scratch_lanes": [_INT],
    "lt_prod12": [_VP, _VP, _VP, _VP, _INT, _VP, _VP],
    "lt_affine_g2": [_VP, _VP, _VP, _VP, _INT, _VP],
    "lt_final_one": [_VP, _VP, _VP, _VP, _INT, _VP],
    "lt_g2_decompress": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP],
    "lt_hash_g2": [_VP, _VP, _VP, _VP, _INT, _VP],
    "lt_agg_pk": [_VP, _VP, _INT, _VP, _VP, _INT, _VP, _VP, _INT, _VP],
    "lt_g1_keyvalidate": [_VP, _VP, _VP, _VP, _INT, _VP],
    "lt_kv_launch_shape": [_VP],
    "lt_seg_sum_g1": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP, _VP],
    "lt_seg_sum_g2": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP, _VP],
    "lt_warp_last_launch": [ctypes.c_char_p, _VP],
    "lt_sha256_pairs": [_VP, _VP, _INT, _VP],
    "lt_sha256_sweep": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _VP],
    "lt_sha256_validators": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _VP],
    "lt_agg_last_launch": [_VP],
    "lt_span_update": [_VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _VP],
    "lt_span_update_many": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, ctypes.c_longlong, _VP],
    # host build only: the ingest building blocks and the pairing's
    # inversions and final exponentiation for the tests
    "lt_host_fp2_sqrt": [_VP, _VP, _VP, _INT],
    "lt_host_final_exp": [_VP, _VP, _INT],
    "lt_host_fp_inv_var": [_VP, _VP, _INT],
    "lt_host_fp_inv": [_VP, _VP, _INT],
    "lt_host_signs": [_VP, _VP, _INT],
    "lt_host_sswu": [_VP, _VP, _VP, _INT],
}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for sym, argtypes in _ARGTYPES.items():
        fn = getattr(lib, sym, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load_all() -> Dict[str, ctypes.CDLL]:
    """Every kernel's CUDA library, built (all sources) and loaded on the
    first call."""
    with _LOCK:
        if not _LIBS:
            for n, path in build_all().items():
                _LIBS[n] = _bind(ctypes.CDLL(str(path)))
        return _LIBS


def load(name: str) -> ctypes.CDLL:
    """The CUDA library of `csrc/<name>.cu`, built (all sources) on first use."""
    return load_all()[name]


def load_host(name: str) -> ctypes.CDLL:
    """The host build of `csrc/<name>.cu` (that source alone compiled)."""
    lib = _bind(ctypes.CDLL(str(build_host((name,))[name])))
    if hasattr(lib, "lt_host_fp_muls"):  # the field-arithmetic kernels
        lib.lt_host_fp_muls.argtypes = []
        lib.lt_host_fp_muls.restype = ctypes.c_uint64
    lib.lt_host_warp_order.argtypes = [_INT]  # virtual threads forwards (0) or reversed (1)
    lib.lt_host_warp_order.restype = None
    if hasattr(lib, "lt_host_rounds"):  # the warp-per-lane kernels
        for counter in (lib.lt_host_rounds, lib.lt_host_gcd_steps):
            counter.argtypes = []
            counter.restype = ctypes.c_uint64
    return lib
