"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc for sm_90a, one nvcc
process per source run side by side, and linked into one shared library
with a plain C interface, under tpumap_torch/_build/ keyed by a hash of
the sources (nvcc's -Xptxas -v report beside it in build.log, read back
into `build_log` when the library is cached), and loaded with ctypes. Each C entry
point launches on the stream it is given and returns cudaGetLastError();
`launch` raises if that is not 0. There is no fallback: a missing nvcc
or a failed build raises.

LAUNCHES counts, per kernel, the launches made through `launch` — the
proof that a run went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_SRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent / "_build"
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the three window scans share one argument list (csrc/localscan.cu)
_SCAN_ARGS = [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]

# C entry point and argument types of each kernel before the stream
# (tensors are passed as pointers)
_ENTRY = {
    "verify_diagonals": ("tt_verify_diagonals",
                         [_P, _L, _P, _L, _P, _L, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _P]),
    "banded_align": ("tt_banded_align",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _P, _P, _P, _P]),
    "traceback": ("tt_traceback",
                  [_P, _P, _P, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P]),
    "chain_dp": ("tt_chain_dp",
                 [_P] * 7 + [_I] * 3 + [_I] * 7 + [_L, _L] + [_I] * 4
                 + [_P] * 8),
    "scan_fragment": ("tt_scan_fragment", _SCAN_ARGS),
    "scan_exact_sites": ("tt_scan_exact_sites", _SCAN_ARGS),
    "scan_fragment_runs": ("tt_scan_fragment_runs", _SCAN_ARGS),
    "chain_segments": ("tt_chain_segments",
                       [_P] * 5 + [_I] * 4 + [_F, _P, _I] + [_P] * 4),
    "region_anchors": ("tt_region_anchors",
                       [_P] * 4 + [_I] * 9 + [_P] * 8),
}

LAUNCHES = {name: 0 for name in _ENTRY}
_lib = None
build_log = ""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def n_sms(device) -> int:
    """The card's streaming multiprocessors (persistent grids)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> ctypes.CDLL:
    """Compile (if the source hash is new) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    srcs = sorted(_SRC.glob("*.cu"))
    h = hashlib.sha256()
    for s in srcs + sorted(_SRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = _BUILD / h.hexdigest()[:16] / "libtpumap_torch_kernels.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        nvcc = _nvcc()
        flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC"]
        # one nvcc per source, all at once, then one link
        objs = [out.parent / f"{s.stem}.{tag}.o" for s in srcs]
        procs = [subprocess.Popen(
            [nvcc] + flags + ["-Xptxas", "-v", "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [s.name for s, p in zip(srcs, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = out.with_suffix(f".{tag}.tmp")
        r = subprocess.run([nvcc] + flags + ["-shared", "-o", str(tmp)]
                           + [str(o) for o in objs],
                           capture_output=True, text=True)
        build_log += r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{build_log}")
        out.with_name("build.log").write_text(build_log)
        os.replace(tmp, out)
        for o in objs:
            o.unlink()
    else:
        log = out.with_name("build.log")
        build_log = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(out))
    for name, (sym, argtypes) in _ENTRY.items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes + [_P]       # the stream
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check_args(name: str, device: torch.device, *specs) -> None:
    """Each spec is (tensor, dtype, shape or None): raise unless the
    tensor lies on `device`, has the dtype and shape, and is contiguous."""
    for i, (t, dtype, shape) in enumerate(specs):
        if t.device != device:
            raise ValueError(f"{name}: argument {i} on {t.device}, "
                             f"expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, "
                            f"expected {dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: argument {i} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel `name` on the current stream of `device`; tensors pass
    as pointers. Raises on a launch error."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor")
    fn = getattr(build(), _ENTRY[name][0])
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
             for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1
