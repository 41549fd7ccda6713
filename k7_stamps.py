#!/usr/bin/env python3
"""Phase stamps of the one-block-a-window K7b and one-block-a-problem K7a
(tpumap_torch/csrc/gmapchain.cu as of commit cc684f3, the design the
current K7a and K7b replaced), on one NVIDIA GPU: the record behind
PERF.md's phase stamps of those kernels. It patches that source only
and stops on any other.

Copies SRC (that gmapchain.cu, e.g. `git show cc684f3:tpumap_torch/csrc/
gmapchain.cu > old.cu`) with clock64() stamps at each phase's barrier,
builds it with nvcc under tpumap_torch/_build/k7_stamps/, and runs it at
the GMAP rows' shapes on inputs from tests/torch_workloads.py: K7b's
four phases (table clear and count, saturate and scan, ordered scatter,
read-out; cycles summed over the persistent blocks) and K7a's three
(rank, DP, backtrack and write-out; mean cycles a problem), each launch
checked against its plain version, with CUDA-event ms a launch.

Usage: python3 k7_stamps.py SRC
"""
import ctypes
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
sys.modules["jax"] = None           # the port runs without JAX

# (text of SRC, its stamped replacement), each applied once
PATCHES = [
    # K7a: stamps[problem][3]
    ("float frac, int32_t* __restrict__ out_diag,",
     "float frac, long long* __restrict__ stamps, "
     "int32_t* __restrict__ out_diag,"),
    ("  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n"
     "  int d = 0,",
     "  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;\n"
     "  const long long c0 = clock64();\n  int d = 0,"),
    ("    member[t] = 0;\n  }\n  __syncthreads();\n  for (int j = 0;",
     "    member[t] = 0;\n  }\n  __syncthreads();\n"
     "  const long long c1 = clock64();\n  for (int j = 0;"),
    ("  // the first best end, then the backtrack\n  {",
     "  const long long c2 = clock64();\n"
     "  // the first best end, then the backtrack\n  {"),
    ("    out_ok[ob + m] = false;\n  }\n}",
     "    out_ok[ob + m] = false;\n  }\n  __syncthreads();\n"
     "  if (t == 0) {\n    stamps[p * 3] = c1 - c0;\n"
     "    stamps[p * 3 + 1] = c2 - c1;\n"
     "    stamps[p * 3 + 2] = clock64() - c2;\n  }\n}"),
    # K7b: stamps[block][4], summed over the block's windows
    ("int32_t* __restrict__ scratch, int32_t* __restrict__ diag_out,",
     "int32_t* __restrict__ scratch, long long* __restrict__ stamps, "
     "int32_t* __restrict__ diag_out,"),
    ("  for (long long p = blockIdx.x; p < N; p += gridDim.x) {\n"
     "    const uint8_t* c = codes + p * R;",
     "  long long acc[4] = {0, 0, 0, 0};\n"
     "  for (long long p = blockIdx.x; p < N; p += gridDim.x) {\n"
     "    long long ck = clock64();\n    const uint8_t* c = codes + p * R;"),
    ("    __syncthreads();\n    // (2) saturate",
     "    __syncthreads();\n"
     "    { long long n = clock64(); acc[0] += n - ck; ck = n; }\n"
     "    // (2) saturate"),
    ("    __syncthreads();\n    // (3) each kept",
     "    __syncthreads();\n"
     "    { long long n = clock64(); acc[1] += n - ck; ck = n; }\n"
     "    // (3) each kept"),
    ("    __syncthreads();\n    // (4) the anchors",
     "    __syncthreads();\n"
     "    { long long n = clock64(); acc[2] += n - ck; ck = n; }\n"
     "    // (4) the anchors"),
    ("      ok_out[ob * max_occ + x] = ok;\n    }\n    __syncthreads();\n"
     "  }\n}",
     "      ok_out[ob * max_occ + x] = ok;\n    }\n    __syncthreads();\n"
     "    { long long n = clock64(); acc[3] += n - ck; }\n  }\n"
     "  if (threadIdx.x == 0)\n"
     "    for (int i = 0; i < 4; ++i) stamps[blockIdx.x * 4 + i] = acc[i];\n"
     "}"),
    # the entry points take the stamps
    ("int max_intron, float frac, void* out_diag,",
     "int max_intron, float frac, void* stamps, void* out_diag,"),
    ("S, M, max_intron, frac,\n      (int32_t*)out_diag",
     "S, M, max_intron, frac, (long long*)stamps,\n      (int32_t*)out_diag"),
    ("int G, int table_global, void* scratch,\n",
     "int G, int table_global, void* scratch, void* stamps,\n"),
    ("(int32_t*)scratch, (int32_t*)diag, (bool*)ok);",
     "(int32_t*)scratch, (long long*)stamps, (int32_t*)diag, (bool*)ok);"),
]


def build(src: pathlib.Path) -> ctypes.CDLL:
    from tpumap_torch import kernels
    text = src.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"{src}: not the expected source ({old[:40]!r})")
        text = text.replace(old, new)
    out = ROOT / "tpumap_torch" / "_build" / "k7_stamps"
    out.mkdir(parents=True, exist_ok=True)
    (out / "stamped.cu").write_text(text)
    lib = out / "libstamped.so"
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(out / "stamped.cu")], check=True)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.tt_region_anchors.argtypes = [P] * 4 + [I] * 8 + [P] * 5
    so.tt_chain_segments.argtypes = [P] * 5 + [I] * 4 + [F] + [P] * 6
    return so


def event_ms(fn, reps=10):
    import torch
    fn()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def k7b(lib, smi, label, N, R, Q, max_occ, keep, poly_a=False):
    import torch
    from tpumap_torch.ops import chain
    from torch_workloads import gmap_windows
    k = 8
    rng = np.random.default_rng(R + N)
    arrays = gmap_windows(rng, N, R, Q, k, poly_a=poly_a)
    rc, rv, qo, qv = (torch.from_numpy(a).cuda() for a in arrays)
    qo32 = qo.to(torch.int32)
    per_block = 4 * ((1 << 2 * k) + 1 + R)
    G = max(1, min(N, torch.cuda.get_device_properties(0)
                   .multi_processor_count, (1 << 30) // per_block))
    scratch = torch.empty(G * per_block // 4 + 1, dtype=torch.int32,
                          device="cuda")
    st = torch.zeros(G * 4, dtype=torch.int64, device="cuda")
    diag = torch.empty((N, Q, max_occ), dtype=torch.int32, device="cuda")
    ok = torch.empty((N, Q, max_occ), dtype=torch.bool, device="cuda")

    def run():
        if lib.tt_region_anchors(
                rc.data_ptr(), rv.data_ptr(), qo32.data_ptr(), qv.data_ptr(),
                N, R, Q, k, max_occ, int(keep), G, 0, scratch.data_ptr(),
                st.data_ptr(), diag.data_ptr(), ok.data_ptr(), None):
            raise SystemExit("K7b did not launch")
    ms = event_ms(run)
    want = chain.region_anchors_plain(rc, rv, qo, qv, k, max_occ, keep)
    if not (torch.equal(diag, want[0]) and torch.equal(ok, want[2])):
        raise SystemExit(f"K7b {label}: differs from its plain version")
    per = st.view(G, 4).double().sum(0)
    share = ", ".join(f"{x:.3f}" for x in (per / per.sum()).tolist())
    print(f"K7b {label}: N={N} Rp={R} Q={Q} max_occ={max_occ} keep={keep}: "
          f"{ms:.4f} ms a launch; phase shares (count + clear, saturate + "
          f"scan, ordered scatter, read-out): {share} [{smi}]", flush=True)


def k7a(lib, smi, label, N, S):
    import torch
    from tpumap_torch.ops import chain
    from torch_workloads import gmap_segments
    rng = np.random.default_rng(S + N)
    segs = {f: torch.from_numpy(v).cuda()
            for f, v in gmap_segments(rng, N, S).items()}
    M = min(S, 128)
    out = [torch.empty((N, M), dtype=torch.int32, device="cuda")
           for _ in range(3)]
    ok = torch.empty((N, M), dtype=torch.bool, device="cuda")
    st = torch.zeros(N * 3, dtype=torch.int64, device="cuda")

    def run():
        if lib.tt_chain_segments(
                *(segs[f].data_ptr() for f in ("diag", "qstart", "qend",
                                               "weight", "valid")),
                N, S, M, 500_000, ctypes.c_float(0.5), st.data_ptr(),
                *(o.data_ptr() for o in out), ok.data_ptr(), None):
            raise SystemExit("K7a did not launch")
    ms = event_ms(run)
    want = chain.chain_compact_plain(segs, M)
    if not all(torch.equal(a, b) for a, b in zip(out + [ok], want)):
        raise SystemExit(f"K7a {label}: differs from its plain version")
    s = st.view(N, 3).double().mean(0).tolist()
    print(f"K7a {label}: N={N} S={S}: {ms:.4f} ms a launch; cycles a "
          f"problem: rank {s[0]:.0f} ({s[0] / sum(s):.3f}), DP {s[1]:.0f} "
          f"({s[1] / sum(s):.3f}, {s[1] / S:.1f} a step), backtrack and "
          f"write-out {s[2]:.0f} ({s[2] / sum(s):.3f}) [{smi}]", flush=True)


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k7_stamps: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib = build(pathlib.Path(sys.argv[1]))
    k7b(lib, smi, "80-exon", 1, 131072, 8192, 8, False)
    k7b(lib, smi, "largest group", 1168, 16384, 2048, 8, False)
    k7b(lib, smi, "widest", 66, 262144, 2048, 8, False)
    k7b(lib, smi, "poly-A, keep", 64, 32768, 512, 128, True, poly_a=True)
    k7a(lib, smi, "largest group", 1168, 128)
    k7a(lib, smi, "80-exon", 1, 512)


if __name__ == "__main__":
    main()
