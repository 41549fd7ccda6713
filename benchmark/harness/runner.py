"""One run of a cell: set-up, the window, the comparison, the result."""
from __future__ import annotations

import contextlib
import gc
import subprocess
import time

from harness import dbcache, genome, manifest, trace, traffic, window
from harness.window import Aligner, ChunkSource, Sink, Spans

HERE = manifest.HERE
# the traced run's device window at most: its profile of the card is read
# within the run's time limit at this length
TRACE_WINDOW_S = 12.0


def _batch(cfg, mix) -> int:
    return cfg["pair_batch_size"] if "pairs" in mix else cfg["batch_size"]


def block_size(cfg) -> int:
    return cfg.get("reads_per_block", traffic.BLOCK)


def blocks_per_chunk(cfg, mix) -> int:
    return cfg["batches_per_chunk"] * _batch(cfg, mix) // block_size(cfg)


def _power_limit():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _span_targets(readers, spans):
    out = []
    for name, mod in readers.items():
        for modname, attr in getattr(mod, "SPANS", ()):
            out.append((modname, attr,
                        lambda old, n=name: spans.wrap(n, old)))
    return out


def _faulty(aligner, sink_fault):
    """The aligner with each SAM text passed through sink_fault on its
    way to the sink (a planted fault, for tests)."""
    if sink_fault is None:
        return aligner

    def drive(t1, t2, sink):
        return aligner(t1, t2, lambda b: sink(sink_fault(b)))
    return drive


def _log_window(log, what, res):
    cs = sorted(res["chunk_s"])
    wait = res["run_delay_s"]
    log(f"{what}: {res['reads']} reads in {res['seconds']:.3f} s "
        f"({res['reads'] / res['seconds']:.1f} a s), {len(res['chunks'])} "
        f"chunks (s each: least {cs[0]:.3f}, median {cs[len(cs) // 2]:.3f}, "
        f"most {cs[-1]:.3f}), {res['sam_bytes']} SAM bytes; main thread "
        f"{res['cpu_s']:.3f} CPU s, "
        + (f"{wait:.3f} s waiting for a core" if wait is not None
           else "its wait for a core unread"))


def run(root, cell, seed: int, seconds: float, traced: bool, device, log,
        t_start: float | None = None, sink_fault=None):
    """(result, checks) of one run. sink_fault, for tests: a function
    that each SAM text passes through before the sink (a planted
    fault).

    The traced run has two windows after the set-up: the host window
    (`seconds`), where the spans of the per-layer metrics are taken on
    the host's clock alone, and the device window (at most
    TRACE_WINDOW_S), profiled for the card's activity alone, where the
    hand kernels' launches are kept for their work; no profiler runs in
    the host window and no wrapper's device op runs in either."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix = cell["config"], cell["traffic"]
    pairs = "pairs" in mix
    bpc = blocks_per_chunk(cfg, mix)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (
        lambda: None)
    readers = {m["name"]: manifest.metric_reader(m["name"])
               for m in cell["per_layer"]} if traced else {}
    source = ChunkSource(HERE / "harness" / "producer.py",
                         cell["config_path"], cell["traffic_path"], seed, bpc,
                         block_size(cfg))
    launches = trace.Launches()
    dev = None
    try:
        db, built = dbcache.load_or_build(root, HERE / ".cache", cfg, log)
        log(f"index {'built' if built else 'loaded'}")
        from tpumap_torch.index.device import DeviceIndex
        index = DeviceIndex.from_host(db, device)
        core = Aligner(cfg, mix, db, index)
        drive = _faulty(core, sink_fault)
        t1, t2 = source.get()
        drive(t1, t2, Sink())               # warm-up: chunk 0
        sync()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.2f} s; window of {seconds} s")
        host_spans = Spans() if traced else None
        core.spans = host_spans
        with window.patched(_span_targets(readers, host_spans)
                            if traced else []):
            res = window.run_window(source, drive, seconds, seed,
                                    host_spans, sync)
        _log_window(log, "window", res)
        kept = dict(res["kept"])
        dres = None
        if traced:
            dev_spans = Spans(intervals=True)
            core.spans = dev_spans
            targets = _span_targets(readers, dev_spans)
            if cuda:
                targets.append(("tpumap_torch.kernels", "launch",
                                launches.wrap))
            with window.patched(targets), contextlib.ExitStack() as stack:
                prof = None
                if cuda:
                    prof = stack.enter_context(torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]))
                    sync()
                    mark = time.perf_counter_ns()
                    torch.zeros(1, device=device)        # the marker
                    sync()
                w0 = time.perf_counter_ns()
                dres = window.run_window(source, drive,
                                         min(seconds, TRACE_WINDOW_S), seed,
                                         dev_spans, sync)
                w1 = time.perf_counter_ns()
            _log_window(log, "device window (profiled)", dres)
            kept.update(dres["kept"])
            if prof is not None:
                t0 = time.perf_counter()
                dev = trace.analyse(prof, trace.hand_kernel_symbols(root),
                                    mark, w0, w1, dev_spans.intervals)
                del prof
                log(f"trace read in {time.perf_counter() - t0:.1f} s: "
                    f"{dev['n_device_events']} device ops "
                    f"({dev['n_outside']} past the window's edges; marker "
                    f"{dev['marker']!r}), {len(launches.calls)} hand-kernel "
                    f"launches")
    finally:
        source.close()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda
                else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    per_batch = 2 * _batch(cfg, mix) if pairs else _batch(cfg, mix)
    metrics = {}
    breakdown = None
    attempted = res["reads"]
    if traced:
        attempted += dres["reads"]
        bound = None
        if dev is not None:
            bound = launches.bound_s()
            dev_info["busy_s"] = dev["busy_s"]
            dev_info["window_s"] = dev["window_s"]
            breakdown = {"device_ops": dev["device_ops"],
                         "idle_gaps": dev["idle_gaps"]}
        readings = trace.Readings(host_spans, res["reads"] / per_batch, dev,
                                  bound, dres["reads"] / per_batch,
                                  res["seconds"])
        for m in cell["per_layer"]:
            v = readers[m["name"]].read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"reads_per_s": res["reads"] / res["seconds"],
                  "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    launches.calls.clear()
    del core, drive, index, db
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        dev_info["power_limit_w"] = _power_limit()
    numbers = compare(cell, kept, seed, device, log)
    limits = cell["limits"]
    checks = {k: (numbers[k], limits[k]) for k in limits}
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": attempted,
              "failed": numbers["bad_records"], "metrics": metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks


def compare(cell, kept: dict, seed: int, device, log,
            control: bool = False) -> dict:
    """The comparison's numbers over blocks drawn from the seed among the
    kept chunks ({chunk: its SAM text}): the program's text, or with
    control=True the control's (reference/control.py) for those blocks
    in the program's place."""
    import torch
    from reference import judge
    from reference.control import control_sam
    t0 = time.perf_counter()
    cfg, mix = cell["config"], cell["traffic"]
    pairs = "pairs" in mix
    bpc = blocks_per_chunk(cfg, mix)
    spec = genome.genome_spec(cfg)
    codes = genome.genome_codes(spec)
    genes = genome.gene_table(spec)
    picks = window.sample_blocks(seed, kept, bpc)
    blocks = [traffic.make_block(codes, genes, mix, seed, b,
                                 n=block_size(cfg)) for b in picks]
    genome_t = torch.from_numpy(codes).to(device)
    contig = cfg["contig"].encode()
    if control:
        texts = [control_sam(codes, genome_t, contig, blocks, pairs,
                             cfg["k"], cfg["interval"], cfg["pairmax"])]
    else:
        texts = [kept[c] for c in sorted({b // bpc for b in picks})]
    out = judge.judge(codes, genome_t, contig, blocks, texts, pairs,
                      cfg["k"], cfg["interval"], cfg["pairmax"])
    del genome_t
    log(f"comparison over blocks {picks} in {time.perf_counter() - t0:.1f}"
        f" s: {out['sample']} reads, bad {out['bad_records']}, worse "
        f"{out['worse_share']:.6f}")
    for p in out["problems"]:
        log(f"  {p}")
    for p in out["worse_examples"]:
        log(f"  worse: {p}")
    return out
