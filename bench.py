"""Benchmark harness — BASELINE.json workloads on real hardware.

Prints ONE JSON line to stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline: two-table equi-join throughput at the reference's own shape —
100M x 100M rows with NON-UNIQUE keys (BASELINE config 3; reference claim
62.5M rows/s on GPU, README.md:325 — rows counted as left+right like the
reference).  Details for all configs go to stderr and bench_results.json,
including the achieved effective scan bandwidth and its fraction of the
per-chip HBM roofline (BASELINE >=80% target).

Crash isolation: every workload runs in its OWN subprocess, one at a time,
and the parent never imports JAX — so exactly one process holds the card.
A crash or OOM kills one config and the parent continues with the rest.
bench_results.json is MERGED with the previous run — a failed config keeps
its last good number (marked stale) instead of erasing it.

Capture guarantees (`timeout` kills with SIGTERM):
  * bench_results.json is rewritten after EVERY config, not at exit;
  * headline configs (join, groupby) run FIRST; the soft budget defaults
    to 1500 s and later configs are skipped over budget;
  * SIGTERM/SIGINT land in a handler that kills the in-flight child,
    writes merged results, and still prints the headline JSON line
    (falling back to the newest stale number if nothing fresh landed).

Every result records the device it ran on (``device_kind``), the card's
``nvidia-smi`` name and power limit, and the peak bandwidth its roofline
shares divide by (None on the CPU: "not measured").

Usage:  python bench.py [--quick] [--only NAME] [--scale F] [--xl]
        [--child NAME]   (internal)
        --xl adds the 1B-row out-of-core streamed GROUP BY (reference
        README.md:332-334 workload; needs ~20 GB disk for the parquet).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RESULT_SENTINEL = "##BENCH_CHILD_RESULT##"

BASELINES = {
    # reference-published GPU numbers (BASELINE.md)
    "join": 62.5e6,          # rows/s, inner join 100Mx100M (l+r rows / time)
    "join_lookup": 62.5e6,   # rows/s, asymmetric unique-build lookup shape
    "groupby": 526e6,        # rows/s, GROUP BY (reference: 1B rows)
    "groupby_1b": 526e6,     # rows/s, the literal 1B-row streamed workload
    "filter_agg": 526e6,     # closest published analogue
    "sortmerge": 48.8e6,     # rows/s sort-merge join
}

# RUN order == HEADLINE order (round-3 lesson): the driver's window may not
# fit all configs, so the configs we most want on the official record (honest
# join, groupby) go FIRST — their compile caches are the ones kept warm
# during development, and a budget skip then only costs the minor configs.
HEADLINE_ORDER = ["join", "groupby", "filter_agg", "sortmerge", "join_lookup"]
# groupby_1b (the reference's literal flagship workload) is in the DEFAULT
# plan as of round 5 (VERDICT r4 #1/#8): it runs last — a budget skip or
# failure is then recorded in statuses instead of silently vanishing.
CONFIG_ORDER = list(HEADLINE_ORDER) + ["groupby_1b"]

REPO = os.path.dirname(os.path.abspath(__file__))


# ======================================================================
# child-side workload implementations (one subprocess each)
# ======================================================================

def _engine(batch_rows: int, join_expansion: float = 1.25):
    import numpy as np  # noqa: F401

    from gpu_olap_tpu import EngineConfig, OlapEngine

    cfg = EngineConfig(
        backend="device",
        join_expansion=join_expansion,
        max_groups=1 << 23,
        min_shape_bucket=1 << 16,
        enable_cache=False,  # measure execution, not the result cache
    )
    return OlapEngine(cfg)


def _time_query(eng, sql: str, iters: int = 3):
    from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS

    eng.query(sql)  # warm: compile + device upload
    best = float("inf")
    best_exec = float("inf")
    bytes_exec = 0
    for _ in range(iters):
        st = GLOBAL_METRICS.ops.get("device_execute")
        s0 = st.seconds if st else 0.0
        b0 = st.bytes_accessed if st else 0
        t0 = time.perf_counter()
        r = eng.query(sql)
        dt = time.perf_counter() - t0
        best = min(best, dt)
        st = GLOBAL_METRICS.ops.get("device_execute")
        if st is not None and st.seconds > s0:
            # device-program wall time, sans host parse/plan + result pull
            best_exec = min(best_exec, st.seconds - s0)
            bytes_exec = st.bytes_accessed - b0
    return best, r, (best_exec if best_exec < float("inf") else None), bytes_exec


def _roofline(res: dict, model_bytes: int = 0, model: str = ""):
    """Bandwidth accounting for the device program (VERDICT r3 #4a).

    Two figures, both divided by device-program wall seconds:

    * ``scan_gbps`` / ``scan_roofline_frac`` — table input bytes counted
      ONCE (the old conservative floor; kept for history comparability);
    * ``sol_gbps`` / ``sol_frac`` — a per-config SPEED-OF-LIGHT bytes model
      (``model`` documents it): the minimum HBM traffic the query's answer
      requires (each input byte read once, each output byte written once).
      ``sol_frac`` says how far the whole pipeline is from a single-pass
      streaming kernel; the gap is the price of the sort-based design
      (lax.sort moves every operand through every merge pass — XLA-internal
      traffic we can't meter).

    Also records rows_per_sec_device (rows / device-program seconds), which
    leaves out parse/plan and the result pull.  Roofline shares are None on
    the CPU backend (no device peak: "not measured")."""
    from gpu_olap_tpu.utils.metrics import GLOBAL_METRICS

    peak = GLOBAL_METRICS.hbm_bandwidth
    ex = res.get("exec_seconds")
    by = res.get("exec_bytes", 0)
    if ex and by:
        res["scan_gbps"] = by / ex / 1e9
        res["scan_roofline_frac"] = None if peak is None else by / ex / peak
    if ex and model_bytes:
        res["sol_model"] = model
        res["sol_gbps"] = model_bytes / ex / 1e9
        res["sol_frac"] = None if peak is None else model_bytes / ex / peak
    if ex and res.get("rows"):
        res["rows_per_sec_device"] = round(res["rows"] / ex, 1)
    return res


def bench_filter_agg(n_rows: int, iters: int):
    """Config 1: scan + filter (x > c) + COUNT/SUM on int64."""
    import numpy as np

    eng = _engine(n_rows)
    rng = np.random.default_rng(0)
    eng.register("t", {
        "k": rng.integers(0, 1 << 20, n_rows).astype(np.int64),
        "v": rng.integers(0, 1000, n_rows).astype(np.int64),
    })
    sql = "SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE v > 500"
    dt, r, ex, by = _time_query(eng, sql, iters)
    return _roofline({"seconds": dt, "exec_seconds": ex, "exec_bytes": by,
                      "rows": n_rows, "rows_per_sec": n_rows / dt,
                      "result_rows": r.num_rows},
                     model_bytes=n_rows * 4,
                     model="4B/row: int32 shadow of v read once "
                           "(value aliases the filter column)")


def bench_groupby(n_rows: int, n_groups: int, iters: int):
    """Config 2: high-cardinality GROUP BY SUM/MIN/MAX."""
    import numpy as np

    eng = _engine(n_rows)
    rng = np.random.default_rng(1)
    eng.register("t", {
        "k": rng.integers(0, n_groups, n_rows).astype(np.int64),
        "v": rng.integers(0, 1_000_000, n_rows).astype(np.int64),
    })
    sql = "SELECT k, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx FROM t GROUP BY k"
    dt, r, ex, by = _time_query(eng, sql, iters)
    return _roofline({"seconds": dt, "exec_seconds": ex, "exec_bytes": by,
                      "rows": n_rows, "rows_per_sec": n_rows / dt,
                      "groups": r.num_rows},
                     model_bytes=n_rows * 8 + n_groups * 24,
                     model="8B/row: int32 shadows of (k, v) read once + "
                           "24B/group written once")


def bench_groupby_1b(n_rows: int, n_groups: int, iters: int):
    """The reference's literal GROUP BY workload (README.md:332-334): 1B rows.

    Larger than HBM (1B x 2 int64 columns + sort buffers) — runs through the
    out-of-core streamed partial-aggregation path from a parquet file, so the
    measured rate is host->device-link-bound, not compute-bound.  The
    device-compute rate is reported separately by the 100M in-memory config.
    """
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    default_path = os.path.join(REPO, ".data", f"gpu_olap_{n_rows}.parquet")
    path = os.environ.get("GPU_OLAP_1B_PARQUET", default_path)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        print(f"# writing {n_rows} rows to {path} ...", file=sys.stderr)
        rng = np.random.default_rng(42)
        chunk = 50_000_000
        writer = None
        for lo in range(0, n_rows, chunk):
            m = min(chunk, n_rows - lo)
            t = pa.table({
                "k": rng.integers(0, n_groups, m),
                "v": rng.integers(0, 1_000_000, m),
            })
            if writer is None:
                writer = pq.ParquetWriter(path, t.schema)
            writer.write_table(t)
        writer.close()
    eng = _engine(1 << 26)
    # chunk size, feed depth and state partition size were picked for the
    # previous accelerator's compiler and link; not yet tuned on the H100
    eng.config.batch_size = int(os.environ.get(
        "GPU_OLAP_1B_BATCH", min(1 << 21, max(n_rows // 8, 1 << 20))))
    eng.config.num_feed_buffers = int(os.environ.get("GPU_OLAP_1B_FEED", 2))
    # per-partition streamed-state threshold (states above HALF this size
    # hash-split; see executor/streaming.py)
    eng.config.stream_state_partition_groups = int(os.environ.get(
        "GPU_OLAP_1B_PART", 1 << 20))
    # always exercise the out-of-core streamed path, even at --quick sizes
    eng.catalog._cache_threshold = min(eng.catalog.cache_threshold,
                                       max(n_rows // 4, 1))
    eng.load_table("t", path)
    sql = "SELECT k, SUM(v) AS s, MIN(v) AS mn, MAX(v) AS mx FROM t GROUP BY k"
    t0 = time.perf_counter()
    r = eng.query(sql)
    dt = time.perf_counter() - t0
    best = dt
    for _ in range(max(iters - 1, 0)):
        t0 = time.perf_counter()
        r = eng.query(sql)
        best = min(best, time.perf_counter() - t0)
    out = {"seconds": best, "rows": n_rows, "rows_per_sec": n_rows / best,
           "groups": r.num_rows, "backend": r.meta.get("backend")}
    sa = getattr(eng._get_device_executor(), "_streaming", None)
    if sa is not None:
        # round-5 hash-partitioned streamed state (the >2M-group compile fix)
        out["hash_state_parts"] = sa.last_hash_parts
        out["stream_chunks"] = sa.last_stream_chunks
        out["h2d_bytes"] = sa.last_link_bytes
        out["compile_seconds"] = getattr(sa, "last_compile_seconds", None)
        out["stream_seconds"] = getattr(sa, "last_stream_seconds", None)
        if getattr(sa, "last_stream_seconds", 0):
            # the streaming window rate: host parquet read + hash split +
            # link upload + device steps, compile and result pull excluded
            out["rows_per_sec_stream"] = round(
                n_rows / sa.last_stream_seconds, 1)
        if sa.last_link_bytes:
            out["h2d_gbps_effective"] = round(
                sa.last_link_bytes / best / 1e9, 3)
    return out


def bench_join(n_left: int, n_right: int, iters: int):
    """Config 3 HONEST shape: 100M x 100M, NON-UNIQUE keys on both sides
    (key space = n_right / 2, ~2 duplicates per build key) — defeats the
    unique-build lookup fast path, so the general merge-probe (radix-hash
    analogue) executes.  Rows/s counts l+r like the reference README.md:325."""
    import numpy as np

    # 2.0x expected match expansion (2 dups/build key) + padding headroom;
    # round-2's 2.6x over-allocated the match buffer at the 100M shape
    eng = _engine(max(n_left, n_right), join_expansion=2.2)
    rng = np.random.default_rng(2)
    nkeys = max(n_right // 2, 1)
    eng.register("l", {"k": rng.integers(0, nkeys, n_left).astype(np.int64)})
    eng.register("r", {"k": rng.integers(0, nkeys, n_right).astype(np.int64)})
    # SUM over BOTH sides forces true pair materialization (the group-join
    # rewrite only covers probe-side arguments); summing the keys themselves
    # keeps the two 100M-row tables single-column so the ~2x-expansion match
    # buffers + sort ping-pongs fit HBM at the reference's full shape
    sql = "SELECT COUNT(*) AS n, SUM(l.k + r.k) AS s FROM l JOIN r ON l.k = r.k"
    dt, r, ex, by = _time_query(eng, sql, iters)
    total_rows = n_left + n_right
    return _roofline({"seconds": dt, "exec_seconds": ex, "exec_bytes": by,
                      "rows": total_rows, "rows_per_sec": total_rows / dt,
                      "matches": int(r.to_pydict()["n"][0])},
                     model_bytes=total_rows * 4,
                     model="4B/row: int32 shadows of both key columns "
                           "read once (COUNT/SUM answer needs no output "
                           "materialization)")


def bench_join_lookup(n_left: int, n_right: int, iters: int):
    """Asymmetric unique-build shape (persistent dense-index lookup join):
    kept alongside the honest config to track the fast path."""
    import numpy as np

    eng = _engine(max(n_left, n_right))
    rng = np.random.default_rng(2)
    lk = rng.integers(0, n_right, n_left).astype(np.int64)
    eng.register("l", {"k": lk, "v": rng.integers(0, 1000, n_left).astype(np.int64)})
    eng.register("r", {"k": np.arange(n_right, dtype=np.int64),
                       "w": rng.integers(0, 1000, n_right).astype(np.int64)})
    sql = "SELECT COUNT(*) AS n, SUM(l.v + r.w) AS s FROM l JOIN r ON l.k = r.k"
    dt, r, ex, by = _time_query(eng, sql, iters)
    total_rows = n_left + n_right
    return _roofline({"seconds": dt, "exec_seconds": ex, "exec_bytes": by,
                      "rows": total_rows, "rows_per_sec": total_rows / dt,
                      "matches": int(r.to_pydict()["n"][0])},
                     model_bytes=n_left * 8 + n_right * 8,
                     model="8B/row: (k, v) / (k, w) int32 shadows read once")


def bench_sortmerge(n_left: int, n_right: int, iters: int):
    """Config 4: duplicate-heavy keys (stress the merge/expansion path)."""
    import numpy as np

    eng = _engine(max(n_left, n_right), join_expansion=2.5)
    rng = np.random.default_rng(3)
    # ~4 duplicates per build key (match count ~= 4x probe rows)
    nkeys = max(n_right // 4, 1)
    eng.register("l", {"k": rng.integers(0, nkeys, n_left).astype(np.int64)})
    eng.register("r", {"k": rng.integers(0, nkeys, n_right).astype(np.int64)})
    sql = "SELECT COUNT(*) AS n FROM l JOIN r ON l.k = r.k"
    dt, r, ex, by = _time_query(eng, sql, iters)
    total_rows = n_left + n_right
    return _roofline({"seconds": dt, "exec_seconds": ex, "exec_bytes": by,
                      "rows": total_rows, "rows_per_sec": total_rows / dt,
                      "matches": int(r.to_pydict()["n"][0])},
                     model_bytes=total_rows * 4,
                     model="4B/row: int32 shadows of both key columns "
                           "read once")


def bench_micro(iters: int = 2000):
    """Frontend micro-benchmarks — parse/optimize parity with the reference's
    criterion benches (benches/engine_bench.rs:8-43)."""
    from gpu_olap_tpu.plan.optimizer import optimize
    from gpu_olap_tpu.sql.parser import parse_sql

    simple = "SELECT a, b, c FROM sales WHERE revenue > 1000"
    complex_join = ("SELECT o.id, c.name, sum(o.amount) FROM orders o "
                    "JOIN customers c ON o.cust_id = c.id "
                    "WHERE o.amount > 100 GROUP BY o.id, c.name "
                    "ORDER BY o.id LIMIT 50")
    out = {}
    for name, sql in [("parse_simple_select", simple),
                      ("parse_complex_join", complex_join)]:
        t0 = time.perf_counter()
        for _ in range(iters):
            parse_sql(sql)
        out[name] = (time.perf_counter() - t0) / iters * 1e6  # us
    plan = parse_sql("SELECT a FROM t WHERE a > 10")
    t0 = time.perf_counter()
    for _ in range(iters):
        optimize(plan)
    out["optimize_simple"] = (time.perf_counter() - t0) / iters * 1e6
    return out


# ======================================================================
# parent-side orchestration
# ======================================================================

class _Interrupted(Exception):
    """Raised from the SIGTERM/SIGINT handler so the parent can still write
    merged results and print the headline line before dying (round-3 lesson:
    the driver kills with `timeout`, and a silent death records nothing)."""


def _install_signal_handlers():
    import signal

    def _handler(signum, frame):  # noqa: ARG001
        raise _Interrupted(f"signal {signum}")

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _handler)
        except (ValueError, OSError):
            pass


def _run_child(name: str, args, timeout=None):
    """Run one workload in a fresh subprocess; returns (result|None, status).
    stderr is passed through; the result rides a sentinel line on stdout.
    The child runs in its own process group so a timeout or parent SIGTERM
    reliably kills the process tree that holds the card."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", name,
           "--iters", str(args.iters), "--scale", str(args.scale)]
    if args.quick:
        cmd.append("--quick")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=None,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout or args.child_timeout)
    except subprocess.TimeoutExpired:
        _kill_child(proc)
        return None, "timeout"
    except BaseException:  # _Interrupted / KeyboardInterrupt
        _kill_child(proc)
        raise
    result = None
    for line in out.decode(errors="replace").splitlines():
        if line.startswith(RESULT_SENTINEL):
            try:
                result = json.loads(line[len(RESULT_SENTINEL):])
            except json.JSONDecodeError:
                pass
    if proc.returncode != 0:
        return None, f"exit_{proc.returncode}"
    if result is None:
        return None, "no_result"
    if "error" in result:
        return None, result["error"]
    return result, "ok"


def _kill_child(proc):
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.kill()
        except OSError:
            pass
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        pass


def _child_main(name: str, args):
    """Child entry: run ONE workload, emit its result on a sentinel line."""
    if os.environ.get("GPU_OLAP_LOG"):
        import logging

        logging.basicConfig(
            level=getattr(logging, os.environ["GPU_OLAP_LOG"].upper(),
                          logging.INFO),
            format="%(asctime)s %(name)s: %(message)s")
    if args.quick:
        sizes = {"filter_agg": 1 << 20, "groupby": (1 << 20, 1 << 14),
                 "join": (1 << 20, 1 << 20), "join_lookup": (1 << 20, 1 << 17),
                 "sortmerge": (1 << 19, 1 << 17),
                 "groupby_1b": (1 << 22, 1 << 14)}
    else:
        s = args.scale
        sizes = {
            "filter_agg": int(200e6 * s),
            "groupby": (int(100e6 * s), int(4e6 * s)),
            "join": (int(100e6 * s), int(100e6 * s)),
            "join_lookup": (int(100e6 * s), int(10e6 * s)),
            "sortmerge": (int(25e6 * s), int(25e6 * s)),
            "groupby_1b": (int(1e9 * s), int(4e6 * s)),
        }
    fns = {
        "join": lambda: bench_join(*sizes["join"], args.iters),
        "groupby": lambda: bench_groupby(*sizes["groupby"], args.iters),
        "filter_agg": lambda: bench_filter_agg(sizes["filter_agg"], args.iters),
        "sortmerge": lambda: bench_sortmerge(*sizes["sortmerge"], args.iters),
        "join_lookup": lambda: bench_join_lookup(*sizes["join_lookup"],
                                                 args.iters),
        "groupby_1b": lambda: bench_groupby_1b(*sizes["groupby_1b"], 1),
    }
    try:
        res = fns[name]()
        import jax

        from gpu_olap_tpu.utils.metrics import (
            GLOBAL_METRICS, gpu_name_and_power_limit)

        dev = jax.devices()[0]
        res["device"] = str(dev)
        res["device_kind"] = dev.device_kind
        res["nvidia_smi"] = gpu_name_and_power_limit()
        res["hbm_roofline_bytes_per_sec"] = GLOBAL_METRICS.hbm_bandwidth
    except Exception as e:  # noqa: BLE001 — reported to the parent
        res = {"error": f"{type(e).__name__}: {e}"}
    print(RESULT_SENTINEL + json.dumps(res, default=str), flush=True)


def _merge_results(new_results: dict, statuses: dict, path: str):
    """Merge into the results file keeping last good numbers for configs
    that failed THIS run (marked stale) — never clobber history with {}."""
    prev = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                prev = json.load(f).get("results", {})
        except (json.JSONDecodeError, OSError):
            prev = {}
    merged = {}
    for name in set(prev) | set(new_results):
        if name in new_results:
            merged[name] = {k: v for k, v in new_results[name].items()
                            if k != "stale"}
        elif name in statuses:
            # planned THIS run but produced nothing: keep the last good
            # number, marked stale
            merged[name] = dict(prev[name])
            merged[name]["stale"] = True
            merged[name]["last_failure"] = statuses[name]
        else:
            # not part of this run (e.g. --only): carry through untouched —
            # a failed single-config run must not stale-mark the others
            merged[name] = dict(prev[name])
    return merged


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small sizes (smoke)")
    ap.add_argument("--micro", action="store_true",
                    help="parse/optimize micro-benches only (engine_bench.rs)")
    ap.add_argument("--xl", action="store_true",
                    help="also run the 1B-row streamed GROUP BY workload")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale factor on row counts")
    ap.add_argument("--budget", type=float, default=1500.0,
                    help="soft time budget (seconds); later configs skipped "
                         "— sized for the driver's window, raise for full "
                         "cold-cache campaigns")
    ap.add_argument("--only", type=str, default=None,
                    help="run a single named config (still subprocess-isolated)")
    ap.add_argument("--child", type=str, default=None, help="(internal)")
    ap.add_argument("--child-timeout", type=float, default=3300.0,
                    help="per-config subprocess timeout (seconds)")
    args = ap.parse_args()

    if args.child:
        _child_main(args.child, args)
        return

    if args.micro:
        micro = bench_micro()
        for k, v in micro.items():
            print(f"# {k}: {v:.1f} us", file=sys.stderr)
        print(json.dumps({"metric": "parse_simple_select_us",
                          "value": round(micro["parse_simple_select"], 2),
                          "unit": "us", "vs_baseline": 1.0}))
        return

    t0 = time.time()
    _install_signal_handlers()

    def remaining():
        return args.budget - (time.time() - t0)

    # ---- workloads, each in its own subprocess ------------------------
    plan = list(CONFIG_ORDER)  # --xl kept for compat; 1B is in the default plan
    if args.only:
        plan = [args.only]

    # quick/scaled runs keep their own history file so a full-scale failure
    # never falls back to a small-scale number (and vice versa)
    out_path = ("bench_results_quick.json" if args.quick or args.scale != 1.0
                else "bench_results.json")

    results, statuses = {}, {}

    def write_results():
        merged = _merge_results(results, statuses, out_path)
        device = next((r.get("device") for r in results.values()
                       if r.get("device")), None)
        if device is None:
            device = next((r.get("device") for r in merged.values()
                           if r.get("device")), "unknown")
        hbm = next((r.get("hbm_roofline_bytes_per_sec")
                    for r in list(results.values()) + list(merged.values())
                    if r.get("hbm_roofline_bytes_per_sec")), None)
        payload = {"device": device, "total_seconds": time.time() - t0,
                   "hbm_roofline_bytes_per_sec": hbm,
                   "scale": args.scale, "quick": args.quick,
                   "statuses": statuses,
                   "results": merged}
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        return merged

    merged = {}
    try:
        for name in plan:
            if remaining() < 120.0:
                print(f"# skipping {name}: over time budget", file=sys.stderr)
                statuses[name] = "skipped_budget"
                continue
            res, status = _run_child(
                name, args,
                timeout=min(args.child_timeout, remaining() + 60.0))
            statuses[name] = status
            if res is not None:
                res["vs_baseline"] = res["rows_per_sec"] / BASELINES[name]
                results[name] = res
                print(f"# {name}: {res}", file=sys.stderr)
            else:
                print(f"# {name} FAILED: {status}", file=sys.stderr)
            merged = write_results()  # land every number the moment it exists
    except _Interrupted as e:
        print(f"# interrupted ({e}) — flushing results", file=sys.stderr)
        statuses["_interrupted"] = str(e)
    finally:
        merged = write_results()
        print(f"# full results -> {out_path}", file=sys.stderr)
        _print_headline(results, merged, args)


def _print_headline(results, merged, args):
    """The ONE driver-visible JSON line.  Prefer a fresh number in headline
    order; fall back to the newest merged (stale) number rather than printing
    nothing — an official record marked stale beats an empty record."""
    pick, headline, stale = None, None, False
    for cand in HEADLINE_ORDER:
        if cand in results:
            pick, headline = cand, results[cand]
            break
    if pick is None:
        for cand in HEADLINE_ORDER:
            r = merged.get(cand)
            if r and "rows_per_sec" in r and "vs_baseline" in r:
                pick, headline, stale = cand, r, True
                break
    if pick is None:
        print(json.dumps({"metric": "bench_failed", "value": 0.0,
                          "unit": "rows/s", "vs_baseline": 0.0}))
        return
    label = {"join": "inner_join_100Mx100M", "groupby": "groupby_100M_4Mgrp",
             "filter_agg": "filter_agg_200M", "sortmerge": "sortmerge_25Mx25M",
             "join_lookup": "inner_join_lookup_100Mx10M"}[pick]
    if args.quick:
        label += "_quick"
    if stale:
        label += "_stale"
    print(json.dumps({
        "metric": f"{label}_rows_per_sec",
        "value": round(headline["rows_per_sec"], 1),
        "unit": "rows/s",
        "vs_baseline": round(headline["vs_baseline"], 4),
    }))


if __name__ == "__main__":
    main()
