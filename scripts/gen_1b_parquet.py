"""Generate the reference's literal 1B-row GROUP BY workload parquet
(README.md:332-334 there) at <repo>/.data/gpu_olap_<rows>.parquet, the path
bench.py's groupby_1b reads — same chunked
writer + seed as bench.py's bench_groupby_1b, run standalone so the bench
child doesn't pay the ~8 min generation inside its timeout."""
import os
import sys
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

n_rows = int(float(sys.argv[1])) if len(sys.argv) > 1 else 1_000_000_000
path = os.environ.get("GPU_OLAP_1B_PARQUET", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".data",
    f"gpu_olap_{n_rows}.parquet"))
os.makedirs(os.path.dirname(path), exist_ok=True)
n_groups = 4_000_000
if os.path.exists(path):
    print(f"exists: {path}")
    sys.exit(0)
t0 = time.time()
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
    print(f"{lo + m}/{n_rows} rows ({time.time()-t0:.0f}s)", flush=True)
writer.close()
print(f"done: {path} ({os.path.getsize(path)/1e9:.1f} GB, {time.time()-t0:.0f}s)")
