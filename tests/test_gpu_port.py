"""The GPU-facing surface: compile-cache placement, the peak-bandwidth table,
imports without pyarrow, and ``chip_smoke.py`` (its refusal to run without a
GPU, and every phase at a tiny size on the CPU)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, cwd=REPO):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


_CACHE_PROBE = (
    "import sys; sys.path.insert(0, %r)\n"
    "from gpu_olap_tpu.utils.jaxenv import ensure_jax, compile_cache_dir\n"
    "jax = ensure_jax()\n"
    "print(jax.config.jax_compilation_cache_dir, '|', compile_cache_dir())\n"
) % REPO


def test_compile_cache_uses_env_dir_when_set(tmp_path):
    out = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    configured, reported = out.stdout.strip().split(" | ")
    # JAX reads the variable itself; nothing in code overrides it
    assert configured == str(tmp_path) and reported == str(tmp_path)


def test_compile_cache_defaults_inside_checkout():
    from gpu_olap_tpu.utils import jaxenv

    out = _run(_CACHE_PROBE)
    assert out.returncode == 0, out.stderr
    configured, reported = out.stdout.strip().split(" | ")
    assert configured == reported == jaxenv.DEFAULT_CACHE_DIR
    assert jaxenv.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_dryrun_multichip_refuses_too_few_devices():
    out = _run("import sys; sys.path.insert(0, '.')\n"
               "from __graft_entry__ import dryrun_multichip\n"
               "dryrun_multichip(4)\n")
    assert out.returncode != 0
    assert "needs 4 devices" in out.stderr


class _Dev:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


def _with_device(monkeypatch, platform, kind):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(platform, kind)])
    from gpu_olap_tpu.utils import metrics

    return metrics


def test_peak_table_h100(monkeypatch):
    metrics = _with_device(monkeypatch, "gpu", "NVIDIA H100 80GB HBM3")
    assert metrics.detect_hbm_bandwidth() == 3.35e12


def test_peak_table_unknown_accelerator_raises(monkeypatch):
    metrics = _with_device(monkeypatch, "gpu", "Some Future Card")
    with pytest.raises(KeyError, match="Some Future Card"):
        metrics.detect_hbm_bandwidth()


def test_peak_table_cpu_is_not_measured(monkeypatch):
    metrics = _with_device(monkeypatch, "cpu", "cpu")
    assert metrics.detect_hbm_bandwidth() is None
    reg = metrics.MetricsRegistry()
    reg.record_span("scan", 0.5, rows_in=10, bytes_accessed=1 << 20)
    assert reg.roofline_fraction("scan") is None
    assert reg.summary()[0]["hbm_roofline_frac"] is None


def test_import_and_dict_query_without_pyarrow():
    code = (
        "import sys; sys.modules['pyarrow'] = None; sys.path.insert(0, %r)\n"
        "import numpy as np\n"
        "import gpu_olap_tpu\n"
        "eng = gpu_olap_tpu.OlapEngine(gpu_olap_tpu.EngineConfig("
        "backend='device'))\n"
        "eng.register('t', {'k': np.arange(50) %% 4, 's': np.array(['x', 'y'])"
        "[np.arange(50) %% 2]})\n"
        "r = eng.query('SELECT s, COUNT(*) AS n, SUM(k) AS t FROM t GROUP BY s"
        " ORDER BY s')\n"
        "print(r.meta['backend'], r.to_pydict()['n'].tolist(),"
        " r.to_pydict()['t'].tolist())\n") % REPO
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "device [25, 25] [24, 49]"


def test_chip_smoke_refuses_cpu():
    out = _run("import runpy; runpy.run_path('chip_smoke.py', "
               "run_name='__main__')")
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=dict(env, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    data = chip_smoke.make_data(seed=3, scale=1e-5)
    eng = chip_smoke.make_engine()
    chip_smoke.register(eng, data)
    return chip_smoke, data, eng


@pytest.mark.parametrize("name", ["a", "b", "c", "c_grouped", "d", "e", "f", "g"])
def test_chip_smoke_query_phase_on_cpu(smoke, name):
    chip_smoke, data, eng = smoke
    (line,) = chip_smoke.phase_queries(eng, data, "cpu", names=(name,),
                                       warm=1)
    assert line["backend"] == "device" and line["rows"] > 0


def test_chip_smoke_reference_catches_wrong_answer(smoke):
    chip_smoke, data, eng = smoke
    sql, ref_check, _rows = chip_smoke.QUERIES["b"](data)
    res = eng.query(sql).to_pydict()
    res["mx"] = res["mx"].copy()
    res["mx"][0] += 1
    with pytest.raises(chip_smoke.SmokeFailure, match=r"\(b\) mx"):
        ref_check(res)


def test_chip_smoke_streamed_phase_on_cpu(smoke):
    chip_smoke = smoke[0]
    line = chip_smoke.phase_streamed(seed=3, scale=1e-4, card="cpu", warm=1)
    assert line["backend"] == "streaming" and line["rows"] == 20_000


def test_chip_smoke_four_card_phase_on_cpu_mesh(smoke):
    chip_smoke, data, _eng = smoke
    lines = chip_smoke.phase_four_cards(data, "cpu")
    assert [ln.get("backend") for ln in lines[:2]] == ["distributed"] * 2


def test_chip_smoke_trace_reduction():
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.kernel_name("sort_22_0__35") == "sort_22_0"
    assert chip_smoke.kernel_name(
        "void cub::CUB_1::DeviceRadixSortOnesweepKernel<int, x>(int*)") == \
        "cub::DeviceRadixSortOnesweepKernel"
    # (kernel, start ns, duration ns, on a compute stream); 50..100 overlaps
    events = [("sort_1_0", 0, 100, True), ("loop_add_fusion", 50, 100, True),
              ("sort_2_1", 300, 40, True), ("MemcpyD2H", 400, 10, False)]
    assert chip_smoke._busy_ns(events) == 200
    assert chip_smoke.stage_split("a", events) == {"masked_reduce": 240e-9}
    b = chip_smoke.stage_split("b", events)
    assert b["sort"] == 100e-9 and abs(b["post_sort"] - 140e-9) < 1e-15
    d = chip_smoke.stage_split("d", events)
    assert d["sort"] == 140e-9 and abs(d["expand_gather"] - 100e-9) < 1e-15
    data = chip_smoke.make_data(seed=1, scale=1e-5)
    for q in "abcd":
        split = chip_smoke.stage_split(q, events)
        for stage, (nbytes, model) in chip_smoke.stage_bytes(q, data).items():
            assert stage in split and nbytes > 0 and model


@pytest.mark.gpu
def test_peak_table_knows_this_gpu(gpu_device):
    from gpu_olap_tpu.utils.metrics import detect_hbm_bandwidth

    assert detect_hbm_bandwidth() > 1e12, gpu_device.device_kind


def test_chip_smoke_parity_corpus_phase_on_cpu(smoke):
    chip_smoke = smoke[0]
    line = chip_smoke.phase_parity_corpus("cpu")
    assert line["queries"] == 44
