"""Test configuration.

Multi-device testing strategy per SURVEY.md §4: force the JAX CPU platform with
8 virtual devices so mesh/shard_map paths compile and run without an
accelerator.  Must run before any ``import jax``.  Tests that need the GPU
carry the ``gpu`` marker and decide inside the ``gpu_device`` fixture.
"""

import os

# CPU unless the caller names a platform (``JAX_PLATFORMS=cuda`` runs the
# ``gpu``-marked tests on the card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

from gpu_olap_tpu import EngineConfig, OlapEngine


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX finds none (decided at
    run time, never while modules are imported)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {devices[0].platform}")
    return devices[0]


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def make_engine(backend: str = "cpu", **kwargs) -> OlapEngine:
    return OlapEngine(EngineConfig(backend=backend, **kwargs))


@pytest.fixture
def cpu_engine():
    return make_engine("cpu")


@pytest.fixture
def device_engine():
    return make_engine("device")


@pytest.fixture
def sales_data(rng):
    n = 5000
    return {
        "product_id": rng.integers(0, 50, n),
        "amount": rng.normal(100.0, 50.0, n),
        "quantity": rng.integers(1, 100, n),
        "customer_id": rng.integers(0, 200, n),
        "region": rng.choice(["EU", "US", "APAC", "LATAM"], n),
        "year": rng.integers(2020, 2026, n),
    }


@pytest.fixture
def customers_data(rng):
    n = 200
    return {
        "customer_id": np.arange(n),
        "customer_name": np.array([f"cust{i:03d}" for i in range(n)]),
        "region": rng.choice(["EU", "US", "APAC", "LATAM"], n),
        "credit": rng.integers(0, 10_000, n),
    }


def assert_result_equal(result, expected: dict, sort_by=None, approx=True):
    """Compare a QueryResult against a dict of expected columns as multisets
    (row order compared only after sorting by ``sort_by``)."""
    got = result.to_pydict()
    assert set(got) == set(expected), (sorted(got), sorted(expected))
    n = len(next(iter(expected.values()))) if expected else 0
    assert result.num_rows == n
    if sort_by is not None:
        import pandas as pd

        gdf = pd.DataFrame(got).sort_values(sort_by).reset_index(drop=True)
        edf = pd.DataFrame(expected).sort_values(sort_by).reset_index(drop=True)
    else:
        import pandas as pd

        gdf = pd.DataFrame(got)
        edf = pd.DataFrame(expected)
    for col in expected:
        g = gdf[col].to_numpy()
        e = edf[col].to_numpy()
        if approx and g.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(float), e.astype(float), rtol=1e-9,
                                       err_msg=f"column {col}")
        else:
            np.testing.assert_array_equal(g, e, err_msg=f"column {col}")
