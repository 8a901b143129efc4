"""Fixtures of the benchmark's tests: a copy of gbench/ and BENCHMARK.json
whose configurations are cut to a scale the CPU runs in a second. Nothing
here imports JAX; the tests run on the CPU (`pytest gbench/tests`) and the
`cuda`-marked ones on the card."""
import pytest

from gbench_tiny import make_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where "
        "torch.cuda.is_available() is False")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("gbench_tiny"))
