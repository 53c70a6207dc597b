import os

# The suite runs on the CPU with a deterministic 8-device mesh for the
# sharding tests; runs on the card go through chip_smoke.py, and the tests
# marked ``gpu`` (`python -m pytest -m gpu tests/`) run there.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault(
    "XLA_FLAGS",
    (os.environ.get("XLA_FLAGS", "") +
     " --xla_force_host_platform_device_count=8").strip())

import pathlib

import pytest

REF_DIR = pathlib.Path("/root/reference/test_data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where JAX finds none")


@pytest.fixture(scope="session")
def hifi_bam() -> str:
    p = REF_DIR / "HG002_chr11_hifi_test.bam"
    if not p.exists():
        pytest.skip("HiFi test BAM unavailable")
    return str(p)


@pytest.fixture(scope="session")
def chr11_fa() -> str:
    p = REF_DIR / "chr11_2M.fa"
    if not p.exists():
        pytest.skip("chr11 test FASTA unavailable")
    return str(p)
