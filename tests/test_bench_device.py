"""bench.py's strict device check: a run without a GPU fails unless
JAX_PLATFORMS=cpu was set explicitly, and every output is labelled with
the device it ran on."""

import importlib.util
import os

import pytest


@pytest.fixture()
def bench_mod():
    path = os.path.join(os.path.dirname(__file__), "..", "bench.py")
    spec = importlib.util.spec_from_file_location("bench_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Dev:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


H100 = Dev("gpu", "NVIDIA H100 80GB HBM3")
CPU = Dev("cpu", "cpu")


@pytest.mark.parametrize("devices,environ,label", [
    ([H100], {}, {"platform": "gpu", "kind": H100.device_kind, "count": 1}),
    ([H100] * 4, {"JAX_PLATFORMS": "cuda"},
     {"platform": "gpu", "kind": H100.device_kind, "count": 4}),
    ([CPU], {"JAX_PLATFORMS": "cpu"},
     {"platform": "cpu", "kind": "cpu", "count": 1}),
])
def test_device_label(bench_mod, devices, environ, label):
    assert bench_mod._require_device(devices, environ) == label


@pytest.mark.parametrize("devices,environ", [
    ([CPU], {}),                          # no GPU and no explicit pin
    ([Dev("rocm", "MI300X")], {}),         # not a platform this repo runs
])
def test_no_gpu_without_explicit_pin_fails(bench_mod, devices, environ):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench_mod._require_device(devices, environ)
