"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests exercise the same XLA programs on the host CPU backend, with 8
virtual devices so sharding tests run real multi-device programs.
JAX_PLATFORMS defaults to cpu so that no test worker opens a GPU; the
chain runs on the GPU through chip_smoke.py.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import pytest  # noqa: E402

from dvbt2ll_tpu.compile_cache import enable_compile_cache  # noqa: E402

# the unrolled QC-LDPC schedules cost seconds of XLA compile per config;
# cache compiled executables across test runs
enable_compile_cache()


@pytest.fixture(scope="session", autouse=True)
def _cpu_default_device():
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        yield


def cpu_devices(n=None):
    devs = jax.devices("cpu")
    return devs if n is None else devs[:n]
