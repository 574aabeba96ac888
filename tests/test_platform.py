"""What each platform runs, and where compiled programs are kept:
select_step_iq (the tail policy) and compile_cache.enable_compile_cache."""
import jax
import pytest

from dvbt2ll_tpu import compile_cache, pipeline
from dvbt2ll_tpu.config import vv009_config


def test_cpu_takes_the_complex_tail():
    fn, planar = pipeline.select_step_iq(vv009_config(), "cpu")
    assert fn is pipeline.transmit_step_iq and not planar


def test_gpu_takes_its_measured_tail():
    fn, planar = pipeline.select_step_iq(vv009_config(), "gpu")
    want = pipeline.STEP_TAIL["gpu"] == "planar"
    assert planar == want
    assert fn is (pipeline.transmit_step_iq_planar if want
                  else pipeline.transmit_step_iq)


def test_unknown_platform_is_an_error():
    with pytest.raises(ValueError, match="'metal'"):
        pipeline.select_step_iq(vv009_config(), "metal")


def test_transmitter_asks_the_policy_for_its_platform(monkeypatch):
    seen = []
    real = pipeline.select_step_iq

    def spy(cfg, platform):
        seen.append(platform)
        return real(cfg, platform)

    monkeypatch.setattr(pipeline, "select_step_iq", spy)
    pipeline.Transmitter(vv009_config(), 1, strict=False)
    assert seen == [jax.devices("cpu")[0].platform]


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compile_cache_default_is_the_checkout(monkeypatch):
    import os

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        assert compile_cache.DEFAULT_DIR == want
        assert compile_cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          before[1])


def test_bench_refuses_a_non_gpu_device():
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(repo, "bench.py"),
                        "2", "1"], cwd=repo, capture_output=True, text=True,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    assert r.returncode != 0
    assert "measures a GPU" in r.stderr and r.stdout == ""
