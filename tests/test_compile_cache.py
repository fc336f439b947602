"""jm_tpu.runtime: where the persistent compilation cache lives, and the
GPU compile flags the launchers add."""

import pytest

from jm_tpu import runtime


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of changing this process's
    configuration."""
    import jax
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_is_honoured_and_nothing_else_set(monkeypatch, tmp_path,
                                                  config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in dict(config_updates)


def test_default_is_one_fixed_path_in_the_checkout(monkeypatch,
                                                   config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(runtime.CHECKOUT / ".jaxcache")
    assert (runtime.CHECKOUT / "jm_tpu" / "runtime.py").is_file()
    assert [runtime.enable_compile_cache() for _ in range(3)] == [want] * 3
    assert [v for k, v in config_updates
            if k == "jax_compilation_cache_dir"] == [want] * 3


def test_parallel_gpu_compile_adds_its_flags_once(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", "--xla_dump_to=/dev/null")
    first = runtime.parallel_gpu_compile()
    assert first.startswith("--xla_dump_to=/dev/null ")
    assert "--xla_gpu_enable_llvm_module_compilation_parallelism=true" in first
    assert runtime.parallel_gpu_compile() == first
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_gpu_force_compilation_parallelism=2")
    assert (runtime.parallel_gpu_compile()
            == "--xla_gpu_force_compilation_parallelism=2")
