import os

# Tests run on the single real CPU device; only launch/dryrun.py forces 512
# host devices (and only in its own process).
assert "xla_force_host_platform_device_count" not in os.environ.get(
    "XLA_FLAGS", "")

# Deterministic hypothesis runs: no example database (stale examples from
# earlier strategy definitions must not replay).  hypothesis is optional:
# without it, property tests are skipped at collection.
try:
    from hypothesis import settings
except ImportError:
    settings = None
else:
    settings.register_profile("repro", database=None, deadline=None)
    settings.load_profile("repro")

# Property tests need hypothesis; auto-skip them when it's absent.
collect_ignore = ([] if settings is not None
                  else ["test_properties.py", "test_scheduling.py"])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")
