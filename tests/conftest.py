"""Test session config.

NOTE: we deliberately do NOT set --xla_force_host_platform_device_count
here (per the dry-run contract, only launch/dryrun.py forces fake devices).
Tests that need a multi-device mesh run themselves in a subprocess — see
tests/test_sharding_dryrun.py."""

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA card; skips without one")
