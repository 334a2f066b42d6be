"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU because CI has no GPU; sharding tests use
XLA's host-platform device virtualization (the standard JAX substitute
for a multi-device machine — SURVEY.md §4). The platform is forced with
jax.config after import, so the tests stay on the CPU even where a GPU
is present. GPU runs go through chip_smoke.py and bench.py instead.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
