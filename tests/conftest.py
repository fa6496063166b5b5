"""Test env: force the CPU backend with a virtual 8-device mesh.

Overrides (not setdefault) the platform, and also sets it through
jax.config after import, so a machine whose environment names an
accelerator still runs the tests on the CPU.  Tests validate semantics on
the fake 8-way CPU mesh (SURVEY.md §4); the GPU is exercised by
chip_smoke.py and bench.py."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
