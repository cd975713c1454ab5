"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU.  XLA's host-platform device splitting gives
eight virtual CPU devices, which stand in for several cards: the
snarl-mesh programs (parallel/) compile and execute here exactly as they
would shard over the GPUs of one host.  Tests that need a real card carry
the ``gpu`` marker and are run on the card by ``chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import stoat_tpu.jaxconfig  # noqa: E402,F401  (enable x64 before any jax use)
