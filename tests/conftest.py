import os

# Tests run on a virtual 8-device CPU mesh (backend init is lazy, so
# this runs before any test touches a device).  An explicit
# JAX_PLATFORMS wins: on a machine with a card,
# `JAX_PLATFORMS=cuda python -m pytest tests/test_gpu_smoke.py -m gpu`
# runs the GPU smoke tests there.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
