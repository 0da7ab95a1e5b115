"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests run on the CPU backend with 8 virtual devices (SURVEY.md §4)
unless ``JAX_PLATFORMS`` names another platform: the few tests marked
``gpu`` need the card and are run there with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``; on the CPU they
skip.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
