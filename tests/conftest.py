"""Test harness config: run JAX on the host CPU with 8 virtual devices.

The kernels are integer-exact, so the CPU gives the same bits as the
GPU (chip_smoke.py checks that on the card); the sharding tests use the
8 virtual host devices as their mesh (SURVEY.md §4.7 distributed
testing). Both settings must be in place before jax is imported.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import pathlib

import pytest

GOLDEN = pathlib.Path(__file__).parent / "golden"
REFERENCE_BIN = pathlib.Path("/root/reference/bin")


@pytest.fixture(scope="session")
def golden_dir():
    return GOLDEN


@pytest.fixture(scope="session")
def foreman_qcif():
    """Path to the 4:2:0 QCIF test clip shipped with the reference."""
    p = REFERENCE_BIN / "foreman_part_qcif.yuv"
    if not p.exists():
        pytest.skip("reference test clip unavailable")
    return p
