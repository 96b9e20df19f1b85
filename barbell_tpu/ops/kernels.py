"""Which hand-written kernels a fused demux step runs.

Every device stage has a plain jnp formulation in
:mod:`barbell_tpu.ops.device` that XLA compiles for any backend.  Two
stages also have a GPU kernel written through Pallas' Triton route:
the flank scan (:mod:`barbell_tpu.ops.triton_myers`) and the barcode
rank (:mod:`barbell_tpu.ops.triton_rank`).  The choice is made once,
from the platform the engine runs on, and travels to the jitted step as
a static argument; nothing falls back silently.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Kernels:
    """Stages not named here run their jnp twin.  ``interpret`` runs the
    named Triton kernels in the Pallas interpreter — tests only, asked
    for by argument."""

    myers: bool = False
    rank: bool = False
    interpret: bool = False

    @property
    def compiled(self) -> bool:
        """True when a kernel is compiled for the GPU (no interpreter)."""
        return (self.myers or self.rank) and not self.interpret


#: jnp twins only (the CPU path)
XLA = Kernels()
#: the GPU path: every stage that has a Triton kernel uses it
GPU = Kernels(myers=True, rank=True)
#: the GPU kernels in the Pallas interpreter (CPU tests)
INTERPRET = Kernels(myers=True, rank=True, interpret=True)


def for_platform(platform: str) -> Kernels:
    """The kernel set for a JAX platform name; unknown platforms are an
    error, never a default."""
    if platform == "gpu":
        return GPU
    if platform == "cpu":
        return XLA
    raise ValueError(
        f"no kernel path for platform {platform!r}: barbell runs on 'gpu' "
        f"(Triton kernels) or 'cpu' (jnp twins)"
    )


def check_platform(kernels: Kernels, platform: str) -> None:
    """Compiled Triton kernels exist only for the GPU."""
    for_platform(platform)
    if kernels.compiled and platform != "gpu":
        raise ValueError(
            f"{kernels} compiles Triton kernels, which need a GPU; the "
            f"devices are {platform!r}"
        )
