"""Hand-written Hopper kernels of the port, one family per directory.

Each family keeps the JAX package's split: ``ref.py`` holds the plain
PyTorch version (the CPU path and the oracle every kernel is held
against), ``ops.py`` the public wrapper, which dispatches on the tensor's
device (CPU -> plain version, CUDA -> kernel or raise) and counts its
launches.  The CUDA sources live in ``csrc/`` and are built by
``build.py`` at first use.

  fused_conv  all T timesteps of one spiking conv layer
              (replaces repro/kernels/fused_conv/kernel.py)
  fused_nce   all T timesteps of one spiking dense layer
              (replaces repro/kernels/fused_nce/kernel.py)
  fused_group all T timesteps of a chain of stride-1 convs and pools
              (replaces repro/kernels/fused_group/kernel.py)

``smem.py`` holds the shared-memory budget the fused_group wrapper and
the fusion planner share.
"""

from repro_torch.kernels.fused_conv import ops as fused_conv_ops  # noqa
from repro_torch.kernels.fused_group import ops as fused_group_ops  # noqa
from repro_torch.kernels.fused_nce import ops as fused_nce_ops  # noqa

__all__ = ["fused_conv_ops", "fused_group_ops", "fused_nce_ops"]
