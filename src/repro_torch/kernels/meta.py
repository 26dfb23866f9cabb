"""The kernels' meta branch: what a wrapper does with fake CUDA tensors.

A dry run (``repro_torch.launch.dryrun``) runs an entry on the fake
tensors of ``torch._subclasses.fake_tensor``: a shape, a dtype and a device,
but no memory and no data pointer, so no kernel can launch on them. A
wrapper handed fake CUDA tensors takes its meta branch instead. It makes
the outputs its launch would make (the same shapes, dtypes and buffers,
which the fake mode allocates nothing for) and, for each launch it would
make, calls every hook in ``HOOKS`` with the kernel's name, the operands
that launch reads, the results it writes and its product FLOPs (0 for a
kernel that runs no products). The op-trace recorder
(``repro_torch.utils.hlo_analyzer``) installs one there, and counts each
call as one kernel of those FLOPs and operand plus result bytes, as the
JAX package's analyzer counts a Pallas custom call. The branch counts no
launch in ``LAUNCHES``: no kernel ran.

This is no fallback: a real CUDA tensor still launches the kernel or
raises, and a CPU tensor (fake or not) still takes the plain version.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

# hook(kernel, operands, results, flops), called once for each launch a
# meta branch stands in for
HOOKS: List[Callable[[str, Sequence[torch.Tensor], Sequence[torch.Tensor],
                      float], None]] = []


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor, which takes the meta branch."""
    return isinstance(t, FakeTensor)


def launched(kernel: str, operands: Sequence[torch.Tensor],
             results: Sequence[torch.Tensor], flops: float = 0.0) -> None:
    """Reports one launch the meta branch stands in for, with its product
    FLOPs."""
    for hook in HOOKS:
        hook(kernel, operands, results, float(flops))
