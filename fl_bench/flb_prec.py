"""The reference's precision: the configuration's compute dtype, or that
dtype's products with their operands rounded to fp8 (the control).

``Prec.mm(a, b)`` is every matrix product of the reference models. In the
configuration's precision it is ``a @ b`` in the compute dtype (f32
accumulation inside cuBLAS, the result rounded to the compute dtype), as
the program computes it. With ``fp8=True`` both operands are first
rounded to float8_e4m3fn under one scale per tensor (amax to 448), the
step a later change that moved the products to fp8 would take; the
rounding passes the gradient straight through, so the backward's
products read the rounded operands too.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor scale, in ``x``'s dtype,
    with an identity gradient."""
    xf = x.detach().to(torch.float32)
    scale = E4M3_MAX / xf.abs().amax().clamp(min=1e-30)
    q = (xf * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q.to(x.dtype) - x).detach()


class Prec:
    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 fp8: bool = False):
        self.dtype = dtype
        self.fp8 = fp8

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.to(self.dtype), b.to(self.dtype)
        if self.fp8:
            a, b = fake_fp8(a), fake_fp8(b)
        return a @ b
