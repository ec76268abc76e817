"""The control: the reference computed in the precision below the
configuration's.

The configurations state bfloat16, so the control runs every matrix
product of the reference (projections, adapters, attention's two products,
the output head) on float8 e4m3 operands: each operand is scaled by its
own amax to e4m3's largest value 448, rounded to e4m3, and scaled back;
the product accumulates in float32.  The gradient passes each rounding as
if it were the identity, so the backward products read the rounded
values, as an fp8 training recipe's do.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under a per-tensor amax scale, in x's dtype;
    the gradient passes through unchanged."""
    with torch.no_grad():
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = E4M3_MAX / amax
        q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fp8_round(a) @ fp8_round(b)
