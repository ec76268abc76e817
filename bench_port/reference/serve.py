"""The reference's reading of served tokens.

For a prompt and the tokens the program served after it, one full forward
of the reference over the prompt and the served tokens (teacher-forced,
no cache) gives the logits at each position that predicted a served
token.  A greedy server serves, at each position, a token whose logit is
the reference's best up to rounding; the gap by which the served token's
logit lies below the reference's best is what the check reads, and the
widest gap over the sample is its number.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_port.reference import model as M
from bench_port.spec import Spec


def served_logits(w: Dict, s: Spec, prompt: torch.Tensor, served: torch.Tensor,
                  mm: M.Mm = M.f32_mm) -> torch.Tensor:
    """(N, V) logits at the positions that predict ``served`` (N tokens):
    the last prompt position and the served tokens but the last."""
    ids = torch.cat([prompt, served[:-1]])[None]
    mask = torch.ones_like(ids, dtype=torch.int32)
    hid = M.hidden_states(w, s, ids, mask, mm=mm)
    return M.logits(w, s, hid[0, prompt.numel() - 1:], mm)


@torch.no_grad()
def widest_gap(w: Dict, s: Spec, requests: List[Dict[str, torch.Tensor]],
               control_mm: M.Mm = None) -> float:
    """The widest gap over ``requests`` (each ``prompt`` and ``served``).
    With ``control_mm``, the token read at each position is the one that
    the control's logits put first rather than the served one."""
    widest = 0.0
    for req in requests:
        ref = served_logits(w, s, req["prompt"], req["served"])
        if control_mm is None:
            tok = req["served"].long()
        else:
            tok = served_logits(w, s, req["prompt"], req["served"], control_mm).argmax(-1)
        gap = ref.max(-1).values - ref.gather(-1, tok[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
    return widest
