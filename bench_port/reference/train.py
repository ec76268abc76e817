"""The reference's LoRA training steps, and the rule of the dropout masks.

The step is the configuration's: the mean next-token cross entropy over
the batch's labelled tokens, gradients of the adapters by autograd, the
clip by global norm 1.0 (optax's rule: gradients under the limit are left
as they are), L2 weight decay 0.01 added to the gradient, Adam (beta 0.9,
0.99, eps 1e-8, bias-corrected, ``torch.optim.Adam``'s formula) and the
Noam learning rate ``d^-0.5 * min(s^-0.5, warmup^-1.5 * s)`` at step
``s = 1, 2, ...``.  Everything in float32 (or the control's product).

Dropout: the masks of the configuration's LoRA dropout ("rank" style, on
the (B, S, r) product).  Each step draws one seed per layer from the host
generator, ``randint(0, 2**62, (layers,))``; each layer seeds a generator
on the device with its seed and draws ``rand`` for each group of adapted
projections in block order, one draw for a group whose projections all
carry adapters (q, k, v; gate, up) and one per adapted projection
otherwise; a value under ``1 - rate`` keeps its element.  The draws cover
the whole batch, and a block of rows takes its rows of them.

The batch goes through the model in blocks of rows, each block's loss
summed over the batch's count of labelled tokens, so that the reference
fits beside nothing else on the card; several processes may share the
rows and sum their gradients before the update.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from bench_port.reference import model as M
from bench_port.spec import Spec

GROUPS = (("q_proj", "k_proj", "v_proj"), ("o_proj",), ("gate_proj", "up_proj"), ("up_proj",),
          ("down_proj",))


def _groups(s: Spec):
    for group in GROUPS:
        if ("gate_proj" in group) != s.gated and ("up_proj" in group):
            continue
        present = [n for n in group if n in s.targets()]
        if present and len(present) == len(group):
            yield present
        else:
            for n in present:
                yield [n]


def dropout_masks(s: Spec, host_gen: Optional[torch.Generator], batch: int, seq: int, device):
    """Per layer, {target: (B, S, r) bool keep mask}; None when dropout is
    off (no generator or a zero rate)."""
    if host_gen is None or s.lora_dropout <= 0.0:
        return None
    seeds = torch.randint(0, 2**62, (s.layers,), generator=host_gen).tolist()
    r = s.lora_rank
    out = []
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(seed)
        layer = {}
        for names in _groups(s):
            u = torch.rand((batch, seq, r * len(names)), generator=gen, device=device)
            keep = u < 1.0 - s.lora_dropout
            for i, n in enumerate(names):
                layer[n] = keep[..., i * r:(i + 1) * r]
        out.append(layer)
    return out


def _pick(masks, idx):
    if masks is None:
        return None
    return [{n: m[idx] for n, m in layer.items()} for layer in masks]


def noam(d_model: int, warmup: int, step: int) -> float:
    s = float(step)
    return d_model ** -0.5 * min(s ** -0.5, warmup ** -1.5 * s)


def _leaves(lora: Dict):
    for i, layer in enumerate(lora["layers"]):
        for name in sorted(layer):
            for ab in ("a", "b"):
                yield (i, name, ab), layer[name][ab]


def run_steps(w: Dict, s: Spec, lora: Dict, batches: List[Dict[str, torch.Tensor]],
              host_gen: Optional[torch.Generator], *, warmup: int, rows: int = 1,
              mm: M.Mm = M.f32_mm, store: torch.dtype = torch.float32,
              row_ids: Optional[Sequence[int]] = None,
              reduce: Optional[Callable[[torch.Tensor], None]] = None, beta1=0.9, beta2=0.99,
              eps=1e-8, weight_decay=1e-2, clip=1.0) -> Dict:
    """Train ``lora`` (f32 leaves, updated in place) on ``batches``, one
    step each.  Returns ``losses`` (per step), ``first_grad`` (per leaf, the
    gradient Adam took at step 1: clipped, with the decay), ``grad_norms``
    (per step, per leaf, the loss gradient's norm before the clip) and
    ``params`` (per leaf, after the last step).  ``store``: the dtype the
    configuration holds the adapters in; each update is rounded to it, as
    an optimizer stepping parameters of that dtype rounds them, while the
    arithmetic stays in float32.

    ``row_ids`` and ``reduce``: where several processes share the work,
    the rows of each batch this one computes, and the in-place sum over the
    processes of a flat float32 tensor (its gradients and loss); each
    process then takes the same update."""
    leaves = dict(_leaves(lora))
    for t in leaves.values():
        t.requires_grad_(True)
    m = {k: torch.zeros_like(t) for k, t in leaves.items()}
    v = {k: torch.zeros_like(t) for k, t in leaves.items()}
    out = {"losses": [], "grad_norms": [], "first_grad": None}
    for step, batch in enumerate(batches, start=1):
        b, seq = batch["input_ids"].shape
        masks = dropout_masks(s, host_gen, b, seq, batch["input_ids"].device)
        count = max(int((batch["labels"][:, 1:] != -100).sum()), 1)
        for t in leaves.values():
            t.grad = None
        total = torch.zeros((), device=batch["input_ids"].device)
        mine = list(range(b)) if row_ids is None else list(row_ids)
        for lo in range(0, len(mine), rows):
            idx = mine[lo:lo + rows]
            part = {k: x[idx] for k, x in batch.items()}
            loss = M.loss_sum(w, s, part, lora, _pick(masks, idx), mm) / count
            loss.backward()
            total += loss.detach()
        with torch.no_grad():
            grads = {k: t.grad if t.grad is not None else torch.zeros_like(t)
                     for k, t in leaves.items()}
            if reduce is not None:
                flat = torch.cat([g.reshape(-1) for g in grads.values()] + [total[None]])
                reduce(flat)
                off = 0
                for k, g in grads.items():
                    grads[k] = flat[off:off + g.numel()].view_as(g)
                    off += g.numel()
                total = flat[-1]
            out["losses"].append(float(total))
            out["grad_norms"].append({k: float(g.norm()) for k, g in grads.items()})
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = 1.0 if float(norm) < clip else clip / float(norm)
            lr = noam(s.hidden, warmup, step)
            bc1, bc2 = 1 - beta1 ** step, 1 - beta2 ** step
            first = {}
            for k, t in leaves.items():
                g = grads[k] * scale + weight_decay * t
                first[k] = g.clone()
                m[k].mul_(beta1).add_(g, alpha=1 - beta1)
                v[k].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                denom = v[k].sqrt() / bc2 ** 0.5 + eps
                t.addcdiv_(m[k], denom, value=-lr / bc1)
                t.copy_(t.to(store).float())
            if out["first_grad"] is None:
                out["first_grad"] = first
    for t in leaves.values():
        t.requires_grad_(False)
        t.grad = None
    out["params"] = {k: t.detach().clone() for k, t in leaves.items()}
    return out
