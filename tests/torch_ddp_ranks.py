"""The rank side of the port's two-rank tests (``tests/test_torch_ddp.py``,
``tests/test_torch_ddp_cli.py``).

``parallel.spawn`` runs these functions in fresh processes, each a rank of
a gloo group on the CPU, and pickles back what they return; the same
functions run in the test process for the one-process side.  No JAX here:
a rank imports this module, and the port must run without JAX.
"""

import numpy as np
import torch

from ecg_byte_tpu_torch.models import encoders as E
from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import resnet1d as R
from ecg_byte_tpu_torch.models import tiny_test_config, vision
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import (
    lora_from_jax,
    merl_head_from_jax,
    params_from_jax,
    resnet_from_jax,
)
from ecg_byte_tpu_torch.parallel import Rows, distributed
from ecg_byte_tpu_torch.parallel.batches import make_loader, shard_rows, steps
from ecg_byte_tpu_torch.train.scheduler import make_optimizer
from ecg_byte_tpu_torch.train.step import (
    compute_gradients,
    create_train_state,
    gradients,
    make_train_step,
)

CPU = torch.device("cpu")


def _np(t):
    return t.detach().numpy().copy()


def _grads(tree):
    return [None if t.grad is None else _np(t.grad) for t in lora_lib.leaves(tree)]


def _rows(total):
    """This process's rows of a global batch of ``total``: rows ``j * world
    + rank`` (all of them without a process group)."""
    return Rows.stride(total, distributed.world(), distributed.rank())


# --- the LM train step -------------------------------------------------------

def lm_config(style):
    return tiny_test_config("llama", lora_dropout=0.1, lora_dropout_style=style)


def lm_state(config):
    """A tiny llama and LoRA adapters with B != 0, drawn from fixed seeds."""
    params = T.init_params(config, torch.Generator().manual_seed(0), CPU)
    gen = torch.Generator().manual_seed(1)
    lora = lora_lib.init_lora(config, gen, CPU)
    for layer in lora["layers"]:
        for ab in layer.values():
            ab["b"] = 0.05 * torch.randn(ab["b"].shape, generator=gen)
    return create_train_state(config, make_optimizer(config.hidden_size, 2), gen, peft=True,
                              params=params, lora=lora)


def lm_count(batch):
    return int((np.asarray(batch["labels"])[:, 1:] != -100).sum())


def lm_gradients(style, batch):
    """(loss, LoRA gradients) of one train step's forward and backward on
    ``batch`` (a global batch), LoRA dropout on: this rank's rows of it
    under a process group, else all of it."""
    config = lm_config(style)
    state = lm_state(config)
    rows = _rows(len(batch["input_ids"]))
    loss = compute_gradients(config, state, shard_rows(batch, rows), torch.Generator().manual_seed(5),
                             rows=rows, n_valid=lm_count(batch))
    return loss.item(), _grads(state.trainable)


def lm_train_step(params_np, lora_np, batch):
    """One whole train step (dropout off, Adam at its defaults) from the JAX
    initialisation ``params_np`` / ``lora_np``: (loss, LoRA leaves after
    it, Adam's m and v)."""
    config = tiny_test_config("llama", lora_dropout=0.0)
    opt = make_optimizer(config.hidden_size, 2)
    state = create_train_state(config, opt, torch.Generator(), peft=True,
                               params=params_from_jax(params_np, config, CPU),
                               lora=lora_from_jax(lora_np, config, CPU))
    rows = _rows(len(batch["input_ids"]))
    state, loss = make_train_step(config, opt)(state, shard_rows(batch, rows), None, rows,
                                               lm_count(batch))
    leaves = lora_lib.leaves(state.trainable)
    adam = [state.optimizer.state[p] for p in leaves]
    return (loss.item(), [_np(p) for p in leaves], [_np(a["exp_avg"]) for a in adam],
            [_np(a["exp_avg_sq"]) for a in adam])


# --- MERL: the ResNet and its head ------------------------------------------

def merl_step(jax_trees, signals, text, dropout):
    """Loss, gradients (ResNet and head) and the new BatchNorm state of the
    MERL pretrain loss on a global batch, from JAX's initial trees."""
    jp, js, jh, meta = jax_trees
    p, s = resnet_from_jax(jp, js, CPU)
    head = merl_head_from_jax(jh, CPU)
    trainable = {"resnet": p, "head": head}
    for t in lora_lib.leaves(trainable):
        t.requires_grad_(True)
    rows = _rows(len(signals))
    x, t = shard_rows({"x": signals, "t": text}, rows).values()
    gen = torch.Generator().manual_seed(7) if dropout else None
    out = {}

    def step_loss():
        feats, out["bn"] = R.resnet_forward(p, s, meta, torch.from_numpy(np.ascontiguousarray(x)),
                                            train=True, rows=rows)
        loss, aux = E.merl_pretrain_loss(head, feats, torch.from_numpy(np.ascontiguousarray(t)),
                                         dropout_generator=gen, rows=rows)
        out["acc1"] = aux["acc1"].item()
        return loss

    loss = gradients(lora_lib.leaves(trainable), step_loss)
    return (loss.item(), _grads(trainable), [_np(v) for v in lora_lib.leaves(out["bn"])],
            out["acc1"])


# --- CLIP -------------------------------------------------------------------

def clip_loss_grads(x, y):
    rows = _rows(len(x))
    x, y = (torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)
            for a in shard_rows({"x": x, "y": y}, rows).values())
    loss, acc1, acc5 = E.clip_loss(x, y, rows=rows)
    loss.backward()
    loss = distributed.sum_over_ranks(loss.detach())
    return loss.item(), _np(x.grad), _np(y.grad), acc1.item(), acc5.item()


def clip_forward_grads(ids, mask, pixels):
    config = vision.tiny_clip_config()
    params = vision.init_clip(torch.Generator().manual_seed(3), config, CPU)
    for t in lora_lib.leaves(params):
        t.requires_grad_(True)
    rows = _rows(len(ids))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             shard_rows({"ids": ids, "mask": mask, "pixels": pixels}, rows).items()}
    loss = gradients(lora_lib.leaves(params), lambda: vision.clip_forward(
        params, config, batch["ids"], batch["mask"], batch["pixels"], return_loss=True,
        rows=rows)["loss"])
    return loss.item(), _grads(params)


def vit_mim_grads(pixels, masked):
    config = vision.tiny_vision_config()
    params = vision.init_vit(torch.Generator().manual_seed(4), config, CPU)
    for t in lora_lib.leaves(params):
        t.requires_grad_(True)
    rows = _rows(len(pixels))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             shard_rows({"pixels": pixels, "masked": masked}, rows).items()}
    loss = gradients(lora_lib.leaves(params), lambda: vision.vit_mim_loss(
        params, config, batch["pixels"], batch["masked"]))
    return loss.item(), _grads(params)


# --- the agreed steps of a sharded loader ----------------------------------

class Items:
    """``n`` items ``{"x": [i]}``; the indices in ``bad`` load as None."""

    def __init__(self, n, bad=()):
        self.n, self.bad = n, set(bad)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return None if i in self.bad else {"x": np.asarray([i])}


def loader_steps(n, batch_size, bad=()):
    """Each step of a shuffled epoch: None (skipped) or (global rows, this
    rank's items, their rows in the global batch, labelled count,
    tokens)."""
    loader = make_loader(Items(n, bad), batch_size, shuffle=True, seed=3, prefetch=False)
    loader.set_epoch(1)
    out = []
    for step in steps(loader, lambda b: (len(b["x"]), 10 * len(b["x"]))):
        out.append(None if step is None else (step.rows.total, step.batch["x"][:, 0].tolist(),
                                              list(step.rows.index), step.n_valid, step.tokens))
    return out


def reduce_with_missing():
    """reduce_gradients_ over three tensors: one with a gradient on every
    rank, one on rank 1 only, one on none."""
    r = distributed.rank()
    params = [torch.zeros(3, requires_grad=True) for _ in range(3)]
    params[0].grad = torch.full((3,), float(r + 1))
    if r == 1:
        params[1].grad = torch.full((3,), 5.0)
    (total,) = distributed.reduce_gradients_(params, torch.tensor(float(r + 1)))
    return [None if p.grad is None else p.grad.tolist() for p in params], total.item()


def run_cases(cases):
    """Every ``(name, function, args)`` of ``cases`` on this rank, one
    torch thread; returns {name: result}."""
    torch.set_num_threads(1)
    return {name: fn(*args) for name, fn, args in cases}


# --- cli.main ranks with a fault ---------------------------------------------

def failing_main_run(args):
    """``cli.main.run`` on this rank, except that rank 1's second train step
    raises."""
    from ecg_byte_tpu_torch.cli import main

    make = main.make_train_step

    def make_failing(*a, **kw):
        step, calls = make(*a, **kw), []

        def failing(*sa, **skw):
            calls.append(1)
            if distributed.rank() == 1 and len(calls) == 2:
                raise RuntimeError("rank 1 fails at step 2")
            return step(*sa, **skw)

        return failing

    main.make_train_step = make_failing
    return main.run(args)
