"""The rank side of the port's ``--tp`` / ``--fsdp`` tests
(``tests/test_torch_mesh.py``).

``parallel.spawn`` runs these functions in fresh processes, each a rank of a
gloo group on the CPU, and pickles back what they return; the same
functions run in the test process, without a process group, for the
one-process side.  Each lays the ranks out as ``(dp, fsdp, tp)``
(``parallel.mesh.init``) and returns whole tensors (gathered from the
shards), so the two sides compare directly.  No JAX here: a rank imports
this module, and the port must run without JAX.
"""

import contextlib
import os

import numpy as np
import torch

from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import lora_from_jax, params_from_jax
from ecg_byte_tpu_torch.parallel import Rows, distributed, mesh, sharding
from ecg_byte_tpu_torch.parallel.batches import shard_rows
from ecg_byte_tpu_torch.train import checkpoint
from ecg_byte_tpu_torch.train.scheduler import clip_by_global_norm_, make_optimizer
from ecg_byte_tpu_torch.train.step import (
    _step_loss,
    create_train_state,
    gradients,
    make_eval_step,
    shard_train_state,
)

CPU = torch.device("cpu")
VOCAB = 509  # odd: T = 2 pads the last vocabulary block


def _np(t):
    return t.detach().float().numpy().copy()


@contextlib.contextmanager
def grid(tp, fsdp):
    """The (dp, fsdp, tp) layout for the block (none in one process)."""
    if distributed.initialized():
        mesh.init(tp, fsdp)
    try:
        yield mesh.grid()
    finally:
        mesh.reset()


def _rows(total):
    return Rows.stride(total, mesh.data_world(), mesh.data_rank())


def lm_config(style="rank", vocab=VOCAB, dropout=0.1):
    return tiny_test_config("llama", vocab_size=vocab, lora_dropout=dropout,
                            lora_dropout_style=style)


def lm_state(config, peft, init=None):
    """A tiny llama (KH = 2) and LoRA adapters with B != 0 from fixed seeds,
    or the JAX initialisation ``init`` = (params, lora or None)."""
    opt = make_optimizer(config.hidden_size, 2)
    if init is not None:
        params = params_from_jax(init[0], config, CPU)
        lora = lora_from_jax(init[1], config, CPU) if peft else None
        return create_train_state(config, opt, torch.Generator(), peft=peft, params=params,
                                  lora=lora), opt
    params = T.init_params(config, torch.Generator().manual_seed(0), CPU)
    gen = torch.Generator().manual_seed(1)
    lora = lora_lib.init_lora(config, gen, CPU) if peft else None
    if peft:
        for layer in lora["layers"]:
            for ab in layer.values():
                ab["b"] = 0.05 * torch.randn(ab["b"].shape, generator=gen)
    return create_train_state(config, opt, gen, peft=peft, params=params, lora=lora), opt


def lm_count(batch):
    return int((np.asarray(batch["labels"])[:, 1:] != -100).sum())


def _whole_grads(trainable):
    return [None if t.grad is None else _np(sharding.gather(sharding.mark(t.grad, t)))
            for t in trainable]


class _SumBothWays(torch.autograd.Function):
    """A sum over ``group`` whose backward sums too: the gradient-scaled-by-T
    fault of a row-parallel output (``all_reduce_sum`` reused for tp)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


def _faults(fault):
    """Patch in the fault a check must refuse; returns the undo."""
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "scaled":  # the row-parallel sum's backward all-reduces: gradients x T
        def scaled(x):
            g = mesh.grid()
            return x if g.tp == 1 else _SumBothWays.apply(x, g.tp_group)
        patch(T, "reduce_from_tp", scaled)
    elif fault == "partial_a":  # a replicated LoRA A trains on its rank's part
        patch(T, "_lora_rank_space", lambda xa: xa)
    elif fault == "mask_cols":  # o/down's "input" mask drawn at the rank's width
        call = T._Dropout.__call__
        patch(T._Dropout, "__call__", lambda self, x, cols=None: call(self, x))
    return lambda: [setattr(o, n, v) for o, n, v in reversed(saved)]


def grid_train(tp, fsdp, peft, style, batch, steps=3, fault=None, vocab=VOCAB, init=None,
               dropout=0.1):
    """``steps`` train steps (forward and backward, the sum over the data
    group, the clip, Adam) on ``batch`` (a global batch) at tp x fsdp:
    (losses, clip norms, the first and the last step's whole gradients
    before the clip, Adam's whole moments and the whole trainables after
    the last step, the eval step's loss summed over the data group)."""
    undo = _faults(fault)
    try:
        with grid(tp, fsdp):
            config = lm_config(style, vocab, dropout)
            state, opt = lm_state(config, peft, init)
            state = shard_train_state(state, opt)
            rows = _rows(len(batch["input_ids"]))
            local = shard_rows(batch, rows)
            gen = torch.Generator().manual_seed(5)
            trainable = lora_lib.leaves(state.trainable)
            losses, norms, first = [], [], None
            for _ in range(steps):
                loss = gradients(trainable, _step_loss(config, state, local, gen, "none", rows,
                                                       lm_count(batch)))
                grads = _whole_grads(trainable)
                first = first or grads
                held = [t for t in trainable if t.grad is not None]
                norm = clip_by_global_norm_([t.grad for t in held], 1.0,
                                            [sharding.norm_groups(t) for t in held])
                state.optimizer.step()
                state.scheduler.step()
                losses.append(loss.item())
                norms.append(norm.item())
            payload = checkpoint._payload(state, mutable_only=True)
            moments = [(_np(s["exp_avg"]), _np(s["exp_avg_sq"]))
                       for _, s in sorted(payload["optimizer"]["state"].items())]
            after = [_np(t) for t in lora_lib.leaves(payload["trainable"])]
            ev = make_eval_step(config)(state, local, rows, lm_count(batch))
            ev = distributed.sum_over_data(ev).item()
            return losses, norms, first, grads, moments, after, ev
    finally:
        undo()


def vocab_pieces(vocab, seed=3):
    """The dense and the chunked cross entropy and the embedding lookup at a
    vocabulary of ``vocab`` (T = 2: an odd one pads the last block): their
    values and the gradients of the hidden states and of the whole table."""
    with grid(2, 1):
        config = tiny_test_config("llama", vocab_size=vocab)
        gen = torch.Generator().manual_seed(seed)
        table = torch.randn(vocab, config.hidden_size, generator=gen)
        hidden = torch.randn(3, 7, config.hidden_size, generator=gen)
        labels = torch.randint(0, vocab, (3, 7), generator=gen)
        labels[0, :3] = -100
        labels[2, 1] = vocab - 1  # the last row of the last (padded) block
        ids = torch.randint(0, vocab, (3, 7), generator=gen)
        ids[1, 2] = vocab - 1
        out = {}
        for name in ("dense", "chunked", "embed"):
            params = {"embed": table.clone(), "final_norm": torch.ones(config.hidden_size)}
            params = sharding.shard_tree(params, sharding.param_splits(params))
            params["embed"].requires_grad_(True)
            h = hidden.clone().requires_grad_(True)
            if name == "dense":
                loss = T.lm_loss_from_hidden(params, config, h, labels)
            elif name == "chunked":
                loss = T.chunked_lm_loss(params, config, h, labels, chunk=100)
            else:
                w = torch.randn(3, 7, config.hidden_size, generator=torch.Generator().manual_seed(9))
                loss = (T._embed(params, config, ids, None) * w).sum() + (h * w).sum()
            loss.backward()
            out[name] = (loss.item(), _np(h.grad),
                         _np(sharding.gather(sharding.mark(params["embed"].grad,
                                                           params["embed"]))))
        return out


def tp_decode(tp, params_np, vocab, ids, mask, new_tokens):
    """Greedy decode of ``ids`` at tp from the JAX initialisation
    ``params_np``: every rank's token stream, and the prefill's whole
    last-position logits."""
    with grid(tp, 1):
        config = tiny_test_config("llama", vocab_size=vocab)
        params = params_from_jax(params_np, config, CPU)
        params = sharding.shard_tree(params, sharding.param_splits(params))
        ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
        out = greedy_generate(params, config, ids, mask, max_new_tokens=new_tokens,
                              eos_token_id=-1, pad_token_id=0)
        cache = T.init_kv_cache(config, ids.shape[0], ids.shape[1], CPU)
        with torch.no_grad():
            logits, _, _ = T.prefill(params, config, ids, mask, cache)
            logits = T.gather_vocab(logits, vocab)
        return out.numpy(), _np(logits), tuple(cache["k"].shape)


def resume(save_grid, load_grid, batch, directory):
    """A LoRA state trained one step on ``save_grid`` and saved (rank 0
    writes the whole tree), then loaded on ``load_grid`` into a fresh
    state and trained one more step: the saved file's trainables, the
    second loss and the whole trainables and moments after it.  Each side
    runs where its grid's ranks are (the other side's group calls its
    collectives with T = F = 1)."""
    config = lm_config("rank")
    rows_of = lambda: _rows(len(batch["input_ids"]))  # noqa: E731
    out = {}
    if save_grid is not None:
        with grid(*save_grid):
            state, opt = lm_state(config, True)
            state = shard_train_state(state, opt)
            rows = rows_of()
            local = shard_rows(batch, rows)
            gen = torch.Generator().manual_seed(5)
            trainable = lora_lib.leaves(state.trainable)
            gradients(trainable, _step_loss(config, state, local, gen, "none", rows,
                                            lm_count(batch)))
            clip_by_global_norm_([t.grad for t in trainable], 1.0,
                                 [sharding.norm_groups(t) for t in trainable])
            state.optimizer.step()
            state.scheduler.step()
            state.step += 1
            checkpoint.save_checkpoint(directory, "best_model", state, epoch=0)
    if load_grid is not None:
        with grid(*load_grid):
            state, opt = lm_state(config, True)
            state = shard_train_state(state, opt)
            state, _ = checkpoint.load_checkpoint(directory, "best_model", state)
            rows = rows_of()
            local = shard_rows(batch, rows)
            gen = torch.Generator().manual_seed(6)
            trainable = lora_lib.leaves(state.trainable)
            loss = gradients(trainable, _step_loss(config, state, local, gen, "none", rows,
                                                   lm_count(batch)))
            clip_by_global_norm_([t.grad for t in trainable], 1.0,
                                 [sharding.norm_groups(t) for t in trainable])
            state.optimizer.step()
            state.scheduler.step()
            payload = checkpoint._payload(state, mutable_only=True)
            out["loss"] = loss.item()
            out["after"] = [_np(t) for t in lora_lib.leaves(payload["trainable"])]
            out["m"] = [_np(s["exp_avg"]) for _, s in sorted(payload["optimizer"]["state"].items())]
            out["step"] = state.step
    distributed.barrier()
    saved = torch.load(os.path.join(directory, "best_model.pt"), weights_only=True)
    out["saved"] = [_np(t) for t in lora_lib.leaves(saved["state"]["trainable"])]
    return out


def run_cases(cases):
    """Every ``(name, function, args)`` of ``cases`` on this rank, one
    torch thread; returns {name: result}."""
    torch.set_num_threads(1)
    return {name: fn(*args) for name, fn, args in cases}
