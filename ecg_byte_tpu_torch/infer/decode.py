"""Greedy autoregressive decoding with a KV cache.

The port of ``ecg_byte_tpu/infer/decode.py``: prefill, then one
``decode_step`` per new token in a Python loop (where JAX compiles a
``lax.while_loop``).  The rules are the same: the prompt is sliced off the
output, rows after their eos are filled with pad, and generation stops once
every row has emitted eos.  Step ``step`` writes cache slot
``s_prompt + step - 1`` and marks it valid before attending.  ``lora``
serves with the adapters attached; ``int8_kv`` keeps the cache in int8
(``--int8_decode``, with an int8 weight tree from ``models/quantized.py``).
``inputs_embeds`` is the two-stage path: the prompt goes in as spliced
embeddings and the continuation as token ids.

On tp-sharded parameters (``parallel/sharding.py``, every rank of a tp
group calling it on the same prompts) it decodes inside the group: each
rank holds its KV heads in the cache, the prefill and decode kernels run
on its heads, and each token is the vocab-parallel argmax
(``transformer.vocab_argmax``), so every rank emits the one-process
stream.  A library path: ``cli.main --inference`` serves on one process,
as the JAX CLI does.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.config import TransformerConfig
from ecg_byte_tpu_torch.utils import profiling


def _done_check(done: torch.Tensor):
    """``(every row done, host seconds blocked in the read)``: the read of
    a device value, which waits for every kernel launched before it."""
    t0 = time.perf_counter()
    with profiling.span("ecg.decode.sync"):
        stop = bool(done.all())
    return stop, time.perf_counter() - t0


@torch.inference_mode()
def greedy_generate(
    params,
    config: TransformerConfig,
    input_ids: Optional[torch.Tensor],
    attn_mask: Optional[torch.Tensor] = None,
    *,
    inputs_embeds: Optional[torch.Tensor] = None,
    max_new_tokens: int = 128,
    eos_token_id: int = -1,
    pad_token_id: int = 0,
    lora: Optional[dict] = None,
    int8_kv: bool = False,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Greedy-decode continuations of left-padded prompts.

    Args:
      input_ids: (B, S) prompt token ids, ignored when ``inputs_embeds``
        is given.
      attn_mask: (B, S) validity mask (1 = valid), default all valid.
      inputs_embeds: (B, S, D) prompt embeddings (the two-stage path): the
        prefill consumes them and each decode step a token id.
      lora: adapters (``models/lora.py``) applied beside the base weights.
      int8_kv: the int8 KV cache (per-row bf16 scales) instead of the
        model dtype's.
      stats: if given, filled with this call's host-clock readings, which
        every call also logs (a copy) under ``profiling.records("decode")``:
        ``rows`` and ``prompt_len`` (B, S); ``prefill_s`` (cache
        allocation, prefill, first token and its done-check) and
        ``prefill_wait_s`` (that done-check); ``decode_s`` over
        ``decode_steps`` steps and ``decode_wait_s``, the part of it spent
        in the steps' done-checks.  Each done-check reads a device value,
        so it waits for the card to finish what the step launched: a
        step's time less its wait is the host's time to launch it.

    Returns:
      (B, max_new_tokens) int32: only the new tokens, padded with
      ``pad_token_id`` after each row's eos.
    """
    if inputs_embeds is not None:
        input_ids = None
    ref = input_ids if inputs_embeds is None else inputs_embeds[..., 0]
    device = ref.device
    if attn_mask is None:
        attn_mask = torch.ones(ref.shape, dtype=torch.int32, device=device)
    b, s_prompt = attn_mask.shape
    t0 = time.perf_counter()
    with profiling.span("ecg.decode.prefill"):
        cache = T.init_kv_cache(config, b, s_prompt + max_new_tokens, device,
                                dtype=torch.int8 if int8_kv else None)
        logits, cache, next_pos = T.prefill(params, config, input_ids, attn_mask, cache,
                                            lora=lora, inputs_embeds=inputs_embeds)
        cur = T.vocab_argmax(logits, config.vocab_size).to(torch.int32)
        done = cur == eos_token_id
        out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.int32, device=device)
        out[:, 0] = cur
        cache_mask = torch.cat(
            [attn_mask.to(torch.int32),
             torch.zeros((b, max_new_tokens), dtype=torch.int32, device=device)],
            dim=1,
        ).contiguous()
        positions = next_pos.to(torch.int32)
        stop, prefill_wait = _done_check(done)
    t1 = time.perf_counter()
    step, decode_wait = 1, 0.0
    while step < max_new_tokens and not stop:
        with profiling.span("ecg.decode.step"):
            write_idx = s_prompt + step - 1
            cache_mask[:, write_idx] = 1
            logits, cache = T.decode_step(
                params, config, cur, positions, write_idx, cache, cache_mask, lora=lora
            )
            nxt = T.vocab_argmax(logits, config.vocab_size).to(torch.int32)
            nxt = torch.where(done, pad_token_id, nxt)
            out[:, step] = nxt
            done = done | (nxt == eos_token_id)
            cur, positions = nxt, positions + 1
            step += 1
            stop, wait = _done_check(done)
        decode_wait += wait
    reading = dict(rows=b, prompt_len=s_prompt, prefill_s=t1 - t0, prefill_wait_s=prefill_wait,
                   decode_s=time.perf_counter() - t1, decode_wait_s=decode_wait,
                   decode_steps=step - 1)
    profiling.record("decode", reading)
    if stats is not None:
        stats.update(reading)
    return out
