"""Parity of the PyTorch port's transformer with the JAX package.

Both packages run the same weights (JAX init, perturbed norms and biases,
carried across by ``params_from_jax``) on the same numpy inputs, in f32 on
the CPU, for the tiny llama, gpt2 and gemma configs.  The port's wrappers
take their plain PyTorch versions on CPU tensors.

Tolerances: logits within 1e-4 absolute (f32 with sums in another order;
the logits are O(0.1) at these sizes); greedy token streams identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.infer import greedy_generate as jax_greedy_generate
from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu_torch.infer import greedy_generate
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import params_from_jax
from ecg_byte_tpu_torch.models.lora import leaves as lora_leaves

ARCHS = ["llama", "gpt2", "gemma"]
ATOL = 1e-4
CPU = torch.device("cpu")


def _models(arch, seed=0):
    jc = jax_config.tiny_test_config(arch)
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, x):  # unit norms and zero biases would hide layout bugs
        name = jax.tree_util.keystr(path)
        if "norm" in name or "bias" in name:
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    pc = tiny_test_config(arch)
    return jparams, jc, params_from_jax(tree, pc, CPU), pc


def _prompt(b=2, s=16, vocab=512, left_pad=3, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :left_pad] = 0
    ids[1, :left_pad] = 0
    return ids, mask


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jparams, jc, params, pc = _models(arch)
    ids, mask = _prompt()
    want = np.asarray(JT.forward(jparams, jc, jnp.asarray(ids), jnp.asarray(mask)))
    got = T.forward(params, pc, _t(ids).long(), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    jparams, jc, params, pc = _models(arch, seed=2)
    ids, mask = _prompt(seed=3)
    b, s = ids.shape
    steps = 8
    jcache = JT.init_kv_cache(jc, b, s + steps)
    jlogits, jcache, jpos = JT.prefill(
        jparams, jc, jnp.asarray(ids), jnp.asarray(mask), jcache
    )
    cache = T.init_kv_cache(pc, b, s + steps, CPU)
    logits, cache, pos = T.prefill(params, pc, _t(ids).long(), _t(mask), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))

    rng = np.random.default_rng(4)
    cache_mask = np.concatenate([mask, np.zeros((b, steps), np.int32)], 1)
    jpos, pos = np.asarray(jpos), pos.to(torch.int32)
    for step in range(1, steps + 1):
        tok = rng.integers(0, 512, (b,)).astype(np.int32)  # teacher-forced
        write_idx = s + step - 1
        cache_mask[:, write_idx] = 1
        jlogits, jcache = JT.decode_step(
            jparams, jc, jnp.asarray(tok), jnp.asarray(jpos), jnp.int32(write_idx),
            jcache, jnp.asarray(cache_mask),
        )
        logits, cache = T.decode_step(
            params, pc, _t(tok).long(), pos, write_idx, cache,
            _t(cache_mask.copy()),
        )
        np.testing.assert_allclose(
            logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0,
            err_msg=f"decode step {step}",
        )
        jpos, pos = jpos + 1, pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_token_streams_identical(arch):
    jparams, jc, params, pc = _models(arch, seed=5)
    ids, mask = _prompt(seed=6, left_pad=5)
    pad_id, n_new = 7, 12
    free = np.asarray(jax_greedy_generate(
        jparams, jc, jnp.asarray(ids), jnp.asarray(mask),
        max_new_tokens=n_new, eos_token_id=-1, pad_token_id=pad_id,
    ))
    # an eos that row 0 emits mid-stream exercises the eos/pad rules
    eos_id = int(free[0, 4])
    want = np.asarray(jax_greedy_generate(
        jparams, jc, jnp.asarray(ids), jnp.asarray(mask),
        max_new_tokens=n_new, eos_token_id=eos_id, pad_token_id=pad_id,
    ))
    got = greedy_generate(
        params, pc, _t(ids).long(), _t(mask), max_new_tokens=n_new,
        eos_token_id=eos_id, pad_token_id=pad_id,
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 5:] == pad_id).all() or eos_id in got[0, :4]


def test_resize_embeddings_matches_jax():
    jparams, jc, params, pc = _models("llama", seed=7)
    jp, jcfg = JT.resize_embeddings(jparams, jc, 600)
    p, cfg = T.resize_embeddings(params, pc, 600)
    assert cfg.vocab_size == jcfg.vocab_size == 600
    np.testing.assert_allclose(p["embed"].numpy(), np.asarray(jp["embed"]), atol=1e-7, rtol=0)


@pytest.mark.parametrize("arch", ["llama", "gemma"])
def test_norm_weight_as_stored_is_bit_equal_to_f32_cast(arch):
    """``_norm`` hands llama's stored bf16 norm weight to the RMSNorm kernel
    as it is (the kernel converts it in registers); gemma's caller still
    adds its 1 in f32.  Logits and LoRA gradients of a bf16 model equal,
    bit for bit, those of the same model with its norm weights cast to
    f32 first."""
    from ecg_byte_tpu_torch.models import lora as lora_lib
    from ecg_byte_tpu_torch.ops import rmsnorm

    pc = tiny_test_config(arch, dtype="bfloat16")
    params = T.init_params(pc, torch.Generator().manual_seed(0), CPU)
    rng = np.random.default_rng(4)

    def tree(fn, t, name=""):
        if isinstance(t, dict):
            return {k: tree(fn, v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(fn, v, name) for v in t]
        return fn(name, t)

    def noisy(name, t):  # unit norm weights would hide a dropped weight
        if "norm" not in name:
            return t
        return (t.float() + 0.1 * torch.from_numpy(rng.standard_normal(t.shape))).to(t.dtype)

    params = tree(noisy, params)
    cast = tree(lambda name, t: t.float() if "norm" in name else t, params)
    assert params["final_norm"].dtype == torch.bfloat16
    lora = lora_lib.init_lora(pc, torch.Generator().manual_seed(1), CPU)
    lora = tree(lambda name, t: (0.05 * torch.from_numpy(rng.standard_normal(t.shape))).to(t.dtype)
                if name == "b" else t, lora)
    ids, mask = _prompt()
    labels = np.where(rng.random(ids.shape) < 0.5, ids, -100)
    seen = []
    real = rmsnorm.rmsnorm

    def spy(x, w, eps):
        seen.append(w.dtype)
        return real(x, w, eps)

    def run(p):
        lo = tree(lambda name, t: t.detach().clone().requires_grad_(True), lora)
        h = T.forward(p, pc, _t(ids).long(), _t(mask), lora=lo, return_hidden=True)
        T.lm_loss_from_hidden(p, pc, h, _t(labels).long()).backward()
        with torch.no_grad():
            logits = T.forward(p, pc, _t(ids).long(), _t(mask), lora=lo)
        return logits, lora_lib.leaves(tree(lambda name, t: t.grad, lo))

    rmsnorm.rmsnorm = spy
    try:
        (logits, grads), (logits_f32, grads_f32) = run(params), run(cast)
    finally:
        rmsnorm.rmsnorm = real
    half = len(seen) // 2
    assert set(seen[:half]) == {torch.bfloat16 if arch == "llama" else torch.float32}
    assert set(seen[half:]) == {torch.float32}
    assert torch.equal(logits, logits_f32)
    assert len(grads) == len(grads_f32) > 0
    for a, b in zip(grads, grads_f32):
        assert a is not None and torch.equal(a, b)


# Twins of tests/test_transformer.py's masking, loss and inputs_embeds
# checks, each on the same weights and inputs as the JAX function.


@pytest.mark.parametrize("arch", ARCHS)
def test_left_pad_invariance(arch):
    """The valid positions' logits do not depend on the left pads' ids, as
    in JAX, and equal JAX's (ATOL)."""
    jparams, jc, params, pc = _models(arch, seed=8)
    ids, mask = _prompt(b=2, s=12, left_pad=4, seed=9)
    ids, mask = ids[1:], mask[1:]  # the row with 4 left pads
    scrambled = ids.copy()
    scrambled[:, :4] = (scrambled[:, :4] + 7) % 512
    got = [T.forward(params, pc, _t(x).long(), _t(mask)).numpy() for x in (ids, scrambled)]
    want = np.asarray(JT.forward(jparams, jc, jnp.asarray(scrambled), jnp.asarray(mask)))
    np.testing.assert_allclose(got[0][:, 4:], got[1][:, 4:], atol=2e-4, rtol=0)
    np.testing.assert_allclose(got[1][:, 4:], want[:, 4:], atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_ignore_index(arch):
    """-100 labels drop out of the loss: all ignored gives exactly 0, as in
    JAX; the masked loss equals JAX's within 1e-5 relative."""
    jparams, jc, params, pc = _models(arch, seed=10)
    ids, mask = _prompt(seed=11)
    logits = T.forward(params, pc, _t(ids).long(), _t(mask))
    jlogits = JT.forward(jparams, jc, jnp.asarray(ids), jnp.asarray(mask))
    ignored = np.full(ids.shape, -100)
    assert T.causal_lm_loss(logits, _t(ignored)).item() == 0.0
    assert float(JT.causal_lm_loss(jlogits, jnp.asarray(ignored))) == 0.0
    labels = np.where(mask == 1, ids, -100)
    got = T.causal_lm_loss(logits, _t(labels).long()).item()
    want = float(JT.causal_lm_loss(jlogits, jnp.asarray(labels)))
    assert 0.0 < got < 3 * np.log(512)
    assert abs(got - want) <= 1e-5 * want


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_embeds_path(arch):
    """forward and prefill on the looked-up embeddings (``input_ids``
    None) equal the id path bit for bit, and JAX's embeds path (ATOL)."""
    jparams, jc, params, pc = _models(arch, seed=12)
    ids, mask = _prompt(seed=13)
    embeds = params["embed"][_t(ids).long()]
    via_ids = T.forward(params, pc, _t(ids).long(), _t(mask))
    via_embeds = T.forward(params, pc, None, _t(mask), inputs_embeds=embeds)
    assert torch.equal(via_ids, via_embeds)
    want = np.asarray(JT.forward(jparams, jc, None, jnp.asarray(mask),
                                 inputs_embeds=jnp.take(jparams["embed"], jnp.asarray(ids), 0)))
    np.testing.assert_allclose(via_embeds.numpy(), want, atol=ATOL, rtol=0)
    b, s = ids.shape
    runs = []
    for kw in ({"input_ids": _t(ids).long()}, {"input_ids": None, "inputs_embeds": embeds}):
        cache = T.init_kv_cache(pc, b, s, CPU)
        ids_arg = kw.pop("input_ids")
        logits, cache, pos = T.prefill(params, pc, ids_arg, _t(mask), cache, **kw)
        runs.append((logits, cache["k"], pos))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_chunked_lm_loss_matches_dense():
    """The vocabulary-tiled loss equals the dense one (rtol 2e-5) and JAX's
    chunked loss, with gradients of every parameter within 2e-2 (the JAX
    test's tolerances), at a vocabulary that leaves a ragged last tile."""
    jc = jax_config.tiny_test_config("llama", vocab_size=300)
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.PRNGKey(0)))
    pc = tiny_test_config("llama", vocab_size=300)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, (2, 24)).astype(np.int32)
    labels = np.where(rng.random((2, 24)) < 0.3, -100, ids)

    def run(chunked):
        params = params_from_jax(tree, pc, CPU)
        leaves = lora_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        h = T.forward(params, pc, _t(ids).long(), return_hidden=True)
        if chunked:
            loss = T.chunked_lm_loss(params, pc, h, _t(labels).long(), chunk=128)
        else:
            loss = T.causal_lm_loss(T._unembed(params, pc, h), _t(labels).long())
        loss.backward()
        return loss.item(), [t.grad for t in leaves]

    (ld, gd), (lc, gc) = run(False), run(True)
    np.testing.assert_allclose(lc, ld, rtol=2e-5)
    want = float(JT.chunked_lm_loss(
        jax.tree.map(jnp.asarray, tree), jc,
        JT.forward(jax.tree.map(jnp.asarray, tree), jc, jnp.asarray(ids), return_hidden=True),
        jnp.asarray(labels), chunk=128))
    np.testing.assert_allclose(lc, want, rtol=2e-5)
    for a, b in zip(gd, gc):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-2, rtol=2e-2)
