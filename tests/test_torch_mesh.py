"""``--tp`` and ``--fsdp`` in the port: gloo ranks on the CPU laid out as the
JAX mesh's (dp, fsdp, tp) axes, against one process and against the JAX
package's step on a mesh of the same shape.

The JAX step under a mesh is GSPMD: the one-device function on the global
batch.  The port's ranks (``parallel.spawn``, one torch thread each) hold
their shards (``parallel/sharding.py``) and must compute it too:

- grids T = 2, F = 2 (two ranks), T = 2 x F = 2 and dp = 2 x T = 2 (four
  ranks) on a tiny llama with KH = 2 and a vocabulary of 509, which T = 2
  does not divide; LoRA with dropout on in both styles, and full fine-tune:
  the first step's loss and clip norm within rtol 1e-5 and its whole
  gradients within 1e-5 of the largest; the next steps' losses and norms
  within rtol 2e-4, and after 3 steps the last
  gradients and Adam's moments within 2e-3 of the largest and the
  parameters within 1e-3 where Adam's bias-corrected RMS gradient is at
  least 1e-5 (three Adam steps turn f32 reduction order into moved
  parameters: an update is about lr * sign(g) where v is tiny); the
  evaluation loss after them within rtol 2e-4.  A batch of one row at F = 2 leaves a
  rank without rows, whose forward still takes part in the gathers;
- one step of each grid against JAX's ``make_train_step`` on
  ``make_mesh(dp, fsdp, tp)`` after ``shard_state`` (dropout off, a
  vocabulary of 512: JAX needs even splits), at
  ``tests/test_torch_train.py``'s tolerances;
- the traps: a row-parallel sum whose backward also sums (gradients x T),
  a replicated LoRA A that trains on its rank's part, and an "input" mask
  drawn at a rank's width: each moves the gradients far past the bounds;
- the vocab-parallel dense and chunked cross entropy and the embedding at
  V = 509 against one process;
- tensor-parallel greedy decode at T = 2, token for token against one
  process (V = 509) and against JAX's ``greedy_generate`` on a tp = 2 mesh
  (V = 512); each rank's cache holds KH / T heads;
- checkpoints: a T = 2 state saves the one-process tree, which one process
  resumes, and a one-process checkpoint resumes on T = 2.

All rank-side work is one spawn a world size (``two_ranks``,
``four_ranks``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks

from ecg_byte_tpu.infer import greedy_generate as jax_greedy
from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu.parallel import make_mesh, param_specs, shard_tree
from ecg_byte_tpu.train import create_train_state as jax_create_state
from ecg_byte_tpu.train import make_train_step as jax_make_step
from ecg_byte_tpu.train.scheduler import make_optimizer as jax_make_optimizer
from ecg_byte_tpu.train.step import shard_state
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models.convert import lora_from_jax, params_from_jax
from ecg_byte_tpu_torch.models.lora import leaves
from ecg_byte_tpu_torch.parallel.spawn import spawn

CPU = torch.device("cpu")
TWO = {"tp2": (2, 1), "fsdp2": (1, 2)}
FOUR = {"tp2-fsdp2": (2, 2), "dp2-tp2": (2, 1)}
MODES = {"peft-rank": (True, "rank"), "peft-input": (True, "input"), "full": (False, "rank")}
FAULTS = {"scaled": "rank", "partial_a": "rank", "mask_cols": "input"}
JAX_MESH = {"tp2": dict(tp=2), "fsdp2": dict(fsdp=2), "tp2-fsdp2": dict(fsdp=2, tp=2),
            "dp2-tp2": dict(dp=2, tp=2)}
JAX_VOCAB = 512
PROMPT = (2, 12)
NEW_TOKENS = 8


def _lm_batch(b, s=24, seed=0, vocab=ranks.VOCAB):
    """Rows of different left pads and labelled spans, so the data ranks
    hold different counts of labelled tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int64)
    mask = np.ones((b, s), np.int64)
    labels = np.full((b, s), -100, np.int64)
    for i in range(b):
        pad, start = (0, 3, 5, 1)[i % 4], (20, 6, 14, 2)[i % 4]
        mask[i, :pad] = 0
        labels[i, start:] = ids[i, start:]
    pos = np.maximum(np.cumsum(mask, -1) - 1, 0) * mask
    return {"input_ids": ids, "attn_mask": mask, "labels": labels, "position_ids": pos}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(peft):
    jc = jax_config.tiny_test_config("llama", vocab_size=JAX_VOCAB, lora_dropout=0.0)
    jopt = jax_make_optimizer(jc.hidden_size, 2)
    jstate = jax_create_state(jc, jopt, jax.random.PRNGKey(0), peft=peft)
    if peft:
        rng = np.random.default_rng(0)
        lora = _np_tree(jstate.trainable)
        for ab in lora["layers"].values():  # B != 0: both adapter halves train
            ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
        jstate = jstate.__class__(trainable=jax.tree.map(jnp.asarray, lora), base=jstate.base,
                                  opt_state=jopt.init(jax.tree.map(jnp.asarray, lora)),
                                  step=jstate.step)
    return jc, jopt, jstate


def _jax_init(jstate, peft):
    return (_np_tree(jstate.full_params()), _np_tree(jstate.trainable) if peft else None)


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return rng.integers(0, vocab, PROMPT).astype(np.int64), np.ones(PROMPT, np.int64)


def _jax_params(vocab):
    jc = jax_config.tiny_test_config("llama", vocab_size=vocab)
    return jc, JT.init_params(jc, jax.random.PRNGKey(0))


def _cases(grids, extra=()):
    batch = _lm_batch(4)
    cases = [(f"{g}-{m}", ranks.grid_train, (*shape, peft, style, batch))
             for g, shape in grids.items() for m, (peft, style) in MODES.items()]
    jax_side = {}
    for g, shape in grids.items():
        # LoRA on every grid against JAX, and full fine-tune on T = 2 x F = 2
        for p in ((True, False) if g == "tp2-fsdp2" else (True,)):
            jc, jopt, jstate = _jax_state(p)
            jax_side[(g, p)] = (jc, jopt, jstate)
            cases.append((f"{g}-jax-{p}", ranks.grid_train,
                          (*shape, p, "rank", _lm_batch(4, seed=11, vocab=JAX_VOCAB), 1, None,
                           JAX_VOCAB, _jax_init(jstate, p), 0.0)))
    return cases + list(extra), jax_side


def _one_process_train():
    batch = _lm_batch(4)
    return {m: ranks.grid_train(1, 1, peft, style, batch) for m, (peft, style) in MODES.items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """{case: [rank 0's, rank 1's]}, the JAX states, and the one-process
    results."""
    root = tmp_path_factory.mktemp("mesh_ckpt")
    one_b1 = _lm_batch(1)
    resume_batch = _lm_batch(4, seed=2)
    one_saved = str(root / "one")
    threads = torch.get_num_threads()
    try:
        one = {"train": _one_process_train(),
               "b1": ranks.grid_train(1, 1, True, "rank", one_b1),
               "vocab": ranks.vocab_pieces(ranks.VOCAB),
               "resume": ranks.resume((1, 1), (1, 1), resume_batch, one_saved)}
    finally:
        torch.set_num_threads(threads)
    _, jparams_odd = _jax_params(ranks.VOCAB)
    jc, jparams = _jax_params(JAX_VOCAB)
    extra = [("fsdp2-b1", ranks.grid_train, (1, 2, True, "rank", one_b1)),
             ("vocab", ranks.vocab_pieces, (ranks.VOCAB,)),
             ("decode-odd", ranks.tp_decode, (2, _np_tree(jparams_odd), ranks.VOCAB,
                                              *_prompts(ranks.VOCAB), NEW_TOKENS)),
             ("decode-jax", ranks.tp_decode, (2, _np_tree(jparams), JAX_VOCAB,
                                              *_prompts(JAX_VOCAB), NEW_TOKENS)),
             ("save-tp2", ranks.resume, ((2, 1), None, resume_batch, str(root / "tp2"))),
             ("load-tp2", ranks.resume, (None, (2, 1), resume_batch, one_saved))]
    extra += [(f"fault-{f}", ranks.grid_train, (2, 1, True, style, _lm_batch(4), 1, f))
              for f, style in FAULTS.items()]
    cases, jax_side = _cases(TWO, extra)
    per_rank = spawn(ranks.run_cases, (cases,), world=2, timeout_s=300)
    try:
        one["from-tp2"] = ranks.resume(None, (1, 1), resume_batch, str(root / "tp2"))
        one["decode-odd"] = ranks.tp_decode(1, _np_tree(jparams_odd), ranks.VOCAB,
                                            *_prompts(ranks.VOCAB), NEW_TOKENS)
        one["decode-jax"] = ranks.tp_decode(1, _np_tree(jparams), JAX_VOCAB,
                                            *_prompts(JAX_VOCAB), NEW_TOKENS)
        for f, style in FAULTS.items():
            one[f"fault-{f}"] = ranks.grid_train(1, 1, True, style, _lm_batch(4), 1)
    finally:
        torch.set_num_threads(threads)
    out = {name: [r[name] for r in per_rank] for name, _, _ in cases}
    return out, jax_side, one, (jc, jparams)


@pytest.fixture(scope="module")
def four_ranks(two_ranks):
    cases, jax_side = _cases(FOUR)
    per_rank = spawn(ranks.run_cases, (cases,), world=4, timeout_s=300)
    return {name: [r[name] for r in per_rank] for name, _, _ in cases}, jax_side


def _top(arrays):
    return max(np.abs(a).max() for a in arrays if a is not None)


def _close(got, want, tol):
    top = _top(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g, w, atol=tol * top, rtol=0)


def _hold_grid(results, one, steps=3):
    for losses, norms, first, last, moments, after, ev in results:
        np.testing.assert_allclose(losses[0], one[0][0], rtol=1e-5)
        np.testing.assert_allclose(norms[0], one[1][0], rtol=1e-5)
        np.testing.assert_allclose(losses, one[0], rtol=2e-4)
        np.testing.assert_allclose(norms, one[1], rtol=2e-4)
        _close(first, one[2], 1e-5)
        _close(last, one[3], 2e-3)
        _close([m for m, _ in moments], [m for m, _ in one[4]], 2e-3)
        _close([v for _, v in moments], [v for _, v in one[4]], 2e-3)
        for p, w, (_, v) in zip(after, one[5], one[4]):
            held = np.sqrt(v / (1 - 0.99 ** steps)) >= 1e-5
            np.testing.assert_allclose(p[held], w[held], atol=1e-3, rtol=0)
        np.testing.assert_allclose(ev, one[6], rtol=2e-4)
    # every rank of the grid holds the same whole state
    for r in results[1:]:
        assert r[0] == results[0][0]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", list(TWO))
def test_two_rank_grid_matches_one_process(two_ranks, grid, mode):
    out, _, one, _ = two_ranks
    _hold_grid(out[f"{grid}-{mode}"], one["train"][mode])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("grid", list(FOUR))
def test_four_rank_grid_matches_one_process(two_ranks, four_ranks, grid, mode):
    _hold_grid(four_ranks[0][f"{grid}-{mode}"], two_ranks[2]["train"][mode])


def test_fsdp_rank_without_rows_matches_one_process(two_ranks):
    """A global batch of one row at F = 2: rank 1 holds none, and its
    forward and backward on a row no loss counts keep the gathers in step
    and add exact zeros."""
    out, _, one, _ = two_ranks
    _hold_grid(out["fsdp2-b1"], one["b1"])


def _hold_jax(results, jc, jopt, jstate, peft, mesh_shape):
    batch = _lm_batch(4, seed=11, vocab=JAX_VOCAB)
    mesh = make_mesh(**mesh_shape)
    jstate = shard_state(jstate, jc, mesh, peft=peft, fsdp="fsdp" in mesh_shape)
    with mesh:
        jstate, jloss = jax_make_step(jc, jopt, mesh, remat=False)(
            jstate, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()},
            jax.random.PRNGKey(7))
    pc = tiny_test_config("llama", vocab_size=JAX_VOCAB, lora_dropout=0.0)
    conv = (lambda t: lora_from_jax(_np_tree(t), pc, CPU)) if peft else (
        lambda t: params_from_jax(_np_tree(t), pc, CPU))
    want_p, want_m, want_v = ([x.numpy() for x in leaves(conv(tree))] for tree in
                              (jstate.trainable, jstate.opt_state[2].mu, jstate.opt_state[2].nu))
    m_max, v_max = _top(want_m), _top(want_v)
    for losses, _, _, _, moments, after, _ in results:
        np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-5)
        for p, (m, v), wp, wm, wv in zip(after, moments, want_p, want_m, want_v):
            np.testing.assert_allclose(m, wm, atol=2e-5 * m_max, rtol=0)
            np.testing.assert_allclose(v, wv, atol=2e-5 * v_max, rtol=0)
            held = np.sqrt(wv / (1 - 0.99)) >= 1e-5
            np.testing.assert_allclose(p[held], wp[held], atol=1e-4, rtol=0)


@pytest.mark.parametrize("grid", list(TWO))
def test_two_rank_grid_matches_jax_mesh(two_ranks, grid):
    out, jax_side, _, _ = two_ranks
    _hold_jax(out[f"{grid}-jax-True"], *jax_side[(grid, True)], True, JAX_MESH[grid])


@pytest.mark.parametrize("grid,peft", [("tp2-fsdp2", True), ("tp2-fsdp2", False),
                                       ("dp2-tp2", True)],
                         ids=["tp2-fsdp2-peft", "tp2-fsdp2-full", "dp2-tp2-peft"])
def test_four_rank_grid_matches_jax_mesh(four_ranks, grid, peft):
    out, jax_side = four_ranks
    _hold_jax(out[f"{grid}-jax-{peft}"], *jax_side[(grid, peft)], peft, JAX_MESH[grid])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_tp_traps_are_caught(two_ranks, fault):
    """Each fault moves the first step's gradients far past the 1e-5 bound
    the grids are held to; the row-parallel sum that sums its gradient
    too scales the gradients of every layer under the last by about T."""
    out, _, one, _ = two_ranks
    got, want = out[f"fault-{fault}"][0][2], one[f"fault-{fault}"][2]
    err = max(np.abs(g - w).max() for g, w in zip(got, want)) / _top(want)
    assert err > 0.1, err
    if fault == "scaled":
        ratios = [np.linalg.norm(g) / np.linalg.norm(w) for g, w in zip(got, want)]
        assert max(ratios) > 1.5, ratios


@pytest.mark.parametrize("piece", ["dense", "chunked", "embed"])
def test_vocab_parallel_pieces_match_one_process(two_ranks, piece):
    """The cross entropy (dense, chunked) and the embedding at V = 509 over
    T = 2: the value, the hidden states' gradient and the whole table's."""
    out, _, one, _ = two_ranks
    w_loss, w_dh, w_dt = one["vocab"][piece]
    for got in out["vocab"]:
        loss, dh, dt = got[piece]
        np.testing.assert_allclose(loss, w_loss, rtol=1e-6)
        np.testing.assert_allclose(dh, w_dh, atol=1e-6 * np.abs(w_dh).max(), rtol=0)
        np.testing.assert_allclose(dt, w_dt, atol=1e-6 * np.abs(w_dt).max(), rtol=0)


def test_tp_greedy_decode_matches_one_process(two_ranks):
    """T = 2 at V = 509: every rank's tokens are one process's; the
    prefill's logits within 1e-5 of the largest; KH / T heads a cache."""
    out, _, one, _ = two_ranks
    w_tokens, w_logits, w_shape = one["decode-odd"]
    for tokens, logits, shape in out["decode-odd"]:
        np.testing.assert_array_equal(tokens, w_tokens)
        np.testing.assert_allclose(logits, w_logits, atol=1e-5 * np.abs(w_logits).max(), rtol=0)
        assert shape[3] == w_shape[3] // 2


def test_tp_greedy_decode_matches_jax_tp_mesh(two_ranks):
    """As ``tests/test_parallel_train.py``'s tp-sharded decode: JAX's
    ``greedy_generate`` on tp-sharded params on a tp = 2 mesh, token for
    token against the port's ranks."""
    out, _, one, (jc, jparams) = two_ranks
    mesh = make_mesh(dp=1, tp=2)
    ids, mask = _prompts(JAX_VOCAB)
    with mesh:
        want = np.asarray(jax_greedy(shard_tree(jparams, param_specs(jc), mesh), jc,
                                     jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32),
                                     max_new_tokens=NEW_TOKENS, eos_token_id=-1, pad_token_id=0))
    for tokens, _, _ in out["decode-jax"]:
        np.testing.assert_array_equal(tokens, want)
    np.testing.assert_array_equal(one["decode-jax"][0], want)


def test_tp_checkpoint_is_the_one_process_tree_and_resumes(two_ranks):
    """A T = 2 state one step in saves the tree one process saves (within
    1e-4 of the largest: one Adam step on f32 gradients that differ in
    reduction order), one process resumes it and
    takes the step one process takes from its own; a one-process
    checkpoint resumes on T = 2 and steps as one process does."""
    out, _, one, _ = two_ranks
    want = one["resume"]
    for r in out["save-tp2"]:
        _close(r["saved"], want["saved"], 1e-4)
    resumed = one["from-tp2"]
    np.testing.assert_allclose(resumed["loss"], want["loss"], rtol=1e-5)
    assert resumed["step"] == want["step"] == 1
    _close(resumed["m"], want["m"], 1e-5)
    for r in out["load-tp2"]:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=1e-5)
        assert r["step"] == 1
        _close(r["m"], want["m"], 1e-5)
