"""The port's training path against the JAX package on the CPU: the Noam
schedule, whole train steps (forward, loss, backward, clip, Adam, schedule)
from one initialisation, the dense loss, checkpoints and the runner.

Both packages start from the same JAX initialisation carried across with
``params_from_jax`` / ``lora_from_jax`` and see the same numpy batches, in
f32 with LoRA dropout off (its random bits differ by design).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu.train import create_train_state as jax_create_state
from ecg_byte_tpu.train import make_train_step as jax_make_step
from ecg_byte_tpu.train.scheduler import make_optimizer as jax_make_optimizer
from ecg_byte_tpu.train.scheduler import noam_schedule as jax_noam
from ecg_byte_tpu_torch.cli.main import lm_measure
from ecg_byte_tpu_torch.models import lora as lora_lib
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.models.convert import lora_from_jax, params_from_jax
from ecg_byte_tpu_torch.parallel.batches import make_loader
from ecg_byte_tpu_torch.train import checkpoint as ckpt
from ecg_byte_tpu_torch.train.runner import trainer
from ecg_byte_tpu_torch.train.scheduler import make_optimizer, noam_schedule
from ecg_byte_tpu_torch.train.step import create_train_state, make_eval_step, make_train_step

CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :5] = 0  # left pad
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, : s // 2] = -100  # loss on the answer half only
    pos = np.maximum(np.cumsum(mask, -1) - 1, 0) * mask
    return {"input_ids": ids, "attn_mask": mask, "labels": labels,
            "position_ids": pos.astype(np.int32)}


def test_noam_schedule_matches_jax():
    """0-based steps 0..600 within 1e-6 relative (JAX computes in f32)."""
    for d_model, warmup in [(2048, 500), (64, 2)]:
        port, ref = noam_schedule(d_model, warmup), jax_noam(d_model, warmup)
        steps = np.arange(601)
        want = np.asarray(jax.vmap(ref)(jnp.asarray(steps, jnp.float32)))
        got = np.asarray([port(int(s)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _states(peft, eps=1e-8, warmup=2, seed=0):
    """The same initial state in both packages (tiny llama, f32, no dropout)."""
    jc = jax_config.tiny_test_config("llama", lora_dropout=0.0)
    pc = tiny_test_config("llama", lora_dropout=0.0)
    jopt = jax_make_optimizer(jc.hidden_size, warmup, eps=eps)
    jstate = jax_create_state(jc, jopt, jax.random.PRNGKey(seed), peft=peft)
    # B = 0 would make the first A gradients exactly zero; start from a
    # small random B so both adapter halves train from step one
    if peft:
        rng = np.random.default_rng(seed)
        lora = _np_tree(jstate.trainable)
        for ab in lora["layers"].values():
            ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
        jstate = jstate.__class__(
            trainable=jax.tree.map(jnp.asarray, lora), base=jstate.base,
            opt_state=jopt.init(jax.tree.map(jnp.asarray, lora)), step=jstate.step,
        )
    params = params_from_jax(_np_tree(jstate.full_params()), pc, CPU)
    lora = lora_from_jax(_np_tree(jstate.trainable), pc, CPU) if peft else None
    opt = make_optimizer(pc.hidden_size, warmup, eps=eps)
    state = create_train_state(pc, opt, torch.Generator(), peft=peft, params=params, lora=lora)
    return (jc, jopt, jstate), (pc, opt, state)


@pytest.mark.parametrize("eps", [1e-8, 1e-3], ids=["adam-eps-default", "adam-eps-1e-3"])
@pytest.mark.parametrize("peft", [True, False], ids=["peft", "full"])
def test_train_steps_track_jax(peft, eps):
    """5 steps from one init: losses within rtol 1e-4; with Adam's eps at
    1e-3 also the LoRA leaves (peft) or every parameter (full) within atol
    1e-4.

    At the default eps 1e-8 the two trajectories drift apart: Adam's update
    g / (|g| + eps) turns the f32 gradients' ~1e-9 differences into update
    differences of order lr wherever the decayed gradient g + wd*p lies
    within ~1e-8 of zero, and the moved parameters then move every later
    gradient (measured: 1.1e-3 apart after 5 steps).  So there only the
    losses are compared here, and each step's update is held from a shared
    state by ``test_each_train_step_matches_jax_at_default_eps``.  At eps
    1e-3 the update is smooth in g and every parameter must agree, to 1e-4
    rather than 1e-5: both packages keep the loss residual as bf16 logits
    centred on their logsumexp, and an f32 difference of 1e-7 flips the
    bf16 rounding of a few logits per step.  Measured: the largest LoRA
    difference after 5 steps (lr ~ 0.05) is 8.4e-5 with the bf16 residual
    and 8.2e-6 with the residual kept in f32 in both packages."""
    (jc, jopt, jstate), (pc, opt, state) = _states(peft, eps)
    jstep = jax_make_step(jc, jopt, remat=False)
    step = make_train_step(pc, opt)
    jlosses, losses = [], []
    for i in range(5):
        batch = _batch(pc.vocab_size, seed=i)
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(7))
        state, loss = step(state, batch, None)
        jlosses.append(float(jloss))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert state.step == 5
    if eps < 1e-3:
        return
    for got_t, want_t in zip(lora_lib.leaves(state.trainable), _port_leaves(jstate.trainable, pc, peft)):
        np.testing.assert_allclose(got_t.detach().numpy(), want_t.numpy(), atol=1e-4, rtol=0)


def _port_leaves(jax_tree, pc, peft):
    """A JAX trainable-shaped tree (parameters or an Adam moment) as the
    port's leaves, in the order of ``lora_lib.leaves(state.trainable)``."""
    convert = lora_from_jax if peft else params_from_jax
    return lora_lib.leaves(convert(_np_tree(jax_tree), pc, CPU))


@pytest.mark.parametrize("peft", [True, False], ids=["peft", "full"])
def test_each_train_step_matches_jax_at_default_eps(peft):
    """Adam at its default eps 1e-8, 5 steps: before each step the port is
    put on JAX's state (parameters and moments), so every step's update is
    compared from the same point and no drift accumulates.  After each step:

    - the loss within rtol 1e-5 (measured 2.3e-7);
    - Adam's moments m and v elementwise within 2e-5 of their largest
      value (measured 7.5e-6 and 6.6e-6, both at step 2 of the LoRA run,
      where the bf16 loss residual flips a few roundings);
    - the parameters within atol 1e-4 (measured 4.3e-5), except where the
      bias-corrected RMS gradient sqrt(v_hat) is below 1e-5: there
      g / (sqrt(v_hat) + eps) turns the gradients' ~1e-9 differences into
      update differences of order lr (3.5e-4 measured; 135 of 32k LoRA
      elements and 1.8k of 107k full fine-tune elements at step 1, a few
      at step 2, none later)."""
    (jc, jopt, jstate), (pc, opt, state) = _states(peft)
    jstep = jax_make_step(jc, jopt, remat=False)
    step = make_train_step(pc, opt)
    params = lora_lib.leaves(state.trainable)
    for i in range(5):
        with torch.no_grad():
            for p, w in zip(params, _port_leaves(jstate.trainable, pc, peft)):
                p.copy_(w)
            if i:
                adam = jstate.opt_state[2]
                for p, m, v in zip(params, _port_leaves(adam.mu, pc, peft),
                                   _port_leaves(adam.nu, pc, peft)):
                    state.optimizer.state[p]["exp_avg"].copy_(m)
                    state.optimizer.state[p]["exp_avg_sq"].copy_(v)
        batch = _batch(pc.vocab_size, seed=i)
        jstate, jloss = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(7))
        state, loss = step(state, batch, None)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        adam = jstate.opt_state[2]
        mus, nus = _port_leaves(adam.mu, pc, peft), _port_leaves(adam.nu, pc, peft)
        m_max = max(m.abs().max().item() for m in mus)
        v_max = max(v.abs().max().item() for v in nus)
        for p, m, v, w in zip(params, mus, nus, _port_leaves(jstate.trainable, pc, peft)):
            adam_state = state.optimizer.state[p]
            np.testing.assert_allclose(adam_state["exp_avg"].numpy(), m.numpy(),
                                       atol=2e-5 * m_max, rtol=0, err_msg=f"m, step {i + 1}")
            np.testing.assert_allclose(adam_state["exp_avg_sq"].numpy(), v.numpy(),
                                       atol=2e-5 * v_max, rtol=0, err_msg=f"v, step {i + 1}")
            held = (v / (1 - 0.99 ** (i + 1))).sqrt() >= 1e-5
            np.testing.assert_allclose(p.detach()[held].numpy(), w[held].numpy(), atol=1e-4,
                                       rtol=0, err_msg=f"parameters, step {i + 1}")


def test_lm_loss_from_hidden_matches_dense_and_jax():
    """Values: the fused loss equals causal_lm_loss(_unembed) in the port
    (1e-6) and both equal JAX (1e-5), with ignore-index rows; the hidden
    gradient of the fused loss equals JAX's (1e-6 absolute)."""
    jc = jax_config.tiny_test_config("llama")
    pc = tiny_test_config("llama")
    jparams = JT.init_params(jc, jax.random.PRNGKey(3))
    params = params_from_jax(_np_tree(jparams), pc, CPU)
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 10, pc.hidden_size)).astype(np.float32)
    labels = rng.integers(0, pc.vocab_size, (2, 10)).astype(np.int32)
    labels[0, :6] = -100
    labels[1, 3] = -100
    h = torch.from_numpy(hidden).requires_grad_(True)
    lab = torch.from_numpy(labels).long()
    fused = T.lm_loss_from_hidden(params, pc, h, lab)
    dense = T.causal_lm_loss(T._unembed(params, pc, h), lab)
    jfused, jgrad = jax.value_and_grad(
        lambda x: JT.lm_loss_from_hidden(jparams, jc, x, jnp.asarray(labels))
    )(jnp.asarray(hidden))
    jdense = JT.causal_lm_loss(JT._unembed(jparams, jc, jnp.asarray(hidden)), jnp.asarray(labels))
    np.testing.assert_allclose(fused.item(), dense.item(), rtol=1e-6)
    np.testing.assert_allclose(fused.item(), float(jfused), rtol=1e-5)
    np.testing.assert_allclose(dense.item(), float(jdense), rtol=1e-5)
    fused.backward()
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=0)


def _trained_state(peft=True, steps=2):
    pc = tiny_test_config("llama")
    state = create_train_state(pc, make_optimizer(pc.hidden_size, 2),
                               torch.Generator().manual_seed(0), peft=peft)
    step = make_train_step(pc, make_optimizer(pc.hidden_size, 2))
    for i in range(steps):
        state, _ = step(state, _batch(pc.vocab_size, seed=i), None)
    return pc, state


def _assert_trees_equal(a, b):
    for x, y in zip(lora_lib.leaves(a), lora_lib.leaves(b)):
        np.testing.assert_array_equal(x.detach().numpy(), y.detach().numpy())


def test_crash_save_live_and_snapshot(tmp_path):
    """A whole live state saves live; one cut mid-step saves the snapshot of
    the last epoch boundary; with neither, nothing is saved."""
    pc, state = _trained_state()
    snap = ckpt.snapshot_state(state)
    assert snap.mutable_only and "base" not in snap.payload
    assert all(t.device.type == "cpu" for t in lora_lib.leaves(snap.payload))
    assert ckpt.save_crash_checkpoint(str(tmp_path), state, snap, epoch=3) == "live"
    assert torch.load(tmp_path / "crash_model.pt", weights_only=True)["epoch"] == 3
    step = make_train_step(pc, make_optimizer(pc.hidden_size, 2))
    state, _ = step(state, _batch(pc.vocab_size, seed=9), None)  # moves past the snapshot
    state.in_step = True  # as after an exception inside a step
    assert ckpt.save_crash_checkpoint(str(tmp_path), state, snap, epoch=4,
                                      fallback_epoch=2) == "snapshot"
    saved = torch.load(tmp_path / "crash_model.pt", weights_only=True)
    assert saved["epoch"] == 2 and saved["mutable_only"]
    _assert_trees_equal(saved["state"]["trainable"], snap.payload["trainable"])
    assert ckpt.save_crash_checkpoint(str(tmp_path / "none"), state, None) == "none"


def test_mutable_only_round_trip_grafts_base(tmp_path):
    """A LoRA crash save holds {trainable, optimizer, scheduler, step}; loaded
    into a fresh state it restores them and keeps the fresh state's base."""
    pc, state = _trained_state(steps=3)
    ckpt.save_crash_checkpoint(str(tmp_path), state, None, epoch=1)
    saved = torch.load(tmp_path / "crash_model.pt", weights_only=True)
    assert set(saved["state"]) == {"trainable", "optimizer", "scheduler", "step"}
    fresh = create_train_state(pc, make_optimizer(pc.hidden_size, 2),
                               torch.Generator().manual_seed(5), peft=True,
                               params=state.base)
    base_before = [t.clone() for t in lora_lib.leaves(fresh.base)]
    loaded, epoch = ckpt.load_checkpoint(str(tmp_path), "crash_model", fresh)
    assert epoch == 1 and loaded.step == 3
    _assert_trees_equal(loaded.trainable, state.trainable)
    _assert_trees_equal(loaded.base, base_before)
    assert loaded.optimizer.state_dict()["state"].keys() == state.optimizer.state_dict()["state"].keys()
    assert loaded.scheduler.last_epoch == state.scheduler.last_epoch == 3
    # both continue identically
    step = make_train_step(pc, make_optimizer(pc.hidden_size, 2))
    batch = _batch(pc.vocab_size, seed=11)
    _, a = step(state, batch, None)
    _, b = step(loaded, batch, None)
    assert a.item() == b.item()
    _assert_trees_equal(loaded.trainable, state.trainable)


def test_full_state_round_trip_and_mode_check(tmp_path):
    """best_model of a full fine-tune round-trips; a LoRA template refuses it."""
    pc, state = _trained_state(peft=False, steps=1)
    ckpt.save_checkpoint(str(tmp_path), "best_model", state, epoch=0)
    fresh = create_train_state(pc, make_optimizer(pc.hidden_size, 2),
                               torch.Generator().manual_seed(1), peft=False)
    loaded, _ = ckpt.load_checkpoint(str(tmp_path), "best_model", fresh)
    _assert_trees_equal(loaded.trainable, state.trainable)
    lora_state = create_train_state(pc, make_optimizer(pc.hidden_size, 2),
                                    torch.Generator().manual_seed(1), peft=True)
    with pytest.raises(ValueError, match="mode differs"):
        ckpt.load_checkpoint(str(tmp_path), "best_model", lora_state)


def test_load_weights_for_serving(tmp_path):
    """Serving loads weights without an optimizer: a LoRA best_model gives
    its saved base and adapters, a mutable-only LoRA save keeps the built
    parameters, a full fine-tune gives its parameters; the mode is checked."""
    pc, state = _trained_state(steps=2)
    ckpt.save_checkpoint(str(tmp_path), "best_model", state)
    ckpt.save_crash_checkpoint(str(tmp_path), state, None)
    built = T.init_params(pc, torch.Generator().manual_seed(9), CPU)
    before = [t.clone() for t in lora_lib.leaves(built)]
    params, lora = ckpt.load_weights(str(tmp_path), "crash_model", built, peft=True)
    _assert_trees_equal(params, before)
    _assert_trees_equal(lora, state.trainable)
    params, lora = ckpt.load_weights(str(tmp_path), "best_model", built, peft=True)
    _assert_trees_equal(params, state.base)
    _assert_trees_equal(lora, state.trainable)
    with pytest.raises(ValueError, match="mode differs"):
        ckpt.load_weights(str(tmp_path), "best_model", built, peft=False)
    pc, full = _trained_state(peft=False, steps=1)
    ckpt.save_checkpoint(str(tmp_path / "full"), "best_model", full)
    params, lora = ckpt.load_weights(str(tmp_path / "full"), "best_model", built, peft=False)
    assert lora is None
    _assert_trees_equal(params, full.trainable)


class _Rows(list):
    """A dataset of cli.main's items: the rows of each batch, two a batch;
    a None batch is two items that fail to load."""

    def __init__(self, batches):
        super().__init__(item for b in batches for item in (b if b is not None else [None] * 2))


def _loader(batches):
    return make_loader(_Rows(batches), 2, prefetch=False)


def _raw(vocab, seed):
    b = _batch(vocab, seed=seed)
    return [{"tokenized_signal": b["input_ids"][i], "attn_mask": b["attn_mask"][i],
             "quantized_signal_ids_input": b["labels"][i], "position_ids": b["position_ids"][i]}
            for i in range(2)]


def test_trainer_propagates_step_errors():
    """A failing step raises out of the epoch (the JAX runner would print
    and go on); a None batch is still skipped."""
    calls = []

    def step_fn(state, batch, rng, rows, n_valid):
        calls.append(batch["input_ids"].shape)
        if len(calls) == 2:
            raise RuntimeError("kernel failed")
        return state, torch.tensor(1.0)

    loader = _loader([None, _raw(64, 0), _raw(64, 1), _raw(64, 2)])
    with pytest.raises(RuntimeError, match="kernel failed"):
        trainer(object(), step_fn, loader, None, measure=lm_measure, epoch=3)
    assert loader._epoch == 3 and len(calls) == 2


def test_trainer_and_eval_step_on_tiny_llama():
    """The runner's averages and token counts over a real step function;
    the eval step leaves parameters and gradients alone."""
    pc, state = _trained_state(steps=0)
    step = make_train_step(pc, make_optimizer(pc.hidden_size, 2))
    loader = _loader([_raw(pc.vocab_size, i) for i in range(3)])
    before = [t.clone() for t in lora_lib.leaves(state.trainable)]
    state, out = trainer(state, step, loader, torch.Generator().manual_seed(0),
                         measure=lm_measure, epoch=0, log_every=2)
    assert out["steps"] == 3 and out["tokens"] == 3 * 2 * 24 and np.isfinite(out["average_loss"])
    assert state.step == 3
    assert any((a != b).any() for a, b in zip(before, lora_lib.leaves(state.trainable)))
    eval_fn = make_eval_step(pc)
    after = [t.clone() for t in lora_lib.leaves(state.trainable)]
    loss = eval_fn(state, _batch(pc.vocab_size, seed=5))
    assert loss.ndim == 0 and not loss.requires_grad
    _assert_trees_equal(state.trainable, after)
