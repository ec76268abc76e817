"""``--dis`` in the port: two gloo ranks on the CPU against one process and
against the JAX package's ``dp=2`` mesh.

The JAX ``--dis`` step is GSPMD: the single-device function on the global
batch.  The port's ranks (``parallel.spawn``, ``init_method=file://``, one
torch thread each) must compute it too:

- the tiny-llama LoRA step, LoRA dropout on (both styles), with uneven
  labelled tokens across the ranks, a short batch (3 rows) and a batch of
  one row, where rank 1 holds none: loss within rtol 1e-6, every LoRA
  gradient within 1e-6 of the largest;
- one whole train step against JAX's ``make_train_step(config, opt,
  make_mesh(dp=2))`` at ``tests/test_torch_train.py``'s tolerances (loss
  rtol 1e-5; Adam's moments within 2e-5 of their largest; parameters atol
  1e-4 where the bias-corrected RMS gradient is at least 1e-5);
- MERL on the tiny ResNet (synced BatchNorm, gathered contrastive losses,
  view dropout on): loss, gradients and the running BatchNorm state
  against one process, and with dropout off against JAX's loss under a
  ``dp=2`` mesh, at ``tests/test_torch_resnet1d.py``'s tolerances (the
  state 1e-5 of its largest, gradients 1e-3, the loss 1e-5 relative);
- ``clip_loss``, ``vision.clip_forward`` (its shared logit scale) and the
  masked-image loss: gradients against one process (1e-6 of the largest),
  with a batch of one row among them, where rank 1 runs its forward on none;
- the sharded loader's agreed steps: rank r holds rows ``j * 2 + r`` of
  each global batch, the short last batch, and a batch that loses an item
  on one rank is skipped on both.

All rank-side work is one spawn (``two_ranks``), about 5 s here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ddp_ranks as ranks
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ecg_byte_tpu.models import config as jax_config
from ecg_byte_tpu.models import encoders as JE
from ecg_byte_tpu.models import resnet1d as JR
from ecg_byte_tpu.parallel import make_mesh
from ecg_byte_tpu.train import create_train_state as jax_create_state
from ecg_byte_tpu.train import make_train_step as jax_make_step
from ecg_byte_tpu.train.scheduler import make_optimizer as jax_make_optimizer
from ecg_byte_tpu.train.step import shard_state
from ecg_byte_tpu_torch.data.loader import DataLoader
from ecg_byte_tpu_torch.models import fusion
from ecg_byte_tpu_torch.parallel import distributed
from ecg_byte_tpu_torch.parallel.spawn import spawn

STYLES = ("rank", "input")
LM_BATCHES = {"b4": 4, "b3-short": 3, "b1-rank-without-rows": 1}
MERL_B = 6  # 3 rows a rank


def _lm_batch(b, s=24, seed=0):
    """Rows of different left pads and different labelled spans, so the two
    ranks hold different counts of labelled tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (b, s)).astype(np.int64)
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


def _jax_lm_state():
    jc = jax_config.tiny_test_config("llama", lora_dropout=0.0)
    jopt = jax_make_optimizer(jc.hidden_size, 2)
    jstate = jax_create_state(jc, jopt, jax.random.PRNGKey(0), peft=True)
    rng = np.random.default_rng(0)
    lora = _np_tree(jstate.trainable)
    for ab in lora["layers"].values():  # B != 0: both adapter halves train
        ab["b"] = (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    jstate = jstate.__class__(trainable=jax.tree.map(jnp.asarray, lora), base=jstate.base,
                              opt_state=jopt.init(jax.tree.map(jnp.asarray, lora)),
                              step=jstate.step)
    return jc, jopt, jstate


def _merl_inputs():
    jp, js, meta = JR.init_resnet(jax.random.PRNGKey(2), "resnet18")
    jh = JE.init_merl_head(jax.random.PRNGKey(3), feature_channels=512, spacial_dim=16)
    rng = np.random.default_rng(4)
    signals = rng.normal(size=(MERL_B, 12, 256)).astype(np.float32)
    text = rng.normal(size=(MERL_B, 768)).astype(np.float32)
    return (_np_tree(jp), _np_tree(js), _np_tree(jh), meta), signals, text


def _clip_inputs(b):
    rng = np.random.default_rng(b)
    ids = rng.integers(1, 300, (b, 16)).astype(np.int64)
    mask = np.ones((b, 16), np.int64)
    mask[:, 12:] = 0
    return ids, mask, rng.normal(size=(b, 3, 32, 32)).astype(np.float32)


def _vit_inputs():
    rng = np.random.default_rng(9)
    return (rng.normal(size=(3, 3, 32, 32)).astype(np.float32),
            rng.random((3, 16)) < 0.4)


def _cases():
    jc, jopt, jstate = _jax_lm_state()
    step_batch = _lm_batch(4, seed=11)
    merl = _merl_inputs()
    cases = [(f"lm-{style}-{name}", ranks.lm_gradients, (style, _lm_batch(b)))
             for style in STYLES for name, b in LM_BATCHES.items()]
    cases += [
        ("lm-step", ranks.lm_train_step,
         (_np_tree(jstate.full_params()), _np_tree(jstate.trainable), step_batch)),
        ("merl-dropout", ranks.merl_step, (*merl, True)),
        ("merl", ranks.merl_step, (*merl, False)),
        # one row: rank 1 runs the forward on none, for BatchNorm's sums
        ("merl-1", ranks.merl_step, (merl[0], merl[1][:1], merl[2][:1], True)),
    ]
    for b in (4, 3, 1):
        rng = np.random.default_rng(b)
        cases.append((f"clip_loss-{b}", ranks.clip_loss_grads,
                      (rng.normal(size=(b, 8)).astype(np.float32),
                       rng.normal(size=(b, 8)).astype(np.float32))))
        cases.append((f"clip_forward-{b}", ranks.clip_forward_grads, _clip_inputs(b)))
    cases += [
        ("vit_mim", ranks.vit_mim_grads, _vit_inputs()),
        ("steps-7", ranks.loader_steps, (7, 4)),
        ("steps-1", ranks.loader_steps, (1, 4)),  # rank 1 never holds a row
        # epoch 1's batches: (1, 2), (0, 5), (4, 3), (6)
        ("steps-bad", ranks.loader_steps, (7, 2, (5, 6))),
        ("reduce", ranks.reduce_with_missing, ()),
    ]
    return cases, (jc, jopt, jstate, step_batch)


@pytest.fixture(scope="module")
def two_ranks():
    """{case: (one-process result, [rank 0's, rank 1's])} and the JAX state."""
    cases, jax_side = _cases()
    per_rank = spawn(ranks.run_cases, (cases,), world=2, timeout_s=240)
    threads = torch.get_num_threads()
    try:
        one = ranks.run_cases([c for c in cases
                               if c[0] not in ("steps-7", "steps-1", "reduce")])
    finally:
        torch.set_num_threads(threads)
    out = {name: (one.get(name), [r[name] for r in per_rank]) for name, _, _ in cases}
    return out, jax_side


def _close_grads(got, want, tol=1e-6):
    assert len(got) == len(want)
    top = max(np.abs(w).max() for w in want if w is not None)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_allclose(g, w, atol=tol * top, rtol=0)


@pytest.mark.parametrize("batch", list(LM_BATCHES))
@pytest.mark.parametrize("style", STYLES)
def test_lm_gradients_two_ranks_match_one_process(two_ranks, style, batch):
    """Every rank ends the backward with the one-process gradient of the
    global batch (summed over the ranks), and the global mean loss."""
    one, per_rank = two_ranks[0][f"lm-{style}-{batch}"]
    for loss, grads in per_rank:
        np.testing.assert_allclose(loss, one[0], rtol=1e-6)
        _close_grads(grads, one[1])
    assert any(np.abs(g).max() > 0 for g in one[1])


def test_lm_train_step_two_ranks_match_jax_dp2_mesh(two_ranks):
    """One whole step (forward, backward, the gradient sum, clip, Adam) at
    W = 2 against the JAX step under GSPMD on a dp=2 mesh."""
    out, (jc, jopt, jstate, batch) = two_ranks
    mesh = make_mesh(dp=2)
    jstate = shard_state(jstate, jc, mesh, peft=True)
    with mesh:
        jstate, jloss = jax_make_step(jc, jopt, mesh, remat=False)(
            jstate, {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()},
            jax.random.PRNGKey(7))
    from ecg_byte_tpu_torch.models import tiny_test_config
    from ecg_byte_tpu_torch.models.convert import lora_from_jax
    from ecg_byte_tpu_torch.models.lora import leaves

    pc = tiny_test_config("llama", lora_dropout=0.0)
    port = [leaves(lora_from_jax(_np_tree(t), pc, torch.device("cpu"))) for t in
            (jstate.trainable, jstate.opt_state[2].mu, jstate.opt_state[2].nu)]
    want_p, want_m, want_v = ([x.numpy() for x in tree] for tree in port)
    m_max = max(np.abs(m).max() for m in want_m)
    v_max = max(np.abs(v).max() for v in want_v)
    for loss, params, ms, vs in out["lm-step"][1]:
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
        for p, m, v, wp, wm, wv in zip(params, ms, vs, want_p, want_m, want_v):
            np.testing.assert_allclose(m, wm, atol=2e-5 * m_max, rtol=0)
            np.testing.assert_allclose(v, wv, atol=2e-5 * v_max, rtol=0)
            held = np.sqrt(wv / (1 - 0.99)) >= 1e-5
            np.testing.assert_allclose(p[held], wp[held], atol=1e-4, rtol=0)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max()


@pytest.mark.parametrize("case", ["merl-dropout", "merl", "merl-1"],
                         ids=["dropout", "no-dropout", "rank-without-rows"])
def test_merl_two_ranks_match_one_process(two_ranks, case):
    """Synced BatchNorm and the gathered contrastive losses: the loss, every
    gradient and the running BatchNorm state of one process, the view
    dropout masks keyed to the global rows; with one row, rank 1 runs its
    forward on none."""
    one, per_rank = two_ranks[0][case]
    for loss, grads, state, acc1 in per_rank:
        assert abs(loss - one[0]) <= 1e-5 * max(abs(one[0]), 1e-6)
        for g, w in zip(grads, one[1]):
            assert np.abs(g - w).max() <= 1e-3 * max(np.abs(w).max(), 1e-6)
        for s, w in zip(state, one[2]):
            assert _rel(s, w) <= 1e-5
        assert acc1 == one[3]


def test_merl_two_ranks_match_jax_dp2_mesh(two_ranks):
    """Dropout off: the loss, the gradients and the new BatchNorm state of
    JAX's ResNet + MERL loss jitted over a batch sharded on a dp=2 mesh."""
    (jp, js, jh, meta), signals, text = _merl_inputs()
    mesh = make_mesh(dp=2)

    def loss_fn(trainable, state, x, t):
        feats, new_state = JR.resnet_forward(trainable["resnet"], state, meta, x, train=True)
        loss, _ = JE.merl_pretrain_loss(trainable["head"], feats, t)
        return loss, new_state

    shard = NamedSharding(mesh, P("dp"))
    with mesh:
        (jloss, jstate), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, {"resnet": jp, "head": jh}), jax.tree.map(jnp.asarray, js),
            jax.device_put(signals, shard), jax.device_put(text, shard))
    from ecg_byte_tpu_torch.models.convert import merl_head_from_jax, resnet_from_jax
    from ecg_byte_tpu_torch.models.lora import leaves

    gp, gs = resnet_from_jax(_np_tree(jgrads["resnet"]), _np_tree(jstate), torch.device("cpu"))
    want_grads = leaves({"resnet": gp, "head": merl_head_from_jax(_np_tree(jgrads["head"]),
                                                                  torch.device("cpu"))})
    # the head's dense weights are (out, in) in the port, as the converter
    # lays out JAX's (in, out) kernels; gradients convert the same way
    for loss, grads, state, _ in two_ranks[0]["merl"][1]:
        assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
        for g, w in zip(grads, want_grads):
            assert _rel(g, w.numpy()) < 1e-3
        for s, w in zip(state, leaves(gs)):
            assert _rel(s, w.numpy()) <= 1e-5


@pytest.mark.parametrize("b", [4, 3, 1])
def test_clip_loss_gradients_two_ranks_match_one_process(two_ranks, b):
    one, per_rank = two_ranks[0][f"clip_loss-{b}"]
    lo = b // 2 + b % 2
    for r, (loss, gx, gy, acc1, acc5) in enumerate(per_rank):
        np.testing.assert_allclose(loss, one[0], rtol=1e-6)
        top = max(np.abs(one[1]).max(), np.abs(one[2]).max())
        np.testing.assert_allclose(gx, one[1][r::2], atol=1e-6 * top, rtol=0)
        np.testing.assert_allclose(gy, one[2][r::2], atol=1e-6 * top, rtol=0)
        assert (acc1, acc5) == (one[3], one[4])
        assert len(gx) == (lo if r == 0 else b - lo)


@pytest.mark.parametrize("b", [4, 3, 1])
def test_clip_forward_gradients_two_ranks_match_one_process(two_ranks, b):
    """CLIP's towers and its logit scale, which every rank's share of the
    loss reads: summed, the ranks' gradients are one process's."""
    one, per_rank = two_ranks[0][f"clip_forward-{b}"]
    for loss, grads in per_rank:
        np.testing.assert_allclose(loss, one[0], rtol=1e-6)
        _close_grads(grads, one[1])


def test_vit_mim_loss_two_ranks_match_one_process(two_ranks):
    one, per_rank = two_ranks[0]["vit_mim"]
    for loss, grads in per_rank:
        np.testing.assert_allclose(loss, one[0], rtol=1e-6)
        _close_grads(grads, one[1])


@pytest.mark.parametrize("n", [7, 1])
def test_sharded_loader_steps_hold_the_global_rows(two_ranks, n):
    """Global batch 4.  7 items: two steps an epoch, the second short (2 rows
    on rank 0, 1 on rank 1); 1 item: rank 1 never holds a row and takes an
    empty batch.  Each rank holds rows j * 2 + r of the batch one process
    draws."""
    _, per_rank = two_ranks[0][f"steps-{n}"]
    one = DataLoader(ranks.Items(n), batch_size=4, shuffle=True, seed=3, prefetch=False)
    one.set_epoch(1)
    batches = [b["x"][:, 0].tolist() for b in one]
    for r in (0, 1):
        assert per_rank[r] == [(len(b), b[r::2], list(range(r, len(b), 2)), len(b), 10 * len(b))
                               for b in batches]


def test_a_batch_that_loses_an_item_is_skipped_on_every_rank(two_ranks):
    """Global batch 2; items 5 and 6 fail to load.  The short last batch,
    item 6 alone on rank 0, loses its only item: every rank skips that
    step, where one process skips it."""
    one, per_rank = two_ranks[0]["steps-bad"]
    skipped = [k for k, s in enumerate(one) if s is None]
    assert skipped == [3] and len(per_rank[0]) == len(per_rank[1]) == len(one) == 4
    for r in (0, 1):
        assert [k for k, s in enumerate(per_rank[r]) if s is None] == skipped


def test_a_batch_that_loses_some_items_trains_the_rest_as_one_process(two_ranks):
    """The batch of items 0 and 5 loses 5, rank 1's: rank 0 holds item 0 as
    row 0 of a global batch of one row, rank 1 none.  In every step the
    ranks' items, each at its row, are the batch one process collates,
    with its counts."""
    one, per_rank = two_ranks[0]["steps-bad"]
    assert one[1] == (1, [0], [0], 1, 10)
    assert per_rank[0][1][1:3] == ([0], [0]) and per_rank[1][1][1:3] == ([], [])
    for k, want in enumerate(one):
        if want is None:
            continue
        total, items, index, valid, tokens = want
        assert index == list(range(total))
        got = [None] * total
        for r in (0, 1):
            r_total, r_items, r_index, r_valid, r_tokens = per_rank[r][k]
            assert (r_total, r_valid, r_tokens) == (total, valid, tokens)
            for item, row in zip(r_items, r_index):
                got[row] = item
        assert got == items


def test_reduce_gradients_keeps_a_gradient_no_rank_has(two_ranks):
    _, per_rank = two_ranks[0]["reduce"]
    for grads, total in per_rank:
        assert grads == [[3.0] * 3, [5.0] * 3, None] and total == 3.0


def test_label_count_is_the_spliced_loss_count():
    """``fusion.label_count`` on the host equals the labels the stage-2 loss
    counts after ``adapt_sequence``'s splice, ``<signal>`` anywhere (last
    position and absent included)."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 50, (5, 12))
    ids[0, 3] = ids[1, 11] = ids[2, 0] = 99  # <signal>; rows 3 and 4 have none
    labels = np.where(rng.random((5, 12)) < 0.6, ids, -100)
    t = torch.from_numpy
    adapted = fusion.adapt_sequence(torch.zeros(5, 1, 4), torch.zeros(5, 12, 4), t(ids),
                                    torch.ones(5, 12, dtype=torch.int32), t(labels),
                                    torch.zeros(5, 12, dtype=torch.long), sig_id=99)
    want = int((adapted["labels"][:, 1:] != -100).sum())
    assert fusion.label_count(ids, labels, 99) == want


def test_backend_rule():
    assert distributed.choose_backend("cpu", [0, 1]) == "gloo"
    assert distributed.choose_backend("cuda", [0, 0]) == "gloo"  # NCCL refuses two ranks a GPU
    assert distributed.choose_backend("cuda", [0, 1, 2, 3]) == "nccl"
    assert distributed.choose_backend("cuda", [0]) == "nccl"
