"""Decode attention with this token's row (the fresh-row contract) in the
port against the JAX package, on the CPU.

The port's ``decode_attention_fused(..., fresh_k, fresh_v, write_idx)`` on a
stale cache (its plain version here: the CUDA kernel runs only on the card,
where ``chip_smoke.py`` holds it to the append followed by the kernel, bit
for bit) against JAX ``decode_attention_fused(..., fresh_k=, fresh_v=,
fresh_ks=, fresh_vs=, write_idx=, interpret=True)``, as
``tests/test_attention_decode.py`` drives it, for the bf16 and the int8
cache, grouped and multi-head, with the row in the first, a middle and the
last slot.  The JAX caller quantizes the row for the int8 cache; the port
quantizes it itself.  Tolerances: the output within 2e-5, the tolerance of
``tests/test_torch_int8.py::test_int8_decode_attention_plain_matches_jax``
(f32 queries, sums in another order); the cache after the call equal to
JAX ``_append_kv``'s bit for bit (the same IEEE division and
round-half-to-even)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.models import transformer as JT
from ecg_byte_tpu.ops import attention_decode as jax_decode
from ecg_byte_tpu_torch.models import tiny_test_config
from ecg_byte_tpu_torch.models import transformer as T
from ecg_byte_tpu_torch.ops import attention_decode, kv_quant


def _bf16(a):
    """numpy f32 -> the bf16 values as f32 (exact in both packages)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _case(int8, h, kh, s=128, b=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    fk = _bf16(rng.standard_normal((b, 1, kh, d)))
    fv = _bf16(rng.standard_normal((b, 1, kh, d)))
    if int8:
        k = rng.integers(-127, 128, (b, s, kh, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, s, kh, d)).astype(np.int8)
        ks = _bf16(rng.uniform(0.01, 0.05, (b, s, kh)))
        vs = _bf16(rng.uniform(0.01, 0.05, (b, s, kh)))
    else:
        k = _bf16(rng.standard_normal((b, s, kh, d)))
        v = _bf16(rng.standard_normal((b, s, kh, d)))
        ks = vs = None
    mask = np.ones((b, s), np.int32)
    mask[:, -s // 4:] = 0  # unfilled tail
    mask[0, :3] = 0  # left padding
    return q, k, v, mask, ks, vs, fk, fv


def _jax(q, k, v, mask, ks, vs, fk, fv, idx):
    """JAX's output and its appended cache {k, v[, k_scale, v_scale]}."""
    bf = jnp.bfloat16
    jk, jv = (jnp.asarray(a) if a.dtype == np.int8 else jnp.asarray(a, bf) for a in (k, v))
    caches = {"k": jk, "v": jv}
    fresh = dict(fresh_k=jnp.asarray(fk, bf), fresh_v=jnp.asarray(fv, bf))
    scales = ()
    if ks is not None:
        caches.update(k_scale=jnp.asarray(ks, bf), v_scale=jnp.asarray(vs, bf))
        scales = (caches["k_scale"], caches["v_scale"])
        kq, ks_row = JT._quant_kv_rows(fresh["fresh_k"])
        vq, vs_row = JT._quant_kv_rows(fresh["fresh_v"])
        fresh = dict(fresh_k=kq, fresh_v=vq, fresh_ks=ks_row, fresh_vs=vs_row)
    out = jax_decode.decode_attention_fused(jnp.asarray(q), jk, jv, jnp.asarray(mask), *scales,
                                            **fresh, write_idx=jnp.int32(idx), interpret=True)
    appended = JT._append_kv(caches, jnp.asarray(fk, bf), jnp.asarray(fv, bf), idx)
    return np.asarray(out), {n: np.asarray(t.astype(jnp.float32)) if t.dtype == bf
                             else np.asarray(t) for n, t in appended.items()}


def _torch(a):
    t = torch.from_numpy(np.array(a))
    return t if a.dtype == np.int8 else t.to(torch.bfloat16)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,kh", [(8, 2), (5, 5)], ids=["gqa", "mha"])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_fresh_row_matches_jax(int8, h, kh, where):
    q, k, v, mask, ks, vs, fk, fv = _case(int8, h, kh, seed=h + kh)
    s = k.shape[1]
    idx = {"first": 0, "middle": s // 2 + 5, "last": s - 1}[where]
    mask[:, idx] = 1  # the decode step marks its own slot valid before attending
    want, want_cache = _jax(q, k, v, mask, ks, vs, fk, fv, idx)

    cache = {"k": _torch(k), "v": _torch(v)}
    if int8:
        cache.update(k_scale=_torch(ks), v_scale=_torch(vs))
    before = (attention_decode.decode_attention_fused.launches,
              attention_decode.decode_attention_fused.int8_launches)
    got = attention_decode.decode_attention_fused(
        torch.from_numpy(q), cache["k"], cache["v"], torch.from_numpy(mask),
        cache.get("k_scale"), cache.get("v_scale"),
        fresh_k=_torch(fk), fresh_v=_torch(fv), write_idx=idx)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    for name, t in cache.items():
        np.testing.assert_array_equal(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                                      want_cache[name], err_msg=name)
    assert (attention_decode.decode_attention_fused.launches,
            attention_decode.decode_attention_fused.int8_launches) == before


def test_fresh_row_needs_all_three():
    q, k, v, mask, *_ = _case(False, 8, 2)
    with pytest.raises(ValueError, match="go together"):
        attention_decode.decode_attention_fused(
            torch.from_numpy(q), _torch(k), _torch(v), torch.from_numpy(mask),
            fresh_k=_torch(k[:, :1]), write_idx=3)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_decode_step_appends_through_the_fresh_row(int8, monkeypatch):
    """``decode_step`` hands its rows to decode attention and appends
    nothing itself: with ``kv_quant.append_kv`` refused, a step writes the
    same cache rows that an explicit append of its K/V writes."""
    c = tiny_test_config("llama", dtype="bfloat16")
    params = T.init_params(c, torch.Generator().manual_seed(0), torch.device("cpu"))
    ids = torch.randint(0, c.vocab_size, (1, 12), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(1, 12, dtype=torch.int32)
    cache = T.init_kv_cache(c, 1, 16, torch.device("cpu"), dtype=torch.int8 if int8 else None)
    _, cache, pos = T.prefill(params, c, ids, mask, cache)
    seen = []
    real = attention_decode.decode_attention_fused

    def spy(q, k_cache, v_cache, valid_mask, k_scale=None, v_scale=None, splits=None, **fresh):
        seen.append({n: t.clone() for n, t in fresh.items() if n != "write_idx"})
        return real(q, k_cache, v_cache, valid_mask, k_scale, v_scale, splits, **fresh)

    def refused(*a, **k):
        raise AssertionError("decode_step appended by itself")

    monkeypatch.setattr(attention_decode, "decode_attention_fused", spy)
    monkeypatch.setattr(kv_quant, "append_kv", refused)
    cache_mask = torch.cat([mask, torch.zeros(1, 4, dtype=torch.int32)], 1)
    cache_mask[:, 12] = 1
    T.decode_step(params, c, ids[:, -1].int(), pos.int(), 12, cache, cache_mask)
    assert len(seen) == c.num_layers
    for i, fresh in enumerate(seen):
        if int8:
            for name, row in (("k", fresh["fresh_k"]), ("v", fresh["fresh_v"])):
                q, s = kv_quant.quant_kv_rows(row)
                assert torch.equal(cache[name][i][:, 12:13], q)
                assert torch.equal(cache[f"{name}_scale"][i][:, 12:13], s)
        else:
            assert torch.equal(cache["k"][i][:, 12:13], fresh["fresh_k"])
            assert torch.equal(cache["v"][i][:, 12:13], fresh["fresh_v"])
