"""The split decode attention kernel's arithmetic and the int8 product's path
choice, on the CPU.

``csrc/attention_decode.cu`` cuts the cache's 64-position tiles into
contiguous ranges, one block each: (A) each range's logits and its softmax
max m_i and sum l_i; (B) the row's (m, l) combined from every range's in
range order, the exact probabilities round_bf16(exp(logit - m) / l
[x v_scale]) and each range's P.V in f32; (C) the partials summed in range
order and rounded.  :func:`split_decode` is that arithmetic in torch, over
the ranges ``ops/attention_decode.split_ranges`` gives the kernel; it is
held to JAX's ``decode_attention_fused`` (the Pallas kernel in interpret
mode) within 2e-2, the bound of the kernel's own check (K2).  The kernel
itself runs only on the card (``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecg_byte_tpu.ops import attention_decode as jax_decode
from ecg_byte_tpu_torch.ops import attention, attention_decode, int8_linear

NEG_INF = -1e30  # the kernel's finite mask fill (csrc/common.cuh kNegInf)


def split_decode(q, k, v, mask, splits, k_scale=None, v_scale=None, drop=None, double=None):
    """The split kernel's arithmetic: q (B, 1, H, D) bf16, the cache
    (B, S, KH, D) bf16 or int8 with (B, S, KH) scales, mask (B, S).  ``drop``
    leaves range ``drop``'s partial out of the sum and ``double`` counts
    range ``double``'s twice, as a faulty reduction would."""
    b, _, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kh, h // kh, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * d**-0.5
    if k_scale is not None:
        logits = logits * k_scale.float().transpose(1, 2)[:, :, None, :]
    logits = torch.where(mask.bool()[:, None, None, :], logits, torch.tensor(NEG_INF))
    ranges = attention_decode.split_ranges(s, splits)
    assert len(ranges) == splits
    # A: each range's max and sum
    ms = [logits[..., lo:hi].amax(-1) for lo, hi in ranges]
    ls = [torch.exp(logits[..., lo:hi] - m_i[..., None]).sum(-1) for (lo, hi), m_i in zip(ranges, ms)]
    # B: the row's (m, l), in range order; exact probabilities, rounded
    m = torch.stack(ms).amax(0)
    l = torch.zeros_like(m)
    for m_i, l_i in zip(ms, ls):
        l = l + l_i * torch.exp(m_i - m)
    p = torch.exp(logits - m[..., None]) / l[..., None]
    if v_scale is not None:
        p = p * v_scale.float().transpose(1, 2)[:, :, None, :]
    p = p.to(torch.bfloat16).float()
    parts = [torch.einsum("bkgs,bskd->bkgd", p[..., lo:hi], v[:, lo:hi].float())
             for lo, hi in ranges]
    # C: the partials in range order
    out = torch.zeros_like(parts[0])
    for i, part in enumerate(parts):
        if i != drop:
            out = out + part * (2 if i == double else 1)
    return out.to(torch.bfloat16).reshape(b, 1, h, d)


def _case(int8, b=2, s=512, h=8, kh=2, d=64, left_pad=3, seed=0):
    """The decode cases of tests/test_torch_ops.py (bf16 cache) and
    tests/test_torch_int8.py (int8 cache, bf16-exact scales) at S 512 (8
    tiles): the last quarter unfilled, row 0 left-padded by ``left_pad``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (b, s, kh, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, s, kh, d)).astype(np.int8)
        ks, vs = (rng.uniform(0.01, 0.05, (b, s, kh)) for _ in range(2))
    else:
        k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
        v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
        ks = vs = None
    mask = np.ones((b, s), np.int32)
    mask[:, -s // 4:] = 0  # unfilled tail
    mask[0, :left_pad] = 0  # left padding
    bf = lambda a: None if a is None else torch.from_numpy(np.asarray(a, np.float32)).to(  # noqa: E731
        torch.bfloat16)
    tq = bf(q)
    tk, tv = (torch.from_numpy(k), torch.from_numpy(v)) if int8 else (bf(k), bf(v))
    return tq, tk, tv, torch.from_numpy(mask), bf(ks), bf(vs)


def _jax(q, k, v, mask, ks, vs):
    j = lambda t: None if t is None else jnp.asarray(  # noqa: E731
        t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
        jnp.bfloat16 if t.dtype == torch.bfloat16 else None)
    args = [j(q), j(k), j(v), j(mask)] + ([j(ks), j(vs)] if ks is not None else [])
    return np.asarray(jax_decode.decode_attention_fused(*args, interpret=True), np.float32)


@pytest.mark.parametrize("splits", [1, 3, 8])
@pytest.mark.parametrize("int8,left_pad", [(False, 3), (True, 3), (False, 130)],
                         ids=["bf16", "int8", "bf16-two-padded-tiles"])
def test_split_model_matches_jax(int8, left_pad, splits):
    """At 8 ranges over 8 tiles the last two ranges lie wholly in the
    unfilled tail, and with 130 slots of left padding the first two wholly
    in row 0's padding (m_i = -1e30, weighed by exp(-1e30 - m) = 0); the
    result is within 2e-2 of JAX's Pallas kernel and of the plain version."""
    q, k, v, mask, ks, vs = _case(int8, left_pad=left_pad)
    got = split_decode(q, k, v, mask, splits, ks, vs).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(q, k, v, mask, ks, vs), atol=2e-2, rtol=0)
    plain = attention.decode_attention(q, k, v, mask, ks, vs).float().numpy()
    np.testing.assert_allclose(got, plain, atol=2e-2, rtol=0)


def test_split_model_row_without_valid_slot():
    """A row whose mask is all zero: every range reports m_i = -1e30 and l_i
    its slot count, so the row is the uniform mean of V over its S slots, as
    in the plain version (not NaN)."""
    q, k, v, mask, ks, vs = _case(False)
    mask[1] = 0
    got = split_decode(q, k, v, mask, 3).float()
    want = attention.decode_attention(q, k, v, mask).float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[1], want[1], atol=2e-2, rtol=0)
    mean = v[1].float().mean(0).repeat_interleave(q.shape[2] // v.shape[2], 0)
    torch.testing.assert_close(got[1, 0], mean.to(torch.bfloat16).float(), atol=1e-2, rtol=0)


@pytest.mark.parametrize("b,kh,s", [(1, 8, 5248), (4, 8, 5248), (1, 1, 5248), (1, 8, 1152),
                                    (4, 25, 1152), (64, 8, 1152), (1, 8, 64), (2, 2, 100)])
def test_num_splits_gives_nonempty_ranges(b, kh, s):
    """Every range the kernel cuts is non-empty, whole tiles but the last,
    in order and covering the cache; there are at most as many as tiles,
    about one wave of blocks, and no range longer than it needs to be."""
    tiles = -(-s // attention_decode.KEYS)
    n = attention_decode.num_splits(b, kh, s, 132)
    assert 1 <= n <= tiles
    ranges = attention_decode.split_ranges(s, n)
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(hi > lo and lo % attention_decode.KEYS == 0 for lo, hi in ranges)
    assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
    longest = max(-(-(hi - lo) // attention_decode.KEYS) for lo, hi in ranges)
    assert n * b * kh <= attention_decode.BLOCKS_PER_SM * 132 or n == 1
    assert longest == -(-tiles // n)  # balanced: the slowest range sets the time
    for forced in (1, tiles):
        assert len(attention_decode.split_ranges(s, forced)) == forced


def test_int8_linear_path_choice():
    """Up to GEMV_MAX_M rows (decode) take the GEMV kernel, more the tensor
    cores.  The tile: a 1,152-token prefill of Llama's 8192-wide gate
    projection takes the 144-token tile (512 blocks: two even waves of two
    blocks an SM, where 128 tokens give 576), a 1k prompt the 128-token one,
    and the narrow k/v projection (N 512) a one-warpgroup tile, since two
    warpgroups' tiles would leave most SMs idle."""
    assert 1 <= int8_linear.GEMV_MAX_M < 16
    for m in range(1, int8_linear.GEMV_MAX_M + 1):
        assert int8_linear.choose_path(m) == "gemv"
    for m in (int8_linear.GEMV_MAX_M + 1, 16, 1000, 1152, 4992):
        assert int8_linear.choose_path(m) == "tc"
    tiles = int8_linear.TC_TILES

    def tile(m, n):
        return tiles[int8_linear.choose_tile(m, n, 132)]

    assert tile(1152, 8192) == (128, 144)
    assert tile(1024, 8192) == (128, 128)
    assert tile(1152, 512) == (64, 64)
    assert tile(16, 8192) == (64, 64)
    for m, n in [(1152, 8192), (1152, 2048), (1152, 512), (17, 8192), (1152, 4800),
                 (1152, 1600), (4992, 8192), (300, 2048)]:
        bw, bt = tile(m, n)
        blocks = -(-m // bt) * -(-n // bw)
        assert bw == 64 or 2 * blocks >= 132  # two warpgroups only where they fill the card
    # a CPU tensor takes the plain version whatever the path
    x = torch.randn(20, 32).to(torch.bfloat16)
    q = torch.randint(-127, 128, (16, 32), dtype=torch.int8)
    sc = torch.rand(16).to(torch.bfloat16)
    want = int8_linear.int8_linear_plain(x, q, sc)
    for path in (None, "gemv", "tc"):
        assert torch.equal(int8_linear.int8_linear(x, q, sc, path=path), want)
    assert int8_linear.int8_linear.launches == int8_linear.int8_linear.tc_launches == 0
