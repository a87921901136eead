"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels
run in interpret mode, as tests/test_kernels.py runs them. Inputs come
from a seeded numpy generator and go through both. Tolerances: f32 2e-5,
bf16 3e-2 (the JAX kernel tests' bars). The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py
and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged_decode  # noqa: E402
from repro.kernels.spa_attention import spa_attention as jax_spa  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.spa_attention import (  # noqa: E402
    allow_mask, chunked_attention, spa_attention, spa_attention_bwd_plain)

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}


def spa_layout(seed, B, Lp, Lr, K, H, Hkv, D, pad_tail=0):
    """A shared-prompt packed row [prompt, r_1..r_K] (+ optional pad), as
    tests/test_kernels.py builds it, from numpy."""
    S = Lp + K * Lr + pad_tail
    pos = np.zeros((B, S), np.int32)
    seg = np.full((B, S), -1, np.int32)
    pos[:, :Lp] = np.arange(Lp)
    seg[:, :Lp] = 0
    off = Lp
    for k in range(K):
        pos[:, off:off + Lr] = np.arange(Lp, Lp + Lr)
        seg[:, off:off + Lr] = k + 1
        off += Lr
    if pad_tail:
        pos[:, off:] = 2 ** 30 - 1
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, S, Hkv, D).astype(np.float32)
    v = rng.randn(B, S, Hkv, D).astype(np.float32)
    return q, k, v, pos, seg


def _both(dtype, *arrays):
    """The same float inputs as JAX and torch arrays of ``dtype`` (both
    round f32 -> bf16 to nearest even)."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, th


def _run_spa(q, k, v, pos, seg, dtype, bq, bk, window=None):
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, k, v)
    want = jax_spa(jq, jk, jv, pos, pos, seg, seg, window=window,
                   block_q=bq, block_k=bk, interpret=True)
    tp, ts = torch.from_numpy(pos), torch.from_numpy(seg)
    got = spa_attention(tq, tk, tv, tp, tp, ts, ts, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,Lp,Lr,K,H,Hkv,D,bq,bk",
    [
        (1, 32, 16, 2, 2, 2, 64, 16, 16),     # MHA, tiny tiles
        (2, 40, 24, 3, 4, 2, 64, 32, 32),     # GQA 2:1, non-divisible -> pad
        (1, 64, 32, 4, 8, 2, 128, 64, 64),    # GQA 4:1, wide head
        (1, 17, 9, 2, 2, 1, 32, 16, 16),      # ragged lengths
    ])
def test_spa_plain_matches_jax_kernel(dtype, B, Lp, Lr, K, H, Hkv, D, bq, bk):
    got, want = _run_spa(*spa_layout(0, B, Lp, Lr, K, H, Hkv, D), dtype,
                         bq, bk)
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("window", [8, 32])
def test_spa_plain_window_matches_jax_kernel(window):
    got, want = _run_spa(*spa_layout(1, 2, 32, 16, 2, 4, 2, 64), "float32",
                         16, 16, window=window)
    np.testing.assert_allclose(got, want, **TOL["float32"])


def test_spa_plain_padding_tail_matches_jax_kernel():
    """Rows padded past the packed content must not leak into real rows."""
    got, want = _run_spa(*spa_layout(2, 2, 24, 8, 2, 2, 2, 32, pad_tail=24),
                         "float32", 16, 16)
    real = 24 + 2 * 8
    np.testing.assert_allclose(got[:, :real], want[:, :real],
                               **TOL["float32"])


def test_spa_plain_row_without_visible_key_is_zero():
    """A query that sees no key returns exactly 0 (JAX returns an average
    of masked values there, so such rows are left out of the comparisons
    above); the CUDA kernel returns 0 too."""
    q, k, v, pos, seg = spa_layout(3, 1, 8, 4, 2, 2, 2, 64)
    qseg = seg.copy()
    qseg[0, -1] = 7                  # a segment no key carries ...
    qpos = pos.copy()
    qpos[0, -1] = -1                 # ... and before every prompt key
    t = torch.from_numpy
    out = spa_attention(t(q), t(k), t(v), t(qpos), t(pos), t(qseg), t(seg))
    assert torch.all(out[0, -1] == 0)
    assert torch.isfinite(out).all()


def _page_pool(seed, H, Hkv, D):
    """The page pool of tests/test_kernel_integration.py (pages 2..5 hold
    two rows' histories at positions 0..7) plus a third, inactive row
    (q_pos 2^30) that sees every slot, null page included."""
    rng = np.random.RandomState(seed)
    P, page = 6, 4
    k_pages = rng.randn(P, page, Hkv, D).astype(np.float32)
    v_pages = rng.randn(P, page, Hkv, D).astype(np.float32)
    pos = np.full((P, page), 2 ** 30, np.int32)
    for j, p0 in ((2, 0), (3, 4), (4, 0), (5, 4)):
        pos[j] = np.arange(p0, p0 + page)
    table = np.asarray([[2, 3, 0], [4, 5, 0], [2, 0, 0]], np.int32)
    q_pos = np.asarray([7, 5, 2 ** 30], np.int32)
    q = rng.randn(3, H, D).astype(np.float32)
    return q, k_pages, v_pages, pos, table, q_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hkv,D", [(4, 2, 64), (8, 2, 64), (6, 2, 128)])
def test_paged_decode_plain_matches_jax_kernel(dtype, H, Hkv, D):
    q, kp, vp, pos, table, q_pos = _page_pool(4, H, Hkv, D)
    (jq, jk, jv), (tq, tk, tv) = _both(dtype, q, kp, vp)
    want = jax_paged_decode(jq, jk, jv, pos, table, q_pos, interpret=True)
    t = torch.from_numpy
    got = paged_decode_attention(tq, tk, tv, t(pos), t(table), t(q_pos))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q, kp, vp, pos, table, q_pos = _page_pool(5, 4, 2, 64)
    t = torch.from_numpy
    before = dict(LAUNCHES)
    a = paged_decode_attention(t(q), t(kp), t(vp), t(pos), t(table), t(q_pos))
    b = paged_decode_attention_plain(t(q), t(kp), t(vp), t(pos), t(table),
                                     t(q_pos))
    assert torch.equal(a, b)
    q2, k2, v2, p2, s2 = map(t, spa_layout(6, 1, 8, 4, 2, 2, 2, 64))
    assert torch.equal(spa_attention(q2, k2, v2, p2, p2, s2, s2),
                       chunked_attention(q2, k2, v2, p2, p2, s2, s2))
    assert LAUNCHES == before


def test_wrappers_refuse_devices_without_a_kernel():
    """The kernel is chosen by the tensor's device: no device other than
    the CPU (plain version) or CUDA (the kernel) is taken."""
    q = torch.zeros((1, 4, 2, 64), device="meta")
    p = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        spa_attention(q, q, q, p, p, p, p)
    with pytest.raises(ValueError, match="no kernel"):
        paged_decode_attention(q[:, 0], q, q, p, p, p[:, 0])


def test_launch_counts_are_not_lost_across_threads():
    """Rollout producer threads and the trainer launch kernels at once:
    every counted launch must show, with threads switching as often as
    the interpreter allows."""
    import sys
    import threading

    from repro_torch.kernels import LAUNCHES, count_launch
    n_threads, per_thread = 16, 2000
    before = LAUNCHES["transfer_cast"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [count_launch("transfer_cast")
                            for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert LAUNCHES["transfer_cast"] == before + n_threads * per_thread
    LAUNCHES["transfer_cast"] = before


# ---------------------------------------------------------------------------
# Why the bf16 SPA kernels split P and dS into a bf16 hi + lo pair
# ---------------------------------------------------------------------------

# the bars chip_smoke.py and tests/test_torch_cuda.py hold the bf16 kernels
# to: one bf16 ulp (2^-7 of the value) plus 1e-5; the gradients' atol is
# relative to each tensor's largest entry
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
BF16_GRAD_TOL = (2.0 ** -7, 1e-5)


def _tensor_core_operand(x, split):
    """f32 ``x`` as the bf16 kernels feed it to a tensor-core product:
    rounded once to bf16, or as the sum of hi = bf16(x) and lo = bf16(x -
    hi) (both go through the product; hi + lo is exact in f32)."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if split else hi


def _heads(q, k, v):
    G = q.shape[2] // k.shape[2]
    return (q.permute(0, 2, 1, 3),
            k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1),
            v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1))


def _emulated_forward(q, k, v, allow, split, tile=64):
    """The bf16 forward kernel's arithmetic: f32 scores of bf16 inputs, an
    online softmax over 64-key tiles, P rounded for P V, f32 accumulation,
    one rounding of the output."""
    qh, kh, vh = _heads(q, k, v)
    scale = q.shape[-1] ** -0.5
    B, H, Sq, D = qh.shape
    m = torch.full((B, H, Sq), -1e30)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, D))
    for k0 in range(0, kh.shape[2], tile):
        ok = allow[:, None, :, k0:k0 + tile]
        s = torch.where(ok, qh @ kh[:, :, k0:k0 + tile].transpose(-1, -2) * scale,
                        -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + \
            _tensor_core_operand(p, split) @ vh[:, :, k0:k0 + tile]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


def _emulated_backward(q, k, v, allow, dout, split):
    """The bf16 backward kernels' arithmetic: P and dS in f32 from bf16
    inputs, rounded for the three gradient products, f32 sums over the G
    heads of a KV head, one rounding of each gradient."""
    qh, kh, vh = _heads(q, k, v)
    gh = dout.permute(0, 2, 1, 3)
    scale = q.shape[-1] ** -0.5
    G = q.shape[2] // k.shape[2]
    ok = allow[:, None]
    s = torch.where(ok, qh @ kh.transpose(-1, -2) * scale, -1e30)
    p = torch.where(ok, torch.exp(s - torch.logsumexp(s, -1, keepdim=True)), 0.0)
    delta = (gh * (p @ vh)).sum(-1, keepdim=True)
    ds = p * (gh @ vh.transpose(-1, -2) - delta)
    pr, dsr = _tensor_core_operand(p, split), _tensor_core_operand(ds, split)

    def kv_heads(x):                   # (B, H, S, D) -> (B, S, Hkv, D)
        B, H, S, D = x.shape
        return x.reshape(B, H // G, G, S, D).sum(2).permute(0, 2, 1, 3)
    dq = (scale * dsr @ kh).permute(0, 2, 1, 3)
    dk = kv_heads(scale * dsr.transpose(-1, -2) @ qh)
    dv = kv_heads(pr.transpose(-1, -2) @ gh)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _within_grad_bar(got, want):
    rtol, atol_rel = BF16_GRAD_TOL
    err = (got.float() - want).abs()
    return bool((err <= rtol * want.abs() + atol_rel * want.abs().max()).all())


def _paged_suffix_bf16(seed=13, cached=512, S=512, page=16):
    """The radix suffix prefill at full-width heads (H 24, Hkv 8, D 128):
    ``cached`` + S tokens in fragmented pages of a pool (and one unused
    table entry, the null page), the last S tokens the queries, bf16
    values as f32. Returns the paged inputs and the gathered context."""
    from repro_torch.kernels.decode_attention import gather_pages
    rng = np.random.RandomState(seed)
    n = cached + S
    n_max = n // page + 1
    P = 2 + n // page
    table = np.zeros((1, n_max), np.int32)
    table[0, :n // page] = rng.permutation(np.arange(2, P))
    pos = np.full((P, page), 2 ** 30, np.int32)
    pos[table[0, :n // page]] = np.arange(n).reshape(-1, page)
    bf = [torch.from_numpy(rng.randn(*shape).astype(np.float32))
          .to(torch.bfloat16).float()
          for shape in ((1, S, 24, 128), (P, page, 8, 128), (P, page, 8, 128))]
    paged = (*bf, torch.from_numpy(pos), torch.from_numpy(table),
             torch.arange(cached, n, dtype=torch.int32)[None])
    k, v, kv_pos = gather_pages(*paged[1:5])
    return paged, (k, v, kv_pos[:, None, :] <= paged[5][:, :, None])


@pytest.mark.parametrize("layout", [(512, 0, 0), (256, 64, 4), "suffix512"],
                         ids=["prompt512", "packed", "suffix512"])
def test_bf16_split_probabilities_meet_the_bar(layout):
    """bf16 inputs at full-width heads (H 24, Hkv 8, D 128): P (forward)
    and P and dS (backward) fed to the tensor cores as a bf16 hi + lo pair
    meet the kernels' bars against the plain versions run in f32; rounded
    once to bf16 they miss them, which is why the kernels split. The
    paged verify kernel's query tiles take the same forward: "suffix512"
    is its radix suffix prefill, 512 query tokens (x G 3 flattened rows)
    over 1024 paged keys in 64-key tiles (no backward there)."""
    if layout == "suffix512":
        from repro_torch.kernels.decode_attention import \
            paged_verify_attention_plain
        paged, (k, v, allow) = _paged_suffix_bf16()
        want = paged_verify_attention_plain(*paged)
        fwd = {split: torch.allclose(
            _emulated_forward(paged[0], k, v, allow, split).float(), want,
            **BF16_TOL) for split in (True, False)}
        assert fwd[True] and not fwd[False]
        return
    Lp, Lr, K = layout
    q, k, v, pos, seg = spa_layout(11, 1, Lp, Lr, K, 24, 8, 128)
    rng = np.random.RandomState(12)
    bf = [torch.from_numpy(a).to(torch.bfloat16).float()
          for a in (q, k, v, rng.randn(*q.shape).astype(np.float32))]
    tp, ts = torch.from_numpy(pos), torch.from_numpy(seg)
    allow = allow_mask(tp, tp, ts, ts)
    want = chunked_attention(*bf[:3], tp, tp, ts, ts)
    want_g = spa_attention_bwd_plain(*bf[:3], tp, tp, ts, ts, bf[3])
    fwd = {split: torch.allclose(_emulated_forward(*bf[:3], allow, split).float(),
                                 want, **BF16_TOL) for split in (True, False)}
    bwd = {split: [_within_grad_bar(g, w) for g, w in zip(
        _emulated_backward(*bf[:3], allow, bf[3], split), want_g)]
        for split in (True, False)}
    assert fwd[True] and all(bwd[True])
    assert not fwd[False] and not any(bwd[False])
