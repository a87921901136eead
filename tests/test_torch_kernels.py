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

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged_decode  # noqa: E402
from repro.kernels.spa_attention import spa_attention as jax_spa  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.spa_attention import (  # noqa: E402
    chunked_attention, spa_attention)

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
