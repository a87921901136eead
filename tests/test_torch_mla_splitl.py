"""The Split-L arithmetic of the paged MLA kernel, emulated on the CPU in f32.

Nothing here can compile the CUDA kernel (csrc/paged_mla_attention.cu), so
these tests repeat its arithmetic with the splits the wrappers' plan
(``mla_plan``) picks: each split's keys are walked in 32-key tiles; a tile's
row maxima are taken over all its keys (the block's warps meet in shared
memory), each row keeps f32 partials (max m in log2 units, sum l,
accumulator acc) rescaled tile by tile; a row that sees no key of a split
keeps m = NEG_INF, l = 0 and writes no acc, and the combine drops it; the
combine merges the splits in split order. The result is held against the
plain version (f32: 2e-5) and against the JAX reference's own split of the
same identity on the same latent rows: ``decode_partial_stats`` per split
on ``_gather_latent_pages``' keys (Dk = r + rd) and values (Dv = r), merged
by ``combine_partial_stats`` under ``jax.vmap`` with an axis name. The
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py).
"""
import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    _gather_latent_pages, combine_partial_stats, decode_partial_stats)
import repro_torch.kernels.decode_attention as da  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    gather_latent_pages, mla_plan, paged_mla_decode_attention_plain,
    paged_mla_verify_attention_plain)

NEG_INF = -1e30
LOG2E = 1.0 / math.log(2.0)
TOL = dict(atol=2e-5, rtol=2e-5)
TILE, ROWS, SMS = 32, 16, 132


def _latent_pool(seed, S, H, r, rd, page, lens, masked=True):
    """Rows b hold ``lens[b]`` tokens in fragmented pages of a latent pool
    (one spare table entry: the null page); the queries are each row's
    last S tokens. With ``masked`` row 0's last query is a masked slot at
    pos 2^30, which sees every slot (the null page once per unused table
    entry)."""
    rng = np.random.RandomState(seed)
    B = len(lens)
    n_max = -(-max(lens) // page) + 1
    P = 2 + sum(-(-n // page) for n in lens)
    ids = rng.permutation(np.arange(2, P))
    table = np.zeros((B, n_max), np.int32)
    pos = np.full((P, page), 2 ** 30, np.int32)
    nxt = 0
    for b, n in enumerate(lens):
        for j in range(-(-n // page)):
            table[b, j] = ids[nxt]
            p = np.arange(j * page, (j + 1) * page)
            pos[ids[nxt]] = np.where(p < n, p, 2 ** 30)
            nxt += 1
    q_pos = np.stack([np.arange(n - S, n) for n in lens]).astype(np.int32)
    if masked:
        q_pos[0, -1] = 2 ** 30
    q = rng.randn(B, S, H, r + rd).astype(np.float32)
    ckv = rng.randn(P, page, r).astype(np.float32)
    kr = rng.randn(P, page, rd).astype(np.float32)
    return q, ckv, kr, pos, table, q_pos


def mla_splitl_emulated(q, ckv, kr, pos, table, q_pos, *, scale,
                        keys_per_split, window=None):
    """The MLA kernel's arithmetic in f32. q (B, S, H, r + rd); returns
    the output (B, S, H, r) and the per-split partials [(m, l, acc)], each
    (B, S*H[, r]) over the flattened query rows."""
    k, v, kv_pos = gather_latent_pages(ckv, kr, pos, table)
    k, v = k[:, :, 0], v[:, :, 0]
    B, S, H, Dk = q.shape
    L = k.shape[1]
    qr = q.reshape(B, S * H, Dk)
    qp = q_pos.repeat_interleave(H, dim=1)                  # (B, S*H)
    s = torch.einsum("brd,bld->brl", qr, k) * (scale * LOG2E)
    ok = kv_pos[:, None, :] <= qp[:, :, None]
    if window is not None:
        ok &= (qp[:, :, None] - kv_pos[:, None, :]) < window
    splits = []
    for k0 in range(0, L, keys_per_split):
        m = torch.full((B, S * H), NEG_INF)
        l = torch.zeros(B, S * H)
        acc = torch.zeros(B, S * H, v.shape[-1])
        for t0 in range(k0, min(L, k0 + keys_per_split), TILE):
            t = slice(t0, min(L, t0 + TILE))
            st, okt = s[..., t], ok[..., t]
            tmax = torch.where(okt, st, torch.full_like(st, NEG_INF)).amax(-1)
            mn = torch.where(tmax == NEG_INF, m, torch.maximum(m, tmax))
            corr = torch.exp2(m - mn)
            p = torch.where(okt, torch.exp2(st - mn[..., None]),
                            torch.zeros_like(st))
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("brl,bld->brd", p,
                                                       v[:, t])
            m = mn
        splits.append((m, l, torch.where(l[..., None] != 0, acc,
                                         torch.zeros_like(acc))))
    mx = splits[0][0]
    for m, _, _ in splits[1:]:
        mx = torch.maximum(mx, m)
    l_sum = torch.zeros_like(mx)
    out = torch.zeros_like(splits[0][2])
    for m, l, acc in splits:
        w = torch.where(l != 0, torch.exp2(m - mx), torch.zeros_like(m))
        l_sum = l_sum + w * l
        out = out + w[..., None] * acc
    out = out / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.reshape(B, S, H, -1), splits


def jax_split_reference(q, ckv, kr, pos, table, q_pos, *, scale,
                        keys_per_split, window=None):
    """The JAX package's split of the same identity on its own latent
    gather: ``decode_partial_stats`` on each split's keys, merged across a
    vmapped axis by ``combine_partial_stats``. Returns the output (B, S,
    H, r) and the per-split (pv, m, l) in natural-log units."""
    k, v, kv_pos = (np.asarray(t) for t in _gather_latent_pages(
        jnp.asarray(ckv), jnp.asarray(kr), jnp.asarray(pos),
        jnp.asarray(table)))
    B, S, H, _ = q.shape
    L = k.shape[1]
    zq, parts = np.zeros_like(q_pos), []
    for k0 in range(0, L, keys_per_split):
        sl = slice(k0, min(L, k0 + keys_per_split))
        parts.append(decode_partial_stats(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(q_pos), jnp.asarray(kv_pos[:, sl]), jnp.asarray(zq),
            jnp.asarray(np.zeros_like(kv_pos[:, sl])), window=window,
            scale=scale))
    pv, m, l = (jnp.stack(x) for x in zip(*parts))
    out = jax.vmap(lambda a, b, c: combine_partial_stats(a, b, c, "split"),
                   axis_name="split")(pv, m, l)[0]     # (B, 1, H, S, r)
    out = np.asarray(out).transpose(0, 3, 1, 2, 4).reshape(B, S, H, -1)
    return out, parts


# (S, H, r, rd, page, lens, window, masked): full-width decode with an
# inactive slot (pos 2^30) and verify with a masked token; the reduced
# width's decode and verify (the shape phase 13 runs); a window that leaves
# the first splits dead; a short row whose later splits see no key
CASES = {
    "decode": (1, 16, 512, 64, 16, (40, 700, 1100, 300), None, True),
    "verify": (5, 16, 512, 64, 16, (100, 1060, 517, 64), None, True),
    "reduced_decode": (1, 4, 64, 16, 4, (6, 600, 97), None, True),
    "reduced_verify": (4, 4, 64, 16, 8, (9, 530, 333), None, True),
    "window": (5, 16, 512, 64, 16, (300, 777), 128, False),
    "dead_split": (1, 16, 512, 64, 16, (5, 1000), None, False),
}


def _case(name, seed=0):
    S, H, r, rd, page, lens, window, masked = CASES[name]
    arrays = _latent_pool(seed, S, H, r, rd, page, lens, masked=masked)
    L = arrays[4].shape[1] * page
    plan = mla_plan(len(lens), S, H, L, SMS)
    assert plan["splits"] > 1
    return arrays, window, plan, (r // 4 + rd) ** -0.5


@pytest.mark.parametrize("name", sorted(CASES))
def test_mla_split_and_combine_matches_plain(name):
    arrays, window, plan, scale = _case(name)
    t = [torch.from_numpy(a) for a in arrays]
    got, splits = mla_splitl_emulated(*t, scale=scale, window=window,
                                      keys_per_split=plan["keys_per_split"])
    assert len(splits) == plan["splits"]
    if t[0].shape[1] == 1:
        want = paged_mla_decode_attention_plain(
            t[0][:, 0], *t[1:5], t[5][:, 0], scale=scale, window=window)
        got = got[:, 0]
    else:
        want = paged_mla_verify_attention_plain(*t, scale=scale,
                                                window=window)
    torch.testing.assert_close(got, want, **TOL)
    if name in ("window", "dead_split"):
        # some split sees no key of some row: m = NEG_INF, l = 0, acc = 0,
        # and the combine weighs it by exactly 0
        dead = [(m == NEG_INF) for m, _, _ in splits]
        assert any(bool(d.any()) for d in dead)
        for (m, l, acc), d in zip(splits, dead):
            assert bool((l[d] == 0).all()) and bool((acc[d] == 0).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_mla_split_and_combine_matches_jax_split(name):
    """Split by split, the emulated partials equal JAX's where the split
    sees a key (JAX's m in natural-log units; its l and pv of a dead split
    are garbage the combine weighs by 0; acc held as the split's own
    output acc / l), and the combined outputs agree."""
    arrays, window, plan, scale = _case(name, seed=1)
    ks = plan["keys_per_split"]
    got, splits = mla_splitl_emulated(
        *(torch.from_numpy(a) for a in arrays), scale=scale,
        keys_per_split=ks, window=window)
    want, parts = jax_split_reference(*arrays, scale=scale,
                                      keys_per_split=ks, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    B, S, H, _ = arrays[0].shape
    for (m, l, acc), (pv, jm, jl) in zip(splits, parts):
        # JAX's (B, 1, H, S[, r]) -> (B, S*H[, r]), rows s-major
        jm, jl = (np.asarray(x).transpose(0, 3, 1, 2).reshape(B, S * H)
                  for x in (jm, jl))
        jpv = np.asarray(pv).transpose(0, 3, 1, 2, 4).reshape(B, S * H, -1)
        live = m.numpy() > NEG_INF
        assert bool((jm[~live] == NEG_INF).all())
        np.testing.assert_allclose(m.numpy()[live] * math.log(2.0),
                                   jm[live], **TOL)
        np.testing.assert_allclose(l.numpy()[live], jl[live], **TOL)
        # the accumulators sum up to 512 keys' p v unnormalized, so their
        # rounding grows with l: compare each split's own output acc / l
        ln = l.numpy()[live][:, None]
        np.testing.assert_allclose(acc.numpy()[live] / ln, jpv[live] / ln,
                                   **TOL)


# (B, S, H, L): chip_smoke's phase-2 shapes (decode B 4 and B 16 to 8k,
# the spec verify block), the serving engine's (max prompt 1024 + 32 new),
# a long single row, a wide batch, the reduced width, one short context
PLAN_SHAPES = [(4, 1, 16, 1104), (16, 1, 16, 8208), (4, 5, 16, 1088),
               (4, 1, 16, 1056), (1, 1, 16, 65536), (64, 1, 16, 2048),
               (2, 4, 4, 64), (3, 1, 4, 608), (8, 5, 16, 96),
               (100, 1, 16, 672), (40, 5, 16, 1100)]


@pytest.mark.parametrize("B,S,H,L", PLAN_SHAPES)
def test_mla_plan_fills_the_card_and_bounds_the_partials(B, S, H, L):
    """Whole 32-key tiles a split, every key in exactly one split, 64 to
    1024 keys a split; two blocks per SM where the context allows. Above
    one split, at least 256 keys a split, so that the f32 partials
    (written once, read once by the combine) stay within a quarter of the
    bf16 latent bytes a full split reads at both built widths, unless
    256-key splits would leave fewer than two blocks per SM."""
    p = mla_plan(B, S, H, L, SMS)
    ks, n, groups = p["keys_per_split"], p["splits"], p["row_groups"]
    assert ks % TILE == 0 and 64 <= ks <= 1024 or n == 1
    assert (n - 1) * ks < L <= n * ks
    assert groups == -(-S * H // ROWS)
    assert p["blocks"] == n * groups * B
    small = B * groups * -(-L // 256) < 2 * SMS  # 256-key splits leave SMs idle
    # two blocks per SM, or as near as whole tiles allow: a split cannot
    # shrink (64 keys; 256 unless small; the whole context) or a tile fewer
    # a split would pass two blocks per SM
    assert p["blocks"] >= 2 * SMS or ks == (64 if small else 256) \
        or n == 1 or B * groups * -(-L // (ks - TILE)) > 2 * SMS
    if n > 1 and ks < 256:
        assert small
    if ks >= 256:
        for r, rd in da._MLA_SHAPES:
            partial = 2 * ROWS * (r + 2) * 4
            assert partial <= 0.25 * ks * (r + rd) * 2


def test_mla_plan_at_the_phase_2_shapes():
    """The numbers ``mla_plan``'s docstring gives."""
    assert mla_plan(4, 1, 16, 1104, SMS) == {
        "regime": "splitl", "splits": 18, "keys_per_split": 64,
        "row_groups": 1, "blocks": 72}
    assert mla_plan(16, 1, 16, 8208, SMS) == {
        "regime": "splitl", "splits": 16, "keys_per_split": 544,
        "row_groups": 1, "blocks": 256}
    assert mla_plan(4, 5, 16, 1088, SMS) == {
        "regime": "splitl", "splits": 12, "keys_per_split": 96,
        "row_groups": 5, "blocks": 240}


@pytest.mark.parametrize("verify", [False, True])
def test_mla_wrapper_hands_the_kernel_its_plan(monkeypatch, verify):
    """The C entry point works out no split of its own: it takes the
    plan's splits and keys per split, which the wrapper also records in
    LAST_PLAN, with one f32 scratch allocation above one split. The launch
    is recorded instead of run; one wrapper call counts one launch."""
    calls, counted = [], []
    monkeypatch.setattr(da.build, "entry",
                        lambda name, symbol, argtypes:
                        lambda *a: calls.append((len(argtypes), a)))
    monkeypatch.setattr(da, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(da, "count_launch", counted.append)
    monkeypatch.setattr(da.build, "stream", lambda t: ctypes.c_void_p(0))
    B, S, H, page, n_max = (4, 5, 16, 16, 68) if verify else \
        (16, 1, 16, 16, 513)
    lead = (B, S) if verify else (B,)       # the decode wrapper's q is 3-D
    args = (torch.zeros(*lead, H, 576), torch.zeros(2, page, 512),
            torch.zeros(2, page, 64), torch.zeros(2, page, dtype=torch.int32),
            torch.zeros(B, n_max, dtype=torch.int32),
            torch.zeros(lead, dtype=torch.int32))
    name = ("paged_mla_verify_attention" if verify
            else "paged_mla_decode_attention")
    out = da._launch_mla(name, *args, 0.07, None, S)
    plan = mla_plan(B, S, H, n_max * page, SMS)
    assert da.LAST_PLAN[name] == plan and counted == [name]
    assert out.shape == (*lead, H, 512)
    (n_types, a), = calls
    assert len(a) == n_types
    ints = a[9:-2]              # after the pointers; before scale, stream
    assert ints[:5] == (B, S, H, 512, 64)
    assert (ints[-2], ints[-1]) == (plan["splits"], plan["keys_per_split"])
    assert plan["splits"] > 1 and a[7].value is not None
    assert a[8].value - a[7].value == 4 * plan["splits"] * B * S * H * 512
