"""The Split-L arithmetic of the paged decode and verify kernels, emulated
on the CPU in f32.

Nothing here can compile the CUDA kernels (csrc/splitl.cuh), so these
tests repeat their arithmetic with the splits the wrappers' plan
(``attention_plan``) picks: each split's keys are walked by four warps, 8
keys a step, each warp keeping f32 partials (max m in log2 units, sum l,
accumulator acc) over its keys; the block merges its warps in warp order
and writes (m, l, acc) per split; a split whose keys no query sees writes
m = NEG_INF, l = 0, acc = 0; the combine merges the splits in split order.
The result is held against the plain version (f32: 2e-5) and against the
JAX reference's own split of the same identity: ``decode_partial_stats``
per split, merged by ``combine_partial_stats`` under ``jax.vmap`` with an
axis name. The kernels themselves are held against the plain version on
the card (tests/test_torch_cuda.py).
"""
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: no intra-op pool

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import (  # noqa: E402
    combine_partial_stats, decode_partial_stats)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    attention_plan, gather_pages, paged_verify_attention_plain)

NEG_INF = -1e30
LOG2E = 1.0 / math.log(2.0)
TOL = dict(atol=2e-5, rtol=2e-5)
WARPS, KEYS_PER_WARP_STEP = 4, 8


def _pool(seed, S, H, Hkv, D, page, lens, n_extra=2, masked=True):
    """Rows b hold ``lens[b]`` tokens in fragmented pages of a pool; the
    queries are each row's last S tokens. With ``masked`` row 0's last
    query is a masked slot at pos 2^30, which sees every slot (the null
    page once per unused table entry)."""
    rng = np.random.RandomState(seed)
    B = len(lens)
    n_max = -(-max(lens) // page) + n_extra
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
    q = rng.randn(B, S, H, D).astype(np.float32)
    kp = rng.randn(P, page, Hkv, D).astype(np.float32)
    vp = rng.randn(P, page, Hkv, D).astype(np.float32)
    return q, kp, vp, pos, table, q_pos


def _stats(s, ok, v):
    """f32 partials of scores s (log2 units, (..., n)) over n keys with
    mask ok and values v (B, n, H, D): m, l, acc; no visible key gives
    m = NEG_INF, l = 0, acc = 0."""
    sc = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = sc.amax(-1) if s.shape[-1] else torch.full(s.shape[:-1], NEG_INF)
    p = torch.where(ok, torch.exp2(sc - m[..., None]), torch.zeros_like(s))
    return m, p.sum(-1), torch.einsum("bshl,blhd->bshd", p, v)


def _merge(parts):
    """(m, l, acc) partials merged in order: the kernels' identity."""
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    l_sum = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp2(m - mx)
        l_sum = l_sum + w * l
        acc = acc + w[..., None] * a
    return mx, l_sum, acc


def splitl_emulated(q, k_pages, v_pages, pos_pages, table, q_pos, *,
                    keys_per_split, window=None, scale=None):
    """The Split-L kernels' arithmetic in f32. q (B, S, H, D); returns the
    output (B, S, H, D) and the per-split partials [(m, l, acc)], each
    (B, S, H[, D])."""
    k, v, kv_pos = gather_pages(k_pages, v_pages, pos_pages, table)
    B, S, H, D = q.shape
    L, G = k.shape[1], H // k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    kh, vh = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,blhd->bshl", q, kh) * (scale * LOG2E)
    ok = kv_pos[:, None, None, :] <= q_pos[:, :, None, None]
    if window is not None:
        ok &= (q_pos[:, :, None, None] - kv_pos[:, None, None, :]) < window
    splits = []
    for k0 in range(0, L, keys_per_split):
        j = torch.arange(k0, min(L, k0 + keys_per_split))
        warp = ((j - k0) // KEYS_PER_WARP_STEP) % WARPS
        splits.append(_merge([
            _stats(s[..., j[warp == w]], ok[..., j[warp == w]],
                   vh[:, j[warp == w]]) for w in range(WARPS)]))
    _, l_sum, acc = _merge(splits)
    return acc / torch.clamp(l_sum, min=1e-30)[..., None], splits


def jax_split_reference(q, k_pages, v_pages, pos_pages, table, q_pos, *,
                        keys_per_split, window=None):
    """The JAX package's split of the same identity: its per-shard
    ``decode_partial_stats`` on each split's keys, merged across a
    vmapped axis by ``combine_partial_stats``. Returns the output (B, S,
    H, D) and the per-split (pv, m, l) in natural-log units."""
    k, v, kv_pos = (np.asarray(t) for t in gather_pages(
        torch.from_numpy(k_pages), torch.from_numpy(v_pages),
        torch.from_numpy(pos_pages), torch.from_numpy(table)))
    B, S, H, D = q.shape
    L = k.shape[1]
    zq, parts = np.zeros_like(q_pos), []
    for k0 in range(0, L, keys_per_split):
        sl = slice(k0, min(L, k0 + keys_per_split))
        parts.append(decode_partial_stats(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(q_pos), jnp.asarray(kv_pos[:, sl]), jnp.asarray(zq),
            jnp.asarray(np.zeros_like(kv_pos[:, sl])), window=window))
    pv, m, l = (jnp.stack(x) for x in zip(*parts))
    out = jax.vmap(lambda a, b, c: combine_partial_stats(a, b, c, "split"),
                   axis_name="split")(pv, m, l)[0]     # (B, Hkv, G, S, D)
    out = np.asarray(out).transpose(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return out, parts


# (S, H, Hkv, D, page, lens, window, masked): decode with an inactive slot
# (pos 2^30); a verify block with a masked slot; a window that leaves the
# first splits dead; a short row whose later splits see no key; G 16
CASES = {
    "decode": (1, 6, 2, 64, 4, (3, 200, 97), None, True),
    "verify": (3, 4, 2, 64, 8, (6, 230, 133), None, True),
    "window": (2, 4, 1, 32, 4, (150, 290), 24, False),
    "dead_split": (1, 4, 2, 64, 8, (5, 260), None, False),
    "g16": (2, 32, 2, 64, 16, (40, 300), None, True),
}


def _case(name, seed=0):
    S, H, Hkv, D, page, lens, window, masked = CASES[name]
    arrays = _pool(seed, S, H, Hkv, D, page, lens, masked=masked)
    L = arrays[4].shape[1] * page
    plan = attention_plan(len(lens), S, H, Hkv, L, 132, verify=S > 1)
    assert plan["regime"] == "splitl" and plan["splits"] > 1
    return arrays, window, plan


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_and_combine_matches_plain(name):
    arrays, window, plan = _case(name)
    t = [torch.from_numpy(a) for a in arrays]
    got, splits = splitl_emulated(*t, keys_per_split=plan["keys_per_split"],
                                  window=window)
    assert len(splits) == plan["splits"]
    want = paged_verify_attention_plain(*t, window=window)
    torch.testing.assert_close(got, want, **TOL)
    if name in ("window", "dead_split"):
        # some split sees no key of some row: m = NEG_INF, l = 0, acc = 0,
        # and the combine weighs it by exactly 0
        dead = [(m == NEG_INF) for m, _, _ in splits]
        assert any(bool(d.any()) for d in dead)
        for (m, l, acc), d in zip(splits, dead):
            assert bool((l[d] == 0).all()) and bool((acc[d] == 0).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_and_combine_matches_jax_split(name):
    """Split by split, the emulated partials equal JAX's where the split
    sees a key (JAX's m in natural-log units; its l and pv of a dead split
    are garbage the combine weighs by 0), and the combined outputs agree."""
    arrays, window, plan = _case(name, seed=1)
    ks = plan["keys_per_split"]
    got, splits = splitl_emulated(*(torch.from_numpy(a) for a in arrays),
                                  keys_per_split=ks, window=window)
    want, parts = jax_split_reference(*arrays, keys_per_split=ks,
                                      window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    B, S, H, D = arrays[0].shape
    for (m, l, acc), (pv, jm, jl) in zip(splits, parts):
        # JAX's (B, Hkv, G, S[, D]) -> (B, S, H[, D])
        jm, jl = (np.asarray(x).transpose(0, 3, 1, 2).reshape(B, S, H)
                  for x in (jm, jl))
        jpv = np.asarray(pv).transpose(0, 3, 1, 2, 4).reshape(B, S, H, D)
        live = m.numpy() > NEG_INF
        assert bool((jm[~live] == NEG_INF).all())
        np.testing.assert_allclose(m.numpy()[live] * math.log(2.0),
                                   jm[live], **TOL)
        np.testing.assert_allclose(l.numpy()[live], jl[live], **TOL)
        np.testing.assert_allclose(acc.numpy()[live], jpv[live], **TOL)


def test_plan_fills_the_card_and_covers_every_key():
    """The wrappers' plan: at least two waves of 132 SMs' blocks where the
    context allows, whole 32-key steps per split, every key in exactly
    one split, at most 4096 keys a split, groups of up to 16 query rows,
    and query tiles past 64 verify rows."""
    for B, S, H, Hkv, L, verify in [
            (4, 1, 24, 8, 1056, False), (16, 1, 24, 8, 8192, False),
            (8, 1, 24, 8, 192, False), (4, 5, 24, 8, 1088, True),
            (4, 1, 24, 8, 1060, False), (64, 1, 32, 8, 65536, False),
            (2, 1, 40, 2, 96, False), (1, 21, 24, 8, 4096, True),
            (32, 1, 24, 8, 288, False)]:
        p = attention_plan(B, S, H, Hkv, L, 132, verify=verify)
        R = S * H // Hkv
        assert p["regime"] == "splitl"
        ks, n = p["keys_per_split"], p["splits"]
        assert ks % 32 == 0 and ks <= 4096
        assert (n - 1) * ks < L <= n * ks
        assert p["row_groups"] == -(-R // (4 if R <= 4 else 8 if R <= 8
                                          else 16))
        assert p["blocks"] == n * Hkv * B * p["row_groups"]
        assert p["blocks"] >= 2 * 132 or ks == 32
    for (B, S, H, Hkv, L), bf16 in itertools.product(
            [(1, 512, 24, 8, 1040), (4, 300, 24, 8, 8192),
             (64, 33, 24, 8, 256), (1, 100, 32, 2, 97)], (True, False)):
        p = attention_plan(B, S, H, Hkv, L, 132, verify=True, bf16=bf16)
        tiles = -(-S * H // Hkv // (128 if bf16 else 64))
        ks, n = p["keys_per_split"], p["splits"]
        assert p["regime"] == "tiles" and p["row_groups"] == tiles
        assert ks % 64 == 0 and ks <= 4096 and (n - 1) * ks < L <= n * ks
        assert p["blocks"] == n * tiles * Hkv * B
        # split only while fewer than half a block per SM exists (or a
        # split would pass 4096 keys)
        if tiles * Hkv * B >= 66:
            assert n == -(-L // 4096)
        else:
            assert n > 1 or ks >= L


@pytest.mark.parametrize("verify", [False, True])
def test_wrapper_hands_the_kernel_its_plan(monkeypatch, verify):
    """The C entry points work out no split of their own: they take the
    plan's splits and keys per split (and, verify, its regime), which the
    wrapper also records in LAST_PLAN. The launch is recorded instead of
    run. At B 32, Hkv 8 and 288 keys the plan holds 128 keys a split in 3
    splits, where 3 splits of ceil(9 / 3) steps would hold 96."""
    import ctypes
    import repro_torch.kernels.decode_attention as da
    calls = []
    monkeypatch.setattr(da.build, "entry",
                        lambda name, symbol, argtypes:
                        lambda *a: calls.append((len(argtypes), a)))
    monkeypatch.setattr(da, "_sm_count", lambda device: 132)
    monkeypatch.setattr(da, "count_launch", lambda name: None)
    monkeypatch.setattr(da.build, "stream", lambda t: ctypes.c_void_p(0))
    B, H, Hkv, D, page, n_max = 32, 24, 8, 64, 16, 18
    S = 512 if verify else 1
    if verify:
        B = 1
    q = torch.zeros((B, S, H, D) if verify else (B, H, D))
    pages = torch.zeros(2, page, Hkv, D)
    args = (q, pages, pages, torch.zeros(2, page, dtype=torch.int32),
            torch.zeros(B, n_max, dtype=torch.int32),
            torch.zeros(q.shape[:-2], dtype=torch.int32))
    name = "paged_verify_attention" if verify else "paged_decode_attention"
    da._launch_paged(name, f"{name}_launch",
                     da._VERIFY_ARGTYPES if verify else da._DECODE_ARGTYPES,
                     *args, None, None, S, verify)
    plan = attention_plan(B, S, H, Hkv, n_max * page, 132, verify=verify)
    assert da.LAST_PLAN[name] == plan
    (n_types, a), = calls
    assert len(a) == n_types
    ints = a[9:-2]              # after the pointers; before scale, stream
    splits, ks = (ints[-3], ints[-2]) if verify else (ints[-2], ints[-1])
    assert (splits, ks) == (plan["splits"], plan["keys_per_split"])
    if verify:
        assert plan["regime"] == "tiles" and ints[-1] == 1
    else:
        assert (splits, ks) == (3, 128)
    assert (a[7].value is None) == (splits == 1)
