"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips without one (decided inside the test). The file imports nothing of
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version run in f32 on the same
inputs. Both kernels compute in f32 and round once at the output, so the
tolerance is f32 summation-order noise (2e-5), plus one bf16 ulp (2^-7 of
the value) for a bf16 result.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain, mla_decode_attention,
    mla_decode_attention_plain, paged_decode_attention,
    paged_decode_attention_plain, paged_mla_decode_attention,
    paged_mla_decode_attention_plain, paged_mla_verify_attention,
    paged_mla_verify_attention_plain, paged_verify_attention,
    paged_verify_attention_plain, verify_attention, verify_attention_plain)
from repro_torch.kernels.spa_attention import (  # noqa: E402
    _forward_kernel, chunked_attention, spa_attention, spa_attention_bwd,
    spa_attention_bwd_plain)
from repro_torch.kernels.transfer_cast import transfer_cast  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=1e-5, rtol=2.0 ** -7)}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _f32(*ts):
    """The same tensors, floating ones as float32 (exact)."""
    return tuple(t.float() if t.is_floating_point() else t for t in ts)


def _reduced_mla_dense():
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    return reduced_config(dataclasses.replace(
        get_config("deepseek-v2-lite-16b"), num_experts=0,
        num_experts_per_tok=0, num_shared_experts=0, moe_d_ff=0,
        first_k_dense=0, dense_d_ff=0))


def _to_dev(tree, dev):
    return {k: _to_dev(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _packed(dev, dtype, seed, Lp, Lr, K, H, Hkv, D):
    S = Lp + K * Lr
    pos = np.zeros((1, S), np.int32)
    seg = np.zeros((1, S), np.int32)
    pos[0, :Lp] = np.arange(Lp)
    for k in range(K):
        lo = Lp + k * Lr
        pos[0, lo:lo + Lr] = np.arange(Lp, Lp + Lr)
        seg[0, lo:lo + Lr] = k + 1
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    qkv = [torch.from_numpy(rng.randn(1, S, h, D).astype(np.float32))
           .to(dev, dt) for h in (H, Hkv, Hkv)]
    return (*qkv, torch.from_numpy(pos).to(dev), torch.from_numpy(seg).to(dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lp,Lr,K,H,Hkv,D,window", [
    (40, 24, 3, 4, 2, 64, None),       # reduced llama heads, ragged tiles
    (256, 64, 4, 24, 8, 128, None),    # full-width heads, SPA-packed
    (300, 0, 0, 24, 8, 128, 64),       # windowed prompt
])
def test_spa_kernel_matches_plain(dev, dtype, Lp, Lr, K, H, Hkv, D, window):
    q, k, v, pos, seg = _packed(dev, dtype, 0, Lp, Lr, K, H, Hkv, D)
    n0 = LAUNCHES["spa_attention"]
    got = spa_attention(q, k, v, pos, pos, seg, seg, window=window)
    assert LAUNCHES["spa_attention"] == n0 + 1
    want = chunked_attention(*_f32(q, k, v, pos, pos, seg, seg),
                             window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


# 16 rows with contexts up to 8k and one of 5 tokens: most of the short
# row's splits see no key
_LONG = tuple(int(n) for n in np.linspace(1024, 8192, 15)) + (5,)


def _launch_twice(name, fn, *args, **kw):
    """Two launches of a wrapper: each counts one launch of ``name`` and
    nothing else, and both give the same bits."""
    n0 = dict(LAUNCHES)
    got = fn(*args, **kw)
    again = fn(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == n0[name] + 2
    assert sum(LAUNCHES.values()) == sum(n0.values()) + 2
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,lens,window", [
    (3, 4, 2, 64, 4, (3, 17, 9), None),
    (4, 24, 8, 128, 16, (100, 1056, 517, 64), None),
    (16, 24, 8, 128, 16, _LONG, None),                # long rows, dead splits
    (4, 24, 8, 128, 16, (100, 1056, 517, 64), 128),   # first splits dead
    (3, 8, 8, 128, 16, (40, 700, 301), None),         # G 1
    (3, 32, 4, 128, 16, (40, 700, 301), None),        # G 8
    (3, 32, 2, 64, 16, (40, 700, 301), None),         # G 16, D 64
    (2, 40, 2, 64, 8, (90, 33), 16),                  # G 20: two row groups
    (32, 24, 8, 128, 16, tuple(range(9, 289, 9)), None),  # 3 splits of 128 keys
])
def test_paged_decode_kernel_matches_plain(dev, dtype, B, H, Hkv, D, page,
                                           lens, window):
    rng = np.random.RandomState(1)
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
    q_pos = np.asarray(lens, np.int32) - 1
    q_pos[0] = 2 ** 30                     # an inactive slot: sees every slot
    dt = getattr(torch, dtype)

    def t(a, float_=False):
        x = torch.from_numpy(np.asarray(a)).to(dev)
        return x.to(dt) if float_ else x
    args = (t(rng.randn(B, H, D).astype(np.float32), True),
            t(rng.randn(P, page, Hkv, D).astype(np.float32), True),
            t(rng.randn(P, page, Hkv, D).astype(np.float32), True),
            t(pos), t(table), t(q_pos))
    got = _launch_twice("paged_decode_attention", paged_decode_attention,
                        *args, window=window)
    want = paged_decode_attention_plain(*_f32(*args), window=window)
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("verify", [False, True])
def test_paged_kernels_refuse_a_plan_that_misses_keys(dev, monkeypatch,
                                                      verify):
    """The kernels run the wrapper's plan as given (they work out no split
    of their own) and refuse one whose splits leave keys out."""
    import repro_torch.kernels.decode_attention as da
    plan = da._plan
    monkeypatch.setattr(da, "_plan", lambda *a: {
        **plan(*a), "splits": 1, "keys_per_split": 64})
    rng = np.random.RandomState(2)
    P, pos, table, q_pos = _verify_pool(rng, 2, 3, 16, (300, 77))
    q = torch.randn(2, 3, 24, 128, device=dev)
    kv = torch.randn(P, 16, 8, 128, device=dev)
    args = [torch.from_numpy(a).to(dev) for a in (pos, table, q_pos)]
    with pytest.raises(RuntimeError, match="CUDA error"):
        if verify:
            paged_verify_attention(q, kv, kv, *args)
        else:
            paged_decode_attention(q[:, 0].contiguous(), kv, kv, *args[:2],
                                   args[2][:, 0].contiguous())


def _verify_pool(rng, B, S, page, lens, n_extra=1, masked=True):
    """Rows b hold ``lens[b]`` tokens in fragmented pages; the last S of
    them are the verify block (their K/V already written). With
    ``masked``, row 0's last token is a masked slot (pos 2^30), which sees
    every slot."""
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
    return P, pos, table, q_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,D,page,lens,window,masked", [
    (3, 4, 4, 2, 64, 4, (6, 17, 9), None, True),
    (4, 5, 24, 8, 128, 16, (100, 1060, 517, 64), None, True),   # spec verify
    (1, 300, 24, 8, 128, 16, (812,), None, True),               # suffix prefill
    (2, 9, 6, 2, 128, 8, (40, 77), 16, True),                   # windowed
    (1, 512, 24, 8, 128, 16, (1024,), None, False),   # phase 2's suffix prefill
    (4, 5, 24, 8, 128, 16, (100, 1060, 517, 64), 256, True),   # first splits dead
    (2, 5, 8, 8, 64, 16, (300, 77), None, True),                # G 1, D 64
    (2, 5, 32, 4, 128, 16, (500, 120), None, True),   # G 8: R 40, 3 row groups
    (2, 3, 32, 2, 128, 16, (200, 700), None, True),   # G 16: R 48
    (1, 100, 8, 2, 64, 8, (333,), None, True),        # query tiles at D 64
])
def test_paged_verify_kernel_matches_plain(dev, dtype, B, S, H, Hkv, D, page,
                                           lens, window, masked):
    rng = np.random.RandomState(2)
    P, pos, table, q_pos = _verify_pool(rng, B, S, page, lens, masked=masked)
    dt = getattr(torch, dtype)

    def t(a, float_=False):
        x = torch.from_numpy(np.asarray(a)).to(dev)
        return x.to(dt) if float_ else x
    args = (t(rng.randn(B, S, H, D).astype(np.float32), True),
            t(rng.randn(P, page, Hkv, D).astype(np.float32), True),
            t(rng.randn(P, page, Hkv, D).astype(np.float32), True),
            t(pos), t(table), t(q_pos))
    got = _launch_twice("paged_verify_attention", paged_verify_attention,
                        *args, window=window)
    want = paged_verify_attention_plain(*_f32(*args), window=window)
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,lens", [(200, (200, 57, 130)),
                                    (1060, (132, 441, 750, 1060))])
def test_contiguous_wrappers_launch_the_kernels(dev, dtype, L, lens):
    """decode_attention / verify_attention over a contiguous cache launch
    the paged kernels through a one-page-per-row view (one table entry per
    row: the Split-L kernel splits it by keys), each counted under its own
    name."""
    rng = np.random.RandomState(3)
    B, S, H, Hkv, D = len(lens), 5, 24, 8, 128
    dt = getattr(torch, dtype)
    k, v = (torch.from_numpy(rng.randn(B, L, Hkv, D).astype(np.float32))
            .to(dev, dt) for _ in range(2))
    lens = np.asarray(lens)
    kv_pos = np.where(np.arange(L)[None] < lens[:, None], np.arange(L)[None],
                      2 ** 30).astype(np.int32)
    q_pos = (lens[:, None] - S + np.arange(S)[None]).astype(np.int32)
    q = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).to(dev, dt)
    kp, qp = torch.from_numpy(kv_pos).to(dev), torch.from_numpy(q_pos).to(dev)
    got_v = _launch_twice("verify_attention", verify_attention, q, k, v,
                          kp, qp)
    got_d = _launch_twice("decode_attention", decode_attention,
                          q[:, 0].contiguous(), k, v, kp,
                          qp[:, 0].contiguous())
    f = _f32(q, k, v)
    torch.testing.assert_close(got_v.float(), verify_attention_plain(
        *f, kp, qp), **TOL[dtype])
    torch.testing.assert_close(got_d.float(), decode_attention_plain(
        f[0][:, 0], f[1], f[2], kp, qp[:, 0]), **TOL[dtype])


# the backward's bars are relative to each tensor's largest entry: dk and
# dv sum over every query that sees a key, so f32 summation-order noise
# scales with the tensor, not with each element
GRAD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-5)}


def _grad_close(got, want, dtype):
    rtol, atol_rel = GRAD_TOL[dtype]
    want = want.float()
    tol = rtol * want.abs() + atol_rel * want.abs().max()
    err = (got.float() - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lp,Lr,K,H,Hkv,D,window", [
    (40, 24, 3, 4, 2, 64, None),       # reduced llama heads, ragged tiles
    (256, 64, 4, 24, 8, 128, None),    # full-width heads, SPA-packed
    (300, 0, 0, 24, 8, 128, 64),       # windowed prompt
])
def test_spa_backward_kernel_matches_plain(dev, dtype, Lp, Lr, K, H, Hkv, D,
                                           window):
    q, k, v, pos, seg = _packed(dev, dtype, 3, Lp, Lr, K, H, Hkv, D)
    gen = torch.Generator(device=dev).manual_seed(4)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    args = (q, k, v, pos, pos, seg, seg)
    out, o32, lse = _forward_kernel(*args, D ** -0.5, window, stats=True)
    n0 = LAUNCHES["spa_attention_bwd"]
    got = spa_attention_bwd(*args, o32, lse, dout, window=window)
    again = spa_attention_bwd(*args, o32, lse, dout, window=window)
    assert LAUNCHES["spa_attention_bwd"] == n0 + 2
    f = _f32(*args, dout)
    want = spa_attention_bwd_plain(*f[:7], f[7], window=window)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)       # no atomics: bitwise deterministic
        _grad_close(g, w, dtype)


def _spa_edge(dev, dtype, case):
    """Inputs at the edges of the kernels' 64-row tiles (and the f32
    kernels' 32-row ones): (q, k, v, q_pos, kv_pos, q_seg, kv_seg)."""
    H, Hkv, D, Sq, Skv = {
        "g1": (8, 8, 128, 100, 100), "g4": (32, 8, 64, 130, 130),
        "g8": (8, 1, 128, 70, 70), "sq_ne_skv": (4, 2, 128, 77, 200),
        "one_live_token": (4, 2, 64, 96, 96),
        "masked_tile": (4, 2, 128, 192, 192)}[case]
    rng = np.random.RandomState(7)
    B = 2 if case == "one_live_token" else 1
    kv_pos = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    q_pos = kv_pos[:, Skv - Sq:].copy()     # Sq < Skv: the last Sq keys' queries
    kv_seg = np.zeros((B, Skv), np.int32)
    q_seg = np.zeros((B, Sq), np.int32)
    if case == "one_live_token":            # row 1 holds one token; the rest
        q_pos[1, 1:] = -1                   # is padding that sees nothing
        kv_pos[1, 1:] = 2 ** 30             # and is seen by nothing
        q_seg[1, 1:] = kv_seg[1, 1:] = -1
    if case == "masked_tile":               # query tile 64..127 sees no key
        q_pos[0, 64:128] = -1
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.randn(B, s, h, D).astype(np.float32))
               .to(dev, dt) for s, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return q, k, v, t(q_pos), t(kv_pos), t(q_seg), t(kv_seg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["g1", "g4", "g8", "sq_ne_skv",
                                  "one_live_token", "masked_tile"])
def test_spa_kernels_at_tile_edges(dev, dtype, case):
    """Forward and backward kernels at G 1, 4 and 8, lengths that are not
    multiples of 64, Sq != Skv, a row with one live token and a query tile
    that sees no key, against the plain versions run in f32."""
    args = _spa_edge(dev, dtype, case)
    q, D = args[0], args[0].shape[-1]
    out, o32, lse = _forward_kernel(*args, D ** -0.5, None, stats=True)
    gen = torch.Generator(device=dev).manual_seed(8)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    got = spa_attention_bwd(*args, o32, lse, dout)
    again = spa_attention_bwd(*args, o32, lse, dout)
    f = _f32(*args, dout)
    want = chunked_attention(*f[:7])
    want_g = spa_attention_bwd_plain(*f[:7], f[7])
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want, **TOL[dtype])
    for g, a, w in zip(got, again, want_g):
        assert torch.equal(g, a)
        _grad_close(g, w, dtype)
    if case == "masked_tile":
        assert float(out[0, 64:128].float().abs().max()) == 0.0
        assert float(got[0][0, 64:128].float().abs().max()) == 0.0


def test_spa_autograd_on_card_matches_cpu(dev):
    """The autograd Function (forward with stats, backward kernel) against
    autograd of the plain version on the CPU, with a row that sees no key."""
    q, k, v, pos, seg = _packed(dev, "float32", 5, 33, 20, 2, 4, 2, 64)
    q_pos, q_seg = pos.clone(), seg.clone()
    q_pos[0, 3], q_seg[0, 3] = -1, 99  # a query that sees no key
    dout = torch.randn(q.shape, device=dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = dict(LAUNCHES)
    out = spa_attention(*leaves, q_pos, pos, q_seg, seg)
    out.backward(dout)
    assert LAUNCHES["spa_attention"] == n0["spa_attention"] + 1
    assert LAUNCHES["spa_attention_bwd"] == n0["spa_attention_bwd"] + 1
    assert float(leaves[0].grad[0, 3].abs().max()) == 0.0
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    want = chunked_attention(*cpu, q_pos.cpu(), pos.cpu(), q_seg.cpu(),
                             seg.cpu())
    want.backward(dout.cpu())
    torch.testing.assert_close(out.detach().cpu(), want.detach(),
                               atol=2e-5, rtol=2e-5)
    for g, w in zip(leaves, cpu):
        _grad_close(g.grad.cpu(), w.grad, "float32")


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (33, 20, 2, 4, 2, 64)),       # the autograd test's row
    ("bfloat16", (256, 64, 4, 24, 8, 128))])
def test_spa_kernels_do_not_read_stale_memory(dev, dtype, shape):
    """The SPA forward and backward kernels 12 times on one input (a query
    that sees no key included), each time after the allocator's free
    memory was filled with another pattern (NaN, +-1e30, 0, noise), so
    that every buffer the wrappers allocate starts with it: the output
    and the three gradients are bitwise the first run's. A read of memory
    the kernels did not write, or a race between their threads, would
    show as a difference."""
    q, k, v, pos, seg = _packed(dev, dtype, 5, *shape)
    q_pos, q_seg = pos.clone(), seg.clone()
    q_pos[0, 3], q_seg[0, 3] = -1, 99  # a query that sees no key
    gen = torch.Generator(device=dev).manual_seed(0)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    first = None
    for fill in [float("nan"), 1e30, -1e30, 0.0, None] * 2 + [None, None]:
        junk = torch.empty(64 << 20, dtype=torch.float32, device=dev)
        if fill is None:
            junk.normal_(generator=gen)
        else:
            junk.fill_(fill)
        torch.cuda.synchronize()
        del junk                        # back to the allocator's cache
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = spa_attention(*leaves, q_pos, pos, q_seg, seg)
        out.backward(dout)
        got = [out.detach()] + [t.grad for t in leaves]
        assert all(bool(torch.isfinite(g).all()) for g in got)
        if first is None:
            first = [g.clone() for g in got]
        else:
            assert all(torch.equal(a, b) for a, b in zip(got, first))


SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                     1.00390625, 1.01171875,        # bf16 ties: even, odd
                     1e-40, -1e-40, 1e-45,          # f32 denormals
                     3.3895314e38, 3.4e38, -3.4e38,  # bf16 overflow edge
                     6.5504e4, 6.5520e4],           # f16 max, overflow tie
                    np.float32)


@pytest.mark.parametrize("wire", ["bfloat16", "float16"])
@pytest.mark.parametrize("n,offset", [(0, 0), (7, 0), (4096, 0), (1000003, 0),
                                      (1000, 1), (3, 1), (5, 2),
                                      (30_000_001, 0),    # many waves, ragged
                                      (20_000_003, 3)])   # misaligned, ragged
def test_transfer_cast_kernel_is_bitwise_to(dev, wire, n, offset):
    rng = np.random.RandomState(n)
    x = (rng.randn(n + offset) * 10.0 ** rng.randint(-8, 8, n + offset)
         ).astype(np.float32)
    x[offset:offset + min(n, SPECIALS.size)] = SPECIALS[:min(n, SPECIALS.size)]
    xt = torch.from_numpy(x).to(dev)[offset:]      # offset 1: misaligned
    dt = getattr(torch, wire)
    n0 = LAUNCHES["transfer_cast"]
    got = transfer_cast(xt, dt)
    want = xt.to(dt)
    torch.cuda.synchronize()
    assert LAUNCHES["transfer_cast"] == n0 + (1 if n else 0)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int16), want[~nan].view(torch.int16))


def test_kernels_refuse_what_they_do_not_take(dev):
    q, k, v, pos, seg = _packed(dev, "float32", 2, 16, 0, 0, 2, 2, 32)
    with pytest.raises(ValueError, match="head_dim"):
        spa_attention(q, k, v, pos, pos, seg, seg)
    q, k, v, pos, seg = _packed(dev, "float32", 2, 16, 0, 0, 2, 2, 64)
    with pytest.raises(ValueError, match="contiguous"):
        spa_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                      pos, pos, seg, seg)
    with pytest.raises(TypeError, match="int32"):
        spa_attention(q, k, v, pos.long(), pos, seg, seg)
    with pytest.raises(TypeError, match="float32 ->"):
        transfer_cast(q.bfloat16(), torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        transfer_cast(q.transpose(1, 2), torch.bfloat16)


def test_reduced_engine_on_card_matches_cpu(dev):
    """Greedy serving of the reduced f32 model: identical tokens on the
    card (both kernels) and on the CPU (plain versions)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import init
    cfg = reduced_config(get_config("llama3.2-3b"))
    p_cpu = init(cfg, seed=0, device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (5, 19, 33)]
    kw = dict(max_prompt_len=40, max_new=8, num_slots=2, page_size=8,
              temperature=0.0, seed=0)
    n0 = dict(LAUNCHES)
    gpu, _ = serve_paged(cfg, prompts, device=dev, params=to(p_cpu), **kw)
    assert all(LAUNCHES[n] > n0[n]
               for n in ("spa_attention", "paged_decode_attention"))
    cpu, _ = serve_paged(cfg, prompts, device="cpu", params=p_cpu, **kw)
    assert [c.response_ids.tolist() for c in gpu] == \
        [c.response_ids.tolist() for c in cpu]


def test_captured_grad_step_on_card_matches_cpu(dev):
    """The reduced model's captured grad step on an SPA-packed row: the
    card (SPA forward and backward kernels) against the CPU (autograd of
    the plain version), within 2e-4 of each leaf's largest entry."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.queue import RolloutGroup
    from repro_torch.core.spa import pack_spa
    from repro_torch.models import init
    from repro_torch.rl.grpo import make_grad_step_captured, to_device
    cfg = reduced_config(get_config("llama3.2-3b"))
    rng = np.random.RandomState(2)
    G, Lp, T = 4, 20, 16
    lens = rng.randint(3, T + 1, size=G).astype(np.int32)
    resp = np.zeros((G, T), np.int32)
    for g in range(G):
        resp[g, :lens[g]] = rng.randint(3, 500, size=lens[g])
    group = RolloutGroup(uid=0, prompt_ids=rng.randint(3, 500, size=Lp)
                         .astype(np.int32), response_ids=resp,
                         response_len=lens, rewards=np.zeros(G, np.float32),
                         weight_version=0,
                         response_logprobs=-rng.rand(G, T).astype(np.float32))
    mb = pack_spa(group, rng.randn(G).astype(np.float32), Lp, T,
                  responses_per_row=G)
    p_cpu = init(cfg, seed=0, device="cpu")
    r_cpu = init(cfg, seed=1, device="cpu")

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d)
                for k, v in tree.items()}
    step = make_grad_step_captured(cfg, RLConfig())
    n0 = LAUNCHES["spa_attention_bwd"]
    g_gpu, _ = step(to(p_cpu, dev), None, to(r_cpu, dev), to_device(mb, dev))
    assert LAUNCHES["spa_attention_bwd"] == n0 + cfg.num_layers
    g_cpu, _ = step(p_cpu, None, r_cpu, to_device(mb, "cpu"))

    def leaves(tree):
        for k in sorted(tree):
            v = tree[k]
            yield from (leaves(v) if isinstance(v, dict) else (v,))
    for a, b in zip(leaves(g_gpu), leaves(g_cpu)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 2e-4 * float(b.abs().max()), err


def test_reduced_spec_engine_on_card_matches_cpu(dev):
    """Greedy spec decode and the radix cache on the reduced f32 model:
    identical tokens on the card (verify kernel) and on the CPU (plain
    versions), and equal to the card's own non-spec tokens."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import init
    cfg = reduced_config(get_config("llama3.2-3b"))
    p_cpu = init(cfg, seed=0, device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    rng = np.random.RandomState(1)
    system = list(rng.randint(3, 500, size=16))
    prompts = [np.asarray(system + list(rng.randint(3, 500, size=n)),
                          np.int32) for n in (3, 11, 7)]
    kw = dict(max_prompt_len=40, max_new=10, num_slots=2, page_size=8,
              temperature=0.0, seed=0, prefix_cache=True)
    n0 = LAUNCHES["paged_verify_attention"]
    gpu, stats = serve_paged(cfg, prompts, device=dev, params=to(p_cpu),
                             spec_k=3, **kw)
    assert LAUNCHES["paged_verify_attention"] > n0
    assert stats["prefix_hit_pages"] > 0
    cpu, _ = serve_paged(cfg, prompts, device="cpu", params=p_cpu, spec_k=3,
                         **kw)
    plain, _ = serve_paged(cfg, prompts, device=dev, params=to(p_cpu),
                           **dict(kw, prefix_cache=False))

    def toks(done):
        return {c.request_id: c.response_ids.tolist() for c in done}
    assert toks(gpu) == toks(cpu) == toks(plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,r,rd,page,lens,window", [
    (3, 1, 4, 64, 16, 4, (6, 17, 9), None),              # reduced, decode
    (3, 4, 4, 64, 16, 4, (6, 17, 9), None),              # reduced, verify
    (3, 1, 4, 64, 16, 8, (6, 700, 301), None),           # reduced, 3 splits
    (2, 4, 4, 64, 16, 8, (530, 33), 40),                 # reduced, windowed
    (4, 1, 16, 512, 64, 16, (64, 400, 1088, 700), None),  # serving decode
    (4, 5, 16, 512, 64, 16, (100, 1060, 517, 64), None),  # spec verify: 80 rows
    (2, 5, 16, 512, 64, 16, (300, 777), 128),             # windowed
    (16, 1, 16, 512, 64, 16, _LONG, None),                # to 8k, dead splits
    (1, 1, 16, 512, 64, 16, (6000,), None),               # one long row
    (1, 5, 16, 512, 64, 16, (3000,), None),               # long verify block
])
def test_paged_mla_kernel_matches_plain(dev, dtype, B, S, H, r, rd, page,
                                        lens, window):
    """Both MLA wrappers launch the one kernel; S == 1 through the decode
    wrapper (row 0 then an inactive slot at pos 2^30), S > 1 through the
    verify wrapper; MLA's scale (nd + rd)^-0.5. Two launches give the same
    bits and count one launch each."""
    rng = np.random.RandomState(4)
    P, pos, table, q_pos = _verify_pool(rng, B, S, page, lens)
    dt = getattr(torch, dtype)
    scale = (r // 4 + rd) ** -0.5

    def t(a, float_=False):
        x = torch.from_numpy(np.asarray(a)).to(dev)
        return x.to(dt) if float_ else x
    q = t(rng.randn(B, S, H, r + rd).astype(np.float32), True)
    pools = (t(rng.randn(P, page, r).astype(np.float32), True),
             t(rng.randn(P, page, rd).astype(np.float32), True),
             t(pos), t(table))
    if S == 1:
        name, fn, plain = ("paged_mla_decode_attention",
                           paged_mla_decode_attention,
                           paged_mla_decode_attention_plain)
        args = (q[:, 0].contiguous(), *pools, t(q_pos[:, 0].copy()))
    else:
        name, fn, plain = ("paged_mla_verify_attention",
                           paged_mla_verify_attention,
                           paged_mla_verify_attention_plain)
        args = (q, *pools, t(q_pos))
    got = _launch_twice(name, fn, *args, scale=scale, window=window)
    want = plain(*_f32(*args), scale=scale, window=window)
    assert got.shape == args[0].shape[:-1] + (r,)
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_mla_verify_kernel_at_suffix_prefill_shape(dev, dtype):
    """The radix suffix prefill at full width: one row of 512 cached
    tokens then a 256-token block of which the first 200 are the suffix
    (pos 512..711, their latents written) and the rest pad slots at pos 0,
    as the engine pads a suffix to its power-of-two page bucket. The
    wrapper's plan has 256 row groups."""
    from repro_torch.kernels.decode_attention import LAST_PLAN
    H, r, rd, page, S, real = 16, 512, 64, 16, 256, 200
    rng = np.random.RandomState(5)
    P, pos, table, _ = _verify_pool(rng, 1, S, page, (512 + real,),
                                    n_extra=3, masked=False)
    q_pos = np.zeros((1, S), np.int32)
    q_pos[0, :real] = np.arange(512, 512 + real)
    dt = getattr(torch, dtype)

    def t(a, float_=False):
        x = torch.from_numpy(np.asarray(a)).to(dev)
        return x.to(dt) if float_ else x
    args = (t(rng.randn(1, S, H, r + rd).astype(np.float32), True),
            t(rng.randn(P, page, r).astype(np.float32), True),
            t(rng.randn(P, page, rd).astype(np.float32), True),
            t(pos), t(table), t(q_pos))
    scale = (128 + rd) ** -0.5
    got = _launch_twice("paged_mla_verify_attention",
                        paged_mla_verify_attention, *args, scale=scale)
    assert LAST_PLAN["paged_mla_verify_attention"]["row_groups"] == S
    want = paged_mla_verify_attention_plain(*_f32(*args), scale=scale)
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


def test_paged_mla_kernel_refuses_unbuilt_shapes(dev):
    q = torch.zeros((2, 1, 4, 72), device=dev)
    ckv = torch.zeros((3, 4, 56), device=dev)
    kr = torch.zeros((3, 4, 16), device=dev)
    pos = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    tab = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    qp = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="built for"):
        paged_mla_verify_attention(q, ckv, kr, pos, tab, qp, scale=0.1)
    q = torch.zeros((2, 1, 4, 80), device=dev, dtype=torch.float16)
    ckv = torch.zeros((3, 4, 64), device=dev, dtype=torch.float16)
    kr = torch.zeros((3, 4, 16), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_mla_verify_attention(q, ckv, kr, pos, tab, qp, scale=0.1)


def test_reduced_mla_engine_on_card_matches_cpu(dev):
    """Greedy serving of reduced mla_dense (f32), spec off and on:
    identical tokens on the card (the MLA kernel) and on the CPU (plain
    versions)."""
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import init
    cfg = _reduced_mla_dense()
    p_cpu = init(cfg, seed=0, device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (5, 19, 33)]
    kw = dict(max_prompt_len=40, max_new=8, num_slots=2, page_size=8,
              temperature=0.0, seed=0)
    out = []
    for spec_k in (0, 3):
        n0 = dict(LAUNCHES)
        gpu, _ = serve_paged(cfg, prompts, device=dev, params=to(p_cpu),
                             spec_k=spec_k, **kw)
        name = ("paged_mla_verify_attention" if spec_k
                else "paged_mla_decode_attention")
        assert LAUNCHES[name] > n0[name]
        cpu, _ = serve_paged(cfg, prompts, device="cpu", params=p_cpu,
                             spec_k=spec_k, **kw)
        toks = [c.response_ids.tolist() for c in gpu]
        assert toks == [c.response_ids.tolist() for c in cpu]
        out.append(sorted(map(tuple, toks)))
    assert out[0] == out[1]


# ---------------------------------------------------------------------
# the device-resident decode loop: CUDA-graph replays
# ---------------------------------------------------------------------

def _reduced_llama(dev):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import init
    cfg = reduced_config(get_config("llama3.2-3b"))
    p_cpu = init(cfg, seed=0, device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    return cfg, p_cpu, to(p_cpu)


def test_decode_block_graph_replay_matches_cpu_engine(dev):
    """Greedy serving of reduced llama (f32) at D 3: the card replays one
    captured graph per block and gives the CPU engine's tokens at D 3 and
    its own tokens at D 1."""
    from repro_torch.launch.serve import build_paged_engine
    cfg, p_cpu, p_gpu = _reduced_llama(dev)
    rng = np.random.RandomState(2)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (5, 19, 33, 7, 12)]
    kw = dict(max_prompt_len=40, max_new=10, num_slots=2, page_size=8,
              temperature=0.0)
    toks = {}
    for where, params, drain in ((dev, p_gpu, 3), ("cpu", p_cpu, 3),
                                 (dev, p_gpu, 1)):
        eng = build_paged_engine(cfg, device=where, drain_interval=drain,
                                 **kw)
        done = eng.serve(params, prompts, 1)
        toks[str(where), drain] = {c.request_id: c.response_ids.tolist()
                                   for c in done}
        if where == dev:
            assert eng.capture_ms is not None
            assert eng.graph_replays * drain == eng.decode_steps > 0
    assert toks[str(dev), 3] == toks["cpu", 3] == toks[str(dev), 1]


def test_engine_owns_its_weights_on_the_card(dev):
    """The graph reads fixed addresses: the first set_params clones the
    caller's tree, later ones copy into the same tensors (the caller's
    tree is never written), and a store flip holds the engine's tree."""
    from repro_torch.launch.serve import build_paged_engine
    from repro_torch.transfer.service import VersionedParamStore
    cfg, p_cpu, p_gpu = _reduced_llama(dev)
    eng = build_paged_engine(cfg, max_prompt_len=24, max_new=8, num_slots=2,
                             page_size=8, temperature=0.0, device=dev)
    own = eng.set_params(p_gpu)
    ptrs = [t.data_ptr() for t in _leaves(own)]
    assert not set(ptrs) & {t.data_ptr() for t in _leaves(p_gpu)}
    def doubled(tree):
        return {k: doubled(v) if isinstance(v, dict) else v * 2
                for k, v in tree.items()}
    store = VersionedParamStore(on_flip=eng.set_params)
    store.install(doubled(p_gpu), 1)
    assert store.snapshot()[0] is own is eng.params
    assert [t.data_ptr() for t in _leaves(own)] == ptrs
    for mine, new, theirs, ref in zip(_leaves(own), _leaves(doubled(p_cpu)),
                                      _leaves(p_gpu), _leaves(p_cpu)):
        assert torch.equal(mine.cpu(), new)
        assert torch.equal(theirs.cpu(), ref)


def test_engine_holds_a_handed_over_tree_once(dev):
    """The serve entry points' hand-over: the caller keeps the tree
    ``set_params`` returns (the engine's clone) and drops its own, and no
    tensor of the dropped tree stays alive; a second engine loaded from
    the first's tree, the first dropped, leaves one tree again; the
    tokens equal those of an engine whose caller kept its tree."""
    import weakref
    from repro_torch.launch.serve import build_paged_engine
    cfg, p_cpu, p_gpu = _reduced_llama(dev)
    prompts = [np.arange(3, 3 + n, dtype=np.int32) for n in (4, 9, 17)]
    kw = dict(max_prompt_len=24, max_new=8, num_slots=2, page_size=8,
              temperature=0.0, device=dev)
    want = [c.response_ids.tolist()
            for c in build_paged_engine(cfg, **kw).serve(p_gpu, prompts, 0)]
    tree = _to_dev(p_cpu, dev)
    for step in range(2):
        eng = build_paged_engine(cfg, **kw)
        gone = [weakref.ref(t) for t in _leaves(tree)]
        own = eng.set_params(tree)
        assert own is eng.params and own is not tree
        del tree
        gc.collect()
        assert all(r() is None for r in gone), step
        got = eng.serve(own, prompts, 0)
        assert [c.response_ids.tolist() for c in got] == want, step
        tree = own
        del eng, own


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_launches_count_each_replay(dev):
    """After k replays LAUNCHES holds k times the captured tally: the
    layers' decode launches per block, D per layer."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.serve import build_paged_engine
    cfg, _, p_gpu = _reduced_llama(dev)
    D = 4
    eng = build_paged_engine(cfg, max_prompt_len=24, max_new=12,
                             num_slots=3, page_size=8, temperature=0.7,
                             drain_interval=D, device=dev)
    eng.set_params(p_gpu)
    tally = eng.capture_ms["launch_tally"]
    assert tally == {"paged_decode_attention": D * cfg.num_layers}
    reset_launch_counts()
    eng.serve(p_gpu, [np.arange(3, 3 + n, dtype=np.int32)
                      for n in (4, 9, 17, 6)], 0)
    torch.cuda.synchronize()
    k = eng.graph_replays
    assert k > 0 and LAUNCHES["paged_decode_attention"] == \
        k * tally["paged_decode_attention"] == \
        cfg.num_layers * eng.decode_steps
    assert LAUNCHES["spa_attention"] == cfg.num_layers * eng.prefills


def test_counter_uniforms_bitwise_equal_on_card_and_cpu(dev):
    from repro_torch.rl.rollout import (RESAMPLE_LANE, row_seed,
                                        uniform_words, uniforms)
    rng = np.random.RandomState(4)
    seeds = torch.from_numpy(np.concatenate([
        [row_seed((0, 1), 0), -1, 2 ** 63 - 1],
        rng.randint(-2 ** 63, 2 ** 63 - 1, size=5, dtype=np.int64)]))
    counter = torch.arange(8, dtype=torch.int64) * 977
    lanes = RESAMPLE_LANE + torch.arange(3)
    for args in ((seeds, counter, 0, 128256),
                 (seeds[:, None], counter[:, None], lanes, 4099)):
        on_card = [a.to(dev) if isinstance(a, torch.Tensor) else a
                   for a in args]
        assert torch.equal(uniform_words(*on_card).cpu(),
                           uniform_words(*args))
        assert torch.equal(uniforms(*on_card).cpu(), uniforms(*args))


def test_a_capture_that_fails_raises(dev):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, and nothing falls back to eager execution."""
    from repro_torch.core.graphs import StepGraph
    x = torch.ones(16, device=dev)

    def step():
        if x.sum().item() > 0:          # a device->host read
            return (x * 2,)
        return (x,)
    with pytest.raises(RuntimeError):
        StepGraph(step, dev)
    torch.cuda.synchronize()
    assert float(x.sum()) == 16.0       # the card still works


# ---------------------------------------------------------------------
# two streams: the paged engines' and the trainer's
# ---------------------------------------------------------------------

def _stress_default_stream(dev, stop):
    """Until ``stop`` is set, keep about 30 ms of work queued on the
    default stream: a spin, a long matmul, and tensors freed and allocated
    again there (filled with NaN, so memory handed out too early shows in
    the results). Engine work issued there by mistake lands that late,
    after the engine's own stream has run on."""
    import collections
    a = torch.randn(4096, 4096, device=dev)
    marks = collections.deque()
    while not stop.is_set():
        torch.cuda._sleep(10_000_000)          # about 5 ms of spinning
        junk = [torch.full((1 << 20,), float("nan"), device=dev)
                for _ in range(8)]
        b = a @ a
        del junk, b
        marks.append(torch.cuda.Event())
        marks[-1].record()
        if len(marks) > 4:
            marks.popleft().synchronize()
    torch.cuda.current_stream(dev).synchronize()


def _drive_threads(eng, prompts, max_news, workers: int = 2):
    """Serve ``prompts`` through ``eng`` from ``workers`` threads that
    step it convoy-style under one lock (as ``InferenceInstance`` does),
    greedy. Returns {request: tokens}."""
    import threading
    lock = threading.Lock()
    out, errors = {}, []

    def worker(ids):
        try:
            hs = {i: eng.submit(prompts[i], (0, i), max_new=max_news[i])
                  for i in ids}
            for i, h in hs.items():
                while not h.done():
                    with lock:
                        if not h.done():
                            eng.step()
                out[i] = h.host_rows()[0].tolist()
        except BaseException as exc:
            errors.append(exc)
    threads = [threading.Thread(target=worker,
                                args=(range(w, len(prompts), workers),))
               for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    while eng.step():            # a block still in flight at D > 1
        pass
    return out


@pytest.mark.parametrize("drain", [1, 4])
def test_engine_stream_under_default_stream_load(dev, drain):
    """Rows finish mid-block and new rows take their freed pages (a tight
    pool, LIFO freelist) while another thread keeps the default stream
    busy and reallocates memory there: the tokens equal the same engine's
    run alone, and every page comes back. Both engines decode on the
    card's one engine stream."""
    import threading
    from repro_torch.core.paged import FIRST_PAGE, engine_stream
    from repro_torch.launch.serve import build_paged_engine
    cfg, _, p_gpu = _reduced_llama(dev)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(3, 500, size=(int(n),)).astype(np.int32)
               for n in rng.randint(3, 40, size=10)]
    max_news = [int(n) for n in rng.randint(3, 14, size=10)]

    def engine():
        eng = build_paged_engine(cfg, max_prompt_len=40, max_new=13,
                                 num_slots=3, page_size=4, temperature=0.0,
                                 drain_interval=drain, device=dev)
        eng.set_params(p_gpu)
        return eng
    first = engine()
    alone = _drive_threads(first, prompts, max_news)
    eng = engine()
    # one stream a card, shared by its paged engines
    assert eng.stream is first.stream is engine_stream(dev)
    assert eng.stream != torch.cuda.default_stream(dev)
    stop = threading.Event()
    stress = threading.Thread(target=_stress_default_stream,
                              args=(dev, stop))
    stress.start()
    try:
        loaded = _drive_threads(eng, prompts, max_news)
    finally:
        stop.set()
        stress.join()
    assert loaded == alone
    assert all(len(alone[i]) <= max_news[i] for i in alone)
    assert eng.alloc.num_live == 0 and \
        eng.alloc.num_free == eng.P - FIRST_PAGE


def test_engine_step_off_its_stream_raises(dev):
    """An engine step issued on another stream than the engine's raises
    before it uploads or replays anything."""
    from repro_torch.launch.serve import build_paged_engine
    cfg, _, p_gpu = _reduced_llama(dev)
    eng = build_paged_engine(cfg, max_prompt_len=24, max_new=8, num_slots=2,
                             page_size=8, temperature=0.0, device=dev)
    eng.set_params(p_gpu)
    n = eng.graph_replays
    with pytest.raises(RuntimeError, match="off the engine's stream"):
        eng._run_step(eng._decode_block, eng._blank_inputs())
    assert eng.graph_replays == n


def test_admission_does_not_wait_for_the_engine_stream(dev):
    """With 0.4 s of work queued on the engine's stream, a step that admits
    a row (prefill, page table, logits and done flag) and dispatches its
    first block at D 4 returns without waiting for the card: no host sync
    in ``step`` before the drain. The tokens match an unhindered run."""
    import time
    from repro_torch.launch.serve import build_paged_engine
    cfg, _, p_gpu = _reduced_llama(dev)
    prompt = np.arange(3, 20, dtype=np.int32)
    out = []
    for hold in (False, True):
        eng = build_paged_engine(cfg, max_prompt_len=24, max_new=8,
                                 num_slots=2, page_size=4, temperature=0.0,
                                 drain_interval=4, device=dev)
        eng.set_params(p_gpu)
        h = eng.submit(prompt, 0)
        torch.cuda.synchronize()
        if hold:
            with torch.cuda.stream(eng.stream):
                torch.cuda._sleep(800_000_000)
        t0 = time.perf_counter()
        eng.step()
        took = time.perf_counter() - t0
        while eng.step():
            pass
        out.append(h.host_rows()[0].tolist())
        if hold:
            assert took < 0.2, took
    assert out[0] == out[1]


def _reduced_pipeline(dev, batch_prompts=2, arch="llama", **over):
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.launch.train import build_pipeline
    from repro_torch.models import init
    cfg = (_reduced_mla_dense() if arch == "mla_dense"
           else reduced_config(get_config("deepseek-v2-lite-16b"))
           if arch == "deepseek_moe"
           else reduced_config(get_config("llama3.2-3b")))
    kw = dict(mode="async", batch_prompts=batch_prompts, group_size=4,
              num_inference_instances=1, max_prompt_len=24,
              max_response_len=8, cbatch_slots=8,
              shared_prompt_attention=True, capture_logprobs=True,
              transfer_wire_dtype="bfloat16", seed=0)
    kw.update(over)
    rl = RLConfig(**kw)
    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    params = to(init(cfg, seed=0, device="cpu"))
    sched, parts = build_pipeline(cfg, rl, seed=0, params=params,
                                  device=dev)
    return cfg, sched, parts


def _parity_reward(resp, answer) -> float:
    """A reward that varies with the tokens, so the updates are not zero
    (a random model never answers right)."""
    return float(np.mean(np.asarray(resp) % 2)) if len(resp) else 0.0


@pytest.mark.parametrize("arch", ["llama", "mla_dense"])
def test_no_engine_kernel_runs_off_its_stream(dev, arch):
    """torch.profiler over a reduced two-iteration training run: every
    decode kernel (llama's paged decode, Split-L, or the MLA kernel; the
    graph's warm-up and its replays) runs on one stream, and for llama the
    prefills' SPA forwards too; the trainer's kernels (llama's SPA
    backwards and forwards; MLA's plain PyTorch, which launches no kernel
    of the port) run on another."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    cfg, sched, parts = _reduced_pipeline(dev, arch=arch)
    decode = "paged_mla_kernel" if cfg.use_mla else "splitl_kernel"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hist = sched.run(2)
        torch.cuda.synchronize()
    assert all(s.max_staleness == 0 for s in hist)
    count = collections.defaultdict(collections.Counter)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.name().startswith(("Memcpy", "Memset")):
            continue
        count[e.device_resource_id()]["all"] += 1
        for kind in (decode, "spa_fwd", "bwd_tiles"):
            if kind in e.name():
                count[e.device_resource_id()][kind] += 1
    L = cfg.num_layers
    steps = sum(s.metrics["decode_steps"] for s in hist)
    prefills = sum(s.metrics["prefills"] for s in hist)
    warm = sum(s.metrics["warmup_steps"] for s in hist)
    engine = max(count, key=lambda s: count[s][decode])
    assert count[engine][decode] == L * (steps + warm) > L * warm
    assert sum(c[decode] for s, c in count.items() if s != engine) == 0
    if cfg.use_mla:
        assert sum(c["spa_fwd"] + c["bwd_tiles"]
                   for c in count.values()) == 0
        # the trainer's forward and backward kernels ran elsewhere
        assert any(c["all"] for s, c in count.items() if s != engine)
        return
    trainer = [s for s, c in count.items() if c["bwd_tiles"]]
    assert len(trainer) == 1 and engine != trainer[0]
    assert count[engine]["spa_fwd"] == L * prefills > 0
    assert count[trainer[0]]["spa_fwd"] == \
        3 * L * sched.captured_micro_steps


@pytest.mark.parametrize("arch", ["llama", "mla_dense", "deepseek_moe"])
def test_async_training_on_card_matches_cpu(dev, arch):
    """A reduced async run, one group per iteration (a fixed accumulation
    order), on the card (two streams, kernels) and on the CPU: the same
    rollouts (trained tokens and rewards) and parameters within 2e-4 of
    each leaf's largest entry, as the captured grad step's bar above."""
    policies, stats = [], []
    for where in (dev, "cpu"):
        _, sched, parts = _reduced_pipeline(where, batch_prompts=1,
                                            arch=arch)
        parts["generator"].reward_fn = _parity_reward
        start = [t.cpu().clone() for t in _leaves(parts["tri"].policy)]
        hist = sched.run(2)
        assert all(s.max_staleness == 0 for s in hist)
        stats.append([(s.trained_tokens, s.reward_mean) for s in hist])
        policies.append([t.cpu() for t in _leaves(parts["tri"].policy)])
        assert not all(torch.equal(a, b) for a, b in zip(start, policies[-1]))
    assert stats[0] == stats[1]
    for a, b in zip(*policies):
        err = float((a - b).abs().max())
        assert err <= 2e-4 * float(b.abs().max()), err


def test_flipped_weights_survive_trainer_allocations(dev):
    """At every flip the engine's stream is held busy (its copy of the
    landed tree queues behind a long matmul), and right after the flip the
    trainer's stream allocates and fills tensors of the landed leaves'
    sizes (NaN). The pool's leaves stay bitwise the bf16-rounded policy:
    the landed tree's memory is not reused before the copy has read it."""
    _, sched, parts = _reduced_pipeline(dev, batch_prompts=1)
    store = parts["pool"].instances[0].store
    eng = parts["pool"].instances[0].paged_engine
    ensure = sched.transfer.ensure
    flips = []

    def hooked(params, version):
        if eng._graph is not None:
            with torch.cuda.stream(eng.stream):
                x = torch.randn(4096, 4096, device=dev)
                for _ in range(8):
                    x = x @ x * 1e-3
        v = ensure(params, version)
        junk = [torch.full_like(t, float("nan")) for t in _leaves(params)
                for _ in range(2)]
        del junk
        pool = store.snapshot()[0]
        flips.append(all(torch.equal(p, q.to(torch.bfloat16).float())
                         for p, q in zip(_leaves(pool), _leaves(params))))
        return v
    sched.transfer.ensure = hooked
    hist = sched.run(3)
    assert all(s.max_staleness == 0 for s in hist)
    assert flips == [True, True, True]
    assert store.snapshot()[0] is eng.params


def test_mla_training_engine_graph_matches_plain(dev):
    """The f32 MLA decode kernel inside the training engine's captured
    graph (reduced mla_dense, G 4 rows a group, sampled at temperature 1,
    captured logprobs): the card's rows are the CPU engine's (the kernel's
    plain version, eagerly), logprobs within 1e-4, and every decode step
    launched the kernel once a layer."""
    from repro_torch.core.paged import PagedGroupEngine
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init
    cfg = _reduced_mla_dense()
    p_cpu = init(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(6)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (7, 20, 13)]
    kw = dict(num_slots=8, page_size=16, num_pages=0, max_prompt_len=24,
              max_new_tokens=12, group_size=4, temperature=1.0)
    out = []
    for where in (dev, "cpu"):
        eng = PagedGroupEngine(cfg, device=where, **kw)
        eng.set_params(p_cpu if where == "cpu" else _to_dev(p_cpu, dev))
        reset_launch_counts()
        hs = [eng.submit(p, (0, i)) for i, p in enumerate(prompts)]
        while eng.step():
            pass
        torch.cuda.synchronize()
        if where != "cpu":
            assert eng.graph_replays == eng.decode_steps > 0
            assert LAUNCHES["paged_mla_decode_attention"] == \
                cfg.num_layers * eng.decode_steps
        out.append([h.result(0) for h in hs])
    for a, b in zip(*out):
        assert torch.equal(a.response_ids, b.response_ids)
        torch.testing.assert_close(a.response_logprobs, b.response_logprobs,
                                   atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------
# MoE: deepseek-v2-lite as published and qwen3-moe
# ---------------------------------------------------------------------

def _moe_layer(dev, cfg, gen):
    """One layer's MoE leaves on the card, bf16 (the router f32), fan-in
    scaled normals; the router's first row favours experts 0..K-1."""
    from repro_torch.models import moe

    def make(shapes):
        out = {}
        for k, v in shapes.items():
            if isinstance(v, dict):
                out[k] = make(v)
                continue
            w = torch.randn(v, generator=gen, device=dev) * v[-2] ** -0.5
            out[k] = w if k == "router" else w.to(torch.bfloat16)
        return out
    p = make(moe.moe_shapes(cfg))
    p["router"][0] = -1.0
    p["router"][0, :cfg.num_experts_per_tok] = 2.0
    return p


@pytest.mark.parametrize("B,S", [(4, 1), (4, 5)])
def test_moe_step_graph_matches_eager(dev, B, S):
    """``moe_ffn`` at deepseek-v2-lite's expert shapes (E 64, K 6, d 2048,
    ff 1408, 2 shared; bf16) captured in a CUDA graph at the decode (4
    tokens) and verify (4 x 5) shapes: every replay on fresh tokens is
    bitwise the eager call's output on them, and on tokens that share a
    large first coordinate (experts 0..5 overflow at the verify shape) the
    dropped pairs are the eager call's too."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-v2-lite-16b")
    gen = torch.Generator(device=dev).manual_seed(0)
    p = _moe_layer(dev, cfg, gen)
    x = torch.zeros((B, S, cfg.d_model), dtype=torch.bfloat16, device=dev)
    moe.moe_ffn(p, cfg, x)                       # warm-up
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y, _ = moe.moe_ffn(p, cfg, x)
    C = moe.capacity(B * S, cfg)
    for skew in (0.0, 0.0, 4.0):
        new = torch.randn(x.shape, generator=gen, device=dev) * 0.3
        new[..., 0] += skew
        x.copy_(new.to(torch.bfloat16))
        g.replay()
        torch.cuda.synchronize()
        want, _ = moe.moe_ffn(p, cfg, x.clone())
        assert torch.equal(y, want)
        _, ti, _ = moe._route(p, cfg, x.reshape(B * S, -1), False)
        _, keep = moe._dispatch_slots(ti, cfg.num_experts, C)
        if skew and B * S > C:
            assert not bool(keep.all())
    del g


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_reduced_moe_engine_on_card_matches_cpu(dev, arch):
    """Greedy serving of the reduced MoE config (f32, 4 experts top-2),
    spec off, spec on and at D 3: identical tokens on the card (the
    captured steps, the kernels) and on the CPU (plain versions), and
    each paged kernel launched once a layer per step (the SPA kernel once
    a layer per prefill for qwen3's GQA; MLA's prefill is plain)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.launch.serve import build_paged_engine, serve_paged
    from repro_torch.models import init
    cfg = reduced_config(get_config(arch))
    p_cpu = init(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(7)
    prompts = []
    for n in (5, 19, 33):
        base = rng.randint(3, 500, size=(n // 2 + 1,))
        prompts.append(np.concatenate([base, base])[:n].astype(np.int32))
    kw = dict(max_prompt_len=40, max_new=8, num_slots=2, page_size=8,
              temperature=0.0, seed=0)
    fam = "paged_mla_" if cfg.use_mla else "paged_"
    L = cfg.num_layers
    for over in ({}, {"spec_k": 3}, {"drain_interval": 3}):
        eng = build_paged_engine(cfg, device=dev, **over,
                                 **{k: v for k, v in kw.items()
                                    if k != "seed"})
        p_gpu = eng.set_params(_to_dev(p_cpu, dev))   # capture, outside
        reset_launch_counts()
        gpu = eng.serve(p_gpu, prompts, kw["seed"] + 1)  # as serve_paged
        torch.cuda.synchronize()
        step = fam + ("verify" if over.get("spec_k") else "decode") \
            + "_attention"
        assert LAUNCHES[step] == L * eng.decode_steps > 0
        assert LAUNCHES["spa_attention"] == \
            (0 if cfg.use_mla else L * len(prompts))
        cpu, _ = serve_paged(cfg, prompts, device="cpu", params=p_cpu,
                             **kw, **over)
        assert [c.response_ids.tolist() for c in gpu] == \
            [c.response_ids.tolist() for c in cpu]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_training_engine_graph_matches_plain(dev, arch):
    """The f32 MoE training engine (reduced, 4 experts top-2; G 4 rows a
    group, sampled at temperature 1, captured logprobs): the card's
    captured decode block gives the CPU engine's rows (its eager step, the
    plain kernel versions), logprobs within 1e-4, and every decode step
    launched the paged decode kernel once a layer."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.paged import PagedGroupEngine
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import init
    cfg = reduced_config(get_config(arch))
    p_cpu = init(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(6)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (7, 20, 13)]
    kw = dict(num_slots=8, page_size=16, num_pages=0, max_prompt_len=24,
              max_new_tokens=12, group_size=4, temperature=1.0)
    step = ("paged_mla_decode_attention" if cfg.use_mla
            else "paged_decode_attention")
    out = []
    for where in (dev, "cpu"):
        eng = PagedGroupEngine(cfg, device=where, **kw)
        eng.set_params(p_cpu if where == "cpu" else _to_dev(p_cpu, dev))
        reset_launch_counts()
        hs = [eng.submit(p, (0, i)) for i, p in enumerate(prompts)]
        while eng.step():
            pass
        torch.cuda.synchronize()
        if where != "cpu":
            assert eng.graph_replays == eng.decode_steps > 0
            assert LAUNCHES[step] == cfg.num_layers * eng.decode_steps
        out.append([h.result(0) for h in hs])
    for a, b in zip(*out):
        assert torch.equal(a.response_ids, b.response_ids)
        torch.testing.assert_close(a.response_logprobs, b.response_logprobs,
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "qwen3-moe-235b-a22b"])
def test_moe_captured_grad_step_on_card_matches_cpu(dev, arch, monkeypatch):
    """A reduced MoE config's captured grad step on an SPA-packed row,
    with every token routed to experts 0 and 1 first, so that each MoE
    forward drops pairs: the card against the CPU on the same micro-batch,
    loss and aux within 1e-5 relative, every gradient leaf within 2e-4 of
    its largest entry, the same pairs dropped, and for qwen3-moe's GQA the
    SPA backward kernel launched once a layer."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.queue import RolloutGroup
    from repro_torch.core.spa import pack_spa
    from repro_torch.models import init, moe
    from repro_torch.rl.grpo import make_grad_step_captured, to_device
    cfg = reduced_config(get_config(arch))
    rng = np.random.RandomState(2)
    G, Lp, T = 4, 20, 16
    lens = rng.randint(3, T + 1, size=G).astype(np.int32)
    resp = np.zeros((G, T), np.int32)
    for g in range(G):
        resp[g, :lens[g]] = rng.randint(3, 500, size=lens[g])
    group = RolloutGroup(uid=0, prompt_ids=rng.randint(3, 500, size=Lp)
                         .astype(np.int32), response_ids=resp,
                         response_len=lens, rewards=np.zeros(G, np.float32),
                         weight_version=0,
                         response_logprobs=-rng.rand(G, T).astype(np.float32))
    mb = pack_spa(group, rng.randn(G).astype(np.float32), Lp, T,
                  responses_per_row=G)
    p_cpu = init(cfg, seed=0, device="cpu")
    with torch.no_grad():
        p_cpu["embed"]["embedding"][:, 0] += 10.0
        router = p_cpu["layers"]["moe"]["router"]
        router[:, 0, :] = 0.0
        router[:, 0, 0], router[:, 0, 1] = 1.0, 0.5
    r_cpu = init(cfg, seed=1, device="cpu")
    r_cpu["embed"] = p_cpu["embed"]
    r_cpu["layers"]["moe"]["router"] = p_cpu["layers"]["moe"]["router"]
    keeps = []
    dispatch = moe._dispatch_slots

    def recording(top_i, E, C):
        slot, keep = dispatch(top_i, E, C)
        keeps.append(keep.cpu())
        return slot, keep
    monkeypatch.setattr(moe, "_dispatch_slots", recording)
    step = make_grad_step_captured(cfg, RLConfig())
    n0 = LAUNCHES["spa_attention_bwd"]
    g_gpu, m_gpu = step(_to_dev(p_cpu, dev), None, _to_dev(r_cpu, dev),
                        to_device(mb, dev))
    torch.cuda.synchronize()
    assert LAUNCHES["spa_attention_bwd"] == n0 + (0 if cfg.use_mla
                                                  else cfg.num_layers)
    n_card = len(keeps)
    g_cpu, m_cpu = step(p_cpu, None, r_cpu, to_device(mb, "cpu"))
    assert len(keeps) == 2 * n_card > 0
    for a, b in zip(keeps[:n_card], keeps[n_card:]):
        assert torch.equal(a, b)
    assert all(int((~k).sum()) > 0 for k in keeps)
    for k in ("loss", "aux"):
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=1e-5,
                                   atol=0)
    for a, b in zip(_leaves(g_gpu), _leaves(g_cpu)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 2e-4 * float(b.abs().max()), err


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (64, 1e4), (64, 5e5),
                                            (128, 5e5), (128, 1e6)])
def test_rope_angles_equal_on_card_and_cpu(dev, head_dim, theta):
    """Rotary frequencies are made on the CPU and copied: the card's are
    the CPU's bitwise, so an SPA padding token or an idle row (positions
    2^30 - 1 and 2^30, where an ulp of a frequency turns the angle by
    O(1)) is rotated alike on both, and a MoE layer routes it alike."""
    from repro_torch.models.layers import apply_rope, rope_freqs
    assert torch.equal(rope_freqs(head_dim, theta, dev).cpu(),
                       rope_freqs(head_dim, theta, "cpu"))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 4, 2, head_dim).astype(np.float32))
    pos = torch.tensor([[0, 77, 2 ** 30 - 1, 2 ** 30]], dtype=torch.int32)
    got = apply_rope(x.to(dev), pos.to(dev), theta).cpu()
    torch.testing.assert_close(got, apply_rope(x, pos, theta), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------
# the sliding window on the paged plane
# ---------------------------------------------------------------------

def _reduced_windowed(arch, window=32):
    """Reduced long_context_variant llama3.2-3b or mla_dense (2 layers,
    f32), window 32 (``reduced_config``) or ``window``."""
    import dataclasses
    from repro_torch.configs import (get_config, long_context_variant,
                                     reduced_config)
    cfg = (_reduced_mla_dense() if arch == "mla_dense" else
           reduced_config(get_config("llama3.2-3b")))
    return dataclasses.replace(long_context_variant(cfg),
                               sliding_window=window)


@pytest.mark.parametrize("drain,spec_k", [(1, 0), (3, 0), (1, 3)])
@pytest.mark.parametrize("arch", ["llama", "mla_dense"])
def test_windowed_engine_on_card_matches_cpu(dev, arch, drain, spec_k):
    """Greedy serving of the reduced windowed model (window 32, page 8,
    prompts of 20-64 tokens, 48 new): the window slides past prompt and
    response pages; the card (kernels, windowed) gives the CPU's tokens,
    reclaimed pages and peak pages, at D 1 and D 3 and with spec."""
    from repro_torch.launch.serve import serve_paged
    from repro_torch.models import init
    cfg = _reduced_windowed(arch)
    p_cpu = init(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(4)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (20, 37, 51, 64)]
    kw = dict(max_prompt_len=64, max_new=48, num_slots=2, page_size=8,
              temperature=0.0, seed=0, drain_interval=drain, spec_k=spec_k)
    out = []
    for where, params in ((dev, _to_dev(p_cpu, dev)), ("cpu", p_cpu)):
        done, stats = serve_paged(cfg, prompts, device=where, params=params,
                                  **kw)
        out.append(({c.request_id: c.response_ids.tolist() for c in done},
                    stats["reclaimed_pages"], stats["peak_pages"]))
    assert out[0] == out[1] and out[0][1] > 0


def test_windowed_decode_graph_replay_matches_eager_step(dev):
    """The windowed reduced llama's D 3 decode block on the card, sampled
    at temperature 1 with captured logprobs: replays of the captured
    graph give the tokens, logprobs and reclaimed pages of the same step
    run eagerly on the card (an engine whose graph is dropped)."""
    from repro_torch.core.paged import PagedGroupEngine
    from repro_torch.models import init
    cfg = _reduced_windowed("llama")
    params = _to_dev(init(cfg, seed=0, device="cpu"), dev)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(3, 500, size=(n,)).astype(np.int32)
               for n in (30, 9, 47)]
    kw = dict(num_slots=4, page_size=8, num_pages=0, max_prompt_len=48,
              max_new_tokens=40, group_size=2, temperature=1.0,
              drain_interval=3)
    out = []
    for graph in (True, False):
        eng = PagedGroupEngine(cfg, device=dev, **kw)
        eng.set_params(params)
        if not graph:
            eng._graph = None          # _run_step calls the step itself
        hs = [eng.submit(p, (7, i)) for i, p in enumerate(prompts)]
        while eng.step():
            pass
        torch.cuda.synchronize()
        assert (eng.graph_replays > 0) == graph and eng.reclaimed_pages > 0
        out.append(([h.result(0) for h in hs], eng.reclaimed_pages,
                    eng.decode_steps))
    assert out[0][1:] == out[1][1:]
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a.response_ids, b.response_ids)
        torch.testing.assert_close(a.response_logprobs, b.response_logprobs,
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch", ["llama", "mla_dense"])
def test_windowed_grad_step_on_card_matches_cpu(dev, arch):
    """A captured grad step of the reduced model with a window of 8 on an
    SPA-packed row (positions up to 35, so the window masks keys inside
    the row): the card (SPA forward and backward kernels with the window;
    MLA's expanded attention) against the CPU, within 2e-4 of each leaf's
    largest entry."""
    from repro_torch.configs.base import RLConfig
    from repro_torch.core.queue import RolloutGroup
    from repro_torch.core.spa import pack_spa
    from repro_torch.models import init
    from repro_torch.rl.grpo import make_grad_step_captured, to_device
    cfg = _reduced_windowed(arch, window=8)
    rng = np.random.RandomState(2)
    G, Lp, T = 4, 20, 16
    lens = rng.randint(3, T + 1, size=G).astype(np.int32)
    resp = np.zeros((G, T), np.int32)
    for g in range(G):
        resp[g, :lens[g]] = rng.randint(3, 500, size=lens[g])
    group = RolloutGroup(uid=0, prompt_ids=rng.randint(3, 500, size=Lp)
                         .astype(np.int32), response_ids=resp,
                         response_len=lens, rewards=np.zeros(G, np.float32),
                         weight_version=0,
                         response_logprobs=-rng.rand(G, T).astype(np.float32))
    mb = pack_spa(group, rng.randn(G).astype(np.float32), Lp, T,
                  responses_per_row=G)
    p_cpu = init(cfg, seed=0, device="cpu")
    r_cpu = init(cfg, seed=1, device="cpu")
    step = make_grad_step_captured(cfg, RLConfig())
    n0 = LAUNCHES["spa_attention_bwd"]
    g_gpu, _ = step(_to_dev(p_cpu, dev), None, _to_dev(r_cpu, dev),
                    to_device(mb, dev))
    assert LAUNCHES["spa_attention_bwd"] == n0 + (
        0 if cfg.use_mla else cfg.num_layers)
    g_cpu, _ = step(p_cpu, None, r_cpu, to_device(mb, "cpu"))
    for a, b in zip(_leaves(g_gpu), _leaves(g_cpu)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 2e-4 * float(b.abs().max()), err


# ---------------------------------------------------------------------
# the group Sampler: the contiguous decode kernels on a model path
# ---------------------------------------------------------------------

def _ring_positions(rng, B, L, q_pos, invalid_share):
    """Each row's ring of L slots holding its last L positions up to
    q_pos[b] (slot i holds the position p <= q with p = i mod L, as a ring
    written at offset % L), rows that have not wrapped yet holding INVALID
    in their unwritten slots, and a share of slots INVALID (padding)."""
    i = np.arange(L)[None]
    q = np.asarray(q_pos)[:, None]
    pos = q - (q - i) % L
    pos = np.where(pos < 0, 2 ** 30, pos)
    pos = np.where(rng.rand(B, L) < invalid_share, 2 ** 30, pos)
    return pos.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_decode_kernel_on_a_rotated_ring(dev, dtype):
    """decode_attention over a sliding-window ring (window = L = 512):
    slots out of position order, two rows wrapped, one not yet full, 20 %
    of slots INVALID (padding), against its plain version; one launch
    counted as decode_attention."""
    rng = np.random.RandomState(5)
    B, L, H, Hkv, D = 3, 512, 24, 8, 128
    q_pos = np.array([1700, 530, 300], np.int32)
    kv_pos = _ring_positions(rng, B, L, q_pos, 0.2)
    dt = getattr(torch, dtype)
    k, v = (torch.from_numpy(rng.randn(B, L, Hkv, D).astype(np.float32))
            .to(dev, dt) for _ in range(2))
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32)).to(dev, dt)
    kp, qp = torch.from_numpy(kv_pos).to(dev), torch.from_numpy(q_pos).to(dev)
    got = _launch_twice("decode_attention", decode_attention, q, k, v, kp,
                        qp, window=L)
    torch.testing.assert_close(got.float(), decode_attention_plain(
        *_f32(q, k, v), kp, qp, window=L), **TOL[dtype])


def _sampler_latent(rng, B, Lp, T, lens, t, r, rd):
    """A contiguous latent cache as the Sampler leaves it after t decode
    steps: left padding (INVALID) before each row's prompt, its positions
    0.. from there, unwritten slots INVALID."""
    L = Lp + T
    i = np.arange(L)[None]
    start = Lp - np.asarray(lens)[:, None]
    live = (i >= start) & (i < Lp + t)
    kv_pos = np.where(live, i - start, 2 ** 30).astype(np.int32)
    q_pos = (np.asarray(lens) + t - 1).astype(np.int32)
    ckv = rng.randn(B, L, r).astype(np.float32)
    kr = rng.randn(B, L, rd).astype(np.float32)
    return ckv, kr, kv_pos, q_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,r,rd,Lp,T,lens,window", [
    (16, 512, 64, 1024, 32, (64, 1024, 500, 201), None),   # phase 20 (a)
    (16, 512, 64, 1024, 32, (64, 1024, 500, 201), 256),
    (4, 64, 16, 40, 9, (5, 40, 17), None),                  # reduced
])
def test_contiguous_mla_wrapper_matches_plain(dev, dtype, H, r, rd, Lp, T,
                                              lens, window):
    """mla_decode_attention over a contiguous latent cache, viewed as B
    pages of length L = Lp + T (no 16-slot pages are gathered), against
    its plain version at the Sampler's layout; one launch counted as
    mla_decode_attention."""
    rng = np.random.RandomState(7)
    B = len(lens)
    ckv, kr, kv_pos, q_pos = _sampler_latent(rng, B, Lp, T, lens, T - 3, r,
                                             rd)
    dt = getattr(torch, dtype)
    ckv, kr = (torch.from_numpy(a).to(dev, dt) for a in (ckv, kr))
    q = torch.from_numpy(rng.randn(B, H, r + rd).astype(np.float32)).to(
        dev, dt)
    kp, qp = torch.from_numpy(kv_pos).to(dev), torch.from_numpy(q_pos).to(dev)
    scale = 192 ** -0.5
    got = _launch_twice("mla_decode_attention", mla_decode_attention, q, ckv,
                        kr, kp, qp, scale=scale, window=window)
    torch.testing.assert_close(got.float(), mla_decode_attention_plain(
        *_f32(q, ckv, kr), kp, qp, scale=scale, window=window), **TOL[dtype])


def _sampler_prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(3, 500, size=(n,)).astype(np.int32)
            for n in (5, 19, 33, 40)]


@pytest.mark.parametrize("arch,window", [("llama", None), ("llama", 8),
                                         ("mla_dense", None)])
def test_sampler_on_card_matches_cpu(dev, arch, window):
    """The reduced f32 Sampler, greedy: the card's tokens and lengths are
    the CPU's, logprobs within 1e-4; the contiguous decode wrapper (llama)
    or the contiguous MLA wrapper launches layers x (max_new - 1) times, the
    prefill's SPA forward (llama) layers times; a windowed prompt longer
    than the window rides the ring."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import init
    from repro_torch.rl.rollout import Sampler
    cfg = (_reduced_mla_dense() if arch == "mla_dense"
           else reduced_config(get_config("llama3.2-3b")))
    cfg = dataclasses.replace(cfg, sliding_window=window)
    p_cpu = init(cfg, seed=0, device="cpu")
    prompts, T = _sampler_prompts(), 10
    outs = []
    for where in (dev, "cpu"):
        params = _to_dev(p_cpu, where)
        n0 = dict(LAUNCHES)
        out = Sampler(cfg, 40, T, temperature=0.0, device=where).generate(
            params, prompts, 3)
        torch.cuda.synchronize()
        got = {n: LAUNCHES[n] - n0[n] for n in LAUNCHES}
        L = cfg.num_layers
        if where == dev:
            step = "mla_decode_attention" if cfg.use_mla else \
                "decode_attention"
            assert got[step] == L * (T - 1)
            assert got["spa_attention"] == (0 if cfg.use_mla else L)
            assert sum(got.values()) == got[step] + got["spa_attention"]
        outs.append(tuple(t.cpu() for t in out))
    a, b = outs
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    torch.testing.assert_close(a[2], b[2], atol=1e-4, rtol=1e-4)


def test_no_sampler_kernel_runs_off_the_engine_stream(dev):
    """torch.profiler over a reduced two-iteration training run on the
    group engine: every prefill SPA forward and every contiguous decode
    kernel of the Sampler runs on one stream (the engine's), the
    trainer's SPA forwards and backwards on another."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    cfg, sched, parts = _reduced_pipeline(dev, rollout_engine="group")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hist = sched.run(2)
        torch.cuda.synchronize()
    assert all(s.max_staleness == 0 for s in hist)
    count = collections.defaultdict(collections.Counter)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for kind in ("splitl_kernel", "spa_fwd", "bwd_tiles"):
            if kind in e.name():
                count[e.device_resource_id()][kind] += 1
    L, groups = cfg.num_layers, 2 * 2          # iterations x prompts
    engine = max(count, key=lambda s: count[s]["splitl_kernel"])
    assert count[engine]["splitl_kernel"] == L * 7 * groups
    assert sum(c["splitl_kernel"] for s, c in count.items()
               if s != engine) == 0
    assert count[engine]["spa_fwd"] == L * groups
    assert count[engine]["bwd_tiles"] == 0
    trainer = [s for s, c in count.items() if c["bwd_tiles"]]
    assert len(trainer) == 1 and trainer[0] != engine
    assert count[trainer[0]]["spa_fwd"] == \
        3 * L * sched.captured_micro_steps


def test_flip_during_generate_survives_trainer_allocations(dev):
    """A store flip while the Sampler's kernels are queued (its engine
    stream held busy behind a long matmul chain) drops the store's last
    reference to the tree they read; the trainer's stream then allocates
    and fills tensors of its leaves' sizes (NaN). The tokens equal an
    unflipped run's: the tree's memory is not reused before the Sampler's
    kernels have read it (``record_stream``)."""
    from repro_torch.device import engine_stream
    from repro_torch.rl.rollout import Sampler
    from repro_torch.transfer.service import VersionedParamStore
    cfg, p_cpu, p_gpu = _reduced_llama(dev)
    prompts = _sampler_prompts()
    sampler = Sampler(cfg, 40, 10, temperature=1.0, device=dev)
    want = sampler.generate(p_gpu, prompts, 11).response_ids.cpu()
    store = VersionedParamStore()
    store.install(_to_dev(p_cpu, dev), 0)
    params, _ = store.snapshot()
    with torch.cuda.stream(engine_stream(dev)):
        x = torch.randn(4096, 4096, device=dev)
        for _ in range(8):
            x = x @ x * 1e-3
    out = sampler.generate(params, prompts, 11)
    del params
    store.install(_to_dev(p_cpu, dev), 1)       # the old tree's last ref
    junk = [torch.full_like(t, float("nan")) for t in _leaves(p_gpu)
            for _ in range(2)]
    del junk
    assert torch.equal(out.response_ids.cpu(), want)


# ---------------------------------------------------------------------
# the dense-cache slot and spec engines: per-row writes, the contiguous
# verify routes on a model path
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_verify_kernel_on_a_rotated_ring(dev, dtype):
    """verify_attention over a sliding-window ring of window + k + 1 slots
    (window 512, k 4: the dense spec engines' ring slack): S 5 queries a
    row at consecutive positions, slots out of position order, two rows
    wrapped, one not yet full, 10 % of slots INVALID and one pad query at
    2^30, against its plain version; one launch counted as
    verify_attention."""
    rng = np.random.RandomState(6)
    W, S, H, Hkv, D = 512, 5, 24, 8, 128
    B, L = 3, W + S
    last = np.array([1900, 600, 300], np.int32)
    kv_pos = _ring_positions(rng, B, L, last, 0.1)
    q_pos = (last[:, None] - S + 1 + np.arange(S)[None]).astype(np.int32)
    q_pos[2, -1] = 2 ** 30
    dt = getattr(torch, dtype)
    k, v = (torch.from_numpy(rng.randn(B, L, Hkv, D).astype(np.float32))
            .to(dev, dt) for _ in range(2))
    q = torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32)).to(dev,
                                                                     dt)
    kp, qp = torch.from_numpy(kv_pos).to(dev), torch.from_numpy(q_pos).to(dev)
    got = _launch_twice("verify_attention", verify_attention, q, k, v, kp,
                        qp, window=W)
    torch.testing.assert_close(got.float(), verify_attention_plain(
        *_f32(q, k, v), kp, qp, window=W), **TOL[dtype])


def _slot_latent(rng, lens, L, S, r, rd):
    """A slot engine's contiguous latent cache at a verify step: row b
    holds positions 0..lens[b] + S - 2 from slot 0 (slot index ==
    position), stale speculative entries past them, INVALID after; its S
    queries sit at the frontier's positions."""
    B = len(lens)
    i = np.arange(L)[None]
    n = np.asarray(lens)[:, None] + S - 1
    kv_pos = np.where(i < n + 3, i, 2 ** 30).astype(np.int32)
    q_pos = (n - S + np.arange(S)[None]).astype(np.int32)
    ckv = rng.randn(B, L, r).astype(np.float32)
    kr = rng.randn(B, L, rd).astype(np.float32)
    return ckv, kr, kv_pos, q_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,r,rd,L,lens,window", [
    (16, 512, 64, 1061, (64, 1030, 500, 201), None),   # phase 21 (a)
    (16, 512, 64, 1061, (64, 1030, 500, 201), 256),
    (4, 64, 16, 53, (5, 40, 17), None),                  # reduced
])
def test_contiguous_mla_verify_wrapper_matches_plain(dev, dtype, H, r, rd, L,
                                                     lens, window):
    """mla_verify_attention (S 5) over a contiguous latent cache viewed
    as B pages of length L, against its plain version; one launch counted
    as mla_verify_attention, its plan covering every key."""
    from repro_torch.kernels.decode_attention import (
        LAST_PLAN, mla_verify_attention, mla_verify_attention_plain)
    rng = np.random.RandomState(8)
    S = 5
    ckv, kr, kv_pos, q_pos = _slot_latent(rng, lens, L, S, r, rd)
    dt = getattr(torch, dtype)
    ckv, kr = (torch.from_numpy(a).to(dev, dt) for a in (ckv, kr))
    q = torch.from_numpy(rng.randn(len(lens), S, H, r + rd).astype(
        np.float32)).to(dev, dt)
    kp, qp = torch.from_numpy(kv_pos).to(dev), torch.from_numpy(q_pos).to(dev)
    scale = 192 ** -0.5
    got = _launch_twice("mla_verify_attention", mla_verify_attention, q, ckv,
                        kr, kp, qp, scale=scale, window=window)
    plan = LAST_PLAN["mla_verify_attention"]
    assert plan["splits"] * plan["keys_per_split"] >= L
    torch.testing.assert_close(got.float(), mla_verify_attention_plain(
        *_f32(q, ckv, kr), kp, qp, scale=scale, window=window), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("S", [1, 5])
def test_per_row_write_on_card_equals_cpu(dev, dtype, ring, S):
    """DenseCacheBackend.write_decode at per-row (B,) offsets, six writes
    of S tokens a row (pads among them), plain and on a ring of window +
    S slots: the card's cache is the CPU's, bitwise."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.attention import DenseCacheBackend, cache_streams
    cfg = reduced_config(get_config("llama3.2-3b"))
    if ring:
        cfg = dataclasses.replace(cfg, sliding_window=8)
    L = 8 + S if ring else 24
    B, rng = 3, np.random.RandomState(S)
    be = DenseCacheBackend(cfg, L)
    dt = getattr(torch, dtype)
    states = [be.init(B, dt, where) for where in (dev, "cpu")]
    for _ in range(6):
        vals = [rng.randn(B, S, *shp).astype(np.float32)
                for _, shp in cache_streams(cfg)]
        off = rng.randint(0, 3 * L if ring else L - S + 1, size=(B,))
        pos = (off[:, None] + np.arange(S)[None]).astype(np.int32)
        seg = np.where(rng.rand(B, S) < 0.3, -1, 0).astype(np.int32)
        for st, where in zip(states, (dev, "cpu")):
            be.write_decode(st, tuple(torch.from_numpy(v).to(where, dt)
                                      for v in vals),
                            torch.from_numpy(pos).to(where),
                            torch.from_numpy(seg).to(where),
                            torch.from_numpy(off).to(where))
    for name in states[1]:
        assert torch.equal(states[0][name].cpu(), states[1][name])


def _slot_cfg(arch):
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    if arch == "mla_dense":
        return _reduced_mla_dense()
    if arch == "deepseek_moe":
        return reduced_config(get_config("deepseek-v2-lite-16b"))
    cfg = reduced_config(get_config("llama3.2-3b"))
    return dataclasses.replace(cfg, sliding_window=8) \
        if arch == "llama_window8" else cfg


def _slot_run(cfg, where, params, draft_params, mode, prompts):
    """One greedy run of a slot or spec engine on ``where``: tokens by
    request (and lengths), with the engine."""
    from repro_torch.core.cbatch import ContinuousBatchingSampler
    from repro_torch.core.paged import PagedGroupEngine
    from repro_torch.spec.sampler import SpecSampler
    Lp, T = 40, 10
    if mode in ("spec_sampler", "spec_sampler_model"):
        kw = dict(draft="model", draft_params=draft_params) \
            if mode.endswith("model") else {}
        out = SpecSampler(cfg, Lp, T, spec_k=2, temperature=0.0,
                          device=where, **kw).generate(params, prompts, 3)
        ids, lens = out.response_ids.tolist(), out.response_len.tolist()
        return {b: ids[b][: lens[b]] for b in range(len(prompts))}
    if mode == "paged_model":
        eng = PagedGroupEngine(cfg, num_slots=2, page_size=8, num_pages=0,
                               max_prompt_len=Lp, max_new_tokens=T,
                               group_size=1, temperature=0.0, spec_k=2,
                               spec_draft="model", device=where)
        eng._draft.params = draft_params
        done = eng.serve(params, prompts, 3)
    else:
        kw = {"d1": {}, "d3": dict(drain_interval=3),
              "spec2": dict(spec_k=2)}[mode]
        eng = ContinuousBatchingSampler(
            cfg, num_slots=2, max_prompt_len=Lp, max_new_tokens=T,
            temperature=0.0, device=where, **kw)
        done = eng.run(params, prompts, 3, max_new_per_request=[10, 4, 9, 7])
    return {c.request_id: c.response_ids.tolist() for c in done}


@pytest.mark.parametrize("mode", ["d1", "d3", "spec2", "spec_sampler",
                                  "spec_sampler_model", "paged_model"])
@pytest.mark.parametrize("arch", ["llama", "llama_window8", "mla_dense",
                                  "deepseek_moe"])
def test_slot_engines_on_card_match_cpu(dev, arch, mode):
    """The reduced f32 slot engine (D 1, D 3, spec k 2), the SpecSampler
    (prompt lookup and the draft model) and the paged engine with the
    draft model, greedy: the card's tokens are the CPU's, on the same
    weights and the same draft weights."""
    from repro_torch.models import init
    from repro_torch.spec.draft import draft_config
    cfg = _slot_cfg(arch)
    p_cpu = init(cfg, seed=0, device="cpu")
    d_cpu = init(draft_config(cfg), seed=5, device="cpu")
    prompts = _sampler_prompts()
    got = _slot_run(cfg, dev, _to_dev(p_cpu, dev), _to_dev(d_cpu, dev),
                    mode, prompts)
    torch.cuda.synchronize()
    want = _slot_run(cfg, "cpu", p_cpu, d_cpu, mode, prompts)
    assert got == want


def test_no_slot_engine_kernel_runs_off_the_engine_stream(dev):
    """torch.profiler over the slot engine at D 3 and with spec and the
    draft model, and the SpecSampler: every SPA forward and every
    contiguous decode / verify kernel runs on one stream (the engine's);
    a decode call queued on the default stream beside them (a marker)
    runs on another."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.cbatch import ContinuousBatchingSampler
    from repro_torch.models import init
    from repro_torch.spec.draft import draft_config
    from repro_torch.spec.sampler import SpecSampler
    cfg, _, p_gpu = _reduced_llama(dev)
    d_gpu = _to_dev(init(draft_config(cfg), seed=5, device="cpu"), dev)
    prompts = _sampler_prompts()
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(2, 4, 64).astype(np.float32)).to(dev)
    kv = torch.from_numpy(rng.randn(2, 16, 2, 64).astype(np.float32)).to(dev)
    kp = torch.arange(16, dtype=torch.int32, device=dev).expand(2, 16)
    kp = kp.contiguous()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ContinuousBatchingSampler(
            cfg, num_slots=2, max_prompt_len=40, max_new_tokens=8,
            temperature=0.0, drain_interval=3, device=dev).run(
            p_gpu, prompts, 0)
        eng = ContinuousBatchingSampler(
            cfg, num_slots=2, max_prompt_len=40, max_new_tokens=8,
            temperature=0.0, spec_k=2, spec_draft="model", device=dev)
        eng._draft.params = d_gpu
        eng.run(p_gpu, prompts, 0)
        SpecSampler(cfg, 40, 8, spec_k=2, temperature=0.0,
                    device=dev).generate(p_gpu, prompts, 0)
        decode_attention(q, kv, kv, kp, torch.full((2,), 15, dtype=torch.int32,
                                                   device=dev))
        torch.cuda.synchronize()
    count = collections.defaultdict(collections.Counter)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        for kind in ("splitl_kernel", "spa_fwd"):
            if kind in e.name():
                count[e.device_resource_id()][kind] += 1
    assert len(count) == 2
    marker = min(count, key=lambda s: count[s]["splitl_kernel"])
    assert count[marker] == collections.Counter(splitl_kernel=1)
    engine = max(count, key=lambda s: count[s]["splitl_kernel"])
    assert count[engine]["splitl_kernel"] > 0 and count[engine]["spa_fwd"] > 0
