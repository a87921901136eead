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
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,D,page,lens", [
    (3, 4, 2, 64, 4, (3, 17, 9)),
    (4, 24, 8, 128, 16, (100, 1056, 517, 64)),
])
def test_paged_decode_kernel_matches_plain(dev, dtype, B, H, Hkv, D, page,
                                           lens):
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
    got = paged_decode_attention(*args)
    want = paged_decode_attention_plain(*_f32(*args))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, **TOL[dtype])


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


SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                     1.00390625, 1.01171875,        # bf16 ties: even, odd
                     1e-40, -1e-40, 1e-45,          # f32 denormals
                     3.3895314e38, 3.4e38, -3.4e38,  # bf16 overflow edge
                     6.5504e4, 6.5520e4],           # f16 max, overflow tie
                    np.float32)


@pytest.mark.parametrize("wire", ["bfloat16", "float16"])
@pytest.mark.parametrize("n,offset", [(0, 0), (7, 0), (4096, 0), (1000003, 0),
                                      (1000, 1)])
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
