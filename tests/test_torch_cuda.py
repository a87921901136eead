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
    chunked_attention, spa_attention)

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
    assert all(LAUNCHES[n] > n0[n] for n in LAUNCHES)
    cpu, _ = serve_paged(cfg, prompts, device="cpu", params=p_cpu, **kw)
    assert [c.response_ids.tolist() for c in gpu] == \
        [c.response_ids.tolist() for c in cpu]
