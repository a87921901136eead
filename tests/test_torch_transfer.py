"""The port's weight-plane against the JAX package's.

* The wire cast: the port's plain version (``x.to(dtype)``, what
  ``transfer_cast`` runs on a CPU tensor) is bitwise equal to JAX's Pallas
  ``transfer_cast`` in interpret mode and to ``astype``, on seeded, ragged
  and special-value inputs (NaN positions compared apart from their bits).
* Plans: every leaf in exactly one bucket, the JAX plan's buckets on the
  same tree, and a bf16 wire round trip that restores the storage dtype.
* The versioned store never shows a half-delivered version, and the
  service's publish / overlap / failure paths behave as the JAX ones.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.transfer_cast import \
    transfer_cast as jax_transfer_cast  # noqa: E402
from repro.transfer.plan import build_plan as jax_build_plan  # noqa: E402
from repro_torch.core.engine import InferenceInstance  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels.transfer_cast import transfer_cast  # noqa: E402
from repro_torch.transfer.plan import (build_plan,  # noqa: E402
                                       flatten_with_keys, pack_bucket,
                                       unflatten, unpack_bucket)
from repro_torch.transfer.service import (  # noqa: E402
    VersionedParamStore, WeightTransferService)

SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                     1.00390625, 1.01171875, 1.0117188,   # bf16 ties, near
                     1e-40, -1e-40, 1e-45,                 # f32 denormals
                     3.3895314e38, 3.4e38, -3.4e38],       # bf16 max, overflow
                    np.float32)


def _bits_equal(got: np.ndarray, want: np.ndarray):
    """Bitwise equality of two bf16 arrays given as uint16 views; NaN
    positions must agree, their payload bits may differ."""
    nan_g = (got & 0x7FFF) > 0x7F80
    nan_w = (want & 0x7FFF) > 0x7F80
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_w], want[~nan_w])


def _torch_bf16_bits(x: np.ndarray) -> np.ndarray:
    return transfer_cast(torch.from_numpy(x), torch.bfloat16) \
        .view(torch.int16).numpy().view(np.uint16)


def _jax_bf16_bits(x) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.uint16))


@pytest.mark.parametrize("shape", [(257, 33), (5,), (16, 128), (1, 1),
                                   (3, 1000)])
def test_plain_cast_bitwise_equals_jax_kernel_and_astype(shape):
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 10.0 ** rng.randint(-6, 6, shape)
         ).astype(np.float32)
    flat = x.reshape(-1)
    flat[:min(flat.size, SPECIALS.size)] = SPECIALS[:flat.size]
    got = _torch_bf16_bits(x)
    _bits_equal(got, _jax_bf16_bits(jnp.asarray(x).astype(jnp.bfloat16)))
    _bits_equal(got, _jax_bf16_bits(jax_transfer_cast(jnp.asarray(x),
                                                      "bfloat16")))


def test_cast_refuses_other_pairs_and_passes_same_dtype():
    x = torch.ones(4)
    assert transfer_cast(x, torch.float32) is x
    n0 = LAUNCHES["transfer_cast"]
    assert transfer_cast(x, torch.float16).dtype == torch.float16
    assert LAUNCHES["transfer_cast"] == n0          # plain version: no launch
    with pytest.raises(TypeError, match="float32 ->"):
        transfer_cast(x.bfloat16(), torch.float32)
    with pytest.raises(TypeError, match="float32 ->"):
        transfer_cast(x.double(), torch.bfloat16)


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"layers": {"w": rng.randn(3, 40, 7).astype(np.float32),
                       "scale": rng.randn(3, 40).astype(np.float32)},
            "embed": {"embedding": rng.randn(50, 40).astype(np.float32)},
            "final_norm": {"scale": rng.randn(40).astype(np.float32)}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("bucket_bytes,wire", [(1, None), (600, None),
                                               (1 << 20, "bfloat16"),
                                               (2000, "bfloat16")])
def test_bucketing_covers_every_leaf_once_like_jax(bucket_bytes, wire):
    tree = _tree()
    plan = build_plan(_torch_tree(tree), bucket_bytes=bucket_bytes,
                      wire_dtype=wire)
    seen = sorted(i for b in plan.buckets for i in b.indices)
    assert seen == list(range(len(plan.leaves)))
    assert all(b.wire_bytes <= bucket_bytes or len(b.indices) == 1
               for b in plan.buckets)
    jplan = jax_build_plan(jax.tree.map(jnp.asarray, tree),
                           bucket_bytes=bucket_bytes, wire_dtype=wire)
    assert [lp.key for lp in plan.leaves] == [lp.key for lp in jplan.leaves]
    assert [b.indices for b in plan.buckets] == \
        [b.indices for b in jplan.buckets]
    assert plan.total_wire_bytes == jplan.total_wire_bytes


def _push(plan, tree):
    leaves = flatten_with_keys(tree)[1]
    slots = [None] * len(leaves)
    for b in plan.buckets:
        for i, x in unpack_bucket(plan, b, pack_bucket(plan, leaves, b)):
            slots[i] = x
    return unflatten(plan.keys, slots)


def test_wire_round_trip_restores_storage_dtype():
    tree = _torch_tree(_tree(1))
    same = _push(build_plan(tree, bucket_bytes=300), tree)
    for a, b in zip(flatten_with_keys(tree)[1], flatten_with_keys(same)[1]):
        assert b is a                       # storage dtype: the leaf itself
    back = _push(build_plan(tree, bucket_bytes=300, wire_dtype="bfloat16"),
                 tree)
    for a, b in zip(flatten_with_keys(tree)[1], flatten_with_keys(back)[1]):
        assert b.dtype == torch.float32 and b.shape == a.shape
        assert torch.equal(b, a.to(torch.bfloat16).to(torch.float32))


def _tiny_tree(v: float):
    return {"a": torch.full((8,), v), "b": torch.full((3, 3), v + 0.5)}


def test_store_partial_delivery_invisible():
    store = VersionedParamStore()
    store.install(_tiny_tree(0.0), 0)
    tree = _tiny_tree(1.0)
    plan = build_plan(tree, bucket_bytes=16)      # forces >= 2 buckets
    assert len(plan.buckets) >= 2
    leaves = flatten_with_keys(tree)[1]
    store.begin(1, plan)
    b0 = plan.buckets[0]
    done = store.deliver(b0, unpack_bucket(plan, b0,
                                           pack_bucket(plan, leaves, b0)))
    assert not done and store.staged_version is None
    p, v = store.snapshot()
    assert v == 0 and float(p["a"][0]) == 0.0
    with pytest.raises(AssertionError):
        store.flip()                              # incomplete staging
    for b in plan.buckets[1:]:
        done = store.deliver(b, unpack_bucket(plan, b,
                                              pack_bucket(plan, leaves, b)))
    assert done and store.staged_version == 1
    assert float(store.staged_params()["a"][0]) == 1.0
    assert store.flip() == 1
    p, v = store.snapshot()
    assert v == 1 and float(p["a"][0]) == 1.0


def test_store_rejects_stale_begin_and_double_deliver():
    store = VersionedParamStore()
    store.install(_tiny_tree(0.0), 5)
    tree = _tiny_tree(1.0)
    plan = build_plan(tree, bucket_bytes=1 << 20)
    with pytest.raises(AssertionError):
        store.begin(5, plan)                      # not newer than active
    store.begin(6, plan)
    leaves = flatten_with_keys(tree)[1]
    b0 = plan.buckets[0]
    placed = unpack_bucket(plan, b0, pack_bucket(plan, leaves, b0))
    store.deliver(b0, placed)
    with pytest.raises(AssertionError):
        store.deliver(b0, placed)


def test_store_snapshot_pair_never_tears():
    store = VersionedParamStore()
    store.install(_tiny_tree(0.0), 0)
    stop = threading.Event()
    errs = []

    def flipper():
        for v in range(1, 60):
            store.install(_tiny_tree(float(v)), v)
        stop.set()

    def reader():
        while not stop.is_set():
            p, v = store.snapshot()
            if float(p["a"][0]) != float(v):
                errs.append((float(p["a"][0]), v))

    threads = [threading.Thread(target=flipper)] + \
        [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, f"torn (params, version) pairs observed: {errs[:5]}"


def _scripted_instances(n):
    return [InferenceInstance(i, cfg=None, scripted_fn=lambda p, k: None)
            for i in range(n)]


def test_service_publish_overlap_and_gate():
    insts = _scripted_instances(2)
    svc = WeightTransferService(insts, bucket_bytes=32, wire_dtype="bfloat16")
    svc.ensure(_tiny_tree(0.0), 0)                # first boundary: eager
    assert svc.gaps[-1]["mode"] == "eager"
    assert svc.bytes_streamed == svc.plan.total_wire_bytes
    got = {}
    waiter = threading.Thread(
        target=lambda: got.update(v=insts[0].store.wait_version(1)[1]))
    waiter.start()
    time.sleep(0.05)
    assert waiter.is_alive()                      # gated on version 1
    svc.publish_async(_tiny_tree(1.25), 1)        # overlapped stream
    assert svc.ensure(_tiny_tree(1.25), 1) == 1
    waiter.join(timeout=5)
    assert got["v"] == 1
    for i in insts:
        p, ver = i.store.snapshot()
        assert ver == 1 and float(p["a"][0]) == 1.25 and \
            p["a"].dtype == torch.float32


def test_stream_failure_surfaces_and_poisons_gate():
    insts = _scripted_instances(1)
    svc = WeightTransferService(insts, bucket_bytes=32,
                                wire_dtype="not-a-dtype")
    svc.publish_async(_tiny_tree(0.0), 0)
    with pytest.raises(RuntimeError, match="weight-plane"):
        svc.ensure(_tiny_tree(0.0), 0)
    with pytest.raises(RuntimeError, match="stream failed"):
        insts[0].store.wait_version(0, timeout=5)
    good = WeightTransferService(insts, bucket_bytes=32)
    good.publish(_tiny_tree(1.0), 1)
    p, v = insts[0].store.wait_version(1, timeout=5)
    assert v == 1 and float(p["a"][0]) == 1.0
