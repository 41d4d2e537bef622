"""The port's PagedKVManager against the JAX one: driven through the same
admit / register_prefix / ensure_writable / preempt / resume sequence, the
two keep equal page tables, block tables, refcounts, prefix indexes and
free counts, and their pools hold the same bytes after every copy-on-write
(copies are exact, so bit for bit)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_reduced as jax_reduced           # noqa: E402
from repro.serving.kvcache import PagedKVManager as JaxKV      # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_reduced                     # noqa: E402
from repro_torch.serving.kvcache import (PagedKVManager,        # noqa: E402
                                         SharedPageBudget, kv_page_bytes)

KW = dict(total_pages=16, page_size=4, max_seqs=4, max_len=64,
          share_prefix=True)


def _same_state(tkv, jkv):
    assert tkv.tables == jkv.tables
    np.testing.assert_array_equal(tkv.block_tables,
                                  np.asarray(jkv.block_tables))
    np.testing.assert_array_equal(tkv.refcount, jkv.refcount)
    np.testing.assert_array_equal(tkv.seq_len, jkv.seq_len)
    assert tkv.free_pages == jkv.free_pages
    assert tkv.used_pages == jkv.used_pages
    assert tkv.prefix_index == jkv.prefix_index
    assert list(tkv.cached) == list(jkv.cached)
    assert tkv.cow_copies == jkv.cow_copies
    assert tkv.partial_head_copies == jkv.partial_head_copies
    pools = bridge.pools_to_numpy(tkv.pools)
    jpools = jax.tree.map(np.asarray, jkv.pools)
    for a, b in zip(jax.tree.leaves(pools), jax.tree.leaves(jpools)):
        np.testing.assert_array_equal(a, b)


def test_kv_manager_matches_jax():
    tkv = PagedKVManager(get_reduced("smollm-135m"), **KW, device="cpu")
    jkv = JaxKV(jax_reduced("smollm-135m"), **KW)
    # identical random pool contents, so every page copy is visible
    rng = np.random.default_rng(0)
    content = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jkv.pools)
    jkv.pools = jax.tree.map(jax.numpy.asarray, content)
    tkv.pools = bridge.pools_from_numpy(content, device="cpu")
    _same_state(tkv, jkv)

    A = rng.integers(1, 500, 13).tolist()
    for kv in (tkv, jkv):
        assert kv.admit(1, 20, tokens=A)
        kv.seq_len[kv.seq_of[1]] = 12
        kv.register_prefix(1, A[:12])
    _same_state(tkv, jkv)
    # rid 2 shares two full pages and the head of the third (token-level
    # partial hit: a CoW copy of the donor page)
    B = A[:10] + rng.integers(1, 500, 6).tolist()
    hits = [kv.admit(2, 24, tokens=B) and kv.length(2) for kv in (tkv, jkv)]
    assert hits[0] == hits[1] == 10
    _same_state(tkv, jkv)
    # write into the shared second page: copy-on-write
    for kv in (tkv, jkv):
        kv.ensure_writable(2, 6, 6)
        kv.check_writable(2, 6, 6)
    _same_state(tkv, jkv)
    assert tkv.cow_copies == 1
    # preempt rid 1 (its published pages retire to the cached pool), let
    # a third request evict part of it, then resume with a re-share
    for kv in (tkv, jkv):
        kv.preempt(1)
    _same_state(tkv, jkv)
    C = rng.integers(1, 500, 30).tolist()
    for kv in (tkv, jkv):
        assert kv.admit(3, 30, tokens=C)
    _same_state(tkv, jkv)
    hits = [kv.resume(1, 20, tokens=A) for kv in (tkv, jkv)]
    assert hits[0] == hits[1]
    _same_state(tkv, jkv)
    probes = [kv.prefix_discounts(A) for kv in (tkv, jkv)]
    assert probes[0] == probes[1]
    for kv in (tkv, jkv):
        kv.release(2)
        kv.release(3)
    _same_state(tkv, jkv)


def test_kv_budget_and_page_bytes():
    from repro.serving.kvcache import kv_page_bytes as jax_page_bytes
    cfg = get_reduced("smollm-135m")
    assert kv_page_bytes(cfg, 16) == jax_page_bytes(
        jax_reduced("smollm-135m"), 16)
    budget = SharedPageBudget(6)
    kv = PagedKVManager(cfg, total_pages=16, page_size=4, max_seqs=4,
                        max_len=64, budget=budget, device="cpu")
    assert kv.admit(1, 16)                        # 4 pages
    assert not kv.admit(2, 12)                    # 3 more exceed the budget
    assert budget.used == kv.used_pages == 4
    kv.release(1)
    assert budget.used == 0


def test_unported_options_raise():
    """The manager options once unported are ported now.  The host
    spill tier: asking for it builds the tier (off without prefix sharing,
    as in the reference).  Mesh placement: ``place`` splits the GQA pools
    on the KV-head axis, one tree per shard, and the pools of a placed
    manager are read per shard; a cluster refuses a mesh that is not a
    ``ServingMesh``."""
    from repro_torch.distributed.sharding import (make_serving_mesh,
                                                  serving_shard_plan)
    from repro_torch.serving.cluster import ClusterFrontend
    cfg = get_reduced("smollm-135m")
    kv = PagedKVManager(cfg, total_pages=8, host_spill_pages=4,
                        share_prefix=True, device="cpu")
    assert kv.host_spill_pages == 4 and not kv.host_index
    assert PagedKVManager(cfg, total_pages=8, host_spill_pages=4,
                          device="cpu").host_spill_pages == 0
    whole = kv.pools[0]["self"]["k_pages"].shape
    mesh = make_serving_mesh(["cpu"] * 2)
    kv.place(mesh, serving_shard_plan(cfg, mesh, max_seqs=kv.max_seqs))
    for pools in kv.shard_pools:
        got = pools[0]["self"]["k_pages"].shape
        assert got[-2] * 2 == whole[-2] and got[:-2] == whole[:-2]
    with pytest.raises(RuntimeError):
        kv.pools
    with pytest.raises(TypeError):
        ClusterFrontend.build(cfg, None, 2, None, mesh=object(),
                              device="cpu")
