"""Property-based tests (hypothesis) on the port's paged KV allocator
(``repro_torch.serve.paged``), twins of ``tests/test_paged_properties.py``:
the BlockPool never double-frees, never leaks (free + live always equals
the pool size), and the logical→physical mapping across all live block
tables stays injective; exhaustion is typed and recoverable.  One more
property runs the same random operation sequence through the reference's
``BlockPool`` / ``BlockTable`` and the port's and asserts the same block
ids and free counts after every operation.

Pure host-side accounting, so these run in milliseconds.
"""

import pytest

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the optional hypothesis dep "
    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.serve.paged import (NULL_BLOCK, BlockPool,  # noqa: E402
                                     BlockTable, PoolExhausted)

_SETTINGS = dict(max_examples=50, deadline=None)
_OPS = st.lists(st.tuples(st.sampled_from(["grow", "release", "new"]),
                          st.integers(0, 7), st.integers(1, 4)),
                min_size=1, max_size=60)


def _check_invariants(pool, tables):
    # conservation: every block is exactly one of {free, live}
    assert pool.num_free + pool.num_live == pool.num_blocks
    # injectivity: no physical block mapped twice across live tables
    seen = set()
    for t in tables:
        for b in t.blocks:
            assert b != NULL_BLOCK
            assert 1 <= b <= pool.num_blocks
            assert b not in seen, f"block {b} mapped twice"
            seen.add(b)
    assert len(seen) == pool.num_live


def _apply(pool_cls, table_cls, exhausted, pool_size, ops, check=None):
    """Run ``ops`` on a fresh pool; after each op yield (the blocks of
    every table, the free count, the outcome)."""
    pool = pool_cls(pool_size)
    max_blocks = max(pool_size // 2, 1)
    tables = [table_cls(pool, max_blocks)]
    for op, idx, n in ops:
        t = tables[idx % len(tables)]
        outcome = "ok"
        if op == "grow":
            before = t.num_blocks
            try:
                t.grow(n)
            except exhausted:
                assert t.num_blocks >= before
                outcome = "exhausted"
            except ValueError:
                assert t.num_blocks + n > t.max_blocks
                outcome = "overflow"
        elif op == "release":
            t.release()
        else:
            tables.append(table_cls(pool, max_blocks))
        if check is not None:
            check(pool, tables)
        yield ([list(map(int, x.blocks)) for x in tables], pool.num_free,
               outcome)
    for t in tables:
        t.release()
    assert pool.num_free == pool.num_blocks


@settings(**_SETTINGS)
@given(pool_size=st.integers(1, 32), ops=_OPS)
def test_pool_table_invariants_under_random_ops(pool_size, ops):
    """Random grow / release / new sequences, with PoolExhausted and
    table-overflow errors absorbed as the slot manager absorbs them, keep
    conservation and injectivity intact."""
    for _ in _apply(BlockPool, BlockTable, PoolExhausted, pool_size, ops,
                    check=_check_invariants):
        pass


@settings(**_SETTINGS)
@given(pool_size=st.integers(1, 16), seq=st.data())
def test_no_double_free(pool_size, seq):
    """Freeing a block the pool does not consider live always raises:
    never allocated, already freed, or out of range."""
    pool = BlockPool(pool_size)
    held = [pool.alloc() for _ in range(
        seq.draw(st.integers(0, pool_size)))]
    freed = []
    while held:
        b = held.pop()
        pool.free(b)
        freed.append(b)
    for b in freed:
        with pytest.raises(ValueError, match="double free"):
            pool.free(b)
    with pytest.raises(ValueError):
        pool.free(NULL_BLOCK)
    with pytest.raises(ValueError):
        pool.free(pool_size + 1)
    assert pool.num_free == pool.num_blocks


@settings(**_SETTINGS)
@given(pool_size=st.integers(2, 16), extra=st.integers(1, 3))
def test_refcount_sharing_delays_recycle(pool_size, extra):
    """A share()d block survives its first free()s and returns to the free
    list only when the last reference drops."""
    pool = BlockPool(pool_size)
    b = pool.alloc()
    for _ in range(extra):
        pool.share(b)
    for _ in range(extra):
        pool.free(b)
        assert pool.num_free == pool_size - 1   # still live
    pool.free(b)
    assert pool.num_free == pool_size
    with pytest.raises(ValueError, match="double free"):
        pool.free(b)


def test_exhaustion_is_typed_and_recoverable():
    pool = BlockPool(2)
    a, b = pool.alloc(), pool.alloc()
    with pytest.raises(PoolExhausted):
        pool.alloc()
    pool.free(a)
    assert pool.alloc() == a                    # LIFO recycle
    with pytest.raises(ValueError, match="not live"):
        pool.share(NULL_BLOCK)


@settings(**_SETTINGS)
@given(pool_size=st.integers(1, 32), ops=_OPS)
def test_same_block_ids_as_reference(pool_size, ops):
    """The reference's allocator and the port's, fed one random operation
    sequence, hand out the same block ids, keep the same free counts and
    fail on the same operations."""
    jpaged = pytest.importorskip("repro.serve.paged")
    want = _apply(jpaged.BlockPool, jpaged.BlockTable, jpaged.PoolExhausted,
                  pool_size, ops)
    got = _apply(BlockPool, BlockTable, PoolExhausted, pool_size, ops)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"op {step} {ops[step]}"
