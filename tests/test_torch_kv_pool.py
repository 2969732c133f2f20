"""The port's KV block-pool allocator (:mod:`unionml_tpu_torch.serving
.kv_pool`): the twins of ``tests/unit/test_kv_pool.py``.

Each case drives the port's pool and the reference's through the same
calls, asserts the reference's contract on both and holds the port's
block ids, counters and gauges equal to the reference's: admission
reserves a request's worst case up front, so table growth never fails;
exhaustion surfaces as ``PoolExhausted`` at reservation; block 0 is the
trash block and is never allocated.
"""

import pytest

from unionml_tpu import telemetry as jtelemetry
from unionml_tpu.serving import kv_pool as jkv

from unionml_tpu_torch import telemetry
from unionml_tpu_torch.serving import kv_pool

import torch_threads

torch_threads.share_cores()

PACKAGES = [(kv_pool, telemetry), (jkv, jtelemetry)]


def make_pool(mod, tel, num_blocks=8, block_size=16, block_nbytes=1024):
    return mod.KVBlockPool(num_blocks=num_blocks, block_size=block_size,
                           block_nbytes=block_nbytes, registry=tel.MetricsRegistry())


def both(case):
    """``case(mod, telemetry)`` on the port and the reference; their
    returns must be equal."""
    ours, theirs = (case(mod, tel) for mod, tel in PACKAGES)
    assert ours == theirs
    return ours


def test_trash_block_is_the_reference_s():
    assert kv_pool.TRASH_BLOCK == jkv.TRASH_BLOCK == 0


def test_capacity_excludes_trash_block():
    def case(mod, tel):
        pool = make_pool(mod, tel, num_blocks=8)
        assert pool.capacity == 7
        assert pool.available == 7
        pool.reserve(7)
        taken = [pool.take() for _ in range(7)]
        assert mod.TRASH_BLOCK not in taken
        assert sorted(taken) == list(range(1, 8))
        return taken

    both(case)


def test_reserve_take_give_roundtrip():
    def case(mod, tel):
        pool = make_pool(mod, tel)
        pool.reserve(3)
        assert pool.reserved == 3
        assert pool.available == pool.capacity - 3
        a, b = pool.take(), pool.take()
        assert pool.in_use == 2
        assert pool.reserved == 1
        pool.give([a, b], unreserve=1)
        assert (pool.in_use, pool.reserved, pool.available) == (0, 0, pool.capacity)
        stats = pool.stats()
        assert stats["allocated_blocks"] == 2
        assert stats["freed_blocks"] == 2
        return (a, b), stats

    both(case)


def test_exhaustion_raises_and_counts():
    def case(mod, tel):
        pool = make_pool(mod, tel, num_blocks=4)  # capacity 3
        pool.reserve(2)
        with pytest.raises(mod.PoolExhausted) as exc:
            pool.reserve(2)
        assert exc.value.needed == 2
        assert exc.value.available == 1
        assert pool.stats()["alloc_failures"] == 1
        # the failed reservation committed nothing
        assert pool.reserved == 2
        pool.reserve(1)  # the remaining block still reservable
        return str(exc.value), pool.stats()

    both(case)


def test_take_without_reservation_refused():
    def case(mod, tel):
        with pytest.raises(RuntimeError) as exc:
            make_pool(mod, tel).take()
        return type(exc.value)

    both(case)


def test_reservation_makes_growth_infallible():
    """Once reserved, every take() succeeds even if another caller
    drains the unreserved remainder first."""
    def case(mod, tel):
        pool = make_pool(mod, tel, num_blocks=6)  # capacity 5
        pool.reserve(2)                 # request A
        pool.reserve(3)                 # request B takes everything else
        b_ids = [pool.take() for _ in range(3)]
        a_ids = [pool.take() for _ in range(2)]
        assert len(set(a_ids + b_ids)) == 5
        with pytest.raises(mod.PoolExhausted):
            pool.reserve(1)
        return a_ids, b_ids

    both(case)


def test_give_validates_ids_and_unreserve():
    def case(mod, tel):
        pool = make_pool(mod, tel, num_blocks=4)
        pool.reserve(1)
        bid = pool.take()
        for bad in (dict(ids=[0]), dict(ids=[99]), dict(ids=[], unreserve=1)):
            # the trash block; outside the pool; nothing reserved anymore
            with pytest.raises(ValueError):
                pool.give(bad["ids"], unreserve=bad.get("unreserve", 0))
        pool.give([bid])
        return pool.stats()

    both(case)


def test_reset_returns_everything():
    def case(mod, tel):
        pool = make_pool(mod, tel, num_blocks=6)
        pool.reserve(4)
        ids = [pool.take() for _ in range(3)]
        assert ids
        pool.reset()
        assert (pool.in_use, pool.reserved, pool.available) == (0, 0, pool.capacity)
        return ids, pool.stats()

    both(case)


def test_occupancy_and_fragmentation_gauges():
    def case(mod, tel):
        pool = make_pool(mod, tel, num_blocks=5, block_size=16)  # capacity 4
        pool.reserve(3)
        pool.take(), pool.take()
        # 2 in use + 1 reserved over capacity 4
        assert pool.stats()["occupancy"] == pytest.approx(0.75)
        # 20 used rows over 2 blocks x 16 rows
        pool.note_used_rows(20)
        st = pool.stats()
        assert st["fragmentation"] == pytest.approx(1 - 20 / 32, abs=1e-3)
        assert st["bytes_in_use"] == 2 * 1024
        return st

    both(case)


def test_blocks_for_rows():
    def case(mod, tel):
        pool = make_pool(mod, tel, block_size=16)
        got = [pool.blocks_for_rows(n) for n in (0, 1, 16, 17)]
        assert got == [0, 1, 1, 2]
        return got

    both(case)


def test_constructor_validation():
    def case(mod, tel):
        with pytest.raises(ValueError):
            make_pool(mod, tel, num_blocks=1)  # only the trash block
        with pytest.raises(ValueError):
            mod.KVBlockPool(num_blocks=4, block_size=0, registry=tel.MetricsRegistry())

    both(case)
