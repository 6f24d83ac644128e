"""The port's prefix store (``tpu_kubernetes_torch/serve/prefix_cache.py``)
against the cases of ``tests/test_prefix_cache.py``, on torch tensors:
longest-prefix matching, byte-accurate sizing (``numel() *
element_size()``), LRU eviction under the cap, subsumption on insert, the
bytes callback, ``stats()``, and the paged entries' eviction callback.
Each case also runs on the JAX package's store with numpy arrays of the
same shapes, and the two must agree."""

import numpy as np
import pytest
import torch

from tpu_kubernetes.serve import prefix_cache as jpc
from tpu_kubernetes_torch.serve import prefix_cache as tpc


def _arrays(n_tokens: int, lib):
    """A fake per-token segment: n_tokens positions of f64 (8 B each)."""
    if lib is tpc:
        return {"k": torch.zeros((n_tokens,), dtype=torch.float64)}
    return {"k": np.zeros((n_tokens,), np.float64)}


BOTH = pytest.mark.parametrize("lib", [tpc, jpc], ids=["port", "jax"])


def test_common_prefix_len():
    for lib in (tpc, jpc):
        assert lib._common_prefix_len((1, 2, 3), (1, 2, 4)) == 2
        assert lib._common_prefix_len((1, 2), (1, 2, 3)) == 2
        assert lib._common_prefix_len((9,), (1,)) == 0
        assert lib._common_prefix_len((), (1, 2)) == 0


def test_entry_nbytes_is_byte_accurate():
    e = tpc.PrefixEntry(ids=(1, 2, 3), arrays={
        "k": torch.zeros((2, 3), dtype=torch.float32),    # 24 B
        "v": torch.zeros((6,), dtype=torch.int8),         # 6 B
        "b": torch.zeros((2, 2), dtype=torch.bfloat16),   # 8 B
        "scale": None,                                    # ignored
    })
    assert e.nbytes == 24 + 6 + 8
    # a view counts its own elements, not its base's storage
    base = torch.zeros((4, 10), dtype=torch.float32)
    assert tpc.PrefixEntry(ids=(1,), arrays={"k": base[:, :3]}).nbytes == 48
    j = jpc.PrefixEntry(ids=(1, 2, 3), arrays={
        "k": np.zeros((2, 3), np.float32), "v": np.zeros((6,), np.int8),
        "scale": None})
    assert j.nbytes == 24 + 6


@BOTH
def test_lookup_longest_match_and_miss(lib):
    pc = lib.PrefixCache(max_bytes=1 << 20)
    pc.insert([1, 2, 3, 4], _arrays(4, lib))
    pc.insert([1, 2, 9, 9, 9, 9], _arrays(6, lib))
    q, entry = pc.lookup([1, 2, 3, 4, 5, 6])
    assert q == 4 and entry.ids == (1, 2, 3, 4)
    q, entry = pc.lookup([1, 2, 9, 7])
    assert q == 3 and entry.ids == (1, 2, 9, 9, 9, 9)  # partial match
    q, entry = pc.lookup([8, 8])
    assert q == 0 and entry is None


@BOTH
def test_insert_covered_refreshes_instead_of_duplicating(lib):
    pc = lib.PrefixCache(max_bytes=1 << 20)
    assert pc.insert([1, 2, 3, 4], _arrays(4, lib)) is True
    # a strict prefix of a stored entry adds nothing
    assert pc.insert([1, 2], _arrays(2, lib)) is False
    assert len(pc) == 1
    # an extension REPLACES the shorter stored segment
    assert pc.insert([1, 2, 3, 4, 5, 6], _arrays(6, lib)) is True
    assert len(pc) == 1
    q, entry = pc.lookup([1, 2, 3, 4, 5, 6, 7])
    assert q == 6 and len(entry.ids) == 6


@BOTH
def test_lru_eviction_under_byte_cap(lib):
    # each segment = 10 tokens × 8 B = 80 B; cap fits two
    pc = lib.PrefixCache(max_bytes=200)
    pc.insert(list(range(100, 110)), _arrays(10, lib))
    pc.insert(list(range(200, 210)), _arrays(10, lib))
    assert len(pc) == 2 and pc.bytes == 160
    # touch the FIRST entry so the second becomes least-recently-used
    q, _ = pc.lookup(list(range(100, 110)))
    assert q == 10
    pc.insert(list(range(300, 310)), _arrays(10, lib))
    assert len(pc) == 2 and pc.bytes <= pc.max_bytes
    assert pc.lookup(list(range(200, 210)))[1] is None   # evicted
    assert pc.lookup(list(range(100, 110)))[0] == 10     # survived


@BOTH
def test_oversized_segment_is_refused(lib):
    pc = lib.PrefixCache(max_bytes=64)
    assert pc.insert(list(range(100)), _arrays(100, lib)) is False
    assert len(pc) == 0 and pc.bytes == 0


@BOTH
def test_on_bytes_callback_tracks_total(lib):
    seen = []
    pc = lib.PrefixCache(max_bytes=200, on_bytes=seen.append)
    pc.insert([1] * 10, _arrays(10, lib))
    pc.insert([2] * 10, _arrays(10, lib))
    pc.insert([3] * 10, _arrays(10, lib))     # evicts the [1]* entry
    assert seen == [80, 160, 160]
    assert pc.bytes == 160


@BOTH
def test_stats_payload(lib):
    pc = lib.PrefixCache(max_bytes=1024,
                         sig=("llama-test", "float32", False))
    pc.insert([5] * 8, _arrays(8, lib))
    assert pc.stats() == {
        "entries": 1, "bytes": 64, "max_bytes": 1024,
        "sig": ["llama-test", "float32", False],
    }


@BOTH
def test_paged_entries_evict_through_the_callback(lib):
    """Paged entries: extension replacement and LRU eviction both hand the
    dropped entry to on_evict, after the store's lock; clear() does only
    with notify."""
    dropped = []
    pc = lib.PrefixCache(max_bytes=300,
                         on_evict=lambda e: dropped.append(e.pages))
    assert pc.insert_paged([1] * 16, [4], 100)
    assert pc.insert_paged([1] * 32, [4, 5], 200)        # extension
    assert dropped == [(4,)]
    assert pc.insert_paged([2] * 16, [7], 100)           # 300: at the cap
    assert pc.insert_paged([3] * 16, [8], 100)           # LRU: [1]*32 goes
    assert dropped == [(4,), (4, 5)]
    assert pc.clear() == 2 and dropped == [(4,), (4, 5)]
    assert pc.insert_paged([3] * 16, [8], 100)
    assert pc.clear(notify=True) == 1 and dropped[-1] == (8,)


def test_zero_cap_is_refused():
    for lib in (tpc, jpc):
        with pytest.raises(ValueError, match="max_bytes must be > 0"):
            lib.PrefixCache(max_bytes=0)
