"""Monotone per-rank offsets for the owner-search edge cases of K6 and
K7 (runs of empty ranks longer than a tile's window, an empty tail,
offsets[0] > 0, one rank, sparse and wide ranks). The card tests hold the
kernels to their plain versions on them; the CPU tests hold the plain
version to the definition."""

import numpy as np

OWNER_CASES = ("mid_zero_runs", "empty_tail", "first_positive", "single_rank", "sparse_ranks",
               "wide_ranks")


def owner_offsets(kind):
    """Monotone int32 offsets and the end of the last rank's slots."""
    rng = np.random.default_rng(OWNER_CASES.index(kind))
    n = 400 if kind == "wide_ranks" else 30_000
    counts = rng.integers(1, 9, size=n)
    if kind == "mid_zero_runs":  # runs of empty ranks longer than a tile, not at the end
        for a in (2_000, 11_000, 20_000):
            counts[a:a + 4_000] = 0
    elif kind == "empty_tail":  # ranks that cover no tile go last
        counts[n - 18_000:] = 0
    elif kind == "sparse_ranks":  # one rank in 3000 owns slots
        counts[:] = 0
        counts[::3_000] = rng.integers(1, 50, size=counts[::3_000].shape[0])
    elif kind == "wide_ranks":  # ranks that span several tiles
        counts = rng.integers(0, 6_000, size=n)
    elif kind == "single_rank":
        counts = np.array([9])
    inc = np.cumsum(counts)
    off = inc - counts
    if kind in ("first_positive", "single_rank"):
        off = off + 777  # slots below offsets[0] clip to rank 0
    return off.astype(np.int32), int(off[-1] + counts[-1])
