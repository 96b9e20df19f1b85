"""Conformance: the Triton barcode-rank kernel (Pallas interpreter on
CPU) must reproduce the jnp path exactly — best valley cost and position
per (window, pattern), and the Lodhi score at that position, bit for
bit."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu.ops.device import (  # noqa: E402
    UNIT,
    best_valley_per_pattern,
    window_dp_summary,
)
from barbell_tpu.ops.triton_rank import rank_pass1  # noqa: E402

BASES = np.array([1, 2, 4, 8], dtype=np.uint8)


def make_windows(rng, pats, H, W, strand_of=None):
    P, m = pats.shape
    wins = np.zeros((H, W), dtype=np.uint8)
    wlen = rng.integers(min(m, W), W + 1, H).astype(np.int32)
    for h in range(H):
        content = BASES[rng.integers(0, 4, size=int(wlen[h]))]
        lo = strand_of(h) if strand_of else 0
        p = pats[lo + rng.integers(0, P if not strand_of else P // 2)]
        pos = int(rng.integers(0, max(1, int(wlen[h]) - m)))
        seg = p[: min(m, int(wlen[h]) - pos)].copy()
        if len(seg) > 3:
            seg[rng.integers(0, len(seg))] = 15  # an N inside the copy
        content[pos : pos + len(seg)] = seg
        wins[h, : wlen[h]] = content
    return wins, wlen


def jnp_rank(pats, wins, wlen):
    H = wins.shape[0]
    m = pats.shape[1]
    summ = window_dp_summary(
        jnp.asarray(pats[None]), jnp.asarray(wins),
        jnp.zeros(H, dtype=bool), jnp.full(H, -1, dtype=jnp.int32),
        jnp.int32(UNIT), jnp.int32(0), jnp.int32(-1), jnp.int32(2),
        jnp.int32(min(7, m - 1)), with_lodhi=True,
    )
    best = best_valley_per_pattern(summ.ends, jnp.asarray(wlen))
    lod = jnp.take_along_axis(summ.lodhi, best.pos[:, :, None], axis=2)[:, :, 0]
    return np.asarray(best.cost), np.asarray(best.pos), np.asarray(lod)


@pytest.mark.parametrize(
    "H,P,m,W",
    [(10, 12, 9, 21), (5, 3, 14, 40), (13, 40, 20, 33), (2, 8, 9, 9)],
)
def test_rank_pass1_matches_jnp(H, P, m, W):
    rng = np.random.default_rng(H * 1000 + P)
    pats = BASES[rng.integers(0, 4, size=(P, m))]
    wins, wlen = make_windows(rng, pats, H, W)
    key, lod = rank_pass1(
        jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(wlen), P=P,
        split=False, interpret=True,
    )
    key, lod = np.asarray(key), np.asarray(lod)
    cost, pos, want_lod = jnp_rank(pats, wins, wlen)
    assert np.array_equal(key // 256, cost)
    assert np.array_equal(key % 256, pos)
    assert np.array_equal(lod, want_lod)


def test_rank_pass1_split_matches_full():
    """Strand-split rank == full 2P rank restricted to each lane's own
    strand half (fwd lanes in the first H/2, rc lanes after)."""
    rng = np.random.default_rng(7)
    P, m, W = 12, 10, 24
    H = 16
    pats = BASES[rng.integers(0, 4, size=(2 * P, m))]
    wins, wlen = make_windows(
        rng, pats, H, W, strand_of=lambda h: P if h >= H // 2 else 0
    )
    ks, ls = rank_pass1(
        jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(wlen), P=P,
        split=True, interpret=True,
    )
    kf, lf = rank_pass1(
        jnp.asarray(pats), jnp.asarray(wins), jnp.asarray(wlen), P=2 * P,
        split=False, interpret=True,
    )
    ks, ls, kf, lf = map(np.asarray, (ks, ls, kf, lf))
    half = H // 2
    assert np.array_equal(ks[:half], kf[:half, :P])
    assert np.array_equal(ks[half:], kf[half:, P:])
    assert np.array_equal(ls[:half], lf[:half, :P])
    assert np.array_equal(ls[half:], lf[half:, P:])
