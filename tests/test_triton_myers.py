"""Triton Myers kernel conformance (Pallas interpreter on CPU): the
in-kernel top-K valley keys and counts must equal the oracle's unit-cost
end-cost curve under the plateau-valley rule."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu.ops import oracle  # noqa: E402
from barbell_tpu.ops.triton_myers import (  # noqa: E402
    BIG,
    TOPK,
    myers_topk,
    pattern_words,
)

BASES = np.array([1, 2, 4, 8], dtype=np.uint8)


def oracle_keys(pattern, row, emit_lo, emit_hi, k_units, klmul):
    """Sorted valley keys (cost*klmul + j) of one row, unit costs; the
    kernel decides positions 0..L-1 from true neighbours."""
    C = oracle.dp_table(pattern, row)
    ends = oracle.end_costs(C) // oracle.COST_SCALE
    L = len(row)
    keys = []
    for j in range(L):
        e = ends[j]
        prv = ends[j - 1] if j > 0 else 1 << 20
        if e <= k_units and e <= prv and e < ends[j + 1] and emit_lo <= j <= emit_hi:
            keys.append(int(e) * klmul + j)
    return sorted(keys)


def run(pattern, rows, emit_lo, emit_hi, k_units, klmul):
    patw, W, top_bit = pattern_words(pattern)
    keys, cnt = myers_topk(
        jnp.asarray(patw), jnp.asarray(rows), jnp.asarray(emit_lo),
        jnp.asarray(emit_hi), W=W, top_bit=top_bit, m=len(pattern),
        k_units=k_units, klmul=klmul, interpret=True,
    )
    return np.asarray(keys), np.asarray(cnt)


def planted_rows(rng, pattern, R, L, active, positions):
    m = len(pattern)
    rows = np.zeros((R, L), dtype=np.uint8)
    for r in active:
        rows[r] = BASES[rng.integers(0, 4, L)]
        for pos in positions:
            seg = pattern[: min(m, L - pos)].copy()
            if len(seg) > 4:
                seg[rng.integers(0, len(seg))] = BASES[rng.integers(0, 4)]
            rows[r, pos : pos + len(seg)] = seg
    return rows


def test_pattern_words():
    pat = np.array([1, 2, 4, 8, 15], dtype=np.uint8)  # A C G T N
    words, W, top_bit = pattern_words(pat)
    assert W == 1
    assert top_bit == 4
    assert words[0, 0] == 0b10001  # A membership: pos 0 and N pos 4
    assert words[1, 0] == 0b10010
    assert words[2, 0] == 0b10100
    assert words[3, 0] == 0b11000


@pytest.mark.parametrize("m", [7, 32, 45, 90])
def test_myers_topk_matches_oracle(m):
    """Word counts 1-3 (incl. the padded 3-word block), rows padded to
    the block size, a padding-only row, and keys + exact counts."""
    rng = np.random.default_rng(m)
    R, L = 70, 128
    pattern = BASES[rng.integers(0, 4, m)]
    active = [0, 1, 37, 69]
    rows = planted_rows(rng, pattern, R, L, active, (3, 50, 90))
    k_units = max(3, m // 4)
    klmul = 1000
    emit_lo = np.full(R, 1, dtype=np.int32)
    emit_hi = np.full(R, L - 2, dtype=np.int32)
    keys, cnt = run(pattern, rows, emit_lo, emit_hi, k_units, klmul)
    assert keys.shape == (R, TOPK) and cnt.shape == (R,)
    for r in active + [2]:  # 2 = all-zero row
        want = oracle_keys(pattern, rows[r], 1, L - 2, k_units, klmul)
        assert cnt[r] == len(want), (m, r)
        got = keys[r][keys[r] < BIG]
        assert np.array_equal(got, want[:TOPK]), (m, r, got, want)


def test_myers_emit_bounds():
    rng = np.random.default_rng(5)
    R, L, m = 64, 128, 10
    pattern = BASES[rng.integers(0, 4, m)]
    rows = np.zeros((R, L), dtype=np.uint8)
    rows[0] = BASES[rng.integers(0, 4, L)]
    rows[0, 40 : 40 + m] = pattern  # exact hit ending at 50
    emit_lo = np.full(R, 60, dtype=np.int32)  # excludes the hit
    emit_hi = np.full(R, 120, dtype=np.int32)
    keys, cnt = run(pattern, rows, emit_lo, emit_hi, 2, 1000)
    want = oracle_keys(pattern, rows[0], 60, 120, 2, 1000)
    assert all(k % 1000 >= 60 for k in keys[0][keys[0] < BIG])
    assert cnt[0] == len(want)


def test_myers_topk_overflow_keeps_best():
    """A row with more than TOPK valleys: exact count, best TOPK keys."""
    rng = np.random.default_rng(11)
    R, L, m = 64, 256, 8
    pattern = BASES[rng.integers(0, 4, m)]
    rows = np.zeros((R, L), dtype=np.uint8)
    rows[5] = BASES[rng.integers(0, 4, L)]
    for pos in range(2, L - m, 2 * m):  # 15 exact copies
        rows[5, pos : pos + m] = pattern
    emit_lo = np.full(R, 1, dtype=np.int32)
    emit_hi = np.full(R, L - 2, dtype=np.int32)
    keys, cnt = run(pattern, rows, emit_lo, emit_hi, 2, 1000)
    want = oracle_keys(pattern, rows[5], 1, L - 2, 2, 1000)
    assert len(want) > TOPK
    assert cnt[5] == len(want)
    assert np.array_equal(keys[5], want[:TOPK])


def _scan_case(case, rng, L=256):
    """Rows + per-row metadata the way demux_call builds them: forward
    reads (left-aligned, both true ends), rc twins (right-aligned), and
    ends-mode prefix/suffix rows (one true end, claims cut short)."""
    from barbell_tpu import PADDING
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models.pipeline import _GroupPlan
    from barbell_tpu.ops.edit_model import get_edit_cut_off
    from barbell_tpu.utils import dna

    g = BarcodeGroup.from_kit("SQK-RBK114-24")[0]
    g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    plan = _GroupPlan(g)
    flank = dna.encode(g.flank)
    R = 12
    rows = np.zeros((R, L), dtype=np.uint8)
    meta = []
    mk = plan.m + plan.k_units
    for r in range(R):
        cut = int(rng.integers(0, 12))  # left overhang: trimmed flank start
        # every third read is short: the flank overhangs both read ends,
        # or the two boundary windows meet (lengths around m+k+2)
        short = {1: plan.m - cut - 3, 4: mk + 2, 7: mk + 1, 10: plan.m - cut - 6}
        n = short.get(r, int(rng.integers(plan.m + 30, L)))
        text = BASES[rng.integers(0, 4, n)]
        head = flank[cut : cut + n]
        text[: len(head)] = np.where(head == 15, text[: len(head)], head)
        mid = int(rng.integers(min(len(head), n), max(len(head) + 1, n - plan.m)))
        seg = flank[: max(0, min(plan.m, n - mid))]
        text[mid : mid + len(seg)] = np.where(seg == 15, text[mid : mid + len(seg)], seg)
        if r == 4:  # a match ending where the two windows meet (m+k+1)
            seg = flank[: mk + 1 - (plan.k_units + 1)]
            text[plan.k_units + 1 : mk + 1] = np.where(
                seg == 15, text[plan.k_units + 1 : mk + 1], seg
            )
        if r % 3 == 0:  # right overhang: flank runs off the read end
            tail = flank[: min(n, plan.m - int(rng.integers(1, 10)))]
            text[n - len(tail) :] = np.where(tail == 15, text[n - len(tail) :], tail)
        if case == "rc":
            rows[r, L - n :] = text
            meta.append((L - n, L, True, True, L - n, L))
        elif case == "fwd":
            rows[r, :n] = text
            meta.append((0, n, True, True, 0, n))
        else:  # ends rows fill the row: prefix / suffix alternate
            full = BASES[rng.integers(0, 4, L)]
            full[:n] = text
            rows[r] = full
            if r % 2 == 0:
                meta.append((0, L, True, False, 0, L - 1 - PADDING))
            else:
                meta.append((0, L, False, True, int(rng.integers(130, 200)), L))
    return plan, rows, meta


@pytest.mark.parametrize("case", ["fwd", "rc", "ends"])
def test_scan_keys_kernel_path_matches_jnp(case):
    """The Myers interior + jnp boundary windows give the same top-K
    valley keys and counts as the whole-row jnp scan, with overhang at
    read starts, read ends and claim edges."""
    from barbell_tpu.ops import composite as comp
    from barbell_tpu.ops.kernels import INTERPRET, XLA
    from barbell_tpu.ops.oracle import scale_alpha

    rng = np.random.default_rng({"fwd": 1, "rc": 2, "ends": 3}[case])
    plan, rows, meta = _scan_case(case, rng)
    L = rows.shape[1]
    tsc, tec, ts, te, lo, hi = (np.array(c) for c in zip(*meta))
    start_col = np.where(ts, tsc, -1).astype(np.int32)
    end_col = np.where(te, tec, L + 2).astype(np.int32)
    mk = plan.m + plan.k_units
    emit_lo = np.where(ts, tsc + mk + 2, lo).astype(np.int32)
    emit_hi = np.where(te, np.minimum(hi, tec - 2), hi).astype(np.int32)
    K = 16
    args = [
        jnp.asarray(plan.flank), jnp.asarray(plan.patw), jnp.asarray(rows),
        jnp.asarray(start_col), jnp.asarray(end_col),
        jnp.asarray(lo.astype(np.int32)), jnp.asarray(hi.astype(np.int32)),
        jnp.asarray(emit_lo), jnp.asarray(emit_hi),
        jnp.int32(scale_alpha(0.4)),
    ]
    kw = dict(K=K, m=plan.m, k_units=plan.k_units, W_words=plan.W_words,
              top_bit=plan.top_bit, csc=jnp.asarray(tsc.astype(np.int32)),
              cec=jnp.asarray(tec.astype(np.int32)))
    kx, cx = (np.asarray(a) for a in comp._scan_keys(*args, kernels=XLA, **kw))
    kk, ck = (np.asarray(a) for a in comp._scan_keys(*args, kernels=INTERPRET, **kw))
    assert (cx > 0).sum() >= len(meta) // 2  # the planted flanks are found
    for r in range(len(meta)):
        if ck[r] > K and cx[r] > TOPK:
            continue  # > TOPK interior valleys: both sides flag overflow
        assert ck[r] == cx[r], (case, r)
        assert np.array_equal(kk[r], kx[r]), (case, r)
