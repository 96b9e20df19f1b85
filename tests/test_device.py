"""Device kernel conformance: every kernel must match the NumPy oracle
exactly (integer cost domain), and the full batched engine must produce
row-identical output to the scalar Demuxer."""

import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from barbell_tpu.kits import database as db  # noqa: E402
from barbell_tpu.models.barcodes import BarcodeGroup  # noqa: E402
from barbell_tpu.models.demux import Demuxer  # noqa: E402
from barbell_tpu.models.pipeline import JaxDemuxEngine  # noqa: E402
from barbell_tpu.models.records import Strand  # noqa: E402
from barbell_tpu.ops import device as dev  # noqa: E402
from barbell_tpu.ops import oracle  # noqa: E402
from barbell_tpu.ops.edit_model import get_edit_cut_off  # noqa: E402
from barbell_tpu.ops.kernels import INTERPRET  # noqa: E402
from barbell_tpu.ops.lodhi import lodhi_from_ops  # noqa: E402
from barbell_tpu.utils import dna  # noqa: E402

BASES = np.array([1, 2, 4, 8], dtype=np.uint8)


def rand_masks(rng, n):
    return BASES[rng.integers(0, 4, n)]


# ---------------------------------------------------------------------------
# flank_ends vs oracle dp_table
# ---------------------------------------------------------------------------


def test_flank_ends_matches_oracle():
    rng = np.random.default_rng(0)
    m, B, L = 12, 6, 64
    pattern = rand_masks(rng, m)
    lens = rng.integers(20, L + 1, B).astype(np.int32)
    text = np.zeros((B, L), dtype=np.uint8)
    for b in range(B):
        text[b, : lens[b]] = rand_masks(rng, lens[b])

    ends = np.asarray(
        dev.flank_ends(
            jnp.asarray(pattern),
            jnp.asarray(text),
            jnp.zeros(B, dtype=np.int32),
            jnp.asarray(lens),
            np.int32(oracle.scale_alpha(0.4)),
        )
    )
    for b in range(B):
        C = oracle.dp_table(pattern, text[b, : lens[b]], alpha=0.4)
        want = oracle.end_costs(C)
        got = ends[b, : lens[b] + 1]
        assert np.array_equal(got, want), b


def test_flank_ends_no_left_edge():
    # is_first=False removes the overhang start boundary: costs near the
    # row start must not benefit from the cheap alpha prefix.
    rng = np.random.default_rng(1)
    pattern = rand_masks(rng, 8)
    text = rand_masks(rng, 40)[None, :]
    ends_first = np.asarray(
        dev.flank_ends(
            jnp.asarray(pattern),
            jnp.asarray(text),
            jnp.asarray(np.array([0], np.int32)),
            jnp.asarray(np.array([40], np.int32)),
            np.int32(oracle.scale_alpha(0.4)),
        )
    )[0]
    ends_mid = np.asarray(
        dev.flank_ends(
            jnp.asarray(pattern),
            jnp.asarray(text),
            jnp.asarray(np.array([-1], np.int32)),
            jnp.asarray(np.array([40], np.int32)),
            np.int32(oracle.scale_alpha(0.4)),
        )
    )[0]
    assert (ends_mid >= ends_first).all()
    # deep interior positions agree (no boundary influence)
    assert np.array_equal(ends_mid[20:], ends_first[20:])


# ---------------------------------------------------------------------------
# find_hits vs oracle find_valleys
# ---------------------------------------------------------------------------


def test_find_hits_matches_oracle_valleys():
    rng = np.random.default_rng(2)
    pattern = rand_masks(rng, 6)
    B, L = 4, 80
    text = np.stack([rand_masks(rng, L) for _ in range(B)])
    k = 2
    ends = dev.flank_ends(
        jnp.asarray(pattern),
        jnp.asarray(text),
        jnp.zeros(B, dtype=np.int32),
        jnp.asarray(np.full(B, L, np.int32)),
        np.int32(oracle.COST_SCALE),  # alpha=1 == no special overhang
    )
    hits = dev.find_hits(
        ends,
        jnp.zeros(B, jnp.int32),
        jnp.full(B, L, jnp.int32),
        np.int32(oracle.scale_k(k)),
        8,
    )
    for b in range(B):
        C = oracle.dp_table(pattern, text[b], alpha=1.0)
        want = set(oracle.find_valleys(oracle.end_costs(C), oracle.scale_k(k)))
        got = {
            int(p)
            for p, v in zip(np.asarray(hits.pos[b]), np.asarray(hits.valid[b]))
            if v
        }
        assert got == want
        assert int(np.asarray(hits.count)[b]) == len(want)


# ---------------------------------------------------------------------------
# window_dp + traceback_reduce vs oracle window_table/traceback
# ---------------------------------------------------------------------------


def _window_case(rng, m=10, W=24, alpha=0.4, left_edge=True, right=False):
    pattern = rand_masks(rng, m)
    w_len = int(rng.integers(m - 2, W + 1))
    window = np.zeros(W, dtype=np.uint8)
    content = rand_masks(rng, w_len)
    # plant a noisy copy of the pattern
    pos = int(rng.integers(0, max(1, w_len - m)))
    content[pos : pos + m] = pattern[: min(m, w_len - pos)]
    window[:w_len] = content
    right_pos = w_len if right else -1
    return pattern, window, w_len, left_edge, right_pos, alpha


def test_window_dp_matches_oracle_window_table():
    rng = np.random.default_rng(3)
    for trial in range(8):
        pattern, window, w_len, left_edge, right_pos, alpha = _window_case(
            rng,
            left_edge=bool(trial % 2),
            right=bool(trial % 3 == 0),
        )
        m, W = len(pattern), len(window)
        wdp = dev.window_dp(
            jnp.asarray(pattern[None, :]),
            jnp.asarray(window[None, :]),
            jnp.asarray(np.array([left_edge])),
            jnp.asarray(np.array([right_pos], np.int32)),
            np.int32(oracle.scale_alpha(alpha)),
        )
        got_ends = np.asarray(wdp.ends)[0, 0]
        C = oracle.window_table(pattern, window[:w_len], left_edge, right_pos, alpha)
        want_ends = C[-1]
        assert np.array_equal(got_ends[: w_len + 1], want_ends), trial


def test_traceback_reduce_matches_oracle_traceback():
    rng = np.random.default_rng(4)
    for trial in range(10):
        pattern, window, w_len, left_edge, right_pos, alpha = _window_case(
            rng, left_edge=bool(trial % 2), right=bool(trial % 4 == 0)
        )
        m, W = len(pattern), len(window)
        wdp = dev.window_dp(
            jnp.asarray(pattern[None, :]),
            jnp.asarray(window[None, :]),
            jnp.asarray(np.array([left_edge])),
            jnp.asarray(np.array([right_pos], np.int32)),
            np.int32(oracle.scale_alpha(alpha)),
        )
        a_incl, b_incl = 2, m - 3
        iv_a, iv_b = 3, m - 2
        tr = dev.traceback_reduce(
            wdp.moves,
            jnp.asarray(np.array([[w_len]], np.int32)),
            jnp.asarray(np.array([[True]])),
            np.int32(a_incl),
            np.int32(b_incl),
            np.int32(iv_a),
            np.int32(iv_b),
            m=m,
            W=W,
        )

        C = oracle.window_table(pattern, window[:w_len], left_edge, right_pos, alpha)
        ts, path, ops = oracle.window_traceback(
            C, pattern, window[:w_len], w_len, left_edge, right_pos, alpha
        )
        aln = oracle.Alignment(
            text_start=ts,
            text_end=w_len,
            cost=int(C[-1, w_len]),
            strand=Strand.Fwd,
            path=path,
            ops=ops,
        )
        assert int(np.asarray(tr.text_start)[0, 0]) == ts, trial

        reg = oracle.matching_region(aln, a_incl, b_incl)
        got_lo = int(np.asarray(tr.region_lo)[0, 0])
        got_hi = int(np.asarray(tr.region_hi)[0, 0])
        assert reg == (got_lo, got_hi), trial

        iv = oracle.map_pattern_interval(aln, iv_a, iv_b)
        assert iv is not None
        (pi, pe), (pj, ej), cost = iv
        assert int(np.asarray(tr.iv_pi)[0, 0]) == pi
        assert int(np.asarray(tr.iv_ei)[0, 0]) == pe - 1
        assert int(np.asarray(tr.iv_pj)[0, 0]) == pj
        assert int(np.asarray(tr.iv_ej)[0, 0]) == ej - 1
        assert int(np.asarray(tr.iv_cost)[0, 0]) == cost

        want_lodhi = lodhi_from_ops(ops)
        got_lodhi = float(np.asarray(tr.lodhi)[0, 0])
        assert got_lodhi == pytest.approx(want_lodhi, rel=1e-5), trial


def test_best_valley_per_pattern_matches_oracle():
    rng = np.random.default_rng(5)
    P, m, H, W = 5, 8, 3, 30
    patterns = np.stack([rand_masks(rng, m) for _ in range(P)])
    w_len = np.array([30, 22, 17], dtype=np.int32)
    windows = np.zeros((H, W), dtype=np.uint8)
    for h in range(H):
        windows[h, : w_len[h]] = rand_masks(rng, w_len[h])
        windows[h, 3 : 3 + m] = patterns[h % P]

    bdp = dev.window_dp(
        jnp.asarray(patterns),
        jnp.asarray(windows),
        jnp.zeros(H, dtype=bool),
        jnp.full(H, -1, jnp.int32),
        np.int32(dev.UNIT),
    )
    best = dev.best_valley_per_pattern(bdp.ends, jnp.asarray(w_len))
    for h in range(H):
        got_best = oracle.best_match_per_pattern(patterns, windows[h, : w_len[h]], m)
        for p in range(P):
            aln = got_best[p]
            assert aln is not None
            assert int(np.asarray(best.cost)[h, p]) == aln.cost, (h, p)
            assert int(np.asarray(best.pos)[h, p]) == aln.text_end, (h, p)


# ---------------------------------------------------------------------------
# Full engine conformance vs scalar Demuxer
# ---------------------------------------------------------------------------


def _engine_pair(kit="SQK-RBK110-96", n_bars=None):
    groups = BarcodeGroup.from_kit(kit)
    for g in groups:
        if n_bars is not None:
            g.barcodes = g.barcodes[:n_bars]
            g.patterns_fwd = g.patterns_fwd[:n_bars]
            g.patterns_rc = g.patterns_rc[:n_bars]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    scalar = Demuxer(alpha=0.4)
    for g in groups:
        scalar.add_query_group(g)
    engine = JaxDemuxEngine(groups, alpha=0.4)
    return scalar, engine


def _random_read(rng, n):
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def _mutate(rng, seq, n_edits):
    s = bytearray(seq)
    for _ in range(n_edits):
        idx = rng.randrange(len(s))
        op = rng.randrange(3)
        if op == 0:
            cur = s[idx]
            choices = [b for b in b"ACGT" if b != cur]
            s[idx] = rng.choice(choices)
        elif op == 1 and len(s) > 1:
            del s[idx]
        else:
            s.insert(idx, rng.choice(b"ACGT"))
    return bytes(s)


def _construct(idx):
    return (db.RBK4_FRONT + db.BC_SEQS[idx] + db.RBK4_REAR).encode()


@pytest.mark.slow
def test_engine_matches_oracle_on_synthetic_reads():
    rng = random.Random(42)
    scalar, engine = _engine_pair(n_bars=16)

    reads = []
    for i in range(24):
        kind = i % 6
        body = _random_read(rng, rng.randrange(150, 500))
        bc = rng.randrange(16)
        if kind == 0:  # clean front construct
            seq = _construct(bc) + body
        elif kind == 1:  # rc read
            seq = dna.reverse_complement_bytes(_construct(bc) + body)
        elif kind == 2:  # mutated construct
            seq = _mutate(rng, _construct(bc) + body, 6)
        elif kind == 3:  # random (no construct)
            seq = body
        elif kind == 4:  # left-trimmed construct (overhang)
            seq = _construct(bc)[rng.randrange(1, 20) :] + body
        else:  # constructs both ends
            seq = (
                _construct(bc)
                + body
                + dna.reverse_complement_bytes(_construct((bc + 1) % 16))
            )
        reads.append((f"r{i}", seq))

    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]
    got = engine.demux_batch(ids, seqs)
    for rid, seq, rows in zip(ids, seqs, got):
        want = scalar.demux(rid, seq)
        assert rows == want, f"{rid}: {rows} != {want}"


@pytest.mark.slow
def test_engine_matches_oracle_chunked_long_reads():
    rng = random.Random(7)
    scalar, engine = _engine_pair(n_bars=8)
    engine.max_row_len = 512  # force chunking

    reads = []
    for i in range(4):
        body = _random_read(rng, 1500)
        mid = _construct(i)  # construct placed mid-read (chunk interior)
        seq = _construct(7 - i) + body[:700] + mid + body[700:]
        reads.append((f"long{i}", seq))

    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]
    got = engine.demux_batch(ids, seqs)
    for rid, seq, rows in zip(ids, seqs, got):
        want = scalar.demux(rid, seq)
        assert rows == want, rid


@pytest.mark.slow
def test_engine_pallas_path_matches_oracle():
    """The Triton kernel path (Myers flank scan + rank, in the Pallas
    interpreter on CPU) must agree with the scalar engine on short
    synthetic reads."""
    rng = random.Random(11)
    groups = BarcodeGroup.from_kit("SQK-RBK110-96")
    for g in groups:
        g.barcodes = g.barcodes[:6]
        g.patterns_fwd = g.patterns_fwd[:6]
        g.patterns_rc = g.patterns_rc[:6]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    scalar = Demuxer(alpha=0.4)
    for g in groups:
        scalar.add_query_group(g)
    engine = JaxDemuxEngine(groups, alpha=0.4, kernels=INTERPRET,
                            devices=jax.devices()[:1])

    reads = []
    for i in range(6):
        body = _random_read(rng, 120)
        bc = i % 6
        if i % 3 == 0:
            seq = _construct(bc) + body  # clean front
        elif i % 3 == 1:
            seq = dna.reverse_complement_bytes(_construct(bc) + body)
        else:
            seq = _construct(bc)[10:] + body  # left-trimmed (overhang)
        reads.append((f"p{i}", seq))

    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]
    got = engine.demux_batch(ids, seqs)
    for rid, seq, rows in zip(ids, seqs, got):
        want = scalar.demux(rid, seq)
        assert rows == want, f"{rid}: {rows} != {want}"


# ---------------------------------------------------------------------------
# window_dp_summary vs window_dp + traceback_reduce
# ---------------------------------------------------------------------------


def test_window_dp_summary_matches_traceback():
    """The fused forward-summary DP must reproduce traceback_reduce's
    outputs at EVERY end position, for every summary kind, including
    alpha boundaries (left edge / right pos)."""
    rng = np.random.default_rng(11)
    for trial in range(8):
        H, P, m, W = 3, 4, 9, 22
        left_edge = bool(trial % 2)
        right = trial % 4 == 0
        alpha = 0.4 if trial % 3 else 1.0
        patterns = np.stack([rand_masks(rng, m) for _ in range(P)])
        windows = np.zeros((H, W), dtype=np.uint8)
        w_lens = rng.integers(m, W + 1, H).astype(np.int32)
        for h in range(H):
            content = rand_masks(rng, int(w_lens[h]))
            p = patterns[rng.integers(0, P)]
            pos = int(rng.integers(0, max(1, w_lens[h] - m)))
            content[pos : pos + m] = p[: min(m, int(w_lens[h]) - pos)]
            windows[h, : w_lens[h]] = content
        ledge = np.full(H, left_edge)
        rpos = np.where(np.full(H, right), w_lens, -1).astype(np.int32)
        a = np.int32(oracle.scale_alpha(alpha))
        region_a, region_b = np.int32(2), np.int32(m - 3)
        iv_a, iv_b = np.int32(3), np.int32(m - 1)

        wdp = dev.window_dp(
            jnp.asarray(patterns), jnp.asarray(windows), jnp.asarray(ledge),
            jnp.asarray(rpos), a,
        )
        summ = dev.window_dp_summary(
            jnp.asarray(patterns[None]), jnp.asarray(windows),
            jnp.asarray(ledge), jnp.asarray(rpos), a,
            region_a, region_b, iv_a, iv_b,
            with_lodhi=True, with_region=True, with_interval=True,
            with_start=True,
        )
        assert np.array_equal(np.asarray(summ.ends), np.asarray(wdp.ends))

        for j in (0, 1, m // 2, m, W // 2, W):
            end_j = jnp.full((H, P), j, dtype=jnp.int32)
            valid = jnp.ones((H, P), dtype=bool)
            tr = dev.traceback_reduce(
                wdp.moves, end_j, valid, region_a, region_b, iv_a, iv_b,
                m=m, W=W,
            )
            sl = lambda arr: np.asarray(arr)[:, :, j]
            assert np.array_equal(sl(summ.text_start), np.asarray(tr.text_start)), (trial, j)
            assert np.array_equal(sl(summ.region_lo), np.asarray(tr.region_lo)), (trial, j)
            assert np.array_equal(sl(summ.region_hi), np.asarray(tr.region_hi)), (trial, j)
            assert np.array_equal(sl(summ.iv_pi), np.asarray(tr.iv_pi)), (trial, j)
            assert np.array_equal(sl(summ.iv_pj), np.asarray(tr.iv_pj)), (trial, j)
            assert np.array_equal(sl(summ.iv_ei), np.asarray(tr.iv_ei)), (trial, j)
            assert np.array_equal(sl(summ.iv_ej), np.asarray(tr.iv_ej)), (trial, j)
            assert np.array_equal(sl(summ.iv_cost), np.asarray(tr.iv_cost)), (trial, j)
            assert np.array_equal(sl(summ.has_interval), np.asarray(tr.has_interval)), (trial, j)
            np.testing.assert_allclose(
                sl(summ.lodhi), np.asarray(tr.lodhi), rtol=1e-5, atol=1e-7,
                err_msg=str((trial, j)),
            )


def test_composites_match_reference_impls():
    """barcode_rank / flank_trace (fused summary DP) vs the kept
    window_dp + traceback_reduce reference implementations, on windows
    carrying noisy kit barcodes."""
    from barbell_tpu.ops import composite as comp

    rng = np.random.default_rng(12)
    group = BarcodeGroup.from_kit("SQK-RBK114-96")[0]
    patterns = np.asarray(group.patterns_fwd, dtype=np.uint8)[:16]
    P, m = patterns.shape
    W = m + 24
    H, L = 12, 256

    rows = np.zeros((H, L), dtype=np.uint8)
    win_start = rng.integers(0, L - W, H).astype(np.int32)
    w_len = rng.integers(m, W + 1, H).astype(np.int32)
    for h in range(H):
        content = rand_masks(rng, int(w_len[h]))
        pat = patterns[rng.integers(0, P)]
        pos = int(rng.integers(0, max(1, int(w_len[h]) - m)))
        noisy = pat.copy()
        for _ in range(rng.integers(0, 4)):
            noisy[rng.integers(0, m)] = BASES[rng.integers(0, 4)]
        content[pos : pos + m] = noisy[: min(m, int(w_len[h]) - pos)]
        rows[h, win_start[h] : win_start[h] + w_len[h]] = content
    hvalid = np.ones(H, dtype=bool)
    hvalid[-1] = False

    pad_start, _ = group.pad_region
    iv_a = np.int32(group.bar_region[0] - pad_start)
    iv_b = np.int32(group.bar_region[1] - pad_start)
    from barbell_tpu.ops.lodhi import perfect_score

    args = (
        jnp.asarray(patterns),
        jnp.asarray(rows),
        jnp.arange(H, dtype=jnp.int32),
        jnp.asarray(win_start),
        jnp.asarray(w_len),
        jnp.asarray(hvalid),
        jnp.int32(oracle.scale_k(int(m * 0.4))),
        iv_a,
        iv_b,
        jnp.float32(perfect_score(group.pad_region[1] - group.pad_region[0])),
        jnp.float32(0.2),
        jnp.float32(0.1),
    )
    got = np.asarray(comp.barcode_rank(*args, m=m, W=W))
    want = np.asarray(comp.barcode_rank_reference(*args, m=m, W=W))
    # Compare semantically meaningful lanes: all columns where hvalid;
    # reference holds masked-traceback init values elsewhere.
    assert np.array_equal(got[hvalid], want[hvalid])

    # flank_trace vs reference on the group flank
    flank = np.asarray(group.flank_masks, dtype=np.uint8)
    fm = len(flank)
    Wf = fm + 30
    frows = np.zeros((H, 512), dtype=np.uint8)
    fstart = rng.integers(0, 512 - Wf, H).astype(np.int32)
    fend = rng.integers(fm - 4, Wf + 1, H).astype(np.int32)
    for h in range(H):
        content = rand_masks(rng, int(fend[h]))
        pos = int(rng.integers(0, max(1, int(fend[h]) - fm)))
        content[pos : pos + fm] = flank[: min(fm, int(fend[h]) - pos)]
        frows[h, fstart[h] : fstart[h] + fend[h]] = content
    ledge = rng.integers(0, 2, H).astype(bool)
    rpos = np.where(rng.integers(0, 2, H).astype(bool), fend, -1).astype(np.int32)
    fargs = (
        jnp.asarray(flank),
        jnp.asarray(frows),
        jnp.arange(H, dtype=jnp.int32),
        jnp.asarray(fstart),
        jnp.asarray(ledge),
        jnp.asarray(rpos),
        jnp.asarray(fend),
        jnp.asarray(hvalid),
        jnp.int32(group.bar_region[0]),
        jnp.int32(group.bar_region[1]),
        jnp.int32(oracle.scale_alpha(0.4)),
    )
    gt = np.asarray(comp.flank_trace(*fargs, m=fm, W=Wf))
    wt = np.asarray(comp.flank_trace_reference(*fargs, m=fm, W=Wf))
    assert np.array_equal(gt[hvalid], wt[hvalid])


def test_engine_pallas_split_rank_matches_oracle():
    """A batch big enough that H_cap hits the strand-split rank layout
    (H_cap % 256 == 0) must still be row-identical to the scalar
    engine (Triton kernels in the Pallas interpreter on CPU)."""
    rng = random.Random(13)
    groups = BarcodeGroup.from_kit("SQK-RBK110-96")
    for g in groups:
        g.barcodes = g.barcodes[:6]
        g.patterns_fwd = g.patterns_fwd[:6]
        g.patterns_rc = g.patterns_rc[:6]
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    scalar = Demuxer(alpha=0.4)
    for g in groups:
        scalar.add_query_group(g)
    engine = JaxDemuxEngine(groups, alpha=0.4, kernels=INTERPRET,
                            devices=jax.devices()[:1])

    reads = []
    for i in range(80):  # R_total_pad = 128 + 128 -> split-eligible
        body = _random_read(rng, 80)
        bc = i % 6
        if i % 3 == 0:
            seq = _construct(bc) + body
        elif i % 3 == 1:
            seq = dna.reverse_complement_bytes(_construct(bc) + body)
        else:
            seq = body  # no construct
        reads.append((f"s{i}", seq))

    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]
    got = engine.demux_batch(ids, seqs)
    for rid, seq, rows in zip(ids, seqs, got):
        want = scalar.demux(rid, seq)
        assert rows == want, f"{rid}: {rows} != {want}"


def test_meta_wire_roundtrip():
    """pack_meta_np/_unpack_meta must be exact inverses over the full
    documented field ranges (14-bit row coords, 32-bit off/n/fsimple,
    16-bit baserow, 15-bit nchunks), including the -1 sentinels."""
    import jax

    from barbell_tpu.ops import composite as comp

    rng = np.random.default_rng(7)
    R = 513
    meta = np.zeros((R, comp.META_COLS), dtype=np.int32)
    meta[:, comp.M_TSC] = rng.integers(0, 1 << 14, R)
    meta[:, comp.M_TEC] = rng.integers(0, 1 << 14, R)
    meta[:, comp.M_TSTART] = rng.integers(0, 2, R)
    meta[:, comp.M_TEND] = rng.integers(0, 2, R)
    meta[:, comp.M_LO] = rng.integers(0, 1 << 14, R)
    meta[:, comp.M_HI] = rng.integers(-1, (1 << 14) - 1, R)
    meta[:, comp.M_OFF] = rng.integers(0, 2**31 - 1, R)
    meta[:, comp.M_N] = rng.integers(0, 2**31 - 1, R)
    meta[:, comp.M_ISRC] = rng.integers(0, 2, R)
    meta[:, comp.M_FSIMPLE] = rng.integers(-1, 1 << 17, R)
    meta[:, comp.M_BASEROW] = rng.integers(0, 1 << 16, R)
    meta[:, comp.M_NCHUNKS] = rng.integers(0, 1 << 15, R)
    meta[:, comp.M_ENDS] = rng.integers(0, 2, R)
    # boundary rows: all-zero, all-max, the M_HI=-1 init row
    meta[0] = 0
    meta[1] = ((1 << 14) - 1, (1 << 14) - 1, 1, 1, (1 << 14) - 1,
               (1 << 14) - 2, 2**31 - 1, 2**31 - 1, 1, 2**31 - 1,
               (1 << 16) - 1, (1 << 15) - 1, 1)
    meta[2] = 0
    meta[2, comp.M_HI] = -1
    meta[2, comp.M_FSIMPLE] = -1

    wire = comp.pack_meta_np(meta)
    assert wire.shape == (R, comp.META_WIRE_COLS)
    back = np.asarray(
        jax.jit(lambda w: comp._unpack_meta(w, with_ends=True))(wire)
    )
    assert np.array_equal(back, meta)
    # the default (full-scan) unpack omits the ends column and must
    # keep the traced HLO of pre-ends executables
    back12 = np.asarray(jax.jit(comp._unpack_meta)(wire))
    assert np.array_equal(back12, meta[:, : comp.M_ENDS])

    # out-of-range coordinates must refuse to pack, not corrupt
    # (ValueError, not assert: asserts vanish under python -O)
    bad = meta.copy()
    bad[5, comp.M_TEC] = 1 << 14
    with pytest.raises(ValueError):
        comp.pack_meta_np(bad)
    bad = meta.copy()
    bad[5, comp.M_BASEROW] = 1 << 16
    with pytest.raises(ValueError):
        comp.pack_meta_np(bad)
    bad = meta.copy()
    bad[5, comp.M_NCHUNKS] = 1 << 15
    with pytest.raises(ValueError):
        comp.pack_meta_np(bad)


def test_rec_wire_roundtrip():
    """Device-side 6-lane hit-record packing inverts exactly through
    unpack_rec_np for every field at its width boundary."""
    from barbell_tpu.ops import composite as comp
    from barbell_tpu.ops.composite import UNIT

    L, R, k_units, P, plen, Wb = 8192, 3072, 12, 96, 29, 45
    wbits = comp.rec_wire_spec(L, R, k_units, P, plen, Wb)
    assert wbits is not None
    rng = np.random.default_rng(7)
    cap = 64
    rec = np.zeros((cap, comp.REC_COLS), dtype=np.int32)
    rec[:, comp.REC_ROW] = rng.integers(0, R, cap)
    rec[:, comp.REC_COL] = rng.integers(0, L + 2, cap)
    rec[:, comp.REC_COST] = rng.integers(0, k_units * UNIT + 1, cap)
    rec[:, comp.REC_HAS] = rng.integers(0, 2, cap)
    rec[:, comp.REC_BSTART] = rng.integers(-(2**31), 2**31 - 1, cap)
    rec[:, comp.REC_FSTEXT] = rng.integers(-(2**31), 2**31 - 1, cap)
    rec[:, comp.REC_TOP] = rng.integers(0, 2 * P, cap)
    rec[:, comp.REC_ACC] = rng.integers(0, 2, cap)
    rec[:, comp.REC_HASIV] = rng.integers(0, 2, cap)
    hasiv = rec[:, comp.REC_HASIV] != 0
    for c in (comp.REC_IVPJ, comp.REC_IVEJ, comp.REC_IVPI, comp.REC_IVEI):
        rec[:, c] = np.where(hasiv, rng.integers(0, Wb + 2, cap), 0)
    rec[:, comp.REC_IVCOST] = np.where(
        hasiv, rng.integers(0, plen * UNIT + 1, cap), 0
    )
    # boundary rows: all-max, all-zero
    rec[0, comp.REC_ROW] = R - 1
    rec[0, comp.REC_COL] = L + 1
    rec[0, comp.REC_COST] = k_units * UNIT
    rec[0, comp.REC_TOP] = 2 * P - 1
    rec[0, comp.REC_HAS] = rec[0, comp.REC_ACC] = rec[0, comp.REC_HASIV] = 1
    rec[0, comp.REC_IVPJ :] = 0
    rec[0, comp.REC_IVPJ] = rec[0, comp.REC_IVEJ] = Wb + 1
    rec[0, comp.REC_IVPI] = rec[0, comp.REC_IVEI] = Wb + 1
    rec[0, comp.REC_IVCOST] = plen * UNIT
    rec[0, comp.REC_HASIV] = 1
    rec[1] = 0

    # pack with the same lane formulas demux_call uses on device
    u = rec.astype(np.int64)
    wire = np.stack(
        [
            u[:, comp.REC_ROW] | (u[:, comp.REC_COL] << 17),
            u[:, comp.REC_TOP]
            | (u[:, comp.REC_HAS] << 8)
            | (u[:, comp.REC_ACC] << 9)
            | (u[:, comp.REC_COST] << 10),
            u[:, comp.REC_BSTART],
            u[:, comp.REC_FSTEXT],
            u[:, comp.REC_IVPJ]
            | (u[:, comp.REC_IVEJ] << wbits)
            | (u[:, comp.REC_IVPI] << (2 * wbits))
            | (u[:, comp.REC_HASIV] << (3 * wbits)),
            u[:, comp.REC_IVEI] | (u[:, comp.REC_IVCOST] << wbits),
        ],
        axis=1,
    ).astype(np.int32)
    back = comp.unpack_rec_np(wire.reshape(-1), cap, wbits)
    assert np.array_equal(back, rec)


def test_engine_mono_upload_matches_separate_uploads():
    """mono_upload (one fused uint8 blob per batch) is row-identical to
    the separate-uploads path, including the IUPAC exception list and
    chunked long reads riding the same blob."""
    rng = random.Random(9)
    scalar, engine = _engine_pair(n_bars=8)
    reads = []
    for i in range(8):
        bc = rng.randrange(8)
        body = _random_read(rng, 2400 if i == 5 else rng.randrange(150, 400))
        seq = _construct(bc) + body
        if i == 2:
            seq = seq[:40] + b"N" + seq[41:]  # exception-list byte
        if i == 4:
            seq = dna.reverse_complement_bytes(seq)
        reads.append((f"m{i}", seq))
    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]

    engine.mono_upload = True
    got_mono = engine.demux_batch(ids, seqs)
    engine.mono_upload = False
    got_multi = engine.demux_batch(ids, seqs)
    assert got_mono == got_multi
    for rid, seq, rows in zip(ids, seqs, got_mono):
        assert rows == scalar.demux(rid, seq), rid


def test_mantissa_bucket_properties():
    from barbell_tpu.models.pipeline import _mantissa_bucket

    for x in list(range(1, 300)) + [1000, 131072, 131073, 1237000, 2**20]:
        b = _mantissa_bucket(x, 8)
        assert b >= x
        assert b == 8 or b <= -(-x * 9) // 8  # waste bounded at 12.5%
        if x > 8:
            e = (x - 1).bit_length() - 4
            if e > 0:
                assert b % (1 << e) == 0  # alignment (t_pad needs %128)


@pytest.mark.parametrize(
    "profile,want",
    [
        ("600-4000", 4096),  # every read whole: fewest padded rows
        ("600-4000+long", 4096),  # 9-21 kb reads chunk at 4096
        ("300-1000", 1024),
        # one 4.2 kb read: chunking it at 1024 pushes the pow2 row bucket
        # from 2048 to 4096 host rows, and the rank's per-row cost
        # outweighs the wider rows' flank cells
        ("300-1000+one", 8192),
    ],
)
def test_choose_L_weighs_rank_lanes_over_row_width(profile, want):
    _, engine = _engine_pair()
    rng = np.random.default_rng(0)
    short = profile.startswith("300")
    lens = rng.integers(300, 1000, 2048) if short else rng.integers(700, 4088, 2048)
    if profile.endswith("+long"):
        lens[:8] = rng.integers(9000, 21000, 8)
    if profile.endswith("+one"):
        lens[0] = 4200
    assert engine._choose_L(lens) == want


def test_engine_fine_row_buckets_row_identical():
    """fine_rows (1/8-octave row buckets; env BARBELL_FINE_ROWS or the
    per-engine flag) must not change any result — only padded shapes."""
    rng = random.Random(13)
    scalar, engine = _engine_pair(n_bars=8)
    ids, seqs = [], []
    for i in range(20):  # R_host 20: pow2 pads to 32, mantissa to 20
        bc = rng.randrange(8)
        seq = _construct(bc) + _random_read(rng, rng.randrange(150, 400))
        ids.append(f"f{i}")
        seqs.append(seq)
    got = engine.demux_batch(ids, seqs)
    engine.fine_rows = True
    got_fine = engine.demux_batch(ids, seqs)
    assert got_fine == got
    for rid, seq, rows in zip(ids, seqs, got):
        assert rows == scalar.demux(rid, seq), rid


def test_engine_mono_upload_nibble_fallback(monkeypatch):
    """mono upload with the nibble pack fallback (BARBELL_PACK_MODE=0)
    stays row-identical — the blob carries 2-D nibble rows instead of
    the concatenated byte stream."""
    monkeypatch.setenv("BARBELL_PACK_MODE", "0")
    rng = random.Random(21)
    scalar, engine = _engine_pair(n_bars=8)
    assert engine.mono_upload
    ids, seqs = [], []
    for i in range(6):
        bc = rng.randrange(8)
        seq = _construct(bc) + _random_read(rng, rng.randrange(150, 400))
        ids.append(f"n{i}")
        seqs.append(seq)
    got = engine.demux_batch(ids, seqs)
    for rid, seq, rows in zip(ids, seqs, got):
        assert rows == scalar.demux(rid, seq), rid
