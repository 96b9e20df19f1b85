"""Ends-only fast path (SURVEY §5.7) + derived-meta wire mode.

The contract under test: for reads whose hits all lie within the end
windows (every kit-construct read — constructs sit at read ends), the
ends-mode engine is ROW-IDENTICAL to the full-scan engine; mid-read
hits (positionally rejected by the kit presets anyway) are the one
documented difference (they are simply not scanned).  The derived-meta
('desc') wire mode and the 64-byte cat alignment must be row-identical
to the classic wire layout in every mode.
"""

import os
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from barbell_tpu.models import hittable
from barbell_tpu.models.barcodes import BarcodeGroup
from barbell_tpu.models.pipeline import JaxDemuxEngine
from barbell_tpu.ops.edit_model import get_edit_cut_off
from barbell_tpu.ops.kernels import INTERPRET, XLA
from barbell_tpu.sim.simulate import (
    default_barcodes,
    mutate_sequence,
    rapid_adapter,
    random_sequence,
)
from barbell_tpu.utils import dna


def _groups(kit="SQK-RBK114-96", extended=False):
    groups = BarcodeGroup.from_kit(kit, extended)
    for g in groups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def _rbk_reads(n, seed=0, lo=300, hi=3500, n_junk=2):
    """Construct-at-start reads, ~50% rc-sequenced, a couple of junk
    reads, plus N/IUPAC bytes near one end."""
    rng = random.Random(seed)
    bcs = default_barcodes(96)
    ids, seqs = [], []
    for i in range(n):
        label, bseq = bcs[rng.randrange(96)]
        body = bytes(random_sequence(rng, rng.randrange(lo, hi)))
        seq = rapid_adapter(bseq) + body
        if rng.random() < 0.5:
            seq = dna.reverse_complement_bytes(seq)
        seq = mutate_sequence(rng, seq, 0, 6)
        ids.append(f"r{i}")
        seqs.append(seq)
    for j in range(n_junk):
        ids.append(f"junk{j}")
        seqs.append(bytes(random_sequence(rng, rng.randrange(lo, hi))))
    if seqs[0]:
        seqs[0] = seqs[0][:5] + b"N" + seqs[0][6:]
    ids.append("empty")
    seqs.append(b"")
    ids.append("tiny")
    seqs.append(b"ACGTACGT")
    return ids, seqs


def _nbd_reads(n, seed=0):
    from barbell_tpu.kits.database import NB_1ST_FRONT, NB_1ST_REAR, NB_SEQS

    rng = random.Random(seed)
    ids, seqs = [], []
    for i in range(n):
        bc = rng.randrange(96)
        construct = (NB_1ST_FRONT + NB_SEQS[bc] + NB_1ST_REAR).encode()
        body = bytes(random_sequence(rng, rng.randrange(400, 3000)))
        seq = construct + body + dna.reverse_complement_bytes(construct)
        if rng.random() < 0.5:
            seq = dna.reverse_complement_bytes(seq)
        seqs.append(mutate_sequence(rng, seq, 0, 6))
        ids.append(f"n{i}")
    return ids, seqs


def _assert_tables_equal(a, b):
    assert a.read_ids == b.read_ids
    assert np.array_equal(a.read_lens, b.read_lens)
    for c in hittable.COLUMNS:
        assert np.array_equal(a.cols[c], b.cols[c]), c


CPU1 = None


def _cpu1():
    return jax.devices()[:1]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ends_matches_full_scan_rbk(use_kernels):
    """Ends rows == full scan, on the jnp twins and on the Triton
    kernels (Pallas interpreter)."""
    kernels = INTERPRET if use_kernels else XLA
    groups = _groups()
    ids, seqs = _rbk_reads(20, seed=1)
    full = JaxDemuxEngine(groups, devices=_cpu1(), kernels=kernels)
    ends = JaxDemuxEngine(
        groups, devices=_cpu1(), kernels=kernels, ends_window=1024
    )
    tf = full.demux_batch_table(ids, seqs)
    te = ends.demux_batch_table(ids, seqs)
    _assert_tables_equal(tf, te)
    # the batch really exercised ends rows
    assert max(len(s) for s in seqs) > 2048


def test_ends_matches_full_scan_nbd_dual_end():
    groups = _groups("SQK-NBD114-96")
    ids, seqs = _nbd_reads(16, seed=2)
    full = JaxDemuxEngine(groups, devices=_cpu1())
    ends = JaxDemuxEngine(groups, devices=_cpu1(), ends_window=512)
    _assert_tables_equal(
        full.demux_batch_table(ids, seqs), ends.demux_batch_table(ids, seqs)
    )


def test_ends_sharded_matches_single_device():
    groups = _groups()
    ids, seqs = _rbk_reads(24, seed=3)
    single = JaxDemuxEngine(groups, devices=_cpu1(), ends_window=1024)
    sharded = JaxDemuxEngine(groups, devices=jax.devices(), ends_window=1024)
    t1 = single.demux_batch_table(ids, seqs)
    t2 = sharded.demux_batch_table(ids, seqs)
    assert sharded.last_dispatch == "sharded"
    _assert_tables_equal(t1, t2)


def test_ends_wire_meta_mode_matches_desc():
    groups = _groups()
    ids, seqs = _rbk_reads(12, seed=4)
    desc = JaxDemuxEngine(
        groups, devices=_cpu1(), ends_window=1024, meta_mode="desc"
    )
    wire = JaxDemuxEngine(
        groups, devices=_cpu1(), ends_window=1024, meta_mode="wire"
    )
    _assert_tables_equal(
        desc.demux_batch_table(ids, seqs), wire.demux_batch_table(ids, seqs)
    )


def test_full_scan_desc_matches_wire():
    """The derived-meta wire diet is row-identical in full-scan mode,
    including long-read chunk rows (tag-3 table path)."""
    groups = _groups()
    ids, seqs = _rbk_reads(10, seed=5, lo=500, hi=9000)  # forces chunking
    desc = JaxDemuxEngine(groups, devices=_cpu1(), meta_mode="desc")
    wire = JaxDemuxEngine(groups, devices=_cpu1(), meta_mode="wire")
    _assert_tables_equal(
        desc.demux_batch_table(ids, seqs), wire.demux_batch_table(ids, seqs)
    )


def test_cat_align_variants_match():
    groups = _groups()
    ids, seqs = _rbk_reads(12, seed=6)
    tables = [
        JaxDemuxEngine(
            groups, devices=_cpu1(), ends_window=1024, cat_align=a
        ).demux_batch_table(ids, seqs)
        for a in (16, 32, 64, 128)
    ]
    for t in tables[1:]:
        _assert_tables_equal(tables[0], t)


def test_ends_nibble_fallback_matches():
    """BARBELL_PACK_MODE=0 (nibble rows, wire meta) with ends rows."""
    groups = _groups()
    ids, seqs = _rbk_reads(8, seed=7)
    os.environ["BARBELL_PACK_MODE"] = "0"
    try:
        nib = JaxDemuxEngine(groups, devices=_cpu1(), ends_window=1024)
        t_nib = nib.demux_batch_table(ids, seqs)
    finally:
        del os.environ["BARBELL_PACK_MODE"]
    full = JaxDemuxEngine(groups, devices=_cpu1())
    _assert_tables_equal(full.demux_batch_table(ids, seqs), t_nib)


def test_ends_drops_mid_read_hits_only():
    """Documented deviation: a mid-read construct is not scanned in
    ends mode; end-region hits of the same batch are untouched."""
    rng = random.Random(8)
    groups = _groups()
    label, bseq = default_barcodes(96)[7]
    mid = (
        bytes(random_sequence(rng, 1500))
        + rapid_adapter(bseq)
        + bytes(random_sequence(rng, 1500))
    )
    endr = rapid_adapter(bseq) + bytes(random_sequence(rng, 2500))
    full = JaxDemuxEngine(groups, devices=_cpu1())
    ends = JaxDemuxEngine(groups, devices=_cpu1(), ends_window=1024)
    tf = full.demux_batch_table(["m", "e"], [mid, endr])
    te = ends.demux_batch_table(["m", "e"], [mid, endr])
    assert 0 in tf.cols["reads"] and 0 not in te.cols["reads"]
    f1 = {c: tf.cols[c][tf.cols["reads"] == 1] for c in hittable.COLUMNS}
    e1 = {c: te.cols[c][te.cols["reads"] == 1] for c in hittable.COLUMNS}
    for c in hittable.COLUMNS:
        assert np.array_equal(f1[c], e1[c]), c


def test_ends_boundary_lengths():
    """Reads straddling n == L (the simple/pair cut) and the
    full-coverage ceiling 2W-halo-PADDING-1."""
    groups = _groups()
    W = 1024
    rng = random.Random(9)
    label, bseq = default_barcodes(96)[3]
    ids, seqs = [], []
    for i, n_body in enumerate([1016, 1024, 1025, 1032, 1900, 4000, 900]):
        seq = rapid_adapter(bseq) + bytes(random_sequence(rng, n_body))
        # trim/extend to hit exact total lengths around L = pow2(W)
        seqs.append(seq[: n_body + 8])
        ids.append(f"b{i}")
    full = JaxDemuxEngine(groups, devices=_cpu1())
    ends = JaxDemuxEngine(groups, devices=_cpu1(), ends_window=W)
    _assert_tables_equal(
        full.demux_batch_table(ids, seqs), ends.demux_batch_table(ids, seqs)
    )


def test_ends_overlapping_pair_full_coverage():
    """Reads in (L, 2W-halo-PADDING-1]: the prefix/suffix windows
    OVERLAP mid-read and their claim ranges tile exactly, so the
    ends-mode engine is row-identical to the full scan EVEN FOR
    mid-read constructs (no skipped middle) — the round-4 L=pow2(W)
    redesign's correctness gate.  Constructs are planted across the
    whole length incl. the claim boundary region around W-PADDING,
    both strands."""
    groups = _groups()
    W = 1024  # coverage ceiling 2W-halo-PADDING-1 = 1908 for RBK
    rng = random.Random(10)
    bcs = default_barcodes(96)
    ids, seqs = [], []
    i = 0
    for n_total in (1100, 1300, 1500, 1652, 1700, 1750):
        for frac in (0.0, 0.3, 0.5, 0.62, 0.8):
            label, bseq = bcs[rng.randrange(96)]
            ad = rapid_adapter(bseq)
            pos = int((n_total - len(ad)) * frac)
            body_l = bytes(random_sequence(rng, pos))
            body_r = bytes(random_sequence(rng, n_total - len(ad) - pos))
            seq = body_l + ad + body_r
            if rng.random() < 0.5:
                seq = dna.reverse_complement_bytes(seq)
            seq = mutate_sequence(rng, seq, 0, 4)
            ids.append(f"c{i}")
            seqs.append(seq)
            i += 1
    full = JaxDemuxEngine(groups, devices=_cpu1())
    ends = JaxDemuxEngine(groups, devices=_cpu1(), ends_window=W)
    tf = full.demux_batch_table(ids, seqs)
    te = ends.demux_batch_table(ids, seqs)
    _assert_tables_equal(tf, te)
    # the planted mid constructs really produced rows
    assert tf.n_rows >= len(ids) // 2


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ends_asymmetric_matches_full_scan(use_kernels):
    """Per-side windows (W_l != W_r): end-construct reads are
    row-identical to the full scan (round-5 wire cut — only the left
    side needs the `@prev_left` chain depth)."""
    kernels = INTERPRET if use_kernels else XLA
    groups = _groups()
    ids, seqs = _rbk_reads(20, seed=21)
    full = JaxDemuxEngine(groups, devices=_cpu1(), kernels=kernels)
    ends = JaxDemuxEngine(
        groups, devices=_cpu1(), kernels=kernels,
        ends_window=(1024, 512),
    )
    _assert_tables_equal(
        full.demux_batch_table(ids, seqs), ends.demux_batch_table(ids, seqs)
    )


def test_ends_asymmetric_desc_matches_wire():
    groups = _groups()
    ids, seqs = _rbk_reads(12, seed=22)
    desc = JaxDemuxEngine(
        groups, devices=_cpu1(), ends_window=(1024, 512), meta_mode="desc"
    )
    wire = JaxDemuxEngine(
        groups, devices=_cpu1(), ends_window=(1024, 512), meta_mode="wire"
    )
    _assert_tables_equal(
        desc.demux_batch_table(ids, seqs), wire.demux_batch_table(ids, seqs)
    )


def test_ends_asymmetric_sharded_matches_single():
    groups = _groups()
    ids, seqs = _rbk_reads(24, seed=23)
    single = JaxDemuxEngine(groups, devices=_cpu1(), ends_window=(1024, 512))
    sharded = JaxDemuxEngine(
        groups, devices=jax.devices(), ends_window=(1024, 512)
    )
    t1 = single.demux_batch_table(ids, seqs)
    t2 = sharded.demux_batch_table(ids, seqs)
    assert sharded.last_dispatch == "sharded"
    _assert_tables_equal(t1, t2)


def test_ends_asymmetric_overlap_full_coverage():
    """Asymmetric windows in the overlap regime (L < n <=
    W_l+W_r-halo-PADDING-1): claims tile exactly, so even mid-read
    constructs are row-identical to the full scan."""
    groups = _groups()
    W = (1024, 512)  # coverage ceiling 1536-halo-PADDING-1 = 1402 for RBK
    rng = random.Random(24)
    bcs = default_barcodes(96)
    ids, seqs = [], []
    i = 0
    for n_total in (1100, 1200, 1300, 1390):
        for frac in (0.0, 0.3, 0.5, 0.66, 0.85):
            label, bseq = bcs[rng.randrange(96)]
            ad = rapid_adapter(bseq)
            pos = int((n_total - len(ad)) * frac)
            body_l = bytes(random_sequence(rng, pos))
            body_r = bytes(random_sequence(rng, n_total - len(ad) - pos))
            seq = body_l + ad + body_r
            if rng.random() < 0.5:
                seq = dna.reverse_complement_bytes(seq)
            ids.append(f"a{i}")
            seqs.append(mutate_sequence(rng, seq, 0, 4))
            i += 1
    full = JaxDemuxEngine(groups, devices=_cpu1())
    ends = JaxDemuxEngine(groups, devices=_cpu1(), ends_window=W)
    tf = full.demux_batch_table(ids, seqs)
    te = ends.demux_batch_table(ids, seqs)
    _assert_tables_equal(tf, te)
    assert tf.n_rows >= len(ids) // 2


def test_claim_boundary_exact():
    """Adversarial pin of the claim edges (VERDICT r04 #7): constructs
    planted so their flank coordinates cross each claim boundary by a
    few bases, on BOTH strands at BOTH read ends.  A full-scan row must
    appear in ends mode iff its strand's claim covers it:

      fw row:  ref <= W-1-PADDING  or  ref >= n-W+halo+1
      rc row:  rsf <= W-halo-1     or  rsf >= n-W+PADDING+1

    (fw claims are valley-END based, rc claims flank-START based — the
    rc twin rows scan the flipped window, which is why the window
    derivation needs the halo term; see stages/kit._round_w)."""
    from barbell_tpu import PADDING

    rng = random.Random(30)
    groups = _groups()
    W = 512
    full = JaxDemuxEngine(groups, devices=_cpu1())
    ends = JaxDemuxEngine(groups, devices=_cpu1(), ends_window=W)
    halo = ends.halo
    label, bseq = default_barcodes(96)[11]
    ad = rapid_adapter(bseq)

    ids, seqs = [], []
    n_total = 3600  # > coverage ceiling: middle unscanned, claims bind
    i = 0
    for side in ("left", "right"):
        for strand_rc in (False, True):
            # sweep the construct start across the relevant boundary
            for p in range(330, 480, 10):
                a = ad if not strand_rc else dna.reverse_complement_bytes(ad)
                pos = p if side == "left" else n_total - p - len(a)
                seq = (
                    bytes(random_sequence(rng, pos))
                    + a
                    + bytes(random_sequence(rng, n_total - pos - len(a)))
                )
                ids.append(f"b{i}")
                seqs.append(seq)
                i += 1
    tf = full.demux_batch_table(ids, seqs)
    te = ends.demux_batch_table(ids, seqs)

    n_present = n_absent = 0
    for r in range(len(ids)):
        n = int(tf.read_lens[r])
        fsel = tf.cols["reads"] == r
        esel = te.cols["reads"] == r
        erows = {
            tuple(int(te.cols[c][j]) for c in hittable.COLUMNS)
            for j in np.nonzero(esel)[0]
        }
        for j in np.nonzero(fsel)[0]:
            row = tuple(int(tf.cols[c][j]) for c in hittable.COLUMNS)
            ref_ = int(tf.cols["ref"][j])
            rsf = int(tf.cols["rsf"][j])
            if int(tf.cols["strand"][j]) == 0:
                want = ref_ <= W - 1 - PADDING or ref_ >= n - W + halo + 1
            else:
                want = rsf <= W - halo - 1 or rsf >= n - W + PADDING + 1
            assert (row in erows) == want, (r, row, want)
            n_present += want
            n_absent += not want
        # ends mode must not invent rows
        frows = {
            tuple(int(tf.cols[c][j]) for c in hittable.COLUMNS)
            for j in np.nonzero(fsel)[0]
        }
        assert erows <= frows, r
    # the sweep really crossed the boundaries in both directions
    assert n_present >= 10 and n_absent >= 10, (n_present, n_absent)


def test_ends_window_validation():
    groups = _groups()
    with pytest.raises(ValueError):
        JaxDemuxEngine(groups, devices=_cpu1(), ends_window=8)
    with pytest.raises(ValueError):
        # one W window must fit a row
        JaxDemuxEngine(groups, devices=_cpu1(), ends_window=16384)
    with pytest.raises(ValueError):
        JaxDemuxEngine(groups, devices=_cpu1(), cat_align=48)
    with pytest.raises(ValueError):
        # both sides must be set together
        JaxDemuxEngine(groups, devices=_cpu1(), ends_window=(1024, 0))
    with pytest.raises(ValueError):
        JaxDemuxEngine(groups, devices=_cpu1(), ends_window=(1024, 8))
    with pytest.raises(ValueError):
        JaxDemuxEngine(groups, devices=_cpu1(), meta_mode="bogus")


def test_ends_window_for_patterns():
    from barbell_tpu.stages.kit import ends_window_for_patterns
    from barbell_tpu.stages.pattern import pattern_from_str

    groups = _groups()  # RBK: flank 90, k 20 -> ext 110, halo 123
    p1 = [pattern_from_str("Ftag[fw, *, @left(0..250), >>]")]
    w1 = ends_window_for_patterns(p1, groups)
    assert w1 == 512  # 250+110+123+1 = 484 -> 512

    chain = [
        pattern_from_str(
            "Ftag[fw, ?1, @left(0..250)]__Ftag[fw, ?1, @prev_left(0..250), >>]"
        )
    ]
    w2 = ends_window_for_patterns(chain, groups)
    assert w2 == 896  # 2*(250+110)+123+1 = 844 -> 896 (128-gran)

    right = [pattern_from_str("Ftag[<<, rc, *, @right(0..250)]")]
    assert ends_window_for_patterns(right, groups) == 512

    unbounded = [pattern_from_str("Ftag[fw, *]")]
    assert ends_window_for_patterns(unbounded, groups) is None

    bare_prev = [pattern_from_str("Ftag[fw, *, @prev_left(0..250)]")]
    assert ends_window_for_patterns(bare_prev, groups) is None


@pytest.mark.slow
def test_kit_ends_matches_full_scan(tmp_path):
    """The default kit run (ends-only scan) writes byte-identical stage
    files to --full-scan on end-construct reads — annotation.tsv,
    pattern_per_read.tsv, filtered.tsv AND trimmed FASTQs (the VERDICT
    r03 'done' gate for the §5.7 fast path)."""
    from barbell_tpu.sim.simulate import create_testdata
    from barbell_tpu.stages.kit import KitRunConfig, demux_using_kit

    sim_dir = tmp_path / "sim"
    create_testdata(
        8, str(sim_dir), barcodes=default_barcodes(4), rc_frac=0.5, seed=11,
        groups=("GroupII",),
    )
    blobs = {}
    for mode, full_scan in (("ends", False), ("full", True)):
        out_dir = tmp_path / mode
        demux_using_kit(
            [str(sim_dir / "GroupII.fastq")],
            KitRunConfig(
                kit_name="SQK-RBK110-96",
                output_folder=str(out_dir),
                backend="jax",
                batch_size=8,
                full_scan=full_scan,
            ),
        )
        blobs[mode] = {
            f: (out_dir / f).read_bytes()
            for f in sorted(os.listdir(out_dir))
        }
    assert sorted(blobs["ends"]) == sorted(blobs["full"])
    for name in blobs["full"]:
        assert blobs["ends"][name] == blobs["full"][name], name
    assert any(n.endswith(".trimmed.fastq") for n in blobs["full"])


def test_kit_presets_window_sizes():
    """The safe/maximize presets of both kit classes stay bounded."""
    from barbell_tpu.kits.presets import preset_patterns
    from barbell_tpu.stages.kit import ends_window_for_patterns
    from barbell_tpu.stages.pattern import pattern_from_str

    for kit, cls in (("SQK-RBK114-96", "single"), ("SQK-NBD114-96", "double")):
        groups = _groups(kit)
        for maximize in (False, True):
            pats = [
                pattern_from_str(s) for s in preset_patterns(cls, maximize)
            ]
            w = ends_window_for_patterns(pats, groups)
            assert w is not None and 256 <= w <= 2048, (kit, maximize, w)
