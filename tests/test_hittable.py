"""HitTable (columnar assembly) identity vs the object path.

The engine's row-identity vs the scalar oracle is covered by
test_engine_fuzz/test_parallel; these tests pin the NEW surfaces:
``demux_batch_table`` vs ``demux_batch`` (same engine), the TSV
serialization, and the vectorized collapse/rel-dist helpers against
their object-path definitions.
"""

import random

import numpy as np
import pytest

from barbell_tpu.models import hittable
from barbell_tpu.models.collapse import collapse_overlapping_matches
from barbell_tpu.models.demux import COLLAPSE_OVERLAP
from barbell_tpu.models.records import BarbellMatch, BarcodeType, Strand, rel_dist_to_end


def test_rel_dist_vec_matches_scalar():
    ns = np.array([0, 1, 5, 10, 11, 4000] * 9, dtype=np.int64)
    rng = random.Random(0)
    pos = np.array(
        [rng.randrange(-2, n + 2) for n in ns.tolist()], dtype=np.int64
    )
    got = hittable.rel_dist_vec(pos, ns).tolist()
    want = [rel_dist_to_end(p, n) for p, n in zip(pos.tolist(), ns.tolist())]
    assert got == want


def _mk(rid, rsf, ref_, mtype, fcost=1, bcost=1, label="RBK01"):
    return BarbellMatch(
        read_id=rid, read_len=1000, rel_dist_to_end=rel_dist_to_end(rsf, 1000),
        read_start_bar=rsf, read_end_bar=ref_, read_start_flank=rsf,
        read_end_flank=ref_, bar_start=0, bar_end=0, match_type=mtype,
        flank_cost=fcost, barcode_cost=bcost, label=label, strand=Strand.Fwd,
    )


def test_collapse_keep_indices_matches_object_collapse_fuzz():
    rng = random.Random(42)
    for trial in range(300):
        B = rng.randrange(1, 5)
        per_read = []
        for r in range(B):
            ms = []
            for _ in range(rng.randrange(0, 6)):
                s = rng.randrange(0, 200)
                e = s + rng.randrange(5, 120)
                mt = rng.choice(
                    [BarcodeType.Ftag, BarcodeType.Rtag,
                     BarcodeType.Fflank, BarcodeType.Rflank]
                )
                ms.append(
                    _mk(f"r{r}", s, e, mt, fcost=rng.randrange(0, 9),
                        bcost=rng.randrange(0, 9))
                )
            per_read.append(ms)

        # object path: per read, sort-by-start inside collapse
        want = [
            collapse_overlapping_matches(ms, COLLAPSE_OVERLAP)
            for ms in per_read
        ]

        # index path: rows pre-sorted by (read, rsf) stable
        rows = [
            (r, m) for r, ms in enumerate(per_read) for m in ms
        ]
        rows.sort(key=lambda t: (t[0], t[1].read_start_flank))
        keep = hittable.collapse_keep_indices(
            [t[0] for t in rows],
            [t[1].read_start_flank for t in rows],
            [t[1].read_end_flank for t in rows],
            [hittable.MTYPE_CODE[t[1].match_type] for t in rows],
            [t[1].flank_cost for t in rows],
            [t[1].barcode_cost for t in rows],
            COLLAPSE_OVERLAP,
        )
        got = [[] for _ in range(B)]
        for i in keep:
            got[rows[i][0]].append(rows[i][1])
        assert got == want, f"trial {trial}"

        # the vectorized fast path (singleton pre-check + loop over hot
        # reads only) must keep exactly the same rows as the full loop
        reads_a = np.array([t[0] for t in rows], dtype=np.int64)
        rsf_a = np.array([t[1].read_start_flank for t in rows], dtype=np.int64)
        ref_a = np.array([t[1].read_end_flank for t in rows], dtype=np.int64)
        hot = hittable.collapse_candidate_rows(
            reads_a, rsf_a, ref_a, COLLAPSE_OVERLAP
        )
        if hot is None:
            fast_keep = list(range(len(rows)))
        else:
            hot_idx = np.nonzero(hot)[0]
            keep_hot = hittable.collapse_keep_indices(
                reads_a[hot_idx].tolist(),
                rsf_a[hot_idx].tolist(),
                ref_a[hot_idx].tolist(),
                [hittable.MTYPE_CODE[rows[i][1].match_type] for i in hot_idx],
                [rows[i][1].flank_cost for i in hot_idx],
                [rows[i][1].barcode_cost for i in hot_idx],
                COLLAPSE_OVERLAP,
            )
            mask = np.ones(len(rows), dtype=bool)
            mask[hot_idx] = False
            mask[hot_idx[np.asarray(keep_hot, dtype=np.int64)]] = True
            fast_keep = np.nonzero(mask)[0].tolist()
        assert fast_keep == sorted(keep), f"trial {trial} fast path"


@pytest.fixture(scope="module")
def engine():
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models.pipeline import JaxDemuxEngine
    from barbell_tpu.ops.edit_model import get_edit_cut_off

    groups = BarcodeGroup.from_kit("SQK-NBD114-24", False)
    for g in groups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    import jax

    return JaxDemuxEngine(groups, devices=jax.devices()[:1])


def _nbd_reads(n, seed=0):
    from barbell_tpu.kits.database import NB_1ST_FRONT, NB_1ST_REAR, NB_SEQS
    from barbell_tpu.sim.simulate import mutate_sequence, random_sequence
    from barbell_tpu.utils import dna

    rng = random.Random(seed)
    reads = []
    for i in range(n):
        bc = rng.randrange(24)
        construct = (NB_1ST_FRONT + NB_SEQS[bc] + NB_1ST_REAR).encode()
        body = bytes(random_sequence(rng, rng.randrange(80, 700)))
        seq = construct + body + dna.reverse_complement_bytes(construct)
        if rng.random() < 0.5:
            seq = dna.reverse_complement_bytes(seq)
        reads.append((f"seq_{i}", mutate_sequence(rng, seq, 0, 6)))
    return reads


def test_table_tsv_identical_to_object_rows(engine):
    reads = _nbd_reads(48, seed=3)
    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]
    table = engine.demux_batch_table(ids, seqs)
    per_read = hittable.table_to_matches(table)

    # object path == table path (demux_batch is defined via the table,
    # so compare against the SCALAR engine for independence)
    scalar = engine._scalar_fallback()
    for rid, seq, got in zip(ids, seqs, per_read):
        want = scalar.demux(rid, seq)
        assert got == want, rid

    # TSV lines byte-identical to BarbellMatch serialization
    want_lines = [
        m.to_tsv_row() for ms in per_read for m in ms
    ]
    assert hittable.emit_tsv_lines(table) == want_lines

    # rows grouped per read, ascending
    rows_per_read = table.rows_per_read()
    assert int(rows_per_read.sum()) == table.n_rows
    assert (np.diff(table.cols["reads"]) >= 0).all()


def test_empty_batch_table(engine):
    table = engine.demux_batch_table([], [])
    assert table.n_rows == 0
    assert hittable.emit_tsv_lines(table) == []
    assert hittable.table_to_matches(table) == []


def test_concat_tables(engine):
    reads = _nbd_reads(20, seed=5)
    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]
    t1 = engine.demux_batch_table(ids[:11], seqs[:11])
    t2 = engine.demux_batch_table(ids[11:], seqs[11:])
    whole = engine.demux_batch_table(ids, seqs)
    merged = engine._concat_tables(t1, t2)
    assert hittable.emit_tsv_lines(merged) == hittable.emit_tsv_lines(whole)
