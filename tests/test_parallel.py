"""Sharded execution tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

from barbell_tpu.ops.kernels import INTERPRET

jax = pytest.importorskip("jax")


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.pos.shape[0] == args[1].shape[0]
    # every example read carries a construct -> at least one valley each
    assert bool(np.asarray(out.valid)[:, 0].all())


def test_sharded_step_matches_single_device():
    """Sharded flank step == unsharded kernels on the same inputs."""
    import jax.numpy as jnp

    from __graft_entry__ import _example_batch
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.ops import device as dev
    from barbell_tpu.ops.edit_model import get_edit_cut_off
    from barbell_tpu.ops.oracle import scale_alpha, scale_k
    from barbell_tpu.parallel.mesh import make_mesh, shard_rows, sharded_flank_step

    group = BarcodeGroup.from_kit("SQK-RBK114-24")[0]
    k = get_edit_cut_off(group.get_effective_len())
    B = 16
    rows, lens = _example_batch(B=B, L=256, seed=3)
    start = np.zeros(B, dtype=np.int32)
    lo = np.zeros(B, dtype=np.int32)

    pattern = jnp.asarray(group.flank_masks)
    k_scaled = np.int32(scale_k(k))
    alpha_scaled = np.int32(scale_alpha(0.4))

    ends = dev.flank_ends(pattern, jnp.asarray(rows), jnp.asarray(start),
                          jnp.asarray(lens), alpha_scaled)
    want = dev.find_hits(ends, jnp.asarray(lo), jnp.asarray(lens), k_scaled, 8)

    mesh = make_mesh()
    rows_s, start_s, lens_s, lo_s, hi_s = shard_rows(
        mesh, rows, start, lens, lo, lens.astype(np.int32)
    )
    step = sharded_flank_step(mesh, K=8)
    got, global_found = step(
        pattern, rows_s, start_s, lens_s, lo_s, hi_s, k_scaled, alpha_scaled
    )

    assert np.array_equal(np.asarray(got.pos), np.asarray(want.pos))
    assert np.array_equal(np.asarray(got.cost), np.asarray(want.cost))
    assert np.array_equal(np.asarray(got.valid), np.asarray(want.valid))
    assert int(global_found) == int(
        np.asarray(want.valid).any(axis=1).sum()
    )


def test_sharded_demux_step_matches_single_device():
    """The fully fused demux step sharded over the mesh must produce,
    per shard, exactly what a single-device demux_call produces on that
    shard's rows."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _example_batch
    from barbell_tpu import PADDING
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models.pipeline import _GroupPlan
    from barbell_tpu.ops import composite as comp
    from barbell_tpu.ops.edit_model import get_edit_cut_off
    from barbell_tpu.ops.oracle import scale_alpha
    from barbell_tpu.parallel.mesh import (
        make_mesh,
        shard_rows,
        sharded_demux_step,
    )

    group = BarcodeGroup.from_kit("SQK-RBK114-24")[0]
    group.set_flank_threshold(get_edit_cut_off(group.get_effective_len()))
    plan = _GroupPlan(group)

    D, per, L = 8, 2, 256
    B = D * per
    rows, lens = _example_batch(B=B, L=L, seed=4)
    R_pad = S_pad = 4
    packs, metas, sidxs = [], [], []
    for d in range(D):
        sub_rows = rows[d * per : (d + 1) * per]
        sub_lens = lens[d * per : (d + 1) * per]
        padded = np.zeros((R_pad, L), dtype=np.uint8)
        padded[:per] = sub_rows
        packs.append(comp.pack_rows_np(padded))
        meta = np.zeros((R_pad + S_pad, comp.META_COLS), dtype=np.int32)
        meta[:, comp.M_HI] = -1
        for i in range(per):
            n = int(sub_lens[i])
            meta[i] = (0, n, 1, 1, 0, n, 0, n, 0, i, 0, 1, 0)
            meta[R_pad + i] = (L - n, L, 1, 1, L - n, L, 0, n, 1, i, 0, 1, 0)
        metas.append(meta)
        sidxs.append(np.arange(S_pad, dtype=np.int32))

    gi = (int(scale_alpha(0.4)), int(plan.mask_start), int(plan.mask_end),
          int(plan.k1_scaled), int(plan.rel_bar_start),
          int(plan.rel_bar_end), L)
    gf = (float(np.float32(plan.perfect)), 0.2, 0.1)
    statics = dict(
        gi=gi, gf=gf,
        K=8, m=plan.m, k_units=plan.k_units, W_words=plan.W_words,
        top_bit=plan.top_bit, Wf=plan.span, plen=plan.plen,
        Wb=plan.barcode_window, P=plan.n_patterns, H_cap=R_pad + S_pad,
        padding=PADDING,
    )

    mesh = make_mesh()
    packed_s, meta_s, sidx_s = shard_rows(
        mesh,
        np.concatenate(packs, axis=0),
        comp.pack_meta_np(np.concatenate(metas, axis=0)),
        np.concatenate(sidxs, axis=0),
    )
    step = sharded_demux_step(mesh, **statics)
    exc_dummy = jnp.zeros((1, 2), dtype=jnp.int32)
    rs_s, exc_s = shard_rows(
        mesh, np.zeros(D * R_pad, dtype=np.int32),
        np.zeros((D, 2), dtype=np.int32),
    )
    out, global_hits = step(
        jnp.asarray(plan.flank), jnp.asarray(plan.patw),
        jnp.asarray(plan.patterns_all), packed_s, sidx_s, meta_s,
        exc_s, rs_s,
    )
    out = np.asarray(out)
    wcols = (
        comp.REC_COLS
        if comp.rec_wire_spec(
            L, R_pad + S_pad, plan.k_units, plan.n_patterns, plan.plen,
            plan.barcode_window,
        ) is None
        else comp.REC_WIRE_COLS
    )
    per_shard = (
        (R_pad + S_pad) * wcols + (R_pad + S_pad + 31) // 32 + 1
    )

    total = 0
    for d in range(D):
        want = np.asarray(
            comp.demux_call(
                jnp.asarray(plan.flank), jnp.asarray(plan.patw),
                jnp.asarray(plan.patterns_all), jnp.asarray(packs[d]),
                jnp.asarray(sidxs[d]), jnp.asarray(comp.pack_meta_np(metas[d])),
                exc_dummy,
                jnp.zeros(R_pad, dtype=jnp.int32), **statics,
            )
        )
        got = out[d * per_shard : (d + 1) * per_shard]
        assert np.array_equal(got, want), d
        total += int(want[-1])
    assert int(global_hits) == total == B


def _mk_reads(n_bars, n_reads, seed, long_at=(), iupac_at=()):
    import random

    from barbell_tpu.sim.simulate import (
        default_barcodes,
        mutate_sequence,
        rapid_adapter,
        random_sequence,
    )
    from barbell_tpu.utils import dna

    rng = random.Random(seed)
    bars = default_barcodes(n_bars)
    ids, seqs = [], []
    for i in range(n_reads):
        _label, bseq = bars[rng.randrange(n_bars)]
        n = 4000 if i in long_at else rng.randrange(250, 1200)
        seq = rapid_adapter(bseq) + bytes(random_sequence(rng, n))
        if i in iupac_at:
            seq = seq[:40] + b"NNRYK" + seq[45:]
        if rng.random() < 0.5:
            seq = dna.reverse_complement_bytes(seq)
        seq = mutate_sequence(rng, seq, 0, 5)
        ids.append(f"r{i}")
        seqs.append(seq)
    return ids, seqs


def test_engine_sharded_matches_single_device():
    """PRODUCTION engine on the 8-device mesh must emit row-identical
    BarbellMatch lists to the single-device engine — through the
    engine's own planning/packing, including chunked long reads and the
    IUPAC exception-list path."""
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models.pipeline import JaxDemuxEngine
    from barbell_tpu.ops.edit_model import get_edit_cut_off

    def groups():
        gs = BarcodeGroup.from_kit("SQK-RBK114-24")
        for g in gs:
            g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
        return gs

    ids, seqs = _mk_reads(24, 19, seed=21, long_at=(4, 11), iupac_at=(2, 4))

    e8 = JaxDemuxEngine(groups(), max_row_len=2048)
    e1 = JaxDemuxEngine(groups(), max_row_len=2048, devices=jax.devices()[:1])
    assert e8.mesh is not None and e1.mesh is None
    out8 = e8.demux_batch(ids, seqs)
    assert e8.last_dispatch == "sharded"
    out1 = e1.demux_batch(ids, seqs)
    assert e1.last_dispatch == "single"
    assert out8 == out1


def test_engine_sharded_nibble_fallback_matches():
    """A shard overflowing the exception cap forces every shard to the
    nibble pack mode; results must not change."""
    from barbell_tpu.models import pipeline as pl
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models.pipeline import JaxDemuxEngine
    from barbell_tpu.ops.edit_model import get_edit_cut_off

    def groups():
        gs = BarcodeGroup.from_kit("SQK-RBK114-24")
        for g in gs:
            g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
        return gs

    ids, seqs = _mk_reads(24, 9, seed=5)
    # one read with more Ns than _EXC_CAP on its shard forces nibbles
    seqs[3] = seqs[3][:100] + b"N" * (pl._EXC_CAP + 8) + seqs[3][100:]

    e8 = JaxDemuxEngine(groups())
    e1 = JaxDemuxEngine(groups(), devices=jax.devices()[:1])
    assert e8.demux_batch(ids, seqs) == e1.demux_batch(ids, seqs)


def test_engine_sharded_pallas_matches_single_device():
    """Mesh + Triton kernels (Pallas interpreter on CPU): the sharded
    engine must stay row-identical with the kernel path enabled — the
    production configuration of a multi-GPU host.  Tiny shapes:
    interpreted kernels run per shard."""
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models.pipeline import JaxDemuxEngine
    from barbell_tpu.ops.edit_model import get_edit_cut_off

    def groups():
        gs = BarcodeGroup.from_kit("SQK-RBK114-24")
        for g in gs:
            g.barcodes = g.barcodes[:4]
            g.patterns_fwd = g.patterns_fwd[:4]
            g.patterns_rc = g.patterns_rc[:4]
            g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
        return gs

    ids, seqs = _mk_reads(4, 8, seed=31)
    seqs = [s[:300] for s in seqs]

    e8 = JaxDemuxEngine(groups(), max_row_len=512, kernels=INTERPRET)
    e1 = JaxDemuxEngine(
        groups(), max_row_len=512, kernels=INTERPRET,
        devices=jax.devices()[:1],
    )
    out8 = e8.demux_batch(ids, seqs)
    assert e8.last_dispatch == "sharded"
    assert out8 == e1.demux_batch(ids, seqs)


def test_engine_sharded_fused_multi_group():
    """Multi-group kits on the mesh take ONE shard_map'd fused call per
    batch (sharded-fused) and stay row-identical to the single-device
    fused path — including the overflow-retry path (hit-dense reads
    overflow the initial per-shard lane capacity)."""
    import random

    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models.pipeline import JaxDemuxEngine
    from barbell_tpu.ops.edit_model import get_edit_cut_off

    def groups():
        gs = BarcodeGroup.from_kit("SQK-RBK114-96", use_extended=True)
        assert len(gs) >= 2
        for g in gs:
            g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
        return gs

    ids, seqs = _mk_reads(96, 17, seed=77, long_at=(2,), iupac_at=(5,))
    # hit-dense reads on several shards: many constructs per read so the
    # initial H_cap overflows and the sticky retry fires on the fused
    # sharded path
    from barbell_tpu.sim.simulate import default_barcodes, rapid_adapter

    rng = random.Random(9)
    gs = groups()
    bars = default_barcodes(96)
    for j in (0, 1, 8, 9, 10):
        parts = []
        for _ in range(12):
            _lab, bseq = bars[rng.randrange(96)]
            parts.append(
                rapid_adapter(bseq)
                + bytes(rng.choice(b"ACGT") for _ in range(40))
            )
        seqs[j] = b"".join(parts)

    e8 = JaxDemuxEngine(gs, max_row_len=2048)
    e1 = JaxDemuxEngine(groups(), max_row_len=2048, devices=jax.devices()[:1])
    out8 = e8.demux_batch(ids, seqs)
    assert e8.last_dispatch == "sharded-fused"
    assert e8._h_cap_hint > 0  # the overflow retry actually fired
    out1 = e1.demux_batch(ids, seqs)
    assert e1.last_dispatch == "single-fused"
    assert out8 == out1
