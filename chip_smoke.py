#!/usr/bin/env python3
"""On-card smoke check: the demux engine and the kit pipeline on one GPU.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the sharded engine on 4 cards vs 1

Phases (every one is fatal; nothing is caught and continued):

1. device   — JAX platform / device kind / count, the card's name and
              power limit (``nvidia-smi``, from a child process that
              stays off JAX), whether the native IO library loaded.
              Exits non-zero when JAX runs on anything but a GPU.
2. compile  — the fused step of every engine mode at real shapes
              (2,048-read batches): RBK two-tier ends, NBD two-tier ends,
              RBK ``--use-extended`` whole-read scan with chunk rows of
              >8,192 bp reads; prints ``compiled.memory_analysis()``.
3. identity — each mode row-identical to the scalar oracle
              (``Demuxer.demux``) on a mixed read set (chunked 9-25 kb
              reads, IUPAC bytes, rc reads, mid-read constructs), and
              each Triton kernel against its jnp twin on a real batch.
              The tolerance is exact.
4. kit      — ``kit -k SQK-NBD114-96 --maximize`` through the CLI on
              simulated reads: assigned and correct-of-assigned >= 0.99
              against the simulator's truth, plus the number of reads
              the engine resolved on the host (overflow path).
5. timing   — reads/s of the RBK ends engine with each Triton kernel
              against its jnp twin (median of 3 passes over the same
              65,536 reads, 32 batches, so pipeline fill and drain stay
              small), and the fused step's own time per batch.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import random
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 2048
SEED = 0


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# phase 1: device


def card_line() -> str:
    """``name, power.limit`` of the card(s), read by nvidia-smi."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def device_phase(n_cards: int):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    log(f"device: platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devs)}")
    require(d0.platform == "gpu", f"JAX runs on {d0.platform!r}, not a GPU")
    require(len(devs) >= n_cards, f"{n_cards} cards needed, {len(devs)} seen")
    card = card_line()
    log(f"card: {card}")
    from barbell_tpu.native import get_lib

    log(f"native IO library loaded: {get_lib() is not None}")
    return devs, card


# ---------------------------------------------------------------------------
# reads and engines


def kit_groups(kit: str, extended: bool = False):
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.ops.edit_model import get_edit_cut_off

    groups = BarcodeGroup.from_kit(kit, extended)
    for g in groups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    return groups


def ends_plan(kit: str, groups, maximize: bool = False):
    from barbell_tpu.kits.database import get_kit_info
    from barbell_tpu.kits.presets import preset_patterns
    from barbell_tpu.stages.kit import ends_plan_for_patterns
    from barbell_tpu.stages.pattern import pattern_from_str

    pats = [
        pattern_from_str(s)
        for s in preset_patterns(get_kit_info(kit).pattern_class, maximize)
    ]
    return ends_plan_for_patterns(pats, groups)


#: engine modes: name -> (kit, use_extended, ends scan)
MODES = {
    "rbk_ends": ("SQK-RBK114-96", False, True),
    "nbd_ends": ("SQK-NBD114-96", False, True),
    "rbk_extended": ("SQK-RBK114-96", True, False),
}


def make_engine(mode: str, devices, kernels=None):
    from barbell_tpu.models.twotier import make_ends_engine

    kit, extended, ends = MODES[mode]
    groups = kit_groups(kit, extended)
    plan = ends_plan(kit, groups) if ends else None
    return make_ends_engine(groups, plan, devices=devices, kernels=kernels)


def construct(mode: str, rng: random.Random):
    """(label, construct bytes, rc-construct for the far end or None)."""
    from barbell_tpu.kits.database import NB_1ST_FRONT, NB_1ST_REAR, NB_SEQS
    from barbell_tpu.sim.simulate import default_barcodes, rapid_adapter
    from barbell_tpu.utils import dna

    if mode.startswith("nbd"):
        bc = rng.randrange(96)
        c = (NB_1ST_FRONT + NB_SEQS[bc] + NB_1ST_REAR).encode()
        return f"NB{bc + 1:02d}", c, dna.reverse_complement_bytes(c)
    label, bseq = default_barcodes(96)[rng.randrange(96)]
    return label, rapid_adapter(bseq), None


def bench_reads(mode: str, n: int, seed: int, lens=(600, 4000)):
    """n reads with a body of ``lens`` bp (600-4000 by default) and a
    construct at the front (NBD: at both ends), half reverse-complemented,
    <= 6 edits: [(id, seq, label)]."""
    import numpy as np

    from barbell_tpu.sim.simulate import mutate_sequence
    from barbell_tpu.utils import dna

    rng = random.Random(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    bodies = np.random.default_rng(seed).integers(0, 4, size=n * 4000)
    out = []
    for i in range(n):
        label, c, tail = construct(mode, rng)
        body = acgt[bodies[i * 4000 : i * 4000 + rng.randrange(*lens)]]
        seq = c + body.tobytes()
        if tail:
            seq += tail
        if rng.random() < 0.5:
            seq = dna.reverse_complement_bytes(seq)
        out.append((f"r{i}", mutate_sequence(rng, seq, 0, 6), label))
    return out


def mixed_reads(mode: str, n: int, seed: int):
    """The identity set: ordinary reads plus chunked 9-25 kb reads, IUPAC
    bytes, rc reads, reads with no construct and reads with a second
    construct mid-read.  Ends modes scan only read ends beyond their
    full-coverage length (docs/SEMANTICS.md deviation 7), so there the
    mid-read constructs sit in reads short enough to be covered whole;
    the whole-read mode puts them into the long reads too."""
    from barbell_tpu.sim.simulate import mutate_sequence, random_sequence
    from barbell_tpu.utils import dna

    rng = random.Random(seed)
    ends = MODES[mode][2]
    ids, seqs = [], []
    for i in range(n):
        kind = i % 8
        _label, c, tail = construct(mode, rng)
        if kind == 0:  # long read: chunk rows (whole-read) / end rows (ends)
            body = bytes(random_sequence(rng, rng.randrange(9000, 25000)))
            if not ends:
                cut = rng.randrange(2000, len(body) - 2000)
                _l2, c2, _t2 = construct(mode, rng)
                body = body[:cut] + c2 + body[cut:]
            seq = c + body + (tail or b"")
        elif kind == 1:  # mid-read construct in a short read
            body = bytes(random_sequence(rng, rng.randrange(300, 500)))
            _l2, c2, _t2 = construct(mode, rng)
            seq = c + body[:150] + c2 + body[150:]
        elif kind == 2:  # IUPAC bytes in the construct and the body
            seq = bytearray(c + bytes(random_sequence(rng, rng.randrange(600, 3000))))
            for _ in range(3):
                seq[rng.randrange(len(seq))] = rng.choice(b"NRYKMSW")
            seq = bytes(seq) + (tail or b"")
        elif kind == 3:  # no construct
            seq = bytes(random_sequence(rng, rng.randrange(600, 4000)))
        else:
            seq = c + bytes(random_sequence(rng, rng.randrange(600, 4000)))
            seq += tail or b""
        if rng.random() < 0.5:
            seq = dna.reverse_complement_bytes(seq)
        ids.append(f"{mode}_{i}")
        seqs.append(mutate_sequence(rng, seq, 0, 6))
    return ids, seqs


def _oracle_rows(mode: str, ids, seqs):
    """Scalar-oracle rows (runs in a worker process that never starts
    JAX)."""
    from barbell_tpu.models.demux import Demuxer

    kit, extended, _ends = MODES[mode]
    d = Demuxer(alpha=0.4)
    for g in kit_groups(kit, extended):
        d.add_query_group(g)
    return [d.demux(rid, s) for rid, s in zip(ids, seqs)]


def oracle_rows(mode: str, ids, seqs, workers: int):
    """Oracle rows in ``workers`` spawned processes (stopped on return)."""
    ctx = multiprocessing.get_context("spawn")
    step = -(-len(ids) // workers)
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        futs = [
            pool.submit(_oracle_rows, mode, ids[i : i + step], seqs[i : i + step])
            for i in range(0, len(ids), step)
        ]
        out = []
        for f in futs:
            out.extend(f.result())
    return out


def tables_equal(a, b) -> int:
    """Number of columns that differ between two HitTables (0 = equal)."""
    import numpy as np

    from barbell_tpu.models import hittable

    bad = 0
    for c in hittable.COLUMNS:
        if a.cols[c].shape != b.cols[c].shape or not np.array_equal(
            a.cols[c], b.cols[c]
        ):
            bad += 1
    return bad


# ---------------------------------------------------------------------------
# phase 2: compile at real shapes


class StepRecorder:
    """Records the first call of every distinct fused-step configuration
    the engines dispatch, so each can be lowered and compiled again for
    its memory analysis (the persistent cache makes that a load)."""

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        from barbell_tpu.ops import composite as comp

        self._comp = comp
        self._orig = (comp.demux_call_mono, comp.demux_call_fused)

        def wrap(fn, name):
            def inner(*args, **kw):
                key = (name, tuple(sorted(kw.items())))
                self.calls.setdefault(key, (fn, args, kw))
                return fn(*args, **kw)

            return inner

        comp.demux_call_mono = wrap(self._orig[0], "mono")
        comp.demux_call_fused = wrap(self._orig[1], "fused")
        return self

    def __exit__(self, *exc):
        self._comp.demux_call_mono, self._comp.demux_call_fused = self._orig

    def report(self, mode: str) -> None:
        for (name, kw), (fn, args, kwargs) in self.calls.items():
            d = dict(kw)
            shape = (
                f"L={d.get('L_rows') or dict(d['common'])['L_rows']} "
                f"H_cap={d.get('H_cap') or dict(d['common'])['H_cap']}"
            )
            t0 = time.perf_counter()
            ma = fn.lower(*args, **kwargs).compile().memory_analysis()
            require(ma is not None, f"{mode}: no memory analysis")
            log(
                f"memory {mode} [{name} {shape}]: "
                f"arguments={ma.argument_size_in_bytes} "
                f"outputs={ma.output_size_in_bytes} "
                f"temp={ma.temp_size_in_bytes} "
                f"code={ma.generated_code_size_in_bytes} bytes "
                f"(lower+compile {time.perf_counter() - t0:.1f}s)"
            )


def long_tail(reads, mode: str, seed: int):
    """Replace a few reads of a real batch by 9-25 kb reads, so the
    whole-read mode compiles its >8,192 bp chunk-row shape."""
    from barbell_tpu.sim.simulate import random_sequence

    rng = random.Random(seed)
    for i in range(0, min(64, len(reads)), 8):
        rid = reads[i][0]
        label, c, tail = construct(mode, rng)
        body = bytes(random_sequence(rng, rng.randrange(9000, 25000)))
        reads[i] = (rid, c + body + (tail or b""), label)
    return reads


def compile_and_identity(devices, workers: int, n_ident: int, seed: int):
    """Phases 2 and 3: per mode, one real batch (memory analysis, Triton
    kernels vs jnp twins) and the oracle identity set."""
    from barbell_tpu.ops import kernels as kern

    for mode in MODES:
        t0 = time.perf_counter()
        real = bench_reads(mode, BATCH, seed + 1)
        if not MODES[mode][2]:
            real = long_tail(real, mode, seed + 2)
        ids = [r[0] for r in real]
        seqs = [r[1] for r in real]
        with StepRecorder() as rec:
            engine = make_engine(mode, devices)
            chosen = getattr(engine, "shallow", engine).kernels
            require(chosen == kern.GPU,
                    f"{mode}: the engine chose {chosen} on the GPU")
            t_gpu = engine.demux_batch_table(ids, seqs)
            if hasattr(engine, "warm_deep"):
                engine.warm_deep()  # the rescue tier's step
            log(f"compile {mode}: first real batch of {len(ids)} reads in "
                f"{time.perf_counter() - t0:.1f}s")
        rec.report(mode)

        xla = make_engine(mode, devices, kernels=kern.XLA)
        t_xla = xla.demux_batch_table(ids, seqs)
        bad = tables_equal(t_gpu, t_xla)
        log(f"kernels-vs-jnp {mode}: {len(ids)} reads, "
            f"{t_gpu.cols['reads'].shape[0]} rows, {bad} differing columns "
            f"(Triton Myers + rank vs jnp twins, exact)")
        require(bad == 0, f"{mode}: Triton kernels differ from the jnp twins")

        mids, mseqs = mixed_reads(mode, n_ident, seed + 3)
        t0 = time.perf_counter()
        want = oracle_rows(mode, mids, mseqs, workers)
        t_oracle = time.perf_counter() - t0
        got = engine.demux_batch(mids, mseqs)
        bad_reads = [
            rid for rid, g, w in zip(mids, got, want) if g != w
        ]
        n_rows = sum(len(w) for w in want)
        log(f"identity {mode}: {len(mids)} reads, {n_rows} oracle rows, "
            f"{len(bad_reads)} mismatching reads (exact: int32 costs, "
            f"float32 Lodhi, labels, positions; oracle {t_oracle:.1f}s)")
        require(not bad_reads, f"{mode}: rows differ from the oracle for "
                f"{bad_reads[:5]}")


# ---------------------------------------------------------------------------
# phase 4: the kit pipeline through the CLI


def kit_phase(n_reads: int, seed: int, work: str):
    from barbell_tpu import cli
    from barbell_tpu.models import pipeline
    from barbell_tpu.sim.compare import assignments_from_trimmed

    reads = bench_reads("nbd_ends", n_reads, seed + 4)
    fq = os.path.join(work, "kit_reads.fastq")
    with open(fq, "w") as fh:
        for rid, seq, _label in reads:
            s = seq.decode()
            fh.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n")
    truth = {rid: label for rid, _s, label in reads}

    engines = []
    init = pipeline.JaxDemuxEngine.__init__

    def tracking_init(self, *a, **kw):
        init(self, *a, **kw)
        engines.append(self)

    pipeline.JaxDemuxEngine.__init__ = tracking_init
    out = os.path.join(work, "kit_out")
    try:
        t0 = time.perf_counter()
        rc = cli.main(["kit", "-k", "SQK-NBD114-96", "-i", fq, "-o", out,
                       "--maximize"])
        dt = time.perf_counter() - t0
    finally:
        pipeline.JaxDemuxEngine.__init__ = init
    require(rc == 0, f"kit CLI exited {rc}")
    assigned = assignments_from_trimmed(out)
    n_ok = sum(
        1 for rid, label in assigned.items()
        if truth.get(rid) == label.split("_")[0]
    )
    frac = len(assigned) / len(reads)
    acc = n_ok / max(1, len(assigned))
    host = sum(e.host_resolved for e in engines)
    log(f"kit SQK-NBD114-96 --maximize: {len(reads)} reads in {dt:.1f}s "
        f"(compile included), assigned {frac:.4f}, correct-of-assigned "
        f"{acc:.4f}, resolved on the host {host} reads "
        f"({len(engines)} engine tiers)")
    require(frac >= 0.99, f"kit assigned {frac:.4f} < 0.99")
    require(acc >= 0.99, f"kit correct-of-assigned {acc:.4f} < 0.99")


# ---------------------------------------------------------------------------
# phase 5: kernel vs jnp twin timings


def time_engine(engine, ids, seqs, repeat: int = 3, batch: int = BATCH):
    """Median reads/s of ``repeat`` pipelined passes over the same reads
    (after one untimed warm pass)."""
    import numpy as np

    from barbell_tpu.models.pipeline import engine_map_batches

    def run():
        batches = (
            (ids[i : i + batch], seqs[i : i + batch])
            for i in range(0, len(ids), batch)
        )
        n = 0
        for _b, _s, _t in engine_map_batches(
            engine, batches, method="demux_batch_table"
        ):
            n += len(_b)
        return n

    run()
    rates = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        n = run()
        rates.append(n / (time.perf_counter() - t0))
    return float(np.median(rates)), rates


def time_step(rec: StepRecorder, repeat: int = 10) -> float:
    """Median ms of the first recorded fused step, re-run on its own
    recorded inputs and waited for (device time plus dispatch)."""
    import jax
    import numpy as np

    fn, args, kw = next(iter(rec.calls.values()))
    jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def timing_phase(devices, card: str, n_reads: int, seed: int):
    from barbell_tpu.ops.kernels import GPU, XLA, Kernels

    reads = bench_reads("rbk_ends", n_reads, seed + 5)
    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]
    results = {}
    for name, k in (
        ("jnp twins", XLA),
        ("Myers kernel", Kernels(myers=True)),
        ("rank kernel", Kernels(rank=True)),
        ("both kernels", GPU),
    ):
        with StepRecorder() as rec:
            engine = make_engine("rbk_ends", devices, kernels=k)
            med, rates = time_engine(engine, ids, seqs)
        results[name] = med
        log(f"timing rbk_ends [{name}]: median {med:.1f} reads/s over "
            f"{len(ids)} reads, passes {[round(r, 1) for r in rates]}; "
            f"fused step {time_step(rec):.2f} ms per {BATCH}-read batch "
            f"[{card}]")
    base = results["jnp twins"]
    for name in ("Myers kernel", "rank kernel", "both kernels"):
        log(f"timing rbk_ends: {name} / jnp twins = "
            f"{results[name] / base:.3f} [{card}]")


# ---------------------------------------------------------------------------
# four cards


def four_cards_phase(devices, card: str, n_reads: int, seed: int):
    """Row identity of the 4-card engine against one card, then reads/s
    of both over the same reads: ``n_reads`` distinct reads, each four
    times, so the 4-card engine (8,192-read batches, 2,048 per card) and
    the 1-card engine (2,048-read batches) both run >= 32 pipelined
    batches per pass."""
    import jax

    reads = bench_reads("rbk_ends", n_reads, seed + 6)
    four = make_engine("rbk_ends", devices[:4])
    one = make_engine("rbk_ends", devices[:1])
    require(four.shallow.mesh is not None, "4-card engine built no mesh")
    ids = [r[0] for r in reads[: 4 * BATCH]]
    seqs = [r[1] for r in reads[: 4 * BATCH]]
    t4 = four.demux_batch_table(ids, seqs)
    require(four.shallow.last_dispatch == "sharded",
            f"4-card dispatch was {four.shallow.last_dispatch}")
    t1 = one.demux_batch_table(ids, seqs)
    bad = tables_equal(t4, t1)
    log(f"four-cards identity: {len(ids)} reads, "
        f"{t1.cols['reads'].shape[0]} rows, {bad} differing columns (exact)")
    require(bad == 0, "4-card rows differ from 1-card rows")
    ids = [f"{r[0]}_{k}" for k in range(4) for r in reads]
    seqs = [r[1] for _k in range(4) for r in reads]
    r4, p4 = time_engine(four, ids, seqs, batch=4 * BATCH)
    r1, p1 = time_engine(one, ids, seqs, batch=BATCH)
    log(f"four-cards timing over {len(ids)} reads: 4 cards {r4:.1f} reads/s "
        f"in {len(ids) // (4 * BATCH)} batches (passes "
        f"{[round(r, 1) for r in p4]}), 1 card {r1:.1f} reads/s in "
        f"{len(ids) // BATCH} batches (passes {[round(r, 1) for r in p1]}), "
        f"scaling {r4 / r1 / 4:.3f} per card [{card}] over "
        f"{jax.device_count()} devices")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded engine vs 1 card")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--identity-reads", type=int, default=256)
    ap.add_argument("--kit-reads", type=int, default=32768)
    ap.add_argument("--timing-reads", type=int, default=32 * BATCH)
    args = ap.parse_args(argv)

    n_cards = 4 if args.four_cards else 1
    devs, card = device_phase(n_cards)
    work = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        if args.four_cards:
            four_cards_phase(devs, card, args.timing_reads, args.seed)
        else:
            one = devs[:1]
            workers = max(1, min(8, (os.cpu_count() or 2) - 2))
            compile_and_identity(one, workers, args.identity_reads, args.seed)
            kit_phase(args.kit_reads, args.seed, work)
            timing_phase(one, card, args.timing_reads, args.seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    d0 = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        import barbell_tpu  # noqa: F401  (run from the repository root)
    except ImportError as exc:
        print(f"chip_smoke: cannot import the package: {exc}", file=sys.stderr)
        sys.exit(1)
    try:
        sys.exit(main())
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
