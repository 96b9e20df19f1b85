"""Per-phase host profile of the annotate hot loop on the GPU.

Runs the bench.py read generators through engine_map_batches with
BARBELL_TIMING=1 and prints the phase report plus wall clock, so the
GIL-bound host phases can be ranked against the pipelined wall time.
Usage: BARBELL_TIMING=1 python scripts/profile_phases.py [rbk114_96|nbd114_96]

Run solo on the card; one warmup batch absorbs the compiles before the
timed passes.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import bench  # noqa: E402


def main():
    config = sys.argv[1] if len(sys.argv) > 1 else "rbk114_96"
    n_reads = int(os.environ.get("BENCH_READS", "16384"))
    batch = int(os.environ.get("BENCH_BATCH", "2048"))
    cfg = bench.CONFIGS[config]

    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models import pipeline
    from barbell_tpu.models.pipeline import JaxDemuxEngine, engine_map_batches
    from barbell_tpu.ops.edit_model import get_edit_cut_off

    groups = BarcodeGroup.from_kit(cfg["kit"], cfg["extended"])
    for g in groups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    # mirror bench.py: kit configs profile the two-tier ends scan
    # unless BENCH_ENDS=0
    plan = None
    if os.environ.get("BENCH_ENDS", "1") != "0" and not cfg["extended"]:
        from barbell_tpu.kits.database import get_kit_info
        from barbell_tpu.kits.presets import preset_patterns
        from barbell_tpu.stages.kit import ends_plan_for_patterns
        from barbell_tpu.stages.pattern import pattern_from_str

        pats = [
            pattern_from_str(s)
            for s in preset_patterns(get_kit_info(cfg["kit"]).pattern_class, False)
        ]
        plan = ends_plan_for_patterns(pats, groups)
        print(f"# ends plan: {plan}", file=sys.stderr)
    from barbell_tpu.models.twotier import make_ends_engine

    engine = make_ends_engine(groups, plan)

    make = cfg["make"]
    warm = make(batch, seed=99)
    t0 = time.perf_counter()
    engine.demux_batch([r[0] for r in warm], [r[1] for r in warm])
    if hasattr(engine, "warm_deep"):
        engine.warm_deep()
    print(f"# warmup batch: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    pipeline.TIMINGS.clear()

    reads = make(n_reads, seed=0)
    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]

    def batches():
        for i in range(0, len(reads), batch):
            if i + batch <= len(reads):
                yield ids[i : i + batch], seqs[i : i + batch]

    t0 = time.perf_counter()
    n = 0
    rows = 0
    for bids, _bseqs, out in engine_map_batches(engine, batches()):
        n += len(bids)
        rows += sum(len(m) for m in out)
    dt = time.perf_counter() - t0
    print(f"# {config}: {n} reads, {rows} match rows in {dt:.2f}s "
          f"({n / dt:.0f} reads/s), {n // batch} batches "
          f"({dt / (n // batch) * 1e3:.1f} ms/batch wall)")
    print(pipeline.timing_report())


if __name__ == "__main__":
    main()
