"""Host-side profile of the streamed kit runner on the GPU.

The kit pipeline adds host inspect/filter/trim + output writing to the
annotate hot loop.  This script cProfiles ONE end-to-end
`demux_using_kit` run (streamed) on bench-shaped NBD reads and prints
the top cumulative functions, so the host work can be ranked before
optimizing (measure, don't guess).

Run solo on the card; a warmup engine absorbs the compiles before the
profiled run.  BARBELL_TIMING=1 adds the engine phase report.

Usage: python scripts/profile_kit.py [n_reads] [out_dir]
"""

import cProfile
import os
import pstats
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    out_root = sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp(
        prefix="profile_kit_"
    )
    batch = int(os.environ.get("BENCH_BATCH", "2048"))

    bench.gpu_device()

    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models.twotier import make_ends_engine
    from barbell_tpu.ops.edit_model import get_edit_cut_off
    from barbell_tpu.stages.kit import KitRunConfig, demux_using_kit

    reads = bench.make_reads_nbd(n_reads, seed=11)

    # absorb the per-process compiles with the SAME engine
    # config the kit runner will build (the maximize two-tier plan)
    wgroups = BarcodeGroup.from_kit("SQK-NBD114-96", False)
    for g in wgroups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    from barbell_tpu.kits.presets import preset_patterns
    from barbell_tpu.stages.kit import ends_plan_for_patterns
    from barbell_tpu.stages.pattern import pattern_from_str

    pats = [pattern_from_str(s) for s in preset_patterns("double", True)]
    plan = ends_plan_for_patterns(pats, wgroups)
    warm = reads[: min(batch, len(reads))]
    t0 = time.perf_counter()
    weng = make_ends_engine(wgroups, plan)
    weng.demux_batch([r[0] for r in warm], [r[1] for r in warm])
    if hasattr(weng, "warm_deep"):
        weng.warm_deep()
    print(
        f"# warmup (compile): {time.perf_counter() - t0:.1f}s, plan={plan}",
        file=sys.stderr,
    )
    del weng

    fq = os.path.join(out_root, "reads.fastq")
    with open(fq, "w") as fh:
        for rid, seq, _label in reads:
            s = seq.decode()
            fh.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n")
    out = os.path.join(out_root, "out")

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    demux_using_kit(
        [fq],
        KitRunConfig(
            kit_name="SQK-NBD114-96", output_folder=out, maximize=True,
            batch_size=batch,
        ),
    )
    prof.disable()
    dt = time.perf_counter() - t0
    print(f"# kit run: {n_reads} reads in {dt:.1f}s ({n_reads / dt:.0f} reads/s)")

    st = pstats.Stats(prof)
    st.sort_stats("cumulative")
    st.print_stats(45)
    st.sort_stats("tottime")
    st.print_stats(30)

    if os.environ.get("BARBELL_TIMING"):
        from barbell_tpu.models.pipeline import timing_report

        print("# engine phases:\n" + timing_report())


if __name__ == "__main__":
    main()
