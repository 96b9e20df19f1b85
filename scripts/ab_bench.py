"""Interleaved A/B throughput comparison on the GPU.

Sequential whole-config runs (one config, then the other) confound
config with drift (clocks, power limit, host load).  This harness
builds BOTH engine variants in one process, warms each once (their
compiles are the per-process cold-start cost), then runs A and B
alternately on the SAME fresh dataset per repetition — a paired
comparison that cancels drift.

Modes (env AB_MODE):
  mono       mono blob upload (default ON) vs per-array uploads
  fine_rows  1/8-octave row buckets vs pow2 row buckets
  batch      AB_BATCH vs AB_BATCH_B (default 4096) on one engine —
             fewer RPCs per read vs more padding + shallower pipeline
  depth      pipeline depth 4 vs AB_DEPTH_B (default 8) on one engine —
             more in-flight batches hide device latency vs more host
             memory + GIL contention

Env: AB_READS (default 16384), AB_BATCH (2048), AB_REPEAT (3 paired
passes).  Output: one JSON line with both arms' per-pass times,
medians, the B/A ratio and the device; progress on stderr.  Exits
non-zero without a GPU.

Run SOLO — nothing else may touch the card or the host while this
runs.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MODE = os.environ.get("AB_MODE", "mono")
N_READS = int(os.environ.get("AB_READS", "16384"))
BATCH = int(os.environ.get("AB_BATCH", "2048"))
REPEAT = int(os.environ.get("AB_REPEAT", "3"))


def log(msg):
    print(f"# [{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def build_engines():
    from barbell_tpu.models.barcodes import BarcodeGroup
    from barbell_tpu.models.pipeline import JaxDemuxEngine
    from barbell_tpu.ops.edit_model import get_edit_cut_off

    groups = BarcodeGroup.from_kit("SQK-RBK114-96", False)
    for g in groups:
        g.set_flank_threshold(get_edit_cut_off(g.get_effective_len()))
    if MODE == "mono":
        arms = (
            (JaxDemuxEngine(groups, mono_upload=True), "mono_upload", BATCH, None),
            (JaxDemuxEngine(groups, mono_upload=False), "per_array_upload", BATCH, None),
        )
    elif MODE == "fine_rows":
        arms = (
            (JaxDemuxEngine(groups, fine_rows=False), "pow2_rows", BATCH, None),
            (JaxDemuxEngine(groups, fine_rows=True), "fine_rows", BATCH, None),
        )
    elif MODE == "batch":
        eng = JaxDemuxEngine(groups)
        bb = int(os.environ.get("AB_BATCH_B", "4096"))
        arms = (
            (eng, f"batch_{BATCH}", BATCH, None),
            (eng, f"batch_{bb}", bb, None),
        )
    elif MODE == "depth":
        eng = JaxDemuxEngine(groups)
        db = int(os.environ.get("AB_DEPTH_B", "8"))
        arms = (
            (eng, "depth_4", BATCH, 4),
            (eng, f"depth_{db}", BATCH, db),
        )
    elif MODE == "ends":
        W = _preset_window(groups)
        arms = (
            (JaxDemuxEngine(groups), "full_scan", BATCH, None),
            (JaxDemuxEngine(groups, ends_window=W), f"ends_{W}", BATCH, None),
        )
    elif MODE == "align":
        W = _preset_window(groups)
        arms = (
            (
                JaxDemuxEngine(groups, ends_window=W, cat_align=128),
                "ends_align128", BATCH, None,
            ),
            (
                JaxDemuxEngine(groups, ends_window=W, cat_align=64),
                "ends_align64", BATCH, None,
            ),
        )
    elif MODE == "fine_ends":
        # Does padded device compute/fetch bind in ends mode?  Round 3
        # measured fine_rows neutral on the FULL scan (fetch-latency
        # bound); ends mode halves the wire, so re-ask under it.
        W = _preset_window(groups)
        arms = (
            (
                JaxDemuxEngine(groups, ends_window=W, fine_rows=False),
                "ends_pow2_rows", BATCH, None,
            ),
            (
                JaxDemuxEngine(groups, ends_window=W, fine_rows=True),
                "ends_fine_rows", BATCH, None,
            ),
        )
    elif MODE == "meta":
        arms = (
            (JaxDemuxEngine(groups, meta_mode="wire"), "meta_wire", BATCH, None),
            (JaxDemuxEngine(groups, meta_mode="desc"), "meta_desc", BATCH, None),
        )
    elif MODE == "twotier":
        # round-4 single-tier symmetric window vs the round-5 two-tier
        # per-side plan (shallow 512 every read + deep-left rescue)
        from barbell_tpu.models.twotier import make_ends_engine

        W = _preset_window(groups)
        plan = _preset_plan(groups)
        arms = (
            (JaxDemuxEngine(groups, ends_window=W), f"single_tier_{W}", BATCH, None),
            (
                make_ends_engine(groups, plan),
                f"two_tier_{plan.shallow[0]}", BATCH, None,
            ),
        )
    elif MODE == "tt_batch":
        # batch 2048 vs 4096 under the round-5 two-tier engine: pass
        # times shrank ~4x since the round-3 batch A/B (dead heat on
        # the full scan), so per-batch fixed costs weigh more now
        from barbell_tpu.models.twotier import make_ends_engine

        plan = _preset_plan(groups)
        eng = make_ends_engine(groups, plan)
        bb = int(os.environ.get("AB_BATCH_B", "4096"))
        arms = (
            (eng, f"tt_batch_{BATCH}", BATCH, None),
            (eng, f"tt_batch_{bb}", bb, None),
        )
    elif MODE == "align2":
        # 32 vs 64 under the round-5 two-tier shallow config (ends rows
        # are exactly 128B of content at W1=512, so alignment should
        # only matter for whole-shipped short reads — measure it)
        from barbell_tpu.models.twotier import make_ends_engine

        plan = _preset_plan(groups)
        arms = (
            (make_ends_engine(groups, plan, cat_align=64), "tt_align64", BATCH, None),
            (make_ends_engine(groups, plan, cat_align=32), "tt_align32", BATCH, None),
        )
    else:
        raise SystemExit(f"unknown AB_MODE {MODE!r}")
    return arms


def _preset_window(groups):
    from barbell_tpu.kits.presets import preset_patterns
    from barbell_tpu.stages.kit import ends_window_for_patterns
    from barbell_tpu.stages.pattern import pattern_from_str

    pats = [pattern_from_str(s) for s in preset_patterns("single", False)]
    return ends_window_for_patterns(pats, groups)


def _preset_plan(groups):
    from barbell_tpu.kits.presets import preset_patterns
    from barbell_tpu.stages.kit import ends_plan_for_patterns
    from barbell_tpu.stages.pattern import pattern_from_str

    pats = [pattern_from_str(s) for s in preset_patterns("single", False)]
    return ends_plan_for_patterns(pats, groups)


def run_pass(engine, reads, batch, depth=None):
    from barbell_tpu.models.pipeline import engine_map_batches
    from barbell_tpu.models.records import BarcodeType

    ids = [r[0] for r in reads]
    seqs = [r[1] for r in reads]
    truth = {r[0]: r[2] for r in reads}

    def batches():
        for i in range(0, len(reads) - batch + 1, batch):
            yield ids[i : i + batch], seqs[i : i + batch]

    t0 = time.perf_counter()
    n = correct = 0
    for bids, _bs, out in engine_map_batches(engine, batches(), depth=depth):
        n += len(bids)
        for rid, rows in zip(bids, out):
            tags = [m for m in rows if m.match_type == BarcodeType.Ftag]
            if tags and tags[0].label == truth[rid]:
                correct += 1
    dt = time.perf_counter() - t0
    assert correct / max(1, n) > 0.99, f"accuracy regression {correct}/{n}"
    return n, dt


def main():
    import bench  # repo root is on sys.path (inserted above)

    device = bench.gpu_device()
    from bench import make_reads_rbk

    arm_a, arm_b = build_engines()
    name_a, name_b = arm_a[1], arm_b[1]
    log(f"mode={MODE}: A={name_a} B={name_b}; warming (compiles)")
    warm = make_reads_rbk(N_READS, seed=99)
    for eng, nm, bsz, dp in (arm_a, arm_b):
        t0 = time.perf_counter()
        run_pass(eng, warm, bsz, dp)
        if hasattr(eng, "warm_deep"):
            eng.warm_deep()  # compile the rescue tier's shapes too
        log(f"warm {nm}: {time.perf_counter() - t0:.1f}s")

    times = {name_a: [], name_b: []}
    n = 0
    for rep in range(REPEAT):
        reads = make_reads_rbk(N_READS, seed=1000 + rep)
        # alternate which arm goes first to cancel slow monotone drift
        order = (arm_a, arm_b) if rep % 2 == 0 else (arm_b, arm_a)
        for eng, nm, bsz, dp in order:
            n, dt = run_pass(eng, reads, bsz, dp)
            times[nm].append(dt)
            log(f"pass {rep} {nm}: {n} reads in {dt:.2f}s ({n / dt:.0f} reads/s)")

    med_a = float(np.median(times[name_a]))
    med_b = float(np.median(times[name_b]))
    print(
        json.dumps(
            {
                "mode": MODE,
                "n_reads": n,
                "arm_a": name_a,
                "arm_b": name_b,
                "times_a": [round(t, 3) for t in times[name_a]],
                "times_b": [round(t, 3) for t in times[name_b]],
                "reads_per_sec_a": round(n / med_a, 1),
                "reads_per_sec_b": round(n / med_b, 1),
                "b_over_a_speedup": round(med_a / med_b, 4),
                **device,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
