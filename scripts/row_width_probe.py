"""Row-width probe for the whole-read scan (``--use-extended``) on the GPU.

``JaxDemuxEngine._choose_L`` picks the row width L of a whole-read batch
from a cost model over shapes.  This script forces every candidate width
on real SQK-RBK114-96 extended batches and times each, so the model's
weights can be checked against the card:

    python scripts/row_width_probe.py [--out chiprun_out/row_width.jsonl]

Batches (``--batches``): ``short``, 2,048 reads of 600-4,000 bp (the
``chip_smoke.py`` bench reads); ``long``, the same batch with eight reads
replaced by 9-25 kb reads; ``one``, 2,048 reads of 300-1,000 bp with one
read of 4,200 bp (chunking that read adds a few rows, which the pow2 row
bucket can turn into a larger padded row count).  For each
(batch, L): the padded row counts, the model's flank and rank DP-cell
terms, the fused step's time on its recorded inputs (median of 10,
``block_until_ready``) and the synchronous batch time through
``demux_batch_table`` (median of 5).  One JSON object per line, also
written to ``--out``.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "row_width.jsonl"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-width", type=int, default=512)
    ap.add_argument("--batches", default="short,long,one")
    args = ap.parse_args(argv)

    import jax
    import numpy as np

    import chip_smoke as cs
    from barbell_tpu.models import pipeline as P

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"row_width_probe: JAX runs on {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    out = open(args.out, "w")

    engine = cs.make_engine("rbk_extended", [dev])
    model_pick = engine._choose_L
    short = cs.bench_reads("rbk_extended", cs.BATCH, args.seed + 1)
    long_ = cs.long_tail(list(short), "rbk_extended", args.seed + 2)
    one = cs.bench_reads("rbk_extended", cs.BATCH, args.seed + 3,
                         lens=(300, 1000))
    label, c, _tail = cs.construct("rbk_extended", random.Random(args.seed))
    body = bytes(random.Random(args.seed).choices(b"ACGT", k=4200 - len(c)))
    one[0] = (one[0][0], c + body, label)
    batches = {"short": short, "long": long_, "one": one}
    flank_m = sum(p.m for p in engine.plans)
    rank_cells = sum(
        2 * p.n_patterns * p.plen * p.barcode_window for p in engine.plans
    )
    for name in args.batches.split(","):
        reads = batches[name]
        ids = [r[0] for r in reads]
        seqs = [r[1] for r in reads]
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        pick = model_pick(lens)
        top = min(P._pow2_at_least(int(lens.max()), lo=256),
                  engine.max_row_len)
        L = top
        while L >= args.min_width:
            engine._choose_L = lambda _lens, L=L: L
            step = L - P.PADDING - engine.halo
            plan = engine._plan_shard(
                [bytes(s) for s in seqs], lens, range(len(seqs)), L, step
            )
            rows = P._row_bucket(max(plan.R_host, 1), lo=8,
                                 fine=engine.fine_rows) + P._row_bucket(
                max(plan.F, 1), lo=8, fine=engine.fine_rows)
            t0 = time.perf_counter()
            with cs.StepRecorder() as rec:
                engine.demux_batch_table(ids, seqs)
            first_s = time.perf_counter() - t0
            step_ms = cs.time_step(rec)
            kw = dict(next(iter(rec.calls))[1])
            h_cap = kw.get("H_cap") or dict(kw["common"])["H_cap"]
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                engine.demux_batch_table(ids, seqs)
                times.append(1e3 * (time.perf_counter() - t0))
            rec_ = {
                "batch": name, "L": L, "model_pick": pick,
                "padded_rows": rows, "H_cap": h_cap,
                "flank_cells": rows * L * flank_m,
                "rank_cells": rows * rank_cells,
                "step_ms": step_ms,
                "batch_ms": float(np.median(times)),
                "first_call_s": first_s,
                "card": card,
            }
            line = json.dumps(rec_)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()
            L //= 2
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
