"""Two-tier ends scan: shallow end windows for every read, deep-left
rescan for the few reads whose near-boundary hits could chain deeper.

The kit presets' ``@prev_left`` chains are the only reason the ends
window is deep (reference ``src/kits/kits.rs:175-236``): every preset's
FIRST element is bounded by ``@left(0..b)`` / ``@right(0..b)``, so a
shallow window W1 discovers every chain's first link, while a deeper
link can exist ONLY when some shallow-visible hit's flank end lies
within ``trigger_margin`` of the shallow claim boundary (margin =
max ``@prev_left`` upper bound + halo + 1; the halo term covers
rc-strand discovery, whose claim depth is ``halo`` shallower than the
forward side's).  Triggered reads — rare: real constructs sit at
position ~0, so a trigger needs ~140+ bases of leading junk — are
re-scanned with the deep prefix window and their rows replace the
shallow rows wholesale.

Contract (docs/SEMANTICS.md deviation 7): triggered reads get exactly
the deep-window row set; untriggered reads the shallow-window row set.
Every read a deep single-tier scan would ACCEPT is accepted identically
(the chain-induction above); a read deep would REJECT only because of
an un-chained band hit (flank end between the shallow and deep claims,
with no near-boundary trigger hit) passes instead — the same class of
deviation as ends mode's unscanned middle, one boundary shallower.
``tests/test_twotier.py`` pins both sides.

Economics (the point): the RBK safe preset needs depth 896 only for
its double-barcode rescue chain; first links bound at ~512.  Two tiers
ship 2x512 bases per long read instead of 2x896 (~43% fewer uploaded
and scanned bases) and halve the padded device row width.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import PADDING
from . import hittable
from .hittable import HitTable
from .records import BarbellMatch


@dataclass(frozen=True)
class EndsPlan:
    """Preset-derived per-side / per-tier ends-scan windows.

    ``shallow`` is the (prefix, suffix) window pair every read is
    scanned with; ``deep`` (optional) the rescan pair for triggered
    reads (suffix side never deepens: ``@prev_left`` after ``@right``
    is unbounded and forces a full scan instead); ``trigger_margin``
    the read-coordinate distance from the shallow prefix width within
    which a visible flank end triggers the rescan."""

    shallow: Tuple[int, int]
    deep: Optional[Tuple[int, int]] = None
    trigger_margin: int = 0


def make_ends_engine(groups, plan: Optional[EndsPlan], **engine_kwargs):
    """Engine for an ends plan: plain full scan (plan None), plain
    ends engine (no deep tier), or the two-tier engine."""
    from .pipeline import JaxDemuxEngine

    if plan is None:
        return JaxDemuxEngine(groups, **engine_kwargs)
    if plan.deep:
        return TwoTierDemuxEngine(groups, plan, **engine_kwargs)
    return JaxDemuxEngine(groups, ends_window=plan.shallow, **engine_kwargs)


class TwoTierDemuxEngine:
    """Shallow-scan + deep-rescue wrapper around two
    :class:`~barbell_tpu.models.pipeline.JaxDemuxEngine` instances.

    Exposes the same ``demux_batch`` / ``demux_batch_table`` interface
    (drivable by ``engine_map_batches``).  The deep engine's batch
    shapes are pinned: rescue batches pad with deterministic dummy
    reads to a fixed row bucket, because every new padded shape is a
    fresh compile.
    """

    #: minimum padded host-row count of a rescue batch (buckets to 64)
    _RESCUE_ROWS = 48

    def __init__(self, groups, plan: EndsPlan, **engine_kwargs):
        from .pipeline import JaxDemuxEngine, _pow2_at_least

        if not plan.deep:
            raise ValueError("TwoTierDemuxEngine needs a plan with a deep tier")
        self.plan = plan
        self.shallow = JaxDemuxEngine(
            groups, ends_window=plan.shallow, **engine_kwargs
        )
        # pow2 row buckets only for the deep engine: rescue batches are
        # tiny and their shape universe must stay minimal
        deep_kwargs = dict(engine_kwargs)
        deep_kwargs["fine_rows"] = False
        self.deep = JaxDemuxEngine(
            groups, ends_window=plan.deep, **deep_kwargs
        )
        self.groups = self.shallow.groups
        self.labels = self.shallow.labels
        self.halo = self.shallow.halo
        W1l, W1r = plan.shallow
        #: reads fully covered by the shallow overlap need no rescue
        self._cover1 = W1l + W1r - self.shallow.halo - PADDING - 1
        #: trigger: a visible left-region flank end past this depth
        self._thresh = W1l - plan.trigger_margin
        self._w1l = W1l
        #: rescued-read count of the last batch (tests/observability)
        self.last_rescued = 0
        #: total rescued reads (engine_map_batches runs batches on
        #: worker threads, so the accumulation is locked)
        self.total_rescued = 0
        import threading

        self._lock = threading.Lock()
        self._L_deep = min(
            _pow2_at_least(max(plan.deep), lo=256), self.deep.max_row_len
        )
        # deterministic hit-free pad read, long enough to take the
        # ends-row path in the deep engine (pins L and the row bucket)
        rng = random.Random(0xBA5BE11)
        self._dummy = bytes(
            rng.choice(b"ACGT") for _ in range(self._L_deep + 64)
        )

    # ------------------------------------------------------------------

    def demux_batch(
        self, read_ids: List[str], seqs: List[bytes]
    ) -> List[List[BarbellMatch]]:
        return hittable.table_to_matches(
            self.demux_batch_table(read_ids, seqs)
        )

    def demux_batch_table(
        self, read_ids: List[str], seqs: List[bytes]
    ) -> HitTable:
        t = self.shallow.demux_batch_table(read_ids, seqs)
        self.last_rescued = 0
        c = t.cols
        if c["reads"].shape[0] == 0:
            return t
        # Trigger: a hit in the LEFT claim region (ref < W1l excludes
        # right-region hits: eligible reads have C1 > W1l) whose flank
        # end could chain a successor past the shallow claims.
        eligible = t.read_lens[c["reads"]] > self._cover1
        trig = eligible & (c["ref"] > self._thresh) & (c["ref"] < self._w1l)
        if not bool(trig.any()):
            return t
        rescue = np.unique(c["reads"][trig])
        self.last_rescued = int(rescue.size)
        with self._lock:
            self.total_rescued += int(rescue.size)
        td = self._deep_call(
            [read_ids[int(i)] for i in rescue],
            [seqs[int(i)] for i in rescue],
        )
        dcols = {k: v for k, v in td.cols.items()}
        dcols["reads"] = rescue[td.cols["reads"]]
        keep = ~np.isin(c["reads"], rescue)
        cols = {
            k: np.concatenate([c[k][keep], dcols[k]])
            for k in hittable.COLUMNS
        }
        # a read's rows are entirely shallow or entirely deep, so the
        # stable read sort keeps each side's internal order
        order = np.argsort(cols["reads"], kind="stable")
        cols = {k: v[order] for k, v in cols.items()}
        return HitTable(
            read_ids=t.read_ids,
            read_lens=t.read_lens,
            cols=cols,
            labels=t.labels,
        )

    # ------------------------------------------------------------------

    def _deep_call(self, ids: List[str], seqs: List) -> HitTable:
        """Deep-window scan of the rescued reads, padded with dummy
        reads to the pinned row bucket; dummy rows are stripped."""
        rows = sum(1 if len(s) <= self._L_deep else 2 for s in seqs)
        n_dummy = max(1, -(-(self._RESCUE_ROWS - rows) // 2))
        all_ids = list(ids) + [f"__pad{i}" for i in range(n_dummy)]
        all_seqs = list(seqs) + [self._dummy] * n_dummy
        td = self.deep.demux_batch_table(all_ids, all_seqs)
        keep = td.cols["reads"] < len(ids)
        cols = {k: v[keep] for k, v in td.cols.items()}
        return HitTable(
            read_ids=td.read_ids[: len(ids)],
            read_lens=td.read_lens[: len(ids)],
            cols=cols,
            labels=td.labels,
        )

    def warm_deep(self) -> None:
        """Compile the deep tier's production shapes (one rescue-sized
        call) so a mid-stream first trigger doesn't stall a batch on
        a compile."""
        self._deep_call(["__warm"], [self._dummy])
