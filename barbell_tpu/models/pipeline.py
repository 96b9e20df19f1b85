"""Batched accelerator demux engine.

Orchestrates the fused device composites in
:mod:`barbell_tpu.ops.composite` over batches of reads and assembles
:class:`BarbellMatch` rows identical to the scalar oracle engine
(:mod:`barbell_tpu.models.demux`) — that equivalence is enforced by
tests.

Per batch the engine issues ONE fused device call per group
(:func:`barbell_tpu.ops.composite.demux_call`): flank scan, top-K valley
compaction into fixed hit lanes, flank traceback, barcode-window mapping
and barcode rank all run on device and return a single packed int32
buffer.  Which stages run hand-written GPU kernels is a
:class:`barbell_tpu.ops.kernels.Kernels` chosen from the devices'
platform.  Input rows ship as 2-bit base codes (4 bases per byte) with
N/IUPAC/junk bytes on a device-applied exception list, encoded+packed by
the native C++ extension in one GIL-free pass; nibble packing remains
the fallback.  Batches pipeline 8-deep (``BARBELL_PIPELINE_DEPTH``) via
:func:`engine_map_batches`.

Row coordinate model: a device row holds text in columns
``[tsc, tec]``.  Forward rows are left-aligned (tsc=0); rc rows are
synthesized on device by flip+complement, so their content is
right-aligned (tsc = L - n).  Long reads are split into fixed-width
chunk rows with a halo overlap (``max flank span + PADDING + 2``) so
every within-threshold flank match — and its padded barcode window —
lives entirely inside one chunk row; chunk valid-ranges partition the
read's end positions exactly, so chunked results equal whole-read
results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import PADDING
from ..ops import composite as comp
from ..ops import oracle
from ..ops import kernels as kern
from ..ops.triton_myers import pattern_words
from ..ops.lodhi import perfect_score
from ..utils import dna
from . import hittable
from .barcodes import BarcodeGroup
from .demux import BARCODE_K_FRAC, COLLAPSE_OVERLAP, Demuxer
from .hittable import HitTable
from .records import BarbellMatch, Strand

MAX_ROW_LEN = 8192  # chunk width for long reads
MAX_HITS_PER_ROW = 16  # K for valley compaction
_EXC_CAP = 4096  # non-ACGT bytes per batch before nibble fallback
_CAT_BUCKET = 128 * 1024  # concatenated-code buffer size floor

# Env-gated phase timing (BARBELL_TIMING=1): accumulates wall-clock per
# pipeline phase into TIMINGS {name: [seconds, calls]}.  Device fetches
# are synchronous at np.asarray, so phases bracketing a fetch include
# device + transfer time.  See CLAUDE.md: profile with this, not with
# repeated-input microbenchmarks.
import contextlib
import os as _os
import threading as _threading
import time as _time

TIMINGS: Dict[str, List[float]] = {}
_TIMING = _os.environ.get("BARBELL_TIMING", "") not in ("", "0")
_TIMING_LOCK = _threading.Lock()


@contextlib.contextmanager
def _phase(name: str):
    if not _TIMING:
        yield
        return
    t0 = _time.perf_counter()
    try:
        yield
    finally:
        dt = _time.perf_counter() - t0
        # engine_map_batches runs demux_batch on several worker threads;
        # unlocked += here loses updates for exactly the most-concurrent
        # (hottest) phases, which is what this profile exists to rank.
        with _TIMING_LOCK:
            acc = TIMINGS.setdefault(name, [0.0, 0])
            acc[0] += dt
            acc[1] += 1


def timing_report() -> str:
    lines = [
        f"  {name:24s} {acc[0]:8.3f}s  n={acc[1]}"
        for name, acc in sorted(TIMINGS.items())
    ]
    return "\n".join(lines)


#: batches in flight in engine_map_batches: worker threads overlap one
#: batch's host encode and fetch with other batches' device work.
DEFAULT_PIPELINE_DEPTH = int(_os.environ.get("BARBELL_PIPELINE_DEPTH", "8"))


def engine_map_batches(
    engine, batches, depth: Optional[int] = None, method: str = "demux_batch"
):
    """Run ``engine.<method>`` over an iterator of (ids, seqs) batches
    with ``depth`` batches in flight on a worker thread.

    Device fetches release the GIL, so one batch's device round trips
    overlap another batch's host work (and each other, with two
    workers) — a simple software pipeline that hides most device
    latency.  Yields (ids, seqs, result) in order; ``method`` is
    ``demux_batch`` (per-read BarbellMatch lists) or
    ``demux_batch_table`` (columnar HitTable, the annotate hot path).
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    if depth is None:
        depth = DEFAULT_PIPELINE_DEPTH
    fn = getattr(engine, method)
    with ThreadPoolExecutor(max_workers=depth) as pool:
        inflight = deque()
        for ids, seqs in batches:
            inflight.append((ids, seqs, pool.submit(fn, ids, seqs)))
            while len(inflight) > depth:
                bids, bseqs, fut = inflight.popleft()
                yield bids, bseqs, fut.result()
        while inflight:
            bids, bseqs, fut = inflight.popleft()
            yield bids, bseqs, fut.result()


def _pow2_at_least(x: int, lo: int = 8) -> int:
    n = lo
    while n < x:
        n *= 2
    return n


def _retry_cap(total: int, h_cap: int) -> int:
    """Overflow-retry hit capacity: the measured total + 12.5% slack at
    a 256-granule (strand-split rank needs % 256 == 0), strictly above
    the failed cap.  The old rule doubled to the next pow2 >= 2*H_cap,
    which left NBD fetching a ~2x-oversized record buffer forever via
    the sticky hint."""
    return max(-(-(total + total // 8) // 256) * 256, h_cap + 256)


def _over_words(R: int) -> int:
    """int32 words of demux_call's packed overflow bitmask for R rows."""
    return (R + 31) // 32


def _over_rows(words: np.ndarray, R: int) -> np.ndarray:
    """Row indices flagged in the packed overflow bitmask."""
    bits = np.unpackbits(
        np.ascontiguousarray(words, dtype="<i4").view(np.uint8),
        bitorder="little",
    )[:R]
    return np.nonzero(bits)[0]


def _mantissa_bucket(x: int, lo: int) -> int:
    """Smallest m * 2**e >= x with m in [8, 16]: 1/8-octave size
    buckets bound padding waste at 12.5% where a pow2 bucket wastes up
    to 2x, at the cost of more distinct compiled shapes.  Results for
    x > lo are multiples of 2**(bit_length(x-1) - 4)."""
    if x <= lo:
        return lo
    e = (x - 1).bit_length() - 4
    return (-(-x >> e)) << e


# Row-count buckets default to pow2 (fewest compiled shapes; every new
# shape is a fresh compile).  BARBELL_FINE_ROWS=1 switches to
# 1/8-octave buckets: up to ~45% less padded device compute + fetch per
# batch once the shapes are compiled.
_FINE_ROWS = _os.environ.get("BARBELL_FINE_ROWS", "0") == "1"


#: Fused-step cost per DP cell (picoseconds) of the flank scan and the
#: barcode rank, fitted from ``scripts/row_width_probe.py`` on an H100
#: 80GB HBM3 (700 W limit): whole-read SQK-RBK114-96 batches at
#: L = 512..8192 (PERF.md).  Only their ratio steers ``_choose_L``.
_FLANK_CELL_PS = 1.3
_RANK_CELL_PS = 4.7


def _row_bucket(x: int, lo: int = 8, fine: Optional[bool] = None) -> int:
    if _FINE_ROWS if fine is None else fine:
        return _mantissa_bucket(x, lo)
    return _pow2_at_least(x, lo)


@dataclass
class _Row:
    strand: Strand
    read_idx: int
    offset: int  # text offset of this row's content within the read
    tsc: int  # text start column within the row
    tec: int  # text end column within the row
    true_start: bool  # row contains the read's true start (at tsc)
    true_end: bool  # row contains the read's true end (at tec)
    lo: int  # valid end-position range, column coords
    hi: int


class _ShardPlan:
    """Row plan for one device shard (or the whole batch, single-device).

    Host-row layout: ``[0, S)`` simple forward reads, ``[S, S + 2E)``
    ends-mode rows (prefix/suffix pairs of long reads, SURVEY §5.7),
    ``[S + 2E, R_host)`` long-read chunk rows.  Rows ``[0, S + 2E)``
    get device-synthesized rc twins (F = S + 2E flip rows); chunk rows
    ship both strands from the host."""

    __slots__ = (
        "rows_meta", "simple_reads", "ends_reads", "fwd_cover",
        "long_reads", "long_content", "R_host", "S", "E", "F",
    )


class _Mat:
    """One shard's materialized host arrays (see _materialize)."""

    __slots__ = (
        "host_packed", "row_start", "exc", "pack_mode", "simple_idx",
        "meta", "row_read", "rowdesc", "chunk_meta",
    )


class _GroupPlan:
    """Per-group compiled constants."""

    def __init__(self, group: BarcodeGroup):
        if group.k_cutoff is None:
            raise ValueError("BarcodeGroup needs a flank threshold before demuxing")
        self.group = group
        self.flank = np.asarray(group.flank_masks, dtype=np.uint8)
        self.m = len(self.flank)
        self.k_units = int(group.k_cutoff)
        self.k_scaled = oracle.scale_k(self.k_units)
        self.span = oracle.flank_window_span(self.m, self.k_units)
        self.plen = group.pattern_len
        self.k1_scaled = oracle.scale_k(int(self.plen * BARCODE_K_FRAC))
        self.mask_start, self.mask_end = group.bar_region
        pad_start, _ = group.pad_region
        self.rel_bar_start = self.mask_start - pad_start
        self.rel_bar_end = self.mask_end - pad_start
        mask_len = self.mask_end - self.mask_start + 1
        self.barcode_window = mask_len + self.k_units + 2 * PADDING + 2
        self.patw, self.W_words, self.top_bit = pattern_words(self.flank)
        self.perfect = perfect_score(group.pad_region[1] - group.pad_region[0])
        self.patterns = {
            Strand.Fwd: np.asarray(group.patterns_fwd, dtype=np.uint8),
            Strand.Rc: np.asarray(group.patterns_rc, dtype=np.uint8),
        }
        self.n_patterns = self.patterns[Strand.Fwd].shape[0]
        self.patterns_all = np.concatenate(
            [self.patterns[Strand.Fwd], self.patterns[Strand.Rc]], axis=0
        )
        # hit-table constants (vectorized assembly)
        self.bar_mtype_codes = np.array(
            [hittable.MTYPE_CODE[b.match_type] for b in group.barcodes],
            dtype=np.int64,
        )
        self.flank_code = hittable.MTYPE_CODE[
            group.barcodes[0].match_type.as_flank()
        ]
        self.flank_cost_len = len(group.barcodes[0].seq)
        self.label_base = 0  # set by the engine (global label vocabulary)
        # Device-resident copies (set by the engine: one upload at init
        # instead of a re-transfer on every batch).
        self.flank_dev = None
        self.patw_dev = None
        self.patterns_dev: Dict[Strand, object] = {}
        self.patterns_all_dev = None


class JaxDemuxEngine:
    def __init__(
        self,
        groups: Sequence[BarcodeGroup],
        alpha: float = 0.4,
        min_score: float = 0.2,
        min_score_diff: float = 0.1,
        max_row_len: int = MAX_ROW_LEN,
        max_hits_per_row: int = MAX_HITS_PER_ROW,
        kernels: Optional[kern.Kernels] = None,
        devices: Optional[Sequence] = None,
        fine_rows: Optional[bool] = None,
        mono_upload: Optional[bool] = None,
        ends_window=None,  # int (symmetric) | (W_left, W_right) | None
        meta_mode: Optional[str] = None,
        cat_align: Optional[int] = None,
    ):
        from ..utils.jaxcache import enable_compilation_cache

        enable_compilation_cache()  # must precede the first compile
        import jax  # deferred so the oracle path works without jax

        self._jax = jax
        self._jnp = jax.numpy
        self.groups = list(groups)
        self.alpha = float(alpha)
        if not 0.0 <= self.alpha <= 1.0:
            # the jnp flank scan can route left-overhang through
            # zero-mask padding at UNIT cost, undercutting the oracle
            # whenever alpha > 1 — reject instead of silently diverging
            raise ValueError(f"alpha must be in [0, 1], got {self.alpha}")
        self.alpha_scaled = oracle.scale_alpha(alpha)
        self.min_score = float(min_score)
        self.min_score_diff = float(min_score_diff)
        if max_row_len < 4:
            raise ValueError(f"max_row_len must be >= 4, got {max_row_len}")
        if max_row_len % 4:
            # packers allocate L//2 (nibble) / L//4 (2-bit) bytes — a
            # non-multiple-of-4 row width would silently truncate the
            # last bases of max-width reads
            raise ValueError(
                f"max_row_len must be a multiple of 4, got {max_row_len}"
            )
        self.max_row_len = max_row_len
        self.K = max_hits_per_row
        self.plans = [_GroupPlan(g) for g in self.groups]
        for p in self.plans:
            p.flank_dev = jax.numpy.asarray(p.flank)
            p.patw_dev = jax.numpy.asarray(p.patw)
            p.patterns_dev = {
                s: jax.numpy.asarray(p.patterns[s])
                for s in (Strand.Fwd, Strand.Rc)
            }
            p.patterns_all_dev = jax.numpy.asarray(p.patterns_all)
        self.halo = max(p.span for p in self.plans) + PADDING + 2
        self._fallback: Optional[Demuxer] = None
        # Sticky hit-record capacity: H_cap starts at the padded row
        # count (>= 1 hit/row), but workloads with constructs at BOTH
        # ends (NBD) produce ~2 raw hits/read — just over that cap, so
        # every batch paid a serialized overflow retry (a second full
        # device round trip).  The first overflow raises this hint and
        # all later batches dispatch at the bigger cap directly.
        self._h_cap_hint = 0

        # Global label vocabulary for hit tables: every group's barcode
        # labels in plan order, then the shared "flank" sentinel.
        self.labels: List[str] = []
        for p in self.plans:
            p.label_base = len(self.labels)
            self.labels.extend(b.label for b in p.group.barcodes)
        self.flank_label = len(self.labels)
        self.labels.append("flank")
        self._label_index = {lab: i for i, lab in enumerate(self.labels)}

        # Multi-chip: a 1-D reads mesh over all local devices.  Each
        # batch's reads partition into per-device row blocks (whole
        # reads stay on one shard — chunk rows gather barcode windows
        # from sibling rows) and every group's fused call runs as ONE
        # shard_map'd step; query tensors replicate, hit records stay
        # sharded with their rows.  Single-device hosts keep the plain
        # path with zero overhead.
        if devices is None:
            devices = jax.devices()
        self.devices = list(devices)
        self.mesh = None
        self.last_dispatch: Optional[str] = None
        self._sharded_steps: Dict[tuple, object] = {}
        if len(self.devices) > 1:
            from ..parallel.mesh import make_mesh

            self.mesh = make_mesh(self.devices)

        # Kernel choice from the platform the engine runs on: Triton
        # kernels on the GPU, jnp twins on the CPU, an error elsewhere.
        # Tests ask for the interpreter by passing kernels=INTERPRET.
        platform = self.devices[0].platform
        if kernels is None:
            kernels = kern.for_platform(platform)
        kern.check_platform(kernels, platform)
        self.kernels = kernels
        #: reads resolved on the host by the scalar engine (valley or
        #: hit-lane overflow); locked — batches run on worker threads
        self.host_resolved = 0
        self._host_lock = _threading.Lock()
        # Batches fuse every per-batch host array into ONE uint8 upload
        # (comp.demux_call_mono; [D, blob] on the sharded path): one
        # transfer per batch instead of five small ones.
        # BARBELL_MONO_UPLOAD=0 restores separate uploads (debug aid).
        self.mono_upload = (
            _os.environ.get("BARBELL_MONO_UPLOAD", "1") != "0"
            if mono_upload is None
            else bool(mono_upload)
        )
        # Row-count bucket granularity (see _row_bucket); per-engine so
        # interleaved A/B benches can compare both in one process.
        self.fine_rows = _FINE_ROWS if fine_rows is None else bool(fine_rows)
        # Valley keys (cost_scaled*(L+2)+col) must stay below the BIG
        # sentinel (2**30) on BOTH the kernel and jnp paths, or valid
        # hits silently read as invalid.  Long flanks (large k) shrink
        # the row width until keys fit; impossible fits are an error,
        # never silent truncation.
        max_k_scaled = max(p.k_units for p in self.plans) * oracle.COST_SCALE
        while (
            self.max_row_len > 256
            and max_k_scaled * (self.max_row_len + 2) + self.max_row_len
            >= 2**30
        ):
            self.max_row_len //= 2
        if max_k_scaled * (self.max_row_len + 2) + self.max_row_len >= 2**30:
            raise ValueError(
                f"flank threshold too large for valley keys: k_scaled="
                f"{max_k_scaled} needs rows shorter than 256"
            )
        if self.max_row_len <= self.halo + PADDING + 2:
            raise ValueError(
                f"row width {self.max_row_len} (shrunk for valley-key "
                f"headroom) cannot hold the flank halo {self.halo}"
            )

        # Ends-only fast path (SURVEY §5.7): reads longer than
        # max(W, L) ship ONLY their first W_l / last W_r bases as two
        # forward rows (rc twins synthesized on device, like simple
        # reads) — the structural wire cut for kit-preset demux, whose
        # filter patterns positionally reject mid-read hits anyway.
        # The windows may be per-side asymmetric (`@prev_left` chains
        # anchor left, so only the prefix needs the chained depth); the
        # claim ranges tile at C = max(n-W_r+halo+1, W_l-PADDING):
        # hits with end positions in [0, W_l-1-PADDING] or [C, n] are
        # byte-identical to the full scan, so reads up to
        # W_l+W_r-halo-PADDING-1 are covered COMPLETELY (the windows
        # overlap mid-read) and only longer reads skip their middle
        # (documented mode — see stages/kit.ends_plan_for_patterns for
        # the preset-derived widths).
        if ends_window:
            if isinstance(ends_window, (tuple, list)):
                wl, wr = int(ends_window[0]), int(ends_window[1])
            else:
                wl = wr = int(ends_window)
        else:
            wl = wr = 0
        if (wl > 0) != (wr > 0):
            raise ValueError(
                f"ends windows must both be set or both unset, got "
                f"({wl}, {wr})"
            )
        self.ends_wl, self.ends_wr = wl, wr
        #: max per-side width: row-width / ends-cut decisions use it
        self.ends_window = max(wl, wr)
        if self.ends_window:
            for W in (wl, wr):
                if W <= self.halo + PADDING + 2:
                    raise ValueError(
                        f"ends window {W} must exceed halo+padding "
                        f"({self.halo + PADDING + 2})"
                    )
                if W > self.max_row_len:
                    raise ValueError(
                        f"ends window {W} needs rows of W <= max_row_len "
                        f"({self.max_row_len})"
                    )
        # Wire meta mode: 'desc' derives per-row metadata + byte starts
        # on device from a 4-byte/row descriptor (pack_mode 2 only;
        # ~24B -> 4B per row of upload); 'wire' uploads the packed meta
        # rows.  BARBELL_META_MODE=wire restores the old
        # layout for debugging/A-B.
        if meta_mode is None:
            meta_mode = _os.environ.get("BARBELL_META_MODE", "desc")
        if meta_mode not in ("wire", "desc"):
            raise ValueError(f"meta_mode must be 'wire' or 'desc', got {meta_mode!r}")
        self.meta_mode = meta_mode
        # Concatenated-row byte alignment: smaller alignment trades
        # per-row padding waste for more gather slab indices.  64 is
        # the default (BARBELL_CAT_ALIGN picks 16/32/64/128 for A/Bs).
        if cat_align is None:
            cat_align = int(_os.environ.get("BARBELL_CAT_ALIGN", "64"))
        if cat_align not in (16, 32, 64, 128):
            raise ValueError(
                f"cat_align must be one of 16/32/64/128, got {cat_align}"
            )
        self.cat_align = cat_align

    # ------------------------------------------------------------------

    def _scalar_fallback(self) -> Demuxer:
        if self._fallback is None:
            d = Demuxer(
                alpha=self.alpha,
                min_score=self.min_score,
                min_score_diff=self.min_score_diff,
            )
            for g in self.groups:
                d.add_query_group(g)
            self._fallback = d
        return self._fallback

    # ------------------------------------------------------------------

    def demux_batch(
        self, read_ids: List[str], seqs: List[bytes]
    ) -> List[List[BarbellMatch]]:
        """Per-read ``BarbellMatch`` lists (the object API); identical
        rows to the scalar engine, enforced by tests."""
        return hittable.table_to_matches(self.demux_batch_table(read_ids, seqs))

    def demux_batch_table(
        self, read_ids: List[str], seqs: List[bytes]
    ) -> HitTable:
        """One batch's annotation rows as a columnar :class:`HitTable`
        — the annotate hot path (no per-hit Python objects)."""
        jnp = self._jnp
        B = len(seqs)
        # bytes input (the native reader's output) is already the wire
        # form — the frombuffer+tobytes round trip is two copies of pure
        # GIL time per read
        seq_bytes = [
            s if type(s) is bytes else dna.seq_to_bytes(s).tobytes()
            for s in seqs
        ]
        lens = np.array([len(s) for s in seq_bytes], dtype=np.int64)
        if B == 0 or lens.max(initial=0) == 0:
            return hittable.empty_table(read_ids, lens, self.labels)

        L = self._choose_L(lens)
        step = L - PADDING - self.halo
        assert step > 0

        if self.mesh is not None and B > 1:
            return self._demux_batch_sharded(
                read_ids, seqs, seq_bytes, lens, L, step
            )

        self.last_dispatch = "single"
        plan = self._plan_shard(seq_bytes, lens, range(B), L, step)
        R_host_pad = _row_bucket(max(plan.R_host, 1), lo=8, fine=self.fine_rows)
        S_pad = _row_bucket(max(plan.F, 1), lo=8, fine=self.fine_rows)
        R_total_pad = R_host_pad + S_pad

        # Flat row indexing (gathers, exception scatter) is int32: keep
        # the padded row matrix under 2**31 elements by splitting
        # oversized batches (a batch of max-length chunked reads can
        # exceed it at large BATCH).
        if R_total_pad * L >= 2**31:
            if B == 1:
                return self._table_from_fallback(read_ids, seqs, lens)
            half = B // 2
            return self._concat_tables(
                self.demux_batch_table(read_ids[:half], seqs[:half]),
                self.demux_batch_table(read_ids[half:], seqs[half:]),
            )

        mat = self._materialize(plan, seq_bytes, lens, L, R_host_pad, S_pad)
        pack_mode, meta, row_read = mat.pack_mode, mat.meta, mat.row_read
        exc = mat.exc
        # Entries fill the exception list in order, so a sentinel at
        # index 64 means <= 64 real entries: upload the 64-entry prefix
        # instead of the 4096-entry worst case (real nanopore reads
        # rarely carry N/IUPAC bytes).
        if exc.shape[0] > 64 and exc[64, 0] == R_host_pad * L:
            exc = exc[:64]
        # Derived-metadata wire mode: a 4B/row descriptor replaces the
        # 24B/row packed meta + simple_idx + row_start uploads (needs
        # the 2-bit cat encoding; rowdesc packs lengths in 29 bits).
        desc = (
            self.meta_mode == "desc"
            and pack_mode == 2
            and int(lens.max()) < 1 << 29
        )
        extra = {"meta_mode": "desc", "S_pad": S_pad} if desc else None

        if self.mono_upload:
            # ONE transfer per batch (demux_call_mono slices the fused
            # buffer on device).
            with _phase("pack_upload"):
                if desc:
                    blob, spans = comp.build_blob_desc_np(
                        mat.host_packed, mat.rowdesc, mat.chunk_meta, exc
                    )
                else:
                    blob, spans = comp.build_blob_np(
                        mat.host_packed, mat.simple_idx,
                        comp.pack_meta_np(meta), exc, mat.row_start,
                    )
                dev_in = ("mono", jnp.asarray(blob), spans)
        else:
            with _phase("pack_upload"):
                if desc:
                    dev_in = (
                        "multi",
                        jnp.asarray(mat.host_packed),
                        jnp.asarray(mat.chunk_meta),
                        jnp.asarray(mat.rowdesc),
                        jnp.asarray(exc),
                        jnp.zeros(1, dtype=jnp.int32),
                    )
                else:
                    dev_in = (
                        "multi",
                        jnp.asarray(mat.host_packed),
                        jnp.asarray(mat.simple_idx),
                        jnp.asarray(comp.pack_meta_np(meta)),
                        jnp.asarray(exc),
                        jnp.asarray(mat.row_start),
                    )

        packets: List[tuple] = []  # (_GroupPlan, packet dict) in plan order
        overflow_reads: set = set()
        H_cap = self._h_cap(B, plan, R_total_pad)

        # Multi-group kits ride ONE fused device call on the mono blob
        # (a dispatch + fetch round trip per group per batch otherwise);
        # the single-group / separate-uploads path dispatches every
        # group before fetching any result so device work overlaps.
        pending = []
        if self.mono_upload and len(self.plans) > 1:
            self.last_dispatch = "single-fused"
            with _phase("demux_call.dispatch"):
                all_dev = self._dispatch_all_groups(
                    dev_in, pack_mode, L, step, H_cap, extra
                )
            with _phase("demux_call.fetch"):
                all_np = np.asarray(all_dev)
            off = 0
            nw = _over_words(R_total_pad)
            for gplan in self.plans:
                wcols, _ = self._rec_wire(gplan, L, R_total_pad)
                n = H_cap * wcols + nw + 1
                pending.append((gplan, all_np[off : off + n]))
                off += n
        else:
            for gplan in self.plans:
                with _phase("demux_call.dispatch"):
                    out_dev = self._dispatch_group(
                        gplan, dev_in, pack_mode, L, step, H_cap, extra
                    )
                pending.append((gplan, out_dev))

        for gplan, out_dev in pending:
            if isinstance(out_dev, np.ndarray):
                # fused path fetched everything in one transfer above;
                # keep the BARBELL_TIMING fetch phase free of no-ops
                out_np = out_dev
            else:
                with _phase("demux_call.fetch"):
                    out_np = np.asarray(out_dev)
            cap = H_cap
            wcols, wbits = self._rec_wire(gplan, L, R_total_pad)
            nw = _over_words(R_total_pad)
            rec = self._unpack_rec(out_np, cap, wcols, wbits)
            over = out_np[cap * wcols : cap * wcols + nw]
            total = int(out_np[-1])
            if total > cap:
                # Hit-dense batch (many constructs per read): one retry
                # at a larger static capacity (sticky — later batches
                # start there), then whole-batch fallback.
                cap = _retry_cap(total, H_cap)
                self._h_cap_hint = max(self._h_cap_hint, cap)
                out_np = np.asarray(
                    self._dispatch_group(
                        gplan, dev_in, pack_mode, L, step, cap, extra
                    )
                )
                rec = self._unpack_rec(out_np, cap, wcols, wbits)
                over = out_np[cap * wcols : cap * wcols + nw]
                total = int(out_np[-1])
                if total > cap:
                    overflow_reads.update(range(B))
                    continue
            for r in _over_rows(over, R_total_pad):
                if row_read[r] >= 0:
                    overflow_reads.add(int(row_read[r]))
            with _phase("assemble.host"):
                pkt = self._gather_packet(rec, row_read, meta)
                if pkt is not None:
                    packets.append((gplan, pkt))

        with _phase("assemble.host"):
            return self._finish_table(
                read_ids, seqs, lens, packets, overflow_reads
            )

    # ------------------------------------------------------------------

    def _choose_L(self, lens: np.ndarray) -> int:
        """Row width minimizing estimated batch cost, not just fitting
        the longest read.

        The old max-length pow2 rule let ONE 4.2kb read in a 2048-read
        batch double EVERY row's padded width (4096 -> 8192): ~2x padded
        device cells and hit-record fetch rows for the whole batch,
        where chunking that read costs 4 extra rows.  Candidates stay
        pow2 (same compiled-shape universe as before; every new shape
        is a fresh compile).

        Cost model per candidate: the fused step's DP cells, counted
        from shapes and weighted by their measured cost — the flank
        scan's rows x L x m plus the barcode rank's 2P x plen x Wb per
        hit lane, with one lane per padded row (the full-scan H_cap);
        chunk rows carry BOTH strands (simple rows get their rc twin
        synthesized on device).  BARBELL_AUTO_L=0 restores the
        max-length rule."""
        lmax = int(lens.max())
        if self.ends_window:
            # Ends mode: L = pow2(min(lmax, W)) — reads <= L ship whole
            # (they ARE their own ends), longer reads become two W-wide
            # end rows that each fill a whole row (a W-wide window in a
            # 2W row would be 50% padded device cells).  Reads in
            # (W, 2W) pay ~2W shipped bases instead of n (the two
            # windows overlap mid-read but their claim ranges tile
            # exactly — see _materialize) for ~half the padded cells.
            eff = min(max(lmax, self.halo + PADDING + 3), self.ends_window)
            return min(_pow2_at_least(eff, lo=256), self.max_row_len)
        top = min(
            _pow2_at_least(max(lmax, self.halo + PADDING + 3), lo=256),
            self.max_row_len,
        )
        if _os.environ.get("BARBELL_AUTO_L", "1") == "0":
            return top
        n = lens[lens > 0]
        flank_m = sum(p.m for p in self.plans)
        rank_cells = sum(
            2 * p.n_patterns * p.plen * p.barcode_window for p in self.plans
        )
        best_L, best_cost = top, None
        L = top
        while L >= 256 and L > self.halo + PADDING + 2:
            step = L - PADDING - self.halo
            long_lens = n[n > L]
            n_simple = int(n.size - long_lens.size)
            nchunks = 1 + (long_lens - L + step - 1) // step
            rows_long = int(2 * nchunks.sum())
            R_host_pad = _row_bucket(
                max(n_simple + rows_long, 1), lo=8, fine=self.fine_rows
            )
            S_pad = _row_bucket(max(n_simple, 1), lo=8, fine=self.fine_rows)
            cost = (R_host_pad + S_pad) * (
                _FLANK_CELL_PS * L * flank_m + _RANK_CELL_PS * rank_cells
            )
            # A smaller L must win by >=5%: chunked reads carry
            # unmodeled host-side encode cost, so near-ties keep the
            # larger width (fewer chunk rows, fewer live shapes).
            if best_cost is None or cost < best_cost * 0.95:
                best_L, best_cost = L, cost
            L //= 2
        return best_L

    def _plan_shard(self, seq_bytes, lens, read_indices, L: int, step: int):
        """Row plan for one device shard: fwd simple rows first, then
        ends-mode prefix/suffix row pairs, then fwd+rc chunk rows of
        long reads.  All row indices are shard-local; read indices stay
        global."""
        plan = _ShardPlan()
        # rows [0, S) are the simple reads, one fwd row each, fully
        # described by (read_idx, len) — no per-row object (a _Row per
        # simple read is GIL time on the pipelined hot path).
        # rows_meta holds ONLY the long-read chunk rows [F, R_host).
        rows_meta: List[_Row] = []
        simple_reads: List[int] = []
        ends_reads: List[int] = []
        fwd_cover: Dict[int, List[Tuple[int, int]]] = {}

        # --- simple reads (fit one row; raw bytes, native-encoded) -----
        # Ends mode: reads longer than max(L, W) ship only their end
        # windows (overlapping mid-read when n < 2W; the claim ranges
        # tile exactly — see _materialize); the chunk path stays for
        # the L < n <= W corner (possible only when max_row_len clamps
        # L below W — the whole read is then within W of an end and the
        # full chunk scan is equivalent).
        ends_cut = max(L, self.ends_window) if self.ends_window else None
        long_reads: List[int] = []
        for ridx in read_indices:
            n = lens[ridx]
            if n == 0:
                continue
            if ends_cut is not None and n > ends_cut:
                ends_reads.append(ridx)
            elif n > L:
                long_reads.append(ridx)
            else:
                simple_reads.append(ridx)
        S = len(simple_reads)
        E = len(ends_reads)
        F = S + 2 * E

        # --- long reads: host-built fwd + rc chunk rows ----------------
        def chunk_spans(n: int):
            out = []
            offset = 0
            while True:
                if offset + L >= n:
                    out.append((offset, n - offset, offset == 0, True))
                    return out
                out.append((offset, L, offset == 0, False))
                offset += step

        for ridx in long_reads:
            n = int(lens[ridx])
            spans = chunk_spans(n)
            cover = []
            for strand in (Strand.Fwd, Strand.Rc):
                for offset, length, is_first, is_last in spans:
                    if strand is Strand.Fwd:
                        cover.append((offset, F + len(rows_meta)))
                    lo = 0 if is_first else self.halo + 1
                    hi = length if is_last else L - 1 - PADDING
                    rows_meta.append(
                        _Row(strand, ridx, offset, 0, length, is_first, is_last, lo, hi)
                    )
            fwd_cover[ridx] = cover

        plan.rows_meta = rows_meta
        plan.simple_reads = simple_reads
        plan.ends_reads = ends_reads
        plan.fwd_cover = fwd_cover
        plan.long_reads = long_reads
        # chunk-row byte content: encoded natively straight from the raw
        # read bytes (bbio_encode_pack2_chunks); _long_content
        # materializes the numpy form lazily for the fallback paths
        plan.long_content = None
        plan.R_host = F + len(rows_meta)
        plan.S = S
        plan.E = E
        plan.F = F
        return plan

    @staticmethod
    def _long_content(plan, seq_bytes) -> List[np.ndarray]:
        """Chunk-row 4-bit mask arrays for ``plan``, materialized on
        demand (nibble fallback / hosts without the native extension;
        the hot path encodes chunk rows natively from raw bytes)."""
        if plan.long_content is None:
            with _phase("encode"):
                content: List[np.ndarray] = []
                per_read: Dict[int, List] = {r: [] for r in plan.long_reads}
                for rowm in plan.rows_meta:
                    per_read[rowm.read_idx].append(rowm)
                for ridx in plan.long_reads:
                    arr = dna.encode(seq_bytes[ridx])
                    rc_arr = dna.reverse_complement_masks(arr)
                    for rowm in per_read[ridx]:
                        text = rc_arr if rowm.strand is Strand.Rc else arr
                        content.append(
                            text[rowm.offset : rowm.offset + rowm.tec]
                        )
                plan.long_content = content
        return plan.long_content

    def _materialize(
        self, plan, seq_bytes, lens, L: int, R_host_pad: int, S_pad: int,
        force_nibble: bool = False, C_pad: Optional[int] = None,
    ) -> "_Mat":
        """Materialize one shard's host arrays.  Pure w.r.t. the plan
        (safe to call twice, e.g. for a nibble re-pack)."""
        R_total_pad = R_host_pad + S_pad
        with _phase("encode"):
            host_packed, row_start, exc, pack_mode = self._pack_host_rows(
                seq_bytes, plan, R_host_pad, L, force_nibble=force_nibble,
            )

        meta = np.zeros((R_total_pad, comp.META_COLS), dtype=np.int32)
        meta[:, comp.M_HI] = -1
        row_read = np.full(R_total_pad, -1, dtype=np.int64)
        simple_idx = np.zeros(S_pad, dtype=np.int32)
        rowdesc = np.zeros(R_host_pad, dtype=np.int32)

        # Simple reads fill rows [0, S) (fwd, appended first by
        # _plan_shard) and [R_host_pad, R_host_pad + S) (their rc
        # twins): per-batch ~2*BATCH rows, built as column-vector ops —
        # a per-row Python loop here would sit squarely on the
        # pipelined hot path.
        S, E, F = plan.S, plan.E, plan.F
        simple_idx[:F] = np.arange(F, dtype=np.int32)
        if S:
            sr = np.asarray(plan.simple_reads, dtype=np.int64)
            ns = np.asarray(lens, dtype=np.int64)[sr].astype(np.int32)
            idx = np.arange(S, dtype=np.int32)
            fwd = meta[:S]
            fwd[:, comp.M_TEC] = ns
            fwd[:, comp.M_TSTART] = 1
            fwd[:, comp.M_TEND] = 1
            fwd[:, comp.M_HI] = ns
            fwd[:, comp.M_N] = ns
            fwd[:, comp.M_FSIMPLE] = idx
            fwd[:, comp.M_NCHUNKS] = 1
            rc = meta[R_host_pad : R_host_pad + S]
            rc[:, comp.M_TSC] = L - ns
            rc[:, comp.M_TEC] = L
            rc[:, comp.M_TSTART] = 1
            rc[:, comp.M_TEND] = 1
            rc[:, comp.M_LO] = L - ns
            rc[:, comp.M_HI] = L
            rc[:, comp.M_N] = ns
            rc[:, comp.M_ISRC] = 1
            rc[:, comp.M_FSIMPLE] = idx
            rc[:, comp.M_NCHUNKS] = 1
            row_read[:S] = sr
            row_read[R_host_pad : R_host_pad + S] = sr
            rowdesc[:S] = ns << 2  # tag 0

        # Ends-mode rows [S, F): interleaved prefix/suffix pairs, plus
        # their on-device rc twins at [R_host_pad + S, R_host_pad + F).
        # The flip of the forward PREFIX is the rc-coordinate SUFFIX
        # window (and vice versa); both cover rows are the forward pair
        # (baserow = prefix row), selected on device by
        # ``bstart >= n - W_r``.  Claim partition: the prefix (width
        # W_l) claims end positions [0, W_l-1-PADDING], the suffix
        # (width W_r) [C, n] with C = max(n-W_r+halo+1, W_l-PADDING) —
        # for n < W_l+W_r the windows OVERLAP mid-read and C makes the
        # claims tile exactly (full coverage, identical rows to the
        # whole-read scan, up to n = W_l+W_r-halo-PADDING-1); beyond
        # that the middle is unscanned (the documented ends-mode
        # deviation).  C-(n-W_r) >= halo+1 always, so the suffix DP has
        # full left context at its first claim.  Must stay in lockstep
        # with composite._derive_meta (meta_mode='desc').
        if E:
            W_l, W_r = self.ends_wl, self.ends_wr
            er = np.asarray(plan.ends_reads, dtype=np.int64)
            ne = np.asarray(lens, dtype=np.int64)[er].astype(np.int32)
            suf_lo = np.maximum(self.halo + 1, W_l + W_r - PADDING - ne)
            rows_p = (S + 2 * np.arange(E, dtype=np.int64)).astype(np.int32)
            blk = np.zeros((2 * E, comp.META_COLS), dtype=np.int32)
            pre, suf = blk[0::2], blk[1::2]
            for half in (pre, suf):
                half[:, comp.M_N] = ne
                half[:, comp.M_FSIMPLE] = -1
                half[:, comp.M_BASEROW] = rows_p
                half[:, comp.M_NCHUNKS] = 2
                half[:, comp.M_ENDS] = 1
            pre[:, comp.M_TEC] = W_l
            pre[:, comp.M_TSTART] = 1
            pre[:, comp.M_HI] = W_l - 1 - PADDING
            suf[:, comp.M_TEC] = W_r
            suf[:, comp.M_TEND] = 1
            suf[:, comp.M_LO] = suf_lo
            suf[:, comp.M_HI] = W_r
            suf[:, comp.M_OFF] = ne - W_r
            meta[S:F] = blk

            tb = np.zeros((2 * E, comp.META_COLS), dtype=np.int32)
            tpre, tsuf = tb[0::2], tb[1::2]  # flips of fwd prefix/suffix
            for half in (tpre, tsuf):
                half[:, comp.M_TEC] = L
                half[:, comp.M_N] = ne
                half[:, comp.M_ISRC] = 1
                half[:, comp.M_FSIMPLE] = -1
                half[:, comp.M_BASEROW] = rows_p
                half[:, comp.M_NCHUNKS] = 2
                half[:, comp.M_ENDS] = 1
            tpre[:, comp.M_TSC] = L - W_l
            tpre[:, comp.M_TEND] = 1  # rc suffix window
            tpre[:, comp.M_LO] = (L - W_l) + suf_lo
            tpre[:, comp.M_HI] = L
            tpre[:, comp.M_OFF] = ne - W_l
            tsuf[:, comp.M_TSC] = L - W_r
            tsuf[:, comp.M_TSTART] = 1  # rc prefix window
            tsuf[:, comp.M_LO] = L - W_r
            tsuf[:, comp.M_HI] = L - 1 - PADDING
            meta[R_host_pad + S : R_host_pad + F] = tb

            er2 = np.repeat(er, 2)
            row_read[S:F] = er2
            row_read[R_host_pad + S : R_host_pad + F] = er2
            rowdesc[S:F:2] = (ne << 2) | 1
            rowdesc[S + 1 : F : 2] = (ne << 2) | 2

        # Long-read chunk rows [F, R_host): few per batch, loop is fine.
        n_chunks = len(plan.rows_meta)
        for mi in range(F, plan.R_host):
            rowm = plan.rows_meta[mi - F]
            ridx = rowm.read_idx
            cover = plan.fwd_cover[ridx]
            meta[mi] = (
                rowm.tsc,
                rowm.tec,
                int(rowm.true_start),
                int(rowm.true_end),
                rowm.lo,
                rowm.hi,
                rowm.offset,
                int(lens[ridx]),
                int(rowm.strand is Strand.Rc),
                -1,
                cover[0][1],
                len(cover),
                0,
            )
            row_read[mi] = ridx
        if n_chunks:
            rowdesc[F : F + n_chunks] = (
                np.arange(n_chunks, dtype=np.int32) << 2
            ) | 3
        if C_pad is None:
            C_pad = _row_bucket(max(n_chunks, 1), lo=8, fine=self.fine_rows)
        chunk_meta = np.zeros((C_pad, comp.META_WIRE_COLS), dtype=np.int32)
        if n_chunks:
            chunk_meta[:n_chunks] = comp.pack_meta_np(meta[F : F + n_chunks])

        mat = _Mat()
        mat.host_packed = host_packed
        mat.row_start = row_start
        mat.exc = exc
        mat.pack_mode = pack_mode
        mat.simple_idx = simple_idx
        mat.meta = meta
        mat.row_read = row_read
        mat.rowdesc = rowdesc
        mat.chunk_meta = chunk_meta
        return mat

    # ------------------------------------------------------------------
    # Multi-device path: shard the batch's reads over the mesh and run
    # every group's fused call as one shard_map'd step.

    def _partition_reads(self, lens, L: int, step: int, D: int):
        """Greedy balanced assignment of whole reads to D shards by row
        count (a read's chunk rows must share a shard: barcode windows
        gather from sibling chunk rows).  Deterministic."""
        B = len(lens)
        ends_cut = max(L, self.ends_window) if self.ends_window else None
        nrows = np.ones(B, dtype=np.int64)
        for r in range(B):
            n = int(lens[r])
            if ends_cut is not None and n > ends_cut:
                nrows[r] = 2  # two host end rows (+2 device twins)
            elif n > L:
                nrows[r] = 2 * (1 + -(-(n - L) // step))
        order = sorted(range(B), key=lambda r: (-nrows[r], r))
        loads = [0] * D
        buckets: List[List[int]] = [[] for _ in range(D)]
        for r in order:
            d = min(range(D), key=lambda i: (loads[i], i))
            buckets[d].append(r)
            loads[d] += int(nrows[r])
        for b in buckets:
            b.sort()
        return buckets

    def _demux_batch_sharded(
        self, read_ids, seqs, seq_bytes, lens, L: int, step: int
    ) -> HitTable:
        jax = self._jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import READS_AXIS

        self.last_dispatch = "sharded"
        B = len(seqs)
        D = len(self.devices)
        buckets = self._partition_reads(lens, L, step, D)
        plans = [
            self._plan_shard(seq_bytes, lens, bucket, L, step)
            for bucket in buckets
        ]
        R_host_pad = _row_bucket(
            max(max(p.R_host for p in plans), 1), lo=8, fine=self.fine_rows
        )
        S_pad = _row_bucket(
            max(max(p.F for p in plans), 1), lo=8, fine=self.fine_rows
        )
        C_pad = _row_bucket(
            max(max(len(p.rows_meta) for p in plans), 1),
            lo=8, fine=self.fine_rows,
        )
        R_total_pad = R_host_pad + S_pad
        if R_total_pad * L >= 2**31:
            half = B // 2
            return self._concat_tables(
                self.demux_batch_table(read_ids[:half], seqs[:half]),
                self.demux_batch_table(read_ids[half:], seqs[half:]),
            )

        mats = [
            self._materialize(
                p, seq_bytes, lens, L, R_host_pad, S_pad, C_pad=C_pad
            )
            for p in plans
        ]
        # pack_mode is static in the jitted step: one shard falling back
        # to nibbles re-packs every shard as nibbles.
        if len({m.pack_mode for m in mats}) > 1:
            mats = [
                self._materialize(
                    p, seq_bytes, lens, L, R_host_pad, S_pad,
                    force_nibble=True, C_pad=C_pad,
                )
                for p in plans
            ]
        pack_mode = mats[0].pack_mode

        metas = [m.meta for m in mats]
        row_reads = [m.row_read for m in mats]
        # pack-mode-2 shards pad their flat byte buffers to one length
        t_pad = (
            max(m.host_packed.shape[0] for m in mats) if pack_mode == 2 else 0
        )
        # Derived-metadata mode rides the mono blob only: the separate-
        # uploads debug path shards meta as a 2-D P(READS_AXIS, None)
        # array, which the 1-D rowdesc doesn't fit.
        desc = (
            self.meta_mode == "desc"
            and pack_mode == 2
            and self.mono_upload
            and int(lens.max()) < 1 << 29
        )
        extra = {"meta_mode": "desc", "S_pad": S_pad} if desc else None

        def put(arr):
            spec = P(READS_AXIS, *([None] * (arr.ndim - 1)))
            return jax.device_put(arr, NamedSharding(self.mesh, spec))

        if self.mono_upload:
            # One [D, blob_len] upload row per shard (the multi-chip
            # form of the fused mono blob; spans match across shards
            # because every shard pads to the same global shapes).
            with _phase("pack_upload"):
                blobs = []
                spans = None
                for m in mats:
                    hp = m.host_packed
                    if pack_mode == 2 and hp.shape[0] != t_pad:
                        hp = np.concatenate(
                            [hp, np.zeros(t_pad - hp.shape[0], dtype=np.uint8)]
                        )
                    if desc:
                        blob, spans = comp.build_blob_desc_np(
                            hp, m.rowdesc, m.chunk_meta, m.exc
                        )
                    else:
                        blob, spans = comp.build_blob_np(
                            hp, m.simple_idx, comp.pack_meta_np(m.meta),
                            m.exc, m.row_start,
                        )
                    blobs.append(blob)
                dev_in = ("mono", put(np.stack(blobs)), spans)
        else:
            with _phase("pack_upload"):
                if pack_mode == 2:
                    host_packed_g = np.zeros(D * t_pad, dtype=np.uint8)
                    for d, m in enumerate(mats):
                        host_packed_g[
                            d * t_pad : d * t_pad + m.host_packed.shape[0]
                        ] = m.host_packed
                else:
                    host_packed_g = np.concatenate(
                        [m.host_packed for m in mats], axis=0
                    )
                dev_in = (
                    "multi",
                    put(host_packed_g),
                    put(np.concatenate([m.simple_idx for m in mats])),
                    put(comp.pack_meta_np(np.concatenate(metas, axis=0))),
                    put(np.concatenate([m.exc for m in mats], axis=0)),
                    put(np.concatenate([m.row_start for m in mats])),
                )

        packets: List[tuple] = []  # (_GroupPlan, packet) group-major
        overflow_reads: set = set()
        if self.ends_window:
            # per-shard lanes at 1.25/read (+ chunk rows), 256-granule —
            # see _h_cap
            lanes = max(
                len(b) + len(b) // 4 + 2 * len(p.rows_meta) + 16
                for b, p in zip(buckets, plans)
            )
            H_cap = max(-(-lanes // 256) * 256, self._h_cap_hint)
        else:
            H_cap = max(R_total_pad, self._h_cap_hint)

        pending = []
        if dev_in[0] == "mono" and len(self.plans) > 1:
            # Multi-group kits: ONE shard_map'd fused call + ONE fetch
            # per batch (per-group dispatch/fetch round trips otherwise
            # — the single-chip design rule, kept on multi-chip).
            self.last_dispatch = "sharded-fused"
            with _phase("demux_call.dispatch"):
                all_dev = self._dispatch_all_groups_sharded(
                    dev_in, pack_mode, L, step, H_cap, extra
                )
            with _phase("demux_call.fetch"):
                all_np = np.asarray(all_dev)
            sizes = [
                H_cap * self._rec_wire(g, L, R_total_pad)[0]
                + _over_words(R_total_pad) + 1
                for g in self.plans
            ]
            T = sum(sizes)
            off = 0
            for gplan, n_g in zip(self.plans, sizes):
                g_np = np.concatenate(
                    [
                        all_np[d * T + off : d * T + off + n_g]
                        for d in range(D)
                    ]
                )
                pending.append((gplan, g_np))
                off += n_g
        else:
            for gplan in self.plans:
                with _phase("demux_call.dispatch"):
                    out_dev = self._dispatch_group_sharded(
                        gplan, dev_in, pack_mode, L, step, H_cap, extra
                    )
                pending.append((gplan, out_dev))

        for gplan, out_dev in pending:
            if isinstance(out_dev, np.ndarray):
                out_np = out_dev  # fused path fetched in one transfer
            else:
                with _phase("demux_call.fetch"):
                    out_np = np.asarray(out_dev)
            cap = H_cap
            wcols, wbits = self._rec_wire(gplan, L, R_total_pad)
            nw = _over_words(R_total_pad)
            per_shard = cap * wcols + nw + 1
            totals = [int(out_np[(d + 1) * per_shard - 1]) for d in range(D)]
            if max(totals) > cap:
                cap = _retry_cap(max(totals), H_cap)
                self._h_cap_hint = max(self._h_cap_hint, cap)
                out_np = np.asarray(
                    self._dispatch_group_sharded(
                        gplan, dev_in, pack_mode, L, step, cap, extra
                    )
                )
                per_shard = cap * wcols + nw + 1
                totals = [
                    int(out_np[(d + 1) * per_shard - 1]) for d in range(D)
                ]
                if max(totals) > cap:
                    overflow_reads.update(range(B))
                    continue
            for d in range(D):
                o = out_np[d * per_shard : (d + 1) * per_shard]
                rec = self._unpack_rec(o, cap, wcols, wbits)
                over = o[cap * wcols : cap * wcols + nw]
                for r in _over_rows(over, R_total_pad):
                    if row_reads[d][r] >= 0:
                        overflow_reads.add(int(row_reads[d][r]))
                with _phase("assemble.host"):
                    pkt = self._gather_packet(rec, row_reads[d], metas[d])
                    if pkt is not None:
                        # a read lives on exactly one shard, so
                        # group-major shard-minor append keeps each
                        # read's insertion order group-major
                        packets.append((gplan, pkt))

        with _phase("assemble.host"):
            return self._finish_table(
                read_ids, seqs, lens, packets, overflow_reads
            )

    def _dispatch_group_sharded(
        self, gplan: _GroupPlan, dev_in, pack_mode: int, L: int, step: int,
        H_cap: int, extra: Optional[dict] = None,
    ):
        statics = self._group_statics(gplan, pack_mode, L, step, H_cap, extra)
        if dev_in[0] == "mono":
            _, blob_dev, spans = dev_in
            key = ("mono", spans) + tuple(sorted(statics.items()))
            sstep = self._sharded_steps.get(key)
            if sstep is None:
                from ..parallel.mesh import sharded_demux_step_mono

                sstep = sharded_demux_step_mono(
                    self.mesh, spans=spans, **statics
                )
                self._sharded_steps[key] = sstep
            out, _global_hits = sstep(
                gplan.flank_dev, gplan.patw_dev, gplan.patterns_all_dev,
                blob_dev,
            )
            return out
        (_, host_packed_dev, simple_idx_dev, meta_dev, exc_dev,
         row_start_dev) = dev_in
        key = tuple(sorted(statics.items()))
        sstep = self._sharded_steps.get(key)
        if sstep is None:
            from ..parallel.mesh import sharded_demux_step

            sstep = sharded_demux_step(self.mesh, **statics)
            self._sharded_steps[key] = sstep
        out, _global_hits = sstep(
            gplan.flank_dev,
            gplan.patw_dev,
            gplan.patterns_all_dev,
            host_packed_dev,
            simple_idx_dev,
            meta_dev,
            exc_dev,
            row_start_dev,
        )
        return out

    # ------------------------------------------------------------------

    @staticmethod
    def _simple_blob(seq_bytes, simple_reads):
        """Concatenate the simple reads into one bytes blob with int64
        offsets and int32 lengths for the native encoders (lengths via
        fromiter + cumsum, not a per-read Python accumulation loop)."""
        S = len(simple_reads)
        ls = np.fromiter(
            (len(seq_bytes[r]) for r in simple_reads), dtype=np.int32,
            count=S,
        )
        offs = np.zeros(S, dtype=np.int64)
        if S > 1:
            np.cumsum(ls[:-1], dtype=np.int64, out=offs[1:])
        blob = b"".join(seq_bytes[r] for r in simple_reads)
        return blob, offs, ls

    def _entry_blob(self, seq_bytes, plan):
        """Blob + per-entry (offs, lens) covering host rows [0, F):
        simple reads whole, then each ends read's prefix/suffix window
        slices — entry order == host row order, so the native encoders'
        exception positions (entry * L + col) land on the right rows."""
        S, E, F = plan.S, plan.E, plan.F
        W_l, W_r = self.ends_wl, self.ends_wr
        ls = np.zeros(F, dtype=np.int32)
        if S:
            ls[:S] = np.fromiter(
                (len(seq_bytes[r]) for r in plan.simple_reads),
                dtype=np.int32, count=S,
            )
        if E:
            ls[S:F:2] = W_l
            ls[S + 1 : F : 2] = W_r
        offs = np.zeros(F, dtype=np.int64)
        if F > 1:
            np.cumsum(ls[:-1], dtype=np.int64, out=offs[1:])
        parts = [seq_bytes[r] for r in plan.simple_reads]
        for r in plan.ends_reads:
            s = seq_bytes[r]
            parts.append(s[:W_l])
            parts.append(s[len(s) - W_r :])
        return b"".join(parts), offs, ls

    def _pack_host_rows(
        self, seq_bytes, plan, R_host_pad: int, L: int,
        force_nibble: bool = False,
    ):
        """-> (packed, row_start, exceptions, pack_mode).

        Preferred form (mode 2): concatenated 2-bit base codes — rows
        pack back to back so neither the 4x nibble blow-up nor row
        padding is uploaded (reads average ~56% of the
        padded row width).  Simple reads, ends-mode end windows AND
        long-read chunk rows all encode natively straight from the raw
        read bytes (bbio_encode_pack2_cat / bbio_encode_pack2_chunks —
        the per-read numpy chunk loop was the largest GIL-bound host
        phase per batch).  N/IUPAC/junk bytes ride an exception list
        the device applies after scattering rows into the padded
        layout.  Batches with more than _EXC_CAP exceptional bytes, or
        hosts without the native extension, fall back to nibble rows
        (mode 0)."""
        import ctypes

        from ..native import get_lib

        S, F = plan.S, plan.F
        n_chunks = len(plan.rows_meta)
        lib = get_lib()
        mode_override = _os.environ.get("BARBELL_PACK_MODE")

        chunk = None

        def encode_chunks(out_buf, row_out_start, n_exc_in, exc) -> int:
            """Native fwd+rc chunk-row encode into ``out_buf``; returns
            the running exception count (may exceed _EXC_CAP)."""
            nonlocal chunk
            if chunk is None:
                rm = plan.rows_meta
                lmap = {r: i for i, r in enumerate(plan.long_reads)}
                chunk = self._simple_blob(seq_bytes, plan.long_reads) + (
                    np.fromiter(
                        (lmap[m.read_idx] for m in rm), dtype=np.int32,
                        count=n_chunks,
                    ),
                    np.fromiter(
                        (m.offset for m in rm), dtype=np.int64,
                        count=n_chunks,
                    ),
                    np.fromiter(
                        (m.strand is Strand.Rc for m in rm), dtype=np.uint8,
                        count=n_chunks,
                    ),
                    (np.arange(n_chunks, dtype=np.int64) + F) * L,
                )
            blob_l, offs_l, ls_l, row_rd, row_off, row_rc, row_base = chunk
            return lib.bbio_encode_pack2_chunks(
                blob_l,
                offs_l.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                ls_l.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                n_chunks,
                row_rd.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                row_off.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                chunk_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                row_rc.ctypes.data_as(ctypes.c_char_p),
                row_out_start.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                row_base.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                dna.CODE2_LUT.tobytes(),
                dna.ENCODE_LUT.tobytes(),
                dna.CODE2C_LUT.tobytes(),
                dna.MASKC_LUT.tobytes(),
                out_buf.ctypes.data_as(ctypes.c_char_p),
                exc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                n_exc_in,
                _EXC_CAP,
            )

        chunk_lens = np.fromiter(
            (m.tec for m in plan.rows_meta), dtype=np.int32, count=n_chunks
        )

        if lib is not None and not force_nibble and mode_override == "1":
            # 2-bit PADDED rows: +33% wire bytes vs the concatenated
            # form, but the device skips the per-row byte gather
            # (see composite._assemble_rows2cat).
            packed2 = np.zeros((R_host_pad, L // 4), dtype=np.uint8)
            exc = np.zeros((_EXC_CAP, 2), dtype=np.int32)
            exc[:, 0] = R_host_pad * L
            total_exc = 0
            ok = True
            if F:
                blob, offs, ls = self._entry_blob(seq_bytes, plan)
                total_exc = lib.bbio_encode_pack2_rows(
                    blob,
                    offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                    ls.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    F,
                    L,
                    dna.CODE2_LUT.tobytes(),
                    dna.ENCODE_LUT.tobytes(),
                    packed2.ctypes.data_as(ctypes.c_char_p),
                    exc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    _EXC_CAP,
                )
                ok = total_exc <= _EXC_CAP
            if ok and n_chunks:
                row_out = (np.arange(n_chunks, dtype=np.int64) + F) * (L // 4)
                total_exc = encode_chunks(packed2, row_out, total_exc, exc)
                ok = total_exc <= _EXC_CAP
            if ok:
                return packed2, np.zeros(R_host_pad, dtype=np.int32), exc, 1
        if lib is not None and not force_nibble and mode_override != "0":
            nb = np.zeros(R_host_pad, dtype=np.int64)
            blob = offs = ls = None
            if F:
                # hoisted: also feeds the byte counts below, vectorized
                # (a per-simple-read Python loop here is GIL time on
                # the hot path)
                blob, offs, ls = self._entry_blob(seq_bytes, plan)
                nb[:F] = (ls.astype(np.int64) + 3) // 4
            if n_chunks:
                nb[F : F + n_chunks] = (chunk_lens.astype(np.int64) + 3) // 4
            # Aligned row starts (cat_align bytes; ~+11% wire at 128)
            # let the device scatter rows with a cheap SLICE gather
            # instead of the per-element take (see
            # composite._assemble_rows2cat); the buffer keeps >= L/4
            # slack past the last row because every device-side row
            # read spans a full L/4 bytes.  meta_mode='desc' re-derives
            # these starts on device — same formula, keep in sync.
            A = self.cat_align
            stride = (nb + (A - 1)) // A * A
            starts = np.zeros(R_host_pad, dtype=np.int64)
            np.cumsum(stride[:-1], out=starts[1:])
            total = int(starts[-1] + nb[-1]) + L
            t_pad = _mantissa_bucket(total, _CAT_BUCKET)
            flat = np.zeros(t_pad, dtype=np.uint8)
            # (flat_pos, mask) pairs; sentinel pos = one past the padded
            # buffer, dropped by the device scatter.  demux_batch caps
            # R_host_pad * L below 2**31 so the sentinel fits int32.
            exc = np.zeros((_EXC_CAP, 2), dtype=np.int32)
            exc[:, 0] = R_host_pad * L
            total_exc = 0
            ok = True
            if F:
                total_exc = lib.bbio_encode_pack2_cat(
                    blob,
                    offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                    ls.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    starts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                    F,
                    L,
                    dna.CODE2_LUT.tobytes(),
                    dna.ENCODE_LUT.tobytes(),
                    flat.ctypes.data_as(ctypes.c_char_p),
                    exc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                    _EXC_CAP,
                )
                ok = total_exc <= _EXC_CAP
            if ok and n_chunks:
                total_exc = encode_chunks(
                    flat, starts[F : F + n_chunks], total_exc, exc
                )
                ok = total_exc <= _EXC_CAP
            if ok:
                return flat, starts.astype(np.int32), exc, 2

        # nibble fallback
        long_content = (
            self._long_content(plan, seq_bytes) if n_chunks else []
        )
        packed = np.zeros((R_host_pad, L // 2), dtype=np.uint8)
        if F and lib is not None:
            blob, offs, ls = self._entry_blob(seq_bytes, plan)
            lib.bbio_encode_pack_rows(
                blob,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                ls.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                F,
                L,
                dna.ENCODE_LUT.tobytes(),
                packed.ctypes.data_as(ctypes.c_char_p),
            )
        elif F:
            W_l, W_r = self.ends_wl, self.ends_wr
            entries = [seq_bytes[r] for r in plan.simple_reads]
            for r in plan.ends_reads:
                s = seq_bytes[r]
                entries.append(s[:W_l])
                entries.append(s[len(s) - W_r :])
            rows = np.zeros((F, L), dtype=np.uint8)
            for i, sb in enumerate(entries):
                e = dna.encode(sb)
                rows[i, : len(e)] = e
            packed[:F] = comp.pack_rows_np(rows)
        if long_content:
            rows = np.zeros((len(long_content), L), dtype=np.uint8)
            for i, content in enumerate(long_content):
                rows[i, : len(content)] = content
            packed[F : F + len(long_content)] = comp.pack_rows_np(rows)
        return (
            packed,
            np.zeros(R_host_pad, dtype=np.int32),
            np.zeros((1, 2), dtype=np.int32),
            0,
        )

    def _h_cap(self, B: int, plan, R_total_pad: int) -> int:
        """Initial hit-lane capacity.  Full scan: R_total_pad (>= 1
        lane/row, ~2/read — the round-1 heuristic).  Ends mode: raw hit
        density is per READ (~1.1/read for single-end kits), so lanes
        start at 1.25/read (+2 per chunk row), rounded to a 256-granule
        (the strand-split rank kernel needs H_cap % 256 == 0) — the
        packed hit records dominate the device->host fetch.
        Hit-dense workloads (NBD ~2/read) overflow ONCE and the sticky
        hint holds the measured cap for the rest of the process (the
        old 2/read estimate ALSO overflowed on NBD, then doubled to a
        2x-oversized pow2 cap)."""
        if not self.ends_window:
            return max(R_total_pad, self._h_cap_hint)
        lanes = B + B // 4 + 2 * len(plan.rows_meta) + 16
        return max(-(-lanes // 256) * 256, self._h_cap_hint)

    def _group_scalars(self, gplan: _GroupPlan, step: int):
        """(gi, gf) as STATIC tuples — group constants bake into the
        jitted executable instead of shipping two arrays per call."""
        gi = (
            int(self.alpha_scaled),
            int(gplan.mask_start),
            int(gplan.mask_end),
            int(gplan.k1_scaled),
            int(gplan.rel_bar_start),
            int(gplan.rel_bar_end),
            int(step),
        )
        gf = (
            float(np.float32(gplan.perfect)),
            float(np.float32(self.min_score)),
            float(np.float32(self.min_score_diff)),
        )
        return gi, gf

    def _rec_wire(self, gplan: _GroupPlan, L: int, R_total_pad: int):
        """(wire_cols, wbits) of the hit-record wire layout — must agree
        with demux_call's rec_wire_spec on the same statics."""
        wbits = comp.rec_wire_spec(
            L, R_total_pad, gplan.k_units, gplan.n_patterns, gplan.plen,
            gplan.barcode_window,
        )
        if wbits is None:
            return comp.REC_COLS, None
        return comp.REC_WIRE_COLS, wbits

    @staticmethod
    def _unpack_rec(out_np, cap, wcols, wbits):
        if wbits is None:
            return out_np[: cap * comp.REC_COLS].reshape(cap, comp.REC_COLS)
        return comp.unpack_rec_np(out_np, cap, wbits)

    def _group_statics(
        self, gplan: _GroupPlan, pack_mode: int, L: int, step: int,
        H_cap: int, extra: Optional[dict] = None,
    ) -> dict:
        gi, gf = self._group_scalars(gplan, step)
        d = dict(
            gi=gi,
            gf=gf,
            K=self.K,
            m=gplan.m,
            k_units=gplan.k_units,
            W_words=gplan.W_words,
            top_bit=gplan.top_bit,
            Wf=gplan.span,
            plen=gplan.plen,
            Wb=gplan.barcode_window,
            P=gplan.n_patterns,
            H_cap=H_cap,
            padding=PADDING,
            kernels=self.kernels,
            pack_mode=pack_mode,
            L_rows=L,
            ends_w=self.ends_wl,
            ends_wr=self.ends_wr,
            halo=self.halo,
            cat_align=self.cat_align,
            meta_mode="wire",
            S_pad=0,
        )
        if extra:
            d.update(extra)
        return d

    def _fused_statics(
        self, pack_mode: int, L: int, step: int, H_cap: int,
        extra: Optional[dict] = None,
    ):
        """(group_statics, common) static tuples for the fused
        all-groups call (single-chip demux_call_fused and the sharded
        step share this layout)."""
        common = dict(
            K=self.K, H_cap=H_cap, padding=PADDING,
            kernels=self.kernels,
            pack_mode=pack_mode, L_rows=L,
            ends_w=self.ends_wl, ends_wr=self.ends_wr, halo=self.halo,
            cat_align=self.cat_align, meta_mode="wire", S_pad=0,
        )
        if extra:
            common.update(extra)
        group_statics = []
        for gplan in self.plans:
            st = self._group_statics(gplan, pack_mode, L, step, H_cap, extra)
            group_statics.append(
                tuple(sorted((k, v) for k, v in st.items() if k not in common))
            )
        return tuple(group_statics), tuple(sorted(common.items()))

    def _group_args(self):
        return tuple(
            (g.flank_dev, g.patw_dev, g.patterns_all_dev)
            for g in self.plans
        )

    def _dispatch_all_groups(
        self, dev_in, pack_mode: int, L: int, step: int, H_cap: int,
        extra: Optional[dict] = None,
    ):
        """ONE device call covering every group on the mono blob (a
        dispatch + fetch round trip per group per batch otherwise)."""
        _, blob_dev, spans = dev_in
        group_statics, common = self._fused_statics(
            pack_mode, L, step, H_cap, extra
        )
        return comp.demux_call_fused(
            self._group_args(),
            blob_dev,
            spans=spans,
            group_statics=group_statics,
            common=common,
        )

    def _dispatch_all_groups_sharded(
        self, dev_in, pack_mode: int, L: int, step: int, H_cap: int,
        extra: Optional[dict] = None,
    ):
        """The sharded form of :meth:`_dispatch_all_groups`: every
        group's fused call in ONE shard_map'd step on the [D, blob]
        upload, so multi-group kits pay one dispatch + fetch per batch
        on multi-chip exactly as they do single-chip."""
        _, blob_dev, spans = dev_in
        group_statics, common = self._fused_statics(
            pack_mode, L, step, H_cap, extra
        )
        key = ("fused", spans, group_statics, common)
        sstep = self._sharded_steps.get(key)
        if sstep is None:
            from ..parallel.mesh import sharded_demux_step_fused

            sstep = sharded_demux_step_fused(
                self.mesh, spans=spans, group_statics=group_statics,
                common=common,
            )
            self._sharded_steps[key] = sstep
        out, _global_hits = sstep(self._group_args(), blob_dev)
        return out

    def _dispatch_group(
        self, gplan: _GroupPlan, dev_in, pack_mode: int, L: int, step: int,
        H_cap: int, extra: Optional[dict] = None,
    ):
        statics = self._group_statics(gplan, pack_mode, L, step, H_cap, extra)
        if dev_in[0] == "mono":
            _, blob_dev, spans = dev_in
            return comp.demux_call_mono(
                gplan.flank_dev, gplan.patw_dev, gplan.patterns_all_dev,
                blob_dev, spans=spans, **statics,
            )
        (_, host_packed_dev, simple_idx_dev, meta_dev, exc_dev,
         row_start_dev) = dev_in
        return comp.demux_call(
            gplan.flank_dev, gplan.patw_dev, gplan.patterns_all_dev,
            host_packed_dev, simple_idx_dev, meta_dev, exc_dev,
            row_start_dev, **statics,
        )

    @staticmethod
    def _gather_packet(rec, row_read, meta):
        """Raw hit arrays from one fused call's packed records, in the
        scalar engine's order: per read, fwd hits then rc hits, each by
        ascending end position (chunk dedup makes the key unique).
        Returns None when the call produced no hits."""
        lanes = np.nonzero(rec[:, comp.REC_HAS] == 1)[0]
        if lanes.size == 0:
            return None
        rows = rec[lanes, comp.REC_ROW]
        reads = row_read[rows]
        isrc = meta[rows, comp.M_ISRC]
        end_abs = (
            meta[rows, comp.M_OFF] + rec[lanes, comp.REC_COL] - meta[rows, comp.M_TSC]
        )
        order = np.lexsort((end_abs, isrc, reads))
        return dict(
            reads=reads[order],
            isrc=isrc[order].astype(np.int64),
            end=end_abs[order].astype(np.int64),
            rec=rec[lanes][order],
        )

    def _packet_columns(self, gplan: _GroupPlan, pkt, lens):
        """Vectorized BarbellMatch field math for one packet — the
        per-hit arithmetic `_gather_packet` left to do, exactly as the
        old object loop computed it (see hittable module docstring)."""
        rec = pkt["rec"]
        reads = pkt["reads"]
        isrc = pkt["isrc"]
        end = pkt["end"]
        n = lens[reads]
        fst = rec[:, comp.REC_FSTEXT].astype(np.int64)
        rc = isrc == 1
        fs = np.where(rc, n - end, fst)
        fe = np.where(rc, n - fst, end)
        SCALE = oracle.COST_SCALE
        fcost = (rec[:, comp.REC_COST].astype(np.int64) + SCALE // 2) // SCALE
        acc = rec[:, comp.REC_ACC] == 1
        if bool(np.any(acc & (rec[:, comp.REC_HASIV] == 0))):
            raise RuntimeError("No barcode match region found; unusual")
        bstart = rec[:, comp.REC_BSTART].astype(np.int64)
        top = rec[:, comp.REC_TOP].astype(np.int64) % gplan.n_patterns
        cols = {
            "reads": reads.astype(np.int64),
            "rel": hittable.rel_dist_vec(fs, n),
            "rsb": np.where(acc, bstart + rec[:, comp.REC_IVPJ], fs),
            "reb": np.where(acc, bstart + rec[:, comp.REC_IVEJ], fe),
            "rsf": fs,
            "ref": fe,
            "bs": np.where(acc, bstart + rec[:, comp.REC_IVPI], 0),
            "be": np.where(acc, bstart + rec[:, comp.REC_IVEI], 0),
            "mtype": np.where(
                acc, gplan.bar_mtype_codes[top], gplan.flank_code
            ),
            "fcost": fcost,
            "bcost": np.where(
                acc, rec[:, comp.REC_IVCOST].astype(np.int64),
                gplan.flank_cost_len,
            ),
            "label": np.where(acc, gplan.label_base + top, self.flank_label),
            "strand": isrc,
        }
        return cols

    def _finish_table(
        self, read_ids, seqs, lens, packets, overflow_reads
    ) -> HitTable:
        """Merge per-(group, shard) packets into the batch HitTable:
        restore per-read insertion order (group-major — packets are
        appended group-major and each is read-ascending), run the
        overlap collapse, and splice scalar-fallback rows for overflow
        reads."""
        col_sets = [
            self._packet_columns(gplan, pkt, lens) for gplan, pkt in packets
        ]
        if col_sets:
            cols = {
                c: np.concatenate([cs[c] for cs in col_sets])
                for c in hittable.COLUMNS
            }
            # stable sort by read: per read, packet (= group) order is
            # preserved — the object path's insertion order
            order = np.argsort(cols["reads"], kind="stable")
            cols = {c: v[order] for c, v in cols.items()}
            if overflow_reads:
                ok = ~np.isin(
                    cols["reads"], np.fromiter(overflow_reads, dtype=np.int64)
                )
                cols = {c: v[ok] for c, v in cols.items()}
            # collapse order: (read, flank start), stable over insertion
            order = np.lexsort((cols["rsf"], cols["reads"]))
            cols = {c: v[order] for c, v in cols.items()}
            # vectorized singleton check first: the per-hit Python loop
            # only runs over reads that actually have an overlapping
            # consecutive pair (rare — see collapse_candidate_rows)
            hot = hittable.collapse_candidate_rows(
                cols["reads"], cols["rsf"], cols["ref"], COLLAPSE_OVERLAP
            )
            if hot is not None:
                hot_idx = np.nonzero(hot)[0]
                keep_hot = hittable.collapse_keep_indices(
                    cols["reads"][hot_idx].tolist(),
                    cols["rsf"][hot_idx].tolist(),
                    cols["ref"][hot_idx].tolist(),
                    cols["mtype"][hot_idx].tolist(),
                    cols["fcost"][hot_idx].tolist(),
                    cols["bcost"][hot_idx].tolist(),
                    COLLAPSE_OVERLAP,
                )
                if len(keep_hot) != hot_idx.shape[0]:
                    keep = np.ones(cols["reads"].shape[0], dtype=bool)
                    keep[hot_idx] = False
                    keep[hot_idx[np.asarray(keep_hot, dtype=np.int64)]] = True
                    cols = {c: v[keep] for c, v in cols.items()}
        else:
            cols = {c: np.zeros(0, dtype=np.int64) for c in hittable.COLUMNS}

        if overflow_reads:
            with self._host_lock:
                self.host_resolved += len(overflow_reads)
            extra = []
            for ridx in sorted(overflow_reads):
                matches = self._scalar_fallback().demux(
                    read_ids[ridx], seqs[ridx]
                )
                if not matches:
                    continue
                fb = hittable.matches_to_columns(
                    ridx, matches, self._label_index
                )
                if fb is None:  # pragma: no cover - labels always in vocab
                    raise RuntimeError(
                        "scalar fallback produced a label outside the "
                        "engine vocabulary"
                    )
                extra.append(fb)
            if extra:
                cols = {
                    c: np.concatenate([cols[c]] + [e[c] for e in extra])
                    for c in hittable.COLUMNS
                }
                # a read is either all-fallback or all-device, so the
                # stable read sort keeps each side's internal order
                order = np.argsort(cols["reads"], kind="stable")
                cols = {c: v[order] for c, v in cols.items()}

        return HitTable(
            read_ids=read_ids,
            read_lens=np.asarray(lens, dtype=np.int64),
            cols=cols,
            labels=self.labels,
        )

    def _table_from_fallback(self, read_ids, seqs, lens) -> HitTable:
        return self._finish_table(
            read_ids, seqs, lens, [], set(range(len(seqs)))
        )

    @staticmethod
    def _concat_tables(a: HitTable, b: HitTable) -> HitTable:
        off = len(a.read_ids)
        cols = {
            c: np.concatenate(
                [a.cols[c], b.cols[c] + (off if c == "reads" else 0)]
            )
            for c in hittable.COLUMNS
        }
        return HitTable(
            read_ids=list(a.read_ids) + list(b.read_ids),
            read_lens=np.concatenate([a.read_lens, b.read_lens]),
            cols=cols,
            labels=a.labels,
        )
