"""Annotate stage: stream FASTQ reads through a demux engine to TSV.

Engine selection: ``backend='jax'`` (and the default ``'auto'``) uses
the batched device pipeline — GPU kernels on a GPU, the jnp twins on
the CPU in tests — and raises if it cannot start; ``backend='oracle'``
uses the scalar NumPy engine.  Each read's rows stay
contiguous in the output — filter/inspect group by consecutive
``read_id`` (reference `src/annotate/annotator.rs:103-119`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..models.barcodes import BarcodeGroup
from ..models.demux import Demuxer
from ..models.records import AnnotationWriter, BarcodeType
from ..ops.edit_model import get_edit_cut_off
from ..utils.fastx import split_fastq_header
from ..utils.fastx_native import iter_fastq_batches_auto
from ..utils.progress import ANNOTATE_METRICS, ProgressTracker


@dataclass
class AnnotateConfig:
    max_flank_errors: Optional[int] = None
    alpha: float = 0.4
    n_threads: int = 10  # batch-parallel on device; kept for CLI parity
    verbose: bool = False
    min_score: float = 0.2
    min_score_diff: float = 0.1
    use_extended: bool = False
    backend: str = "auto"  # 'auto' | 'jax' | 'oracle'
    batch_size: int = 2048
    # Multi-host record striping: (rank, world) — this process handles
    # records with stream_index %% world == rank.
    shard: Optional[tuple] = None
    # Ends-only fast path (SURVEY §5.7): long reads ship only their
    # first/last W bases (full coverage up to W_l+W_r-halo-PADDING-1;
    # the middle of longer reads is not scanned).  Accepts an int
    # (symmetric W), a (W_left, W_right) pair, or a two-tier
    # models.twotier.EndsPlan.  None = whole-read scan (the
    # reference-parity default for annotate); the kit runner derives
    # the plan from its preset patterns.
    ends_window: object = None


def _apply_flank_threshold(groups: Sequence[BarcodeGroup], config: AnnotateConfig):
    for group in groups:
        if config.max_flank_errors is not None:
            group.set_flank_threshold(config.max_flank_errors)
        else:
            k = get_edit_cut_off(group.get_effective_len())
            print(f"Auto edit flank cut off: {k}")
            group.set_flank_threshold(k)
    return groups


def _jax_engine(groups: Sequence[BarcodeGroup], config: AnnotateConfig):
    """Device engine for the config: plain full/ends scan, or the
    two-tier shallow+rescue engine when ``ends_window`` is an
    :class:`~barbell_tpu.models.twotier.EndsPlan` with a deep tier."""
    from ..models.pipeline import JaxDemuxEngine
    from ..models.twotier import EndsPlan, make_ends_engine

    kw = dict(
        alpha=config.alpha,
        min_score=config.min_score,
        min_score_diff=config.min_score_diff,
    )
    ew = config.ends_window
    if isinstance(ew, EndsPlan):
        return make_ends_engine(list(groups), ew, **kw)
    return JaxDemuxEngine(list(groups), ends_window=ew, **kw)


def _make_engine(groups: Sequence[BarcodeGroup], config: AnnotateConfig):
    backend = config.backend
    if backend in ("auto", "jax"):
        return _jax_engine(groups, config)
    if backend == "oracle":
        return _OracleEngine(groups, config)
    raise ValueError(f"Unknown annotate backend: {backend!r}")


class _OracleEngine:
    """Batch adapter over the scalar Demuxer."""

    def __init__(self, groups: Sequence[BarcodeGroup], config: AnnotateConfig):
        self._demuxer = Demuxer(
            alpha=config.alpha,
            verbose=config.verbose,
            min_score=config.min_score,
            min_score_diff=config.min_score_diff,
        )
        for group in groups:
            self._demuxer.add_query_group(group)

    def demux_batch(self, read_ids: List[str], seqs: List[bytes]):
        return [
            self._demuxer.demux(read_id, seq) for read_id, seq in zip(read_ids, seqs)
        ]


def annotate(
    read_files: Sequence[str],
    out_file: str,
    query_groups: Sequence[BarcodeGroup],
    config: AnnotateConfig,
) -> None:
    for i, group in enumerate(query_groups):
        print(f"{group.barcode_type.as_str()}: {i}")
        group.display(5)

    engine = _make_engine(query_groups, config)

    log_dir = os.path.dirname(out_file) or "."
    progress = ProgressTracker(
        ANNOTATE_METRICS,
        step="annotate" if config.verbose else None,
        log_dir=log_dir if config.verbose else None,
    )

    shard = config.shard
    from collections import deque

    # Sharded runs also write a ``<out>.idx`` sidecar of
    # ``stream_index<TAB>n_rows`` per processed read, so the merge can
    # interleave shards back into the exact single-host read order
    # (reads with zero annotation rows would otherwise desynchronize a
    # row-count-based merge).
    idx_queue: deque = deque()

    def batches():
        if shard is None:
            for batch in iter_fastq_batches_auto(read_files, config.batch_size):
                read_ids = [split_fastq_header(h)[0] for h, _s, _q in batch]
                seqs = [s for _h, s, _q in batch]
                yield read_ids, seqs
            return
        rank, world = shard
        idx = 0
        read_ids: list = []
        seqs: list = []
        idxs: list = []
        for batch in iter_fastq_batches_auto(read_files, config.batch_size):
            for h, s, _q in batch:
                if idx % world == rank:
                    read_ids.append(split_fastq_header(h)[0])
                    seqs.append(s)
                    idxs.append(idx)
                    if len(read_ids) >= config.batch_size:
                        idx_queue.append(idxs)
                        yield read_ids, seqs
                        read_ids, seqs, idxs = [], [], []
                idx += 1
        if read_ids:
            idx_queue.append(idxs)
            yield read_ids, seqs

    from ..models.pipeline import engine_map_batches

    # BARBELL_PROFILE_DIR=<dir> captures a JAX profiler trace of the
    # whole annotate stream (host + device timelines, viewable in
    # TensorBoard/XProf) alongside the BARBELL_TIMING phase counters.
    profile_dir = os.environ.get("BARBELL_PROFILE_DIR")
    if profile_dir:
        try:
            import jax

            jax.profiler.start_trace(profile_dir)
        except Exception:
            profile_dir = None

    # The device engine yields columnar HitTables (no per-hit Python
    # objects on the hot path); the oracle engine yields BarbellMatch
    # lists.  Both serialize to byte-identical TSV.
    table_mode = hasattr(engine, "demux_batch_table")
    method = "demux_batch_table" if table_mode else "demux_batch"

    sidecar = open(out_file + ".idx", "w") if shard is not None else None
    try:
        with open(out_file, "w") as fh:
            writer = AnnotationWriter(fh)
            for read_ids, _seqs, out in engine_map_batches(
                engine, batches(), method=method
            ):
                idxs = idx_queue.popleft() if shard is not None else None
                if table_mode:
                    from ..models.hittable import emit_tsv_lines

                    writer.write_lines(emit_tsv_lines(out))
                    counts = out.rows_per_read()
                    found = int((counts > 0).sum())
                    if sidecar is not None:
                        sidecar.write(
                            "".join(
                                f"{si}\t{c}\n"
                                for si, c in zip(idxs, counts.tolist())
                            )
                        )
                else:
                    rows = []
                    found = 0
                    for matches in out:
                        if matches:
                            found += 1
                            rows.extend(matches)
                    writer.write_rows(rows)
                    if sidecar is not None:
                        # one block write per batch (per-read writes are
                        # GIL time on the pipelined host path)
                        sidecar.write(
                            "".join(
                                f"{si}\t{len(m)}\n"
                                for si, m in zip(idxs, out)
                            )
                        )
                progress.add(0, len(read_ids))
                progress.add(1, found)
                progress.add(2, len(read_ids) - found)
                progress.refresh()
            writer.finish()
    finally:
        if sidecar is not None:
            sidecar.close()
        if profile_dir:
            try:
                import jax

                jax.profiler.stop_trace()
            except Exception:
                pass
    progress.finish("records")


def annotate_with_kit(
    read_files: Sequence[str], out_file: str, kit: str, config: AnnotateConfig
) -> None:
    groups = BarcodeGroup.from_kit(kit, config.use_extended)
    annotate(read_files, out_file, _apply_flank_threshold(groups, config), config)


def annotate_with_files(
    read_files: Sequence[str],
    query_files: Sequence[str],
    query_types: Sequence[BarcodeType],
    out_file: str,
    config: AnnotateConfig,
) -> None:
    if len(query_files) != len(query_types):
        raise ValueError(
            f"Expected the same number of query files and barcode types, got "
            f"{len(query_files)} query file(s) and {len(query_types)} barcode type(s)"
        )
    groups = [
        BarcodeGroup.from_fasta(path, qtype)
        for path, qtype in zip(query_files, query_types)
    ]
    annotate(read_files, out_file, _apply_flank_threshold(groups, config), config)


def annotate_with_groups(
    read_files: Sequence[str],
    out_file: str,
    query_groups: Sequence[BarcodeGroup],
    config: AnnotateConfig,
) -> None:
    annotate(read_files, out_file, _apply_flank_threshold(query_groups, config), config)
