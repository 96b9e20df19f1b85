"""Multi-card execution: 1-D data mesh over reads.

Demultiplexing is embarrassingly parallel per read, so the sharding
story is a single ``reads`` mesh axis over the local devices in their
listed order (the cards of one host are joined all to all, so no device
order is better than another): read-chunk rows are sharded across
cards, the query tensors (flank + barcode patterns) are replicated, and
the only collectives are ``psum`` reductions of hit counters (tiny).
Everything here is single-controller `jax.sharding` + `jax.shard_map`;
multi-host runs additionally shard input *files* per host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import device as dev

READS_AXIS = "reads"


def _shard_map(fn, mesh, in_specs, out_specs):
    # Varying-mesh-axes checking is off: the Triton pallas_calls inside
    # the step do not carry vma types.
    return jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (READS_AXIS,))


def shard_rows(mesh: Mesh, *arrays):
    """Place arrays with their leading axis sharded over the reads axis."""
    out = []
    for arr in arrays:
        spec = P(READS_AXIS, *([None] * (np.ndim(arr) - 1)))
        out.append(jax.device_put(arr, NamedSharding(mesh, spec)))
    return tuple(out)


def sharded_flank_step(mesh: Mesh, K: int = 16):
    """The sharded per-batch flank-scan step.

    Per shard: end-cost scan + valley extraction on the local rows;
    cross-chip: a `psum` of the rows-with-hits counter (the progress /
    histogram reduction — the only collective demux needs).  Hit arrays
    stay sharded with their rows.
    """

    def local_step(pattern, rows, start_col, end_col, lo, hi, k_scaled, alpha_scaled):
        ends = dev.flank_ends(pattern, rows, start_col, end_col, alpha_scaled)
        hits = dev.find_hits(ends, lo, hi, k_scaled, K)
        local_found = jnp.sum(hits.valid.any(axis=1).astype(jnp.int32))
        global_found = jax.lax.psum(local_found, READS_AXIS)
        return hits, global_found

    row = P(READS_AXIS)
    row2 = P(READS_AXIS, None)
    mapped = _shard_map(
        local_step,
        mesh,
        in_specs=(P(None), row2, row, row, row, row, P(), P()),
        out_specs=(
            dev.Hits(pos=row2, cost=row2, valid=row2, count=row),
            P(),
        ),
    )
    return jax.jit(mapped)


def sharded_demux_step(mesh: Mesh, **statics):
    """The FULL fused demux step sharded over the reads mesh.

    Each chip runs :func:`barbell_tpu.ops.composite.demux_call` on its
    local row block (row indices inside ``meta`` / ``simple_idx`` are
    shard-local, and the exception list is likewise per-shard with
    shard-local flat positions); query tensors and group scalars are
    replicated.  The packed per-hit records stay sharded with their
    rows; the only collective is a ``psum`` of the per-shard hit
    counters.  ``statics`` are demux_call's static kwargs (K, m,
    k_units, W_words, top_bit, Wf, plen, Wb, P, H_cap, padding,
    kernels, pack_mode, L_rows) — H_cap is the per-shard
    lane capacity.  ``host_packed`` is the row matrix for pack modes
    0/1 and the flat concatenated byte buffer (equal length per shard)
    for pack mode 2.
    """
    from ..ops import composite as comp

    def local_step(flank, patw, patterns_all, host_packed, simple_idx, meta,
                   exc, row_start):
        out = comp.demux_call(
            flank, patw, patterns_all, host_packed, simple_idx, meta,
            exc, row_start, **statics,
        )
        global_hits = jax.lax.psum(out[-1], READS_AXIS)
        return out, global_hits

    packed_spec = (
        P(READS_AXIS) if statics.get("pack_mode", 0) == 2
        else P(READS_AXIS, None)
    )
    mapped = _shard_map(
        local_step,
        mesh,
        in_specs=(
            P(None),
            P(None, None),
            P(None, None),
            packed_spec,
            P(READS_AXIS),
            P(READS_AXIS, None),
            P(READS_AXIS, None),
            P(READS_AXIS),
        ),
        out_specs=(P(READS_AXIS), P()),
    )
    return jax.jit(mapped)


def sharded_demux_step_fused(mesh: Mesh, *, spans, group_statics, common):
    """EVERY group's fused demux in ONE shard_map'd device call on the
    per-shard mono blobs — the multi-chip form of
    :func:`barbell_tpu.ops.composite.demux_call_fused`.  Multi-group
    kits (NBD front+rear custom runs, ``--use-extended``) otherwise pay
    a dispatch + fetch round trip per group per batch on every card —
    the per-call overhead the single-card fused call removes.  ``group_statics``/``common`` follow
    demux_call_fused; each shard's output is the plan-order
    concatenation of its groups' packed buffers."""
    from ..ops import composite as comp

    n_groups = len(group_statics)

    def local_step(group_args, blob):
        parts = comp._blob_parts(blob.reshape(-1), spans)
        outs = []
        for (flank, patw, patterns_all), st in zip(group_args, group_statics):
            outs.append(
                comp._call_from_parts(
                    flank, patw, patterns_all, parts,
                    **dict(st), **dict(common),
                )
            )
        out = jnp.concatenate(outs)
        global_hits = jax.lax.psum(
            sum(o[-1] for o in outs), READS_AXIS
        )
        return out, global_hits

    gspec = tuple(
        (P(None), P(None, None), P(None, None)) for _ in range(n_groups)
    )
    mapped = _shard_map(
        local_step,
        mesh,
        in_specs=(gspec, P(READS_AXIS, None)),
        out_specs=(P(READS_AXIS), P()),
    )
    return jax.jit(mapped)


def sharded_demux_step_mono(mesh: Mesh, *, spans, **statics):
    """:func:`sharded_demux_step` with each shard's five host arrays
    riding one row of a ``[n_devices, blob_len]`` uint8 upload — the
    multi-card form of :func:`barbell_tpu.ops.composite.demux_call_mono`
    (one transfer per batch instead of five).  ``spans`` is the
    shared blob layout; it is identical across shards because every
    shard pads its segments to the same global shapes."""
    from ..ops import composite as comp

    def local_step(flank, patw, patterns_all, blob):
        parts = comp._blob_parts(blob.reshape(-1), spans)
        out = comp._call_from_parts(
            flank, patw, patterns_all, parts, **statics
        )
        global_hits = jax.lax.psum(out[-1], READS_AXIS)
        return out, global_hits

    mapped = _shard_map(
        local_step,
        mesh,
        in_specs=(
            P(None),
            P(None, None),
            P(None, None),
            P(READS_AXIS, None),
        ),
        out_specs=(P(READS_AXIS), P()),
    )
    return jax.jit(mapped)
