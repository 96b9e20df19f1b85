"""Batched JAX kernels for the demux pipeline (any XLA backend).

Four device stages, all in the scaled-integer cost domain of
:mod:`barbell_tpu.ops.oracle` (exact agreement with the oracle is a
test invariant):

1. :func:`flank_ends` — semiglobal DP end-cost curve of one flank
   pattern over a batch of padded reads.  Row-scan over pattern
   positions; the in-row horizontal (text-gap) closure is a min-plus
   prefix scan, so each of the ~90 rows is a handful of vectorized
   [B, L] ops + one associative scan.  Overhang alpha applies at
   column 0 (read start) and at each read's own end column.
2. :func:`find_hits` — plateau-valley extraction + top-K compaction.
3. :func:`window_dp` — windowed multi-pattern DP that also records
   per-cell traceback moves (2-bit move + match bit).
4. :func:`traceback_reduce` — fixed-length backward scan over the move
   tables computing, per lane: alignment start, the text window covered
   by a pattern sub-range (mask region), the mapped barcode interval +
   its sub-cost, and the Lodhi gap-weighted score — all as scan
   carries, no materialized paths.

Everything is pure jnp (XLA fuses the elementwise work); on the GPU the
flank scan interior and the barcode rank have Triton kernels
(:mod:`barbell_tpu.ops.triton_myers`, :mod:`barbell_tpu.ops.triton_rank`)
tested against these twins.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .oracle import COST_SCALE

UNIT = COST_SCALE
# Plain int so importing this module never initializes a jax backend.
BIG = 2**30

LAM = 0.5  # Lodhi decay
A_DIAG = LAM * LAM  # width-2 column factor
A_GAP = LAM  # width-1 column factor


# ---------------------------------------------------------------------------
# Stage 1: flank end-cost curve
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=())
def flank_ends(pattern, text, start_col, end_col, alpha_scaled):
    """End-cost curve of `pattern` over each (chunked) text row.

    pattern:   [m]  uint8 IUPAC masks
    text:      [B, L] uint8 IUPAC masks (0 outside each row's text span)
    start_col: [B] int32 — column of the read's *true start* within the
               row (overhang boundary: vertical steps there cost alpha),
               or -1 when the row does not contain the read start.
    end_col:   [B] int32 — column of the read's true end, or out of
               range when absent.
    alpha_scaled: int32 — scaled overhang cost
    returns:   ends [B, L+1] int32 (garbage outside each row's valid
               end range; mask downstream)

    Rows may carry their text anywhere within [start, end] columns —
    bytes outside match nothing, and any ≤k end-cost within the valid
    range is unaffected by them (a path crossing them pays a unit per
    crossed column).
    """
    B, L = text.shape
    m = pattern.shape[0]
    jpos = jnp.arange(L + 1, dtype=jnp.int32)
    boundary_col = (jpos[None, :] == start_col[:, None]) | (
        jpos[None, :] == end_col[:, None]
    )
    vert = jnp.where(boundary_col, alpha_scaled, UNIT)  # [B, L+1]
    unit_j = UNIT * jpos

    # Derive the initial carry from `text` so it inherits the same
    # varying-axes type under shard_map (a plain zeros() is "replicated"
    # and scan would reject the carry type mismatch).
    C0 = jnp.zeros((B, L + 1), dtype=jnp.int32) + (text[:, :1].astype(jnp.int32) * 0)
    rows = (pattern.astype(jnp.int32), jnp.arange(1, m + 1, dtype=jnp.int32))
    boundary_step = jnp.where(start_col == 0, alpha_scaled, UNIT)  # [B]

    def row_step(C_prev, xs):
        pat_i, i = xs
        eq = (text.astype(jnp.int32) & pat_i) != 0
        sub = jnp.where(eq, 0, UNIT)
        boundary = boundary_step * i  # [B] — column-0 init
        v = jnp.minimum(C_prev[:, :-1] + sub, C_prev[:, 1:] + vert[:, 1:])
        w = jnp.concatenate([boundary[:, None], v], axis=1)
        u = w - unit_j[None, :]
        u = jax.lax.associative_scan(jnp.minimum, u, axis=1)
        return u + unit_j[None, :], None

    ends, _ = jax.lax.scan(row_step, C0, rows)
    return ends


# ---------------------------------------------------------------------------
# Stage 2: valley extraction
# ---------------------------------------------------------------------------


class Hits(NamedTuple):
    pos: jnp.ndarray  # [B, K] int32 end positions (within row)
    cost: jnp.ndarray  # [B, K] int32 scaled costs
    valid: jnp.ndarray  # [B, K] bool
    count: jnp.ndarray  # [B] int32 total valleys (for overflow detection)


@functools.partial(jax.jit, static_argnames=("K",))
def find_hits(ends, lo, hi, k_scaled, K: int) -> Hits:
    """Plateau-valley minima with cost <= k, compacted to K per row.

    Valid end positions are lo[b] <= j <= hi[b].  A valley is
    ``e[j] <= k and e[j] < e[j+1] and e[j] <= e[j-1]`` with +inf outside
    the valid range (the rightmost point of each plateau).  Returns the
    K lowest-cost valleys (ties -> smallest j).
    """
    B, N = ends.shape
    jpos = jnp.arange(N, dtype=jnp.int32)
    valid = (jpos[None, :] >= lo[:, None]) & (jpos[None, :] <= hi[:, None])
    e = jnp.where(valid, ends, BIG)
    prv = jnp.concatenate([jnp.full((B, 1), BIG), e[:, :-1]], axis=1)
    nxt = jnp.concatenate([e[:, 1:], jnp.full((B, 1), BIG)], axis=1)
    isv = (e <= k_scaled) & (e < nxt) & (e <= prv)
    count = isv.sum(axis=1, dtype=jnp.int32)
    neg = jnp.where(isv, -e, -BIG)
    vals, idxs = jax.lax.top_k(neg, K)  # ties -> lowest index = smallest j
    return Hits(
        pos=idxs.astype(jnp.int32),
        cost=-vals,
        valid=vals > -BIG,
        count=count,
    )


# ---------------------------------------------------------------------------
# Stage 3: windowed multi-pattern DP with move recording
# ---------------------------------------------------------------------------


class WindowDP(NamedTuple):
    ends: jnp.ndarray  # [H, P, W+1] int32
    moves: jnp.ndarray  # [m, H, P, W+1] uint8 (bits 0-1 move, bit 2 eq)


@functools.partial(jax.jit, static_argnames=())
def window_dp(patterns, windows, left_edge, right_pos, alpha_scaled) -> WindowDP:
    """Semiglobal DP of every pattern against every window.

    patterns: [P, m] uint8
    windows:  [H, W] uint8 (left-aligned content, 0-padded tail)
    left_edge: [H] bool — column 0 is the read's true start (alpha
              boundary); otherwise the boundary is unreachable.
    right_pos: [H] int32 — window column equal to the read's true end
              (alpha verticals), or -1.
    alpha_scaled: scaled overhang cost; pass UNIT for plain semiglobal.

    Move encoding per cell (i, j): 0 diagonal, 1 up, 2 left; bit 2 set
    when the diagonal characters match.
    """
    P, m = patterns.shape
    H, W = windows.shape
    jpos = jnp.arange(W + 1, dtype=jnp.int32)
    unit_j = UNIT * jpos
    vert = jnp.where(jpos[None, :] == right_pos[:, None], alpha_scaled, UNIT)  # [H, W+1]
    win = windows.astype(jnp.int32)

    C0 = jnp.zeros((H, P, W + 1), dtype=jnp.int32)
    rows = (patterns.T.astype(jnp.int32), jnp.arange(1, m + 1, dtype=jnp.int32))

    def row_step(C_prev, xs):
        pat_row, i = xs  # pat_row [P]
        eq = (win[:, None, :] & pat_row[None, :, None]) != 0  # [H, P, W]
        sub = jnp.where(eq, 0, UNIT)
        boundary = jnp.where(left_edge, alpha_scaled * i, UNIT * i)  # [H]
        v = jnp.minimum(
            C_prev[:, :, :-1] + sub, C_prev[:, :, 1:] + vert[:, None, 1:]
        )
        w = jnp.concatenate(
            [jnp.broadcast_to(boundary[:, None, None], (H, P, 1)), v], axis=2
        )
        u = w - unit_j[None, None, :]
        u = jax.lax.associative_scan(jnp.minimum, u, axis=2)
        C = u + unit_j[None, None, :]

        diag_ok = C[:, :, 1:] == C_prev[:, :, :-1] + sub
        up_ok = C == C_prev + vert[:, None, :]
        move_tail = jnp.where(diag_ok, 0, jnp.where(up_ok[:, :, 1:], 1, 2))
        move = jnp.concatenate(
            [jnp.ones((H, P, 1), dtype=jnp.int32), move_tail], axis=2
        )
        eq_bits = jnp.concatenate(
            [jnp.zeros((H, P, 1), dtype=jnp.int32), eq.astype(jnp.int32)], axis=2
        )
        moves_row = (move | (eq_bits << 2)).astype(jnp.uint8)
        return C, moves_row

    ends, moves = jax.lax.scan(row_step, C0, rows)
    return WindowDP(ends=ends, moves=moves)  # moves: [m, H, P, W+1]


# ---------------------------------------------------------------------------
# Stage 4: traceback with fused reductions
# ---------------------------------------------------------------------------


class TraceResult(NamedTuple):
    text_start: jnp.ndarray  # [H, P] int32 window col where the match starts
    region_lo: jnp.ndarray  # [H, P] int32 min col-start j over region cols
    region_hi: jnp.ndarray  # [H, P] int32 max col-start j over region cols
    has_region: jnp.ndarray  # [H, P] bool
    iv_pi: jnp.ndarray  # [H, P] first in-interval column (pattern pos)
    iv_pj: jnp.ndarray  # [H, P] first in-interval column (text pos)
    iv_ei: jnp.ndarray  # [H, P] last in-interval column (pattern pos)
    iv_ej: jnp.ndarray  # [H, P] last in-interval column (text pos)
    iv_cost: jnp.ndarray  # [H, P] int32 sub-cost in edit units
    has_interval: jnp.ndarray  # [H, P] bool
    lodhi: jnp.ndarray  # [H, P] float32 gap-weighted score


@functools.partial(jax.jit, static_argnames=("m", "W"))
def traceback_reduce(
    moves,  # [m, H, P, W+1] uint8
    end_j,  # [H, P] int32
    valid,  # [H, P] bool
    region_a,  # int32 inclusive pattern-range start (mask region)
    region_b,  # int32 inclusive pattern-range end
    iv_a,  # int32 interval start (inclusive)
    iv_b,  # int32 interval end (EXCLUSIVE)
    m: int,
    W: int,
) -> TraceResult:
    """Backward walk over the move tables with fused reductions.

    Columns are visited last-to-first; every reduction is either
    order-independent (min/max/sum, Lodhi is reversal-invariant) or
    handles the reversal explicitly (first/last column tracking).
    """
    H, P = end_j.shape
    HP = H * P
    moves_flat = moves.reshape(-1)
    lane = (jnp.arange(H, dtype=jnp.int32)[:, None] * P) + jnp.arange(
        P, dtype=jnp.int32
    )[None, :]

    init = dict(
        i=jnp.full((H, P), m, dtype=jnp.int32),
        j=end_j.astype(jnp.int32),
        done=~valid,
        text_start=jnp.zeros((H, P), dtype=jnp.int32),
        region_lo=jnp.full((H, P), BIG, dtype=jnp.int32),
        region_hi=jnp.full((H, P), -1, dtype=jnp.int32),
        iv_pi=jnp.zeros((H, P), dtype=jnp.int32),
        iv_pj=jnp.zeros((H, P), dtype=jnp.int32),
        iv_ei=jnp.full((H, P), -1, dtype=jnp.int32),
        iv_ej=jnp.full((H, P), -1, dtype=jnp.int32),
        iv_cost=jnp.zeros((H, P), dtype=jnp.int32),
        has_interval=jnp.zeros((H, P), dtype=bool),
        T1=jnp.zeros((H, P), dtype=jnp.float32),
        T2=jnp.zeros((H, P), dtype=jnp.float32),
        S=jnp.zeros((H, P), dtype=jnp.float32),
    )

    def step(state, _):
        i, j, done = state["i"], state["j"], state["done"]
        active = ~done
        # move for cell (i, j) lives at moves[i-1, h, p, j]
        safe_i = jnp.maximum(i, 1)
        idx = ((safe_i - 1) * HP + lane) * (W + 1) + j
        mv = jnp.take(moves_flat, idx.reshape(-1)).reshape(H, P).astype(jnp.int32)
        move = mv & 3
        eqb = (mv >> 2) & 1

        ni = jnp.where(move == 2, i, i - 1)
        nj = jnp.where(move == 1, j, j - 1)

        is_match = active & (move == 0) & (eqb == 1)
        a_c = jnp.where(move == 0, A_DIAG, A_GAP).astype(jnp.float32)
        a_c = jnp.where(active, a_c, 1.0)
        mf = is_match.astype(jnp.float32)

        S = state["S"] + mf * a_c * state["T2"]
        T2 = jnp.where(active, a_c * (state["T2"] + mf * state["T1"]), state["T2"])
        T1 = jnp.where(active, a_c * (state["T1"] + mf), state["T1"])

        # column coordinates = state after the step
        col_i, col_j = ni, nj
        in_region = active & (col_i >= region_a) & (col_i <= region_b)
        region_lo = jnp.where(
            in_region, jnp.minimum(state["region_lo"], col_j), state["region_lo"]
        )
        region_hi = jnp.where(
            in_region, jnp.maximum(state["region_hi"], col_j), state["region_hi"]
        )

        in_iv = active & (col_i >= iv_a) & (col_i < iv_b)
        # visited backward: overwrite start every time, set end only once
        iv_pi = jnp.where(in_iv, col_i, state["iv_pi"])
        iv_pj = jnp.where(in_iv, col_j, state["iv_pj"])
        first_iv = in_iv & ~state["has_interval"]
        iv_ei = jnp.where(first_iv, col_i, state["iv_ei"])
        iv_ej = jnp.where(first_iv, col_j, state["iv_ej"])
        iv_cost = state["iv_cost"] + jnp.where(in_iv & ~is_match, 1, 0)
        has_interval = state["has_interval"] | in_iv

        newly_done = active & (ni == 0)
        text_start = jnp.where(newly_done, nj, state["text_start"])
        done = done | newly_done
        i = jnp.where(active, ni, i)
        j = jnp.where(active, nj, j)

        return (
            dict(
                i=i,
                j=j,
                done=done,
                text_start=text_start,
                region_lo=region_lo,
                region_hi=region_hi,
                iv_pi=iv_pi,
                iv_pj=iv_pj,
                iv_ei=iv_ei,
                iv_ej=iv_ej,
                iv_cost=iv_cost,
                has_interval=has_interval,
                T1=T1,
                T2=T2,
                S=S,
            ),
            None,
        )

    state, _ = jax.lax.scan(step, init, None, length=m + W, unroll=8)
    return TraceResult(
        text_start=state["text_start"],
        region_lo=state["region_lo"],
        region_hi=state["region_hi"],
        has_region=state["region_hi"] >= 0,
        iv_pi=state["iv_pi"],
        iv_pj=state["iv_pj"],
        iv_ei=state["iv_ei"],
        iv_ej=state["iv_ej"],
        iv_cost=state["iv_cost"],
        has_interval=state["has_interval"],
        lodhi=state["S"],
    )


# ---------------------------------------------------------------------------
# Stage 3/4 fused: forward path-summary DP (no moves table, no traceback)
# ---------------------------------------------------------------------------


class SummaryDP(NamedTuple):
    """Per-cell path summaries at the final pattern row.

    Every field is [H, P, W+1]: the value for the optimal alignment path
    ENDING at text position j (semantics identical to running
    :func:`traceback_reduce` from (m, j) over :func:`window_dp` moves —
    enforced by tests).  Fields not requested are None.
    """

    ends: jnp.ndarray  # int32 end costs (== window_dp().ends)
    lodhi: jnp.ndarray  # float32 gap-weighted score
    text_start: jnp.ndarray  # int32 window col where the path starts
    region_lo: jnp.ndarray  # int32 min text col over region pattern rows
    region_hi: jnp.ndarray  # int32 max text col (has_region = hi >= 0)
    iv_pi: jnp.ndarray  # int32 first in-interval pattern pos
    iv_pj: jnp.ndarray  # int32 first in-interval text pos
    iv_ei: jnp.ndarray  # int32 last in-interval pattern pos
    iv_ej: jnp.ndarray  # int32 last in-interval text pos
    iv_cost: jnp.ndarray  # int32 non-match steps inside the interval
    has_interval: jnp.ndarray  # bool


@functools.partial(
    jax.jit,
    static_argnames=("with_lodhi", "with_region", "with_interval", "with_start"),
)
def window_dp_summary(
    patterns_hp,  # [Hp, P, m] uint8, Hp in {1, H} (per-window when Hp == H)
    windows,  # [H, W] uint8
    left_edge,  # [H] bool — col 0 is the read's true start (alpha boundary)
    right_pos,  # [H] int32 — col of the read's true end, or -1
    alpha_scaled,
    region_a,  # int32 inclusive pattern-row range for region tracking
    region_b,
    iv_a,  # int32 pattern interval start (inclusive)
    iv_b,  # int32 pattern interval end (EXCLUSIVE)
    with_lodhi: bool = False,
    with_region: bool = False,
    with_interval: bool = False,
    with_start: bool = False,
) -> SummaryDP:
    """Forward DP carrying path summaries per cell.

    Replaces window_dp + traceback_reduce on the hot path: the move
    tables ([m, H, P, W+1] in HBM) and the m+W-step gather scan vanish;
    instead each summary is propagated cell-to-cell during the row scan.
    Move tie-breaking (diag > up > left) and all update formulas mirror
    traceback_reduce exactly; a horizontal (left-move) run only scales
    the Lodhi state by lambda^d and extends min/max trackers, so runs
    collapse into a cummax scan + one gather per carried array.
    """
    assert LAM == 0.5, "left-run collapse uses exact powers of two"
    Hp, P, m = patterns_hp.shape
    H, W = windows.shape
    jpos = jnp.arange(W + 1, dtype=jnp.int32)
    unit_j = UNIT * jpos
    vert = jnp.where(jpos[None, :] == right_pos[:, None], alpha_scaled, UNIT)
    win = windows.astype(jnp.int32)

    f32 = jnp.float32
    # Scan carries derive from `windows` so they inherit its varying-axes
    # type under shard_map (plain zeros/full are "replicated" and the
    # scan would reject the carry type mismatch — same trick as
    # flank_ends).
    vary_i = windows[:, :1, None].astype(jnp.int32) * 0  # [H, 1, 1]
    vary_f = vary_i.astype(f32)
    vary_b = vary_i != 0

    def zi(fill):
        return jnp.full((H, P, W + 1), fill, dtype=jnp.int32) + vary_i

    carry = dict(C=zi(0))
    if with_lodhi:
        for name in ("T1", "T2", "S"):
            carry[name] = jnp.zeros((H, P, W + 1), dtype=f32) + vary_f
    if with_region:
        carry["region_lo"] = zi(BIG)
        carry["region_hi"] = zi(-1)
    if with_interval:
        carry["iv_pi"] = zi(0)
        carry["iv_pj"] = zi(0)
        carry["iv_ei"] = zi(-1)
        carry["iv_ej"] = zi(-1)
        carry["iv_cost"] = zi(0)
        carry["has_iv"] = jnp.zeros((H, P, W + 1), dtype=bool) | vary_b
    if with_start:
        carry["ts"] = zi(0)

    pat_cols = jnp.transpose(patterns_hp, (2, 0, 1)).astype(jnp.int32)  # [m, Hp, P]
    rows = (pat_cols, jnp.arange(1, m + 1, dtype=jnp.int32))

    def shift_right(a, fill):
        return jnp.concatenate(
            [jnp.full((H, P, 1), fill, dtype=a.dtype), a[:, :, :-1]], axis=2
        )

    def row_step(st, xs):
        pat_i, i = xs  # pat_i [Hp, P]; row index i (1-based)
        C_prev = st["C"]
        eq = (win[:, None, :] & pat_i[:, :, None]) != 0  # [H, P, W]
        sub = jnp.where(eq, 0, UNIT)
        diag_val = C_prev[:, :, :-1] + sub  # cost via diag into j=1..W
        up_val = C_prev[:, :, 1:] + vert[:, None, 1:]
        v = jnp.minimum(diag_val, up_val)
        boundary = jnp.where(left_edge, alpha_scaled * i, UNIT * i)  # [H]
        w = jnp.concatenate(
            [jnp.broadcast_to(boundary[:, None, None], (H, P, 1)), v], axis=2
        )
        u = w - unit_j[None, None, :]
        u = jax.lax.associative_scan(jnp.minimum, u, axis=2)
        C = u + unit_j[None, None, :]

        false_col = jnp.zeros((H, P, 1), dtype=bool)
        diag_ok = jnp.concatenate([false_col, C[:, :, 1:] == diag_val], axis=2)
        up_ok = C == C_prev + vert[:, None, :]
        # col 0 is always an up move (window_dp forces move=1 there, and
        # the alpha left-edge boundary can make the cost test fail)
        up_ok = up_ok.at[:, :, 0].set(True)
        isleft = ~diag_ok & ~up_ok

        # Summaries of the edge INTO cell (i, j): diag consumes
        # (pattern i, text j) with predecessor u=(i-1, j-1); up consumes
        # pattern only, u=(i-1, j).  mf (Lodhi match flag) is diag & eq.
        eq_full = jnp.concatenate([false_col, eq], axis=2)
        mf = (diag_ok & eq_full).astype(f32)
        u_i = jnp.where(diag_ok | up_ok, i - 1, i)  # predecessor pattern row
        # predecessor text col: j-1 for diag, j for up (left handled below)
        base = {}
        for name, arr in st.items():
            if name == "C":
                continue
            prev_d = shift_right(arr, 0 if arr.dtype != f32 else 0.0)
            base[name] = jnp.where(diag_ok, prev_d, arr)  # up keeps col j
        if with_lodhi:
            a_c = jnp.where(diag_ok, f32(A_DIAG), f32(A_GAP))
            T1p, T2p, Sp = base["T1"], base["T2"], base["S"]
            base["S"] = Sp + mf * a_c * T2p
            base["T2"] = a_c * (T2p + mf * T1p)
            base["T1"] = a_c * (T1p + mf)
        u_j = jnp.where(diag_ok, jpos[None, None, :] - 1, jpos[None, None, :])
        if with_region:
            in_r = (u_i >= region_a) & (u_i <= region_b)
            base["region_lo"] = jnp.minimum(
                base["region_lo"], jnp.where(in_r, u_j, BIG)
            )
            base["region_hi"] = jnp.maximum(
                base["region_hi"], jnp.where(in_r, u_j, -1)
            )
        if with_interval:
            in_iv = (u_i >= iv_a) & (u_i < iv_b)
            first_iv = in_iv & ~base["has_iv"]
            base["iv_pi"] = jnp.where(first_iv, u_i, base["iv_pi"])
            base["iv_pj"] = jnp.where(first_iv, u_j, base["iv_pj"])
            base["iv_ei"] = jnp.where(in_iv, u_i, base["iv_ei"])
            base["iv_ej"] = jnp.where(in_iv, u_j, base["iv_ej"])
            base["iv_cost"] = base["iv_cost"] + jnp.where(
                in_iv & (mf == 0.0), 1, 0
            )
            base["has_iv"] = base["has_iv"] | in_iv
        if with_start:
            base["ts"] = jnp.where(u_i == 0, u_j, base["ts"])

        # Collapse left runs: cell j's path enters the row at g(j) = the
        # nearest non-left cell <= j, then takes d = j - g left edges,
        # each with predecessor (i, j'), j' = g..j-1, a = lambda, mf = 0.
        # The base state is forward-filled across runs with a segmented
        # last-base associative scan (no per-element gathers).
        fill = dict(base)
        fill["_g"] = jnp.broadcast_to(
            jpos[None, None, :], (H, P, W + 1)
        ).astype(jnp.int32)
        fill["_f"] = ~isleft  # base (non-left) cells

        def last_base(a, b):
            fb = b["_f"]
            out = {k: jnp.where(fb, v, a[k]) for k, v in b.items() if k != "_f"}
            out["_f"] = a["_f"] | fb
            return out

        new = jax.lax.associative_scan(last_base, fill, axis=2)
        new.pop("_f")
        g = new.pop("_g")
        d = jpos[None, None, :] - g
        chain = d > 0
        if with_lodhi:
            factor = jnp.exp2(-d.astype(f32))  # lambda**d, exact
            new["T1"] = new["T1"] * factor
            new["T2"] = new["T2"] * factor
        if with_region:
            in_r_row = (i >= region_a) & (i <= region_b)
            ext = chain & in_r_row
            new["region_lo"] = jnp.where(
                ext, jnp.minimum(new["region_lo"], g), new["region_lo"]
            )
            new["region_hi"] = jnp.where(
                ext, jnp.maximum(new["region_hi"], jpos[None, None, :] - 1),
                new["region_hi"],
            )
        if with_interval:
            in_iv_row = (i >= iv_a) & (i < iv_b)
            ext = chain & in_iv_row
            first_iv = ext & ~new["has_iv"]
            new["iv_pi"] = jnp.where(first_iv, i, new["iv_pi"])
            new["iv_pj"] = jnp.where(first_iv, g, new["iv_pj"])
            new["iv_ei"] = jnp.where(ext, i, new["iv_ei"])
            new["iv_ej"] = jnp.where(ext, jpos[None, None, :] - 1, new["iv_ej"])
            new["iv_cost"] = new["iv_cost"] + jnp.where(ext, d, 0)
            new["has_iv"] = new["has_iv"] | ext
        new["C"] = C
        return new, None

    final, _ = jax.lax.scan(row_step, carry, rows)
    return SummaryDP(
        ends=final["C"],
        lodhi=final.get("S"),
        text_start=final.get("ts"),
        region_lo=final.get("region_lo"),
        region_hi=final.get("region_hi"),
        iv_pi=final.get("iv_pi"),
        iv_pj=final.get("iv_pj"),
        iv_ei=final.get("iv_ei"),
        iv_ej=final.get("iv_ej"),
        iv_cost=final.get("iv_cost"),
        has_interval=final.get("has_iv"),
    )


# ---------------------------------------------------------------------------
# Stage 3a helper: best valley per pattern
# ---------------------------------------------------------------------------


class BestPerPattern(NamedTuple):
    cost: jnp.ndarray  # [H, P] int32
    pos: jnp.ndarray  # [H, P] int32
    has: jnp.ndarray  # [H, P] bool


@functools.partial(jax.jit, static_argnames=())
def best_valley_per_pattern(ends, w_len) -> BestPerPattern:
    """Lowest-cost valley per (window, pattern); ties -> smallest j.

    ends: [H, P, W+1]; w_len: [H] valid window length.
    """
    H, P, N = ends.shape
    jpos = jnp.arange(N, dtype=jnp.int32)
    valid = jpos[None, None, :] <= w_len[:, None, None]
    e = jnp.where(valid, ends, BIG)
    prv = jnp.concatenate([jnp.full((H, P, 1), BIG), e[:, :, :-1]], axis=2)
    nxt = jnp.concatenate([e[:, :, 1:], jnp.full((H, P, 1), BIG)], axis=2)
    isv = (e < nxt) & (e <= prv)
    # key favours low cost then low j; costs bounded by m*UNIT << 2^24
    key = jnp.where(isv, e * 256 + jpos[None, None, :], BIG)
    best = jnp.argmin(key, axis=2).astype(jnp.int32)
    best_cost = jnp.take_along_axis(e, best[:, :, None], axis=2)[:, :, 0]
    return BestPerPattern(cost=best_cost, pos=best, has=best_cost < BIG)
